"""One run of one cell: set-up, warm-up, the measured window, the traced
slice, the check against the plain reference, and the result line.

Everything that belongs to one cell is found by name from `BENCHMARK.json`:
the configuration `portbench/configs/<config>.json`, the traffic mix
`portbench/traffic/<traffic>.json`, the loop it names
`portbench/loops/<loop>.py` (the driver, the numbers of its check and its
faults), the reader of each metric `portbench/metrics/<metric>.py` and the
correctness limits `portbench/limits/<cell>.json`. The configuration names
its plain references, `portbench/reference/<module>.py` by role.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# no module of these top-level names may be loaded in a run: the JAX package
# and its stack are not the program under test
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pbhc_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of `BENCHMARK.json` with everything found by its names."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = Path(root)
        spec = load_json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json ({', '.join(cells)})")
        self.name, self.spec = name, cells[name]
        self.chips = int(self.spec["chips"])
        bench = self.root / "portbench"
        self.config = load_json(bench / "configs" / f"{self.spec['config']}.json")
        self.traffic = load_json(bench / "traffic" / f"{self.spec['traffic']}.json")
        self.limits = load_json(bench / "limits" / f"{name}.json")

        def here(m):
            return name in m.get("workloads", cells)

        self.end_to_end = [m for m in spec["end_to_end"] if here(m)]
        self.per_layer = [m for m in spec["per_layer"] if here(m)]

    def reader(self, metric: str):
        return _module(self.root / "portbench" / "metrics" / f"{metric}.py").read

    def loop(self):
        """The module of the mix's loop: `Loop`, `numbers`, `FAULTS`."""
        return _module(self.root / "portbench" / "loops" / f"{self.traffic['loop']}.py")

    def references(self, device, control=False) -> dict:
        """The configuration's references by role, in float32 and, for the
        control, each as `<role>_lo` in the control's precision."""
        refs = {}
        for role, name in self.config["references"].items():
            mod = importlib.import_module(f"portbench.reference.{name}")
            refs[role] = mod.Reference(self.config, self.root, device)
            if control:
                refs[f"{role}_lo"] = mod.Reference(self.config, self.root, device, "tf32")
        return refs


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(f"portbench_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_probe_ms() -> float:
    """Milliseconds the host takes for a fixed pure-Python workload: read
    beside a run's rates, it tells the host's speed from the program's."""
    t, x = time.perf_counter(), 0
    for i in range(200_000):
        x += i * i % 7
    return 1e3 * (time.perf_counter() - t)


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda", t0=None,
             overrides=(), plant=None, control=False) -> dict:
    """One run; returns the result object. `overrides` (a.b.c=v) change the
    program's config and `plant` (a function of the loop) breaks the timed
    path, for the tests and the control's readings; `control` adds the
    control's numbers (the reference in TF32 in the program's place) under
    `control`."""
    import torch

    from portbench import judge
    from portbench.trace import Profiler, breakdown, reduce_all
    from portbench.window import Spans, run_window

    t0 = time.perf_counter() if t0 is None else t0
    rng = random.Random(seed)
    kind = cell.loop()
    loop = kind.Loop(cell.root, cell.config, cell.traffic, seed, device, overrides)
    if plant is not None:
        plant(loop)
    dev = loop.device
    loop.warmup(rng, Spans(False, dev))
    setup_s = time.perf_counter() - t0
    spans = Spans(trace, dev)
    probe, cpu0 = host_probe_ms(), time.thread_time()
    win = run_window(loop, seconds, spans, rng)
    cpu_s, probe_after = time.thread_time() - cpu0, host_probe_ms()
    profiler, profiled = Profiler(dev), {}
    if trace:
        profiled = loop.profile_units(cell.traffic, profiler)
    attempted, failed = win["units"], loop.failed()
    cuda = dev.type == "cuda"
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    capture = loop.capture
    loop.release()
    del loop
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    slices = reduce_all(profiler)
    del profiler

    numbers, ctrl = kind.numbers(cell.references(dev, control), capture, dev)
    correct, checks = judge.verdict(numbers, cell.limits)

    ctx = {"window": win, "setup_s": setup_s, "spans": dict(spans.seconds), "slices": slices,
           "profiled": profiled, "config": cell.config, "traffic": cell.traffic}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if cuda else dev.type,
                      "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                      "count": cell.chips, "memory_peak_bytes": int(memory_peak)}}
    if trace:
        out["device"]["busy_s"] = sum(s["busy_s"] for s in slices)
        out["device"]["window_s"] = sum(s["wall_s"] for s in slices)
        out["breakdown"] = breakdown(slices)
    # the host beside the window: its speed before and after, and the share
    # of the window in which the dispatching thread ran
    out["host"] = {"probe_ms": [probe, probe_after], "thread_cpu_share": cpu_s / win["seconds"]}
    if control:
        out["control"] = ctrl
    out["checks"] = checks
    return out


def _args(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0) -> int:
    args = _args(argv)
    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of the JAX stack were loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    print(f"portbench: {cell.name} seed {args.seed}: {out['attempted']} units of the {cell.traffic['loop']} "
          f"loop in the window, {out['failed']} failed", flush=True)
    print(json.dumps(out), flush=True)
    for k, c in out["checks"].items():
        shown = "missing" if c["value"] is None else str(c["value"])
        print(f"check {k} {shown} limit {c['limit']!r}", file=sys.stderr)
    return 0
