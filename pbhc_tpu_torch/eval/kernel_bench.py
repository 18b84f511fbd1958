"""Time the two APGD contact kernels on the card, against their plain
versions, their bounds and, optionally, another build of the same kernels.
Kernel 1 is timed in each matvec mode (`apgd_lanes` in float32,
`apgd_lanes_bf16`, `apgd_lanes_f16`: `contact_matvec_dtype` bfloat16 and
float16), each against the plain version in the same mode.

    python -m pbhc_tpu_torch.eval.kernel_bench [rows=12,38] [num_envs=4096] [iters=16]
        [reps=50] [envs=4,8,16] [parts=1,2,4] [old=<dir>]

For each kernel and row count R it prints one JSON line: the kernel's max
and mean abs error against its plain version, its time per launch over `reps`
launches back to back after a warm-up (`ms`, CUDA events; the host's launch
cost shows there when it exceeds the kernel's), its device time per launch
(`ms_device`, from a `torch.profiler` trace of `reps` launches), the plain
version's time (CUDA events) and the bound.

`old=` is the A/B step of a kernel redesign: it names a directory holding
an earlier design's `apgd_lanes.cu` and `apgd_envfirst.cu` with the same C
launch functions (an earlier commit's `pbhc_tpu_torch/csrc/`, unpacked with
`git archive` under `build/`, which git ignores; the reduced modes only
against a design that has `apgd_lanes_launch_mode`). They are built into
`build/kernels/` and timed in turns with the current design, in the order
earlier, current, current, earlier; both through the bare launch function.
`envs=` and `parts=` also time the current design at each tile of the
listed widths E and threads per contact P that it takes (the defaults: the
kernel's own choice). The last line is the card's name and power limit.
Needs a CUDA card.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from pbhc_tpu_torch.sim import contact_kernel as ck
from pbhc_tpu_torch.utils import nvcc

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12     # f32 outside the tensor cores, H100 SXM data sheet


def card_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = shutil.which("nvidia-smi")
    if smi:
        out = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    return f"{torch.cuda.get_device_name(0)}, power limit not read (no nvidia-smi)"


def cuda_ms(fn, reps):
    """Mean device time of `fn()` over `reps` runs, after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps, name):
    """Mean device time of the last `reps` CUDA kernels whose name contains
    `name` in a `torch.profiler` trace of 2 x `reps` calls of `fn()` (one
    such kernel per call), after one warm-up call outside the trace. A trace
    misses the kernels launched before its recording starts (30 of 50 short
    launches in one H100 run), so the first `reps` calls only cover that
    start."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2 * reps):
            fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name),
                     key=lambda e: e.time_range.start)
    if not reps <= len(kernels) <= 2 * reps:
        raise RuntimeError(f"the trace holds {len(kernels)} {name} kernels for {2 * reps} calls")
    return sum(e.device_time for e in kernels[-reps:]) / 1e3 / reps


def _bound(nbytes, ops):
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _ops(R, N, iters):
    # Lipschitz bound (abs, mul, add per entry) + per iteration the matvec
    # (mul+add per entry) and ~12 ops per row for momentum and projection
    n = 3 * R
    return N * (3 * n * n + iters * (2 * n * n + 12 * n))


def apgd_bound_ms(R, N, iters):
    """Kernel 1: A, b, mu, active and x0 read once, the impulses written once,
    over the memory rate, or its f32 operations over the f32 rate. The same
    in every matvec mode: A arrives in f32 and is read once either way."""
    n = 3 * R
    return _bound(4 * N * (n * n + n + 1 + R + n + n), _ops(R, N, iters))


def envfirst_bound_ms(R, N, iters):
    """Kernel 2: A, b, mu and active read once, the impulses written once."""
    n = 3 * R
    return _bound(4 * N * (n * n + 2 * n + 1 + R), _ops(R, N, iters))


def lanes_problem(R, N, dev, seed):
    """Random SPD Delassus matrices with ~30% inactive rows and a warm start,
    env-last: (A, b, mu, active, x0)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = 3 * R
    J = torch.randn((n, 40, N), generator=g, device=dev) * 0.3
    A = (torch.einsum("ivn,jvn->ijn", J, J) + 1e-2 * torch.eye(n, device=dev)[:, :, None]).contiguous()
    b = torch.randn((n, N), generator=g, device=dev)
    mu = 0.2 + torch.rand((N,), generator=g, device=dev)
    active = (torch.rand((R, N), generator=g, device=dev) > 0.3).float()
    x0 = torch.rand((n, N), generator=g, device=dev) * 0.5
    return A, b, mu, active, x0


def envfirst_problem(R, N, dev, seed):
    """The same kind of problem, env-first and without a warm start:
    (A, b, mu, active)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = 3 * R
    J = torch.randn((N, n, 40), generator=g, device=dev) * 0.3
    A = (J @ J.transpose(1, 2) + 1e-2 * torch.eye(n, device=dev)).contiguous()
    b = torch.randn((N, n), generator=g, device=dev)
    mu = 0.2 + torch.rand((N,), generator=g, device=dev)
    active = (torch.rand((N, R), generator=g, device=dev) > 0.3).float()
    return A, b, mu, active


# One kernel (and matvec mode) to time: its wrapper, the same at a chosen
# tile, the plain version, the problem and the bound; `symbol`, the prefix of
# its C functions; `n_in`, the input pointers before `out` in its launch
# function; `mode`, the matvec dtype.
Kernel = collections.namedtuple("Kernel", "wrapper at_tile plain problem bound symbol n_in mode")


def _lanes_mode(mode):
    """Kernel 1 in matvec mode `mode`."""
    part = lambda fn: functools.partial(fn, mv_dtype=mode)
    return Kernel(part(ck.apgd_lanes), part(ck.apgd_lanes_at_tile), part(ck.apgd_lanes_plain), lanes_problem,
                  apgd_bound_ms, "apgd_lanes", 5, mode)


KERNELS = {
    "apgd_lanes": _lanes_mode("float32"),
    "apgd_lanes_bf16": _lanes_mode("bfloat16"),
    "apgd_lanes_f16": _lanes_mode("float16"),
    "apgd_envfirst": Kernel(ck.apgd_envfirst, ck.apgd_envfirst_at_tile, ck.apgd_envfirst_plain, envfirst_problem,
                            envfirst_bound_ms, "apgd_envfirst", 4, "float32"),
}


def _launcher(lib, k: Kernel, args, R, N, iters):
    """A function that launches `lib`'s launch function of `k` (its
    `<symbol>_launch`, or `<symbol>_launch_mode` in a reduced mode) on `args`
    into a fresh output and returns the output."""
    if k.mode == "float32":
        fn, extra = getattr(lib, f"{k.symbol}_launch"), ()
    else:
        fn, extra = getattr(lib, f"{k.symbol}_launch_mode"), (ck.MV_MODES[k.mode], 0, 0)
    fn.argtypes = [ctypes.c_void_p] * (k.n_in + 1) + [ctypes.c_int] * (3 + len(extra)) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(args[1].shape, dtype=torch.float32, device=args[0].device)

    def run():
        err = fn(*[t.data_ptr() for t in args], out.data_ptr(), R, N, iters, *extra,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{k.symbol}: launch failed with code {err}")
        return out
    return run


def bench(rows=(12, 38), num_envs=4096, iters=16, reps=50, envs=(), parts=(), old=None):
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_bench measures the card: no CUDA device visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    new_libs = {"apgd_lanes": ck._library(), "apgd_envfirst": ck._envfirst_library()}
    old_libs = {}
    if old:
        root = Path(old).resolve()
        specs = [nvcc.CudaLibrary(f"earlier_{sym}", (f"{sym}.cu",), root=root) for sym in new_libs]
        nvcc.build(specs)
        old_libs = {sym: nvcc.load(spec) for sym, spec in zip(new_libs, specs)}
    lines = []
    for name, k in KERNELS.items():
        for R in rows:
            N, (E, P) = num_envs, ck.tile(k.symbol, R, k.mode)
            args = k.problem(R, N, dev, R)
            ref = k.plain(*args, iters).reshape(args[1].shape)
            line = {"kernel": name, "mode": k.mode, "R": R, "N": N, "iters": iters, "E": E, "P": P}

            def err_of(out):
                return float((out.reshape(ref.shape) - ref).abs().max())

            out = k.wrapper(*args, iters).reshape(ref.shape)
            line["max_abs_err"] = float((out - ref).abs().max())
            line["mean_abs_err"] = float((out - ref).abs().mean())
            runs = {"current": _launcher(new_libs[k.symbol], k, args, R, N, iters)}
            earlier = old_libs.get(k.symbol)
            if earlier is not None and k.mode != "float32" and not hasattr(earlier, f"{k.symbol}_launch_mode"):
                line["earlier_ms"] = "has no reduced matvec modes"
            elif earlier is not None:
                max_rows = getattr(earlier, f"{k.symbol}_max_rows")()
                if R <= max_rows:
                    runs["earlier"] = _launcher(earlier, k, args, R, N, iters)
                    line["earlier_max_abs_err"] = err_of(runs["earlier"]())
                else:
                    line["earlier_ms"] = f"refuses R > {max_rows}"
            order = ["earlier", "current", "current", "earlier"] if "earlier" in runs else ["current", "current"]
            events = {key: [] for key in runs}
            device = {key: [] for key in runs}
            for key in order:
                events[key].append(cuda_ms(runs[key], reps))
                device[key].append(device_ms(runs[key], reps, k.symbol))
            line["ms_turns"], line["ms_device_turns"] = events, device
            for key, prefix in (("current", ""), ("earlier", "earlier_")):
                if key in runs:
                    line[f"{prefix}ms"] = sum(events[key]) / len(events[key])
                    line[f"{prefix}ms_device"] = sum(device[key]) / len(device[key])
            for e_ in envs or (E,):
                for p_ in parts or (P,):
                    if (e_, p_) == (E, P):
                        continue
                    run = lambda e_=e_, p_=p_: k.at_tile(*args, iters, e_, p_)
                    try:
                        err = err_of(run())
                    except ValueError:  # a tile the kernel does not take at this R
                        continue
                    line.setdefault("err_by_tile", {})[f"E{e_}P{p_}"] = err
                    line.setdefault("ms_device_by_tile", {})[f"E{e_}P{p_}"] = device_ms(run, reps, k.symbol)
            line["plain_ms"] = cuda_ms(lambda: k.plain(*args, iters), max(1, reps // 5))
            line["bound_ms"], line["bound_by"] = k.bound(R, N, iters)
            lines.append(line)
            del args, ref
            torch.cuda.empty_cache()
    return lines


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    kv = dict(a.split("=", 1) for a in argv)
    kw = {}
    for k, v in kv.items():
        kw[k] = (v if k == "old" else tuple(int(x) for x in v.split(",")) if k in ("rows", "envs", "parts")
                 else int(v))
    for line in bench(**kw):
        print(json.dumps(line), flush=True)
    print(card_line(), flush=True)


if __name__ == "__main__":
    main()
