"""Time the two APGD contact kernels on the card, against their plain
versions, their bounds and, optionally, another build of the same kernels.

    python -m pbhc_tpu_torch.eval.kernel_bench [rows=12,38] [num_envs=4096] [iters=16]
        [reps=50] [envs=4,8,16] [parts=1,2,4] [old=<dir>]

For each kernel and row count R it prints one JSON line: the kernel's max
abs error against its plain version, its time per launch over `reps`
launches back to back after a warm-up (`ms`, CUDA events; the host's launch
cost shows there when it exceeds the kernel's), its device time per launch
(`ms_device`, from a `torch.profiler` trace of `reps` launches), the plain
version's time (CUDA events) and the bound.

`old=` is the A/B step of a kernel redesign: it names a directory holding
an earlier design's `apgd_lanes.cu` and `apgd_envfirst.cu` with the same C
launch functions (an earlier commit's `pbhc_tpu_torch/csrc/`, unpacked with
`git archive` under `build/`, which git ignores). They are built into
`build/kernels/` and timed in turns with the current design, in the order
earlier, current, current, earlier; both through the bare launch function.
`envs=` and `parts=` also time the current design at each tile of the
listed widths E and threads per contact P that it takes (the defaults: the
kernel's own choice). The last line is the card's name and power limit.
Needs a CUDA card.
"""
from __future__ import annotations

import ctypes
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
    """Mean device time of the CUDA kernels whose name contains `name` in a
    `torch.profiler` trace of `reps` calls of `fn()` (one such kernel per
    call) after one warm-up call. The trace may miss a kernel at its start,
    so the mean is over the kernels it holds."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
    if not reps // 2 <= len(kernels) <= reps:
        raise RuntimeError(f"the trace holds {len(kernels)} {name} kernels for {reps} calls")
    return sum(e.device_time for e in kernels) / 1e3 / len(kernels)


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
    over the memory rate, or its f32 operations over the f32 rate."""
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


# kernel name -> (wrapper, the same at a chosen tile, plain version,
# problem, bound, count of input pointers before `out` in its launch function)
KERNELS = {
    "apgd_lanes": (ck.apgd_lanes, ck.apgd_lanes_at_tile, ck.apgd_lanes_plain, lanes_problem, apgd_bound_ms, 5),
    "apgd_envfirst": (ck.apgd_envfirst, ck.apgd_envfirst_at_tile, ck.apgd_envfirst_plain, envfirst_problem,
                      envfirst_bound_ms, 4),
}


def _launcher(lib, name, n_in, args, R, N, iters):
    """A function that launches `lib`'s `<name>_launch` on `args` into a fresh
    output and returns the output."""
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * (n_in + 1) + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(args[1].shape, dtype=torch.float32, device=args[0].device)

    def run():
        err = fn(*[t.data_ptr() for t in args], out.data_ptr(), R, N, iters,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name}: launch failed with code {err}")
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
        specs = [nvcc.CudaLibrary(f"earlier_{name}", (f"{name}.cu",), root=root) for name in KERNELS]
        nvcc.build(specs)
        old_libs = {name: nvcc.load(spec) for name, spec in zip(KERNELS, specs)}
    lines = []
    for name, (wrapper, at_tile, plain, problem, bound, n_in) in KERNELS.items():
        for R in rows:
            N, (E, P) = num_envs, ck.tile(name, R)
            args = problem(R, N, dev, R)
            ref = plain(*args, iters).reshape(args[1].shape)
            line = {"kernel": name, "R": R, "N": N, "iters": iters, "E": E, "P": P}

            def err_of(out):
                return float((out.reshape(ref.shape) - ref).abs().max())

            line["max_abs_err"] = err_of(wrapper(*args, iters))
            runs = {"current": _launcher(new_libs[name], name, n_in, args, R, N, iters)}
            if name in old_libs:
                max_rows = getattr(old_libs[name], f"{name}_max_rows")()
                if R <= max_rows:
                    runs["earlier"] = _launcher(old_libs[name], name, n_in, args, R, N, iters)
                    line["earlier_max_abs_err"] = err_of(runs["earlier"]())
                else:
                    line["earlier_ms"] = f"refuses R > {max_rows}"
            order = ["earlier", "current", "current", "earlier"] if "earlier" in runs else ["current", "current"]
            events = {k: [] for k in runs}
            device = {k: [] for k in runs}
            for k in order:
                events[k].append(cuda_ms(runs[k], reps))
                device[k].append(device_ms(runs[k], reps, name))
            line["ms_turns"], line["ms_device_turns"] = events, device
            for k, prefix in (("current", ""), ("earlier", "earlier_")):
                if k in runs:
                    line[f"{prefix}ms"] = sum(events[k]) / len(events[k])
                    line[f"{prefix}ms_device"] = sum(device[k]) / len(device[k])
            for e_ in envs or (E,):
                for p_ in parts or (P,):
                    if (e_, p_) == (E, P):
                        continue
                    run = lambda e_=e_, p_=p_: at_tile(*args, iters, e_, p_)
                    try:
                        err = err_of(run())
                    except ValueError:  # a tile the kernel does not take at this R
                        continue
                    line.setdefault("err_by_tile", {})[f"E{e_}P{p_}"] = err
                    line.setdefault("ms_device_by_tile", {})[f"E{e_}P{p_}"] = device_ms(run, reps, name)
            line["plain_ms"] = cuda_ms(lambda: plain(*args, iters), max(1, reps // 5))
            line["bound_ms"], line["bound_by"] = bound(R, N, iters)
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
