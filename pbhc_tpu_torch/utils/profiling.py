"""Profiling helpers (counterpart of `pbhc_tpu/utils/profiling.py`).

    with trace("build/trace"):               # a Chrome trace: chrome://tracing or Perfetto
        ... work ...

    with phase_timer("rollout", state) as t: ...   # wall time with device sync
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir):
    """`torch.profiler` over the block (CPU and, where a card is present, CUDA
    activities); the trace is written to `log_dir/trace.json`."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def _sync(value):
    """Wait for every CUDA device that holds a tensor of `value` (a tensor, or
    a dict, list, tuple or dataclass of them); CPU tensors need no wait."""
    devices = set()

    def visit(v):
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                devices.add(v.device)
        elif isinstance(v, dict):
            for x in v.values():
                visit(x)
        elif isinstance(v, (list, tuple)):
            for x in v:
                visit(x)
        elif hasattr(v, "__dataclass_fields__"):
            for name in v.__dataclass_fields__:
                visit(getattr(v, name))

    visit(value)
    for d in devices:
        torch.cuda.synchronize(d)


class phase_timer:
    """Wall-clock timer that waits for the devices of `sync_value`'s tensors
    before and after the phase; `elapsed` is in seconds."""

    def __init__(self, name, sync_value=None, verbose=True):
        self.name = name
        self.sync_value = sync_value
        self.verbose = verbose

    def __enter__(self):
        _sync(self.sync_value)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.sync_value)
        self.elapsed = time.perf_counter() - self.t0
        if self.verbose:
            print(f"[timer] {self.name}: {self.elapsed*1000:.2f} ms")


def timeit(fn, *args, reps=20, warmup=1):
    """Mean seconds per call of `fn(*args)` over `reps` calls, after `warmup`
    calls, with the devices of the output synchronised after the warm-up and
    after the reps. (The JAX module's docstring says median; its code, and
    this one, return the mean.)"""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / reps
