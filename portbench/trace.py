"""The traced run's profiler slices and what they are reduced to.

A slice is a short stretch of the loop under `torch.profiler` (CPU and CUDA
activity), bounded so that its trace processes in well under a minute: a few
control steps, or one update. Each is reduced to plain numbers here, and the
per-layer readers (`portbench/metrics/`) read only those.
"""
from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict

import torch

# the CUDA calls (runtime `cuda*`, low-level `cu*`) that launch work on the device
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
            "cudaLaunchCooperativeKernel", "cudaGraphLaunch", "cuGraphLaunch")
TOP = 10
NAME_CHARS = 120
_OP = re.compile(r"\w*(?:Functor|functor)\w*|\w+_kernel_cuda|\w+_kernel_impl")


def short_name(kernel: str) -> str:
    """A kernel's name without its template arguments, which run to
    thousands of characters, but with the innermost functor or kernel
    implementation they name (`elementwise_kernel[MulFunctor]`)."""
    name = kernel.removeprefix("void ")
    head = re.split(r"[<(]", name, maxsplit=1)[0]
    ops = _OP.findall(name[len(head):])
    return (head + (f"[{ops[-1]}]" if ops else ""))[:NAME_CHARS]


class Profiler:
    """Profiled slices, started and stopped by the loop; `slices` holds
    (label, host seconds, profile) for each."""

    def __init__(self, device):
        self.device, self.slices, self._prof = device, [], None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self, label):
        from torch.profiler import ProfilerActivity, profile

        self.stop()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        self._sync()
        self._prof, self._label = profile(activities=acts), label
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self):
        if self._prof is None:
            return
        self._sync()
        wall = time.perf_counter() - self._t0
        self._prof.stop()
        self.slices.append((self._label, wall, self._prof))
        self._prof = None


def _union(intervals):
    """Merged [start, end] intervals of a list sorted by start."""
    out = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_slice(label, wall_s, prof) -> dict:
    """One slice as numbers: its host seconds, the device's busy seconds (the
    union of kernel intervals), the kernels' seconds by name and per launch,
    the host's launch calls, and the device's idle gaps between kernels by
    the innermost host op running when each began."""
    kernels, cpu, launches = [], [], 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((e.time_range.start, e.time_range.end, e.name))
        elif e.name in LAUNCHES:
            launches += 1
        else:
            cpu.append((e.time_range.start, e.time_range.end, e.name))
    kernels.sort()
    merged = _union([[s, e] for s, e, _ in kernels])
    busy_us = sum(e - s for s, e in merged)
    by_name = defaultdict(lambda: [0.0, 0])
    for s, e, name in kernels:
        by_name[name][0] += (e - s) / 1e6
        by_name[name][1] += 1
    cpu.sort()
    starts = [s for s, _, _ in cpu]
    gaps = defaultdict(float)
    for (_, end), (nxt, _) in zip(merged[:-1], merged[1:]):
        # the innermost host op that spans the gap's start: the latest to
        # begin among the last few; none there means Python between ops
        i = bisect.bisect_right(starts, end) - 1
        name = "python"
        for j in range(i, max(i - 64, -1), -1):
            if cpu[j][1] >= end:
                name = cpu[j][2]
                break
        gaps[name] += (nxt - end) / 1e6
    return {"label": label, "wall_s": wall_s, "busy_s": busy_us / 1e6, "launches": launches,
            "kernels": {k: {"seconds": v[0], "count": v[1]} for k, v in by_name.items()},
            "gaps": dict(gaps)}


def reduce_all(profiler: Profiler) -> list:
    return [reduce_slice(*s) for s in profiler.slices]


def breakdown(slices: list) -> dict:
    """The device ops that took most time and the longest idle gaps by what
    the host was doing, over every slice."""
    ops, gaps = defaultdict(float), defaultdict(float)
    for s in slices:
        for k, v in s["kernels"].items():
            ops[short_name(k)] += v["seconds"]
        for k, v in s["gaps"].items():
            gaps[k] += v
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}
