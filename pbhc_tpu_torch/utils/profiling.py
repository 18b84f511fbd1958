"""Profiling helpers (counterpart of `pbhc_tpu/utils/profiling.py`), and
the program's own spans.

    with trace("build/trace"):               # a Chrome trace: chrome://tracing or Perfetto
        ... work ...

    with phase_timer("rollout", state) as t: ...   # wall time with device sync

    with span("env.rewards"): ...            # a named stage, recorded under a profiler

`span` records only while a `torch.profiler` session runs: it then puts a
range of its name on the profiler's timeline, beside the ops and kernels it
encloses, and keeps a record of the span (name, parent, host start and end,
host syncs counted in it) in memory; `sessions()` returns the records of the
last `KEEP_SESSIONS` profiler sessions. With no profiler running it returns
one shared no-op context.
"""
from __future__ import annotations

import collections
import contextlib
import time
import warnings
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


# ---------------------------------------------------------------- spans
KEEP_SESSIONS = 8
# what CUDA's sync debug mode "warn" says of each synchronising operation
SYNC_WARNING = "called a synchronizing CUDA operation"


class SpanRecord:
    """One recorded span: `parent` is the index of the enclosing span in the
    same session (None at the top); times are host `perf_counter_ns`;
    `syncs` counts the synchronising CUDA operations run while this was the
    innermost open span."""

    __slots__ = ("name", "parent", "start_ns", "end_ns", "syncs")

    def __init__(self, name, parent):
        self.name, self.parent, self.start_ns, self.end_ns, self.syncs = name, parent, None, None, 0

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _Tracer:
    """The process's span records: the kept sessions, the recording spans
    open now as (session, index), innermost last, and whether the latest
    span opened recorded."""

    def __init__(self):
        self.sessions = collections.deque(maxlen=KEEP_SESSIONS)
        self.open = []
        self.recorded = False


_tracer = _Tracer()
_OFF = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled
# a CPU-op range, as the ops themselves are: a user annotation
# (`torch.profiler.record_function`) would also put a copy of the range on
# the device's timeline, among the kernels
_Range = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A context for the stage `name`: recorded while a profiler runs, else
    the shared no-op context. A session of records starts when a recording
    span opens after a span that did not record."""
    if not _profiling():
        _tracer.recorded = False
        return _OFF
    if not _tracer.recorded:
        _tracer.sessions.append([])
        _tracer.recorded = True
    return _Span(name)


def sessions() -> list:
    """The records of the kept sessions, oldest first: each a list of
    `SpanRecord`s in the order the spans opened."""
    return list(_tracer.sessions)


def totals(records) -> dict:
    """{name: {"count", "seconds", "syncs"}} over `records`: the spans of a
    name, their host seconds summed, and the syncs counted in them."""
    out = {}
    for r in records:
        t = out.setdefault(r.name, {"count": 0, "seconds": 0.0, "syncs": 0})
        t["count"] += 1
        t["seconds"] += r.seconds
        t["syncs"] += r.syncs
    return out


def root_of(records, i: int) -> str:
    """The name of the outermost span enclosing record `i` (itself at the top)."""
    while records[i].parent is not None:
        i = records[i].parent
    return records[i].name


class _SyncCounter:
    """While the outermost recording span is open: CUDA's sync debug mode set
    to "warn" where CUDA is initialised (the previous mode restored after),
    and each of its warnings counted against the innermost open span; every
    other warning goes on as it was."""

    def __enter__(self):
        self.catch = warnings.catch_warnings()
        self.catch.__enter__()
        warnings.filterwarnings("always", message=".*" + SYNC_WARNING)
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if SYNC_WARNING in str(message) and _tracer.open:
                session, i = _tracer.open[-1]
                session[i].syncs += 1
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        self.mode = None
        if torch.cuda.is_initialized():
            self.mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        if self.mode is not None:
            torch.cuda.set_sync_debug_mode(self.mode)
        self.catch.__exit__(*exc)


class _Span:
    __slots__ = ("range", "counter", "entry")

    def __init__(self, name):
        session, opened = _tracer.sessions[-1], _tracer.open
        parent = opened[-1][1] if opened and opened[-1][0] is session else None
        session.append(SpanRecord(name, parent))
        self.entry, self.range, self.counter = (session, len(session) - 1), _Range(name), None

    def __enter__(self):
        if not _tracer.open:
            self.counter = _SyncCounter().__enter__()
        _tracer.open.append(self.entry)
        self.range.__enter__()
        session, i = self.entry
        session[i].start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        session, i = self.entry
        session[i].end_ns = time.perf_counter_ns()
        self.range.__exit__(*exc)
        _tracer.open.pop()
        if self.counter is not None:
            self.counter.__exit__(*exc)
