"""Port parity: the profiling helpers (`trace`, `phase_timer`, `timeit`)
against `pbhc_tpu.utils.profiling`.

Both modules read `time.perf_counter`; the tests replace it in both with one
fake clock that the timed function advances, so the two return the same
numbers exactly. `timeit` returns the mean over the reps (the JAX docstring
says median; its code computes the mean).
"""
import json

import pytest
import torch

torch.set_num_threads(2)

from pbhc_tpu.utils import profiling as jprof  # noqa: E402
from pbhc_tpu_torch.utils import profiling as tprof  # noqa: E402


class FakeClock:
    def __init__(self, ticks):
        self.now, self.ticks = 0.0, list(ticks)

    def __call__(self):
        return self.now

    def work(self, *args):
        self.now += self.ticks.pop(0)
        return torch.ones(2)


@pytest.mark.parametrize("module", [jprof, tprof], ids=["jax", "port"])
def test_timeit_returns_the_mean(module, monkeypatch):
    # one warm-up call of 5 s, then reps of 1, 1, 1, 9 s: mean 3, median 1
    clock = FakeClock([5.0, 1.0, 1.0, 1.0, 9.0])
    monkeypatch.setattr(module.time, "perf_counter", clock)
    assert module.timeit(clock.work, reps=4, warmup=1) == 3.0


@pytest.mark.parametrize("module", [jprof, tprof], ids=["jax", "port"])
def test_phase_timer_sets_elapsed(module, monkeypatch, capsys):
    clock = FakeClock([0.25])
    monkeypatch.setattr(module.time, "perf_counter", clock)
    with module.phase_timer("rollout", sync_value=torch.zeros(3) if module is tprof else None) as t:
        clock.work()
    assert t.elapsed == 0.25
    assert capsys.readouterr().out == "[timer] rollout: 250.00 ms\n"
    with module.phase_timer("quiet", verbose=False) as t:
        pass
    assert t.elapsed == 0.0 and capsys.readouterr().out == ""


def test_phase_timer_syncs_only_cuda_tensors(monkeypatch):
    """CPU tensors (nested in dicts, lists and dataclasses) need no wait:
    `torch.cuda.synchronize` is not called for them."""
    calls = []
    monkeypatch.setattr(tprof.torch.cuda, "synchronize", lambda d=None: calls.append(d))
    with tprof.phase_timer("cpu", {"a": [torch.zeros(1)], "b": (torch.ones(1),)}, verbose=False):
        pass
    assert calls == []


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(tmp_path / "trace"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    out = tmp_path / "trace" / "trace.json"
    events = json.loads(out.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
