"""The readers of the program's spans read their own run: two traced runs of
one cell in one process each read the sessions of records of their own
profiled slices (the last sessions, one a slice, in order)."""
import pytest
from conftest import tiny

from pbhc_tpu_torch.utils import profiling
from portbench.harness import Cell, run_cell

# the session of records of each cell's env-step slice, counted from the last
ROLLOUT = {"kb1-serve": -1, "kb1-train": -2}


@pytest.mark.parametrize("name", sorted(ROLLOUT))
def test_two_traced_runs_read_their_own_sessions(name):
    metric = f"env_step_host_ms.{name.split('-')[1]}"
    seen = []
    for steps in (2, 1):
        cell = Cell(name)
        overrides = tiny(cell)
        cell.traffic["profile_steps"] = steps
        out = run_cell(cell, 2**31 + 3, 0.3, True, "cpu", overrides=overrides)
        records = profiling.sessions()[ROLLOUT[name]]
        seen.append(records)
        step = [r for r in records if r.name == "env.step"]
        assert len(step) == steps
        want = 1e3 * sum(r.seconds for r in step) / steps
        assert out["metrics"][metric]["value"] == pytest.approx(want, rel=1e-12)
        if name == "kb1-train":
            assert profiling.sessions()[-1][0].name == "learner.update"
            assert out["metrics"]["host_syncs_per_iter.train"]["value"] == 0
        else:
            assert out["metrics"]["host_syncs_per_step.serve"]["value"] == 0
    assert seen[0] is not seen[1]
