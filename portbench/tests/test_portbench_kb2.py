"""Tiny CPU runs of the KungfuBot2 teacher's cell through the same entries as
the chip run: a sound run is correct, the control (the reference in TF32 in
the program's place) is not, and neither is a run with any fault of its loop
planted; a traced run reports every per-layer metric of the cell but the
roofline. The limits are the committed ones."""
import pytest

from portbench.harness import Cell, run_cell

NAME = "kb2-teacher-train"


def _tiny(cell, envs=16, steps=3):
    cell.config["num_envs"], cell.config["num_steps_per_env"] = envs, steps
    return [f"algo.config.num_steps_per_env={steps}"]


def _run(seed, trace=False, **kw):
    cell = Cell(NAME)
    return cell, run_cell(cell, seed, 0.3, trace, "cpu", overrides=_tiny(cell), **kw)


def test_sound_run_is_correct_and_the_control_is_not():
    cell, out = _run(2**31 + 11, control=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    failing = [k for k, v in out["control"].items() if k in cell.limits and v > cell.limits[k]]
    assert failing, (out["control"], cell.limits)


@pytest.mark.parametrize("fault", list(Cell(NAME).loop().FAULTS))
def test_each_fault_is_not_correct(fault):
    cell = Cell(NAME)
    _, out = _run(5, plant=cell.loop().FAULTS[fault])
    assert not out["correct"], out["checks"]


def test_traced_run_reports_per_layer_metrics():
    cell, out = _run(7, trace=True)
    assert out["correct"]
    want = {m["name"] for m in cell.per_layer if "roofline" not in m["name"]}
    assert set(out["metrics"]) == want


def test_a_configuration_the_program_does_not_run_raises():
    cell = Cell(NAME)
    cell.config["actor"]["motion_encoder"]["channels"] = [40, 21]
    with pytest.raises(ValueError, match="motion_encoder"):
        run_cell(cell, 3, 0.3, False, "cpu", overrides=_tiny(cell))


@pytest.mark.cuda
def test_chip_run_is_correct(card):
    """The chip's short run of the cell (`python -m pytest -m cuda portbench/tests`)."""
    out = run_cell(Cell(NAME), 17, 5.0, False, "cuda")
    assert out["correct"], out["checks"]
