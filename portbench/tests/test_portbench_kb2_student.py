"""Tiny CPU runs of the KungfuBot2 student's distillation cell and the
29-DoF teacher's serving cell through the same entries as the chip run: a
sound run is correct, the control (the reference in TF32 in the program's
place) is not, and neither is a run with any fault of its loop planted; a
traced run reports every per-layer metric of the cell that a CPU run can
read. The limits are the committed ones."""
import pytest

from portbench.harness import Cell, run_cell

CELLS = ("kb2-student-distill", "kb2-teacher-serve")


def _tiny(cell, envs=16, steps=3):
    cell.config["num_envs"] = envs
    if cell.traffic["loop"] == "train_distill":
        cell.config["num_steps_per_env"] = steps
        return [f"algo.config.num_steps_per_env={steps}"]
    return []


def _run(name, seed, trace=False, **kw):
    cell = Cell(name)
    return cell, run_cell(cell, seed, 0.3, trace, "cpu", overrides=_tiny(cell), **kw)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_the_control_is_not(name):
    cell, out = _run(name, 2**31 + 11, control=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    failing = [k for k, v in out["control"].items() if k in cell.limits and v > cell.limits[k]]
    assert failing, (out["control"], cell.limits)


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS for f in Cell(c).loop().FAULTS])
def test_each_fault_is_not_correct(name, fault):
    cell = Cell(name)
    _, out = _run(name, 5, plant=cell.loop().FAULTS[fault])
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_per_layer_metrics(name):
    cell, out = _run(name, 7, trace=True)
    assert out["correct"]
    # on the CPU no kernel runs on a device: the rooflines and the kernel's share read nothing
    want = {m["name"] for m in cell.per_layer if "roofline" not in m["name"] and "kernel_share" not in m["name"]}
    assert set(out["metrics"]) == want


def test_the_distillation_history_encoder_stays_the_teachers():
    _, out = _run("kb2-student-distill", 13)
    assert out["checks"]["history_frozen"]["value"] == 0.0


def test_a_configuration_the_program_does_not_run_raises():
    cell = Cell("kb2-student-distill")
    cell.config["teacher"]["actor"]["motion_encoder"]["in"] = 720
    with pytest.raises(ValueError, match="motion_encoder"):
        run_cell(cell, 3, 0.3, False, "cpu", overrides=_tiny(cell))


@pytest.mark.cuda
def test_chip_run_is_correct(card):
    """The chip's short run of each cell (`python -m pytest -m cuda portbench/tests`)."""
    for name in CELLS:
        out = run_cell(Cell(name), 17, 5.0, False, "cuda")
        assert out["correct"], (name, out["checks"])
