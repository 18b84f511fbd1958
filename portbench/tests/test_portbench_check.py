"""Tiny CPU runs of both mixes through the same entries as the chip run: a
sound run is correct, the control (the reference in TF32 in the program's
place) is not, and neither is a run with any fault planted under the timed
path. The limits are the committed ones."""
import pytest
from conftest import tiny

from portbench.harness import Cell, run_cell

CELLS = ("kb1-train", "kb1-serve")


def _run(name, seed, **kw):
    cell = Cell(name)
    return cell, run_cell(cell, seed, 0.3, False, "cpu", overrides=tiny(cell), **kw)


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
    cell = Cell(name)
    out = run_cell(cell, 7, 0.3, True, "cpu", overrides=tiny(cell))
    assert out["correct"]
    # on the CPU no kernel runs on a device: the rooflines read nothing
    want = {m["name"] for m in cell.per_layer if "roofline" not in m["name"]}
    assert set(out["metrics"]) == want
    assert out["device"]["window_s"] > 0 and "breakdown" in out
    assert list(out)[-1] == "checks"


def test_same_seed_same_inputs():
    a = _run("kb1-serve", 123)[1]["checks"]
    b = _run("kb1-serve", 123)[1]["checks"]
    assert a == b


@pytest.mark.cuda
def test_chip_run_is_correct(card):
    """The chip's short run of each cell (run on the card by
    `python -m pytest -m cuda portbench/tests`)."""
    for name in CELLS:
        out = run_cell(Cell(name), 17, 5.0, False, "cuda")
        assert out["correct"], (name, out["checks"])

