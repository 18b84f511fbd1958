"""The work counts against hand counts at the committed shapes, and the
readers that refuse a share that cannot be."""
import pytest

from portbench.counts import work
from portbench.harness import Cell
from portbench.readers import p95, share


def test_apgd_lanes_bytes_at_r12():
    R, N = 12, 4096
    A = 36 * 36 * 4096 * 4
    assert A == 21_233_664
    vectors = 3 * (36 * 4096 * 4)          # b, x0, the output
    assert work.apgd_lanes_bytes(R, N) == A + vectors + 4096 * 4 + 12 * 4096 * 4
    assert work.apgd_lanes_bound_s(R, N, 16) == pytest.approx(6.93e-6, rel=2e-3)


def test_apgd_lanes_flops_at_r12():
    assert work.apgd_lanes_flops(12, 4096, 16) == 16 * 2 * 36 * 36 * 4096


def test_kb1_policy_macs():
    c = Cell("kb1-train").config
    actor = 380 * 512 + 512 * 256 + 256 * 128 + 128 * 23
    critic = 630 * 768 + 768 * 512 + 512 * 128 + 128 * 21
    net = work.networks(c)
    assert net.rollout_macs(c) == net.update_macs(c) == actor + critic == 1_306_624
    assert net.serve_macs(c) == actor == 361_344


def test_kb1_iteration_and_step_flops():
    c = Cell("kb1-train").config
    fwd = 2 * 1_306_624
    solves = 24 * 4 * 16 * 2 * 36 * 36 * 4096
    assert work.train_iteration_flops(c) == 98_304 * fwd * (1 + 5 * 3) + solves
    assert work.train_iteration_flops(c) == pytest.approx(4.125e12, rel=1e-3)
    assert work.serve_step_flops(c) == 2 * 361_344 * 4096 + 4 * 16 * 2 * 36 * 36 * 4096


@pytest.mark.parametrize("value", [0.0, -1.0, 105.01, float("nan")])
def test_share_refuses_what_cannot_be(value):
    with pytest.raises(ValueError):
        share(value, "x")


def test_share_passes_a_share():
    assert share(23.1, "x") == 23.1


def test_p95_nearest_rank():
    assert p95(range(1, 201)) == 190
    assert p95([5.0]) == 5.0
