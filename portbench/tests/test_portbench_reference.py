"""The env step's plain reference works out the program's tables again from
the robot description and the run's config: held equal here, on the CPU, to
what the program builds at set-up."""
import numpy as np
import pytest
import torch

from portbench.harness import Cell
from portbench.reference import engine, robot


@pytest.fixture(scope="module")
def both():
    from pbhc_tpu_torch.eval import batch_eval

    cell = Cell("kb1-serve")
    env, _, _ = batch_eval.load(cell.root / cell.config["checkpoint"], 4, device="cpu")
    ref = cell.references("cpu")["step"]
    return env, ref


def test_robot_tables_match_the_program(both):
    env, ref = both
    m, tb = env.sim_model, ref.engine.tb
    assert tb["names"] == list(m.body_names) and tb["dof_names"] == list(m.dof_names)
    for key, prog in (("parent", m.parent), ("local_pos", m.local_pos), ("local_quat", m.local_quat),
                      ("dof_body", m.dof_body), ("dof_axis", m.dof_axis), ("dof_limits", m.dof_limits),
                      ("contact_body", m.contact_body), ("contact_pos", m.contact_pos),
                      ("contact_radius", m.contact_radius), ("pairs", m.contact_pairs)):
        np.testing.assert_array_equal(np.asarray(tb[key]), np.asarray(prog), err_msg=key)


def test_engine_options_and_gains_match_the_program(both):
    env, ref = both
    opt = env.lanes_engine.opt
    for key, value in ref.engine.opt.items():
        assert getattr(opt, key) == value, key
    assert ref.engine.decimation == env.decimation and ref.dt == pytest.approx(env.dt)
    for name in ("p_gains", "d_gains", "action_scales", "torque_limits", "dof_vel_limits"):
        assert torch.equal(getattr(ref, name), getattr(env, name)), name
    assert list(ref.feet) == list(env.feet_indices) and list(ref.penalised) == list(env.penalised_contact_indices)
    assert ref.columns == env.reward_names


def test_quaternion_helpers_round_trip():
    q = torch.nn.functional.normalize(torch.randn(64, 4, generator=torch.Generator().manual_seed(3)), dim=-1)
    q = torch.where(q[:, 3:] < 0, -q, q)
    torch.testing.assert_close(engine.matrix_to_quat(engine.quat_to_matrix(q)), q, atol=2e-6, rtol=0)
    assert robot.tables(Cell("kb1-serve").root, "g1_23dof_lock_wrist")["pairs"].shape == (17, 2)
