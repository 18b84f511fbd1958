"""Port parity: the simulator facade (`sim/simulator.py`, `EngineSimulator`)
against the JAX package's `TpuSimulator` on the CPU, with
tests/test_simulator_facade.py's contract: tensor shapes and body names,
the state setters, and a lock-step free fall; then a few steps standing on
the ground, where the contact solve acts. 2 envs, the engine's default
options (APGD over every contact row, 32 iterations).

Tolerances: the setters exactly; the free fall (no contact) 1e-5 on
positions and 1e-4 on velocities over 10 physics steps; standing (contacts
solved) tests/test_torch_engine_perenv.py's 1e-4 over 5 steps.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pbhc_tpu.model.g1 import load_g1_sim_model as jax_sim_model  # noqa: E402
from pbhc_tpu.sim.engine import Engine as JaxEngine  # noqa: E402
from pbhc_tpu.sim.simulator import TpuSimulator  # noqa: E402
from pbhc_tpu_torch.model.g1 import load_g1_sim_model  # noqa: E402
from pbhc_tpu_torch.sim.engine import Engine, EngineOptions  # noqa: E402
from pbhc_tpu_torch.sim.simulator import BaseSimulator, EngineSimulator  # noqa: E402


@pytest.fixture
def sims():
    return (TpuSimulator(JaxEngine(jax_sim_model()), num_envs=2),
            EngineSimulator(Engine(load_g1_sim_model(), EngineOptions(), device="cpu"), num_envs=2))


def _pose(z, dof=0.1):
    rs = np.zeros((2, 13), dtype=np.float32)
    rs[:, 2] = z
    rs[:, 6] = 1.0                                      # unit quaternion, xyzw
    rs[1, 7] = 0.3
    return rs, np.full((2, 23), dof, dtype=np.float32)


def test_contract_shapes(sims):
    jsim, tsim = sims
    assert isinstance(tsim, BaseSimulator)
    assert tuple(tsim.robot_root_states.shape) == tuple(jsim.robot_root_states.shape) == (2, 13)
    assert tuple(tsim._rigid_body_pos.shape) == (2, 24, 3) and tuple(tsim.contact_forces.shape) == (2, 24, 3)
    assert tuple(tsim.dof_pos.shape) == (2, 23)
    assert tsim._body_list == jsim._body_list
    assert tsim.find_rigid_body_indice("torso_link") == jsim.find_rigid_body_indice("torso_link")
    np.testing.assert_allclose(tsim._rigid_body_pos.numpy(), np.asarray(jsim._rigid_body_pos), atol=1e-6)


def test_state_setters_roundtrip(sims):
    jsim, tsim = sims
    rs, dof = _pose(1.5)
    for sim in sims:
        sim.set_actor_root_state_tensor([1], rs)
        sim.set_dof_state_tensor([1], dof, -dof)
        sim.refresh_sim_tensors()
    np.testing.assert_array_equal(tsim.robot_root_states.numpy(), np.asarray(jsim.robot_root_states))
    np.testing.assert_array_equal(tsim.robot_root_states[1].numpy(), rs[1])
    assert float(tsim.robot_root_states[0, 2]) != 1.5            # env 0 untouched
    np.testing.assert_array_equal(tsim.dof_vel.numpy(), np.asarray(jsim.dof_vel))
    np.testing.assert_allclose(tsim._rigid_body_pos.numpy(), np.asarray(jsim._rigid_body_pos), atol=1e-5)


@pytest.mark.parametrize("z,steps", [(5.0, 10), (0.793, 5)])
def test_lockstep_matches_tpu_simulator(sims, z, steps):
    """Zero torque from the same pose: a free fall (z = 5 m, no contact), and
    standing (z = 0.793 m, the soles on the ground)."""
    jsim, tsim = sims
    rs, dof = _pose(z, 0.0 if z < 1 else 0.1)
    for sim in sims:
        sim.set_actor_root_state_tensor([0, 1], rs)
        sim.set_dof_state_tensor([0, 1], dof, np.zeros_like(dof))
    tau = np.zeros((2, 23), dtype=np.float32)
    for _ in range(steps):
        for sim in sims:
            sim.apply_torques_at_dof(tau)
            sim.simulate_at_each_physics_step()
    for sim in sims:
        sim.refresh_sim_tensors()
    lam = np.asarray(jsim._lam)
    assert (np.abs(lam).max() > 1e-3) == (z < 1)                # contacts only when standing
    np.testing.assert_allclose(tsim._lam.numpy(), lam, atol=1e-4)
    pos_tol = 1e-5 if z > 1 else 1e-4
    np.testing.assert_allclose(tsim.robot_root_states[:, :7].numpy(), np.asarray(jsim.robot_root_states[:, :7]),
                               atol=pos_tol)
    np.testing.assert_allclose(tsim.robot_root_states[:, 7:].numpy(), np.asarray(jsim.robot_root_states[:, 7:]),
                               atol=1e-4)
    np.testing.assert_allclose(tsim.dof_pos.numpy(), np.asarray(jsim.dof_pos), atol=pos_tol)
    np.testing.assert_allclose(tsim.dof_vel.numpy(), np.asarray(jsim.dof_vel), atol=1e-4)
    np.testing.assert_allclose(tsim._rigid_body_pos.numpy(), np.asarray(jsim._rigid_body_pos), atol=pos_tol)
