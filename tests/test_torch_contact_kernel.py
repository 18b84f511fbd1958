"""Kernel 1 (env-last APGD contact solve): its plain PyTorch version against
`LanesEngine._apgd` and the Pallas kernel in interpret mode.

Inputs: random SPD Delassus matrices (as tests/test_pallas_contact.py builds
them), N = 128 envs, R = 12 rows (the slice's active-set size), a warm start
and about 30% inactive rows. Tolerance atol 1e-4, the repo's own kernel
bound (test_pallas_contact.py::test_lanes_kernel_matches_xla_apgd). The
CUDA kernel itself is held against the plain version in
tests/test_torch_cuda_kernel.py, which runs on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pbhc_tpu.model.g1 import load_g1_sim_model  # noqa: E402
from pbhc_tpu.sim.engine import Engine, EngineOptions  # noqa: E402
from pbhc_tpu.sim.engine_lanes import LanesEngine  # noqa: E402
from pbhc_tpu.sim.pallas_contact import solve_contacts_pallas_lanes  # noqa: E402
from pbhc_tpu_torch.sim import contact_kernel as ck  # noqa: E402

ATOL = 1e-4
R, N = 12, 128


def _problem(seed, warm=True):
    rng = np.random.default_rng(seed)
    n = 3 * R
    J = (rng.normal(size=(n, 40, N)) * 0.3).astype(np.float32)
    A = (np.einsum("ivn,jvn->ijn", J, J) + 1e-2 * np.eye(n)[:, :, None]).astype(np.float32)
    b = rng.normal(size=(n, N)).astype(np.float32)
    mu = rng.uniform(0.2, 1.2, size=N).astype(np.float32)
    active = (rng.uniform(size=(R, N)) > 0.3).astype(np.float32)
    x0 = (rng.uniform(size=(n, N)) * (0.5 if warm else 0.0)).astype(np.float32)
    return A, b, mu, active, x0


def _jax_lanes(iters):
    return LanesEngine(Engine(load_g1_sim_model("g1_23dof_lock_wrist"), EngineOptions(solver_iters=iters)))


@pytest.mark.parametrize("iters", [16, 32])
@pytest.mark.parametrize("warm", [True, False])
def test_plain_matches_xla_apgd(iters, warm):
    A, b, mu, active, x0 = _problem(iters + warm, warm)
    ref = _jax_lanes(iters)._apgd(*map(jnp.asarray, (A, b, mu, active)), x0=jnp.asarray(x0))
    out = ck.apgd_lanes_plain(*map(torch.as_tensor, (A, b, mu, active, x0)), iters=iters)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("iters", [16, 32])
def test_plain_matches_pallas_interpret(iters):
    A, b, mu, active, x0 = _problem(100 + iters)
    ref = solve_contacts_pallas_lanes(*map(jnp.asarray, (A, b, mu, active)), iters=iters,
                                      interpret=True, x0=jnp.asarray(x0))
    out = ck.apgd_lanes_plain(*map(torch.as_tensor, (A, b, mu, active, x0)), iters=iters)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    args = list(map(torch.as_tensor, _problem(7)))
    before = ck.apgd_lanes.launches
    out = ck.apgd_lanes(*args, iters=16)
    assert torch.equal(out, ck.apgd_lanes_plain(*args, iters=16))
    assert ck.apgd_lanes.launches == before


def test_solution_is_feasible():
    A, b, mu, active, x0 = map(torch.as_tensor, _problem(8))
    lam = ck.apgd_lanes_plain(A, b, mu, active, x0, iters=32).reshape(R, 3, N)
    assert (lam[:, 2] >= 0).all()
    tn = torch.sqrt(lam[:, 0] ** 2 + lam[:, 1] ** 2)
    assert (tn <= mu[None] * lam[:, 2] * (1 + 1e-5) + 1e-7).all()
    assert (lam.permute(0, 2, 1)[active == 0] == 0).all()


@pytest.mark.parametrize("bad", ["dtype", "shape"])
def test_wrapper_rejects_bad_input(bad):
    A, b, mu, active, x0 = map(torch.as_tensor, _problem(9))
    if bad == "dtype":
        with pytest.raises(TypeError, match="float32"):
            ck.apgd_lanes(A.double(), b, mu, active, x0, iters=4)
    else:
        with pytest.raises(ValueError, match="shape"):
            ck.apgd_lanes(A[:-1], b, mu, active, x0, iters=4)



@pytest.mark.parametrize("kernel", ["apgd_lanes", "apgd_envfirst"])
def test_tile_sweep_entry_raises_on_cpu(kernel):
    # the tile-sweep entries launch a kernel or raise: they have no CPU version
    A, b, mu, active, x0 = map(torch.as_tensor, _problem(10))
    if kernel == "apgd_lanes":
        call = lambda: ck.apgd_lanes_at_tile(A, b, mu, active, x0, 4, 8, 1)
    else:
        call = lambda: ck.apgd_envfirst_at_tile(A.permute(2, 0, 1), b.T, mu, active.T, 4, 8, 1)
    with pytest.raises(ValueError, match="no implementation for device cpu"):
        call()
