"""The CUDA contact kernels against their plain PyTorch versions, on the card.

This file imports no JAX, so it runs on the machine with the card, where the
repo's conftest (which imports JAX) must be skipped:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernel.py
Without a card every test here skips.

Tolerance atol 1e-4 (the repo's kernel-parity bound): the kernel and the plain
version sum the matvecs in different orders and the kernel fuses multiply-adds.
"""
import numpy as np
import pytest
import torch

from pbhc_tpu_torch.sim import contact_kernel as ck

ATOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _problem(R, N, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    n = 3 * R
    J = torch.randn((n, 40, N), generator=g, device=device) * 0.3
    A = (torch.einsum("ivn,jvn->ijn", J, J) + 1e-2 * torch.eye(n, device=device)[:, :, None]).contiguous()
    b = torch.randn((n, N), generator=g, device=device)
    mu = 0.2 + torch.rand((N,), generator=g, device=device)
    active = (torch.rand((R, N), generator=g, device=device) > 0.3).float()
    x0 = torch.rand((n, N), generator=g, device=device) * 0.5
    return A, b, mu, active, x0


@pytest.mark.cuda
@pytest.mark.parametrize("R,N,iters", [(12, 4096, 16), (12, 128, 32), (1, 50, 16), (17, 1000, 16),
                                       (36, 256, 8), (38, 4096, 16), (38, 1001, 16), (42, 4096, 16),
                                       (42, 333, 8), (21, 4093, 16)])
def test_kernel_matches_plain(cuda_device, R, N, iters):
    args = _problem(R, N, R + N, cuda_device)
    before = ck.apgd_lanes.launches
    out = ck.apgd_lanes(*args, iters=iters)
    ref = ck.apgd_lanes_plain(*args, iters=iters)
    torch.cuda.synchronize()
    assert ck.apgd_lanes.launches == before + 1
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=ATOL)


@pytest.mark.cuda
def test_kernel_refuses_too_many_rows(cuda_device):
    R = ck._library().apgd_lanes_max_rows() + 1
    with pytest.raises(ValueError, match="at most"):
        ck.apgd_lanes(*_problem(R, 32, 0, cuda_device), iters=4)


@pytest.mark.cuda
def test_kernel_takes_every_row_of_the_g1_models(cuda_device):
    # contact_cap 0 gives R = 38 (21 spheres + 17 pairs); n = 3R <= 128
    assert ck._library().apgd_lanes_max_rows() >= 42


@pytest.mark.cuda
def test_tile_at_the_paths_row_counts(cuda_device):
    # R = 12: the committed configs (8 ground + 4 pair rows); R = 38: contact_cap 0
    assert [ck.tile("apgd_lanes", R) for R in (12, 38)] == [(8, 1), (4, 2)]
    assert [ck.tile("apgd_envfirst", R) for R in (12, 38)] == [(8, 1), (1, 4)]


def _envfirst_problem(R, N, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    n = 3 * R
    J = torch.randn((N, n, 40), generator=g, device=device) * 0.3
    A = (J @ J.transpose(1, 2) + 1e-2 * torch.eye(n, device=device)).contiguous()
    b = torch.randn((N, n), generator=g, device=device)
    mu = 0.2 + torch.rand((N,), generator=g, device=device)
    active = (torch.rand((N, R), generator=g, device=device) > 0.3).float()
    return A, b, mu, active


@pytest.mark.cuda
@pytest.mark.parametrize("R,N,iters", [(12, 4096, 16), (38, 4096, 16), (12, 128, 32), (1, 50, 16),
                                       (11, 1000, 16), (42, 64, 8), (21, 777, 16), (38, 1001, 16)])
def test_envfirst_kernel_matches_plain(cuda_device, R, N, iters):
    args = _envfirst_problem(R, N, R + N, cuda_device)
    before = ck.apgd_envfirst.launches
    out = ck.apgd_envfirst(*args, iters=iters)
    ref = ck.apgd_envfirst_plain(*args, iters=iters)
    torch.cuda.synchronize()
    assert ck.apgd_envfirst.launches == before + 1
    assert out.shape == (N, R, 3) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=ATOL)


@pytest.mark.cuda
def test_envfirst_kernel_refuses_too_many_rows(cuda_device):
    R = ck._envfirst_library().apgd_envfirst_max_rows() + 1
    with pytest.raises(ValueError, match="at most"):
        ck.apgd_envfirst(*_envfirst_problem(R, 32, 0, cuda_device), iters=4)


@pytest.mark.cuda
@pytest.mark.parametrize("R,N", [(12, 1000), (38, 301), (5, 77)])
def test_every_tile_matches_plain(cuda_device, R, N):
    # the launch functions take every tile (E envs, P threads per contact)
    # that fits a block; the kernels pick one per R
    for name, at_tile, plain, args in (
            ("apgd_lanes", ck.apgd_lanes_at_tile, ck.apgd_lanes_plain, _problem(R, N, R, cuda_device)),
            ("apgd_envfirst", ck.apgd_envfirst_at_tile, ck.apgd_envfirst_plain,
             _envfirst_problem(R, N, R, cuda_device))):
        ref = plain(*args, iters=16)
        before = getattr(ck, name).launches
        taken = []
        for E in (1, 2, 4, 8):
            for P in (1, 2, 4):
                try:
                    out = at_tile(*args, 16, E, P)
                except ValueError:  # more threads or shared memory than a block has
                    continue
                taken.append((E, P))
                torch.cuda.synchronize()
                np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=ATOL,
                                           err_msg=f"{name} E={E} P={P}")
        assert ck.tile(name, R) in taken and len(taken) >= 6
        assert getattr(ck, name).launches == before
