"""Kernel 1's CUDA kernel against its plain PyTorch version, on the card.

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
                                       (36, 256, 8)])
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
