"""The deploy chain on the card: the committed KungfuBot2 student served on the
H100 with env 0's deploy inputs rebuilt on the host and run by both host
executors of its export (`chip_smoke.py` phase deploy, at N = 128).

This file imports no JAX, so it runs on the machine with the card:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda_deploy.py
Without a card every test here skips.

Tolerances (chip_smoke.py's): the deploy inputs against the env's row 0
2e-4 (tests/test_student_obs.py); each host executor against the torch
student on the card on the same inputs, and the side-kick's host executors
against its actor on the card, 1e-4.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
N = 128
STEPS = 20


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the deploy chain's env runs the CUDA contact kernel")
    from pbhc_tpu_torch.eval.batch_eval import set_precision

    set_precision()
    return torch.device("cuda")


@pytest.fixture
def chip_smoke():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


@pytest.mark.cuda
def test_student_deploy_chain_on_the_card(cuda_device, chip_smoke, tmp_path):
    from pbhc_tpu_torch.deploy import export
    from pbhc_tpu_torch.eval import batch_eval
    from pbhc_tpu_torch.sim import contact_kernel as ck

    onnx = export.main(["student", str(REPO / chip_smoke.STUDENT_CKPT), str(tmp_path / "student.onnx")])
    env, net, _ = batch_eval.load(REPO / chip_smoke.STUDENT_CKPT, N, chip_smoke.STUDENT_OFF, device=cuda_device)
    before = ck.apgd_lanes.launches
    res = chip_smoke.student_deploy_chain(torch, env, net, onnx, STEPS)
    torch.cuda.synchronize()
    assert ck.apgd_lanes.launches - before == 4 * STEPS
    assert res["compared"] == STEPS, res
    for k, v in res.items():
        if k.startswith("obs_"):
            assert v <= chip_smoke.DEPLOY_OBS_ATOL, (k, v)
        elif k.startswith("exec_"):
            assert v <= chip_smoke.DEPLOY_ACT_ATOL, (k, v)


@pytest.mark.cuda
def test_side_kick_host_executors_match_the_card(cuda_device, tmp_path):
    from pbhc_tpu_torch.deploy.export import export_policy
    from pbhc_tpu_torch.deploy.native import NativePolicy
    from pbhc_tpu_torch.deploy.onnx_numpy import OnnxPolicy
    from pbhc_tpu_torch.eval import batch_eval
    from pbhc_tpu_torch.utils.checkpoint import load_checkpoint_payload

    ckpt = REPO / "artifacts" / "kb1_side_kick" / "ckpt" / "model_10500.pkl"
    env, actor, _ = batch_eval.load(ckpt, 64, device=cuda_device)
    npz = export_policy(actor, load_checkpoint_payload(ckpt)["actor_params"], env, tmp_path / "p.npz")
    state, obs = batch_eval.start_episodes(env)
    with torch.no_grad():
        state, obs, _, _, _ = env.step(state, actor(obs["actor_obs"])[0])
        mean = actor(obs["actor_obs"])[0].cpu().numpy()
    host_obs = obs["actor_obs"].cpu().numpy()
    for pol in (NativePolicy(npz), OnnxPolicy(npz.with_suffix(".onnx"))):
        np.testing.assert_allclose(pol(host_obs), mean, atol=1e-4)
