"""Port parity: the joblib-free motion reader and the motion library.

The reader must return exactly what `joblib.load` returns for every clip.
`get_motion_state` is compared at fixed ids and times: 2e-5 absolute, since
the libraries' FK runs in f32 in both packages and the velocities are
finite differences divided by the frame time (30 fps). Rotations get 4e-4:
the reference slerp (`rotations.py:239`) returns q0 once the f32 dot product
of two frames rounds to 1, i.e. for frames closer than ~3.5e-4, and an ulp
of FK difference flips that branch, moving the result by at most t*|q1-q0|.
"""
from pathlib import Path

import jax.numpy as jnp
import joblib
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pbhc_tpu.model.g1 import load_g1_motion_model as jax_motion_model  # noqa: E402
from pbhc_tpu.motion import motion_lib as jml  # noqa: E402
from pbhc_tpu_torch.model.g1 import load_g1_motion_model  # noqa: E402
from pbhc_tpu_torch.motion import motion_lib as tml  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
MOTIONS = sorted((REPO / "assets" / "motions").glob("*.pkl"))


def _equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
        assert a.flags["C_CONTIGUOUS"] == b.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert type(a) is type(b) and a == b


@pytest.mark.parametrize("path", MOTIONS, ids=lambda p: p.stem)
def test_reader_matches_joblib(path):
    _equal(joblib.load(path), tml.load_joblib(path))


@pytest.mark.parametrize("clip", ["Side_kick", "Horse-stance_punch"])
def test_get_motion_state_matches_jax(clip, monkeypatch):
    monkeypatch.setenv("PBHC_MOTION_CACHE", "0")   # keep the JAX library off its /tmp cache
    path = str(REPO / "assets" / "motions" / f"{clip}.pkl")
    jlib = jml.MotionLib(path, jax_motion_model(), 8, 0.02)
    tlib = tml.MotionLib(path, load_g1_motion_model(), 8, 0.02, device="cpu")
    for f in ("lengths", "num_frames", "fps"):
        np.testing.assert_allclose(getattr(tlib.data, f).numpy(), np.asarray(getattr(jlib.data, f)), rtol=1e-6)
    L = float(jlib.data.lengths[0])
    times = np.asarray([0.0, 0.013, 0.5, 1.234, 0.5 * L, L - 0.01, L, L + 0.3], np.float32)
    ids = np.zeros(len(times), np.int64)
    ref = jml.get_motion_state(jlib.data, jnp.asarray(ids, jnp.int32), jnp.asarray(times))
    out = tml.get_motion_state(tlib.data, torch.as_tensor(ids), torch.as_tensor(times))
    assert set(out) == set(ref)
    for k in ref:
        atol = 4e-4 if k in ("root_rot", "rb_rot", "rg_rot_t") else 2e-5
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=atol, err_msg=k)
    assert tml.motion_length(tlib.data, torch.as_tensor(ids[:1])).item() == pytest.approx(L, rel=1e-6)


def test_fix_height_shifts_like_jax(monkeypatch):
    monkeypatch.setenv("PBHC_MOTION_CACHE", "0")
    path = str(REPO / "assets" / "motions" / "Side_kick.pkl")
    jlib = jml.MotionLib(path, jax_motion_model(), 4, 0.02, fix_height="full_fix")
    tlib = tml.MotionLib(path, load_g1_motion_model(), 4, 0.02, fix_height="full_fix", device="cpu")
    np.testing.assert_allclose(tlib.data.gts.numpy(), np.asarray(jlib.data.gts), atol=2e-5)
