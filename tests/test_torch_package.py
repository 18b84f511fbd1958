"""Port parity: the motion packager (`merge`, `info`, `compute_contact_mask`
and its CLI) against `pbhc_tpu.motion.package`.

The port writes a merged library without joblib (a plain pickle through
zlib at level 3). Both directions must hold exactly: JAX's `joblib.load`
reads the port's library, the port's reader reads JAX's, and the two
libraries are equal once loaded (keys in order, the `<stem>__<key>` renaming
on a collision, arrays and dtypes bit for bit).
"""
from pathlib import Path

import joblib
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pbhc_tpu.motion import package as jpkg  # noqa: E402
from pbhc_tpu_torch.motion import package as tpkg  # noqa: E402
from pbhc_tpu_torch.motion.motion_lib import load_joblib  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
M = REPO / "assets" / "motions"
# the suite's config 4 library; the side kick twice forces a key collision
INPUTS = [M / "Horse-stance_pose.pkl", M / "Horse-stance_punch.pkl", M / "Side_kick.pkl", M / "Side_kick.pkl"]


def _equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    d = tmp_path_factory.mktemp("libs")
    return jpkg.merge(d / "jax.pkl", INPUTS), tpkg.merge(d / "port.pkl", INPUTS)


def test_merge_round_trips_both_ways(libs):
    jax_lib, port_lib = libs
    want = joblib.load(jax_lib)
    assert len(want) == 4 and list(want)[-1].startswith("Side_kick__")
    _equal(want, joblib.load(port_lib))          # JAX's reader on the port's library
    _equal(want, load_joblib(jax_lib))           # the port's reader on JAX's library
    _equal(want, load_joblib(port_lib))
    assert Path(port_lib).read_bytes()[:1] == b"\x78"     # zlib, as joblib's compress=3


def test_info_matches_jax(libs):
    jax_lib, port_lib = libs
    want = jpkg.info(jax_lib)
    assert tpkg.info(port_lib) == want == tpkg.info(jax_lib)
    assert [r[1] for r in want] == [210, 200, 179, 179]


def test_cli_matches_jax(libs, tmp_path, capsys):
    jpkg.main(["merge", str(tmp_path / "j.pkl"), *map(str, INPUTS[:2])])
    jax_out = capsys.readouterr().out
    tpkg.main(["merge", str(tmp_path / "t.pkl"), *map(str, INPUTS[:2])])
    assert capsys.readouterr().out == jax_out.replace("j.pkl", "t.pkl")
    jpkg.main(["info", str(libs[0])])
    jax_out = capsys.readouterr().out
    tpkg.main(["info", str(libs[1])])
    assert capsys.readouterr().out == jax_out
    with pytest.raises(SystemExit, match="unknown command"):
        tpkg.main(["nope"])


def test_compute_contact_mask_matches_jax():
    rng = np.random.default_rng(0)
    body_pos = np.cumsum(rng.normal(scale=0.01, size=(120, 24, 3)), axis=0)
    body_pos[..., 2] = np.abs(body_pos[..., 2]) * 3
    for feet, fps in (([6, 12], 30), ([5, 11], 50)):
        want = jpkg.compute_contact_mask(body_pos, feet, fps)
        got = tpkg.compute_contact_mask(body_pos, feet, fps)
        assert got.dtype == want.dtype and 0 < got.sum() < got.size
        np.testing.assert_array_equal(got, want)
