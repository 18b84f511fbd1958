"""SMPL body model: load a user-supplied model file and run LBS (counterpart
of `pbhc_tpu/motion/smpl_model.py`, numpy as there).

The reference's SMPL mesh pipeline delegates to the ``smplx`` package backed
by the licensed SMPL body-model files (reference smpl_vis/utils/
body_model_smpl.py:28-49 ``BodyModelSMPLH``, smpl_vis/smpl_render.py:51-76
``render``; the shape-fit stage reference smpl_retarget/phc_retarget/
fit_smpl_shape.py likewise needs the model's shapedirs/J_regressor).  Those
model files are licensed external assets that cannot ship in this image, so
this module implements the SMPL forward model from scratch (the published
SMPL formulation: shape blendshapes, optional pose blendshapes, joint
regression, linear blend skinning) and activates only when the user drops
their own model file in — exactly how the reference expects users to supply
``body_model/`` assets.

Accepted model formats:
  * the official ``SMPL_*.pkl`` (python-2 pickle with chumpy arrays — loaded
    with a chumpy shim, no chumpy dependency),
  * a plain ``.npz``/``.pkl`` with numpy arrays,
with keys ``v_template`` [V,3], ``J_regressor`` [24,V] (dense or scipy
sparse), ``weights`` [V,24], ``f``/``faces`` [F,3], and optionally
``shapedirs`` [V,3,B] and ``posedirs`` [V,3,207].

Everything here is offline tooling (retarget/vis), so it is plain numpy —
the training hot path never touches it.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from pbhc_tpu_torch.motion.smpl_npz import SMPL_PARENTS, _aa_to_mat

# Default search locations for a user-supplied model file (mirrors the
# reference's ``body_model/`` drop-in directory convention).
DEFAULT_MODEL_PATHS = (
    "assets/body_models/SMPL_NEUTRAL.pkl",
    "assets/body_models/smpl/SMPL_NEUTRAL.pkl",
)


class _ChumpyShim:
    """Stand-in for chumpy.Ch during unpickling: keeps only the data array."""

    def __setstate__(self, state):
        self.__dict__.update(state)

    @property
    def data(self):
        # chumpy.Ch pickles its backing numpy array under 'x'
        return np.asarray(self.__dict__.get("x"))


class _ShimUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyShim
        return super().find_class(module, name)


def _to_dense(v):
    if isinstance(v, _ChumpyShim):
        return v.data
    if hasattr(v, "toarray"):  # scipy sparse J_regressor in official pkls
        return np.asarray(v.toarray())
    if isinstance(v, np.ndarray):
        return v
    return v


def find_model_file(path=None):
    """Resolve an SMPL model file: explicit path, $SMPL_MODEL_PATH, or the
    assets/body_models drop-in locations. Returns None when absent.

    An EXPLICITLY requested path that does not exist raises — silently falling
    back to the mean-shape skeleton is the exact approximation the argument
    exists to avoid."""
    if path and not os.path.exists(path):
        raise FileNotFoundError(f"SMPL model file not found: {path}")
    candidates = [path, os.environ.get("SMPL_MODEL_PATH")]
    repo = os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
    candidates += [os.path.join(repo, p) for p in DEFAULT_MODEL_PATHS]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    return None


def load_smpl_model(path) -> dict:
    """Load an SMPL body model file -> dict of plain float64/int numpy arrays.

    Returns keys: v_template [V,3], J_regressor [J,V], weights [V,J],
    faces [F,3] int, parents [J], and (when present in the file)
    shapedirs [V,3,B], posedirs [V,3,9*(J-1)].
    """
    if str(path).endswith(".npz"):
        raw = dict(np.load(path, allow_pickle=True))
    else:
        with open(path, "rb") as f:
            raw = _ShimUnpickler(f, encoding="latin1").load()
    raw = {k: _to_dense(v) for k, v in raw.items()}

    model = {}
    model["v_template"] = np.asarray(raw["v_template"], np.float64)
    model["J_regressor"] = np.asarray(raw["J_regressor"], np.float64)
    model["weights"] = np.asarray(raw["weights"], np.float64)
    faces = raw.get("f", raw.get("faces"))
    if faces is None:
        raise KeyError("SMPL model file has no 'f'/'faces' entry")
    model["faces"] = np.asarray(faces, np.int64)
    if "kintree_table" in raw:
        kt = np.asarray(raw["kintree_table"], np.int64)
        parents = kt[0].copy()
        parents[0] = -1
        model["parents"] = parents
    else:
        model["parents"] = SMPL_PARENTS[: model["J_regressor"].shape[0]].astype(
            np.int64
        )
    if "shapedirs" in raw:
        sd = np.asarray(raw["shapedirs"], np.float64)
        model["shapedirs"] = sd
    if "posedirs" in raw:
        model["posedirs"] = np.asarray(raw["posedirs"], np.float64)

    V, J = model["weights"].shape
    if model["v_template"].shape != (V, 3) or model["J_regressor"].shape != (J, V):
        raise ValueError(f"{path}: v_template {model['v_template'].shape} and J_regressor "
                         f"{model['J_regressor'].shape} do not fit weights [V={V}, J={J}]")
    return model


def shaped_template(model: dict, betas=None):
    """Apply shape blendshapes: v_template + shapedirs . betas -> [V,3]."""
    v = model["v_template"]
    if betas is not None and "shapedirs" in model:
        betas = np.asarray(betas, np.float64)
        nb = min(betas.shape[-1], model["shapedirs"].shape[-1])
        v = v + model["shapedirs"][..., :nb] @ betas[:nb]
    return v


def rest_joints(model: dict, betas=None):
    """Regress the rest-pose joint positions [J,3] for a given shape."""
    return model["J_regressor"] @ shaped_template(model, betas)


def rest_offsets_from_model(model: dict, betas=None):
    """Parent-relative rest offsets [J,3] — a drop-in replacement for
    smpl_npz.SMPL_NEUTRAL_OFFSETS that respects ``betas`` (the role of the
    reference's shape-fit stage, reference smpl_retarget/phc_retarget/
    fit_smpl_shape.py)."""
    J = rest_joints(model, betas)
    parents = model["parents"]
    off = J.copy()
    off[1:] -= J[parents[1:]]
    off[0] = 0.0
    return off


def smpl_lbs(model: dict, poses, betas=None, trans=None):
    """SMPL forward: axis-angle poses [T,3*J] (+shape, +translation) ->
    (vertices [T,V,3], joints [T,J,3]).

    Standard SMPL formulation: shape blendshapes, pose-dependent corrective
    blendshapes (when ``posedirs`` is present), rigid kinematic chain, then
    linear blend skinning with the model's vertex weights.
    """
    poses = np.asarray(poses, np.float64)
    if poses.ndim == 1:
        poses = poses[None]
    T = poses.shape[0]
    parents = model["parents"]
    J = parents.shape[0]
    poses = poses.reshape(T, -1, 3)
    if poses.shape[1] < J:
        raise ValueError(f"poses carry {poses.shape[1]} joints < model {J}")
    poses = poses[:, :J]  # SMPL-H/X archives: drop joints past the model

    v_shaped = shaped_template(model, betas)  # [V,3]
    j_rest = model["J_regressor"] @ v_shaped  # [J,3]

    R = _aa_to_mat(poses.reshape(-1, 3)).reshape(T, J, 3, 3)

    if "posedirs" in model:
        # pose blendshapes are driven by the non-root rotations minus identity
        feat = (R[:, 1:] - np.eye(3)).reshape(T, -1)  # [T,9*(J-1)]
        P = model["posedirs"].reshape(-1, feat.shape[1])  # [V*3, 9*(J-1)]
        v_posed = v_shaped[None] + (feat @ P.T).reshape(T, -1, 3)
    else:
        v_posed = np.broadcast_to(v_shaped, (T,) + v_shaped.shape)

    # kinematic chain: world transform per joint
    G = np.zeros((T, J, 4, 4))
    G[:, 0, :3, :3] = R[:, 0]
    G[:, 0, :3, 3] = j_rest[0]
    G[:, 0, 3, 3] = 1.0
    for j in range(1, J):
        local = np.zeros((T, 4, 4))
        local[:, :3, :3] = R[:, j]
        local[:, :3, 3] = j_rest[j] - j_rest[parents[j]]
        local[:, 3, 3] = 1.0
        G[:, j] = G[:, parents[j]] @ local
    joints = G[:, :, :3, 3].copy()

    # skinning transforms act on rest-pose coordinates: subtract the rest
    # joint location from each transform's translation column
    A = G.copy()
    A[:, :, :3, 3] -= np.einsum("tjab,jb->tja", G[:, :, :3, :3], j_rest)

    W = model["weights"]  # [V,J]
    M = np.einsum("vj,tjab->tvab", W, A)  # [T,V,4,4]
    verts = (
        np.einsum("tvab,tvb->tva", M[:, :, :3, :3], v_posed) + M[:, :, :3, 3]
    )
    if trans is not None:
        t = np.asarray(trans, np.float64).reshape(T, 1, 3)
        verts = verts + t
        joints = joints + t
    return verts, joints
