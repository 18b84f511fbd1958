"""Deploy-policy export (counterpart of `pbhc_tpu/deploy/export.py:17-72`).

`export_policy` writes an actor's MLP weights, given in flax's layout, and
the deployment metadata as an `.npz`, and the actor-mean ONNX graph beside
it. The weights are a checkpoint's `actor_params`, or the port's
`GaussianActor` through `agents/convert.py::flax_params`: the same arrays
and the same ONNX bytes as the JAX package writes. The `.npz` bytes are the
JAX package's only from the checkpoint's own arrays, since `np.savez`
records each array's memory order and a committed checkpoint may hold a
Fortran-ordered kernel (the side-kick's `Dense_3`) where the converter
gives C-ordered copies (`tests/test_torch_eval.py`). Unlike the JAX
function, a failure of the ONNX writer is an error, not a printed
"skipped".

Not here yet (ROADMAP queue 1 item 13, deploy half): `student_meta`,
`export_student`, the `export` CLI and the ONNX runtimes.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from pbhc_tpu_torch.deploy.onnx_export import export_actor_onnx


def _floats(t) -> list:
    return t.detach().cpu().numpy().tolist()


def export_policy(actor, params, env, path, meta_extra=None):
    """`params`, the flax params `{"params": {"MLP_0": ..., "std": ...}}` of
    `actor` (a `GaussianActor` or `PhaseAwareActor`, read for the ONNX
    graph's activation, width and phase embedding), -> `path` (.npz: `w<i>`, `b<i>` in flax's `[in, out]` layout,
    `std`, and `meta_json`) and its ONNX twin `path.with_suffix(".onnx")`.
    Returns `path`."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    arrays = {}
    n_layers = 0
    mlp = params["params"]["MLP_0"]
    while f"Dense_{n_layers}" in mlp:
        d = mlp[f"Dense_{n_layers}"]
        arrays[f"w{n_layers}"] = np.asarray(d["kernel"])
        arrays[f"b{n_layers}"] = np.asarray(d["bias"])
        n_layers += 1
    arrays["std"] = np.asarray(params["params"]["std"])

    meta = {
        "n_layers": n_layers,
        "activation": "ELU",
        "num_actions": int(arrays[f"b{n_layers - 1}"].shape[0]),
        "obs_dim": int(arrays["w0"].shape[0]),
        "action_scale": _floats(env.action_scales),
        "default_dof_pos": _floats(env.raw_default_dof_pos),
        "kp": _floats(env.p_gains),
        "kd": _floats(env.d_gains),
        "torque_limits": _floats(env.torque_limits),
        "dof_names": list(env.sim_model.dof_names),
        "obs_groups": {k: list(v) for k, v in env.config.obs.obs_dict.items()},
        "obs_dims": dict(env.obs_dims),
        "obs_scales": {k: float(v) for k, v in env.config.obs.obs_scales.items()},
        "history_spec": {g: dict(s) for g, s in env.history_spec.items()},
        "action_clip": float(env.action_clip),
        "clip_obs": float(env.clip_obs),
        "dt": float(env.dt),
        "robot_type": str(env.config.robot.robot_type),
    }
    if meta_extra:
        meta.update(meta_extra)
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)
    export_actor_onnx(actor, params, meta["obs_dim"], path.with_suffix(".onnx"))
    return path
