"""Deploy-policy export and the host executors of an export (counterpart
of `pbhc_tpu/deploy/export.py`).

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

`export_student` writes a KungfuBot2 student (a PPOMimic checkpoint) as the
3-input ONNX graph (`actor_obs`, `future_motion_targets`, `prop_history`)
and a `.meta.json` beside it, which `deploy/student_obs.py` and the deploy
runtimes read. `StudentPolicy` runs that graph on the numpy executor or the
native core, `NumpyPolicy` an `.npz` export.

CLI:
    python -m pbhc_tpu_torch.deploy.export info <policy.npz>
    python -m pbhc_tpu_torch.deploy.export student <run>/ckpt/model_<it>.pkl [out.onnx] [device=cpu]
`student` loads the run through `eval/batch_eval.py::load` (on the first
CUDA card unless `device=` names another) and writes the checkpoint's own
arrays, so the ONNX bytes are the JAX package's.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from pbhc_tpu_torch.deploy.onnx_export import export_actor_onnx, export_mimic_onnx


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


def student_meta(env, meta_extra=None):
    """Deploy metadata of a `GeneralTrackingEnv` (`export.py:75`): what
    `StudentObsBuilder` and the runtimes need to rebuild the training obs."""
    meta = {
        "num_actions": int(env.nd),
        "obs_dim": int(env.obs_dim("actor_obs")),
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
        "history_length": int(env.config.obs.history_length),
        "future_num_steps": int(env.future_num_steps),
        "future_max_steps": int(env.future_max_steps),
        "key_body_ids": env.key_body_id.tolist(),
        "anchor_index": int(env.anchor_index),
        "action_clip": float(env.action_clip),
        "clip_obs": float(env.clip_obs),
        "dt": float(env.dt),
        "robot_type": str(env.config.robot.robot_type),
    }
    if meta_extra:
        meta.update(meta_extra)
    return meta


def export_student(net, params, env, path, meta_extra=None):
    """The student `net` (a `MimicActorCritic`, read for its geometry) with
    flax-layout `params` -> `path` (the 3-input ONNX graph, reference
    inference_helpers.py:95-138) and `<path>.meta.json`. Returns `path`."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    export_mimic_onnx(net, params, path, obs_dim=env.obs_dim("actor_obs"))
    Path(str(path) + ".meta.json").write_text(json.dumps(student_meta(env, meta_extra), indent=1))
    return path


class StudentPolicy:
    """An exported student ONNX with its `.meta.json`; called on the feed
    dict of `StudentObsBuilder.build`, returns the action [num_actions].
    `native=True` runs the graph on the host C++ core (`onnx_exec.cpp`),
    the real-robot controller's path; else on the numpy executor."""

    def __init__(self, path, native=False):
        from pbhc_tpu_torch.deploy.onnx_numpy import OnnxPolicy

        self.meta = json.loads(Path(str(path) + ".meta.json").read_text())
        if native:
            from pbhc_tpu_torch.deploy.native.onnx_exec import NativeOnnxPolicy

            self._onnx = NativeOnnxPolicy(path, meta=self.meta)
        else:
            self._onnx = OnnxPolicy(path, meta=self.meta)

    def __call__(self, feeds: dict):
        return np.asarray(self._onnx.run(feeds)[0]).reshape(-1)


class NumpyPolicy:
    """The deterministic forward pass of an `.npz` export in numpy."""

    def __init__(self, path):
        data = np.load(path)
        self.meta = json.loads(bytes(data["meta_json"]).decode())
        self.layers = [(data[f"w{i}"], data[f"b{i}"]) for i in range(self.meta["n_layers"])]

    @staticmethod
    def _elu(x):
        return np.where(x > 0, x, np.expm1(np.minimum(x, 0.0)))

    def __call__(self, obs):
        x = np.asarray(obs, dtype=np.float32)
        for i, (w, b) in enumerate(self.layers):
            x = x @ w + b
            if i < len(self.layers) - 1:
                x = self._elu(x)
        return x


def main(argv=None):
    """`info <policy.npz>`: the export's metadata and layer shapes as JSON
    (reference check_model_dims.py). `student <ckpt.pkl> [out.onnx]
    [device=...]`: export a PPOMimic checkpoint as the deployable student
    (default `<run>/exported/<ckpt stem>_student.onnx`). Returns what it
    printed (`info`) or the ONNX path (`student`)."""
    import sys

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "student":
        from pbhc_tpu_torch.eval import batch_eval
        from pbhc_tpu_torch.utils.checkpoint import load_checkpoint_payload

        kv = dict(a.split("=", 1) for a in argv[1:] if "=" in a)
        pos = [a for a in argv[1:] if "=" not in a]
        device = kv.pop("device", "cuda")
        if kv or not 1 <= len(pos) <= 2:
            raise SystemExit("usage: export student <ckpt.pkl> [out.onnx] [device=cuda|cpu]")
        ckpt = Path(pos[0])
        out = Path(pos[1]) if len(pos) > 1 else ckpt.parent.parent / "exported" / f"{ckpt.stem}_student.onnx"
        env, net, cfg = batch_eval.load(ckpt, 1, device=device)
        payload = load_checkpoint_payload(ckpt)
        params = payload.get("actor_params") or payload.get("params")
        export_student(net, params, env, out, meta_extra={"motion_file": str(cfg.robot.motion.motion_file)})
        print(f"[export] student ONNX -> {out}")
        return out
    if len(argv) != 2 or argv[0] != "info":
        raise SystemExit("usage: export info <policy.npz> | export student <ckpt.pkl> [out.onnx] [device=...]")
    pol = NumpyPolicy(argv[1])
    meta = dict(pol.meta)
    meta["layers"] = [f"{w.shape[0]}x{w.shape[1]}" for w, _ in pol.layers]
    for k in ("kp", "kd", "torque_limits", "action_scale", "default_dof_pos"):
        meta[k] = f"[{len(meta[k])} values]"
    text = json.dumps(meta, indent=1, default=str)
    print(text)
    return text


if __name__ == "__main__":
    main()
