"""Dependency-free ONNX inference in numpy and the deploy metadata of a
committed run (counterpart of `pbhc_tpu/deploy/onnx_numpy.py`, a copy: the
port imports nothing of the JAX package).

The reference ships its pretrained policies as ONNX and runs them with
onnxruntime (reference humanoidverse/urci.py:97-136). This module decodes
the ONNX protobuf itself and executes the graph with numpy (`OnnxPolicy`):
the MLP actors and the 3-input KungfuBot2 student, on the robot's onboard
PC or in the MuJoCo sim2sim runtime, without onnxruntime.

`meta_from_reference_config` builds the deploy metadata (gains, scales, obs
layout) from a run's training config. The JAX function reads the run's
`config.yaml`; the port takes the config as a dict, or a run directory whose
`config.json` it reads, else the committed snapshot named after the
directory (`config/loader.py::snapshot_for_run`), so it needs no YAML
parser. A malformed graph raises `ValueError`; an op outside the set below
raises `NotImplementedError`.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


# ------------------------------------------------------------ protobuf reader
def _varint(b, i):
    r = s = 0
    while True:
        x = b[i]
        i += 1
        r |= (x & 0x7F) << s
        if not x & 0x80:
            return r, i
        s += 7


def _fields(b):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    i = 0
    while i < len(b):
        key, i = _varint(b, i)
        f, w = key >> 3, key & 7
        if w == 0:
            v, i = _varint(b, i)
        elif w == 1:
            v = b[i:i + 8]
            i += 8
        elif w == 2:
            ln, i = _varint(b, i)
            v = b[i:i + ln]
            i += ln
        elif w == 5:
            v = b[i:i + 4]
            i += 4
        else:  # pragma: no cover - groups unused in onnx
            raise ValueError(f"unsupported wire type {w}")
        yield f, w, v


def _parse_tensor(b):
    dims, dtype, name, raw, floats = [], 1, "", b"", []
    for f, w, v in _fields(b):
        if f == 1 and w == 0:
            dims.append(v)
        elif f == 2 and w == 0:
            dtype = v
        elif f == 8 and w == 2:
            name = v.decode()
        elif f == 9 and w == 2:
            raw = v
        elif f == 4:
            if w == 2:  # packed floats
                floats.extend(struct.unpack(f"<{len(v)//4}f", v))
            else:
                floats.append(struct.unpack("<f", v)[0])
    if raw:
        if dtype == 7:
            arr = np.frombuffer(raw, dtype=np.int64)
        else:
            if dtype != 1:
                raise ValueError(f"tensor {name}: only float32/int64 supported (got {dtype})")
            arr = np.frombuffer(raw, dtype=np.float32)
    else:
        arr = np.asarray(floats, dtype=np.float32)
    return name, arr.reshape(dims or [-1])


def _parse_attr(b):
    name, fval, ival, ints = "", None, None, []
    for f, w, v in _fields(b):
        if f == 1 and w == 2:
            name = v.decode()
        elif f == 2 and w == 5:
            fval = struct.unpack("<f", v)[0]
        elif f == 3 and w == 0:
            ival = v
        elif f == 8:  # repeated int64 ints (signed: two's complement varint)
            x = v if w == 0 else None
            if x is not None:
                ints.append(x - (1 << 64) if x >= (1 << 63) else x)
    if ints:
        return name, ints
    if ival is not None and ival >= (1 << 63):
        ival -= 1 << 64
    return name, (fval if fval is not None else ival)


def _parse_node(b):
    inputs, outputs, op, attrs = [], [], "", {}
    for f, w, v in _fields(b):
        if f == 1 and w == 2:
            inputs.append(v.decode())
        elif f == 2 and w == 2:
            outputs.append(v.decode())
        elif f == 4 and w == 2:
            op = v.decode()
        elif f == 5 and w == 2:
            k, val = _parse_attr(v)
            attrs[k] = val
    return dict(inputs=inputs, outputs=outputs, op=op, attrs=attrs)


def _value_info_name(b):
    for f, w, v in _fields(b):
        if f == 1 and w == 2:
            return v.decode()
    return ""


def _value_info_dims(b):
    """Concrete dims from ValueInfoProto (None for symbolic axes).

    ValueInfoProto{name=1, type=2}; TypeProto{tensor_type=1};
    Tensor{elem_type=1, shape=2}; TensorShapeProto{dim=1*};
    Dimension{dim_value=1, dim_param=2}."""
    for f, w, v in _fields(b):
        if f == 2 and w == 2:                      # type
            for f2, w2, v2 in _fields(v):
                if f2 == 1 and w2 == 2:            # tensor_type
                    for f3, w3, v3 in _fields(v2):
                        if f3 == 2 and w3 == 2:    # shape
                            dims = []
                            for f4, w4, v4 in _fields(v3):
                                if f4 == 1 and w4 == 2:   # dim
                                    dv = None
                                    for f5, w5, v5 in _fields(v4):
                                        if f5 == 1 and w5 == 0:
                                            dv = int(v5)
                                    dims.append(dv)
                            return dims
    return []


class OnnxPolicy:
    """Minimal ONNX executor for MLP policy graphs (Gemm/Elu/Relu/Tanh/
    Sigmoid/Identity/Flatten). Callable like NumpyPolicy: obs [d] -> action."""

    def __init__(self, path, meta=None):
        data = Path(path).read_bytes()
        graph = None
        for f, w, v in _fields(data):
            if f == 7 and w == 2:
                graph = v
        if graph is None:
            raise ValueError(f"{path}: no GraphProto in the model")
        self.nodes, self.weights, self.inputs, self.outputs = [], {}, [], []
        self.input_dims = {}
        for f, w, v in _fields(graph):
            if f == 1 and w == 2:
                self.nodes.append(_parse_node(v))
            elif f == 5 and w == 2:
                name, arr = _parse_tensor(v)
                self.weights[name] = arr
            elif f == 11 and w == 2:
                name = _value_info_name(v)
                self.inputs.append(name)
                self.input_dims[name] = _value_info_dims(v)
            elif f == 12 and w == 2:
                self.outputs.append(_value_info_name(v))
        self.inputs = [n for n in self.inputs if n not in self.weights]
        self.meta = meta or {}

    def run(self, feeds: dict):
        env = dict(self.weights)
        env.update({k: np.asarray(v, dtype=np.float32) for k, v in feeds.items()})
        for nd in self.nodes:
            op = nd["op"]
            x = [env[i] for i in nd["inputs"] if i]
            a = nd["attrs"]
            if op == "Gemm":
                A, B = x[0], x[1]
                if a.get("transA", 0):
                    A = A.T
                if a.get("transB", 0):
                    B = B.T
                y = float(a.get("alpha", 1.0)) * (A @ B)
                if len(x) > 2:
                    y = y + float(a.get("beta", 1.0)) * x[2]
            elif op == "MatMul":
                y = x[0] @ x[1]
            elif op == "Add":
                y = x[0] + x[1]
            elif op == "Elu":
                al = float(a.get("alpha", 1.0))
                y = np.where(x[0] > 0, x[0], al * np.expm1(np.minimum(x[0], 0.0)))
            elif op == "Relu":
                y = np.maximum(x[0], 0.0)
            elif op == "Tanh":
                y = np.tanh(x[0])
            elif op == "Sigmoid":
                y = 1.0 / (1.0 + np.exp(-x[0]))
            elif op in ("Identity", "Flatten"):
                y = x[0].reshape(x[0].shape[0], -1) if op == "Flatten" else x[0]
            elif op == "Concat":
                y = np.concatenate(x, axis=int(a.get("axis", -1)))
            elif op == "Mul":
                y = x[0] * x[1]
            elif op == "Sub":
                y = x[0] - x[1]
            elif op == "Div":
                y = x[0] / x[1]
            elif op == "Sqrt":
                y = np.sqrt(x[0])
            elif op == "Sin":
                y = np.sin(x[0])
            elif op == "Cos":
                y = np.cos(x[0])
            elif op == "ReduceMean":
                axes = tuple(a.get("axes", [-1]))
                y = x[0].mean(axis=axes, keepdims=bool(a.get("keepdims", 1)))
            elif op == "Transpose":
                y = np.transpose(x[0], a["perm"])
            elif op == "Reshape":
                y = x[0].reshape([int(d) for d in x[1]])
            elif op == "Slice":
                starts, ends = x[1], x[2]
                axes = x[3] if len(x) > 3 else np.arange(len(starts))
                steps = x[4] if len(x) > 4 else np.ones(len(starts), np.int64)
                sl = [slice(None)] * x[0].ndim
                for st, en, ax, sp in zip(starts, ends, axes, steps):
                    sl[int(ax)] = slice(int(st), int(en), int(sp))
                y = x[0][tuple(sl)]
            elif op == "Conv":
                # NCW 1-D convolution, VALID padding (pads [0,0])
                xin, w = x[0], x[1]                     # [N,C,W], [M,C,k]
                stride = int(a.get("strides", [1])[0])
                if any(int(pv) != 0 for pv in a.get("pads", [0, 0])):
                    raise NotImplementedError("Conv with padding")
                N, C, W = xin.shape
                M, _, k = w.shape
                Wo = (W - k) // stride + 1
                idx = np.arange(Wo)[:, None] * stride + np.arange(k)[None]  # [Wo,k]
                patches = xin[:, :, idx]                # [N,C,Wo,k]
                y = np.einsum("ncok,mck->nmo", patches, w)
                if len(x) > 2:
                    y = y + x[2][None, :, None]
            else:
                raise NotImplementedError(f"ONNX op {op} not supported")
            env[nd["outputs"][0]] = y
        return [env[o] for o in self.outputs]

    def __call__(self, obs):
        obs = np.asarray(obs, dtype=np.float32)
        squeeze = obs.ndim == 1
        feed = obs[None] if squeeze else obs
        out = self.run({self.inputs[0]: feed})[0]
        return out[0] if squeeze else out


def meta_from_reference_config(config, motion_file=None):
    """Deploy metadata from a run's training config (reference
    eval_agent.py:71-106, the checkpoint-adjacent config): `config` is the
    config dict, or the run directory (`<run>/config.json`, else the
    committed snapshot named after it).

    A reference config lists `robot.dof_names` and gives `obs.obs_dims` as a
    list of one-key dicts, which is all the JAX function reads. The runs this
    repo commits have neither: their DoF order is the robot MJCF's joint
    order (`model/g1.py`), and `obs_dims` is one dict; both are read here."""
    from pbhc_tpu_torch.config.loader import resolve_interpolations, snapshot_for_run

    # resolved leniently, as JAX's is: foreign resolvers (`${now:...}`) stay raw
    cfg = resolve_interpolations(config if isinstance(config, dict) else snapshot_for_run(config), strict=False)
    r = cfg["robot"]
    if "dof_names" in r:
        dof_names = list(r["dof_names"])
    else:
        from pbhc_tpu_torch.model.g1 import load_g1_sim_model

        dof_names = list(load_g1_sim_model(str(r["robot_type"])).dof_names)

    def per_dof(table):
        out = []
        for n in dof_names:
            val = None
            for pat, v in table.items():
                if pat in n:
                    val = v
            if val is None:
                raise ValueError(f"no entry for {n} in {sorted(table)}")
            out.append(float(val))
        return out

    ctrl = r["control"]
    a = ctrl["action_scale"]
    action_scale = per_dof(a) if isinstance(a, dict) else [float(a)] * len(dof_names)
    obs = cfg["obs"]
    obs_dims = {}
    for ent in (obs["obs_dims"] if isinstance(obs["obs_dims"], list) else [obs["obs_dims"]]):
        obs_dims.update({k: int(v) for k, v in ent.items()})
    default_angles = r["init_state"]["default_joint_angles"]
    return {
        "n_layers": 0,
        "activation": "ELU",
        "num_actions": len(dof_names),
        "obs_dim": None,
        "action_scale": action_scale,
        "default_dof_pos": [float(default_angles[n]) for n in dof_names],
        "kp": per_dof(ctrl["stiffness"]),
        "kd": per_dof(ctrl["damping"]),
        "torque_limits": [float(v) for v in r["dof_effort_limit_list"]],
        "dof_names": dof_names,
        "obs_groups": {k: list(v) for k, v in obs["obs_dict"].items()},
        "obs_dims": obs_dims,
        "obs_scales": {k: float(v) for k, v in obs["obs_scales"].items()},
        "history_spec": {g: {k: int(v) for k, v in s.items()}
                         for g, s in (obs.get("obs_auxiliary") or {}).items()},
        "action_clip": float(ctrl.get("action_clip_value", 100.0)),
        "clip_obs": float(cfg["env"]["config"].get("normalization", {})
                          .get("clip_observations", 100.0)),
        "dt": 0.02,
        "motion_file": motion_file,
    }
