"""Dependency-free ONNX export of trained policies (a copy of
`pbhc_tpu/deploy/onnx_export.py`, which imports no JAX; the port keeps its
own, and writes the same bytes for the same parameters).

The reference exports its actors to ONNX for deployment (reference
humanoidverse/utils/inference_helpers.py:13-138: actor-only export, and the
3-input actor+encoder export consumed by the real-robot controller, reference
deploy_real/deploy_real.py:870-895). onnx/onnxruntime are not in this image,
so this module serializes the ONNX protobuf directly (ModelProto/GraphProto/
NodeProto/TensorProto wire format). The parameters come in flax's layout
(`agents/convert.py::flax_params` gives it for the port's networks).

Exported graphs use plain opset-13 ops (Gemm/Elu/Relu/Tanh/MatMul/Add/Conv/
Transpose/Reshape/Concat/Slice/Sin/Cos/Mul/Sub/Div/Sqrt/ReduceMean) so real
onnxruntime deployments load them unchanged.

Entry points:
    export_actor_onnx(actor, params, obs_dim, path)          # MLP / PhaseAware
    export_mimic_onnx(net, params, dims, path)               # 3-input student
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

# ------------------------------------------------------------ protobuf writer

def _varint(v: int) -> bytes:
    out = b""
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _int_field(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def _str_field(field: int, s: str) -> bytes:
    return _len_delim(field, s.encode())


def _tensor(name: str, arr: np.ndarray) -> bytes:
    """TensorProto: dims=1, data_type=2, int64_data=7, name=8, raw_data=9."""
    arr = np.asarray(arr)
    out = b"".join(_int_field(1, int(d)) for d in arr.shape)
    if arr.dtype == np.int64:
        out += _int_field(2, 7)  # INT64
        out += _str_field(8, name)
        out += _len_delim(9, arr.astype("<i8").tobytes())
    else:
        out += _int_field(2, 1)  # FLOAT
        out += _str_field(8, name)
        out += _len_delim(9, arr.astype("<f4").tobytes())
    return out


def _attr_f(name: str, v: float) -> bytes:
    return (_str_field(1, name) + _tag(2, 5) + struct.pack("<f", v)
            + _int_field(20, 1))  # type=FLOAT


def _attr_i(name: str, v: int) -> bytes:
    return _str_field(1, name) + _int_field(3, v) + _int_field(20, 2)  # INT


def _attr_ints(name: str, vals) -> bytes:
    out = _str_field(1, name)
    for v in vals:
        out += _int_field(8, int(v) & ((1 << 64) - 1))
    return out + _int_field(20, 7)  # INTS


def _node(op: str, inputs, outputs, attrs: bytes = b"", name: str = "") -> bytes:
    out = b"".join(_str_field(1, i) for i in inputs)
    out += b"".join(_str_field(2, o) for o in outputs)
    out += _str_field(3, name or outputs[0])
    out += _str_field(4, op)
    if attrs:
        # attrs is pre-encoded: a concat of AttributeProto payloads, each
        # wrapped by the caller via _len_delim(5, ...)
        out += attrs
    return out


def _attrs(*payloads: bytes) -> bytes:
    return b"".join(_len_delim(5, p) for p in payloads)


def _value_info(name: str, shape) -> bytes:
    """ValueInfoProto{name=1, type=2}; dim None -> symbolic 'N'."""
    dims = b""
    for d in shape:
        if d is None:
            dims += _len_delim(1, _str_field(2, "N"))
        else:
            dims += _len_delim(1, _int_field(1, int(d)))
    tensor_type = _int_field(1, 1) + _len_delim(2, dims)  # elem_type=FLOAT
    return _str_field(1, name) + _len_delim(2, _len_delim(1, tensor_type))


class GraphBuilder:
    """Accumulates nodes/initializers and serializes a ModelProto."""

    def __init__(self, name="pbhc_policy"):
        self.name = name
        self.nodes = []
        self.inits = []
        self.inputs = []
        self.outputs = []
        self._uid = 0

    def fresh(self, hint="t"):
        self._uid += 1
        return f"{hint}_{self._uid}"

    def add_input(self, name, dim):
        self.inputs.append(_value_info(name, (None, dim)))

    def add_output(self, name, dim):
        self.outputs.append(_value_info(name, (None, dim)))

    def init(self, arr, hint="w"):
        name = self.fresh(hint)
        self.inits.append(_tensor(name, arr))
        return name

    def op(self, op_type, inputs, attrs=b"", out=None):
        out = out or self.fresh(op_type.lower())
        self.nodes.append(_node(op_type, inputs, [out], attrs))
        return out

    # -------------------------------------------------- composite helpers
    def dense(self, x, kernel, bias, gemm=True):
        """flax Dense: y = x @ kernel + bias. Gemm for 2D x, MatMul+Add for ND."""
        w = self.init(kernel, "kernel")
        b = self.init(bias, "bias")
        if gemm:
            return self.op("Gemm", [x, w, b])
        return self.op("Add", [self.op("MatMul", [x, w]), b])

    def activation(self, x, kind):
        if kind == "ELU":
            return self.op("Elu", [x], _attrs(_attr_f("alpha", 1.0)))
        if kind == "ReLU":
            return self.op("Relu", [x])
        if kind == "Tanh":
            return self.op("Tanh", [x])
        if kind == "SiLU":
            return self.op("Mul", [x, self.op("Sigmoid", [x])])
        raise NotImplementedError(f"activation {kind} not exportable")

    def mlp(self, x, layers, act, gemm=True):
        """layers: list of (kernel, bias); activation between all but last."""
        for i, (k, b) in enumerate(layers):
            x = self.dense(x, k, b, gemm=gemm)
            if i < len(layers) - 1:
                x = self.activation(x, act)
        return x

    def layer_norm(self, x, gamma, beta, eps=1e-6):
        """Decomposed LayerNorm over the last axis (portable to old opsets)."""
        m = self.op("ReduceMean", [x], _attrs(_attr_ints("axes", [-1]), _attr_i("keepdims", 1)))
        d = self.op("Sub", [x, m])
        var = self.op("ReduceMean", [self.op("Mul", [d, d])],
                      _attrs(_attr_ints("axes", [-1]), _attr_i("keepdims", 1)))
        eps_c = self.init(np.asarray([eps], np.float32), "eps")
        s = self.op("Sqrt", [self.op("Add", [var, eps_c])])
        g = self.init(gamma, "ln_g")
        b = self.init(beta, "ln_b")
        return self.op("Add", [self.op("Mul", [self.op("Div", [d, s]), g]), b])

    def conv1d_nwc(self, x, kernel, bias, stride):
        """flax nn.Conv (NWC, kernel [k,Cin,Cout], VALID) as ONNX Conv (NCW)."""
        w = self.init(np.transpose(np.asarray(kernel), (2, 1, 0)), "conv_w")  # [Cout,Cin,k]
        b = self.init(bias, "conv_b")
        ncw = self.op("Transpose", [x], _attrs(_attr_ints("perm", [0, 2, 1])))
        y = self.op("Conv", [ncw, w, b],
                    _attrs(_attr_ints("strides", [stride]), _attr_ints("pads", [0, 0]),
                           _attr_ints("dilations", [1])))
        return self.op("Transpose", [y], _attrs(_attr_ints("perm", [0, 2, 1])))

    def reshape(self, x, shape):
        s = self.init(np.asarray(shape, np.int64), "shape")
        return self.op("Reshape", [x, s])

    def serialize(self) -> bytes:
        graph = b"".join(_len_delim(1, n) for n in self.nodes)
        graph += _str_field(2, self.name)
        graph += b"".join(_len_delim(5, t) for t in self.inits)
        graph += b"".join(_len_delim(11, vi) for vi in self.inputs)
        graph += b"".join(_len_delim(12, vi) for vi in self.outputs)
        model = _int_field(1, 8)                       # ir_version = 8
        model += _str_field(2, "pbhc_tpu")             # producer_name
        model += _len_delim(7, graph)
        model += _len_delim(8, _int_field(2, 13))      # opset_import {version: 13}
        return model


# --------------------------------------------------------------- param access

def _mlp_layers(tree):
    """Ordered (kernel, bias) list from a flax MLP param subtree."""
    keys = sorted((k for k in tree if k.startswith("Dense_")),
                  key=lambda s: int(s.split("_")[1]))
    return [(np.asarray(tree[k]["kernel"]), np.asarray(tree[k]["bias"])) for k in keys]


# ------------------------------------------------------------------ exporters

def export_actor_onnx(actor, params, obs_dim: int, path,
                      input_name="actor_obs", output_name="action"):
    """Actor-mean-only export (reference inference_helpers.py:13-44).

    Supports GaussianActor (MLP) and PhaseAwareActor (sinusoidal or learnable
    phase embedding spliced onto the obs vector).
    """
    p = params["params"]
    g = GraphBuilder("pbhc_actor")
    g.add_input(input_name, obs_dim)
    x = input_name

    if "PhaseEmbed_0" in p or type(actor).__name__ == "PhaseAwareActor":
        pos = int(actor.phase_pos)
        starts = g.init(np.asarray([pos], np.int64), "starts")
        ends = g.init(np.asarray([pos + 1], np.int64), "ends")
        axes = g.init(np.asarray([-1], np.int64), "axes")
        phase = g.op("Slice", [x, starts, ends, axes])
        if actor.embed_type == "Learnable":
            emb_tree = p["PhaseEmbed_0"]["Dense_0"]
            emb = g.dense(phase, np.asarray(emb_tree["kernel"]), np.asarray(emb_tree["bias"]))
        else:
            k = np.arange(actor.embed_dim // 2)
            freq = ((2.0 ** k) * np.pi).astype(np.float32)
            ang = g.op("Mul", [phase, g.init(freq, "freqs")])
            emb = g.op("Concat", [g.op("Sin", [ang]), g.op("Cos", [ang])],
                       _attrs(_attr_i("axis", -1)))
        x = g.op("Concat", [x, emb], _attrs(_attr_i("axis", -1)))

    mean = g.mlp(x, _mlp_layers(p["MLP_0"]), actor.activation)
    g.nodes.append(_node("Identity", [mean], [output_name]))
    g.add_output(output_name, int(actor.num_actions))
    Path(path).write_bytes(g.serialize())
    return path


def export_mimic_onnx(net, params, path,
                      obs_dim=None, future_dim=None, history_dim=None):
    """Deterministic student export with the reference real-robot contract:
    3 named inputs actor_obs / future_motion_targets / prop_history
    (reference inference_helpers.py:95-138; deploy_real.py:870-895), output =
    actor mean with the HISTORY encoder latent (the deployable path).
    """
    from types import SimpleNamespace

    p = params["params"]["actor"] if "actor" in params["params"] else params["params"]
    g = GraphBuilder("pbhc_student")
    # net is MimicActorCritic or MimicActor; pull the geometry off its fields
    a = SimpleNamespace(
        future_steps=net.future_steps, future_per_step=net.future_per_step,
        history_steps=net.history_steps, history_per_step=net.history_per_step,
        activation=net.activation, num_actions=net.num_actions,
        use_layernorm=getattr(net, "use_layernorm", "ln" in p))
    future_dim = future_dim or a.future_steps * a.future_per_step
    history_dim = history_dim or a.history_steps * a.history_per_step
    g.add_input("actor_obs", obs_dim)
    g.add_input("future_motion_targets", future_dim)
    g.add_input("prop_history", history_dim)

    def conv_encoder(enc_tree, x_name, tsteps, per_step):
        from pbhc_tpu_torch.agents.mimic_networks import _CONV_PLANS

        plan = _CONV_PLANS[tsteps]
        x = g.reshape(x_name, [-1, tsteps, per_step])
        d0 = enc_tree["Dense_0"]
        x = g.op("Relu", [g.dense(x, np.asarray(d0["kernel"]), np.asarray(d0["bias"]), gemm=False)])
        t = tsteps
        for i, (k, s) in enumerate(zip(plan["kernels"], plan["strides"])):
            c = enc_tree[f"Conv_{i}"]
            x = g.activation(g.conv1d_nwc(x, c["kernel"], np.asarray(c["bias"]), s), a.activation)
            t = (t - k) // s + 1
        x = g.reshape(x, [-1, t * plan["out_channels"][-1]])
        d1 = enc_tree["Dense_1"]
        return g.dense(x, np.asarray(d1["kernel"]), np.asarray(d1["bias"]))

    motion = conv_encoder(p["motion_encoder"], "future_motion_targets",
                          a.future_steps, a.future_per_step)
    hist = conv_encoder(p["history_encoder"], "prop_history",
                        a.history_steps, a.history_per_step)
    x = g.op("Concat", ["actor_obs", motion, hist], _attrs(_attr_i("axis", -1)))
    if a.use_layernorm:
        ln = p["ln"]
        x = g.layer_norm(x, np.asarray(ln["scale"]), np.asarray(ln["bias"]))
    mean = g.mlp(x, _mlp_layers(p["backbone"]), a.activation)
    g.nodes.append(_node("Identity", [mean], ["action"]))
    g.add_output("action", int(a.num_actions))
    Path(path).write_bytes(g.serialize())
    return path
