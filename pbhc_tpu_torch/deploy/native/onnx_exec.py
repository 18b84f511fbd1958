"""Planner and ctypes binding of the native ONNX executor `onnx_exec.cpp`
(counterpart of `pbhc_tpu/deploy/native/onnx_exec.py`, a copy).

`NativeOnnxPolicy` has the surface of `deploy/onnx_numpy.py::OnnxPolicy`
and covers every op the exported policies use, the KungfuBot2 3-input
student included (Conv1d motion and history encoders, LayerNorm, Concat), on
the host C++ core with no allocation per tick (the reference deploys on
onnxruntime's C++ core, reference urci.py:97-136, deploy_real.py:31).

Lowering: the graph is traced once with numpy on random inputs to fix every
shape, each node is lowered to the VM's static instruction set, and the plan
is checked when it is made: the VM's output on those inputs must agree with
the numpy executor's to 2e-5, else the constructor raises. At run time only
the input buffers are rewritten. The core is compiled at first use into
`<repo>/build/native/` (`deploy/native/__init__.py::host_library`); a failed
build raises, and nothing falls back to the numpy executor.
"""
from __future__ import annotations

import ctypes

import numpy as np

from pbhc_tpu_torch.deploy.native import host_library
from pbhc_tpu_torch.deploy.onnx_numpy import OnnxPolicy

_BIN = {"Add": 0, "Sub": 1, "Mul": 2, "Div": 3}
_UN = {"Elu": 0, "Relu": 1, "Tanh": 2, "Sigmoid": 3, "Sqrt": 4, "Sin": 5,
       "Cos": 6}

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = host_library("onnx_exec")
        i32, i64, fp = ctypes.c_int32, ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.ox_create.restype = ctypes.c_void_p
        lib.ox_alloc.restype = i32
        lib.ox_alloc.argtypes = [ctypes.c_void_p, i64]
        lib.ox_write.argtypes = [ctypes.c_void_p, i32, fp, i64]
        lib.ox_read.argtypes = [ctypes.c_void_p, i32, fp, i64]
        lib.ox_add_copy.argtypes = [ctypes.c_void_p, i32, i64, i32, i64p, i64p,
                                    i32, i64]
        lib.ox_add_binary.argtypes = [ctypes.c_void_p, i32, i32, i64, i64p,
                                      i32, i64, i64p, i32, i64p, i32]
        lib.ox_add_unary.argtypes = [ctypes.c_void_p, i32, i32, i64, i32]
        lib.ox_add_matmul.argtypes = [ctypes.c_void_p, i32, i64, i64, i32, i64,
                                      i32, i32]
        lib.ox_add_conv1d.argtypes = [ctypes.c_void_p, i32, i64, i64, i32, i64,
                                      i64, i32, i32, i32]
        lib.ox_add_reducemean_last.argtypes = [ctypes.c_void_p, i32, i64, i64,
                                               i32]
        lib.ox_run.restype = i32
        lib.ox_run.argtypes = [ctypes.c_void_p]
        lib.ox_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def _i64arr(vals):
    return (ctypes.c_int64 * len(vals))(*[int(v) for v in vals])


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class _Val:
    """A graph value: traced numpy array + its VM placement (buffer view)."""

    __slots__ = ("arr", "buf", "off", "shape", "strides")

    def __init__(self, arr, buf, off, shape, strides):
        self.arr = arr
        self.buf = buf
        self.off = off
        self.shape = tuple(int(s) for s in shape)
        self.strides = tuple(int(s) for s in strides)

    @property
    def direct(self):
        return self.off == 0 and self.strides == _canonical(self.shape)


def _canonical(shape):
    st, acc = [], 1
    for s in reversed(shape):
        st.append(acc)
        acc *= s
    return tuple(reversed(st))


class NativeOnnxPolicy:
    """Native-core executor for an exported .onnx; same surface as OnnxPolicy."""

    def __init__(self, path, meta=None):
        ref = OnnxPolicy(path, meta=meta)
        self.meta = ref.meta
        self.inputs = list(ref.inputs)
        self.outputs = list(ref.outputs)
        self._lib = _load()
        self._h = ctypes.c_void_p(self._lib.ox_create())

        # trace with random inputs (shapes come from one numpy pass; the same
        # pass validates the lowered program at the end)
        rng = np.random.default_rng(0)
        feeds = {}
        for name in self.inputs:
            dims = [d for d in ref.input_dims.get(name, []) if d]
            d = int(np.prod(dims)) if dims else _infer_input_dim(ref, name)
            feeds[name] = rng.standard_normal((1, int(d))).astype(np.float32)
        self._plan(ref, feeds)
        self._validate(ref, feeds)

    # -- planning ----------------------------------------------------------
    def _alloc(self, arr):
        return int(self._lib.ox_alloc(self._h, max(1, arr.size)))

    def _upload(self, arr):
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        buf = self._alloc(arr)
        self._lib.ox_write(self._h, buf, _fptr(arr), arr.size)
        return buf

    def _materialize(self, v):
        """Ensure `v` is a direct (offset-0, canonically-strided) buffer."""
        if v.direct:
            return v
        buf = self._lib.ox_alloc(self._h, max(1, int(np.prod(v.shape))))
        self._lib.ox_add_copy(self._h, v.buf, v.off, len(v.shape),
                              _i64arr(v.shape), _i64arr(v.strides), buf, 0)
        return _Val(v.arr, buf, 0, v.shape, _canonical(v.shape))

    def _out(self, arr):
        return self._alloc(arr), np.ascontiguousarray(arr)

    def _plan(self, ref, feeds):
        env = {}
        consts = {}  # plan-time integer/initializer constants
        for name, w in ref.weights.items():
            if w.dtype in (np.int64, np.int32):
                consts[name] = w
            else:
                arr = np.asarray(w, dtype=np.float32)
                env[name] = _Val(arr, self._upload(arr), 0, arr.shape,
                                 _canonical(arr.shape))
        self._in_bufs = {}
        for name, arr in feeds.items():
            buf = self._upload(arr)
            self._in_bufs[name] = (buf, arr.size)
            env[name] = _Val(arr, buf, 0, arr.shape, _canonical(arr.shape))

        lib, h = self._lib, self._h
        for nd in ref.nodes:
            op, a = nd["op"], nd["attrs"]
            ins = [i for i in nd["inputs"] if i]
            out_name = nd["outputs"][0]

            if op in ("Identity", "Flatten", "Reshape"):
                v = self._materialize(env[ins[0]])
                if op == "Reshape":
                    shp = [int(d) for d in consts.get(ins[1], env.get(ins[1], _Val(None, 0, 0, (), ())).arr)]
                    arr = v.arr.reshape(shp)
                elif op == "Flatten":
                    arr = v.arr.reshape(v.arr.shape[0], -1)
                else:
                    arr = v.arr
                env[out_name] = _Val(arr, v.buf, 0, arr.shape,
                                     _canonical(arr.shape))

            elif op == "Transpose":
                v = env[ins[0]]
                perm = [int(p) for p in a["perm"]]
                arr = np.transpose(v.arr, perm)
                env[out_name] = _Val(arr, v.buf, v.off,
                                     [v.shape[p] for p in perm],
                                     [v.strides[p] for p in perm])

            elif op == "Slice":
                v = env[ins[0]]
                starts = consts[ins[1]]
                ends = consts[ins[2]]
                axes = consts[ins[3]] if len(ins) > 3 else np.arange(len(starts))
                steps = consts[ins[4]] if len(ins) > 4 else np.ones(len(starts), np.int64)
                sl = [slice(None)] * len(v.shape)
                for st, en, ax, sp in zip(starts, ends, axes, steps):
                    sl[int(ax)] = slice(int(st), int(en), int(sp))
                arr = v.arr[tuple(sl)]
                off, shape, strides = v.off, [], []
                for d, s in enumerate(sl):
                    start, stop, stp = s.indices(v.shape[d])
                    off += start * v.strides[d]
                    shape.append(max(0, -(-(stop - start) // stp)))
                    strides.append(v.strides[d] * stp)
                env[out_name] = _Val(arr, v.buf, off, shape, strides)

            elif op in _BIN:
                va, vb = env[ins[0]], env[ins[1]]
                arr = {"Add": np.add, "Sub": np.subtract, "Mul": np.multiply,
                       "Div": np.divide}[op](va.arr, vb.arr)
                oshape = arr.shape
                sa = _bcast_strides(va, oshape)
                sb = _bcast_strides(vb, oshape)
                buf = self._alloc(arr)
                lib.ox_add_binary(h, _BIN[op], va.buf, va.off, _i64arr(sa),
                                  vb.buf, vb.off, _i64arr(sb), len(oshape),
                                  _i64arr(oshape), buf)
                env[out_name] = _Val(arr, buf, 0, oshape, _canonical(oshape))

            elif op in _UN:
                v = self._materialize(env[ins[0]])
                al = float(a.get("alpha", 1.0))
                arr = {
                    "Elu": lambda x: np.where(x > 0, x, al * np.expm1(np.minimum(x, 0))),
                    "Relu": lambda x: np.maximum(x, 0.0),
                    "Tanh": np.tanh,
                    "Sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x)),
                    "Sqrt": np.sqrt, "Sin": np.sin, "Cos": np.cos,
                }[op](v.arr).astype(np.float32)
                if op == "Elu" and al != 1.0:
                    raise NotImplementedError("native Elu supports alpha=1 only")
                buf = self._alloc(arr)
                lib.ox_add_unary(h, _UN[op], v.buf, arr.size, buf)
                env[out_name] = _Val(arr, buf, 0, arr.shape,
                                     _canonical(arr.shape))

            elif op in ("Gemm", "MatMul"):
                va = self._materialize(env[ins[0]])
                A = va.arr
                lead = A.shape[:-1]  # [..., k] @ [k, n]: fold leading dims
                A = A.reshape(-1, A.shape[-1])
                if op == "Gemm":
                    if a.get("transA", 0):
                        raise NotImplementedError("Gemm with transA")
                    W = ref.weights.get(ins[1])
                    if W is None:
                        raise NotImplementedError("Gemm weight must be an initializer")
                    W = W.T if a.get("transB", 0) else W
                    W = (float(a.get("alpha", 1.0)) * W).astype(np.float32)
                    wbuf = self._upload(W)
                    bias = -1
                    if len(ins) > 2:
                        B0 = ref.weights.get(ins[2])
                        if B0 is None:
                            raise NotImplementedError("Gemm bias must be an initializer")
                        bias = self._upload(
                            (float(a.get("beta", 1.0)) * B0).astype(np.float32))
                        arr = (A @ W + float(a.get("beta", 1.0)) * B0).astype(np.float32)
                    else:
                        arr = (A @ W).astype(np.float32)
                else:
                    vb = self._materialize(env[ins[1]])
                    W, wbuf, bias = vb.arr, vb.buf, -1
                    if W.ndim != 2:
                        raise NotImplementedError(f"MatMul rhs must be 2-D, got {W.shape}")
                    arr = (A @ W).astype(np.float32)
                arr = arr.reshape(*lead, W.shape[1])
                buf = self._alloc(arr)
                lib.ox_add_matmul(h, va.buf, A.shape[0], A.shape[1], wbuf,
                                  W.shape[1], bias, buf)
                env[out_name] = _Val(arr, buf, 0, arr.shape,
                                     _canonical(arr.shape))

            elif op == "Concat":
                vs = [self._materialize(env[i]) for i in ins]
                ax = int(a.get("axis", -1))
                arr = np.concatenate([v.arr for v in vs], axis=ax)
                ax = ax % arr.ndim
                outer = int(np.prod(arr.shape[:ax], dtype=np.int64))
                inner = int(np.prod(arr.shape[ax + 1:], dtype=np.int64))
                buf = self._alloc(arr)
                row = arr.shape[ax] * inner
                col = 0
                for v in vs:
                    blk = v.shape[ax] * inner
                    for r in range(outer):
                        lib.ox_add_copy(h, v.buf, r * blk, 1, _i64arr([blk]),
                                        _i64arr([1]), buf, r * row + col)
                    col += blk
                env[out_name] = _Val(arr, buf, 0, arr.shape,
                                     _canonical(arr.shape))

            elif op == "ReduceMean":
                v = self._materialize(env[ins[0]])
                axes = tuple(int(x) for x in a.get("axes", [-1]))
                nd_ = v.arr.ndim
                if not all(ax % nd_ == nd_ - 1 for ax in axes):
                    raise NotImplementedError("native ReduceMean supports the last axis only")
                keep = bool(a.get("keepdims", 1))
                arr = v.arr.mean(axis=-1, keepdims=keep).astype(np.float32)
                d = v.shape[-1]
                buf = self._alloc(arr)
                lib.ox_add_reducemean_last(h, v.buf, max(1, v.arr.size // d),
                                           d, buf)
                env[out_name] = _Val(arr, buf, 0, arr.shape,
                                     _canonical(arr.shape))

            elif op == "Conv":
                v = self._materialize(env[ins[0]])
                W = ref.weights[ins[1]]
                if not (v.arr.ndim == 3 and v.arr.shape[0] == 1):
                    raise NotImplementedError(f"native Conv expects [1,C,W], got {v.arr.shape}")
                if any(int(p) != 0 for p in a.get("pads", [0, 0])):
                    raise NotImplementedError("native Conv is valid-padding only")
                stride = int(a.get("strides", [1])[0])
                M, C, kW = W.shape
                Wlen = v.shape[2]
                Wo = (Wlen - kW) // stride + 1
                bias = self._upload(ref.weights[ins[2]]) if len(ins) > 2 else -1
                wbuf = self._upload(W)
                idx = np.arange(Wo)[:, None] * stride + np.arange(kW)[None]
                patches = v.arr[:, :, idx]
                arr = np.einsum("ncok,mck->nmo", patches, W).astype(np.float32)
                if len(ins) > 2:
                    arr = arr + ref.weights[ins[2]][None, :, None]
                buf = self._alloc(arr)
                lib.ox_add_conv1d(h, v.buf, C, Wlen, wbuf, M, kW, stride,
                                  bias, buf)
                env[out_name] = _Val(arr, buf, 0, arr.shape,
                                     _canonical(arr.shape))

            else:
                raise NotImplementedError(f"native ONNX op {op}")

        outs = []
        for o in self.outputs:
            v = self._materialize(env[o])
            outs.append((v.buf, v.arr.shape))
        self._out_bufs = outs

    def _validate(self, ref, feeds):
        got = self.run(feeds)
        want = ref.run(feeds)
        for g, w in zip(got, want):
            if not np.allclose(g, w, rtol=2e-5, atol=2e-5):
                raise RuntimeError(f"native plan disagrees with the numpy executor: max abs diff "
                                   f"{float(np.abs(g - w).max()):.3e} (tol 2e-5)")

    # -- runtime -----------------------------------------------------------
    def run(self, feeds: dict):
        for name, arr in feeds.items():
            buf, n = self._in_bufs[name]
            arr = np.ascontiguousarray(arr, dtype=np.float32)
            if arr.size != n:
                raise ValueError(f"{name}: expected {n} elements, got {arr.size}")
            self._lib.ox_write(self._h, buf, _fptr(arr), n)
        self._lib.ox_run(self._h)
        outs = []
        for buf, shape in self._out_bufs:
            out = np.empty(int(np.prod(shape)), dtype=np.float32)
            self._lib.ox_read(self._h, buf, _fptr(out), out.size)
            outs.append(out.reshape(shape))
        return outs

    def __call__(self, obs):
        obs = np.asarray(obs, dtype=np.float32)
        squeeze = obs.ndim == 1
        feed = obs[None] if squeeze else obs
        out = self.run({self.inputs[0]: feed})[0]
        return out[0] if squeeze else out

    def close(self):
        """Free the native program (also done when the policy is collected)."""
        if self._h:
            self._lib.ox_destroy(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()


def _bcast_strides(v, oshape):
    """Strides of view `v` broadcast to `oshape` (zero on broadcast axes)."""
    nd, vnd = len(oshape), len(v.shape)
    out = []
    for i in range(nd):
        j = i - (nd - vnd)
        if j < 0 or v.shape[j] == 1 and oshape[i] != 1:
            out.append(0)
        else:
            out.append(v.strides[j])
    return out


def _infer_input_dim(ref, name):
    """Last-dim size of graph input `name` from its first consumer."""
    for nd in ref.nodes:
        if name not in nd["inputs"]:
            continue
        op = nd["op"]
        if op == "Gemm":
            w = ref.weights[nd["inputs"][1]]
            return w.shape[1] if nd["attrs"].get("transB", 0) else w.shape[0]
        if op == "Reshape":
            shp = ref.weights[nd["inputs"][1]]
            return int(np.prod([int(d) for d in shp]))
    raise ValueError(f"cannot infer input dim for {name}")
