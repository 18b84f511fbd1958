"""Native host cores of the deploy stack (counterpart of
`pbhc_tpu/deploy/native/__init__.py`).

`mlp_infer.cpp` and `onnx_exec.cpp` are host C++ for the robot's onboard
CPU, the port's copies of the JAX package's: a deterministic per-tick
latency at batch 1, where the reference runs onnxruntime's C++ core
(reference urci.py:97-136, deploy_real.py:31). They are not CUDA: the card
is not on the robot.

`host_library` compiles one of them with `g++ -O3 -shared -fPIC` at first
use into `<repo>/build/native/<name>-<hash>/`, keyed by a hash of the source
and the flags, and loads it with `ctypes`. Nothing is built next to the
sources, and no `-march=native`: a library cached under `build/` may be read
by another host. A failed build raises. `NativePolicy` runs an `.npz`
export on `mlp_infer`, with the call surface of
`deploy/export.py::NumpyPolicy`.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
_ACT = {"ELU": 0, "ReLU": 1, "Tanh": 2}


def host_library(name: str) -> ctypes.CDLL:
    """`<name>.cpp` of this directory as a loaded shared library, compiled
    first if no build of this source and these flags exists."""
    src = SRC_DIR / f"{name}.cpp"
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + src.read_bytes()).hexdigest()[:16]
    target = BUILD_DIR / f"{name}-{h}" / f"lib{name}.so"
    if not target.is_file():
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = ["g++", *GXX_FLAGS, str(src), "-o", str(tmp)]
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed: {' '.join(cmd)}\n{out.stdout}{out.stderr}")
        os.replace(tmp, target)
    return ctypes.CDLL(str(target))


_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = host_library("mlp_infer")
        lib.mlp_create.restype = ctypes.c_void_p
        lib.mlp_create.argtypes = [ctypes.c_int32]
        lib.mlp_add_layer.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32]
        lib.mlp_infer.restype = ctypes.c_int32
        lib.mlp_infer.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32, ctypes.POINTER(ctypes.c_float)]
        lib.mlp_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativePolicy:
    """Native-core policy: the same `.npz` export and call surface as
    `NumpyPolicy` (obs [d] or [B, d] -> action)."""

    def __init__(self, path):
        lib = _load()
        data = np.load(path)
        self.meta = json.loads(bytes(data["meta_json"]).decode())
        act = _ACT.get(str(self.meta.get("activation", "ELU")), 0)
        self._lib = lib
        self._h = ctypes.c_void_p(lib.mlp_create(act))
        self.layers = []
        for i in range(self.meta["n_layers"]):
            w = np.ascontiguousarray(data[f"w{i}"], dtype=np.float32)
            b = np.ascontiguousarray(data[f"b{i}"], dtype=np.float32)
            self.layers.append((w, b))
            lib.mlp_add_layer(self._h, _fptr(w), _fptr(b), w.shape[0], w.shape[1])
        self.obs_dim = self.layers[0][0].shape[0]
        self.out_dim = self.layers[-1][1].shape[0]
        self._out = np.empty(self.out_dim, dtype=np.float32)

    def _infer(self, row, out):
        r = self._lib.mlp_infer(self._h, _fptr(row), row.shape[0], _fptr(out))
        if r != self.out_dim:      # -1: the row's width is not the first layer's
            raise ValueError(f"native inference of an obs of {row.shape[0]} entries returned {r} "
                             f"(the policy takes {self.obs_dim})")

    def __call__(self, obs):
        obs = np.ascontiguousarray(obs, dtype=np.float32)
        if obs.ndim == 1:
            self._infer(obs, self._out)
            return self._out.copy()
        out = np.empty((obs.shape[0], self.out_dim), dtype=np.float32)
        for i in range(obs.shape[0]):
            self._infer(np.ascontiguousarray(obs[i]), out[i])
        return out

    def close(self):
        """Free the native handle (also done when the policy is collected)."""
        if self._h:
            self._lib.mlp_destroy(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()
