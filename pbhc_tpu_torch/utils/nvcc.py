"""Build the port's CUDA sources into plain-C shared libraries with `nvcc`.

Each library is compiled for `sm_90a` at first use into
`<repo>/build/kernels/<name>-<hash>/`, keyed by a hash of its sources, the
headers they include and the flags, and loaded with `ctypes`. No PyTorch
headers are involved, so a build takes seconds. Nothing here runs at import
time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
CSRC = REPO_ROOT / "pbhc_tpu_torch" / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class CudaLibrary:
    """One shared library: its name, the sources `nvcc` compiles and the
    headers they include (hashed, never compiled on their own), all under
    `root`: `csrc/`, or an earlier design's sources for the A/B timing of a
    kernel redesign (`eval/kernel_bench.py old=`)."""

    name: str
    sources: tuple
    headers: tuple = ()
    root: Path = CSRC

    def paths(self):
        return [self.root / s for s in self.sources]

    def target(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in self.paths() + [self.root / s for s in self.headers]:
            h.update(p.name.encode())
            h.update(p.read_bytes())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}" / f"lib{self.name}.so"


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: set CUDA_HOME or install the CUDA toolkit "
                       "under /usr/local/cuda")


def build(libs) -> dict:
    """Compile every library in `libs` that is not built yet, all `nvcc`
    processes at once. Returns {name: compiler output}; raises on failure."""
    nvcc = find_nvcc()
    procs = {}
    for lib in libs:
        target = lib.target()
        if target.is_file():
            continue
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, lib.paths())]
        procs[lib.name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True), tmp, target, cmd)
    logs = {}
    failed = []
    for name, (proc, tmp, target, cmd) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def load(lib: CudaLibrary) -> ctypes.CDLL:
    """The library, built first if needed."""
    target = lib.target()
    if not target.is_file():
        build([lib])
    return ctypes.CDLL(str(target))
