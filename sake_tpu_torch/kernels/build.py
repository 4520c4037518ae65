"""Build the hand-written CUDA kernels of ``sake_tpu_torch/csrc`` at first
use and load them with ``ctypes``.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain
C interface (no PyTorch headers, so a build takes seconds). The library
lands in ``sake_tpu_torch/_build/<hash>/``, keyed by a hash of the sources
and the flags, so an edit rebuilds and an unchanged tree reuses it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the library path. The ptxas report
    (registers, shared memory, spills) is kept beside it as ``ptxas.txt``."""
    out_dir = BUILD_DIR / source_hash()
    lib_path = out_dir / "libsake_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *cu],
        capture_output=True, text=True,
    )
    (out_dir / "ptxas.txt").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib_path)
    return lib_path


def load():
    """The loaded library, with argument types declared for every entry."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dims = [I] * 8
    lib.sake_resid_fwd.argtypes = [P] * 4 + [P, P] + [P] * 6 + [P] + dims + [P]
    lib.sake_resid_fwd.restype = I
    lib.sake_resid_bwd.argtypes = [P] * 4 + [P, P, P] + [P] + [P] * 3 + [P] * 3 + dims + [P]
    lib.sake_resid_bwd.restype = I
    lib.sake_resid_fwd_smem_bytes.argtypes = dims
    lib.sake_resid_fwd_smem_bytes.restype = LL
    lib.sake_resid_bwd_smem_bytes.argtypes = dims
    lib.sake_resid_bwd_smem_bytes.restype = LL
    lib.sake_error_string.argtypes = [I]
    lib.sake_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}: {lib.sake_error_string(err).decode()}")
