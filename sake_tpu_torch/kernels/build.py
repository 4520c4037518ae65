"""Build the hand-written CUDA kernels of ``sake_tpu_torch/csrc`` at first
use and load them with ``ctypes``.

``nvcc`` compiles each ``csrc/*.cu`` to an object, all sources at once in
parallel processes, and links the objects into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds). The
library lands in ``sake_tpu_torch/_build/<hash>/``, keyed by a hash of the
sources and the flags, so an edit rebuilds and an unchanged tree reuses it.
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
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    cus = sorted(CSRC.glob("*.cu"))
    objs = [out_dir / f"{cu.stem}.o" for cu in cus]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(cu)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cu, obj in zip(cus, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    (out_dir / "ptxas.txt").write_text("".join(logs))
    failed = [(cu.name, p.returncode, log) for cu, p, log in zip(cus, procs, logs)
              if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{name} ({rc}):\n{log[-4000:]}" for name, rc, log in failed))
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", tmp, *map(str, objs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr[-4000:]}")
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
    # h0, xs, v0, upd, mask, leaves, strides
    fwd_in = [P] * 5 + [P, P]
    lib.sake_resid_fwd.argtypes = fwd_in + [P] * 6 + [P] + dims + [P]
    lib.sake_resid_infer.argtypes = fwd_in + [P] * 3 + dims + [P]
    # bh, bx, bv, upd, mask, leaves, leaves_t, strides, resid, dh, dx, dv, 3 outs
    bwd_in = [P] * 5 + [P, P, P] + [P] + [P] * 3 + [P] * 3
    lib.sake_resid_bwd.argtypes = bwd_in + dims + [P]
    # ... rows, add_h, add_x, add_v
    lib.sake_resid_bwd_rows.argtypes = bwd_in + [P] * 4 + dims + [P]
    # bh, leaves, strides, resid, rows, partial, out, per_chunk
    lib.sake_param_grads.argtypes = [P] * 7 + [I] + dims + [P]
    # bh, bx, bv, upd, leaves, strides, resid, tx0, tbh, tbx, tbv, 3 finals, tresid
    lib.sake_resid_jvp.argtypes = [P] * 15 + dims + [P]
    # bh, bx, bv, tbh, tbx, tbv, upd, leaves, leaves_t, strides, resid, tresid,
    # dh, dx, dv, 3 outs, add_h, add_x, add_v, rows, t_rows, scratch
    lib.sake_resid_tbwd.argtypes = [P] * 24 + dims + [P]
    # bh, tbh, leaves, strides, resid, tresid, rows, rows_t, t_rows, partial, out,
    # ro_part, ro_out, ro_len, per_chunk
    lib.sake_param_grads_aug.argtypes = [P] * 13 + [LL, I] + dims + [P]
    # readout of the fused kernels: w0, b0, w1, b1, w0t ... F0, O after the dims
    # h0, xs, upd, leaves, leaves_t, strides, readout, bh, bx, bv, resid, h_fin,
    # x_fin, v_fin, e, dx
    lib.sake_fused_primal.argtypes = [P] * 20 + dims + [I, I, P]
    # h0, xs, upd, mask, leaves, leaves_t, strides, readout, bh, bx, bv, resid, e,
    # dx, grid
    lib.sake_one_ef.argtypes = [P] * 18 + [I] + dims + [I, I, P]
    lib.sake_one_ef_grid.argtypes = dims + [I]
    # bh, bx, bv, upd, leaves, leaves_t, strides, resid, h_fin, tx0, g_e, readout,
    # tbh, tbx, tbv, tresid, rows, rows_t, t_rows, scratch, dh0, dx0, ro_part
    lib.sake_fused_bwd.argtypes = [P] * 27 + dims + [I, I, P]
    # the sparse edge kernels: hg, ai, oi, d0, m, w, then ... dims (NR, K, F, R, H,
    # Kh, C), stream
    edims = [I] * 7
    lib.sake_sparse_fwd.argtypes = [P] * 6 + [P, P] + edims + [P]  # pooled, hatt
    lib.sake_sparse_bwd.argtypes = [P] * 6 + [P, P] + [P] * 4 + edims + [P]  # gp, gh, 4 outs
    lib.sake_sparse_bwd_rows.argtypes = [P] * 6 + [P, P] + [P] * 4 + [P] + edims + [P]
    # ... gp, gh, 4 cotangents, 6 outs, rows, t_rows
    lib.sake_sparse_bwd2.argtypes = [P] * 6 + [P, P] + [P] * 4 + [P] * 6 + [P, P] + edims + [P]
    # n_terms, a, na, g, ng, leaf, E, n_chunks, partial, leaf_off, n_leaves, out, stream
    lib.sake_sparse_contract.argtypes = [I, P, P, P, P, P, LL, I, P, P, I, P, P]
    for fn in ("sake_resid_fwd", "sake_resid_infer", "sake_resid_bwd", "sake_resid_bwd_rows",
               "sake_param_grads", "sake_resid_jvp", "sake_resid_tbwd", "sake_param_grads_aug",
               "sake_fused_primal", "sake_one_ef", "sake_one_ef_grid", "sake_fused_bwd",
               "sake_sparse_fwd", "sake_sparse_bwd", "sake_sparse_bwd_rows", "sake_sparse_bwd2",
               "sake_sparse_contract"):
        getattr(lib, fn).restype = I
    for fn in ("sake_resid_fwd_smem_bytes", "sake_resid_bwd_smem_bytes",
               "sake_resid_jvp_smem_bytes", "sake_resid_tbwd_smem_bytes"):
        getattr(lib, fn).argtypes = dims
        getattr(lib, fn).restype = LL
    for fn in ("sake_fused_ef_smem_bytes", "sake_fused_bwd_smem_bytes"):  # ..., F0
        getattr(lib, fn).argtypes = dims + [I]
        getattr(lib, fn).restype = LL
    lib.sake_error_string.argtypes = [I]
    lib.sake_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}: {lib.sake_error_string(err).decode()}")
