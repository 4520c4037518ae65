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


def source_hash(extra: tuple = ()) -> str:
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *extra)).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(only: tuple = (), defines: tuple = ()) -> Path:
    """Compile (if needed) and return the library path. The ptxas report
    (registers, shared memory, spills) is kept beside it as ``ptxas.txt``.
    ``only``: the ``.cu`` names to build (every source when empty);
    ``defines``: ``-D`` macros (``SAKE_PROBE`` for the clock probe)."""
    extra = (*only, *(f"-D{m}" for m in defines))
    out_dir = BUILD_DIR / source_hash(extra)
    lib_path = out_dir / "libsake_kernels.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    cus = [cu for cu in sorted(CSRC.glob("*.cu")) if not only or cu.name in only]
    objs = [out_dir / f"{cu.stem}.o" for cu in cus]
    flags = (*NVCC_FLAGS, *(f"-D{m}" for m in defines))
    procs = [
        subprocess.Popen([nvcc, *flags, "-I", str(CSRC), "-c", "-o", str(obj), str(cu)],
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


def signatures() -> dict:
    """Every entry's ``(argtypes, restype)``, by symbol name."""
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dims = [I] * 8
    # h0, xs, v0, upd, mask, leaves, strides
    fwd_in = [P] * 5 + [P, P]
    # bh, bx, bv, upd, mask, leaves, leaves_t, strides, resid, dh, dx, dv, 3 outs
    bwd_in = [P] * 5 + [P, P, P] + [P] + [P] * 3 + [P] * 3
    # the sparse edge kernels: hg, ai, oi, d0, m, w, then ... dims (NR, K, F, R, H,
    # Kh, C), stream
    edims = [I] * 7
    # the split ops: op, in, w, (g,) out, (rows,) dims (B, N, R, H, Kh, C), stream
    sdims = [I] * 6
    sig = {
        "sake_resid_fwd": fwd_in + [P] * 6 + [P] + dims + [P],
        "sake_resid_fwd_cluster": fwd_in + [P] * 6 + [P] + dims + [P],
        # #6 on the cluster kernel: h_fin, x_fin, pool
        "sake_resid_infer_cluster": fwd_in + [P] * 3 + dims + [P],
        "sake_resid_bwd": bwd_in + dims + [P],
        # K1's and K2's tensor-core kernels: the arguments of the two above
        "sake_resid_fwd_tc": fwd_in + [P] * 6 + [P] + dims + [P],
        "sake_resid_bwd_tc": bwd_in + dims + [P],
        # their routes (1: the tensor-core kernel) and K1's blocks an SM
        "sake_resid_fwd_tc_route": dims,
        "sake_resid_bwd_tc_route": dims,
        "sake_resid_fwd_tc_occupancy": dims,
        # one product of their routes alone: warps, A, W, out, n, kd, m, stream
        "sake_resid_tc_product": [I, P, P, P, I, I, I, P],
        # ... rows, add_h, add_x, add_v
        "sake_resid_bwd_rows": bwd_in + [P] * 4 + dims + [P],
        # the cluster route: ... rows (no addend)
        "sake_resid_bwd_rows_cluster": bwd_in + [P] + dims + [P],
        # bh, leaves, strides, resid, rows, partial, out, n_chunks
        "sake_param_grads": [P] * 7 + [I] + dims + [P],
        # resid_ef's bf16 tier: K1 (route 0 CUDA cores, 1 tensor cores, 2 #4's
        # cluster) with a pooled scratch after the residuals; #6; K2 (route 0, 1); the
        # one-block rows kernel with rows and the addend; #5's cluster rows kernel; the
        # contraction
        "sake_resid_fwd16": [I] + fwd_in + [P] * 6 + [P, P] + dims + [P],
        "sake_resid_infer_cluster16": fwd_in + [P] * 3 + dims + [P],
        "sake_resid_bwd16": [I] + bwd_in + dims + [P],
        "sake_resid_bwd_rows16": bwd_in + [P] * 4 + dims + [P],
        "sake_resid_bwd_rows_cluster16": bwd_in + [P] + dims + [P],
        "sake_param_grads16": [P] * 7 + [I] + dims + [P],
        # bh, bx, bv, upd, leaves, strides, resid, tx0, tbh, tbx, tbv, 3 finals, tresid
        "sake_resid_jvp": [P] * 15 + dims + [P],
        # bh, bx, bv, tbh, tbx, tbv, upd, leaves, leaves_t, strides, resid, tresid,
        # dh, dx, dv, 3 outs, add_h, add_x, add_v, rows, t_rows, scratch
        "sake_resid_tbwd": [P] * 24 + dims + [P],
        # #9 and #10's tangent chain in the bf16 tier: #9's arguments with an f32
        # pooled scratch after them, #10's as they are
        "sake_resid_jvp16": [P] * 16 + dims + [P],
        "sake_resid_tbwd16": [P] * 24 + dims + [P],
        # bh, tbh, leaves, strides, resid, tresid, rows, rows_t, t_rows, partial, out,
        # ro_part, ro_out, ro_len, n_chunks
        "sake_param_grads_aug": [P] * 13 + [LL, I] + dims + [P],
        # readout of the fused kernels: w0, b0, w1, b1, w0t ... F0, O after the dims
        # h0, xs, upd, leaves, leaves_t, strides, readout, bh, bx, bv, resid, h_fin,
        # x_fin, v_fin, e, dx
        "sake_fused_primal": [P] * 20 + dims + [I, I, P],
        # h0, xs, upd, mask, leaves, leaves_t, strides, readout, bh, bx, bv, resid, e,
        # dx, grid
        "sake_one_ef": [P] * 18 + [I] + dims + [I, I, P],
        "sake_one_ef_grid": dims + [I],
        # bh, bx, bv, upd, leaves, leaves_t, strides, resid, h_fin, tx0, g_e, readout,
        # tbh, tbx, tbv, tresid, rows, rows_t, t_rows, scratch, dh0, dx0, ro_part
        "sake_fused_bwd": [P] * 27 + dims + [I, I, P],
        # #11, #12's block and #12's contraction in resid_ef's bf16 tier: the arguments
        # above, #11 and #12's block with an f32 pooled scratch after them
        "sake_fused_primal16": [P] * 21 + dims + [I, I, P],
        "sake_fused_bwd16": [P] * 28 + dims + [I, I, P],
        "sake_param_grads_aug16": [P] * 13 + [LL, I] + dims + [P],
        # the clock probes (probe.cuh) of #11 and #12, of K1's and K2's sources:
        # out (slots,) u64, reset
        "sake_fused_ef_probe": [P, I],
        "sake_resid_fwd_probe": [P, I],
        "sake_resid_bwd_probe": [P, I],
        "sake_resid_bwd_cl_probe": [P, I],
        "sake_fused_bwd_probe": [P, I],
        "sake_fused_remat_ef_probe": [P, I],  # #20's
        "sake_remat_bwd_probe": [P, I],  # #22's and #24's
        # #13's, #14's and #15's clock probes
        "sake_sparse_fwd_probe": [P, I],
        "sake_sparse_bwd_probe": [P, I],
        "sake_sparse_bwd2_probe": [P, I],
        # the contractions' clock probes
        "sake_sparse_contract_probe": [P, I],
        "sake_param_grads_probe": [P, I],
        # h0, xs, tx0, upd, leaves, strides, the primal's and the tangent's bh, bx, bv,
        # h_fin, x_fin, v_fin, resid, tresid
        "sake_aug_fwd": [P] * 20 + dims + [P],
        "sake_retrace_fwd": [P] * 20 + dims + [P],
        # #18 in the bf16 tier: ... the one-layer f32 scratches, then the streams; #16's
        # as sake_retrace_fwd's
        "sake_aug_fwd16": [P] * 22 + dims + [P],
        "sake_retrace_fwd16": [P] * 20 + dims + [P],
        # #17 in the bf16 tier: layer, as sake_retrace_bwd's without its third row
        # set; then its contraction: sake_param_grads_aug's first 11, partial16;
        # n_chunks, tile, sub
        "sake_retrace_bwd16": [I] + [P] * 21 + dims + [P],
        "sake_retrace_grads16": [P] * 12 + [I, I, I] + dims + [P],
        # layer, bh, bx, bv, tbh, tbx, tbv, upd, leaves, leaves_t, strides, resid, tresid,
        # rows, rows_t, t_rows, scratch, cp_dh, cp_dx, cp_dv, ct_dh, ct_dx, ct_dv
        "sake_retrace_bwd": [I] + [P] * 22 + dims + [P],
        # layers l0, l1; h_in, x_in, v_in, upd, leaves, strides, bh, bx, bv, pool, h_out,
        # x_out, v_out
        "sake_remat_fwd": [I, I] + [P] * 13 + dims + [P],
        # #21's and #23's route (1: the tensor-core kernel)
        "sake_remat_fwd_tc": dims,
        # layers l_hi, l_lo; bh, bx, bv, upd, leaves, leaves_t, strides, resid, dh_in,
        # dx_in, dv_in, dh_out, dx_out, dv_out
        "sake_remat_bwd": [I, I] + [P] * 14 + dims + [P],
        "sake_remat_bwd_tc": dims,  # #22's and #24's route: 1 the tensor cores, 0 the CUDA cores
        # #20: bf16; h, x, upd, leaves, leaves_t, strides, w_emb, b_emb, readout (w0, b0,
        # w1, b1, w0t), bh, bx, bv, resid, e, f; grid; dims; F_in, F0, O
        "sake_fused_remat_ef": [I] + [P] * 19 + [I] + dims + [I, I, I, P],
        "sake_fused_remat_ef_grid": [I] + dims + [I, I],  # ..., F_in, F0
        "sake_fused_remat_ef_tc": dims,  # 1: the tensor-core route, 0: the CUDA cores
        # passes, A, W, out, n, kd, m, stream
        "sake_fused_remat_ef_tc_product": [I, P, P, P, I, I, I, P],
        "sake_sparse_fwd": [P] * 6 + [P, P] + edims + [P],  # pooled, hatt
        "sake_sparse_bwd": [P] * 6 + [P, P] + [P] * 4 + edims + [P],  # gp, gh, 4 outs
        "sake_sparse_bwd_rows": [P] * 6 + [P, P] + [P] * 4 + [P] + edims + [P],
        # ... gp, gh, 4 cotangents, 6 outs, rows, t_rows
        "sake_sparse_bwd2": [P] * 6 + [P, P] + [P] * 4 + [P] * 6 + [P, P] + edims + [P],
        # the most slots a row may have on #13's, #14's and #15's route at (F, R, H, Kh, C)
        "sake_sparse_fwd_max_slots": [I] * 5,
        "sake_sparse_bwd_max_slots": [I] * 5,
        "sake_sparse_bwd2_max_slots": [I] * 5,
        # n_terms, a, na, g, ng, leaf, E, n_chunks, partial, leaf_off, n_leaves, out, stream
        "sake_sparse_contract": [I, P, P, P, P, P, LL, I, P, P, I, P, P],
        "sake_split_fwd": [I, P, P, P] + sdims + [P],
        "sake_split_bwd": [I, P, P, P, P, P] + sdims + [P],
        # op, dims: 1 where the forward (pullback) takes the tensor-core route
        "sake_split_fwd_tc": [I] + sdims,
        "sake_split_bwd_tc": [I] + sdims,
        "sake_split_fwd_probe": [P, I],  # #25's and #27's clock probe
        "sake_split_bwd_probe": [P, I],  # #26's and #28's clock probe
    }
    out = {name: (args, I) for name, args in sig.items()}
    for fn in ("sake_resid_fwd_cluster_max_active", "sake_resid_bwd_cluster_max_active"):
        out[fn] = (dims, I)
    for fn in ("sake_resid_fwd_smem_bytes", "sake_resid_bwd_smem_bytes",
               "sake_resid_fwd_tc_smem_bytes", "sake_resid_bwd_tc_smem_bytes",
               "sake_resid_fwd_cluster_smem_bytes", "sake_resid_bwd_cluster_smem_bytes",
               "sake_resid_jvp_smem_bytes", "sake_resid_tbwd_smem_bytes",
               "sake_aug_fwd_smem_bytes", "sake_retrace_bwd_smem_bytes",
               "sake_retrace_bwd16_smem_bytes",
               "sake_remat_fwd_smem_bytes", "sake_remat_bwd_smem_bytes"):
        out[fn] = (dims, LL)
    for fn in ("sake_fused_ef_smem_bytes", "sake_fused_bwd_smem_bytes",  # ..., F0
               "sake_fused_primal16_smem_bytes", "sake_fused_bwd16_smem_bytes"):
        out[fn] = (dims + [I], LL)
    out["sake_fused_remat_ef_smem_bytes"] = (dims + [I, I], LL)
    out["sake_split_smem_bytes"] = ([I, I] + sdims, LL)
    out["sake_error_string"] = ([I], ctypes.c_char_p)
    return out


def declare(lib, names=None):
    """Declare the argument and result types of ``names`` (every entry when
    None) on a loaded library; returns it."""
    for name, (args, res) in signatures().items():
        if names is None or name in names:
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
    return lib


def load():
    """The loaded library, with argument types declared for every entry."""
    global _lib
    if _lib is None:
        _lib = declare(ctypes.CDLL(str(build())))
    return _lib


def check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}: {lib.sake_error_string(err).decode()}")
