"""Run a kernel source on the CPU against its plain version: #20
(``csrc/fused_remat_ef.cu``), or with ``--train`` #11 (``csrc/fused_ef.cu``) and
#12's block (``csrc/fused_bwd.cu``), or with ``--sparse`` #13 (``csrc/sparse_fwd.cu``),
#14 in both instantiations (``csrc/sparse_bwd.cu``, with the contraction) and #15
(``csrc/sparse_bwd2.cu``, with the contraction).

    EMU_THREADS=128 python tools/cuda_emu/emulate.py                  # hidden 8 and 16
    EMU_THREADS=128 python tools/cuda_emu/emulate.py --hidden 64 --depth 3 --atoms 21
    EMU_THREADS=128 python tools/cuda_emu/emulate.py --asan          # AddressSanitizer
    EMU_THREADS=128 python tools/cuda_emu/emulate.py --train --hidden 8 16 64 --atoms 21
    EMU_THREADS=128 python tools/cuda_emu/emulate.py --train --bf16 --hidden 8 64 --atoms 7 21
    EMU_THREADS=128 python tools/cuda_emu/emulate.py --helper        # mma_tf32x3.cuh alone
    python tools/cuda_emu/emulate.py --wgmma                          # wgmma_tf32.cuh alone
    python tools/cuda_emu/emulate.py --sparse --slots 64 48 80 37      # #13, #14, #15
    python tools/cuda_emu/emulate.py --contract                        # the contractions
    EMU_THREADS=128 python tools/cuda_emu/emulate.py --qm9 --hidden 8 16 64 --atoms 29 21 16 7
    EMU_THREADS=128 python tools/cuda_emu/emulate.py --remat --hidden 8 16 64 --atoms 21
    EMU_THREADS=128 python tools/cuda_emu/emulate.py --serving --hidden 8 16 64 --atoms 21 7 22
    python tools/cuda_emu/emulate.py --split --hidden 8 16 64 --atoms 21 22 7 17 --batch 2

Compiles the kernel source with g++ against ``cuda_runtime.h`` beside this file
(one std::thread per CUDA thread; see there), loads it with ctypes in place of
``build.load()``, and calls ``fused_ef.launch`` with CPU tensors, in f32 and in
bf16, printing each mode's max relative error against ``fused_ef_plain`` and the
plain bf16 version's distance from plain f32. With ``--train`` it calls
``train2_ef``'s ``_launch_fused_primal`` and ``_launch_fused_bwd_block`` and prints
each output's max relative error against ``fused_primal_plain`` and
``fused_bwd_block_plain``; at aspirin's widths (hidden 64, 4 heads) their x-mixing
and edge products take the emulated tensor cores. A check before a kernel's first call on
the card, not a measurement of it. With ``--sparse`` it calls ``sparse_ef``'s
``_launch_fwd``, ``_launch_bwd`` and ``_launch_bwd_grads`` on the seeded inputs of
``tools/probe_sparse.py`` at the sparse widths and ``--slots`` K, and
``_launch_bwd2`` where K is within #15's limit (67 there), whose x-mixing
takes the emulated ``wgmma``; ``--wgmma`` holds ``wgmma_tf32.cuh``'s
product alone against float64. With ``--contract`` it runs the two gradient
contractions on the emulated f64 tensor cores (``dmma_f64.cuh``):
``sparse_ef._contract`` (``csrc/sparse_contract.cu``) on random rows at the
sparse widths for each ``--slots`` K (``--rows`` receiver rows; E not a multiple
of the 1024-edge chunk) and at narrow widths (C = 12, R = 6, 3 heads), under
``GRAD_TERMS`` and ``aug_terms`` against ``contract_plain``; and
``resid_ef._launch_param_grads`` and ``train2_ef._launch_param_grads_aug``
(``csrc/param_grads.cu``) on ``tools/probe_contract.py``'s random inputs at each
``--hidden`` x ``--batch`` x ``--atoms`` (``--depth`` layers) against
``param_grads_plain`` and ``param_grads_aug_plain``. With ``--qm9`` it runs the
cluster kernels of #4, #6 and #5's rows kernel (``csrc/resid_fwd.cu``,
``csrc/resid_bwd_cl.cu``: one molecule per two-CTA cluster, the emulated CTAs of a
cluster at once, with distributed shared memory and the cluster barrier) through
``resid_ef._launch_fwd`` and ``_bwd_launch`` on the cluster route, and #6's (the
same source's cluster kernel without streams) through ``resid_ef._launch_infer``,
at each ``--hidden`` x ``--atoms`` N, masked (padded molecules, one of them a single
atom) and unmasked, against ``resid_fwd_plain`` (boundaries, final state, all 17
residuals), ``resid_infer_plain`` (h_fin, x_fin; also whether they equal #4's bit
for bit) and ``resid_bwd_rows_plain`` (dh, dx, dv, all 20 rows); at hidden 64
(H * K = C = 256) and N <= 32 their products take the emulated tensor cores. With
``--remat`` it runs #21 and #23 (``csrc/remat_ef.cu``'s forward, one launch over
every layer and one launch per layer) through ``fori_ef._launch_fwd`` on the
kernel the shape takes (at hidden 64 and N <= 21 ``remat_fwd_kernel<true>``,
K1's tensor-core body; at N = 22 and the narrow widths ``<false>``), against
``fori_fwd_plain`` and ``depthgrid_fwd_plain``;
then #22 and #24 (``remat_bwd_kernel``, the same two orchestrations) through
``fori_ef._launch_bwd`` on the plain forward's boundaries at each ``--hidden`` x
``--atoms`` N (``--depth`` layers, gates 1 and 0.4), against ``fori_bwd_plain`` and
``depthgrid_bwd_plain``; at hidden 64 their products take the emulated tensor
cores (``tensor_core_route``).
With ``--serving`` it runs K1 and K2 (``csrc/resid_fwd.cu``, ``csrc/resid_bwd.cu``)
on both of their one-block routes through ``resid_ef._launch_fwd`` and
``_bwd_launch`` at each ``--hidden`` x ``--atoms`` N, masked (padded molecules, one
a single atom) and unmasked, against ``resid_fwd_plain`` (boundaries, final state,
all 17 residuals) and ``resid_bwd_plain`` (dh, dx, dv): the CUDA-core kernels
everywhere, the tensor-core kernels where the shape takes them (K1 at hidden 64 up
to N = 21, where two blocks fit an SM; K2 up to N = 22; a launch off that route
must be refused), then K1's and K2's tensor-core products alone
(``sake_resid_tc_product``) against float64.
``--bf16`` runs ``--serving`` and ``--qm9`` in resid_ef's bf16 tier (bf16 edge
products and residual streams: the kernels' kE16 instantiations, through the
wrappers' ``bf16`` and the tier's streams) against the plain bf16 versions, and
with ``--qm9`` also the contraction (``csrc/param_grads.cu``'s
``sake_param_grads16``) against ``param_grads_plain``; with ``--train`` #11
(``csrc/fused_ef16.cu``), #12's block (``csrc/fused_bwd16.cu``) and the augmented
contraction (``sake_param_grads_aug16``) at each ``--hidden`` x ``--atoms`` against
``fused_primal_plain``, ``fused_bwd_block_plain`` and ``param_grads_aug_plain``
(sums in float64) in the tier; each line also prints the plain bf16 version's
distance from the plain f32 one.
With ``--split`` it runs the split forwards #25 (the edge_att and coeff_pool ops)
and #27 (the merged op) of ``csrc/split_fwd.cu`` through ``split_ef._launch_fwd``
against the plain bodies (``tools/probe_split.check_forwards``: twice bit for
bit), then the pullbacks #26 and #28 of ``csrc/split_bwd.cu`` through
``split_ef._launch_bwd`` (the weight cotangents through
``csrc/sparse_contract.cu``; ``tools/probe_split.check_pullbacks``: with and
without weight cotangents, twice bit for bit) against ``split_ef.vjp_plain``, at
each ``--hidden`` x ``--atoms`` N (``--batch`` molecules), each on the kernel the
shape takes: at hidden 64 (H * K = C = 256) the tensor-core route, ``64 // N``
receiver rows a tile (N = 21: three; 22: two; 17: a last group of two; 7: one
group of seven), the x-mixing on the emulated ``wgmma`` and the edge products on
the emulated ``mma.sync``; the CUDA-core route at hidden 8 and 16.
``--asan`` needs the script started with g++'s libasan and libstdc++ preloaded
(it prints the ``LD_PRELOAD`` line).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from sake_tpu_torch.kernels import build, fused_ef  # noqa: E402
from sake_tpu_torch.kernels.adapter import linen_tree, model_params_from_linen  # noqa: E402
from sake_tpu_torch.models import SAKEModel  # noqa: E402


def compile_source(source: str, out_dir: Path, asan: bool, extra_src: Path = None,
                   opt=("-O1", "-g")) -> Path:
    """``csrc/<source>`` (or ``extra_src/<source>``) and its headers, launches
    rewritten, into a shared library (``opt``: g++'s optimisation flags)."""
    src = out_dir / "src"
    src.mkdir(parents=True, exist_ok=True)
    extra = list(extra_src.glob("*.cu")) if extra_src else []
    for p in list(build.CSRC.glob("*.cu")) + list(build.CSRC.glob("*.cuh")) + extra:
        s = p.read_text().replace("extern __shared__ float4 smem4[];",
                                  "float4* smem4 = emu_smem();")
        s = re.sub(r"([\w:]+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\s*\(", r"emu_launch(\1, \2, ", s,
                   flags=re.S)
        (src / p.name).write_text(s)
    lib = out_dir / f"{Path(source).stem}.so"
    flags = ["-fsanitize=address", "-fno-omit-frame-pointer"] if asan else []
    subprocess.run(["g++", "-std=c++20", *opt, "-fPIC", "-shared", *flags,
                    "-I", str(Path(__file__).parent), "-I", str(src), "-x", "c++",
                    str(src / source), "-o", str(lib), "-lpthread"], check=True)
    return lib


def load(lib_path: Path, names=None):
    """The emulated library, its entries (``names``; #20's when None) declared
    by ``build.declare``."""
    names = names or [n for n in build.signatures() if n.startswith("sake_fused_remat_ef")]
    lib = build.declare(ctypes.CDLL(str(lib_path)), names)
    lib.sake_error_string = lambda err: b"emulated"
    return lib


class Libs:
    """Several emulated libraries as one: an entry is looked up in turn."""

    def __init__(self, *libs):
        self.libs = libs

    def __getattr__(self, name):
        for lib in self.libs:
            if hasattr(lib, name):
                return getattr(lib, name)
        raise AttributeError(name)


def check_helper(tmp: Path, asan: bool):
    """mm_tc and mm_tc_small against a float64 product and ``mm_tf32x3_plain``
    at the shapes of the kTc sites (max |diff| / max |ref|)."""
    import numpy as np

    from sake_tpu_torch.kernels.tf32 import mm_tf32x3_plain

    src = tmp / "src"
    src.mkdir(parents=True, exist_ok=True)
    (src / "mma_check.cu").write_text((Path(__file__).parent / "mma_check.cu").read_text())
    lib_path = compile_source("mma_check.cu", tmp, asan, extra_src=src)
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sake_mma_check.argtypes = [I, I, I, I, P, I, P, P]
    rng = np.random.default_rng(0)
    for which, n, kd, m in ((3, 21, 256, 256), (6, 42, 256, 256), (3, 12, 256, 256),
                            (0, 21, 50, 64), (0, 21, 64, 50), (0, 42, 64, 64)):
        lda = kd + (8 if which else 0)
        a = torch.from_numpy(rng.standard_normal((n, kd)).astype(np.float32))
        w = torch.from_numpy((rng.standard_normal((kd, m)) / np.sqrt(kd)).astype(np.float32))
        a_pad = torch.zeros(n, lda)
        a_pad[:, :kd] = a
        out = torch.full((n, m), float("nan"))
        lib.sake_mma_check(which, n, kd, m, a_pad.data_ptr(), lda, w.data_ptr(), out.data_ptr())
        ref = a.double() @ w.double()
        rel = lambda x: float((x.double() - ref).abs().max() / ref.abs().max())
        print(f"{'mm_tc' if which else 'mm_tc_small'} {n} x {kd} @ {kd} x {m}: vs float64 "
              f"{rel(out):.3e}, plain 3xTF32 vs float64 {rel(mm_tf32x3_plain(a, w)):.3e}, "
              f"finite {bool(torch.isfinite(out).all())}", flush=True)


def check_wgmma(tmp: Path, asan: bool):
    """wg_xmix (``wgmma_tf32.cuh``) against a float64 product and
    ``mm_tf32x3_chunked_plain`` (max |diff| / max |ref|) at the sparse shapes:
    64, 48 and 37 rows of 256 against 256 x 256, rings of 2 and 3 stages, the
    product run twice in a row (the ring's phases wrap)."""
    import numpy as np

    from sake_tpu_torch.kernels.tf32 import mm_tf32x3_chunked_plain, wgmma_planes

    src = tmp / "src"
    src.mkdir(parents=True, exist_ok=True)
    (src / "wgmma_check.cu").write_text((Path(__file__).parent / "wgmma_check.cu").read_text())
    lib = ctypes.CDLL(str(compile_source("wgmma_check.cu", tmp, asan, extra_src=src)))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sake_wgmma_check.argtypes = [I, P, P, P, I, I]
    rng = np.random.default_rng(0)
    worst = 0.0
    for n, stages in ((64, 3), (48, 2), (37, 3)):
        a = torch.from_numpy(rng.standard_normal((n, 256)).astype(np.float32))
        w = torch.from_numpy((rng.standard_normal((256, 256)) / 16).astype(np.float32))
        out = torch.full((n, 256), float("nan"))
        bpk = wgmma_planes(w.T.contiguous())  # B K-major: row c holds w[:, c]
        lib.sake_wgmma_check(n, a.data_ptr(), bpk.data_ptr(), out.data_ptr(), stages, 2)
        ref = a.double() @ w.double()
        rel = lambda x: float((x.double() - ref).abs().max() / ref.abs().max())
        worst = max(worst, rel(out))
        print(f"wg_xmix {n} x 256 @ 256 x 256, {stages} stages: vs float64 {rel(out):.3e}, "
              f"plain chunked 3xTF32 vs float64 {rel(mm_tf32x3_chunked_plain(a, w)):.3e}, "
              f"f32 vs float64 {rel(a @ w):.3e}, finite {bool(torch.isfinite(out).all())}",
              flush=True)
    return worst


def check_sparse(K: int, NR: int):
    """#13, #14 and #14's rows instantiation (and its contraction), and #15
    where K is within its limit, against their plain versions at K slots, NR
    receiver rows; returns the worst relative error."""
    import importlib.util

    from sake_tpu_torch.kernels import sparse_ef as se

    spec = importlib.util.spec_from_file_location(  # its seeded inputs at the sparse widths
        "probe_sparse", ROOT / "tools" / "probe_sparse.py")
    probe_sparse = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe_sparse)
    hg, ai, oi, d0, m, ep, gp, gh = probe_sparse.sparse_inputs(NR, K, seed=K)
    rel = lambda a, b: float((a - b).abs().max() / (b.abs().max() + 1e-30))
    worst = 0.0
    t0 = time.perf_counter()
    k13, p13 = se._launch_fwd(hg, ai, oi, d0, m, ep), se.sparse_fwd_plain(hg, ai, oi, d0, m, ep)
    wt = se.edge_transposes(ep)
    k14 = se._launch_bwd(hg, ai, oi, d0, m, ep, gp, gh, wt)
    p14 = se.sparse_bwd_plain(hg, ai, oi, d0, m, ep, gp, gh)
    kg = se._launch_bwd_grads(hg, ai, oi, d0, m, ep, gp, gh, wt)
    pg = se.sparse_bwd_plain(hg, ai, oi, d0, m, ep, gp, gh, True)
    checks = [("#13 sparse_fwd", zip(("pooled", "hatt"), k13, p13)),
              ("#14 sparse_bwd", zip(("d_h_g", "d_a_i", "d_o_i", "d_d0"), k14, p14)),
              ("#14 sparse_bwd_grads",
               [*zip(("d_h_g", "d_a_i", "d_o_i", "d_d0"), kg[:4], pg[:4]),
                *((f"dW.{n}", kg[4][n], pg[4][n]) for n in se.EDGE_LEAVES)])]
    widths = (hg.shape[2], ai.shape[1], oi.shape[1], ep["w_sem"].shape[1], gp.shape[-1])
    if K <= build.load().sake_sparse_bwd2_max_slots(*widths):
        cg = probe_sparse.cotangents(hg, ai, oi, d0, seed=K)
        k15 = se._launch_bwd2(hg, ai, oi, d0, m, ep, gp, gh, *cg, wt)
        p15 = se.sparse_bwd2_plain(hg, ai, oi, d0, m, ep, gp, gh, *cg)
        checks.append(("#15 sparse_bwd2",
                       [*zip(("e_hg", "e_ai", "e_oi", "e_d0", "e_gp", "e_gh"), k15[:6], p15[:6]),
                        *((f"dW2.{n}", k15[6][n], p15[6][n]) for n in se.EDGE_LEAVES)]))
    for name, pairs in checks:
        errs = {n: rel(a, b) for n, a, b in pairs}
        w = max(errs, key=errs.get)
        worst = max(worst, errs[w])
        print(f"{name} K {K} NR {NR}: max rel err {errs[w]:.3e} ({w})", flush=True)
    print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    return worst


def check_split(hid: int, B: int, N: int) -> float:
    """#25 (both ops) and #27 on the route the shape takes against the plain
    bodies (``tools/probe_split.check_forwards``), then #26 (both ops) and #28
    against ``vjp_plain`` (``check_pullbacks``); returns the worst relative
    error, and fails where the route is not the one expected at these widths
    (the tensor cores at hidden 64) or two launches differ."""
    import importlib.util

    from sake_tpu_torch.kernels import split_ef as se

    spec = importlib.util.spec_from_file_location("probe_split", ROOT / "tools" / "probe_split.py")
    ps = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ps)
    t0 = time.perf_counter()
    case = ((f"hidden {hid}, B={B}, N={N}", hid, B, N),)
    cpu = torch.device("cpu")
    res = {"fwd": ps.check_forwards(cpu, case, launch=lambda kind, a: se._launch_fwd(
               f"{kind}_fwd", kind, a)),
           "bwd": ps.check_pullbacks(cpu, case, launch=lambda kind, a, c, w: se._launch_bwd(
               f"{kind}_bwd", kind, a, c, w))}
    worst = 0.0
    want = "tensor cores" if hid == 64 else "CUDA cores"
    for d, r in res.items():
        for (label, kind), (err, route, bitwise) in r.items():
            print(f"split {kind}_{d} {label}: max rel err {err:.3e}, route {route}, two "
                  f"launches bitwise {bitwise}", flush=True)
            if route != want or not bitwise:
                sys.exit(f"split {kind}_{d} {label}: route {route} (want {want}), bitwise "
                         f"{bitwise}")
            worst = max(worst, err)
    print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    return worst


def _rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / (b.double().abs().max() + 1e-30))


def check_contract_sparse(K: int, NR: int, F=64, R=50, H=64, Kh=4, C=256, seed=0):
    """The sparse contraction under #14's and #15's terms against
    ``contract_plain`` (f64) on random rows; returns the worst leaf's relative
    error."""
    from sake_tpu_torch.kernels import sparse_ef as se

    g = torch.Generator().manual_seed(seed)
    rows = {n: torch.randn(NR * K, w, generator=g)
            for n, w in se._row_widths((NR, K, F, R, H, Kh, C)).items()}
    rows["h_g"] = torch.randn(NR * K, F, generator=g)
    for n in list(rows):
        rows["t_" + n] = torch.randn(rows[n].shape, generator=g)
    shapes = dict(w_in_j=(F, R), w_o_j=(F, H), rbf_m=(1, R), rbf_b=(1, R), w_o_f=(R, H),
                  w_o_r=(1, H), w_o1=(H, H), b_o1=(1, H), w_sem=(H, Kh), b_sem=(1, Kh),
                  w_xmix=(H * Kh, C))
    worst = 0.0
    for name, terms in (("#14 with dW", se.GRAD_TERMS), ("#15", se.aug_terms(se.GRAD_TERMS))):
        t0 = time.perf_counter()
        got = se._contract(build.load(), rows, terms, shapes, NR * K, "cpu")
        want = se.contract_plain(rows, terms)
        errs = {n: _rel(got[n], want[n]) for n in want}
        w = max(errs, key=errs.get)
        worst = max(worst, errs[w])
        print(f"sparse_contract {name} K {K} NR {NR} (E {NR * K}, C {C}, R {R}, heads {Kh}): "
              f"max rel err {errs[w]:.3e} ({w}) ({time.perf_counter() - t0:.1f} s)", flush=True)
    return worst


def check_contract_dense(hid: int, B: int, N: int, depth: int):
    """``param_grads.cu`` in both instantiations against its plain versions on
    ``tools/probe_contract.py``'s random inputs; returns the worst leaf's
    relative error."""
    import importlib.util

    from sake_tpu_torch.kernels import resid_ef
    from sake_tpu_torch.kernels import train2_ef as t2

    spec = importlib.util.spec_from_file_location("probe_contract",
                                                  ROOT / "tools" / "probe_contract.py")
    pc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pc)
    worst = 0.0
    for aug in (False, True):
        t0 = time.perf_counter()
        ins = pc.dense_inputs(B, N, aug, torch.device("cpu"), hidden=hid, depth=depth)
        if aug:
            got, want = t2._launch_param_grads_aug(*ins)[0], t2.param_grads_aug_plain(*ins)
        else:
            got, want = resid_ef._launch_param_grads(*ins), resid_ef.param_grads_plain(*ins)
        errs = {n: _rel(got[n], want[n]) for n in want}
        w = max(errs, key=errs.get)
        worst = max(worst, errs[w])
        print(f"param_grads{'_aug' if aug else ''} hidden {hid} B {B} N {N} depth {depth} "
              f"({resid_ef.grad_chunks(B, N, 4, depth)} chunks): max rel err {errs[w]:.3e} ({w}), "
              f"w_xmix {errs['w_xmix']:.3e} ({time.perf_counter() - t0:.1f} s)", flush=True)
    return worst


def check_train(hid: int, depth: int, B: int, N: int, seed: int = 0):
    """#11 and #12's block against their plain versions."""
    from sake_tpu_torch.kernels import train2_ef as t2
    from sake_tpu_torch.kernels.functional import embed
    from sake_tpu_torch.kernels.leaves import transposed, wide_stack

    F_in = 9 if hid == 64 else 5
    model = SAKEModel(hid, 1, depth, in_features=F_in, device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    p = model_params_from_linen(linen_tree(model), device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    h = torch.randn(B, N, F_in, generator=g)
    xs = 1.5 * torch.randn(3, B, N, generator=g)
    tx0, g_e = torch.randn(3, B, N, generator=g), torch.randn(B, generator=g)
    upd = [1.0] * depth
    leaves = wide_stack(p, 4)
    leaves_t = transposed(leaves)
    h0 = embed(p, h).contiguous()
    rel = lambda a, b: float((a - b).abs().max() / (b.abs().max() + 1e-30))
    worst = lambda pairs: max(((rel(a, b), n) for n, a, b in pairs), key=lambda t: t[0])
    names = ("bh", "bx", "bv", "h_fin", "x_fin", "v_fin")
    t0 = time.perf_counter()
    kf, ke, kdx = t2._launch_fused_primal(p, leaves, h0, xs, upd, leaves_t)
    pf, pe, pdx = t2.fused_primal_plain(p, leaves, h0, xs, upd)
    pairs = [("e", ke, pe), ("dx", kdx, pdx), *zip(names, kf[:6], pf[:6]),
             *((n, kf.resid[n], pf.resid[n]) for n in pf.resid)]
    print(f"#11 fused_primal hidden {hid} depth {depth} B {B} N {N}: max rel err "
          f"{worst(pairs)[0]:.3e} ({worst(pairs)[1]}), e {rel(ke, pe):.3e}, dx "
          f"{rel(kdx, pdx):.3e}, finite {bool(torch.isfinite(kdx).all())} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    kb = t2._launch_fused_bwd_block(p, leaves, pf, upd, tx0, g_e, leaves_t)
    pb = t2.fused_bwd_block_plain(p, leaves, pf, upd, tx0, g_e)
    rows = lambda i: [(f"{i}.{n}", kb[i][n], pb[i][n]) for n in pb[i]]
    pairs = [("dh0", kb[0], pb[0]), ("dx0", kb[1], pb[1]), ("ro_part", kb[6], pb[6]),
             *zip(("tbh", "tbx", "tbv"), kb[2][:3], pb[2][:3]),
             *((f"t.{n}", kb[2].resid[n], pb[2].resid[n]) for n in pb[2].resid),
             *rows(3), *rows(4), *rows(5)]
    print(f"#12 fused_bwd_block hidden {hid} depth {depth} B {B} N {N}: max rel err "
          f"{worst(pairs)[0]:.3e} ({worst(pairs)[1]}), dh0 {rel(kb[0], pb[0]):.3e}, dx0 "
          f"{rel(kb[1], pb[1]):.3e}, finite {bool(torch.isfinite(kb[1]).all())} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def _report16(name, label, pairs, ref, t0) -> float:
    """One tier kernel's line: its largest relative error against the plain bf16
    version, the plain bf16 version's distance from the plain f32 one there,
    and the largest share of that distance over the tensors the tier moves.
    Returns the largest error."""
    errs = {n: _rel(a.float(), b.float()) for n, a, b in pairs}
    w = max(errs, key=errs.get)
    finite = all(bool(torch.isfinite(a.float()).all()) for _, a, _ in pairs)
    ratio = {n: e / ref[n] for n, e in errs.items() if ref.get(n, 0.0) >= 1e-5}
    r = max(ratio, key=ratio.get)
    print(f"{name} bf16 {label}: max rel err {errs[w]:.3e} ({w}; plain bf16 from plain f32 "
          f"there {ref.get(w, float('nan')):.3e}); largest share of that distance "
          f"{ratio[r]:.3e} ({r}: {errs[r]:.3e}); finite {finite} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return errs[w]


def _train_inputs(hid: int, depth: int, B: int, N: int, seed: int):
    """A seeded model's ``(params, leaves, leaves_t, h0, xs, tx0, g_e, upd)``."""
    from sake_tpu_torch.kernels.functional import embed
    from sake_tpu_torch.kernels.leaves import transposed, wide_stack

    F_in = 9 if hid == 64 else 5
    model = SAKEModel(hid, 1, depth, in_features=F_in, device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    p = model_params_from_linen(linen_tree(model), device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    h = torch.randn(B, N, F_in, generator=g)
    xs = 1.5 * torch.randn(3, B, N, generator=g)
    tx0, g_e = torch.randn(3, B, N, generator=g), torch.randn(B, generator=g)
    leaves = wide_stack(p, 4)
    return p, leaves, transposed(leaves), embed(p, h).contiguous(), xs, tx0, g_e, [1.0] * depth


def check_modes16(hid: int, depth: int, B: int, N: int, seed: int = 0) -> float:
    """The tier kernels of make_ef_train2's shared, resid and retrace modes
    against their plain bf16 versions: #9 (``sake_resid_jvp16``) on the plain
    bf16 K1 streams, #10's tangent chain (``sake_resid_tbwd16``) and primal chain
    (the one-block rows kernel ``sake_resid_bwd_rows16`` with the plain Hessian
    terms as its addend) on those and the plain #9's, #18 (``sake_aug_fwd16``),
    #16 (``sake_retrace_fwd16``) and #17 (``sake_retrace_bwd16`` with its
    contraction ``sake_retrace_grads16``) on plain #16's boundaries, its edge
    weights rounded per tile of 1 and of 2 molecules.
    Each line with the plain bf16 version's distance from the plain f32 one.
    Returns the worst relative error."""
    from sake_tpu_torch.kernels import resid_ef
    from sake_tpu_torch.kernels import train2_ef as t2

    p, leaves, leaves_t, h0, xs, tx0, g_e, upd = _train_inputs(hid, depth, B, N, seed)
    label = f"hidden {hid} depth {depth} B {B} N {N}"
    g = torch.Generator().manual_seed(seed + 2)
    dh = torch.randn(B, N, hid, generator=g)
    zeros = torch.zeros_like(xs)
    fwd = resid_ef.resid_fwd_plain(leaves, h0, xs, zeros, upd, bf16=True)
    fwd32 = resid_ef.resid_fwd_plain(leaves, h0, xs, zeros, upd)
    worst = 0.0
    state = lambda o: [("bh", o.bh), ("bx", o.bx), ("bv", o.bv), ("h_fin", o.h_fin),
                       ("x_fin", o.x_fin), *((f"r.{n}", o.resid[n]) for n in o.resid)]

    def pairs_ref(k, pb, p32):
        return ([(n, a, b) for (n, a), (_, b) in zip(k, pb)],
                {n: _rel(a.float(), b.float()) for (n, a), (_, b) in zip(pb, p32)})

    t0 = time.perf_counter()
    kt = t2._launch_resid_jvp(leaves, fwd, upd, tx0)
    pt, pt32 = (t2.resid_jvp_plain(leaves, f, upd, tx0) for f in (fwd, fwd32))
    if any(kt.resid[n].dtype != torch.bfloat16 for n in resid_ef.RESID_LOWP):
        raise SystemExit("#9 bf16 wrote a low-precision tangent stream in another dtype")
    worst = max(worst, _report16("#9 resid_jvp", label,
                                 *pairs_ref(state(kt), state(pt), state(pt32)), t0))

    t0 = time.perf_counter()
    flat = lambda o: [("dh0", o[0]), ("dx0", o[1]), ("dv0", o[2]),
                      *((f"add{i}", a) for i, a in enumerate(o[3])),
                      *((f"{i}.{n}", o[i][n]) for i in (4, 5) for n in o[i])]
    kb = t2._launch_resid_tbwd(leaves, fwd, pt, upd, dh, zeros, zeros, leaves_t)
    pb, pb32 = (t2.resid_tbwd_plain(leaves, f, t, upd, dh, zeros, zeros)
                for f, t in ((fwd, pt), (fwd32, pt32)))
    worst = max(worst, _report16("#10 resid_tbwd", label,
                                 *pairs_ref(flat(kb), flat(pb), flat(pb32)), t0))

    t0 = time.perf_counter()
    flat = lambda o: [("dh0", o[0]), ("dx0", o[1]), ("dv0", o[2]),
                      *((f"rows.{n}", o[3][n]) for n in o[3])]
    kr = resid_ef._bwd_launch("resid_bwd_aug", leaves, fwd, upd, dh, zeros, zeros, None,
                              leaves_t, True, pb[3])
    pr, pr32 = (t2.resid_bwd_aug_plain(leaves, f, upd, dh, zeros, zeros, a)
                for f, a in ((fwd, pb[3]), (fwd32, pb32[3])))
    worst = max(worst, _report16("#10 resid_bwd_aug (rows)", label,
                                 *pairs_ref(flat(kr), flat(pr), flat(pr32)), t0))

    t0 = time.perf_counter()
    ka = t2._launch_aug_fwd(leaves, h0, xs, upd, tx0, True, True)
    pa, pa32 = (t2.aug_fwd_plain(leaves, h0, xs, upd, tx0, bf16=b) for b in (True, False))
    if any(f.resid[n].dtype != torch.bfloat16 for f in ka for n in resid_ef.RESID_LOWP):
        raise SystemExit("#18 bf16 wrote a low-precision stream in another dtype")
    both = lambda o: [(f"{k}.{n}", a) for k, f in zip("pt", o) for n, a in state(f)]
    worst = max(worst, _report16("#18 aug_fwd", label,
                                 *pairs_ref(both(ka), both(pa), both(pa32)), t0))

    # retrace mode: #16 and #17 (every layer, its contraction and its edge weights,
    # rounded per tile of 1 and of 2 molecules) against their plain bf16 versions
    t0 = time.perf_counter()
    fin = lambda o: [(f"{k}.{n}", a) for k, f in zip("pt", o)
                     for n, a in zip(("bh", "bx", "bv", "h_fin", "x_fin", "v_fin"), f[:6])]
    kr16 = t2._launch_aug_fwd(leaves, h0, xs, upd, tx0, False, True)
    pr16, pr32 = (t2.retrace_fwd_plain(leaves, h0, xs, upd, tx0, bf16=b) for b in (True, False))
    worst = max(worst, _report16("#16 retrace_fwd", label,
                                 *pairs_ref(fin(kr16), fin(pr16), fin(pr32)), t0))
    t0 = time.perf_counter()
    flat = lambda o: [("dh0", o[0]), ("dx0", o[1]), ("dth0", o[2]),
                      *((f"g.{n}", o[3][n]) for n in o[3])]
    for tile in (1, 2):
        kb17 = t2._launch_retrace_bwd(leaves, *pr16, upd, dh, dh, leaves_t, True, tile)
        pb17, pb32 = (t2.retrace_bwd_plain(leaves, *pr16, upd, dh, dh, bf16=b, tile=tile)
                      for b in (True, False))
        worst = max(worst, _report16(f"#17 retrace_bwd (tile {tile})", label,
                                     *pairs_ref(flat(kb17), flat(pb17), flat(pb32)), t0))
        t0 = time.perf_counter()
    return worst


def check_train16(hid: int, depth: int, B: int, N: int, seed: int = 0) -> float:
    """#11, #12's block and #12's contraction in resid_ef's bf16 tier against their
    plain bf16 versions, each line with the plain bf16 version's distance from the
    plain f32 one; #12 on the plain bf16 primal's streams, the contraction on the
    plain block's streams and rows with its sums in float64 (chip_smoke.f64_sums).
    Returns the worst relative error."""
    import chip_smoke

    from sake_tpu_torch.kernels import resid_ef
    from sake_tpu_torch.kernels import train2_ef as t2

    p, leaves, leaves_t, h0, xs, tx0, g_e, upd = _train_inputs(hid, depth, B, N, seed)
    label = f"hidden {hid} depth {depth} B {B} N {N}"
    worst = 0.0

    def report(name, pairs, ref, t0):
        nonlocal worst
        worst = max(worst, _report16(name, label, pairs, ref, t0))

    t0 = time.perf_counter()
    kf, ke, kdx = t2._launch_fused_primal(p, leaves, h0, xs, upd, leaves_t, bf16=True)
    pf, pe, pdx = t2.fused_primal_plain(p, leaves, h0, xs, upd, bf16=True)
    pf32, pe32, pdx32 = t2.fused_primal_plain(p, leaves, h0, xs, upd)
    if any(kf.resid[n].dtype != torch.bfloat16 for n in resid_ef.RESID_LOWP):
        raise SystemExit("#11 bf16 wrote a low-precision stream in another dtype")
    names = ("bh", "bx", "bv", "h_fin", "x_fin", "v_fin")
    pairs = [("e", ke, pe), ("dx", kdx, pdx), *zip(names, kf[:6], pf[:6]),
             *((n, kf.resid[n], pf.resid[n]) for n in pf.resid)]
    ref = {n: _rel(a.float(), b.float()) for n, a, b in
           [("e", pe, pe32), ("dx", pdx, pdx32), *zip(names, pf[:6], pf32[:6]),
            *((n, pf.resid[n], pf32.resid[n]) for n in pf.resid)]}
    report("#11 fused_primal", pairs, ref, t0)

    t0 = time.perf_counter()
    kb = t2._launch_fused_bwd_block(p, leaves, pf, upd, tx0, g_e, leaves_t)
    pb = t2.fused_bwd_block_plain(p, leaves, pf, upd, tx0, g_e)
    pb32 = t2.fused_bwd_block_plain(p, leaves, pf32, upd, tx0, g_e)
    if any(kb[2].resid[n].dtype != torch.bfloat16 for n in resid_ef.RESID_LOWP):
        raise SystemExit("#12 bf16 wrote a low-precision tangent stream in another dtype")
    flat = lambda o: [("dh0", o[0]), ("dx0", o[1]), ("ro_part", o[6]),
                      *zip(("tbh", "tbx", "tbv"), o[2][:3]),
                      *((f"t.{n}", o[2].resid[n]) for n in o[2].resid),
                      *((f"{i}.{n}", o[i][n]) for i in (3, 4, 5) for n in o[i])]
    pairs = [(n, a, b) for (n, a), (_, b) in zip(flat(kb), flat(pb))]
    ref = {n: _rel(a.float(), b.float()) for (n, a), (_, b) in zip(flat(pb), flat(pb32))}
    report("#12 fused_bwd_block", pairs, ref, t0)

    t0 = time.perf_counter()
    kg = t2._launch_param_grads_aug(leaves, pf, pb[2], pb[3], pb[4], pb[5])[0]
    with chip_smoke.f64_sums():
        pg = t2.param_grads_aug_plain(leaves, pf, pb[2], pb[3], pb[4], pb[5])
    pg32 = t2.param_grads_aug_plain(leaves, pf32, pb32[2], pb32[3], pb32[4], pb32[5])
    report("#12 param_grads_aug", [(n, kg[n], pg[n]) for n in pg],
           {n: _rel(pg[n], pg32[n]) for n in pg}, t0)
    return worst


def check_qm9(hid: int, depth: int, B: int, N: int, masked: bool, seed: int = 0,
              bf16: bool = False):
    """#4's, #6's and #5's cluster kernels against their plain versions (in the
    bf16 tier with ``bf16``, then also the contraction); returns the worst
    relative error."""
    from sake_tpu_torch.kernels import resid_ef
    from sake_tpu_torch.kernels.functional import embed
    from sake_tpu_torch.kernels.leaves import wide_stack

    F_in = 5
    model = SAKEModel(hid, 1, depth, in_features=F_in, device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    p = model_params_from_linen(linen_tree(model), device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    h = torch.randn(B, N, F_in, generator=g)
    xs = 1.5 * torch.randn(3, B, N, generator=g)
    dh, dx, dv = torch.randn(B, N, hid, generator=g), torch.randn(3, B, N, generator=g), \
        torch.randn(3, B, N, generator=g)
    upd = [1.0, 0.4, 1.0][:depth] + [1.0] * max(0, depth - 3)
    m4 = None
    if masked:  # the first molecule whole, then one that leaves rank 1 only padding, one atom
        sizes = ([N, max(1, N // 3), 1, N - 1] * B)[:B]
        nm = (torch.arange(N)[None, :] < torch.tensor(sizes)[:, None]).float()
        m4 = (nm[:, :, None] * nm[:, None, :])[..., None].contiguous()
    leaves = wide_stack(p, 4)
    h0 = embed(p, h).contiguous()
    zs = torch.zeros_like(xs)
    worst = 0.0
    t0 = time.perf_counter()
    kf = resid_ef._launch_fwd(leaves, h0, xs, zs, upd, m4, "cluster", bf16=bf16)
    pf = resid_ef.resid_fwd_plain(leaves, h0, xs, zs, upd, mask=m4, bf16=bf16)
    tier = " bf16" if bf16 else ""
    names = ("bh", "bx", "bv", "h_fin", "x_fin", "v_fin")
    errs = {**{n: _rel(a, b) for n, a, b in zip(names, kf[:6], pf[:6])},
            **{n: _rel(kf.resid[n], pf.resid[n]) for n in resid_ef.RESIDS}}
    w = max(errs, key=errs.get)
    worst = max(worst, errs[w])
    ranges = [resid_ef.cluster_rows(N, r) for r in range(resid_ef.CLUSTER_SIZE)]
    print(f"#4{tier} resid_fwd cluster hidden {hid} depth {depth} B {B} N {N} rows {ranges} "
          f"{'masked' if masked else 'unmasked'}: max rel err {errs[w]:.3e} ({w}), finite "
          f"{all(bool(torch.isfinite(t).all()) for t in kf[:6])} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    k6 = resid_ef._launch_infer(leaves, h0, xs, zs, upd, m4, bf16=bf16)
    p6 = resid_ef.resid_infer_plain(leaves, h0, xs, zs, upd, mask=m4, bf16=bf16)
    errs = {n: _rel(a, b) for n, a, b in zip(("h_fin", "x_fin"), k6, p6)}
    w = max(errs, key=errs.get)
    worst = max(worst, errs[w])
    same = all(torch.equal(a, b) for a, b in zip(k6, (kf.h_fin, kf.x_fin)))
    print(f"#6{tier} resid_infer cluster hidden {hid} depth {depth} B {B} N {N} "
          f"{'masked' if masked else 'unmasked'}: max rel err {errs[w]:.3e} ({w}), finite "
          f"{all(bool(torch.isfinite(t).all()) for t in k6)}, bitwise #4's h_fin and x_fin "
          f"{same} ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    kb = resid_ef._bwd_launch("resid_bwd_rows", leaves, pf, upd, dh, dx, dv, m4, None, True,
                              route="cluster")
    pb = resid_ef.resid_bwd_rows_plain(leaves, pf, upd, dh, dx, dv, mask=m4)
    errs = {**{n: _rel(a, b) for n, a, b in zip(("dh", "dx", "dv"), kb[:3], pb[:3])},
            **{n: _rel(kb[3][n], pb[3][n]) for n in resid_ef.ROWS}}
    w = max(errs, key=errs.get)
    worst = max(worst, errs[w])
    print(f"#5{tier} resid_bwd_rows cluster hidden {hid} depth {depth} B {B} N {N} "
          f"{'masked' if masked else 'unmasked'}: max rel err {errs[w]:.3e} ({w}), finite "
          f"{all(bool(torch.isfinite(t).all()) for t in kb[:3])} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if bf16:  # the contraction on the kernel's rows, and the tier's own distance
        t0 = time.perf_counter()
        kg = resid_ef._launch_param_grads(leaves, pf, kb[3])
        pg = resid_ef.param_grads_plain(leaves, pf, kb[3])
        errs = {n: _rel(kg[n], pg[n]) for n in pg}
        w = max(errs, key=errs.get)
        worst = max(worst, errs[w])
        p32 = resid_ef.resid_fwd_plain(leaves, h0, xs, zs, upd, mask=m4)
        pb32 = resid_ef.resid_bwd_rows_plain(leaves, p32, upd, dh, dx, dv, mask=m4)
        g32 = resid_ef.param_grads_plain(leaves, p32, pb32[3])
        tier_d = max(_rel(pg[n], g32[n]) for n in pg)
        print(f"#5 bf16 param_grads hidden {hid} depth {depth} B {B} N {N} "
              f"{'masked' if masked else 'unmasked'}: max rel err {errs[w]:.3e} ({w}); plain "
              f"bf16 from plain f32 {tier_d:.3e} ({time.perf_counter() - t0:.1f} s)", flush=True)
    return worst


def check_remat(hid: int, depth: int, B: int, N: int, seed: int = 0):
    """#21 and #23 on the kernel the shape takes, then #22 and #24, against
    their plain versions; returns the worst relative error."""
    from sake_tpu_torch.kernels import depthgrid_ef, fori_ef
    from sake_tpu_torch.kernels.functional import embed
    from sake_tpu_torch.kernels.leaves import wide_stack

    F_in = 5
    model = SAKEModel(hid, 1, depth, in_features=F_in, device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    p = model_params_from_linen(linen_tree(model), device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    h0 = embed(p, torch.randn(B, N, F_in, generator=g)).contiguous()
    xs = 1.5 * torch.randn(3, B, N, generator=g)
    dh = torch.randn(B, N, hid, generator=g)
    upd = ([1.0, 0.4] * depth)[:depth]
    leaves = wide_stack(p, 4)
    bnd = fori_ef.fori_fwd_plain(leaves, h0, xs, upd)
    worst = 0.0
    fn = ("bh", "bx", "bv", "h_fin")

    def launch_fwd(label, per_layer):
        """The forward's launches as ``fori_fwd`` (one) or ``depthgrid_fwd`` (one
        a layer, the carry in place) make them, and the route they took."""
        lib, dims, upd_t, out, pool, route = fori_ef._fwd_setup(label, leaves, h0, xs, upd)
        if not per_layer:
            fori_ef._launch_fwd(lib, dims, 0, depth, h0, xs, None, upd_t, leaves, out, pool,
                                out.h_fin, None, None, label)
            return out, route
        h, x, v = out.h_fin, xs.clone(), torch.zeros_like(xs)
        h.copy_(h0)
        for l in range(depth):
            fori_ef._launch_fwd(lib, dims, l, l + 1, h, x, v, upd_t, leaves, out, pool, h, x, v,
                                label)
        return out, route

    for label, per_layer, plain in (("#21 fori_fwd", False, fori_ef.fori_fwd_plain),
                                    ("#23 depthgrid_fwd", True, depthgrid_ef.depthgrid_fwd_plain)):
        want = plain(leaves, h0, xs, upd)
        t0 = time.perf_counter()
        got, route = launch_fwd(label, per_layer)
        errs = {n: _rel(a, b) for n, a, b in zip(fn, got, want)}
        w = max(errs, key=errs.get)
        worst = max(worst, errs[w])
        print(f"{label} hidden {hid} depth {depth} B {B} N {N} gates {upd} on the {route}: max "
              f"rel err {errs[w]:.3e} ({w}), finite "
              f"{all(bool(torch.isfinite(t).all()) for t in got)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    names = ("dh0", "dx", "dv")
    for label, plain in (("#22 fori_bwd", fori_ef.fori_bwd_plain),
                         ("#24 depthgrid_bwd", depthgrid_ef.depthgrid_bwd_plain)):
        t0 = time.perf_counter()
        lib, dims, upd_t, leaves_t, res, route = fori_ef._bwd_setup(label, leaves, bnd, upd, dh,
                                                                   None)
        dh_, dx, dv = torch.full_like(dh, float("nan")), torch.zeros(3, B, N), torch.zeros(3, B, N)
        if label.startswith("#22"):
            fori_ef._launch_bwd(lib, dims, depth - 1, 0, bnd, upd_t, leaves, leaves_t, res, dh,
                                None, None, dh_, dx, dv, label)
        else:  # one launch a layer, the carry in place
            dh_.copy_(dh)
            for l in reversed(range(depth)):
                fori_ef._launch_bwd(lib, dims, l, l, bnd, upd_t, leaves, leaves_t, res, dh_, dx,
                                    dv, dh_, dx, dv, label)
        want = plain(leaves, bnd, upd, dh)
        errs = {n: _rel(a, b) for n, a, b in zip(names, (dh_, dx, dv), want)}
        w = max(errs, key=errs.get)
        worst = max(worst, errs[w])
        print(f"{label} hidden {hid} depth {depth} B {B} N {N} gates {upd} on the {route}: max "
              f"rel err {errs[w]:.3e} ({w}), finite "
              f"{all(bool(torch.isfinite(t).all()) for t in (dh_, dx, dv))} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return worst


def check_serving(hid: int, depth: int, B: int, N: int, masked: bool, seed: int = 0,
                  bf16: bool = False):
    """K1 and K2 on both one-block routes against their plain versions (in the
    bf16 tier with ``bf16``); returns the worst relative error."""
    from sake_tpu_torch.kernels import resid_ef
    from sake_tpu_torch.kernels.functional import embed
    from sake_tpu_torch.kernels.leaves import transposed, wide_stack

    F_in = 5
    model = SAKEModel(hid, 1, depth, in_features=F_in, device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    p = model_params_from_linen(linen_tree(model), device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    h0 = embed(p, torch.randn(B, N, F_in, generator=g)).contiguous()
    xs, v0 = 1.5 * torch.randn(3, B, N, generator=g), 0.1 * torch.randn(3, B, N, generator=g)
    dh, dx, dv = torch.randn(B, N, hid, generator=g), torch.randn(3, B, N, generator=g), \
        torch.randn(3, B, N, generator=g)
    upd = ([1.0, 0.4, 0.0] * depth)[:depth]
    m4 = None
    if masked:  # the first molecule whole, then a third of it, then a single atom
        sizes = ([N, max(1, N // 3), 1] * B)[:B]
        nm = (torch.arange(N)[None, :] < torch.tensor(sizes)[:, None]).float()
        m4 = (nm[:, :, None] * nm[:, None, :])[..., None].contiguous()
    leaves = wide_stack(p, 4)
    leaves_t = transposed(leaves)
    dims = resid_ef._dims(leaves, h0)
    label = (f"{'bf16 ' if bf16 else ''}hidden {hid} depth {depth} B {B} N {N} "
             f"{'masked' if masked else 'unmasked'}")
    pf = resid_ef.resid_fwd_plain(leaves, h0, xs, v0, upd, mask=m4, bf16=bf16)
    pb = resid_ef.resid_bwd_plain(leaves, pf, upd, dh, dx, dv, mask=m4)
    if bf16:
        p32 = resid_ef.resid_fwd_plain(leaves, h0, xs, v0, upd, mask=m4)
        pb32 = resid_ef.resid_bwd_plain(leaves, p32, upd, dh, dx, dv, mask=m4)
        print(f"plain bf16 from plain f32, {label}: K1 h_fin {_rel(pf.h_fin, p32.h_fin):.3e}, "
              f"K2 dx {_rel(pb[1], pb32[1]):.3e}, dh {_rel(pb[0], pb32[0]):.3e}", flush=True)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import probe_resid  # K1's pairs (tools/probe_resid.py)

    worst = 0.0
    takes = {"K1": resid_ef.fwd_tensor_core_route(dims), "K2": resid_ef.bwd_tensor_core_route(dims)}
    for route in resid_ef.ROUTES:
        for kern in ("K1", "K2"):
            t0 = time.perf_counter()
            if route == "tensor cores" and not takes[kern]:
                try:  # off the route: refused, no other kernel tried
                    if kern == "K1":
                        resid_ef._launch_fwd(leaves, h0, xs, v0, upd, m4, route, bf16=bf16)
                    else:
                        resid_ef._bwd_launch("resid_bwd", leaves, pf, upd, dh, dx, dv, m4,
                                             leaves_t, False, route=route)
                except RuntimeError as e:
                    print(f"{kern} {label} on the {route}: refused ({e})", flush=True)
                    continue
                raise RuntimeError(f"{kern} {label}: the tensor-core kernel took a shape off "
                                   "its route")
            if kern == "K1":
                kf = resid_ef._launch_fwd(leaves, h0, xs, v0, upd, m4, route, bf16=bf16)
                pairs = probe_resid.k1_pairs(kf, pf, m4)
            else:
                kb = resid_ef._bwd_launch("resid_bwd", leaves, pf, upd, dh, dx, dv, m4,
                                          leaves_t, False, route=route)
                pairs = [*zip(("dh", "dx", "dv"), kb[:3], pb[:3])]
            errs = {n: _rel(a, b) for n, a, b in pairs}
            w = max(errs, key=errs.get)
            worst = max(worst, errs[w])
            if bf16 and kern == "K1":  # the f32 outputs apart from the bf16 streams
                f32 = {n: e for n, e in errs.items() if n in ("bh", "bx", "bv", "h_fin", "x_fin",
                                                              "v_fin", "r", "t")}
                w32 = max(f32, key=f32.get)
                print(f"{kern} {label} on the {route}: f32 outputs max rel err {f32[w32]:.3e} "
                      f"({w32})", flush=True)
            print(f"{kern} {label} on the {route}: max rel err {errs[w]:.3e} ({w}), finite "
                  f"{all(bool(torch.isfinite(a).all()) for _, a, _ in pairs)} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return worst


def check_serving_products(lib):
    """K1's and K2's tensor-core products alone (``sake_resid_tc_product``)
    at ``tools/probe_resid.py``'s ``TC_PRODUCTS`` against float64, as
    chip_smoke.py phase 3 holds them on the card; returns the worst."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import probe_resid

    def product(warps, a, w):
        out = torch.full((a.shape[0], w.shape[1]), float("nan"))
        build.check(lib, lib.sake_resid_tc_product(
            warps, a.data_ptr(), w.data_ptr(), out.data_ptr(), *a.shape, w.shape[1], None),
            "resid_tc_product")
        return out

    errs = probe_resid.check_tc_products(torch.device("cpu"), product, seeds=(0,))
    print(f"K1's and K2's tensor-core products vs float64 (limit "
          f"{probe_resid.TC_PRODUCT_TOL:.0e}): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)
    return max(errs.values())


def check_tc_products(lib):
    """#20's bf16 tensor-core products alone (``sake_fused_remat_ef_tc_product``)
    at ``tools/probe_fused.py``'s ``TC_PRODUCTS`` against float64, as
    chip_smoke.py phase 24 holds them on the card."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import probe_fused

    def product(a, w, passes):
        out = torch.full((a.shape[0], w.shape[1]), float("nan"))
        build.check(lib, lib.sake_fused_remat_ef_tc_product(
            passes, a.data_ptr(), w.data_ptr(), out.data_ptr(), *a.shape, w.shape[1], None),
            "tc_product")
        return out

    errs = probe_fused.check_tc_products(torch.device("cpu"), product, seeds=(0,))
    print(f"bf16 tensor-core products vs float64 (limit {probe_fused.TC_PRODUCT_TOL:.0e}): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)


def check(hid: int, depth: int, B: int, N: int, F_in: int, upd, seed: int = 0):
    model = SAKEModel(hid, 1, depth, in_features=F_in, device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    p = model_params_from_linen(linen_tree(model), device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    h = torch.randn(B, N, F_in, generator=g)
    x = 1.5 * torch.randn(B, N, 3, generator=g)
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    e32, f32 = fused_ef.fused_ef_plain(p, h, x, upd, n_heads=4, matmul_dtype=None)
    worst = 0.0
    for dtype in (None, torch.bfloat16):
        w = fused_ef.kernel_weights(p, 4, dtype is not None)
        t0 = time.perf_counter()
        ek, fk = fused_ef.launch(w, h, x, upd)
        secs = time.perf_counter() - t0
        ep, fp = fused_ef.fused_ef_plain(p, h, x, upd, n_heads=4, matmul_dtype=dtype)
        worst = max(worst, rel(ek, ep), rel(fk, fp))
        print(f"hidden {hid} depth {depth} B {B} N {N} gates {upd} {dtype or 'f32'} on the "
              f"{fused_ef.ROUTES[fused_ef.tensor_core_route(w, h)]}: kernel vs plain e "
              f"{rel(ek, ep):.3e} f {rel(fk, fp):.3e}; plain vs plain f32 e "
              f"{rel(ep, e32):.3e} f {rel(fp, f32):.3e}; finite "
              f"{bool(torch.isfinite(fk).all())} ({secs:.1f} s)", flush=True)
    return worst


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hidden", type=int, nargs="*", default=[8, 16])
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--batch", type=int, nargs="*", default=[3])
    ap.add_argument("--atoms", type=int, nargs="*", default=[7])
    ap.add_argument("--asan", action="store_true")
    ap.add_argument("--train", action="store_true", help="#11 and #12 in place of #20")
    ap.add_argument("--modes", action="store_true",
                    help="the bf16 tier of make_ef_train2's shared, resid and retrace modes: #9, "
                         "#10's tangent chain and rows kernel, #18, #16, #17")
    ap.add_argument("--helper", action="store_true",
                    help="mma_tf32x3.cuh's products alone (mma_check.cu)")
    ap.add_argument("--wgmma", action="store_true",
                    help="wgmma_tf32.cuh's product alone (wgmma_check.cu)")
    ap.add_argument("--sparse", action="store_true",
                    help="#13, #14 and #15 (csrc/sparse_fwd.cu, sparse_bwd.cu, sparse_bwd2.cu) "
                         "in place of #20")
    ap.add_argument("--slots", type=int, nargs="*", default=[64, 48],
                    help="--sparse: the K of each case")
    ap.add_argument("--rows", type=int, default=3, help="--sparse: receiver rows")
    ap.add_argument("--contract", action="store_true",
                    help="the contractions (csrc/sparse_contract.cu, csrc/param_grads.cu)")
    ap.add_argument("--qm9", action="store_true",
                    help="#4's, #6's and #5's cluster kernels (csrc/resid_fwd.cu, "
                         "csrc/resid_bwd_cl.cu)")
    ap.add_argument("--remat", action="store_true",
                    help="#21-#24 (csrc/remat_ef.cu's forward and remat pullback) in place of #20")
    ap.add_argument("--bf16", action="store_true",
                    help="--serving, --qm9, --train: resid_ef's bf16 tier")
    ap.add_argument("--serving", action="store_true",
                    help="K1 and K2 on both routes (csrc/resid_fwd.cu, csrc/resid_bwd.cu)")
    ap.add_argument("--split", action="store_true",
                    help="#25-#28 on the route each shape takes (csrc/split_fwd.cu, "
                         "csrc/split_bwd.cu)")
    args = ap.parse_args()
    if args.asan and "libasan" not in os.environ.get("LD_PRELOAD", ""):
        asan = subprocess.run(["g++", "-print-file-name=libasan.so"], capture_output=True,
                              text=True).stdout.strip()
        cxx = subprocess.run(["g++", "-print-file-name=libstdc++.so.6"], capture_output=True,
                             text=True).stdout.strip()
        sys.exit(f'start with LD_PRELOAD="{asan} {cxx}" ASAN_OPTIONS=detect_leaks=0')
    if args.helper:
        with tempfile.TemporaryDirectory() as tmp:
            check_helper(Path(tmp), args.asan)
        return
    if args.wgmma:
        with tempfile.TemporaryDirectory() as tmp:
            check_wgmma(Path(tmp), args.asan)
        return
    if args.sparse:
        from sake_tpu_torch.kernels import sparse_ef as se

        with tempfile.TemporaryDirectory() as tmp:
            libs = Libs(*(load(compile_source(src, Path(tmp) / Path(src).stem, args.asan), names)
                          for src, names in (
                              ("sparse_fwd.cu", ["sake_sparse_fwd", "sake_sparse_fwd_max_slots"]),
                              ("sparse_bwd.cu", ["sake_sparse_bwd", "sake_sparse_bwd_rows",
                                                 "sake_sparse_bwd_max_slots"]),
                              ("sparse_bwd2.cu", ["sake_sparse_bwd2",
                                                  "sake_sparse_bwd2_max_slots"]),
                              ("sparse_contract.cu", ["sake_sparse_contract"]))))
            build.load = lambda: libs
            se._require_cuda = lambda name, t: None
            se._stream = lambda dev: None
            worst = max(check_sparse(K, args.rows) for K in args.slots)
        print(f"worst {worst:.3e}", flush=True)
        return
    if args.contract:
        from sake_tpu_torch.kernels import resid_ef
        from sake_tpu_torch.kernels import sparse_ef as se
        from sake_tpu_torch.kernels import train2_ef as t2

        with tempfile.TemporaryDirectory() as tmp:
            libs = Libs(*(load(compile_source(src, Path(tmp) / Path(src).stem, args.asan), names)
                          for src, names in (
                              ("sparse_contract.cu", ["sake_sparse_contract"]),
                              ("param_grads.cu", ["sake_param_grads", "sake_param_grads_aug"]))))
            build.load = lambda: libs
            se._stream = resid_ef._stream = lambda dev: None
            resid_ef._require_cuda = t2._require_cuda = lambda name, t: None
            worst = max(check_contract_sparse(K, args.rows) for K in args.slots)
            worst = max(worst, check_contract_sparse(20, 2, F=10, R=6, H=4, Kh=3, C=12))
            for hid in args.hidden:
                for B in args.batch:
                    for N in args.atoms:
                        worst = max(worst, check_contract_dense(hid, B, N, args.depth))
        print(f"worst {worst:.3e}", flush=True)
        return
    if args.qm9:
        from sake_tpu_torch.kernels import resid_ef

        with tempfile.TemporaryDirectory() as tmp:
            libs = Libs(*(load(compile_source(src, Path(tmp) / Path(src).stem, args.asan), names)
                          for src, names in (
                              ("resid_fwd.cu", ["sake_resid_fwd_cluster",
                                                "sake_resid_infer_cluster",
                                                "sake_resid_fwd_cluster_smem_bytes",
                                                "sake_resid_fwd16",
                                                "sake_resid_infer_cluster16"]),
                              ("resid_bwd_cl.cu", ["sake_resid_bwd_rows_cluster",
                                                   "sake_resid_bwd_cluster_smem_bytes",
                                                   "sake_resid_bwd_rows_cluster16"]),
                              ("param_grads.cu", ["sake_param_grads16"]))))
            build.load = lambda: libs
            resid_ef._require_cuda = lambda name, t: None
            resid_ef._stream = lambda dev: None
            worst = 0.0
            for hid in args.hidden:
                for N in args.atoms:
                    for masked in (True, False):
                        worst = max(worst, check_qm9(hid, args.depth, args.batch[0], N, masked,
                                                     bf16=args.bf16))
        print(f"worst {worst:.3e}", flush=True)
        return
    if args.remat:
        from sake_tpu_torch.kernels import fori_ef

        with tempfile.TemporaryDirectory() as tmp:
            lib = load(compile_source("remat_ef.cu", Path(tmp), args.asan),
                       [n for n in build.signatures() if n.startswith("sake_remat")])
            build.load = lambda: lib
            fori_ef._require_cuda = lambda name, t: None
            fori_ef._stream = lambda dev: None
            worst = 0.0
            for hid in args.hidden:
                for N in args.atoms:
                    worst = max(worst, check_remat(hid, args.depth, args.batch[0], N))
        print(f"worst {worst:.3e}", flush=True)
        return
    if args.split:
        from sake_tpu_torch.kernels import sparse_ef as se
        from sake_tpu_torch.kernels import split_ef

        with tempfile.TemporaryDirectory() as tmp:
            libs = Libs(*(load(compile_source(src, Path(tmp) / Path(src).stem, args.asan), names)
                          for src, names in (
                              ("split_fwd.cu", ["sake_split_fwd", "sake_split_fwd_tc",
                                                "sake_split_smem_bytes"]),
                              ("split_bwd.cu", ["sake_split_bwd", "sake_split_bwd_tc"]),
                              ("sparse_contract.cu", ["sake_sparse_contract"]))))
            build.load = lambda: libs
            split_ef._require_cuda = lambda name, t: None
            split_ef._stream = se._stream = lambda dev: None
            worst = 0.0
            for hid in args.hidden:
                for N in args.atoms:
                    worst = max(worst, check_split(hid, args.batch[0], N))
        print(f"worst {worst:.3e}", flush=True)
        return
    if args.serving:
        from sake_tpu_torch.kernels import resid_ef

        names = [n for n in build.signatures() if n.startswith("sake_resid_")]
        with tempfile.TemporaryDirectory() as tmp:
            paths = [compile_source(src, Path(tmp) / Path(src).stem, args.asan)
                     for src in ("resid_fwd.cu", "resid_bwd.cu")]
            libs = Libs(*(load(lp, [n for n in names if hasattr(ctypes.CDLL(str(lp)), n)])
                          for lp in paths))
            build.load = lambda: libs
            resid_ef._require_cuda = lambda name, t: None
            resid_ef._stream = lambda dev: None
            worst = 0.0
            for hid in args.hidden:
                for N in args.atoms:
                    for masked in (False, True):
                        worst = max(worst, check_serving(hid, args.depth, args.batch[0], N,
                                                         masked, bf16=args.bf16))
            if not args.bf16:
                worst = max(worst, check_serving_products(libs))
        print(f"worst {worst:.3e}", flush=True)
        return
    if args.modes:
        from sake_tpu_torch.kernels import resid_ef
        from sake_tpu_torch.kernels import train2_ef as t2

        with tempfile.TemporaryDirectory() as tmp:
            libs = Libs(*(load(compile_source(src, Path(tmp) / Path(src).stem, args.asan), names)
                          for src, names in (
                              ("resid_jvp16.cu", ["sake_resid_jvp16"]),
                              ("resid_jvp.cu", ["sake_resid_jvp_smem_bytes"]),
                              ("resid_tbwd16.cu", ["sake_resid_tbwd16"]),
                              ("resid_tbwd.cu", ["sake_resid_tbwd_smem_bytes"]),
                              ("resid_bwd16.cu", ["sake_resid_bwd_rows16"]),
                              ("resid_bwd.cu", ["sake_resid_bwd_smem_bytes"]),
                              ("aug_fwd16.cu", ["sake_aug_fwd16", "sake_retrace_fwd16"]),
                              ("aug_fwd.cu", ["sake_aug_fwd_smem_bytes"]),
                              ("retrace_bwd16.cu", ["sake_retrace_bwd16",
                                                    "sake_retrace_bwd16_smem_bytes"]),
                              ("param_grads.cu", ["sake_retrace_grads16"]))))
            build.load = lambda: libs
            t2._require_cuda = resid_ef._require_cuda = lambda name, t: None
            resid_ef._stream = lambda dev: None
            worst = 0.0
            for hid in args.hidden:
                for N in args.atoms:
                    worst = max(worst, check_modes16(hid, args.depth, args.batch[0], N))
        print(f"worst {worst:.3e}", flush=True)
        return
    if args.train and args.bf16:
        from sake_tpu_torch.kernels import resid_ef
        from sake_tpu_torch.kernels import train2_ef as t2

        with tempfile.TemporaryDirectory() as tmp:
            libs = Libs(*(load(compile_source(src, Path(tmp) / Path(src).stem, args.asan), names)
                          for src, names in (
                              ("fused_ef16.cu", ["sake_fused_primal16",
                                                 "sake_fused_primal16_smem_bytes"]),
                              ("fused_bwd16.cu", ["sake_fused_bwd16",
                                                  "sake_fused_bwd16_smem_bytes"]),
                              ("param_grads.cu", ["sake_param_grads_aug16"]))))
            build.load = lambda: libs
            t2._require_cuda = resid_ef._require_cuda = lambda name, t: None
            resid_ef._stream = lambda dev: None
            worst = 0.0
            for hid in args.hidden:
                for N in args.atoms:
                    worst = max(worst, check_train16(hid, args.depth, args.batch[0], N))
        print(f"worst {worst:.3e}", flush=True)
        return
    if args.train:
        from sake_tpu_torch.kernels import resid_ef
        from sake_tpu_torch.kernels import train2_ef as t2

        with tempfile.TemporaryDirectory() as tmp:
            libs = Libs(*(load(compile_source(src, Path(tmp) / Path(src).stem, args.asan), names)
                          for src, names in (
                              ("fused_ef.cu", ["sake_fused_primal", "sake_fused_ef_smem_bytes"]),
                              ("fused_bwd.cu", ["sake_fused_bwd", "sake_fused_bwd_smem_bytes"]))))
            build.load = lambda: libs
            t2._require_cuda = lambda name, t: None
            resid_ef._stream = lambda dev: None
            for hid in args.hidden:
                check_train(hid, args.depth, args.batch[0], args.atoms[0])
        return
    with tempfile.TemporaryDirectory() as tmp:
        lib = load(compile_source("fused_remat_ef.cu", Path(tmp), args.asan))
        build.load = lambda: lib
        fused_ef._require_cuda = lambda name, t: None
        fused_ef._stream = lambda dev: None
        worst = 0.0
        for hid in args.hidden:  # every layer updating, as the main path
            worst = max(worst, check(hid, args.depth, args.batch[0], args.atoms[0],
                                     9 if hid == 64 else 5, [1.0] * args.depth))
        print(f"worst {worst:.3e}", flush=True)
        check_tc_products(lib)


if __name__ == "__main__":
    main()
