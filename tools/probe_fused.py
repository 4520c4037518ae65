"""Where the block time of #11 and #12 (or of #20) goes: a clock64() probe per
phase and per product site, at aspirin's full width on one NVIDIA GPU.

    python3 tools/probe_fused.py                  # B = 4 and 512
    python3 tools/probe_fused.py --batches 512
    python3 tools/probe_fused.py --k20            # #20, both tiers, B = 37 and 2048
    python3 tools/probe_fused.py --remat          # #22 and #24, B = 512

Builds the kernels (``build.build()``) and, beside them, ``csrc/fused_ef.cu``
(#11) and ``csrc/fused_bwd.cu`` (#12) with ``-DSAKE_PROBE`` (``csrc/probe.cuh``),
prints ptxas's registers and spills of #11, #12's block and #12's contraction in
the build without the probe, then launches each kernel once per batch on the
probe build and prints each slot's share of the block cycles (thread 0
reads the SM clock after a block barrier and charges the cycles since its last
mark; the slots sum over every block of the launch). The x-mixing slots are the
four ``he_att @ w_xmix`` sites and the per-row sum beside the forward ones. The
probe build's time per launch (CUDA events) is printed beside the plain build's,
so the probe's own cost shows. The card's name and power limit come first.

With ``--k20`` the same for #20 (``csrc/fused_remat_ef.cu``, built alone, with
and without the probe) in f32 and bf16, at chip_smoke.py phase 24's model and
inputs (``--batches`` default 37 and 2048): ptxas's lines of both
instantiations, each slot's share, and both builds' time per launch.

With ``--remat`` the same for #22 and #24 (``csrc/remat_ef.cu``'s
``remat_bwd_kernel``, built alone, with and without the probe) at chip_smoke.py
phase 18's model and the path's chunk (``--batches`` default 512): ptxas's lines
of ``remat_bwd_kernel``, the route of each launch, and the shares of the
re-forward (the forward body's slots) against the pullback (the pullback body's),
of the x-mixing, of o_f and o1, and of the pullback's staging of the residual
scratch (its reads; the re-forward's writes to it are stores inside the forward's
row slots, which the probe does not part), with both builds' time per launch.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import threading

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("fused_ef.cu", "fused_bwd.cu")
SLOTS = ("fwd_pre", "fwd_row", "fwd_xmix", "fwd_node", "bwd_pre", "bwd_row", "bwd_xmix",
         "bwd_node", "jvp_pre", "jvp_row", "jvp_xmix", "jvp_node", "tb_pre", "tb_row",
         "tb_xmix", "tb_node", "head", "other", "fwd_mm", "bwd_mm", "jvp_mm", "tb_mm",
         "bwd_load", "tb_load", "sp_load", "sp_narrow", "sp_softmax", "sp_heatt", "sp_xmix_f",
         "sp_xmix_b", "sp_epi", "sp_tail", "sp_store", "sc_stage", "sc_mma", "sc_store",
         "sc_sum", "pg_xmix_stage", "pg_xmix_mma", "pg_xmix_flush", "pg_wide_stage",
         "pg_wide_mma", "pg_wide_flush", "pg_narrow", "pg_sum", "fwd_of_mm", "fwd_o1_mm",
         "bwd_of_mm", "bwd_o1_mm", "fwd_cl", "bwd_cl", "bwd_rows", "spl_load", "spl_mm",
         "spl_xmix", "spl_epi", "spl_row", "spl_bar", "spl_sem",
         "spl_mm_b", "spl_ring", "spl_pool")  # probe.cuh's ProbeSlot order
KERNELS = ("fused_ef_kernelILb0E", "fused_bwd_kernel", "param_grads_kernelILb1E")
ENTRIES = ("sake_fused_primal", "sake_fused_ef_smem_bytes", "sake_fused_bwd",
           "sake_fused_bwd_smem_bytes", "sake_fused_ef_probe", "sake_fused_bwd_probe")


def cuda_ms(fn, reps=3):
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_probe():
    """The library of #11 and #12 with the probe compiled in (``-DSAKE_PROBE``)."""
    from sake_tpu_torch.kernels import build

    return build.build(SOURCES, ("SAKE_PROBE",))


def load(path, entries=ENTRIES):
    from sake_tpu_torch.kernels import build

    lib = build.declare(ctypes.CDLL(str(path)), entries)
    lib.sake_error_string = lambda err: b"see cudaGetErrorString"
    return lib


def shares_of(ticks):
    """``(total, {slot: share})`` of a probe read."""
    total = sum(ticks)
    return total, {s: round(t / total, 4) for s, t in zip(SLOTS, ticks) if t}


def probe(prm, cfg, data, species, dev, B: int, lib, smi: str) -> dict:
    """One launch each of #11 and #12's block at batch B on ``lib`` (a probe
    build); prints and returns ``{kernel: {slot: share}}``."""
    import torch

    from sake_tpu_torch.kernels import build
    from sake_tpu_torch.kernels import train2_ef as t2
    from sake_tpu_torch.kernels.functional import embed
    from sake_tpu_torch.kernels.leaves import transposed, wide_stack

    N, depth = len(data.z), cfg.depth
    upd = [1.0] * depth
    gen = torch.Generator(dev).manual_seed(5)
    saved, build._lib = build._lib, lib  # the wrappers launch through build.load()
    out = {}
    try:
        with torch.no_grad():
            leaves = wide_stack(prm, cfg.n_heads)
            leaves_t = transposed(leaves)
            h0 = embed(prm, species.to(dev).expand(B, N, -1)).contiguous()
            xs = torch.as_tensor(np.ascontiguousarray(data.x[:B], np.float32),
                                 device=dev).permute(2, 0, 1).contiguous()
            tx0 = torch.randn(3, B, N, device=dev, generator=gen)
            g_e = torch.randn(B, device=dev, generator=gen)
            fwd = t2.fused_primal(prm, leaves, h0, xs, upd, leaves_t=leaves_t)[0]
            for name, fn, entry in (
                    ("#11 fused_primal", lambda: t2.fused_primal(prm, leaves, h0, xs, upd,
                                                                 leaves_t=leaves_t),
                     lib.sake_fused_ef_probe),
                    ("#12 fused_bwd_block", lambda: t2.fused_bwd_block(
                        prm, leaves, fwd, upd, tx0, g_e, leaves_t=leaves_t),
                     lib.sake_fused_bwd_probe)):
                ticks = (ctypes.c_ulonglong * len(SLOTS))()
                build.check(lib, entry(ticks, 1), "probe reset")
                fn()
                torch.cuda.synchronize()
                build.check(lib, entry(ticks, 1), "probe read")
                total, shares = shares_of(ticks)
                xmix = sum(v for s, v in shares.items() if s.endswith("xmix"))
                mm = sum(v for s, v in shares.items() if s.endswith("_mm"))
                print(f"PROBE {name} B={B} N={N} depth {depth}: block cycles {total} "
                      f"({total / B:.4g} per molecule); x-mixing share {xmix:.4f}, edge "
                      f"products {mm:.4f}; shares {json.dumps(shares)} ({smi})", flush=True)
                out[name] = shares
    finally:
        build._lib = saved
    return out


def k20_inputs(dev, B: int = 2048):
    """chip_smoke.py phase 24's model (``MD17Config``'s widths, seed 0) and
    data (2048 synthetic aspirin molecules, seed 0), its first B molecules:
    ``(params, h (B, N, F_in), x (B, N, 3))``."""
    import torch

    from sake_tpu_torch.data.md17 import synthesize_md17
    from sake_tpu_torch.tasks.md17 import MD17Config, make_model, species_onehot

    data = synthesize_md17(n_samples=max(B, 2048), seed=0)
    species = species_onehot(data.z, int(data.z.max())).to(dev)
    cfg = MD17Config(hidden_features=64, depth=6, n_heads=4)
    model = make_model(cfg, species.shape[-1], device=dev,
                       generator=torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    N = len(data.z)
    return (model.functional_params(), species.expand(B, N, -1).float().contiguous(),
            torch.as_tensor(data.x[:B], device=dev).float().contiguous())


# #20's bf16 tensor-core products at aspirin's widths, as its bodies call them,
# (n, k, m, passes): the x-mixing and its pullback (mm_tc), the forward's o_f and
# o1 (mm_tc_small, a rounded to bf16 as read), and their pullbacks
TC_PRODUCTS = ((21, 256, 256, 2), (21, 50, 64, 1), (21, 64, 64, 1), (21, 64, 64, 2),
               (21, 64, 50, 2))
TC_PRODUCT_TOL = 1e-6  # max |diff| / max |float64 ref|, as the CPU tests hold the plain models


def check_tc_products(dev, product=None, seeds=(0, 1, 2, 3)) -> dict:
    """Each of ``TC_PRODUCTS`` through ``product(a, w, passes)``
    (``fused_ef.tc_product`` by default) on seeded operands on ``dev``: ``a``
    normal, ``w`` normal / sqrt(k) rounded to bf16. Returns the worst max |diff| /
    max |ref| over ``seeds`` against the float64 product (of ``bf16(a)`` at one
    pass), by case name."""
    import torch

    from sake_tpu_torch.kernels import fused_ef
    from sake_tpu_torch.kernels.functional import bf16_round

    product = product or fused_ef.tc_product
    out = {}
    for n, k, m, passes in TC_PRODUCTS:
        name = f"{n}x{k}@{k}x{m} {passes} pass{'es' if passes > 1 else ''}"
        for seed in seeds:
            rng = np.random.default_rng(seed)
            a = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).to(dev)
            w = bf16_round(torch.from_numpy(
                (rng.standard_normal((k, m)) / np.sqrt(k)).astype(np.float32)).to(dev))
            got = product(a, w, passes)
            ref = (bf16_round(a) if passes == 1 else a).double() @ w.double()
            err = float((got.double() - ref).abs().max() / ref.abs().max())
            out[name] = max(out.get(name, 0.0), err if err == err else float("inf"))
    return out


def probe_k20(batches, smi: str) -> int:
    """#20's ptxas lines, its probe shares in both tiers per batch, and its
    time per launch with and without the probe."""
    import torch

    from sake_tpu_torch.kernels import build, fused_ef

    src = "fused_remat_ef.cu"
    paths = {}
    jobs = [threading.Thread(target=lambda: paths.__setitem__("plain", build.build((src,)))),
            threading.Thread(target=lambda: paths.__setitem__(
                "probe", build.build((src,), ("SAKE_PROBE",))))]
    for j in jobs:
        j.start()
    for j in jobs:
        j.join()
    lines = (paths["plain"].parent / "ptxas.txt").read_text().splitlines()
    for i, line in enumerate(lines):  # the entry, its stack and spills, its registers
        if "Compiling entry" in line and "fused_remat_ef_kernel" in line:
            for ln in lines[i:i + 4]:
                print(f"PTXAS {ln.strip()}", flush=True)
    entries = [n for n in build.signatures() if n.startswith("sake_fused_remat_ef")]
    libs = {k: load(p, entries) for k, p in paths.items()}
    dev = torch.device("cuda", 0)
    params, h_all, x_all = k20_inputs(dev, max(batches))
    upd = [1.0] * len(params.layers)
    for B in batches:
        h, x = h_all[:B].contiguous(), x_all[:B].contiguous()
        for bf16 in (False, True):
            tier = "bf16" if bf16 else "f32"
            w = fused_ef.kernel_weights(params, 4, bf16)
            saved = build._lib
            try:
                build._lib = libs["probe"]
                ticks = (ctypes.c_ulonglong * len(SLOTS))()
                build.check(libs["probe"], libs["probe"].sake_fused_remat_ef_probe(ticks, 1),
                            "probe reset")
                with torch.no_grad():
                    fused_ef.launch(w, h, x, upd)
                torch.cuda.synchronize()
                build.check(libs["probe"], libs["probe"].sake_fused_remat_ef_probe(ticks, 1),
                            "probe read")
                total, shares = shares_of(ticks)
                ms = {}
                for k, lib in libs.items():
                    build._lib = lib
                    with torch.no_grad():
                        ms[k] = cuda_ms(lambda: fused_ef.launch(w, h, x, upd))
            finally:
                build._lib = saved
            xmix = sum(v for s, v in shares.items() if s.endswith("xmix"))
            mm = sum(v for s, v in shares.items() if s.endswith("_mm"))
            print(f"PROBE #20 {tier} B={B} N={x.shape[1]} depth {len(upd)}: block cycles "
                  f"{total} ({total / B:.4g} per molecule); x-mixing share {xmix:.4f}, edge "
                  f"products {mm:.4f}; shares "
                  f"{json.dumps(shares)}; ms per launch without the probe {ms['plain']:.3f}, "
                  f"with it {ms['probe']:.3f} ({smi})", flush=True)
    return 0


REMAT_TOL = 1e-4  # max |diff| / max |plain| per tensor, chip_smoke.py phase 17's limit
# the re-forward's residuals (coeff is tanh of the x-mixing product): 3xTF32 keeps
# each product within 1e-6 of float64, where a dropped pass shows at about 1e-4
REMAT_RESID_TOL = 1e-5


def check_remat(dev, B: int = 37, lib=None) -> dict:
    """#22 and #24 against ``fori_bwd_plain`` and ``depthgrid_bwd_plain`` on
    ``dev``: at aspirin's widths (``k20_inputs``' first B molecules, depth 6,
    the plain forward's boundaries) and at hidden 8 and 16 (random inputs, B =
    4, N = 7, depth 2, gates 1 and 0.4). Returns ``{case: (worst max |diff| /
    max |plain| over dh0, dx, dv, route)}``, and at aspirin's widths a case
    "re-forward residuals" (one #24 launch of the last layer, its residual
    scratch against ``resid_ef.layer_fwd_resid``'s, worst over the 17, held to
    ``REMAT_RESID_TOL``: dh0, dx and dv barely feel the x-mixing at these random
    weights); ``lib``: the library the wrappers launch through (``build.load()``'s
    when None)."""
    import torch

    from sake_tpu_torch.kernels import build, depthgrid_ef, fori_ef, resid_ef
    from sake_tpu_torch.kernels.adapter import linen_tree, model_params_from_linen
    from sake_tpu_torch.kernels.functional import embed
    from sake_tpu_torch.kernels.leaves import wide_stack
    from sake_tpu_torch.models import SAKEModel

    rel = lambda a, b: float((a - b).abs().max() / (b.abs().max() + 1e-30))
    cases = {}
    params, h, x = k20_inputs(dev, B)
    with torch.no_grad():
        h0 = embed(params, h).contiguous()
        cases[f"aspirin B={B}"] = (wide_stack(params, 4), h0, x.permute(2, 0, 1).contiguous(),
                                   [1.0] * len(params.layers), params)
        for hid in (8, 16):
            m = SAKEModel(hid, 1, 2, in_features=5, device=dev,
                          generator=torch.Generator().manual_seed(hid))
            gen = torch.Generator(dev).manual_seed(hid)
            rnd = lambda *shape: torch.randn(*shape, device=dev, generator=gen)
            cases[f"hidden {hid} B=4 N=7"] = (
                wide_stack(model_params_from_linen(linen_tree(m), device=dev), 4), rnd(4, 7, hid),
                1.5 * rnd(3, 4, 7), [1.0, 0.4], None)
    out = {}
    saved = build._lib
    try:
        if lib is not None:
            build._lib = lib
        for case, (leaves, h0, xs, upd, prm) in cases.items():
            with torch.no_grad():
                bnd = fori_ef.fori_fwd_plain(leaves, h0, xs, upd)
                gen = torch.Generator(dev).manual_seed(7)
                dh = (resid_ef._readout_seed(prm, bnd.h_fin, None)[1] if prm is not None else
                      torch.randn(h0.shape, device=dev, generator=gen))
                route = fori_ef.ROUTES[fori_ef.tensor_core_route(resid_ef._dims(leaves, h0))]
                for name, fn, plain in (
                        ("#22", fori_ef.fori_bwd, fori_ef.fori_bwd_plain),
                        ("#24", depthgrid_ef.depthgrid_bwd, depthgrid_ef.depthgrid_bwd_plain)):
                    got, want = fn(leaves, bnd, upd, dh), plain(leaves, bnd, upd, dh)
                    err = max(rel(a, b) for a, b in zip(got, want))
                    out[f"{name} {case}"] = (err if err == err else float("inf"), route)
                if prm is not None:
                    out[f"re-forward residuals {case}"] = (resid_err(leaves, bnd, upd, dh),
                                                           route)
    finally:
        build._lib = saved
    return out


def check_remat_fwd(dev, B: int = 37) -> dict:
    """#21 and #23 against ``fori_fwd_plain`` and ``depthgrid_fwd_plain`` on
    ``dev`` (bh, bx, bv, h_fin), through their wrappers on the route the shape
    takes: at aspirin's widths (``k20_inputs``' first B molecules, depth 6) the
    tensor cores; at those widths with N = 22 (random inputs, B = 4, depth 6),
    and at hidden 8 and 16 (random inputs, B = 4, N = 7, depth 2, gates 1 and
    0.4), the CUDA cores. Returns ``{case: (worst max |diff| / max |plain|,
    route)}``; raises if a wrapper's launch left the route its shape
    selects."""
    import torch

    from sake_tpu_torch.kernels import depthgrid_ef, fori_ef, resid_ef
    from sake_tpu_torch.kernels.adapter import linen_tree, model_params_from_linen
    from sake_tpu_torch.kernels.functional import embed
    from sake_tpu_torch.kernels.leaves import wide_stack
    from sake_tpu_torch.models import SAKEModel

    rel = lambda a, b: float((a - b).abs().max() / (b.abs().max() + 1e-30))
    cases = {}
    params, h, x = k20_inputs(dev, B)
    with torch.no_grad():
        leaves, upd = wide_stack(params, 4), [1.0] * len(params.layers)
        cases[f"aspirin B={B}"] = (leaves, embed(params, h).contiguous(),
                                   x.permute(2, 0, 1).contiguous(), upd)
        gen = torch.Generator(dev).manual_seed(22)
        rnd = lambda *shape: torch.randn(*shape, device=dev, generator=gen)
        cases["hidden 64 B=4 N=22"] = (leaves, rnd(4, 22, 64), 1.5 * rnd(3, 4, 22), upd)
        for hid in (8, 16):
            m = SAKEModel(hid, 1, 2, in_features=5, device=dev,
                          generator=torch.Generator().manual_seed(hid))
            cases[f"hidden {hid} B=4 N=7"] = (
                wide_stack(model_params_from_linen(linen_tree(m), device=dev), 4), rnd(4, 7, hid),
                1.5 * rnd(3, 4, 7), [1.0, 0.4])
    out = {}
    for case, (leaves, h0, xs, upd) in cases.items():
        route = fori_ef.ROUTES[fori_ef.fwd_tensor_core_route(resid_ef._dims(leaves, h0))]
        with torch.no_grad():
            for name, fn, plain in (
                    ("#21", fori_ef.fori_fwd, fori_ef.fori_fwd_plain),
                    ("#23", depthgrid_ef.depthgrid_fwd, depthgrid_ef.depthgrid_fwd_plain)):
                want = plain(leaves, h0, xs, upd)
                before = dict(fn.routes)
                got = fn(leaves, h0, xs, upd)
                taken = [r for r in fn.routes if fn.routes[r] != before[r]]
                if taken != [route]:
                    raise RuntimeError(f"{name} {case}: launches on {taken}, not the {route}")
                err = max(rel(a, b) for a, b in zip(got, want))
                out[f"{name} {case}"] = (err if err == err else float("inf"), route)
    return out


def resid_err(leaves, bnd, upd, dh) -> float:
    """One pullback launch of the last layer (#24's), then its residual scratch
    (that layer's re-forward) against ``resid_ef.layer_fwd_resid``'s: the worst
    max |diff| / max |plain| over the 17 residuals."""
    import torch

    from sake_tpu_torch.kernels import fori_ef, resid_ef
    from sake_tpu_torch.kernels.leaves import layer_leaves

    l = len(upd) - 1
    lib, dims, upd_t, leaves_t, res, _ = fori_ef._bwd_setup("fori_bwd", leaves, bnd, upd, dh,
                                                            None)
    outs = [torch.empty_like(dh), torch.empty_like(bnd.bx[0]), torch.empty_like(bnd.bx[0])]
    fori_ef._launch_bwd(lib, dims, l, l, bnd, upd_t, leaves, leaves_t, res, dh, None, None, *outs,
                        "fori_bwd")
    want = resid_ef.layer_fwd_resid(layer_leaves(leaves, l), bnd.bh[l],
                                    resid_ef._planes(bnd.bx[l]), resid_ef._planes(bnd.bv[l]),
                                    upd[l])[3]
    err = max(float((res[n].reshape(-1) - want[n].reshape(-1)).abs().max()
                    / (want[n].abs().max() + 1e-30)) for n in resid_ef.RESIDS)
    return err if err == err else float("inf")


def remat_shares(shares: dict) -> dict:
    """#22's and #24's summary shares of a probe read (``shares_of``)."""
    part = lambda pred: round(sum(v for s, v in shares.items() if pred(s)), 4)
    return {"re-forward": part(lambda s: s.startswith("fwd_")),
            "pullback": part(lambda s: s.startswith("bwd_")),
            "x-mixing": part(lambda s: s.endswith("_xmix")),
            "o_f and o1": part(lambda s: s.endswith(("_of_mm", "_o1_mm"))),
            "scratch reads": part(lambda s: s == "bwd_load")}


def probe_remat(batches, smi: str, check_only: bool = False) -> int:
    """#22's and #24's ptxas lines, their check against plain (``check_remat``),
    their probe shares and route per batch, and their time per launch with and
    without the probe (not with ``check_only``)."""
    import torch

    from sake_tpu_torch.kernels import build, depthgrid_ef, fori_ef, resid_ef
    from sake_tpu_torch.kernels.functional import embed
    from sake_tpu_torch.kernels.leaves import transposed, wide_stack

    src = "remat_ef.cu"
    paths = {}
    kinds = {"plain": ()} if check_only else {"plain": (), "probe": ("SAKE_PROBE",)}
    jobs = [threading.Thread(target=lambda k=k, m=m: paths.__setitem__(k, build.build((src,), m)))
            for k, m in kinds.items()]
    for j in jobs:
        j.start()
    for j in jobs:
        j.join()
    lines = (paths["plain"].parent / "ptxas.txt").read_text().splitlines()
    for i, line in enumerate(lines):  # the entry, its stack and spills, its registers
        if "Compiling entry" in line and "remat_bwd_kernel" in line:
            for ln in lines[i:i + 4]:
                print(f"PTXAS {ln.strip()}", flush=True)
    entries = [n for n in build.signatures() if n.startswith("sake_remat")]
    libs = {k: load(p, entries) for k, p in paths.items()}
    dev = torch.device("cuda", 0)
    checks = check_remat(dev, lib=libs["plain"])
    limit = lambda case: REMAT_RESID_TOL if case.startswith("re-forward") else REMAT_TOL
    for case, (err, route) in checks.items():
        print(f"CHECK {case} on the {route}: max rel err {err:.3e} (limit {limit(case):.0e})",
              flush=True)
    if any(e > limit(c) for c, (e, _) in checks.items()):
        print("CHECK failed", flush=True)
        return 1
    if check_only:
        return 0
    params, h_all, x_all = k20_inputs(dev, max(batches))
    depth = len(params.layers)
    upd = [1.0] * depth
    leaves = wide_stack(params, 4)
    leaves_t = transposed(leaves)
    for B in batches:
        with torch.no_grad():
            h0 = embed(params, h_all[:B]).contiguous()
            xs = x_all[:B].permute(2, 0, 1).contiguous()
        saved = build._lib
        try:
            build._lib = libs["plain"]
            with torch.no_grad():
                bnd = fori_ef.fori_fwd(leaves, h0, xs, upd)
                dh = resid_ef._readout_seed(params, bnd.h_fin, None)[1]
            route = fori_ef.ROUTES[fori_ef.tensor_core_route(resid_ef._dims(leaves, h0))]
            for name, fn in (("#22 fori_bwd", fori_ef.fori_bwd),
                             ("#24 depthgrid_bwd", depthgrid_ef.depthgrid_bwd)):
                run = lambda: fn(leaves, bnd, upd, dh, leaves_t=leaves_t)
                build._lib = libs["probe"]
                ticks = (ctypes.c_ulonglong * len(SLOTS))()
                build.check(libs["probe"], libs["probe"].sake_remat_bwd_probe(ticks, 1),
                            "probe reset")
                with torch.no_grad():
                    run()
                torch.cuda.synchronize()
                build.check(libs["probe"], libs["probe"].sake_remat_bwd_probe(ticks, 1),
                            "probe read")
                total, shares = shares_of(ticks)
                ms = {}
                for k, lb in libs.items():
                    build._lib = lb
                    with torch.no_grad():
                        ms[k] = cuda_ms(run)
                print(f"PROBE {name} B={B} N={h0.shape[1]} depth {depth} on the {route}: block "
                      f"cycles {total} ({total / B:.4g} per molecule); "
                      f"{json.dumps(remat_shares(shares))}; shares {json.dumps(shares)}; ms per "
                      f"call without the probe {ms['plain']:.3f}, with it {ms['probe']:.3f} "
                      f"({smi})", flush=True)
        finally:
            build._lib = saved
    return 0


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, nargs="*")
    ap.add_argument("--k20", action="store_true",
                    help="#20 (csrc/fused_remat_ef.cu) in place of #11 and #12")
    ap.add_argument("--remat", action="store_true",
                    help="#22 and #24 (csrc/remat_ef.cu) in place of #11 and #12")
    ap.add_argument("--check-only", action="store_true",
                    help="--remat: the ptxas lines and the check against plain, no probe or time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_fused: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from sake_tpu_torch.data.md17 import load_md17
    from sake_tpu_torch.kernels import build
    from sake_tpu_torch.kernels import train2_ef as t2
    from sake_tpu_torch.tasks import md17 as task

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.k20:
        return probe_k20(args.batches or [37, 2048], smi)
    if args.remat:
        return probe_remat(args.batches or [512], smi, args.check_only)
    args.batches = args.batches or [4, 512]
    dev = torch.device("cuda", 0)

    # both builds at once: nvcc's processes run in parallel
    paths = {}
    jobs = [threading.Thread(target=lambda: paths.__setitem__("plain", build.build())),
            threading.Thread(target=lambda: paths.__setitem__("probe", build_probe()))]
    for j in jobs:
        j.start()
    for j in jobs:
        j.join()
    lines = (paths["plain"].parent / "ptxas.txt").read_text().splitlines()
    for i, line in enumerate(lines):  # #11's and #12's kernels: the entry, spills, registers
        if "Compiling entry" in line and any(k in line for k in KERNELS):
            for ln in lines[i:i + 3]:
                print(f"PTXAS {ln.strip()}", flush=True)
    libs = {k: load(p) for k, p in paths.items()}

    cfg = task.MD17Config(use_kernel_ef=True)
    data = load_md17(cfg.molecule, None, n_samples=max(args.batches))
    species = task.species_onehot(data.z, int(data.z.max()))
    model = task.make_model(cfg, species.shape[-1], device=dev,
                            generator=torch.Generator().manual_seed(cfg.seed))
    prm = task.make_branch(cfg, model, species, float(data.e.mean()), float(data.e.std()))[0]
    from sake_tpu_torch.kernels.functional import embed
    from sake_tpu_torch.kernels.leaves import transposed, wide_stack

    N, depth = len(data.z), cfg.depth
    upd = [1.0] * depth
    for B in args.batches:
        probe(prm, cfg, data, species, dev, B, libs["probe"], smi)
        with torch.no_grad():
            leaves = wide_stack(prm, cfg.n_heads)
            leaves_t = transposed(leaves)
            h0 = embed(prm, species.to(dev).expand(B, N, -1)).contiguous()
            xs = torch.as_tensor(np.ascontiguousarray(data.x[:B], np.float32),
                                 device=dev).permute(2, 0, 1).contiguous()
            tx0, g_e = torch.zeros(3, B, N, device=dev), torch.zeros(B, device=dev)
            out = {}
            for k, lib in libs.items():
                saved, build._lib = build._lib, lib
                fwd = t2.fused_primal(prm, leaves, h0, xs, upd, leaves_t=leaves_t)[0]
                out[k] = (cuda_ms(lambda: t2.fused_primal(prm, leaves, h0, xs, upd,
                                                          leaves_t=leaves_t)),
                          cuda_ms(lambda: t2.fused_bwd_block(prm, leaves, fwd, upd, tx0, g_e,
                                                             leaves_t=leaves_t)))
                build._lib = saved
        print(f"PROBE TIMES B={B} (ms per launch, #11, #12 block): without the probe "
              f"{out['plain'][0]:.3f}, {out['plain'][1]:.3f}; with it {out['probe'][0]:.3f}, "
              f"{out['probe'][1]:.3f} ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
