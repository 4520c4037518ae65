"""Where the block time of #4 and #5's rows kernel goes at QM9's shapes, on one
NVIDIA GPU: the one-block kernels and the cluster kernels (one molecule per
two-CTA cluster), a clock64() probe per phase and product site; with
``--serving``, of K1 and K2 at MD17 serving's shapes on both of their routes.

    python3 tools/probe_resid.py                      # check, probe, times
    python3 tools/probe_resid.py --phases check probe  # no timing
    python3 tools/probe_resid.py --reps 5             # more timing rounds
    python3 tools/probe_resid.py --phases sweep --batches 64 96 128 192 256
    python3 tools/probe_resid.py --serving            # K1 and K2, both routes
    python3 tools/probe_resid.py --serving --phases check probe --routes "CUDA cores"

``--serving``: the input is chip_smoke.py phase 4's per-kernel input (aspirin, B =
512, N = 21, hidden 64, depth 6, 4 heads, unmasked, every layer updating, a random
cotangent of h); only ``csrc/resid_fwd.cu`` and ``csrc/resid_bwd.cu`` are built,
plain and with ``-DSAKE_PROBE``, at once. Prints the card, the ptxas lines of K1's
and K2's kernels on both routes, the routes and carves at that shape and the
blocks of K1's tensor-core kernel an SM holds
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``: two by design); then (phase
``check``, :func:`check_serving_on_card`) each kernel of ``--routes`` against its
plain version unmasked and with random edge masks (1e-4 relative per tensor, two
launches bit for bit) and the routes' tensor-core products alone against float64
(:func:`check_tc_products`, ``TC_PRODUCT_TOL``); then (``probe``) one launch of K1
and K2 on each of ``--routes`` on the probe build, each slot's share of the block
cycles and the shares of the x-mixing, the edge products (o_f, o1, sem), the rest
of the row (geometry, softmax, the residual stores and loads that ride in it), the
pullback's staging of its saved rows, and the node phase; then (``time``) K1 and K2
on each route (CUDA events, 3 launches after a warm-up) in rounds that alternate
them.

The input is chip_smoke.py phase 5's: the first ``qm9_kernel`` training batch
(B = 64, N = 29, hidden 64, depth 6, 4 heads, its real edge masks), the model
from the task's seed, random cotangents of h. Builds, all at once:

- the library (``build.build()``);
- ``csrc/resid_fwd.cu``, ``csrc/resid_bwd.cu`` and ``csrc/resid_bwd_cl.cu`` with
  ``-DSAKE_PROBE`` (``csrc/probe.cuh``).

Prints the card's name and power limit, ptxas's registers and spills of the four
kernels, the clusters the card holds at once (``cudaOccupancyMaxActiveClusters``)
and each kernel's shared memory; then (phase ``check``) both cluster
kernels against their plain versions (:func:`check_on_card`: 1e-4 relative per
tensor, two launches bit for bit; CHECK lines); then (``probe``) one launch
of each route of #4 and #5 on the probe build, each slot's share of the block
cycles (thread 0 reads the SM clock after a block or cluster barrier and
charges the cycles since its last mark; the slots sum over every block, so a
cluster kernel's shares are of both CTAs' cycles); then (``time``) the time per launch (CUDA events, 3
launches after a warm-up) of every route on both builds in rounds that alternate
them, each round printed, and the means with their spreads (max / min); then
(``sweep``) both routes of #4 and #5's rows kernel at each of ``--batches``
(the phase 5 batch repeated along B), in rounds that alternate the routes
(SWEEP lines: each route's runs, mean, spread, and cluster / one-block).
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
SOURCES = ("resid_fwd.cu", "resid_bwd.cu", "resid_bwd_cl.cu")
KERNELS = ("16resid_fwd_kernelE", "resid_bwd_kernelILb1E", "resid_fwd_cl_kernelILb1E",
           "resid_bwd_cl_kernel")
# the builds beside the library: (name, sources, defines)
VARIANTS = (("probe", SOURCES, ("SAKE_PROBE",)),)
# --serving: K1's and K2's sources, their kernels on both routes and the products
SERVING_SOURCES = ("resid_fwd.cu", "resid_bwd.cu")
SERVING_KERNELS = ("16resid_fwd_kernelE", "resid_fwd_tc_kernel", "resid_bwd_kernelILb0E",
                   "resid_bwd_tc_kernel", "resid_tc_product_kernel")
SERVING_B = 512  # resid_energy_forces' chunk
# the tensor-core products of K1's and K2's routes alone, (n, k, m, warps): the
# x-mixing (K1, 8 warps) and its transpose (K2, 16), o_f and o1 (K1) and their
# pullbacks (K2)
TC_PRODUCTS = ((21, 256, 256, 8), (21, 256, 256, 16), (21, 50, 64, 8), (21, 64, 64, 8),
               (21, 64, 64, 16), (21, 64, 50, 16))
TC_PRODUCT_TOL = 1e-6  # max |diff| / max |float64 ref|, as the CPU tests hold the plain models


def slots():
    """probe.cuh's slot names, in order (tools/probe_fused.py keeps them)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from probe_fused import SLOTS

    return SLOTS


def cuda_ms(fn, reps: int = 3, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def load(path):
    """A library with every entry of K1's and K2's sources declared."""
    from sake_tpu_torch.kernels import build

    names = [n for n in build.signatures() if n.startswith("sake_resid_")
             and not n.startswith(("sake_resid_jvp", "sake_resid_tbwd"))] + ["sake_error_string"]
    have = [n for n in names if hasattr(ctypes.CDLL(str(path)), n)]
    return build.declare(ctypes.CDLL(str(path)), have)


def qm9_inputs(dev):
    """chip_smoke.py phase 5's inputs: ``(leaves, leaves_t, h0, xs, zs, m4, dh,
    upd)`` of the first ``qm9_kernel`` training batch."""
    import torch

    from sake_tpu_torch.data.qm9 import dimenet_split, load_qm9
    from sake_tpu_torch.kernels.functional import embed
    from sake_tpu_torch.kernels.leaves import transposed, wide_stack
    from sake_tpu_torch.tasks import qm9 as task
    from sake_tpu_torch.train import shuffle_batches

    cfg = task.QM9Config(use_kernel_backbone=True, data_parallel=False)
    data = load_qm9(None, cfg.n_samples, seed=cfg.seed)
    tr_idx, _, _ = dimenet_split(len(data.x))
    n_classes = int(data.charges.max()) + 1
    y_mean, y_std = float(data.y[tr_idx].mean()), float(data.y[tr_idx].std())
    train = task.prepare_split(data, tr_idx, n_classes, y_mean, y_std, dev)
    batch = shuffle_batches(np.random.RandomState(cfg.seed), train, cfg.batch_size)[0]
    model = task.QM9Model(cfg, n_classes, device=dev,
                          generator=torch.Generator().manual_seed(cfg.seed))
    params, _ = task.make_forward(cfg, model)
    B, N = batch["x"].shape[:2]
    with torch.no_grad():
        kp = params["kp"]
        leaves = wide_stack(kp, cfg.n_heads)
        h0 = embed(kp, batch["species"]).contiguous()
        xs = batch["x"].permute(2, 0, 1).contiguous()
        m4 = batch["edge_mask"][..., None].contiguous()
        dh = torch.randn(B, N, cfg.hidden_features, device=dev,
                         generator=torch.Generator(dev).manual_seed(3))
    return leaves, transposed(leaves), h0, xs, torch.zeros_like(xs), m4, dh, [1.0] * cfg.depth


def routes(inputs):
    """``{name: fn}``: one launch of each route of #4 and #5's rows kernel."""
    from sake_tpu_torch.kernels import resid_ef

    leaves, leaves_t, h0, xs, zs, m4, dh, upd = inputs
    fwd = resid_ef.resid_fwd_plain(leaves, h0, xs, zs, upd, mask=m4)
    return {
        "#4 one-block": lambda: resid_ef.resid_fwd(leaves, h0, xs, zs, upd, m4),
        "#4 cluster": lambda: resid_ef.resid_fwd(leaves, h0, xs, zs, upd, m4, cluster=True),
        "#5 one-block": lambda: resid_ef.resid_bwd_rows(leaves, fwd, upd, dh, zs, zs, m4,
                                                        leaves_t=leaves_t),
        "#5 cluster": lambda: resid_ef.resid_bwd_rows(leaves, fwd, upd, dh, zs, zs, m4,
                                                      leaves_t=leaves_t, cluster=True),
    }


def check_on_card(dev, inputs=None) -> dict:
    """The cluster kernels of #4, #6 and #5 (``make_hidden_fn``'s routes; #6
    through ``resid_infer``) against their plain versions on ``inputs``
    (:func:`qm9_inputs` when None): ``{check: {tensor: max |kernel - plain| /
    max |plain|}}``, and whether a second launch of each gave the first's
    outputs bit for bit (``"bitwise"``). Raises if the wrappers took the
    one-block route."""
    import torch

    from sake_tpu_torch.kernels import resid_ef

    leaves, leaves_t, h0, xs, zs, m4, dh, upd = inputs or qm9_inputs(dev)
    rel = lambda a, b: float((a - b).abs().max() / (b.abs().max() + 1e-30))
    n4, n5 = resid_ef.resid_fwd.cluster_launches, resid_ef.resid_bwd_rows.cluster_launches
    n6 = resid_ef.resid_infer.launches
    with torch.no_grad():
        k4 = [resid_ef.resid_fwd(leaves, h0, xs, zs, upd, m4, cluster=True) for _ in range(2)]
        p4 = resid_ef.resid_fwd_plain(leaves, h0, xs, zs, upd, mask=m4)
        k6 = [resid_ef.resid_infer(leaves, h0, xs, zs, upd, m4) for _ in range(2)]
        k5 = [resid_ef.resid_bwd_rows(leaves, p4, upd, dh, zs, zs, m4, leaves_t=leaves_t,
                                      cluster=True) for _ in range(2)]
        p5 = resid_ef.resid_bwd_rows_plain(leaves, p4, upd, dh, zs, zs, mask=m4)
        torch.cuda.synchronize()
    if (resid_ef.resid_fwd.cluster_launches - n4, resid_ef.resid_bwd_rows.cluster_launches - n5) \
            != (2, 2) or resid_ef.resid_infer.launches - n6 != 2:
        raise RuntimeError("the cluster route was not taken")
    names = ("bh", "bx", "bv", "h_fin", "x_fin", "v_fin")
    fwd_t = lambda o: [*zip(names, o[:6]), *((n, o.resid[n]) for n in resid_ef.RESIDS)]
    bwd_t = lambda o: [*zip(("dh", "dx", "dv"), o[:3]), *((n, o[3][n]) for n in resid_ef.ROWS)]
    same = lambda a, b: all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))
    return {
        "resid_fwd_cluster": {n: rel(a, b) for (n, a), (_, b) in zip(fwd_t(k4[0]), fwd_t(p4))},
        "resid_bwd_rows_cluster": {n: rel(a, b)
                                   for (n, a), (_, b) in zip(bwd_t(k5[0]), bwd_t(p5))},
        "resid_infer_cluster": {"h_fin": rel(k6[0][0], p4.h_fin),
                                "x_fin": rel(k6[0][1], p4.x_fin)},
        "bitwise": {"resid_fwd_cluster": same(fwd_t(k4[0]), fwd_t(k4[1])),
                    "resid_bwd_rows_cluster": same(bwd_t(k5[0]), bwd_t(k5[1])),
                    "resid_infer_cluster": all(map(torch.equal, k6[0], k6[1]))},
    }


def serving_inputs(dev, B: int = SERVING_B):
    """chip_smoke.py phase 4's per-kernel inputs: ``(params, leaves, leaves_t, hc,
    xc, zc, dh, upd)``: the MD17 serving model (``MD17Config``'s aspirin at hidden
    64, depth 6, 4 heads, seed 0), the first ``B`` molecules of
    ``synthesize_md17`` embedded, v = 0, every layer updating, a random cotangent
    of the final h."""
    import torch

    from sake_tpu_torch.data.md17 import synthesize_md17
    from sake_tpu_torch.kernels.functional import embed
    from sake_tpu_torch.kernels.leaves import transposed, wide_stack
    from sake_tpu_torch.tasks.md17 import MD17Config, make_model, species_onehot

    data = synthesize_md17(n_samples=2048, seed=0)
    species = species_onehot(data.z, int(data.z.max()))
    cfg = MD17Config(hidden_features=64, depth=6, n_heads=4)
    model = make_model(cfg, species.shape[-1], device=dev,
                       generator=torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    params = model.functional_params()
    N = len(data.z)
    with torch.no_grad():
        leaves = wide_stack(params, cfg.n_heads)
        xc = torch.as_tensor(data.x[:B], device=dev).permute(2, 0, 1).contiguous()
        hc = embed(params, species.to(dev).expand(B, N, -1)).contiguous()
        dh = torch.randn(hc.shape, device=dev, generator=torch.Generator(dev).manual_seed(2))
    return params, leaves, transposed(leaves), hc, xc, torch.zeros_like(xc), dh, \
        [1.0] * cfg.depth


def serving_masks(B: int, N: int, dev, seed: int = 1):
    """Random edge masks ``(B, N, N, 1)`` as chip_smoke.py phase 3 draws them: the
    first ``n_b`` atoms of molecule b live, ``n_b`` from 3 to N, the first
    molecule fully padded."""
    import torch

    rng = np.random.RandomState(seed)
    nm = (np.arange(N)[None] < rng.randint(3, N + 1, size=B)[:, None]).astype(np.float32)
    nm[0] = 0.0
    return torch.as_tensor((nm[:, :, None] * nm[:, None, :])[..., None], device=dev)


def k1_pairs(k, p, mask) -> list:
    """``[(name, kernel, reference)]`` of K1's outputs ``k`` against the plain
    version's ``p`` (``FwdOut``s): the boundaries, the final state and the 17
    residuals. With an edge ``mask`` the ``att`` residual is held in two parts: on
    receiver rows with a live sender against the plain version; on rows with none
    against ``resid_ef.raw_attention`` of the kernel's own ``sem_pre`` residual
    (itself held to the plain version's), since there the plain version's att
    moves by up to about 1e-3 when its logits move by 1e-7 (the -1e5 offset's
    f32 spacing; see ``raw_attention``) and no output reads it."""
    import torch

    from sake_tpu_torch.kernels import resid_ef

    names = ("bh", "bx", "bv", "h_fin", "x_fin", "v_fin")
    pairs = [*zip(names, k[:6], p[:6]),
             *((n, k.resid[n], p.resid[n]) for n in resid_ef.RESIDS if n != "att")]
    att_k, att_p = k.resid["att"], p.resid["att"]
    if mask is None:
        return pairs + [("att", att_k, att_p)]
    depth, B, NN, K = att_k.shape
    N = mask.shape[1]
    live = (mask.reshape(B, N, N).sum(-1) > 0).to(att_k.dtype)  # (B, N) receivers
    rows = live[:, :, None].expand(B, N, N).reshape(1, B, NN, 1)
    sem = k.resid["sem_pre"].float().reshape(depth, B, N, N, K)  # bf16 in the bf16 tier
    ref = torch.stack([resid_ef.raw_attention(sem[l], mask=mask)
                       for l in range(depth)]).to(att_k.dtype)
    return pairs + [("att (rows with a live sender)", att_k * rows, att_p * rows),
                    ("att (rows with none, from its own sem_pre)", att_k * (1 - rows),
                     ref.reshape(att_k.shape) * (1 - rows))]


def serving_launch(kind: str, route: str, inputs, mask=None):
    """One launch of K1 (``kind`` "K1") or K2 on ``route`` (a ``resid_ef.ROUTES``
    entry; refused off the shape's route), without counting it; K2 reads K1's
    plain outputs."""
    from sake_tpu_torch.kernels import resid_ef

    params, leaves, leaves_t, hc, xc, zc, dh, upd = inputs
    if kind == "K1":
        return lambda: resid_ef._launch_fwd(leaves, hc, xc, zc, upd, mask, route)
    fwd = resid_ef.resid_fwd_plain(leaves, hc, xc, zc, upd, mask=mask)
    return lambda: resid_ef._bwd_launch("resid_bwd", leaves, fwd, upd, dh, zc, zc, mask,
                                        leaves_t, False, route=route)[:3]


def check_tc_products(dev, product=None, seeds=(0, 1, 2, 3)) -> dict:
    """Each of ``TC_PRODUCTS`` through ``product(warps, a, w)``
    (``resid_ef.tc_product`` by default) on seeded operands on ``dev`` (``a``
    normal, ``w`` normal / sqrt(k)): the worst max |diff| / max |ref| over
    ``seeds`` against the float64 product, by case name."""
    import torch

    from sake_tpu_torch.kernels import resid_ef

    product = product or (lambda warps, a, w: resid_ef.tc_product(a, w, warps))
    out = {}
    for n, k, m, warps in TC_PRODUCTS:
        name = f"{n}x{k}@{k}x{m} {warps} warps"
        for seed in seeds:
            rng = np.random.default_rng(seed)
            a = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).to(dev)
            w = torch.from_numpy(
                (rng.standard_normal((k, m)) / np.sqrt(k)).astype(np.float32)).to(dev)
            got = product(warps, a, w)
            ref = a.double() @ w.double()
            err = float((got.double() - ref).abs().max() / ref.abs().max())
            out[name] = max(out.get(name, 0.0), err if err == err else float("inf"))
    return out


def check_serving_on_card(dev, inputs=None, routes=None) -> dict:
    """K1 and K2 on each of ``routes`` (``resid_ef.ROUTES`` when None) against
    their plain versions on ``inputs`` (:func:`serving_inputs` when None),
    unmasked and with :func:`serving_masks`: ``{check: {tensor: max |kernel -
    plain| / max |plain|}}``, whether a second launch gave the first's outputs
    bit for bit (``"bitwise"``), and the routes' products against float64
    (``"products"``)."""
    import torch

    from sake_tpu_torch.kernels import resid_ef

    inputs = inputs or serving_inputs(dev)
    params, leaves, leaves_t, hc, xc, zc, dh, upd = inputs
    rel = lambda a, b: float((a - b).abs().max() / (b.abs().max() + 1e-30))
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
    fwd_t = lambda o: [*o[:6], *(o.resid[n] for n in resid_ef.RESIDS)]
    res = {"bitwise": {}}
    for label, m4 in (("unmasked", None), ("masked", serving_masks(*hc.shape[:2], dev))):
        with torch.no_grad():
            p1 = resid_ef.resid_fwd_plain(leaves, hc, xc, zc, upd, mask=m4)
            p2 = resid_ef.resid_bwd_plain(leaves, p1, upd, dh, zc, zc, mask=m4)
            for route in routes or resid_ef.ROUTES:
                k1 = [resid_ef._launch_fwd(leaves, hc, xc, zc, upd, m4, route) for _ in range(2)]
                k2 = [resid_ef._bwd_launch("resid_bwd", leaves, p1, upd, dh, zc, zc, m4,
                                           leaves_t, False, route=route)[:3] for _ in range(2)]
                torch.cuda.synchronize()
                key = f"K1 {route} {label}"
                res[key] = {n: rel(a, b) for n, a, b in k1_pairs(k1[0], p1, m4)}
                res["bitwise"][key] = same(fwd_t(k1[0]), fwd_t(k1[1]))
                key = f"K2 {route} {label}"
                res[key] = {n: rel(a, b) for n, a, b in zip(("dh", "dx", "dv"), k2[0], p2)}
                res["bitwise"][key] = same(k2[0], k2[1])
                del k1, k2
    res["products"] = check_tc_products(dev)
    return res


def probe_serving(lib, inputs, routes, smi: str) -> dict:
    """One launch of K1 and K2 on each of ``routes`` on the probe build ``lib``;
    prints and returns ``{label: {slot: share}}``."""
    import torch

    from sake_tpu_torch.kernels import build

    names = slots()
    B, N = inputs[3].shape[:2]
    out = {}
    groups = {"x-mixing": ("_xmix",), "edge products (o_f, o1, sem)": ("_mm",),
              "row rest": ("_row",), "saved-row staging": ("_load",),
              "node phase": ("_node", "_pre", "_rows")}
    for kind in ("K1", "K2"):
        entry = lib.sake_resid_fwd_probe if kind == "K1" else lib.sake_resid_bwd_probe
        for route in routes:
            fn = serving_launch(kind, route, inputs)
            ticks = (ctypes.c_ulonglong * len(names))()
            build.check(lib, entry(ticks, 1), "probe reset")
            with_lib(lib, fn)
            torch.cuda.synchronize()
            build.check(lib, entry(ticks, 1), "probe read")
            total = sum(ticks)
            shares = {s: round(t / total, 4) for s, t in zip(names, ticks) if t}
            grouped = {g: round(sum(v for s, v in shares.items() if s.endswith(ends)), 4)
                       for g, ends in groups.items()}
            print(f"PROBE {kind} {route} B={B} N={N} unmasked: block cycles {total} "
                  f"({total / B:.4g} per molecule); {json.dumps(grouped)}; shares "
                  f"{json.dumps(shares)} ({smi})", flush=True)
            out[f"{kind} {route}"] = shares
    return out


def serving_main(args, smi: str) -> int:
    """``--serving`` (see the top)."""
    import torch

    from sake_tpu_torch.kernels import build, resid_ef

    dev = torch.device("cuda", 0)
    routes = args.routes or list(resid_ef.ROUTES)
    paths, errors = {}, []

    def job(key, defines=()):
        try:
            paths[key] = build.build(SERVING_SOURCES, defines)
        except Exception as e:  # re-raised below
            errors.append(e)

    jobs = [threading.Thread(target=job, args=("plain",))]
    if "probe" in args.phases:
        jobs.append(threading.Thread(target=job, args=("probe", ("SAKE_PROBE",))))
    for j in jobs:
        j.start()
    for j in jobs:
        j.join()
    if errors:
        raise errors[0]
    for key in paths:
        lines = (paths[key].parent / "ptxas.txt").read_text().splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and any(k in line for k in SERVING_KERNELS):
                for ln in lines[i:i + 4]:
                    print(f"PTXAS {key} {ln.strip()}", flush=True)
    libs = {k: load(p) for k, p in paths.items()}
    build._lib = libs["plain"]  # the wrappers launch through the plain build
    inputs = serving_inputs(dev)
    dims = resid_ef._dims(inputs[1], inputs[3])
    lib = libs["plain"]
    occ = {"K1 route": resid_ef.ROUTES[lib.sake_resid_fwd_tc_route(*dims)],
           "K2 route": resid_ef.ROUTES[lib.sake_resid_bwd_tc_route(*dims)],
           "K1 tensor-core blocks an SM": lib.sake_resid_fwd_tc_occupancy(*dims),
           **{k: getattr(lib, e)(*dims) for k, e in (
               ("K1 CUDA-core smem", "sake_resid_fwd_smem_bytes"),
               ("K1 tensor-core smem", "sake_resid_fwd_tc_smem_bytes"),
               ("K2 CUDA-core smem", "sake_resid_bwd_smem_bytes"),
               ("K2 tensor-core smem", "sake_resid_bwd_tc_smem_bytes"))}}
    print(f"OCCUPANCY at {dims} on "
          f"{torch.cuda.get_device_properties(dev).multi_processor_count} SMs: "
          f"{json.dumps(occ)}", flush=True)
    ok = occ["K1 tensor-core blocks an SM"] == 2
    if "check" in args.phases:
        res = check_serving_on_card(dev, inputs, routes)
        for key, errs in res.items():
            if key in ("bitwise", "products"):
                continue
            worst = max(errs, key=errs.get)
            good = errs[worst] <= 1e-4 and res["bitwise"][key]
            ok &= good
            print(f"CHECK {key} vs plain (B={dims[0]}, N={dims[1]}): max rel err "
                  f"{errs[worst]:.3e} ({worst}), two launches bitwise {res['bitwise'][key]}, "
                  f"ok {good} " + json.dumps({k: float(f"{v:.2e}") for k, v in errs.items()}),
                  flush=True)
        good = max(res["products"].values()) <= TC_PRODUCT_TOL
        ok &= good
        print(f"CHECK tensor-core products vs float64 (limit {TC_PRODUCT_TOL:.0e}): ok {good} "
              + json.dumps({k: float(f"{v:.3e}") for k, v in res["products"].items()}),
              flush=True)
    if "probe" in args.phases:
        probe_serving(libs["probe"], inputs, routes, smi)
    if "time" in args.phases:
        with torch.no_grad():
            cases = {f"{kind} {route} B={dims[0]}": serving_launch(kind, route, inputs)
                     for kind in ("K1", "K2") for route in routes}
            runs = {k: [] for k in cases}
            for r in range(args.reps):
                row = {}
                for k, fn in (cases.items() if r % 2 == 0 else reversed(cases.items())):
                    row[k] = cuda_ms(fn)
                    runs[k].append(row[k])
                print(f"TIMES round {r}: " + json.dumps({k: round(v, 4) for k, v in row.items()}),
                      flush=True)
        for k, v in runs.items():
            print(f"TIME {k}: mean {sum(v) / len(v):.4f} ms, spread {max(v) / min(v):.4f}, runs "
                  f"{json.dumps([round(x, 4) for x in v])} ({smi})", flush=True)
    print(f"SERVING ok {ok}", flush=True)
    return 0 if ok else 1


def tiled(inputs, B: int):
    """:func:`qm9_inputs` with its molecules repeated along the batch up to
    ``B``."""
    import torch

    leaves, leaves_t, h0, xs, zs, m4, dh, upd = inputs
    idx = torch.arange(B, device=h0.device) % h0.shape[0]
    xs = xs[:, idx].contiguous()
    return (leaves, leaves_t, h0[idx].contiguous(), xs, torch.zeros_like(xs),
            m4[idx].contiguous(), dh[idx].contiguous(), upd)


def sweep(inputs, batches, reps: int, smi: str) -> dict:
    """Both routes of #4 and #5's rows kernel at each batch size
    (``_launch_fwd`` / ``_bwd_launch`` on the route named), in rounds that
    alternate the order; prints and returns ``{B: {route: mean ms}}``."""
    import torch

    from sake_tpu_torch.kernels import resid_ef

    out = {}
    for B in batches:
        leaves, leaves_t, h0, xs, zs, m4, dh, upd = tiled(inputs, B)
        with torch.no_grad():
            fwd = resid_ef._launch_fwd(leaves, h0, xs, zs, upd, m4, "cluster")
            cases = {f"#4 {r}": (lambda r=r: resid_ef._launch_fwd(leaves, h0, xs, zs, upd, m4,
                                                                  r))
                     for r in ("block", "cluster")}
            cases.update({f"#5 {r}": (lambda r=r: resid_ef._bwd_launch(
                "resid_bwd_rows", leaves, fwd, upd, dh, zs, zs, m4, leaves_t, True, route=r))
                for r in ("block", "cluster")})
            runs = {k: [] for k in cases}
            for r in range(reps):
                for k, fn in (cases.items() if r % 2 == 0 else reversed(cases.items())):
                    runs[k].append(cuda_ms(fn))
        means = {k: sum(v) / len(v) for k, v in runs.items()}
        for k, v in runs.items():
            print(f"SWEEP B={B} N={h0.shape[1]} masked {k}: mean {means[k]:.4f} ms, spread "
                  f"{max(v) / min(v):.4f}, runs {json.dumps([round(x, 4) for x in v])} ({smi})",
                  flush=True)
        print(f"SWEEP B={B} cluster / one-block: #4 {means['#4 cluster'] / means['#4 block']:.4f}"
              f", #5 {means['#5 cluster'] / means['#5 block']:.4f}", flush=True)
        out[B] = means
        del fwd, cases
    return out


def with_lib(lib, fn):
    """``fn()`` with the wrappers launching through ``lib``."""
    from sake_tpu_torch.kernels import build

    saved, build._lib = build._lib, lib
    try:
        return fn()
    finally:
        build._lib = saved


def probe(lib, inputs, smi: str) -> dict:
    """One launch of each route on the probe build ``lib``; prints and returns
    ``{route: {slot: share}}``."""
    import torch

    from sake_tpu_torch.kernels import build, resid_ef

    names = slots()
    B, N = inputs[2].shape[:2]
    out = {}
    for name, fn in routes(inputs).items():
        entry = {"#4 one-block": lib.sake_resid_fwd_probe, "#4 cluster": lib.sake_resid_fwd_probe,
                 "#5 one-block": lib.sake_resid_bwd_probe,
                 "#5 cluster": lib.sake_resid_bwd_cl_probe}[name]
        ticks = (ctypes.c_ulonglong * len(names))()
        build.check(lib, entry(ticks, 1), "probe reset")
        before = (resid_ef.resid_fwd.cluster_launches, resid_ef.resid_bwd_rows.cluster_launches)
        with_lib(lib, fn)
        torch.cuda.synchronize()
        took = (resid_ef.resid_fwd.cluster_launches, resid_ef.resid_bwd_rows.cluster_launches)
        if ("cluster" in name) != (took != before):
            raise RuntimeError(f"{name}: the wrapper took the other route")
        build.check(lib, entry(ticks, 1), "probe read")
        total = sum(ticks)
        shares = {s: round(t / total, 4) for s, t in zip(names, ticks) if t}
        xmix = sum(v for s, v in shares.items() if s.endswith("xmix"))
        mm = sum(v for s, v in shares.items() if s.endswith("_mm"))
        print(f"PROBE {name} B={B} N={N} masked: block cycles {total} ({total / B:.4g} per "
              f"molecule); x-mixing share {xmix:.4f}, edge products {mm:.4f}; shares "
              f"{json.dumps(shares)} ({smi})", flush=True)
        out[name] = shares
    return out


def occupancy(lib, dims) -> dict:
    """The cluster kernels' clusters the card holds at once, and each
    kernel's shared memory in bytes, at ``dims``."""
    entries = {"#4 cluster clusters": "sake_resid_fwd_cluster_max_active",
               "#5 cluster clusters": "sake_resid_bwd_cluster_max_active",
               "#4 one-block smem": "sake_resid_fwd_smem_bytes",
               "#5 one-block smem": "sake_resid_bwd_smem_bytes",
               "#4 cluster smem": "sake_resid_fwd_cluster_smem_bytes",
               "#5 cluster smem": "sake_resid_bwd_cluster_smem_bytes"}
    return {k: getattr(lib, e)(*dims) for k, e in entries.items()}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3, help="timing rounds")
    ap.add_argument("--phases", nargs="*", default=["check", "probe", "time"],
                    choices=["check", "probe", "time", "sweep"])
    ap.add_argument("--batches", nargs="*", type=int, default=[64, 96, 128, 192, 256],
                    help="batch sizes of the sweep phase")
    ap.add_argument("--serving", action="store_true",
                    help="K1 and K2 at MD17 serving's shapes on both routes (see the top)")
    ap.add_argument("--routes", nargs="*", choices=["CUDA cores", "tensor cores"],
                    help="--serving: the routes to check, probe and time (both by default)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_resid: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from sake_tpu_torch.kernels import build, resid_ef

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.serving:
        return serving_main(args, smi)
    dev = torch.device("cuda", 0)

    paths, errors = {}, []

    def job(key, only=(), defines=()):
        try:
            paths[key] = build.build(only, defines)
        except Exception as e:  # re-raised below
            errors.append(e)

    jobs = [threading.Thread(target=job, args=("plain",))]
    if {"probe", "time"} & set(args.phases):
        jobs += [threading.Thread(target=job, args=v) for v in VARIANTS]
    for j in jobs:
        j.start()
    for j in jobs:
        j.join()
    if errors:
        raise errors[0]
    for key in paths:
        lines = (paths[key].parent / "ptxas.txt").read_text().splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and any(k in line for k in KERNELS):
                for ln in lines[i:i + 4]:
                    print(f"PTXAS {key} {ln.strip()}", flush=True)
    libs = {k: (build.load() if k == "plain" else load(p)) for k, p in paths.items()}

    inputs = qm9_inputs(dev)
    dims = resid_ef._dims(inputs[0], inputs[2])
    print(f"OCCUPANCY at {dims} on "
          f"{torch.cuda.get_device_properties(dev).multi_processor_count} SMs: "
          f"{json.dumps(occupancy(libs['plain'], dims))}", flush=True)
    ok = True
    if "check" in args.phases:
        res = check_on_card(dev, inputs)
        for check in ("resid_fwd_cluster", "resid_bwd_rows_cluster"):
            worst = max(res[check], key=res[check].get)
            good = res[check][worst] <= 1e-4 and res["bitwise"][check]
            ok &= good
            print(f"CHECK {check} vs plain (B={dims[0]}, N={dims[1]}, masked): max rel err "
                  f"{res[check][worst]:.3e} ({worst}), two launches bitwise "
                  f"{res['bitwise'][check]}, ok {good} "
                  + json.dumps({k: float(f"{v:.2e}") for k, v in res[check].items()}),
                  flush=True)
    if "probe" in args.phases:
        probe(libs["probe"], inputs, smi)
    if "sweep" in args.phases:
        sweep(inputs, args.batches, args.reps, smi)
    if "time" not in args.phases:
        return 0 if ok else 1

    # every route on both builds, alternated round by round
    fns = routes(inputs)
    cases = {f"{name} [{key}]": (libs[key], fn) for key in ("plain", "probe")
             for name, fn in fns.items()}
    runs = {k: [] for k in cases}
    for r in range(args.reps):
        row = {}
        for k, (lib, fn) in (cases.items() if r % 2 == 0 else reversed(cases.items())):
            row[k] = with_lib(lib, lambda: cuda_ms(fn))
            runs[k].append(row[k])
        print(f"TIMES round {r}: " + json.dumps({k: round(v, 4) for k, v in row.items()}),
              flush=True)
    for k, v in runs.items():
        print(f"TIME {k}: mean {sum(v) / len(v):.4f} ms, spread {max(v) / min(v):.4f}, runs "
              f"{json.dumps([round(x, 4) for x in v])} ({smi})", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
