"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. device: requires CUDA (no CPU fallback); prints the card's name and
   power limit as nvidia-smi reports them. TF32 is off for matmuls and cuDNN.
2. build: compiles ``sake_tpu_torch/csrc/*.cu`` with nvcc (one process per
   source, in parallel) and prints the build time and ptxas's register
   and spill lines.
3. kernels vs plain, MD17: at full width (hidden 64, C 256, R 50, 4 heads),
   aspirin's N = 21 and B = 37, K1 against ``resid_fwd_plain`` (boundary
   states and all 17 residuals) and K2 against ``resid_bwd_plain`` (dh, dx,
   dv), unmasked and with random edge masks; max relative error =
   max|kernel - plain| / max|plain| per tensor, limit 1e-4.
4. MD17 slice: ``SAKEModel(64, depth=6, n_heads=4)`` from a seeded init
   serves aspirin E + F requests of B in {1, 37, 512, 2048} through
   ``tasks/md17.make_energy_force_fn`` -> dispatch -> K1 + K2, checked
   against the plain f32 autograd path (chunks of 256):
   ``f_err = max|dF| / max|F|`` <= 1e-4 and ``e_err = max|dE| / max|E|``
   on raw (uncolored) energies <= 1e-5. The launch counters must move. Then
   both paths are timed at B = 2048 in chunks of 512 with CUDA events, in
   turns, and the kernel path's time is split into K1 + K2 and the rest.
5. kernels vs plain, QM9: a ``synthesize_qm9`` training batch at the
   ``qm9_kernel`` widths (B = 64, N = 29, hidden 64, depth 6) with its real
   masks: the masked K1 (boundaries and all 17 residuals), the forward
   without residuals (h_fin, x_fin), the training pullback (dh, dx, dv) and
   the parameter-gradient kernel (each of the 29 leaves of each layer),
   limit 1e-4 relative per tensor.
6. QM9 slice: ``tasks/qm9.run`` at the ``qm9_kernel`` settings (kernel
   backbone, one device, batch 64, 4096 synthetic molecules) for 2 epochs
   of 53 steps and the valid/test evaluation through the forward without
   residuals. Every kernel of the path must launch, every step's loss must
   be finite and the last below the first.
7. QM9 step parity and timing: from one seeded init, step 1's loss and
   every parameter gradient of the kernel branch against the plain branch
   (1e-4 relative per leaf), the first 5 steps' losses (1e-3 relative);
   then the train step of both branches timed in turns (every run
   printed) and each kernel timed at the slice's shapes beside its plain
   version and its bound.
8. MD17 second-order training kernels vs plain: aspirin at full width (N =
   21, hidden 64, depth 6), B = 300 (three waves of one block per SM), the
   training path's inputs (embedded species, v = 0, every layer updating)
   and random cotangents: the shared primal's K1 (#7, boundaries and all 17
   residuals) and K2 (#8, dx), the tangent forward (#9, every tangent
   boundary and residual), the tangent pullback (its cotangents, Hessian
   terms, rows and row tangents), the primal chain with the Hessian terms
   (cotangents and rows), the augmented contraction and the whole
   augmented pullback (#10: dh0, dx, dth and each of the 29 leaves of each
   layer), limit 1e-4 relative per tensor.
9. MD17 step parity: ``tasks/md17`` kernel branch (``make_ef_train2``,
   ``aug_mode="shared"``) against the plain branch (double autograd through
   the functional model) from one seeded init at B = 4: E and F of the
   kernel primal against the functional path (as phase 4's limits), step
   1's loss and every gradient (1e-4 relative per leaf), the first 5
   losses (1e-3 relative).
10. MD17 slice: ``tasks/md17.run`` on the kernel branch, ``MD17Config()``
   defaults but ``aug_mode="shared"``, n_valid 200 and 2 epochs of 250
   steps (cut from 1000 and 100): every kernel of the path must
   launch, the loss must stay finite and fall, and the E and F MAE (kcal/mol)
   are printed. Then the train step of both branches at B = 4 and B = 512
   in turns (every run printed), a BREAKDOWN of the kernel branch's step,
   and each kernel timed at both batches beside its plain version and its
   bound.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

K1_TOL = K2_TOL = 1e-4
F_TOL, E_TOL = 1e-4, 1e-5
QM9_TOL = 1e-4  # kernels and step-1 gradients, relative per tensor
LOSS_TOL = 1e-3  # the first steps' losses, relative
FULL = dict(hidden=64, depth=6, heads=4)
REQUESTS = (1, 37, 512, 2048)
SEED = 0
CHECK_CHUNK = 256  # molecules per autograd pass of the plain reference in the checks
PATH_CHUNK = 512  # resid_energy_forces' chunk; the plain path is timed at it too
QM9_EPOCHS = 2
PARITY_STEPS = 5
TRAIN_TOL = 1e-4  # MD17 training kernels and step-1 gradients, relative per tensor
TRAIN_CHECK_B = 300  # three waves of one block per SM on 132 SMs
TRAIN_BATCHES = (4, 512)  # MD17Config's batch, and bench_md17_train.py's
# the slice's cut: MD17Config() validates on 1000 molecules and trains 100 epochs
MD17_RUN = dict(n_valid=200, n_epochs=2, epochs_per_block=1)
# H100 SXM peaks (NVIDIA's data sheet): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS, PEAK_BYTES = 67e12, 3.35e12


def fail(msg: str):
    print(f"FAIL {msg}", flush=True)
    sys.exit(1)


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / (want.abs().max() + 1e-30))


def abs_err(got, want) -> float:
    return float((got - want).abs().max())


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


def nbytes(*trees) -> int:
    """Bytes of every tensor in nested tuples, lists and dicts."""
    import torch

    total = 0
    for t in trees:
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        elif isinstance(t, dict):
            total += nbytes(*t.values())
        elif isinstance(t, (list, tuple)):
            total += nbytes(*t)
    return total


def layer_fma(N, F, H, R, K, C):
    """Multiply-adds of the matrix products of one molecule and layer, for
    the forward, the input pullback and the parameter-gradient contractions.
    Elementwise work (exp, tanh, sigmoid, sums) is not counted, so bounds
    built on these counts are lower bounds."""
    HK, E = H * K, N * N
    fwd = (E * (R * H + H * H + H * K + HK * C + 3 * C)  # o_f, o1, sem, x_mixing, pooled
           + N * (F * (2 * R + 2 * H) + C * H + 2 * H * H + 2 * F * H + HK * H + H * F
                  + 3 * C + H))  # projections, post MLP, node MLP, gate, v_mixing
    bwd = (E * (C * HK + 2 * HK + K * H + H * H + H * R + 6 * C)
           + N * (2 * F * R + 2 * R * F + 2 * H * F + 3 * H * F + HK * H + 2 * H * H
                  + C * H + 3 * C + H))
    grads = (E * (R * H + H * H + H * K + HK * C)
             + N * (2 * F * R + 2 * F * H + C * H + H * H + F * H + HK * H + H * H
                    + H * F + 3 * C + F * H + H))
    # the tangent forward: the forward's products on the tangents, plus the
    # recomputed a_j, a_i and the pooled sum's second term
    jvp = fwd + N * 2 * F * R + E * 3 * C
    # the tangent pullback: every product of the pullback on values and on
    # tangents; the augmented contraction: a (g_p + t_g) and t_a g_t
    return dict(fwd=fwd, bwd=bwd, grads=grads, jvp=jvp, tbwd=2 * bwd, grads_aug=2 * grads)


def bound(fma: float, moved: int):
    """``(bound_ms, bound_by)``: the larger of the f32 operations (2 per
    multiply-add) over the card's peak and the bytes over its memory rate."""
    t_ops, t_bytes = 2 * fma / PEAK_F32_FLOPS * 1e3, moved / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_entry(name, source, replaces, launches, max_abs_err, ms, plain_ms, fma, moved):
    bound_ms, bound_by = bound(fma, moved)
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)  # no one PyTorch call runs a layer stack


def main() -> int:
    import torch

    # -- 1. device ------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU only", file=sys.stderr)
        return 1
    # the port itself: without it beside this script, fail before printing anything
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sake_tpu_torch.data.md17 import synthesize_md17
    from sake_tpu_torch.kernels import build, resid_ef
    from sake_tpu_torch.kernels.functional import embed, energy_and_forces_fn
    from sake_tpu_torch.kernels.leaves import transposed, wide_stack
    from sake_tpu_torch.tasks.md17 import (
        MD17Config,
        make_energy_force_fn,
        make_model,
        species_onehot,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"DEVICE {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}", flush=True)

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    print(f"BUILD ok {time.perf_counter() - t0:.2f} s -> {lib_path.parent.name}", flush=True)
    for line in (lib_path.parent / "ptxas.txt").read_text().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"PTXAS {line.strip()}", flush=True)

    data = synthesize_md17(n_samples=max(REQUESTS), seed=SEED)
    species = species_onehot(data.z, int(data.z.max()))
    e_mean, e_std = float(data.e.mean()), float(data.e.std())
    cfg = MD17Config(hidden_features=FULL["hidden"], depth=FULL["depth"],
                     n_heads=FULL["heads"])
    gen = torch.Generator().manual_seed(SEED)
    model = make_model(cfg, species.shape[-1], device=dev, generator=gen)
    model.requires_grad_(False)
    params = model.functional_params()
    leaves = wide_stack(params, cfg.n_heads)
    N = len(data.z)

    # -- 3. kernels vs plain at full width, B = 37, unmasked and masked ---------
    rng = np.random.RandomState(SEED + 1)
    Bk = 37
    tdev = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
    x37 = tdev(data.x[:Bk].transpose(2, 0, 1))
    h37 = embed(params, species.to(dev).expand(Bk, N, -1)).contiguous()
    v37 = tdev(0.1 * rng.randn(3, Bk, N))
    upd = [1.0, 0.3, 0.0, 1.0, 1.0, 1.0]  # exercises the gate at 0 < upd < 1
    nm37 = (np.arange(N)[None] < rng.randint(3, N + 1, size=Bk)[:, None]).astype(np.float32)
    nm37[0] = 0.0  # one fully padded molecule
    masks = {"unmasked": None, "masked": tdev((nm37[:, :, None] * nm37[:, None, :])[..., None])}
    abs_md17 = {"resid_fwd": 0.0, "resid_bwd": 0.0}
    for label, m4 in masks.items():
        with torch.no_grad():
            k1 = resid_ef.resid_fwd(leaves, h37, x37, v37, upd, mask=m4)
            p1 = resid_ef.resid_fwd_plain(leaves, h37, x37, v37, upd, mask=m4)
            seeds = (tdev(rng.randn(Bk, N, FULL["hidden"])), tdev(rng.randn(3, Bk, N)),
                     tdev(rng.randn(3, Bk, N)))
            k2 = resid_ef.resid_bwd(leaves, p1, upd, *seeds, mask=m4)
            p2 = resid_ef.resid_bwd_plain(leaves, p1, upd, *seeds, mask=m4)
            torch.cuda.synchronize()
        pairs1 = [*zip(("bh", "bx", "bv", "h_fin", "x_fin", "v_fin"), k1[:6], p1[:6]),
                  *((n, k1.resid[n], p1.resid[n]) for n in resid_ef.RESIDS)]
        k1_err = {n: rel_err(a, b) for n, a, b in pairs1}
        k2_err = {n: rel_err(a, b) for n, a, b in zip(("dh", "dx", "dv"), k2, p2)}
        abs_md17["resid_fwd"] = max(abs_md17["resid_fwd"], *(abs_err(a, b) for _, a, b in pairs1))
        abs_md17["resid_bwd"] = max(abs_md17["resid_bwd"], *(abs_err(a, b) for a, b in zip(k2, p2)))
        worst1, worst2 = max(k1_err, key=k1_err.get), max(k2_err, key=k2_err.get)
        print(f"K1 vs plain {label} (B={Bk}, N={N}, depth 6): max rel err {k1_err[worst1]:.3e} "
              f"({worst1}) " + json.dumps({k: float(f"{v:.3e}") for k, v in k1_err.items()}),
              flush=True)
        print(f"K2 vs plain {label}: max rel err {k2_err[worst2]:.3e} ({worst2}) "
              + json.dumps({k: float(f"{v:.3e}") for k, v in k2_err.items()}), flush=True)
        if not (k1_err[worst1] <= K1_TOL and k2_err[worst2] <= K2_TOL):
            fail(f"{label} kernel vs plain beyond {K1_TOL}")

    # -- 4. the MD17 slice: serve aspirin E + F through K1 + K2 -----------------
    serve = make_energy_force_fn(model, species, e_mean, e_std)

    def plain_ef(x, chunk=CHECK_CHUNK):
        es, fs = [], []
        for s in range(0, x.shape[0], chunk):
            xc = x[s : s + chunk]
            h = species.to(dev).expand(xc.shape[0], N, -1)
            e, f = energy_and_forces_fn(params, h, xc, n_heads=cfg.n_heads)
            es.append(e)
            fs.append(f)
        return torch.cat(es), torch.cat(fs)

    xs_all = torch.as_tensor(data.x, device=dev)
    resid_ef.resid_fwd.launches = 0
    resid_ef.resid_bwd.launches = 0
    answers = {B: serve(xs_all[:B]) for B in REQUESTS}
    torch.cuda.synchronize()
    md17_launches = {"resid_fwd": resid_ef.resid_fwd.launches,
                     "resid_bwd": resid_ef.resid_bwd.launches}
    print(f"SLICE launches {json.dumps(md17_launches)}", flush=True)
    if min(md17_launches.values()) == 0:
        fail("the MD17 path did not launch every kernel")
    worst = {"f_err": 0.0, "e_err": 0.0}
    for B, (e, f) in answers.items():
        if e.shape != (B, 1) or f.shape != (B, N, 3):
            fail(f"B={B}: shapes {tuple(e.shape)} {tuple(f.shape)}")
        if not (torch.isfinite(e).all() and torch.isfinite(f).all()):
            fail(f"B={B}: non-finite output")
        e_raw = (e[:, 0] - e_mean) / e_std
        e_ref, f_ref = plain_ef(xs_all[:B])
        f_err = rel_err(f / e_std, f_ref)
        e_err = rel_err(e_raw, e_ref)
        worst = {"f_err": max(worst["f_err"], f_err), "e_err": max(worst["e_err"], e_err)}
        print(f"SLICE B={B}: f_err {f_err:.3e} e_err {e_err:.3e} "
              f"|F|max {float(f.abs().max()):.4g}", flush=True)
    if not (worst["f_err"] <= F_TOL and worst["e_err"] <= E_TOL):
        fail(f"slice beyond f_err {F_TOL} / e_err {E_TOL}: {worst}")

    # timing at B = 2048: the served path vs the plain f32 autograd path, both
    # in chunks of 512, in turns; every run is printed beside each side's mean
    Bt = 2048
    xb = xs_all[:Bt]
    runs = {"plain": [], "kernel": []}
    for side in ("plain", "kernel", "kernel", "plain", "plain", "kernel"):
        fn = serve if side == "kernel" else lambda x: plain_ef(x, PATH_CHUNK)
        runs[side].append(cuda_ms(lambda: fn(xb)))
    ms_kernel, ms_plain = (sum(runs[k]) / len(runs[k]) for k in ("kernel", "plain"))
    print(f"TIMING B={Bt}: kernel path {ms_kernel:.2f} ms = {Bt * 1e3 / ms_kernel:.1f} evals/s; "
          f"plain f32 autograd (chunk {PATH_CHUNK}) {ms_plain:.2f} ms = "
          f"{Bt * 1e3 / ms_plain:.1f} evals/s (runs {json.dumps(runs)}; {smi})", flush=True)
    # per kernel at the shapes the main path gives it (chunk 512, depth 6)
    xc = xs_all[:PATH_CHUNK].permute(2, 0, 1).contiguous()
    hc = embed(params, species.to(dev).expand(PATH_CHUNK, N, -1)).contiguous()
    zc = torch.zeros_like(xc)
    u6 = [1.0] * cfg.depth
    with torch.no_grad():
        leaves_t = transposed(leaves)
        fwd = resid_ef.resid_fwd(leaves, hc, xc, zc, u6)
        dh = torch.randn(hc.shape, device=dev, generator=torch.Generator(dev).manual_seed(2))
        t_k1 = cuda_ms(lambda: resid_ef.resid_fwd(leaves, hc, xc, zc, u6))
        t_p1 = cuda_ms(lambda: resid_ef.resid_fwd_plain(leaves, hc, xc, zc, u6))
        t_k2 = cuda_ms(lambda: resid_ef.resid_bwd(leaves, fwd, u6, dh, zc, zc,
                                                  leaves_t=leaves_t))
        t_p2 = cuda_ms(lambda: resid_ef.resid_bwd_plain(leaves, fwd, u6, dh, zc, zc))
    print(f"TIMING per kernel at B={PATH_CHUNK} depth 6: K1 {t_k1:.2f} ms (plain {t_p1:.2f}), "
          f"K2 {t_k2:.2f} ms (plain {t_p2:.2f})", flush=True)

    # where the B = 2048 path's time goes: K1 + K2 per chunk against the rest
    # (leaf restaging, embed, the readout seed, layout copies, host gaps)
    n_chunks = -(-Bt // PATH_CHUNK)
    with torch.no_grad():
        t_stage = cuda_ms(lambda: transposed(wide_stack(model.functional_params(), cfg.n_heads)))
        hb = species.to(dev).expand(Bt, N, -1)
        t_embed = cuda_ms(lambda: embed(params, hb))
    t_seed = cuda_ms(lambda: resid_ef._readout_seed(params, fwd.h_fin, None))
    inside = n_chunks * (t_k1 + t_k2)
    outside = ms_kernel - inside
    print(f"BREAKDOWN B={Bt}: K1+K2 {n_chunks}x({t_k1:.3f}+{t_k2:.3f}) = {inside:.3f} ms of the "
          f"path's {ms_kernel:.3f} ms; outside {outside:.3f} ms "
          f"({100 * outside / ms_kernel:.2f}%): leaf restaging {t_stage:.3f} ms, "
          f"embed {t_embed:.3f} ms, readout seed {n_chunks}x{t_seed:.3f} ms", flush=True)
    print("SLICE " + json.dumps({"evals_per_s_kernel": 2048e3 / ms_kernel,
                                 "evals_per_s_plain": 2048e3 / ms_plain, **worst}), flush=True)
    dims21 = (N, FULL["hidden"], FULL["hidden"], 50, FULL["heads"], 256)
    fma21 = {k: v * PATH_CHUNK * cfg.depth for k, v in layer_fma(*dims21).items()}
    kernels = [
        kernel_entry("resid_fwd", "sake_tpu_torch/csrc/resid_fwd.cu",
                     "sake_tpu/kernels/resid_ef.py:1099", md17_launches["resid_fwd"],
                     abs_md17["resid_fwd"], t_k1, t_p1, fma21["fwd"],
                     nbytes(leaves, hc, xc, zc, fwd)),
        kernel_entry("resid_bwd", "sake_tpu_torch/csrc/resid_bwd.cu",
                     "sake_tpu/kernels/resid_ef.py:1211", md17_launches["resid_bwd"],
                     abs_md17["resid_bwd"], t_k2, t_p2, fma21["bwd"],
                     nbytes(leaves, leaves_t, fwd.bh, fwd.bx, fwd.bv, fwd.resid, dh, zc, zc,
                            dh, zc, zc)),
    ]
    del fwd, answers

    kernels += qm9_phases(dev, smi)
    kernels += md17_train_phases(dev, smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def qm9_phases(dev, smi) -> list:
    """Phases 5-7 (see the module docstring); returns their kernel entries."""
    import torch

    from sake_tpu_torch.data.qm9 import dimenet_split, load_qm9
    from sake_tpu_torch.kernels import resid_ef
    from sake_tpu_torch.kernels.adapter import model_params_from_linen
    from sake_tpu_torch.kernels.functional import embed
    from sake_tpu_torch.kernels.leaves import LEAF_NAMES, transposed, wide_stack
    from sake_tpu_torch.tasks import qm9 as task
    from sake_tpu_torch.train import (
        TrainState,
        make_optimizer,
        run_epoch,
        shuffle_batches,
        tree_leaves,
    )
    from sake_tpu_torch.train.metrics import MetricLogger

    cfg = task.QM9Config(use_kernel_backbone=True, data_parallel=False, n_epochs=QM9_EPOCHS)
    plain_cfg = task.QM9Config(data_parallel=False)
    data = load_qm9(None, cfg.n_samples, seed=cfg.seed)
    tr_idx, _, _ = dimenet_split(len(data.x))
    n_classes = int(data.charges.max()) + 1
    y_mean, y_std = float(data.y[tr_idx].mean()), float(data.y[tr_idx].std())
    train = task.prepare_split(data, tr_idx, n_classes, y_mean, y_std, dev)
    new_model = lambda: task.QM9Model(cfg, n_classes, device=dev,
                                      generator=torch.Generator().manual_seed(cfg.seed))
    batches = shuffle_batches(np.random.RandomState(cfg.seed), train, cfg.batch_size)
    batch = batches[0]
    B, N = batch["x"].shape[:2]
    F, depth = cfg.hidden_features, cfg.depth

    # -- 5. kernels vs plain at the QM9 shapes ----------------------------------
    params, _ = task.make_forward(cfg, new_model())
    upd = [1.0] * depth
    with torch.no_grad():
        kp = params["kp"]
        leaves = wide_stack(kp, cfg.n_heads)
        leaves_t = transposed(leaves)
        h0 = embed(kp, batch["species"]).contiguous()
        xs = batch["x"].permute(2, 0, 1).contiguous()
        zs = torch.zeros_like(xs)
        m4 = batch["edge_mask"][..., None].contiguous()
        dh = torch.randn(B, N, F, device=dev, generator=torch.Generator(dev).manual_seed(3))
        k4 = resid_ef.resid_fwd(leaves, h0, xs, zs, upd, mask=m4)
        p4 = resid_ef.resid_fwd_plain(leaves, h0, xs, zs, upd, mask=m4)
        k6 = resid_ef.resid_infer(leaves, h0, xs, zs, upd, mask=m4)
        p6 = resid_ef.resid_infer_plain(leaves, h0, xs, zs, upd, mask=m4)
        k5 = resid_ef.resid_bwd_rows(leaves, p4, upd, dh, zs, zs, mask=m4, leaves_t=leaves_t)
        p5 = resid_ef.resid_bwd_rows_plain(leaves, p4, upd, dh, zs, zs, mask=m4)
        kg = resid_ef.param_grads(leaves, p4, k5[3])
        pg = resid_ef.param_grads_plain(leaves, p4, p5[3])
        pg_same = resid_ef.param_grads_plain(leaves, p4, k5[3])
        torch.cuda.synchronize()
    checks = {
        "resid_fwd_masked": [*zip(("bh", "bx", "bv", "h_fin", "x_fin", "v_fin"), k4[:6], p4[:6]),
                             *((n, k4.resid[n], p4.resid[n]) for n in resid_ef.RESIDS)],
        "resid_infer": [("h_fin", k6[0], p6[0]), ("x_fin", k6[1], p6[1])],
        "resid_bwd_rows": [*zip(("dh", "dx", "dv"), k5[:3], p5[:3]),
                           *((n, k5[3][n], p5[3][n]) for n in resid_ef.ROWS)],
        "param_grads": [(f"{n}[{l}]", kg[n][l], pg[n][l]) for n in LEAF_NAMES
                        for l in range(depth)],
        "param_grads_same_rows": [(f"{n}[{l}]", kg[n][l], pg_same[n][l]) for n in LEAF_NAMES
                                  for l in range(depth)],
    }
    abs_qm9 = {}
    for name, pairs in checks.items():
        errs = {n: rel_err(a, b) for n, a, b in pairs}
        abs_qm9[name] = max(abs_err(a, b) for _, a, b in pairs)
        w = max(errs, key=errs.get)
        print(f"QM9 {name} vs plain (B={B}, N={N}, depth {depth}, masked): max rel err "
              f"{errs[w]:.3e} ({w}), max abs err {abs_qm9[name]:.3e} "
              + json.dumps({k: float(f"{v:.2e}") for k, v in errs.items()}), flush=True)
        if errs[w] > QM9_TOL:
            fail(f"QM9 {name} beyond {QM9_TOL}")
    del k4, k6, k5, p5, kg, pg, pg_same, checks

    # -- 6. the QM9 slice through tasks/qm9.run -----------------------------------
    counters = (resid_ef.resid_fwd, resid_ef.resid_infer, resid_ef.resid_bwd_rows,
                resid_ef.param_grads, resid_ef.resid_bwd)
    step_losses = []

    def recording_epoch(step_fn, state, batches_):
        state, losses = run_epoch(step_fn, state, batches_)
        step_losses.append(losses)
        return state, losses

    task.run_epoch = recording_epoch  # keeps every step's loss of the run
    for c in counters:
        c.launches = 0
    logger = MetricLogger(stream=sys.stdout)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, results = task.run(cfg, logger, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    task.run_epoch = run_epoch
    qm9_launches = {c.__name__: c.launches for c in counters}
    losses = torch.cat(step_losses).cpu()
    print(f"QM9 SLICE launches {json.dumps(qm9_launches)}; {len(losses)} steps in "
          f"{wall:.2f} s with the evaluation; loss first {float(losses[0]):.6f} last "
          f"{float(losses[-1]):.6f}; valid MAE {results['valid_mae']:.6f} "
          f"(CI {[float(v) for v in results['valid_mae_ci']]}), test MAE "
          f"{results['test_mae']:.6f}", flush=True)
    print("QM9 SLICE losses " + json.dumps([float(f"{v:.6f}") for v in losses]), flush=True)
    if min(v for k, v in qm9_launches.items() if k != "resid_bwd") == 0:
        fail("the QM9 path did not launch every kernel")
    if not (torch.isfinite(losses).all() and losses[-1] < losses[0]
            and losses[-10:].mean() < losses[:10].mean()):
        fail("the QM9 training loss is not finite or did not fall")
    if not all(np.isfinite(results[k]) for k in ("valid_mae", "test_mae")):
        fail("non-finite QM9 evaluation")

    # -- 7. step parity against the plain branch, and timing --------------------
    branches = {}
    for name, c in (("kernel", cfg), ("plain", plain_cfg)):
        prm, fwd_fn = task.make_forward(c, new_model())
        branches[name] = dict(params=prm, forward=fwd_fn, step=task.make_train_step(fwd_fn),
                              state=TrainState.create(params=prm, tx=make_optimizer(
                                  c.learning_rate, weight_decay=c.weight_decay)))

    def loss_and_grads(br):
        leaves_ = tree_leaves(br["params"])
        pred = br["forward"](br["params"], batch["species"], batch["x"], batch["edge_mask"],
                             batch["node_mask"])
        loss = ((pred - batch["y"]) ** 2).mean()
        return loss.detach(), dict(zip(map(id, leaves_), torch.autograd.grad(
            loss, leaves_, allow_unused=True)))

    head_names = [(d, w) for d in ("dense_0", "dense_1") for w in ("kernel", "bias")]
    lk, gk = loss_and_grads(branches["kernel"])
    lp, gp = loss_and_grads(branches["plain"])
    pk = branches["kernel"]["params"]
    got = resid_ef.flat_params(pk["kp"]) + [pk["head"][d][w] for d, w in head_names]
    got = [gk[id(t)] for t in got]
    tree = {}  # the plain branch's gradients by linen name
    for name, prm in branches["plain"]["params"].items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        g = gp[id(prm)]
        node[leaf] = torch.zeros_like(prm) if g is None else g
    want = (resid_ef.flat_params(model_params_from_linen(tree["backbone"], dev))
            + [tree["head"]["head"][d][w] for d, w in head_names])
    grad_err = [rel_err(a, b) for a, b in zip(got, want)]
    loss_err = abs(float(lk - lp)) / abs(float(lp))
    print(f"QM9 STEP 1 kernel vs plain branch: loss {float(lk):.7f} vs {float(lp):.7f} "
          f"(rel {loss_err:.2e}); gradients of {len(got)} leaves, max rel err "
          f"{max(grad_err):.3e} (leaf {int(np.argmax(grad_err))})", flush=True)
    if loss_err > QM9_TOL or max(grad_err) > QM9_TOL:
        fail(f"QM9 step 1 beyond {QM9_TOL}")
    traj = {}
    for name, br in branches.items():
        traj[name] = []
        for b_ in batches[:PARITY_STEPS]:
            br["state"], loss = br["step"](br["state"], b_)
            traj[name].append(float(loss))
    traj_err = max(abs(a - b) / abs(b) for a, b in zip(traj["kernel"], traj["plain"]))
    print(f"QM9 STEPS 1-{PARITY_STEPS} losses kernel {json.dumps(traj['kernel'])} plain "
          f"{json.dumps(traj['plain'])}: max rel diff {traj_err:.2e}", flush=True)
    if traj_err > LOSS_TOL:
        fail(f"QM9 step losses differ beyond {LOSS_TOL}")

    # train step time, kernel and plain branches in turns, 5 steps a run
    runs = {"plain": [], "kernel": []}
    timed = batches[PARITY_STEPS : PARITY_STEPS + 5]
    for side in ("plain", "kernel", "kernel", "plain", "plain", "kernel"):
        br = branches[side]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b_ in timed:
            br["state"], _ = br["step"](br["state"], b_)
        torch.cuda.synchronize()
        runs[side].append((time.perf_counter() - t0) * 1e3 / len(timed))
    step_ms = {k: sum(v) / len(v) for k, v in runs.items()}
    # where the kernel branch's step goes: the optimizer update alone, and
    # the forward + backward without it
    br = branches["kernel"]
    zero_grads = [torch.zeros_like(p) for p in tree_leaves(br["params"])]
    t_opt = cuda_ms(lambda: br["state"].apply_gradients(zero_grads))
    t_fb = cuda_ms(lambda: loss_and_grads(br))
    print(f"QM9 TIMING train step at B={B}: kernel {step_ms['kernel']:.2f} ms = "
          f"{B * 1e3 / step_ms['kernel']:.1f} samples/s; plain {step_ms['plain']:.2f} ms = "
          f"{B * 1e3 / step_ms['plain']:.1f} samples/s (ms per step, runs {json.dumps(runs)}; "
          f"{smi})", flush=True)
    print(f"QM9 BREAKDOWN kernel-branch step {step_ms['kernel']:.2f} ms: forward + backward "
          f"{t_fb:.2f} ms, optimizer update {t_opt:.2f} ms ({len(zero_grads)} tensors)",
          flush=True)

    # per kernel at the slice's shapes
    with torch.no_grad():
        rows = resid_ef.resid_bwd_rows(leaves, p4, upd, dh, zs, zs, mask=m4,
                                       leaves_t=leaves_t)[3]
        grads = resid_ef.param_grads(leaves, p4, rows)
        t = dict(
            resid_fwd_masked=(cuda_ms(lambda: resid_ef.resid_fwd(leaves, h0, xs, zs, upd, m4)),
                              cuda_ms(lambda: resid_ef.resid_fwd_plain(leaves, h0, xs, zs, upd,
                                                                       m4))),
            resid_infer=(cuda_ms(lambda: resid_ef.resid_infer(leaves, h0, xs, zs, upd, m4)),
                         cuda_ms(lambda: resid_ef.resid_infer_plain(leaves, h0, xs, zs, upd,
                                                                    m4))),
            resid_bwd_rows=(cuda_ms(lambda: resid_ef.resid_bwd_rows(
                                leaves, p4, upd, dh, zs, zs, m4, leaves_t=leaves_t)),
                            cuda_ms(lambda: resid_ef.resid_bwd_rows_plain(
                                leaves, p4, upd, dh, zs, zs, m4))),
            param_grads=(cuda_ms(lambda: resid_ef.param_grads(leaves, p4, rows)),
                         cuda_ms(lambda: resid_ef.param_grads_plain(leaves, p4, rows))),
        )
    print(f"QM9 TIMING per kernel (ms, kernel and plain) at B={B}, N={N}, depth {depth}: "
          + json.dumps({k: [round(a, 3), round(b, 3)] for k, (a, b) in t.items()})
          + f"; kernels of one step {t['resid_fwd_masked'][0] + t['resid_bwd_rows'][0] + t['param_grads'][0]:.2f} ms",
          flush=True)
    fma = {k: v * B * depth for k, v in layer_fma(N, F, F, 50, cfg.n_heads, 256).items()}
    inputs_fwd = (leaves, h0, xs, zs, m4)
    src = "sake_tpu_torch/csrc/"
    at = "sake_tpu/kernels/resid_ef.py:"
    return [
        kernel_entry("resid_fwd_masked", src + "resid_fwd.cu", at + "1484",
                     qm9_launches["resid_fwd"], abs_qm9["resid_fwd_masked"],
                     *t["resid_fwd_masked"], fma["fwd"], nbytes(inputs_fwd, p4)),
        kernel_entry("resid_infer", src + "resid_fwd.cu", at + "1732",
                     qm9_launches["resid_infer"], abs_qm9["resid_infer"], *t["resid_infer"],
                     fma["fwd"], nbytes(inputs_fwd, p4.h_fin, p4.x_fin)),
        kernel_entry("resid_bwd_rows", src + "resid_bwd.cu", at + "1598",
                     qm9_launches["resid_bwd_rows"], abs_qm9["resid_bwd_rows"],
                     *t["resid_bwd_rows"], fma["bwd"],
                     nbytes(leaves, leaves_t, p4.bh, p4.bx, p4.bv, p4.resid, m4, dh, zs, zs,
                            dh, zs, zs, rows)),
        kernel_entry("param_grads", src + "param_grads.cu", at + "1598",
                     qm9_launches["param_grads"], abs_qm9["param_grads"], *t["param_grads"],
                     fma["grads"], nbytes(leaves, p4.bh, p4.resid, rows, grads)),
    ]


def md17_train_phases(dev, smi) -> list:
    """Phases 8-10 (see the module docstring); returns their kernel entries."""
    import dataclasses

    import torch

    from sake_tpu_torch.data.md17 import load_md17
    from sake_tpu_torch.kernels import resid_ef
    from sake_tpu_torch.kernels import train2_ef as t2
    from sake_tpu_torch.kernels.adapter import model_params_from_linen
    from sake_tpu_torch.kernels.functional import embed, flat_params
    from sake_tpu_torch.kernels.leaves import LEAF_NAMES, transposed, wide_stack
    from sake_tpu_torch.tasks import md17 as task
    from sake_tpu_torch.train import (
        TrainState,
        make_optimizer,
        run_epoch,
        shuffle_batches,
        tree_leaves,
        warmup_cosine_schedule,
    )
    from sake_tpu_torch.train.metrics import MetricLogger

    cfg = task.MD17Config(use_kernel_ef=True, aug_mode="shared", **MD17_RUN)
    data = load_md17(cfg.molecule, None, n_samples=max(cfg.n_train + 2 * cfg.n_valid,
                                                       max(TRAIN_BATCHES)))
    species = task.species_onehot(data.z, int(data.z.max()))
    n_tr = cfg.n_train
    e_mean, e_std = float(data.e[:n_tr].mean()), float(data.e[:n_tr].std())
    N, F, depth = len(data.z), cfg.hidden_features, cfg.depth
    tdev = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
    train = {"x": tdev(data.x), "e": tdev(data.e), "f": tdev(data.f)}

    def branch(use_kernel_ef: bool):
        c = dataclasses.replace(cfg, use_kernel_ef=use_kernel_ef)
        model = task.make_model(c, species.shape[-1], device=dev,
                                generator=torch.Generator().manual_seed(c.seed))
        prm, ef_fn, _ = task.make_branch(c, model, species, e_mean, e_std)
        total = (c.n_train // c.batch_size) * c.n_epochs
        state = TrainState.create(params=prm, tx=make_optimizer(
            warmup_cosine_schedule(c.learning_rate, total)))
        return dict(params=prm, ef=ef_fn, step=task.make_step_fn(ef_fn, c.energy_loss_weight),
                    state=state)

    # -- 8. #7-#10 against their plain versions at full width -------------------
    kp = branch(True)["params"]
    Bc = TRAIN_CHECK_B
    gen = torch.Generator(dev).manual_seed(5)
    rnd = lambda *shape: torch.randn(*shape, device=dev, generator=gen)
    upd = [1.0] * depth
    with torch.no_grad():
        leaves = wide_stack(kp, cfg.n_heads)
        leaves_t = transposed(leaves)
        h0 = embed(kp, species.to(dev).expand(Bc, N, -1)).contiguous()
        xs = train["x"][:Bc].permute(2, 0, 1).contiguous()
        zs = torch.zeros_like(xs)
        tx0, dh_fin, dth_fin = rnd(3, Bc, N), rnd(Bc, N, F), rnd(Bc, N, F)
        k7 = t2.shared_fwd(leaves, h0, xs, upd)
        p7 = resid_ef.resid_fwd_plain(leaves, h0, xs, zs, upd)
        k8 = t2.shared_bwd(leaves, p7, upd, dh_fin, leaves_t=leaves_t)
        p8 = resid_ef.resid_bwd_plain(leaves, p7, upd, dh_fin, zs, zs)[1]
        k9 = t2.resid_jvp(leaves, p7, upd, tx0)
        p9 = t2.resid_jvp_plain(leaves, p7, upd, tx0)
        torch.cuda.synchronize()
        fwd_names = ("bh", "bx", "bv", "h_fin", "x_fin", "v_fin")
        checks = {
            "shared_fwd": [*zip(fwd_names, k7[:6], p7[:6]),
                           *((n, k7.resid[n], p7.resid[n]) for n in resid_ef.RESIDS)],
            "shared_bwd": [("dx", k8, p8)],
            "resid_jvp": [*zip(fwd_names, k9[:6], p9[:6]),
                          *((n, k9.resid[n], p9.resid[n]) for n in resid_ef.RESIDS)],
        }
        del k7, k9
        kt = t2.resid_tbwd(leaves, p7, p9, upd, dth_fin, zs, zs, leaves_t=leaves_t)
        pt = t2.resid_tbwd_plain(leaves, p7, p9, upd, dth_fin, zs, zs)
        torch.cuda.synchronize()
        checks["resid_tbwd"] = [*zip(("dh", "dx", "dv", "add_h", "add_x", "add_v"),
                                     [*kt[:3], *kt[3]], [*pt[:3], *pt[3]]),
                                *((n, kt[4][n], pt[4][n]) for n in resid_ef.ROWS),
                                *((f"t_{n}", kt[5][n], pt[5][n]) for n in resid_ef.ROWS)]
        del kt
        kb = t2.resid_bwd_aug(leaves, p7, upd, dh_fin, zs, zs, pt[3], leaves_t=leaves_t)
        pb = t2.resid_bwd_aug_plain(leaves, p7, upd, dh_fin, zs, zs, pt[3])
        torch.cuda.synchronize()
        checks["resid_bwd_aug"] = [*zip(("dh", "dx", "dv"), kb[:3], pb[:3]),
                                   *((n, kb[3][n], pb[3][n]) for n in resid_ef.ROWS)]
        del kb
        kg = t2.param_grads_aug(leaves, p7, p9, pb[3], pt[4], pt[5])
        pg = t2.param_grads_aug_plain(leaves, p7, p9, pb[3], pt[4], pt[5])
        torch.cuda.synchronize()
        checks["param_grads_aug"] = [(f"{n}[{l}]", kg[n][l], pg[n][l]) for n in LEAF_NAMES
                                     for l in range(depth)]
        del kg, pg, pb, pt
        ka = t2.resid_aug_bwd(leaves, p7, p9, upd, dh_fin, dth_fin, leaves_t=leaves_t)
        pa = t2.resid_aug_bwd_plain(leaves, p7, p9, upd, dh_fin, dth_fin)
        torch.cuda.synchronize()
        checks["resid_aug_bwd"] = [*zip(("dh0", "dx", "dth"), ka[:3], pa[:3]),
                                   *((f"{n}[{l}]", ka[3][n][l], pa[3][n][l])
                                     for n in LEAF_NAMES for l in range(depth))]
    abs_train = {}
    for name, pairs in checks.items():
        errs = {n: rel_err(a, b) for n, a, b in pairs}
        abs_train[name] = max(abs_err(a, b) for _, a, b in pairs)
        w = max(errs, key=errs.get)
        finite = all(bool(torch.isfinite(a).all()) for _, a, _ in pairs)
        print(f"MD17 TRAIN {name} vs plain (B={Bc}, N={N}, depth {depth}): max rel err "
              f"{errs[w]:.3e} ({w}), max abs err {abs_train[name]:.3e}, finite {finite} "
              + json.dumps({k: float(f"{v:.2e}") for k, v in errs.items()}), flush=True)
        if errs[w] > TRAIN_TOL or not finite:
            fail(f"MD17 training kernel {name} beyond {TRAIN_TOL}")
    del checks, ka, pa, p7, p8, p9

    # -- 9. step parity: kernel branch against the plain branch -----------------
    batches = shuffle_batches(np.random.RandomState(0), {k: v[:n_tr] for k, v in train.items()},
                              cfg.batch_size)
    branches = {"kernel": branch(True), "plain": branch(False)}

    def loss_and_grads(br, batch):  # the loss of tasks/md17.make_step_fn
        leaves_ = tree_leaves(br["params"])
        with torch.enable_grad():
            e, f = br["ef"](br["params"], batch["x"])
            loss = ((f - batch["f"]).abs().mean()
                    + cfg.energy_loss_weight * (e - batch["e"]).abs().mean())
            grads = torch.autograd.grad(loss, leaves_, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves_, grads)]

    with torch.no_grad():
        e_k, f_k = branches["kernel"]["ef"](branches["kernel"]["params"], batches[0]["x"])
        e_p, f_p = branches["plain"]["ef"](None, batches[0]["x"])
    ef_err = {"f_err": rel_err(f_k, f_p), "e_err": rel_err((e_k - e_mean) / e_std,
                                                           (e_p - e_mean) / e_std)}
    print(f"MD17 TRAIN primal (#7 + #8) E and F vs the functional path at B={cfg.batch_size}: "
          + json.dumps({k: float(f"{v:.3e}") for k, v in ef_err.items()}), flush=True)
    if not (ef_err["f_err"] <= F_TOL and ef_err["e_err"] <= E_TOL):
        fail(f"MD17 training primal beyond f_err {F_TOL} / e_err {E_TOL}")
    lk, gk = loss_and_grads(branches["kernel"], batches[0])
    lp, gp_ = loss_and_grads(branches["plain"], batches[0])
    tree = {}  # the plain branch's gradients by linen name
    for name, g in zip(sorted(branches["plain"]["params"]), gp_):  # tree_leaves order
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = g
    want = flat_params(model_params_from_linen(tree, dev))
    grad_err = [rel_err(a, b) for a, b in zip(gk, want)]
    loss_err = abs(float(lk - lp)) / abs(float(lp))
    print(f"MD17 STEP 1 kernel vs plain branch: loss {float(lk):.7f} vs {float(lp):.7f} "
          f"(rel {loss_err:.2e}); gradients of {len(gk)} leaves, max rel err "
          f"{max(grad_err):.3e} (leaf {int(np.argmax(grad_err))})", flush=True)
    if loss_err > TRAIN_TOL or max(grad_err) > TRAIN_TOL or len(gk) != len(want):
        fail(f"MD17 step 1 beyond {TRAIN_TOL}")
    traj = {}
    for name, br in branches.items():
        traj[name] = []
        for b_ in batches[:PARITY_STEPS]:
            br["state"], loss = br["step"](br["state"], b_)
            traj[name].append(float(loss))
    traj_err = max(abs(a - b) / abs(b) for a, b in zip(traj["kernel"], traj["plain"]))
    print(f"MD17 STEPS 1-{PARITY_STEPS} losses kernel {json.dumps(traj['kernel'])} plain "
          f"{json.dumps(traj['plain'])}: max rel diff {traj_err:.2e}", flush=True)
    if traj_err > LOSS_TOL:
        fail(f"MD17 step losses differ beyond {LOSS_TOL}")

    # -- 10. the slice through tasks/md17.run, then timing ----------------------
    counters = (t2.shared_fwd, t2.shared_bwd, t2.resid_jvp, t2.resid_tbwd, t2.resid_bwd_aug,
                t2.param_grads_aug)
    step_losses = []

    def recording_epoch(step_fn, state, batches_):
        state, losses = run_epoch(step_fn, state, batches_)
        step_losses.append(losses)
        return state, losses

    task.run_epoch = recording_epoch  # keeps every step's loss of the run
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, results = task.run(cfg, MetricLogger(stream=sys.stdout), device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    task.run_epoch = run_epoch
    launches = {c.__name__: c.launches for c in counters}
    losses = torch.cat(step_losses).cpu()
    print(f"MD17 SLICE launches {json.dumps(launches)}; {len(losses)} steps in {wall:.2f} s with "
          f"the evaluation; loss first {float(losses[0]):.6f} last {float(losses[-1]):.6f} "
          f"(means of the first and last 20 steps {float(losses[:20].mean()):.6f} "
          f"{float(losses[-20:].mean()):.6f}); E MAE {results['e_mae_kcalmol']:.4f} kcal/mol "
          f"(CI {[float(v) for v in results['e_mae_ci']]}), F MAE "
          f"{results['f_mae_kcalmol']:.4f} kcal/mol (CI {[float(v) for v in results['f_mae_ci']]})",
          flush=True)
    if min(launches.values()) == 0:
        fail("the MD17 training path did not launch every kernel")
    if not (torch.isfinite(losses).all() and losses[-20:].mean() < losses[:20].mean()):
        fail("the MD17 training loss is not finite or did not fall")
    if not all(np.isfinite(results[k]) for k in ("e_mae_kcalmol", "f_mae_kcalmol")):
        fail("non-finite MD17 evaluation")

    entries = {}
    for B in TRAIN_BATCHES:
        batch = {k: v[:B] for k, v in train.items()}
        runs = {"plain": [], "kernel": []}
        steps = 5 if B < 64 else 2
        for side in ("plain", "kernel", "kernel", "plain", "plain", "kernel"):
            br = branches[side]
            br["step"](br["state"], batch)  # warm up this side's shapes
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                br["state"], _ = br["step"](br["state"], batch)
            torch.cuda.synchronize()
            runs[side].append((time.perf_counter() - t0) * 1e3 / steps)
        step_ms = {k: sum(v) / len(v) for k, v in runs.items()}
        print(f"MD17 TIMING train step at B={B}: kernel {step_ms['kernel']:.2f} ms = "
              f"{B * 1e3 / step_ms['kernel']:.1f} samples/s; plain {step_ms['plain']:.2f} ms = "
              f"{B * 1e3 / step_ms['plain']:.1f} samples/s (ms per step, runs {json.dumps(runs)}; "
              f"{smi})", flush=True)

        # the kernel branch's step in parts, and each kernel beside its plain version
        br = branches["kernel"]
        prm = br["params"]
        with torch.no_grad():
            leaves = wide_stack(prm, cfg.n_heads)
            leaves_t = transposed(leaves)
            h0 = embed(prm, species.to(dev).expand(B, N, -1)).contiguous()
            xs = batch["x"].permute(2, 0, 1).contiguous()
            zs = torch.zeros_like(xs)
            fwd = t2.shared_fwd(leaves, h0, xs, upd)
            _, dh_fin = resid_ef._readout_seed(prm, fwd.h_fin, None)
            tx0 = rnd(3, B, N)
            tfwd = t2.resid_jvp(leaves, fwd, upd, tx0)
            _, dh_s, dth_s = t2.head_grads(prm, fwd.h_fin, tfwd.h_fin, rnd(B))
            tb = t2.resid_tbwd(leaves, fwd, tfwd, upd, dth_s, zs, zs, leaves_t=leaves_t)
            ba = t2.resid_bwd_aug(leaves, fwd, upd, dh_s, zs, zs, tb[3], leaves_t=leaves_t)
            grads = t2.param_grads_aug(leaves, fwd, tfwd, ba[3], tb[4], tb[5])
            plain_reps = 3 if B < 64 else 1
            t = dict(
                shared_fwd=(cuda_ms(lambda: t2.shared_fwd(leaves, h0, xs, upd)),
                            cuda_ms(lambda: resid_ef.resid_fwd_plain(leaves, h0, xs, zs, upd),
                                    reps=plain_reps)),
                shared_bwd=(cuda_ms(lambda: t2.shared_bwd(leaves, fwd, upd, dh_fin,
                                                          leaves_t=leaves_t)),
                            cuda_ms(lambda: resid_ef.resid_bwd_plain(leaves, fwd, upd, dh_fin,
                                                                     zs, zs), reps=plain_reps)),
                resid_jvp=(cuda_ms(lambda: t2.resid_jvp(leaves, fwd, upd, tx0)),
                           cuda_ms(lambda: t2.resid_jvp_plain(leaves, fwd, upd, tx0),
                                   reps=plain_reps)),
                resid_tbwd=(cuda_ms(lambda: t2.resid_tbwd(leaves, fwd, tfwd, upd, dth_s, zs, zs,
                                                          leaves_t=leaves_t)),
                            cuda_ms(lambda: t2.resid_tbwd_plain(leaves, fwd, tfwd, upd, dth_s,
                                                                zs, zs), reps=plain_reps)),
                resid_bwd_aug=(cuda_ms(lambda: t2.resid_bwd_aug(leaves, fwd, upd, dh_s, zs, zs,
                                                                tb[3], leaves_t=leaves_t)),
                               cuda_ms(lambda: t2.resid_bwd_aug_plain(leaves, fwd, upd, dh_s, zs,
                                                                      zs, tb[3]),
                                       reps=plain_reps)),
                param_grads_aug=(cuda_ms(lambda: t2.param_grads_aug(leaves, fwd, tfwd, ba[3],
                                                                    tb[4], tb[5])),
                                 cuda_ms(lambda: t2.param_grads_aug_plain(
                                     leaves, fwd, tfwd, ba[3], tb[4], tb[5]), reps=plain_reps)),
            )
            t_seed = cuda_ms(lambda: resid_ef._readout_seed(prm, fwd.h_fin, None))
            t_head = cuda_ms(lambda: t2.head_grads(prm, fwd.h_fin, tfwd.h_fin, rnd(B)))
        zero_grads = [torch.zeros_like(p) for p in tree_leaves(prm)]
        t_opt = cuda_ms(lambda: br["state"].apply_gradients(zero_grads))
        primal = t["shared_fwd"][0] + t_seed + t["shared_bwd"][0]
        parts = dict(primal=primal, tangent_forward=t["resid_jvp"][0],
                     aug_pullback=t["resid_tbwd"][0] + t["resid_bwd_aug"][0],
                     contraction=t["param_grads_aug"][0], head=t_head, optimizer=t_opt)
        rest = step_ms["kernel"] - sum(parts.values())
        print(f"MD17 BREAKDOWN kernel-branch step at B={B}, {step_ms['kernel']:.3f} ms: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
              + f", rest {rest:.3f} ms ({len(zero_grads)} parameter tensors)", flush=True)
        print(f"MD17 TIMING per kernel (ms, kernel and plain) at B={B}, N={N}, depth {depth}: "
              + json.dumps({k: [round(a, 3), round(b, 3)] for k, (a, b) in t.items()}),
              flush=True)
        fma = {k: v * B * depth for k, v in layer_fma(N, F, F, 50, cfg.n_heads, 256).items()}
        moved = dict(
            shared_fwd=nbytes(leaves, h0, xs, fwd),
            shared_bwd=nbytes(leaves, leaves_t, fwd.bh, fwd.bx, fwd.bv, fwd.resid, dh_fin, xs),
            resid_jvp=nbytes(leaves, fwd.bh, fwd.bx, fwd.bv, fwd.resid, tx0, tfwd),
            resid_tbwd=nbytes(leaves, leaves_t, fwd.bh, fwd.bx, fwd.bv, fwd.resid, tfwd.bh,
                              tfwd.bx, tfwd.bv, tfwd.resid, dth_s, tb),
            resid_bwd_aug=nbytes(leaves, leaves_t, fwd.bh, fwd.bx, fwd.bv, fwd.resid, dh_s,
                                 tb[3], ba),
            param_grads_aug=nbytes(leaves, fwd.bh, tfwd.bh, fwd.resid, tfwd.resid, ba[3], tb[4],
                                   tb[5], grads),
        )
        ops = dict(shared_fwd=fma["fwd"], shared_bwd=fma["bwd"], resid_jvp=fma["jvp"],
                   resid_tbwd=fma["tbwd"], resid_bwd_aug=fma["bwd"],
                   param_grads_aug=fma["grads_aug"])
        print(f"MD17 BOUNDS at B={B} (ms, by): " + json.dumps(
            {k: [round(bound(ops[k], moved[k])[0], 4), bound(ops[k], moved[k])[1]] for k in t}),
            flush=True)
        entries[B] = (t, ops, moved)
        del fwd, tfwd, tb, ba, grads

    t, ops, moved = entries[max(TRAIN_BATCHES)]  # the entries carry B = 512
    src = "sake_tpu_torch/csrc/"
    at = "sake_tpu/kernels/train2_ef.py:"
    where = dict(shared_fwd=("resid_fwd.cu", "1030"), shared_bwd=("resid_bwd.cu", "1110"),
                 resid_jvp=("resid_jvp.cu", "1397"), resid_tbwd=("resid_tbwd.cu", "1507"),
                 resid_bwd_aug=("resid_bwd.cu", "1507"), param_grads_aug=("param_grads.cu", "1507"))
    return [kernel_entry(name, src + where[name][0], at + where[name][1], launches[name],
                         abs_train[name], *t[name], ops[name], moved[name]) for name in t]

if __name__ == "__main__":
    sys.exit(main())
