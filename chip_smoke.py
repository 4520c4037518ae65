"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own line; any failure exits non-zero):

1. device: requires CUDA (no CPU fallback); prints the card's name and
   power limit as nvidia-smi reports them.
2. build: compiles the K1/K2 CUDA sources of ``sake_tpu_torch/csrc`` with
   nvcc and prints the build time.
3. kernels vs plain: at full width (hidden 64, C 256, R 50, 4 heads),
   aspirin's N = 21 and B = 37, K1 against ``resid_fwd_plain`` (boundary
   states and all 17 residuals) and K2 against ``resid_bwd_plain``
   (dh, dx, dv); max relative error = max|kernel - plain| / max|plain| per
   tensor, limit 1e-4. TF32 is off for matmuls and cuDNN.
4. slice: ``SAKEModel(64, depth=6, n_heads=4)`` from a seeded init serves
   aspirin E + F requests of B in {1, 37, 512, 2048} through
   ``tasks/md17.make_energy_force_fn`` -> dispatch -> K1 + K2, checked
   against the plain f32 autograd path (chunks of 256):
   ``f_err = max|dF| / max|F|`` <= 1e-4 and ``e_err = max|dE| / max|E|``
   on raw (uncolored) energies <= 1e-5. The launch counters must move, and
   an edge mask on CUDA tensors must raise ``NotImplementedError``.
   Then both paths are timed at B = 2048 in chunks of 512 with CUDA events,
   in turns, and the kernel path's time is split into K1 + K2 and the rest.

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
FULL = dict(hidden=64, depth=6, heads=4)
REQUESTS = (1, 37, 512, 2048)
SEED = 0
CHECK_CHUNK = 256  # molecules per autograd pass of the plain reference in the checks
PATH_CHUNK = 512  # resid_energy_forces' chunk; the plain path is timed at it too


def fail(msg: str):
    print(f"FAIL {msg}", flush=True)
    sys.exit(1)


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / (want.abs().max() + 1e-30))


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
    from sake_tpu_torch.kernels.dispatch import dispatch_energy_forces
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
        if "registers" in line or "spill" in line:
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

    # -- 3. kernels vs plain at full width, B = 37 ------------------------------
    rng = np.random.RandomState(SEED + 1)
    Bk = 37
    tdev = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
    x37 = tdev(data.x[:Bk].transpose(2, 0, 1))
    h37 = embed(params, species.to(dev).expand(Bk, N, -1)).contiguous()
    v37 = tdev(0.1 * rng.randn(3, Bk, N))
    upd = [1.0, 0.3, 0.0, 1.0, 1.0, 1.0]  # exercises the gate at 0 < upd < 1
    with torch.no_grad():
        k1 = resid_ef.resid_fwd(leaves, h37, x37, v37, upd)
        p1 = resid_ef.resid_fwd_plain(leaves, h37, x37, v37, upd)
        torch.cuda.synchronize()
        k1_err = {n: rel_err(a, b) for n, a, b in zip(
            ("bh", "bx", "bv", "h_fin", "x_fin", "v_fin"), k1[:6], p1[:6])}
        k1_err.update({n: rel_err(k1.resid[n], p1.resid[n]) for n in resid_ef.RESIDS})
        k1_abs = max(float((a - b).abs().max()) for a, b in
                     [*zip(k1[:6], p1[:6]), *((k1.resid[n], p1.resid[n]) for n in resid_ef.RESIDS)])
        seeds = (tdev(rng.randn(Bk, N, FULL["hidden"])), tdev(rng.randn(3, Bk, N)),
                 tdev(rng.randn(3, Bk, N)))
        k2 = resid_ef.resid_bwd(leaves, p1, upd, *seeds)
        p2 = resid_ef.resid_bwd_plain(leaves, p1, upd, *seeds)
        torch.cuda.synchronize()
    k2_err = {n: rel_err(a, b) for n, a, b in zip(("dh", "dx", "dv"), k2, p2)}
    k2_abs = max(float((a - b).abs().max()) for a, b in zip(k2, p2))
    worst1, worst2 = max(k1_err, key=k1_err.get), max(k2_err, key=k2_err.get)
    print(f"K1 vs plain (B={Bk}, N={N}, depth 6): max rel err {k1_err[worst1]:.3e} ({worst1}), "
          f"max abs err {k1_abs:.3e}", flush=True)
    print("K1 per tensor " + json.dumps({k: float(f"{v:.3e}") for k, v in k1_err.items()}),
          flush=True)
    print(f"K2 vs plain: max rel err {k2_err[worst2]:.3e} ({worst2}), max abs err {k2_abs:.3e} "
          + json.dumps({k: float(f"{v:.3e}") for k, v in k2_err.items()}), flush=True)
    if not (k1_err[worst1] <= K1_TOL and k2_err[worst2] <= K2_TOL):
        fail(f"kernel vs plain beyond {K1_TOL}")

    # -- 4. the slice: serve aspirin E + F through K1 + K2 -----------------------
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
    # an edge mask on CUDA tensors raises: no silent plain path
    try:
        dispatch_energy_forces(params, species.to(dev).expand(2, N, -1), xs_all[:2],
                               torch.ones(2, N, N, device=dev))
    except NotImplementedError as exc:
        print(f"MASK a CUDA edge mask raises NotImplementedError ({exc})", flush=True)
    else:
        fail("a CUDA edge mask did not raise NotImplementedError")

    resid_ef.resid_fwd.launches = 0
    resid_ef.resid_bwd.launches = 0
    answers = {B: serve(xs_all[:B]) for B in REQUESTS}
    torch.cuda.synchronize()
    launches = {"resid_fwd": resid_ef.resid_fwd.launches,
                "resid_bwd": resid_ef.resid_bwd.launches}
    print(f"SLICE launches {json.dumps(launches)}", flush=True)
    if min(launches.values()) == 0:
        fail("the main path did not launch every kernel")
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

    kernels = [
        dict(name="resid_fwd", route="cuda", source="sake_tpu_torch/csrc/resid_fwd.cu",
             replaces="sake_tpu/kernels/resid_ef.py:1099", launches=launches["resid_fwd"],
             max_abs_err=k1_abs, ms=t_k1, plain_ms=t_p1),
        dict(name="resid_bwd", route="cuda", source="sake_tpu_torch/csrc/resid_bwd.cu",
             replaces="sake_tpu/kernels/resid_ef.py:1211", launches=launches["resid_bwd"],
             max_abs_err=k2_abs, ms=t_k2, plain_ms=t_p2),
    ]
    print("SLICE " + json.dumps({"evals_per_s_kernel": 2048e3 / ms_kernel,
                                 "evals_per_s_plain": 2048e3 / ms_plain, **worst}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
