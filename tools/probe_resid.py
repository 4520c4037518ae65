"""Where the block time of #4 and #5's rows kernel goes at QM9's shapes, on one
NVIDIA GPU: the one-block kernels and the cluster kernels (one molecule per
two-CTA cluster), a clock64() probe per phase and product site.

    python3 tools/probe_resid.py                      # check, probe, times
    python3 tools/probe_resid.py --phases check probe  # no timing
    python3 tools/probe_resid.py --reps 5             # more timing rounds
    python3 tools/probe_resid.py --phases sweep --batches 64 96 128 192 256

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
KERNELS = ("resid_fwd_kernelILb1E", "resid_bwd_kernelILb1E", "resid_fwd_cl_kernel",
           "resid_bwd_cl_kernel")
# the builds beside the library: (name, sources, defines)
VARIANTS = (("probe", SOURCES, ("SAKE_PROBE",)),)


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
    """The cluster kernels of #4 and #5 (``cluster=True``, ``make_hidden_fn``'s
    route) against their plain versions on ``inputs`` (:func:`qm9_inputs` when
    None): ``{check: {tensor: max |kernel - plain| / max |plain|}}``, and
    whether a second launch of each gave the first's outputs bit for bit
    (``"bitwise"``). Raises if the wrappers took the one-block route."""
    import torch

    from sake_tpu_torch.kernels import resid_ef

    leaves, leaves_t, h0, xs, zs, m4, dh, upd = inputs or qm9_inputs(dev)
    rel = lambda a, b: float((a - b).abs().max() / (b.abs().max() + 1e-30))
    n4, n5 = resid_ef.resid_fwd.cluster_launches, resid_ef.resid_bwd_rows.cluster_launches
    with torch.no_grad():
        k4 = [resid_ef.resid_fwd(leaves, h0, xs, zs, upd, m4, cluster=True) for _ in range(2)]
        p4 = resid_ef.resid_fwd_plain(leaves, h0, xs, zs, upd, mask=m4)
        k5 = [resid_ef.resid_bwd_rows(leaves, p4, upd, dh, zs, zs, m4, leaves_t=leaves_t,
                                      cluster=True) for _ in range(2)]
        p5 = resid_ef.resid_bwd_rows_plain(leaves, p4, upd, dh, zs, zs, mask=m4)
        torch.cuda.synchronize()
    if (resid_ef.resid_fwd.cluster_launches - n4, resid_ef.resid_bwd_rows.cluster_launches - n5) \
            != (2, 2):
        raise RuntimeError("the cluster route was not taken")
    names = ("bh", "bx", "bv", "h_fin", "x_fin", "v_fin")
    fwd_t = lambda o: [*zip(names, o[:6]), *((n, o.resid[n]) for n in resid_ef.RESIDS)]
    bwd_t = lambda o: [*zip(("dh", "dx", "dv"), o[:3]), *((n, o[3][n]) for n in resid_ef.ROWS)]
    same = lambda a, b: all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))
    return {
        "resid_fwd_cluster": {n: rel(a, b) for (n, a), (_, b) in zip(fwd_t(k4[0]), fwd_t(p4))},
        "resid_bwd_rows_cluster": {n: rel(a, b)
                                   for (n, a), (_, b) in zip(bwd_t(k5[0]), bwd_t(p5))},
        "bitwise": {"resid_fwd_cluster": same(fwd_t(k4[0]), fwd_t(k4[1])),
                    "resid_bwd_rows_cluster": same(bwd_t(k5[0]), bwd_t(k5[1]))},
    }


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
