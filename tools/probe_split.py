"""Where the block time of the split kernels #25-#28 goes, on both of their
routes, at MD17 aspirin's shapes on one NVIDIA GPU.

    python3 tools/probe_split.py
    python3 tools/probe_split.py --check     # the forwards and pullbacks against plain alone
    python3 tools/probe_split.py --d-b-sem   # #28's d_b_sem against float64 (d_b_sem)

Builds ``csrc/split_fwd.cu`` and ``csrc/split_bwd.cu`` four ways at once: plain,
with ``-DSAKE_PROBE`` (``csrc/probe.cuh``), and both again with
``-DSAKE_SPLIT_CUDA_CORES``, which keeps every forward and pullback on its
CUDA-core kernel, so that both routes run at the same shape. It prints ptxas's
registers, shared memory and spills of the split kernels, then at aspirin B =
2048 (layer 0 of chip_smoke.py phase 22's seeded model on ``synthesize_md17``
data) launches each forward and each pullback (edge_att, coeff_pool, merged;
the pullbacks without weight cotangents, as the E + F path) once on each probe
build and prints each slot's share of the block cycles: loads and geometry, the edge products o_f and o1, the
x-mixing product (and its transpose), their epilogues (the head expansion he_att,
d_u, d_xm, d_h_e, d_att), the rest of the rows (the forward's filtered), thread
0's waits at the block barriers (thread 0 reads the SM clock before and after
each barrier; the slots sum over every block of the launch), the semantic
attention (sem, the softmax and their pullbacks), the pullback's edge products
(d_e0, d_filtered and their sums), thread 0's waits for the x-mixing's ring
(the forwards' route) and the forwards' epilogue (hatt_sum, pooled, the stores of
h_e and att). Each launch's time (CUDA events) on every build follows, so the
probe's own cost shows. The card's name and power limit come first.

It also holds what ``chip_smoke.py``, ``tools/tc_ab.py``, ``tools/cuda_emu/
emulate.py`` and ``tests/test_torch_split_tc.py`` share: layer 0's arguments of
the three ops (``layer0_args``), seeded models at other widths and atom counts
(``model_args``), the aspirin model and inputs (``aspirin_model``,
``aspirin_args``), seeded cotangents
(``cotangents``), the forwards against the plain bodies (``check_forwards``: two
launches bit for bit, the route each took) and the pullbacks against
``split_ef.vjp_plain`` (``check_pullbacks``: each op with and without weight
cotangents, two launches bit for bit, the route each took).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("split_fwd.cu", "split_bwd.cu")
SLOTS = ("spl_load", "spl_mm", "spl_xmix", "spl_epi", "spl_row", "spl_bar", "spl_sem",
         "spl_mm_b", "spl_ring", "spl_pool")  # PR_SPL_*
SLOT0 = 52  # PR_SPL_LOAD
N_SLOTS = 62  # kProbeSlots
KINDS = ("edge_att", "coeff_pool", "merged")
SPLIT_TOL = 1e-4  # the kernels against plain, max relative error per tensor
# check_forwards's and check_pullbacks's cases on the card: (label, hidden, B, N).
# Aspirin's widths take the tensor-core route: 21 atoms (three rows a tile), 22
# (two), 17 (a last group of two rows); the narrow models take the CUDA cores.
CARD_CASES = (("hidden 64, N=21", 64, 37, 21), ("hidden 64, N=22 (g=2)", 64, 37, 22),
              ("hidden 64, N=17 (last group 2 rows)", 64, 37, 17),
              ("hidden 8, N=7", 8, 4, 7), ("hidden 16, N=7", 16, 4, 7))


def layer0_args(params, h, x, n_heads: int) -> dict:
    """Layer 0's arguments of the three split ops, as the entry points build
    them (embedded species, the node projections in torch; the coeff_pool op's
    h_e and att from the plain edge_att body)."""
    import torch

    from sake_tpu_torch.kernels import split_ef as se
    from sake_tpu_torch.kernels.functional import embed

    F = params.w_embed.shape[-1]
    lp = params.layers[0]
    e = lp.edge
    R = e.w_in.shape[-1]
    with torch.no_grad():
        hc = embed(params, h)
        xp = [x[..., k : k + 1].contiguous() for k in range(3)]
        halves = [(hc @ e.w_in[:F]).contiguous(), (hc @ e.w_in[F:] + e.b_in).contiguous(),
                  (hc @ e.w_out0[:F]).contiguous(), (hc @ e.w_out0[F : 2 * F]).contiguous()]
        w = [t.detach().contiguous() for t in se.edge_weights(lp, F, R)]
        he, att = se.edge_att_body(*xp, *halves, *w)
    wx = lp.w_xmix.detach().contiguous()
    return {"edge_att": (*xp, *halves, *w), "coeff_pool": (*xp, he, att, wx),
            "merged": (*xp, *halves, *w, wx)}


def model_args(dev, hid: int, B: int, N: int, seed: int = 0) -> dict:
    """:func:`layer0_args` of a seeded ``SAKEModel(hid, depth=2, n_heads=4)``
    (50 rbf channels; C = 256 at hidden 64, else 4 * hid) on random species
    features (5) and positions of B molecules of N atoms."""
    import torch

    from sake_tpu_torch.kernels.adapter import linen_tree, model_params_from_linen
    from sake_tpu_torch.models import SAKEModel

    m = SAKEModel(hid, 1, 2, in_features=5, device=dev,
                  generator=torch.Generator().manual_seed(seed))
    params = model_params_from_linen(linen_tree(m), device=dev)
    gen = torch.Generator(dev).manual_seed(seed)
    h = torch.randn(B, N, 5, device=dev, generator=gen)
    x = 1.5 * torch.randn(B, N, 3, device=dev, generator=gen)
    return layer0_args(params, h, x, 4)


def aspirin_model(dev, B: int = 2048):
    """``(params, h, x)`` of chip_smoke.py phase 22: its seeded model
    (``MD17Config`` at hidden 64, depth 6, 4 heads), the one-hot species and the
    positions of the first B molecules of ``synthesize_md17``."""
    import torch

    from sake_tpu_torch.data.md17 import synthesize_md17
    from sake_tpu_torch.tasks.md17 import MD17Config, make_model, species_onehot

    data = synthesize_md17(n_samples=B, seed=0)
    species = species_onehot(data.z, int(data.z.max())).to(dev)
    cfg = MD17Config(hidden_features=64, depth=6, n_heads=4)
    model = make_model(cfg, species.shape[-1], device=dev,
                       generator=torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    x = torch.as_tensor(data.x, device=dev)
    return model.functional_params(), species.expand(B, *species.shape), x


def aspirin_args(dev, B: int = 2048) -> dict:
    """:func:`layer0_args` at chip_smoke.py phase 22's per-kernel input
    (:func:`aspirin_model`)."""
    params, h, x = aspirin_model(dev, B)
    return layer0_args(params, h, x, 4)


def cotangents(args: dict, seed: int) -> dict:
    """Seeded cotangents of each op's outputs (the plain bodies' shapes)."""
    import torch

    from sake_tpu_torch.kernels import split_ef as se

    dev = args["merged"][0].device
    gen = torch.Generator(dev).manual_seed(seed)
    with torch.no_grad():
        outs = {k: se.BODIES[k](*a) for k, a in args.items()}
    return {k: [torch.randn(o.shape, device=dev, generator=gen) for o in v]
            for k, v in outs.items()}


def _rel(a, b) -> float:
    return float((a - b).abs().max() / (b.abs().max() + 1e-30))


def check_forwards(dev, cases=CARD_CASES, launch=None, route=None) -> dict:
    """Each op's forward against its plain body (``split_ef.BODIES``) in every
    case ``(label, hidden, B, N)``: every output; the launch twice, bit for bit.
    ``{(label, kind): (max relative error, route, bitwise)}``. ``launch(kind,
    args)``: the forward (``split_ef.FWD[kind]`` when None); ``route(kind,
    args)``: the route it takes (``split_ef``'s rule when None)."""
    import torch

    from sake_tpu_torch.kernels import split_ef as se

    launch = launch or (lambda kind, a: se.FWD[kind](*a))
    route = route or (lambda kind, a: se._route(kind, a, False))
    out = {}
    for label, hid, B, N in cases:
        args = model_args(dev, hid, B, N, seed=hid + N)
        for kind in KINDS:
            a = args[kind]
            with torch.no_grad():
                k1, k2, p = launch(kind, a), launch(kind, a), se.BODIES[kind](*a)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            errs = [_rel(x, y) for x, y in zip(k1, p)]
            finite = all(bool(torch.isfinite(t).all()) for t in k1)
            bitwise = all(torch.equal(x, y) for x, y in zip(k1, k2))
            out[(label, kind)] = (max(errs) if finite else float("inf"), route(kind, a), bitwise)
    return out


def check_pullbacks(dev, cases=CARD_CASES, launch=None, route=None) -> dict:
    """Each op's pullback against ``vjp_plain`` in every case ``(label, hidden,
    B, N)``: every batched cotangent with and without the weight cotangents, and
    every weight cotangent; the launch twice, bit for bit. ``{(label, kind):
    (max relative error, route, bitwise)}``. ``launch(kind, args, cots,
    weights)``: the pullback (``split_ef.BWD[kind]`` when None); ``route(kind,
    args)``: the route it takes (``split_ef``'s rule when None)."""
    import torch

    from sake_tpu_torch.kernels import split_ef as se

    launch = launch or (lambda kind, a, c, w: se.BWD[kind](a, c, w))
    route = route or (lambda kind, a: se._route(kind, a, True))
    out = {}
    for label, hid, B, N in cases:
        args = model_args(dev, hid, B, N, seed=hid + N)
        cots = cotangents(args, seed=N)
        for kind in KINDS:
            a, c = args[kind], cots[kind]
            kb, kw = launch(kind, a, c, True)
            kb2, kw2 = launch(kind, a, c, True)
            kb0, _ = launch(kind, a, c, False)
            pb, pw = se.vjp_plain(kind, a, c, True)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            errs = [_rel(x, y) for x, y in zip([*kb, *kw, *kb0], [*pb, *pw, *pb])]
            finite = all(bool(torch.isfinite(t).all()) for t in (*kb, *kw, *kb0))
            bitwise = all(torch.equal(x, y) for x, y in zip([*kb, *kw], [*kb2, *kw2]))
            out[(label, kind)] = (max(errs) if finite else float("inf"), route(kind, a), bitwise)
    return out


def _ptxas(path) -> list:
    lines, keep = [], False
    for line in (path.parent / "ptxas.txt").read_text().splitlines():
        if "Compiling entry function" in line:
            keep = any(k in line for k in ("split_tc_kernel", "split_tc_fwd_kernel",
                                           "split_kernel"))
        if keep and ("Compiling" in line or "Used" in line or "spill" in line):
            lines.append(line.strip())
    return lines


def build_all() -> dict:
    """``{"plain": path, "probe": path, "cc": path, "probe_cc": path}``: the split
    sources without the probe and with it, both routes and the CUDA-core route
    alone; built in parallel."""
    from sake_tpu_torch.kernels import build

    jobs = {"plain": (SOURCES, ()), "probe": (SOURCES, ("SAKE_PROBE",)),
            "cc": (SOURCES, ("SAKE_SPLIT_CUDA_CORES",)),
            "probe_cc": (SOURCES, ("SAKE_PROBE", "SAKE_SPLIT_CUDA_CORES"))}
    paths, errs = {}, []

    def one(k):
        try:
            paths[k] = build.build(*jobs[k])
        except Exception as e:  # reported below, with every other build's
            errs.append(f"{k}: {e}")

    ts = [threading.Thread(target=one, args=(k,)) for k in jobs]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        raise RuntimeError("\n".join(errs))
    return paths


def load(path):
    from sake_tpu_torch.kernels import build

    lib = ctypes.CDLL(str(path))
    names = [n for n in build.signatures() if n.startswith("sake_split") and hasattr(lib, n)]
    lib = build.declare(lib, names)
    lib.sake_error_string = lambda err: b"see cudaGetErrorString"  # not in these sources
    return lib


def cuda_ms(fn, reps: int = 3) -> float:
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


def _slots(lib, pull: bool, run) -> tuple:
    """``(block cycles, {slot: share})`` of one ``run()`` on a probe build, after
    a warm-up."""
    import torch

    read = lib.sake_split_bwd_probe if pull else lib.sake_split_fwd_probe
    ticks = (ctypes.c_ulonglong * N_SLOTS)()
    run()
    torch.cuda.synchronize()
    read(ticks, 1)  # reset after the warm-up
    run()
    torch.cuda.synchronize()
    read(ticks, 1)
    sl = list(ticks)[SLOT0:SLOT0 + len(SLOTS)]
    total = sum(sl)
    return total, {s: round(t / max(total, 1), 4) for s, t in zip(SLOTS, sl)}


def probe(dev, B: int = 2048) -> dict:
    """Each forward's and pullback's slot shares and ms on both routes at
    aspirin B; returns ``{(name, route): {"ms": ..., "probe_ms": ..., "cycles":
    ..., "shares": {...}}}``."""
    import torch

    from sake_tpu_torch.kernels import build
    from sake_tpu_torch.kernels import split_ef as se

    paths = build_all()
    for line in _ptxas(paths["plain"]):
        print(f"PROBE_SPLIT ptxas {line}", flush=True)
    args = aspirin_args(dev, B)
    cots = cotangents(args, seed=22)
    libs = {k: load(p) for k, p in paths.items()}
    out = {}
    runs = {}
    for kind in KINDS:
        a = args[kind]
        runs[f"{kind}_fwd"] = (False, lambda kind=kind, a=a: se.FWD[kind](*a))
        runs[f"{kind}_bwd"] = (True, lambda kind=kind, a=a: se.BWD[kind](a, cots[kind]))
    saved = build._lib
    try:
        for k, plain in (("probe", "plain"), ("probe_cc", "cc")):
            for name, (pull, run) in runs.items():
                build._lib = libs[k]
                kind = name.rsplit("_", 1)[0]
                label = se._route(kind, args[kind], pull)
                with torch.no_grad():
                    total, shares = _slots(libs[k], pull, run)
                    probe_ms = cuda_ms(run)
                    build._lib = libs[plain]
                    ms = cuda_ms(run)
                out[(name, label)] = dict(ms=ms, probe_ms=probe_ms, cycles=total, shares=shares)
                print(f"PROBE_SPLIT {name} B={B} {label}: ms {ms:.3f} (probe build "
                      f"{probe_ms:.3f}), block cycles {total:.4e}, shares {json.dumps(shares)}",
                      flush=True)
    finally:
        build._lib = saved
    return out


def check_on_card(dev) -> bool:
    """:func:`check_forwards` and :func:`check_pullbacks` at ``CARD_CASES`` on
    ``csrc/split_fwd.cu``, ``csrc/split_bwd.cu`` and ``csrc/sparse_contract.cu``
    built by themselves: each within ``SPLIT_TOL``, bit for bit twice, on the
    route its widths take (the tensor cores at hidden 64). Prints a line a case
    and kernel."""
    from sake_tpu_torch.kernels import build

    lib = ctypes.CDLL(str(build.build((*SOURCES, "sparse_contract.cu"))))
    names = [n for n in build.signatures()
             if (n.startswith("sake_split") or n == "sake_sparse_contract") and hasattr(lib, n)]
    lib = build.declare(lib, names)
    lib.sake_error_string = lambda err: b"see cudaGetErrorString"  # not in these sources
    saved, build._lib = build._lib, lib
    try:
        res = {"fwd": check_forwards(dev), "bwd": check_pullbacks(dev)}
    finally:
        build._lib = saved
    ok = True
    for d, r in res.items():
        for (label, kind), (err, route, bitwise) in r.items():
            want = "tensor cores" if label.startswith("hidden 64") else "CUDA cores"
            good = err <= SPLIT_TOL and bitwise and route == want
            ok &= good
            print(f"PROBE_SPLIT CHECK {kind}_{d} {label}: max rel err {err:.3e}, route {route}, "
                  f"two launches bitwise {bitwise}: {'ok' if good else 'FAILED'}", flush=True)
    return ok


def d_b_sem(dev, B: int = 300, seed: int = 21) -> dict:
    """#28's d_b_sem (the merged pullback with weight cotangents) and the plain
    f32 version's (``split_ef.vjp_plain``) against the plain version in float64,
    at chip_smoke.py phase 21's input: layer 0 of :func:`aspirin_model` at its
    first B of 2048 molecules, the cotangents of seed ``seed``
    (:func:`cotangents`). d_b_sem sums d_sem over every edge, and that sum
    cancels, so it is the one pullback output near its gate there. Returns
    ``{"kernel": e, "plain_f32": e, "kernel_vs_plain_f32": e}``, max relative
    errors, and prints them."""
    import torch

    from sake_tpu_torch.kernels import split_ef as se

    params, h, x = aspirin_model(dev)
    args = layer0_args(params, h[:B], x[:B], 4)
    a, cots = args["merged"], cotangents(args, seed)["merged"]
    i = se.WEIGHTS["merged"].index("b_sem")
    kw = se.BWD["merged"](a, cots, True)[1][i]
    pw = se.vjp_plain("merged", a, cots, True)[1][i]
    ref = se.vjp_plain("merged", [t.double() for t in a], [c.double() for c in cots], True)[1][i]
    torch.cuda.synchronize()
    out = {"kernel": _rel(kw.double(), ref), "plain_f32": _rel(pw.double(), ref),
           "kernel_vs_plain_f32": _rel(kw, pw)}
    print(f"PROBE_SPLIT D_B_SEM #28 (merged pullback, B={B}, N={a[0].shape[1]}) against its "
          f"plain version in float64: kernel {out['kernel']:.3e}, plain f32 "
          f"{out['plain_f32']:.3e}; kernel against plain f32 {out['kernel_vs_plain_f32']:.3e}",
          flush=True)
    return out


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="check_on_card only (no probe): the forwards and pullbacks against plain")
    ap.add_argument("--d-b-sem", action="store_true",
                    help="d_b_sem only (no probe): #28's d_b_sem against float64")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if not torch.cuda.is_available():
        print("probe_split.py needs a CUDA device", flush=True)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    if args.check:
        return 0 if check_on_card(dev) else 1
    if args.d_b_sem:
        d_b_sem(dev)
        return 0
    ok = check_on_card(dev)
    probe(dev)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
