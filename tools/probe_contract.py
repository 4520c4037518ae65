"""Where the time of the two gradient contractions goes: a clock64() probe per
phase of ``csrc/sparse_contract.cu`` and ``csrc/param_grads.cu``, at their
callers' shapes on one NVIDIA GPU.

    python3 tools/probe_contract.py

Builds the two sources twice at once, without and with ``-DSAKE_PROBE``
(``csrc/probe.cuh``), prints ptxas's registers, shared memory and spills of
their kernels, then launches each case once on the probe build and prints each
slot's share of the block cycles (thread 0 reads the SM clock after a block
barrier and charges the cycles since its last mark; the slots sum over every
block of the launch, the second pass's blocks included). The slots: the
sparse contraction's staging (loads and conversion), products, stores of the
partial sums and second pass; ``param_grads.cu``'s w_xmix leaf and its other
wide leaves (staging and operand formation, products, the f64 flushes and
stores), its narrow leaves and its second pass. Each case's time per launch
(CUDA events) on both builds follows, so the probe's own cost shows. The
card's name and power limit come first.

Before the probe, ``check_contractions`` holds both kernels against their
plain versions (and two launches bitwise); after the times, each case's device
time by kernel (``torch.profiler``: SPLIT lines) and its kernel alone beside
its yardsticks (``torch.matmul`` of the whole function, one product per term in
f64, and of its w_xmix term in f64 and f32: LIBRARY lines).

The cases (``cases``), which ``tools/contract_ab.py`` and ``chip_smoke.py``
share: the sparse contraction on #14's rows (with dW) and on #15's augmented
rows at layer 0 of ``SparseTrainConfig()``'s box (N 1024, K 48: E = 49,152),
and on #26's rows (the split pullbacks' weight cotangents) at aspirin B = 2048;
#12's augmented contraction (``md17_kernel``) at aspirin's N = 21, B = 4 and
512, and #17's (one layer a launch) at 512; #5's at QM9's B = 64, N = 29; full
width (hidden 64, 4 heads, R 50, C 256), rows and residuals random from fixed
seeds (the contraction's time does not depend on their values) but #14's,
which are the plain pullback's.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("sparse_contract.cu", "param_grads.cu")
SLOTS = ("sc_stage", "sc_mma", "sc_store", "sc_sum", "pg_xmix_stage", "pg_xmix_mma",
         "pg_xmix_flush", "pg_wide_stage", "pg_wide_mma", "pg_wide_flush", "pg_narrow",
         "pg_sum")  # probe.cuh's PR_SC_* and PR_PG_* slots, in order
N_SLOTS = 62  # kProbeSlots
SLOT0 = 33  # PR_SC_STAGE
ENTRIES = ("sake_sparse_contract", "sake_param_grads", "sake_param_grads_aug",
           "sake_retrace_grads16", "sake_sparse_contract_probe", "sake_param_grads_probe")
# the rows that are a wide leaf's operand a (functions of the forward)
A_ROWS = ("att2", "filt", "hatt", "psq")
# (label, B, N, augmented, layers): the dense cases (#17 contracts one layer a launch)
DENSE = (("#12 augmented (md17_kernel) B=4 N=21", 4, 21, True, 6),
         ("#12 augmented (md17_kernel) B=512 N=21", 512, 21, True, 6),
         ("#17 augmented, one layer, B=512 N=21", 512, 21, True, 1),
         ("#5 (qm9_kernel) B=64 N=29", 64, 29, False, 6))
# #17's contraction in the bf16 tier (sake_retrace_grads16, one layer of the
# retrace backward's f32 scratch), its edge weights rounded per md17's batch tile
DENSE16 = (("#17 bf16 tier, one layer, B=512 N=21", 512, 21, 1),)
RETRACE_TILE = 2
SPLIT_B = 2048  # #26's batch (aspirin's N = 21, a layer)

def _module(name: str, *path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_both():
    """``{"plain": path, "probe": path}``: the two sources without and with the
    probe, built in parallel."""
    from sake_tpu_torch.kernels import build

    paths = {}
    jobs = [threading.Thread(target=lambda: paths.__setitem__("plain", build.build(SOURCES))),
            threading.Thread(target=lambda: paths.__setitem__(
                "probe", build.build(SOURCES, ("SAKE_PROBE",))))]
    for j in jobs:
        j.start()
    for j in jobs:
        j.join()
    return paths


def load(path):
    from sake_tpu_torch.kernels import build

    lib = build.declare(ctypes.CDLL(str(path)), ENTRIES)
    lib.sake_error_string = lambda err: b"see cudaGetErrorString"
    return lib


def ptxas_lines(lib_path) -> list:
    """The contraction kernels' entry, register and spill lines of a build's
    ptxas log."""
    out = []
    for line in (lib_path.parent / "ptxas.txt").read_text().splitlines():
        if any(w in line for w in ("Compiling entry", "spill", "Used")):
            out.append(line.strip())
    return out


def sparse_rows(dev, seed: int = 25):
    """#14's rows (``edge_rows_plain``) at layer 0 of the sparse training box,
    and random tangent rows of the same widths: ``(rows, shapes, E)``, rows
    keyed as :func:`sparse_ef.aug_terms` names them."""
    import torch

    from sake_tpu_torch.kernels import sparse_ef as se

    ps = _module("probe_sparse", "tools", "probe_sparse.py")
    hg, ai, oi, d0, m, ep, gp, gh = ps.layer0_inputs("sparse_train_kernel", dev)
    with torch.no_grad():
        rows = se.edge_rows_plain(hg, ai, oi, d0, m, ep, gp, gh)
    rows["h_g"] = hg.reshape(-1, hg.shape[-1])
    gen = torch.Generator(dev).manual_seed(seed)
    for n in list(rows):
        rows["t_" + n] = torch.randn(rows[n].shape, device=dev, generator=gen)
    return rows, {n: tuple(ep[n].shape) for n in se.EDGE_LEAVES}, rows["h_g"].shape[0]


def dense_inputs(B: int, N: int, aug: bool, dev, seed: int = 0, hidden: int = 64,
                 depth: int = 6):
    """Random inputs of ``param_grads.cu`` (full width by default):
    ``(leaves, fwd, rows)`` or, augmented, ``(leaves, fwd, tfwd, rows, rows_t,
    t_rows)``; the leaves are a seeded ``SAKEModel(hidden, depth=depth,
    n_heads=4)``'s."""
    import torch

    from sake_tpu_torch.kernels import resid_ef as re_
    from sake_tpu_torch.kernels.adapter import linen_tree, model_params_from_linen
    from sake_tpu_torch.kernels.leaves import wide_stack
    from sake_tpu_torch.models import SAKEModel

    model = SAKEModel(hidden, 1, depth, in_features=hidden, device=dev,
                      generator=torch.Generator().manual_seed(seed))
    leaves = wide_stack(model_params_from_linen(linen_tree(model), device=dev), 4)
    dims = re_._dims(leaves, torch.empty(B, N, hidden))
    depth, F = dims[-1], dims[2]
    gen = torch.Generator(dev).manual_seed(seed + 1)
    rnd = lambda *s: torch.randn(*s, device=dev, generator=gen)

    def fwd():
        return re_.FwdOut(rnd(depth, B, N, F), rnd(depth, 3, B, N), rnd(depth, 3, B, N),
                          rnd(B, N, F), rnd(3, B, N), rnd(3, B, N),
                          {n: rnd(*s) for n, s in re_._resid_shapes(dims, leaves).items()})

    rows = lambda: {n: rnd(*s) for n, s in re_._row_shapes(dims, leaves).items()}
    if not aug:
        return leaves, fwd(), rows()
    p_rows, t_rows = rows(), rows()
    # the rows that are functions of the forward (a wide leaf's operand a) are
    # the same in both chains; the contraction reads them from the tangent
    # chain's
    return leaves, fwd(), fwd(), p_rows, {**t_rows, **{n: p_rows[n] for n in A_ROWS}}, rows()


def split_rows(dev, B: int = SPLIT_B, seed: int = 26):
    """Random rows of #26's pullbacks at aspirin's widths, B molecules of N =
    21 (one layer): ``{kind: (rows, terms, shapes)}`` for the edge_att and the
    coeff_pool pullback, ``E`` = B N^2."""
    import torch

    from sake_tpu_torch.kernels import split_ef as sf

    dims = (B, 21, 50, 64, 4, 256)
    gen = torch.Generator(dev).manual_seed(seed)
    out = {}
    for kind in ("edge_att", "coeff_pool"):
        widths = sf._row_widths(kind, dims)
        rows = {n: torch.randn(B * 21 * 21, w, device=dev, generator=gen)
                for n, w in widths.items()}
        terms = {n: sf.GRAD_TERMS[n] for n in sf.WEIGHTS[kind]}
        shapes = {n: (1 if a is None else widths[a], widths[g]) for n, ((a, g),) in terms.items()}
        out[kind] = rows, terms, shapes
    return out


def _yard_rows(rows: dict, terms: dict) -> dict:
    """The yardsticks of a sparse contraction: the whole function as one
    ``torch.matmul`` per term in f64 over materialised rows (a row sum against
    a column of ones), their times summed, and its w_xmix term(s) as one
    product in f64 and in f32."""
    import torch

    tc = _module("tc_ab", "tools", "tc_ab.py")
    f64 = torch.float64
    mm = lambda x, y: torch.matmul(x.transpose(-2, -1), y)
    E = next(iter(rows.values())).shape[0]
    ones = torch.ones(E, 1, device=next(iter(rows.values())).device, dtype=f64)
    whole = 0.0
    for ts in terms.values():
        for a, g in ts:
            x = ones if a is None else rows[a].to(f64)
            y = rows[g].to(f64)
            whole += tc.cuda_ms(lambda: mm(x, y))
            del x, y
    out = {"whole_f64": whole}
    if "w_xmix" in terms:
        xm = terms["w_xmix"]
        for dt in (f64, torch.float32):
            x = torch.cat([rows[a] for a, _ in xm]).to(dt)
            y = torch.cat([rows[g] for _, g in xm]).to(dt)
            out[f"w_xmix_{str(dt).split('.')[1]}"] = tc.cuda_ms(lambda: mm(x, y))
            del x, y
    return out


def _yard_dense(B: int, N: int, aug: bool, depth: int, dev, seed: int = 7) -> dict:
    """The yardsticks of ``param_grads.cu`` over ``depth`` layers at full width:
    one batched ``torch.matmul`` per leaf in f64 over random operands of its
    shapes (rows: edges, atoms or w_vmix's pooled rows; augmented, twice the
    rows: a against g_p + t_g stacked over t_a against g_t; a row sum against a
    column of ones), their times summed, and the w_xmix leaf's in f64 and f32;
    and the yardstick of resid_ef's bf16 tier (``whole_tier``): the same
    products with the four edge leaves' operands materialised in bf16 (one
    ``torch.matmul`` each, f32 accumulation) and the others' in f32, summed."""
    import torch

    from sake_tpu_torch.kernels import resid_ef as re_
    from sake_tpu_torch.kernels.leaves import LEAF_NAMES

    tc = _module("tc_ab", "tools", "tc_ab.py")
    gen = torch.Generator(dev).manual_seed(seed)
    mm = lambda x, y: torch.matmul(x.transpose(-2, -1), y)
    shapes = re_._leaf_shapes(64, 64, 50, 4, 256)
    out = {"whole_f64": 0.0, "whole_tier": 0.0}
    for leaf in LEAF_NAMES:
        r, c = shapes[leaf]
        ra, cg = (c, 1) if r == 1 else (r, c)
        rows = (B * N * N if leaf in EDGE_LEAVES else 3 * B * N if leaf == "w_vmix" else B * N)
        rows *= 2 if aug else 1
        x = torch.randn(depth, rows, ra, device=dev, generator=gen, dtype=torch.float64)
        y = torch.randn(depth, rows, cg, device=dev, generator=gen, dtype=torch.float64)
        out["whole_f64"] += tc.cuda_ms(lambda: mm(x, y))
        dt = torch.bfloat16 if leaf in re_.EDGE_MM_LEAVES else torch.float32
        xt, yt = x.to(dt), y.to(dt)
        out["whole_tier"] += tc.cuda_ms(lambda: mm(xt, yt))
        del xt, yt
        if leaf == "w_xmix":
            for dt in (torch.float64, torch.float32):
                xd, yd = x.to(dt), y.to(dt)
                out[f"w_xmix_{str(dt).split('.')[1]}"] = tc.cuda_ms(lambda: mm(xd, yd))
                del xd, yd
        del x, y
    return out


# the leaves of param_grads.cu contracted over edge rows (the others over atoms,
# w_vmix over the three pooled planes' atoms)
EDGE_LEAVES = ("rbf_m", "rbf_b", "w_o_f", "w_o_r", "b_o0", "w_o1", "b_o1", "w_sem", "b_sem",
               "w_xmix")


def cases(dev, names=None) -> dict:
    """``{label: (launch, probe entry, yardsticks)}`` (``names``: only the labels
    that start with one of them):
    each contraction once through its wrapper (the sparse one and #12's and
    #17's through their launch helpers; #5's through ``resid_ef.param_grads``,
    whose counter moves), on the library ``build.load()`` returns when called,
    and a callable of its yardsticks (:func:`_yard_rows`, :func:`_yard_dense`)."""
    from sake_tpu_torch.kernels import build, resid_ef
    from sake_tpu_torch.kernels import sparse_ef as se
    from sake_tpu_torch.kernels import train2_ef as t2

    want = lambda label: names is None or any(label.startswith(n) for n in names)
    out = {}
    sparse = [(label, terms) for label, terms in (("sparse #14 with dW", se.GRAD_TERMS),
                                                  ("sparse #15", se.aug_terms(se.GRAD_TERMS)))
              if want(label)]
    if sparse:
        rows, shapes, E = sparse_rows(dev)
    for label, terms in sparse:
        label = f"{label} E={E}"
        if want(label):
            out[label] = (lambda terms=terms: se._contract(build.load(), rows, terms, shapes, E,
                                                           dev),
                          "sake_sparse_contract_probe",
                          lambda terms=terms: _yard_rows(rows, terms))
    label = f"#26 split weight cotangents B={SPLIT_B} N=21, a layer"
    if want(label):
        split = split_rows(dev)
        E2 = SPLIT_B * 21 * 21

        def both(fn):
            return lambda: [fn(*v) for v in split.values()]
        out[label] = (both(lambda r, t, sh: se._contract(build.load(), r, t, sh, E2, dev)),
                      "sake_sparse_contract_probe",
                      lambda: {k: sum(d[k] for d in both(lambda r, t, sh: _yard_rows(r, t))()
                                      if k in d)
                               for k in ("whole_f64", "w_xmix_float64", "w_xmix_float32")})
    for label, B, N, aug, depth in DENSE:
        if want(label):
            ins = dense_inputs(B, N, aug, dev, depth=depth)
            fn = ((lambda ins=ins: t2._launch_param_grads_aug(*ins)) if aug else
                  (lambda ins=ins: resid_ef.param_grads(*ins)))
            out[label] = (fn, "sake_param_grads_probe",
                          lambda B=B, N=N, aug=aug, depth=depth: _yard_dense(B, N, aug, depth, dev))
    for label, B, N, depth in DENSE16:
        if want(label):
            ins = dense_inputs(B, N, True, dev, depth=depth)
            out[label] = (lambda ins=ins: t2._launch_retrace_grads16(*ins, RETRACE_TILE),
                          "sake_param_grads_probe",
                          lambda B=B, N=N, depth=depth: _yard_dense(B, N, True, depth, dev))
    return out


def library(cs: dict, smi: str) -> dict:
    """Each case's kernel alone beside its yardsticks (LIBRARY lines), ms:
    ``{case: {kernel, whole_f64, w_xmix_float64, w_xmix_float32}}``."""
    import torch

    tc = _module("tc_ab", "tools", "tc_ab.py")
    out = {}
    for name, (fn, _, yard) in cs.items():
        with torch.no_grad():
            row = {"kernel": tc.cuda_ms(fn), **yard()}
        out[name] = {k: round(v, 4) for k, v in row.items()}
        print(f"LIBRARY {name}: the kernel alone, the whole function as torch.matmul f64 per term "
              f"summed, its w_xmix term(s) as one torch.matmul, and (dense) the bf16 tier's "
              f"yardstick, the edge leaves' terms in bf16 and the rest in f32 (ms) "
              f"{json.dumps(out[name])} ({smi})", flush=True)
    return out


SPARSE_TOL = 1e-6  # the sparse contraction per leaf, max |kernel - plain f64| / max |plain|
DENSE_TOL = 1e-4  # param_grads.cu per leaf against its plain f32 version, relative


def _rel(got, ref) -> float:
    return float((got.double() - ref.double()).abs().max() / (ref.double().abs().max() + 1e-30))


def check_contractions(dev, dense=((8, 29, False), (4, 21, True), (3, 21, True))) -> dict:
    """Both contraction kernels against their plain versions on the card, and
    two launches of each bitwise equal: the sparse one on #14's rows and on
    #15's augmented rows of the sparse training box (each leaf within
    ``SPARSE_TOL`` of ``contract_plain``, which sums in f64), ``param_grads.cu``
    on :func:`dense_inputs` at full width for each ``(B, N, augmented)`` of
    ``dense`` (each leaf within ``DENSE_TOL`` of ``param_grads_plain`` /
    ``param_grads_aug_plain``, f32). Returns ``{check: worst error}``."""
    import torch

    from sake_tpu_torch.kernels import build, resid_ef
    from sake_tpu_torch.kernels import sparse_ef as se
    from sake_tpu_torch.kernels import train2_ef as t2

    err = {}
    rows, shapes, E = sparse_rows(dev)
    for name, terms in (("sparse #14 with dW", se.GRAD_TERMS),
                        ("sparse #15", se.aug_terms(se.GRAD_TERMS))):
        runs = [se._contract(build.load(), rows, terms, shapes, E, dev) for _ in range(2)]
        torch.cuda.synchronize()
        assert all(torch.equal(runs[0][n], runs[1][n]) for n in terms), f"{name}: two launches differ"
        want = se.contract_plain(rows, terms)
        err[name] = max(_rel(runs[0][n], want[n]) for n in terms)
        assert err[name] <= SPARSE_TOL, (name, err[name])
    del rows
    for B, N, aug in dense:
        ins = dense_inputs(B, N, aug, dev, seed=B)
        launch = ((lambda: t2._launch_param_grads_aug(*ins)[0]) if aug else
                  (lambda: resid_ef._launch_param_grads(*ins)))
        runs = [launch() for _ in range(2)]
        torch.cuda.synchronize()
        name = f"param_grads{'_aug' if aug else ''} B={B} N={N}"
        assert all(torch.equal(runs[0][n], runs[1][n]) for n in runs[0]), f"{name}: two launches differ"
        with torch.no_grad():
            want = t2.param_grads_aug_plain(*ins) if aug else resid_ef.param_grads_plain(*ins)
        err[name] = max(_rel(runs[0][n], want[n]) for n in want)
        assert err[name] <= DENSE_TOL, (name, err[name])
    return err


def probe(cs: dict, lib, smi: str) -> dict:
    """One launch of each case on ``lib`` (a probe build); prints and returns
    ``{case: {slot: share}}``."""
    import torch

    from sake_tpu_torch.kernels import build

    saved, build._lib = build._lib, lib
    out = {}
    try:
        for name, (fn, entry, _) in cs.items():
            ticks = (ctypes.c_ulonglong * N_SLOTS)()
            build.check(lib, getattr(lib, entry)(ticks, 1), "probe reset")
            with torch.no_grad():
                fn()
            torch.cuda.synchronize()
            build.check(lib, getattr(lib, entry)(ticks, 1), "probe read")
            sl = list(ticks)[SLOT0:SLOT0 + len(SLOTS)]
            total = sum(sl)
            shares = {s: round(t / total, 4) for s, t in zip(SLOTS, sl) if t}
            print(f"PROBE {name}: block cycles {total}; shares {json.dumps(shares)} ({smi})",
                  flush=True)
            out[name] = shares
    finally:
        build._lib = saved
    return out


def kernel_split(cs: dict, smi: str) -> dict:
    """Each case's device time by kernel (``torch.profiler`` over 3 launches
    after a warm-up): ``{case: {kernel: ms per launch}}``, printed; empty where
    the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, (fn, _, _) in cs.items():
        with torch.no_grad():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
        split = {}
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
            if us and ("contract" in e.key or "param_grads" in e.key or "sum_chunks" in e.key):
                short = next((k for k in ("contract_tiles", "contract_sum", "param_grads_wide",
                                          "param_grads_narrow", "sum_chunks") if k in e.key),
                             e.key[:40])
                if short in ("contract_tiles", "param_grads_wide"):  # by tile width
                    short += " 256" if ("Li8E" in e.key or "8>" in e.key) else " 64"
                split[short] = round(split.get(short, 0.0) + us / 3e3, 4)
        print(f"SPLIT {name} (ms per launch by kernel): {json.dumps(split)} ({smi})", flush=True)
        out[name] = split
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_contract: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from sake_tpu_torch.kernels import build

    tc_ab = _module("tc_ab", "tools", "tc_ab.py")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    paths = build_both()
    for line in ptxas_lines(paths["plain"]):
        print(f"PTXAS {line}", flush=True)
    libs = {k: load(p) for k, p in paths.items()}
    saved, build._lib = build._lib, libs["plain"]
    err = check_contractions(dev)
    build._lib = saved
    print("CHECK both contractions against plain, two launches bitwise equal: max rel err "
          + json.dumps({k: float(f"{v:.3e}") for k, v in err.items()}) + f" ({smi})", flush=True)
    cs = cases(dev)
    probe(cs, libs["probe"], smi)
    times = {}
    for k, lib in libs.items():
        saved, build._lib = build._lib, lib
        with torch.no_grad():
            times[k] = {name: round(tc_ab.cuda_ms(fn), 4) for name, (fn, _, _) in cs.items()}
        build._lib = saved
    print(f"PROBE TIMES (ms per launch): without the probe {json.dumps(times['plain'])}; with it "
          f"{json.dumps(times['probe'])} ({smi})", flush=True)
    saved, build._lib = build._lib, libs["plain"]
    kernel_split(cs, smi)
    library(cs, smi)
    build._lib = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
