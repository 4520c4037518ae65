"""Where the block time of the sparse edge kernels #13 and #14 goes: a clock64()
probe per phase of the receiver row, at the sparse tasks' shapes on one NVIDIA
GPU.

    python3 tools/probe_sparse.py

Builds ``csrc/sparse_fwd.cu`` (#13), ``csrc/sparse_bwd.cu`` (#14 and its rows
instantiation) and ``csrc/sparse_contract.cu`` twice at once, without and with
``-DSAKE_PROBE`` (``csrc/probe.cuh``), prints ptxas's registers, shared memory
and spills of the edge kernels, then at ``SparseMDConfig()``'s box (4096 atoms,
K = 64) and ``SparseTrainConfig()``'s (1024 atoms, K = 48) launches each kernel
once on layer 0's inputs on the probe build and prints each slot's share of the
block cycles (thread 0 reads the SM clock after a block barrier and charges the
cycles since its last mark; the slots sum over every block of the launch). The
slots: geometry and loads, the narrow products, the softmax, forming he_att, the
x-mixing product and its transpose, their epilogues (pooling, d_u, d_xm, d_h_e,
d_att2), the pullback's narrow tail and the rows instantiation's row stores.
Each kernel's time per launch (CUDA events) on both builds follows, so the
probe's own cost shows. The card's name and power limit come first.

It also holds what ``chip_smoke.py``, ``tools/sparse_ab.py``,
``tools/cuda_emu/emulate.py`` and ``tests/test_torch_sparse_wgmma.py`` share:
layer 0's inputs of the sparse boxes (``layer0_inputs``), seeded inputs at the
sparse widths (``sparse_inputs``), and the checks of #13 and #14 against plain on
the card (``check_on_card``, ``check_slot_limit``).
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
SOURCES = ("sparse_fwd.cu", "sparse_bwd.cu", "sparse_contract.cu")
SLOTS = ("sp_load", "sp_narrow", "sp_softmax", "sp_heatt", "sp_xmix_f", "sp_xmix_b", "sp_epi",
         "sp_tail", "sp_store")  # probe.cuh's PR_SP_* slots, in order
N_SLOTS = 52  # kProbeSlots
SLOT0 = 24  # the first of the sparse edge row's slots (PR_SP_LOAD)
ENTRIES = ("sake_sparse_fwd", "sake_sparse_bwd", "sake_sparse_bwd_rows", "sake_sparse_contract",
           "sake_sparse_fwd_probe", "sake_sparse_bwd_probe", "sake_sparse_fwd_max_slots",
           "sake_sparse_bwd_max_slots")
CASES = (("sparse_md_kernel", 4096, 64), ("sparse_train_kernel", 1024, 48))


SPARSE_TOL = 1e-4  # #13's and #14's limit against plain, max relative error per tensor
# (K, receiver rows) of check_on_card's seeded cases: both tasks' K, two and three
# 64-slot tiles, one K not a multiple of 8
CARD_CASES = ((64, 256), (48, 256), (80, 128), (96, 128), (128, 128), (37, 128))


def _tc_ab():
    spec = importlib.util.spec_from_file_location("tc_ab", os.path.join(ROOT, "tools",
                                                                        "tc_ab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cuda_ms = _tc_ab().cuda_ms


def build_both():
    """``{"plain": path, "probe": path}``: the sparse sources without and with
    the probe, built in parallel."""
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


def build_probe():
    """The sparse sources with the probe compiled in."""
    from sake_tpu_torch.kernels import build

    return build.build(SOURCES, ("SAKE_PROBE",))


def load(path):
    from sake_tpu_torch.kernels import build

    lib = build.declare(ctypes.CDLL(str(path)), ENTRIES)
    lib.sake_error_string = lambda err: b"see cudaGetErrorString"
    return lib


def ptxas_lines(lib_path) -> list:
    """The edge kernels' entry, register, spill and wgmma lines of a build's
    ptxas log (and any warning that names wgmma)."""
    lines = (lib_path.parent / "ptxas.txt").read_text().splitlines()
    out, mine = [], False
    for line in lines:
        if "Compiling entry" in line:
            mine = "edge_" in line and "kernel" in line
        if (mine and any(w in line for w in ("Compiling entry", "spill", "Used"))) or (
                "wgmma" in line and "Compiling" not in line):
            out.append(line.strip())
    return out


def layer0_inputs(workload: str, dev, seed: int = 11):
    """Layer 0's edge-op inputs of a sparse workload's box at its defaults, and
    random cotangents of #13's outputs: ``(hg, ai, oi, d0, m, ep, gp, gh)``."""
    import torch

    from sake_tpu_torch import sparse as sp
    from sake_tpu_torch.kernels import sparse_ef as se
    from sake_tpu_torch.kernels.functional import embed
    from sake_tpu_torch.kernels.leaves import split_layer
    from sake_tpu_torch.tasks import sparse_md, sparse_train
    from sake_tpu_torch.tasks.registry import get_workload

    cfg = get_workload(workload)[1]
    if workload == "sparse_md_kernel":
        h, x = sparse_md._synthesize_box(cfg, dev)[:2]
        rc = cfg.cutoff + cfg.skin
    else:
        h, x = sparse_train.synthesize(cfg, dev)
        rc = cfg.cutoff
    kp = sparse_md.make_params(cfg, h.shape[-1], cfg.seed, dev)
    with torch.no_grad():
        idx, m = sp.neighbor_list(x, rc, cfg.max_neighbors)
        F = kp.w_embed.shape[-1]
        L = {k: v.detach() for k, v in split_layer(kp.layers[0], F, cfg.n_heads).items()}
        ep = {n: L[n].contiguous() for n in se.EDGE_LEAVES}
        hg, ai, oi, d0 = se.edge_inputs(L, embed(kp, h).detach(), x, idx)
        NR, K = hg.shape[:2]
        gen = torch.Generator(dev).manual_seed(seed)
        C, HK = ep["w_xmix"].shape[1], ep["w_xmix"].shape[0]
        gp = torch.randn(3, NR, C, device=dev, generator=gen)
        gh = torch.randn(NR, HK, device=dev, generator=gen)
    return hg, ai, oi, d0, m.reshape(NR, K).float().contiguous(), ep, gp, gh


def sparse_inputs(NR, K, seed=0, F=64, R=50, H=64, Kh=4):
    """Seeded inputs of the edge kernels at the sparse tasks' widths (C = H *
    heads = 256), on the CPU: ``(hg, ai, oi, d0, m, ep, gp, gh)``; about a fifth
    of the slots masked, and the last row with no live slot."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: torch.from_numpy((sc * rng.standard_normal(s)).astype(np.float32))
    C = HK = H * Kh
    ep = dict(w_in_j=f(F, R, sc=F ** -0.5), w_o_j=f(F, H, sc=F ** -0.5),
              rbf_m=torch.from_numpy(rng.random((1, R)).astype(np.float32)),
              rbf_b=torch.from_numpy((1 + 4 * rng.random((1, R))).astype(np.float32)),
              w_o_f=f(R, H, sc=R ** -0.5), w_o_r=f(1, H), w_o1=f(H, H, sc=H ** -0.5),
              b_o1=f(1, H, sc=0.1), w_sem=f(H, Kh, sc=H ** -0.5), b_sem=f(1, Kh, sc=0.1),
              w_xmix=f(HK, C, sc=HK ** -0.5))
    m = torch.from_numpy((rng.random((NR, K)) < 0.8).astype(np.float32))
    m[-1] = 0.0
    return (f(NR, K, F), f(NR, R), f(NR, H), f(3, NR, K, sc=2.0), m, ep, f(3, NR, C), f(NR, HK))


def _rel(got, ref):
    return float((got.double() - ref).abs().max() / ref.abs().max())


def check_on_card(K, NR, dev, seed=0):
    """#13, #14 and #14 with the leaf gradients against their plain versions
    (max relative error per tensor, within ``SPARSE_TOL``), and a second launch
    of each bitwise equal to the first, on :func:`sparse_inputs`; returns
    ``{kernel: worst error}``."""
    import torch

    from sake_tpu_torch.kernels import sparse_ef as se

    cpu = sparse_inputs(NR, K, seed=seed)
    hg, ai, oi, d0, m, ep, gp, gh = [
        {n: a.to(dev) for n, a in t.items()} if isinstance(t, dict) else t.to(dev) for t in cpu]
    wt = se.edge_transposes(ep)
    before = (se.sparse_fwd.launches, se.sparse_bwd.launches, se.sparse_bwd_grads.launches)
    runs = [(se.sparse_fwd(hg, ai, oi, d0, m, ep, wt),
             se.sparse_bwd(hg, ai, oi, d0, m, ep, gp, gh, wt),
             se.sparse_bwd_grads(hg, ai, oi, d0, m, ep, gp, gh, wt)) for _ in range(2)]
    torch.cuda.synchronize()
    assert (se.sparse_fwd.launches, se.sparse_bwd.launches,
            se.sparse_bwd_grads.launches) == tuple(b + 2 for b in before)
    flat = lambda r: [*r[0], *r[1], *r[2][:4], *(r[2][4][n] for n in se.EDGE_LEAVES)]
    assert all(torch.equal(a, b) for a, b in zip(flat(runs[0]), flat(runs[1])))
    with torch.no_grad():
        want = (se.sparse_fwd_plain(hg, ai, oi, d0, m, ep),
                se.sparse_bwd_plain(hg, ai, oi, d0, m, ep, gp, gh),
                se.sparse_bwd_plain(hg, ai, oi, d0, m, ep, gp, gh, True))
    k13, k14, kg = runs[0]
    err = {"sparse_fwd": max(_rel(a, b.double()) for a, b in zip(k13, want[0])),
           "sparse_bwd": max(_rel(a, b.double()) for a, b in zip(k14, want[1])),
           "sparse_bwd_grads": max([_rel(a, b.double()) for a, b in zip(kg[:4], want[2][:4])]
                                   + [_rel(kg[4][n], want[2][4][n].double())
                                      for n in se.EDGE_LEAVES])}
    assert max(err.values()) <= SPARSE_TOL, err
    return err


def check_slot_limit(dev, NR=64):
    """The most slots the route takes at the sparse widths (#14's, under #13's):
    :func:`check_on_card` there, and one slot more raises a ValueError that names
    the limit. Returns ``(limit, {kernel: worst error})``."""
    from sake_tpu_torch.kernels import build
    from sake_tpu_torch.kernels import sparse_ef as se

    lib = build.load()
    most = lib.sake_sparse_bwd_max_slots(64, 50, 64, 4, 256)
    assert lib.sake_sparse_fwd_max_slots(64, 50, 64, 4, 256) >= most
    err = check_on_card(most, NR, dev)
    hg, ai, oi, d0, m, ep, gp, gh = [
        {n: a.to(dev) for n, a in t.items()} if isinstance(t, dict) else t.to(dev)
        for t in sparse_inputs(2, most + 1)]
    try:
        se.sparse_bwd(hg, ai, oi, d0, m, ep, gp, gh)
    except ValueError as e:
        assert f"at most {most} neighbour slots" in str(e), e
    else:
        raise AssertionError(f"#14 took K = {most + 1}, over its limit of {most}")
    return most, err


def launches(inputs):
    """#13, #14 and #14's rows instantiation on one input, as callables of the
    launch helpers (no counters move), the layer's transposes and planes made
    once, as the model makes them."""
    from sake_tpu_torch.kernels import sparse_ef as se

    hg, ai, oi, d0, m, ep, gp, gh = inputs
    wt = se.edge_transposes(ep)
    return {"#13 sparse_fwd": (lambda: se._launch_fwd(hg, ai, oi, d0, m, ep, wt), "fwd"),
            "#14 sparse_bwd": (lambda: se._launch_bwd(hg, ai, oi, d0, m, ep, gp, gh, wt), "bwd"),
            "#14 sparse_bwd_rows": (lambda: se._launch_bwd_grads(hg, ai, oi, d0, m, ep, gp, gh,
                                                                 wt), "bwd")}


def probe(inputs, lib, label: str, smi: str) -> dict:
    """One launch of each kernel on ``lib`` (a probe build); prints and returns
    ``{kernel: {slot: share}}``."""
    import torch

    from sake_tpu_torch.kernels import build

    saved, build._lib = build._lib, lib  # the launch helpers go through build.load()
    out = {}
    try:
        for name, (fn, src) in launches(inputs).items():
            entry = lib.sake_sparse_fwd_probe if src == "fwd" else lib.sake_sparse_bwd_probe
            ticks = (ctypes.c_ulonglong * N_SLOTS)()
            build.check(lib, entry(ticks, 1), "probe reset")
            with torch.no_grad():
                fn()
            torch.cuda.synchronize()
            build.check(lib, entry(ticks, 1), "probe read")
            sp = list(ticks)[SLOT0:SLOT0 + len(SLOTS)]
            total = sum(sp)
            shares = {s: round(t / total, 4) for s, t in zip(SLOTS, sp) if t}
            xmix = shares.get("sp_xmix_f", 0) + shares.get("sp_xmix_b", 0)
            print(f"PROBE {name} {label}: block cycles {total} ({total / inputs[0].shape[0]:.4g} "
                  f"per row); x-mixing share {xmix:.4f}; shares {json.dumps(shares)} ({smi})",
                  flush=True)
            out[name] = shares
    finally:
        build._lib = saved
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_sparse: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from sake_tpu_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    paths = build_both()
    for line in ptxas_lines(paths["plain"]):
        print(f"PTXAS {line}", flush=True)
    libs = {k: load(p) for k, p in paths.items()}
    for workload, N, K in CASES:
        inputs = layer0_inputs(workload, dev)
        label = f"N={inputs[0].shape[0]} K={inputs[0].shape[1]} ({workload})"
        probe(inputs, libs["probe"], label, smi)
        times = {}
        for k, lib in libs.items():
            saved, build._lib = build._lib, lib
            with torch.no_grad():
                times[k] = {name: round(cuda_ms(fn), 4) for name, (fn, _) in
                            launches(inputs).items()}
            build._lib = saved
        print(f"PROBE TIMES {label} (ms per launch): without the probe "
              f"{json.dumps(times['plain'])}; with it {json.dumps(times['probe'])} ({smi})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
