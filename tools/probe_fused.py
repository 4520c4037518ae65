"""Where the block time of #11 and #12 goes: a clock64() probe per phase and
per product site, at aspirin's full width on one NVIDIA GPU.

    python3 tools/probe_fused.py                  # B = 4 and 512
    python3 tools/probe_fused.py --batches 512

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
         "pg_wide_mma", "pg_wide_flush", "pg_narrow", "pg_sum")  # probe.cuh's ProbeSlot order
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


def load(path):
    from sake_tpu_torch.kernels import build

    lib = build.declare(ctypes.CDLL(str(path)), ENTRIES)
    lib.sake_error_string = lambda err: b"see cudaGetErrorString"
    return lib


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
                total = sum(ticks)
                shares = {s: round(t / total, 4) for s, t in zip(SLOTS, ticks) if t}
                xmix = sum(v for s, v in shares.items() if s.endswith("xmix"))
                mm = sum(v for s, v in shares.items() if s.endswith("_mm"))
                print(f"PROBE {name} B={B} N={N} depth {depth}: block cycles {total} "
                      f"({total / B:.4g} per molecule); x-mixing share {xmix:.4f}, edge "
                      f"products {mm:.4f}; shares {json.dumps(shares)} ({smi})", flush=True)
                out[name] = shares
    finally:
        build._lib = saved
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, nargs="*", default=[4, 512])
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
