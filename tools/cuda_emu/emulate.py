"""Run #20 (``csrc/fused_remat_ef.cu``) on the CPU against its plain version.

    EMU_THREADS=128 python tools/cuda_emu/emulate.py                  # hidden 8 and 16
    EMU_THREADS=128 python tools/cuda_emu/emulate.py --hidden 64 --depth 3 --atoms 21
    EMU_THREADS=128 python tools/cuda_emu/emulate.py --asan          # AddressSanitizer

Compiles the kernel source with g++ against ``cuda_runtime.h`` beside this file
(one std::thread per CUDA thread; see there), loads it with ctypes in place of
``build.load()``, and calls ``fused_ef.launch`` with CPU tensors, in f32 and in
bf16, printing each mode's max relative error against ``fused_ef_plain`` and the
plain bf16 version's distance from plain f32. A check before a kernel's first
call on the card, not a measurement of it. ``--asan`` needs the script started
with g++'s libasan and libstdc++ preloaded (it prints the ``LD_PRELOAD`` line).
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


def compile_source(source: str, out_dir: Path, asan: bool) -> Path:
    """``csrc/<source>`` and its headers, launches rewritten, into a shared library."""
    src = out_dir / "src"
    src.mkdir(parents=True, exist_ok=True)
    for p in list(build.CSRC.glob("*.cu")) + list(build.CSRC.glob("*.cuh")):
        s = p.read_text().replace("extern __shared__ float4 smem4[];",
                                  "float4* smem4 = emu_smem();")
        s = re.sub(r"([\w:]+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\s*\(", r"emu_launch(\1, \2, ", s,
                   flags=re.S)
        (src / p.name).write_text(s)
    lib = out_dir / f"{Path(source).stem}.so"
    flags = ["-fsanitize=address", "-fno-omit-frame-pointer"] if asan else []
    subprocess.run(["g++", "-std=c++20", "-O1", "-g", "-fPIC", "-shared", *flags,
                    "-I", str(Path(__file__).parent), "-I", str(src), "-x", "c++",
                    str(src / source), "-o", str(lib), "-lpthread"], check=True)
    return lib


def load(lib_path: Path):
    """The emulated library, its entries declared by ``build.declare``."""
    lib = build.declare(ctypes.CDLL(str(lib_path)),
                        [n for n in build.signatures() if n.startswith("sake_fused_remat_ef")])
    lib.sake_error_string = lambda err: b"emulated"
    return lib


def check(hid: int, depth: int, B: int, N: int, F_in: int, upd, seed: int = 0):
    model = SAKEModel(hid, 1, depth, in_features=F_in, device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    p = model_params_from_linen(linen_tree(model), device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    h = torch.randn(B, N, F_in, generator=g)
    x = 1.5 * torch.randn(B, N, 3, generator=g)
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    e32, f32 = fused_ef.fused_ef_plain(p, h, x, upd, n_heads=4, matmul_dtype=None)
    for dtype in (None, torch.bfloat16):
        t0 = time.perf_counter()
        ek, fk = fused_ef.launch(fused_ef.kernel_weights(p, 4, dtype is not None), h, x, upd)
        secs = time.perf_counter() - t0
        ep, fp = fused_ef.fused_ef_plain(p, h, x, upd, n_heads=4, matmul_dtype=dtype)
        print(f"hidden {hid} depth {depth} B {B} N {N} gates {upd} {dtype or 'f32'}: kernel "
              f"vs plain e {rel(ek, ep):.3e} f {rel(fk, fp):.3e}; plain vs plain f32 e "
              f"{rel(ep, e32):.3e} f {rel(fp, f32):.3e}; finite "
              f"{bool(torch.isfinite(fk).all())} ({secs:.1f} s)", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hidden", type=int, nargs="*", default=[8, 16])
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--batch", type=int, default=3)
    ap.add_argument("--atoms", type=int, default=7)
    ap.add_argument("--asan", action="store_true")
    args = ap.parse_args()
    if args.asan and "libasan" not in os.environ.get("LD_PRELOAD", ""):
        asan = subprocess.run(["g++", "-print-file-name=libasan.so"], capture_output=True,
                              text=True).stdout.strip()
        cxx = subprocess.run(["g++", "-print-file-name=libstdc++.so.6"], capture_output=True,
                             text=True).stdout.strip()
        sys.exit(f'start with LD_PRELOAD="{asan} {cxx}" ASAN_OPTIONS=detect_leaks=0')
    with tempfile.TemporaryDirectory() as tmp:
        lib = load(compile_source("fused_remat_ef.cu", Path(tmp), args.asan))
        build.load = lambda: lib
        fused_ef._require_cuda = lambda name, t: None
        fused_ef._stream = lambda dev: None
        for hid in args.hidden:  # every layer updating, as the main path
            check(hid, args.depth, args.batch, args.atoms, 9 if hid == 64 else 5,
                  [1.0] * args.depth)


if __name__ == "__main__":
    main()
