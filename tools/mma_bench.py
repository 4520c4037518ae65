"""Time the 3xTF32 tensor-core products of #11 and #12 alone against the
CUDA-core products they replace, on one NVIDIA GPU.

    python3 tools/mma_bench.py

Compiles ``tools/mma_bench.cu`` (with ``csrc/mma_tf32x3.cuh``) with nvcc for
``sm_90a`` into ``sake_tpu_torch/_build/mma_bench/`` and runs it: one receiver
row's x-mixing product (21 or 42 rows by 256 against 256 x 256) and the o1 edge
product (21 x 64 against 64 x 64), 126 times per block on 132 blocks of 512
threads. Prints the card's name and power limit, then one ``MMA_BENCH`` line per
variant with its cycles per product and ms per launch, and ``MMA_ACCURACY`` lines:
the x-mixing product of 21 rows against a float64 product (8 seeds, signed and
non-negative operands) on the CUDA cores, in 3xTF32 as ``mm_tc`` sums it (chunks
of k-steps from zero, each then added in f32) and with one running sum in the mma.

Then the sparse shape of #13 and #14 (one receiver row: 64 slots by 256 against 256 x
256), 31 products a block (a row per SM at N = 4096) on 132 blocks of 256 threads, four
ways: ``mm_wide`` on the CUDA cores in chunks of 16 slots (the route #13 and #14 had
before), #11's and #12's ``mma.sync`` 3xTF32 (``mm_tc``), the ``wgmma`` 3xTF32 of #13
and #14 (``wg_xmix``), each with its error against float64; and, as the library's
yardstick for the same multiply-adds (not a kernel of the port), one ``torch.matmul`` in
f32 with TF32 off of all 132 x 31 rows' slots against the weight.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    from sake_tpu_torch.kernels import build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    out = build.BUILD_DIR / "mma_bench"
    out.mkdir(parents=True, exist_ok=True)
    exe = out / "mma_bench"
    subprocess.run([build._nvcc(), *build.ARCH, "-std=c++17", "-O3", "-I", str(build.CSRC),
                    "-o", str(exe), str(ROOT / "tools" / "mma_bench.cu")], check=True)
    rc = subprocess.run([str(exe)]).returncode
    import torch

    if torch.cuda.is_available():
        torch.backends.cuda.matmul.allow_tf32 = False
        g = torch.Generator("cuda").manual_seed(0)
        a = torch.randn(132 * 31 * 64, 256, device="cuda", generator=g)
        w = torch.randn(256, 256, device="cuda", generator=g) / 16
        torch.matmul(a, w)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            torch.matmul(a, w)
        end.record()
        torch.cuda.synchronize()
        print(f"MMA_BENCH sparse n=64 x-mixing, torch.matmul f32 (TF32 off) of the 132 x 31 "
              f"rows' slots: {start.elapsed_time(end) / 5:.4f} ms", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
