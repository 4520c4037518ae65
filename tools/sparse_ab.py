"""Hold the sparse edge kernels on the tensor cores against the parent commit's
on one NVIDIA GPU, in one process tree (the sparse sibling of ``tools/tc_ab.py``):

    python3 tools/sparse_ab.py --parent <checkout of the parent commit>

1. ``SASS``: builds both trees' kernels at once and compares every object's SASS
   function by function (``cuobjdump -sass``). #15's CUDA-core kernel
   (``edge_kernel<Dl, ...>``) is gone and its tensor-core one
   (``edge_wg_dl_kernel``) is new, and must run its x-mixing on ``wgmma`` (HGMMA
   ... TF32); every other function, #13's and #14's (``edge_wg_kernel``) and
   every dense kernel's included, must be the parent's.
2. ``TIME``: #13, #14 and #14 with the leaf gradients (its rows instantiation and
   the contraction) at layer 0 of ``SparseMDConfig()``'s box (N 4096, K 64) and
   ``SparseTrainConfig()``'s (N 1024, K 48), and at the latter #15's edge kernel
   alone (``tools/probe_sparse.bwd2_edge``) and whole (with its contraction), in
   worker processes that alternate the trees (parent, change, change, parent,
   parent, change), CUDA events, 5 launches after one warm-up; each kernel's runs
   per tree and their spread.
3. ``GRADS``: step 1 of ``sparse_train_kernel``'s kernel branch against its plain
   branch (double autograd), per-leaf gradients as max |diff| / max |plain|, and
   the loss, in both trees.
4. ``GPU_TEST``: the gpu-marked checks of ``tests/test_torch_sparse_wgmma.py``
   (``tools/probe_sparse.py``'s ``check_on_card``: #13, #14 and #14 with dW
   against plain at K = 64, 48, 80, 96, 128, 37, two launches bitwise equal;
   ``check_slot_limit``: the same at the most slots the route takes, one more
   raising; ``check_bwd2_on_card`` and ``check_bwd2_slot_limit``: #15 alike at K
   = 48, 37, 16 and its own limit), run without pytest, whose conftest needs JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
CASES = (("sparse_md_kernel", "N=4096 K=64"), ("sparse_train_kernel", "N=1024 K=48"))


def _module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TC_AB = _module("tc_ab", HERE / "tools" / "tc_ab.py")
# layer 0's inputs of the sparse boxes (by APIs both trees have) and the checks on the card
PROBE = _module("probe_sparse", HERE / "tools" / "probe_sparse.py")


def hgmma_lines(obj: Path, func: str) -> list:
    """The HGMMA instructions of one function of an object's SASS."""
    return [line for line in TC_AB.sass_functions(obj).get(func, []) if "HGMMA" in line]


def sass_phase(parent: Path) -> bool:
    t0 = time.perf_counter()
    procs = {"parent": TC_AB.build_tree(parent), "change": TC_AB.build_tree(HERE)}
    libs = {}
    for k, p in procs.items():
        out = p.communicate()[0]
        if p.returncode != 0:
            print(f"SASS build of the {k} tree failed:\n{out[-4000:]}", flush=True)
            return False
        libs[k] = Path(out.strip().splitlines()[-1])
    print(f"SASS both trees built in {time.perf_counter() - t0:.1f} s", flush=True)
    props = {k: TC_AB.ptxas_props((v.parent / "ptxas.txt").read_text()) for k, v in libs.items()}
    ok = True
    for obj in sorted(libs["change"].parent.glob("*.o")):
        a = TC_AB.sass_functions(libs["parent"].parent / obj.name)
        b = TC_AB.sass_functions(obj)
        same = [f for f in b if a.get(f) == b[f]]
        differ = [f for f in b if f in a and a[f] != b[f]]
        new = [f for f in b if f not in a]
        gone = [f for f in a if f not in b]
        print(f"SASS {obj.stem}.cu: {len(same)} of {len(b)} functions identical to the parent's"
              + (f"; differing {differ}" if differ else "") + (f"; new {new}" if new else "")
              + (f"; gone {gone}" if gone else ""), flush=True)
        for f in new:
            hg = hgmma_lines(obj, f)
            tf32 = bool(hg) and all("TF32" in line for line in hg)
            print(f"SASS   {f}: {len(hg)} HGMMA instructions, all TF32 {tf32}; "
                  f"[{props['change'].get(f, '?')}]", flush=True)
            ok &= "edge_wg_dl_kernel" in f and tf32
        for f in gone:
            print(f"SASS   gone {f}: parent [{props['parent'].get(f, '-')}]", flush=True)
            ok &= "edge_kernelINS_2DlE" in f  # edge_kernel<sake::Dl, ...>
        ok &= not differ
    print(f"SASS every kernel but #15's unchanged, #15's on HGMMA TF32: {ok}", flush=True)
    return ok


def time_worker(label: str) -> dict:
    import inspect

    import numpy as np
    import torch

    from sake_tpu_torch.kernels import build
    from sake_tpu_torch.kernels import sparse_ef as se

    build.load()
    dev = torch.device("cuda", 0)
    t = {}
    with torch.no_grad():
        for workload, shape in CASES:
            hg, ai, oi, d0, m, ep, gp, gh = PROBE.layer0_inputs(workload, dev)
            wt = se.edge_transposes(ep)  # once per layer, as the model makes them
            fwd_wt = (wt,) if "wt" in inspect.signature(se._launch_fwd).parameters else ()
            t[f"#13 sparse_fwd {shape}"] = TC_AB.cuda_ms(
                lambda: se._launch_fwd(hg, ai, oi, d0, m, ep, *fwd_wt), reps=5)
            t[f"#14 sparse_bwd {shape}"] = TC_AB.cuda_ms(
                lambda: se._launch_bwd(hg, ai, oi, d0, m, ep, gp, gh, wt), reps=5)
            t[f"#14 with dW {shape}"] = TC_AB.cuda_ms(
                lambda: se._launch_bwd_grads(hg, ai, oi, d0, m, ep, gp, gh, wt), reps=5)
            if workload == "sparse_train_kernel":
                cg = PROBE.cotangents(hg, ai, oi, d0)
                t[f"#15 edge kernel {shape}"] = TC_AB.cuda_ms(
                    lambda: PROBE.bwd2_edge(hg, ai, oi, d0, m, ep, gp, gh, cg, wt), reps=5)
                t[f"#15 sparse_bwd2 {shape}"] = TC_AB.cuda_ms(
                    lambda: se._launch_bwd2(hg, ai, oi, d0, m, ep, gp, gh, *cg, wt), reps=5)
    assert all(np.isfinite(v) for v in t.values())
    print("TC_AB_TIME " + json.dumps({"tree": label, "ms": t}), flush=True)
    return t


def grads_worker(label: str):
    import dataclasses

    import numpy as np
    import torch

    from sake_tpu_torch.kernels.functional import flat_params
    from sake_tpu_torch.tasks import sparse_train as task
    from sake_tpu_torch.tasks.registry import get_workload

    dev = torch.device("cuda", 0)
    cfg = get_workload("sparse_train_kernel")[1]
    rel = lambda a, b: float((a - b).abs().max() / (b.abs().max() + 1e-30))

    def loss_and_grads(c):
        kp, loss = task.setup(c, dev)
        leaves = flat_params(kp)
        lval = loss(kp)
        g = torch.autograd.grad(lval, leaves, allow_unused=True)
        return lval.detach(), [torch.zeros_like(p) if a is None else a for p, a in zip(leaves, g)]

    lk, gk = loss_and_grads(cfg)
    lp, gp = loss_and_grads(dataclasses.replace(cfg, use_kernel=False))
    errs = [rel(a, b) for a, b in zip(gk, gp)]
    worst = sorted(range(len(errs)), key=lambda i: -errs[i])[:3]
    print("TC_AB_GRADS " + json.dumps({
        "tree": label, "N": cfg.n_atoms, "K": cfg.max_neighbors, "leaves": len(errs),
        "loss_rel": abs(float(lk - lp)) / abs(float(lp)), "max": max(errs),
        "worst": [[i, errs[i]] for i in worst], "median": float(np.median(errs))}), flush=True)


def gpu_test_phase() -> bool:
    import torch

    dev, ok = torch.device("cuda", 0), True
    for K, NR in PROBE.CARD_CASES:
        try:
            err = PROBE.check_on_card(K, NR, dev)
            print(f"GPU_TEST K={K} NR={NR}: max rel err per kernel "
                  + json.dumps({k: float(f"{v:.3e}") for k, v in err.items()})
                  + ", two launches bitwise equal", flush=True)
        except AssertionError as e:
            ok = False
            print(f"GPU_TEST K={K} NR={NR}: FAILED {e!r}", flush=True)
    try:
        most, err = PROBE.check_slot_limit(dev)
        print(f"GPU_TEST the route's limit K={most}: max rel err per kernel "
              + json.dumps({k: float(f"{v:.3e}") for k, v in err.items()})
              + f"; K={most + 1} raises", flush=True)
    except AssertionError as e:
        ok = False
        print(f"GPU_TEST slot limit: FAILED {e!r}", flush=True)
    for K, NR in PROBE.BWD2_CASES:
        try:
            err = PROBE.check_bwd2_on_card(K, NR, dev)
            print(f"GPU_TEST #15 K={K} NR={NR}: max rel err {err:.3e}, two launches bitwise "
                  "equal", flush=True)
        except AssertionError as e:
            ok = False
            print(f"GPU_TEST #15 K={K} NR={NR}: FAILED {e!r}", flush=True)
    try:
        most, err = PROBE.check_bwd2_slot_limit(dev)
        print(f"GPU_TEST #15's limit K={most}: max rel err {err:.3e}; K={most + 1} raises",
              flush=True)
    except AssertionError as e:
        ok = False
        print(f"GPU_TEST #15's slot limit: FAILED {e!r}", flush=True)
    return ok


def run_worker(kind: str, root: Path, label: str, times: list) -> int:
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker", kind,
                           "--root", str(root), "--label", label], capture_output=True,
                          text=True)
    print(proc.stdout + proc.stderr[-4000:], end="", flush=True)
    times += [json.loads(line.split(" ", 1)[1]) for line in proc.stdout.splitlines()
              if line.startswith("TC_AB_TIME ")]
    return proc.returncode


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--worker", choices=("time", "grads"))
    ap.add_argument("--root", type=Path)
    ap.add_argument("--label")
    args = ap.parse_args()
    if args.worker:
        sys.path.insert(0, str(args.root.resolve()))
        (time_worker if args.worker == "time" else grads_worker)(args.label)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("sparse_ab.py needs a CUDA device", flush=True)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    parent = args.parent.resolve()
    ok = sass_phase(parent)
    trees = {"parent": parent, "change": HERE}
    times = []
    for label in ("parent", "change", "change", "parent", "parent", "change"):
        ok &= run_worker("time", trees[label], label, times) == 0
    if times:
        TC_AB.time_summary(times)
    for label in ("parent", "change"):
        ok &= run_worker("grads", trees[label], label, []) == 0
    sys.path.insert(0, str(HERE))
    ok &= gpu_test_phase()
    print(f"SPARSE_AB ok {ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
