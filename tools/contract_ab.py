"""Hold the two gradient contractions on the f64 tensor cores against the parent
commit's on one NVIDIA GPU, in one process tree (the sibling of
``tools/tc_ab.py`` and ``tools/sparse_ab.py``):

    python3 tools/contract_ab.py --parent <checkout of the parent commit>

1. ``SASS``: builds both trees' kernels at once and compares every object's SASS
   function by function (``cuobjdump -sass``). Every function outside
   ``csrc/sparse_contract.cu`` and ``csrc/param_grads.cu`` must be the parent's;
   the kernels of those two that carry the products (``contract_tiles``,
   ``param_grads_wide``) must run them on DMMA (the f64 tensor cores).
2. ``TIME``: ``tools/probe_contract.py``'s cases (the sparse contraction on #14's
   and #15's rows of ``SparseTrainConfig()``'s box and on #26's at aspirin B =
   2048; #12's augmented contraction at aspirin B = 4 and 512, #17's one layer at
   512; #5's at QM9's B = 64) in worker processes that
   alternate the trees (parent, change, change, parent, parent, change), CUDA
   events, 3 launches after one warm-up; each case's runs per tree and their
   spread.
3. ``STEPS``: the train steps whose backward runs them, in worker processes
   that alternate the trees (parent, change, change, parent):
   ``md17_kernel``'s fused step at B = 4 and 512, ``qm9_kernel``'s kernel step at
   B = 64 and ``sparse_train_kernel``'s kernel step, on the host clock.
4. ``CHECK``: ``probe_contract.check_contractions`` on this tree (both kernels
   against their plain versions, two launches bitwise equal), the gpu-marked test
   of ``tests/test_torch_contract.py`` run without pytest, whose conftest needs
   JAX.
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
CHANGED = ("sparse_contract", "param_grads")  # the sources whose functions may differ
DMMA_KERNELS = ("contract_tiles", "param_grads_wide")


def _module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TC_AB = _module("tc_ab", HERE / "tools" / "tc_ab.py")
# the cases, their inputs (by APIs both trees have) and the checks on the card
PROBE = _module("probe_contract", HERE / "tools" / "probe_contract.py")


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
        if obj.stem not in CHANGED:
            ok &= not (differ or new or gone)
            continue
        for f in differ + new:
            dmma = [line for line in b[f] if "DMMA" in line]
            print(f"SASS   {f}: {len(dmma)} DMMA instructions "
                  f"({sorted({line.split()[1] for line in dmma})}); change "
                  f"[{props['change'].get(f, '?')}] parent [{props['parent'].get(f, '-')}]",
                  flush=True)
            if any(k in f for k in DMMA_KERNELS):
                ok &= bool(dmma)
        for f in gone:
            print(f"SASS   gone {f}: parent [{props['parent'].get(f, '-')}]", flush=True)
    print(f"SASS every function outside the two contraction sources unchanged, their "
          f"product kernels on DMMA: {ok}", flush=True)
    return ok


def time_worker(label: str) -> dict:
    import numpy as np
    import torch

    from sake_tpu_torch.kernels import build

    build.load()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    with torch.no_grad():
        t = {name: TC_AB.cuda_ms(fn) for name, (fn, _, _) in PROBE.cases(dev).items()}
    assert all(np.isfinite(v) for v in t.values())
    print("TC_AB_TIME " + json.dumps({"tree": label, "ms": t}), flush=True)
    return t


def step_worker(label: str) -> dict:
    """The train steps whose backward runs the contractions, each timed on the
    host clock around steps ended by a synchronise: ``md17_kernel``'s fused
    step at B = 4 (5 steps) and 512 (2), ``qm9_kernel``'s kernel step at B = 64
    (5), ``sparse_train_kernel``'s kernel step at N = 1024 (2), each after a
    warm-up step; the trees' own task code, from fixed seeds."""
    import numpy as np
    import torch

    from sake_tpu_torch.data.md17 import load_md17
    from sake_tpu_torch.data.qm9 import dimenet_split, load_qm9
    from sake_tpu_torch.kernels import build
    from sake_tpu_torch.tasks import md17, qm9, sparse_train
    from sake_tpu_torch.tasks.registry import get_workload
    from sake_tpu_torch.train import (
        TrainState,
        make_optimizer,
        shuffle_batches,
        warmup_cosine_schedule,
    )

    build.load()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    def host_ms(fn, n):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    t = {}
    cfg = md17.MD17Config(use_kernel_ef=True, aug_mode="fused")
    data = load_md17(cfg.molecule, None, n_samples=600)
    species = md17.species_onehot(data.z, int(data.z.max()))
    model = md17.make_model(cfg, species.shape[-1], device=dev,
                            generator=torch.Generator().manual_seed(cfg.seed))
    prm, ef_fn, _ = md17.make_branch(cfg, model, species, float(data.e.mean()),
                                     float(data.e.std()))
    box = {"state": TrainState.create(params=prm, tx=make_optimizer(
        warmup_cosine_schedule(cfg.learning_rate, 1000)))}
    step = md17.make_step_fn(ef_fn, cfg.energy_loss_weight)
    tdev = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
    for B, n in ((4, 5), (512, 2)):
        batch = {"x": tdev(data.x[:B]), "e": tdev(data.e[:B]), "f": tdev(data.f[:B])}
        t[f"md17_kernel fused step B={B}"] = host_ms(
            lambda: box.__setitem__("state", step(box["state"], batch)[0]), n)
    qcfg = qm9.QM9Config(use_kernel_backbone=True, data_parallel=False)
    qdata = load_qm9(None, qcfg.n_samples, seed=qcfg.seed)
    tr_idx = dimenet_split(len(qdata.x))[0]
    n_classes = int(qdata.charges.max()) + 1
    train = qm9.prepare_split(qdata, tr_idx, n_classes, float(qdata.y[tr_idx].mean()),
                              float(qdata.y[tr_idx].std()), dev)
    qprm, fwd = qm9.make_forward(qcfg, qm9.QM9Model(
        qcfg, n_classes, device=dev, generator=torch.Generator().manual_seed(qcfg.seed)))
    qstep = qm9.make_train_step(fwd)
    qbox = {"state": TrainState.create(params=qprm, tx=make_optimizer(
        qcfg.learning_rate, weight_decay=qcfg.weight_decay))}
    qbatch = shuffle_batches(np.random.RandomState(qcfg.seed), train, qcfg.batch_size)[0]
    t["qm9_kernel step B=64"] = host_ms(
        lambda: qbox.__setitem__("state", qstep(qbox["state"], qbatch)[0]), 5)
    scfg = get_workload("sparse_train_kernel")[1]
    kp, loss = sparse_train.setup(scfg, dev)
    t["sparse_train_kernel step N=1024"] = host_ms(sparse_train.make_step(scfg, kp, loss), 2)
    assert all(np.isfinite(v) for v in t.values())
    print("TC_AB_TIME " + json.dumps({"tree": label, "ms": t}), flush=True)
    return t


def run_worker(root: Path, label: str, times: list, kind: str = "time") -> int:
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
    ap.add_argument("--worker", choices=("time", "steps"))
    ap.add_argument("--root", type=Path)
    ap.add_argument("--label")
    args = ap.parse_args()
    if args.worker:
        sys.path.insert(0, str(args.root.resolve()))
        (time_worker if args.worker == "time" else step_worker)(args.label)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("contract_ab.py needs a CUDA device", flush=True)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    parent = args.parent.resolve()
    ok = sass_phase(parent)
    trees = {"parent": parent, "change": HERE}
    times = []
    for label in ("parent", "change", "change", "parent", "parent", "change"):
        ok &= run_worker(trees[label], label, times) == 0
    if times:
        TC_AB.time_summary(times)
    steps = []
    for label in ("parent", "change", "change", "parent"):
        ok &= run_worker(trees[label], label, steps, "steps") == 0
    if steps:
        TC_AB.time_summary(steps)
    sys.path.insert(0, str(HERE))
    try:
        err = PROBE.check_contractions(torch.device("cuda", 0))
        print("CHECK both contractions against plain, two launches bitwise equal: max rel err "
              + json.dumps({k: float(f"{v:.3e}") for k, v in err.items()}), flush=True)
    except AssertionError as e:
        ok = False
        print(f"CHECK FAILED {e!r}", flush=True)
    print(f"CONTRACT_AB ok {ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
