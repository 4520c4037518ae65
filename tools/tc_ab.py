"""Hold a change to the dense kernels against the parent commit's on one NVIDIA
GPU, in one process tree:

    python3 tools/tc_ab.py --parent <checkout of the parent commit>
    python3 tools/tc_ab.py --parent <checkout> --phases sass time --time-sets qm9
    python3 tools/tc_ab.py --parent <checkout> --change <another checkout> \
        --phases time outputs --time-sets fused
    python3 tools/tc_ab.py --parent <checkout> --phases sass time --time-sets fori depthgrid \
        --kernels remat_bwd_kernel
    python3 tools/tc_ab.py --parent <checkout> --phases sass time --time-sets serving
    python3 tools/tc_ab.py --parent <checkout> --phases sass time --time-sets qm9 fori depthgrid

1. ``SASS``: builds both trees' kernels at once (``build.build``) and compares
   every object's SASS function by function (``cuobjdump -sass``). Every kernel
   but those ``--kernels`` names (by default #6's cluster kernel,
   ``resid_fwd_cl_kernel<false>``, #21's and #23's tensor-core kernel,
   ``remat_fwd_kernel<true>``, and the one-block forward without streams,
   ``resid_fwd_kernel<false>``, which #6 ran on before and which is gone;
   ``resid_fwd_tc_kernel``, ``resid_bwd_tc_kernel`` and
   ``resid_tc_product_kernel`` for a change to K1 and K2 on MD17 serving's
   route; ``remat_bwd_kernel`` for a change to #22 and #24;
   the cluster kernels of #4 and #5, ``resid_fwd_cl_kernel`` and
   ``resid_bwd_cl_kernel``, for a change to those; ``fused_ef_kernel`` and
   ``fused_bwd_kernel`` for a change to #11 and #12's block) must compile to the
   parent's instructions (a function whose name changed, as #4's cluster kernel
   became ``resid_fwd_cl_kernel<true>``, ``remat_fwd_kernel`` became
   ``remat_fwd_kernel<false>`` and ``resid_fwd_kernel<true>`` a plain
   ``resid_fwd_kernel``, counts as unchanged when its instructions are the parent's
   function's); the ptxas lines of the kernels
   that differ or are new are printed beside the parent's.
2. ``TIME``: kernels timed in worker processes that alternate the trees
   (parent, change, change, parent, parent, change), CUDA events, 3 launches
   after one warm-up. Set ``md17``: K1, K2, #3 and #20 (f32, bf16) at aspirin
   B = 2048 (#3, #20) or 512, #9, #10, #21-#24 at 512, and #11, #12's block
   and its contraction at 512 and 4. Set ``qm9``: at chip_smoke.py phase 5's
   input (the first ``qm9_kernel`` batch, B = 64, N = 29, masked) #6 through
   ``resid_infer`` (that tree's route: the cluster kernel where it has one), #4
   and #5's rows kernel on the route ``make_hidden_fn`` takes in that tree (the
   cluster kernels where the tree has them) and on the one-block route, and the
   ``qm9_kernel`` train step (5 steps a run, after one). Set ``fused``: #20
   alone (``csrc/fused_remat_ef.cu`` built by itself) in f32 and bf16 at
   chip_smoke.py phase 24's B = 2048. Sets ``fori`` and ``depthgrid``: #21 and
   #22, or #23 and #24 (``csrc/remat_ef.cu`` built by itself; each wrapper on the
   route its tree takes, so the forwards' tensor-core kernel against the parent's
   CUDA-core one), at chip_smoke.py
   phase 18's model and the path's chunk, B = 512, and the path's E + F at B =
   2048 (``fori_energy_forces``, ``depthgrid_energy_forces``) with its peak device
   memory (TC_AB_PEAK lines). Set ``serving``: K1 and K2 through their wrappers
   (each tree's route) at chip_smoke.py phase 4's per-kernel input (aspirin, B =
   512; ``tools/probe_resid.serving_inputs``) and MD17 serving's path,
   ``resid_energy_forces`` at B = 2048 in chunks of 512 (``csrc/resid_fwd.cu`` and
   ``csrc/resid_bwd.cu`` built by themselves). Each kernel's runs per tree and
   their spread.
3. ``GRADS``: step 1 of ``md17_kernel``'s fused branch against its plain
   branch (double autograd), per-leaf gradients as max |diff| / max |plain|, at
   batch 4 (``MD17Config``'s) and 512, on four (model init, batch order) seeds,
   the first chip_smoke.py's, in both trees.
4. ``ALIGN``: #11, #12 and #20 refuse a w_xmix leaf (or its transpose) that does
   not start 16-byte aligned (``tests/test_torch_tf32x3.py``'s gpu-marked test,
   run without pytest, whose conftest needs JAX).
5. ``OUTPUTS``: #20's E and F in f32 and bf16 at phase 24's B = 37 and 2048 in a
   worker of each tree, compared bit for bit (and max |diff| / max |parent|), and
   each tree's distance at B = 37 from the plain bf16 and f32 versions
   (``fused_ef_plain`` on the card; phase 24's aspirin check).

``--change`` is the tree held against the parent (this checkout by default).

Full width: hidden 64, depth 6, 4 heads, C 256, R 50, aspirin's 21 atoms, the
weights and inputs random from fixed seeds.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# the kernels this change may add, alter or remove: #6's cluster kernel (the
# cluster forward without streams; with them, #4's, it must keep the parent's
# instructions under its template name), #21's and #23's tensor-core kernel
# (remat_fwd_kernel<false> must keep the parent's remat_fwd_kernel's), and the
# one-block forward without streams, gone
NEW_KERNELS = ("resid_fwd_cl_kernelILb0E", "remat_fwd_kernelILb1E", "resid_fwd_kernelILb0E")
# (model seed, batch seed): chip_smoke.py's step 1 (MD17Config's seed, batch
# order RandomState(0)), then three more
SEEDS = ((2666, 0), (0, 1), (1, 2), (2, 3))
GRAD_BATCHES = (4, 512)


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


def build_tree(root: Path) -> subprocess.Popen:
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from sake_tpu_torch.kernels import build; print(build.build())")
    return subprocess.Popen([sys.executable, "-c", code, str(root)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def anonymous(text: str) -> str:
    """``text`` with the hashes nvcc puts into an anonymous namespace's name
    dropped: they differ from tree to tree, and with the source's text."""
    text = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_", "_GLOBAL__N__", text)
    return re.sub(r"(_GLOBAL__N__\d+_\w+?_cu)_[0-9a-f]{8}", r"\1", text)


def sass_functions(obj: Path) -> dict:
    """``{function: [instruction lines]}`` of one object's SASS (names as
    ``anonymous`` gives them)."""
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(obj)], capture_output=True, text=True,
                          check=True).stdout
    text = anonymous(text)
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None and "/*" in line:
            funcs[name].append(line.strip())
    return funcs


def ptxas_props(ptxas: str) -> dict:
    """``{function: "registers ..., spills ..."}`` from a ptxas -v log."""
    props, name = {}, None
    for line in anonymous(ptxas).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line)
        if m:
            name = m.group(1)
        elif name and ("spill" in line or "Used" in line):
            props[name] = (props.get(name, "") + " " + line.split(":", 1)[-1].strip()).strip()
    return props


def sass_phase(parent: Path, change: Path, kernels=NEW_KERNELS) -> bool:
    t0 = time.perf_counter()
    procs = {"parent": build_tree(parent), "change": build_tree(change)}
    libs = {}
    for k, p in procs.items():
        out = p.communicate()[0]
        if p.returncode != 0:
            print(f"SASS build of the {k} tree failed:\n{out[-4000:]}", flush=True)
            return False
        libs[k] = Path(out.strip().splitlines()[-1])
    print(f"SASS both trees built in {time.perf_counter() - t0:.1f} s", flush=True)
    ok = True
    props = {k: ptxas_props((v.parent / "ptxas.txt").read_text()) for k, v in libs.items()}
    for obj in sorted(libs["change"].parent.glob("*.o")):
        old = libs["parent"].parent / obj.name
        a, b = (sass_functions(old) if old.exists() else {}), sass_functions(obj)
        same = [f for f in b if a.get(f) == b[f]]
        differ = [f for f in b if f in a and a[f] != b[f]]
        new = [f for f in b if f not in a]
        gone = [f for f in a if f not in b]
        # a function renamed (made a template's instantiation) with the parent's instructions
        renamed = {f: g for f in gone for g in new if a[f] == b[g]}
        new = [f for f in new if f not in renamed.values()]
        gone = [f for f in gone if f not in renamed]
        print(f"SASS {obj.stem}.cu: {len(same) + len(renamed)} of {len(b)} functions identical "
              f"to the parent's" + (f"; renamed {renamed}" if renamed else "")
              + (f"; differing {differ}" if differ else "") + (f"; new {new}" if new else "")
              + (f"; gone {gone}" if gone else ""), flush=True)
        for f in differ + new:
            print(f"SASS   {f}: change [{props['change'].get(f, '?')}] parent "
                  f"[{props['parent'].get(f, '-')}]", flush=True)
        for f in differ:  # where the instructions first part
            at = next(i for i, (x, y) in enumerate(zip(a[f] + [""], b[f] + [""])) if x != y)
            print(f"SASS   {f} first differs at instruction {at} of {len(a[f])} / {len(b[f])}: "
                  f"parent {a[f][at:at + 3]} change {b[f][at:at + 3]}", flush=True)
        if any(not any(k in f for k in kernels) for f in differ + new + gone):
            ok = False
    print(f"SASS every kernel but {list(kernels)} unchanged: {ok}", flush=True)
    return ok


def qm9_times(dev) -> dict:
    """The ``qm9`` set: #4 and #5's rows kernel on both routes and the train
    step at chip_smoke.py phase 5's input, in the tree on ``sys.path``."""
    import inspect

    import numpy as np
    import torch

    from sake_tpu_torch.data.qm9 import dimenet_split, load_qm9
    from sake_tpu_torch.kernels import resid_ef
    from sake_tpu_torch.tasks import qm9 as task
    from sake_tpu_torch.train import TrainState, make_optimizer, shuffle_batches

    spec = importlib.util.spec_from_file_location("probe_resid", HERE / "tools" / "probe_resid.py")
    pr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pr)
    leaves, leaves_t, h0, xs, zs, m4, dh, upd = pr.qm9_inputs(dev)
    B, N = h0.shape[:2]
    kw = ({"cluster": True} if "cluster" in inspect.signature(resid_ef.resid_fwd).parameters
          else {})
    t = {}
    with torch.no_grad():
        fwd = resid_ef.resid_fwd_plain(leaves, h0, xs, zs, upd, mask=m4)
        # #6 through its wrapper: the route make_hidden_fn's evaluation takes in this tree
        t[f"#6 resid_infer masked B={B} N={N}"] = cuda_ms(
            lambda: resid_ef.resid_infer(leaves, h0, xs, zs, upd, m4))
        for route, k in (("make_hidden_fn's route", kw), ("one-block", {})):
            t[f"#4 resid_fwd masked B={B} N={N} {route}"] = cuda_ms(
                lambda: resid_ef.resid_fwd(leaves, h0, xs, zs, upd, m4, **k))
            t[f"#5 resid_bwd_rows masked B={B} N={N} {route}"] = cuda_ms(
                lambda: resid_ef.resid_bwd_rows(leaves, fwd, upd, dh, zs, zs, m4,
                                                leaves_t=leaves_t, **k))
        del fwd
    cfg = task.QM9Config(use_kernel_backbone=True, data_parallel=False)
    data = load_qm9(None, cfg.n_samples, seed=cfg.seed)
    tr_idx, _, _ = dimenet_split(len(data.x))
    n_classes = int(data.charges.max()) + 1
    y_mean, y_std = float(data.y[tr_idx].mean()), float(data.y[tr_idx].std())
    train = task.prepare_split(data, tr_idx, n_classes, y_mean, y_std, dev)
    batches = shuffle_batches(np.random.RandomState(cfg.seed), train, cfg.batch_size)[:6]
    model = task.QM9Model(cfg, n_classes, device=dev,
                          generator=torch.Generator().manual_seed(cfg.seed))
    prm, fwd_fn = task.make_forward(cfg, model)
    step = task.make_train_step(fwd_fn)
    state = TrainState.create(params=prm, tx=make_optimizer(cfg.learning_rate,
                                                            weight_decay=cfg.weight_decay))
    state, _ = step(state, batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b_ in batches[1:]:
        state, _ = step(state, b_)
    torch.cuda.synchronize()
    t[f"qm9_kernel train step B={B}"] = (time.perf_counter() - t0) * 1e3 / (len(batches) - 1)
    return t


def fused_inputs(dev, B: int = 2048):
    """chip_smoke.py phase 24's model and first B molecules
    (``tools/probe_fused.k20_inputs``), with #20's library of the tree on
    ``sys.path``: ``csrc/fused_remat_ef.cu`` built by itself."""
    import ctypes

    from sake_tpu_torch.kernels import build

    spec = importlib.util.spec_from_file_location("probe_fused", HERE / "tools" / "probe_fused.py")
    pf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pf)
    names = [n for n in build.signatures() if n.startswith("sake_fused_remat_ef")]
    lib = ctypes.CDLL(str(build.build(("fused_remat_ef.cu",))))
    lib = build.declare(lib, [n for n in names if hasattr(lib, n)])
    lib.sake_error_string = lambda err: b"see cudaGetErrorString"
    return lib, pf.k20_inputs(dev, B)


def fused_times(dev) -> dict:
    """The ``fused`` set: #20 in both tiers at B = 2048."""
    import torch

    from sake_tpu_torch.kernels import build, fused_ef

    lib, (p, h, x) = fused_inputs(dev)
    upd = [1.0] * len(p.layers)
    t = {}
    saved, build._lib = build._lib, lib
    try:
        with torch.no_grad():
            for bf16 in (False, True):
                w = fused_ef.kernel_weights(p, 4, bf16)
                t[f"#20 {'bf16' if bf16 else 'f32'} B={x.shape[0]} alone"] = cuda_ms(
                    lambda: fused_ef.launch(w, h, x, upd))
    finally:
        build._lib = saved
    return t


def remat_times(dev, sets, peaks: dict) -> dict:
    """The ``fori`` and ``depthgrid`` sets: #21 and #22, #23 and #24, at B =
    512 and their path's E + F at B = 2048, on ``csrc/remat_ef.cu`` built by
    itself in the tree on ``sys.path``, at ``tools/probe_fused.k20_inputs``
    (chip_smoke.py phase 18's model and data). The E + F call's peak device
    memory above what was allocated before it goes into ``peaks`` (MiB)."""
    import ctypes

    import torch

    from sake_tpu_torch.kernels import build, depthgrid_ef, fori_ef, resid_ef
    from sake_tpu_torch.kernels.functional import embed
    from sake_tpu_torch.kernels.leaves import transposed, wide_stack

    spec = importlib.util.spec_from_file_location("probe_fused", HERE / "tools" / "probe_fused.py")
    pf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pf)
    lib = ctypes.CDLL(str(build.build(("remat_ef.cu",))))
    lib = build.declare(lib, [n for n in build.signatures()
                              if n.startswith("sake_remat") and hasattr(lib, n)])
    lib.sake_error_string = lambda err: b"see cudaGetErrorString"
    p, h, x = pf.k20_inputs(dev, 2048)
    upd = [1.0] * len(p.layers)
    paths = {"fori": (fori_ef, "#21/#22", "fori_fwd", "fori_bwd", "fori_energy_forces"),
             "depthgrid": (depthgrid_ef, "#23/#24", "depthgrid_fwd", "depthgrid_bwd",
                           "depthgrid_energy_forces")}
    t = {}
    saved, build._lib = build._lib, lib
    try:
        with torch.no_grad():
            leaves = wide_stack(p, 4)
            leaves_t = transposed(leaves)
            h0 = embed(p, h[:512]).contiguous()
            xs = x[:512].permute(2, 0, 1).contiguous()
            for name in sets:
                mod, ids, fw, bw, ef = paths[name]
                f_fn, b_fn, ef_fn = getattr(mod, fw), getattr(mod, bw), getattr(mod, ef)
                bnd = f_fn(leaves, h0, xs, upd)
                dh = resid_ef._readout_seed(p, bnd.h_fin, None)[1]
                fwd_id, bwd_id = ids.split("/")
                t[f"{fwd_id} {fw} B=512"] = cuda_ms(lambda: f_fn(leaves, h0, xs, upd))
                t[f"{bwd_id} {bw} B=512"] = cuda_ms(
                    lambda: b_fn(leaves, bnd, upd, dh, leaves_t=leaves_t))
                t[f"{ef} B=2048"] = cuda_ms(lambda: ef_fn(p, h, x, n_heads=4))
                del bnd
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                ef_fn(p, h, x, n_heads=4)
                torch.cuda.synchronize()
                peaks[f"{ef} B=2048"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    finally:
        build._lib = saved
    return t


def serving_times(dev) -> dict:
    """The ``serving`` set: K1 and K2 at B = 512 and ``resid_energy_forces`` at B
    = 2048, on ``csrc/resid_fwd.cu`` and ``csrc/resid_bwd.cu`` built by themselves
    in the tree on ``sys.path``."""
    import ctypes

    import torch

    from sake_tpu_torch.data.md17 import synthesize_md17
    from sake_tpu_torch.kernels import build, resid_ef
    from sake_tpu_torch.tasks.md17 import species_onehot

    spec = importlib.util.spec_from_file_location("probe_resid", HERE / "tools" / "probe_resid.py")
    pr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pr)
    path = build.build(("resid_fwd.cu", "resid_bwd.cu"))
    lib = ctypes.CDLL(str(path))
    lib = build.declare(lib, [n for n in build.signatures()
                              if n.startswith("sake_resid") and hasattr(lib, n)]
                        + ["sake_error_string"])
    params, leaves, leaves_t, hc, xc, zc, dh, upd = pr.serving_inputs(dev)
    data = synthesize_md17(n_samples=2048, seed=0)
    species = species_onehot(data.z, int(data.z.max())).to(dev)
    x = torch.as_tensor(data.x, device=dev)
    h = species.expand(x.shape[0], *species.shape).contiguous()
    t = {}
    saved, build._lib = build._lib, lib
    try:
        with torch.no_grad():
            fwd = resid_ef.resid_fwd(leaves, hc, xc, zc, upd)
            B = hc.shape[0]
            t[f"K1 resid_fwd B={B}"] = cuda_ms(lambda: resid_ef.resid_fwd(leaves, hc, xc, zc, upd))
            t[f"K2 resid_bwd B={B}"] = cuda_ms(
                lambda: resid_ef.resid_bwd(leaves, fwd, upd, dh, zc, zc, leaves_t=leaves_t))
            del fwd
            t[f"resid_energy_forces B={x.shape[0]}"] = cuda_ms(
                lambda: resid_ef.resid_energy_forces(params, h, x, n_heads=4))
        routes = {f: dict(getattr(getattr(resid_ef, f), "routes", {}))
                  for f in ("resid_fwd", "resid_bwd")}
        print("TC_AB_ROUTES " + json.dumps(routes), flush=True)
    finally:
        build._lib = saved
    return t


def outputs_worker(label: str, out: Path):
    """#20's E and F (both tiers, B = 37 and 2048) into ``out``; the distance at
    B = 37 from the plain versions printed."""
    import torch

    from sake_tpu_torch.kernels import build, fused_ef

    dev = torch.device("cuda", 0)
    lib, (p, h, x) = fused_inputs(dev)
    upd = [1.0] * len(p.layers)
    rel = lambda a, b: float((a - b).abs().max() / (b.abs().max() + 1e-30))
    res = {}
    saved, build._lib = build._lib, lib
    try:
        with torch.no_grad():
            for bf16 in (False, True):
                w = fused_ef.kernel_weights(p, 4, bf16)
                for B in (37, x.shape[0]):
                    e, f = fused_ef.launch(w, h[:B].contiguous(), x[:B].contiguous(), upd)
                    res[("bf16" if bf16 else "f32", B)] = (e.cpu(), f.cpu())
        plain = {tier: fused_ef.fused_ef_plain(p, h[:37], x[:37], upd, n_heads=4,
                                               matmul_dtype=dtype)
                 for tier, dtype in (("f32", None), ("bf16", torch.bfloat16))}
    finally:
        build._lib = saved
    for tier in ("f32", "bf16"):
        e, f = res[(tier, 37)]
        print("TC_AB_FUSED_PLAIN " + json.dumps({
            "tree": label, "tier": tier, "B": 37,
            **{f"vs_plain_{k}": {"e": rel(e, plain[k][0].cpu()), "f": rel(f, plain[k][1].cpu())}
               for k in plain}}), flush=True)
    torch.save(res, out)


def outputs_phase(parent: Path, change: Path) -> bool:
    """Each tree's #20 outputs from a worker of its own, compared."""
    import tempfile

    import torch

    with tempfile.TemporaryDirectory() as tmp:
        outs = {}
        for label, root in (("parent", parent), ("change", change)):
            outs[label] = Path(tmp) / f"{label}.pt"
            if run_worker("outputs", root, label, [], out=outs[label]) != 0:
                return False
        a, b = (torch.load(outs[k]) for k in ("parent", "change"))
    for key in a:
        for name, x, y in zip(("e", "f"), a[key], b[key]):
            print(f"TC_AB_FUSED_OUT {key[0]} B={key[1]} {name}: bitwise equal "
                  f"{torch.equal(x, y)}, max |change - parent| {float((x - y).abs().max()):.3e}, "
                  f"relative {float((x - y).abs().max() / x.abs().max()):.3e}", flush=True)
    return True


def time_worker(label: str, sets=("md17",)) -> dict:
    import numpy as np
    import torch

    from sake_tpu_torch.data.md17 import load_md17
    from sake_tpu_torch.kernels import build, depthgrid_ef, fori_ef, fused_ef, one_ef, resid_ef
    from sake_tpu_torch.kernels import train2_ef as t2
    from sake_tpu_torch.kernels.adapter import linen_tree, model_params_from_linen
    from sake_tpu_torch.kernels.functional import embed
    from sake_tpu_torch.kernels.leaves import transposed, wide_stack
    from sake_tpu_torch.models import SAKEModel

    dev = torch.device("cuda", 0)
    t = fused_times(dev) if "fused" in sets else {}
    if "serving" in sets:
        t |= serving_times(dev)
    remat = [k for k in ("fori", "depthgrid") if k in sets]
    if remat:
        peaks = {}
        t |= remat_times(dev, remat, peaks)
        print("TC_AB_PEAK " + json.dumps({"tree": label, "MiB": peaks}), flush=True)
    if "qm9" in sets or "md17" in sets:
        build.load()
    if "qm9" in sets:
        t |= qm9_times(dev)
    if "md17" not in sets:
        print("TC_AB_TIME " + json.dumps({"tree": label, "ms": t}), flush=True)
        return t
    data = load_md17("aspirin", None, n_samples=2048)
    N, F_in, depth, heads = len(data.z), 8, 6, 4
    model = SAKEModel(64, 1, depth, n_heads=heads, in_features=F_in, device=dev,
                      generator=torch.Generator().manual_seed(0))
    p = model_params_from_linen(linen_tree(model), device=dev)
    g = torch.Generator(dev).manual_seed(1)
    upd = [1.0] * depth
    with torch.no_grad():
        leaves = wide_stack(p, heads)
        leaves_t = transposed(leaves)
        x_all = torch.as_tensor(data.x, device=dev)
        h_all = torch.nn.functional.one_hot(torch.as_tensor(data.z % F_in, device=dev).long(),
                                            F_in).float().expand(2048, N, F_in).contiguous()
        hb, xb = h_all, x_all.contiguous()
        t["#3 one_ef B=2048"] = cuda_ms(lambda: one_ef.one_energy_forces(p, hb, xb,
                                                                          n_heads=heads))
        for bf16 in (False, True):
            w = fused_ef.kernel_weights(p, heads, bf16)
            t[f"#20 {'bf16' if bf16 else 'f32'} B=2048"] = cuda_ms(
                lambda: fused_ef.launch(w, hb, xb, upd))
        for B in (512, 4):
            h0 = embed(p, h_all[:B]).contiguous()
            xs = x_all[:B].permute(2, 0, 1).contiguous()
            zs = torch.zeros_like(xs)
            tx0 = torch.randn(3, B, N, device=dev, generator=g)
            g_e = torch.randn(B, device=dev, generator=g)
            if B == 512:
                fwd = resid_ef.resid_fwd(leaves, h0, xs, zs, upd)
                _, dh = resid_ef._readout_seed(p, fwd.h_fin, None)
                t["K1 B=512"] = cuda_ms(lambda: resid_ef.resid_fwd(leaves, h0, xs, zs, upd))
                t["K2 B=512"] = cuda_ms(lambda: resid_ef.resid_bwd(leaves, fwd, upd, dh, zs, zs,
                                                                   leaves_t=leaves_t))
                tfwd = t2.resid_jvp(leaves, fwd, upd, tx0)
                t["#9 resid_jvp B=512"] = cuda_ms(lambda: t2.resid_jvp(leaves, fwd, upd, tx0))
                t["#10 resid_tbwd B=512"] = cuda_ms(lambda: t2.resid_tbwd(
                    leaves, fwd, tfwd, upd, dh, zs, zs, leaves_t=leaves_t))
                del tfwd
                for name, mod, fw, bw in (("#21/#22", fori_ef, "fori_fwd", "fori_bwd"),
                                          ("#23/#24", depthgrid_ef, "depthgrid_fwd",
                                           "depthgrid_bwd")):
                    f_fn, b_fn = getattr(mod, fw), getattr(mod, bw)
                    bnd = f_fn(leaves, h0, xs, upd)
                    _, dhc = resid_ef._readout_seed(p, bnd.h_fin, None)
                    t[f"{name.split('/')[0]} {fw} B=512"] = cuda_ms(lambda: f_fn(leaves, h0, xs,
                                                                                  upd))
                    t[f"{name.split('/')[1]} {bw} B=512"] = cuda_ms(
                        lambda: b_fn(leaves, bnd, upd, dhc, leaves_t=leaves_t))
                    del bnd
                del fwd
            fwd, _, _ = t2.fused_primal(p, leaves, h0, xs, upd, leaves_t=leaves_t)
            blk = t2.fused_bwd_block(p, leaves, fwd, upd, tx0, g_e, leaves_t=leaves_t)
            t[f"#11 fused_primal B={B}"] = cuda_ms(
                lambda: t2.fused_primal(p, leaves, h0, xs, upd, leaves_t=leaves_t))
            t[f"#12 fused_bwd_block B={B}"] = cuda_ms(
                lambda: t2.fused_bwd_block(p, leaves, fwd, upd, tx0, g_e, leaves_t=leaves_t))
            t[f"#12 fused_bwd_grads B={B}"] = cuda_ms(
                lambda: t2.fused_bwd_grads(p, leaves, fwd, *blk[2:]))
            del fwd, blk
    assert all(np.isfinite(v) for v in t.values())
    print("TC_AB_TIME " + json.dumps({"tree": label, "ms": t}), flush=True)
    return t


def loss_and_grads(br: dict, batch: dict, energy_loss_weight: float):
    """``tasks/md17.make_step_fn``'s loss on ``batch`` and the gradient of
    every parameter (zeros for one the branch does not use)."""
    import torch

    from sake_tpu_torch.train import tree_leaves

    leaves_ = tree_leaves(br["params"])
    with torch.enable_grad():
        e, f = br["ef"](br["params"], batch["x"])
        loss = ((f - batch["f"]).abs().mean()
                + energy_loss_weight * (e - batch["e"]).abs().mean())
        grads = torch.autograd.grad(loss, leaves_, allow_unused=True)
    return loss.detach(), [torch.zeros_like(q) if g is None else g
                           for q, g in zip(leaves_, grads)]


def grads_worker(label: str):
    import dataclasses

    import numpy as np
    import torch

    from sake_tpu_torch.data.md17 import load_md17
    from sake_tpu_torch.kernels.adapter import model_params_from_linen
    from sake_tpu_torch.kernels.functional import flat_params
    from sake_tpu_torch.tasks import md17 as task
    from sake_tpu_torch.train import shuffle_batches

    dev = torch.device("cuda", 0)
    base = task.MD17Config(use_kernel_ef=True, aug_mode="fused", n_valid=200)
    data = load_md17(base.molecule, None, n_samples=base.n_train + 2 * base.n_valid)
    species = task.species_onehot(data.z, int(data.z.max()))
    n_tr = base.n_train
    e_mean, e_std = float(data.e[:n_tr].mean()), float(data.e[:n_tr].std())
    tdev = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
    train = {"x": tdev(data.x[:n_tr]), "e": tdev(data.e[:n_tr]), "f": tdev(data.f[:n_tr])}
    rel = lambda a, b: float((a - b).abs().max() / (b.abs().max() + 1e-30))
    for B in GRAD_BATCHES:
        for seed, batch_seed in SEEDS:
            def branch(kernel: bool):
                c = dataclasses.replace(base, use_kernel_ef=kernel, batch_size=B, seed=seed)
                model = task.make_model(c, species.shape[-1], device=dev,
                                        generator=torch.Generator().manual_seed(c.seed))
                prm, ef_fn, _ = task.make_branch(c, model, species, e_mean, e_std)
                return dict(params=prm, ef=ef_fn)

            batch = shuffle_batches(np.random.RandomState(batch_seed), train, B)[0]
            plain, fused = branch(False), branch(True)
            lp, gp = loss_and_grads(plain, batch, base.energy_loss_weight)
            tree = {}
            for name, g in zip(sorted(plain["params"]), gp):  # tree_leaves order
                *path, leaf = name.split(".")
                node = tree
                for part in path:
                    node = node.setdefault(part, {})
                node[leaf] = g
            want = flat_params(model_params_from_linen(tree, dev))
            lk, gk = loss_and_grads(fused, batch, base.energy_loss_weight)
            errs = [rel(a, b) for a, b in zip(gk, want)]
            worst = sorted(range(len(errs)), key=lambda i: -errs[i])[:3]
            print("TC_AB_GRADS " + json.dumps({
                "tree": label, "B": B, "seed": seed, "batch_seed": batch_seed, "leaves": len(errs),
                "loss_rel": abs(float(lk - lp)) / abs(float(lp)), "max": max(errs),
                "worst": [[i, errs[i]] for i in worst],
                "median": float(np.median(errs))}), flush=True)
            del plain, fused, gp, gk, want, tree


def align_phase() -> bool:
    spec = importlib.util.spec_from_file_location(
        "test_torch_tf32x3", HERE / "tests" / "test_torch_tf32x3.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ok = True
    for kernel in ("fused_primal", "fused_bwd_block", "fused_energy_forces"):
        for leaf in ("w_xmix", "w_xmix.T"):
            try:
                mod.test_tensor_core_kernels_refuse_misaligned_w_xmix(kernel, leaf)
                print(f"ALIGN {kernel} with a misaligned {leaf}: ValueError raised", flush=True)
            except BaseException as e:  # pytest.fail is a BaseException
                ok = False
                print(f"ALIGN {kernel} with a misaligned {leaf}: FAILED {e!r}", flush=True)
    return ok


def run_worker(kind: str, root: Path, label: str, times: list, sets=("md17",),
               out: Path = None) -> int:
    """One worker process on ``root``'s package; its output is passed on and
    its TC_AB_TIME lines are appended to ``times``."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker", kind,
                           "--root", str(root), "--label", label, "--time-sets", *sets,
                           *(["--out", str(out)] if out else [])],
                          capture_output=True, text=True)
    print(proc.stdout + proc.stderr[-4000:], end="", flush=True)
    times += [json.loads(line.split(" ", 1)[1]) for line in proc.stdout.splitlines()
              if line.startswith("TC_AB_TIME ")]
    return proc.returncode


def time_summary(times: list):
    """Per kernel: each tree's runs, their spread (max / min) and the ratio
    of the means, change over parent."""
    for k in times[0]["ms"]:
        runs = {tree: [t["ms"][k] for t in times if t["tree"] == tree and k in t["ms"]]
                for tree in ("parent", "change")}
        if not all(runs.values()):
            continue
        mean = {tree: sum(v) / len(v) for tree, v in runs.items()}
        spread = {tree: max(v) / min(v) for tree, v in runs.items()}
        print(f"TC_AB_TIME_SUMMARY {k}: parent {json.dumps(runs['parent'])} (spread "
              f"{spread['parent']:.4f}), change {json.dumps(runs['change'])} (spread "
              f"{spread['change']:.4f}); change / parent {mean['change'] / mean['parent']:.4f}",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--change", type=Path, default=HERE)
    ap.add_argument("--worker", choices=("time", "grads", "outputs"))
    ap.add_argument("--root", type=Path)
    ap.add_argument("--label")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--phases", nargs="*", default=["sass", "time", "grads", "align"],
                    choices=["sass", "time", "grads", "align", "outputs"])
    ap.add_argument("--time-sets", nargs="*", default=["md17", "qm9"],
                    choices=["md17", "qm9", "fused", "fori", "depthgrid", "serving"])
    ap.add_argument("--kernels", nargs="*", default=list(NEW_KERNELS),
                    help="SASS: the functions (by a part of their names) that may differ")
    args = ap.parse_args()
    if args.worker:
        sys.path.insert(0, str(args.root.resolve()))
        if args.worker == "time":
            time_worker(args.label, args.time_sets)
        elif args.worker == "outputs":
            outputs_worker(args.label, args.out)
        else:
            grads_worker(args.label)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("tc_ab.py needs a CUDA device", flush=True)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    parent, change = args.parent.resolve(), args.change.resolve()
    ok = True
    if "sass" in args.phases:
        ok &= sass_phase(parent, change, tuple(args.kernels))
    trees = {"parent": parent, "change": change}
    times = []
    if "time" in args.phases:
        for label in ("parent", "change", "change", "parent", "parent", "change"):
            ok &= run_worker("time", trees[label], label, times, args.time_sets) == 0
    if times:
        time_summary(times)
    if "outputs" in args.phases:
        ok &= outputs_phase(parent, change)
    if "grads" in args.phases:
        for label in ("parent", "change"):
            ok &= run_worker("grads", trees[label], label, []) == 0
    sys.path.insert(0, str(HERE))
    if "align" in args.phases:
        ok &= align_phase()
    print(f"TC_AB ok {ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
