"""Workload registry: every experiment family of the JAX package mapped to a
task and a config preset.

Port of ``sake_tpu/tasks/registry.py``: ``get_workload``, ``list_workloads``,
``parse_overrides`` and ``main``, with the same entries. An entry whose task
module is not ported yet raises ``NotImplementedError`` when it is built,
naming the ROADMAP item that ports it; an unknown name raises ``KeyError``.

Usage::

    from sake_tpu_torch.tasks.registry import get_workload
    run, cfg = get_workload("md17_kernel")  # MD17Config(use_kernel_ef=True), fused mode
    run(cfg)

or from the command line: ``python -m sake_tpu_torch.tasks.registry md17_kernel``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

# task modules of the JAX package the port does not have yet, and the
# ROADMAP Queue 1 item that ports each
_NOT_PORTED = {
    "nbody": 11, "forecast": 11, "iso17": 11, "ani": 11, "ablation": 11,
    "oc20": 11, "flows": 12, "sweep": 16,
}


def _lazy(module: str, fn: str, cfg_cls: str, **overrides):
    def build() -> Tuple[Callable, Any]:
        import importlib

        if module in _NOT_PORTED:
            raise NotImplementedError(
                f"sake_tpu_torch.tasks.{module} is not ported yet (ROADMAP Queue 1 item "
                f"{_NOT_PORTED[module]})")
        mod = importlib.import_module(f"sake_tpu_torch.tasks.{module}")
        cfg = getattr(mod, cfg_cls)(**overrides)
        return getattr(mod, fn), cfg

    return build


_REGISTRY: Dict[str, Callable] = {
    # dynamics / forecasting
    "nbody": _lazy("nbody", "run", "NBodyConfig"),
    "motion": _lazy("forecast", "run", "ForecastConfig", workload="motion"),
    "md17_forecast": _lazy("forecast", "run", "ForecastConfig", workload="md17_forecast"),
    # energy + force
    "md17": _lazy("md17", "run", "MD17Config"),
    "md17_traj": _lazy("md17", "run", "MD17Config", checkpoint_every_blocks=1),
    # second-order force-loss training on the kernels, in the config's
    # default aug_mode="fused" (#11, #12)
    "md17_kernel": _lazy("md17", "run", "MD17Config", use_kernel_ef=True),
    "iso17": _lazy("iso17", "run", "ISO17Config"),
    # property regression
    "qm9": _lazy("qm9", "run", "QM9Config"),
    "qm9_tpu": _lazy("qm9", "run", "QM9Config", data_parallel=True),
    # the kernel backbone (#4-#6)
    "qm9_kernel": _lazy("qm9", "run", "QM9Config", data_parallel=False,
                        use_kernel_backbone=True),
    "qm9_kernel_bucketed": _lazy("qm9", "run", "QM9Config", data_parallel=False,
                                 use_kernel_backbone=True, bucket_pad_multiple=8),
    # large heterogeneous
    "ani": _lazy("ani", "run", "ANIConfig"),
    "oc20": _lazy("oc20", "run", "OC20Config"),
    "oc20_sparse_kernel": _lazy("oc20", "run", "OC20Config", use_sparse_kernel=True),
    # cutoff-sparse: the plain sparse model, or the edge kernels #13-#15
    "sparse_md": _lazy("sparse_md", "run", "SparseMDConfig"),
    "sparse_train": _lazy("sparse_train", "run", "SparseTrainConfig"),
    "sparse_train_kernel": _lazy("sparse_train", "run", "SparseTrainConfig", use_kernel=True),
    "sparse_md_kernel": _lazy("sparse_md", "run", "SparseMDConfig", use_kernel=True),
    # flows
    "dw4": _lazy("flows", "run_cnf", "CNFConfig"),
    "dw4_aug": _lazy("flows", "run_augmented", "AugmentedFlowConfig", system="dw4"),
    "lj13_aug": _lazy("flows", "run_augmented", "AugmentedFlowConfig", system="lj13"),
    "qm9_aug": _lazy("flows", "run_augmented", "AugmentedFlowConfig", system="qm9"),
    # ablations (one flag each off the md17 template)
    "ablation_no_euclidean": _lazy("ablation", "run", "AblationConfig", flag="no_euclidean"),
    "ablation_no_semantic": _lazy("ablation", "run", "AblationConfig", flag="no_semantic"),
    "ablation_no_spatial": _lazy("ablation", "run", "AblationConfig", flag="no_spatial"),
    "ablation_no_update": _lazy("ablation", "run", "AblationConfig", flag="no_update"),
    "ablation_egnn": _lazy("ablation", "run", "AblationConfig", flag="egnn"),
}


def list_workloads():
    return sorted(_REGISTRY)


def get_workload(name: str, **overrides) -> Tuple[Callable, Any]:
    """``(run, cfg)`` of the named workload, with ``overrides`` replacing
    config fields."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown workload {name!r}; known: {list_workloads()}")
    run, cfg = _REGISTRY[name]()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return run, cfg


def parse_overrides(tokens):
    """``key=value`` command-line tokens -> config overrides. Values are
    parsed as Python literals (ints, floats, True/None, quoted strings,
    tuples); bare words fall back to strings, so ``molecule=ethanol``
    works."""
    import ast

    overrides = {}
    for tok in tokens:
        key, eq, text = tok.partition("=")
        if not eq:
            raise SystemExit(f"override {tok!r} is not key=value (e.g. molecule=ethanol)")
        try:
            overrides[key] = ast.literal_eval(text)
        except (ValueError, SyntaxError):
            overrides[key] = text
    return overrides


def main(argv=None):
    """``python -m sake_tpu_torch.tasks.registry <workload> [key=value ...]``;
    no workload prints the registry. The JAX package's ``sweep`` subcommand
    is not ported yet (ROADMAP Queue 1 item 16)."""
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m sake_tpu_torch.tasks.registry <workload> [key=value ...]\n"
              "workloads:")
        for n in list_workloads():
            print(f"  {n}")
        return
    if argv[0] == "sweep":
        raise NotImplementedError("the sweep subcommand is not ported yet (ROADMAP Queue 1 "
                                  "item 16)")
    run, cfg = get_workload(argv[0], **parse_overrides(argv[1:]))
    print(f"running {argv[0]} with {cfg}")
    run(cfg)


if __name__ == "__main__":
    main()
