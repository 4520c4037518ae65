"""The CUDA build of the port: what can be checked without ``nvcc``."""

import re

import pytest

from sake_tpu_torch.kernels import build, resid_ef
from sake_tpu_torch.kernels.leaves import LEAF_NAMES


def test_source_hash_covers_every_source(tmp_path, monkeypatch):
    names = {p.name for p in build._sources()}
    assert {"resid_fwd.cu", "resid_bwd.cu", "param_grads.cu", "resid_common.cuh"} <= names
    base = build.source_hash()
    for src in build._sources():
        copy = tmp_path / "csrc"
        copy.mkdir(exist_ok=True)
        for p in build._sources():
            text = p.read_text()
            (copy / p.name).write_text(text + ("\n// edit\n" if p == src else ""))
        monkeypatch.setattr(build, "CSRC", copy)
        assert build.source_hash() != base, src.name
        monkeypatch.setattr(build, "CSRC", src.parent)
    assert build.source_hash() == base


def test_build_without_nvcc_raises_clearly(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()


def test_kernel_tables_match_the_python_order():
    """The C enums index leaves, residuals and cotangent rows by position."""
    src = (build.CSRC / "resid_common.cuh").read_text()

    def enum(name):
        body = src[src.index(f"enum {name} {{"):src.index("};", src.index(f"enum {name} {{"))]
        return [t.strip() for t in body.split("{")[1].split(",") if t.strip()]

    assert enum("Leaf") == [n.upper() for n in LEAF_NAMES]
    assert [r.removeprefix("RS_") for r in enum("Resid")] == [n.upper() for n in resid_ef.RESIDS]
    assert [r.removeprefix("RW_") for r in enum("Row")] == [n.upper() for n in resid_ef.ROWS]
    assert f"kRows = {len(resid_ef.ROWS)};" in src


def test_declared_signatures_match_the_c_entries():
    """``build.signatures`` (the ctypes table ``load`` and the CPU emulator
    share) names every ``extern "C"`` entry of the sources, with its arity."""
    entries = {}
    for p in build._sources():
        for m in re.finditer(r'extern "C"\s+[\w\s*]+?\b(sake_\w+)\s*\(([^)]*)\)\s*\{',
                             p.read_text()):
            entries[m.group(1)] = len([a for a in m.group(2).split(",") if a.strip()])
    sig = build.signatures()
    assert "sake_fused_remat_ef" in entries and set(entries) == set(sig)
    assert {n: len(sig[n][0]) for n in sig} == entries
