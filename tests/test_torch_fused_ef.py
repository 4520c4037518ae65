"""The port's whole-model E + F in one launch (``kernels/fused_ef``, #20) and
the bf16 product rule of its functional model, against the JAX package.

On CPU tensors ``fused_energy_forces`` runs its plain version
(``fused_ef_plain``: the gated update layer over depth, the readout, one
autograd for F); the CUDA kernel (``csrc/fused_remat_ef.cu``) is checked
against it on the card by ``chip_smoke.py`` and by the ``gpu``-marked test
here. The JAX reference is ``sake_tpu.kernels.fused_energy_forces`` run by the
Pallas interpreter, at ``tests/test_kernels.py``'s size (B 4, N 7, F_in 5,
hidden 16, depth 3, ``batch_tile=2``), every layer updating and the mixed
schedule ``[False, True, False]``.

Tolerances:
- f32: ``rtol=2e-4, atol=2e-5``, the JAX test's own (``test_kernels.py:17``;
  f32 sums in another order);
- bf16: max|port - JAX| / max|JAX| <= 1e-3 for E and F. f32 sums in another
  order can flip a bf16 rounding of an operand, one bf16 step being 3.9e-3 of
  that operand. Measured on this size: the plain bf16 #20 against JAX's #20 in
  bf16 8.8e-5 (F) and 6.9e-8 (E) with every layer updating, 1.2e-6 and 5.1e-8
  with the mixed schedule; the functional ``energy_and_forces_fn`` in bf16
  against JAX's lax one 7.0e-7 and 6.9e-8, 3.3e-6 and 5.1e-8. The bf16 result
  differs from the f32 one by about 5e-3 in E and 9e-3 in F at this size, so
  the checks see the rounding rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sake_tpu.kernels import energy_and_forces_fn as jax_ef
from sake_tpu.kernels import fused_energy_forces as jax_fused
from sake_tpu.kernels import model_forward as jax_model_forward
from sake_tpu.kernels import model_params_from_linen as jax_from_linen
from sake_tpu.models import SAKEModel as JaxSAKEModel
from sake_tpu_torch.kernels import fused_ef, functional
from sake_tpu_torch.kernels.adapter import model_params_from_linen
from sake_tpu_torch.kernels.fori_ef import fori_energy_forces

TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = 1e-3
B, N, F_IN, HID, DEPTH = 4, 7, 5, 16, 3
UPDATES = {"all": True, "mixed": [False, True, False]}
DTYPES = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _t(a):
    return torch.as_tensor(np.array(a))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    h = rng.randn(B, N, F_IN).astype(np.float32)
    x = rng.randn(B, N, 3).astype(np.float32)
    models = {}
    for name, upd in UPDATES.items():
        model = JaxSAKEModel(hidden_features=HID, out_features=1, depth=DEPTH, update=upd)
        params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(h), jnp.asarray(x))
        models[name] = (jax_from_linen(params),
                        model_params_from_linen(jax.tree.map(np.asarray, params)))
    return dict(h=h, x=x, models=models, jax_fused={})


def _jax_fused(s, upd_name, dtype_name):
    """JAX #20 in interpret mode, once per (schedule, dtype) in the module."""
    key = (upd_name, dtype_name)
    if key not in s["jax_fused"]:
        e, f = jax_fused(s["models"][upd_name][0], jnp.asarray(s["h"]), jnp.asarray(s["x"]),
                         update=UPDATES[upd_name], batch_tile=2,
                         matmul_dtype=DTYPES[dtype_name][0], interpret=True)
        s["jax_fused"][key] = (np.asarray(e), np.asarray(f))
    return s["jax_fused"][key]


def _port_fused(s, upd_name, dtype, **kw):
    return fused_ef.fused_energy_forces(s["models"][upd_name][1], _t(s["h"]), _t(s["x"]),
                                        update=UPDATES[upd_name], matmul_dtype=dtype, **kw)


@pytest.mark.parametrize("upd_name", list(UPDATES))
def test_f32_matches_jax_interpret(setup, upd_name):
    """The plain f32 version against JAX #20 with ``matmul_dtype=None``; the
    JAX tile is accepted."""
    e_j, f_j = _jax_fused(setup, upd_name, "f32")
    e, f = _port_fused(setup, upd_name, None, batch_tile=2, interpret=True)
    assert e.shape == (B,) and f.shape == (B, N, 3)
    np.testing.assert_allclose(e.numpy(), e_j, **TOL)
    np.testing.assert_allclose(f.numpy(), f_j, **TOL)


@pytest.mark.parametrize("upd_name", list(UPDATES))
def test_bf16_matches_jax_interpret(setup, upd_name):
    """The plain bf16 version against JAX #20 in bf16; bf16 is the default
    ``matmul_dtype``, and it lies far enough from f32 that the rounding rule
    is what the check sees."""
    e_j, f_j = _jax_fused(setup, upd_name, "bf16")
    e, f = _port_fused(setup, upd_name, torch.bfloat16, batch_tile=2)
    assert _rel(e, e_j) <= BF16_TOL and _rel(f, f_j) <= BF16_TOL, (_rel(e, e_j), _rel(f, f_j))
    e_d, f_d = fused_ef.fused_energy_forces(setup["models"][upd_name][1], _t(setup["h"]),
                                            _t(setup["x"]), update=UPDATES[upd_name],
                                            batch_tile=2)
    torch.testing.assert_close((e_d, f_d), (e, f), rtol=0, atol=0)
    f32 = _port_fused(setup, upd_name, None, batch_tile=2)[1]
    assert _rel(f, f32) > 2 * BF16_TOL, _rel(f, f32)


@pytest.mark.parametrize("upd_name", list(UPDATES))
def test_functional_bf16_matches_jax_lax(setup, upd_name):
    """``energy_and_forces_fn`` and ``model_forward`` with ``matmul_dtype=
    torch.bfloat16`` against the JAX functional model in bf16 (lax)."""
    jp, tp = setup["models"][upd_name]
    h, x, upd = setup["h"], setup["x"], UPDATES[upd_name]
    e_j, f_j = jax.jit(lambda p, h_, x_: jax_ef(p, h_, x_, update=upd,
                                                matmul_dtype=jnp.bfloat16))(
        jp, jnp.asarray(h), jnp.asarray(x))
    e, f = functional.energy_and_forces_fn(tp, _t(h), _t(x), update=upd,
                                           matmul_dtype=torch.bfloat16)
    assert _rel(e, e_j) <= BF16_TOL and _rel(f, f_j) <= BF16_TOL, (_rel(e, e_j), _rel(f, f_j))
    out_j, x_j, _ = jax_model_forward(jp, jnp.asarray(h), jnp.asarray(x), update=upd,
                                      matmul_dtype=jnp.bfloat16)
    out, x_out, _ = functional.model_forward(tp, _t(h), _t(x), update=upd,
                                             matmul_dtype=torch.bfloat16)
    assert _rel(out, out_j) <= BF16_TOL and _rel(x_out, x_j) <= BF16_TOL


def test_f32_matches_fori(setup):
    """#20 in f32 and ``fori_energy_forces`` (#21 + #22) compute the same
    function: their plain versions agree at the f32 tolerance."""
    tp = setup["models"]["mixed"][1]
    h, x = _t(setup["h"]), _t(setup["x"])
    e, f = fused_ef.fused_energy_forces(tp, h, x, update=UPDATES["mixed"], batch_tile=1,
                                        matmul_dtype=None)
    e_r, f_r = fori_energy_forces(tp, h, x, update=UPDATES["mixed"])
    torch.testing.assert_close(e, e_r, **TOL)
    torch.testing.assert_close(f, f_r, **TOL)


def test_batch_not_divisible_by_tile_raises(setup):
    with pytest.raises(ValueError, match="batch 4 not divisible by batch_tile 3"):
        _port_fused(setup, "all", None, batch_tile=3)


@pytest.mark.parametrize("call", ["fused_energy_forces", "energy_and_forces_fn",
                                  "model_forward"])
def test_other_matmul_dtypes_raise(setup, call):
    """Only None, f32 and bf16 products exist in the port; f16 raises."""
    tp = setup["models"]["all"][1]
    fn = {"fused_energy_forces": lambda *a, **k: fused_ef.fused_energy_forces(
              *a, batch_tile=1, **k),
          "energy_and_forces_fn": functional.energy_and_forces_fn,
          "model_forward": functional.model_forward}[call]
    with pytest.raises(NotImplementedError):
        fn(tp, _t(setup["h"]), _t(setup["x"]), matmul_dtype=torch.float16)


def test_plain_f32_is_unchanged_by_the_bf16_rule(setup):
    """``matmul_dtype=torch.float32`` is None: the same products, bit for bit."""
    tp = setup["models"]["all"][1]
    a = functional.energy_and_forces_fn(tp, _t(setup["h"]), _t(setup["x"]))
    b = functional.energy_and_forces_fn(tp, _t(setup["h"]), _t(setup["x"]),
                                        matmul_dtype=torch.float32)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)


def test_wrapper_counts_only_card_launches(setup):
    """On CPU tensors the wrapper takes the plain version and leaves its launch
    count alone."""
    before = fused_ef.fused_ef.launches
    _port_fused(setup, "all", torch.bfloat16, batch_tile=1)
    assert fused_ef.fused_ef.launches == before


@pytest.mark.gpu
def test_kernel_matches_plain_on_the_card(setup):
    """#20 on the card against its plain version in both modes, one launch per
    call: f32 at the f32 tolerance, bf16 within 1e-3 of max|plain| and no
    farther from plain than plain bf16 is from plain f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sake_tpu_torch.kernels.functional import params_to

    dev = torch.device("cuda")
    for upd_name in UPDATES:
        tp = params_to(setup["models"][upd_name][1], dev)
        h, x = _t(setup["h"]).to(dev), _t(setup["x"]).to(dev)
        upd = [1.0 if u else 0.0 for u in functional.per_layer(UPDATES[upd_name], DEPTH)]
        ref32 = fused_ef.fused_ef_plain(tp, h, x, upd, n_heads=4, matmul_dtype=None)
        for dtype in (None, torch.bfloat16):
            before = fused_ef.fused_ef.launches
            e, f = fused_ef.fused_energy_forces(tp, h, x, update=UPDATES[upd_name],
                                                batch_tile=1, matmul_dtype=dtype)
            torch.cuda.synchronize()
            assert fused_ef.fused_ef.launches == before + 1
            e_p, f_p = fused_ef.fused_ef_plain(tp, h, x, upd, n_heads=4, matmul_dtype=dtype)
            if dtype is None:
                torch.testing.assert_close(e, e_p, **TOL)
                torch.testing.assert_close(f, f_p, **TOL)
            else:
                assert _rel(f.cpu(), f_p.cpu()) <= max(BF16_TOL, _rel(f_p.cpu(), ref32[1].cpu()))
