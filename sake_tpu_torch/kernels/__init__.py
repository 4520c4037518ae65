"""The port's hand-written CUDA kernels and their functional reference forms.

The names of the JAX package's ``sake_tpu.kernels.__all__``, every one.
"""

from sake_tpu_torch.kernels.functional import (
    ModelParams,
    LayerParams,
    CFConvParams,
    model_forward,
    energy_and_forces_fn,
)
from sake_tpu_torch.kernels.adapter import (
    model_params_from_linen,
    layer_params_from_linen,
)
from sake_tpu_torch.kernels.dispatch import dispatch_energy_forces
from sake_tpu_torch.kernels.fori_ef import fori_energy_forces
from sake_tpu_torch.kernels.fused_ef import fused_energy_forces
from sake_tpu_torch.kernels.one_ef import one_energy_forces
from sake_tpu_torch.kernels.resid_ef import make_hidden_fn, resid_energy_forces
from sake_tpu_torch.kernels.train_ef import make_trainable_energy_forces

__all__ = [
    "ModelParams",
    "LayerParams",
    "CFConvParams",
    "model_forward",
    "energy_and_forces_fn",
    "model_params_from_linen",
    "layer_params_from_linen",
    "dispatch_energy_forces",
    "fused_energy_forces",
    "fori_energy_forces",
    "one_energy_forces",
    "resid_energy_forces",
    "make_hidden_fn",
    "make_trainable_energy_forces",
]
