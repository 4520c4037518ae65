"""Training: state, optimizer chains, epoch loops and metrics. Port of
``sake_tpu/train`` (checkpoints are not ported yet)."""

from sake_tpu_torch.train import metrics
from sake_tpu_torch.train.loop import run_epoch, shuffle_batches
from sake_tpu_torch.train.optim import make_optimizer, notfinite_count, warmup_cosine_schedule
from sake_tpu_torch.train.state import TrainState, tree_leaves

__all__ = [
    "TrainState",
    "make_optimizer",
    "metrics",
    "notfinite_count",
    "run_epoch",
    "shuffle_batches",
    "tree_leaves",
    "warmup_cosine_schedule",
]
