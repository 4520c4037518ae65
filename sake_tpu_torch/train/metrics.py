"""Metrics, unit conversions and a JSONL metric logger.

Port of ``sake_tpu/train/metrics.py``.
"""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional

from sake_tpu_torch.utils import bootstrap_mae, mae  # re-export  # noqa: F401

KCAL_PER_MOL = 43.364  # model energy units -> kcal/mol
MEV_PER_EV = 1000.0  # eV -> meV


def format_bootstrap(original: float, low: float, high: float) -> str:
    """``mean_{low}^{high}``, the evaluation report format."""
    return f"{original:.6f}_{{{low:.6f}}}^{{{high:.6f}}}"


class MetricLogger:
    """Append-only JSONL metric stream with wall-clock timestamps."""

    def __init__(self, path: Optional[str] = None, stream: Optional[IO] = None):
        self._file = open(path, "a") if path else None
        self._stream = stream if stream is not None else sys.stdout
        self._t0 = time.time()
        self.records = []  # in-memory copy (programmatic consumers)

    def log(self, step: int, **metrics) -> None:
        rec = {"step": int(step), "t": round(time.time() - self._t0, 3), **metrics}
        self.records.append(rec)
        line = json.dumps(rec)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        else:
            print(line, file=self._stream, flush=True)

    def close(self) -> None:
        if self._file:
            self._file.close()
