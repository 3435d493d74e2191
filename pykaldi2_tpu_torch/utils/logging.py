"""Structured JSONL metrics + stdlib logging setup.

Reference behavior: pykaldi2 logs per-N-batch loss/frame-acc/throughput via
print/logging, rank-0 only (SURVEY.md §6.5). We keep the same scalars (so
loss parity is checkable) but emit machine-readable JSONL alongside.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Optional


def setup_logging(exp_dir: Optional[str] = None, rank: int = 0, name: str = "pykaldi2_tpu_torch"):
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO if rank == 0 else logging.WARNING)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s [%(levelname)s] %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if exp_dir and rank == 0:
        os.makedirs(exp_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(exp_dir, "train.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class MetricsLogger:
    """Append-only JSONL metrics stream (rank 0 writes, others no-op).

    Optional TensorBoard mirror (SURVEY.md §6.5 "JSONL + optional
    tensorboard"): set ``tensorboard=True`` (or env ``PK2_TENSORBOARD=1``)
    to also emit event files under ``exp_dir/tb/``. Degrades to JSONL-only
    when the tensorboard package is absent. The scalar names match the
    reference's logged quantities so loss curves compare directly.
    """

    def __init__(self, exp_dir: Optional[str], rank: int = 0,
                 filename: str = "metrics.jsonl",
                 tensorboard: Optional[bool] = None):
        self._f = None
        self._tb = None
        self._step = 0
        if exp_dir is not None and rank == 0:
            os.makedirs(exp_dir, exist_ok=True)
            self._f = open(os.path.join(exp_dir, filename), "a")
            if tensorboard is None:
                tensorboard = os.environ.get("PK2_TENSORBOARD", "") not in ("", "0")
            if tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter

                    self._tb = SummaryWriter(os.path.join(exp_dir, "tb"))
                except ImportError:
                    logging.getLogger("pykaldi2_tpu_torch").warning(
                        "PK2_TENSORBOARD set but tensorboard is unavailable; "
                        "JSONL metrics only")
        self._t0 = time.time()

    def log(self, **scalars):
        if self._f is None:
            return
        rec = {"time": round(time.time() - self._t0, 3)}
        for k, v in scalars.items():
            rec[k] = float(v) if hasattr(v, "__float__") else v
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            step = int(rec.get("step", self._step))
            self._step = max(self._step, step) + 1
            for k, v in rec.items():
                if k not in ("time", "step", "epoch") and isinstance(v, float):
                    self._tb.add_scalar(k, v, step)
            self._tb.flush()

    def close(self):
        if self._f:
            self._f.close()
        if self._tb is not None:
            self._tb.close()
