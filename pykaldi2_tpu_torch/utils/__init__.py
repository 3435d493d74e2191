"""Utilities: logging/metrics, checkpointing, optimizers and LR schedules.

Port of pykaldi2_tpu/utils (reference behavior: pykaldi2/utils/ and the
per-epoch checkpoints and rank-0 logging in bin/train_*.py).
"""

from pykaldi2_tpu_torch.utils.logging import MetricsLogger, setup_logging
from pykaldi2_tpu_torch.utils.checkpoint import (latest_checkpoint, load_checkpoint,
                                                 save_checkpoint)
from pykaldi2_tpu_torch.utils.lr import PlateauAnnealer, make_optimizer
