"""% of the bf16 peak that the CE window's model FLOPs reach: three times
the forward's FLOPs a frame (stack and output layer) times the labelled
frames trained, over the window's seconds, over 989 TFLOP/s."""

import peaks
from _common import is_ce
from _shapes import model_forward_flops


def read(run):
    w = run.window
    if not is_ce(run) or w.seconds <= 0 or w.frames <= 0:
        return None
    flops = 3.0 * model_forward_flops(run.config, run.config["num_mel_bins"]) * w.frames
    return 100.0 * flops / w.seconds / peaks.BF16_FLOPS
