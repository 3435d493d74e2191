"""% of the bf16 peak that the SE window's model FLOPs reach: four times the
forward's FLOPs a frame (the eval forward the search reads, then the train
forward and its backward; nothing of the search) times the utterances'
frames trained, over the window's seconds, over 989 TFLOP/s."""

import peaks
from _shapes import model_forward_flops


def read(run):
    w = run.window
    if run.mix.get("driver") != "se_otf" or w.seconds <= 0 or w.frames <= 0:
        return None
    flops = 4.0 * model_forward_flops(run.config, run.config["num_mel_bins"]) * w.frames
    return 100.0 * flops / w.seconds / peaks.BF16_FLOPS
