"""Readings shared by this folder's readers."""

from __future__ import annotations

import peaks
from _shapes import stack_bytes, stack_flops


def is_ce(run) -> bool:
    return run.mix.get("driver") == "ce_train"


def stack_roofline(run):
    """% of the recurrent stack's least time, from its shapes, over the
    device time of what was launched under the stack's spans; None where the
    trace holds none of it."""
    if run.trace is None:
        return None
    dev_s = run.trace.span_device_s("lstm.fwd", "lstm.bwd")
    if dev_s <= 0.0:
        return None
    dim = run.config["num_mel_bins"]
    nbytes = stack_bytes(run.config, dim, run.traced_frames, run.trace.steps)
    flops = stack_flops(run.config, dim, run.traced_frames)
    least, _ = peaks.least_seconds(nbytes, [(flops, peaks.BF16_FLOPS)])
    return 100.0 * least / dev_s
