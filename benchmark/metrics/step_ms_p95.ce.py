"""95th percentile (nearest rank) of the CE train step's ms on the device's
timeline: the intervals between CUDA events recorded at each step's start in
the window, the last one closed by an event after it."""

import math

from _common import is_ce


def read(run):
    ms = sorted(run.window.step_ms)
    if not is_ce(run) or not ms:
        return None
    return ms[max(0, math.ceil(0.95 * len(ms)) - 1)]
