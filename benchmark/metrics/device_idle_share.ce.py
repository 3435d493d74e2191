"""% of the traced window of CE steps in which no kernel, copy or set ran on
the device."""

from _common import is_ce


def read(run):
    if not is_ce(run) or run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
