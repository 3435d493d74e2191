"""Device ms a CE step of what the program launched under its own span
``pk2/train.backward`` (the backward pass, opened on the thread that runs
it) in the traced steps; none without the program's spans."""

from _common import is_ce


def read(run):
    if not is_ce(run) or run.trace is None:
        return None
    dev_s = run.trace.span_device_s("pk2/train.backward")
    return 1e3 * dev_s / run.trace.steps if dev_s > 0 else None
