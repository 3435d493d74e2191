"""Device ms a CE step of what the program launched under its own span
``pk2/train.forward`` (``make_ce_train_step``: the front end, the model's
forward and the loss) in the traced steps. The program enters its spans as
``record_function``s while a profiler records; a program without them
leaves this metric out."""

from _common import is_ce


def read(run):
    if not is_ce(run) or run.trace is None:
        return None
    dev_s = run.trace.span_device_s("pk2/train.forward")
    return 1e3 * dev_s / run.trace.steps if dev_s > 0 else None
