"""Device ms a CE step of what was launched under the harness's span around
``Optimizer.step`` (the global-norm clip, then torch.optim's Adam)."""

from _common import is_ce


def read(run):
    if not is_ce(run) or run.trace is None:
        return None
    dev_s = run.trace.span_device_s("optimizer")
    return 1e3 * dev_s / run.trace.steps if dev_s > 0 else None
