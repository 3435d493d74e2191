"""% of the traced window of SE steps in which no kernel, copy or set ran on
the device."""


def read(run):
    if run.mix.get("driver") != "se_otf" or run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
