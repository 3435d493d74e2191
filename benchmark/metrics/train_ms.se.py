"""Device ms an SE step of what the program launched under its own spans
``pk2/train.forward``, ``pk2/train.backward`` and ``pk2/optimizer.step``
(the lattice train step, without the eval forward and the search) in the
traced steps; none without the program's spans."""

SPANS = ("pk2/train.forward", "pk2/train.backward", "pk2/optimizer.step")


def read(run):
    if run.mix.get("driver") != "se_otf" or run.trace is None:
        return None
    dev_s = run.trace.span_device_s(*SPANS)
    return 1e3 * dev_s / run.trace.steps if dev_s > 0 else None
