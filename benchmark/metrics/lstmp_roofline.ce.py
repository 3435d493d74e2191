"""% of the LSTMP stack's roofline (K5/K6 and its input products): the
least time its forward and backward FLOPs (bf16 peak) or bytes could take,
over the device time of what was launched under the harness's spans around
the stack's forward and its backward, in the traced steps."""

from _common import is_ce, stack_roofline


def read(run):
    if not is_ce(run) or not run.config.get("proj_size", 0):
        return None
    return stack_roofline(run)
