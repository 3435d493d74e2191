"""% of the lattice forward-backward's roofline (K7 forward, K8 backward,
and the gathers and sums around them): the least time of the work the
traced steps' lattices need, over the device time of what was launched under
the harness's spans around ``mmi_objective_lattice_ts`` and its backward.

Work a frame of an utterance (fp32, counted for its valid links L and its
slots K): K7 6 operations a link and 8 a slot, K8 14 a link and 8 a slot;
bytes: each link's score, weight and two slot ids read forward and again
backward (32 B) and its occupancy written (4 B), each slot's forward score
written and read back (8 B)."""

import peaks

OPS_LINK, OPS_SLOT = 6 + 14, 8 + 8
BYTES_LINK, BYTES_SLOT = 36, 8


def work(links: float, slot_frames: float) -> tuple:
    """(bytes, fp32 operations) of the forward-backward."""
    return (BYTES_LINK * links + BYTES_SLOT * slot_frames,
            OPS_LINK * links + OPS_SLOT * slot_frames)


def read(run):
    if run.mix.get("driver") != "se_otf" or run.trace is None:
        return None
    dev_s = run.trace.span_device_s("latfb.fwd", "latfb.bwd")
    if dev_s <= 0 or run.traced_links <= 0:
        return None
    nbytes, ops = work(run.traced_links, run.traced_frames * run.config["max_active"])
    least, _ = peaks.least_seconds(nbytes, [(ops, peaks.FP32_FLOPS)])
    return 100.0 * least / dev_s
