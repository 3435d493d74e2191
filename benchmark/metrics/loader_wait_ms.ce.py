"""Host ms a CE step waited on the loader (``ChunkDataloader`` behind
``device_prefetch``): the host clock around each fetch of a batch in the
window, mean a step."""

from _common import is_ce


def read(run):
    waits = run.window.loader_waits_s
    if not is_ce(run) or not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
