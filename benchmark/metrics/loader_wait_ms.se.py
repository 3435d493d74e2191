"""Host ms an SE step waited on the loader (``SeqDataloader`` through
``device_batches``): the host clock around each fetch of a batch in the
window, mean a step."""


def read(run):
    waits = run.window.loader_waits_s
    if run.mix.get("driver") != "se_otf" or not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
