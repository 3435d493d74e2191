"""Device ms a step of the search (``DeviceSearch.__call__``, a CUDA-graph
replay of the frame loop) and the band's compaction (``_compact_band``):
CUDA events around the two calls in the window, mean a step."""


def read(run):
    ms = run.window.search_ms
    if run.mix.get("driver") != "se_otf" or not ms:
        return None
    return sum(ms) / len(ms)
