"""extractor.drain_us_per_window: host microseconds in the program's
`PipelineMetrics` stage `drain` (the wait for a chunk's sums on the host
and their hand-off to the caller), over the windows (frame pairs) the
window ran."""


def read(r):
    if "drain" not in r.stages or not r.pairs:
        return None
    return r.stages["drain"][0] * 1e6 / r.pairs
