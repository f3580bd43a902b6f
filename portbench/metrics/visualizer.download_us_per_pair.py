"""visualizer.download_us_per_pair: host microseconds in the program's
`PipelineMetrics` stage `download` (waiting for a chunk's BGR on the copy
stream), over the frame pairs the window ran."""


def read(r):
    if "download" not in r.stages or not r.pairs:
        return None
    return r.stages["download"][0] * 1e6 / r.pairs
