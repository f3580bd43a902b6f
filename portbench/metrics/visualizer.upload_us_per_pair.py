"""visualizer.upload_us_per_pair: host microseconds in the program's
`PipelineMetrics` stage `upload` (a frame's copy into pinned memory and
the enqueue of its copy to the card, once a frame), over the frame pairs
the window ran."""


def read(r):
    if "upload" not in r.stages or not r.pairs:
        return None
    return r.stages["upload"][0] * 1e6 / r.pairs
