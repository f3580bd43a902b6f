"""extractor.flow_stage_us_per_window: host microseconds in the program's
`PipelineMetrics` stage `flow` (stacking a chunk's frames and enqueueing
its pyramid and sums), over the windows (frame pairs) the window ran."""


def read(r):
    if "flow" not in r.stages or not r.pairs:
        return None
    return r.stages["flow"][0] * 1e6 / r.pairs
