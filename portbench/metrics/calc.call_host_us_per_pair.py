"""calc.call_host_us_per_pair: host microseconds inside the harness's
calls of `calc_flow_batched` (the trace's `portbench/calc_flow_batched`
spans: the enqueue of a call's pyramid, not the wait for its flow), over
the frame pairs the window's clips ran.  None without a trace or without
such spans."""

SPAN = "portbench/calc_flow_batched"


def read(r):
    if r.trace is None or not r.pairs:
        return None
    ns = sum(o.end - o.start for o in r.trace.spans if o.name == SPAN)
    if ns <= 0:
        return None
    return ns * 1e-3 / r.pairs
