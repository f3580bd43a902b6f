"""extractor.graph_replay_pct: the share of the extractor's chunk
dispatches (its counter `dispatches`, one a chunk sent to the device) that
a captured CUDA graph served (its counter `graph_replays`), in %.  None
where the program keeps no such counters, or dispatched nothing."""


def read(r):
    counters = r.runner.program.metrics.counters
    dispatches = counters.get("dispatches")
    if not dispatches or "graph_replays" not in counters:
        return None
    return 100.0 * counters["graph_replays"] / dispatches
