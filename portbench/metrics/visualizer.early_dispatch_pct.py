"""visualizer.early_dispatch_pct: the share of the program's dispatches
(its counter `dispatches`, one a chunk sent to the device) that its pixel
budget made before the chunk cap or the end of a shot (its counter
`early_dispatches`), in %.  None where the program keeps no such counters,
or dispatched nothing."""


def read(r):
    counters = r.runner.program.metrics.counters
    dispatches = counters.get("dispatches")
    if not dispatches or "early_dispatches" not in counters:
        return None
    return 100.0 * counters["early_dispatches"] / dispatches
