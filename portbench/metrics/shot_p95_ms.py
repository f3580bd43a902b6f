"""shot_p95_ms: the 95th percentile, over every shot that completed in the
window, of the time from the call of `visualize_frames` to its return
(after the shot's last image was written), in ms."""

import statistics


def read(r):
    lat = [u["t1"] - u["t0"] for u in r.runner.records if u["t1"] <= r.deadline]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3
