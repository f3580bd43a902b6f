"""extractor.upload_gb_per_s: the bytes of frames the program copied into
pinned slots (its counter `staged_bytes`, added once a frame inside the
stage `upload`) over the seconds of the stage `upload`, in GB/s.  None
where the program keeps no such counter."""


def read(r):
    staged = r.runner.program.metrics.counters.get("staged_bytes")
    if staged is None or "upload" not in r.stages or r.stages["upload"][0] <= 0:
        return None
    return staged / r.stages["upload"][0] * 1e-9
