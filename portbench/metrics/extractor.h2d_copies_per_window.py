"""extractor.h2d_copies_per_window: host-to-device copies the trace shows
in the window, over the windows (frame pairs) it ran."""


def read(r):
    if r.trace is None or not r.pairs:
        return None
    return len(r.trace.copies("HtoD")) / r.pairs
