"""visualizer.pinned_alloc_us_per_pair: microseconds CUDA's caching host
allocator spent growing its pinned pool (the program's counter
`pinned_alloc_us`, from `torch.cuda.host_memory_stats()` once a call of
`visualize_frames`: the frames' uploads and the chunks' downloads), over
the frame pairs the window ran."""


def read(r):
    us = r.runner.program.metrics.counters.get("pinned_alloc_us")
    if us is None or not r.pairs:
        return None
    return us / r.pairs
