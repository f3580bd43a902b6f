"""Hand-written CUDA kernels of the main path and their Python wrappers.

  K3 `gauss_resize.gauss_resize`  pyramid level from the full-res frame
  K6 `gauss.gaussian_blur`        full-res Gaussian, for levels K3 does not take
  K2 `polyexp.poly_exp`           polynomial expansion, optional pre-smooth
  K1 `update_gather.update_blur`  one fused iterate step, box or Gaussian window
  K4 `colorize.flow_to_bgr_planar` flow -> BGR for the visualizer
  K5a `update_gather.update_matrices` displaced fetch + M alone
  K5b `blur_solve.blur_solve`     box or Gaussian window sum of M + solve
  K7 `update_gather.update_blur_poly` K1 with the expansion derived in-kernel
  X1 `resample.resize_bilinear`, `resize_area`, `bilinear_rows`
                                  separable resize by tap tables: the flow's
                                  x2 upsample, the K6 route's resize, the
                                  seed's INTER_AREA downsample, a halo block's
                                  resize
  X2 `magnitude_sum.magnitude_sum` per-pair sums of the flow magnitude
  `fused_iterate.update_flow` drives a level's iterations: K1 for a
  window that fits its tile, K5a -> K5b otherwise;
  `fused_iterate.update_flow_fused_poly` drives K7 where the
  `FUSE_POLYEXP` switch sends a level to it.  K1-K7 replace the JAX
package's Pallas kernels; X1 and X2 the glue it leaves to XLA's fusions.

Each wrapper launches its kernel for a CUDA tensor and runs the plain
version for a CPU tensor; nothing falls back from one to the other.
`LAUNCHES` counts kernel launches (never plain-version calls), so that a
run can show that the main path went through the kernels;
`FIXED_WINDOW` counts those of them that ran an instantiation with the
window built in (K1's at winsize 15), kept apart so that `LAUNCHES`
sums to launches.  `launch_counts` and `add_launches` take both at once
(a captured graph's launches, restored and replayed).  A table the
wrappers make once and keep on the device for their launches to read is
cached by `device_cache`, which hands it also to an open
`hold_device_tables` (a captured CUDA graph's launches read it at every
replay, whatever the cache has evicted since).
"""

import contextlib
import functools
import threading

import torch

LAUNCHES = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5a": 0, "K5b": 0, "K6": 0,
            "K7": 0, "X1": 0, "X2": 0}
FIXED_WINDOW = {"K1": 0}
_COUNTERS = {"launches": LAUNCHES, "fixed_window": FIXED_WINDOW}

# Dynamic shared memory one block may use on Hopper (sm_90).
MAX_SMEM = 227 * 1024


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


_HELD = threading.local()


def device_cache(maxsize):
    """`functools.lru_cache(maxsize)` for a function that returns device
    tables a launch reads by address; while `hold_device_tables` is open
    on the calling thread, each result also goes into its list."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def call(*args):
            out = cached(*args)
            held = getattr(_HELD, "tables", None)
            if held is not None:
                held.append(out)
            return out
        call.cache_clear, call.cache_info = cached.cache_clear, cached.cache_info
        return call
    return wrap


@contextlib.contextmanager
def hold_device_tables():
    """A list of every table a `device_cache` returns on this thread while
    the block runs: whoever keeps the list keeps the tables' memory."""
    held = _HELD.tables = []
    try:
        yield held
    finally:
        _HELD.tables = None


def reset_launches() -> None:
    for counter in _COUNTERS.values():
        for k in counter:
            counter[k] = 0


def launch_counts() -> dict:
    """Both counters as they stand, {(counter, kernel): launches} with
    counter "launches" (`LAUNCHES`) or "fixed_window" (`FIXED_WINDOW`)."""
    return {(name, k): n for name, counter in _COUNTERS.items()
            for k, n in counter.items()}


def add_launches(counts: dict) -> None:
    """Add `counts`, keyed as `launch_counts` keys them, to the counters."""
    for (name, k), n in counts.items():
        _COUNTERS[name][k] += n


def on_cuda(t) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; raises for any
    other device, which has neither a kernel nor a plain path here."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t.device}")
    return t.is_cuda


def check(t, name: str, device, dtypes, ndim: int) -> None:
    """Raise unless `t` is a contiguous tensor of `ndim` dims on `device`
    with a dtype in `dtypes`: what the CUDA kernels take."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def output(out, shape, device, *inputs):
    """`out` checked as a contiguous f32 buffer of `shape` on `device` that
    shares no memory with `inputs`, or a new one when it is None."""
    if out is None:
        return torch.empty(shape, dtype=torch.float32, device=device)
    check(out, "out", device, (torch.float32,), len(shape))
    if tuple(out.shape) != tuple(shape):
        raise ValueError(f"out has shape {tuple(out.shape)}, expected {tuple(shape)}")
    if any(out.data_ptr() == t.data_ptr() for t in inputs):
        raise ValueError("out must be a buffer distinct from the inputs")
    return out


def raise_on_error(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc}")
