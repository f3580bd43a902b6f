#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one CUDA card.

Run from the repo root on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--profile]

It builds the ten CUDA kernels from `optical_flow_tpu_torch/csrc/`
(one nvcc per source, in parallel) and holds each against its plain
PyTorch version at the shapes of the 1080p B=16 paths (the K1 and K3
lines also carry ptxas's registers, spills and shared memory per kernel
and the blocks resident per SM; K5a, K5b and K1,
box and Gaussian, also at one 4320x7680 level; K6 at the two levels of a
five-level 1080p pyramid that K3 does not take, with ptxas's report and
its occupancy, and at 3 to 159 taps, uint8 and f32, on 1080x1920, 37x1001
and a frame within the radius; K4 at B=16 and B=1 on 1080x1920 and
1079x1917 and on all-zero frames; K2 also at poly_n 7 and 11; K5b,
box and Gaussian, at winsize 15 and at winsize 63, where its path runs
it; K7, box and Gaussian, at every level and at L0 on a ±60 px flow,
equal to K2 -> K1 to the bit, with the share of its M pixels that took
the per-pixel path, ptxas's report and its occupancy at both tile
widths; K2 and K5b with ptxas's report too; X1, the resample that
replaces the JAX package's fused resize glue, equal to the bit at the
three x2 upsamples, the seed's downsample read in its (B, H, W, 2)
layout, the levels=5 resizes, the 72x129 B=128 chunk's upsample and two
8K halo row blocks, each with its device time and the launch plan it
took; X2, the per-pair magnitude sum, within one f32 ulp at 1080p B=16
and 72x129 B=128, equal across runs and batch sizes, with its device
time beside the library's),
and holds K5a -> K5b equal to K1 to the bit at every level, with the box
window and, per iterate step on the pyramid's own flow, with the
Gaussian one; both are timed (`ab_K1_vs_K5a_K5b_*`), as are K7 x 3
against K2 + K1 x 3 per level on the pyramid's own flow at 1080p B=16
and 72x129 B=128 (`ab_K7_vs_K2_K1`); the K1 line's occupancy covers
both instantiations, the run-time one and the one with winsize 15 built
in.  Then it drives the
extractor's path, `magnitude_sums` / `calc_flow_batched`, at 1080x1920
(with FUSE_POLYEXP off and on: `e2e_fused_poly_1080p`, every level on
K7) and at the extractor's 72x129, the extractor's device loop
`extract_frames` on in-memory 25 fps clips (`e2e_extractor_loop`: 4000
frames at 72x129, 200 at 1080x1920; launches, the sums and the CSV line
against the plain path's, FUSE_POLYEXP's sums, the 72x129 chunks' captured
dispatch replayed), the visualizer's device loop
(`pipeline/visualizer.py:visualize_frames`: chained pyramid, K4 colorize,
download) on 17 frames at 1080x1920 fed from memory, the Gaussian window
(flags 256), the seeded entry (flags 4, `calc_flow` and
`calc_flow_batched` from a noisy true flow), a box window beyond K1's
tile (winsize 63, K5a -> K5b) and a five-level pyramid (levels=5, K6 on
L4 and L5) at 1080x1920, and bench.py's 8K row (4320x7680, B=1).  Each
path is checked against the plain path on the card, the true shift and,
where the file has it, the JAX package's golden numbers
(`tests/data/torch_port_golden.json`), and both paths are timed.  Then
the mesh (`parallel/`), on meshes whose device list repeats the one card:
`mesh_dp_1080p` (a 2x1 mesh, 17 pairs of an 18-frame chain at 1080x1920:
`sharded_flow_step`, the extractor's mesh branch, `sharded_bgr_chain_step`
over `chain_shards` and the visualizer's loop through the mesh, each equal
to the one-device entry to the bit) and `mesh_sp_8k` (a 1x2 mesh, the 8K
pair through the halo stages, K6, K2, K5a and K5b, held to the one-device
flow by the flow gate and to the true flow; and the cross-seam update,
fetches past the 32-row halo, against K5a at atol 1e-4).  Then
the package's own tools: `selftest` (`utils/selftest.py:run_selftest`,
every kernel against its plain version over the JAX self test's shape
classes, K7 at the iterate's spills, the full pyramid on
`vertical_jump_pair` at 1080p; it must be ok), `warmup_1080p` (the
extractor's, the visualizer's and the flow's warmers at 1080p source
frames: the chunk each launched at, its seconds and its peak device
memory beside the card's total) and `cold_start` (the warmup CLI in
three fresh processes: cold with an empty kernel cache, then packing it;
warm on the same cache; restored from the pack into an empty cache:
wall seconds and nvcc runs each, 0 required for the last two).
Kernels build into `build/<hash>/` of the checkout unless
OFT_COMPILE_CACHE names another directory.
--profile adds `profile_1080p`, `profile_deep_1080p`,
`profile_winsize63_1080p`, `profile_8k` and `profile_72x129`: the device
time per kernel, the kernels launched and the host-to-device copies per
call and the device share of the 1080p flow call under flags 0, 256 and 4,
with levels=5 and with winsize 63, of the 8K pair and of the extractor's
72x129 chunk (torch.profiler).  --profile-only builds, runs the X1 and X2
kernel phases (`kernel_X1`, `kernel_X2`: their checks, event and device
times) and then the profile phases, and prints no result line.
One JSON line per phase; then the card's nvidia-smi line, the kernels
summary (each kernel's launches on the paths, its error against its
plain version, its time, its plain version's, the bound of its bytes or
operations on an H100 SXM and, where one PyTorch call computes the same
function, that call's time) and, last, {"ok": true, "device": {...}}.
Any failed check raises: the script then exits non-zero and prints no
result.  It refuses to run without a CUDA card.  It imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_port_golden.json"
SHIFT = (2, 3)            # (dy, dx) of smooth_texture_pair: true flow (-3, -2)
TRUE_FLOW = (-3.0, -2.0)
BATCH = 16
CROP = 32
WARMUP, TIMED, PROFILED = 3, 10, 5
KERNEL_TOL = {"K3": (1e-4, 1e-5), "K2": (1e-4, 1e-5), "K1": (1e-3, 1e-3),
              "K5a": (1e-4, 1e-5), "K5b": (1e-3, 1e-3), "K6": (0.0, 0.0),
              "K7": (1e-3, 1e-3), "X1": (0.0, 0.0)}
EPE_GATE = 0.5            # BASELINE.md's interior EPE gate, px
WIDE = (4320, 7680)       # wider than the TPU kernels' 4096-column window
WIDE_WINDOW = 63          # a box beyond K1's tile: the window K5b runs
SHIFT_8K = (3, 5)         # bench.py's 8K row: true flow (-5, -3)
# Peaks of one H100 SXM, for each kernel's bound: HBM3 bytes/s (NVIDIA's
# data sheet) and f32 operations/s outside the tensor cores.  The data
# sheet's 67e12 counts a fused multiply-add as two operations; every
# kernel here is built with --fmad=false and the work_* functions count
# each multiply and each add, so one counted operation is one issued
# instruction: 132 SMs x 128 f32 lanes x 1.98 GHz = 33.5e12 a second.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 33.5e12
BGR_SHARE = 1e-3          # at most this share of bytes 1 level off (and none more)
GOLDEN_BGR_SHARE = 1e-2   # sampled bytes that may differ from the JAX golden file
KERNEL_INFO = {
    "K3": ("gauss_resize", "optical_flow_tpu_torch/csrc/gauss_resize.cu",
           "optical_flow_tpu/pallas/gauss_resize.py:345"),
    "K2": ("polyexp", "optical_flow_tpu_torch/csrc/polyexp.cu",
           "optical_flow_tpu/pallas/polyexp.py:645"),
    "K1": ("update_blur", "optical_flow_tpu_torch/csrc/update_blur.cu",
           "optical_flow_tpu/pallas/update_gather.py:956"),
    "K4": ("colorize", "optical_flow_tpu_torch/csrc/colorize.cu",
           "optical_flow_tpu/pallas/colorize.py:125"),
    "K5a": ("update_matrices", "optical_flow_tpu_torch/csrc/update_matrices.cu",
            "optical_flow_tpu/pallas/update_gather.py:1851"),
    "K5b": ("blur_solve", "optical_flow_tpu_torch/csrc/blur_solve.cu",
            "optical_flow_tpu/pallas/blur_solve.py:194"),
    "K6": ("gauss", "optical_flow_tpu_torch/csrc/gauss.cu",
           "optical_flow_tpu/pallas/gauss.py:107"),
    "K7": ("update_blur_poly", "optical_flow_tpu_torch/csrc/update_blur_poly.cu",
           "optical_flow_tpu/pallas/update_gather.py:1145"),
    # the glue the JAX package leaves to XLA's fusions (no pl.pallas_call)
    "X1": ("resample", "optical_flow_tpu_torch/csrc/resample.cu",
           "optical_flow_tpu/models/farneback/flow.py:296"),
    "X2": ("magnitude_sum", "optical_flow_tpu_torch/csrc/magnitude_sum.cu",
           "optical_flow_tpu/pipeline/extractor.py:113"),
}


def x2_launches(h: int, w: int) -> int:
    """The kernels one X2 call launches on pairs of h x w pixels: the span
    sums, and the combine past one span of 2^17 pixels (`SPAN` in
    `csrc/magnitude_sum.cu`)."""
    return 1 if h * w <= 1 << 17 else 2


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def errors(got, ref):
    """(max abs error, max relative error) of got against ref."""
    d = (got - ref).abs()
    return float(d.max()), float((d / ref.abs().clamp_min(1e-30)).max())


def require_close(name: str, got, ref, atol: float, rtol: float) -> None:
    bad = int(((got - ref).abs() > atol + rtol * ref.abs()).sum())
    require(bad == 0, f"{name}: {bad} values outside atol={atol} rtol={rtol}")


def require_bgr_close(name: str, got, ref) -> dict:
    """At most 1 level apart, on at most BGR_SHARE of the bytes."""
    d = (got.int() - ref.int()).abs()
    share = float((d > 0).float().mean())
    require(int(d.max()) <= 1 and share <= BGR_SHARE,
            f"{name}: max diff {int(d.max())}, {share} of the bytes differ")
    return {"max_diff": int(d.max()), "share_differing": share}


def median_s(fn, warmup: int = WARMUP, timed: int = TIMED) -> float:
    """Median wall seconds of fn over `timed` runs after `warmup`, each
    ended by torch.cuda.synchronize()."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn over `reps` back-to-back runs, after one
    warm-up run (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device time of fn's kernels over `reps` runs, after one
    warm-up run: the sum of the CUDA events' device time in a
    torch.profiler trace, so the host's time between launches is left
    out (cuda_ms counts it where the launches do not queue up).  A trace
    that caught no device event (it happens now and then) is taken
    again, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ms = sum(device_events(prof, reps)["by_name"].values())
        if ms > 0:
            return ms
    raise RuntimeError("check failed: no device time traced")


def host_us(fn, reps: int = 200) -> float:
    """Mean host microseconds of one call of fn, launches enqueued and not
    waited for (a shape whose kernels take less than the call keeps the
    queue short)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def frames(h: int, w: int, dev, batch: int = BATCH, shift=SHIFT):
    import torch
    from optical_flow_tpu_torch.oracle.synthetic import smooth_texture_pair
    f1, f2 = smooth_texture_pair(h, w, shift)
    prev = torch.as_tensor(np.broadcast_to(f1, (batch, h, w)).copy()).to(dev)
    nxt = torch.as_tensor(np.broadcast_to(f2, (batch, h, w)).copy()).to(dev)
    return prev, nxt


def seed_flow(n: int, h: int, w: int) -> np.ndarray:
    """The seeded phase's initial flow, (n, h, w, 2) f32: the true flow plus
    0.5 px of normal noise from np.random.default_rng(1), as
    tests/make_torch_port_golden.py:seed_flow (its first pair is the
    golden entry's seed)."""
    noise = np.random.default_rng(1).standard_normal((n, h, w, 2))
    return (np.asarray(TRUE_FLOW) + 0.5 * noise).astype(np.float32)


def random_flow(shape, gen, dev):
    """Displacements up to 6 px: many fetches leave the image near the
    borders and the gather is far from the identity."""
    import torch
    return (torch.rand(shape, generator=gen, device=dev) - 0.5) * 12.0


# The least work of each kernel's function, from its shapes: (bytes, f32
# operations).  Bytes read each input once and write each output once;
# operations count each multiply and add of the function's arithmetic
# once (none of a kernel's halo recompute).
M_OPS = 36        # displaced fetch + M per pixel (update_matrices.cuh)
SOLVE_OPS = 19    # scale + 2x2 solve per pixel


def bound(work) -> tuple:
    """(ms, "bytes" or "operations"): the least time of `work` = (bytes,
    ops) on an H100 SXM, the larger of bytes over HBM's rate and ops over
    the unfused f32 issue rate."""
    t_b = work[0] / HBM_BYTES_PER_S * 1e3
    t_o = work[1] / F32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def pixels(t) -> int:
    """Pixels of an (N, C, H, W) or (N, H, W) batch, channels aside."""
    return t.shape[0] * t.shape[-2] * t.shape[-1]


def work_level(img, ntaps: int, oh: int, ow: int) -> tuple:
    """K3: the frame read once, the level written; vertical sums at two
    source rows per output row over the frame's width, four horizontal
    sums and the two lerps per output pixel."""
    n, _, w = img.shape
    out = n * oh * ow
    return (img.numel() * img.element_size() + 4 * out,
            n * 2 * oh * w * 2 * ntaps + out * (4 * 2 * ntaps + 6))


def work_blur(img, ntaps: int) -> tuple:
    """K6: the frame read and the f32 blur written; a multiply and an add
    per tap and pass."""
    return img.numel() * (img.element_size() + 4), img.numel() * 4 * ntaps


def work_polyexp(img, poly_n: int, pre: bool) -> tuple:
    """K2: the frame read and R (5 f32) written; three vertical and six
    horizontal correlations of 2n + 1 taps, the combination, and the
    3x3 pre-smooth at level 0."""
    ops = 18 * (2 * poly_n + 1) + 9 + (20 if pre else 0)
    return img.numel() * (img.element_size() + 20), img.numel() * ops


def window_ops(winsize: int, gaussian: bool) -> int:
    """Per pixel, five channels' separable window sums: adds alone for the
    box, a multiply and an add per tap for the Gaussian window."""
    m = winsize // 2
    return 10 * (4 * m + 1) if gaussian else 20 * m


def work_step(flow, winsize: int, gaussian: bool) -> tuple:
    """K1: R0 and the flow read, the R1 gather, the new flow written
    (56 B/px); M, the window sums and the solve."""
    px = pixels(flow)
    return 56 * px, px * (M_OPS + window_ops(winsize, gaussian) + SOLVE_OPS)


def work_step_poly(img0, flow, winsize: int, gaussian: bool, poly_n: int,
                   pre: bool) -> tuple:
    """K7: the two level images read, the flow read and written; K2's
    operations on both images, then K1's."""
    return (2 * img0.numel() * img0.element_size() + 16 * pixels(flow),
            2 * work_polyexp(img0, poly_n, pre)[1] + work_step(flow, winsize, gaussian)[1])


def work_matrices(flow) -> tuple:
    """K5a: K1's reads and M written (68 B/px)."""
    return 68 * pixels(flow), M_OPS * pixels(flow)


def work_blur_solve(flow, winsize: int, gaussian: bool) -> tuple:
    """K5b: M read, the flow written (28 B/px); the window sums, the solve."""
    px = pixels(flow)
    return 28 * px, px * (window_ops(winsize, gaussian) + SOLVE_OPS)


def work_resample(x, iy, ix, vertical_first: bool) -> tuple:
    """X1 with the tap tables' indices iy (dh, Ty) and ix (dw, Tx): the
    source pixels the taps reach read once (a downsample by bilinear taps
    reaches a few rows and columns of each step), the f32 output written
    once; the two passes' multiplies and adds (each first-pass value made
    once, over the rows or columns the taps reach), and the scale."""
    n = x.numel() // (x.shape[-2] * x.shape[-1])
    (dh, ty), (dw, tx) = iy.shape, ix.shape
    rows, cols = len(np.unique(iy)), len(np.unique(ix))
    inter = n * (dh * cols * (2 * ty - 1) if vertical_first else rows * dw * (2 * tx - 1))
    out = n * dh * dw
    return (n * rows * cols * 4 + out * 4,
            inter + out * 2 * (tx if vertical_first else ty))


def work_magnitude_sum(flow) -> tuple:
    """X2: the planar flow read once, the sums written; two multiplies, an
    add and a sqrt a pixel (the f64 sum aside)."""
    return flow.numel() * 4 + flow.shape[0] * 4, 4 * pixels(flow)


def library_blur(taps, dev):
    """One PyTorch call of K6's function, as a yardstick that the port
    never calls: reflect pad + two cuDNN conv2d (TF32 off)."""
    import torch
    import torch.nn.functional as F
    t = torch.as_tensor(np.asarray(taps, np.float32), device=dev)
    r = len(taps) // 2

    def blur(img):
        x = F.pad(img.float()[:, None], (r, r, r, r), mode="reflect")
        x = F.conv2d(x, t.view(1, 1, -1, 1))
        return F.conv2d(x, t.view(1, 1, 1, -1))[:, 0]
    return blur


def library_level(taps, oh: int, ow: int, dev):
    """K3's yardstick: the blur above + F.interpolate (bilinear,
    half-pixel centres, as cv2's INTER_LINEAR)."""
    import torch.nn.functional as F
    blur = library_blur(taps, dev)
    return lambda img: F.interpolate(blur(img)[:, None], size=(oh, ow), mode="bilinear",
                                     align_corners=False)[:, 0]


def library_polyexp(poly_n: int, poly_sigma: float, pre_taps, dev):
    """K2's yardstick, the same function in PyTorch calls (TF32 off):
    reflect pad + a 3x3 conv2d for the pre-smooth, replicate pad + one
    conv2d for the three vertical correlations, replicate pad + one
    grouped conv2d for the six horizontal ones (three a group, one of the
    nine unused), and the combine."""
    import torch
    import torch.nn.functional as F
    from optical_flow_tpu_torch.models.farneback.params import poly_exp_weights
    g, xg, xxg, ig11, ig03, ig33, ig55 = poly_exp_weights(poly_n, poly_sigma)
    n = poly_n
    vert = torch.as_tensor(np.stack([g, xg, xxg]), device=dev).view(3, 1, 2 * n + 1, 1)
    horiz = torch.as_tensor(np.stack([g, xg, xxg] * 3), device=dev).view(9, 1, 1, 2 * n + 1)
    pre = None if pre_taps is None else torch.as_tensor(
        np.outer(pre_taps, pre_taps).astype(np.float32), device=dev).view(1, 1, 3, 3)
    ig11, ig03, ig33, ig55 = (float(np.float32(v)) for v in (ig11, ig03, ig33, ig55))

    def expand(img):
        x = img.float()[:, None]
        if pre is not None:
            x = F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), pre)
        x = F.conv2d(F.pad(x, (0, 0, n, n), mode="replicate"), vert)
        x = F.conv2d(F.pad(x, (n, n, 0, 0), mode="replicate"), horiz, groups=3)
        # row0 x (g, xg, xxg) = b1, b2, b4; row1 x (g, xg) = b3, b6; row2 x g = b5
        b1, b2, b4, b3, b6, b5 = x[:, 0], x[:, 1], x[:, 2], x[:, 3], x[:, 4], x[:, 6]
        return torch.stack([b3 * ig11, b2 * ig11, b1 * ig03 + b5 * ig33,
                            b1 * ig03 + b4 * ig33, b6 * ig55], dim=1)
    return expand


def library_box_solve(winsize: int):
    """K5b's box yardstick: replicate pad + avg_pool2d, then the solve."""
    import torch.nn.functional as F
    from optical_flow_tpu_torch.models.farneback import core
    m = winsize // 2
    return lambda M: core.solve_flow(
        F.avg_pool2d(F.pad(M, (m, m, m, m), mode="replicate"), winsize, stride=1), 1.0)


def run_cases(kid: str, cases, stats, key=None, phase=None, device_time=False,
              **extra) -> None:
    """Each (label, kernel fn, plain fn, work, library fn or None) case:
    the kernel against its plain version within KERNEL_TOL[kid], then
    kernel, plain version and library call timed with CUDA events (with
    device_time, kernel and library call also by their device time in a
    profile: `device_ms`, `library_device_ms`), and the bound of `work`
    (bytes, ops).  Sums over the pyramid levels (labels "L<k>...") and
    the largest error over every case go to stats[key or kid]; one JSON
    line."""
    import torch
    atol, rtol = KERNEL_TOL[kid]
    levels, max_abs = [], 0.0
    sums = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    if device_time:
        sums.update(device_ms=0.0, library_device_ms=0.0)
    by_time = {"bytes": 0.0, "operations": 0.0}
    has_library = True
    for label, kern_fn, plain_fn, work, lib_fn in cases:
        got, ref = kern_fn(), plain_fn()
        torch.cuda.synchronize()
        require_close(f"{kid} {label}", got, ref, atol, rtol)
        ea, er = errors(got, ref)
        row = {"level": label, "shape": list(got.shape), "max_abs_err": ea,
               "max_rel_err": er, "ms": cuda_ms(kern_fn, 10),
               "plain_ms": cuda_ms(plain_fn, 3)}
        row["bound_ms"], row["bound_by"] = bound(work)
        row["library_ms"] = None if lib_fn is None else cuda_ms(lambda: lib_fn(), 10)
        if device_time:
            row["device_ms"] = device_ms(kern_fn, 10)
            row["library_device_ms"] = None if lib_fn is None else device_ms(lib_fn, 10)
            row["device_bound_share"] = row["bound_ms"] / row["device_ms"]
        levels.append(row)
        if label.startswith("L"):
            for k in sums:
                sums[k] += row[k] or 0.0
            by_time[row["bound_by"]] += row["bound_ms"]
            has_library = has_library and lib_fn is not None
        max_abs = max(max_abs, ea)
        del got, ref
    stats[key or kid] = {**sums, "max_abs_err": max_abs,
                         "bound_by": max(by_time, key=by_time.get),
                         "library_ms": sums["library_ms"] if has_library else None}
    if device_time:
        extra.update(device_ms_sum=sums["device_ms"],
                     library_device_ms_sum=sums["library_device_ms"] if has_library else None)
    emit(phase or f"kernel_{kid}", name=KERNEL_INFO[kid][0], atol=atol, rtol=rtol,
         levels=levels, ms_sum=sums["ms"], plain_ms_sum=sums["plain_ms"],
         bound_ms_sum=sums["bound_ms"],
         bound_share=sums["bound_ms"] / sums["ms"] if sums["ms"] else None, **extra)


def ptxas_report(name: str) -> list:
    """What ptxas says of each kernel of csrc/<name>.cu (registers a
    thread, spill bytes, static shared memory), from a build with
    -Xptxas -v into a scratch file beside the built libraries."""
    from optical_flow_tpu_torch.kernels import _build
    out = _build.build_dir() / f"ptxas_{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    log = subprocess.run(_build.nvcc_command(name, out) + ["-Xptxas", "-v"],
                         capture_output=True, text=True, timeout=600, check=True)
    out.unlink(missing_ok=True)
    rows, entry = [], None
    for line in (log.stdout + log.stderr).splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            # the kernel's own name and template arguments, after the
            # anonymous namespace's mangled prefix
            cut = re.search(r"_cu_[0-9a-f]{8}\d+", name)
            entry = {"kernel": (name[cut.end():] if cut else name)[:60]}
            rows.append(entry)
        elif entry is not None and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            entry["stack_bytes"], entry["spill_store_bytes"], entry["spill_load_bytes"] = nums[:3]
        elif entry is not None and "Used" in line and "registers" in line:
            words = line.replace(",", " ").split()
            entry["registers"] = int(words[words.index("Used") + 1])
            entry["static_smem_bytes"] = next(
                (int(words[i - 2]) for i, w in enumerate(words) if w == "smem"), 0)
    return rows


def occupancy_k1(winsize: int, dev) -> dict:
    """K1's dynamic shared memory per block and resident blocks per SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), box and Gaussian,
    of the run-time instantiation and, where the window is the one built
    in (`k1_fixed`), of the fixed one ("box_fixed", "gaussian_fixed")."""
    import ctypes
    from optical_flow_tpu_torch.kernels import _build
    from optical_flow_tpu_torch.kernels.update_gather import k1_fixed
    f = _build.library("update_blur").oft_update_blur_occupancy
    out = {}
    for fixed in (0, 1) if k1_fixed(winsize) else (0,):
        for gauss in (0, 1):
            blocks, smem = ctypes.c_int(), ctypes.c_int()
            require(f(winsize // 2, gauss, fixed, dev.index, ctypes.byref(blocks),
                      ctypes.byref(smem)) == 0, "K1 occupancy query")
            key = ("gaussian" if gauss else "box") + ("_fixed" if fixed else "")
            out[key] = {"smem_bytes": smem.value, "blocks_per_sm": blocks.value}
    return out


def occupancy_k3(src_u8: bool, smem: int, dev) -> int:
    """K3's resident blocks per SM at `smem` bytes of shared memory."""
    import ctypes
    from optical_flow_tpu_torch.kernels import _build
    blocks = ctypes.c_int()
    f = _build.library("gauss_resize").oft_gauss_resize_occupancy
    require(f(int(src_u8), smem, dev.index, ctypes.byref(blocks)) == 0,
            "K3 occupancy query")
    return blocks.value


def kernel_phases(prev, nxt, cfg, stats) -> None:
    """Each kernel against its plain version at the 1080p B=16 shapes; K1
    and K3 also with ptxas's report and their occupancy."""
    import torch
    from optical_flow_tpu_torch.kernels import gauss_resize as k3
    from optical_flow_tpu_torch.kernels import update_gather as k1
    from optical_flow_tpu_torch.kernels.gauss_resize import gauss_resize
    from optical_flow_tpu_torch.kernels.polyexp import poly_exp
    from optical_flow_tpu_torch.kernels.update_gather import update_blur
    from optical_flow_tpu_torch.models.farneback import core
    from optical_flow_tpu_torch.models.farneback.params import (build_plan,
                                                                gaussian_kernel)
    both = torch.cat([prev, nxt])
    dev = both.device
    plan = build_plan(prev.shape[1], prev.shape[2], cfg)
    imgs = {}
    k3_cases = []
    for lv in plan.levels:
        if lv.k == 0:
            continue
        kern = gaussian_kernel(lv.smooth_ksize, lv.smooth_sigma)
        imgs[lv.k] = gauss_resize(both, kern, lv.width, lv.height)
        lib = library_level(kern, lv.height, lv.width, dev)
        k3_cases.append((f"L{lv.k}",
                         lambda kern=kern, lv=lv: gauss_resize(both, kern, lv.width, lv.height),
                         lambda kern=kern, lv=lv: core.gaussian_blur_resize(both, kern, lv.width,
                                                                            lv.height),
                         work_level(both, len(kern), lv.height, lv.width),
                         lambda lib=lib: lib(both)))
    k3_tiles = {}
    for lv in (lv for lv in plan.levels if lv.k > 0):
        tw, th, _, _, _, smem = k3._tile(lv.smooth_ksize, *both.shape[1:], lv.height,
                                         lv.width, both.element_size())
        k3_tiles[f"L{lv.k}"] = {"tile": [tw, th], "smem_bytes": smem,
                                "blocks_per_sm": occupancy_k3(True, smem, dev)}
    run_cases("K3", k3_cases, stats, ptxas=ptxas_report("gauss_resize"),
              tiles=k3_tiles)

    Rs = {}
    k2 = []
    lib_err = {}
    for lv in plan.levels:
        if lv.k == 0:
            src, pre = both, gaussian_kernel(lv.smooth_ksize, lv.smooth_sigma)
        else:
            src, pre = imgs[lv.k], None
        Rs[lv.k] = poly_exp(src, cfg.poly_n, cfg.poly_sigma, pre_taps=pre)
        lib = library_polyexp(cfg.poly_n, cfg.poly_sigma, pre, dev)
        # the yardstick computes the same function (cuDNN sums in its own
        # order): its largest difference from K2, against R's largest value
        lib_err[f"L{lv.k}"] = [float((lib(src) - Rs[lv.k]).abs().max()),
                               float(Rs[lv.k].abs().max())]
        k2.append((f"L{lv.k}",
                   lambda src=src, pre=pre: poly_exp(src, cfg.poly_n, cfg.poly_sigma, pre_taps=pre),
                   lambda src=src, pre=pre: core.poly_exp(src, cfg.poly_n, cfg.poly_sigma, pre_taps=pre),
                   work_polyexp(src, cfg.poly_n, pre is not None),
                   lambda src=src, lib=lib: lib(src)))
    # cv2's other poly_n (the kernel's other compiled n) and one beyond the
    # kernel's former cap of poly_n 10 (the n read at run time), at level
    # 0's shape
    pre = gaussian_kernel(3, 0.0)
    for n, sigma in ((7, 1.5), (11, 2.4)):
        k2.append((f"poly_n{n}_level0",
                   lambda n=n, sigma=sigma: poly_exp(both, n, sigma, pre_taps=pre),
                   lambda n=n, sigma=sigma: core.poly_exp(both, n, sigma, pre_taps=pre),
                   work_polyexp(both, n, True), None))
    run_cases("K2", k2, stats, ptxas=ptxas_report("polyexp"),
              library_max_abs_diff_and_max_abs_ref=lib_err)

    gen = torch.Generator(device=dev).manual_seed(0)
    k1_cases = []
    flows = {}
    for lv in plan.levels:
        R = Rs[lv.k]
        B = R.shape[0] // 2
        flow = flows[lv.k] = random_flow((B, 2, lv.height, lv.width), gen, dev)
        k1_cases.append((f"L{lv.k}",
                         lambda R=R, B=B, flow=flow: update_blur(R[:B], R[B:], flow, cfg.winsize),
                         lambda R=R, B=B, flow=flow: core.update_step(R[:B], R[B:], flow,
                                                                      cfg.winsize),
                         work_step(flow, cfg.winsize, False), None))
    run_cases("K1", k1_cases, stats, ptxas=ptxas_report("update_blur"),
              occupancy=occupancy_k1(cfg.winsize, dev),
              rows_per_block={f"L{lv.k}": k1._rows_per_block(
                  prev.shape[0], lv.height, lv.width, dev) for lv in plan.levels})
    kernel_k7_phase(both, imgs, Rs, flows, plan, cfg, stats)
    del imgs
    unfused_phases(Rs, flows, plan, cfg.winsize, stats)
    ab_gauss_phase(Rs, flows, plan, cfg, stats)
    del Rs, flows
    torch.cuda.empty_cache()
    kernel_k6_phase(both, stats)


def occupancy_k7(cfg, dev) -> dict:
    """K7's dynamic shared memory per block and resident blocks per SM at
    each tile width, uint8 with the pre-smooth (level 0) and f32, box and
    Gaussian, at the config's winsize and poly_n."""
    import ctypes
    from optical_flow_tpu_torch.kernels import _build
    from optical_flow_tpu_torch.kernels.update_gather import _k7_plan
    f = _build.library("update_blur_poly").oft_update_blur_poly_occupancy
    out = {}
    for tile_w in (32, 64):
        if _k7_plan(cfg.winsize, cfg.poly_n, tile_w) is None:
            continue
        for u8 in (1, 0):
            for gauss in (0, 1):
                blocks, smem = ctypes.c_int(), ctypes.c_int()
                require(f(cfg.winsize // 2, cfg.poly_n, gauss, u8, u8, tile_w, dev.index,
                          ctypes.byref(blocks), ctypes.byref(smem)) == 0,
                        "K7 occupancy query")
                out[f"{tile_w}x32_{'u8_pre' if u8 else 'f32'}_{'gaussian' if gauss else 'box'}"] = {
                    "smem_bytes": smem.value, "blocks_per_sm": blocks.value}
    return out


def k7_paths(img0, img1, flow, winsize, gaussian, cfg, pre) -> dict:
    """How K7's M pixels took R1 on these inputs (the counted entry at the
    default tile): the counts and the share that took the per-pixel path."""
    import torch
    from optical_flow_tpu_torch.kernels.update_gather import update_blur_poly_counted
    got, counts = update_blur_poly_counted(img0, img1, flow, winsize, gaussian,
                                           cfg.poly_n, cfg.poly_sigma, pre)
    torch.cuda.synchronize()
    del got
    return {**counts, "per_pixel_share": counts["per_pixel"] / max(counts["m_pixels"], 1)}


def kernel_k7_phase(both, imgs, Rs, flows, plan, cfg, stats) -> None:
    """K7 against its plain version at every level of the 1080p B=16
    pyramid (L0: the uint8 frames with the pre-smooth; L1-L3: K3's f32
    levels), box and Gaussian, on the random ±6 px flow, and at L0 on a
    ±60 px one (`spread60_L0`, whose fetch boxes are cut: both paths);
    and against K2 -> K1 on the same inputs (K2's R of the level, then
    K1): equal to the bit.  Per case the share of M pixels on the
    per-pixel path; with the box window, ptxas's report and the
    occupancy."""
    import torch
    from optical_flow_tpu_torch.kernels.update_gather import (update_blur,
                                                              update_blur_poly)
    from optical_flow_tpu_torch.models.farneback import core
    from optical_flow_tpu_torch.models.farneback.params import gaussian_kernel

    B = both.shape[0] // 2
    n, sigma = cfg.poly_n, cfg.poly_sigma
    gen = torch.Generator(device=both.device).manual_seed(60)
    spread = (torch.rand((B, 2) + both.shape[1:], generator=gen, device=both.device)
              - 0.5) * 120.0
    for gaussian in (False, True):
        cases, vs_k2_k1, shares = [], 0.0, {}
        for lv in plan.levels:
            if lv.k == 0:
                src, pre = both, gaussian_kernel(lv.smooth_ksize, lv.smooth_sigma)
            else:
                src, pre = imgs[lv.k], None
            img0, img1, R = src[:B], src[B:], Rs[lv.k]
            level_cases = [(f"L{lv.k}", flows[lv.k])]
            if lv.k == 0:
                level_cases.append(("spread60_L0", spread))
            for label, flow in level_cases:
                got = update_blur_poly(img0, img1, flow, cfg.winsize, gaussian, n, sigma, pre)
                ref = update_blur(R[:B], R[B:], flow, cfg.winsize, gaussian)
                torch.cuda.synchronize()
                vs_k2_k1 = max(vs_k2_k1, float((got - ref).abs().max()))
                require(torch.equal(got, ref),
                        f"K7 != K2 -> K1 at {label} (gaussian={gaussian}): max diff {vs_k2_k1}")
                del got, ref
                shares[label] = k7_paths(img0, img1, flow, cfg.winsize, gaussian, cfg, pre)
                cases.append((
                    label,
                    lambda a=img0, b=img1, f=flow, p=pre, g=gaussian:
                        update_blur_poly(a, b, f, cfg.winsize, g, n, sigma, p),
                    lambda a=img0, b=img1, f=flow, p=pre, g=gaussian:
                        core.update_step_poly(a, b, f, cfg.winsize, g, n, sigma, p),
                    work_step_poly(img0, flow, cfg.winsize, gaussian, n, pre is not None),
                    None))
        window = "gaussian" if gaussian else "box"
        extra = ({"ptxas": ptxas_report("update_blur_poly"),
                  "occupancy": occupancy_k7(cfg, both.device)}
                 if not gaussian else {})
        run_cases("K7", cases, stats, key="K7_gaussian" if gaussian else None,
                  window=window, max_abs_err_vs_k2_k1=vs_k2_k1, paths=shares, **extra)
    del spread
    stats["K7"]["max_abs_err"] = max(stats["K7"]["max_abs_err"],
                                     stats["K7_gaussian"]["max_abs_err"])


def ab_k7_phase(name: str, h: int, w: int, batch: int, cfg, dev, power) -> None:
    """Per level of the pyramid, the level's `iterations` steps on the
    pyramid's own flow: K7 x iterations against K2 on both frames + K1 x
    iterations, equal to the bit, each timed twice in one call (K7 first,
    then K2 + K1 first), with the share of K7's M pixels that took the
    per-pixel path in the first step.  A level shape where K7 is faster
    in both runs may go to K7 by default (`fused_iterate.use_fused_poly`)."""
    import torch
    from optical_flow_tpu_torch.kernels import fused_iterate
    from optical_flow_tpu_torch.kernels.polyexp import poly_exp
    from optical_flow_tpu_torch.models.farneback.flow import _level_images
    from optical_flow_tpu_torch.models.farneback.params import (build_plan,
                                                                gaussian_kernel)
    from optical_flow_tpu_torch.ops.resize import resize_bilinear_f32

    prev, nxt = frames(h, w, dev, batch)
    both = torch.cat([prev, nxt])
    del prev, nxt
    plan = build_plan(h, w, cfg)
    its, win, gauss = cfg.iterations, cfg.winsize, cfg.gaussian_window
    reps = 5 if h >= 1080 else 50
    rows, flow = [], None
    for lv in plan.levels:
        kern = gaussian_kernel(lv.smooth_ksize, lv.smooth_sigma)
        imgs, pre = ((both, kern) if lv.k == 0
                     else (_level_images(both, kern, lv.width, lv.height), None))
        img0, img1 = imgs[:batch], imgs[batch:]
        if flow is None:
            flow = torch.zeros((batch, 2, lv.height, lv.width), device=dev)
        else:
            flow = resize_bilinear_f32(flow, lv.width, lv.height)
            flow = flow * float(np.float32(1.0 / cfg.pyr_scale))

        def k7(img0=img0, img1=img1, flow=flow, pre=pre):
            return fused_iterate.update_flow_fused_poly(
                img0, img1, flow, win, its, gauss, poly_n=cfg.poly_n,
                poly_sigma=cfg.poly_sigma, pre_taps=pre)

        def k2_k1(imgs=imgs, flow=flow, pre=pre):
            R = poly_exp(imgs, cfg.poly_n, cfg.poly_sigma, pre_taps=pre)
            return fused_iterate.update_flow_fused(R[:batch], R[batch:], flow, win,
                                                   its, gauss)

        fused, split = k7(), k2_k1()
        torch.cuda.synchronize()
        require(torch.equal(fused, split),
                f"{name}: K7 x {its} != K2 + K1 x {its} at L{lv.k}: max diff "
                f"{float((fused - split).abs().max())}")
        t_k7 = [cuda_ms(k7, reps)]
        t_split = [cuda_ms(k2_k1, reps)]
        t_split.append(cuda_ms(k2_k1, reps))
        t_k7.append(cuda_ms(k7, reps))
        rows.append({"level": f"L{lv.k}", "shape": [batch, lv.height, lv.width],
                     "bit_equal": True, "k7_ms": t_k7, "k2_k1_ms": t_split,
                     "paths_first_step": k7_paths(img0, img1, flow, win, gauss, cfg, pre),
                     "k7_faster_both_runs": all(a < b for a, b in zip(t_k7, t_split)),
                     "route": "K7" if fused_iterate.use_fused_poly(win, cfg.poly_n)
                     else "K2_K1"})
        flow = split
        del fused, imgs
    emit(name, h=h, w=w, batch=batch, iterations=its, winsize=win, levels=rows,
         k7_ms_sum=[sum(r["k7_ms"][i] for r in rows) for i in range(2)],
         k2_k1_ms_sum=[sum(r["k2_k1_ms"][i] for r in rows) for i in range(2)],
         fuse_polyexp=fused_iterate.FUSE_POLYEXP, card=power)


def unfused_phases(Rs, flows, plan, winsize: int, stats) -> None:
    """K5a and K5b (box and Gaussian window) against their plain versions
    at every level of the 1080p B=16 path and at one 4320x7680 B=1 level,
    K1 (box and Gaussian) at that level too, and K5a -> K5b (box) against
    K1: equal to the bit, both timed."""
    import torch
    from optical_flow_tpu_torch.kernels.blur_solve import blur_solve
    from optical_flow_tpu_torch.kernels.polyexp import poly_exp
    from optical_flow_tpu_torch.kernels.update_gather import (update_blur,
                                                              update_matrices)
    from optical_flow_tpu_torch.models.farneback import core

    dev = flows[0].device
    ops = {}     # label -> (R0, R1, flow)
    for lv in plan.levels:
        R, B = Rs[lv.k], Rs[lv.k].shape[0] // 2
        ops[f"L{lv.k}"] = (R[:B], R[B:], flows[lv.k])
    gen = torch.Generator(device=dev).manual_seed(2)
    h, w = WIDE
    wide = torch.randint(0, 256, (2, h, w), generator=gen, device=dev,
                         dtype=torch.uint8)
    Rw = poly_exp(wide, 5, 1.2)
    del wide
    wide_label = f"wide_{h}x{w}_B1"
    ops[wide_label] = (Rw[:1], Rw[1:], random_flow((1, 2, h, w), gen, dev))

    run_cases("K5a", [(label, lambda o=o: update_matrices(*o),
                       lambda o=o: core.update_matrices(*o), work_matrices(o[2]), None)
                      for label, o in ops.items()], stats)
    Ms = {label: update_matrices(*o) for label, o in ops.items()}
    # the config's winsize at every level and the 8K one (K5b's former
    # line, and the operands of ab_K1_vs_K5a_K5b_*), then winsize 63 at
    # every 1080p level: the window K5b runs on its path (K1 takes the
    # others); the kernels line gives winsize 63's box
    ptxas = ptxas_report("blur_solve")
    keys = []
    for ws in (winsize, WIDE_WINDOW):
        for gaussian in (False, True):
            window = "gaussian" if gaussian else "box"
            lib = None if gaussian else library_box_solve(ws)
            key = f"K5b_{window}_{ws}"
            keys.append(key)
            run_cases("K5b", [(label, lambda M=M, g=gaussian, ws=ws: blur_solve(M, ws, g),
                               lambda M=M, g=gaussian, ws=ws: core.blur_solve(M, ws, g),
                               work_blur_solve(M, ws, gaussian),
                               None if lib is None else lambda M=M, lib=lib: lib(M))
                              for label, M in Ms.items()
                              if ws == winsize or label.startswith("L")],
                      stats, key=key, phase=f"kernel_K5b_{window}", window=window,
                      winsize=ws, **({"ptxas": ptxas} if key == f"K5b_box_{WIDE_WINDOW}" else {}))
    stats["K5b"] = {**stats[f"K5b_box_{WIDE_WINDOW}"],
                    "max_abs_err": max(stats[k]["max_abs_err"] for k in keys)}
    del Ms

    # K1 at the 8K level, the TPU's column-chunked K8 territory
    R0w, R1w, fw = ops[wide_label]
    run_cases("K1", [(f"{wide_label}_{'gaussian' if g else 'box'}",
                      lambda g=g: update_blur(R0w, R1w, fw, winsize, g),
                      lambda g=g: core.update_step(R0w, R1w, fw, winsize, g),
                      work_step(fw, winsize, g), None) for g in (False, True)],
              stats, key="K1_wide", phase="kernel_K1_wide", winsize=winsize)
    stats["K1"]["max_abs_err"] = max(stats["K1"]["max_abs_err"],
                                     stats["K1_wide"]["max_abs_err"])

    rows = []
    for label, (R0, R1, rough) in ops.items():
        if label.startswith("wide"):
            continue
        # the random flow above, and the smooth one the pyramid iterates
        # on: the true flow at the level's scale, where neighbouring
        # pixels fetch neighbouring R1 values
        k = int(label[1:])
        smooth = torch.empty_like(rough)
        smooth[:, 0], smooth[:, 1] = TRUE_FLOW[0] / 2 ** k, TRUE_FLOW[1] / 2 ** k
        M = torch.empty(R0.shape, dtype=torch.float32, device=dev)
        for flow_kind, flow in (("random_6px", rough), ("uniform_true", smooth)):
            unfused = blur_solve(update_matrices(R0, R1, flow, out=M), winsize, False)
            fused = update_blur(R0, R1, flow, winsize)
            torch.cuda.synchronize()
            require(torch.equal(unfused, fused),
                    f"K5a -> K5b (box) != K1 at {label}, {flow_kind} flow: max diff "
                    f"{float((unfused - fused).abs().max())}")
            t_k1 = cuda_ms(lambda: update_blur(R0, R1, flow, winsize, out=fused), 10)
            t_a = cuda_ms(lambda: update_matrices(R0, R1, flow, out=M), 10)
            t_b = cuda_ms(lambda: blur_solve(M, winsize, False, out=unfused), 10)
            t_ab = cuda_ms(lambda: blur_solve(update_matrices(R0, R1, flow, out=M),
                                              winsize, False, out=unfused), 10)
            px = flow.shape[0] * flow.shape[2] * flow.shape[3]
            rows.append({"level": label, "flow": flow_kind, "shape": list(flow.shape),
                         "bit_equal": True, "k1_ms": t_k1, "k5a_ms": t_a,
                         "k5b_ms": t_b, "k5a_k5b_ms": t_ab,
                         # 56 B/px for K1, 96 B/px for K5a + K5b (PERF.md)
                         "k1_gb_per_s_at_56_b_per_px": 56 * px / t_k1 / 1e6,
                         "k5_gb_per_s_at_96_b_per_px": 96 * px / t_ab / 1e6})
            del unfused, fused
        del M, smooth
    sums = {kind: {"k1_ms_sum": sum(r["k1_ms"] for r in rows if r["flow"] == kind),
                   "k5a_k5b_ms_sum": sum(r["k5a_k5b_ms"] for r in rows if r["flow"] == kind)}
            for kind in ("random_6px", "uniform_true")}
    emit("ab_K1_vs_K5a_K5b_box", winsize=winsize, levels=rows, sums=sums)


def ab_gauss_phase(Rs, flows, plan, cfg, stats) -> None:
    """K1 with the Gaussian window against K5a -> K5b with it, per level on
    the random flow and per iterate step on the pyramid's own flow: the
    flows that the Gaussian pyramid (flags 256) feeds its 12 steps on
    this pair, recorded by iterating it here.  K1 is held to its plain
    version and to the pair (to the bit); both are timed.  The sums over
    the 12 own-flow steps are what the choice in
    `fused_iterate.update_flow` rests on (PERF.md)."""
    import torch
    from optical_flow_tpu_torch.kernels.blur_solve import blur_solve
    from optical_flow_tpu_torch.kernels.update_gather import (k1_fits, update_blur,
                                                              update_matrices)
    from optical_flow_tpu_torch.models.farneback import core
    from optical_flow_tpu_torch.ops.resize import resize_bilinear_f32

    winsize = cfg.winsize
    atol, rtol = KERNEL_TOL["K1"]
    cases = []          # (label, flow kind, step, R0, R1, flow)
    flow = None
    for lv in plan.levels:
        R, B = Rs[lv.k], Rs[lv.k].shape[0] // 2
        R0, R1 = R[:B], R[B:]
        cases.append((f"L{lv.k}", "random_6px", None, R0, R1, flows[lv.k]))
        if flow is None:
            flow = torch.zeros_like(flows[lv.k])
        else:
            flow = resize_bilinear_f32(flow, lv.width, lv.height)
            flow = flow * float(np.float32(1.0 / cfg.pyr_scale))
        for step in range(cfg.iterations):
            cases.append((f"L{lv.k}", "pyramid_own", step, R0, R1, flow))
            flow = update_blur(R0, R1, flow, winsize, True)
    del flow
    rows, max_abs = [], 0.0
    for label, kind, step, R0, R1, flow in cases:
        M = torch.empty(R0.shape, dtype=torch.float32, device=flow.device)
        fused = update_blur(R0, R1, flow, winsize, True)
        unfused = blur_solve(update_matrices(R0, R1, flow, out=M), winsize, True)
        plain = core.update_step(R0, R1, flow, winsize, True)
        torch.cuda.synchronize()
        require(torch.equal(fused, unfused),
                f"K5a -> K5b (Gaussian) != K1 at {label} step {step}, {kind} flow: "
                f"max diff {float((fused - unfused).abs().max())}")
        require_close(f"K1 Gaussian {label} {kind}", fused, plain, atol, rtol)
        max_abs = max(max_abs, errors(fused, plain)[0])
        del plain
        t_k1 = cuda_ms(lambda: update_blur(R0, R1, flow, winsize, True, out=fused), 10)
        t_ab = cuda_ms(lambda: blur_solve(update_matrices(R0, R1, flow, out=M),
                                          winsize, True, out=unfused), 10)
        rows.append({"level": label, "flow": kind, "step": step,
                     "shape": list(flow.shape), "bit_equal": True,
                     "k1_ms": t_k1, "k5a_k5b_ms": t_ab,
                     "k1_bound_ms": bound(work_step(flow, winsize, True))[0]})
        del M, fused, unfused
    stats["K1"]["max_abs_err"] = max(stats["K1"]["max_abs_err"], max_abs)
    sums = {kind: {"k1_ms_sum": sum(r["k1_ms"] for r in rows if r["flow"] == kind),
                   "k5a_k5b_ms_sum": sum(r["k5a_k5b_ms"] for r in rows if r["flow"] == kind)}
            for kind in ("random_6px", "pyramid_own")}
    own = sums["pyramid_own"]
    emit("ab_K1_vs_K5a_K5b_gauss", winsize=winsize, levels=rows, sums=sums,
         k1_max_abs_err_vs_plain=max_abs,
         faster_on_pyramid_own_flow="K1" if own["k1_ms_sum"] <= own["k5a_k5b_ms_sum"]
         else "K5a_K5b",
         rule="K1" if k1_fits(winsize) else "K5a_K5b")


def occupancy_k6(ntaps: int, w: int, dev) -> dict:
    """K6's block (kernels/gauss.py:tile), its dynamic shared memory and
    the blocks resident per SM, uint8 and f32."""
    import ctypes
    from optical_flow_tpu_torch.kernels import _build
    from optical_flow_tpu_torch.kernels.gauss import tile
    ty, tx = tile(ntaps, w)
    f = _build.library("gauss").oft_gauss_occupancy
    out = {"rows": ty, "columns": tx}
    for u8 in (1, 0):
        blocks, smem = ctypes.c_int(), ctypes.c_int()
        require(f(u8, ntaps, ty, tx, dev.index, ctypes.byref(blocks),
                  ctypes.byref(smem)) == 0, "K6 occupancy query")
        out["uint8" if u8 else "f32"] = {"smem_bytes": smem.value,
                                         "blocks_per_sm": blocks.value}
    return out


def kernel_k6_phase(both, stats) -> None:
    """K6 at the two levels of the five-level 1080p pyramid that K3 does
    not take (L4: 39 taps, L5: 79), on the (32, 1080, 1920) uint8 frames
    of the B=16 pairs: equal to its plain version (max abs error 0); the
    sum over those two levels is the kernels line's.  Then, at 3 taps and
    at the 39, 79 and 159 that the pyramids send to K6 up to 4320x7680,
    uint8 and f32, two frames of 1080x1920, of 37x1001 and of a height
    within the radius (more than one reflection)."""
    import torch
    from optical_flow_tpu_torch.kernels.gauss import gaussian_blur
    from optical_flow_tpu_torch.kernels.gauss_resize import k3_fits
    from optical_flow_tpu_torch.models.farneback import core
    from optical_flow_tpu_torch.models.farneback.params import (build_plan,
                                                                gaussian_kernel)
    from optical_flow_tpu_torch.utils.config import FarnebackConfig

    def case(label, img, kern, lib=True):
        blur = library_blur(kern, img.device) if lib else None
        return (label, lambda: gaussian_blur(img, kern),
                lambda: core.gaussian_blur_reflect101(img, kern),
                work_blur(img, len(kern)), None if blur is None else lambda: blur(img))

    _, h, w = both.shape
    cases, occupancy = [], {}
    for lv in build_plan(h, w, FarnebackConfig(levels=5)).levels:
        if lv.k == 0 or k3_fits(lv.smooth_ksize, h, w, lv.width):
            continue
        kern = gaussian_kernel(lv.smooth_ksize, lv.smooth_sigma)
        cases.append(case(f"L{lv.k}_{len(kern)}taps", both, kern))
        occupancy[f"{len(kern)}taps"] = occupancy_k6(len(kern), w, both.device)
    require(len(cases) > 0, "no level of the five-level pyramid goes to K6")
    gen = np.random.default_rng(6)
    for ntaps in (3, 39, 79, 159):
        kern = gaussian_kernel(ntaps, (ntaps - 1) / 5)
        for fh, fw in ((h, w), (37, 1001), (max(1, ntaps // 2), 300)):
            u8 = torch.as_tensor(gen.integers(0, 256, (2, fh, fw), dtype=np.uint8),
                                 device=both.device)
            for img in (u8, u8.float() / 7.0 - 3.0):
                dt = "u8" if img.dtype == torch.uint8 else "f32"
                # the library call pads by r on each side, which reflect
                # refuses past the frame's side
                cases.append(case(f"{ntaps}taps_{dt}_{fh}x{fw}", img, kern,
                                  lib=min(fh, fw) > ntaps // 2))
    run_cases("K6", cases, stats, ptxas=ptxas_report("gauss"), occupancy=occupancy)


def x1_path(x, ytab, xtab, vertical_first: bool) -> dict:
    """The launch plan X1's host picks for x and the tables
    (`kernels/resample.py:plan`): path, load width, tile, staged band and
    shared memory."""
    from optical_flow_tpu_torch.kernels import resample
    return resample.plan(x, ytab, xtab, vertical_first)._asdict()


def kernel_x1_phase(dev, stats) -> None:
    """X1 against its plain version, to the bit, at the shapes of the
    1080p B=16 paths: the flow's three x2 upsamples with their scale
    (labels L2, L1, L0: the level made; the kernels line's sum), the
    seed's INTER_AREA downsample to L3 read in its (B, H, W, 2) layout,
    the levels=5 pyramid's two resizes after K6 (of the (32, 1080, 1920)
    f32 blur), the extractor's 72x129 B=128 chunk's upsample and the halo
    path's row-block resizes at 8K (mesh_sp_8k's second block).
    Library: F.interpolate (bilinear with half-pixel centres, or area)
    times the scale.  Each case is timed with events and by its device
    time (`device_ms`), and names the launch plan its host picked
    (`paths`); `host_us` is the host's time of one launch at the L2 and
    72x129 upsamples, and of `resample.plan` alone at L2 (`L2_plan`)."""
    import torch
    import torch.nn.functional as F
    from optical_flow_tpu_torch.kernels import resample
    from optical_flow_tpu_torch.kernels.resample import area_plan, resize_area, resize_bilinear
    from optical_flow_tpu_torch.models.farneback.params import build_plan
    from optical_flow_tpu_torch.ops.resize import (_area_taps, _coeffs_f32, bilinear_taps,
                                                   coeff_tensors, resize_area_f32,
                                                   resize_bilinear_f32)
    from optical_flow_tpu_torch.ops.resize import bilinear_rows as bilinear_rows_plain
    from optical_flow_tpu_torch.utils.config import FarnebackConfig

    gen = torch.Generator(device=dev).manual_seed(13)
    cases, paths, host = [], {}, {}

    def bilinear(label, x, dh, dw, scale):
        cases.append((label, lambda: resize_bilinear(x, dw, dh, scale),
                      lambda: resize_bilinear_f32(x, dw, dh) * scale,
                      work_resample(x, bilinear_taps(x.shape[-2], dh)[0],
                                    bilinear_taps(x.shape[-1], dw)[0], False),
                      lambda: F.interpolate(x if x.dim() == 4 else x[:, None], size=(dh, dw),
                                            mode="bilinear", align_corners=False) * scale))
        paths[label] = x1_path(x, resample._table("bilinear", x.shape[-2], dh, dev),
                               resample._table("bilinear", x.shape[-1], dw, dev), False)

    levels = build_plan(1080, 1920, FarnebackConfig()).levels
    for coarse, fine in zip(levels, levels[1:]):
        flow = random_flow((BATCH, 2, coarse.height, coarse.width), gen, dev)
        bilinear(f"L{fine.k}", flow, fine.height, fine.width, 2.0)
        if fine.k == 2:
            host["L2"] = host_us(lambda: resize_bilinear(flow, fine.width, fine.height, 2.0))
            ytab = resample._table("bilinear", coarse.height, fine.height, dev)
            xtab = resample._table("bilinear", coarse.width, fine.width, dev)
            host["L2_plan"] = host_us(lambda: resample.plan(flow, ytab, xtab, False))
    seed = torch.as_tensor(seed_flow(BATCH, 1080, 1920)).to(dev).movedim(-1, 1)
    l3 = levels[0]
    plan = area_plan(1080, 1920, l3.height, l3.width)
    require(len(plan) == 1, f"X1: the seed's downsample takes {len(plan)} launches")
    label = f"seed_area_L{l3.k}_strided"
    cases.append((label, lambda: resize_area(seed, l3.width, l3.height, 0.125),
                  lambda: resize_area_f32(seed, l3.width, l3.height) * 0.125,
                  work_resample(seed, _area_taps(1080, l3.height)[0],
                                _area_taps(1920, l3.width)[0], True),
                  lambda: F.interpolate(seed, size=(l3.height, l3.width), mode="area") * 0.125))
    paths[label] = x1_path(seed, resample._table(*plan[0][0], dev),
                           resample._table(*plan[0][1], dev), True)
    blurred = torch.rand((2 * BATCH, 1080, 1920), generator=gen, device=dev) * 255.0
    for lv in build_plan(1080, 1920, FarnebackConfig(levels=5)).levels:
        if lv.k >= 4:
            bilinear(f"deep5_resize_L{lv.k}", blurred, lv.height, lv.width, 1.0)
    coarse, fine = build_plan(72, 129, FarnebackConfig()).levels
    chunk = random_flow((128, 2, coarse.height, coarse.width), gen, dev)
    bilinear(f"chunk72x129_B128_L{fine.k}", chunk, fine.height, fine.width, 2.0)
    host["chunk72x129_B128"] = host_us(lambda: resize_bilinear(chunk, fine.width,
                                                               fine.height, 2.0))
    # the halo path's per-block resizes (`parallel/halo.py:resize_bilinear`,
    # mesh_sp_8k's 1x2 mesh at 4320x7680): the second row block of the
    # flow's x2 upsample to L0 and of the level resize to L1

    def halo_block(label, x, dh, dw, scale):
        sh, w = x.shape[-2:]
        s0, s1, _ = _coeffs_f32(sh, dh)
        a, b = dh // 2, dh
        lo = int(s0[a])
        src = x[..., lo:int(s1[b - 1]) + 1, :]
        sy0, sy1, ty = coeff_tensors(sh, dh, dev)
        rows = resample._row_block_table(sh, dh, a, b, lo, dev)
        cases.append((label, lambda: resample.bilinear_rows(src, dw, sh, dh, a, b, lo, scale),
                      lambda: bilinear_rows_plain(src, dw, sy0[a:b] - lo, sy1[a:b] - lo,
                                                  ty[a:b]) * scale,
                      work_resample(src, rows.index.cpu().numpy(), bilinear_taps(w, dw)[0],
                                    False), None))
        paths[label] = x1_path(src, rows, resample._table("bilinear", w, dw, dev), False)

    halo_block("halo_8k_upsample_L0_block1", random_flow((1, 2, 2160, 3840), gen, dev),
               4320, 7680, 2.0)
    halo_block("halo_8k_level_L1_block1",
               torch.rand((2, 4320, 7680), generator=gen, device=dev) * 255.0, 2160, 3840, 1.0)
    run_cases("X1", cases, stats, tolerance="equal to the bit", device_time=True,
              paths=paths, host_us=host, ptxas=ptxas_report("resample"))


def kernel_x2_phase(dev, stats) -> None:
    """X2 against its plain version (the f64 sum rounded once): within one
    f32 ulp per pair, equal across two runs, and each of a few pairs the
    same alone as in its batch; at 1080p B=16 (the kernels line's case)
    and 72x129 B=128.  Library: torch.linalg.vector_norm over the two
    components, then the sum (f32).  Kernel and library call are timed
    with events and by their device time in a profile; `host_us` is the
    host's time of one call."""
    import torch
    from optical_flow_tpu_torch.kernels.magnitude_sum import magnitude_sum
    from optical_flow_tpu_torch.ops.polar import magnitude_sums

    gen = torch.Generator(device=dev).manual_seed(14)
    rows = []
    for b, h, w in ((BATCH, 1080, 1920), (128, 72, 129)):
        flow = random_flow((b, 2, h, w), gen, dev)
        got = magnitude_sum(flow)
        ref = magnitude_sums(flow[:, 0], flow[:, 1])
        again = magnitude_sum(flow)
        alone = [magnitude_sum(flow[i:i + 1]) for i in (0, b // 2, b - 1)]
        torch.cuda.synchronize()
        ulps = int((got.view(torch.int32).long() - ref.view(torch.int32).long()).abs().max())
        require(ulps <= 1, f"X2 {b}x{h}x{w}: {ulps} ulps off the plain version")
        require(torch.equal(got, again), f"X2 {b}x{h}x{w}: two runs differ")
        require(all(torch.equal(a, got[i:i + 1]) for a, i in zip(alone, (0, b // 2, b - 1))),
                f"X2 {b}x{h}x{w}: a pair alone differs from the batch")

        def library():
            return torch.linalg.vector_norm(flow, dim=1).sum((-2, -1))

        row = {"case": f"B{b}_{h}x{w}", "max_ulps": ulps,
               "max_abs_err": float((got - ref).abs().max()),
               "ms": cuda_ms(lambda: magnitude_sum(flow), 20),
               "plain_ms": cuda_ms(lambda: magnitude_sums(flow[:, 0], flow[:, 1]), 5),
               "library_ms": cuda_ms(library, 20),
               "device_ms": device_ms(lambda: magnitude_sum(flow), 20),
               "library_device_ms": device_ms(library, 20),
               "host_us": host_us(lambda: magnitude_sum(flow))}
        row["bound_ms"], row["bound_by"] = bound(work_magnitude_sum(flow))
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["device_bound_share"] = row["bound_ms"] / row["device_ms"]
        rows.append(row)
        del flow
    stats["X2"] = {k: rows[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms")}
    stats["X2"]["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    emit("kernel_X2", name=KERNEL_INFO["X2"][0], tolerance="1 f32 ulp", cases=rows,
         ptxas=ptxas_report("magnitude_sum"))


def e2e_phase(name: str, h: int, w: int, cfg, dev, golden, power, stats=None,
              golden_key: str | None = None, seeded: bool = False,
              batch: int = BATCH, shift=SHIFT, fused_poly: bool = False):
    """The extractor's device step on `batch` copies of the texture pair
    (shift (dy, dx), true flow (-dx, -dy)): launch counts (and K1's by
    level width; every K1 launch of the instantiation with the window
    built in where `k1_fixed`, none elsewhere), kernel path vs plain
    path, interior EPE, the JAX golden
    entry `golden_key` where there is one, and pairs/s of both paths.
    seeded: flags 4 from seed_flow(batch, h, w), through calc_flow_batched
    (magnitude_sums takes no seed); only the first pair has the golden
    entry's seed, and calc_flow of that pair must equal it.  fused_poly:
    with FUSE_POLYEXP on (every level on K7, no K2, no K1); the flow must
    equal the switch-off run's to the bit, and the switch-off run's
    pairs/s stands in for the plain path's.  The first path that
    launches a kernel gives its count to stats."""
    import torch
    from optical_flow_tpu_torch.kernels import (FIXED_WINDOW, LAUNCHES, fused_iterate,
                                                reset_launches)
    from optical_flow_tpu_torch.kernels.gauss_resize import k3_fits
    from optical_flow_tpu_torch.kernels.update_gather import k1_fits, k1_fixed
    from optical_flow_tpu_torch.models.farneback.flow import (calc_flow,
                                                              calc_flow_batched)
    from optical_flow_tpu_torch.kernels.magnitude_sum import magnitude_sum
    from optical_flow_tpu_torch.kernels.resample import area_plan
    from optical_flow_tpu_torch.models.farneback.params import build_plan
    from optical_flow_tpu_torch.ops import polar
    from optical_flow_tpu_torch.pipeline.extractor import magnitude_sums

    true_flow = (-float(shift[1]), -float(shift[0]))
    prev, nxt = frames(h, w, dev, batch, shift)
    seed = torch.as_tensor(seed_flow(batch, h, w)).to(dev) if seeded else None

    def sums_of(plain: bool):
        if seed is None:
            return magnitude_sums(prev, nxt, cfg, plain=plain)
        flow = calc_flow_batched(prev, nxt, cfg, seed, plain=plain)
        if plain:
            return polar.magnitude_sums(flow[..., 0], flow[..., 1])
        return magnitude_sum(flow.movedim(-1, 1))

    levels = build_plan(h, w, cfg).levels
    n_k6 = sum(1 for lv in levels
               if lv.k > 0 and not k3_fits(lv.smooth_ksize, h, w, lv.width))
    steps = len(levels) * cfg.iterations
    fused = k1_fits(cfg.winsize) and not fused_poly
    unfused = not k1_fits(cfg.winsize) and not fused_poly
    # X1: the upsamples, the K6 route's resizes and the seed's downsample
    n_area = len(area_plan(h, w, levels[0].height, levels[0].width)) if seeded else 0
    expected = {"K3": len(levels) - 1 - n_k6, "K2": 0 if fused_poly else len(levels),
                "K1": steps if fused else 0, "K4": 0,
                "K5a": steps if unfused else 0, "K5b": steps if unfused else 0,
                "K6": n_k6, "K7": steps if fused_poly else 0,
                "X1": len(levels) - 1 + n_k6 + n_area, "X2": x2_launches(h, w)}
    path = [kid for kid, n in expected.items() if n > 0]
    fused_iterate.FUSE_POLYEXP = fused_poly
    # K1's launches by level width: the update_blur calls of the counted run
    k1_widths = {}
    update_blur = fused_iterate.update_blur

    def counted(R0, R1, flow, *args, **kwargs):
        k1_widths[flow.shape[-1]] = k1_widths.get(flow.shape[-1], 0) + 1
        return update_blur(R0, R1, flow, *args, **kwargs)

    fused_iterate.update_blur = counted
    try:
        reset_launches()
        sums = sums_of(False)
        torch.cuda.synchronize()
        launches, fixed = dict(LAUNCHES), FIXED_WINDOW["K1"]
    finally:
        fused_iterate.update_blur = update_blur
    for kid in path:
        require(launches[kid] > 0, f"{name}: kernel {kid} was not launched")
    require(launches == expected, f"{name}: launches {launches} != {expected}")
    require(fixed == (launches["K1"] if k1_fixed(cfg.winsize) else 0),
            f"{name}: {fixed} of {launches['K1']} K1 launches with the window built in")
    require(k1_widths == ({lv.width: cfg.iterations for lv in levels} if fused else {}),
            f"{name}: K1 launches by level width {k1_widths}")
    if stats is not None:
        for kid in path:
            stats[kid].setdefault("launches", launches[kid])
        if "K1" in path:
            stats["K1"].setdefault("fixed_window_launches", fixed)

    flow = calc_flow_batched(prev, nxt, cfg, seed)
    fields = {}
    if fused_poly:
        fused_iterate.FUSE_POLYEXP = False
        off = calc_flow_batched(prev, nxt, cfg, seed)
        torch.cuda.synchronize()
        require(torch.equal(flow, off), f"{name}: switch on != switch off: max diff "
                f"{float((flow - off).abs().max())}")
        fields["equals_switch_off"] = True
        del off
        fused_iterate.FUSE_POLYEXP = True
    flow_p = calc_flow_batched(prev, nxt, cfg, seed, plain=True)
    torch.cuda.synchronize()
    require(tuple(flow.shape) == (batch, h, w, 2), f"{name}: flow shape {tuple(flow.shape)}")
    require(bool(torch.isfinite(flow).all()), f"{name}: non-finite flow")
    d = (flow - flow_p).abs()
    share = float((d <= 2e-3 + 1e-3 * flow_p.abs()).float().mean())
    mean_d = float(d.mean())
    require(share >= 0.999, f"{name}: only {share:.6f} of components match the plain path")
    require(mean_d <= 1e-3, f"{name}: mean |kernel - plain| {mean_d} > 1e-3 px")

    fields.update({"flags": cfg.flags, "winsize": cfg.winsize, "levels": cfg.levels,
              "fuse_polyexp": fused_poly, "launches": launches,
              "k1_fixed_window_launches": fixed,
              "k1_launches_by_width": {str(k): v for k, v in sorted(k1_widths.items())},
              "vs_plain": {"share_within_tol": share, "mean_abs_diff": mean_d,
                           "max_abs_diff": float(d.max())}})
    del d, flow_p
    if seeded:
        one = calc_flow(prev[0], nxt[0], cfg, seed[0])
        torch.cuda.synchronize()
        require(torch.equal(one, flow[0]), f"{name}: calc_flow != calc_flow_batched[0]")
        fields["calc_flow_equals_batched_0"] = True
        del one
    g = golden[golden_key] if golden_key else {}
    if h > 2 * CROP and w > 2 * CROP:
        inner = flow[:, CROP:h - CROP, CROP:w - CROP]
        truth = torch.tensor(true_flow, device=dev)
        epe = float((inner - truth).norm(dim=-1).mean())
        fields["interior_epe_px"] = epe
        fields["jax_interior_epe_px"] = g.get("interior_epe_px")
        if h >= 1080:
            require(epe <= EPE_GATE, f"{name}: interior EPE {epe} > {EPE_GATE} px")
        del inner

    if g:
        require(g["config"] == {k: getattr(cfg, k) for k in g["config"]}
                and g["flags"] == cfg.flags and tuple(g["shift"]) == tuple(shift),
                f"{name}: golden entry {golden_key} is for another input")
        pairs = slice(0, 1) if seeded else slice(None)    # pairs with the golden input
        sums_h = sums[pairs].double().cpu().numpy()
        rel = np.abs(sums_h - g["mag_sum"]) / abs(g["mag_sum"])
        require(bool((rel <= 1e-4).all()), f"{name}: magnitude sums off by {rel.max()} rel")
        ys = torch.as_tensor(g["sample_y"], device=dev)
        xs = torch.as_tensor(g["sample_x"], device=dev)
        samples = flow[pairs][:, ys, xs].cpu().numpy()
        ref = np.asarray(g["sample_flow"], dtype=np.float32)
        within = float((np.abs(samples - ref[None]) <= 2e-3).mean())
        require(within >= 0.99, f"{name}: only {within:.4f} of golden samples within 2e-3 px")
        fields["vs_jax_golden"] = {"mag_sum_max_rel_err": float(rel.max()),
                                   "samples_within_2e-3": within}
    del flow

    def pairs_per_s(plain: bool) -> float:
        return batch / median_s(lambda: sums_of(plain))

    fields["pairs_per_s"] = pairs_per_s(False)
    if fused_poly:
        fused_iterate.FUSE_POLYEXP = False
        fields["switch_off_pairs_per_s"] = pairs_per_s(False)
    else:
        fields["plain_pairs_per_s"] = pairs_per_s(True)
    fused_iterate.FUSE_POLYEXP = False
    fields["card"] = power
    emit(name, h=h, w=w, batch=batch, **fields)


def kernel_k4_phase(h: int, w: int, dev, stats) -> None:
    """K4 against its plain version, byte-equal: a random flow of up to 6
    px at B=16 (the kernels line's case) and B=1, on 1080x1920 and on
    1079x1917 (planes not 16-byte aligned: scalar quads), and all-zero
    frames (constant magnitude: value 0)."""
    import torch
    from optical_flow_tpu_torch.kernels.colorize import flow_to_bgr_planar
    from optical_flow_tpu_torch.ops import colorize

    gen = torch.Generator(device=dev).manual_seed(1)
    cases = {}
    for fh, fw in ((h, w), (h - 1, w - 3)):
        for batch in (BATCH, 1):
            cases[f"random_B{batch}_{fh}x{fw}"] = (torch.rand(
                (batch, 2, fh, fw), generator=gen, device=dev) - 0.5) * 12.0
        cases[f"zero_B1_{fh}x{fw}"] = torch.zeros((1, 2, fh, fw), device=dev)
    rows = []
    for label, flow in cases.items():
        got = flow_to_bgr_planar(flow)
        ref = colorize.flow_to_bgr_planar(flow)
        torch.cuda.synchronize()
        diff = int((got.int() - ref.int()).abs().max())
        require(diff == 0, f"K4 {label}: max byte diff {diff} against the plain version")
        if label.startswith("zero"):
            require(not bool(got.any()), "K4: zero flow must give black images")
        t_k = cuda_ms(lambda: flow_to_bgr_planar(flow), 20)
        t_p = cuda_ms(lambda: colorize.flow_to_bgr_planar(flow), 5)
        px = flow.shape[0] * flow.shape[2] * flow.shape[3]
        # the least work: the flow read once, BGR written once (11 B/px);
        # magnitude, fastAtan2 and HSV -> BGR, about 40 operations a pixel
        bound_ms, bound_by = bound((11 * px, 40 * px))
        rows.append({"case": label, "shape": list(flow.shape), "max_abs_err": diff,
                     "ms": t_k, "plain_ms": t_p, "bound_ms": bound_ms,
                     "bound_by": bound_by, "bound_share": bound_ms / t_k,
                     "gb_per_s_at_11_b_per_px": 11 * px / t_k / 1e6})
    del cases
    stats["K4"] = {"ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
                   "bound_ms": rows[0]["bound_ms"], "bound_by": rows[0]["bound_by"],
                   "library_ms": None,
                   "max_abs_err": max(r["max_abs_err"] for r in rows)}
    emit("kernel_K4", name=KERNEL_INFO["K4"][0], tolerance="byte-equal",
         cases=rows, ptxas=ptxas_report("colorize"))


def e2e_visualizer_phase(name: str, h: int, w: int, cfg, dev, golden, power,
                         stats) -> None:
    """The visualizer's device loop on 17 frames fed from memory, f1, f2,
    f1, ...: 16 pairs whose true flow alternates between (-3, -2) and
    (3, 2)."""
    import torch
    from optical_flow_tpu_torch.kernels import LAUNCHES, reset_launches
    from optical_flow_tpu_torch.models.farneback.flow import (
        calc_flow_batched, calc_flow_bgr_chain_batched, calc_flow_chain_batched)
    from optical_flow_tpu_torch.models.farneback.params import build_plan
    from optical_flow_tpu_torch.oracle.synthetic import smooth_texture_pair
    from optical_flow_tpu_torch.pipeline.prefetch import dispatch_pairs, pair_chunk_for
    from optical_flow_tpu_torch.pipeline.visualizer import visualize_frames

    f1, f2 = smooth_texture_pair(h, w, SHIFT)
    seq = [(float(i), f2 if i % 2 else f1) for i in range(BATCH + 1)]
    chunk = pair_chunk_for(h, w, device=dev)

    def run(plain: bool, write, chunk_size: int = chunk) -> None:
        n = visualize_frames(seq, write, cfg, chunk_size=chunk_size,
                             device=dev, plain=plain)
        require(n == BATCH, f"{name}: {n} images written, expected {BATCH}")

    def loop(plain: bool, chunk_size: int = chunk) -> np.ndarray:
        out = []
        run(plain, lambda pos, bgr: out.append(bgr), chunk_size)
        return np.stack(out)

    n_levels = len(build_plan(h, w, cfg).levels)
    n_chunks = -(-BATCH // dispatch_pairs(h, w, chunk))
    expected = {"K3": (n_levels - 1) * n_chunks, "K2": n_levels * n_chunks,
                "K1": n_levels * cfg.iterations * n_chunks, "K4": n_chunks,
                "K5a": 0, "K5b": 0, "K6": 0, "K7": 0,
                "X1": (n_levels - 1) * n_chunks, "X2": 0}
    reset_launches()
    bgr = loop(False)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    for kid in ("K1", "K2", "K3", "K4"):
        require(launches[kid] > 0, f"{name}: kernel {kid} was not launched")
    require(launches == expected, f"{name}: launches {launches} != {expected}")
    stats["K4"].setdefault("launches", launches["K4"])
    require(bgr.shape == (BATCH, 3, h, w) and bgr.dtype == np.uint8,
            f"{name}: BGR {bgr.shape} {bgr.dtype}")
    require(np.array_equal(loop(False, chunk_size=5), bgr),
            f"{name}: chunks of 5 pairs do not give the one-chunk images")
    vs_plain = require_bgr_close(name, torch.as_tensor(bgr),
                                 torch.as_tensor(loop(True)))

    frames_dev = torch.as_tensor(np.stack([g for _, g in seq])).to(dev)
    chain = calc_flow_chain_batched(frames_dev, cfg)
    pairs = calc_flow_batched(frames_dev[:-1], frames_dev[1:], cfg)
    torch.cuda.synchronize()
    require(torch.equal(chain, pairs), f"{name}: chained flow != batched flow")
    del pairs
    truth = torch.tensor([TRUE_FLOW, [-v for v in TRUE_FLOW]], device=dev)
    truth = truth[torch.arange(BATCH, device=dev) % 2][:, None, None, :]
    inner = chain[:, CROP:h - CROP, CROP:w - CROP]
    epe = float((inner - truth).norm(dim=-1).mean())
    require(epe <= 0.5, f"{name}: interior EPE {epe} > 0.5 px")
    del chain, inner

    g = golden[f"chain_bgr_{h}x{w}"]
    samples = bgr[:2][:, :, g["sample_y"], g["sample_x"]].astype(np.int32)
    ref = np.asarray(g["sample_bgr"], dtype=np.int32)
    golden_share = float((samples != ref).mean())
    require(golden_share <= GOLDEN_BGR_SHARE,
            f"{name}: {golden_share} of the golden BGR samples differ")

    def device_only(plain: bool) -> float:
        return BATCH / median_s(lambda: calc_flow_bgr_chain_batched(frames_dev, cfg, plain=plain))

    def with_download(plain: bool) -> float:
        # the writer drops each image, as a JPEG pool would take it over
        return BATCH / median_s(lambda: run(plain, lambda pos, bgr: None))

    out = torch.as_tensor(bgr).to(dev)
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    download_s = median_s(lambda: host.copy_(out, non_blocking=True))
    emit(name, h=h, w=w, pairs=BATCH, chunk=chunk, launches=launches,
         vs_plain=vs_plain, interior_epe_px=epe,
         vs_jax_golden={"samples": int(ref.size), "share_differing": golden_share,
                        "max_diff": int(np.abs(samples - ref).max())},
         device_only_pairs_per_s=device_only(False),
         device_only_plain_pairs_per_s=device_only(True),
         with_download_pairs_per_s=with_download(False),
         with_download_plain_pairs_per_s=with_download(True),
         download_ms=download_s * 1e3, download_mb=out.numel() / 1e6, card=power)


def rolled_chain(n: int, h: int, w: int) -> np.ndarray:
    """n uint8 frames of the texture rolled (1, 2) px a frame, each with
    0/1 noise from np.random.default_rng(3) (tests/test_parallel.py's
    chain at another size)."""
    from optical_flow_tpu_torch.oracle.synthetic import smooth_texture_pair
    base = smooth_texture_pair(h, w, (1, 2), seed=3)[0].astype(np.int16)
    rng = np.random.default_rng(3)
    return np.stack([np.clip(np.roll(base, (i, 2 * i), (0, 1))
                             + rng.integers(0, 2, (h, w)), 0, 255)
                     for i in range(n)]).astype(np.uint8)


def mesh_dp_phase(dev, power) -> None:
    """The data axis (`parallel/mesh.py`) on the one card: a 2x1 mesh whose
    device list repeats the card, at 1080x1920, the default config.  An
    18-frame chain gives 17 pairs (not a multiple of 2: the extractor's
    branch pads to 18).  `sharded_flow_step`, the extractor's branch
    (`_magnitude_sums` with the mesh, which runs `sharded_extract_step`'s
    shards), `sharded_bgr_chain_step` over `chain_shards(frames, 2)` and
    the visualizer's loop through the mesh must each equal the one-device
    entry to the bit.  Also the sums of the two shards summed apart (the
    JAX package's per-shard reduction) against the one-device sums: equal,
    as X2 sums each pair in an order fixed by (H, W) alone."""
    import torch
    from optical_flow_tpu_torch.kernels import LAUNCHES, reset_launches
    from optical_flow_tpu_torch.models.farneback.flow import (
        calc_flow_batched, calc_flow_bgr_chain_batched)
    from optical_flow_tpu_torch.parallel import (chain_shards, make_mesh,
                                                 sharded_bgr_chain_step, sharded_flow_step)
    from optical_flow_tpu_torch.pipeline import visualizer
    from optical_flow_tpu_torch.pipeline.extractor import _magnitude_sums, magnitude_sums
    from optical_flow_tpu_torch.utils.config import ExtractorConfig

    name, h, w, n_frames = "mesh_dp_1080p", 1080, 1920, 18
    mesh = make_mesh(2, 1, devices=[dev, dev])
    host = rolled_chain(n_frames, h, w)
    chain = torch.as_tensor(host).to(dev)
    prev, nxt = chain[:-1], chain[1:]
    cfg = ExtractorConfig()

    def sharded():
        return (sharded_flow_step(mesh, prev, nxt),
                _magnitude_sums(prev, nxt, cfg, device=dev, mesh=mesh)[0],
                sharded_bgr_chain_step(mesh, chain_shards(chain, 2))[:n_frames - 1])

    reset_launches()
    flow, sums, bgr = sharded()
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    for kid in ("K1", "K2", "K3", "K4", "X1", "X2"):
        require(launches[kid] > 0, f"{name}: kernel {kid} was not launched")
    # each data shard sums its own pairs: one X2 call a shard with pairs
    require(launches["X2"] == 2 * x2_launches(h, w),
            f"{name}: {launches['X2']} X2 launches, expected {2 * x2_launches(h, w)}")
    wall_s = median_s(sharded, warmup=1, timed=3)
    one_flow = calc_flow_batched(prev, nxt)
    one_sums = magnitude_sums(prev, nxt)
    one_bgr = calc_flow_bgr_chain_batched(chain)
    require(torch.equal(flow, one_flow), f"{name}: sharded flow != calc_flow_batched: "
            f"max diff {float((flow - one_flow).abs().max())}")
    require(torch.equal(sums, one_sums), f"{name}: branch sums != magnitude_sums: "
            f"max diff {float((sums - one_sums).abs().max())}")
    require(torch.equal(bgr, one_bgr), f"{name}: sharded BGR chain != "
            f"calc_flow_bgr_chain_batched on {int((bgr != one_bgr).sum())} bytes")
    apart = torch.cat([magnitude_sums(prev[:9], nxt[:9]), magnitude_sums(prev[9:], nxt[9:])])
    require(torch.equal(apart, one_sums), f"{name}: sums of 9 + 8 pairs != sums of 17: max "
            f"diff {float((apart - one_sums).abs().max())}")

    def loop():
        out = []
        visualizer.visualize_frames(list(enumerate(host)), lambda pos, b: out.append(b),
                                    chunk_size=n_frames - 1, device=dev)
        return np.stack(out)

    solo = loop()
    dp_mesh = visualizer.dp_mesh
    visualizer.dp_mesh = lambda device=None: mesh
    try:
        meshed = loop()
    finally:
        visualizer.dp_mesh = dp_mesh
    require(np.array_equal(meshed, solo), f"{name}: the visualizer's loop through the "
            f"mesh differs on {int((meshed != solo).sum())} bytes")
    require(np.array_equal(solo, one_bgr.cpu().numpy()),
            f"{name}: the visualizer's loop != calc_flow_bgr_chain_batched")
    emit(name, h=h, w=w, pairs=n_frames - 1, mesh=list(mesh.devices.shape),
         devices=[str(d) for d in mesh.devices.flat], launches=launches,
         flow_equal=True, sums_equal=True, bgr_chain_equal=True,
         visualizer_equal=True,
         per_shard_sums_equal=True,
         wall_s=wall_s, card=power)


def mesh_sp_phase(dev, power) -> None:
    """The spatial axis (`parallel/halo.py`) on the one card: a 1x2 mesh
    whose device list repeats the card, bench.py's 8K pair (4320x7680,
    B=1, shift (3, 5)).  `sharded_flow_step` runs every stage per halo
    block (K6, K2, K5a, K5b; no K1, K3, K4 or K7) and is held to the
    one-device `calc_flow_batched` by the flow gate and to the true flow
    by the interior EPE.  Then the cross-seam case of
    `HaloKernels.update_matrices_stats` at the same size: a random +-6 px
    flow plus a band of dy = 45 px rows just above the seam, whose fetches
    land past the 32-row halo (tests/test_halo.py:92-105 at full size),
    against the one-device K5a."""
    import torch
    from optical_flow_tpu_torch.kernels import LAUNCHES, reset_launches
    from optical_flow_tpu_torch.kernels.polyexp import poly_exp
    from optical_flow_tpu_torch.kernels.update_gather import update_matrices
    from optical_flow_tpu_torch.models.farneback.flow import calc_flow_batched
    from optical_flow_tpu_torch.parallel import HaloKernels, make_mesh, sharded_flow_step
    from optical_flow_tpu_torch.parallel.halo import Blocks

    name, (h, w) = "mesh_sp_8k", WIDE
    mesh = make_mesh(1, 2, devices=[dev, dev])
    prev, nxt = frames(h, w, dev, batch=1, shift=SHIFT_8K)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flow = sharded_flow_step(mesh, prev, nxt)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    for kid in ("K6", "K2", "K5a", "K5b", "X1"):
        require(launches[kid] > 0, f"{name}: kernel {kid} was not launched")
    require(all(launches[k] == 0 for k in ("K1", "K3", "K4", "K7")),
            f"{name}: a one-device kernel ran under sp: {launches}")
    ref = calc_flow_batched(prev, nxt)
    torch.cuda.synchronize()
    require(tuple(flow.shape) == (1, h, w, 2) and bool(torch.isfinite(flow).all()),
            f"{name}: flow {tuple(flow.shape)}, finite {bool(torch.isfinite(flow).all())}")
    d = (flow - ref).abs()
    share = float((d <= 2e-3 + 1e-3 * ref.abs()).float().mean())
    mean_d = float(d.mean())
    require(share >= 0.999, f"{name}: only {share:.6f} of components match one device")
    require(mean_d <= 1e-3, f"{name}: mean |sp - one device| {mean_d} > 1e-3 px")
    truth = torch.tensor((-float(SHIFT_8K[1]), -float(SHIFT_8K[0])), device=dev)
    epe = float((flow[:, CROP:h - CROP, CROP:w - CROP] - truth).norm(dim=-1).mean())
    require(epe <= EPE_GATE, f"{name}: interior EPE {epe} > {EPE_GATE} px")
    vs_one = {"share_within_tol": share, "mean_abs_diff": mean_d,
              "max_abs_diff": float(d.max())}
    del d, flow, ref

    R = poly_exp(torch.cat([prev, nxt]), 5, 1.2)
    R0, R1 = R[:1], R[1:]
    fl = random_flow((1, 2, h, w), torch.Generator(dev).manual_seed(5), dev)
    seam = h // 2
    fl[:, 1, seam - 8:seam, 1000:3000] = 45.0
    reset_launches()
    M, n_fixed = HaloKernels(mesh).update_matrices_stats(
        *(Blocks.split(t, [dev, dev]) for t in (R0, R1, fl)))
    seam_launches = dict(LAUNCHES)
    got = M.gather()
    ref_m = update_matrices(R0, R1, fl)
    torch.cuda.synchronize()
    require(seam_launches["K5a"] == 2, f"{name}: seam case launches {seam_launches}")
    require_close(f"{name} seam", got, ref_m, 1e-4, 1e-5)
    require(n_fixed >= 8 * 2000, f"{name}: only {n_fixed} seam pixels corrected")
    emit(name, h=h, w=w, batch=1, mesh=list(mesh.devices.shape),
         devices=[str(x) for x in mesh.devices.flat], launches=launches,
         vs_one_device=vs_one, interior_epe_px=epe, wall_s=wall_s,
         seam_case={"band": [seam - 8, seam, 1000, 3000], "dy": 45.0,
                    "seam_pixels_corrected": n_fixed,
                    "max_abs_diff": float((got - ref_m).abs().max())},
         card=power)


def e2e_extractor_loop_phase(name: str, h: int, w: int, n_frames: int, cfg,
                             dev, power) -> None:
    """The extractor's device loop (`pipeline/extractor.py:extract_frames`)
    on an in-memory 25 fps clip moving 1 px a frame (`translating_clip`),
    the windows `extract_video` takes at the default step and window, in
    chunks of `pair_chunk_for(h, w)` pairs: its launches, its sums held
    to the plain path (1e-4 rel) and its CSV line equal to the plain
    path's, and with FUSE_POLYEXP its sums equal to the switch-off sums
    (every level on K7); where `extractor.graph_engaged` takes its chunks
    (72x129), a captured dispatch replayed at least once in each kernel
    run, and at 1080x1920 none.  The cells time this loop; this phase
    checks it."""
    import torch
    from optical_flow_tpu_torch.io.sidecar import mag_csv_line
    from optical_flow_tpu_torch.kernels import LAUNCHES, fused_iterate, reset_launches
    from optical_flow_tpu_torch.models.farneback.params import build_plan
    from optical_flow_tpu_torch.oracle.synthetic import translating_clip
    from optical_flow_tpu_torch.pipeline import extractor
    from optical_flow_tpu_torch.pipeline.prefetch import pair_chunk_for
    from optical_flow_tpu_torch.utils.config import ExtractorConfig
    from optical_flow_tpu_torch.utils.metrics import PipelineMetrics

    fps = 25.0
    config = ExtractorConfig(farneback=cfg)
    windows, step = extractor._window_schedule(n_frames, fps, config.step_size,
                                               config.window_size)
    todo = list(enumerate(windows))
    needed = sorted({f for win in windows for f in win})
    amp = min(48, w // 2 - 1)          # a triangle wave of column offsets
    dxs = [amp - abs(amp - f % (2 * amp)) for f in needed]
    seq = list(zip(needed, translating_clip(h, w, dxs)))
    chunk = pair_chunk_for(h, w, device=dev)
    graphed = extractor.graph_engaged(dev.type, chunk, h, w, plain=False, mesh=None,
                                      nan_check=False)
    replays = []

    def run(plain: bool = False) -> dict:
        reset_launches()
        m = PipelineMetrics("extract")
        out = extractor.extract_frames(seq, todo, config, chunk_size=chunk,
                                       device=dev, plain=plain, metrics=m)
        torch.cuda.synchronize()
        if not plain:
            replays.append(m.counters["graph_replays"])
            require(replays[-1] >= 1 if graphed else replays[-1] == 0,
                    f"{name}: {replays[-1]} graph replays, graphed={graphed}")
        return out

    def csv_line(results) -> str:
        mags, stamps = extractor.aggregate(results, n_frames, fps, step)
        return mag_csv_line(extractor.scale_magnitudes(mags, config.top_percentile), stamps)

    n_chunks = -(-len(todo) // chunk)
    n_levels = len(build_plan(h, w, cfg).levels)
    sums = run()
    launches = dict(LAUNCHES)
    expected = {"K1": 3 * n_levels * n_chunks, "K2": n_levels * n_chunks,
                "K3": (n_levels - 1) * n_chunks, "K4": 0, "K5a": 0, "K5b": 0,
                "K6": 0, "K7": 0, "X1": (n_levels - 1) * n_chunks,
                "X2": x2_launches(h, w) * n_chunks}
    require(launches == expected, f"{name}: launches {launches} != {expected}")
    require(sorted(sums) == list(range(len(todo))), f"{name}: windows missing")
    plain = run(plain=True)
    got = np.asarray([sums[i][2] for i in range(len(todo))])
    ref = np.asarray([plain[i][2] for i in range(len(todo))])
    # windows at the clip's turning points do not move: both sums are 0 there
    d = np.abs(got - ref)
    rel = float((d / np.maximum(np.abs(ref), 1e-30)).max())
    require(bool((d <= 1e-4 * np.abs(ref)).all()),
            f"{name}: magnitude sums off the plain path by {rel} rel")
    line = csv_line(sums)
    require(line == csv_line(plain), f"{name}: the CSV line differs from the plain path's")
    fused_iterate.FUSE_POLYEXP = True
    try:
        fused = run()
        k7_launches = dict(LAUNCHES)
    finally:
        fused_iterate.FUSE_POLYEXP = False
    require(fused == sums, f"{name}: FUSE_POLYEXP sums != the switch-off sums")
    require(k7_launches == {**expected, "K1": 0, "K2": 0, "K7": 3 * n_levels * n_chunks},
            f"{name}: FUSE_POLYEXP launches {k7_launches}")
    emit(name, h=h, w=w, frames=n_frames, frames_uploaded=len(seq),
         windows=len(todo), chunk=chunk, launches=launches,
         fuse_polyexp_launches=k7_launches, graph_replays=replays,
         sums_max_rel_err_vs_plain=rel,
         csv_equals_plain=True, fuse_polyexp_sums_equal=True,
         csv_start_end=line.split("\t")[:2], card=power)


def device_events(prof, calls: int) -> dict:
    """Per call, from a profile: device ms by event name, the kernels
    launched (device events other than copies and fills) and the
    host-to-device copies."""
    import torch
    by_name, n_kernels, n_h2d = {}, 0, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3 / calls
        if e.name.startswith("Memcpy HtoD"):
            n_h2d += 1
        elif not e.name.startswith(("Memcpy", "Memset")):
            n_kernels += 1
    return {"by_name": by_name, "kernels_per_call": n_kernels / calls,
            "h2d_copies_per_call": n_h2d / calls}


def profile_phase(dev, power) -> None:
    """Where the device time of one flow call + magnitude sums goes:
    1080p B=16 under flags 0, 256 and 4, with levels=5 and with winsize
    63, the 8K pair (B=1) and the extractor's 72x129 chunk (B=128), each
    profiled twice: torch.profiler over PROFILED calls after WARMUP.
    Device work is the sum of the CUDA events' device time per call, its
    `device_share` that over the profiled wall time per call; every device
    event is listed by name, largest first, beside the kernels launched
    and the host-to-device copies per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from optical_flow_tpu_torch.kernels.magnitude_sum import magnitude_sum
    from optical_flow_tpu_torch.models.farneback.flow import calc_flow_batched
    from optical_flow_tpu_torch.utils.config import FarnebackConfig

    hd = frames(1080, 1920, dev)
    seed = torch.as_tensor(seed_flow(BATCH, 1080, 1920)).to(dev)
    cells = [("profile_1080p", hd, FarnebackConfig(flags=flags), seed)
             for flags in (0, 256, 4)]
    cells += [("profile_deep_1080p", hd, FarnebackConfig(levels=5), None),
              ("profile_winsize63_1080p", hd, FarnebackConfig(winsize=WIDE_WINDOW), None),
              ("profile_8k", frames(*WIDE, dev, 1, SHIFT_8K), FarnebackConfig(), None),
              ("profile_72x129", frames(72, 129, dev, 128), FarnebackConfig(), None)]
    for run in range(2):
        for phase, (prev, nxt), cfg, seed in cells:

            def call():
                return magnitude_sum(calc_flow_batched(prev, nxt, cfg, seed).movedim(-1, 1))

            for _ in range(WARMUP):
                call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(PROFILED):
                    call()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) / PROFILED * 1e3
            ev = device_events(prof, PROFILED)
            device_ms = sum(ev["by_name"].values())
            require(device_ms > 0, f"{phase} flags {cfg.flags}: no device time traced")
            top = sorted(ev["by_name"].items(), key=lambda kv: -kv[1])
            emit(phase, run=run, flags=cfg.flags, levels=cfg.levels, winsize=cfg.winsize,
                 batch=prev.shape[0],
                 calls=PROFILED, wall_ms_per_call=wall_ms, device_ms_per_call=device_ms,
                 device_share=device_ms / wall_ms,
                 kernels_per_call=ev["kernels_per_call"],
                 h2d_copies_per_call=ev["h2d_copies_per_call"],
                 top_device_ms_per_call=[[name[:70], ms] for name, ms in top],
                 card=power)


def selftest_phase(power) -> None:
    """The package's own self test on the card (`utils/selftest.py`):
    every kernel against its plain version over the JAX self test's shape
    classes, K7 at the iterate's spills, and the full pyramid on
    `vertical_jump_pair` at 1080p.  Every kernel must launch in it."""
    from optical_flow_tpu_torch.kernels import LAUNCHES, reset_launches
    from optical_flow_tpu_torch.utils.selftest import run_selftest

    reset_launches()
    t0 = time.perf_counter()
    verdict = run_selftest()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    pyramid = next(c for c in verdict["cases"] if c["name"].startswith("pyramid/"))
    failed = [c for c in verdict["cases"] if not c["ok"]]
    emit("selftest", n_cases=verdict["n_cases"], n_failed=verdict["n_failed"],
         seconds=seconds, max_abs_diff=verdict["max_abs_diff"], pyramid=pyramid,
         launches=launches, failed=failed, card=power)
    require(verdict["kernels"] and verdict["ok"],
            f"selftest: {verdict['n_failed']} of {verdict['n_cases']} cases failed")
    require(all(launches[k] > 0 for k in KERNEL_INFO),
            f"selftest: a kernel was never launched: {launches}")


def warmup_phase(dev, power) -> None:
    """The warmers at 1080p source frames (`utils/warmup.py`): each
    launches its production step once at the chunk its pipeline sends on
    this card (`pair_chunk_for`; the visualizer's `dispatch_pairs` of
    it), and reports its seconds and peak device memory."""
    import torch
    from optical_flow_tpu_torch.kernels import LAUNCHES, reset_launches
    from optical_flow_tpu_torch.pipeline.prefetch import dispatch_pairs, pair_chunk_for
    from optical_flow_tpu_torch.utils.warmup import (warmup_extractor, warmup_flow,
                                                     warmup_visualizer)

    total = torch.cuda.get_device_properties(dev).total_memory
    chunk = pair_chunk_for(1080, 1920, device=dev)
    runs = {}
    for name, warm, kernels in [
            ("extractor", warmup_extractor, ("K3", "K2", "K1")),
            ("visualizer", warmup_visualizer, ("K3", "K2", "K1", "K4")),
            ("flow", warmup_flow, ("K3", "K2", "K1"))]:
        torch.cuda.empty_cache()
        reset_launches()
        info = warm(1080, 1920, device=dev)
        launches = {k: v for k, v in LAUNCHES.items() if v}
        require(all(launches.get(k, 0) > 0 for k in kernels),
                f"warmup {name}: launches {launches}")
        require(info["peak_bytes"] < total, f"warmup {name}: peak past the card")
        runs[name] = {**info, "peak_gb": info["peak_bytes"] / 1e9, "launches": launches}
    torch.cuda.empty_cache()
    require(runs["flow"]["chunk"] == chunk
            and runs["visualizer"]["chunk"] == dispatch_pairs(1080, 1920, chunk),
            f"warmup: chunks {runs} against pair_chunk_for {chunk}")
    emit("warmup_1080p", pair_chunk_for_1080p=chunk, card_total_gb=total / 1e9,
         card=power, **runs)


def cold_start_phase(power) -> None:
    """Three starts of the warmup CLI at 1920x1080, each a fresh process:
    cold (an empty kernel cache; builds every kernel, then packs them),
    warm (the same cache again) and restored (a fresh, empty cache that
    the pack fills).  The warm and restored starts must run no nvcc."""
    import shutil
    import tempfile
    from optical_flow_tpu_torch.kernels import _build

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="cold_start_", dir=ROOT / "build"))
    pack = tmp / "warm.tgz"
    res = ["--res", "1920x1080"]
    runs = {}
    try:
        for label, cache, args in [("cold", "a", [*res, "--pack", str(pack)]),
                                   ("warm", "a", res),
                                   ("restored", "b", ["--unpack", str(pack), *res])]:
            env = {**os.environ, "OFT_COMPILE_CACHE": str(tmp / cache)}
            t0 = time.perf_counter()
            out = subprocess.run(
                [sys.executable, "-m", "optical_flow_tpu_torch.utils.warmup", *args],
                cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
            wall = time.perf_counter() - t0
            require(out.returncode == 0, f"cold_start {label}: {out.stderr[-2000:]}")
            r = json.loads(out.stdout.strip().splitlines()[-1])
            runs[label] = {"wall_s": wall, "nvcc_runs": r["nvcc_runs"],
                           "build_s": r["build_s"],
                           "extractor_s": r["warmed"][0]["extractor"]["seconds"],
                           "visualizer_s": r["warmed"][0]["visualizer"]["seconds"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("cold_start", card=power, **runs)
    require(runs["cold"]["nvcc_runs"] == len(_build.SOURCES),
            f"cold_start: the cold start ran {runs['cold']['nvcc_runs']} nvcc")
    require(runs["warm"]["nvcc_runs"] == 0 and runs["restored"]["nvcc_runs"] == 0,
            f"cold_start: nvcc ran on a warm or restored start: {runs}")


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile the 1080p B=16 flow call under "
                             "flags 0, 256 and 4, levels=5 and winsize 63, "
                             "and the 8K pair (PERF.md section 5)")
    parser.add_argument("--profile-only", action="store_true",
                        help="build and run the X1 and X2 kernel phases and the "
                             "profile phases alone (no other checks, no result line)")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    # build into the checkout's build/ (gitignored) unless told otherwise
    os.environ.setdefault("OFT_COMPILE_CACHE", str(ROOT / "build"))
    from optical_flow_tpu_torch.kernels import _build
    from optical_flow_tpu_torch.utils.config import (
        OPTFLOW_FARNEBACK_GAUSSIAN, OPTFLOW_USE_INITIAL_FLOW, FarnebackConfig)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    power = nvidia_smi_line()
    report = _build.build()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=power,
         kernel_build_s=report.seconds, nvcc_runs=report.nvcc_runs,
         kernel_dir=str(_build.build_dir()))
    if args.profile_only:
        kernel_x1_phase(dev, {})
        torch.cuda.empty_cache()
        kernel_x2_phase(dev, {})
        torch.cuda.empty_cache()
        profile_phase(dev, power)
        print(power)
        return 0
    golden = json.loads(GOLDEN.read_text())
    cfg = FarnebackConfig()

    stats = {}
    prev, nxt = frames(1080, 1920, dev)
    kernel_phases(prev, nxt, cfg, stats)
    del prev, nxt
    torch.cuda.empty_cache()
    kernel_x1_phase(dev, stats)
    torch.cuda.empty_cache()
    kernel_x2_phase(dev, stats)
    torch.cuda.empty_cache()
    e2e_phase("e2e_1080p", 1080, 1920, cfg, dev, golden, power, stats,
              golden_key="1080x1920")
    e2e_phase("e2e_extractor", 72, 129, cfg, dev, golden, power,
              golden_key="72x129")
    torch.cuda.empty_cache()
    ab_k7_phase("ab_K7_vs_K2_K1", 1080, 1920, BATCH, cfg, dev, power)
    ab_k7_phase("ab_K7_vs_K2_K1", 72, 129, 128, cfg, dev, power)
    torch.cuda.empty_cache()
    e2e_phase("e2e_fused_poly_1080p", 1080, 1920, cfg, dev, golden, power, stats,
              golden_key="1080x1920", fused_poly=True)
    torch.cuda.empty_cache()
    e2e_extractor_loop_phase("e2e_extractor_loop", 72, 129, 4000, cfg, dev, power)
    e2e_extractor_loop_phase("e2e_extractor_loop", 1080, 1920, 200, cfg, dev, power)
    torch.cuda.empty_cache()
    kernel_k4_phase(1080, 1920, dev, stats)
    torch.cuda.empty_cache()
    e2e_visualizer_phase("e2e_visualizer_1080p", 1080, 1920, cfg, dev, golden,
                         power, stats)
    torch.cuda.empty_cache()
    e2e_phase("e2e_gaussian_1080p", 1080, 1920,
              FarnebackConfig(flags=OPTFLOW_FARNEBACK_GAUSSIAN), dev, golden,
              power, stats, golden_key="gaussian_1080x1920")
    torch.cuda.empty_cache()
    e2e_phase("e2e_seeded_1080p", 1080, 1920,
              FarnebackConfig(flags=OPTFLOW_USE_INITIAL_FLOW), dev, golden,
              power, golden_key="seeded_1080x1920", seeded=True)
    torch.cuda.empty_cache()
    e2e_phase("e2e_winsize63_1080p", 1080, 1920, FarnebackConfig(winsize=WIDE_WINDOW),
              dev, golden, power, stats)
    torch.cuda.empty_cache()
    e2e_phase("e2e_deep_1080p", 1080, 1920, FarnebackConfig(levels=5), dev,
              golden, power, stats, golden_key="deep5_1080x1920")
    torch.cuda.empty_cache()
    e2e_phase("e2e_8k", *WIDE, cfg, dev, golden, power, stats, batch=1,
              shift=SHIFT_8K)
    torch.cuda.empty_cache()
    mesh_dp_phase(dev, power)
    torch.cuda.empty_cache()
    mesh_sp_phase(dev, power)
    torch.cuda.empty_cache()
    selftest_phase(power)
    torch.cuda.empty_cache()
    warmup_phase(dev, power)
    cold_start_phase(power)
    if args.profile:
        torch.cuda.empty_cache()
        profile_phase(dev, power)

    kernels = []
    for kid in ("K3", "K6", "K2", "K1", "K4", "K5a", "K5b", "K7", "X1", "X2"):
        name, source, replaces = KERNEL_INFO[kid]
        st = stats[kid]
        require("launches" in st, f"kernel {kid} was launched on no path")
        kernels.append({"name": f"{kid} {name}", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": st["launches"], "max_abs_err": st["max_abs_err"],
                        "ms": st["ms"], "plain_ms": st["plain_ms"],
                        "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
                        "library_ms": st["library_ms"]})
        if kid == "K1":
            kernels[-1]["fixed_window_launches"] = st["fixed_window_launches"]
    print(power)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
