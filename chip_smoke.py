#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one CUDA card.

Run from the repo root on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--profile]

It builds the six CUDA kernels from `optical_flow_tpu_torch/csrc/`
(one nvcc per source, in parallel) and holds each against its plain
PyTorch version at the shapes of the 1080p B=16 paths (K5a and K5b also
at one 4320x7680 level), and holds K5a -> K5b with the box window equal
to K1 to the bit at every level.  Then it drives the extractor's path,
`magnitude_sums` / `calc_flow_batched`, at 1080x1920 and at the
extractor's 72x129, the visualizer's device loop
(`pipeline/visualizer.py:visualize_frames`: chained pyramid, K4 colorize,
download) on 17 frames at 1080x1920 fed from memory, the Gaussian window
(flags 256, K5a -> K5b on every level) and the seeded entry (flags 4,
`calc_flow` and `calc_flow_batched` from a noisy true flow) at 1080x1920.
Each path is checked against the plain path on the card, the true shift
and the JAX package's golden numbers (`tests/data/torch_port_golden.json`),
and both paths are timed.  --profile adds `profile_1080p`: the device
time per kernel and the busy share of the 1080p flow call under flags 0,
256 and 4 (torch.profiler).  One JSON line per phase; then the card's
nvidia-smi line, the kernels summary and, last, {"ok": true, "device":
{...}}.  Any failed check raises: the script then exits non-zero and
prints no result.  It refuses to run without a CUDA card.  It imports no
JAX.
"""

from __future__ import annotations

import argparse
import json
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
              "K5a": (1e-4, 1e-5), "K5b": (1e-3, 1e-3)}
EPE_GATE = 0.5            # BASELINE.md's interior EPE gate, px
WIDE = (4320, 7680)       # wider than the TPU kernels' 4096-column window
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
}


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


def median_s(fn) -> float:
    """Median wall seconds of fn over TIMED runs after WARMUP, each ended
    by torch.cuda.synchronize()."""
    import torch
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED):
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


def frames(h: int, w: int, dev):
    import torch
    from optical_flow_tpu_torch.oracle.synthetic import smooth_texture_pair
    f1, f2 = smooth_texture_pair(h, w, SHIFT)
    prev = torch.as_tensor(np.broadcast_to(f1, (BATCH, h, w)).copy()).to(dev)
    nxt = torch.as_tensor(np.broadcast_to(f2, (BATCH, h, w)).copy()).to(dev)
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


def run_cases(kid: str, cases, stats, key=None, phase=None, **extra) -> None:
    """Each (label, kernel fn, plain fn) case: the kernel against its plain
    version within KERNEL_TOL[kid], then both timed with CUDA events.
    Sums over the pyramid levels (labels "L<k>") and the largest error
    over every case go to stats[key or kid]; one JSON line."""
    import torch
    atol, rtol = KERNEL_TOL[kid]
    levels, ms, plain_ms, max_abs = [], 0.0, 0.0, 0.0
    for label, kern_fn, plain_fn in cases:
        got, ref = kern_fn(), plain_fn()
        torch.cuda.synchronize()
        require_close(f"{kid} {label}", got, ref, atol, rtol)
        ea, er = errors(got, ref)
        t_k, t_p = cuda_ms(kern_fn, 10), cuda_ms(plain_fn, 3)
        levels.append({"level": label, "shape": list(got.shape),
                       "max_abs_err": ea, "max_rel_err": er,
                       "ms": t_k, "plain_ms": t_p})
        if label.startswith("L"):
            ms, plain_ms = ms + t_k, plain_ms + t_p
        max_abs = max(max_abs, ea)
        del got, ref
    stats[key or kid] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": max_abs}
    emit(phase or f"kernel_{kid}", name=KERNEL_INFO[kid][0], atol=atol, rtol=rtol,
         levels=levels, ms_sum=ms, plain_ms_sum=plain_ms, **extra)


def kernel_phases(prev, nxt, cfg, stats) -> None:
    """Each kernel against its plain version at the 1080p B=16 shapes."""
    import torch
    from optical_flow_tpu_torch.kernels.gauss_resize import gauss_resize
    from optical_flow_tpu_torch.kernels.polyexp import poly_exp
    from optical_flow_tpu_torch.kernels.update_gather import update_blur
    from optical_flow_tpu_torch.models.farneback import core
    from optical_flow_tpu_torch.models.farneback.params import (build_plan,
                                                                gaussian_kernel)
    both = torch.cat([prev, nxt])
    plan = build_plan(prev.shape[1], prev.shape[2], cfg)
    imgs = {}
    k3 = []
    for lv in plan.levels:
        if lv.k == 0:
            continue
        kern = gaussian_kernel(lv.smooth_ksize, lv.smooth_sigma)
        imgs[lv.k] = gauss_resize(both, kern, lv.width, lv.height)
        k3.append((f"L{lv.k}",
                   lambda kern=kern, lv=lv: gauss_resize(both, kern, lv.width, lv.height),
                   lambda kern=kern, lv=lv: core.gaussian_blur_resize(both, kern, lv.width, lv.height)))
    run_cases("K3", k3, stats)

    Rs = {}
    k2 = []
    for lv in plan.levels:
        if lv.k == 0:
            src, pre = both, gaussian_kernel(lv.smooth_ksize, lv.smooth_sigma)
        else:
            src, pre = imgs[lv.k], None
        Rs[lv.k] = poly_exp(src, cfg.poly_n, cfg.poly_sigma, pre_taps=pre)
        k2.append((f"L{lv.k}",
                   lambda src=src, pre=pre: poly_exp(src, cfg.poly_n, cfg.poly_sigma, pre_taps=pre),
                   lambda src=src, pre=pre: core.poly_exp(src, cfg.poly_n, cfg.poly_sigma, pre_taps=pre)))
    run_cases("K2", k2, stats)
    del imgs

    gen = torch.Generator(device=both.device).manual_seed(0)
    k1 = []
    flows = {}
    for lv in plan.levels:
        R = Rs[lv.k]
        B = R.shape[0] // 2
        flow = flows[lv.k] = random_flow((B, 2, lv.height, lv.width), gen, both.device)
        k1.append((f"L{lv.k}",
                   lambda R=R, B=B, flow=flow: update_blur(R[:B], R[B:], flow, cfg.winsize),
                   lambda R=R, B=B, flow=flow: core.update_step(R[:B], R[B:], flow, cfg.winsize)))
    run_cases("K1", k1, stats)
    unfused_phases(Rs, flows, plan, cfg.winsize, stats)


def unfused_phases(Rs, flows, plan, winsize: int, stats) -> None:
    """K5a and K5b (box and Gaussian window) against their plain versions
    at every level of the 1080p B=16 path and at one 4320x7680 B=1 level,
    and K5a -> K5b (box) against K1: equal to the bit, both timed."""
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
    ops[f"wide_{h}x{w}_B1"] = (Rw[:1], Rw[1:], random_flow((1, 2, h, w), gen, dev))

    run_cases("K5a", [(label, lambda o=o: update_matrices(*o),
                       lambda o=o: core.update_matrices(*o))
                      for label, o in ops.items()], stats)
    Ms = {label: update_matrices(*o) for label, o in ops.items()}
    for gaussian, key in ((False, "K5b_box"), (True, "K5b")):
        window = "gaussian" if gaussian else "box"
        run_cases("K5b", [(label, lambda M=M, g=gaussian: blur_solve(M, winsize, g),
                           lambda M=M, g=gaussian: core.blur_solve(M, winsize, g))
                          for label, M in Ms.items()], stats, key=key,
                  phase=f"kernel_K5b_{window}", window=window, winsize=winsize)
    stats["K5b"]["max_abs_err"] = max(stats["K5b"]["max_abs_err"],
                                      stats.pop("K5b_box")["max_abs_err"])
    del Ms

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


def e2e_phase(name: str, h: int, w: int, cfg, dev, golden, power, stats=None,
              golden_key=None, seeded: bool = False):
    """The extractor's device step on BATCH copies of the texture pair:
    launch counts, kernel path vs plain path, interior EPE, the JAX golden
    entry `golden_key` (by default "<h>x<w>"), and pairs/s of both paths.
    seeded: flags 4 from seed_flow(BATCH, h, w), through calc_flow_batched
    (magnitude_sums takes no seed); only the first pair has the golden
    entry's seed, and calc_flow of that pair must equal it."""
    import torch
    from optical_flow_tpu_torch.kernels import LAUNCHES, reset_launches
    from optical_flow_tpu_torch.kernels.update_gather import k1_fits
    from optical_flow_tpu_torch.models.farneback.flow import (calc_flow,
                                                              calc_flow_batched)
    from optical_flow_tpu_torch.models.farneback.params import build_plan
    from optical_flow_tpu_torch.ops.polar import magnitude
    from optical_flow_tpu_torch.pipeline.extractor import magnitude_sums

    prev, nxt = frames(h, w, dev)
    seed = torch.as_tensor(seed_flow(BATCH, h, w)).to(dev) if seeded else None

    def sums_of(plain: bool):
        if seed is None:
            return magnitude_sums(prev, nxt, cfg, plain=plain)
        flow = calc_flow_batched(prev, nxt, cfg, seed, plain=plain)
        return magnitude(flow[..., 0], flow[..., 1]).sum(dim=(-2, -1))

    n_levels = len(build_plan(h, w, cfg).levels)
    steps = n_levels * cfg.iterations
    fused = not cfg.gaussian_window and k1_fits(cfg.winsize)
    expected = {"K3": n_levels - 1, "K2": n_levels, "K1": steps if fused else 0,
                "K4": 0, "K5a": 0 if fused else steps, "K5b": 0 if fused else steps}
    path = ("K1", "K2", "K3") if fused else ("K5a", "K5b", "K2", "K3")
    reset_launches()
    sums = sums_of(False)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    for kid in path:
        require(launches[kid] > 0, f"{name}: kernel {kid} was not launched")
    require(launches == expected, f"{name}: launches {launches} != {expected}")
    if stats is not None:
        for kid in path:
            stats[kid]["launches"] = launches[kid]

    flow = calc_flow_batched(prev, nxt, cfg, seed)
    flow_p = calc_flow_batched(prev, nxt, cfg, seed, plain=True)
    torch.cuda.synchronize()
    require(tuple(flow.shape) == (BATCH, h, w, 2), f"{name}: flow shape {tuple(flow.shape)}")
    require(bool(torch.isfinite(flow).all()), f"{name}: non-finite flow")
    d = (flow - flow_p).abs()
    share = float((d <= 2e-3 + 1e-3 * flow_p.abs()).float().mean())
    mean_d = float(d.mean())
    require(share >= 0.999, f"{name}: only {share:.6f} of components match the plain path")
    require(mean_d <= 1e-3, f"{name}: mean |kernel - plain| {mean_d} > 1e-3 px")

    fields = {"flags": cfg.flags, "winsize": cfg.winsize, "launches": launches,
              "vs_plain": {"share_within_tol": share, "mean_abs_diff": mean_d,
                           "max_abs_diff": float(d.max())}}
    del d, flow_p
    if seeded:
        one = calc_flow(prev[0], nxt[0], cfg, seed[0])
        torch.cuda.synchronize()
        require(torch.equal(one, flow[0]), f"{name}: calc_flow != calc_flow_batched[0]")
        fields["calc_flow_equals_batched_0"] = True
        del one
    g = golden[golden_key or f"{h}x{w}"]
    if h > 2 * CROP and w > 2 * CROP:
        inner = flow[:, CROP:h - CROP, CROP:w - CROP]
        truth = torch.tensor(TRUE_FLOW, device=dev)
        epe = float((inner - truth).norm(dim=-1).mean())
        fields["interior_epe_px"] = epe
        fields["jax_interior_epe_px"] = g.get("interior_epe_px")
        if h >= 1080:
            require(epe <= EPE_GATE, f"{name}: interior EPE {epe} > {EPE_GATE} px")

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
        return BATCH / median_s(lambda: sums_of(plain))

    fields["pairs_per_s"] = pairs_per_s(False)
    fields["plain_pairs_per_s"] = pairs_per_s(True)
    fields["card"] = power
    emit(name, h=h, w=w, batch=BATCH, **fields)


def kernel_k4_phase(h: int, w: int, dev, stats) -> None:
    """K4 against its plain version: a B=16 random flow of up to 6 px,
    and one all-zero frame (constant magnitude: value 0)."""
    import torch
    from optical_flow_tpu_torch.kernels.colorize import flow_to_bgr_planar
    from optical_flow_tpu_torch.ops import colorize

    gen = torch.Generator(device=dev).manual_seed(1)
    cases = {
        f"random_B{BATCH}": (torch.rand((BATCH, 2, h, w), generator=gen,
                                        device=dev) - 0.5) * 12.0,
        "zero_B1": torch.zeros((1, 2, h, w), device=dev),
    }
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
        rows.append({"case": label, "shape": list(flow.shape), "max_abs_err": diff,
                     "ms": t_k, "plain_ms": t_p,
                     # flow read by both launches, BGR written once
                     "gb_per_s_at_19_b_per_px": 19 * px / t_k / 1e6})
    del cases
    stats["K4"] = {"ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
                   "max_abs_err": max(r["max_abs_err"] for r in rows)}
    emit("kernel_K4", name=KERNEL_INFO["K4"][0], tolerance="byte-equal",
         cases=rows)


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
    from optical_flow_tpu_torch.pipeline.prefetch import pair_chunk_for
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
    n_chunks = -(-BATCH // chunk)
    expected = {"K3": (n_levels - 1) * n_chunks, "K2": n_levels * n_chunks,
                "K1": n_levels * cfg.iterations * n_chunks, "K4": n_chunks,
                "K5a": 0, "K5b": 0}
    reset_launches()
    bgr = loop(False)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    for kid in ("K1", "K2", "K3", "K4"):
        require(launches[kid] > 0, f"{name}: kernel {kid} was not launched")
    require(launches == expected, f"{name}: launches {launches} != {expected}")
    stats["K4"]["launches"] = launches["K4"]
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


def profile_phase(dev, power) -> None:
    """Where the device time of one 1080p B=16 flow call + magnitude sums
    goes, under flags 0, 256 and 4, each profiled twice: torch.profiler
    over PROFILED calls after WARMUP.  Device work is the sum of the CUDA
    events' device time per call, its busy share that over the profiled
    wall time per call; the largest kernels are listed by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from optical_flow_tpu_torch.models.farneback.flow import calc_flow_batched
    from optical_flow_tpu_torch.ops.polar import magnitude
    from optical_flow_tpu_torch.utils.config import FarnebackConfig

    prev, nxt = frames(1080, 1920, dev)
    seed = torch.as_tensor(seed_flow(BATCH, 1080, 1920)).to(dev)
    for run in range(2):
        for flags in (0, 256, 4):
            cfg = FarnebackConfig(flags=flags)

            def call():
                flow = calc_flow_batched(prev, nxt, cfg, seed)
                return magnitude(flow[..., 0], flow[..., 1]).sum(dim=(-2, -1))

            for _ in range(WARMUP):
                call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(PROFILED):
                    call()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) / PROFILED * 1e3
            by_name = {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3 / PROFILED
            device_ms = sum(by_name.values())
            require(device_ms > 0, f"profile flags {flags}: no device time traced")
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:14]
            emit("profile_1080p", run=run, flags=flags, calls=PROFILED,
                 wall_ms_per_call=wall_ms, device_ms_per_call=device_ms,
                 busy_share=device_ms / wall_ms,
                 top_device_ms_per_call=[[name[:70], ms] for name, ms in top],
                 card=power)


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile the 1080p B=16 flow call under "
                             "flags 0, 256 and 4 (PERF.md section 5)")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from optical_flow_tpu_torch.kernels import _build
    from optical_flow_tpu_torch.utils.config import (
        OPTFLOW_FARNEBACK_GAUSSIAN, OPTFLOW_USE_INITIAL_FLOW, FarnebackConfig)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    power = nvidia_smi_line()
    build_s = _build.build()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=power,
         kernel_build_s=build_s)
    golden = json.loads(GOLDEN.read_text())
    cfg = FarnebackConfig()

    stats = {}
    prev, nxt = frames(1080, 1920, dev)
    kernel_phases(prev, nxt, cfg, stats)
    del prev, nxt
    torch.cuda.empty_cache()
    e2e_phase("e2e_1080p", 1080, 1920, cfg, dev, golden, power, stats)
    e2e_phase("e2e_extractor", 72, 129, cfg, dev, golden, power)
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
    if args.profile:
        torch.cuda.empty_cache()
        profile_phase(dev, power)

    kernels = []
    for kid in ("K3", "K2", "K1", "K4", "K5a", "K5b"):
        name, source, replaces = KERNEL_INFO[kid]
        kernels.append({"name": f"{kid} {name}", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": stats[kid]["launches"],
                        "max_abs_err": stats[kid]["max_abs_err"],
                        "ms": stats[kid]["ms"],
                        "plain_ms": stats[kid]["plain_ms"]})
    print(power)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
