"""On-card differential self test of every CUDA kernel against its plain
PyTorch version: a port of `optical_flow_tpu.utils.selftest`.

`run_selftest()` builds the kernels and runs one case for each of the
JAX self test's 36 shape classes (`_cases`) and its colorize byte gate
(`_colorize_case`), under the same names, shapes and flow geometry,
modifications included: `_spill` (rows 30-32 at dy 45), `_dx_cross`
(dx 300 over 2000 of 7680 columns), `_spill_f` and `_spill_bimodal`
(dy 36 and 100).  Each case draws its inputs with the JAX case's
`np.random.default_rng` recipe, call for call (`Case.inputs`), and holds
the port's kernel route (`Case.cuda`) to its plain version (`Case.plain`)
at the JAX case's tolerance; K4 keeps its byte gate.  JAX case -> port
kernel:

  update_gather/*   K5a `update_matrices`
  blur_solve/*      K5b `blur_solve`
  fused_iterate/*   K1, `update_flow_fused` (the level's iterations)
  fused_blur/*      K1, `update_blur` (one step)
  gauss/*           K6 `gaussian_blur`
  gauss_resize/*    K3 `gauss_resize`
  polyexp/*         K2 `poly_exp`
  colorize/*        K4 `flow_to_bgr_planar`

A JAX case that holds a TPU-only variant (bf16 operands or staging, the
`pair2`/`pair4` store layouts, the multi-level `multi` sweep, the
store-layout padding) keeps its name and shape and runs the port's one
kernel there; where its frames are whole numbers (the bf16 staging's
`exact_u8`), the kernel reads them as uint8, its narrow staging.  The
JAX tolerances are ceilings: the port's kernels follow their plain
versions op for op (`--fmad=false`) and agree to the bit, so any
`max_abs_diff` above 0 is news.

Two groups the JAX self test lacks:
  fused_poly/*        K7 (`update_flow_fused_poly`) at fused_iterate's
                      shapes and spills, against its plain version;
  fused_poly_k2k1/*   the same K7 against K2 -> K1, to the bit;
  pyramid/vertical_jump_1080x1920
                      `calc_flow_batched` at the default config on
                      `vertical_jump_pair(1080, 1920)`, B=2 (strips that
                      jump 40 and 104 rows, the geometry of the TPU's
                      spill tiers), against the plain path with the
                      port's flow gate (>= 99.9 % of components within
                      2e-3 + 1e-3 |ref|, mean <= 1e-3 px); the interior
                      EPE inside and outside the strips is reported, not
                      gated.

Devices: by default the current card, which raises where there is none.
`device="cpu"` runs each case's plain version against itself (the
harness, not the kernels) and says `"kernels": false`, so a CPU verdict
never passes for a card verdict.  A case that raises is reported
`ok: false` with its error, and the verdict is then not ok.

    python -m optical_flow_tpu_torch.utils.selftest [--device cpu] [--quick]

prints the verdict as one JSON object and exits 1 unless it is ok.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from optical_flow_tpu_torch.kernels import _build
from optical_flow_tpu_torch.kernels.blur_solve import blur_solve
from optical_flow_tpu_torch.kernels.colorize import flow_to_bgr_planar
from optical_flow_tpu_torch.kernels.fused_iterate import (update_flow_fused,
                                                          update_flow_fused_poly)
from optical_flow_tpu_torch.kernels.gauss import gaussian_blur
from optical_flow_tpu_torch.kernels.gauss_resize import gauss_resize
from optical_flow_tpu_torch.kernels.polyexp import poly_exp
from optical_flow_tpu_torch.kernels.update_gather import (update_blur,
                                                          update_matrices)
from optical_flow_tpu_torch.models.farneback import core
from optical_flow_tpu_torch.models.farneback.flow import calc_flow_batched
from optical_flow_tpu_torch.models.farneback.params import gaussian_kernel
from optical_flow_tpu_torch.ops import colorize
from optical_flow_tpu_torch.oracle.synthetic import vertical_jump_pair
from optical_flow_tpu_torch.utils.device import resolve_device

POLY_N, POLY_SIGMA = 5, 1.2
PRE_TAPS = tuple(gaussian_kernel(3, 0.0).tolist())
# The flow gate of the whole path against the plain path (PERF.md section 2)
FLOW_ATOL, FLOW_RTOL, FLOW_SHARE, FLOW_MEAN = 2e-3, 1e-3, 0.999, 1e-3
# The colorize byte gate of the JAX self test
BYTE_MAX, BYTE_SHARE = 1, 1e-4
EPE_CROP = 32


@dataclass(frozen=True)
class Case:
    """One differential: `inputs()` draws numpy arrays as the JAX case
    does, `plain(**tensors)` is the plain PyTorch version (any device),
    `cuda(**tensors)` the kernel route (CUDA tensors), held to `against`
    where it is not the plain version (K7 against K2 -> K1)."""
    name: str
    kernel: str
    atol: float
    rtol: float
    inputs: Callable[[], Dict[str, np.ndarray]]
    plain: Callable[..., torch.Tensor]
    cuda: Callable[..., torch.Tensor]
    against: Optional[Callable[..., torch.Tensor]] = None
    gate: str = "close"        # "close", "bytes" (K4) or "flow" (pyramid)


# --- inputs, drawn as the JAX cases draw them -------------------------------

def _psd_M(B, H, W, seed=0) -> np.ndarray:
    """Positive-semidefinite 5-channel M fields (the JAX `_psd_M`)."""
    rng = np.random.default_rng(seed)
    r4, r5, r6, r2, r3 = (rng.standard_normal((B, H, W)).astype(np.float32)
                          for _ in range(5))
    return np.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                     r4 * r2 + r6 * r3, r6 * r2 + r5 * r3], axis=1)


def _update_inputs(H, W, flow_mod=None, B=2):
    rng = np.random.default_rng(0)
    R0 = rng.standard_normal((B, 5, H, W)).astype(np.float32)
    R1 = rng.standard_normal((B, 5, H, W)).astype(np.float32)
    flow = rng.standard_normal((B, 2, H, W)).astype(np.float32) * 2
    if flow_mod is not None:
        flow_mod(flow)
    return {"R0": R0, "R1": R1, "flow": flow}


def _fused_inputs(H, W, flow_mod=None, B=2, seed=7):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (2 * B, H, W)).astype(np.float32)
    flow = rng.standard_normal((B, 2, H, W)).astype(np.float32) * 1.5
    if flow_mod is not None:
        flow_mod(flow)
    return {"img": img, "flow": flow}


def _fused_blur_inputs(H, W, B, seed):
    rng = np.random.default_rng(seed)
    R0 = rng.standard_normal((B, 5, H, W)).astype(np.float32)
    R1 = rng.standard_normal((B, 5, H, W)).astype(np.float32)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    fl0 = np.stack([1.3 + xs / W + 0.5 * ys / H, -0.8 + ys / H])[None]
    flow = np.broadcast_to(fl0, (B, 2, H, W)).astype(np.float32)
    return {"R0": R0, "R1": R1, "flow": flow}


def _uniform_frames(shape, seed):
    return {"img": np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)}


def _integer_frames(shape, seed):
    return {"img": np.random.default_rng(seed).integers(0, 256, shape).astype(np.float32)}


def _spill(flow):
    flow[:, 1, 30:32, 100:160] = 45.0       # escapes the TPU's 32-row window


def _dx_cross(flow):
    flow[:, 0, :, :2000] = 300.0            # sources 2+ TPU column chunks away


def _spill_f(flow):
    flow[:, 1, 30:34, 100:200] = 45.0


def _spill_bimodal(flow):
    flow[:, 1, 4:6, 100:160] = 36.0
    flow[:, 1, 4:6, 300:360] = 100.0


# --- the cases --------------------------------------------------------------

def _as_u8(img: torch.Tensor) -> torch.Tensor:
    """Whole-number f32 frames as uint8, the kernels' narrow staging."""
    return img.to(torch.uint8)


def _fused_plain(ws, iters):
    def plain(img, flow):
        B = flow.shape[0]
        R = core.poly_exp(img, POLY_N, POLY_SIGMA)
        return core.update_flow(R[:B], R[B:], flow, ws, iters)
    return plain


def _fused_k1(ws, iters):
    def cuda(img, flow):
        B = flow.shape[0]
        R = core.poly_exp(img, POLY_N, POLY_SIGMA)
        return update_flow_fused(R[:B], R[B:], flow, ws, iters)
    return cuda


def _fused_k7(ws, iters):
    def cuda(img, flow):
        B = flow.shape[0]
        return update_flow_fused_poly(img[:B], img[B:], flow, ws, iters,
                                      poly_n=POLY_N, poly_sigma=POLY_SIGMA)
    return cuda


def _fused_k2_k1(ws, iters):
    def cuda(img, flow):
        B = flow.shape[0]
        R = poly_exp(img, POLY_N, POLY_SIGMA)
        return update_flow_fused(R[:B], R[B:], flow, ws, iters)
    return cuda


def _levels(specs, kernel: bool, u8: bool):
    """Each (scale, taps) level of the frames, flattened per frame and
    concatenated: the JAX multi-level case's layout."""
    def run(img):
        n, h, w = img.shape
        src = _as_u8(img) if kernel and u8 else img
        fn = gauss_resize if kernel else core.gaussian_blur_resize
        return torch.cat([fn(src, taps, w // s, h // s).reshape(n, -1)
                          for s, taps in specs], 1)
    return run


def _cases(quick: bool = False) -> List[Case]:
    cases: List[Case] = []

    def add(name, kernel, atol, rtol, inputs, plain, cuda, *, in_quick=False,
            **extra):
        if quick and not in_quick:
            return
        cases.append(Case(name, kernel, atol, rtol, inputs, plain, cuda, **extra))

    # update_gather -> K5a
    def update(name, H, W, flow_mod=None, B=2, in_quick=False):
        add(name, "K5a", 5e-4, 1e-4,
            lambda: _update_inputs(H, W, flow_mod, B),
            core.update_matrices, update_matrices, in_quick=in_quick)

    update("update_gather/aligned_64x512", 64, 512)
    update("update_gather/unaligned_60x130", 60, 130, in_quick=True)
    update("update_gather/spill_tier2", 64, 512, _spill)
    update("update_gather/chunked_8k_40x7680", 40, 7680, B=1)
    update("update_gather/chunked_8k_dx_40x7680", 40, 7680, _dx_cross, B=1)
    update("update_gather/chunked_unaligned_40x5003", 40, 5003, B=1)

    # blur_solve -> K5b
    def blur(name, H, W, ws, gaussian=False, in_quick=False):
        add(name, "K5b", 1e-3, 1e-3, lambda: {"M": _psd_M(2, H, W)},
            lambda M: core.blur_solve(M, ws, gaussian),
            lambda M: blur_solve(M, ws, gaussian), in_quick=in_quick)

    blur("blur_solve/aligned_24x256_ws15", 24, 256, 15, in_quick=True)
    blur("blur_solve/unaligned_33x257_ws21", 33, 257, 21)
    blur("blur_solve/gaussian_32x256_ws15", 32, 256, 15, gaussian=True)

    # fused_iterate -> K1 over a level's iterations; the same geometry
    # again on K7, against its plain version and against K2 -> K1
    fused_geometry = [
        ("store_64x512", 64, 512, 2, None, 2, False),
        ("store_unaligned_70x257", 70, 257, 1, None, 2, True),
        ("store_spill", 64, 512, 2, _spill_f, 2, False),
        ("chunked_8k_48x7680", 48, 7680, 2, None, 1, False),
        ("chunked_spill_128x5000", 128, 5000, 2, _spill_bimodal, 1, False),
    ]
    for suffix, H, W, iters, mod, B, in_quick in fused_geometry:
        add(f"fused_iterate/{suffix}", "K1", 2e-3, 1e-3,
            lambda H=H, W=W, mod=mod, B=B: _fused_inputs(H, W, mod, B),
            _fused_plain(15, iters), _fused_k1(15, iters), in_quick=in_quick)
    add("fused_iterate/bf16_bitwise_64x512", "K1", 0.0, 0.0,
        lambda: _fused_inputs(64, 512, seed=11),
        _fused_plain(15, 2), _fused_k1(15, 2))

    # gauss -> K6
    def gauss(name, ks, sigma, H=50, W=200, B=2, in_quick=False):
        taps = gaussian_kernel(ks, sigma)
        add(name, "K6", 1e-3, 1e-5, lambda: _uniform_frames((B, H, W), 0),
            lambda img: core.gaussian_blur_reflect101(img, taps),
            lambda img: gaussian_blur(img, taps), in_quick=in_quick)

    gauss("gauss/ks9", 9, 1.5, in_quick=True)
    gauss("gauss/chunked_8k_ks19_48x7680", 19, 3.5, H=48, W=7680, B=1)

    # gauss_resize -> K3
    def gresize(name, H, W, s, ks, sigma, atol=1e-3, rtol=1e-5, seed=0,
                frames=_uniform_frames, in_quick=False):
        taps = gaussian_kernel(ks, sigma)
        u8 = frames is _integer_frames
        add(name, "K3", atol, rtol, lambda: frames((2, H, W), seed),
            lambda img: core.gaussian_blur_resize(img, taps, W // s, H // s),
            lambda img: gauss_resize(_as_u8(img) if u8 else img, taps,
                                     W // s, H // s), in_quick=in_quick)

    gresize("gauss_resize/64x256_s2", 64, 256, 2, 3, 0.5)
    gresize("gauss_resize/unaligned_48x136_s2", 48, 136, 2, 3, 0.5, in_quick=True)
    gresize("gauss_resize/chunked_8k_64x7680_s8", 64, 7680, 8, 19, 3.5)

    # polyexp -> K2
    def poly(name, H, W, seed, pre=None, atol=2e-2, rtol=1e-5, n=2,
             frames=_uniform_frames, in_quick=False):
        u8 = frames is _integer_frames
        add(name, "K2", atol, rtol, lambda: frames((n, H, W), seed),
            lambda img: core.poly_exp(img, POLY_N, POLY_SIGMA, pre),
            lambda img: poly_exp(_as_u8(img) if u8 else img, POLY_N,
                                 POLY_SIGMA, pre), in_quick=in_quick)

    poly("polyexp/aligned_32x256", 32, 256, 3)
    poly("polyexp/unaligned_40x130", 40, 130, 3, in_quick=True)
    poly("polyexp/chunked_32x1200", 32, 1200, 3)
    poly("polyexp/pre_smooth_32x256", 32, 256, 5, PRE_TAPS)
    poly("polyexp/pre_smooth_border_33x257", 33, 257, 5, PRE_TAPS)
    poly("polyexp/pre_smooth_bf16_bitwise_33x257", 33, 257, 6, PRE_TAPS, 0.0, 0.0,
         frames=_integer_frames)
    poly("polyexp/pair2_bitwise_48x200", 48, 200, 9, PRE_TAPS, 0.0, 0.0, n=4,
         frames=_integer_frames)
    poly("polyexp/pair4_bitwise_48x200", 48, 200, 9, PRE_TAPS, 0.0, 0.0, n=4,
         frames=_integer_frames)

    # fused_blur -> K1, one step
    def fused_blur(name, H, W, B=2, gaussian=False, seed=0):
        add(name, "K1", 0.0, 0.0, lambda: _fused_blur_inputs(H, W, B, seed),
            lambda R0, R1, flow: core.update_step(R0, R1, flow, 15, gaussian),
            lambda R0, R1, flow: update_blur(R0, R1, flow, 15, gaussian))

    fused_blur("fused_blur/bitwise_64x200", 64, 200)
    fused_blur("fused_blur/bitwise_split_patch_57x130", 57, 130, B=1, seed=1)
    fused_blur("fused_blur/bitwise_gaussian_64x200", 64, 200, B=1, gaussian=True, seed=2)
    fused_blur("fused_blur/bitwise_4k_48x3840", 48, 3840, B=1, seed=3)

    gresize("gauss_resize/bf16_bitwise_128x256_s4", 128, 256, 4, 9, 1.5, 0.0, 0.0,
            seed=7, frames=_integer_frames)
    gresize("gauss_resize/bf16_bitwise_8k_64x7680_s8", 64, 7680, 8, 19, 3.5,
            0.0, 0.0, seed=7, frames=_integer_frames)

    # the multi-level sweep -> K3, one launch per level
    specs = tuple((2 ** k, gaussian_kernel(ks, sg))
                  for k, ks, sg in [(3, 19, 3.5), (2, 9, 1.5), (1, 3, 0.5)])
    for name, H, W, u8, in_quick in [
            ("gauss_resize/multi_bitwise_128x256", 128, 256, False, True),
            ("gauss_resize/multi_bitwise_bf16_192x384", 192, 384, True, False)]:
        add(name, "K3", 0.0, 0.0, lambda H=H, W=W: _integer_frames((2, H, W), 9),
            _levels(specs, False, u8), _levels(specs, True, u8), in_quick=in_quick)

    # colorize -> K4, the byte gate
    add("colorize/u8_48x200", "K4", 0.0, 0.0,
        lambda: {"flow": np.random.default_rng(11).standard_normal(
            (2, 2, 48, 200)).astype(np.float32) * 8},
        colorize.flow_to_bgr_planar, flow_to_bgr_planar, in_quick=True,
        gate="bytes")

    # K7 at fused_iterate's geometry: against its plain version, and
    # against K2 -> K1 to the bit
    for suffix, H, W, iters, mod, B, in_quick in fused_geometry:
        inputs = (lambda H=H, W=W, mod=mod, B=B: _fused_inputs(H, W, mod, B))
        add(f"fused_poly/{suffix}", "K7", 2e-3, 1e-3, inputs,
            _fused_plain(15, iters), _fused_k7(15, iters), in_quick=in_quick)
        add(f"fused_poly_k2k1/{suffix}", "K7", 0.0, 0.0, inputs,
            _fused_plain(15, iters), _fused_k7(15, iters),
            against=_fused_k2_k1(15, iters))

    add("pyramid/vertical_jump_1080x1920", "pyramid", FLOW_ATOL, FLOW_RTOL,
        lambda: _jump_inputs(1080, 1920),
        lambda prev, nxt: calc_flow_batched(prev, nxt, plain=True),
        lambda prev, nxt: calc_flow_batched(prev, nxt), gate="flow")
    return cases


# --- the pyramid on vertical_jump_pair ---------------------------------------

JUMPS = ((0.37, 0.445, 40), (0.46, 0.535, 104))


def _jump_inputs(h: int, w: int, B: int = 2):
    f1, f2 = vertical_jump_pair(h, w, JUMPS)
    return {"prev": np.stack([f1] * B), "nxt": np.stack([f2] * B)}


def strip_epe(flow: torch.Tensor, jumps=JUMPS, crop: int = EPE_CROP) -> dict:
    """Mean endpoint error of (B, H, W, 2) flow against the jump pair's
    true flow, (0, dy) in a strip and 0 elsewhere, inside the crop-px
    interior: over the strips' rows and over the other rows."""
    h, w = flow.shape[1:3]
    truth = torch.zeros_like(flow)
    in_strip = torch.zeros(h, dtype=torch.bool, device=flow.device)
    for r0f, r1f, dy in jumps:
        r0, r1 = int(h * r0f), int(h * r1f)
        truth[:, r0:r1, :, 1] = float(dy)
        in_strip[r0:r1] = True
    epe = (flow - truth).norm(dim=-1)[:, crop:h - crop, crop:w - crop]
    rows = in_strip[crop:h - crop]
    return {"epe_in_strips": float(epe[:, rows].mean()),
            "epe_outside": float(epe[:, ~rows].mean())}


# --- running ----------------------------------------------------------------

def _compare(case: Case, out: torch.Tensor, ref: torch.Tensor) -> dict:
    if case.gate == "bytes":
        diff = (out.int() - ref.int()).abs()
        n_bad = int((diff > 0).sum())
        frac = n_bad / diff.numel()
        return {"max_abs_diff": float(diff.max()), "mismatched_bytes": n_bad,
                "mismatched_frac": frac,
                "ok": bool(int(diff.max()) <= BYTE_MAX and frac <= BYTE_SHARE)}
    err = (out - ref).abs()
    within = err <= case.atol + case.rtol * ref.abs()
    entry = {"max_abs_diff": float(err.max()), "atol": case.atol, "rtol": case.rtol}
    if case.gate == "flow":
        share, mean = float(within.float().mean()), float(err.mean())
        entry.update(share_within=share, mean_abs_diff=mean,
                     ok=bool(share >= FLOW_SHARE and mean <= FLOW_MEAN),
                     **strip_epe(out))
    else:
        entry["ok"] = bool(within.all())
    return entry


def run_case(case: Case, device: torch.device) -> dict:
    """One case on `device`: the kernel route against its reference on a
    card, the plain version against itself on the CPU."""
    t = {k: torch.as_tensor(np.ascontiguousarray(v)).to(device)
         for k, v in case.inputs().items()}
    if device.type == "cuda":
        ref = (case.against or case.plain)(**t)
        out = case.cuda(**t)
        torch.cuda.synchronize(device)
    else:
        ref = out = case.plain(**t)
    return _compare(case, out, ref)


def run_selftest(device=None, quick: bool = False) -> dict:
    """Every case on `device` (by default the current card; "cpu" runs
    plain against plain).  Returns the JSON-ready verdict."""
    device = resolve_device(device)
    kernels = device.type == "cuda"
    verdict = {"device": device.type, "kernels": kernels}
    if kernels:
        report = _build.build()
        verdict.update(card=torch.cuda.get_device_name(device),
                       build_s=report.seconds, nvcc_runs=report.nvcc_runs)
    results = []
    for case in _cases(quick):
        entry = {"name": case.name, "kernel": case.kernel}
        try:
            entry.update(run_case(case, device))
        except Exception as e:   # reported in the verdict, which then fails
            entry.update(ok=False, error=repr(e))
        results.append(entry)
        if kernels:
            torch.cuda.empty_cache()
    worst: Dict[str, float] = {}
    for r in results:
        if "max_abs_diff" in r:
            worst[r["kernel"]] = max(worst.get(r["kernel"], 0.0), r["max_abs_diff"])
    verdict.update(n_cases=len(results),
                   n_failed=sum(1 for r in results if not r["ok"]),
                   ok=all(r["ok"] for r in results),
                   max_abs_diff=worst, cases=results)
    return verdict


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (the current card, the default) or cpu "
                             "(the plain versions against themselves)")
    parser.add_argument("--quick", action="store_true",
                        help="one or two small cases per kernel")
    args = parser.parse_args(argv)
    verdict = run_selftest(args.device, quick=args.quick)
    print(json.dumps(verdict))
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
