"""The port's packaging, exports and kernel routing, on the CPU.

- Every header a CUDA source includes ships with the package: each
  `#include "..."` under `optical_flow_tpu_torch/csrc/` matches a
  package-data glob of `pyproject.toml`, so an installed package builds.
- Each subpackage re-exports the names of the JAX package's `__all__`
  that the port has, at the same paths, as the same objects as at their
  modules; `parallel` all ten of JAX's.
- Each re-exported callable, and the prefetch module's, takes the JAX
  counterpart's parameters (names, kinds, defaults, positions), plus only
  the keyword-only additions listed in KEYWORD_ADDITIONS; the two halo
  names differ as DIFFERENT lists.
- The redesigned K1 and K3 take every level they took before: K1 every
  winsize up to 61 (no wider, so winsize 63 stays on K5a -> K5b), K3 every
  level of the pyramids below that it took, pinned as literals; the
  redesigned K2 every poly_n up to 96, and K5b's strip kernel every window
  up to 261 (the tile kernel the rest).
"""

import fnmatch
import importlib
import re
import tomllib
from pathlib import Path

import pytest

from optical_flow_tpu_torch.kernels import polyexp, update_gather
from optical_flow_tpu_torch.kernels.blur_solve import k5b_smem, k5b_strip_fits
from optical_flow_tpu_torch.kernels.gauss_resize import _tile, k3_fits
from optical_flow_tpu_torch.kernels.update_gather import k1_fits, k1_smem
from optical_flow_tpu_torch.kernels import MAX_SMEM
from optical_flow_tpu_torch.models.farneback.params import build_plan
from optical_flow_tpu_torch.utils.config import FarnebackConfig

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "optical_flow_tpu_torch" / "csrc"


def _package_data_globs():
    data = tomllib.loads((REPO / "pyproject.toml").read_text())
    return data["tool"]["setuptools"]["package-data"]["optical_flow_tpu_torch"]


@pytest.mark.parametrize("source", sorted(p.name for p in CSRC.iterdir()
                                          if p.suffix in (".cu", ".cuh")))
def test_every_csrc_file_and_include_ships(source):
    globs = _package_data_globs()
    names = [source] + re.findall(r'#include\s+"([^"]+)"', (CSRC / source).read_text())
    for name in names:
        assert (CSRC / name).exists(), f"{source} includes a missing {name}"
        assert any(fnmatch.fnmatch(f"csrc/{name}", g) for g in globs), (
            f"{source}: csrc/{name} matches no package-data glob in {globs}")


# subpackage -> {name: module that defines it}
EXPORTS = {
    "": {"FarnebackConfig": "utils.config", "ExtractorConfig": "utils.config"},
    "models": {n: "models.farneback.flow" for n in (
        "calc_flow", "calc_flow_batched", "calc_flow_bgr_batched",
        "calc_flow_chain_batched", "calc_flow_bgr_chain_batched")},
    "models.farneback": {
        **{n: "models.farneback.flow" for n in (
            "calc_flow", "calc_flow_batched", "calc_flow_bgr_batched",
            "calc_flow_chain_batched", "calc_flow_bgr_chain_batched")},
        **{n: "models.farneback.params" for n in (
            "FarnebackPlan", "build_plan", "effective_levels", "poly_exp_weights")}},
    "ops": {"bgr2gray_u8": "ops.color", "hsv2bgr_u8": "ops.color",
            "cart_to_polar": "ops.polar", "normalize_minmax_u8_value": "ops.polar",
            "resize_bilinear_f32": "ops.resize", "resize_area_f32": "ops.resize",
            "resize_u8_cv": "ops.resize", "resize_frame_u8": "ops.resize",
            "aspect_preserving_size": "ops.resize", "flow_to_bgr_u8": "ops.colorize"},
    "pipeline": {"extract_video": "pipeline.extractor",
                 "scale_magnitudes": "pipeline.extractor",
                 "run_corpus": "pipeline.extractor",
                 "visualize_shot": "pipeline.visualizer"},
    "parallel": {"shard_videoids": "parallel.corpus",
                 "HaloKernels": "parallel.halo", "halo_extend": "parallel.halo",
                 **{n: "parallel.mesh" for n in (
                     "make_mesh", "shard_pairs", "chain_shards", "sharded_flow_step",
                     "sharded_bgr_step", "sharded_extract_step",
                     "sharded_bgr_chain_step")}},
    "utils": {"FarnebackConfig": "utils.config", "ExtractorConfig": "utils.config",
              "get_logger": "utils.logging"},
    "oracle": {n: "oracle.synthetic" for n in (
        "smooth_texture_pair", "motion_boundary_pair", "quadratic_pair",
        "vertical_jump_pair", "write_synthetic_video")},
    "io": {"VideoReader": "io.video", "write_jpeg_bgr": "io.jpeg",
           "write_mag_to_csv": "io.sidecar", "DoneSentinel": "io.sidecar"},
}


def _module(pkg: str, sub: str):
    return importlib.import_module(f"{pkg}.{sub}" if sub else pkg)


@pytest.mark.parametrize("sub", sorted(EXPORTS))
def test_reexports_are_the_modules_objects(sub):
    port = _module("optical_flow_tpu_torch", sub)
    assert sorted(port.__all__) == sorted(set(EXPORTS[sub]) | ({"__version__"}
                                                                if not sub else set()))
    for name, module in EXPORTS[sub].items():
        got = getattr(port, name)
        assert got is getattr(_module("optical_flow_tpu_torch", module), name), name
        ns = {}
        exec(f"from {port.__name__} import {name}", ns)
        assert ns[name] is got


@pytest.mark.parametrize("sub", sorted(EXPORTS))
def test_reexports_are_named_as_in_the_jax_package(sub):
    """Every name the port exports stands in the JAX package's __all__ at
    the same path."""
    jax_all = set(_module("optical_flow_tpu", sub).__all__)
    assert set(EXPORTS[sub]) <= jax_all, set(EXPORTS[sub]) - jax_all


def test_parallel_exports_all_of_jax_s_names():
    assert sorted(_module("optical_flow_tpu_torch", "parallel").__all__) == sorted(
        _module("optical_flow_tpu", "parallel").__all__)


# Keyword-only parameters a port callable adds to its JAX counterpart's:
# where to run, and the plain versions as the card's reference.
KEYWORD_ADDITIONS = {
    **{("models", n): {"device", "plain"} for n in (
        "calc_flow_batched", "calc_flow_bgr_batched", "calc_flow_chain_batched",
        "calc_flow_bgr_chain_batched")},
    **{("models.farneback", n): {"device", "plain"} for n in (
        "calc_flow_batched", "calc_flow_bgr_batched", "calc_flow_chain_batched",
        "calc_flow_bgr_chain_batched")},
    ("pipeline", "extract_video"): {"device"},
    ("pipeline", "run_corpus"): {"device"},
    ("pipeline", "visualize_shot"): {"device"},
    ("pipeline.prefetch", "pair_chunk_for"): {"device"},
}
# Signatures that differ otherwise: the port's parameter names, and why.
DIFFERENT = {
    ("parallel", "HaloKernels"): (
        ["self", "mesh"],
        "no use_pallas: a block on a card runs the kernel, on the CPU its plain "
        "version, by the tensor's device"),
    ("parallel", "halo_extend"): (
        ["blocks", "r", "mode"],
        "the spatial group's blocks in one process (peer copies); JAX's runs "
        "inside shard_map, per shard, with the group size and an axis name"),
}
# Module-level names the pipelines' signatures rest on, pinned as well.
PINNED = {"pipeline.prefetch": ("DecodePrefetcher", "pair_chunk_for",
                                "default_decode_workers")}
CALLABLES = sorted({(sub, n) for sub, names in EXPORTS.items() for n in names}
                   | {(m, n) for m, names in PINNED.items() for n in names})


def _params(obj):
    import inspect
    sig = inspect.signature(obj.__init__ if inspect.isclass(obj) else obj)
    return [(q.name, q.kind, None if q.default is q.empty else repr(q.default))
            for q in sig.parameters.values()]


@pytest.mark.parametrize("sub,name", CALLABLES)
def test_signature_is_jax_s(sub, name):
    """Each re-exported callable takes the JAX counterpart's parameters,
    names, kinds and defaults, at the same positions; the port adds only
    the keyword-only parameters of KEYWORD_ADDITIONS, and the callables of
    DIFFERENT differ as listed there."""
    import inspect
    port = _params(getattr(_module("optical_flow_tpu_torch", sub), name))
    ref = _params(getattr(_module("optical_flow_tpu", sub), name))
    if (sub, name) in DIFFERENT:
        assert [q[0] for q in port] == DIFFERENT[(sub, name)][0]
        return
    added = KEYWORD_ADDITIONS.get((sub, name), set())
    assert {q[0] for q in port if q[0] in added} == added
    assert all(q[1] is inspect.Parameter.KEYWORD_ONLY for q in port if q[0] in added)
    assert [q for q in port if q[0] not in added] == ref


def test_unknown_lazy_name_raises_attribute_error():
    mod = importlib.import_module("optical_flow_tpu_torch.models.farneback")
    with pytest.raises(AttributeError):
        mod.no_such_name
    assert "calc_flow_batched" in dir(mod)


def test_k1_takes_every_winsize_up_to_61():
    assert all(k1_fits(w) for w in range(1, 62))
    assert not k1_fits(63)
    assert k1_smem(61) <= MAX_SMEM


def test_k2_takes_every_poly_n_up_to_96():
    assert all(polyexp.k2_fits(n) for n in range(1, 97))
    assert not polyexp.k2_fits(97) and not polyexp.k2_fits(0)


# K2's tile per (poly_n, width, element size, pre-smooth): (tile_w,
# tile_h, band staged, shared memory bytes)
K2_TILES = {
    (5, 1920, 1, True): (128, 16, True, 41248),
    (5, 960, 4, False): (64, 16, True, 22720),
    (5, 480, 4, False): (128, 16, True, 41664),
    (5, 240, 4, False): (128, 16, True, 41664),
    (5, 129, 1, True): (32, 16, True, 13040),
    (7, 1920, 1, True): (128, 16, True, 44736),
    (11, 1920, 1, True): (128, 16, True, 56912),
    (96, 1920, 1, True): (32, 16, False, 229568),
    (96, 1920, 4, False): (32, 16, False, 229568),
}


@pytest.mark.parametrize("key", sorted(K2_TILES))
def test_k2_tile(key):
    assert polyexp._tile(*key) == K2_TILES[key]


# K7's launch per (winsize, poly_n, tile width): (shared-memory bytes, floats
# of the region the staged images, their vertical sums and the row sums
# share), as `plan` in csrc/update_blur_poly.cu; None: no launch
K7_PLANS = {
    (15, 5, 32): (115712, 18333),     # two blocks an SM, 1080p's window
    (15, 5, 64): (232448, 40157),
    (1, 5, 32): (115712, 23807),
    (3, 7, 32): (115712, 23145),
    (21, 5, 32): (115712, 15387),
    (23, 5, 32): (232448, 43509),     # R0's sums of every row miss the share
    (61, 5, 32): (232448, 15731),     # R0 in bands
    (61, 7, 32): (232448, 15731),
    (61, 5, 64): None,
    (3, 96, 32): (232448, 52329),
    (63, 5, 32): None,
}


@pytest.mark.parametrize("key", sorted(K7_PLANS, key=str))
def test_k7_plan(key):
    assert update_gather._k7_plan(*key) == K7_PLANS[key]


def test_k7_takes_what_it_took_before_its_redesign():
    """k7_fits: poly_n 1..96 within the constants and a plan at 32
    columns, the same (winsize, poly_n) as the former kernel's formula
    (M on the tile and halo, the staged img0 or the row sums, the taps):
    every winsize up to 61 at poly_n 5 and 7."""
    def former(winsize, poly_n):
        m = winsize // 2
        mh = 32 + 2 * m
        staged = max((mh + 2 * poly_n) ** 2, 5 * mh * 32)
        return 1 <= poly_n <= 96 and 4 * (5 * mh * mh + staged + 2 * m + 1) <= MAX_SMEM

    for winsize in range(1, 130):
        for poly_n in range(0, 98):
            assert update_gather.k7_fits(winsize, poly_n) == former(winsize, poly_n)
    assert all(update_gather.k7_fits(w, n) for w in range(1, 62) for n in (5, 7))
    assert not update_gather.k7_fits(63, 5)
    # 64 columns where they fit (1080p's winsize 15), else 32
    assert update_gather._k7_tile(15, 5) == 64 and update_gather._k7_tile(61, 7) == 32
    assert max(w for w in range(1, 62) if update_gather._k7_tile(w, 5) == 64) == 37


def test_k5b_strip_takes_every_winsize_up_to_261():
    assert all(k5b_strip_fits(w) for w in range(1, 262))
    assert not any(k5b_strip_fits(w) for w in (262, 263, 301, 401))
    assert k5b_smem(63) == 74708 and k5b_smem(15) == 36692


# The levels K3 took before its redesign, per pyramid: (level, taps,
# height, width, taken); the levels it did not take run K6.
K3_ROUTES = {
    (1080, 1920, 3): [(3, 19, 135, 240, True), (2, 9, 270, 480, True),
                      (1, 3, 540, 960, True)],
    (72, 129, 3): [(1, 3, 36, 64, True)],
    (37, 53, 3): [],
    (4320, 7680, 3): [(3, 19, 540, 960, True), (2, 9, 1080, 1920, True),
                      (1, 3, 2160, 3840, True)],
    (1080, 1920, 5): [(5, 79, 34, 60, False), (4, 39, 68, 120, False),
                      (3, 19, 135, 240, True), (2, 9, 270, 480, True),
                      (1, 3, 540, 960, True)],
    (720, 1280, 5): [(4, 39, 45, 80, False), (3, 19, 90, 160, True),
                     (2, 9, 180, 320, True), (1, 3, 360, 640, True)],
}


@pytest.mark.parametrize("h,w,levels", sorted(K3_ROUTES))
def test_k3_takes_the_levels_it_took(h, w, levels):
    plan = build_plan(h, w, FarnebackConfig(levels=levels))
    got = [(lv.k, lv.smooth_ksize, lv.height, lv.width,
            k3_fits(lv.smooth_ksize, h, w, lv.width))
           for lv in plan.levels if lv.k > 0]
    assert sorted(got) == sorted(K3_ROUTES[(h, w, levels)])
    for k, ntaps, oh, ow, taken in got:
        if taken:     # a tile for either frame type fits a block
            for esize in (1, 4):
                assert _tile(ntaps, h, w, oh, ow, esize)[5] <= MAX_SMEM


@pytest.mark.parametrize("ntaps", [1, 3, 9, 19, 31])
@pytest.mark.parametrize("h,w", [(37, 53), (72, 129), (33, 257), (4320, 7680)])
def test_k3_takes_small_frames_at_every_tap_count(h, w, ntaps):
    for oh, ow in ((h // 2, w // 2), (2 * h, 2 * w), (1, 1)):
        assert k3_fits(ntaps, h, w, ow)
        assert _tile(ntaps, h, w, oh, ow, 4)[5] <= MAX_SMEM
    assert not k3_fits(33, h, w, w // 2)
