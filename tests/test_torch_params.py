"""The port's host-side copies (config, params, synthetic oracle) against the
JAX package's originals: exact equality, since both are the same numpy
arithmetic and feed the kernels' constants."""

import dataclasses

import numpy as np
import pytest

from optical_flow_tpu.models.farneback import params as jparams
from optical_flow_tpu.oracle import synthetic as jsyn
from optical_flow_tpu.utils import config as jconfig
from optical_flow_tpu_torch.models.farneback import params as tparams
from optical_flow_tpu_torch.oracle import synthetic as tsyn
from optical_flow_tpu_torch.utils import config as tconfig

SIZES = [(1080, 1920), (72, 129), (96, 128), (33, 257)]
CONFIGS = [
    {},
    {"pyr_scale": 0.4, "levels": 5, "winsize": 9, "iterations": 2,
     "poly_n": 7, "poly_sigma": 1.5},
]


@pytest.mark.parametrize("cfg_kw", CONFIGS)
@pytest.mark.parametrize("h,w", SIZES)
def test_build_plan_matches_jax(h, w, cfg_kw):
    tp = tparams.build_plan(h, w, tconfig.FarnebackConfig(**cfg_kw))
    jp = jparams.build_plan(h, w, jconfig.FarnebackConfig(**cfg_kw))
    assert (tp.height, tp.width) == (jp.height, jp.width)
    assert ([dataclasses.astuple(lv) for lv in tp.levels]
            == [dataclasses.astuple(lv) for lv in jp.levels])
    assert dataclasses.asdict(tp.config) == dataclasses.asdict(jp.config)


@pytest.mark.parametrize("h,w", SIZES)
def test_level_gaussians_match_jax(h, w):
    for lv in tparams.build_plan(h, w, tconfig.FarnebackConfig()).levels:
        t = tparams.gaussian_kernel(lv.smooth_ksize, lv.smooth_sigma)
        j = jparams.gaussian_kernel(lv.smooth_ksize, lv.smooth_sigma)
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("n,sigma", [(3, 0.0), (5, 0.0), (7, 0.0), (9, 1.5),
                                     (19, 3.5), (11, 0.0)])
def test_gaussian_kernel_matches_jax(n, sigma):
    np.testing.assert_array_equal(tparams.gaussian_kernel(n, sigma),
                                  jparams.gaussian_kernel(n, sigma))


@pytest.mark.parametrize("poly_n,poly_sigma", [(5, 1.2), (7, 1.5), (3, 0.0)])
def test_poly_exp_weights_match_jax(poly_n, poly_sigma):
    t = tparams.poly_exp_weights(poly_n, poly_sigma)
    j = jparams.poly_exp_weights(poly_n, poly_sigma)
    for a, b in zip(t[:3], j[:3]):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert t[3:] == j[3:]


def test_effective_levels_and_cv_round_match_jax():
    for h, w in SIZES + [(64, 64), (63, 200), (126, 126), (256, 300)]:
        for levels in (1, 3, 6):
            assert (tparams.effective_levels(h, w, levels, 0.5)
                    == jparams.effective_levels(h, w, levels, 0.5))
    for x in (0.5, 1.5, 2.5, -0.5, 64.5, 3.49):
        assert tparams.cv_round(x) == jparams.cv_round(x)


@pytest.mark.parametrize("cfg_kw", CONFIGS + [{"flags": 256}])
def test_config_from_jax_round_trips(cfg_kw):
    jcfg = jconfig.FarnebackConfig(**cfg_kw)
    for src in (jcfg, dataclasses.asdict(jcfg)):
        tcfg = tconfig.config_from_jax(src)
        assert isinstance(tcfg, tconfig.FarnebackConfig)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.gaussian_window == jcfg.gaussian_window
    assert tcfg.use_initial_flow == jcfg.use_initial_flow
    assert (tconfig.OPTFLOW_FARNEBACK_GAUSSIAN, tconfig.OPTFLOW_USE_INITIAL_FLOW) \
        == (jconfig.OPTFLOW_FARNEBACK_GAUSSIAN, jconfig.OPTFLOW_USE_INITIAL_FLOW)


def test_visualizer_config_matches_jax():
    t, j = tconfig.VisualizerConfig(), jconfig.VisualizerConfig()
    assert ([f.name for f in dataclasses.fields(t)]
            == [f.name for f in dataclasses.fields(j)])
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    with pytest.raises(dataclasses.FrozenInstanceError):
        t.step_size = 1


@pytest.mark.parametrize("kw", [{}, {"frame_width": 0, "step_size": 600,
                                    "window_size": 1200, "top_percentile": 10,
                                    "force_run": "True", "resume": True}])
def test_extractor_config_matches_jax(kw):
    """The same fields and defaults, and the same .done content, which the
    reference, the JAX package and the port accept from one another."""
    t, j = tconfig.ExtractorConfig(**kw), jconfig.ExtractorConfig(**kw)
    assert ([f.name for f in dataclasses.fields(t)]
            == [f.name for f in dataclasses.fields(j)])
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.done_version == j.done_version
    assert (tconfig.EXTRACTOR, tconfig.VERSION) == (jconfig.EXTRACTOR, jconfig.VERSION)
    with pytest.raises(dataclasses.FrozenInstanceError):
        t.frame_width = 1


def test_config_validate_rejects_like_jax():
    for bad in ({"pyr_scale": 1.0}, {"levels": 0}, {"winsize": 0},
                {"iterations": 0}, {"poly_n": 0}):
        with pytest.raises(ValueError):
            jconfig.FarnebackConfig(**bad).validate()
        with pytest.raises(ValueError):
            tconfig.FarnebackConfig(**bad).validate()


@pytest.mark.parametrize("h,w,shift,seed", [(72, 129, (2, 3), 42),
                                            (96, 128, (1, 2), 42),
                                            (33, 57, (-2, 3), 5)])
def test_smooth_texture_pair_byte_equal(h, w, shift, seed):
    for a, b in zip(tsyn.smooth_texture_pair(h, w, shift, seed=seed),
                    jsyn.smooth_texture_pair(h, w, shift, seed=seed)):
        assert a.dtype == b.dtype == np.uint8
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("h,w", [(96, 128), (72, 129)])
def test_motion_boundary_pair_byte_equal(h, w):
    for a, b in zip(tsyn.motion_boundary_pair(h, w),
                    jsyn.motion_boundary_pair(h, w)):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("winsize", range(2, 32))
def test_gaussian_window_kernel_matches_jax(winsize):
    from optical_flow_tpu.models.farneback import core as jcore
    from optical_flow_tpu_torch.models.farneback import core as tcore

    t, j = tcore.gaussian_window_kernel(winsize), jcore.gaussian_window_kernel(winsize)
    assert t.dtype == j.dtype == np.float32
    assert t.tobytes() == j.tobytes()


def test_gaussian_window_kernel_winsize_1_is_refused():
    """The reference's sigma-0 window is NaN (0 / 0); the port raises."""
    from optical_flow_tpu.models.farneback import core as jcore
    from optical_flow_tpu_torch.models.farneback import core as tcore

    with np.errstate(invalid="ignore"):
        assert np.isnan(jcore.gaussian_window_kernel(1)).all()
    with pytest.raises(ValueError, match="sigma 0"):
        tcore.gaussian_window_kernel(1)
