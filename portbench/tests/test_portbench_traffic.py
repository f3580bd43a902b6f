"""The traffic generator: the same seed gives the same units and frames,
every seed runs the same set of lengths, and the mixes' lengths are the
distributions their cells state."""

import itertools
import json
import math
import statistics

import numpy as np
import pytest
import torch

from portbench import generator
from portbench.entries import visualizer
from portbench.reference import extractor as reference_extractor
from portbench.tests.tiny import BENCH

MIXES = {n: json.loads((BENCH / "traffic" / f"{n}.json").read_text())
         for n in ("long_shots", "film_shots", "corpus")}
VIS = json.loads((BENCH / "configs" / "visualizer_1080p.json").read_text())
BIG = 2**31 + 12345


def take(mix, seed, n):
    return list(itertools.islice(generator.units(mix, seed), n))


@pytest.mark.parametrize("name", sorted(MIXES))
def test_same_seed_same_schedule(name):
    assert take(MIXES[name], BIG, 200) == take(MIXES[name], BIG, 200)
    assert take(MIXES[name], BIG, 200) != take(MIXES[name], BIG + 1, 200)


@pytest.mark.parametrize("name", sorted(MIXES))
def test_every_cycle_runs_the_same_lengths(name):
    mix = MIXES[name]
    n = mix["strata"]
    for seed in (0, 7, BIG, 2**63 + 5):
        units = take(mix, seed, 3 * n)
        for c in range(3):
            got = sorted(u["seconds"] for u in units[c * n:(c + 1) * n])
            assert got == generator.strata(mix)


def test_long_shots_are_the_film_shots_tail():
    """The long shots are the film shots' lognormal between 16 and 30 s:
    its strata are the lognormal's quantiles over that share of it."""
    long, film = MIXES["long_shots"]["seconds"], MIXES["film_shots"]["seconds"]
    assert (long["median"], long["sigma_ln"]) == (film["median"], film["sigma_ln"])
    assert long["high"] == film["high"]
    lengths = generator.strata(MIXES["long_shots"])
    assert 16.0 < min(lengths) and max(lengths) < 30.0
    ln = statistics.NormalDist(math.log(4.0), 0.8)
    lo, hi = ln.cdf(math.log(16.0)), ln.cdf(math.log(30.0))
    n = len(lengths)
    assert [ln.cdf(math.log(s)) for s in lengths] == pytest.approx(
        [lo + (i + 0.5) / n * (hi - lo) for i in range(n)], abs=1e-12)
    pairs = [len(visualizer.positions(VIS, {"start_ms": 0, "seconds": s})) - 1 for s in lengths]
    assert min(pairs) == 53 and max(pairs) == 98


def test_film_shots_lognormal():
    mix = MIXES["film_shots"]
    lengths = generator.strata(mix)
    assert statistics.median(lengths) == pytest.approx(4.0, rel=0.03)
    logs = np.log([s for s in lengths if 0.6 < s < 30.0])
    assert np.std(np.log(lengths)) == pytest.approx(0.8, rel=0.1)
    assert min(lengths) >= 0.6 and max(lengths) <= 30.0 and logs.size > 60
    pairs = [len(visualizer.positions(VIS, {"start_ms": 0, "seconds": s})) - 1 for s in lengths]
    assert 1 <= min(pairs) and max(pairs) <= 100


def test_corpus_is_ten_second_clips():
    """Kinetics' clips last about 10 s: 250 frames at 25 fps, 36 windows."""
    assert set(generator.strata(MIXES["corpus"])) == {10.0}
    ext = json.loads((BENCH / "configs" / "extractor_w129.json").read_text())
    windows, _ = reference_extractor.window_schedule(
        int(10.0 * ext["fps"]), ext["fps"], ext["step_ms"], ext["window_ms"])
    assert len(windows) == 36


def test_frame_pool_from_the_seed():
    a = generator.frame_pool(24, 40, 12, BIG, torch.device("cpu"))
    b = generator.frame_pool(24, 40, 12, BIG, torch.device("cpu"))
    c = generator.frame_pool(24, 40, 12, BIG + 1, torch.device("cpu"))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    # frame k is frame 0 moved (k // 2, k) px: a pan
    assert np.array_equal(a[4][:-2, :-4], a[0][2:, 4:])


def test_pool_index_is_a_triangle_wave():
    assert [generator.pool_index(k, 4) for k in range(8)] == [0, 1, 2, 3, 2, 1, 0, 1]
