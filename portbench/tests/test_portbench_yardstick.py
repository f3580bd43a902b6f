"""The yardstick's work counts: at the 1080p B=16 shapes they give the
bounds of PERF.md's kernel table (per level the larger of bytes over
3.35 TB/s and operations over the unfused issue rate, 33.5e12 a second,
that table's rate), and the least time of a unit holds under every
kernel's own bound at the published f32 peak; the window sums are
counted at the least any window size needs."""

import pytest

from portbench import yardstick
from portbench.reference import farneback

OLD_RATE = 33.5e12              # PERF.md's table: the --fmad=false issue rate
FB = {"pyr_scale": 0.5, "levels": 3, "winsize": 15, "iterations": 3, "poly_n": 5,
      "poly_sigma": 1.2, "flags": 0}
LEVELS = yardstick.level_taps(farneback.level_plan(1080, 1920, 3, 0.5))
B = 16


def bound_ms(work, rate=OLD_RATE):
    return max(work[0] / yardstick.HBM_BYTES_PER_S, work[1] / rate) * 1e3


def per_level(fn):
    return sum(bound_ms(fn(k, h, w, n)) for k, h, w, n in LEVELS)


# (kernel, the table's bound in ms, the sum over the levels it runs on)
CASES = [
    ("K1", 0.737, lambda: per_level(lambda k, h, w, n: yardstick.work_step(B, h, w))),
    ("K2", 0.606, lambda: per_level(lambda k, h, w, n: yardstick.work_polyexp(
        2 * B, h, w, 1 if k == 0 else 4, 5, k == 0))),
    ("K3", 0.091, lambda: per_level(lambda k, h, w, n: yardstick.work_level(
        2 * B, 1080, 1920, 1, n, h, w) if k else (0, 0))),
    ("K4", 0.109, lambda: bound_ms(yardstick.work_colorize(B, 1080, 1920))),
    ("X1", 0.130, lambda: sum(bound_ms(yardstick.work_upsample(B, a[1], a[2], b[1], b[2]))
                              for a, b in zip(LEVELS, LEVELS[1:]))),
    ("X2", 0.079, lambda: bound_ms(yardstick.work_magnitude_sum(B, 1080, 1920))),
]


@pytest.mark.parametrize("kid,table_ms,count", CASES, ids=[c[0] for c in CASES])
def test_work_counts_equal_the_kernel_table(kid, table_ms, count):
    assert count() == pytest.approx(table_ms, abs=5e-4)


def running_box(x: list, r: int) -> tuple:
    """Sums of 2r + 1 values around each of x's (zero outside), as running
    sums; and the adds and subtractions each output after the first took."""
    pad = [0.0] * (r + 1) + list(x) + [0.0] * r
    s = sum(pad[1:2 * r + 2])
    out, ops = [s], 0
    for i in range(1, len(x)):
        s = s + pad[i + 2 * r + 1] - pad[i]
        out.append(s)
        ops += 2
    return out, ops / (len(x) - 1)


@pytest.mark.parametrize("winsize", [15, 63])
def test_window_sums_are_counted_as_running_sums(winsize):
    """By hand: a running sum takes 2 operations an output, whatever the
    window; two passes over K1's five channels make 20 a pixel."""
    r = winsize // 2
    x = [float((7 * i) % 11) for i in range(200)]
    sums, ops = running_box(x, r)
    assert sums == [sum(x[max(0, i - r):i + r + 1]) for i in range(len(x))]
    assert ops == 2
    assert yardstick.WINDOW_OPS == 5 * 2 * ops == 20
    assert yardstick.work_step(1, 1, 1)[1] == yardstick.M_OPS + 20 + yardstick.SOLVE_OPS == 75


def test_the_level_plan_is_the_default_pyramid():
    assert [(k, h, w, n) for k, h, w, n in LEVELS] == [
        (3, 135, 240, 19), (2, 270, 480, 9), (1, 540, 960, 3), (0, 1080, 1920, 3)]


@pytest.mark.parametrize("chunk", [
    yardstick.Chunk(80, 1080, 1920, True, "bgr"),
    yardstick.Chunk(1, 1080, 1920, True, "bgr"),
    yardstick.Chunk(128, 72, 129, False, "sums"),
], ids=["bgr_80", "bgr_1", "sums_128"])
def test_least_time_is_a_lower_bound(chunk):
    """Every stage at the published peaks takes at least its share of the
    unit's least time: the least time never exceeds the stages' own
    bounds summed, so no fusing of stages can beat it."""
    levels = yardstick.level_taps(farneback.level_plan(chunk.h, chunk.w, 3, 0.5))
    least, by = yardstick.least_seconds(chunk, levels, FB)
    stages = yardstick.chunk_work(chunk, levels, FB)
    assert by == "ops"
    assert least <= sum(bound_ms(w, yardstick.F32_FLOPS) for w in stages.values()) * 1e-3
    assert least == pytest.approx(sum(w[1] for w in stages.values()) / yardstick.F32_FLOPS)
