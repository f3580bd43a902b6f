"""X1 (`kernels/resample.py`) and X2 (`kernels/magnitude_sum.py`) on the
CPU: their tables and plain versions against the JAX package, and X1's
table loop (`resample_taps` below, the kernel's pass order and
per-output recomputation in PyTorch) against the plain resizes it
replaces on the card.

  * The table loop equals `resize_bilinear_f32(x) * s`,
    `resize_area_f32(x) * s` (in `area_plan`'s launches, two where an
    axis grows) and `bilinear_rows` on a halo block's shifted tables to
    the bit (`torch.equal`, NaNs at the same places): the 1080p
    pyramid's x2 steps, odd sizes (1079x1917), 1-wide and 1-tall axes,
    the seed's (B, H, W, 2) layout read in place, NaN and +-inf seeds.
  * X1's tables equal JAX's `_coeffs_f32` and `_area_weights` exactly.
  * The plain `magnitude_sums` is JAX's `jnp.sum(cart_to_polar(...)[0])`
    within rtol 2e-6 (JAX sums in f32, the port in f64) and a float64
    numpy sum rounded to f32 within 1 ulp (both sum in f64, in other
    orders).

The kernels themselves run on the card: tests/test_torch_cuda.py holds
them to these plain versions to the bit (X1) and within 1 ulp (X2).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from optical_flow_tpu.ops import polar as jpolar
from optical_flow_tpu.ops import resize as jresize
from optical_flow_tpu_torch import kernels
from optical_flow_tpu_torch.kernels import resample
from optical_flow_tpu_torch.kernels.magnitude_sum import magnitude_sum
from optical_flow_tpu_torch.ops import polar, resize

CPU = torch.device("cpu")


def _bit_equal(got, ref) -> bool:
    nan = torch.isnan(ref)
    return (tuple(got.shape) == tuple(ref.shape) and torch.equal(torch.isnan(got), nan)
            and torch.equal(got.masked_fill(nan, 0).view(torch.int32),
                            ref.masked_fill(nan, 0).view(torch.int32)))


def _flow(n, h, w, seed, odd=False):
    """(n, 2, h, w) f32, up to 6 px, from default_rng(seed); with odd,
    NaN and +-inf at a few places, pixel (0, 0) among them (where an area
    table's zero-weight pads point)."""
    x = ((np.random.default_rng(seed).random((n, 2, h, w)) - 0.5) * 12).astype(np.float32)
    if odd:
        x[0, 0, 0, 0] = np.nan
        x[-1, -1, 0, 0] = np.inf
        x[0, -1, h // 2, w // 3] = -np.inf
    return torch.as_tensor(x)


def _tables(kind, s_len, d_len):
    return resample._table(kind, s_len, d_len, CPU)


def resample_taps(src, ytab, xtab, vertical_first, scale=1.0):
    """X1's function in plain PyTorch: src (..., H, W) resampled by the
    tap tables ytab (dh, Ty) and xtab (dw, Tx), then `* scale`; f32
    (..., dh, dw).

    The kernel's loop, output by output: for each tap of the second axis,
    the first axis's sum over its taps, each sum starting from its first
    term and adding the others in table order; the first-pass values each
    output needs are made for it, as the kernel makes them."""
    iy, wy, ix, wx = ytab.index.long(), ytab.weight, xtab.index.long(), xtab.weight
    src = src.float()
    acc = None
    if vertical_first:
        for i in range(ix.shape[1]):
            cols = src.index_select(-1, ix[:, i])
            v = None
            for j in range(iy.shape[1]):
                term = cols.index_select(-2, iy[:, j]) * wy[:, j, None]
                v = term if v is None else v + term
            term = v * wx[:, i]
            acc = term if acc is None else acc + term
    else:
        for j in range(iy.shape[1]):
            rows = src.index_select(-2, iy[:, j])
            h = None
            for i in range(ix.shape[1]):
                term = rows.index_select(-1, ix[:, i]) * wx[:, i]
                h = term if h is None else h + term
            term = h * wy[:, j, None]
            acc = term if acc is None else acc + term
    return acc * scale


def _loop_area(x, dw, dh, scale):
    """`resize_area` as the card runs it, with the table loop for X1."""
    h, w = x.shape[-2:]
    plan = resample.area_plan(h, w, dh, dw)
    for k, (vert, horiz, vertical_first) in enumerate(plan):
        x = resample_taps(x, _tables(*vert), _tables(*horiz), vertical_first,
                          scale if k == len(plan) - 1 else 1.0)
    return x


@pytest.mark.parametrize("n,h,w,dh,dw,scale,odd", [
    (1, 135, 240, 270, 480, 2.0, False),    # the 1080p pyramid's x2 steps
    (1, 270, 480, 540, 960, 2.0, False),
    (1, 540, 960, 1080, 1920, 2.0, True),
    (1, 540, 959, 1079, 1917, 2.0, True),   # odd sizes
    (2, 1, 37, 2, 74, 2.0, True), (2, 37, 1, 74, 2, 2.0, True),    # 1-tall, 1-wide
    (2, 1, 1, 3, 5, 4.0, False),
    (2, 37, 53, 37, 106, 4.0, True),        # an axis keeps its size: its identity table
    (3, 200, 300, 13, 19, 1.0, False),      # a level resize after K6 (downsample)
])
def test_table_loop_is_resize_bilinear_times_scale(n, h, w, dh, dw, scale, odd):
    x = _flow(n, h, w, seed=h + w, odd=odd)
    got = resample_taps(x, _tables("bilinear", h, dh), _tables("bilinear", w, dw),
                        False, scale)
    assert _bit_equal(got, resize.resize_bilinear_f32(x, dw, dh) * scale)


@pytest.mark.parametrize("n,h,w,dh,dw,launches", [
    (1, 1080, 1920, 135, 240, 1),           # the seed at 1080p, levels 3
    (1, 1079, 1917, 135, 240, 1),           # odd sizes
    (2, 67, 121, 9, 13, 1), (2, 1, 40, 1, 7, 1), (2, 40, 1, 7, 1, 1),
    (2, 10, 40, 10, 7, 1), (2, 10, 40, 5, 40, 1),
    (2, 10, 40, 20, 10, 2), (2, 40, 10, 10, 20, 2),    # an axis grows: two launches
    (2, 10, 10, 20, 30, 2), (2, 3, 30, 7, 5, 2),
    (2, 37, 53, 37, 53, 1),                 # the same size: a copy times the scale
    (2, 40, 1000, 5, 13, 1),                # 78 horizontal taps
])
def test_table_loop_is_resize_area_times_scale(n, h, w, dh, dw, launches):
    """In `area_plan`'s launches, on the seed's (B, H, W, 2) layout read in
    place, with NaN and +-inf in the seed."""
    seed = _flow(n, h, w, seed=h * w, odd=True).movedim(1, -1).contiguous()
    x = seed.movedim(-1, 1)
    assert not x.is_contiguous()
    assert len(resample.area_plan(h, w, dh, dw)) == launches
    scale = float(np.float32(0.5 ** 3))
    assert _bit_equal(_loop_area(x, dw, dh, scale), resize.resize_area_f32(x, dw, dh) * scale)


@pytest.mark.parametrize("sh,dh,w,dw,parts", [(270, 540, 48, 96, 2), (135, 270, 37, 74, 3),
                                              (541, 1079, 20, 40, 4), (9, 17, 5, 9, 4)])
def test_table_loop_on_row_blocks_is_bilinear_rows(sh, dh, w, dw, parts):
    """The halo path's resize: each output row block from the source rows
    it reads, with the frame's vertical table shifted to them
    (`resample._row_block_table`), equals `bilinear_rows` on that block,
    and the blocks together the frame's resize."""
    x = _flow(2, sh, w, seed=sh)
    s0, s1, _ = resize._coeffs_f32(sh, dh)
    sy0, sy1, ty = resize.coeff_tensors(sh, dh, CPU)
    blocks = []
    for rows in np.array_split(np.arange(dh), parts):
        a, b = int(rows[0]), int(rows[-1]) + 1
        lo, hi = int(s0[a]), int(s1[b - 1]) + 1
        src = x[..., lo:hi, :]
        tab = resample._row_block_table(sh, dh, a, b, lo, CPU)
        assert (tab.lo, tab.hi) == (0, hi - lo)
        got = resample_taps(src, tab, _tables("bilinear", w, dw), False, 2.0)
        assert _bit_equal(got, resize.bilinear_rows(src, dw, sy0[a:b] - lo, sy1[a:b] - lo,
                                                    ty[a:b]) * 2.0)
        assert _bit_equal(resample.bilinear_rows(src, dw, sh, dh, a, b, lo, 2.0), got)
        blocks.append(got)
    assert _bit_equal(torch.cat(blocks, -2), resize.resize_bilinear_f32(x, dw, dh) * 2.0)


@pytest.mark.parametrize("s_len,d_len", [(135, 270), (540, 1080), (959, 1917), (1, 2),
                                         (2, 1), (37, 37), (1080, 68), (7, 3)])
def test_bilinear_table_is_jax_s_coeffs(s_len, d_len):
    s0, s1, t = jresize._coeffs_f32(s_len, d_len)
    tab = _tables("bilinear", s_len, d_len)
    idx, wt, lo, hi = tab.index, tab.weight, tab.lo, tab.hi
    assert idx.dtype == torch.int32 and wt.dtype == torch.float32
    assert (lo, hi) == (int(s0.min()), int(s1.max()) + 1)
    np.testing.assert_array_equal(idx.numpy(), np.stack([s0, s1], 1))
    np.testing.assert_array_equal(wt.numpy(), np.stack([np.float32(1.0) - t, t], 1))


@pytest.mark.parametrize("s_len,d_len", [(1080, 135), (1920, 240), (1079, 135),
                                         (1917, 240), (121, 13), (40, 7), (10, 3)])
def test_area_table_is_jax_s_area_weights(s_len, d_len):
    """Scattered back into a dense (d_len, s_len) matrix, the table (its
    zero-weight pads at index 0 included) is JAX's `_area_weights`."""
    tab = _tables("area", s_len, d_len)
    idx, wt, lo, hi = tab.index, tab.weight, tab.lo, tab.hi
    assert (lo, hi) == (0, s_len)
    dense = np.zeros((d_len, s_len), np.float32)
    for d in range(d_len):
        for i, v in zip(idx[d].tolist(), wt[d].tolist()):
            dense[d, i] += v
    np.testing.assert_array_equal(dense, jresize._area_weights(s_len, d_len))
    assert resample._table("area", s_len, d_len, CPU) is resample._table("area", s_len,
                                                                         d_len, CPU)


def test_cpu_wrappers_run_the_plain_versions():
    """On CPU tensors the wrappers run the plain versions and launch
    nothing; the launch itself takes a CUDA tensor only."""
    kernels.reset_launches()
    x = _flow(2, 17, 23, seed=1, odd=True)
    assert _bit_equal(resample.resize_bilinear(x, 46, 34, 2.0),
                      resize.resize_bilinear_f32(x, 46, 34) * 2.0)
    assert _bit_equal(resample.resize_bilinear(x, 23, 17), x)
    assert _bit_equal(resample.resize_area(x, 5, 4, 0.25), resize.resize_area_f32(x, 5, 4) * 0.25)
    ytab, xtab = _tables("bilinear", 17, 34), _tables("bilinear", 23, 46)
    with pytest.raises(ValueError):
        resample._resample(x, ytab, xtab, False, 2.0)
    assert _bit_equal(magnitude_sum(x), polar.magnitude_sums(x[:, 0], x[:, 1]))
    with pytest.raises(ValueError):
        magnitude_sum(x[:, :1])
    assert all(v == 0 for v in kernels.LAUNCHES.values())


@pytest.mark.parametrize("b,h,w", [(7, 72, 129), (2, 135, 240), (3, 1, 1), (1, 5, 7)])
def test_magnitude_sums_match_jax_and_float64(b, h, w):
    rng = np.random.default_rng(b * h + w)
    x, y = ((rng.random((2, b, h, w)) - 0.5) * 12).astype(np.float32)
    got = polar.magnitude_sums(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    assert got.dtype == np.float32 and got.shape == (b,)
    ref = np.asarray(jnp.sum(jpolar.cart_to_polar(jnp.asarray(x), jnp.asarray(y))[0],
                             axis=(-2, -1)))
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=0)
    # cart_to_polar's magnitude: x*x + y*y in f32, its sqrt correctly rounded
    mag = np.sqrt((x * x + y * y).astype(np.float64)).astype(np.float32)
    f64 = mag.astype(np.float64).sum(axis=(-2, -1)).astype(np.float32)
    assert np.abs(got.view(np.int32).astype(np.int64) - f64.view(np.int32)).max() <= 1


def test_magnitude_sums_are_each_pair_s_own():
    """A pair's plain sum is the same in any batch (the mesh gathers the
    shards' sums)."""
    rng = np.random.default_rng(5)
    flow = torch.as_tensor(((rng.random((7, 2, 96, 128)) - 0.5) * 12).astype(np.float32))
    whole = polar.magnitude_sums(flow[:, 0], flow[:, 1])
    apart = torch.cat([polar.magnitude_sums(f[:, 0], f[:, 1]) for f in flow.split(3)])
    assert torch.equal(whole, apart)
