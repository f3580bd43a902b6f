"""Halo-exchanged, spatially sharded stencil stages, a port of
`optical_flow_tpu.parallel.halo`.

The spatial axis splits the frame HEIGHT over a mesh's 'spatial' devices,
for frames whose pyramid outgrows one card.  An array under it is a
`Blocks`: its row blocks, block j on device j of the spatial group, in
spatial order.  Each separable stage halo-extends every block with `r`
rows copied from its neighbours (a peer `copy_` in one process, where JAX
`ppermute`s over ICI), synthesizes the global image border (REFLECT_101
or replicate, the stage's cv2 semantics) on the outermost blocks, runs
the port's kernel on each extended block on that block's device (on the
CPU its plain version), and keeps the centre rows:

  * `gauss`: K6 `kernels/gauss.py:gaussian_blur`, REFLECT_101;
  * `poly_exp`: K2 `kernels/polyexp.py:poly_exp`, replicate, no pre-smooth
    (the sp route smooths level 0 through `gauss`);
  * `blur_solve`: K5b `kernels/blur_solve.py:blur_solve`, replicate;
  * `update_matrices_stats`: K5a `kernels/update_gather.py:update_matrices`
    on a WIN_H-row replicate halo, then the seam fix below.

A kernel applied to an extended block applies its own border handling at
the block's edges, which only reaches output rows within `r` of them:
the halo rows, which are dropped.  So each kept row equals the one-device
op's, to the bit for the stencils (direct sums in the same order).

A stage decomposes where JAX's `_plan` says it does: the height divides
by the spatial count and each block holds more than `r` rows.  Where it
does not (coarse levels, an indivisible height, a deep halo), the stage's
input is gathered on the group's first device, the SAME kernel runs on
the whole array, and the result is split back; the plain PyTorch version
never stands in for a kernel on a card.  Blocks stay on their devices
from stage to stage otherwise.  The resizes between levels run per block
(X1, `kernels/resample.py:bilinear_rows`) on the source rows each output
block reads (at most one row from a neighbour), equal to the bit to the
one-device resize.  The split of a
height into blocks is always `torch.tensor_split`'s.

The displaced-fetch update decomposes by JAX's three observations:

  1. a WIN_H-row replicate halo makes the block's clamped fetch equal the
     global one for every displacement that lands inside the halo;
  2. every M term is a product of two border-scaled values, so the global
     row border ramp, which a block cannot see (its own ramp falls inside
     the dropped halo rows, since WIN_H > BORDER), is a post-multiply by
     roww^2 on the first and last BORDER rows;
  3. the pixels where the block's and the global semantics can differ are
     an analytic mask, recomputed with the global formula.  JAX's mask is
     global-inside XOR fetched-in-halo.  The port's also takes the pixels
     whose block-local row coordinate rounds to another row than the
     global one (f32 `y + dy` rounds in another binade at another `y`),
     because the card's K5a computes the coordinate from the block's own
     row index.

A masked pixel fetches its R1 value from the block that owns the source
row, by index, however many pixels are masked: the card has a hardware
gather and no spill tiers.  The TPU needed VIOL_MAX, and a full global
recompute above it, because its gather was bounded; neither is ported.
The fix is a few gathers and elementwise ops on those pixels in plain
PyTorch, as JAX computes it in XLA outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from optical_flow_tpu_torch.kernels.blur_solve import blur_solve
from optical_flow_tpu_torch.kernels.gauss import gaussian_blur
from optical_flow_tpu_torch.kernels.polyexp import poly_exp
from optical_flow_tpu_torch.kernels.update_gather import update_matrices
from optical_flow_tpu_torch.models.farneback.core import border_axis_weights
from optical_flow_tpu_torch.kernels import resample
from optical_flow_tpu_torch.ops.resize import _coeffs_f32

# The update's halo depth: JAX's `pallas/update_gather.py` WIN_H, the TPU
# kernel's row window.  The card's K5a has no window; the constant stays
# because it decides which level shapes decompose (`_plan`), so that the
# port and JAX shard the same stages.
WIN_H = 32


def _split_sizes(n: int, parts: int) -> list:
    """Block heights of `torch.tensor_split(x, parts)` along an axis of n."""
    return [n // parts + (1 if j < n % parts else 0) for j in range(parts)]


class Blocks:
    """An (..., H, W) array held as row blocks: `parts[j]` holds the j-th
    `torch.tensor_split` block of the rows, on its own device."""

    def __init__(self, parts):
        self.parts = list(parts)

    @classmethod
    def split(cls, x: torch.Tensor, devices) -> "Blocks":
        return cls(p.contiguous().to(d) for p, d in
                   zip(torch.tensor_split(x, len(devices), dim=-2), devices))

    @property
    def devices(self) -> list:
        return [p.device for p in self.parts]

    @property
    def height(self) -> int:
        return sum(p.shape[-2] for p in self.parts)

    @property
    def shape(self) -> tuple:
        p = self.parts[0]
        return tuple(p.shape[:-2]) + (self.height, p.shape[-1])

    def __getitem__(self, index) -> "Blocks":
        """The same leading-axis index of every block (e.g. R[:B])."""
        return Blocks(p[index] for p in self.parts)

    def __mul__(self, c: float) -> "Blocks":
        return Blocks(p * c for p in self.parts)

    def gather(self, device=None) -> torch.Tensor:
        """The whole array on `device` (by default the first block's)."""
        device = self.parts[0].device if device is None else device
        return torch.cat([p.to(device) for p in self.parts], dim=-2)

    def rows(self, lo: int, hi: int, device) -> torch.Tensor:
        """Global rows [lo, hi) on `device`, from the blocks that hold them."""
        pieces, top = [], 0
        for p in self.parts:
            a, b = max(lo, top), min(hi, top + p.shape[-2])
            if a < b:
                pieces.append(p[..., a - top:b - top, :].to(device))
            top += p.shape[-2]
        return torch.cat(pieces, dim=-2)


def _synth_border(x: torch.Tensor, r: int, mode: str, top: bool) -> torch.Tensor:
    """The r rows the global image border contributes beyond this block's
    edge: REFLECT_101 (cv2 GaussianBlur) or replicate, 'edge' (the
    expansion's correlation, the window sums)."""
    if mode == "reflect101":
        # virtual row -k = row k  /  virtual row H-1+k = row H-1-k
        rows = x[..., 1:r + 1, :] if top else x[..., -r - 1:-1, :]
        return rows.flip(-2)
    if mode == "edge":
        edge = x[..., :1, :] if top else x[..., -1:, :]
        return edge.expand(edge.shape[:-2] + (r,) + edge.shape[-1:])
    raise ValueError(f"unknown border mode {mode!r}")


def halo_extend(blocks, r: int, mode: str) -> list:
    """A spatial group's blocks (`Blocks` or a list of (..., h_j, W)
    tensors, in order) -> each block extended to (..., h_j + 2r, W) on its
    own device: r rows copied from each neighbour, the synthesized global
    border (`mode`) on the outermost blocks.  Requires r <= h_j - 1 for
    every block (halos come from the immediate neighbour only)."""
    parts = list(blocks.parts if isinstance(blocks, Blocks) else blocks)
    if r == 0:
        return parts
    h = min(p.shape[-2] for p in parts)
    if r > h - 1:
        raise ValueError(f"halo depth {r} needs local height > {r}, got {h}")
    out = []
    for j, x in enumerate(parts):
        top = (_synth_border(x, r, mode, top=True) if j == 0
               else parts[j - 1][..., -r:, :].to(x.device))
        bot = (_synth_border(x, r, mode, top=False) if j == len(parts) - 1
               else parts[j + 1][..., :r, :].to(x.device))
        out.append(torch.cat([top, x, bot], dim=-2))
    return out


class HaloKernels:
    """Per-stage spatially sharded entries for `_flow_pyramid`, over the
    'spatial' axis of `mesh`.  Each method takes and returns the `Blocks`
    of one spatial group (one data shard's devices along 'spatial');
    shapes that do not decompose run the stage's kernel on the gathered
    array."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.n_sp = int(mesh.shape["spatial"])

    def _plan(self, h: int, r: int) -> bool:
        """Whether a stage of height h with halo depth r decomposes: JAX's
        `_plan` (`halo.py:161-170`) without its batch test, since each
        data shard's group holds its own batch."""
        if self.n_sp <= 1 or h % self.n_sp:
            return False
        return r <= h // self.n_sp - 1

    def _check(self, x: Blocks) -> None:
        if len(x.parts) != self.n_sp:
            raise ValueError(f"{len(x.parts)} blocks for {self.n_sp} spatial devices")

    @staticmethod
    def _whole(fn, x: Blocks, *more: Blocks) -> Blocks:
        """A stage that does not decompose: its inputs gathered on the
        group's first device, `fn` on the whole arrays, split back."""
        dev = x.devices[0]
        out = fn(x.gather(dev), *(m.gather(dev) for m in more))
        return Blocks.split(out, x.devices)

    @staticmethod
    def _per_block(fn, x: Blocks, r: int, mode: str) -> Blocks:
        return Blocks(fn(e)[..., r:r + p.shape[-2], :].contiguous()
                      for e, p in zip(halo_extend(x, r, mode), x.parts))

    # -- pyramid smoothing: separable Gaussian, REFLECT_101 (K6) ----------
    def gauss(self, x: Blocks, taps) -> Blocks:
        self._check(x)
        r = (len(taps) - 1) // 2
        fn = lambda a: gaussian_blur(a, taps)  # noqa: E731
        if r == 0 or not self._plan(x.height, r):
            return self._whole(fn, x)
        return self._per_block(fn, x, r, "reflect101")

    # -- polynomial expansion: replicate-border correlation (K2) ----------
    def poly_exp(self, img: Blocks, poly_n: int, poly_sigma: float,
                 pre_taps=None) -> Blocks:
        if pre_taps is not None:
            raise ValueError("the sharded expansion takes no pre-smooth; "
                             "smooth through gauss first")
        self._check(img)
        fn = lambda a: poly_exp(a, poly_n, poly_sigma)  # noqa: E731
        if not self._plan(img.height, poly_n):
            return self._whole(fn, img)
        return self._per_block(fn, img, poly_n, "edge")

    # -- window sum + 2x2 solve: replicate-border sums (K5b) --------------
    def blur_solve(self, M: Blocks, winsize: int, gaussian: bool) -> Blocks:
        self._check(M)
        m = winsize // 2
        fn = lambda a: blur_solve(a, winsize, gaussian)  # noqa: E731
        if m == 0 or not self._plan(M.height, m):
            return self._whole(fn, M)
        return self._per_block(fn, M, m, "edge")

    # -- displaced-fetch matrix update (module docstring, 1-3) (K5a) -------
    def update_matrices_stats(self, R0: Blocks, R1: Blocks, flow: Blocks):
        """(M, n_fixed): the sharded FarnebackUpdateMatrices, equal to the
        one-device op up to the float rounding of the border post-multiply,
        and the count of seam pixels recomputed with the global formula
        (0 where the stage does not decompose)."""
        self._check(R0)
        h, w = R0.height, R0.shape[-1]
        r = WIN_H
        if not self._plan(h, r):
            return self._whole(update_matrices, R0, R1, flow), 0
        hl = h // self.n_sp
        ext = [halo_extend(t, r, "edge") for t in (R0, R1, flow)]
        roww = border_axis_weights(h)
        colw = border_axis_weights(w)
        parts, n_fixed = [], 0
        for j, dev in enumerate(R0.devices):
            M = update_matrices(*(e[j] for e in ext))[..., r:r + hl, :]
            # (2) the global row border ramp on the rows that have one
            ramp = roww[j * hl:(j + 1) * hl]
            if (ramp != 1).any():
                ramp = torch.as_tensor(ramp * ramp).to(dev)
                M = M * ramp[:, None]
            else:
                M = M.contiguous()
            fixed = self._fix_seams(M, j, hl, r, R0, R1, flow, roww, colw)
            n_fixed += fixed
            parts.append(M)
        return Blocks(parts), n_fixed

    def _fix_seams(self, M, j, hl, r, R0, R1, flow, roww, colw) -> int:
        """(3): recompute in place, with the global formula, the pixels of
        block j whose fetch or inside test differs from the global op's;
        returns how many."""
        h, w = R0.height, R0.shape[-1]
        fl = flow.parts[j]
        dev = fl.device
        dx, dy = fl[:, 0], fl[:, 1]
        xs = torch.arange(w, dtype=torch.float32, device=dev)
        y_g = torch.arange(j * hl, (j + 1) * hl, dtype=torch.float32, device=dev)[:, None]
        y_l = torch.arange(r, r + hl, dtype=torch.float32, device=dev)[:, None]
        x1 = torch.round(xs + dx)
        y1 = torch.round(y_g + dy)
        y1_l = torch.round(y_l + dy)
        xin = (x1 >= 0) & (x1 <= w - 1)
        gin = xin & (y1 >= 0) & (y1 <= h - 1)
        lin = xin & (y1_l >= 0) & (y1_l <= hl + 2 * r - 1)
        unsafe = (gin != lin) | (gin & (y1_l + float(j * hl - r) != y1))
        b, py, px = unsafe.nonzero(as_tuple=True)
        if b.numel() == 0:
            return 0
        dxv, dyv = dx[b, py, px], dy[b, py, px]
        xi = x1[b, py, px].clamp(0, w - 1).long()
        yi = y1[b, py, px].clamp(0, h - 1).long()
        # R1 at the global target, from the block that owns its row
        fetched = torch.empty((b.numel(), 5), dtype=torch.float32, device=dev)
        owner = yi // hl
        for o in owner.unique().tolist():
            sel = (owner == o).nonzero(as_tuple=True)[0]
            src = R1.parts[o]
            idx = [t[sel].to(src.device) for t in (b, yi - o * hl, xi)]
            fetched[sel] = src[idx[0], :, idx[1], idx[2]].to(dev)
        r0 = R0.parts[j][b, :, py, px]
        insi = gin[b, py, px]
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        f0 = torch.where(insi, fetched[:, 0], zero)
        f1 = torch.where(insi, fetched[:, 1], zero)
        r4 = torch.where(insi, (r0[:, 2] + fetched[:, 2]) * 0.5, r0[:, 2])
        r5 = torch.where(insi, (r0[:, 3] + fetched[:, 3]) * 0.5, r0[:, 3])
        r6 = torch.where(insi, (r0[:, 4] + fetched[:, 4]) * 0.25, r0[:, 4] * 0.5)
        r2 = (r0[:, 0] - f0) * 0.5 + (r4 * dyv + r6 * dxv)
        r3 = (r0[:, 1] - f1) * 0.5 + (r6 * dyv + r5 * dxv)
        s = (torch.as_tensor(roww).to(dev)[py + j * hl]
             * torch.as_tensor(colw).to(dev)[px])
        r2, r3, r4, r5, r6 = (v * s for v in (r2, r3, r4, r5, r6))
        M[b, :, py, px] = torch.stack([
            r4 * r4 + r6 * r6,
            (r4 + r5) * r6,
            r5 * r5 + r6 * r6,
            r4 * r2 + r6 * r3,
            r6 * r2 + r5 * r3,
        ], dim=-1)
        return int(b.numel())

    # -- the pyramid's other steps over blocks -----------------------------
    def update_flow(self, R0: Blocks, R1: Blocks, flow: Blocks, winsize: int,
                    iterations: int, gaussian: bool = False) -> Blocks:
        """One level's iterations, `core.update_flow`'s order: the update,
        then the window sum and solve."""
        for _ in range(iterations):
            M, _ = self.update_matrices_stats(R0, R1, flow)
            flow = self.blur_solve(M, winsize, gaussian)
        return flow

    def resize_bilinear(self, x: Blocks, dw: int, dh: int, scale: float = 1.0) -> Blocks:
        """`ops/resize.py:resize_bilinear_f32` per output block, then `*
        scale`: X1 on the source rows each block reads (its own and at most
        a row from each neighbour) with the frame's vertical table shifted
        to them, to the bit."""
        sh, sw = x.height, x.shape[-1]
        if (dw, dh) == (sw, sh):
            return x if scale == 1.0 else x * scale
        s0, s1, _ = _coeffs_f32(sh, dh)
        parts, a = [], 0
        for size, dev in zip(_split_sizes(dh, len(x.parts)), x.devices):
            b = a + size
            if size == 0:
                parts.append(torch.empty(x.shape[:-2] + (0, dw), dtype=torch.float32,
                                         device=dev))
                continue
            lo, hi = int(s0[a]), int(s1[b - 1]) + 1
            parts.append(resample.bilinear_rows(x.rows(lo, hi, dev), dw, sh, dh, a, b,
                                                lo, scale))
            a = b
        return Blocks(parts)

    def level_images(self, frames: Blocks, kern, out_w: int, out_h: int) -> Blocks:
        """A coarser level from the full-resolution frames: `gauss`, then
        the bilinear resize (K3 does not run under sp, as in JAX)."""
        return self.resize_bilinear(self.gauss(frames, kern), out_w, out_h)

    @staticmethod
    def zeros(shape, like: Blocks) -> Blocks:
        """Zeros of `shape` (..., H, W), split as `like`'s devices hold rows."""
        return Blocks(torch.zeros(tuple(shape[:-2]) + (n, shape[-1]),
                                  dtype=torch.float32, device=dev)
                      for n, dev in zip(_split_sizes(shape[-2], len(like.parts)),
                                        like.devices))
