"""Test-fixture mp4 surgery: inject rotation / VFR metadata into a
CFR mp4 (as written by `oracle.synthetic.write_synthetic_video`).

A copy of `optical_flow_tpu.oracle.mp4edit` (pure `struct`), so that the
port's tests make their rotated and variable-frame-rate fixtures without
the JAX package.  There is no ffmpeg CLI to author such files, so the
mp4 boxes are patched directly:

  * `patch_rotation`: rewrite the tkhd transformation matrix to a 90°
    rotation (what phone cameras write); libavformat surfaces it as
    DISPLAYMATRIX side data.
  * `patch_vfr`: split the single stts (time-to-sample) run into two runs
    with different frame durations, so the head of the stream becomes
    genuinely VFR without re-encoding any sample data.

Both rely on the writer placing `moov` after `mdat` (ffmpeg/cv2 default,
no faststart), so growing `moov` never shifts the `stco` chunk offsets.
"""

from __future__ import annotations

import struct

_CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts"}


def _walk(buf: bytes, off: int, end: int, path=()):
    out = []
    while off + 8 <= end:
        size, typ = struct.unpack(">I4s", buf[off:off + 8])
        if size < 8:
            break
        out.append((path + (typ,), off, size))
        if typ in _CONTAINERS:
            out += _walk(buf, off + 8, off + size, path + (typ,))
        off += size
    return out


def _find(boxes, tail: bytes):
    hits = [(p, o, s) for p, o, s in boxes if p[-1] == tail]
    if len(hits) != 1:
        raise ValueError(f"expected exactly one {tail!r} box, got {hits}")
    return hits[0]


def patch_rotation(src: str, dst: str, clockwise90: bool = True) -> None:
    """Write dst = src with the video track's tkhd matrix set to a 90°
    rotation (16.16 fixed point [0 1; -1 0] with the axes swap phone
    muxers emit).  Sample data and timing are untouched."""
    data = bytearray(open(src, "rb").read())
    boxes = _walk(data, 0, len(data))
    _p, off, size = _find(boxes, b"tkhd")
    version = data[off + 8]
    if version != 0:
        raise ValueError("tkhd v1 not supported by this patcher")
    mat_off = off + 8 + 40             # v0: ver/flags + times/ids + a/v
    one = 1 << 16
    if clockwise90:
        m = [0, one, 0, -one & 0xFFFFFFFF, 0, 0, 0, 0, 1 << 30]
    else:
        m = [0, -one & 0xFFFFFFFF, 0, one, 0, 0, 0, 0, 1 << 30]
    data[mat_off:mat_off + 36] = struct.pack(">9I", *m)
    open(dst, "wb").write(bytes(data))


def patch_vfr(src: str, dst: str) -> None:
    """Write dst = src with the stts run split: the first half of the
    samples keep their duration d, the second half get 2d.  moov and
    ancestor box sizes grow by the 8 inserted bytes; mdhd duration is
    updated so the file stays self-consistent."""
    data = bytes(open(src, "rb").read())
    boxes = _walk(data, 0, len(data))
    _p, off, size = _find(boxes, b"stts")
    ver_flags, n_entries = struct.unpack(">II", data[off + 8:off + 16])
    if n_entries != 1:
        raise ValueError(f"expected a single CFR stts run, got {n_entries}")
    count, delta = struct.unpack(">II", data[off + 16:off + 24])
    n1 = count // 2
    n2 = count - n1
    new_stts = (struct.pack(">I4s", size + 8, b"stts")
                + struct.pack(">II", ver_flags, 2)
                + struct.pack(">II", n1, delta)
                + struct.pack(">II", n2, delta * 2))

    # grow every ancestor of stts (all begin before it, end after it)
    grown = bytearray(data[:off] + new_stts + data[off + size:])
    for p, boff, bsize in boxes:
        if p[-1] in _CONTAINERS and boff < off < boff + bsize:
            old = struct.unpack(">I", data[boff:boff + 4])[0]
            grown[boff:boff + 4] = struct.pack(">I", old + 8)

    # keep mdhd duration consistent with the new total sample time
    _p2, moff, _ms = _find(boxes, b"mdhd")
    if grown[moff + 8] == 0:           # v0: duration at payload offset 16
        grown[moff + 8 + 16:moff + 8 + 20] = struct.pack(
            ">I", n1 * delta + n2 * delta * 2)
    open(dst, "wb").write(bytes(grown))
