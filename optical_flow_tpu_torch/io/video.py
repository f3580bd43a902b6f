"""VideoReader: cv2.VideoCapture-style frame-index access on the native
libav decoder, a port of `optical_flow_tpu.io.video`.

  * `fps`, `frame_count`, `width`, `height`: what the reference reads via
    CAP_PROP_FPS / CAP_PROP_FRAME_COUNT;
  * `read_at(pos)`: seek by frame index and decode; float positions decode
    frame floor(pos), as CAP_PROP_POS_FRAMES does; returns
    (ret, BGR uint8 (H, W, 3) | None) like `vid.read()`.

A variable-frame-rate stream raises `VFRStreamError` (fps-based seeks would
select wrong frames) unless OFIO_ALLOW_VFR=1; a rotation in the stream's
display matrix is logged and the frames are decoded unrotated, as the
reference's pinned cv2 4.2 does.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from optical_flow_tpu_torch.io.native import get_lib
from optical_flow_tpu_torch.utils.logging import get_logger

logger = get_logger("io.video")


class VFRStreamError(IOError):
    """A variable-frame-rate stream, on which frame-index seeks are wrong."""


class VideoReader:
    def __init__(self, path: str):
        self._h = None
        self._lib = get_lib()
        self._h = self._lib.ofio_open(str(path).encode())
        self.path = path
        self.rotation_degrees = 0.0
        self.is_vfr = False
        self.fps = 0.0
        self.frame_count = self.width = self.height = 0
        if not self._h:
            return
        fps, cnt = ctypes.c_double(), ctypes.c_int64()
        w, h = ctypes.c_int(), ctypes.c_int()
        self._lib.ofio_props(self._h, ctypes.byref(fps), ctypes.byref(cnt),
                             ctypes.byref(w), ctypes.byref(h))
        self.fps = fps.value
        self.frame_count = int(cnt.value)
        self.width, self.height = int(w.value), int(h.value)
        rot, vfr = ctypes.c_double(), ctypes.c_int()
        self._lib.ofio_meta(self._h, ctypes.byref(rot), ctypes.byref(vfr))
        self.rotation_degrees = float(rot.value)
        self.is_vfr = bool(vfr.value)
        if self.is_vfr and os.environ.get("OFIO_ALLOW_VFR") != "1":
            self.release()
            raise VFRStreamError(
                f"'{path}': variable frame rate stream: frame-index seeks "
                "are fps-based and would select wrong frames. Re-encode to "
                "constant frame rate, or set OFIO_ALLOW_VFR=1 to force "
                "cv2-style fps-based indexing anyway.")
        if self.rotation_degrees:
            logger.warning(
                "'%s' carries a displaymatrix rotation of %g deg; decoding "
                "unrotated for cv2-4.2 parity", path, self.rotation_degrees)

    def is_opened(self) -> bool:
        return bool(self._h)

    def read_at(self, pos: float):
        """Decode frame floor(pos).  Returns (ret, frame_bgr | None)."""
        if not self._h:
            return False, None
        buf = np.empty((self.height, self.width, 3), np.uint8)
        ok = self._lib.ofio_read_frame(
            self._h, float(pos),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if not ok:
            return False, None
        return True, buf

    def release(self) -> None:
        if self._h:
            self._lib.ofio_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()

    def __del__(self):
        self.release()
