"""JPEG output matching cv2.imwrite defaults, a port of
`optical_flow_tpu.io.jpeg`.

cv2.imwrite('x.jpeg', bgr) is libjpeg at quality 95 with stock tables and
4:2:0; the native encoder writes the same bytes, and so does PIL at the
same quality, which serves where the native library cannot be built or
loaded.  Reference call sites: `visualize_optical_flow.py:59-60`.
"""

from __future__ import annotations

import ctypes
import subprocess

import numpy as np


def write_jpeg_bgr(path: str, bgr: np.ndarray, quality: int = 95) -> None:
    bgr = np.ascontiguousarray(bgr, dtype=np.uint8)
    h, w = bgr.shape[:2]
    from optical_flow_tpu_torch.io.native import get_lib
    try:
        lib = get_lib()
    except (OSError, subprocess.CalledProcessError):
        lib = None
    if lib is not None and lib.ofio_jpeg_write(
            str(path).encode(),
            bgr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h,
            int(quality)):
        return
    from PIL import Image
    Image.fromarray(bgr[..., ::-1]).save(str(path), quality=int(quality))
