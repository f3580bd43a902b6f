"""ctypes binding to `native/libofio.so` (libav decoder + libjpeg encoder),
a port of `optical_flow_tpu.io.native`.

The library is the repo's own, built from the unedited `native/ofio.cpp`
by `make -C native` (g++, pkg-config and the libav/libjpeg development
packages) at the first `get_lib()` call when it is missing or older than
its source.  Importing this module builds and loads nothing.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
SO_PATH = NATIVE_DIR / "libofio.so"

_lock = threading.Lock()
_lib = None


def _build() -> None:
    subprocess.run(["make", "-C", str(NATIVE_DIR)], check=True,
                   capture_output=True, text=True)


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        src = NATIVE_DIR / "ofio.cpp"
        if (not SO_PATH.exists()
                or (src.exists()
                    and src.stat().st_mtime > SO_PATH.stat().st_mtime)):
            _build()
        lib = ctypes.CDLL(str(SO_PATH))
        p, dp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)
        ip, u8p = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint8)
        lib.ofio_open.argtypes = [ctypes.c_char_p]
        lib.ofio_open.restype = p
        lib.ofio_props.argtypes = [p, dp, ctypes.POINTER(ctypes.c_int64), ip, ip]
        lib.ofio_props.restype = ctypes.c_int
        lib.ofio_read_frame.argtypes = [p, ctypes.c_double, u8p]
        lib.ofio_read_frame.restype = ctypes.c_int
        lib.ofio_meta.argtypes = [p, dp, ip]
        lib.ofio_meta.restype = ctypes.c_int
        lib.ofio_close.argtypes = [p]
        lib.ofio_close.restype = None
        lib.ofio_jpeg_write.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int]
        lib.ofio_jpeg_write.restype = ctypes.c_int
        _lib = lib
        return _lib
