"""Builds the CUDA kernels at first use and loads them with ctypes.

Each `csrc/<name>.cu` has a plain C interface (no PyTorch headers), so
nvcc builds it in seconds; `csrc/*.cuh` are headers they share.  The
shared library goes to `<cache>/<hash>/lib<name>.so`, where <cache> is
`utils/compile_cache.py:kernel_cache_dir()` (OFT_COMPILE_CACHE, else
~/.cache/optical_flow_tpu_torch/kernels; a private temporary directory
for the process where OFT_COMPILE_CACHE=0) and <hash> covers the
sources, the headers and the flags: a changed source builds anew, an
unchanged one is loaded as it is.  Each library is written under a
temporary name and renamed into place, so processes that build the same
<hash> at once never load a partial file.  Nothing here runs at import
time.

`--fmad=false`: the plain versions run unfused elementwise ops, and FMA
contraction would move the rint boundary of the displaced fetch and the
last bits of every stencil.
"""

from __future__ import annotations

import atexit
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import NamedTuple

from optical_flow_tpu_torch.utils.compile_cache import kernel_cache_dir

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("blur_solve", "colorize", "gauss", "gauss_resize", "magnitude_sum",
           "polyexp", "resample", "update_blur", "update_blur_poly",
           "update_matrices")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's default place."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


@functools.lru_cache(maxsize=1)
def _private_dir() -> Path:
    """This process's own build directory, for OFT_COMPILE_CACHE=0;
    removed at exit."""
    path = tempfile.mkdtemp(prefix="optical_flow_tpu_torch_kernels_")
    atexit.register(shutil.rmtree, path, ignore_errors=True)
    return Path(path)


def source_hash() -> str:
    """16 hex digits over the nvcc flags and every source and header."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    files = [CSRC / f"{name}.cu" for name in SOURCES] + sorted(CSRC.glob("*.cuh"))
    for path in files:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    """Where this tree's libraries are built and loaded from."""
    return (kernel_cache_dir() or _private_dir()) / source_hash()


def nvcc_command(name: str, out: Path) -> list:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


class BuildReport(NamedTuple):
    seconds: float      # wall time of the call
    nvcc_runs: int      # libraries compiled: 0 where all were built already


def build(names=SOURCES) -> BuildReport:
    """Compile every library in `names` that is not built yet, in parallel.
    Returns the seconds it took and how many nvcc runs it made; raises
    with nvcc's output on failure."""
    t0 = time.perf_counter()
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        lib = out_dir / f"lib{name}.so"
        if lib.exists():
            continue
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        procs.append((lib, tmp, subprocess.Popen(
            nvcc_command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    errors = []
    for lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{lib.name}: nvcc exit {proc.returncode}\n{log}")
        else:
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return BuildReport(time.perf_counter() - t0, len(procs))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if need be."""
    with _lock:
        if name not in _libs:
            build((name,))
            _libs[name] = ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
        return _libs[name]
