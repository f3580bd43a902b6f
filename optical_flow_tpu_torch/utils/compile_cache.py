"""Where the port's built kernels live: its counterpart of the JAX
package's persistent compile cache (`optical_flow_tpu.utils.compile_cache`).

The CUDA kernels are built by nvcc at first use (`kernels/_build.py`)
into `<cache>/<hash>/lib<name>.so`, where <hash> covers the sources, the
headers and the nvcc flags (the `sm_90a` target among them).  <cache>
follows the JAX package's rules:

  1. OFT_COMPILE_CACHE=<dir>: that directory;
  2. unset: ~/.cache/optical_flow_tpu_torch/kernels, shared by every
     process of the user, so a machine builds each source once;
  3. OFT_COMPILE_CACHE=0: no shared cache.  Each process then builds into
     a private temporary directory of its own, and the warmup packs
     (`utils/warmup.py`) refuse to run.

Never a directory inside the installed package, which may be read-only
and is shared by every environment that imports it.
"""

from __future__ import annotations

import os
from pathlib import Path


def kernel_cache_dir() -> Path | None:
    """The shared kernel cache directory, or None when OFT_COMPILE_CACHE=0
    disables it.  The directory is not created here."""
    env = os.environ.get("OFT_COMPILE_CACHE", "")
    if env == "0":
        return None
    if env:
        return Path(env).expanduser()
    return Path.home() / ".cache" / "optical_flow_tpu_torch" / "kernels"
