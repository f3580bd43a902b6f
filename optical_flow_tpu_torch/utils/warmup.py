"""Warm start: build the kernels ahead of the first video, launch the
production device steps once, and carry the built kernels to fresh
machines.  A port of `optical_flow_tpu.utils.warmup`.

The JAX package compiles one executable per shape; the port builds each
CUDA source once per source hash (`kernels/_build.py`) into the kernel
cache (`utils/compile_cache.py`), in seconds with nvcc.  The warmers
build every kernel and launch the same steps the pipelines launch, at
the chunk they launch them at, so a warmed worker's first real chunk
builds nothing and its peak device memory is known:

  * `warmup_extractor`: `_magnitude_sums` on `pair_chunk_for(gh, gw,
    device=)` pairs at the frame size `aspect_preserving_size` gives,
    sharded over every card where the extractor would shard it
    (`parallel/mesh.py:dp_mesh`);
  * `warmup_visualizer`: `calc_flow_bgr_chain_batched` on the
    `(dispatch_pairs(h, w, pair_chunk_for(h, w, device=)) + 1, h, w)`
    frame stack, or under that mesh `sharded_bgr_chain_step` on its
    `chain_shards`;
  * `warmup_flow`: `calc_flow_batched` and the magnitude sums.

Each returns what it launched: the chunk, the shape, the seconds of the
launch, the data shards it ran on and, on a card,
`torch.cuda.max_memory_allocated` over it (on the first card).

Cold-start packs: `pack_cache` writes this tree's built libraries
(`<cache>/<hash>/lib<name>.so`) and a manifest (the hash, `sm_90a`,
nvcc's version line) into a .tgz; `unpack_cache` restores it on a fresh
machine of the same tree, and refuses a pack of another source hash.
Both need the shared cache (not OFT_COMPILE_CACHE=0).

    python -m optical_flow_tpu_torch.utils.warmup --res 1920x1080 --pack warm.tgz
    # on each fresh machine:
    python -m optical_flow_tpu_torch.utils.warmup --unpack warm.tgz --res 1920x1080

The CLI prints one JSON line: the cache directory, the nvcc runs its
build made (0 on a warm or restored start) and what each warmer ran.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import shutil
import subprocess
import sys
import tarfile
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

from optical_flow_tpu_torch.kernels import _build
from optical_flow_tpu_torch.models.farneback.flow import (
    calc_flow_batched, calc_flow_bgr_chain_batched)
from optical_flow_tpu_torch.kernels.magnitude_sum import magnitude_sum
from optical_flow_tpu_torch.ops.resize import aspect_preserving_size
from optical_flow_tpu_torch.parallel.mesh import chain_shards, dp_mesh, sharded_bgr_chain_step
from optical_flow_tpu_torch.pipeline.extractor import _magnitude_sums
from optical_flow_tpu_torch.pipeline.prefetch import dispatch_pairs, pair_chunk_for
from optical_flow_tpu_torch.utils.compile_cache import kernel_cache_dir
from optical_flow_tpu_torch.utils.config import ExtractorConfig, FarnebackConfig
from optical_flow_tpu_torch.utils.device import resolve_device
from optical_flow_tpu_torch.utils.logging import get_logger

logger = get_logger("optical_flow_tpu_torch.warmup")

ARCH = "sm_90a"
MANIFEST = "manifest.json"


def _launch(device: torch.device, shape, step, mesh=None) -> dict:
    """Build the kernels (on a card), then run `step()` once and wait for
    it (on every card of `mesh`): its seconds and, on a card, its peak
    device memory on `device`."""
    cards = [device] if mesh is None else sorted(set(mesh.devices.flat), key=str)
    if device.type == "cuda":
        _build.build()
        for d in cards:
            torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    step()
    peak = None
    if device.type == "cuda":
        for d in cards:
            torch.cuda.synchronize(d)
        peak = torch.cuda.max_memory_allocated(device)
    return {"shape": list(shape), "chunk": shape[0],
            "shards": 1 if mesh is None else mesh.shape["data"],
            "seconds": time.perf_counter() - t0, "peak_bytes": peak}


def warmup_flow(h: int, w: int, batch: Optional[int] = None,
                config: FarnebackConfig = FarnebackConfig(), *,
                device=None) -> dict:
    """Launch the batched flow pyramid and its magnitude sums once on
    (batch, h, w) pairs, batch `pair_chunk_for(h, w)` by default."""
    device = resolve_device(device)
    b = batch or pair_chunk_for(h, w, device=device)
    z = torch.zeros((b, h, w), dtype=torch.uint8, device=device)

    def step():
        flow = calc_flow_batched(z, z, config)
        float(magnitude_sum(flow.movedim(-1, 1)).sum())

    info = _launch(device, (b, h, w), step)
    logger.info("warmed the flow for %s: %s", (b, h, w), info)
    return info


def warmup_extractor(src_h: int, src_w: int,
                     config: ExtractorConfig = ExtractorConfig(), *,
                     device=None) -> dict:
    """Launch the extractor's device step for a source resolution once:
    `_magnitude_sums` at the `pair_chunk_for` chunk `extract_video`
    sends, at the frame size its resize gives, sharded where the
    extractor shards it."""
    mesh = dp_mesh(device)
    device = resolve_device(device)
    if config.frame_width:
        gw, gh = aspect_preserving_size(src_h, src_w, config.frame_width)
    else:
        gw, gh = src_w, src_h
    b = pair_chunk_for(max(gh, 1), max(gw, 1), device=device)
    z = torch.zeros((b, gh, gw), dtype=torch.uint8, device=device)

    def step():
        float(_magnitude_sums(z, z, config, device=device, mesh=mesh)[0].sum())

    info = _launch(device, (b, gh, gw), step, mesh)
    logger.info("warmed the extractor for %dx%d: %s", src_w, src_h, info)
    return info


def warmup_visualizer(src_h: int, src_w: int,
                      config: FarnebackConfig = FarnebackConfig(), *,
                      device=None) -> dict:
    """Launch the visualizer's device step for a source resolution once:
    the chained flow + colorize on the frame stack `visualize_frames`
    sends, `(dispatch_pairs(h, w, pair_chunk_for(h, w)) + 1, h, w)`, split
    into sub-chains where the visualizer splits it.  `chunk` is the pair
    count."""
    mesh = dp_mesh(device)
    device = resolve_device(device)
    b = dispatch_pairs(src_h, src_w, pair_chunk_for(src_h, src_w, device=device),
                       1 if mesh is None else mesh.devices.size)
    frames = torch.zeros((b + 1, src_h, src_w), dtype=torch.uint8, device=device)

    def step():
        if mesh is None:
            out = calc_flow_bgr_chain_batched(frames, config)
        else:
            out = sharded_bgr_chain_step(mesh, chain_shards(frames, mesh.shape["data"]),
                                         config)
        int(out[:, :, ::31, ::31].sum())

    info = _launch(device, (b + 1, src_h, src_w), step, mesh)
    info["chunk"] = b
    logger.info("warmed the visualizer for %dx%d: %s", src_w, src_h, info)
    return info


# --- cold-start packs --------------------------------------------------------

def _cache_dir() -> Path:
    """This tree's build directory in the shared cache; raises where
    OFT_COMPILE_CACHE=0 disables the cache."""
    if kernel_cache_dir() is None:
        raise RuntimeError("the kernel cache is disabled (OFT_COMPILE_CACHE=0); "
                           "packs need it")
    return _build.build_dir()


def _nvcc_version() -> Optional[str]:
    """nvcc's release line, or None where there is no nvcc."""
    try:
        out = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = [ln for ln in out.splitlines() if "release" in ln]
    return lines[0].strip() if lines else None


def _library_names() -> set:
    return {f"lib{name}.so" for name in _build.SOURCES}


def pack_cache(path: str) -> int:
    """Write this tree's built libraries and a manifest into the .tgz at
    `path`; returns how many libraries it holds."""
    d = _cache_dir()
    libs = sorted(n for n in _library_names() if (d / n).is_file())
    manifest = {"hash": d.name, "arch": ARCH, "nvcc": _nvcc_version(),
                "libraries": libs}
    data = json.dumps(manifest).encode()
    with tarfile.open(path, "w:gz") as tf:
        info = tarfile.TarInfo(MANIFEST)
        info.size, info.mtime = len(data), int(time.time())
        tf.addfile(info, io.BytesIO(data))
        for n in libs:
            tf.add(d / n, arcname=n)
    logger.info("packed %d kernel libraries from %s into %s", len(libs), d, path)
    return len(libs)


def unpack_cache(path: str) -> int:
    """Restore a pack into this tree's build directory; returns how many
    libraries it wrote.  Refuses a pack whose source hash is not this
    tree's.  Only flat regular files named lib<name>.so for a name in
    `_build.SOURCES` are extracted (with the `data` filter), each written
    under a temporary name and renamed into place, as `build()` writes."""
    d = _cache_dir()
    with tarfile.open(path, "r:gz") as tf:
        try:
            manifest = json.load(tf.extractfile(MANIFEST))
        except KeyError:
            raise ValueError(f"{path} has no {MANIFEST}: not a kernel pack") from None
        if manifest.get("hash") != d.name or manifest.get("arch") != ARCH:
            raise ValueError(
                f"{path} holds kernels built from source hash {manifest.get('hash')} "
                f"for {manifest.get('arch')}; this tree's is {d.name} for {ARCH}")
        wanted = _library_names()
        members = [m for m in tf.getmembers()
                   if m.isfile() and m.name in wanted]
        d.mkdir(parents=True, exist_ok=True)
        staging = Path(tempfile.mkdtemp(prefix=".unpack-", dir=d))
        try:
            for m in members:
                tf.extract(m, staging, filter="data")
                os.replace(staging / m.name, d / m.name)
        finally:
            shutil.rmtree(staging, ignore_errors=True)
    logger.info("unpacked %d kernel libraries from %s into %s", len(members), path, d)
    return len(members)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Build the kernels, warm the production steps and "
                    "pack/unpack the built kernels for cold starts.")
    parser.add_argument("--res", action="append", default=[],
                        help="source resolution WxH to warm (extractor + "
                             "visualizer); repeatable, e.g. --res 1920x1080 "
                             "--res 3840x2160")
    parser.add_argument("--pack", help="write the built kernels into this .tgz")
    parser.add_argument("--unpack", help="restore a .tgz into the kernel cache")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default: the current card, or every "
                             "visible card where the pipelines shard), "
                             "cuda:<i> (one card) or cpu (the plain "
                             "versions; builds nothing)")
    args = parser.parse_args(argv)
    out = {"cache": str(_cache_dir())}
    if args.unpack:
        out["unpacked"] = unpack_cache(args.unpack)
    device = resolve_device(args.device)
    if device.type == "cuda":
        report = _build.build()
        out.update(build_s=report.seconds, nvcc_runs=report.nvcc_runs)
    warmed = []
    for res in args.res:
        w, h = (int(v) for v in res.lower().split("x"))
        warmed.append({"res": res,
                       "extractor": warmup_extractor(h, w, device=args.device),
                       "visualizer": warmup_visualizer(h, w, device=args.device)})
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out["warmed"] = warmed
    if args.pack:
        out["packed"] = pack_cache(args.pack)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
