"""Where the port's entry points run: on the current CUDA card unless the
caller asks for the CPU.

A CPU tensor, `device="cpu"` or a CLI's `--device cpu` is that ask, and
runs the kernels' plain versions; anything else with no card visible
raises, so a run never drops to the CPU without saying so.
"""

from __future__ import annotations

import torch

_NO_CARD = ("no CUDA card is visible; pass device='cpu' (--device cpu on "
            "the CLIs) to run the plain PyTorch versions on the CPU")


def default_device() -> torch.device:
    """The current CUDA card; raises RuntimeError where there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(_NO_CARD)
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device: None is the current card, "cuda" (no
    index) the current card too; a CUDA device raises without a card."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(_NO_CARD)
        if device.index is None:
            return default_device()
    return device


def device_of(x, device=None) -> torch.device:
    """Where an entry runs on input `x`: `device` when given, else the
    device of a tensor `x` (a CPU tensor is the ask for the CPU), else
    (host arrays) the current card."""
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(device)
