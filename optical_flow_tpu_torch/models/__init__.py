"""The flow entry points, under the names `optical_flow_tpu.models`
exports; they load on first access, as in `models.farneback`."""

import importlib

__all__ = [
    "calc_flow",
    "calc_flow_batched",
    "calc_flow_bgr_batched",
    "calc_flow_chain_batched",
    "calc_flow_bgr_chain_batched",
]


def __getattr__(name):
    if name not in __all__:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.farneback.flow"), name)


def __dir__():
    return sorted(list(globals()) + __all__)
