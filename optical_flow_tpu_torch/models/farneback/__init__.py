"""The Farnebäck flow model: the entry points of `flow.py` and the plan of
`params.py`, under the names `optical_flow_tpu.models.farneback` exports.

The names load on first access (PEP 562): the kernel wrappers import
`models.farneback.core`, and an eager import of `flow` here would close
a cycle through them."""

import importlib

_EXPORTS = {
    "calc_flow": "flow",
    "calc_flow_batched": "flow",
    "calc_flow_bgr_batched": "flow",
    "calc_flow_chain_batched": "flow",
    "calc_flow_bgr_chain_batched": "flow",
    "FarnebackPlan": "params",
    "build_plan": "params",
    "effective_levels": "params",
    "poly_exp_weights": "params",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)


def __dir__():
    return sorted(list(globals()) + __all__)
