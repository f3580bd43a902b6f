"""Farnebäck, extractor and visualizer configuration, copies of
`optical_flow_tpu.utils.config`.

The copy exists because the card's machine has no JAX, and the JAX
package's `__init__` imports it.  `tests/test_torch_params.py` pins the
two together.
"""

from __future__ import annotations

import dataclasses

# Flag bits, mirroring cv2's public constants so configs translate 1:1.
OPTFLOW_USE_INITIAL_FLOW = 4
OPTFLOW_FARNEBACK_GAUSSIAN = 256


@dataclasses.dataclass(frozen=True)
class FarnebackConfig:
    """Parameters of the Farnebäck dense-flow algorithm.

    Defaults are the values frozen at both call sites of the reference
    scripts (`optical_flow.py:53-59`, `visualize_optical_flow.py:40-46`).
    """

    pyr_scale: float = 0.5
    levels: int = 3
    winsize: int = 15
    iterations: int = 3
    poly_n: int = 5
    poly_sigma: float = 1.2
    flags: int = 0

    @property
    def use_initial_flow(self) -> bool:
        return bool(self.flags & OPTFLOW_USE_INITIAL_FLOW)

    @property
    def gaussian_window(self) -> bool:
        return bool(self.flags & OPTFLOW_FARNEBACK_GAUSSIAN)

    def validate(self) -> "FarnebackConfig":
        if not (0.0 < self.pyr_scale < 1.0):
            raise ValueError(f"pyr_scale must be in (0, 1), got {self.pyr_scale}")
        if self.levels < 1:
            raise ValueError(f"levels must be >= 1, got {self.levels}")
        if self.winsize < 1:
            raise ValueError(f"winsize must be >= 1, got {self.winsize}")
        if self.iterations < 1:
            raise ValueError(f"iterations must be >= 1, got {self.iterations}")
        if self.poly_n < 1:
            raise ValueError(f"poly_n must be >= 1, got {self.poly_n}")
        return self


# Version stamp for .done sentinels, the reference's (`optical_flow.py:12`),
# so that .done files of the reference, the JAX package and the port are
# mutually accepted; format as `optical_flow.py:152`.
EXTRACTOR = "opticalflow"
VERSION = "20201209"


@dataclasses.dataclass(frozen=True)
class ExtractorConfig:
    """Corpus-extractor parameters (reference `optical_flow.py:171-185`).

    `force_run` is a *string* compared against 'True', the reference's
    CLI contract (`optical_flow.py:154,182`).  `validate` logs one sampled
    pair's EPE against cv2 per video; `resume` keeps a shot-granular
    checkpoint (io/sidecar.py:ShotProgress).  Both are the JAX package's
    additions to the reference.
    """

    frame_width: int = 129
    step_size: int = 300          # milliseconds
    window_size: int = 300        # milliseconds
    top_percentile: int = 5
    force_run: str = "False"
    validate: bool = False
    resume: bool = False
    farneback: FarnebackConfig = dataclasses.field(default_factory=FarnebackConfig)

    @property
    def done_version(self) -> str:
        """Content of the .done sentinel (`optical_flow.py:152`)."""
        return (
            VERSION
            + "\n" + str(self.frame_width)
            + "\n" + str(self.step_size)
            + "\n" + str(self.window_size)
            + "\n" + str(self.top_percentile)
        )


@dataclasses.dataclass(frozen=True)
class VisualizerConfig:
    """Shot-visualizer parameters (reference `visualize_optical_flow.py:6`)."""

    step_size: int = 300          # milliseconds, module constant STEP_SIZE
    jpeg_quality: int = 95        # cv2.imwrite default
    validate: bool = False        # log one sampled pair's EPE against cv2
    farneback: FarnebackConfig = dataclasses.field(default_factory=FarnebackConfig)


def config_from_jax(obj) -> FarnebackConfig:
    """A FarnebackConfig from any object with the same fields (such as the
    JAX package's FarnebackConfig) or from its `dataclasses.asdict` dict."""
    names = [f.name for f in dataclasses.fields(FarnebackConfig)]
    if isinstance(obj, dict):
        return FarnebackConfig(**{n: obj[n] for n in names})
    return FarnebackConfig(**{n: getattr(obj, n) for n in names})
