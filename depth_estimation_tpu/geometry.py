"""Geometry / learning configuration for the flow+depth framework.

The reference builds free-form Lua tables named ``geometry`` and ``learning``
(see /root/reference/opticalflow.lua:120-220, radial/train_radial_opticalflow.lua:83-130).
Here they are frozen dataclasses — hashable so they can be closed over by
``jax.jit`` as static configuration, with every derived quantity (patch sizes,
kernel composition, window halves) computed once in Python, keeping all shapes
static for XLA.

Conventions (inherited from the reference and preserved exactly):
  * the search window is ``maxh x maxw``; centered displacement ``dy`` ranges
    over ``[-(ceil(maxh/2)-1), floor(maxh/2)]`` (asymmetric for even sizes),
    same for ``dx`` — see /root/reference/opticalflow_model.lua:29-34,277-297.
  * the feature extractor is a stack of valid convolutions; the total kernel
    footprint is ``hKernel x wKernel`` (composition of the per-layer kernels),
    so a patch of ``hPatch2 = maxh + hKernel - 1`` produces a ``maxh``-tall
    feature map — /root/reference/opticalflow.lua:161-189.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal, Optional, Tuple

# One conv layer: (in_channels, kernel_h, kernel_w, out_channels).
# Mirrors the reference's geometry.layers entries
# (/root/reference/opticalflow.lua:152-171).
LayerSpec = Tuple[int, int, int, int]


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Static geometry of a flow matcher model (shapes, windows, pyramid)."""

    # Image size the model operates on (train/infer resolution).
    hImg: int = 180
    wImg: int = 320

    # Conv feature stack (valid convs, Tanh between layers, none after last).
    layers: Tuple[LayerSpec, ...] = ((3, 16, 16, 10),)

    # Search window of the matcher (displacement search range).
    maxh: int = 16
    maxw: int = 16

    # Window/kernel used by the exhaustive cross-correlation groundtruth.
    maxhGT: int = 16
    maxwGT: int = 16
    hKernelGT: int = 16
    wKernelGT: int = 16

    # Multiscale (foveated pyramid) settings.
    multiscale: bool = False
    ratios: Tuple[int, ...] = (1,)
    share_filters: bool = True
    cascad_trainable_weights: bool = False
    single_beta: bool = False

    # Output head: 'max' = argmax/WTA over window logits (NLL training),
    # 'mean' = soft-argmax expectation (MSE training).
    output_extraction_method: Literal["max", "mean"] = "max"

    # When True the model consumes pre-filtered feature maps (streaming mode:
    # filter runs once per frame, matcher on consecutive pairs) —
    # /root/reference/depth_estimation_api.lua:30-31.
    prefilter: bool = False

    training_mode: bool = True

    # ---- derived sizes -------------------------------------------------

    @property
    def hKernel(self) -> int:
        """Total vertical footprint of the conv stack (composition)."""
        return sum(l[1] - 1 for l in self.layers) + 1

    @property
    def wKernel(self) -> int:
        return sum(l[2] - 1 for l in self.layers) + 1

    @property
    def hPatch2(self) -> int:
        """Height of the patch fed to the 2nd (searched) branch."""
        return self.maxh + self.hKernel - 1

    @property
    def wPatch2(self) -> int:
        return self.maxw + self.wKernel - 1

    @property
    def hPatch1(self) -> int:
        """Height of the (cropped) reference branch patch."""
        return self.hKernel

    @property
    def wPatch1(self) -> int:
        return self.wKernel

    # Window halves. For a window of size n, centered displacements span
    # [-half_lo, half_hi] with half_lo = ceil(n/2)-1, half_hi = floor(n/2).
    @property
    def halfh1(self) -> int:
        return int(math.ceil(self.maxh / 2)) - 1

    @property
    def halfh2(self) -> int:
        return self.maxh // 2

    @property
    def halfw1(self) -> int:
        return int(math.ceil(self.maxw / 2)) - 1

    @property
    def halfw2(self) -> int:
        return self.maxw // 2

    @property
    def in_channels(self) -> int:
        return self.layers[0][0]

    @property
    def out_channels(self) -> int:
        return self.layers[-1][3]

    @property
    def rmax(self) -> int:
        return self.ratios[-1]

    def validate(self) -> None:
        if self.multiscale:
            assert self.ratios[0] == 1, "first pyramid ratio must be 1"
            for r in self.ratios:
                k = self.rmax - r
                assert (self.maxh * k) % 2 == 0 and (self.maxw * k) % 2 == 0, (
                    "maxh/maxw * (rmax - r) must be even for every ratio "
                    "(/root/reference/opticalflow_model_multiscale.lua:183-188)"
                )
        for a, b in zip(self.layers[:-1], self.layers[1:]):
            assert a[3] >= b[0], "layer channel chain mismatch"


@dataclasses.dataclass(frozen=True)
class Learning:
    """Training hyper-parameters (reference 'learning' table,
    /root/reference/opticalflow.lua:210-220)."""

    rate: float = 5e-3
    # Torch optim.sgd learningRateDecay semantics; default matches the
    # reference CLI default (-lrd 5e-7, /root/reference/opticalflow.lua:47-48)
    rate_decay: float = 5e-7
    weight_decay: float = 0.0
    n_epochs: int = 10
    # 'nll' on window logits | 'mse' on soft-argmax output | 'soft' = soft
    # (Gaussian) targets with cross-entropy (reference DistNLLCriterion).
    criterion: Literal["nll", "mse", "soft"] = "nll"
    soft_targets: bool = False
    st_sigma2: float = 1.0            # sigma^2 of the soft-target Gaussian
    batch_size: int = 32


def default_geometry(**overrides) -> Geometry:
    """The reference's canonical single-scale config
    (/root/reference/opticalflow.lua:120-198 defaults)."""
    g = Geometry(**overrides)
    g.validate()
    return g
