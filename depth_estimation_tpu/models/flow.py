"""Single-scale patch-correlation flow model — the reference's central model.

Rebuilds getModel + prepareInput/prepareTarget/processOutput
(/root/reference/opticalflow_model.lua:81-320) as one jittable functional
pipeline: siamese ConvFilter -> SSD matching -> softmax(-cost) -> output head
('max' WTA with middle tie-break, or 'mean' soft-argmax).

Differences from the reference (semantics preserved):
  * the reference crops the raw image before filtering
    (prepareInput, opticalflow_model.lua:144-148); we filter the full frame
    once and crop the *features* — numerically identical for VALID convs and
    lets the filter run once per frame in streaming mode (the reference's
    "prefiltered" split, depth_estimation_api.lua:30-31, falls out for free).
  * everything is batched (leading axis) and NHWC.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import codecs
from ..geometry import Geometry, Learning
from ..ops import matching
from .filters import ConvFilter


def crop_features_center(geom: Geometry, f: jnp.ndarray) -> jnp.ndarray:
    """Crop the reference-branch feature map by the half-window so matching
    is centered (prepareInput, /root/reference/opticalflow_model.lua:144-148:
    drop ceil(maxh/2)-1 rows at top, floor(maxh/2) at bottom)."""
    h1, h2 = geom.halfh1, geom.halfh2
    w1, w2 = geom.halfw1, geom.halfw2
    return f[..., h1:f.shape[-3] - h2, w1:f.shape[-2] - w2, :]


class FlowModel:
    """Functional single-scale matcher. Params are a pytree from
    ``init``; all methods are jit-friendly pure functions."""

    def __init__(self, geometry: Geometry):
        geometry.validate()
        assert not geometry.multiscale
        self.geometry = geometry
        self.filter = ConvFilter(geometry)

    def init(self, rng) -> dict:
        g = self.geometry
        dummy = jnp.zeros((g.hPatch2, g.wPatch2, g.in_channels), jnp.float32)
        return self.filter.init(rng, dummy)

    # ---- forward ---------------------------------------------------------

    def features(self, params, image: jnp.ndarray) -> jnp.ndarray:
        """Run the conv trunk. image: (..., H, W, Cin) -> (..., H', W', K)."""
        return self.filter.apply(params, image)

    def costs(self, params, img1: jnp.ndarray, img2: jnp.ndarray) -> jnp.ndarray:
        """Full cost volume for a frame pair (unbatched: (H, W, C) inputs).
        Returns (H'', W'', maxh*maxw) SSD costs."""
        g = self.geometry
        f1 = crop_features_center(g, self.features(params, img1))
        f2 = self.features(params, img2)
        return matching.match_ssd(f1, f2, g.maxh, g.maxw)

    def log_scores(self, params, img1, img2) -> jnp.ndarray:
        """Training head for 'max': log softmax(-cost) over the window —
        the reference's Minus+SoftMax+Log stack
        (/root/reference/opticalflow_model.lua:94-117)."""
        return jax.nn.log_softmax(-self.costs(params, img1, img2), axis=-1)

    def scores(self, params, img1, img2) -> jnp.ndarray:
        return jax.nn.softmax(-self.costs(params, img1, img2), axis=-1)

    def forward_fused(self, params, img1, img2):
        """Inference fast path: the fused matcher kernel, no cost volume in
        device memory.
        Returns (idx, ey, ex, pmax), each (H'', W'')."""
        g = self.geometry
        f1 = crop_features_center(g, self.features(params, img1))
        f2 = self.features(params, img2)
        return matching.match_flow_fused(f1, f2, g.maxh, g.maxw)


# ---------------------------------------------------------------------------
# Target encoding (prepareTarget)
# ---------------------------------------------------------------------------

def prepare_target(
    geom: Geometry, learning: Learning, target_yx
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Encode a continuous GT displacement into (itarget, target).

    Port of prepareTarget (/root/reference/opticalflow_model.lua:277-320):
    displacements outside the window are clamped to (0, 0) ("flat pixel");
    with soft targets the target is an (unnormalized) Gaussian over window
    cells, sigma^2 = learning.st_sigma2. target_yx: (..., 2) array (dy, dx).
    """
    t = jnp.asarray(target_yx)
    dy, dx = t[..., 0], t[..., 1]
    if geom.multiscale:
        lo_h = -(math.ceil(geom.maxh * geom.rmax / 2)) + 1
        hi_h = (geom.maxh * geom.rmax) // 2
        lo_w = -(math.ceil(geom.maxw * geom.rmax / 2)) + 1
        hi_w = (geom.maxw * geom.rmax) // 2
    else:
        lo_h, hi_h = -geom.halfh1, geom.halfh2
        lo_w, hi_w = -geom.halfw1, geom.halfw2
    inside = (dy >= lo_h) & (dy <= hi_h) & (dx >= lo_w) & (dx <= hi_w)
    dy = jnp.where(inside, dy, 0)
    dx = jnp.where(inside, dx, 0)
    itarget = codecs.encode(geom, dy, dx)

    if learning.soft_targets:
        off = codecs.window_offsets(geom).astype(jnp.float32)  # (D, 2)
        d2 = (dy[..., None] - off[:, 0]) ** 2 + (dx[..., None] - off[:, 1]) ** 2
        target = jnp.exp(-d2 / learning.st_sigma2)
        return itarget, target
    return itarget, itarget


# ---------------------------------------------------------------------------
# Output decoding (processOutput)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FlowOutput:
    """Decoded flow. y/x are centered displacements (H'', W''); full is the
    (2, hImg, wImg) zero-padded full-frame flow; confidences as in the
    reference (1s, or thresholded extract scores)."""
    index: jnp.ndarray
    y: jnp.ndarray
    x: jnp.ndarray
    confidences: Optional[jnp.ndarray] = None
    full: Optional[jnp.ndarray] = None
    full_confidences: Optional[jnp.ndarray] = None


def process_output(
    geom: Geometry,
    dist: jnp.ndarray,
    process_full: bool = True,
    threshold: Optional[float] = None,
    method: str = "max",
) -> FlowOutput:
    """Decode a window distribution (H'', W'', D) into flow.

    Port of processOutput (/root/reference/opticalflow_model.lua:201-252),
    honoring geometry.output_extraction_method: 'max' = WTA with middle
    tie-break (no threshold) or extract_output confidences (with
    threshold); 'mean' = soft-argmax expectation decode
    (getOutputConfidences2) — the 'cc-mean' GT variant's head. Both then
    assemble the full frame with centered zero padding.
    """
    from ..ops import extract

    mid = codecs.middle_index(geom)
    if method == "mean":
        ey, ex = soft_argmax(geom, dist)
        # confidence gate of the mean head: y-marginal mass above threshold
        # (getOutputConfidences2, opticalflow_model.lua:192-196)
        if threshold is None:
            confidences = jnp.ones(ey.shape, dist.dtype)
        else:
            pmax = jnp.max(dist, axis=-1)
            confidences = (pmax > threshold).astype(dist.dtype)
        out = FlowOutput(index=None, y=ey, x=ex, confidences=confidences)
        if process_full:
            H, W = ey.shape[-2], ey.shape[-1]
            hoff = (geom.hImg - H) // 2
            woff = (geom.wImg - W) // 2
            full = jnp.zeros((2, geom.hImg, geom.wImg), dist.dtype)
            full = full.at[0, hoff:hoff + H, woff:woff + W].set(ey)
            full = full.at[1, hoff:hoff + H, woff:woff + W].set(ex)
            fullc = jnp.zeros((geom.hImg, geom.wImg), dist.dtype)
            fullc = fullc.at[hoff:hoff + H, woff:woff + W].set(confidences)
            out.full = full
            out.full_confidences = fullc
        return out
    if threshold is None:
        # argmax + flat-pixel tie-break; scores are -dist? No: dist is the
        # softmax distribution, WTA = argmax with middle preference.
        best = jnp.argmax(dist, axis=-1).astype(jnp.int32)
        m = jnp.max(dist, axis=-1)
        tie = dist[..., mid] >= m
        index = jnp.where(tie, mid, best)
        confidences = jnp.ones(index.shape, dist.dtype)
    else:
        index, scores = extract.extract_output(dist, 0.11)
        confidences = (scores > threshold).astype(dist.dtype)

    y, x = codecs.decode(geom, index)
    out = FlowOutput(index=index, y=y, x=x, confidences=confidences)

    if process_full:
        H, W = index.shape[-2], index.shape[-1]
        hoff = (geom.hImg - H) // 2
        woff = (geom.wImg - W) // 2
        full = jnp.zeros((2, geom.hImg, geom.wImg), dist.dtype)
        full = full.at[0, hoff:hoff + H, woff:woff + W].set(y.astype(dist.dtype))
        full = full.at[1, hoff:hoff + H, woff:woff + W].set(x.astype(dist.dtype))
        fullc = jnp.zeros((geom.hImg, geom.wImg), dist.dtype)
        fullc = fullc.at[hoff:hoff + H, woff:woff + W].set(confidences)
        out.full = full
        out.full_confidences = fullc
    return out


def soft_argmax(geom: Geometry, dist: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """'mean' head: expectation of centered (dy, dx) under the distribution
    (reference OutputExtractor, /root/reference/OutputExtractor.lua:21-35,
    and getOutputConfidences2, opticalflow_model.lua:171-199)."""
    off = codecs.window_offsets(geom).astype(dist.dtype)
    ey = jnp.einsum("...d,d->...", dist, off[:, 0])
    ex = jnp.einsum("...d,d->...", dist, off[:, 1])
    return ey, ex
