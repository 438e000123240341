"""Confidence extraction over per-pixel window distributions.

Rebuild of extract_output.cpp (/root/reference/extract_output.cpp:63-155
ExtractOutput, :157-255 ExtractOutputMarginalized — the file ships two
identical copies of the latter): the reference scans each pixel's
distribution, collects the FIRST-in-scan-order 4 (threshold >= 0.2) or 8
values above the threshold, sorts them with hand-rolled sorting networks,
and returns the argmax-among-kept index plus a rank-weighted score
``sum_k (K - k) * v_sorted[k]`` (cumsum-then-sum, :121-129). Here the
scan-order keep is a cumsum mask and the sort is ``jax.lax.top_k`` —
vectorized over all pixels at once, bit-matching the C scan (property-tested
against a literal numpy port in tests/test_extract.py).

One deviation (saner): pixels with no value above the threshold have
*uninitialized* idx/score in the reference (the output tensors are never
zeroed); we return the plain argmax and score 0.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnums=(1, 2))
def extract_output(
    dist: jnp.ndarray, threshold: float = 0.11, max_highs: int | None = None
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Args: dist (..., D) per-pixel distribution (softmax scores).
    Returns (idx, score): argmax flat index among the first-in-scan-order
    max_highs above-threshold entries (int32; plain argmax where nothing
    clears the threshold) and the rank-weighted accumulated score
    (0 where nothing clears the threshold)."""
    if max_highs is None:
        max_highs = 8 if threshold < 0.2 else 4
    k_eff = min(max_highs, dist.shape[-1])
    above = dist > threshold
    # the reference keeps the FIRST max_highs entries in scan order
    # (extract_output.cpp:98-112), not the largest ones
    kept = above & (jnp.cumsum(above, axis=-1) <= max_highs)
    v = jnp.where(kept, dist, 0.0)
    vals, _ = jax.lax.top_k(v, k_eff)
    # rank weights start at max_highs even when D < max_highs (the reference
    # always uses a buffer of max_highs slots, zero-filled)
    weights = jnp.arange(max_highs, max_highs - k_eff, -1, dtype=dist.dtype)
    score = jnp.einsum("...k,k->...", vals, weights)
    any_kept = kept.any(axis=-1)
    idx = jnp.where(any_kept, jnp.argmax(v, axis=-1),
                    jnp.argmax(dist, axis=-1)).astype(jnp.int32)
    return idx, score


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def extract_output_marginalized(
    dist: jnp.ndarray, threshold: float = 0.11, threshold_acc: float = 0.0,
    max_highs: int | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """ExtractOutputMarginalized (/root/reference/extract_output.cpp:157-255):
    same scan as extract_output but gates on the accumulated score —
    returns (idx, good) with good = 1 where the rank-weighted score clears
    threshold_acc (int32; the reference's retgd), 0 elsewhere. The caller
    marginalizes the window distribution first (getOutputConfidences2,
    opticalflow_model.lua:192-193, sums over the x axis before extracting)."""
    idx, score = extract_output(dist, threshold, max_highs)
    good = (score >= threshold_acc).astype(jnp.int32)
    return idx, good


def confidences_from_marginal(marg: jnp.ndarray,
                              threshold: float = 0.11) -> jnp.ndarray:
    """Thresholded extraction on an already-computed y-marginal
    (..., maxh) -> bool (...): score > 0 (getOutputConfidences2's gds)."""
    _, score = extract_output(marg, threshold)
    return score > 0


def mean_head_confidences(dist: jnp.ndarray, maxh: int, maxw: int,
                          threshold: float = 0.11) -> jnp.ndarray:
    """The 'mean' output head's confidence gate (getOutputConfidences2,
    /root/reference/opticalflow_model.lua:171-199): marginalize the window
    distribution over x (sum over maxw -> a maxh-length y-marginal), run the
    thresholded extraction on the marginal, keep pixels with score > 0.
    dist (..., maxh*maxw) -> bool (...)."""
    marg = dist.reshape(dist.shape[:-1] + (maxh, maxw)).sum(axis=-1)
    return confidences_from_marginal(marg, threshold)


def middle_disc_mask(h: int, w: int, radius: float = 25.0,
                     feather: float = 0.0) -> jnp.ndarray:
    """Mask out a disc around the image center (where forward-motion flow
    vanishes and carries no depth signal) with optional linear feathering —
    the maskmiddle of the offline video pipeline
    (/root/reference/test_opticalflow.lua:259-273)."""
    ii = jnp.arange(h, dtype=jnp.float32)[:, None] - h / 2
    jj = jnp.arange(w, dtype=jnp.float32)[None, :] - w / 2
    d = jnp.sqrt(ii * ii + jj * jj)
    if feather > 0:
        return jnp.clip((d - radius) / feather, 0.0, 1.0)
    return (d >= radius).astype(jnp.float32)


def entropy_mask(dist: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """Uncertainty gating: mask out pixels whose window distribution has
    entropy above threshold (the entropy mask of the offline video pipeline,
    /root/reference/test_opticalflow.lua:259-273). dist: (..., D) softmax
    scores. Returns bool (...,)."""
    p = jnp.clip(dist, 1e-12, 1.0)
    h = -jnp.sum(p * jnp.log(p), axis=-1)
    return h <= threshold


def enlarge_mask(mask: jnp.ndarray, kh: int, kw: int) -> jnp.ndarray:
    """Shrink a validity mask by the matcher footprint: a pixel stays valid
    only if the whole (kh, kw) window around it is valid — min-pool, the
    morphological erosion the reference implements in inline C as enlargeMask
    (/root/reference/depth_estimation_api.lua:76-132)."""
    m = mask.astype(jnp.float32)
    # out-of-frame is invalid: zero-pad, then VALID min-pool
    m = jnp.pad(m, ((kh // 2, kh - 1 - kh // 2), (kw // 2, kw - 1 - kw // 2)))
    eroded = jax.lax.reduce_window(
        m, 1.0, jax.lax.min,
        window_dimensions=(kh, kw),
        window_strides=(1, 1),
        padding="VALID",
    )
    return eroded > 0.5


def enlarge_mask_batched(mask: jnp.ndarray, kh: int, kw: int) -> jnp.ndarray:
    """enlarge_mask over a batch: (B, H, W) -> (B, H, W) bool. Batch-LAST
    layout for the windowed reduce (window (kh, kw, 1) on (H, W, B)) — a
    vmapped 2-D reduce_window would lane-pad a trailing singleton 128x
    (see good_features_to_track_batched, geometry3d/egomotion.py)."""
    m = jnp.transpose(mask.astype(jnp.float32), (1, 2, 0))
    m = jnp.pad(m, ((kh // 2, kh - 1 - kh // 2),
                    (kw // 2, kw - 1 - kw // 2), (0, 0)))
    eroded = jax.lax.reduce_window(
        m, 1.0, jax.lax.min,
        window_dimensions=(kh, kw, 1),
        window_strides=(1, 1, 1),
        padding="VALID",
    )
    return jnp.transpose(eroded, (2, 0, 1)) > 0.5
