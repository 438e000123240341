"""Multiscale (foveated pyramid) flow model — coarse-to-fine matcher.

Rebuilds getModelMultiscale (/root/reference/opticalflow_model_multiscale.lua:175-373)
with its three intricacies, each spec'd by /root/reference/tests/test_multiscale.lua:

  * per-ratio pyramid: average-pool downsample by r, zero-pad by patch-1
    (getMultiscalePrefilter padding, :137-141), shared siamese filter,
    SSD matcher per scale (:219-230);
  * cascading score fusion (nn.CascadingAddTable): each fine-scale window
    distribution receives the central crop of every coarser scale's
    distribution, upsampled onto the fine window via the ceil-centered map
    ``coarse_cell = ceil(centered/r)`` and averaged over contributing scales
    (spec: test_multiscale.lua:169-193; the shipped module sums and has its
    beta-weight normalizers commented out — we implement the mean the test
    asserts, with an optional raw-sum mode);
  * middle-band removal + concatenation (:293-324): at each coarse scale the
    central region already covered by finer scales is dropped and the four
    remaining bands (top, left, right, bottom) are flattened in exactly the
    codec order of yx2xMulti — so ``codecs.decode`` reads the concatenated
    distribution directly.

Design: the cascade is a constant-index gather (no pad/resample modules),
the whole pyramid compiles into one XLA program, and the foveated training
path (``forward_fovea``) uses static-shape dynamic-slice crops.
"""

from __future__ import annotations

import functools
import math
from functools import lru_cache
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import codecs
from ..geometry import Geometry
from ..ops import matching
from .filters import ConvFilter
from .flow import crop_features_center


# ---------------------------------------------------------------------------
# Cascade gather maps
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _cascade_map(maxh: int, maxw: int, r: int) -> np.ndarray:
    """(maxh*maxw,) int32: fine-window flat cell -> coarse-window flat cell of
    a scale coarser by factor r, via the ceil-centered mapping
    (test_multiscale.lua:179-186: filters_out[j][ceil(ii/r)+cy][ceil(jj/r)+cx])."""
    cy, cx = math.ceil(maxh / 2), math.ceil(maxw / 2)
    out = np.empty(maxh * maxw, np.int32)
    for iy in range(maxh):
        for ix in range(maxw):
            ii = iy + 1 - cy           # centered, 1-based arithmetic
            jj = ix + 1 - cx
            ty = math.ceil(ii / r) + cy - 1
            tx = math.ceil(jj / r) + cx - 1
            out[iy * maxw + ix] = ty * maxw + tx
    return out


@lru_cache(maxsize=None)
def _cascade_onehot(maxh: int, maxw: int, r: int) -> np.ndarray:
    """One-hot selection matrix of _cascade_map: out = in @ M — the same
    selection as a minor-dimension gather, run as a matmul."""
    m = _cascade_map(maxh, maxw, r)
    D = maxh * maxw
    M = np.zeros((D, D), np.float32)
    M[m, np.arange(D)] = 1.0
    return M


def cascade(geom: Geometry, dists: List[jnp.ndarray],
            normalize: bool = True) -> List[jnp.ndarray]:
    """Coarse-to-fine fusion. dists[i]: (..., maxh*maxw) distribution at
    scale ratios[i]. Returns same-shaped list: out[i] = mean_{j >= i}
    gather(dists[j]) (sum if normalize=False, matching the shipped
    CascadingAddTable forward which dropped its normalizers)."""
    n = len(geom.ratios)
    out = []
    for i in range(n):
        acc = dists[i]
        for j in range(i + 1, n):
            r = geom.ratios[j] // geom.ratios[i]
            M = jnp.asarray(_cascade_onehot(geom.maxh, geom.maxw, r))
            acc = acc + dists[j] @ M
        if normalize:
            acc = acc / (n - i)
        out.append(acc)
    return out


def cascade_beta(geom: Geometry, dists: List[jnp.ndarray],
                 betas: jnp.ndarray, single_beta: bool = False
                 ) -> List[jnp.ndarray]:
    """Trainable-beta cascade — the reference's Mul2/Power design
    (CascadingAddTable.lua:24-63): out[i] = (w1 * in[i] + w2 *
    gather(out[i+1])) ** pow with pow = -1 / sqrt(w1 * w2) — the
    updateNormalizers rule (:93-98), applied there AFTER each SGD step, so
    pow is a constant w.r.t. the gradient (stop_gradient here). Weights
    initialise to -beta = -1 (:23,27-45); ``single_beta`` shares one weight
    per link (mul2 = mul1:clone, :39-40). NOTE: the reference ships with
    this path commented out of the forward (:29,46,62) — `cascade` above is
    the shipped behavior; this is the intended trainable variant, enabled by
    Geometry.cascad_trainable_weights (trainer -mstw/-mssb)."""
    n = len(geom.ratios)
    assert n >= 2
    out: List = [None] * n
    out[n - 1] = dists[n - 1]
    for i in range(n - 2, -1, -1):
        if single_beta:
            w1 = w2 = betas[i]
        else:
            w1, w2 = betas[i, 0], betas[i, 1]
        r = geom.ratios[i + 1] // geom.ratios[i]
        M = jnp.asarray(_cascade_onehot(geom.maxh, geom.maxw, r))
        s = w1 * dists[i] + w2 * (out[i + 1] @ M)
        prod = jax.lax.stop_gradient(w1 * w2)
        # sqrt of a negative product is NaN in the reference too; the tiny
        # floor only guards the exactly-zero case
        pw = -1.0 / jnp.sqrt(jnp.maximum(prod, 1e-12))
        out[i] = jnp.power(s, pw)
    return out


def init_cascade_betas(geom: Geometry) -> jnp.ndarray:
    """Initial Mul2 weights: -beta with beta=1 (CascadingAddTable.lua:23,38,44).
    Shape (n_links,) when single_beta else (n_links, 2) [mul1, mul2]."""
    n_links = len(geom.ratios) - 1
    shape = (n_links,) if geom.single_beta else (n_links, 2)
    return jnp.full(shape, -1.0, jnp.float32)


def apply_cascade(geom: Geometry, params, dists: List[jnp.ndarray]
                  ) -> List[jnp.ndarray]:
    """Dispatch between the shipped (mean) cascade and the trainable-beta
    variant, depending on Geometry flags and the params payload."""
    if geom.cascad_trainable_weights:
        return cascade_beta(geom, dists, params["cascade"]["betas"],
                            geom.single_beta)
    return cascade(geom, dists)


# ---------------------------------------------------------------------------
# Middle removal + band concatenation (the multiscale index layout)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _band_indices(geom: Geometry) -> np.ndarray:
    """Concatenated gather indices selecting, per scale, the cells kept by
    the middle-removers in codec order. Shape (n_indices,); entry k is
    scale_offset*maxh*maxw + flat cell, where scale = k's scale."""
    maxh, maxw = geom.maxh, geom.maxw
    idx = []
    # scale 0: everything
    idx.extend(range(maxh * maxw))
    for i in range(1, len(geom.ratios)):
        d = codecs._border(geom, i)
        base = i * maxh * maxw
        # top band
        for iy in range(d):
            for ix in range(maxw):
                idx.append(base + iy * maxw + ix)
        # left band
        for iy in range(d, maxh - d):
            for ix in range(d):
                idx.append(base + iy * maxw + ix)
        # right band
        for iy in range(d, maxh - d):
            for ix in range(maxw - d, maxw):
                idx.append(base + iy * maxw + ix)
        # bottom band
        for iy in range(maxh - d, maxh):
            for ix in range(maxw):
                idx.append(base + iy * maxw + ix)
    out = np.asarray(idx, np.int32)
    assert out.shape[0] == codecs.n_indices(geom), (out.shape, codecs.n_indices(geom))
    return out


@lru_cache(maxsize=None)
def _band_onehot(geom: Geometry) -> np.ndarray:
    """One-hot selection matrix of _band_indices (the selection as a
    matmul instead of a minor-dim gather)."""
    idx = _band_indices(geom)
    n_in = len(geom.ratios) * geom.maxh * geom.maxw
    M = np.zeros((n_in, idx.shape[0]), np.float32)
    M[idx, np.arange(idx.shape[0])] = 1.0
    return M


def middle_removal_concat(geom: Geometry, dists: List[jnp.ndarray]) -> jnp.ndarray:
    """Stack per-scale (..., maxh*maxw) distributions and select the
    band-ordered cells -> (..., n_indices) in yx2xMulti layout."""
    stacked = jnp.concatenate(dists, axis=-1)
    return stacked @ jnp.asarray(_band_onehot(geom))


def log_eps(x: jnp.ndarray, eps: float = 1e-10) -> jnp.ndarray:
    """nn.Log2: log with input clamped below eps (NaN guard before NLL,
    /root/reference/Log.lua:13-22)."""
    return jnp.log(jnp.maximum(x, eps))


# ---------------------------------------------------------------------------
# Pyramid helpers
# ---------------------------------------------------------------------------

def avg_downsample(img: jnp.ndarray, r: int) -> jnp.ndarray:
    """nnx SpatialDownSampling(r, r): average over non-overlapping r x r
    blocks. img: (..., H, W, C)."""
    if r == 1:
        return img
    *lead, H, W, C = img.shape
    img = img[..., : (H // r) * r, : (W // r) * r, :]
    img = img.reshape(*lead, H // r, r, W // r, r, C)
    return img.mean(axis=(-4, -2))


def pad_patch_border(geom: Geometry, img: jnp.ndarray) -> jnp.ndarray:
    """Zero-pad by (hPatch2-1, wPatch2-1) split floor/ceil
    (getMultiscalePrefilter, /root/reference/opticalflow_model_multiscale.lua:137-147)."""
    hP, wP = geom.hPatch2 - 1, geom.wPatch2 - 1
    pads = [(0, 0)] * (img.ndim - 3) + [
        (hP // 2, hP - hP // 2), (wP // 2, wP - wP // 2), (0, 0)
    ]
    return jnp.pad(img, pads)


class MultiscaleFlowModel:
    """Functional multiscale matcher (shared filters across scales when
    geometry.share_filters — the reference default)."""

    def __init__(self, geometry: Geometry, decode_dtype=None):
        geometry.validate()
        assert geometry.multiscale
        assert geometry.output_extraction_method == "max", \
            "multiscale supports the 'max' head only (reference assert, " \
            "opticalflow_model_multiscale.lua:176)"
        self.geometry = geometry
        self.filter = ConvFilter(geometry)
        # inference-only matcher precision for the fast decode (bf16 halves
        # the SSD load traffic; training/forward_full stay full precision)
        self.decode_dtype = decode_dtype

    def init(self, rng) -> dict:
        g = self.geometry
        dummy = jnp.zeros((g.hPatch2, g.wPatch2, g.in_channels), jnp.float32)
        if g.share_filters:
            params = self.filter.init(rng, dummy)
        else:
            # share_filters=false branch: an independent filter per pyramid
            # scale (the reference clones the trunk per scale instead of
            # weight-sharing it, opticalflow_model_multiscale.lua:219-225)
            params = {"scales": {
                f"scale{s}": self.filter.init(jax.random.fold_in(rng, s),
                                              dummy)
                for s in range(len(g.ratios))}}
        if g.cascad_trainable_weights:
            params = dict(params, cascade={"betas": init_cascade_betas(g)})
        return params

    def _scale_params(self, params, s: int):
        """Filter variables for pyramid scale s (scale-indexed when the
        geometry trains per-scale filters, the shared trunk otherwise)."""
        return params["scales"][f"scale{s}"] if "scales" in params else params

    # -- per-scale matcher on an already-downsampled (padded) image pair ----

    def _scale_costs(self, params, d1: jnp.ndarray, d2: jnp.ndarray,
                     s: int = 0) -> jnp.ndarray:
        g = self.geometry
        p = self._scale_params(params, s)
        f1 = crop_features_center(g, self.filter.apply(p, d1))
        f2 = self.filter.apply(p, d2)
        return matching.match_ssd(f1, f2, g.maxh, g.maxw)

    # -- full-image inference ----------------------------------------------

    def forward_full(self, params, img1: jnp.ndarray, img2: jnp.ndarray,
                     log: bool = False) -> jnp.ndarray:
        """img1, img2: (hImg, wImg, C). Returns (hImg, wImg, n_indices)
        multiscale distribution (log of it if ``log``)."""
        g = self.geometry
        dists = []
        for s, r in enumerate(g.ratios):
            d1 = pad_patch_border(g, avg_downsample(img1, r))
            d2 = pad_patch_border(g, avg_downsample(img2, r))
            costs = self._scale_costs(params, d1, d2, s)
            dist = jax.nn.softmax(-costs, axis=-1)
            if r > 1:
                # spatial upsample back to full res by replication
                # (0-based Y reads coarse row Y // r — the ceil-centered
                # 1-based convention)
                dist = jnp.repeat(jnp.repeat(dist, r, axis=0), r, axis=1)
                dist = dist[: g.hImg, : g.wImg]
            dists.append(dist.reshape(g.hImg, g.wImg, -1))
        fused = apply_cascade(g, params, dists)
        out = middle_removal_concat(g, fused)
        return log_eps(out) if log else out

    # -- fast full-image inference decode ------------------------------------

    def features_pyramid(self, params, img1: jnp.ndarray, img2: jnp.ndarray):
        """Per-scale cropped/full feature pairs [(f1, f2), ...] — stage 1 of
        the fast decode, kept as its own dispatch (the conv trunk and the
        displacement loop compile as separate programs)."""
        g = self.geometry
        outs = []
        for s, r in enumerate(g.ratios):
            d1 = pad_patch_border(g, avg_downsample(img1, r))
            d2 = pad_patch_border(g, avg_downsample(img2, r))
            p = self._scale_params(params, s)
            outs.append((crop_features_center(g, self.filter.apply(p, d1)),
                         self.filter.apply(p, d2)))
        return outs

    def decode_from_features(self, feats) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Stage 2 of the fast decode: per-scale match + softmax + cascade +
        middle-band WTA, all at each scale's own resolution (see decode_full)."""
        g = self.geometry
        assert not g.cascad_trainable_weights, \
            "staged decode implements the shipped linear cascade only"
        n = len(g.ratios)
        D = g.maxh * g.maxw
        mid_concat = codecs.middle_index(g)
        dists = [jax.nn.softmax(
            -matching.match_ssd(f1, f2, g.maxh, g.maxw,
                                dtype=self.decode_dtype), axis=-1)
            for f1, f2 in feats]

        # static per-scale band metadata from the concat codec layout
        band = _band_indices(g)
        scale_of = band // D
        cell_of = band % D
        concat_of = [np.full(D, -1, np.int64) for _ in range(n)]
        keep = []
        for s in range(n):
            sel = np.nonzero(scale_of == s)[0]
            concat_of[s][cell_of[sel]] = sel
            keep.append(concat_of[s] >= 0)

        def up_to_full(x, r):
            if r > 1:
                x = jnp.repeat(jnp.repeat(x, r, axis=0), r, axis=1)
            return x[: g.hImg, : g.wImg]

        vals, idxs, sums, mid_p = [], [], [], None
        for s in range(n):
            # cascade at scale-s resolution: gather coarser dists via the
            # one-hot matmul, spatially replicated down to scale s
            acc = dists[s]
            Hs, Ws = acc.shape[0], acc.shape[1]
            for j in range(s + 1, n):
                r = g.ratios[j] // g.ratios[s]
                M = jnp.asarray(_cascade_onehot(g.maxh, g.maxw, r))
                gj = dists[j] @ M
                gj = jnp.repeat(jnp.repeat(gj, r, axis=0), r, axis=1)
                acc = acc + gj[:Hs, :Ws]
            fused = acc / (n - s)
            if s == 0:
                mid_p = fused[..., mid_concat]   # zero-flow cell (scale 0)
            # middle-band removal = static mask; max/argmax/sum per pixel
            keep_s = jnp.asarray(keep[s])
            masked = jnp.where(keep_s, fused, -1.0)
            v = jnp.max(masked, axis=-1)
            am = jnp.argmax(masked, axis=-1).astype(jnp.int32)
            # cell -> concatenated index ARITHMETICALLY (band layout is
            # piecewise affine in (iy, ix): vector math, no per-pixel LUT
            # gather)
            if s == 0:
                k = am                       # scale 0 keeps every cell
            else:
                d = codecs._border(g, s)
                base = int(np.nonzero(scale_of == s)[0][0])
                iy = am // g.maxw
                ix = am % g.maxw
                rows_mid = g.maxh - 2 * d
                pos_top = am
                pos_left = d * g.maxw + (iy - d) * d + ix
                pos_right = (d * g.maxw + rows_mid * d
                             + (iy - d) * d + ix - (g.maxw - d))
                pos_bot = (d * g.maxw + 2 * rows_mid * d
                           + (iy - (g.maxh - d)) * g.maxw + ix)
                k = jnp.where(iy < d, pos_top,
                              jnp.where(iy >= g.maxh - d, pos_bot,
                                        jnp.where(ix < d, pos_left,
                                                  pos_right)))
                k = base + k
            ssum = jnp.sum(jnp.where(keep_s, fused, 0.0), axis=-1)
            r = g.ratios[s]
            vals.append(up_to_full(v, r))
            idxs.append(up_to_full(k, r))
            sums.append(up_to_full(ssum, r))

        total = sums[0]
        bm = vals[0]
        bi = idxs[0]
        for s in range(1, n):                    # first occurrence = lowest
            total = total + sums[s]              # scale = concat order
            better = vals[s] > bm
            bi = jnp.where(better, idxs[s], bi)
            bm = jnp.maximum(bm, vals[s])
        # flat-pixel middle tie-break (getOutputConfidences semantics)
        tie = mid_p >= bm
        idx = jnp.where(tie, mid_concat, bi)
        pmax = jnp.where(tie, mid_p, bm) / total
        return idx, pmax

    def decode_full(self, params, img1: jnp.ndarray, img2: jnp.ndarray
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """WTA decode of the multiscale distribution WITHOUT materializing
        it at full resolution. Returns (idx, pmax): per-pixel concatenated-
        codec index (int32, middle tie-break) and its probability mass —
        exactly argmax/max of ``forward_full`` (equality-tested in
        tests/test_multiscale.py).

        The key identity: the cascaded distribution at scale s is CONSTANT
        over scale-s pixel blocks (a full-res pixel p reads coarser scales
        at p // r_j, and r_j | r_s block-constancy chains), so cascade,
        middle-band selection, per-scale max and per-scale sum all run at
        each scale's own resolution; only a 2-channel (value, index) map is
        replicated to full res. This removes the (hImg, wImg, n_indices)
        device-memory traffic that dominates forward_full — the multiscale
        equivalent of the fused single-scale kernel.

        For peak throughput dispatch the two stages separately
        (``decode_full_staged``) — see features_pyramid for why.
        """
        if self.geometry.cascad_trainable_weights:
            # beta cascade is non-linear; materialize the distribution
            g = self.geometry
            out = self.forward_full(params, img1, img2, log=False)
            mid = codecs.middle_index(g)
            val = jnp.max(out, axis=-1)
            am = jnp.argmax(out, axis=-1).astype(jnp.int32)
            tie = out[..., mid] >= val
            idx = jnp.where(tie, mid, am)
            pmax = jnp.where(tie, out[..., mid], val) / jnp.sum(out, axis=-1)
            return idx, pmax
        return self.decode_from_features(
            self.features_pyramid(params, img1, img2))

    def decode_full_staged(self, params, imgs1: jnp.ndarray,
                           imgs2: jnp.ndarray):
        """Throughput path: batched (B, H, W, C) image pairs, two device
        dispatches (conv pyramid | match+decode). ~3.5x faster than the
        single-program composition (XLA scheduling pathology, see
        features_pyramid)."""
        if not hasattr(self, "_staged_jits"):
            vf = jax.vmap(self.features_pyramid, in_axes=(None, 0, 0))
            vd = jax.vmap(self.decode_from_features)
            self._staged_jits = (jax.jit(vf), jax.jit(vd))
        jf, jd = self._staged_jits
        return jd(jf(params, imgs1, imgs2))

    # -- foveated training path --------------------------------------------

    def forward_fovea(self, params, img1: jnp.ndarray, img2: jnp.ndarray,
                      y, x, log: bool = True) -> jnp.ndarray:
        """Single fovea at 0-based center (y, x): per scale r, crop the
        full-res (r*hPatch2, r*wPatch2) region whose *center pixel*
        (ceil convention) is (y, x) — the invariant test_multiscale.lua
        asserts at :111-120 — downsample, match, fuse. Returns
        (n_indices,) distribution (log by default, the training head)."""
        g = self.geometry
        dists = []
        for s, r in enumerate(g.ratios):
            Hc, Wc = r * g.hPatch2, r * g.wPatch2
            y0 = y - (math.ceil(Hc / 2) - 1)
            x0 = x - (math.ceil(Wc / 2) - 1)
            c1 = jax.lax.dynamic_slice(
                img1, (y0, x0, 0), (Hc, Wc, img1.shape[2]))
            c2 = jax.lax.dynamic_slice(
                img2, (y0, x0, 0), (Hc, Wc, img2.shape[2]))
            costs = self._scale_costs(
                params, avg_downsample(c1, r), avg_downsample(c2, r), s)
            dists.append(jax.nn.softmax(-costs, axis=-1).reshape(-1))
        fused = apply_cascade(g, params, dists)
        out = middle_removal_concat(g, fused)
        return log_eps(out) if log else out

    def forward_fovea_batch(self, params, crops1: jnp.ndarray,
                            crops2: jnp.ndarray, log: bool = True
                            ) -> jnp.ndarray:
        """Batched fovea forward over PRE-CROPPED coarsest-scale footprints:
        crops1/crops2 (B, rmax*hPatch2, rmax*wPatch2, C), each the region
        whose center pixel (ceil convention) is the fovea — exactly the
        pixels ``forward_fovea`` reads, materialized at sampler time
        (training.sample_foveas). Every per-scale crop is then a STATIC
        centered slice, so the whole batch compiles to dense conv/matmul
        work instead of a per-sample dynamic_slice (vmap of
        ``forward_fovea`` over full frames). Returns (B, n_indices)."""
        g = self.geometry
        Hm, Wm = g.rmax * g.hPatch2, g.rmax * g.wPatch2
        assert crops1.shape[1:3] == (Hm, Wm), (crops1.shape, Hm, Wm)

        def one(c1, c2):
            dists = []
            for s, r in enumerate(g.ratios):
                Hc, Wc = r * g.hPatch2, r * g.wPatch2
                oy = (math.ceil(Hm / 2) - 1) - (math.ceil(Hc / 2) - 1)
                ox = (math.ceil(Wm / 2) - 1) - (math.ceil(Wc / 2) - 1)
                d1 = avg_downsample(c1[oy:oy + Hc, ox:ox + Wc], r)
                d2 = avg_downsample(c2[oy:oy + Hc, ox:ox + Wc], r)
                costs = self._scale_costs(params, d1, d2, s)
                dists.append(jax.nn.softmax(-costs, axis=-1).reshape(-1))
            fused = apply_cascade(g, params, dists)
            out = middle_removal_concat(g, fused)
            return log_eps(out) if log else out

        return jax.vmap(one, in_axes=(0, 0))(crops1, crops2)
