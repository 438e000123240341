"""Patch-correlation matching: the framework's north-star hot op.

Re-implements the semantics of nnx ``SpatialMatching(maxh, maxw, false)`` used
throughout the reference (/root/reference/opticalflow_model.lua:93,
groundtruth_opticalflow.lua:73-74, version2/network.lua) and its 1-D radial
variant ``SpatialRadialMatching`` (/root/reference/radial/radial_opticalflow_network.lua:32-34):

    cost[y, x, dy*maxw + dx] = sum_k (f1[y, x, k] - f2[y+dy, x+dx, k])^2

where ``f1`` is the feature map of the reference frame *pre-cropped* by the
half-window (see ``prepareInput``, /root/reference/opticalflow_model.lua:131-151)
so that flat window index ``d`` means centered displacement
``(dy - halfh1, dx - halfw1)`` — exactly the codec in ``codecs.py``.

Implementations:

  * ``match_ssd`` — pure JAX, returns the full cost volume. Differentiable,
    bit-exact parity path; used for training and for groundtruth generation.

  * ``match_flow_reference`` — the plain form of the fused contract
    ``(f1, f2) -> (idx, ey, ex, pmax[, conf])``: ``match_ssd`` followed by
    WTA, softmax, soft-argmax and the 'mean'-head confidence gate. It is
    the test oracle and what XLA makes of the matcher without a kernel.

  * ``match_flow_fused`` — a Pallas kernel on the Triton route that fuses
    matching, softmax, WTA with the reference's tie-break, soft-argmax and
    the confidence gate into one pass, so the (H*W*maxh*maxw) cost volume
    (~59 MB/frame in f32 at 320x180 with a 16x16 window) never reaches
    device memory.

Where the kernel runs is decided in one place, by the platform the program
is lowered for (``match_flow_fused``): compiled through Triton on CUDA, the
Pallas interpreter on the CPU (which is only how the tests run), and an
error on any other platform.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton


# ---------------------------------------------------------------------------
# Pure-JAX reference path (differentiable, parity-exact)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def match_ssd(f1: jnp.ndarray, f2: jnp.ndarray, maxh: int, maxw: int,
              dtype=None) -> jnp.ndarray:
    """SSD cost volume.

    Args:
      f1: (H, W, K) reference features (already half-window cropped).
      f2: (H + maxh - 1, W + maxw - 1, K) search features.
      dtype: optional feature STORAGE type (e.g. jnp.bfloat16 halves the
        per-displacement load traffic). Features are quantized ONCE to the
        storage type and the subtraction runs in f32 on the quantized
        values, so the only reduced-precision effect is the storage
        rounding itself — the same storage-only discipline as
        match_flow_fused's bf16 option. None keeps the input precision
        (the default for training and bit-parity paths).
    Returns:
      (H, W, maxh * maxw) f32 cost volume, d = dy * maxw + dx.
    """
    H = f2.shape[0] - maxh + 1
    W = f2.shape[1] - maxw + 1
    K = f2.shape[2]
    assert f1.shape[0] == H and f1.shape[1] == W, (f1.shape, f2.shape, maxh, maxw)
    # channels-first internally, so each displacement's slice is a
    # contiguous (H, W) plane per channel
    f1t = jnp.transpose(f1, (2, 0, 1))
    f2t = jnp.transpose(f2, (2, 0, 1))
    if dtype is not None:
        # quantize ONCE to the storage type (this is what the loads read);
        # each use upcasts to f32 as part of the subtract's fused producer,
        # so traffic stays at the storage width while the arithmetic is f32
        f1t = f1t.astype(dtype)
        f2t = f2t.astype(dtype)
    costs = []
    for dy in range(maxh):
        for dx in range(maxw):
            win = jax.lax.slice(f2t, (0, dy, dx), (K, dy + H, dx + W))
            diff = f1t.astype(jnp.float32) - win.astype(jnp.float32)
            costs.append(jnp.sum(diff * diff, axis=0))
    return jnp.stack(costs, axis=-1)


def match_ssd_radial(f1: jnp.ndarray, f2: jnp.ndarray, hwin: int) -> jnp.ndarray:
    """1-D radial matching (polar space, search along rows only).

    Equivalent of nnx SpatialRadialMatching(hWin): f2 taller than f1 by
    hwin - 1 (the trainer pads the bottom by hWin-1,
    /root/reference/radial/radial_opticalflow_network.lua:39).
    Returns (H, W, hwin).
    """
    return match_ssd(f1, f2, hwin, 1)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6))
def match_flow_reference(
    f1: jnp.ndarray, f2: jnp.ndarray, maxh: int, maxw: int,
    dtype=jnp.float32, want_conf: bool = False, conf_threshold: float = 0.11,
) -> Tuple[jnp.ndarray, ...]:
    """Plain-JAX form of ``match_flow_fused``'s contract, built from the
    cost volume: same inputs, same outputs, same ``dtype`` storage rule.
    Accepts (H, W, K) or (B, H, W, K). Every reduction is an explicit sum
    (no dot), so no float32 product runs at reduced matmul precision."""
    from . import extract
    ssd = functools.partial(match_ssd, maxh=maxh, maxw=maxw, dtype=dtype)
    costs = ssd(f1, f2) if f1.ndim == 3 else jax.vmap(ssd)(f1, f2)
    halfh1, halfw1 = math.ceil(maxh / 2) - 1, math.ceil(maxw / 2) - 1
    idx = wta_from_costs(costs, halfh1 * maxw + halfw1)
    p = softmax_scores(costs)
    d = jnp.arange(maxh * maxw)
    off_y = (d // maxw - halfh1).astype(jnp.float32)
    off_x = (d % maxw - halfw1).astype(jnp.float32)
    outs = (idx, jnp.sum(p * off_y, axis=-1), jnp.sum(p * off_x, axis=-1),
            jnp.max(p, axis=-1))
    if want_conf:
        marg = p.reshape(p.shape[:-1] + (maxh, maxw)).sum(axis=-1)
        conf = extract.confidences_from_marginal(marg, conf_threshold)
        outs += (conf.astype(jnp.float32),)
    return outs


# ---------------------------------------------------------------------------
# Fused kernel (Pallas, Triton route): match + softmax + WTA + soft-argmax
# ---------------------------------------------------------------------------

# Tile width in pixels: 32 f32 (one 128-byte line) of contiguous W per row,
# so every load of a displaced f2 window coalesces. With the default
# 4-row tile and 4 warps each thread decodes one pixel.
BLOCK_COLS = 32
NUM_WARPS = 4


def _fused_kernel(f1_ref, f2_ref, idx_ref, ey_ref, ex_ref, pmax_ref,
                  *conf_ref, maxh: int, maxw: int, th: int, tw: int,
                  conf_threshold: float):
    """One program decodes a (th, tw) tile of output pixels.

    f1_ref: (1, K, th, tw) reference features of the tile.
    f2_ref: (1, K, Hp + maxh - 1, Wp + maxw - 1) the whole search map of
            this batch item; the tile reads its displaced windows at
            dynamic offsets (L1/L2 serve the overlap between neighbours).

    Per dy row the maxw logits stay in registers: one row maximum, then ONE
    exp per displacement. Each row folds into a single running max / sum /
    expectation (flash-style rescaling), and a running maximum of the
    rescaled row sums gives the 'mean'-head gate: extract_output's
    rank-weighted score on the y-marginal is > 0 iff any marginal entry
    clears the threshold (all rank weights are positive), i.e.
    max_dy(row mass) > threshold * total mass. Nothing of size maxh is held
    per pixel.
    """
    K = f1_ref.shape[1]
    y0 = pl.program_id(1) * th
    x0 = pl.program_id(2) * tw
    f1 = [f1_ref[0, k].astype(jnp.float32) for k in range(K)]
    halfh1 = math.ceil(maxh / 2) - 1
    halfw1 = math.ceil(maxw / 2) - 1
    mid = halfh1 * maxw + halfw1

    def logit(dy, dx):
        acc = jnp.zeros((th, tw), jnp.float32)
        for k in range(K):
            win = f2_ref[0, k, pl.ds(y0 + dy, th), pl.ds(x0 + dx, tw)]
            diff = f1[k] - win.astype(jnp.float32)
            acc = acc + diff * diff
        return -acc

    def row(dy, carry):
        m_all, s_all, sy_all, sx_all, r_max, bm, bi = carry
        ls = [logit(dy, dx) for dx in range(maxw)]
        m = ls[0]
        for l in ls[1:]:
            m = jnp.maximum(m, l)
        s = jnp.zeros((th, tw), jnp.float32)
        sx = jnp.zeros((th, tw), jnp.float32)
        for dx, l in enumerate(ls):
            p = jnp.exp(l - m)
            s = s + p
            sx = sx + p * float(dx - halfw1)
            # WTA with first-occurrence semantics in flat (dy, dx) order
            better = l > bm
            bi = jnp.where(better, dy * maxw + dx, bi)
            bm = jnp.where(better, l, bm)
        m_new = jnp.maximum(m_all, m)
        a = jnp.exp(m_all - m_new)
        w = jnp.exp(m - m_new)
        r = s * w
        s_all = s_all * a + r
        sy_all = sy_all * a + r * (dy - halfh1).astype(jnp.float32)
        sx_all = sx_all * a + sx * w
        r_max = jnp.maximum(r_max * a, r)
        return m_new, s_all, sy_all, sx_all, r_max, bm, bi

    neg = jnp.full((th, tw), -jnp.inf, jnp.float32)
    zero = jnp.zeros((th, tw), jnp.float32)
    m_all, s_all, sy_all, sx_all, r_max, bm, bi = jax.lax.fori_loop(
        0, maxh, row,
        (neg, zero, zero, zero, zero, neg, jnp.zeros((th, tw), jnp.int32)))
    # flat-pixel tie-break: if the middle (zero-flow) cell ties the best,
    # prefer it (/root/reference/opticalflow_model.lua:158-160)
    idx_ref[0] = jnp.where(logit(halfh1, halfw1) >= bm, mid, bi)
    inv = 1.0 / s_all
    pmax_ref[0] = jnp.exp(bm - m_all) * inv
    ey_ref[0] = sy_all * inv
    ex_ref[0] = sx_all * inv
    if conf_ref:
        conf_ref[0][0] = (r_max > jnp.float32(conf_threshold) * s_all
                          ).astype(jnp.float32)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6, 7))
def match_flow_fused(
    f1: jnp.ndarray, f2: jnp.ndarray, maxh: int, maxw: int,
    dtype=jnp.float32, want_conf: bool = False, conf_threshold: float = 0.11,
    block_rows: int = 4,
) -> Tuple[jnp.ndarray, ...]:
    """Fused match + decode. Accepts (H, W, K) or batched (B, H, W, K)
    features (f2 larger by maxh - 1 rows and maxw - 1 columns).

    Returns (idx, ey, ex, pmax), each ([B,] H, W):
      idx  int32 WTA flat window index (middle tie-break),
      ey/ex f32 soft-argmax centered displacement expectations,
      pmax f32 softmax probability of the WTA cell.
    With want_conf=True a fifth output is appended: the 'mean'-head
    confidence GATE ([B,] H, W f32 0/1), equal to
    extract.confidences_from_marginal on the y-marginal.
    ``dtype`` is the feature storage type the kernel loads (bf16 halves the
    load traffic; the arithmetic is f32 either way). ``block_rows`` (a
    power of two) is the tile height; it only tiles the grid.
    """
    squeeze = f1.ndim == 3
    if squeeze:
        f1, f2 = f1[None], f2[None]
    B, H, W, K = f1.shape
    assert f2.shape == (B, H + maxh - 1, W + maxw - 1, K), (f1.shape, f2.shape)
    th, tw = block_rows, BLOCK_COLS
    assert th > 0 and th & (th - 1) == 0, block_rows
    # pad to whole tiles (the padded pixels decode garbage and are cut
    # below); channels-first so every tile load is W-contiguous
    hp, wp = pl.cdiv(H, th) * th, pl.cdiv(W, tw) * tw
    pad = ((0, 0), (0, 0), (0, hp - H), (0, wp - W))
    f1t = jnp.pad(jnp.transpose(f1, (0, 3, 1, 2)).astype(dtype), pad)
    f2t = jnp.pad(jnp.transpose(f2, (0, 3, 1, 2)).astype(dtype), pad)
    n_out = 5 if want_conf else 4
    tile = pl.BlockSpec((1, th, tw), lambda b, i, j: (b, i, j))

    def kernel(interpret):
        return pl.pallas_call(
            functools.partial(_fused_kernel, maxh=maxh, maxw=maxw, th=th,
                              tw=tw, conf_threshold=conf_threshold),
            grid=(B, hp // th, wp // tw),
            in_specs=[
                pl.BlockSpec((1, K, th, tw), lambda b, i, j: (b, 0, i, j)),
                pl.BlockSpec((1,) + f2t.shape[1:],
                             lambda b, i, j: (b, 0, 0, 0)),
            ],
            out_specs=[tile] * n_out,
            out_shape=[jax.ShapeDtypeStruct((B, hp, wp), jnp.int32)]
            + [jax.ShapeDtypeStruct((B, hp, wp), jnp.float32)] * (n_out - 1),
            backend="triton",
            compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                     num_stages=1),
            interpret=interpret,
            name="match_flow_fused",
        )

    # the one place the implementation is chosen: by lowering platform;
    # any platform not listed fails to lower
    outs = jax.lax.platform_dependent(
        f1t, f2t, cuda=kernel(False), cpu=kernel(True))
    outs = tuple(o[:, :H, :W] for o in outs)
    if squeeze:
        outs = tuple(o[0] for o in outs)
    return outs


# ---------------------------------------------------------------------------
# Decode helpers on full cost volumes (parity with getOutputConfidences)
# ---------------------------------------------------------------------------

def wta_from_costs(costs: jnp.ndarray, mid: int) -> jnp.ndarray:
    """Argmin over the window with the reference's middle tie-break:
    if the zero-flow cell attains the min, pick it. costs: (..., D)."""
    best = jnp.argmin(costs, axis=-1).astype(jnp.int32)
    cmin = jnp.min(costs, axis=-1)
    tie = costs[..., mid] <= cmin
    return jnp.where(tie, mid, best)


def softmax_scores(costs: jnp.ndarray) -> jnp.ndarray:
    """softmax(-cost) over the window dim — the model's score distribution
    (reference Minus + SoftMax, /root/reference/opticalflow_model.lua:94-109)."""
    return jax.nn.softmax(-costs, axis=-1)
