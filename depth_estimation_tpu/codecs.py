"""Index codecs: centered displacement (dy, dx) <-> flat window index.

These encode the reference's exact conventions — the half-window asymmetries,
1-based centering, rounding and tie-break rules that every score depends on:

  * single scale ``yx2x``/``x2yx``       /root/reference/opticalflow_model.lua:12-34
  * multiscale band codec ``yx2xMulti``  /root/reference/opticalflow_model_multiscale.lua:10-52
    and its inverse ``x2yxMultiNumber``  /root/reference/opticalflow_model_multiscale.lua:83-132

Design: instead of running the band arithmetic per element (the reference
JIT-compiles a C loop, x2yxMulti2.c), we precompute small constant lookup
tables once in Python/numpy and make encode/decode a single gather — the
idiomatic XLA formulation (fully vectorized, static shapes; the LUT is at
most a few thousand int32s).

All flat indices here are 0-based. Displacements are *centered*: for a window
of size n, dy in [-(ceil(n/2)-1), floor(n/2)].
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from .geometry import Geometry


def _round_half_up(v: float) -> int:
    """Lua's round(): floor(v + 0.5). (Python's round() is banker's — wrong.)"""
    return int(math.floor(v + 0.5))


# ---------------------------------------------------------------------------
# Single-scale codec
# ---------------------------------------------------------------------------

def yx2x(geom: Geometry, dy, dx):
    """Centered displacement -> flat window index (0-based).

    Mirrors prepareTarget's encoding (/root/reference/opticalflow_model.lua:294-296):
    row = dy + ceil(maxh/2) - 1, col = dx + ceil(maxw/2) - 1, flat = row*maxw + col.
    Works on Python ints, numpy, or jnp arrays.
    """
    return (dy + geom.halfh1) * geom.maxw + (dx + geom.halfw1)


def x2yx(geom: Geometry, flat):
    """Flat window index (0-based) -> centered displacement (dy, dx)."""
    ty = flat // geom.maxw
    tx = flat - ty * geom.maxw
    return ty - geom.halfh1, tx - geom.halfw1


def middle_index(geom: Geometry) -> int:
    """Flat index of the zero-displacement cell ("flat pixel" / no motion).
    Reference getMiddleIndex (/root/reference/opticalflow_model.lua:36-43)."""
    if geom.multiscale:
        return yx2x_multi_scalar(geom, 0, 0)
    return int(yx2x(geom, 0, 0))


@lru_cache(maxsize=None)
def _window_offsets_np(maxh: int, maxw: int) -> np.ndarray:
    """(maxh*maxw, 2) int32: centered (dy, dx) for each flat index."""
    h1 = math.ceil(maxh / 2) - 1
    w1 = math.ceil(maxw / 2) - 1
    dy = np.arange(maxh) - h1
    dx = np.arange(maxw) - w1
    yy, xx = np.meshgrid(dy, dx, indexing="ij")
    return np.stack([yy.ravel(), xx.ravel()], axis=-1).astype(np.int32)


def window_offsets(geom: Geometry) -> jnp.ndarray:
    """Per-flat-index centered (dy, dx) table for the model's search window
    (multiscale-aware). Shape (n_indices, 2), int32."""
    if geom.multiscale:
        return jnp.asarray(decode_lut(geom))
    return jnp.asarray(_window_offsets_np(geom.maxh, geom.maxw))


# ---------------------------------------------------------------------------
# Multiscale band codec (scalar reference implementations)
# ---------------------------------------------------------------------------

def _border(geom: Geometry, i: int) -> int:
    """Width d of the ring band kept at scale i (i >= 1, 0-based scale index).
    The middle (maxh-2d)x(maxw-2d) is covered by finer scales and removed."""
    return _round_half_up(
        geom.maxw * (geom.ratios[i] - geom.ratios[i - 1]) / (2 * geom.ratios[i])
    )


def _band_len(geom: Geometry, i: int) -> int:
    d = _border(geom, i)
    return 2 * d * geom.maxw + 2 * (geom.maxh - 2 * d) * d


def n_indices(geom: Geometry) -> int:
    """Total number of flat indices of the (possibly multiscale) window."""
    if not geom.multiscale:
        return geom.maxh * geom.maxw
    return geom.maxh * geom.maxw + sum(
        _band_len(geom, i) for i in range(1, len(geom.ratios))
    )


def yx2x_multi_scalar(geom: Geometry, dy: float, dx: float) -> int:
    """Centered displacement -> flat multiscale index (0-based).
    Literal port of yx2xMulti (/root/reference/opticalflow_model_multiscale.lua:10-52),
    1-based internally to keep the band arithmetic identical."""
    dy = _round_half_up(dy)
    dx = _round_half_up(dx)

    def is_in(size: int, v: int) -> bool:
        return -math.ceil(size / 2) + 1 <= v <= math.floor(size / 2)

    for i, r in enumerate(geom.ratios):
        if is_in(geom.maxw * r, dx) and is_in(geom.maxh * r, dy):
            tx = math.ceil(dx / r) + math.ceil(geom.maxw / 2)
            ty = math.ceil(dy / r) + math.ceil(geom.maxh / 2)
            break
    else:
        raise ValueError(f"displacement ({dy},{dx}) outside coarsest window")

    maxh, maxw = geom.maxh, geom.maxw
    if i == 0:
        it = (ty - 1) * maxw + tx
    else:
        d = _border(geom, i)
        if ty <= d:                      # top band
            it = (ty - 1) * maxw + tx
        elif ty > maxh - d:              # bottom band
            it = d * maxw + 2 * (maxh - 2 * d) * d + (ty - (maxh - d) - 1) * maxw + tx
        elif tx <= d:                    # left band
            it = d * maxw + (ty - d - 1) * d + tx
        elif tx > maxw - d:              # right band
            it = d * maxw + (maxh - 2 * d) * d + (ty - d - 1) * d + (tx - (maxw - d))
        else:
            raise ValueError(
                f"displacement ({dy},{dx}) maps into the removed middle of scale {i}"
            )
        # NOTE: like the reference, earlier coarse scales' lengths are computed
        # with *this* scale's d — exact only when all borders are equal, which
        # holds for the reference's power-of-two ratio schedule
        # (/root/reference/opticalflow.lua:184).
        it = maxw * maxh + (i - 1) * (2 * d * maxw + 2 * (maxh - 2 * d) * d) + it
    return it - 1


def x2yx_multi_scalar(geom: Geometry, flat: int) -> Tuple[int, int]:
    """Flat multiscale index (0-based) -> centered displacement (dy, dx).
    Literal port of x2yxMultiNumber
    (/root/reference/opticalflow_model_multiscale.lua:83-132)."""
    maxh, maxw = geom.maxh, geom.maxw
    chh, chw = math.ceil(maxh / 2), math.ceil(maxw / 2)
    x = flat + 1
    if x <= maxh * maxw:
        ty = (x - 1) // maxw + 1
        tx = (x - 1) % maxw + 1
        return ty - chh, tx - chw
    x -= maxh * maxw
    for i in range(1, len(geom.ratios)):
        r = geom.ratios[i]
        d = _border(geom, i)
        ln = _band_len(geom, i)
        if x <= ln:
            if x <= d * maxw:                      # top band
                ty = (x - 1) // maxw + 1
                tx = (x - 1) % maxw + 1
            else:
                x -= d * maxw
                m_h = (maxh - 2 * d) * d
                if x <= m_h:                       # left band
                    ty = (x - 1) // d + 1 + d
                    tx = (x - 1) % d + 1
                elif x <= 2 * m_h:                 # right band
                    x -= m_h
                    ty = (x - 1) // d + 1 + d
                    tx = (x - 1) % d + 1 + maxw - d
                else:                              # bottom band
                    x -= 2 * m_h
                    assert x <= d * maxw
                    ty = (x - 1) // maxw + 1 + maxh - d
                    tx = (x - 1) % maxw + 1
            return (ty - chh) * r, (tx - chw) * r
        x -= ln
    raise ValueError(f"flat index {flat} out of range for geometry")


# ---------------------------------------------------------------------------
# Vectorized codecs via constant LUTs (the device path)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def decode_lut(geom: Geometry) -> np.ndarray:
    """(n_indices, 2) int32 table: flat index -> centered (dy, dx)."""
    if geom.multiscale:
        n = n_indices(geom)
        out = np.empty((n, 2), dtype=np.int32)
        for k in range(n):
            out[k] = x2yx_multi_scalar(geom, k)
        return out
    return _window_offsets_np(geom.maxh, geom.maxw)


@lru_cache(maxsize=None)
def encode_lut(geom: Geometry) -> Tuple[np.ndarray, int, int]:
    """Dense table for encode: (table, y_off, x_off) with
    ``flat = table[dy + y_off, dx + x_off]`` over the coarsest window range."""
    if geom.multiscale:
        mh, mw = geom.maxh * geom.rmax, geom.maxw * geom.rmax
    else:
        mh, mw = geom.maxh, geom.maxw
    y_off = math.ceil(mh / 2) - 1
    x_off = math.ceil(mw / 2) - 1
    tab = np.empty((mh, mw), dtype=np.int32)
    for iy in range(mh):
        for ix in range(mw):
            dy, dx = iy - y_off, ix - x_off
            if geom.multiscale:
                tab[iy, ix] = yx2x_multi_scalar(geom, dy, dx)
            else:
                tab[iy, ix] = yx2x(geom, dy, dx)
    return tab, y_off, x_off


def encode(geom: Geometry, dy, dx) -> jnp.ndarray:
    """Vectorized encode: centered (dy, dx) arrays -> flat indices (int32).
    Values are rounded half-up and clamped into the coarsest window."""
    tab, y_off, x_off = encode_lut(geom)
    tabj = jnp.asarray(tab)
    iy = jnp.clip(jnp.floor(jnp.asarray(dy) + 0.5).astype(jnp.int32) + y_off,
                  0, tab.shape[0] - 1)
    ix = jnp.clip(jnp.floor(jnp.asarray(dx) + 0.5).astype(jnp.int32) + x_off,
                  0, tab.shape[1] - 1)
    return tabj[iy, ix]


def encode_np(geom: Geometry, dy, dx) -> np.ndarray:
    """HOST-side ``encode`` (same table, same rounding). The patch samplers
    call encode once per accepted sample inside their rejection loops — the
    jnp form costs a device dispatch + fetch per call."""
    tab, y_off, x_off = encode_lut(geom)
    iy = np.clip(np.floor(np.asarray(dy) + 0.5).astype(np.int32) + y_off,
                 0, tab.shape[0] - 1)
    ix = np.clip(np.floor(np.asarray(dx) + 0.5).astype(np.int32) + x_off,
                 0, tab.shape[1] - 1)
    return tab[iy, ix]


def decode(geom: Geometry, flat) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Vectorized decode: flat indices -> centered (dy, dx) int32 arrays.
    Replaces the reference's inline-C x2yxMulti2 (/root/reference/x2yxMulti2.c)
    with a single constant-table gather."""
    flat = jnp.asarray(flat)
    if not geom.multiscale:
        # single-scale flat index is plain row-major: arithmetic, no LUT
        # gather
        return (flat // geom.maxw - geom.halfh1,
                flat % geom.maxw - geom.halfw1)
    lut = jnp.asarray(decode_lut(geom))
    return lut[flat, 0], lut[flat, 1]
