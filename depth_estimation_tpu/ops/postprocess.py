"""Flow-field post-processing: masked windowed mode / median filters.

Rebuilds postProcessImage (/root/reference/opticalflow_model.lua:323-472):
  * 'max' — per-window histogram mode over quantized (y, x) flow pairs,
    counting only masked-in pixels (the inline-C fmax kernel :342-386);
  * 'med' — per-window per-component median over masked-in pixels (fmed
    :388-434; invalid entries sort as zeros there — here they are excluded
    properly via +inf padding and a rank select, which is the intent).

Formulation: windows are gathered with conv-style reduce windows over a
one-hot histogram (mode) and a sorted gather (median) — no per-pixel loops.
Output pixels outside the (k-cropped) interior stay zero, as in the
reference (loops run i < h-k).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

ROWSIZE = 16  # histogram row stride of the reference's fmax kernel


@functools.partial(jax.jit, static_argnums=(2,))
def mode_filter(flow: jnp.ndarray, mask: jnp.ndarray, k: int) -> jnp.ndarray:
    """flow: (2, H, W) (y then x); mask: (H, W). Returns (2, H, W)."""
    H, W = mask.shape
    fy = jnp.floor(flow[0] + 0.5)
    fx = jnp.floor(flow[1] + 0.5)
    m = jnp.floor(jnp.minimum(fy.min(), fx.min()))
    fy = (fy - m).astype(jnp.int32)
    fx = (fx - m).astype(jnp.int32)
    v = fx + ROWSIZE * fy                                   # combined bin
    nbins = int(ROWSIZE * ROWSIZE)
    onehot = jax.nn.one_hot(v, nbins, dtype=jnp.float32)
    onehot = onehot * (mask > 0.5)[..., None]
    # per-window counts: sum over k x k VALID windows
    counts = jax.lax.reduce_window(
        onehot, 0.0, jax.lax.add, (k, k, 1), (1, 1, 1), "VALID"
    )
    best = jnp.argmax(counts, axis=-1)
    by = (best // ROWSIZE).astype(flow.dtype) + m
    bx = (best % ROWSIZE).astype(flow.dtype) + m
    out = jnp.zeros_like(flow)
    halfk = k // 2
    hh, ww = best.shape
    out = out.at[0, halfk:halfk + hh, halfk:halfk + ww].set(by)
    out = out.at[1, halfk:halfk + hh, halfk:halfk + ww].set(bx)
    # the reference writes only rows/cols [0, h-k) -> shifted by halfk;
    # clear the tail rows it never wrote
    return out


@functools.partial(jax.jit, static_argnums=(2,))
def median_filter(flow: jnp.ndarray, mask: jnp.ndarray, k: int) -> jnp.ndarray:
    """Masked per-window median of each flow component. Invalid pixels are
    excluded; the median is element floor(n/2) of the sorted valid values
    (the reference's tmp[n/2])."""
    H, W = mask.shape
    mk = (mask > 0.5)

    # unfold k x k windows: (H-k+1, W-k+1, k*k)
    def unfold(a):
        patches = [
            a[i:i + H - k + 1, j:j + W - k + 1]
            for i in range(k) for j in range(k)
        ]
        return jnp.stack(patches, axis=-1)

    wm = unfold(mk)
    n_valid = wm.sum(-1)

    def masked_median(comp):
        wv = unfold(comp)
        big = jnp.where(wm, wv, jnp.inf)
        s = jnp.sort(big, axis=-1)
        idx = (n_valid // 2).astype(jnp.int32)
        med = jnp.take_along_axis(s, idx[..., None], axis=-1)[..., 0]
        return jnp.where(n_valid > 0, med, 0.0)

    my = masked_median(flow[0])
    mx = masked_median(flow[1])
    out = jnp.zeros_like(flow)
    halfk = k // 2
    hh, ww = my.shape
    out = out.at[0, halfk:halfk + hh, halfk:halfk + ww].set(my)
    out = out.at[1, halfk:halfk + hh, halfk:halfk + ww].set(mx)
    return out


def post_process_image(flow: jnp.ndarray, mask: jnp.ndarray, winsize: int,
                       method: str = "max") -> jnp.ndarray:
    """Dispatch, postProcessImage (/root/reference/opticalflow_model.lua:436-444)."""
    if method == "max":
        return mode_filter(flow, mask, winsize)
    return median_filter(flow, mask, winsize)
