"""Width-folded (space-to-depth) VALID convolution — a matrix-unit
utilization rewrite of the feature trunk's conv.

Why this exists: every matcher's siamese trunk
(/root/reference/opticalflow_model.lua:45-79) convolves 3 input channels
to ~10 output channels. A conv lowers to a matmul whose N dimension is
cout, and cout=10 underfills a wide matrix unit. The remedy is
space-to-depth: fold spatial phases into channels so the matmul's N
grows phase-fold.

Why WIDTH-ONLY folding: a general s x s fold needs real transposes on
both sides. Folding ONLY the width axis makes both data reshapes
layout-preserving no-ops: x[b,h,s*J+t,c] -> x2[b,h,J,(t,c)] and
y2[b,i,J,(q,o)] -> y[b,i,s*J+q,o] are contiguous reinterpretations of
the same NHWC buffer. The only real work left is the conv itself:

    kernel: (kh, kw2, s*cin, s*cout),  kw2 = (kw + s - 2)//s + 1
    MAC overhead kw2*s/kw, matmul N = s*cout

and a tiny static 0/1 matmul that maps the direct kernel into the
folded one (constant-folded when params are closed over). The fold was
chosen by measurement on the previous accelerator; whether cuDNN wants
it on the GPU is an open A/B (ROADMAP S4, ``DE_TPU_S2D=off``).

The rewrite is exact up to f32 summation order: the same dot products
grouped differently. The kernel map is linear, so gradients flow back
to the direct kernel and training through it is equivalent.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=None)
def _fold_matrix(kw: int, s: int) -> np.ndarray:
    """Static 0/1 matrix S of shape (kw2*s*s, kw) with
    S[(Dj, t, q), dj] = 1 iff dj == s*Dj + t - q — the linear map from
    the direct kernel's width taps to the folded kernel's
    (macro-tap, in-phase, out-phase) triples."""
    kw2 = (kw + s - 2) // s + 1
    S = np.zeros((kw2, s, s, kw), np.float32)
    for Dj in range(kw2):
        for t in range(s):
            for q in range(s):
                dj = s * Dj + t - q
                if 0 <= dj < kw:
                    S[Dj, t, q, dj] = 1.0
    return S.reshape(kw2 * s * s, kw)


def fold_kernel(w: jnp.ndarray, s: int) -> jnp.ndarray:
    """Map a VALID-conv kernel (kh, kw, cin, cout) to its width-folded
    form (kh, kw2, s*cin, s*cout). Linear in w (one tiny static matmul),
    so gradients flow back to the direct kernel."""
    kh, kw, cin, cout = w.shape
    kw2 = (kw + s - 2) // s + 1
    S = jnp.asarray(_fold_matrix(kw, s), w.dtype)
    # R[(Dj,t,q), kh, cin, cout] = sum_dj S[(Dj,t,q), dj] w[kh, dj, c, o]
    R = jnp.tensordot(S, w, axes=[[1], [1]])
    R = R.reshape(kw2, s, s, kh, cin, cout)
    # -> (kh, Dj, t, cin, q, cout): input block (t, c), output block (q, o)
    R = R.transpose(3, 0, 1, 4, 2, 5)
    return R.reshape(kh, kw2, s * cin, s * cout)


def s2d_conv(x: jnp.ndarray, w: jnp.ndarray, s: int) -> jnp.ndarray:
    """VALID conv (NHWC x HWIO -> NHWC) with the width axis folded by
    ``s``. Same values as ``lax.conv_general_dilated(..., 'VALID')`` up
    to f32 summation order. ``s=1`` is the direct conv."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    if s == 1:
        y = jax.lax.conv_general_dilated(
            x, w, window_strides=(1, 1), padding="VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return y[0] if squeeze else y
    B, H, W, C = x.shape
    kh, kw = w.shape[0], w.shape[1]
    cout = w.shape[3]
    n_h, n_w = H - kh + 1, W - kw + 1
    kw2 = (kw + s - 2) // s + 1
    # every output macro-column must exist: Ws = J_max + kw2 with
    # J_max = ceil(n_w/s) - 1 (garbage tail outputs are sliced off)
    ws = ((n_w + s - 1) // s - 1) + kw2
    pad_w = ws * s - W
    if pad_w > 0:
        x = jnp.pad(x, ((0, 0), (0, 0), (0, pad_w), (0, 0)))
    # layout-preserving fold: width phases are memory-adjacent in NHWC
    x2 = x[:, :, :ws * s, :].reshape(B, H, ws, s * C)
    y2 = jax.lax.conv_general_dilated(
        x2, fold_kernel(w, s), window_strides=(1, 1), padding="VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    # layout-preserving unfold + garbage-tail slice
    J = y2.shape[2]
    y = y2.reshape(B, n_h, J * s, cout)[:, :, :n_w, :]
    return y[0] if squeeze else y


# ---------------------------------------------------------------------------
# Trunk integration policy
# ---------------------------------------------------------------------------

def pick_s2d_factor(kh: int, kw: int, cin: int, cout: int) -> int:
    """Static width-fold heuristic for the trunks: fold only
    LARGE-contraction small-cout convs (the 16x16 trunk), never small
    kernels (the 5x5 trunk). Fold factor: smallest power of two with
    s*cout >= 64. The rule was set on the previous accelerator and has not
    been measured on the GPU yet (ROADMAP S4). Disabled by DE_TPU_S2D=off;
    forced by DE_TPU_S2D=<int>."""
    env = os.environ.get("DE_TPU_S2D", "").strip().lower()
    if env == "off":
        return 1
    if env.isdigit():
        return max(1, int(env))
    if cout >= 64:                 # already lane-efficient
        return 1
    if kh * kw * cin < 256:        # small-K convs run faster direct
        return 1
    s = 1
    while s * cout < 64:
        s *= 2
    return s
