"""Lens undistortion — sfm2.undistortImage equivalent.

The reference calls the external sfm2 package (OpenCV undistort) at every
pipeline entry (/root/reference/depth_estimation_api.lua:139,
groundtruth_opticalflow.lua:270-281). Standard inverse mapping: for each
undistorted output pixel, apply the Brown 5-coefficient forward distortion
model (k1, k2, p1, p2, k3) to its normalized coordinates, then bilinearly
sample the distorted source image there.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..flow.celiu import bilinear_sample


def distort_points(x: jnp.ndarray, y: jnp.ndarray, dist) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Apply the forward Brown model to normalized coords."""
    k1, k2, p1, p2, k3 = [jnp.float32(d) for d in dist]
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return xd, yd


def undistort_image(img: jnp.ndarray, K, dist) -> jnp.ndarray:
    """img: (H, W, C); K: 3x3 intrinsics; dist: 5 coefficients. Out-of-range
    samples are zero (OpenCV undistort default border)."""
    K = jnp.asarray(K)
    H, W = img.shape[0], img.shape[1]
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    j = jnp.arange(W, dtype=jnp.float32)[None, :]
    i = jnp.arange(H, dtype=jnp.float32)[:, None]
    xn = (j - cx) / fx * jnp.ones((H, 1), jnp.float32)
    yn = (i - cy) / fy * jnp.ones((1, W), jnp.float32)
    xd, yd = distort_points(xn, yn, dist)
    xs = xd * fx + cx
    ys = yd * fy + cy
    out = bilinear_sample(img, xs, ys)
    # epsilon absorbs f32 cancellation in the coordinate round trip: border
    # pixels can land ~1e-6 outside [0, n-1] (fusion-order dependent, so
    # eager and jit/vmap paths would otherwise disagree on the border mask)
    eps = 1e-3
    ok = ((xs >= -eps) & (xs <= W - 1 + eps)
          & (ys >= -eps) & (ys <= H - 1 + eps))
    return out * ok[..., None]


def remove_ego_motion(img: jnp.ndarray, K, R) -> jnp.ndarray:
    """Rotation compensation — sfm2.removeEgoMotion equivalent
    (used at /root/reference/depth_estimation_api.lua:147,
    groundtruth_opticalflow.lua:289): warp by the infinite-homography
    H = K R K^-1 so the previous frame aligns with the current camera
    orientation. Sampling: out(p) = img(H^-1... we follow the convention
    out(x) = img(K R K^-1 x), matching a prev->current rotation R."""
    K = jnp.asarray(K, jnp.float32)
    R = jnp.asarray(R, jnp.float32)
    Hm = K @ R @ jnp.linalg.inv(K)
    H, W = img.shape[0], img.shape[1]
    j = jnp.arange(W, dtype=jnp.float32)
    i = jnp.arange(H, dtype=jnp.float32)
    xx, yy = jnp.meshgrid(j, i)
    ones = jnp.ones_like(xx)
    p = jnp.stack([xx, yy, ones])                       # (3, H, W)
    q = jnp.einsum("ab,bhw->ahw", Hm, p)
    xs = q[0] / q[2]
    ys = q[1] / q[2]
    out = bilinear_sample(img, xs, ys)
    # epsilon absorbs f32 cancellation in the coordinate round trip: border
    # pixels can land ~1e-6 outside [0, n-1] (fusion-order dependent, so
    # eager and jit/vmap paths would otherwise disagree on the border mask)
    eps = 1e-3
    ok = ((xs >= -eps) & (xs <= W - 1 + eps)
          & (ys >= -eps) & (ys <= H - 1 + eps))
    return out * ok[..., None]


def homography_grid(K, R, H: int, W: int):
    """Sample coordinates of the infinite-homography warp out(x) =
    img(K R K^-1 x). K (3,3) shared; R (..., 3, 3) per item. Returns
    (xs, ys) (..., H, W)."""
    K = jnp.asarray(K, jnp.float32)
    R = jnp.asarray(R, jnp.float32)
    Hm = K @ R @ jnp.linalg.inv(K)                      # (..., 3, 3)
    j = jnp.arange(W, dtype=jnp.float32)
    i = jnp.arange(H, dtype=jnp.float32)
    xx, yy = jnp.meshgrid(j, i)
    p = jnp.stack([xx, yy, jnp.ones_like(xx)])          # (3, H, W)
    q = jnp.einsum("...ab,bhw->...ahw", Hm, p)
    return q[..., 0, :, :] / q[..., 2, :, :], q[..., 1, :, :] / q[..., 2, :, :]


def remove_ego_motion_batched(imgs: jnp.ndarray, K, R,
                              dtype=None) -> jnp.ndarray:
    """remove_ego_motion over B items with per-item rotations — imgs
    (B, H, W, C), R (B, 3, 3). The four bilinear corner lookups are single
    batched take_along_axis gathers over the flattened (H*W) axis (the
    celiu _gather_hw formulation) instead of a vmapped 2-D gather.
    ``dtype``: optional storage type
    for the gathered values (bf16 halves the gather traffic; interpolation
    weights stay f32 and the result promotes back to f32 — the same
    inference-only precision option as the matcher's)."""
    from ..flow.celiu import bilinear_sample
    B, H, W = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    if dtype is not None:
        imgs = imgs.astype(dtype)
    xs, ys = homography_grid(K, R, H, W)               # (B, H, W)
    out = bilinear_sample(imgs, xs, ys).astype(jnp.float32)
    eps = 1e-3
    ok = ((xs >= -eps) & (xs <= W - 1 + eps)
          & (ys >= -eps) & (ys <= H - 1 + eps))
    return out * ok[..., None]


def warp_in_band(K, R, H: int, W: int, band: int) -> jnp.ndarray:
    """Scalar bool: does EVERY in-frame sample of the homography warp
    displace by <= ``band`` on both axes? Pure elementwise arithmetic on
    the grid — no warp, no gather. This is the speculation predicate of
    remove_ego_motion_exact: when true, the banded warp equals the
    unconditional 4-tap gather on every pixel the validity mask keeps
    (out-of-frame pixels are masked identically by both)."""
    xs, ys = homography_grid(K, R, H, W)
    jj = jnp.arange(W, dtype=jnp.float32)[None, :]
    ii = jnp.arange(H, dtype=jnp.float32)[:, None]
    eps = 1e-3
    in_frame = ((xs >= -eps) & (xs <= W - 1 + eps)
                & (ys >= -eps) & (ys <= H - 1 + eps))
    banded = (jnp.abs(xs - jj) <= band) & (jnp.abs(ys - ii) <= band)
    return jnp.all(~in_frame | banded)


@functools.partial(jax.jit, static_argnums=(3, 4))
def remove_ego_motion_exact(imgs: jnp.ndarray, K, R,
                            band: int = 8, dtype=None) -> jnp.ndarray:
    """The UNCONDITIONAL 4-tap gather warp (the reference's
    sfm2.removeEgoMotion, /root/reference/depth_estimation_api.lua:147 —
    no band restriction), dispatched by speculation: on every frame the
    online pipeline keeps, the rotation-compensation displacement sits well
    inside the matcher's search margin, so a cheap on-device predicate
    (warp_in_band: pure arithmetic on the homography grid) picks the form:

      * covered (the common case): the gather-free banded shift-sum
        (remove_ego_motion_banded) — the same bilinear tensor product,
        equal to the gather within float rounding wherever the
        displacement is in-band, which the predicate just proved is
        everywhere in-frame;
      * not covered (rare: a rotation the bad-image gate is about to
        reject anyway): the flat-gather form — the same computation as the
        non-speculative path, equal within the ~1-ulp fusion-rounding
        drift of compiling under lax.cond (pinned at 1e-6 by
        tests/test_egomotion.py).

    `lax.cond` on the scalar predicate executes ONE branch per batch (not
    a select), so the fast path never pays the gather. Semantics are
    exact for ANY rotation by construction. ``dtype`` as in
    remove_ego_motion_batched (bf16 storage is inference-only opt-in)."""
    H, W = imgs.shape[1], imgs.shape[2]
    covered = warp_in_band(K, R, H, W, band)

    def banded_path(ims):
        out = remove_ego_motion_banded(ims, K, R, band=band, dtype=dtype)
        # banded zeroes + band-masks out-of-band pixels; covered means
        # there are none in-frame, so re-masking with the unconditional
        # mask changes nothing — both paths return in-frame-masked values
        return out

    def gather_path(ims):
        return remove_ego_motion_batched(ims, K, R, dtype=dtype)

    return jax.lax.cond(covered, banded_path, gather_path, imgs)


@functools.partial(jax.jit, static_argnums=(3, 4))
def remove_ego_motion_banded(imgs: jnp.ndarray, K, R,
                             band: int = 8, dtype=None) -> jnp.ndarray:
    """remove_ego_motion_batched without the gather: the warp displacement
    |K R K^-1 p - p| of frame-to-frame rotation compensation is bounded by
    the matcher's search margin on every frame the pipeline keeps, so the
    4-tap bilinear lookup equals a sum over STATIC shifts of the
    zero-padded image weighted by the bilinear hat,

        out[y, x] = sum_{s,t in [-band, band+1]}
                    hat(sy - y - s) * hat(sx - x - t) * img[y+s, x+t],

    which is pure slice/multiply/add work that XLA fuses into one pass
    (equal to the flat take_along_axis gather up to f32 accumulation
    order).

    Exact-or-masked for ANY rotation: pixels whose displacement exceeds
    ``band`` are zeroed and excluded from the validity mask (use
    ego_motion_valid_mask(..., band=band) downstream) — the same pixels the
    matcher cannot range over anyway (band defaults to the 16x16 window's
    margin), and big-rotation frames already fail the inlier gate.
    imgs (B, H, W, C), R (B, 3, 3). ``dtype``: optional storage type for
    the shifted image reads (bf16 halves the slab traffic; hat weights and
    the accumulator stay f32 — the same inference-only precision option as
    the gather warp's).
    """
    B, H, W = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    D = band
    if dtype is not None:
        imgs = imgs.astype(dtype)
    xs, ys = homography_grid(K, R, H, W)                # (B, H, W)
    jj = jnp.arange(W, dtype=jnp.float32)[None, None, :]
    ii = jnp.arange(H, dtype=jnp.float32)[None, :, None]
    dyf = ys - ii
    dxf = xs - jj
    P = D + 1
    pad = jnp.pad(imgs, ((0, 0), (P, P), (P, P), (0, 0)))
    C = imgs.shape[3]
    out = jnp.zeros(imgs.shape, jnp.float32)
    for s in range(-D, D + 2):
        wy = jnp.maximum(0.0, 1.0 - jnp.abs(dyf - s))
        row = jnp.zeros(imgs.shape, jnp.float32)
        for t in range(-D, D + 2):
            wx = jnp.maximum(0.0, 1.0 - jnp.abs(dxf - t))
            sl = jax.lax.slice(pad, (0, s + P, t + P, 0),
                               (B, s + P + H, t + P + W, C))
            row = row + wx[..., None] * sl
        out = out + wy[..., None] * row
    eps = 1e-3
    ok = ((xs >= -eps) & (xs <= W - 1 + eps)
          & (ys >= -eps) & (ys <= H - 1 + eps)
          & (jnp.abs(dxf) <= D) & (jnp.abs(dyf) <= D))
    return out * ok[..., None]


def ego_motion_valid_mask(K, R, H: int, W: int, band: int = 0) -> jnp.ndarray:
    """The warp-validity mask of remove_ego_motion — computed ANALYTICALLY
    (pure elementwise range test on the homography grid, no gather at all;
    warping a ones-image costs the same 4-tap gather as the real warp for a
    result that is just the in-range indicator). R (..., 3, 3) ->
    (..., H, W) float mask. ``band`` > 0 additionally excludes pixels whose
    warp displacement exceeds it (the remove_ego_motion_banded domain)."""
    xs, ys = homography_grid(K, R, H, W)
    eps = 1e-3
    ok = ((xs >= -eps) & (xs <= W - 1 + eps)
          & (ys >= -eps) & (ys <= H - 1 + eps))
    if band > 0:
        jj = jnp.arange(W, dtype=jnp.float32)[None, :]
        ii = jnp.arange(H, dtype=jnp.float32)[:, None]
        ok = ok & (jnp.abs(xs - jj) <= band) & (jnp.abs(ys - ii) <= band)
    return ok.astype(jnp.float32)
