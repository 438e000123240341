"""Ego-motion estimation: feature tracking + robust model fitting.

Rebuilds the reference's geometry stack on device:

  * Shi-Tomasi corner detection + pyramidal Lucas-Kanade tracking — the
    opencv GoodFeaturesToTrack / TrackPyrLK calls
    (/root/reference/motion_correction.lua:243-249,
    radial/test_radial_opticalflow.lua:96-107). Static shapes: always returns
    max_points corners with a validity mask (rejection stays masked, not
    dynamically shaped — XLA-friendly).
  * the 4-DoF (pan, tilt, zoom, roll) linear flow model fit by least squares
    with RANSAC — a faithful port of lsq_trans / lsq_trans_ransac
    (/root/reference/motion_correction.lua:90-169), vectorized over a fixed
    batch of samples instead of the reference's sequential adaptive count.
  * essential-matrix ego-motion (R, T, inlier count) — the sfm2.getEgoMotion
    / getEgoMotion2 surface (/root/reference/groundtruth_opticalflow.lua:283,
    radial/test_radial_opticalflow.lua:121-127): batched 8-point algorithm
    over RANSAC samples, E -> (R, t) disambiguation by cheirality, Sampson
    inlier count. The epipole is e2 = K T / T_3
    (/root/reference/radial/test_radial_opticalflow.lua:129-130).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# Shi-Tomasi corners
# ---------------------------------------------------------------------------

def _to_gray(img: jnp.ndarray) -> jnp.ndarray:
    if img.ndim == 3 and img.shape[2] == 3:
        w = jnp.asarray([0.299, 0.587, 0.114], img.dtype)
        return (img * w).sum(-1)
    return img[..., 0] if img.ndim == 3 else img


def _box(img: jnp.ndarray, k: int) -> jnp.ndarray:
    p = jnp.pad(img, ((k // 2, k - 1 - k // 2), (k // 2, k - 1 - k // 2)))
    return jax.lax.reduce_window(p, 0.0, jax.lax.add, (k, k), (1, 1), "VALID")


@functools.lru_cache(maxsize=None)
def _grid_dims(max_points: int, H: int, W: int) -> Tuple[int, int]:
    """The (gh, gw) cell grid whose aspect best matches the image, with
    gh * gw == max_points exactly when a reasonable factoring exists.
    Counts with no divisor near the aspect target (primes etc.) would
    degenerate to 1 x N full-height strips — exactly the spread failure
    the grid selector exists to prevent — so those fall back to the
    near-square grid with gh * gw >= max_points (a few extra cells; the
    selection output is gh * gw slots, downstream masks by ``valid``)."""
    target = (max_points * H / max(W, 1)) ** 0.5
    gh = min((d for d in range(1, max_points + 1) if max_points % d == 0),
             key=lambda d: abs(d - target))
    if target / 2 <= gh <= target * 2:
        return gh, max_points // gh
    gh = max(int(round(target)), 1)
    return gh, -(-max_points // gh)


def _grid_select(score: jnp.ndarray, max_points: int, quality):
    """Sort-free corner selection: per-cell argmax over a grid of
    ~max_points cells (exactly max_points when it factors near the image
    aspect; see _grid_dims) — selector='grid'.

    ``score`` (H, W, B) is the non-negative peak map (zero off-peak).
    Returns (pts (B, N, 2) as (x, y), valid (B, N)). No lax.top_k over the
    flat H*W map: the cell form is two reshape-reduces, and taking one
    corner per cell ALSO enforces the
    spatial spread OpenCV's goodFeaturesToTrack gets from its minDistance
    rule — RANSAC conditioning wants spread corners, not the global top-K
    clustered on the most textured region. Ties within a cell break to the
    first pixel in row-major scan order (deterministic)."""
    H, W, B = score.shape
    gh, gw = _grid_dims(max_points, H, W)
    ch, cw = -(-H // gh), -(-W // gw)
    Hp, Wp = gh * ch, gw * cw
    s = jnp.pad(score, ((0, Hp - H), (0, Wp - W), (0, 0)))
    s = s.reshape(gh, ch, gw, cw, B)
    m = s.max(axis=(1, 3))                                   # (gh, gw, B)
    me = m[:, None, :, None, :]
    lin = (jnp.arange(Hp, dtype=jnp.int32)[:, None] * Wp
           + jnp.arange(Wp, dtype=jnp.int32)[None, :])
    lin = lin.reshape(gh, ch, gw, cw, 1)
    hit = (s == me) & (me > 0)
    idx = jnp.where(hit, lin, jnp.int32(Hp * Wp)).min(axis=(1, 3))
    ys = (idx // Wp).astype(jnp.float32)
    xs = (idx % Wp).astype(jnp.float32)
    best = m.max(axis=(0, 1))                                # (B,)
    valid = (m > 0) & (m > quality * jnp.maximum(best, 1e-20))
    pts = jnp.stack([xs, ys], axis=-1).reshape(gh * gw, B, 2)
    pts = jnp.transpose(pts, (1, 0, 2))
    valid = valid.reshape(gh * gw, B).T
    # empty cells carry the sentinel index — zero their coords
    return jnp.where(valid[..., None], pts, 0.0), valid


def good_features_to_track(
    img: jnp.ndarray, max_points: int, quality: float = 0.01,
    min_dist: int = 8, block: int = 5, selector: str = "topk",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (pts (N, 2) float32 as (x, y), valid (N,) bool). Shi-Tomasi
    min-eigenvalue score, quality gate relative to the best corner, greedy
    non-max suppression via a min_dist x min_dist max-pool.

    ``selector``: 'topk' = global top-max_points by score (the parity
    rule); 'grid' = one corner per grid cell (_grid_select) — sort-free
    and spread-enforcing, the throughput option."""
    g = _to_gray(img)
    gx = (jnp.pad(g[:, 2:], ((0, 0), (0, 2))) - jnp.pad(g[:, :-2], ((0, 0), (2, 0)))) / 2
    gy = (jnp.pad(g[2:, :], ((0, 2), (0, 0))) - jnp.pad(g[:-2, :], ((2, 0), (0, 0)))) / 2
    ixx = _box(gx * gx, block)
    iyy = _box(gy * gy, block)
    ixy = _box(gx * gy, block)
    tr = ixx + iyy
    det = ixx * iyy - ixy * ixy
    lam_min = tr / 2 - jnp.sqrt(jnp.maximum(tr * tr / 4 - det, 0.0))
    # suppress borders
    H, W = g.shape
    b = max(block, 3)
    border = jnp.zeros((H, W), bool).at[b:-b, b:-b].set(True)
    lam = jnp.where(border, lam_min, 0.0)
    # non-max suppression
    k = max(int(min_dist) | 1, 3)
    p = jnp.pad(lam, ((k // 2, k - 1 - k // 2), (k // 2, k - 1 - k // 2)),
                constant_values=-jnp.inf)
    mx = jax.lax.reduce_window(p, -jnp.inf, jax.lax.max, (k, k), (1, 1), "VALID")
    is_peak = (lam >= mx) & (lam > 0)
    if selector == "grid":
        pts, valid = _grid_select(jnp.where(is_peak, lam, 0.0)[..., None],
                                  max_points, quality)
        return pts[0], valid[0]
    score = jnp.where(is_peak, lam, 0.0).reshape(-1)
    vals, flat = jax.lax.top_k(score, max_points)
    ys = (flat // W).astype(jnp.float32)
    xs = (flat % W).astype(jnp.float32)
    valid = vals > quality * jnp.maximum(vals[0], 1e-20)
    return jnp.stack([xs, ys], axis=-1), valid


# ---------------------------------------------------------------------------
# Pyramidal Lucas-Kanade tracking
# ---------------------------------------------------------------------------

def _sample_patches_gather(img: jnp.ndarray, pts: jnp.ndarray, win: int) -> jnp.ndarray:
    """Bilinear (win, win) patches centered (ceil) on pts (N, 2=(x,y)) —
    gather formulation (reference semantics, kept for tests)."""
    off = jnp.arange(win, dtype=jnp.float32) - (win - 1) / 2.0
    dy, dx = jnp.meshgrid(off, off, indexing="ij")
    xs = pts[:, 0][:, None, None] + dx[None]
    ys = pts[:, 1][:, None, None] + dy[None]
    from ..flow.celiu import bilinear_sample
    return bilinear_sample(img[..., None], xs, ys)[..., 0]


def _axis_weights(coords: jnp.ndarray, n: int) -> jnp.ndarray:
    """Bilinear selection matrix S[..., i] = weight of source index i for
    each continuous coordinate (clamped-corner semantics, identical to
    bilinear_sample's EnforceRange clamping). coords (...,) -> (..., n)."""
    c = jnp.clip(coords, 0.0, n - 1.0)
    c0 = jnp.floor(c)
    w = c - c0
    ii = jnp.arange(n, dtype=jnp.float32)
    return ((1.0 - w)[..., None] * (ii == c0[..., None])
            + w[..., None] * (ii == c0[..., None] + 1.0))


def _sample_patches(img: jnp.ndarray, pts: jnp.ndarray, win: int) -> jnp.ndarray:
    """Bilinear (win, win) patches centered (ceil) on pts (N, 2=(x,y)).

    Matmul formulation: bilinear sampling is separable, so each patch is
    Ry @ img @ Cx^T with 2-hot row/column selection matrices — two batched
    matmuls instead of N*win*win scattered gathers."""
    H, W = img.shape
    off = jnp.arange(win, dtype=jnp.float32) - (win - 1) / 2.0
    ys = pts[:, 1][:, None] + off[None]               # (N, win)
    xs = pts[:, 0][:, None] + off[None]
    Ry = _axis_weights(ys, H)                          # (N, win, H)
    Cx = _axis_weights(xs, W)                          # (N, win, W)
    rows = jax.lax.dot_general(
        Ry, img, (((2,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST)           # (N, win, W)
    return jax.lax.dot_general(
        rows, Cx, (((2,), (2,)), ((0,), (0,))),
        precision=jax.lax.Precision.HIGHEST)           # (N, win, win)


def _axis_onehot_int(idx: jnp.ndarray, n: int, dtype=jnp.float32) -> jnp.ndarray:
    """One-hot selection matrix for INTEGER indices with border clamping
    (replicate semantics). idx (...,) int32 -> (..., n)."""
    ii = jnp.arange(n, dtype=jnp.int32)
    return (ii == jnp.clip(idx, 0, n - 1)[..., None]).astype(dtype)


def _gather_window(img: jnp.ndarray, by: jnp.ndarray, bx: jnp.ndarray,
                   s: int, precision=jax.lax.Precision.DEFAULT) -> jnp.ndarray:
    """(s, s) integer-aligned windows of img (H, W) at top-left (by, bx)
    (N,) int32, indices clamped (replicate borders). One-hot row/column
    MATMULS instead of a take_along_axis column gather; integer one-hots
    are exact in any dtype, so DEFAULT precision (bf16 or TF32 passes)
    only rounds the [0,1] image values (~4e-3 at worst), well under the
    tracker's noise floor."""
    H, W = img.shape
    k = jnp.arange(s, dtype=jnp.int32)
    dt = jnp.bfloat16 if precision == jax.lax.Precision.DEFAULT else img.dtype
    Ry = _axis_onehot_int(by[:, None] + k[None], H, dt)     # (N, s, H)
    Cx = _axis_onehot_int(bx[:, None] + k[None], W, dt)     # (N, s, W)
    rows = jax.lax.dot_general(
        Ry, img.astype(dt), (((2,), (0,)), ((), ())),
        precision=precision, preferred_element_type=jnp.float32)
    return jax.lax.dot_general(
        rows.astype(dt), Cx, (((2,), (2,)), ((0,), (0,))),
        precision=precision, preferred_element_type=jnp.float32)


def _bilin4(w: jnp.ndarray, fy: jnp.ndarray, fx: jnp.ndarray) -> jnp.ndarray:
    """Per-point 4-tap bilinear combine of an (N, M+1, M+1) integer-grid
    window at uniform fractional offset (fy, fx) (N,) -> (N, M, M)."""
    fy = fy[:, None, None]
    fx = fx[:, None, None]
    return ((1 - fy) * (1 - fx) * w[:, :-1, :-1]
            + (1 - fy) * fx * w[:, :-1, 1:]
            + fy * (1 - fx) * w[:, 1:, :-1]
            + fy * fx * w[:, 1:, 1:])


def track_lk_windowed(
    img1: jnp.ndarray, img2: jnp.ndarray, pts: jnp.ndarray,
    win: int = 15, n_levels: int = 3, n_iters: int = 10, search: int = 32,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Faster LK with window caching + correlation surfaces: per pyramid
    level the template and the search image are gathered ONCE per point
    into integer-aligned windows; the Gauss-Newton iteration then runs on
    two per-point CROSS-CORRELATION surfaces (window x template-gradient,
    one depthwise conv per level) — bilinear resampling commutes with the
    fixed-weight inner products the update needs, so each iteration is a
    2-tap-per-axis sample of a (P, P) surface: only (N,)-sized math in the
    loop, no per-iteration window extraction at all. Identical math to
    track_lk whenever the residual motion at each level stays within
    (search - win)/2 px (larger motions clamp at the window edge and get
    rejected by the same border-status test). Track agreement with
    track_lk is pinned by tests/test_egomotion.py."""
    g1 = _to_gray(jnp.asarray(img1))
    g2 = _to_gray(jnp.asarray(img2))
    from ..models.multiscale import avg_downsample
    pyr1 = [g1]
    pyr2 = [g2]
    for _ in range(n_levels - 1):
        pyr1.append(avg_downsample(pyr1[-1][..., None], 2)[..., 0])
        pyr2.append(avg_downsample(pyr2[-1][..., None], 2)[..., 0])

    half = (win - 1) / 2.0
    d = jnp.zeros_like(pts)
    for lvl in range(n_levels - 1, -1, -1):
        scale = 2.0 ** lvl
        p_lvl = pts / scale
        i1 = pyr1[lvl]
        i2 = pyr2[lvl]

        # template: (win+1)^2 integer window + one 4-tap combine
        ty0 = p_lvl[:, 1] - half
        tx0 = p_lvl[:, 0] - half
        tby = jnp.floor(ty0)
        tbx = jnp.floor(tx0)
        wt = _gather_window(i1, tby.astype(jnp.int32), tbx.astype(jnp.int32),
                            win + 1)
        t = _bilin4(wt, ty0 - tby, tx0 - tbx)               # (N, win, win)
        tx = (t[:, :, 2:] - t[:, :, :-2]) / 2
        ty = (t[:, 2:, :] - t[:, :-2, :]) / 2
        tx = tx[:, 1:-1, :]
        ty = ty[:, :, 1:-1]
        a11 = (tx * tx).sum((1, 2))
        a12 = (tx * ty).sum((1, 2))
        a22 = (ty * ty).sum((1, 2))
        det = a11 * a22 - a12 * a12

        # search window cached once around the level-entry estimate
        c0 = p_lvl + d / scale                              # (N, 2)
        bx = jnp.floor(c0[:, 0]).astype(jnp.int32) - search // 2
        by = jnp.floor(c0[:, 1]).astype(jnp.int32) - search // 2
        wnd = _gather_window(i2, by, bx, search)            # (N, S, S)

        # Gauss-Newton only consumes the window through the two inner
        # products  b1 = sum_ij (w(d) - t)[1+i,1+j] * tx[i,j]  (and ty):
        # bilinear resampling commutes with this fixed-weight sum, so
        # sum_ij w(d)[1+i,1+j]*tx[i,j] is EXACTLY the bilinear sample at
        # (ly+1, lx+1) of the cross-correlation surface
        #   corr_x(p, q) = sum_ij wnd[p+i, q+j] * tx[i, j],
        # computed ONCE per level as a per-point depthwise conv — the
        # per-iteration loop then touches only (N,)-sized tensors instead
        # of re-extracting a (win+1)^2 sub-window every iteration. (A
        # banded static-shift extraction is pathological to COMPILE under
        # vmap in this loop.)
        kw = win - 2                                        # 13: interior
        P = search - kw + 1                                 # corr positions
        dn = jax.lax.conv_dimension_numbers(
            (1, 1, search, search), (1, 1, kw, kw), ("NCHW", "OIHW", "NCHW"))
        N = wnd.shape[0]

        def corr_with(k):
            # wnd as N feature groups of one channel; per-point kernels
            out = jax.lax.conv_general_dilated(
                wnd[None], k[:, None], (1, 1), "VALID",
                dimension_numbers=dn, feature_group_count=N,
                precision=jax.lax.Precision.HIGHEST)
            return out[0]                                   # (N, P, P)
        corr_x = corr_with(tx)
        corr_y = corr_with(ty)
        t_in = t[:, 1:-1, 1:-1]
        tdx = (t_in * tx).sum((1, 2))                       # (N,)
        tdy = (t_in * ty).sum((1, 2))
        lim = float(search - win - 1)

        def body(_, dcur):
            # continuous top-left of the patch within the window, clamped
            # into the representable band (points whose estimate escapes
            # the search window degrade to an edge-clamped sample; the
            # matmul form replicate-clamped rows instead — identical for
            # in-window motion, both garbage->border-rejected beyond)
            ly = jnp.clip(p_lvl[:, 1] + dcur[:, 1] / scale - half
                          - by.astype(jnp.float32), 0.0, lim)
            lx = jnp.clip(p_lvl[:, 0] + dcur[:, 0] / scale - half
                          - bx.astype(jnp.float32), 0.0, lim)
            # bilinear sample of the corr surfaces via 2-hot axis weights
            oy = _axis_weights(ly + 1.0, P)                 # (N, P)
            ox = _axis_weights(lx + 1.0, P)
            cyx = jnp.einsum("npq,nq->np", corr_x, ox,
                             precision=jax.lax.Precision.HIGHEST)
            b1 = jnp.einsum("np,np->n", cyx, oy,
                            precision=jax.lax.Precision.HIGHEST) - tdx
            cyy = jnp.einsum("npq,nq->np", corr_y, ox,
                             precision=jax.lax.Precision.HIGHEST)
            b2 = jnp.einsum("np,np->n", cyy, oy,
                            precision=jax.lax.Precision.HIGHEST) - tdy
            ddx = -(a22 * b1 - a12 * b2) / jnp.maximum(det, 1e-8)
            ddy = -(-a12 * b1 + a11 * b2) / jnp.maximum(det, 1e-8)
            return dcur + jnp.stack([ddx, ddy], -1) * scale
        d = jax.lax.fori_loop(0, n_iters, body, d)

    pts2 = pts + d
    H, W = g1.shape
    m = win // 2 + 1
    status = ((pts2[:, 0] >= m) & (pts2[:, 0] <= W - 1 - m)
              & (pts2[:, 1] >= m) & (pts2[:, 1] <= H - 1 - m)
              & jnp.isfinite(pts2).all(-1))
    return pts2, status


def track_lk(
    img1: jnp.ndarray, img2: jnp.ndarray, pts: jnp.ndarray,
    win: int = 15, n_levels: int = 3, n_iters: int = 10,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Track pts from img1 to img2 (OpenCV TrackPyrLK semantics). Returns
    (pts2 (N, 2), status (N,) bool)."""
    g1 = _to_gray(jnp.asarray(img1))
    g2 = _to_gray(jnp.asarray(img2))
    from ..models.multiscale import avg_downsample
    pyr1 = [g1]
    pyr2 = [g2]
    for _ in range(n_levels - 1):
        pyr1.append(avg_downsample(pyr1[-1][..., None], 2)[..., 0])
        pyr2.append(avg_downsample(pyr2[-1][..., None], 2)[..., 0])

    d = jnp.zeros_like(pts)
    for lvl in range(n_levels - 1, -1, -1):
        scale = 2.0 ** lvl
        p_lvl = pts / scale
        i1 = pyr1[lvl]
        i2 = pyr2[lvl]
        t = _sample_patches(i1, p_lvl, win)                 # template
        # spatial gradients of the template (central diffs inside the patch)
        tx = (t[:, :, 2:] - t[:, :, :-2]) / 2
        ty = (t[:, 2:, :] - t[:, :-2, :]) / 2
        tx = tx[:, 1:-1, :]
        ty = ty[:, :, 1:-1]
        a11 = (tx * tx).sum((1, 2))
        a12 = (tx * ty).sum((1, 2))
        a22 = (ty * ty).sum((1, 2))
        det = a11 * a22 - a12 * a12

        def body(_, dcur):
            w = _sample_patches(i2, p_lvl + dcur / scale, win)
            err = (w - t)[:, 1:-1, 1:-1]
            b1 = (err * tx).sum((1, 2))
            b2 = (err * ty).sum((1, 2))
            ddx = -(a22 * b1 - a12 * b2) / jnp.maximum(det, 1e-8)
            ddy = -(-a12 * b1 + a11 * b2) / jnp.maximum(det, 1e-8)
            return dcur + jnp.stack([ddx, ddy], -1) * scale
        d = jax.lax.fori_loop(0, n_iters, body, d)

    pts2 = pts + d
    H, W = g1.shape
    m = win // 2 + 1
    status = ((pts2[:, 0] >= m) & (pts2[:, 0] <= W - 1 - m)
              & (pts2[:, 1] >= m) & (pts2[:, 1] <= H - 1 - m)
              & jnp.isfinite(pts2).all(-1))
    return pts2, status


# ---------------------------------------------------------------------------
# 4-DoF (pan, tilt, zoom, roll) model — motion_correction port
# ---------------------------------------------------------------------------

def _lsq_features(pts_in, pts_out, w_center, h_center):
    """Per-point basis of the 4-DoF linear flow model
    (lsq_trans, /root/reference/motion_correction.lua:90-147): flow f is fit
    as x1*p + x2*t + x3*z + x4*r with p=(-1,0), t=(0,-1), z=-pt, r=(pt_y,-pt_x)."""
    pt = pts_in - jnp.asarray([w_center, h_center])
    mpt = pts_out - jnp.asarray([w_center, h_center])
    f = mpt - pt
    p = jnp.broadcast_to(jnp.asarray([-1.0, 0.0]), pt.shape)
    t = jnp.broadcast_to(jnp.asarray([0.0, -1.0]), pt.shape)
    z = -pt
    r = jnp.stack([pt[:, 1], -pt[:, 0]], -1)
    return f, (p, t, z, r)


def lsq_trans(pts_in, pts_out, w_center, h_center, weights=None):
    """Weighted least squares of the 4-DoF model. Returns (H (2,3), x (4,))."""
    f, basis = _lsq_features(pts_in, pts_out, w_center, h_center)
    B = jnp.stack(basis, axis=1)                    # (N, 4, 2)
    if weights is None:
        weights = jnp.ones(f.shape[0], f.dtype)
    w = weights[:, None, None]
    A = jnp.einsum("nac,nbc->ab", B * w, B)
    b = jnp.einsum("nac,nc->a", B * w, f)
    x = jnp.linalg.solve(A + 1e-9 * jnp.eye(4), b)
    dtheta = -jnp.arctan(x[3])
    c, s = jnp.cos(dtheta), jnp.sin(dtheta)
    H = jnp.array([
        [c, s, (1 - c) * w_center - s * h_center],
        [-s, c, s * w_center - (1 - c) * h_center],
    ])
    H = H.at[0, 2].add(x[0])
    H = H.at[1, 2].add(x[1])
    return H, x


def _model_residuals(x, pts_in, pts_out, w_center, h_center):
    f, (p, t, z, r) = _lsq_features(pts_in, pts_out, w_center, h_center)
    fout = x[0] * p + x[1] * t + x[2] * z + x[3] * r
    return jnp.linalg.norm(fout - f, axis=-1)


@functools.partial(jax.jit, static_argnums=(4,))
def lsq_trans_ransac(pts_in, pts_out, w_center, h_center,
                     n_samples: int = 64, key=None):
    """RANSAC over minimal 5-point samples, all samples evaluated in one
    batched solve (the batched reformulation of lsq_trans_ransac,
    /root/reference/motion_correction.lua:149-169 — fixed sample count
    instead of the sequential p=0.99 adaptive loop). Inlier rule: residual
    <= sqrt(5.99 * std(residuals)^2) (:48)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    n = pts_in.shape[0]
    idx = jax.random.randint(key, (n_samples, 5), 0, n)

    def fit_and_score(sample_idx):
        _, x = lsq_trans(pts_in[sample_idx], pts_out[sample_idx],
                         w_center, h_center)
        d = _model_residuals(x, pts_in, pts_out, w_center, h_center)
        thr = jnp.sqrt(5.99) * jnp.std(d)
        return x, (d <= thr).sum()

    xs, inliers = jax.vmap(fit_and_score)(idx)
    best = jnp.argmax(inliers)
    x = xs[best]
    dtheta = -jnp.arctan(x[3])
    c, s = jnp.cos(dtheta), jnp.sin(dtheta)
    H = jnp.array([
        [c, s, (1 - c) * w_center - s * h_center],
        [-s, c, s * w_center - (1 - c) * h_center],
    ])
    H = H.at[0, 2].add(x[0])
    H = H.at[1, 2].add(x[1])
    return H, inliers[best]


def warp_affine(img: jnp.ndarray, H) -> jnp.ndarray:
    """Nearest-neighbor affine warp (WarpAffine inline C,
    /root/reference/motion_correction.lua:171-200): out(i,j) = img(round(H [j i 1]))."""
    Hm = jnp.asarray(H, jnp.float32)
    Ht, Wd = img.shape[0], img.shape[1]
    j = jnp.arange(Wd, dtype=jnp.float32)
    i = jnp.arange(Ht, dtype=jnp.float32)
    xx, yy = jnp.meshgrid(j, i)
    xs = jnp.round(Hm[0, 0] * xx + Hm[0, 1] * yy + Hm[0, 2]).astype(jnp.int32)
    ys = jnp.round(Hm[1, 0] * xx + Hm[1, 1] * yy + Hm[1, 2]).astype(jnp.int32)
    ok = (xs >= 0) & (xs < Wd) & (ys >= 0) & (ys < Ht)
    out = img[jnp.clip(ys, 0, Ht - 1), jnp.clip(xs, 0, Wd - 1)]
    return out * ok[..., None] if img.ndim == 3 else out * ok


# ---------------------------------------------------------------------------
# Essential-matrix ego-motion (sfm2.getEgoMotion / getEgoMotion2 surface)
# ---------------------------------------------------------------------------

class EgoMotion(NamedTuple):
    R: jnp.ndarray          # (3, 3) rotation prev->curr
    T: jnp.ndarray          # (3,) unit translation
    n_inliers: jnp.ndarray  # scalar int
    n_found: jnp.ndarray    # scalar int


def _eight_point(p1n, p2n):
    """Normalized 8-point: p1n, p2n (8, 2) normalized coords -> E (3, 3).

    QR formulation: the nullspace of the (8, 9) A is the orthogonal
    complement of range(A^T) — the last column of a COMPLETE Householder QR
    of A^T. Batched QR is used instead of batched SVD (RANSAC runs 64 of
    these per pair), and unlike an eigh of A^T A it never
    squares the conditioning (the squared system cannot separate a
    sigma_8 ~ 1e-4 direction from the nullspace in f32 — measured 1e-2
    nullspace error vs 2e-4 for QR, 2e-5 for SVD). The essential-manifold
    projection is DEFERRED: Sampson scoring ranks samples on the raw
    nullspace E, and ``_decompose_E``'s SVD of the single winning E
    projects implicitly when extracting (R, t)."""
    x1, y1 = p1n[:, 0], p1n[:, 1]
    x2, y2 = p2n[:, 0], p2n[:, 1]
    A = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                   jnp.ones_like(x1)], axis=-1)
    Q, _ = jnp.linalg.qr(A.T, mode="complete")
    return Q[:, 8].reshape(3, 3)


def _decompose_E(E):
    """E -> 4 candidate (R, t)."""
    u, _, vt = jnp.linalg.svd(E)
    d = jnp.sign(jnp.linalg.det(u @ vt))
    W = jnp.asarray([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    R1 = u @ W @ vt * d
    R2 = u @ W.T @ vt * d
    t = u[:, 2]
    return jnp.stack([R1, R1, R2, R2]), jnp.stack([t, -t, t, -t])


def _sampson(E, p1n, p2n):
    ones = jnp.ones((p1n.shape[0], 1), p1n.dtype)
    x1 = jnp.concatenate([p1n, ones], -1)
    x2 = jnp.concatenate([p2n, ones], -1)
    Ex1 = x1 @ E.T
    Etx2 = x2 @ E
    num = jnp.einsum("nc,nc->n", x2, Ex1) ** 2
    den = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
    return num / jnp.maximum(den, 1e-12)


def _cheirality_count(R, t, p1n, p2n):
    """Count points with positive depth in both views (midpoint-free linear
    triangulation of the z coordinates)."""
    ones = jnp.ones((p1n.shape[0], 1), p1n.dtype)
    x1 = jnp.concatenate([p1n, ones], -1)          # bearing in cam1
    x2 = jnp.concatenate([p2n, ones], -1)          # bearing in cam2
    # depth of point along x1 solving z2 * x2 = z1 * R x1 + t (two eqs)
    Rx1 = x1 @ R.T
    a = Rx1[:, :2] - Rx1[:, 2:3] * p2n             # (N, 2)
    b = t[2] * p2n - t[:2]
    z1 = jnp.einsum("nc,nc->n", a, b) / jnp.maximum(
        jnp.einsum("nc,nc->n", a, a), 1e-12)
    z2 = z1 * Rx1[:, 2] + t[2]
    return ((z1 > 0) & (z2 > 0)).sum()


@functools.partial(jax.jit, static_argnums=(4,))
def get_ego_motion_from_matches(pts1, pts2, valid, K, n_samples: int = 64,
                                key=None, max_dist: float = 1e-3) -> EgoMotion:
    """RANSAC essential-matrix fit on matched points (pixel coords).
    pts1/pts2 (N, 2), valid (N,) mask; returns EgoMotion with R, unit T
    (prev->curr), Sampson inlier count and found count."""
    if key is None:
        key = jax.random.PRNGKey(1)
    K = jnp.asarray(K, jnp.float32)
    f = jnp.asarray([K[0, 0], K[1, 1]])
    c = jnp.asarray([K[0, 2], K[1, 2]])
    p1n = (pts1 - c) / f
    p2n = (pts2 - c) / f
    n = pts1.shape[0]
    w = valid.astype(jnp.float32)
    # sample indices biased to valid points: sample from valid via gumbel-max
    gk = jax.random.gumbel(key, (n_samples, 8, n))
    scores = gk + jnp.where(valid, 0.0, -1e9)[None, None, :]
    idx = jnp.argmax(scores, axis=-1)

    def fit(sample_idx):
        E = _eight_point(p1n[sample_idx], p2n[sample_idx])
        d = _sampson(E, p1n, p2n)
        inl = ((d < max_dist) & valid).sum()
        return E, inl

    Es, inls = jax.vmap(fit)(idx)
    best = jnp.argmax(inls)
    E = Es[best]

    Rs, ts = _decompose_E(E)
    counts = jax.vmap(lambda R, t: _cheirality_count(R, t, p1n, p2n))(Rs, ts)
    pick = jnp.argmax(counts)
    return EgoMotion(Rs[pick], ts[pick], inls[best], valid.sum())


@functools.partial(jax.jit, static_argnums=(3, 6))
def _ego_motion_jit(img1, img2, K, max_points: int, quality, key,
                    tracker: str = "windowed") -> EgoMotion:
    pts, pvalid = good_features_to_track(img1, max_points, quality)
    # 'windowed': window-cached tracker — OpenCV's calcOpticalFlowPyrLK
    # (the reference's actual dependency, sfm2) also iterates inside a
    # window around the current estimate; the online-regime default.
    # 'full': full-image-resample track_lk — for the offline loaders,
    # where inter-frame motion is unbounded and the batched device
    # programs (load_rectified_pairs_batched, _polar_batch_device) use
    # the same form, keeping the per-pair/batched equivalence exact.
    if tracker == "windowed":
        pts2, status = track_lk_windowed(img1, img2, pts)
    else:
        pts2, status = track_lk(img1, img2, pts)
    valid = pvalid & status
    return get_ego_motion_from_matches(pts, pts2, valid, K, key=key)


# ---------------------------------------------------------------------------
# Batched variants: B independent frame pairs in ONE device program (the
# full-pipeline throughput regime, benchmarks/bench_full_pipeline.py)
# ---------------------------------------------------------------------------

def _to_gray_batched(imgs: jnp.ndarray) -> jnp.ndarray:
    if imgs.ndim == 4 and imgs.shape[-1] == 3:
        w = jnp.asarray([0.299, 0.587, 0.114], imgs.dtype)
        return (imgs * w).sum(-1)
    return imgs[..., 0] if imgs.ndim == 4 else imgs


def _box_blast(img_hwb: jnp.ndarray, k: int) -> jnp.ndarray:
    """Box filter on (H, W, B) with window (k, k, 1) — batch stays on the
    lane dimension."""
    p = jnp.pad(img_hwb,
                ((k // 2, k - 1 - k // 2), (k // 2, k - 1 - k // 2), (0, 0)))
    return jax.lax.reduce_window(p, 0.0, jax.lax.add, (k, k, 1), (1, 1, 1),
                                 "VALID")


def good_features_to_track_batched(
    imgs: jnp.ndarray, max_points: int, quality: float = 0.01,
    min_dist: int = 8, block: int = 5, selector: str = "topk",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched Shi-Tomasi: imgs (B, H, W[, 3]) -> (pts (B, N, 2) as (x, y),
    valid (B, N) bool). Same selection rules as good_features_to_track
    (``selector``: 'topk' parity / 'grid' sort-free per-cell argmax).

    Batch-LAST layout for every windowed op: a vmapped 2-D reduce_window
    lowers to (B, H, W, 1) temps whose trailing singleton is lane-padded
    128x (the layout blowup documented at patch_ssd_costs,
    data/groundtruth.py); with (H, W, B) the batch fills the lanes."""
    g = jnp.transpose(_to_gray_batched(imgs), (1, 2, 0))       # (H, W, B)
    gx = (jnp.pad(g[:, 2:], ((0, 0), (0, 2), (0, 0)))
          - jnp.pad(g[:, :-2], ((0, 0), (2, 0), (0, 0)))) / 2
    gy = (jnp.pad(g[2:, :], ((0, 2), (0, 0), (0, 0)))
          - jnp.pad(g[:-2, :], ((2, 0), (0, 0), (0, 0)))) / 2
    ixx = _box_blast(gx * gx, block)
    iyy = _box_blast(gy * gy, block)
    ixy = _box_blast(gx * gy, block)
    tr = ixx + iyy
    det = ixx * iyy - ixy * ixy
    lam_min = tr / 2 - jnp.sqrt(jnp.maximum(tr * tr / 4 - det, 0.0))
    H, W, B = g.shape
    b = max(block, 3)
    border = jnp.zeros((H, W, 1), bool).at[b:-b, b:-b].set(True)
    lam = jnp.where(border, lam_min, 0.0)
    k = max(int(min_dist) | 1, 3)
    p = jnp.pad(lam, ((k // 2, k - 1 - k // 2), (k // 2, k - 1 - k // 2),
                      (0, 0)), constant_values=-jnp.inf)
    mx = jax.lax.reduce_window(p, -jnp.inf, jax.lax.max, (k, k, 1),
                               (1, 1, 1), "VALID")
    is_peak = (lam >= mx) & (lam > 0)
    score = jnp.where(is_peak, lam, 0.0)
    if selector == "grid":
        return _grid_select(score, max_points, quality)
    score = jnp.transpose(score, (2, 0, 1)).reshape(B, H * W)
    vals, flat = jax.lax.top_k(score, max_points)
    ys = (flat // W).astype(jnp.float32)
    xs = (flat % W).astype(jnp.float32)
    valid = vals > quality * jnp.maximum(vals[:, :1], 1e-20)
    return jnp.stack([xs, ys], axis=-1), valid


@functools.partial(jax.jit, static_argnums=(3, 6, 7, 8, 9))
def _ego_motion_batched_jit(imgs1, imgs2, K, max_points: int, quality,
                            key, lk_iters: int = 10,
                            n_samples: int = 64,
                            selector: str = "topk",
                            lk_search: int = 32) -> EgoMotion:
    pts, pvalid = good_features_to_track_batched(imgs1, max_points, quality,
                                                 selector=selector)
    # window-cached LK (track_lk_windowed): windows extracted once per
    # level (one-hot matmuls), tiny per-iteration resamples
    pts2, status = jax.vmap(
        lambda a, b, p: track_lk_windowed(a, b, p, n_iters=lk_iters,
                                          search=lk_search)
    )(imgs1, imgs2, pts)
    valid = pvalid & status
    # ONE key shared across items (not split(key, B)): the RANSAC index
    # draws land on different points anyway (per-item corner sets), and it
    # makes results independent of how the batch is sliced — a dp-sharded
    # step (parallel.mesh.sharded_pipeline_step) computes bitwise the same
    # ego-motion as the unsharded one.
    return jax.vmap(
        lambda p1, p2, v: get_ego_motion_from_matches(
            p1, p2, v, K, n_samples, key=key)
    )(pts, pts2, valid)


def get_ego_motion_batched(imgs1, imgs2, K, max_points: int = 400,
                           quality: float = 0.001, key=None,
                           lk_iters: int = 10,
                           n_samples: int = 64,
                           selector: str = "topk",
                           lk_search: int = 32) -> EgoMotion:
    """get_ego_motion over B independent frame pairs in one jitted program.
    imgs1/imgs2: (B, H, W[, 3]). Returns EgoMotion with leading batch dims:
    R (B, 3, 3), T (B, 3), n_inliers/n_found (B,). ``selector``: corner
    selection rule ('topk' parity / 'grid' sort-free, see
    good_features_to_track). ``lk_search``: the cached search-window side
    (track_lk_windowed) — per-level residual capture is
    (lk_search - win - 1) px; classic pyramid LK's own capture range is
    ~win/2 per level, so 24 (margin 8 >= win/2) preserves the reference's
    effective envelope while shrinking the window matmuls, the corr
    convs, and the per-iteration einsums (all ~S or (S-kw+1)^2 shaped);
    32 is the conservative default."""
    if key is None:
        key = jax.random.PRNGKey(1)
    return _ego_motion_batched_jit(jnp.asarray(imgs1), jnp.asarray(imgs2),
                                   jnp.asarray(K, jnp.float32),
                                   int(max_points), jnp.float32(quality),
                                   key, int(lk_iters), int(n_samples),
                                   str(selector), int(lk_search))


def get_ego_motion(img1, img2, K, max_points: int = 400,
                   quality: float = 0.001, key=None,
                   tracker: str = "windowed") -> EgoMotion:
    """Full sfm2.getEgoMotion surface: detect corners in img1, LK-track to
    img2, robust essential fit. Returns (R, T, inliers, found).
    ``tracker``: 'windowed' (online regime, bounded motion) or 'full'
    (offline loaders; matches the batched device programs exactly).

    The whole pipeline runs as ONE jitted program — eager composition costs
    thousands of per-op dispatches)."""
    if key is None:
        key = jax.random.PRNGKey(1)
    return _ego_motion_jit(jnp.asarray(img1), jnp.asarray(img2),
                           jnp.asarray(K, jnp.float32), max_points,
                           jnp.float32(quality), key, tracker)


def fundamental_from_essential(E, K) -> jnp.ndarray:
    """F = K^-T E K^-1 — the fundmat return of sfm2.getEgoMotion2
    (/root/reference/radial/test_radial_opticalflow.lua:121-127)."""
    Ki = jnp.linalg.inv(jnp.asarray(K, jnp.float32))
    return Ki.T @ jnp.asarray(E) @ Ki


def essential_from_rt(R, T) -> jnp.ndarray:
    """E = [T]_x R."""
    T = jnp.asarray(T)
    tx = jnp.array([[0.0, -T[2], T[1]],
                    [T[2], 0.0, -T[0]],
                    [-T[1], T[0], 0.0]])
    return tx @ jnp.asarray(R)


def epipole(K, T) -> jnp.ndarray:
    """e2 = K T / T_3 (x, y) — /root/reference/radial/test_radial_opticalflow.lua:129-130."""
    e = jnp.asarray(K) @ jnp.asarray(T)
    return e[:2] / e[2]
