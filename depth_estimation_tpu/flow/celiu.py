"""Coarse-to-fine variational optical flow (Ce Liu's solver) in JAX.

Rebuilds the celiu mex solver the reference uses as its "ground truth"
generator (liuflow / celiu: /root/reference/celiu/mex/OpticalFlow.cpp):

  * Gaussian pyramid with Liu's level/sigma schedule
    (GaussianPyramid.cpp:45-76);
  * im2feature: gray+dx+dy (1ch) or gray+dx+dy+(g-r)+(g-b) (3ch)
    (OpticalFlow.cpp:1090-1130);
  * IRLS ("outer/inner fixed point") with robust smoothness weight
    Phi = 0.5/sqrt(|grad u|^2+|grad v|^2+eps) and data weight
    Psi = 1/(2 sqrt((It + Ix du + Iy dv)^2 + eps)) under the Laplacian noise
    model (OpticalFlow.cpp:258-339, noiseModel=Lap at :18);
  * per-level iteration schedule nOuter+k, nSOR+3k (OpticalFlow.cpp:1006);
  * bilinear warping with out-of-range pixels taking frame-1 values
    (interpolation=Bilinear at :17, ImageProcessing warpImage).

Deviation (documented): the omega=1.8 SOR relaxation is sequential
Gauss-Seidel in the reference; here it is RED-BLACK SOR — the classic
parallel reordering that solves the same linear system (same A, same b, same
omega) with checkerboard sweeps, as dense elementwise updates. Fixed points
are identical; iterates differ only in sweep order.
``tests/test_celiu.py`` verifies convergence to the sequential solver's
solution on the same system.

Layout: images are (H, W, C) float32 in [0, 1], flow fields (H, W).
vx = x (column) flow, vy = y (row) flow, matching the mex convention.
"""

from __future__ import annotations

import functools
import math
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# image helpers (clamp-boundary separable filters, bilinear sampling)
# ---------------------------------------------------------------------------

def _axpad(ndim: int, axis: int, lo: int, hi: int):
    """Pad spec touching one (negative) axis of an ndim-array."""
    pads = [(0, 0)] * ndim
    pads[axis] = (lo, hi)
    return pads


def _hfilter(img: jnp.ndarray, f: np.ndarray) -> jnp.ndarray:
    """Horizontal correlation with clamp (replicate) boundary
    (ImageProcessing::hfiltering). img: (..., H, W, C) — leading batch dims
    pass through (the explicit-batch regime, coarse2fine_flow_batched)."""
    r = len(f) // 2
    p = jnp.pad(img, _axpad(img.ndim, -2, r, r), mode="edge")
    out = jnp.zeros_like(img)
    ax = img.ndim - 2
    for k, w in enumerate(f):
        out = out + w * jax.lax.slice_in_dim(p, k, k + img.shape[-2], axis=ax)
    return out


def _vfilter(img: jnp.ndarray, f: np.ndarray) -> jnp.ndarray:
    r = len(f) // 2
    p = jnp.pad(img, _axpad(img.ndim, -3, r, r), mode="edge")
    out = jnp.zeros_like(img)
    ax = img.ndim - 3
    for k, w in enumerate(f):
        out = out + w * jax.lax.slice_in_dim(p, k, k + img.shape[-3], axis=ax)
    return out


_DERIV5 = np.array([1, -8, 0, 8, -1], np.float32) / 12.0


def dx_advanced(img: jnp.ndarray) -> jnp.ndarray:
    """5-tap derivative filter (Image<T>::dx advanced,
    /root/reference/celiu/mex/Image.h:965-969)."""
    return _hfilter(img, _DERIV5)


def dy_advanced(img: jnp.ndarray) -> jnp.ndarray:
    return _vfilter(img, _DERIV5)


def dx_forward(img: jnp.ndarray) -> jnp.ndarray:
    """Forward difference along W, last column zero (Image<T>::dx simple).
    img: (..., H, W, C) image layout."""
    d = img[..., :, 1:, :] - img[..., :, :-1, :]
    return jnp.pad(d, _axpad(img.ndim, -2, 0, 1))


def dy_forward(img: jnp.ndarray) -> jnp.ndarray:
    d = img[..., 1:, :, :] - img[..., :-1, :, :]
    return jnp.pad(d, _axpad(img.ndim, -3, 0, 1))


def gaussian_smooth(img: jnp.ndarray, sigma: float, fsize: int) -> jnp.ndarray:
    """Separable Gaussian with clamp boundary (Image::GaussianSmoothing)."""
    xs = np.arange(-fsize, fsize + 1, dtype=np.float64)
    f = np.exp(-(xs ** 2) / (2 * sigma * sigma))
    f = (f / f.sum()).astype(np.float32)
    return _vfilter(_hfilter(img, f), f)


def _gather_hw(img: jnp.ndarray, yy: jnp.ndarray, xx: jnp.ndarray) -> jnp.ndarray:
    """img (..., H, W, C) indexed at integer (yy, xx) (..., Hs, Ws) with
    clamped coordinates. Unbatched keeps the plain 2-D gather; with leading
    batch dims the (H, W) axes flatten and the lookup becomes ONE batched
    take_along_axis (a native batched gather — no vmap)."""
    H, W = img.shape[-3], img.shape[-2]
    yy = jnp.clip(yy, 0, H - 1)
    xx = jnp.clip(xx, 0, W - 1)
    if img.ndim == 3:
        return img[yy, xx]
    C = img.shape[-1]
    lead = img.shape[:-3]
    flat = img.reshape(lead + (H * W, C))
    idx = (yy * W + xx).reshape(lead + (-1,))[..., None]
    out = jnp.take_along_axis(flat, idx, axis=-2)
    return out.reshape(yy.shape + (C,))


def bilinear_sample(img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray,
                    packed: bool = False) -> jnp.ndarray:
    """Sample img (..., H, W, C) at continuous (x, y) (..., Hs, Ws) with
    clamped corners (ImageProcessing::BilinearInterpolate, clamp via
    EnforceRange). Leading batch dims of img and x/y must match.

    ``packed=True`` selects the packed-tap formulation: the four taps
    live in ONE edge-padded (H, W, 4C) table so a single gather fetches
    them all (one index per sample instead of four). Equal to the four-tap
    form within float rounding (<= 1e-6,
    enforced per call shape by
    tests/test_celiu.py::test_packed_bilinear_matches_four_tap — NOT
    bitwise: collapsed-tap blends like (1-dx)*v + dx*v are only ulp-equal
    in f32, the same ulp sensitivity that flips knife-edge RANSAC
    consumers below): coordinates are pre-clamped per axis, which
    collapses every out-of-range tap onto the same edge pixel the per-tap
    clamping produced, and the edge pad reproduces the +1-tap clamp at
    the last row/column.

    Which form where: packed is the celiu-internal default (the warp and
    pyramid resamples dominate that solve); the four-tap form stays the
    global default because at the full pipeline's warp shape (C=10)
    40-channel rows push the gather into its byte-bound regime, and
    because packing changes XLA fusion rounding at the ulp level,
    which knife-edge RANSAC consumers (the rectification loaders) amplify
    into visibly different inlier sets."""
    if packed:
        H, W = img.shape[-3], img.shape[-2]
        x = jnp.clip(x, 0, W - 1)
        y = jnp.clip(y, 0, H - 1)
        x0 = jnp.floor(x).astype(jnp.int32)
        y0 = jnp.floor(y).astype(jnp.int32)
        dx = (x - x0)[..., None]
        dy = (y - y0)[..., None]

        pr = _axpad(img.ndim, -2, 0, 1)      # pad one column at the right
        pd = _axpad(img.ndim, -3, 0, 1)      # pad one row at the bottom
        xr = jnp.pad(img, pr, mode="edge")[..., :, 1:, :]
        yd = jnp.pad(img, pd, mode="edge")[..., 1:, :, :]
        xyd = jnp.pad(xr, pd, mode="edge")[..., 1:, :, :]
        table = jnp.concatenate([img, xr, yd, xyd], axis=-1)

        t = _gather_hw(table, y0, x0)
        C = img.shape[-1]
        t00, t10, t01, t11 = (t[..., :C], t[..., C:2 * C],
                              t[..., 2 * C:3 * C], t[..., 3 * C:])
        return ((1 - dx) * (1 - dy) * t00 + dx * (1 - dy) * t10
                + (1 - dx) * dy * t01 + dx * dy * t11)

    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    dx = jnp.clip(x - x0, 0.0, 1.0)[..., None]
    dy = jnp.clip(y - y0, 0.0, 1.0)[..., None]

    def at(yy, xx):
        return _gather_hw(img, yy, xx)

    return ((1 - dx) * (1 - dy) * at(y0, x0)
            + dx * (1 - dy) * at(y0, x0 + 1)
            + (1 - dx) * dy * at(y0 + 1, x0)
            + dx * dy * at(y0 + 1, x0 + 1))


def imresize(img: jnp.ndarray, dst_h: int, dst_w: int) -> jnp.ndarray:
    """Liu's resize: sample at x = (j+1)/ratio - 1
    (ImageProcessing::ResizeImage, :202-219). img: (..., H, W, C)."""
    H, W = img.shape[-3], img.shape[-2]
    rx = dst_w / W
    ry = dst_h / H
    j = jnp.arange(dst_w, dtype=jnp.float32)
    i = jnp.arange(dst_h, dtype=jnp.float32)
    x = (j + 1.0) / rx - 1.0
    y = (i + 1.0) / ry - 1.0
    xx, yy = jnp.meshgrid(x, y)
    lead = img.shape[:-3]
    xx = jnp.broadcast_to(xx, lead + xx.shape)
    yy = jnp.broadcast_to(yy, lead + yy.shape)
    return bilinear_sample(img, xx, yy, packed=True)


def warp_image(im1: jnp.ndarray, im2: jnp.ndarray,
               vx: jnp.ndarray, vy: jnp.ndarray) -> jnp.ndarray:
    """warpIm2(i,j) = im2(i+vy, j+vx) bilinear; out-of-range pixels copy im1
    (ImageProcessing::warpImage with pIm1 fallback). im1/im2 (..., H, W, C),
    vx/vy (..., H, W)."""
    H, W = im1.shape[-3], im1.shape[-2]
    j = jnp.arange(W, dtype=jnp.float32)[None, :]
    i = jnp.arange(H, dtype=jnp.float32)[:, None]
    x = j + vx
    y = i + vy
    warped = bilinear_sample(im2, x, y, packed=True)
    oob = (x < 0) | (x > W - 1) | (y < 0) | (y > H - 1)
    return jnp.where(oob[..., None], im1, warped)


def _hermite(t: jnp.ndarray):
    """Cubic Hermite basis (h00, h10, h01, h11)(t) — the closed form of the
    reference's BicubicCoeff matrix (Image.h:2375-2410)."""
    t2 = t * t
    t3 = t2 * t
    return (2 * t3 - 3 * t2 + 1, t3 - 2 * t2 + t,
            -2 * t3 + 3 * t2, t3 - t2)


def warp_image_bicubic(im1: jnp.ndarray, im2: jnp.ndarray,
                       vx: jnp.ndarray, vy: jnp.ndarray) -> jnp.ndarray:
    """Bicubic Hermite warp with im1 fallback and [0, 1] threshold —
    Image::warpImageBicubicRef (Image.h:2464-2472 derivative images with
    filter [-0.5, 0, 0.5]; :2500-2572 Hermite patch evaluation) followed by
    warpIm2.threshold() (OpticalFlow.cpp:744-746). The reference's
    coefficient matrix a[4][4] is the textbook Hermite-patch solve; here it
    is evaluated in the separable basis-product form (identical values)."""
    H, W = im1.shape[-3], im1.shape[-2]
    d = np.asarray([-0.5, 0.0, 0.5], np.float32)
    fx = _hfilter(im2, d)
    fy = _vfilter(im2, d)
    fxy = _vfilter(fx, d)

    j = jnp.arange(W, dtype=jnp.float32)[None, :]
    i = jnp.arange(H, dtype=jnp.float32)[:, None]
    x = j + vx
    y = i + vy
    oob = (x < 0) | (x > W - 1) | (y < 0) | (y > H - 1)
    # pre-clamp before floor: out-of-range pixels are overwritten by im1
    # below, and for in-range coordinates the clamp is the identity, so
    # the packed single gather (see bilinear_sample) stays value-exact
    x = jnp.clip(x, 0, W - 1)
    y = jnp.clip(y, 0, H - 1)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    dx = (x - x0)[..., None]
    dy = (y - y0)[..., None]

    hx = _hermite(dx)
    hy = _hermite(dy)

    # all 16 taps (4 Hermite tables x 4 corners) packed into one (H, W,
    # 16C) edge-padded table: ONE index-rate-bound gather instead of 16
    G = jnp.concatenate([im2, fx, fy, fxy], axis=-1)
    pr = _axpad(G.ndim, -2, 0, 1)
    pd = _axpad(G.ndim, -3, 0, 1)
    Gx = jnp.pad(G, pr, mode="edge")[..., :, 1:, :]
    Gy = jnp.pad(G, pd, mode="edge")[..., 1:, :, :]
    Gxy = jnp.pad(Gx, pd, mode="edge")[..., 1:, :, :]
    packed = jnp.concatenate([G, Gx, Gy, Gxy], axis=-1)
    t = _gather_hw(packed, y0, x0)

    C = im1.shape[-1]
    out = jnp.zeros_like(im1)
    # corner blocks in the packed order: (x0,y0), (x0+1,y0), (y0+1,x0),
    # (x0+1,y0+1); within each block: value, d/dx, d/dy, d2/dxdy tables
    for bi, (ix, iy) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
        f = t[..., bi * 4 * C + 0 * C:bi * 4 * C + 1 * C]
        gx = t[..., bi * 4 * C + 1 * C:bi * 4 * C + 2 * C]
        gy = t[..., bi * 4 * C + 2 * C:bi * 4 * C + 3 * C]
        gxy = t[..., bi * 4 * C + 3 * C:bi * 4 * C + 4 * C]
        # basis: value/deriv pair per axis — h0*/h1* select the corner
        bxv = hx[0] if ix == 0 else hx[2]
        bxd = hx[1] if ix == 0 else hx[3]
        byv = hy[0] if iy == 0 else hy[2]
        byd = hy[1] if iy == 0 else hy[3]
        out = out + (bxv * byv * f + bxd * byv * gx
                     + bxv * byd * gy + bxd * byd * gxy)
    out = jnp.where(oob[..., None], im1, out)
    return jnp.clip(out, 0.0, 1.0)


_WARPERS = {"bilinear": warp_image, "bicubic": warp_image_bicubic}


# ---------------------------------------------------------------------------
# pyramid and features
# ---------------------------------------------------------------------------

def pyramid_shapes(h: int, w: int, ratio: float, min_width: int) -> List[Tuple[int, int]]:
    if ratio > 0.98 or ratio < 0.4:
        ratio = 0.75
    n_levels = int(math.log(min_width / w) / math.log(ratio))
    shapes = [(h, w)]
    for i in range(1, n_levels):
        shapes.append((int(h * ratio ** i), int(w * ratio ** i)))
    return shapes


def build_pyramid(img: jnp.ndarray, ratio: float, min_width: int) -> List[jnp.ndarray]:
    """GaussianPyramid::ConstructPyramid (GaussianPyramid.cpp:45-76)."""
    if ratio > 0.98 or ratio < 0.4:
        ratio = 0.75
    shapes = pyramid_shapes(img.shape[-3], img.shape[-2], ratio, min_width)
    base_sigma = 1 / ratio - 1
    n = int(math.log(0.25) / math.log(ratio))
    n_sigma = base_sigma * n
    pyr = [img]
    for i in range(1, len(shapes)):
        if i <= n:
            sigma = base_sigma * i
            foo = gaussian_smooth(img, sigma, int(sigma * 3))
            pyr.append(imresize(foo, *shapes[i]))
        else:
            foo = gaussian_smooth(pyr[i - n], n_sigma, int(n_sigma * 3))
            pyr.append(imresize(foo, *shapes[i]))
    return pyr


def im2feature(img: jnp.ndarray) -> jnp.ndarray:
    """OpticalFlow::im2feature (OpticalFlow.cpp:1090-1130)."""
    C = img.shape[-1]
    if C == 1:
        return jnp.concatenate([img, dx_advanced(img), dy_advanced(img)],
                               axis=-1)
    if C == 3:
        w = jnp.asarray([0.299, 0.587, 0.114], img.dtype)
        gray = (img * w).sum(-1, keepdims=True)
        return jnp.concatenate([
            gray, dx_advanced(gray), dy_advanced(gray),
            (img[..., 1] - img[..., 0])[..., None],   # g - r
            (img[..., 1] - img[..., 2])[..., None],   # g - b
        ], axis=-1)
    return img


# ---------------------------------------------------------------------------
# Gaussian-mixture noise model (NoiseModel.h / Stochastic.h)
# ---------------------------------------------------------------------------

def gaussian_mixture_init(n_channels: int):
    """Per-channel 2-component mixture (inlier sigma, outlier beta) with the
    reference's defaults alpha=0.95, sigma=0.05, beta=0.5
    (/root/reference/celiu/mex/NoiseModel.h:25-36)."""
    return (jnp.full((n_channels,), 0.95, jnp.float32),
            jnp.full((n_channels,), 0.05, jnp.float32),
            jnp.full((n_channels,), 0.5, jnp.float32))


def _gm_gaussian(t2: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """GaussianMixture::Gaussian (NoiseModel.h:112-118):
    exp(-x / (2 s^2)) / (2 pi s); t2 broadcast against per-channel s."""
    return jnp.exp(-t2 / (2.0 * s * s)) / (2.0 * math.pi * s)


def gmm_psi(temp: jnp.ndarray, gm) -> jnp.ndarray:
    """Data weight under the GMixture noise model
    (OpticalFlow.cpp:296-305): psi = (p1/(2 sigma^2) + p2/(2 beta^2)) /
    (p1 + p2) with p1 = N(t^2; sigma) alpha, p2 = N(t^2; beta) (1-alpha)."""
    alpha, sigma, beta = gm
    alpha, sigma, beta = (p[..., None, None, :] for p in (alpha, sigma, beta))
    t2 = temp * temp
    p1 = _gm_gaussian(t2, sigma) * alpha
    p2 = _gm_gaussian(t2, beta) * (1.0 - alpha)
    num = p1 / (2.0 * sigma * sigma) + p2 / (2.0 * beta * beta)
    return num / jnp.maximum(p1 + p2, 1e-30)


def est_gaussian_mixture(im1f: jnp.ndarray, warp: jnp.ndarray, gm,
                         prior: float = 0.9, n_iters: int = 3):
    """3-iteration EM re-estimate of the mixture after each warp
    (OpticalFlow::estGaussianMixture, OpticalFlow.cpp:764-815), with the
    reference's regularized M-step: alpha and beta are blended toward the
    0.95 / 0.3 priors with weight ``prior``."""
    alpha, sigma, beta = gm
    t2 = (im1f - warp) ** 2                      # (..., H, W, C)

    def bc(p):
        # per-channel params (..., C) broadcast against (..., H, W, C)
        return p[..., None, None, :]

    for _ in range(n_iters):
        w1 = _gm_gaussian(t2, bc(sigma)) * bc(alpha)     # E step
        w2 = _gm_gaussian(t2, bc(beta)) * (1.0 - bc(alpha))
        tot = jnp.maximum(w1 + w2, 1e-30)
        w1, w2 = w1 / tot, w2 / tot
        total1 = w1.sum(axis=(-3, -2))
        total2 = w2.sum(axis=(-3, -2))
        # M step (regularized, :805-811)
        alpha = total1 / jnp.maximum(total1 + total2, 1e-30) * (1 - prior) \
            + 0.95 * prior
        sigma = jnp.sqrt((w1 * t2).sum(axis=(-3, -2))
                         / jnp.maximum(total1, 1e-30))
        beta = jnp.sqrt((w2 * t2).sum(axis=(-3, -2))
                        / jnp.maximum(total2, 1e-30)) * (1 - prior) \
            + 0.3 * prior
    return alpha, sigma, beta


# ---------------------------------------------------------------------------
# the IRLS + red-black SOR solver for one pyramid level
# ---------------------------------------------------------------------------

_GFILTER = np.array([0.02, 0.11, 0.74, 0.11, 0.02], np.float32)


def get_dxs(im1: jnp.ndarray, im2: jnp.ndarray):
    """OpticalFlow::getDxs: smooth both, Im = 0.4 Im1 + 0.6 Im2, 5-tap
    derivatives, dt = Im2s - Im1s (OpticalFlow.cpp:34-62)."""
    s1 = _vfilter(_hfilter(im1, _GFILTER), _GFILTER)
    s2 = _vfilter(_hfilter(im2, _GFILTER), _GFILTER)
    im = 0.4 * s1 + 0.6 * s2
    return dx_advanced(im), dy_advanced(im), s2 - s1


def _neighbor_weights(phi: jnp.ndarray):
    """Edge weights of the 5-point stencil, zero at the image boundary
    (the SOR loop's j>0 / j<W-1 / i>0 / i<H-1 guards, OpticalFlow.cpp:381-427):
    west edge uses phi[west], east/south use phi[self], north uses phi[north]."""
    H, W = phi.shape[-2:]
    w_w = jnp.pad(phi[..., :, :-1], _axpad(phi.ndim, -1, 1, 0))
    w_e = phi * (jnp.arange(W) < W - 1)[None, :]
    w_n = jnp.pad(phi[..., :-1, :], _axpad(phi.ndim, -2, 1, 0))
    w_s = phi * (jnp.arange(H) < H - 1)[:, None]
    return w_w, w_e, w_n, w_s


def _nsum(f: jnp.ndarray, w_w, w_e, w_n, w_s) -> jnp.ndarray:
    left = jnp.pad(f[..., :, :-1], _axpad(f.ndim, -1, 1, 0))
    right = jnp.pad(f[..., :, 1:], _axpad(f.ndim, -1, 0, 1))
    up = jnp.pad(f[..., :-1, :], _axpad(f.ndim, -2, 1, 0))
    down = jnp.pad(f[..., 1:, :], _axpad(f.ndim, -2, 0, 1))
    return w_w * left + w_e * right + w_n * up + w_s * down


def _sor_xla(du, dv, w_w, w_e, w_n, w_s, denom_u, denom_v, b1, b2, imdxy,
             *, alpha, n_sor: int, omega: float = 1.8):
    """n_sor red-black SOR iterations as an XLA fori_loop (the general
    form: any shape, any warm du/dv start). The update rule and in-place
    scan order (red du, red dv, black du, black dv) mirror
    OpticalFlow.cpp:381-427."""
    H, W = du.shape[-2:]
    ii, jj = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    red = jnp.asarray((ii + jj) % 2 == 0)

    def sor_iter(_, duv):
        du, dv = duv
        for color in (red, ~red):
            s1 = -alpha * _nsum(du, w_w, w_e, w_n, w_s) + imdxy * dv
            du_new = (1 - omega) * du + omega / denom_u * (b1 - s1)
            du = jnp.where(color, du_new, du)
            s2 = -alpha * _nsum(dv, w_w, w_e, w_n, w_s) + imdxy * du
            dv_new = (1 - omega) * dv + omega / denom_v * (b2 - s2)
            dv = jnp.where(color, dv_new, dv)
        return du, dv

    return jax.lax.fori_loop(0, n_sor, sor_iter, (du, dv))


def smooth_flow_sor(im1f, im2f, warp, u, v, lap_para, alpha,
                    n_outer: int, n_inner: int, n_sor: int,
                    noise_model: str = "lap", gm=None,
                    interpolation: str = "bilinear"):
    """One pyramid level of IRLS (OpticalFlow::SmoothFlowSOR,
    OpticalFlow.cpp:194-452), red-black SOR inside. ``noise_model``:
    'lap' (reference default, :18) or 'gmm' (GMixture branch, :296-305);
    ``interpolation``: 'bilinear' (default, :17) or 'bicubic'
    (warpImageBicubicRef + threshold, :740-746).

    Shapes: images/warp (..., H, W, C), flows (..., H, W), lap_para (..., C)
    — leading batch dims solve B independent systems in the SAME dense
    program (the explicit-batch regime, no vmap over the solver)."""
    eps_phi = 1e-6
    eps_psi = 1e-6
    omega = 1.8
    H, W = u.shape[-2:]

    for count in range(n_outer):
        imdx, imdy, imdt = get_dxs(im1f, warp)
        du = jnp.zeros_like(u)
        dv = jnp.zeros_like(v)

        for hh in range(n_inner):
            uu = u if hh == 0 else u + du
            vv = v if hh == 0 else v + dv
            ux = dx_forward(uu[..., None])[..., 0]
            uy = dy_forward(uu[..., None])[..., 0]
            vx_ = dx_forward(vv[..., None])[..., 0]
            vy_ = dy_forward(vv[..., None])[..., 0]
            phi = 0.5 / jnp.sqrt(ux * ux + uy * uy + vx_ * vx_ + vy_ * vy_
                                 + eps_phi)

            temp = imdt + imdx * du[..., None] + imdy * dv[..., None]
            if noise_model == "gmm":
                psi = gmm_psi(temp, gm)
            else:
                psi = 1.0 / (2.0 * jnp.sqrt(temp * temp + eps_psi))
                # Laplacian-noise gate: channels whose estimated noise is ~0
                # keep psi = 0 (OpticalFlow.cpp:332-338). lap_para (..., C)
                # broadcasts against (..., H, W, C)
                psi = psi * (lap_para[..., None, None, :] >= 1e-20)

            # collapse = channel average (Image::collapse average mode)
            imdxy = jnp.mean(psi * imdx * imdy, axis=-1)
            imdx2 = jnp.mean(psi * imdx * imdx, axis=-1)
            imdy2 = jnp.mean(psi * imdy * imdy, axis=-1)
            imdtdx = jnp.mean(psi * imdx * imdt, axis=-1)
            imdtdy = jnp.mean(psi * imdy * imdt, axis=-1)

            # weighted Laplacian of the current flow (divergence form)
            def lap(f):
                fh = dx_forward(f[..., None])[..., 0] * phi
                fv = dy_forward(f[..., None])[..., 0] * phi
                out = -fh - fv
                out = out + jnp.pad(fh[..., :, :-1], _axpad(fh.ndim, -1, 1, 0))
                out = out + jnp.pad(fv[..., :-1, :], _axpad(fv.ndim, -2, 1, 0))
                return out

            b1 = -imdtdx - alpha * lap(u)
            b2 = -imdtdy - alpha * lap(v)

            w_w, w_e, w_n, w_s = _neighbor_weights(phi)
            coeff = alpha * (w_w + w_e + w_n + w_s)
            denom_u = imdx2 + alpha * 0.05 + coeff
            denom_v = imdy2 + alpha * 0.05 + coeff

            du, dv = _sor_xla(du, dv, w_w, w_e, w_n, w_s,
                              denom_u, denom_v, b1, b2, imdxy,
                              alpha=alpha, n_sor=n_sor, omega=omega)

        u = u + du
        v = v + dv
        warp = _WARPERS[interpolation](im1f, im2f, u, v)

        if noise_model == "gmm":
            gm = est_gaussian_mixture(im1f, warp, gm)
        else:
            # estLaplacianNoise (OpticalFlow.cpp:817-855): per-channel
            # mean |It|
            diff = jnp.abs(im1f - warp)
            valid = (diff > 0) & (diff < 1e6)
            cnt = jnp.maximum(valid.sum(axis=(-3, -2)), 1)
            lap_para = (diff * valid).sum(axis=(-3, -2)) / cnt
    return u, v, warp, lap_para, gm


# ---------------------------------------------------------------------------
# coarse-to-fine driver
# ---------------------------------------------------------------------------

def coarse2fine_flow(
    im1: jnp.ndarray, im2: jnp.ndarray,
    alpha: float = 1.0, ratio: float = 0.5, min_width: int = 40,
    n_outer: int = 3, n_inner: int = 1, n_sor: int = 20,
    noise_model: str = "lap", interpolation: str = "bilinear",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Full Coarse2FineFlow (OpticalFlow.cpp:944-1015). Defaults are the mex
    entry point's (Coarse2FineTwoFrames.cpp:66-72). Returns (vx, vy, warped).
    The reference trainer's 'liu' GT uses alpha=0.005, ratio=0.75,
    minWidth=30, 5/1/40 (/root/reference/groundtruth_opticalflow_celiu.lua:9-14).
    ``noise_model``: 'lap' | 'gmm'; ``interpolation``: 'bilinear' | 'bicubic'
    (the solver's two compile-time switches, OpticalFlow.cpp:16-18)."""
    im1 = jnp.asarray(im1, jnp.float32)
    im2 = jnp.asarray(im2, jnp.float32)
    if im1.ndim == 2:
        im1, im2 = im1[..., None], im2[..., None]
    pyr1 = build_pyramid(im1, ratio, min_width)
    pyr2 = build_pyramid(im2, ratio, min_width)
    if ratio > 0.98 or ratio < 0.4:
        ratio = 0.75

    n_ch = 3 if im1.shape[-1] == 1 else (5 if im1.shape[-1] == 3
                                          else im1.shape[-1])
    lead = im1.shape[:-3]
    lap_para = jnp.full(lead + (n_ch,), 0.02, jnp.float32)
    gm = (tuple(jnp.broadcast_to(p, lead + (n_ch,))
                for p in gaussian_mixture_init(n_ch))
          if noise_model == "gmm" else None)

    u = v = None
    warp = None
    for k in range(len(pyr1) - 1, -1, -1):
        f1 = im2feature(pyr1[k])
        f2 = im2feature(pyr2[k])
        h, w = f1.shape[-3], f1.shape[-2]
        if u is None:
            u = jnp.zeros(f1.shape[:-3] + (h, w), jnp.float32)
            v = jnp.zeros(f1.shape[:-3] + (h, w), jnp.float32)
            warp = f2
        else:
            u = imresize(u[..., None], h, w)[..., 0] * (1 / ratio)
            v = imresize(v[..., None], h, w)[..., 0] * (1 / ratio)
            warp = _WARPERS[interpolation](f1, f2, u, v)
        u, v, warp, lap_para, gm = smooth_flow_sor(
            f1, f2, warp, u, v, lap_para, alpha,
            n_outer + k, n_inner, n_sor + k * 3,
            noise_model=noise_model, gm=gm, interpolation=interpolation,
        )
    # final warp of the raw pair (OpticalFlow.cpp:1013-1014 uses
    # warpFL/bicubic per the interpolation switch)
    warped = jnp.clip(_WARPERS[interpolation](im1, im2, u, v), 0.0, 1.0)
    return u, v, warped


def coarse2fine_flow_batched(
    im1s: jnp.ndarray, im2s: jnp.ndarray, **kw,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """coarse2fine_flow over B independent pairs (B, H, W, C) in ONE dense
    device program: every stage (pyramid, im2feature, IRLS, red-black SOR,
    warps) carries an explicit leading batch dim, and the warps' data-
    dependent lookups are single batched take_along_axis gathers.

    The explicit batch keeps the solver out of ``jax.vmap``. Returns
    (vx, vy, warped), each with leading B."""
    im1s = jnp.asarray(im1s, jnp.float32)
    im2s = jnp.asarray(im2s, jnp.float32)
    if im1s.ndim == 3:                       # (B, H, W) gray
        im1s, im2s = im1s[..., None], im2s[..., None]
    assert im1s.ndim == 4, "batched input must be (B, H, W, C)"
    return coarse2fine_flow(im1s, im2s, **kw)
