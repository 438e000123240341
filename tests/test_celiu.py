"""Variational flow solver tests: red-black SOR reaches the sequential
Gauss-Seidel solution (same linear system), zero-motion and known-shift
recovery, and a real-pair check on the bundled celiu car images
(/root/reference/celiu/car1.jpg — read-only test fixtures)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from depth_estimation_tpu.flow import celiu


def sequential_sor(phi, imdxy, imdx2, imdy2, b1, b2, alpha, n_iter, omega=1.8):
    """Literal numpy port of the reference SOR loop
    (/root/reference/celiu/mex/OpticalFlow.cpp:381-427)."""
    H, W = phi.shape
    du = np.zeros((H, W)); dv = np.zeros((H, W))
    for _ in range(n_iter):
        for i in range(H):
            for j in range(W):
                s1 = s2 = coeff = 0.0
                if j > 0:
                    w = phi[i, j - 1]; s1 += w * du[i, j - 1]; s2 += w * dv[i, j - 1]; coeff += w
                if j < W - 1:
                    w = phi[i, j]; s1 += w * du[i, j + 1]; s2 += w * dv[i, j + 1]; coeff += w
                if i > 0:
                    w = phi[i - 1, j]; s1 += w * du[i - 1, j]; s2 += w * dv[i - 1, j]; coeff += w
                if i < H - 1:
                    w = phi[i, j]; s1 += w * du[i + 1, j]; s2 += w * dv[i + 1, j]; coeff += w
                s1 *= -alpha; s2 *= -alpha; coeff *= alpha
                s1 += imdxy[i, j] * dv[i, j]
                du[i, j] = (1 - omega) * du[i, j] + omega / (imdx2[i, j] + alpha * 0.05 + coeff) * (b1[i, j] - s1)
                s2 += imdxy[i, j] * du[i, j]
                dv[i, j] = (1 - omega) * dv[i, j] + omega / (imdy2[i, j] + alpha * 0.05 + coeff) * (b2[i, j] - s2)
    return du, dv


def test_redblack_sor_matches_sequential_fixed_point():
    """Both orderings solve the same system: after enough iterations the
    solutions coincide."""
    rng = np.random.RandomState(0)
    H, W = 12, 14
    phi = rng.rand(H, W).astype(np.float32) + 0.1
    imdxy = (rng.rand(H, W).astype(np.float32) - 0.5) * 0.1
    imdx2 = rng.rand(H, W).astype(np.float32) + 0.5
    imdy2 = rng.rand(H, W).astype(np.float32) + 0.5
    b1 = rng.randn(H, W).astype(np.float32)
    b2 = rng.randn(H, W).astype(np.float32)
    alpha = 0.5

    want_du, want_dv = sequential_sor(phi, imdxy, imdx2, imdy2, b1, b2,
                                      alpha, 300)

    red = jnp.asarray((np.add.outer(np.arange(H), np.arange(W)) % 2) == 0)
    w_w, w_e, w_n, w_s = celiu._neighbor_weights(jnp.asarray(phi))
    coeff = alpha * (w_w + w_e + w_n + w_s)
    denom_u = jnp.asarray(imdx2) + alpha * 0.05 + coeff
    denom_v = jnp.asarray(imdy2) + alpha * 0.05 + coeff
    du = jnp.zeros((H, W)); dv = jnp.zeros((H, W))
    omega = 1.8
    for _ in range(600):
        for color in (red, ~red):
            s1 = -alpha * celiu._nsum(du, w_w, w_e, w_n, w_s) + jnp.asarray(imdxy) * dv
            du = jnp.where(color, (1 - omega) * du + omega / denom_u * (jnp.asarray(b1) - s1), du)
            s2 = -alpha * celiu._nsum(dv, w_w, w_e, w_n, w_s) + jnp.asarray(imdxy) * du
            dv = jnp.where(color, (1 - omega) * dv + omega / denom_v * (jnp.asarray(b2) - s2), dv)

    np.testing.assert_allclose(np.asarray(du), want_du, atol=1e-4)
    np.testing.assert_allclose(np.asarray(dv), want_dv, atol=1e-4)


@pytest.mark.slow
def test_zero_motion_gives_zero_flow():
    rng = np.random.RandomState(1)
    im = rng.rand(40, 48, 1).astype(np.float32)
    u, v, warped = celiu.coarse2fine_flow(im, im, alpha=1.0, ratio=0.5,
                                          min_width=20)
    assert np.abs(np.asarray(u)).max() < 0.05
    assert np.abs(np.asarray(v)).max() < 0.05


@pytest.mark.slow
def test_known_shift_recovered():
    rng = np.random.RandomState(2)
    base = rng.rand(80, 96, 1).astype(np.float32)
    base = np.asarray(celiu.gaussian_smooth(jnp.asarray(base), 1.5, 4))
    dx = 2
    im1 = base[:, 4:84]
    im2 = base[:, 4 - dx:84 - dx]   # im2(x) = im1(x - dx): flow vx = +?
    # im2 sampled dx to the left: feature at im1 x appears at im2 x+dx
    u, v, _ = celiu.coarse2fine_flow(im1, im2, alpha=0.02, ratio=0.75,
                                     min_width=20, n_outer=5, n_inner=1,
                                     n_sor=40)
    inner_u = np.asarray(u)[12:-12, 12:-12]
    inner_v = np.asarray(v)[12:-12, 12:-12]
    assert abs(np.median(inner_u) - dx) < 0.25, np.median(inner_u)
    assert abs(np.median(inner_v)) < 0.25, np.median(inner_v)


@pytest.mark.slow
def test_car_pair_photometric_improvement():
    """On the bundled real pair, warping by the solved flow must reduce the
    photometric error a lot vs identity warp."""
    from depth_estimation_tpu.data.images import load_image, scale
    im1 = np.asarray(scale(load_image("/root/reference/celiu/car1.jpg"), 96, 128))
    im2 = np.asarray(scale(load_image("/root/reference/celiu/car2.jpg"), 96, 128))
    u, v, warped = celiu.coarse2fine_flow(im1, im2, alpha=0.02, ratio=0.75,
                                          min_width=30, n_outer=5, n_inner=1,
                                          n_sor=30)
    err_id = np.abs(im1 - im2).mean()
    err_warp = np.abs(im1 - np.asarray(warped)).mean()
    assert err_warp < 0.55 * err_id, (err_id, err_warp)
    # flow magnitudes are sane (car pair has modest motion)
    assert np.abs(np.asarray(u)).max() < 30


@pytest.mark.slow
def test_table_pair_and_debug_utils():
    """Second bundled pair (table1/table2) + the numeric sanitizers."""
    from depth_estimation_tpu.data.images import load_image, scale
    im1 = np.asarray(scale(load_image("/root/reference/celiu/table1.jpg"), 96, 128))
    im2 = np.asarray(scale(load_image("/root/reference/celiu/table2.jpg"), 96, 128))
    u, v, warped = celiu.coarse2fine_flow(im1, im2, alpha=0.02, ratio=0.75,
                                          min_width=30, n_outer=4, n_inner=1,
                                          n_sor=25)
    err_id = np.abs(im1 - im2).mean()
    err_warp = np.abs(im1 - np.asarray(warped)).mean()
    assert err_warp < 0.6 * err_id, (err_id, err_warp)

    from depth_estimation_tpu.utils.debug import checked, nan_debug
    f = checked(lambda x: jnp.log(x))
    np.testing.assert_allclose(np.asarray(f(jnp.asarray(1.0))), 0.0)
    with pytest.raises(Exception):
        f(jnp.asarray(-1.0))   # NaN raises
    with nan_debug(False):
        pass


def test_bicubic_warp_exact_on_quadratics():
    """Hermite bicubic with central-difference derivatives reproduces
    quadratic images exactly under subpixel shifts (central differences are
    exact for quadratics); bilinear does not. Pins warpImageBicubicRef
    semantics (Image.h:2464-2572)."""
    H, W = 24, 30
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)

    def quad(x, y):
        # stays inside [0, 1] so the reference's threshold() is a no-op
        return (0.0004 * x * x + 0.0006 * y * y + 0.0002 * x * y
                + 0.002 * x + 0.004 * y)

    img = quad(xx, yy)[..., None]
    im2 = jnp.asarray(img)
    sx, sy = 0.3, -0.4
    vx = jnp.full((H, W), sx, jnp.float32)
    vy = jnp.full((H, W), sy, jnp.float32)
    out = np.asarray(celiu.warp_image_bicubic(im2, im2, vx, vy))[..., 0]
    exact = quad(xx + sx, yy + sy)
    inner = np.s_[3:-3, 3:-3]
    np.testing.assert_allclose(out[inner], exact[inner], atol=1e-5)
    bil = np.asarray(celiu.warp_image(im2, im2, vx, vy))[..., 0]
    assert np.abs(bil[inner] - exact[inner]).max() > 1e-4  # bilinear is not exact


def test_bicubic_warp_zero_flow_identity_and_oob():
    rng = np.random.RandomState(3)
    im1 = jnp.asarray(rng.rand(16, 20, 2).astype(np.float32))
    im2 = jnp.asarray(rng.rand(16, 20, 2).astype(np.float32))
    z = jnp.zeros((16, 20), jnp.float32)
    out = np.asarray(celiu.warp_image_bicubic(im1, im2, z, z))
    np.testing.assert_allclose(out, np.asarray(im2), atol=1e-6)
    # large flow -> out of range everywhere -> im1 fallback
    big = jnp.full((16, 20), 100.0, jnp.float32)
    out2 = np.asarray(celiu.warp_image_bicubic(im1, im2, big, big))
    np.testing.assert_allclose(out2, np.clip(np.asarray(im1), 0, 1), atol=1e-6)


@pytest.mark.slow
def test_gmm_noise_model_flow_and_em():
    """noise_model='gmm' (OpticalFlow.cpp:296-305 + estGaussianMixture
    :764-815) recovers the same known shift as the Lap default, and the EM
    update keeps the mixture parameters sane."""
    rng = np.random.RandomState(4)
    base = rng.rand(80, 96, 1).astype(np.float32)
    base = np.asarray(celiu.gaussian_smooth(jnp.asarray(base), 1.5, 4))
    dx = 2
    im1 = base[:, 4:84]
    im2 = base[:, 4 - dx:84 - dx]
    u, v, _ = celiu.coarse2fine_flow(im1, im2, alpha=0.02, ratio=0.75,
                                     min_width=20, n_outer=5, n_inner=1,
                                     n_sor=40, noise_model="gmm")
    inner_u = np.asarray(u)[12:-12, 12:-12]
    assert abs(np.median(inner_u) - dx) < 0.3, np.median(inner_u)
    # EM unit behavior: near-identical images -> inlier weight dominates
    gm = celiu.gaussian_mixture_init(3)
    f = jnp.asarray(rng.rand(20, 24, 3).astype(np.float32))
    alpha, sigma, beta = celiu.est_gaussian_mixture(f, f + 0.01, gm)
    a, s, b = np.asarray(alpha), np.asarray(sigma), np.asarray(beta)
    assert (a > 0.9).all() and (s < 0.05).all() and np.isfinite(b).all()


@pytest.mark.slow
def test_bicubic_interpolation_option_end_to_end():
    rng = np.random.RandomState(5)
    base = rng.rand(60, 72, 1).astype(np.float32)
    base = np.asarray(celiu.gaussian_smooth(jnp.asarray(base), 1.5, 4))
    im1 = base[:, 4:64]
    im2 = base[:, 2:62]
    u, v, warped = celiu.coarse2fine_flow(im1, im2, alpha=0.02, ratio=0.75,
                                          min_width=20, n_outer=4, n_inner=1,
                                          n_sor=30, interpolation="bicubic")
    inner_u = np.asarray(u)[10:-10, 10:-10]
    assert abs(np.median(inner_u) - 2) < 0.3, np.median(inner_u)


@pytest.mark.parametrize("pair", ["table", "car"])
@pytest.mark.slow
def test_flow_render_vs_bundled_reference_output(pair):
    """Validate the solver against the reference's own bundled renders
    (/root/reference/celiu/output/{table,car}_flow.jpg, produced by
    demoflow.m with alpha=0.012, ratio=0.75, minWidth=20, 7/1/30 on the
    bundled pairs — demoflow.m:3-27): decode each render's Middlebury
    hues back to flow directions and require directional agreement with
    our solve where both are confident. (Pixel-exact comparison is
    meaningless: the bundled JPEG's normalization radius is unknown and
    compression washes out saturation.)"""
    from PIL import Image
    from depth_estimation_tpu.utils.viz import (
        flow_to_color_middlebury, color_to_flow_direction)

    im1 = np.asarray(Image.open(f"/root/reference/celiu/{pair}1.jpg")
                     .resize((320, 180), Image.BICUBIC), np.float32) / 255
    im2 = np.asarray(Image.open(f"/root/reference/celiu/{pair}2.jpg")
                     .resize((320, 180), Image.BICUBIC), np.float32) / 255
    u, v, _ = celiu.coarse2fine_flow(im1, im2, alpha=0.012, ratio=0.75,
                                     min_width=20, n_outer=7, n_inner=1,
                                     n_sor=30)
    u = np.asarray(u)
    v = np.asarray(v)
    # table_flow.jpg is 320x180, car_flow.jpg full-res 640x480 — bring the
    # render to the solve resolution (hue = direction survives resampling)
    ref = np.asarray(Image.open(
        f"/root/reference/celiu/output/{pair}_flow.jpg")
        .resize((320, 180), Image.BILINEAR))
    rx, ry, sat = color_to_flow_direction(ref)

    mag = np.sqrt(u * u + v * v)
    conf = (sat > np.percentile(sat, 75)) & (mag > np.percentile(mag, 50))
    assert conf.sum() > 500
    cos = (u * rx + v * ry)[conf] / np.maximum(mag[conf], 1e-9)
    # directional correlation must be positive (better than random). The
    # bar is deliberately low: the bundled render's provenance is unclear —
    # demoflow.m as shipped (:15-19) reads a local '~/data/sfm/parc'
    # sequence, not table1/table2, so the jpg may come from different
    # frames/params; qualitative comparison in examples/table_flow_vs_
    # reference.png shows our solve resolves MORE scene structure.
    assert cos.mean() > 0.0, cos.mean()

    # round trip of our own colorizer: decode(encode(flow)) preserves
    # direction nearly exactly away from zero flow
    img = flow_to_color_middlebury(u, v)
    dx, dy, s2 = color_to_flow_direction(img)
    sel = mag > np.percentile(mag, 60)
    cos2 = (u * dx + v * dy)[sel] / np.maximum(mag[sel], 1e-9)
    assert cos2.mean() > 0.95, cos2.mean()


@pytest.mark.slow
def test_batched_solver_matches_single():
    """coarse2fine_flow_batched (explicit leading batch dim, no vmap over
    the solver) must reproduce the single-pair solver on every item."""
    rng = np.random.RandomState(11)
    H, W = 36, 48
    pairs = []
    for b in range(3):
        im1 = rng.rand(H, W, 3).astype(np.float32)
        im2 = np.roll(im1, b + 1, axis=1)
        pairs.append((im1, im2))
    kw = dict(alpha=0.02, ratio=0.75, min_width=16,
              n_outer=2, n_inner=1, n_sor=10)
    ub, vb, wb = celiu.coarse2fine_flow_batched(
        jnp.asarray(np.stack([p[0] for p in pairs])),
        jnp.asarray(np.stack([p[1] for p in pairs])), **kw)
    for b, (im1, im2) in enumerate(pairs):
        us, vs, ws = celiu.coarse2fine_flow(
            jnp.asarray(im1), jnp.asarray(im2), **kw)
        np.testing.assert_allclose(np.asarray(ub[b]), np.asarray(us),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(vb[b]), np.asarray(vs),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(wb[b]), np.asarray(ws),
                                   atol=1e-4)


@pytest.mark.slow
def test_batched_solver_matches_single_gmm_bicubic():
    """The two solver switches (GMixture noise model, bicubic warp) must
    also agree between the explicit-batch and single-pair paths."""
    rng = np.random.RandomState(12)
    H, W = 32, 40
    im1 = rng.rand(H, W, 3).astype(np.float32)
    im2 = np.roll(im1, 2, axis=1)
    kw = dict(alpha=0.02, ratio=0.75, min_width=16,
              n_outer=2, n_inner=1, n_sor=8,
              noise_model="gmm", interpolation="bicubic")
    ub, vb, _ = celiu.coarse2fine_flow_batched(
        jnp.asarray(im1[None]), jnp.asarray(im2[None]), **kw)
    us, vs, _ = celiu.coarse2fine_flow(jnp.asarray(im1), jnp.asarray(im2),
                                       **kw)
    np.testing.assert_allclose(np.asarray(ub[0]), np.asarray(us),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(vb[0]), np.asarray(vs),
                               rtol=1e-4, atol=1e-4)


def test_packed_bilinear_matches_four_tap():
    """The packed-tap gather (one edge-padded (H, W, 4C) table, one gather)
    must be value-exact vs the four-tap form for every coordinate class:
    interior, fractional edge, exactly-on-edge, and far out-of-range (the
    celiu solver's warps run packed; everything else runs four-tap —
    see bilinear_sample's docstring for where each form wins)."""
    rng = np.random.RandomState(7)
    for shape in [(7, 9, 3), (2, 7, 9, 5), (13, 17, 1)]:
        img = jnp.asarray(rng.rand(*shape).astype(np.float32))
        H, W = shape[-3], shape[-2]
        lead = shape[:-3]
        x = jnp.asarray(
            (rng.rand(*lead, 20, 30) * (W + 6) - 3).astype(np.float32))
        y = jnp.asarray(
            (rng.rand(*lead, 20, 30) * (H + 6) - 3).astype(np.float32))
        # exact-edge coordinates exercise the dx=0 tap collapse
        x = x.at[..., 0, 0].set(W - 1.0).at[..., 0, 1].set(0.0)
        y = y.at[..., 0, 0].set(H - 1.0).at[..., 0, 1].set(0.0)
        a = celiu.bilinear_sample(img, x, y, packed=False)
        b = celiu.bilinear_sample(img, x, y, packed=True)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
