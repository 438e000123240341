"""Geometry layer tests: lsq_trans analytic recovery (port of
test_lsq_trans / test_motion_correction,
/root/reference/motion_correction.lua:202-275), LK tracking on known shifts,
undistortion identity, essential-matrix ego-motion on synthetic 3D scenes."""

import math

import jax
import jax.numpy as jnp
import numpy as np

from depth_estimation_tpu.geometry3d import calibration, egomotion, undistort
import pytest


def test_lsq_trans_recovers_translation_rotation():
    """Synthetic pan/tilt/roll flow must be recovered exactly (least squares
    on a noiseless linear model)."""
    rng = np.random.RandomState(0)
    n = 50
    pts = rng.rand(n, 2).astype(np.float32) * 200
    wc, hc = 100.0, 100.0
    # ground-truth params: x = (pan, tilt, zoom, roll)
    x_true = np.array([2.0, -1.0, 0.05, 0.02], np.float32)
    pt = pts - [wc, hc]
    f = (x_true[0] * np.array([-1.0, 0.0]) + x_true[1] * np.array([0.0, -1.0])
         + x_true[2] * (-pt) + x_true[3] * np.stack([pt[:, 1], -pt[:, 0]], -1))
    pts_out = pts + f
    H, x = egomotion.lsq_trans(jnp.asarray(pts), jnp.asarray(pts_out), wc, hc)
    np.testing.assert_allclose(np.asarray(x), x_true, atol=1e-4)


def test_lsq_ransac_rejects_outliers():
    rng = np.random.RandomState(1)
    n = 80
    pts = rng.rand(n, 2).astype(np.float32) * 200
    wc = hc = 100.0
    x_true = np.array([3.0, 1.0, 0.0, 0.01], np.float32)
    pt = pts - [wc, hc]
    f = (x_true[0] * np.array([-1.0, 0.0]) + x_true[1] * np.array([0.0, -1.0])
         + x_true[2] * (-pt) + x_true[3] * np.stack([pt[:, 1], -pt[:, 0]], -1))
    pts_out = pts + f
    # corrupt 25% of matches
    k = n // 4
    pts_out[:k] += rng.rand(k, 2) * 50
    H, inliers = egomotion.lsq_trans_ransac(
        jnp.asarray(pts), jnp.asarray(pts_out), wc, hc)
    assert int(inliers) >= n - k - 5


@pytest.mark.slow
def test_track_lk_known_shift():
    rng = np.random.RandomState(2)
    from depth_estimation_tpu.flow.celiu import gaussian_smooth
    base = np.asarray(gaussian_smooth(
        jnp.asarray(rng.rand(100, 120, 1).astype(np.float32)), 1.5, 4))
    dy, dx = 3.0, -2.0
    img1 = base[10:74, 10:90]
    img2 = base[10 - int(dy):74 - int(dy), 10 - int(dx):90 - int(dx)]
    pts, pvalid = egomotion.good_features_to_track(jnp.asarray(img1), 30,
                                                   quality=0.01)
    pts2, status = egomotion.track_lk(img1, img2, pts)
    ok = np.asarray(pvalid & status)
    d = np.asarray(pts2 - pts)[ok]
    assert ok.sum() >= 10
    err = np.abs(d - [dx, dy])
    assert np.median(err[:, 0]) < 0.2, d[:5]
    assert np.median(err[:, 1]) < 0.2, d[:5]


def test_undistort_identity_when_no_distortion():
    rng = np.random.RandomState(3)
    img = rng.rand(48, 64, 3).astype(np.float32)
    cal = calibration.RECTIFIED_GOPRO_SMALL
    out = np.asarray(undistort.undistort_image(
        jnp.asarray(img), cal.K, cal.distortion))
    np.testing.assert_allclose(out, img, atol=1e-5)


def test_remove_ego_motion_identity_rotation():
    rng = np.random.RandomState(4)
    img = rng.rand(40, 50, 1).astype(np.float32)
    out = np.asarray(undistort.remove_ego_motion(
        jnp.asarray(img), calibration.ARDRONE.K, np.eye(3, dtype=np.float32)))
    np.testing.assert_allclose(out, img, atol=1e-5)


def _rot(ax, ay, az):
    cx, sx = math.cos(ax), math.sin(ax)
    cy, sy = math.cos(ay), math.sin(ay)
    cz, sz = math.cos(az), math.sin(az)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (Rx @ Ry @ Rz).astype(np.float32)


@pytest.mark.slow
def test_remove_ego_motion_banded_matches_gather():
    """The banded shift-sum warp must EQUAL the gather warp wherever the
    rotation displacement stays within the band (it is the same bilinear
    tensor product, just summed over static shifts), and zero + mask-
    excluded beyond it."""
    rng = np.random.RandomState(7)
    B, H, W, C = 3, 40, 56, 4
    imgs = jnp.asarray(rng.rand(B, H, W, C).astype(np.float32))
    K = np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]], np.float32)
    # small rotations: displacement well inside band=8
    R = jnp.asarray(np.stack([
        _rot(0.004, -0.006, 0.003),
        _rot(-0.008, 0.005, -0.002),
        np.eye(3, dtype=np.float32)]))
    ref = np.asarray(undistort.remove_ego_motion_batched(imgs, K, R))
    out = np.asarray(undistort.remove_ego_motion_banded(imgs, K, R, band=8))
    np.testing.assert_allclose(out, ref, atol=2e-5)
    # bf16 storage option: f32 weights/accumulation, read-rounding only
    out16 = np.asarray(undistort.remove_ego_motion_banded(
        imgs, K, R, band=8, dtype=jnp.bfloat16))
    assert out16.dtype == np.float32
    np.testing.assert_allclose(out16, ref, atol=6e-3)
    # mask variant agrees with the plain one when nothing exceeds the band
    m0 = np.asarray(undistort.ego_motion_valid_mask(K, R, H, W))
    m1 = np.asarray(undistort.ego_motion_valid_mask(K, R, H, W, band=8))
    np.testing.assert_array_equal(m0, m1)

    # a big yaw: some pixels displace beyond the band -> zero + masked out
    Rbig = jnp.asarray(np.stack([_rot(0.0, 0.08, 0.0)] * B))
    refb = np.asarray(undistort.remove_ego_motion_batched(imgs, K, Rbig))
    outb = np.asarray(undistort.remove_ego_motion_banded(
        imgs, K, Rbig, band=8))
    mb = np.asarray(undistort.ego_motion_valid_mask(K, Rbig, H, W, band=8))
    assert 0 < mb.mean() < 1.0, mb.mean()  # both regimes present
    inb = mb > 0.5
    np.testing.assert_allclose(outb[inb], refb[inb], atol=2e-5)
    np.testing.assert_array_equal(outb[~inb], np.zeros_like(outb[~inb]))


def test_remove_ego_motion_exact_speculative_dispatch():
    """remove_ego_motion_exact keeps the reference's UNCONDITIONAL 4-tap
    warp semantics (depth_estimation_api.lua:147 — no band restriction)
    for any rotation: in-band batches ride the banded kernel and must
    match the gather within float rounding; out-of-band batches fall back
    to the gather itself (same computation — equal within the ~1-ulp
    fusion-rounding drift of compiling it inside lax.cond, measured
    1.2e-7 max here). The speculation predicate
    (warp_in_band) is pinned on both regimes so the fast path provably
    engages."""
    rng = np.random.RandomState(11)
    B, H, W, C = 3, 40, 56, 4
    imgs = jnp.asarray(rng.rand(B, H, W, C).astype(np.float32))
    K = np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]], np.float32)

    Rsmall = jnp.asarray(np.stack([
        _rot(0.004, -0.006, 0.003),
        _rot(-0.008, 0.005, -0.002),
        np.eye(3, dtype=np.float32)]))
    assert bool(undistort.warp_in_band(K, Rsmall, H, W, band=8))
    ref = np.asarray(undistort.remove_ego_motion_batched(imgs, K, Rsmall))
    out = np.asarray(undistort.remove_ego_motion_exact(
        imgs, K, Rsmall, band=8))
    np.testing.assert_allclose(out, ref, atol=2e-5)

    # one big-yaw item poisons the whole batch's coverage -> gather
    # fallback for all items, bit-identical to the non-speculative path
    # (yaw 0.15 rad displaces in-frame pixels ~12 px > band; 0.08 stays
    # covered because its beyond-band pixels are all out-of-frame, which
    # the predicate rightly ignores — both paths mask them to zero)
    Rmix = jnp.asarray(np.stack([
        _rot(0.004, -0.006, 0.003),
        _rot(0.0, 0.15, 0.0),
        np.eye(3, dtype=np.float32)]))
    assert not bool(undistort.warp_in_band(K, Rmix, H, W, band=8))
    refm = np.asarray(undistort.remove_ego_motion_batched(imgs, K, Rmix))
    outm = np.asarray(undistort.remove_ego_motion_exact(
        imgs, K, Rmix, band=8))
    np.testing.assert_allclose(outm, refm, atol=1e-6)

    # the subtle boundary regime: a 0.08-rad yaw displaces its deepest
    # border pixels beyond the band, but every one of those samples lands
    # OUT OF FRAME (both paths mask them to zero), so the predicate must
    # still claim coverage — and the banded output must still equal the
    # gather everywhere, zeros included
    Redge = jnp.asarray(np.stack([
        _rot(0.0, 0.08, 0.0),
        np.eye(3, dtype=np.float32),
        np.eye(3, dtype=np.float32)]))
    assert bool(undistort.warp_in_band(K, Redge, H, W, band=8))
    refe = np.asarray(undistort.remove_ego_motion_batched(imgs, K, Redge))
    oute = np.asarray(undistort.remove_ego_motion_exact(
        imgs, K, Redge, band=8))
    np.testing.assert_allclose(oute, refe, atol=2e-5)


def synthetic_scene(n, R, T, K, seed=0):
    """Random 3D points in front of both cameras, projected to both views."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 3).astype(np.float64)
    X[:, :2] = (X[:, :2] - 0.5) * 4
    X[:, 2] = X[:, 2] * 5 + 3
    x1 = X @ K.T
    p1 = x1[:, :2] / x1[:, 2:3]
    X2 = X @ np.asarray(R).T + np.asarray(T)
    x2 = X2 @ K.T
    p2 = x2[:, :2] / x2[:, 2:3]
    return p1.astype(np.float32), p2.astype(np.float32)


def test_essential_egomotion_synthetic():
    K = np.array([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]], np.float32)
    angle = 0.03
    R = np.array([[math.cos(angle), 0, math.sin(angle)],
                  [0, 1, 0],
                  [-math.sin(angle), 0, math.cos(angle)]], np.float32)
    T = np.array([0.2, 0.05, 1.0], np.float32)
    T_unit = T / np.linalg.norm(T)
    p1, p2 = synthetic_scene(120, R, T, K)
    em = egomotion.get_ego_motion_from_matches(
        jnp.asarray(p1), jnp.asarray(p2), jnp.ones(len(p1), bool), K)
    assert int(em.n_inliers) > 100, int(em.n_inliers)
    # rotation within a fraction of a degree
    Rd = np.asarray(em.R) @ R.T
    ang_err = math.acos(min(1.0, (np.trace(Rd) - 1) / 2))
    assert ang_err < 0.01, ang_err
    # translation direction up to sign
    t = np.asarray(em.T)
    assert min(np.linalg.norm(t - T_unit), np.linalg.norm(t + T_unit)) < 0.05

    # epipole: e2 = K T / T_3
    e = np.asarray(egomotion.epipole(K, T))
    np.testing.assert_allclose(e, [160 + 300 * 0.2, 120 + 300 * 0.05], rtol=1e-5)


def test_sample_patches_matmul_matches_gather():
    """The one-hot matmul patch sampler must reproduce the gather
    formulation bit-closely, including out-of-frame clamping."""
    rng = np.random.RandomState(3)
    img = jnp.asarray(rng.rand(40, 56).astype(np.float32))
    pts = jnp.asarray(np.stack([
        rng.rand(30) * 70 - 8,          # x, some out of frame
        rng.rand(30) * 50 - 6,          # y
    ], axis=-1).astype(np.float32))
    for win in (7, 15):
        a = egomotion._sample_patches(img, pts, win)
        b = egomotion._sample_patches_gather(img, pts, win)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)


def test_essential_fundamental_epipolar_constraint():
    """essential_from_rt / fundamental_from_essential (the sfm2.getEgoMotion2
    fundmat surface): correspondences generated by (R, T) must satisfy the
    epipolar constraint x2^T F x1 = 0 in pixel coordinates."""
    from depth_estimation_tpu.geometry3d.egomotion import (
        essential_from_rt, fundamental_from_essential)
    rng = np.random.RandomState(6)
    th = 0.05
    R = np.array([[np.cos(th), 0, np.sin(th)],
                  [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]], np.float32)
    T = np.array([0.3, 0.1, 1.0], np.float32)
    T = T / np.linalg.norm(T)
    K = np.array([[200.0, 0, 80], [0, 200.0, 60], [0, 0, 1]], np.float32)
    # random 3-D points in front of both cameras
    P = rng.rand(50, 3).astype(np.float32) * [4, 3, 2] + [-2, -1.5, 4]
    x1h = P @ K.T
    x1 = x1h[:, :2] / x1h[:, 2:3]
    P2 = P @ R.T + T
    x2h = P2 @ K.T
    x2 = x2h[:, :2] / x2h[:, 2:3]
    E = np.asarray(essential_from_rt(R, T))
    F = np.asarray(fundamental_from_essential(E, K))
    ones = np.ones((50, 1), np.float32)
    resid = np.einsum("ni,ij,nj->n", np.hstack([x2, ones]), F,
                      np.hstack([x1, ones]))
    # scale-normalized residual
    resid = resid / (np.abs(F).max() * 200)
    assert np.abs(resid).max() < 1e-3, np.abs(resid).max()


@pytest.mark.slow
def test_track_lk_windowed_agrees_with_full():
    """The window-cached LK (track_lk_windowed — per-level integer-aligned
    search windows, tiny per-iteration matmuls) must recover the same
    tracks as the full-image track_lk."""
    rng = np.random.RandomState(5)
    from depth_estimation_tpu.flow.celiu import gaussian_smooth
    base = np.asarray(gaussian_smooth(
        jnp.asarray(rng.rand(110, 130, 1).astype(np.float32)), 1.5, 4))
    dy, dx = 4.0, -3.0
    img1 = base[10:74, 10:90]
    img2 = base[10 - int(dy):74 - int(dy), 10 - int(dx):90 - int(dx)]
    pts, pvalid = egomotion.good_features_to_track(jnp.asarray(img1), 40,
                                                   quality=0.01)
    p_full, s_full = egomotion.track_lk(img1, img2, pts)
    p_win, s_win = egomotion.track_lk_windowed(img1, img2, pts)
    ok = np.asarray(pvalid & s_full & s_win)
    assert ok.sum() >= 10
    diff = np.abs(np.asarray(p_full - p_win))[ok]
    # identical math while the motion stays inside the window: sub-0.05 px
    assert np.median(diff) < 0.05, diff.max(0)
    # and both recover the true shift
    d = np.asarray(p_win - pts)[ok]
    err = np.abs(d - [dx, dy])
    assert np.median(err[:, 0]) < 0.2
    assert np.median(err[:, 1]) < 0.2


def test_grid_selector_finds_planted_corners():
    """selector='grid' must return the planted corners: bright 2x2 blobs on
    a dark background, one per region, each the only peak in its cell."""
    H, W = 64, 64
    img = np.zeros((H, W, 3), np.float32)
    planted = [(10, 12), (10, 44), (30, 20), (30, 52), (50, 8), (50, 36)]
    for (y, x) in planted:
        img[y:y + 2, x:x + 2] = 1.0
    pts, valid = egomotion.good_features_to_track(
        jnp.asarray(img), 16, quality=0.01, selector="grid")
    got = np.asarray(pts)[np.asarray(valid)]
    for (y, x) in planted:
        d = np.abs(got - [x, y]).max(axis=1).min()
        assert d <= 2.0, ((y, x), got)


def test_grid_dims_never_degenerate():
    """Point budgets with no divisor near the aspect target (primes etc.)
    must fall back to a near-square >=budget grid, not 1xN strips."""
    for n in (401, 397, 2 * 199, 64, 400, 100):
        gh, gw = egomotion._grid_dims(n, 180, 320)
        assert gh * gw >= n
        target = (n * 180 / 320) ** 0.5
        assert target / 2 <= gh <= target * 2, (n, gh, gw)


@pytest.mark.slow
def test_grid_selector_batched_matches_single():
    rng = np.random.RandomState(7)
    from test_batched_pipeline import _texture
    imgs = np.stack([_texture(rng, 48, 64) for _ in range(3)])
    pb, vb = egomotion.good_features_to_track_batched(
        jnp.asarray(imgs), 32, 0.01, selector="grid")
    for i in range(3):
        ps, vs = egomotion.good_features_to_track(
            jnp.asarray(imgs[i]), 32, 0.01, selector="grid")
        np.testing.assert_array_equal(np.asarray(vb[i]), np.asarray(vs))
        np.testing.assert_allclose(np.asarray(pb[i]), np.asarray(ps))
