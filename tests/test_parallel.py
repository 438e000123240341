"""Mesh parallelism tests on the 8-device virtual CPU mesh: dp-sharded
training/inference and the spatial (halo-exchange) frame sharding — the
sharded result must equal the unsharded computation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from depth_estimation_tpu.geometry import Geometry, Learning
from depth_estimation_tpu.models.flow import FlowModel, crop_features_center
from depth_estimation_tpu.ops import matching
from depth_estimation_tpu.parallel import mesh as pmesh
from depth_estimation_tpu.training import train as training


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, jax.devices()
    return pmesh.make_mesh(jax.devices(), axis="sp")


def test_spatial_halo_sharding_matches_unsharded(mesh8):
    g = Geometry(hImg=64, wImg=48, layers=((3, 5, 5, 6),), maxh=4, maxw=4)
    model = FlowModel(g)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    H = 64  # 8 devices x 8 rows
    img1 = jnp.asarray(rng.rand(H, 48, 3), jnp.float32)
    img2 = jnp.asarray(rng.rand(H, 48, 3), jnp.float32)

    fn = pmesh.spatial_sharded_flow_fn(model, mesh8, axis="sp")
    idx_s, ey_s, ex_s, pm_s = fn(params, img1, img2)

    # unsharded equivalent: zero-pad the bottom by the halo and run whole
    halo = (g.maxh - 1) + (g.hKernel - 1)
    p1 = jnp.pad(img1, ((0, halo), (0, 0), (0, 0)))
    p2 = jnp.pad(img2, ((0, halo), (0, 0), (0, 0)))
    f1 = crop_features_center(g, model.features(params, p1))
    f2 = model.features(params, p2)
    idx_u, ey_u, ex_u, pm_u = matching.match_flow_fused(
        f1, f2, g.maxh, g.maxw)

    np.testing.assert_array_equal(np.asarray(idx_s)[:H],
                                  np.asarray(idx_u)[:H])
    np.testing.assert_allclose(np.asarray(ey_s)[:H], np.asarray(ey_u)[:H],
                               atol=1e-5)


def test_dp_training_step_matches_single_device(mesh8):
    g = Geometry(hImg=32, wImg=32, layers=((3, 5, 5, 6),), maxh=4, maxw=4)
    lrn = Learning(rate=1e-2, batch_size=16, criterion="nll")
    model = FlowModel(g)
    trainer = training.Trainer(model, lrn)
    state = trainer.init(jax.random.PRNGKey(1))

    rng = np.random.RandomState(1)
    B = 16
    p1 = jnp.asarray(rng.rand(B, g.hPatch2, g.wPatch2, 3), jnp.float32)
    p2 = jnp.asarray(rng.rand(B, g.hPatch2, g.wPatch2, 3), jnp.float32)
    it = jnp.asarray(rng.randint(0, 16, B), jnp.int32)
    st = jnp.zeros((B, 16), jnp.float32)

    # single-device result
    s1, aux1 = trainer._step(state, p1, p2, it, st)

    # dp-sharded result
    dp = pmesh.make_mesh(jax.devices(), axis="dp")
    step = pmesh.sharded_train_step(trainer, dp)
    state0 = pmesh.replicate(state, dp)
    b1, b2, bit, bst = pmesh.shard_batch((p1, p2, it, st), dp)
    s2, aux2 = step(state0, b1, b2, bit, bst)

    np.testing.assert_allclose(float(aux1["loss"]), float(aux2["loss"]),
                               rtol=1e-5)
    for a, b in zip(jax.tree.leaves(s1.params), jax.tree.leaves(s2.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_dp_sharded_inference_matches_single_device(mesh8):
    g = Geometry(hImg=40, wImg=40, layers=((3, 5, 5, 6),), maxh=4, maxw=4)
    model = FlowModel(g)
    params = model.init(jax.random.PRNGKey(2))
    rng = np.random.RandomState(2)
    B = 16
    img1 = jnp.asarray(rng.rand(B, 40, 40, 3), jnp.float32)
    img2 = jnp.asarray(rng.rand(B, 40, 40, 3), jnp.float32)

    dp = pmesh.make_mesh(jax.devices(), axis="dp")
    fn = pmesh.sharded_flow_fn(model, dp, axis="dp")
    i_s, ey_s, ex_s, pm_s = fn(params, *pmesh.shard_batch((img1, img2), dp))

    i_u, ey_u, ex_u, pm_u = model.forward_fused(params, img1, img2)
    np.testing.assert_array_equal(np.asarray(i_s), np.asarray(i_u))
    np.testing.assert_allclose(np.asarray(ey_s), np.asarray(ey_u), atol=1e-5)


def test_pad_to_multiple_for_sharding(mesh8):
    """pad_to_multiple prepares ragged batches for the dp mesh (static
    shard shapes); the valid count round-trips."""
    from depth_estimation_tpu.parallel.mesh import pad_to_multiple, shard_batch
    x = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    xp, n = pad_to_multiple(x, 8)
    assert n == 10 and xp.shape[0] == 16
    np.testing.assert_array_equal(xp[:10], x)
    np.testing.assert_array_equal(xp[10:], np.repeat(x[-1:], 6, axis=0))
    sharded = shard_batch(jnp.asarray(xp), mesh8, axis="sp")
    assert sharded.shape == (16, 3)


@pytest.mark.parametrize("share_filters", [True, False])
def test_spatial_sharded_multiscale_matches_unsharded(share_filters):
    """Row-sharded multiscale forward (two-sided halo exchange) must equal
    forward_full exactly — the halos make every device's pyramid slice
    identical to the corresponding rows of the unsharded computation.
    Covers both filter layouts: the shared trunk and the per-scale
    (share_filters=False) parameter tree."""
    from depth_estimation_tpu.models.multiscale import MultiscaleFlowModel

    g = Geometry(hImg=64, wImg=48, layers=((3, 5, 5, 6),), maxh=4, maxw=4,
                 multiscale=True, ratios=(1, 2, 4),
                 share_filters=share_filters)
    model = MultiscaleFlowModel(g)
    params = model.init(jax.random.PRNGKey(2))
    rng = np.random.RandomState(2)
    img1 = jnp.asarray(rng.rand(64, 48, 3), jnp.float32)
    img2 = jnp.asarray(rng.rand(64, 48, 3), jnp.float32)

    # 2-device sub-mesh: 64 rows = 2 x 32, and 32 % rmax == 0
    mesh2 = pmesh.make_mesh(jax.devices()[:2], axis="sp")
    fn = pmesh.spatial_sharded_multiscale_fn(model, mesh2, axis="sp")
    out_s = np.asarray(fn(params, img1, img2))

    out_u = np.asarray(model.forward_full(params, img1, img2))
    np.testing.assert_allclose(out_s, out_u, rtol=1e-5, atol=1e-6)


def test_spatial_sharded_radial_matches_unsharded(mesh8):
    """Row-sharded radial matcher: equals the unsharded flow() on a
    bottom-zero-padded polar pair (same convention as the single-scale
    halo sharding)."""
    from depth_estimation_tpu.models.radial import RadialFlowNetwork

    net = RadialFlowNetwork(
        layers=((3, 5, 5, 6), "tanh"), h_win=4)
    params = net.init(jax.random.PRNGKey(3), 32, 32)
    rng = np.random.RandomState(3)
    H, W = 64, 32    # 8 devices x 8 rows
    p1 = jnp.asarray(rng.rand(H, W, 3), jnp.float32)
    p2 = jnp.asarray(rng.rand(H, W, 3), jnp.float32)

    fn = pmesh.spatial_sharded_radial_fn(net, mesh8, axis="sp")
    flow_s, cost_s = fn(params, p1, p2)

    halo = (net.h_kernel - 1) + (net.h_win - 1)
    pp1 = jnp.pad(p1, ((0, halo), (0, 0), (0, 0)))
    pp2 = jnp.pad(p2, ((0, halo), (0, 0), (0, 0)))
    fp = net.filter.apply(params, pp1)[:H]
    fc = net.filter.apply(params, pp2)[:H + net.h_win - 1]
    from depth_estimation_tpu.ops import matching as m
    costs = m.match_ssd_radial(fp, fc, net.h_win)
    flow_u = np.asarray(jnp.argmin(costs, -1))
    cost_u = np.asarray(jnp.min(costs, -1))

    np.testing.assert_array_equal(np.asarray(flow_s), flow_u)
    np.testing.assert_allclose(np.asarray(cost_s), cost_u, atol=1e-5)


@pytest.mark.slow
def test_dp_sharded_full_pipeline_matches_unsharded(mesh8):
    """The COMPLETE per-frame online program (prep -> ego-motion ->
    compensation -> fused match -> masks -> depth), dp-sharded over the
    mesh via BatchedDepthEstimator.shard: stream state lives sharded
    between steps and every output must match the unsharded step bitwise
    (ego RANSAC uses one shared key, so results are independent of how
    the batch is sliced)."""
    import dataclasses
    from depth_estimation_tpu import api_batched as api
    from depth_estimation_tpu.geometry3d import calibration as calmod

    rng = np.random.RandomState(11)
    h, w = 48, 64
    cal = dataclasses.replace(
        calmod.RECTIFIED_GOPRO_SMALL, name="tp", wImg=w, hImg=h,
        fx=60.0, fy=60.0, cx=w / 2, cy=h / 2,
        sfm=dataclasses.replace(calmod.RECTIFIED_GOPRO_SMALL.sfm,
                                max_points=64))
    g = Geometry(hImg=h, wImg=w, layers=((3, 5, 5, 6),), maxh=4, maxw=4)
    model = FlowModel(g)
    params = model.init(jax.random.PRNGKey(1))

    B = 8
    base = rng.rand(B, h // 4, w // 4).astype(np.float32)
    f1 = np.asarray(jax.image.resize(jnp.asarray(base), (B, h, w),
                                     "bilinear"))
    f1 = np.repeat(f1[..., None], 3, axis=-1)
    f2 = np.roll(f1, -1, axis=2)
    frames1 = jnp.asarray(f1)
    frames2 = jnp.asarray(f2)

    ref = api.BatchedDepthEstimator(g, params, cal)
    ref.reset(frames1)
    out_ref = [np.asarray(a) for a in ref.next_frames(frames2)]

    m = pmesh.make_mesh(jax.devices(), axis="dp")
    sh = api.BatchedDepthEstimator(g, params, cal).shard(m)
    sh.reset(frames1)
    out_sh = [np.asarray(a) for a in sh.next_frames(frames2)]

    for a, b in zip(out_ref, out_sh):
        np.testing.assert_array_equal(a, b)


def _assert_bitwise_per_chunk(got, single_fn, prevs, imgs, n_dev):
    """The dp-sharded offline builds' equivalence contract (round-3 verdict
    item 3, the 'per-pair bitwise' branch): shard_map traces the body at
    the LOCAL batch shape, so each device's chunk must be BITWISE equal to
    a single-device run of the same program on that chunk. (GSPMD
    jit(in_shardings=...) would instead partition the global program and
    reorder dot products by a few ulp — which the ego-motion RANSAC's
    inlier knife edge `d < 1e-3` amplifies into wholesale divergence; see
    parallel/mesh.py _dp_shard_map.)"""
    B = np.asarray(prevs).shape[0]
    loc = B // n_dev
    for d in range(n_dev):
        s = slice(d * loc, (d + 1) * loc)
        want = single_fn(jnp.asarray(prevs[s]), jnp.asarray(imgs[s]))
        for i, (g_, w_) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(
                np.asarray(g_)[s], np.asarray(w_),
                err_msg=f"device chunk {d}, output {i}")


@pytest.mark.slow
def test_dp_sharded_celiu_gt_matches_single_device(mesh8):
    """sharded_celiu_fn (round-3 verdict item 3): celiu GT over a dp-split
    pair batch must be bitwise equal, per device chunk, to the
    single-device explicit-batch solver at the local batch shape."""
    from depth_estimation_tpu.flow import celiu

    rng = np.random.RandomState(0)
    B, H, W = 8, 32, 40
    base = rng.rand(B, H, W, 1).astype(np.float32)
    im1 = np.asarray(celiu.gaussian_smooth(jnp.asarray(base), 0.8, 2))
    im2 = np.roll(im1, 1, axis=2)

    kw = dict(alpha=0.01, ratio=0.75, min_width=16,
              n_outer=2, n_inner=1, n_sor=10)

    dp = pmesh.make_mesh(jax.devices(), axis="dp")
    fn = pmesh.sharded_celiu_fn(dp, **kw)
    a, b = pmesh.shard_batch((jnp.asarray(im1), jnp.asarray(im2)), dp)
    got = fn(a, b)

    single = jax.jit(lambda x, y: celiu.coarse2fine_flow_batched(
        x, y, **kw))
    _assert_bitwise_per_chunk(got, single, im1, im2, len(jax.devices()))


def _smooth_shift_pairs(B, H, W, dx=2, seed=1):
    """B (prev, img) pairs: sliding crops of one gaussian-smoothed texture —
    clean dx-px translations with NO wrap seam (the test_datasets.py
    make_sequence fixture). np.roll fixtures put the ego-motion RANSAC on a
    knife edge (the wrap column is a hard-outlier band and the translation
    is unrepresentable by the rotation-only model): 1-device vs 8-device
    compilation ulp drift then flips inlier sets and the fitted R wholesale."""
    from depth_estimation_tpu.flow.celiu import gaussian_smooth
    rng = np.random.RandomState(seed)
    big = np.asarray(gaussian_smooth(
        jnp.asarray(rng.rand(H + 8, W + 8 + B * dx, 3).astype(np.float32)),
        1.0, 3))
    frames = np.stack([big[4:4 + H, 4 + i * dx:4 + W + i * dx]
                       for i in range(B + 1)])
    return frames[:-1], frames[1:]


def _zoom_chain_pairs(B, H, W, s_top=1.05, s_bottom=1.10, seed=2):
    """B (prev, img) pairs from a TWO-PLANE center-zoom chain: each frame is
    the previous one resampled by a zoom about the image center with a
    different scale above/below the centerline (the test_datasets.py
    units-test fixture). Forward/zoom motion puts the epipole AT the image
    center — well-conditioned for the radial pipeline (a lateral shift puts
    it at infinity and the polar projection degenerates) — and the two
    depth planes break the planar-homography degeneracy (a single-plane
    zoom leaves the fundamental matrix, hence the epipole, unconstrained)."""
    from depth_estimation_tpu.flow.celiu import bilinear_sample, gaussian_smooth
    rng = np.random.RandomState(seed)
    base = np.asarray(gaussian_smooth(
        jnp.asarray(rng.rand(H, W, 3).astype(np.float32)), 0.8, 2))
    base = np.clip(base * 1.5, 0, 1).astype(np.float32)
    cy, cx = H / 2, W / 2
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    s = np.where(yy < cy, s_top, s_bottom).astype(np.float32)
    xs = jnp.asarray(cx + (xx - cx) / s)
    ys = jnp.asarray(cy + (yy - cy) / s)
    frames = [base]
    for _ in range(B):
        frames.append(np.asarray(bilinear_sample(
            jnp.asarray(frames[-1]), xs, ys)))
    frames = np.stack(frames)
    return frames[:-1], frames[1:]


@pytest.mark.slow
def test_dp_sharded_rectify_build_matches_single_device(mesh8):
    """sharded_rectify_fn: the dp-split rectification dataset build must be
    bitwise equal, per device chunk, to the single-device fused program
    (undistort -> LK ego-motion -> RANSAC -> rotation warp) at the local
    batch shape."""
    import dataclasses
    from depth_estimation_tpu.data import datasets as ds
    from depth_estimation_tpu.geometry3d import calibration as calmod

    H, W = 48, 64
    cal = dataclasses.replace(
        calmod.RECTIFIED_GOPRO_SMALL, name="dpr", wImg=W, hImg=H,
        fx=60.0, fy=60.0, cx=W / 2, cy=H / 2,
        sfm=dataclasses.replace(calmod.RECTIFIED_GOPRO_SMALL.sfm,
                                max_points=64))
    prevs, imgs = _smooth_shift_pairs(8, H, W, seed=1)

    dp = pmesh.make_mesh(jax.devices(), axis="dp")
    fn = pmesh.sharded_rectify_fn(dp, cal, H, W)
    a, b = pmesh.shard_batch((jnp.asarray(prevs), jnp.asarray(imgs)), dp)
    got = fn(a, b)

    single = jax.jit(lambda p, i: ds._rectify_batch_device(
        p, i, cal.K, tuple(cal.distortion), H, W,
        cal.sfm.max_points, cal.sfm.points_quality))
    _assert_bitwise_per_chunk(got, single, prevs, imgs, len(jax.devices()))


def test_dp_sharded_polar_build_matches_single_device(mesh8):
    """sharded_polar_load_fn: the dp-split polar dataset build must be
    bitwise equal, per device chunk, to the single-device fused program
    (ego-motion -> epipole -> rotation removal -> polar warps) at the
    local batch shape. Center-zoom two-plane fixture so the epipole is
    well-conditioned and the full polar path is exercised with real
    geometry — see _zoom_chain_pairs."""
    import dataclasses
    from depth_estimation_tpu.data import datasets as ds
    from depth_estimation_tpu.geometry3d import calibration as calmod

    H, W = 48, 64
    cal = dataclasses.replace(
        calmod.RECTIFIED_GOPRO_SMALL, name="dpp", wImg=W, hImg=H,
        fx=60.0, fy=60.0, cx=W / 2, cy=H / 2,
        sfm=dataclasses.replace(calmod.RECTIFIED_GOPRO_SMALL.sfm,
                                max_points=64))
    prevs, imgs = _zoom_chain_pairs(8, H, W, seed=2)

    hi = wi = 32
    wk = 5
    dp = pmesh.make_mesh(jax.devices(), axis="dp")
    fn = pmesh.sharded_polar_load_fn(dp, cal, H, W, hi, wi, wk)
    a, b = pmesh.shard_batch((jnp.asarray(prevs), jnp.asarray(imgs)), dp)
    got = fn(a, b)

    single = jax.jit(lambda p, i: ds._polar_batch_device(
        p, i, cal.K, cal.wImg, cal.hImg, H, W, hi, wi, wk,
        cal.sfm.max_points, cal.sfm.points_quality))
    _assert_bitwise_per_chunk(got, single, prevs, imgs, len(jax.devices()))
