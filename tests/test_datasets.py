"""Dataset pipeline + version2 tests: SFM-rectified pair loading on a
synthetic rotating/translating sequence, the v2 lazy dataset object over a
real file tree, radial GT projection math, and the v2 network with
contrastive normalization."""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from depth_estimation_tpu.data import datasets, groundtruth
from depth_estimation_tpu.geometry import Geometry
from depth_estimation_tpu.geometry3d import calibration
from depth_estimation_tpu.models.version2 import V2Network, V2Params
from depth_estimation_tpu.ops.normalization import (
    gaussian1d, spatial_contrastive_normalization)


def small_cal(h, w):
    return dataclasses.replace(
        calibration.RECTIFIED_GOPRO_SMALL, wImg=w, hImg=h,
        fx=120.0, fy=120.0, cx=w / 2, cy=h / 2)


def make_sequence(tmp_path, n=4, h=64, w=80, dx=2, seed=0):
    from depth_estimation_tpu.flow.celiu import gaussian_smooth
    rng = np.random.RandomState(seed)
    big = np.asarray(gaussian_smooth(
        jnp.asarray(rng.rand(h + 30, w + 30, 3).astype(np.float32)), 1.0, 3))
    d = tmp_path / "seq" / "images"
    os.makedirs(d)
    from PIL import Image
    for i in range(n):
        im = big[10:10 + h, 10 + i * dx:10 + w + i * dx]
        Image.fromarray((im * 255).astype(np.uint8)).save(d / f"{i:09d}.png")
    return str(tmp_path / "seq")


def test_project_groundtruth_radial():
    H, W = 40, 50
    e2 = (25.0, 20.0)
    # purely radial outward flow of magnitude 3 everywhere
    ys = np.arange(H, dtype=np.float32)[:, None] - e2[1]
    xs = np.arange(W, dtype=np.float32)[None, :] - e2[0]
    n = np.sqrt(np.broadcast_to(ys, (H, W)) ** 2
                + np.broadcast_to(xs, (H, W)) ** 2) + 1e-9
    flow = np.stack([3 * ys / n * np.ones((1, W)), 3 * xs / n * np.ones((H, 1))])
    flow = np.stack([3 * np.broadcast_to(ys, (H, W)) / n,
                     3 * np.broadcast_to(xs, (H, W)) / n])
    gds = np.ones((H, W), np.float32)
    proj, gds2 = datasets.project_groundtruth(flow, gds, e2)
    ok = np.ones((H, W), bool)
    ok[int(e2[1]), int(e2[0])] = False   # undefined at the epipole itself
    assert (proj[ok] == 3).all()
    assert gds2[ok].all()
    # inward flow is rejected (projection < 0)
    proj2, gds3 = datasets.project_groundtruth(-flow, gds, e2)
    assert not gds3[ok].any()


def test_saturate_groundtruth():
    f = np.asarray([1.0, 5.0, 12.0], np.float32)
    g = np.ones(3, np.float32)
    f2, g2 = datasets.saturate_groundtruth(f, g, 10.0)
    np.testing.assert_array_equal(f2, [1, 5, 10])
    np.testing.assert_array_equal(g2, [1, 1, 0])


def test_smooth_epipole():
    e = datasets.smooth_epipole(None, np.array([10.0, 10.0]), 100, 100)
    np.testing.assert_array_equal(e, [10, 10])
    e2 = datasets.smooth_epipole(np.array([10.0, 10.0]),
                                 np.array([20.0, 30.0]), 100, 100)
    np.testing.assert_array_equal(e2, [15, 20])
    # out of frame falls back
    e3 = datasets.smooth_epipole(np.array([10.0, 10.0]),
                                 np.array([500.0, 0.0]), 100, 100)
    np.testing.assert_array_equal(e3, [10, 10])


def test_flow_dataset_lazy(tmp_path):
    g = Geometry(hImg=64, wImg=80, layers=((3, 5, 5, 8),),
                 maxh=6, maxw=6, maxhGT=6, maxwGT=6,
                 hKernelGT=5, wKernelGT=5)
    cal = small_cal(64, 80)
    root = make_sequence(tmp_path)
    ds = datasets.FlowDataset(g, cal, root, cache_root=str(tmp_path / "cache"))
    assert len(ds) == 4
    img = ds.get_image(1)
    assert img.shape == (64, 80, 3)
    prev = ds.get_prev_image(1)
    assert prev.shape == (64, 80, 3)
    gt = ds.get_gt(1)
    assert gt is not None and gt.shape == (2, 64, 80)
    # camera pans right by 2 px/frame: after rotation compensation the
    # remaining GT x-flow should be concentrated near a constant
    mask = ds.get_mask(1)
    sel = (mask > 0.5) & (np.abs(gt[1]) > 0)
    # lazy caches: second access is the same object
    assert ds.get_image(1) is img
    # patch sampling end-to-end
    patches = ds.get_patches(8, np.random.RandomState(0))
    assert len(patches) == 8


def test_gaussian1d_matches_torch_shape():
    g = gaussian1d(17)
    assert g.shape == (17,)
    assert abs(g[8] - 1.0) < 1e-6       # amplitude 1 at center
    assert g[0] < g[8]


def test_contrastive_normalization_properties():
    rng = np.random.RandomState(0)
    img = rng.rand(40, 48, 3).astype(np.float32) * 3 + 2
    out = np.asarray(spatial_contrastive_normalization(jnp.asarray(img), 9))
    assert out.shape == img.shape
    # local mean removed: interior mean near zero
    assert abs(out[10:-10, 10:-10].mean()) < 0.2
    # scale-invariance-ish: doubling input contrast barely changes output
    out2 = np.asarray(spatial_contrastive_normalization(
        jnp.asarray(img * 2), 9))
    np.testing.assert_allclose(out[10:-10, 10:-10], out2[10:-10, 10:-10],
                               atol=0.2)


def test_v2_network_forward_and_shift():
    datap = V2Params(wImg=60, hImg=48, normalization_k=5,
                     layers=((3, 5, 5, 8),), hWin=5, wWin=5)
    net = V2Network(datap)
    params = net.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    img2 = rng.rand(48, 60, 3).astype(np.float32)
    img1 = np.roll(img2, -1, axis=0)   # dy = +1
    logp = net.log_scores(params, jnp.asarray(img1), jnp.asarray(img2))
    D = datap.hWin * datap.wWin
    assert logp.shape[-1] == D
    from depth_estimation_tpu import codecs
    g = net.geometry
    idx = np.asarray(jnp.argmax(logp, axis=-1))
    dy, dx = codecs.decode(g, idx)
    inner = np.asarray(dy)[8:-8, 8:-8]
    assert (inner == 1).mean() > 0.9, np.unique(inner, return_counts=True)


@pytest.mark.slow
def test_liu_gt_cache(tmp_path):
    g = Geometry(hImg=40, wImg=48)
    rng = np.random.RandomState(2)
    from depth_estimation_tpu.flow.celiu import gaussian_smooth
    im = np.asarray(gaussian_smooth(
        jnp.asarray(rng.rand(40, 48, 1).astype(np.float32)), 1.5, 4))
    fy, fx = groundtruth.cached_liu_flow(str(tmp_path), g, 1, "f0", im, im,
                                         min_width=20)
    assert np.abs(fy).max() < 0.05
    fy2, fx2 = groundtruth.cached_liu_flow(str(tmp_path), g, 1, "f0",
                                           im + 1, im, min_width=20)
    np.testing.assert_array_equal(fy, fy2)   # cache hit


def test_scale_np_matches_device_scale():
    """The host-side resize must reproduce jax.image.resize bilinear
    (antialiased) closely — it feeds the same model."""
    import jax.numpy as jnp
    from depth_estimation_tpu.data.images import scale, scale_np

    rng = np.random.RandomState(2)
    img = rng.rand(48, 64, 3).astype(np.float32)
    a = np.asarray(scale(jnp.asarray(img), 18, 32))
    b = scale_np(img, 18, 32)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    # uint8 path stays close after quantization
    u8 = (img * 255).astype(np.uint8)
    b8 = scale_np(u8, 18, 32)
    a8 = np.asarray(scale(jnp.asarray(u8.astype(np.float32)), 18, 32))
    assert np.abs(b8.astype(np.float32) - a8).max() <= 1.0


def test_scale_batched_device_matches_resize():
    """The device-side separable-matmul resize (used by bench.py and the
    batched pipeline) must reproduce jax.image.resize bilinear."""
    import jax
    import jax.numpy as jnp
    from depth_estimation_tpu.data.images import scale_batched_device

    rng = np.random.RandomState(3)
    frames = rng.rand(4, 48, 64, 3).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(frames), (4, 18, 32, 3),
                           method="bilinear")
    out = scale_batched_device(jnp.asarray(frames), 18, 32)
    np.testing.assert_allclose(np.asarray(ref), np.asarray(out),
                               rtol=1e-4, atol=1e-4)
    # identity early-out keeps the tensor untouched
    same = scale_batched_device(jnp.asarray(frames), 48, 64)
    np.testing.assert_array_equal(np.asarray(same), frames)


@pytest.mark.slow
def test_load_mc_pair_recovers_affine_motion():
    """The -mc backend (load_mc_pair) must align a previous frame related to
    the current one by an in-plane rotation + translation — exactly the
    4-DoF model of motion_correction.lua."""
    from depth_estimation_tpu.flow.celiu import gaussian_smooth
    from depth_estimation_tpu.geometry3d.egomotion import warp_affine

    h, w = 96, 128
    rng = np.random.RandomState(3)
    cur = np.asarray(gaussian_smooth(
        jnp.asarray(rng.rand(h, w, 3).astype(np.float32)), 1.0, 3))
    # prev(p) = cur(H_pc p): rotate 0.02 rad about the center + shift
    th = 0.02
    c, s = math.cos(th), math.sin(th)
    cx, cy = w / 2, h / 2
    H_pc = np.array([
        [c, -s, cx - c * cx + s * cy + 2.0],
        [s, c, cy - s * cx - c * cy - 1.0],
    ], np.float32)
    prev = np.asarray(warp_affine(jnp.asarray(cur), jnp.asarray(H_pc)))

    g = Geometry(hImg=h, wImg=w, layers=((3, 5, 5, 8),),
                 maxh=6, maxw=6, maxhGT=6, maxwGT=6,
                 hKernelGT=5, wKernelGT=5)
    cal = small_cal(h, w)
    pair = datasets.load_mc_pair(g, cal, prev, cur, compute_gt=False)
    assert pair.good
    inner = np.s_[12:-12, 12:-12]
    m = pair.mask[inner] > 0.5
    err_warped = np.abs(pair.prev_warped[inner] - pair.image[inner])[m].mean()
    err_raw = np.abs(prev[inner] - cur[inner])[m].mean()
    assert err_warped < 0.25 * err_raw, (err_warped, err_raw)
    assert err_warped < 0.02


def test_load_plain_pair_and_backend_dispatch(tmp_path):
    g = Geometry(hImg=64, wImg=80, layers=((3, 5, 5, 8),),
                 maxh=6, maxw=6, maxhGT=6, maxwGT=6,
                 hKernelGT=5, wKernelGT=5)
    cal = small_cal(64, 80)
    root = make_sequence(tmp_path, n=3)
    raw = datasets.load_data_optical_flow(g, cal, root, 3,
                                          motion_correction=None)
    assert len(raw["flow"]) == 2 and raw["flow"][0] is not None
    # plain pairs: masks are all-ones, images are the raw scaled frames
    assert all(m.min() == 1.0 for m in raw["masks"])
    # pure 2 px/frame pan (crop window moves right -> scene shifts left):
    # uncorrected GT x-flow is exactly -2 everywhere in the interior
    f = raw["flow"][0]
    inner = f[1][20:-20, 20:-20]
    assert (inner == -2.0).all()


def test_yuyv_to_rgb_conversion():
    """BT.601 YUYV -> RGB: gray (U=V=128) maps to r=g=b=Y/255; a pure-red
    sample round-trips within quantization error."""
    from depth_estimation_tpu.data.v4l2 import yuyv_to_rgb
    h, w = 2, 4
    # all-gray Y=128
    raw = np.tile(np.array([128, 128, 128, 128], np.uint8), h * w // 2)
    rgb = yuyv_to_rgb(raw, h, w)
    np.testing.assert_allclose(rgb, 128 / 255.0, atol=1e-3)
    assert rgb.shape == (h, w, 3)
    # encode pure red (255,0,0): Y=76.245, U=84.972, V=255 (clamped) —
    # use the forward BT.601 to build the sample
    r, g, b = 255.0, 0.0, 0.0
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = (b - y) / 1.772 + 128
    v = (r - y) / 1.402 + 128
    raw = np.tile(np.array([y, u, y, v], np.uint8), h * w // 2)
    rgb = yuyv_to_rgb(raw, h, w)
    assert rgb[0, 0, 0] > 0.95 and rgb[0, 0, 1] < 0.05 and rgb[0, 0, 2] < 0.05


def test_v4l2_ioctl_codes_and_struct_sizes():
    """The ioctl codes embed sizeof(struct); pin the 64-bit UAPI layouts
    (videodev2.h): sizeof(v4l2_format)=208, v4l2_buffer=88,
    v4l2_requestbuffers=20."""
    import ctypes
    from depth_estimation_tpu.data import v4l2
    assert ctypes.sizeof(v4l2.v4l2_format) == 208
    assert ctypes.sizeof(v4l2.v4l2_buffer) == 88
    assert ctypes.sizeof(v4l2.v4l2_requestbuffers) == 20
    assert v4l2.VIDIOC_S_FMT == 0xC0D05605
    assert v4l2.VIDIOC_QUERYBUF == 0xC0585609
    assert v4l2.VIDIOC_REQBUFS == 0xC0145608
    assert v4l2.VIDIOC_STREAMON == 0x40045612


def test_image_camera_queue_and_crop():
    """Fake-backend ImageCamera applies the reference's vertical center
    crop to target aspect before scaling (image_camera.lua:22-24); opening
    a missing V4L2 device raises."""
    from depth_estimation_tpu.data.images import ImageCamera
    cam = ImageCamera(60, 80)
    frame = np.zeros((480, 640, 3), np.float32)
    frame[100:380] = 1.0   # bright band exactly at the kept center rows
    cam.push(frame)
    out = cam.get_next_frame()
    assert out.shape == (60, 80, 3)
    # 640 * 60/80 = 480 target rows... same height: nothing cropped
    assert out.mean() < 0.99
    cam2 = ImageCamera(60, 120)   # target 640*60/120 = 320 rows center crop
    cam2.push(frame)
    out2 = cam2.get_next_frame()
    assert out2.shape == (60, 120, 3)
    assert out2.mean() > 0.85, out2.mean()   # kept rows are the bright band
    import pytest as _pytest
    with _pytest.raises(OSError):
        ImageCamera(60, 80, device="/dev/video99")


def test_batched_rectification_matches_per_pair(tmp_path):
    """load_rectified_pairs_batched (one fused XLA program for the whole
    stack) must reproduce the per-pair loader exactly — same scale, tracker
    and RANSAC key."""
    g = Geometry(hImg=64, wImg=80, layers=((3, 5, 5, 8),),
                 maxh=6, maxw=6, maxhGT=6, maxwGT=6,
                 hKernelGT=5, wKernelGT=5)
    cal = small_cal(64, 80)
    root = make_sequence(tmp_path, n=4)
    from depth_estimation_tpu.data.images import ImageLoader
    loader = ImageLoader(root, cal.hImg, cal.wImg)
    frames = [loader.get_next_frame() for _ in range(4)]

    batched = datasets.load_rectified_pairs_batched(g, cal, frames)
    assert len(batched) == 3
    for k in range(3):
        single = datasets.load_rectified_pair(g, cal, frames[k],
                                              frames[k + 1])
        assert batched[k].good == single.good
        if not single.good:
            continue
        np.testing.assert_allclose(batched[k].image, single.image,
                                   atol=1e-5)
        np.testing.assert_allclose(batched[k].prev_warped,
                                   single.prev_warped, atol=1e-4)
        np.testing.assert_array_equal(batched[k].mask, single.mask)
        np.testing.assert_array_equal(batched[k].flow, single.flow)


@pytest.mark.slow
def test_batched_polar_loader_matches_per_pair(tmp_path):
    """load_polar_pairs_batched (fused device program for all pairs) must
    reproduce the per-pair reference formulation: same tracker key, same polar
    grids, same projected GT."""
    from depth_estimation_tpu.flow.celiu import bilinear_sample, gaussian_smooth

    H, W = 96, 128
    rng = np.random.RandomState(2)
    base = np.asarray(gaussian_smooth(
        jnp.asarray(rng.rand(H, W, 3).astype(np.float32)), 0.8, 2))
    base = np.clip(base * 1.5, 0, 1).astype(np.float32)

    def forward_step(img, s_top, s_bottom):
        cy, cx = H / 2, W / 2
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        s = np.where(yy < cy, s_top, s_bottom)
        xs = cx + (xx - cx) / s
        ys = cy + (yy - cy) / s
        return np.asarray(bilinear_sample(jnp.asarray(img),
                                          jnp.asarray(xs), jnp.asarray(ys)))

    frames = [base]
    for _ in range(2):
        frames.append(forward_step(frames[-1], 1.03, 1.10))

    cal = small_cal(H, W)
    gg = Geometry(hImg=H, wImg=W, layers=((3, 8, 8, 8),),
                  maxh=8, maxw=8, maxhGT=8, maxwGT=8,
                  hKernelGT=8, wKernelGT=8)
    hi = wi = 64
    wk = 5
    batched = datasets.load_polar_pairs_batched(
        cal, frames, H, W, hi, wi, wk, geom_gt=gg, max_flow=6.0)
    assert len(batched) == 2
    for k in range(2):
        single = datasets.load_polar_pair_reference(
            cal, frames[k], frames[k + 1], H, W, hi, wi, wk,
            geom_gt=gg, max_flow=6.0)
        assert batched[k].good == single.good
        if not single.good:
            continue
        np.testing.assert_allclose(batched[k].e2, single.e2,
                                   atol=1e-3, rtol=1e-4)
        np.testing.assert_allclose(batched[k].polar_image,
                                   single.polar_image, atol=2e-3)
        np.testing.assert_allclose(batched[k].polar_prev_image,
                                   single.polar_prev_image, atol=2e-3)
        assert (batched[k].polar_mask == single.polar_mask).mean() > 0.995
        # the device path projects in f32, the per-pair path in numpy f64:
        # values sitting exactly on the floor(x + 0.5) quantization boundary
        # flip by one step — everything else must agree exactly
        same_gt = (batched[k].polar_gt == single.polar_gt).mean()
        assert same_gt > 0.95, same_gt
        diff = np.abs(batched[k].polar_gt - single.polar_gt)
        assert diff.max() <= 1.0 + 1e-6, diff.max()


@pytest.mark.slow
def test_polar_gt_units_are_polar_rows():
    """The warped GT must be in POLAR ROWS, not cartesian pixels: the polar
    warp maps r in [0, rmax] onto hInput rows, so a radial displacement of
    d cartesian pixels is d*hInput/rmax rows (the reference rescales
    exactly so, radial_opticalflow_data.lua:273,278). For a two-plane zoom
    about the image center the expected polar-row flow at polar row i is
    analytically (s - 1)*i (radius r = i*rmax/hInput scales to s*r, and the
    row rescale cancels rmax). A units regression (e.g. dropping the
    hInput/rmax factor) multiplies the observed/expected slope by
    rmax/hInput (~2.1 at these dims), far outside the tolerance — this is
    the pin the batched-vs-reference equivalence test cannot provide, since
    both paths share the scaling code path shape."""
    from depth_estimation_tpu.flow.celiu import bilinear_sample, gaussian_smooth

    H, W = 96, 128
    s_top, s_bottom = 1.05, 1.10
    rng = np.random.RandomState(5)
    base = np.asarray(gaussian_smooth(
        jnp.asarray(rng.rand(H, W, 3).astype(np.float32)), 0.8, 2))
    base = np.clip(base * 1.5, 0, 1).astype(np.float32)

    cy, cx = H / 2, W / 2

    def forward_step(img):
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        s = np.where(yy < cy, s_top, s_bottom)
        xs = cx + (xx - cx) / s
        ys = cy + (yy - cy) / s
        return np.asarray(bilinear_sample(jnp.asarray(img),
                                          jnp.asarray(xs), jnp.asarray(ys)))

    prev = base
    curr = forward_step(prev)
    # stricter corner gate: the default 0.0001 admits weak corners on
    # smoothed-noise textures that tilt the translation estimate (same pin
    # as the CLI test fixture)
    cal = small_cal(H, W)
    cal = dataclasses.replace(cal, sfm=dataclasses.replace(
        cal.sfm, max_points=400, points_quality=0.001))
    gg = Geometry(hImg=H, wImg=W, layers=((3, 8, 8, 8),),
                  maxh=8, maxw=8, maxhGT=8, maxwGT=8,
                  hKernelGT=8, wKernelGT=8)
    hi = wi = 64
    pair = datasets.load_polar_pair(cal, prev, curr, H, W, hi, wi, 5,
                                    geom_gt=gg, max_flow=7.0)
    assert pair.good
    ex, ey = float(pair.e2[0]), float(pair.e2[1])
    # the zoom is centered on the image center; the estimated epipole must
    # land near it for the radial projection to capture the full flow
    assert abs(ex - cx) < 12 and abs(ey - cy) < 12, (ex, ey)

    import math
    rmax = float(np.floor(math.sqrt(max(
        ex**2 + ey**2, (W - ex)**2 + ey**2,
        ex**2 + (H - ey)**2, (W - ex)**2 + (H - ey)**2))))
    # polar outputs carry the angular wrap padding: column j of the padded
    # image is angle index (j - lpadding) mod wInput
    wk = 5
    lp = (wk - 1) // 2
    ii = np.arange(hi, dtype=np.float32)[:, None]
    jj = (np.arange(wi + wk - 1, dtype=np.float32)[None, :] - lp) % wi
    r = ii * (rmax / hi)
    th = 2 * np.pi * jj / wi
    ysrc = r * np.sin(th) + ey
    s_plane = np.where(ysrc < cy, s_top, s_bottom)
    expected = (s_plane - 1.0) * ii  # polar rows

    valid = (pair.polar_gt_mask > 0.5)
    # keep clear of the plane boundary (mixed-s flow) and the saturation
    valid &= np.abs(ysrc - cy) > 6
    valid &= expected < 5.5
    valid &= ii + np.zeros_like(jj) > 8  # tiny radii: mostly rounding noise
    assert valid.sum() > 300
    err = np.abs(pair.polar_gt - expected)[valid]
    assert np.mean(err) < 0.5, np.mean(err)
    # units pin: the regression slope of observed on expected must be ~1
    x = expected[valid]
    y = pair.polar_gt[valid]
    slope = float((x * y).sum() / (x * x).sum())
    assert 0.8 < slope < 1.2, slope


def test_polar_loader_pixel_frames_split_roles():
    """pixel_frames (the clean-targets regime, round-3 verdict item 4):
    geometry + GT must come from the primary frames, polar PIXELS from the
    pixel frames warped through that same geometry."""
    from depth_estimation_tpu.flow.celiu import bilinear_sample, gaussian_smooth

    H, W = 96, 128
    rng = np.random.RandomState(4)
    base = np.asarray(gaussian_smooth(
        jnp.asarray(rng.rand(H, W, 3).astype(np.float32)), 0.8, 2))
    base = np.clip(base * 1.5, 0, 1).astype(np.float32)

    def forward_step(img, s_top, s_bottom):
        cy, cx = H / 2, W / 2
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        s = np.where(yy < cy, s_top, s_bottom)
        xs = cx + (xx - cx) / s
        ys = cy + (yy - cy) / s
        return np.asarray(bilinear_sample(jnp.asarray(img),
                                          jnp.asarray(xs), jnp.asarray(ys)))

    clean = [base, forward_step(base, 1.03, 1.10)]
    noisy = [np.clip(f + rng.randn(H, W, 3).astype(np.float32) * 0.1, 0, 1)
             for f in clean]

    cal = small_cal(H, W)
    gg = Geometry(hImg=H, wImg=W, layers=((3, 8, 8, 8),),
                  maxh=8, maxw=8, maxhGT=8, maxwGT=8,
                  hKernelGT=8, wKernelGT=8)
    hi = wi = 64
    wk = 5
    ref = datasets.load_polar_pairs_batched(
        cal, clean, H, W, hi, wi, wk, geom_gt=gg, max_flow=6.0)[0]
    # identity split: pixel_frames == frames must reproduce the plain call
    same = datasets.load_polar_pairs_batched(
        cal, clean, H, W, hi, wi, wk, geom_gt=gg, max_flow=6.0,
        pixel_frames=clean)[0]
    np.testing.assert_array_equal(same.polar_image, ref.polar_image)
    np.testing.assert_array_equal(same.polar_gt, ref.polar_gt)

    split = datasets.load_polar_pairs_batched(
        cal, clean, H, W, hi, wi, wk, geom_gt=gg, max_flow=6.0,
        pixel_frames=noisy)[0]
    assert ref.good and split.good
    # GT, mask, epipole: from the clean frames — identical
    np.testing.assert_array_equal(split.polar_gt, ref.polar_gt)
    np.testing.assert_array_equal(split.polar_gt_mask, ref.polar_gt_mask)
    np.testing.assert_array_equal(split.polar_mask, ref.polar_mask)
    np.testing.assert_allclose(split.e2, ref.e2, atol=1e-6)
    # pixels: from the noisy frames — different from clean, and carrying
    # roughly the injected noise level where the mask is on
    m = ref.polar_mask > 0
    d = np.abs(split.polar_image - ref.polar_image)[m]
    assert d.mean() > 0.02, d.mean()

    import pytest
    with pytest.raises(ValueError):
        datasets.load_polar_pairs_batched(
            cal, clean, H, W, hi, wi, wk, pixel_frames=noisy[:1])
