"""Remaining tooling tests: the synthetic random-warp GT exactness check
(cartesian_groundtruth_cc_testme port,
/root/reference/radial/radial_opticalflow_groundtruth.lua:170-210),
threshold sweeps, kernel visualization, profiler spans."""

import numpy as np
import jax
import jax.numpy as jnp

from depth_estimation_tpu.data import groundtruth
from depth_estimation_tpu.geometry import Geometry
from depth_estimation_tpu.models import flow as flow_model


def test_random_flow_warp_gt_exact():
    """Build a random integer flow field, construct im1 so that
    im1(p) = im2(p + flow(p)), and assert the cross-correlation GT recovers
    the flow exactly where patches are fully determined — the reference's
    strongest GT self-test."""
    g = Geometry(hImg=48, wImg=56, layers=((8, 5, 5, 200),),
                 maxh=4, maxw=4, maxhGT=4, maxwGT=4,
                 hKernelGT=5, wKernelGT=5)
    rng = np.random.RandomState(0)
    # many channels -> near-unique patches (the reference uses a random
    # 30-channel image)
    im2 = rng.rand(g.hImg, g.wImg, 8).astype(np.float32)
    # piecewise-constant flow (so whole patches share a displacement and
    # the warp is exactly realizable)
    fy = np.zeros((g.hImg, g.wImg), np.int32)
    fx = np.zeros((g.hImg, g.wImg), np.int32)
    fy[:, :28] = 1
    fx[:, :28] = -1
    fy[:, 28:] = 0
    fx[:, 28:] = 2
    ys, xs = np.mgrid[0:g.hImg, 0:g.wImg]
    sy = np.clip(ys + fy, 0, g.hImg - 1)
    sx = np.clip(xs + fx, 0, g.wImg - 1)
    im1 = im2[sy, sx]

    gy, gx, conf = groundtruth.exhaustive_flow(g, im1, im2)
    # check interior pixels away from the region boundary and frame borders
    sel = np.zeros((g.hImg, g.wImg), bool)
    sel[8:-8, 8:20] = True
    sel[8:-8, 36:-8] = True
    ok = sel & (conf > 0)
    assert ok.sum() > 200
    np.testing.assert_array_equal(gy[ok], fy[ok])
    np.testing.assert_array_equal(gx[ok], fx[ok])


def test_sweep_thresholds():
    from depth_estimation_tpu.training.curves import sweep_thresholds

    g = Geometry(hImg=40, wImg=48, layers=((3, 5, 5, 75),), maxh=4, maxw=4,
                 maxhGT=4, maxwGT=4, hKernelGT=5, wKernelGT=5)
    model = flow_model.FlowModel(g)
    from depth_estimation_tpu.models.filters import identity_filter_params
    params = identity_filter_params(g)
    rng = np.random.RandomState(1)
    im2 = rng.rand(g.hImg, g.wImg, 3).astype(np.float32)
    im1 = np.roll(im2, -1, axis=0)
    gtf = np.zeros((2, g.hImg, g.wImg), np.float32)
    gtf[0] = 1.0
    res = sweep_thresholds(model, params, g, [(im1, im2)], [gtf],
                           thresholds=(0.0, 0.5))
    assert len(res) == 2
    assert res[0]["kept_frac"] >= res[1]["kept_frac"]
    assert res[0]["acc_at_kept"] > 0.9


def test_kernels_image_and_profiler_span():
    from depth_estimation_tpu.utils.viz import kernels_image
    from depth_estimation_tpu.utils.timer import profiled_span

    k = np.random.RandomState(0).randn(5, 5, 3, 4).astype(np.float32)
    img = kernels_image(k)
    assert img.ndim == 2 and img.max() <= 1.0

    with profiled_span("test-span"):
        x = jnp.ones(8).sum()
    assert float(x) == 8.0


def test_export_video_gif_fallback(tmp_path):
    """Without ffmpeg the video export must still produce an animated GIF
    (the reference ships its own demo sequences as GIFs)."""
    import numpy as np
    from PIL import Image
    from depth_estimation_tpu.utils.viz import export_video

    d = tmp_path / "frames"
    d.mkdir()
    for i in range(3):
        arr = np.full((16, 20, 3), i * 80, np.uint8)
        Image.fromarray(arr).save(d / f"{i:09d}.png")
    out = str(tmp_path / "movie.mp4")
    assert export_video(str(d), out, fps=5)
    import os
    assert os.path.exists(out) or os.path.exists(str(tmp_path / "movie.gif"))


def test_interactive_download_menus(tmp_path, capsys, monkeypatch):
    """The download_model.lua prompt rebuild: numbered menus with recency
    stars, epoch selection with the contiguous-run rule and default-last,
    final scp of the chosen epoch (injected lister + scripted input)."""
    import argparse
    import subprocess as sp
    from depth_estimation_tpu.cli import tools

    tree = {
        "models": [("16x16", "2026-08-17"), ("8x8", "2026-01-01")],
        "models/16x16": [("r0.01", "2026-08-16")],
        "models/16x16/r0.01": [("imgs_park", "2026-08-16")],
        "models/16x16/r0.01/imgs_park": [
            ("e0", "2026-08-15"), ("e1", "2026-08-16"), ("e2", "2026-08-16")],
    }
    scp_calls = []
    monkeypatch.setattr(tools.subprocess, "run",
                        lambda cmd, **kw: scp_calls.append(cmd))

    inputs = iter(["1", "", "1", ""])   # 16x16 -> only learning -> imgs -> last epoch
    args = argparse.Namespace(host="h", remote_dir="models",
                              output_dir=str(tmp_path), interactive=True)
    rc = tools.cmd_download_interactive(
        args, lister=lambda p: tree.get(p), input_fn=lambda: next(inputs),
        today="2026-08-17")
    assert rc == 0
    out = capsys.readouterr().out
    assert "(1) 16x16 **" in out          # today -> two stars
    assert "(2) 8x8" in out and "8x8 *" not in out
    assert "Select epoch: 0..2" in out
    assert scp_calls and scp_calls[0][:2] == ["scp", "-r"]
    assert scp_calls[0][2].endswith("imgs_park/e2")   # default = last

    # explicit epoch + missing-epoch refusal
    inputs2 = iter(["1", "", "1", "1"])
    rc = tools.cmd_download_interactive(
        args, lister=lambda p: tree.get(p), input_fn=lambda: next(inputs2),
        today="2026-08-17")
    assert rc == 0 and scp_calls[-1][2].endswith("e1")

    tree2 = dict(tree)
    tree2["models/16x16/r0.01/imgs_park"] = [("e1", "x"), ("e2", "x")]
    inputs3 = iter(["1", "", "1"])
    rc = tools.cmd_download_interactive(
        args, lister=lambda p: tree2.get(p), input_fn=lambda: next(inputs3),
        today="2026-08-17")
    assert rc == 1
    assert "Missing epochs" in capsys.readouterr().out


def test_live_viewer_headless_fallback(monkeypatch):
    """--show (round-3 verdict item 7): the LiveViewer must degrade to a
    silent no-op without a display — env-forced headless here — and the
    avoidance loop must run unchanged with a viewer attached."""
    import numpy as np
    from depth_estimation_tpu.utils.viewer import LiveViewer

    monkeypatch.setenv("DE_TPU_HEADLESS", "1")
    v = LiveViewer("t")
    assert v.backend == "none"
    v.show(np.zeros((8, 8)))          # must be a no-op, not an error
    v.show(np.zeros((8, 8, 3)))
    v.close()

    # DISPLAY unset (no DE_TPU_HEADLESS) is also headless
    monkeypatch.delenv("DE_TPU_HEADLESS")
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    assert LiveViewer("t2").backend == "none"

    # the control loop accepts a viewer and still steps headlessly
    from depth_estimation_tpu.robotics.control import AvoidanceController
    from depth_estimation_tpu.robotics.runtime import DepthMap, SimulatedAPI
    api = SimulatedAPI(64, 48, fixed_dt=0.1, seed=1)
    api.takeoff()
    ctl = AvoidanceController(api, DepthMap(16, 32, 100.0, 0.9, 64),
                              fov=8, viewer=LiveViewer("t3"))
    traj = ctl.run(3)
    assert traj.shape == (3, 3)
