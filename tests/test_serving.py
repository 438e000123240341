"""Serving exports (serving.py): the StableHLO artifact must reproduce the
live program bitwise, embed the weights (no params at call time), and round
trip through the `tools export` CLI."""

import numpy as np
import jax
import jax.numpy as jnp

from depth_estimation_tpu import serving
from depth_estimation_tpu.geometry import Geometry, Learning
from depth_estimation_tpu.models.flow import FlowModel
import pytest


def _tiny():
    g = Geometry(hImg=32, wImg=40, layers=((3, 5, 5, 6),), maxh=4, maxw=4)
    model = FlowModel(g)
    params = model.init(jax.random.PRNGKey(0))
    return g, model, params


def test_flow_forward_roundtrip(tmp_path):
    g, model, params = _tiny()
    path = str(tmp_path / "fwd.stablehlo")
    serving.export_flow_forward(g, params, path)
    re = serving.load_exported(path)

    rng = np.random.RandomState(0)
    img1 = jnp.asarray(rng.rand(g.hImg, g.wImg, 3), jnp.float32)
    img2 = jnp.asarray(rng.rand(g.hImg, g.wImg, 3), jnp.float32)
    got = re.call(img1, img2)                    # no params: weights embedded
    want = jax.jit(model.forward_fused)(params, img1, img2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.slow
def test_pipeline_pairs_roundtrip(tmp_path):
    import dataclasses
    from depth_estimation_tpu import api_batched as apib
    from depth_estimation_tpu.geometry3d import calibration as calmod

    hp, wp = 48, 64
    cal = dataclasses.replace(
        calmod.RECTIFIED_GOPRO_SMALL, name="srv", wImg=wp, hImg=hp,
        fx=60.0, fy=60.0, cx=wp / 2, cy=hp / 2,
        sfm=dataclasses.replace(calmod.RECTIFIED_GOPRO_SMALL.sfm,
                                max_points=64))
    g = Geometry(hImg=hp, wImg=wp, layers=((3, 5, 5, 6),), maxh=4, maxw=4)
    params = FlowModel(g).init(jax.random.PRNGKey(1))

    path = str(tmp_path / "pipe.stablehlo")
    serving.export_pipeline_pairs(g, params, cal, batch=2,
                                  frame_hw=(hp, wp), path=path)
    re = serving.load_exported(path)

    rng = np.random.RandomState(2)
    base = rng.rand(2, hp // 4, wp // 4, 3).astype(np.float32)
    f1 = np.asarray(jax.image.resize(jnp.asarray(base), (2, hp, wp, 3),
                                     "bilinear"))
    f2 = np.roll(f1, -1, axis=2)
    u1 = jnp.asarray((f1 * 255).astype(np.uint8))
    u2 = jnp.asarray((f2 * 255).astype(np.uint8))

    got = re.call(u1, u2)
    pipeline = apib.make_batched_pipeline(g, cal)
    want = pipeline(params, u1, u2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_cli_export(tmp_path):
    from depth_estimation_tpu.models import io as mio
    from depth_estimation_tpu.cli import tools

    g, model, params = _tiny()
    mdir = mio.save_model(str(tmp_path), g,
                          Learning(rate=1e-2, batch_size=4, criterion="nll"),
                          params)
    out = str(tmp_path / "artifact.stablehlo")
    assert tools.main(["export", mdir, "--out", out]) == 0

    re = serving.load_exported(out)
    rng = np.random.RandomState(3)
    img1 = jnp.asarray(rng.rand(g.hImg, g.wImg, 3), jnp.float32)
    img2 = jnp.asarray(rng.rand(g.hImg, g.wImg, 3), jnp.float32)
    got = re.call(img1, img2)
    want = jax.jit(model.forward_fused)(params, img1, img2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_multiscale_export_roundtrip(tmp_path):
    from depth_estimation_tpu.models.multiscale import MultiscaleFlowModel

    g = Geometry(hImg=24, wImg=32, layers=((3, 5, 5, 6),), maxh=4, maxw=4,
                 multiscale=True, ratios=(1, 2))
    model = MultiscaleFlowModel(g)
    params = model.init(jax.random.PRNGKey(4))

    path = str(tmp_path / "ms.stablehlo")
    serving.export_flow_forward(g, params, path)
    re = serving.load_exported(path)

    rng = np.random.RandomState(5)
    img1 = jnp.asarray(rng.rand(g.hImg, g.wImg, 3), jnp.float32)
    img2 = jnp.asarray(rng.rand(g.hImg, g.wImg, 3), jnp.float32)
    got = re.call(img1, img2)
    want = jax.jit(model.decode_full)(params, img1, img2)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b)
        else:
            # embedding the weights as constants changes XLA fusion order
            # slightly (measured 1.5e-8 max) — physical equality, not bitwise
            np.testing.assert_allclose(a, b, atol=1e-6)


def test_radial_export_roundtrip_and_cli(tmp_path):
    """export_radial_forward + `tools export` autodetection of the
    cli/train_radial.py checkpoint layout (meta.json layers/hWin +
    e<N>.msgpack)."""
    import json
    from depth_estimation_tpu.models.io import to_bytes
    from depth_estimation_tpu.cli import tools
    from depth_estimation_tpu.models.radial import RadialFlowNetwork

    layers, h_win, hw = ((3, 5, 5, 8),), 5, (40, 48)
    net = RadialFlowNetwork(layers, h_win)
    params = net.init(jax.random.PRNGKey(6))

    path = str(tmp_path / "radial.stablehlo")
    serving.export_radial_forward(layers, h_win, params, polar_hw=hw,
                                  path=path)
    re = serving.load_exported(path)
    rng = np.random.RandomState(7)
    p1 = jnp.asarray(rng.rand(*hw, 3), jnp.float32)
    p2 = jnp.asarray(rng.rand(*hw, 3), jnp.float32)
    got = re.call(p1, p2)
    want = jax.jit(net.flow)(params, p1, p2)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               atol=1e-6)

    # CLI path: trainer-layout dir -> autodetected radial export
    mdir = tmp_path / "mr"
    mdir.mkdir()
    (mdir / "meta.json").write_text(json.dumps(
        {"version": 1, "layers": [list(l) for l in layers], "hWin": h_win}))
    (mdir / "e0.msgpack").write_bytes(to_bytes(params))
    out = str(tmp_path / "radial_cli.stablehlo")
    assert tools.main(["export", str(mdir), "--out", out,
                       "--hw", str(hw[0]), str(hw[1])]) == 0
    got = serving.load_exported(out).call(p1, p2)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))


def test_v2_export_roundtrip_and_cli(tmp_path):
    """export_v2_forward + `tools export` autodetection of BOTH version2
    layouts: meta.json sidecar and the reference's bare e<N> payloads
    (version2/train.lua 'models/e<N>_no_bin')."""
    import json
    from depth_estimation_tpu.models.io import to_bytes
    from depth_estimation_tpu import codecs
    from depth_estimation_tpu.cli import tools
    from depth_estimation_tpu.models.version2 import V2Network, V2Params

    datap = V2Params(wImg=48, hImg=40, normalization_k=5,
                     layers=((3, 5, 5, 6),), hWin=5, wWin=5)
    net = V2Network(datap)
    params = net.init(jax.random.PRNGKey(8))

    path = str(tmp_path / "v2.stablehlo")
    serving.export_v2_forward(datap, params, path=path)
    re = serving.load_exported(path)
    rng = np.random.RandomState(9)
    img1 = jnp.asarray(rng.rand(datap.hImg, datap.wImg, 3), jnp.float32)
    img2 = jnp.asarray(rng.rand(datap.hImg, datap.wImg, 3), jnp.float32)
    got = re.call(img1, img2)

    def want_fn(a, b):
        costs = net.costs(params, a, b)
        idx = jnp.argmin(costs, axis=-1).astype(jnp.int32)
        dy, dx = codecs.decode(net.geometry, idx)
        return dy, dx, jnp.min(costs, axis=-1)

    want = jax.jit(want_fn)(img1, img2)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_allclose(np.asarray(got[2]), np.asarray(want[2]),
                               atol=1e-6)

    # CLI: meta.json layout
    mdir = tmp_path / "mv2"
    mdir.mkdir()
    (mdir / "meta.json").write_text(json.dumps(
        {"version": 1, "family": "version2", "wImg": datap.wImg,
         "hImg": datap.hImg, "normalization_k": datap.normalization_k,
         "layers": [list(l) for l in datap.layers],
         "hWin": datap.hWin, "wWin": datap.wWin}))
    (mdir / "e0").write_bytes(to_bytes(params))
    out = str(tmp_path / "v2_cli.stablehlo")
    assert tools.main(["export", str(mdir), "--out", out]) == 0
    got = serving.load_exported(out).call(img1, img2)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))

    # bare-payload layout (no meta.json) still detects as version2
    assert serving.detect_family(str(mdir))[0] == "v2"
    (mdir / "meta.json").unlink()
    assert serving.detect_family(str(mdir))[0] == "v2"
    assert serving.detect_family(str(mdir))[1] is None


@pytest.mark.slow
def test_legacy_depth_export_roundtrip_and_cli(tmp_path):
    """export_legacy_depth + `tools export` autodetection of the
    cli/depth_estimation.py checkpoint layout (meta.json n_classes +
    params.msgpack); the artifact is the fully-convolutional class map
    (depth_estimation.lua:340-404)."""
    import json
    from depth_estimation_tpu.models.io import to_bytes
    from depth_estimation_tpu.cli import tools
    from depth_estimation_tpu.models.legacy_depth import DepthClassifierCNN

    n_classes, hw = 3, (56, 64)
    model = DepthClassifierCNN(n_classes=n_classes)
    params = model.init(jax.random.PRNGKey(10),
                        jnp.zeros((1, 48, 48, 2), jnp.float32))

    path = str(tmp_path / "depth.stablehlo")
    serving.export_legacy_depth(n_classes, params, frame_hw=hw, path=path)
    re = serving.load_exported(path)
    rng = np.random.RandomState(11)
    x = jnp.asarray(rng.rand(*hw, 2), jnp.float32)
    got = np.asarray(re.call(x))
    want = np.asarray(jnp.argmax(
        jax.jit(model.apply)(params, x[None])[0], axis=-1))
    np.testing.assert_array_equal(got, want)

    mdir = tmp_path / "md"
    mdir.mkdir()
    (mdir / "meta.json").write_text(json.dumps(
        {"n_classes": n_classes, "cut_depth": 2.0, "bin_step": 1.0,
         "patch": 48}))
    (mdir / "params.msgpack").write_bytes(
        to_bytes(params))
    out = str(tmp_path / "depth_cli.stablehlo")
    assert tools.main(["export", str(mdir), "--out", out,
                       "--hw", str(hw[0]), str(hw[1])]) == 0
    got = np.asarray(serving.load_exported(out).call(x))
    np.testing.assert_array_equal(got, want)
