"""Checkpoint I/O without flax: the msgpack layout reader/writer of
models/io.py and the plain-JAX feature trunk of models/filters.py."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from depth_estimation_tpu.geometry import Geometry
from depth_estimation_tpu.models import io as mio
from depth_estimation_tpu.models.filters import ConvFilter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAR = os.path.join(ROOT, "examples", "car_model")


def test_main_path_without_flax_or_msgpack():
    """The main path (api, api_batched, models, training) imports, loads
    examples/car_model and builds a BatchedDepthEstimator with flax and
    msgpack imports blocked."""
    code = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("flax", "msgpack"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
from depth_estimation_tpu import api, api_batched
from depth_estimation_tpu.models import filters, flow, io
from depth_estimation_tpu.training import train
from depth_estimation_tpu.geometry3d.calibration import ARDRONE
g, learning, params, meta = io.load_model({CAR!r})
est = api_batched.BatchedDepthEstimator(g, params, ARDRONE)
api.DepthEstimator(g, params, ARDRONE)
train.Trainer(flow.FlowModel(g), learning)
assert not any(m.split(".")[0] in ("flax", "msgpack") for m in sys.modules)
print(g.layers, sorted(params["params"]))
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "['layer1', 'layer2']" in out.stdout


def test_checkpoint_round_trip_is_byte_identical(tmp_path):
    """Loading the shipped (flax-written) checkpoint and saving it again
    gives the same params.msgpack bytes."""
    g, learning, params, meta = mio.load_model(CAR)
    assert params["params"]["layer2"]["kernel"].shape == (12, 12, 8, 10)
    out = mio.save_model(str(tmp_path / "m"), g, learning, params,
                         meta["score"], meta["epoch"])
    with open(os.path.join(CAR, "params.msgpack"), "rb") as a, \
            open(os.path.join(out, "params.msgpack"), "rb") as b:
        assert a.read() == b.read()


def test_msgpack_codec_leaf_types():
    """Arrays of several dtypes (bfloat16 included), numpy scalars and
    nested maps survive to_bytes/msgpack_restore exactly."""
    rng = np.random.RandomState(0)
    tree = {"params": {
        "a": rng.rand(3, 4).astype(np.float32),
        "b": {"c": np.arange(300, dtype=np.int32),
              "d": np.asarray(jnp.ones((2,), jnp.bfloat16))},
        "big": rng.rand(20000).astype(np.float32),
        "s": np.float32(2.5)}}
    back = mio.msgpack_restore(mio.to_bytes(tree))
    for x, y in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_from_bytes_rejects_structure_mismatch(tmp_path):
    g, _, params, _ = mio.load_model(CAR)
    payload = mio.to_bytes(params)
    wrong = {"params": {"layer1": params["params"]["layer1"]}}
    with pytest.raises(ValueError, match="structure mismatch"):
        mio.from_bytes(wrong, payload)
    # the finetune path restores into a matching template
    d = tmp_path / "w"
    shutil.copytree(CAR, d)
    got = mio.load_weights_into(str(d), params)
    np.testing.assert_array_equal(got["params"]["layer2"]["bias"],
                                  params["params"]["layer2"]["bias"])


def test_conv_filter_params_follow_flax_layout():
    """ConvFilter.init gives nn.Conv's tree, shapes and initializers:
    zero biases, lecun-normal kernels (std ~ 1/sqrt(fan_in))."""
    g = Geometry(hImg=64, wImg=64, layers=((3, 5, 5, 64), (64, 7, 7, 32)),
                 maxh=4, maxw=4)
    f = ConvFilter(g)
    params = f.init(jax.random.PRNGKey(0), jnp.zeros((20, 20, 3)))
    p = params["params"]
    assert sorted(p) == ["layer1", "layer2"]
    assert p["layer1"]["kernel"].shape == (5, 5, 3, 64)
    assert p["layer2"]["kernel"].shape == (7, 7, 64, 32)
    for name, fan_in in (("layer1", 75), ("layer2", 7 * 7 * 64)):
        assert not np.asarray(p[name]["bias"]).any()
        std = float(np.asarray(p[name]["kernel"]).std())
        assert abs(std * np.sqrt(fan_in) - 1.0) < 0.1, (name, std)
    y = f.apply(params, jnp.ones((2, 20, 20, 3)))
    assert y.shape == (2, 10, 10, 32)
