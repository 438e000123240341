"""Conv feature extractor ("filter") — the siamese trunk of every matcher.

Rebuilds getFilter (/root/reference/opticalflow_model.lua:45-79): a stack of
VALID convolutions with Tanh between layers (none after the last). The
reference uses nn.SpatialConvolutionMap with a random sparse connection table
when consecutive layer channel counts don't chain
(/root/reference/opticalflow_model.lua:56-59), reproduced here by
SparseConvMap: the reference's sparse parameter count, scattered into a
dense kernel at apply time so the conv still runs dense.

Plain JAX: each module has ``init(rng, x) -> {"params": ...}`` and
``apply(params, x)``, with the parameter tree, names and initializers of
the equivalent flax.linen modules, so checkpoints written by either load
into both. Layout is NHWC. Weights are named ``layer1..layerN`` to mirror
the reference's named-weights checkpoint payload
(/root/reference/opticalflow_model.lua:66-76).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import Geometry
from ..ops.s2d_conv import pick_s2d_factor, s2d_conv


class _Layer:
    """``init``/``apply`` on a ``{"params": layer_params}`` tree, for a
    layer used on its own."""

    def init(self, rng, x: jnp.ndarray) -> dict:
        return {"params": self.init_layer(rng, x.shape[-1])}

    def apply(self, params, x: jnp.ndarray) -> jnp.ndarray:
        return self(params["params"], x)


class TrunkConv(_Layer):
    """nn.Conv-compatible VALID conv that dispatches to the width-folded
    (space-to-depth) form when ops/s2d_conv.pick_s2d_factor asks for it.
    Param names, shapes, and initializers match nn.Conv (lecun-normal
    kernel (kh, kw, cin, cout), zero bias)."""

    def __init__(self, features: int, kernel_size: Tuple[int, int]):
        self.features = features
        self.kernel_size = tuple(kernel_size)

    def init_layer(self, key, cin: int) -> dict:
        kh, kw = self.kernel_size
        kernel = jax.nn.initializers.lecun_normal()(
            key, (kh, kw, cin, self.features), jnp.float32)
        return {"bias": jnp.zeros((self.features,), jnp.float32),
                "kernel": kernel}

    def __call__(self, p, x: jnp.ndarray) -> jnp.ndarray:
        kh, kw = self.kernel_size
        s = pick_s2d_factor(kh, kw, x.shape[-1], self.features)
        y = s2d_conv(x, p["kernel"].astype(x.dtype), s)
        return y + p["bias"].astype(y.dtype)


def random_connection_table(nin: int, nout: int, nto: int,
                            seed: int = 0) -> np.ndarray:
    """(nout, nto) int table: each output channel's nto distinct input
    channels — the clean-room equivalent of nn.tables.random(nin, nout,
    nto). Fixed seed so the topology is part of the architecture (the
    reference freezes its table at module construction)."""
    rng = np.random.RandomState(seed)
    return np.stack([rng.choice(nin, size=nto, replace=False)
                     for _ in range(nout)])


class SparseConvMap(_Layer):
    """nn.SpatialConvolutionMap(nn.tables.random(nin, nout, nto))
    (/root/reference/opticalflow_model.lua:56-59): each output map reads a
    fixed random subset of nto input channels. Parameters are exactly the
    sparse (kh, kw, nto, nout) kernel (reference parameter count); at apply
    time it is scattered into a dense (kh, kw, nin, nout) kernel so the
    conv still runs dense — sparse-random connectivity was a 2012
    FLOP-saving trick, not something a matrix unit wants."""

    def __init__(self, nin: int, nout: int, nto: int, kh: int, kw: int,
                 seed: int = 0):
        self.nin, self.nout, self.nto = nin, nout, nto
        self.kh, self.kw = kh, kw
        self.table = random_connection_table(nin, nout, nto, seed)

    def init_layer(self, key, cin: int) -> dict:
        kernel = jax.nn.initializers.variance_scaling(
            1.0 / 3, "fan_in", "uniform", in_axis=(0, 1, 2))(
            key, (self.kh, self.kw, self.nto, self.nout), jnp.float32)
        return {"bias": jnp.zeros((self.nout,), jnp.float32),
                "kernel": kernel}

    def __call__(self, p, x: jnp.ndarray) -> jnp.ndarray:
        # scatter sparse -> dense: one-hot (nout, nto, nin) selection
        onehot = np.zeros((self.nout, self.nto, self.nin), np.float32)
        for o in range(self.nout):
            for j in range(self.nto):
                onehot[o, j, self.table[o, j]] = 1.0
        dense = jnp.einsum("hwjo,ojn->hwno",
                           jnp.asarray(p["kernel"], jnp.float32),
                           jnp.asarray(onehot),
                           precision=jax.lax.Precision.HIGHEST
                           ).astype(x.dtype)
        y = jax.lax.conv_general_dilated(
            x[None] if x.ndim == 3 else x, dense,
            window_strides=(1, 1), padding="VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        y = y + p["bias"].astype(y.dtype)
        return y[0] if x.ndim == 3 else y


class ConvFilter:
    """Feature trunk: geometry.layers = ((cin, kh, kw, cout), ...).

    When a layer's nominal cin differs from the previous layer's cout, the
    reference builds a sparse random connection table with fan-in cin over
    the actual prev_cout channels (getFilter,
    /root/reference/opticalflow_model.lua:53-59; the trainer's -s2c/-s3c
    flags feed that first element) — reproduced here by SparseConvMap."""

    def __init__(self, geometry: Geometry):
        self.geometry = geometry
        layers = geometry.layers
        self.layers = []
        for i, (cin, kh, kw, cout) in enumerate(layers):
            prev_cout = layers[i - 1][3] if i > 0 else cin
            if i > 0 and prev_cout != cin:
                self.layers.append(SparseConvMap(
                    nin=prev_cout, nout=cout, nto=cin, kh=kh, kw=kw))
            else:
                self.layers.append(TrunkConv(cout, (kh, kw)))

    def init(self, rng, x: jnp.ndarray) -> dict:
        keys = jax.random.split(rng, len(self.layers))
        cins = [x.shape[-1]] + [l[3] for l in self.geometry.layers[:-1]]
        return {"params": {
            f"layer{i + 1}": layer.init_layer(keys[i], cins[i])
            for i, layer in enumerate(self.layers)}}

    def apply(self, params, x: jnp.ndarray) -> jnp.ndarray:
        p = params["params"]
        for i, layer in enumerate(self.layers):
            x = layer(p[f"layer{i + 1}"], x)
            if i != len(self.layers) - 1:
                x = jnp.tanh(x)
        return x


def identity_filter_params(geometry: Geometry, dtype=jnp.float32):
    """Build ConvFilter params whose output features are the raw input patch
    vectorized — the reference's analytic-test trick
    (/root/reference/tests/test_patches2.lua:44-54): with these weights,
    feature-space SSD equals raw-pixel patch SSD, so matching is decidable by
    brute force. Requires a single layer with cout == kh*kw*cin."""
    assert len(geometry.layers) == 1
    cin, kh, kw, cout = geometry.layers[0]
    assert cout == kh * kw * cin, "identity filter needs cout == kh*kw*cin"
    # conv kernel shape: (kh, kw, cin, cout)
    kernel = jnp.zeros((kh, kw, cin, cout), dtype)
    for i in range(kh):
        for j in range(kw):
            for k in range(cin):
                out_idx = (i * kw + j) * cin + k
                kernel = kernel.at[i, j, k, out_idx].set(1.0)
    bias = jnp.zeros((cout,), dtype)
    return {"params": {"layer1": {"kernel": kernel, "bias": bias}}}
