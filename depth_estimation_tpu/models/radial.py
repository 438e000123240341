"""Radial (polar 1-D) flow network — forward-motion matcher.

Rebuilds /root/reference/radial/radial_opticalflow_network.lua: a siamese
conv trunk applied to epipole-centered *polar* images, followed by a 1-D
matcher that searches only along the radial (row) direction:

    cost[y, x, k] = sum_c (f_prev[y, x, c] - f_curr[y + k, x, c])^2,
    k in [0, hWin)   (nnx SpatialRadialMatching(hWin))

The previous frame's features are cropped by hWin-1 at the bottom
(SpatialPadding(0,0,0,-hWin+1), :39-44) so the search is one-sided: forward
motion makes everything flow outward (increasing radius), flow = k >= 0.

The trunk uses the radial layer-spec format: tuples (in, kh, kw, out)
interleaved with the literal string 'tanh' (:6-30). Dense convs replace the
SpatialConvolutionMap random tables (see models/filters.py rationale).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import jax
import jax.numpy as jnp

from ..ops import matching
from .filters import TrunkConv

RadialLayer = Union[str, Tuple[int, int, int, int]]


class RadialFilter:
    """Conv trunk for polar images; layers per the radial spec format.
    Params {"params": {"layer<i>": {"kernel", "bias"}}}, i counting the
    conv layers from 1."""

    def __init__(self, layers: Tuple[RadialLayer, ...]):
        self.layers = layers
        self.convs = [TrunkConv(l[3], (l[1], l[2])) for l in layers
                      if not isinstance(l, str)]

    def init(self, rng, x: jnp.ndarray) -> dict:
        keys = jax.random.split(rng, len(self.convs))
        cins = [x.shape[-1]] + [c.features for c in self.convs[:-1]]
        return {"params": {
            f"layer{i + 1}": conv.init_layer(keys[i], cins[i])
            for i, conv in enumerate(self.convs)}}

    def apply(self, params, x: jnp.ndarray) -> jnp.ndarray:
        p = params["params"]
        i = 0
        for layer in self.layers:
            if layer == "tanh":
                x = jnp.tanh(x)
            else:
                x = self.convs[i](p[f"layer{i + 1}"], x)
                i += 1
        return x


class RadialFlowNetwork:
    """Functional radial matcher. networkp mirrors the reference parameter
    table: layers, hWin, hInput/wInput (polar size), hImg/wImg (frame size)."""

    def __init__(self, layers: Sequence[RadialLayer], h_win: int):
        self.layers = tuple(tuple(l) if not isinstance(l, str) else l
                            for l in layers)
        self.h_win = h_win
        self.filter = RadialFilter(self.layers)

    @property
    def h_kernel(self) -> int:
        return sum(l[1] - 1 for l in self.layers if not isinstance(l, str)) + 1

    @property
    def w_kernel(self) -> int:
        return sum(l[2] - 1 for l in self.layers if not isinstance(l, str)) + 1

    def init(self, rng, h: int = 64, w: int = 64) -> dict:
        cin = next(l[0] for l in self.layers if not isinstance(l, str))
        dummy = jnp.zeros((h, w, cin), jnp.float32)
        return self.filter.init(rng, dummy)

    def costs(self, params, polar_prev: jnp.ndarray,
              polar_curr: jnp.ndarray) -> jnp.ndarray:
        """(H, W, C) polar pair -> (H', W', hWin) radial cost volume."""
        f_prev = self.filter.apply(params, polar_prev)
        f_curr = self.filter.apply(params, polar_curr)
        # crop prev features at the bottom by hWin-1 (one-sided search)
        f_prev = f_prev[: f_prev.shape[0] - self.h_win + 1]
        return matching.match_ssd_radial(f_prev, f_curr, self.h_win)

    def log_scores(self, params, polar_prev, polar_curr) -> jnp.ndarray:
        """Trainer head: LogSoftMax(-cost) over the hWin classes
        (getTrainerNetwork, :36-54)."""
        return jax.nn.log_softmax(-self.costs(params, polar_prev, polar_curr),
                                  axis=-1)

    @staticmethod
    def filter_output_trainer(logp: jnp.ndarray, threshold: float
                              ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """filterOutputTrainer (/root/reference/radial/
        radial_opticalflow_filtering.lua:3-8): WTA class index + confidence
        gate exp(max log-prob) >= threshold. NOTE: the reference's training
        loop disables the gate (`if good or true`,
        train_radial_opticalflow.lua:231); provided for parity and for
        callers that want the gate live. logp (..., hWin) ->
        (idx (...,) int32, good (...,) bool)."""
        m = jnp.max(logp, axis=-1)
        idx = jnp.argmax(logp, axis=-1).astype(jnp.int32)
        return idx, jnp.exp(m) >= threshold

    def flow(self, params, polar_prev, polar_curr) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Tester decode: WTA radial flow (argmin over hWin) and min cost
        (test_radial_opticalflow.lua:205-207). Returns (flow, min_cost)."""
        costs = self.costs(params, polar_prev, polar_curr)
        return (jnp.argmin(costs, axis=-1).astype(jnp.int32),
                jnp.min(costs, axis=-1))

    def flow_batch(self, params, polar_prev, polar_curr):
        """Throughput path: batched (B, H, W, C) polar pairs -> batched
        (flow, min_cost). One cached jitted vmap — frame batching is where
        the device's parallelism comes from for these small 1-D matchers."""
        if not hasattr(self, "_flow_batch_jit"):
            self._flow_batch_jit = jax.jit(
                jax.vmap(self.flow, in_axes=(None, 0, 0)))
        return self._flow_batch_jit(params, polar_prev, polar_curr)
