"""Training-step throughput on the GPU: single-scale patch NLL trainer and
the multiscale fovea trainer at reference shapes, each step ended by
jax.block_until_ready.

The reference trains strictly batch-1 SGD on a 2012 CPU
(/root/reference/opticalflow.lua:280-342, no published rate).
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from depth_estimation_tpu.geometry import Geometry, Learning
    from depth_estimation_tpu.models.flow import FlowModel
    from depth_estimation_tpu.models.multiscale import MultiscaleFlowModel
    from depth_estimation_tpu.training import train as training

    rng = np.random.RandomState(0)

    # --- single-scale: 17x17 kernel, 16x16 window -> 32x32 patches
    g = Geometry(hImg=180, wImg=320, layers=((3, 17, 17, 10),),
                 maxh=16, maxw=16)
    lrn = Learning(rate=5e-3, criterion="nll", batch_size=256)
    model = FlowModel(g)
    trainer = training.Trainer(model, lrn)
    state = trainer.init(jax.random.PRNGKey(0))
    B = lrn.batch_size
    p1 = jnp.asarray(rng.rand(B, g.hPatch2, g.wPatch2, 3), jnp.float32)
    p2 = jnp.asarray(rng.rand(B, g.hPatch2, g.wPatch2, 3), jnp.float32)
    it = jnp.asarray(rng.randint(0, g.maxh * g.maxw, B), jnp.int32)
    soft_t = jnp.zeros((B, g.maxh * g.maxw), jnp.float32)

    state, aux = jax.block_until_ready(trainer._step(state, p1, p2, it,
                                                     soft_t))
    t0 = time.perf_counter()
    N = 20
    for _ in range(N):
        state, aux = trainer._step(state, p1, p2, it, soft_t)
    jax.block_until_ready(state)
    dt = (time.perf_counter() - t0) / N
    print(f"single-scale train step (B={B}, 32x32 patches): "
          f"{dt*1e3:.2f} ms -> {B/dt:.0f} samples/s", flush=True)

    # --- multiscale fovea trainer: 2 scales, 8x8 window
    g2 = Geometry(hImg=180, wImg=320, layers=((3, 16, 16, 10),),
                  maxh=8, maxw=8, multiscale=True, ratios=(1, 2))
    lrn2 = Learning(rate=5e-3, criterion="nll", batch_size=32)
    m2 = MultiscaleFlowModel(g2)
    t2 = training.MultiscaleTrainer(m2, lrn2)
    st2 = t2.init(jax.random.PRNGKey(0))
    B2 = lrn2.batch_size
    Hm, Wm = g2.rmax * g2.hPatch2, g2.rmax * g2.wPatch2
    c1 = jnp.asarray(rng.rand(B2, Hm, Wm, 3), jnp.float32)
    c2 = jnp.asarray(rng.rand(B2, Hm, Wm, 3), jnp.float32)
    itg = jnp.zeros(B2, jnp.int32)

    st2, aux2 = jax.block_until_ready(t2._step(st2, c1, c2, itg))
    t0 = time.perf_counter()
    for _ in range(N):
        st2, aux2 = t2._step(st2, c1, c2, itg)
    jax.block_until_ready(st2)
    dt2 = (time.perf_counter() - t0) / N
    print(f"multiscale fovea train step (B={B2}, 2 scales, "
          f"{Hm}x{Wm} crops): {dt2*1e3:.2f} ms -> {B2/dt2:.0f} samples/s",
          flush=True)


if __name__ == "__main__":
    main()
