"""Variational-flow GT generation throughput (BASELINE config 2): celiu
coarse-to-fine IRLS on the reference car pair, single-pair and
explicit-batch rates on the GPU, each run ended by jax.block_until_ready.
Also writes qualitative artifacts (flow HSV + warp) into examples/."""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp


def main():
    from depth_estimation_tpu.data.images import load_image, scale
    from depth_estimation_tpu.flow import celiu
    from depth_estimation_tpu.utils.viz import flow2hsv, save_image

    H, W = 192, 256
    im1 = np.asarray(scale(load_image("/root/reference/celiu/car1.jpg"), H, W))
    im2 = np.asarray(scale(load_image("/root/reference/celiu/car2.jpg"), H, W))

    # reference GT generator schedule (groundtruth_opticalflow_celiu.lua:9-14)
    kw = dict(alpha=0.005, ratio=0.75, min_width=30,
              n_outer=5, n_inner=1, n_sor=40)
    solve = jax.jit(lambda a, b: celiu.coarse2fine_flow(a, b, **kw))

    t0 = time.perf_counter()
    u, v, warped = jax.block_until_ready(solve(jnp.asarray(im1),
                                               jnp.asarray(im2)))
    print(f"compile+run: {time.perf_counter() - t0:.0f}s", flush=True)

    N = 10
    t0 = time.perf_counter()
    for _ in range(N):
        u, v, warped = solve(jnp.asarray(im1), jnp.asarray(im2))
    jax.block_until_ready(u)
    dt = (time.perf_counter() - t0) / N
    print(f"celiu single-pair: {dt*1e3:.1f} ms/pair -> {1/dt:.1f} pairs/s",
          flush=True)

    # Batch scaling via the EXPLICIT leading-batch solver
    # (coarse2fine_flow_batched).
    for B in (2, 4, 8, 16):
        solve_b = jax.jit(
            lambda a, b: celiu.coarse2fine_flow_batched(a, b, **kw))
        bb1 = jnp.broadcast_to(jnp.asarray(im1), (B, H, W, 3))
        bb2 = jnp.broadcast_to(jnp.asarray(im2), (B, H, W, 3))
        jax.block_until_ready(solve_b(bb1, bb2))
        t0 = time.perf_counter()
        for _ in range(3):
            ub, vb, wb = solve_b(bb1, bb2)
        jax.block_until_ready(ub)
        dtb = (time.perf_counter() - t0) / (3 * B)
        print(f"celiu explicit batch B={B}: {dtb*1e3:.1f} ms/pair -> "
              f"{1/dtb:.1f} pairs/s", flush=True)

    # qualitative artifacts
    exdir = os.path.join(os.path.dirname(__file__), "..", "examples")
    os.makedirs(exdir, exist_ok=True)
    flow = np.stack([np.asarray(v), np.asarray(u)])

    class _G:
        maxh = maxw = 10
    save_image(os.path.join(exdir, "car_flow_hsv.png"), flow2hsv(_G, flow))
    save_image(os.path.join(exdir, "car_warped.png"),
               np.asarray(warped).transpose(2, 0, 1))
    save_image(os.path.join(exdir, "car_frame1.png"), im1.transpose(2, 0, 1))
    print("wrote examples/car_{flow_hsv,warped,frame1}.png", flush=True)


if __name__ == "__main__":
    main()
