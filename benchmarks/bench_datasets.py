"""Dataset build throughput: SFM-rectified GT generation for a 50-pair
sequence, per-pair (eager, ~7 dispatches/pair) vs batched (one fused XLA
program for the whole rectification stack).

Writes a synthetic 51-frame panning sequence to a temporary directory,
builds the dataset both ways on the attached GPU (both paths return host
arrays, so each timing includes its device work), prints seconds per 50
pairs.
"""

import os
import sys
import time
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    import jax.numpy as jnp
    from PIL import Image
    from depth_estimation_tpu.data import datasets
    from depth_estimation_tpu.data.images import ImageLoader
    from depth_estimation_tpu.flow.celiu import gaussian_smooth
    from depth_estimation_tpu.geometry import Geometry
    from depth_estimation_tpu.geometry3d import calibration as calmod
    import dataclasses

    N = 51
    H, W = 240, 320
    rng = np.random.RandomState(0)
    big = np.asarray(gaussian_smooth(
        jnp.asarray(rng.rand(H + 20, W + 2 * N + 20, 3).astype(np.float32)),
        1.0, 3))
    tmp = tempfile.mkdtemp(prefix="bench_ds_")
    d = os.path.join(tmp, "images")
    os.makedirs(d)
    for i in range(N):
        im = big[10:10 + H, 10 + 2 * i:10 + W + 2 * i]
        Image.fromarray((im * 255).astype(np.uint8)).save(
            os.path.join(d, f"{i:09d}.png"))

    geom = Geometry(hImg=180, wImg=320, layers=((3, 5, 5, 8),),
                    maxh=16, maxw=16)
    cal = dataclasses.replace(
        calmod.RECTIFIED_GOPRO_SMALL, name="bench", wImg=W, hImg=H,
        fx=300.0, fy=300.0, cx=W / 2, cy=H / 2)

    loader = ImageLoader(tmp, cal.hImg, cal.wImg)
    frames = [loader.get_next_frame() for _ in range(N)]

    # warm up compiles at the REAL shapes (jit keys on the batch size)
    datasets.load_rectified_pairs_batched(geom, cal, frames,
                                          compute_gt=False)
    datasets.load_rectified_pair(geom, cal, frames[0], frames[1],
                                 compute_gt=True)
    # warm the chunked batched-GT program at its working resolution
    from depth_estimation_tpu.data import groundtruth as gt_mod
    small = np.zeros((8, geom.hImg, geom.wImg, 3), np.float32)
    gt_mod.exhaustive_flow_batched(geom, small, small)

    # rectification only (the part this batching targets)
    t0 = time.perf_counter()
    pairs_b = datasets.load_rectified_pairs_batched(geom, cal, frames,
                                                    compute_gt=False)
    t_b_rect = time.perf_counter() - t0
    t0 = time.perf_counter()
    for k in range(N - 1):
        datasets.load_rectified_pair(geom, cal, frames[k], frames[k + 1],
                                     compute_gt=False)
    t_s_rect = time.perf_counter() - t0
    print(f"rectify-only: batched {t_b_rect:.1f} s vs per-pair "
          f"{t_s_rect:.1f} s for {N-1} pairs -> "
          f"{t_s_rect/t_b_rect:.1f}x", flush=True)

    # full build incl. exhaustive GT (one extra dispatch per pair; shared
    # by both paths)
    t0 = time.perf_counter()
    pairs_b = datasets.load_rectified_pairs_batched(geom, cal, frames,
                                                    compute_gt=True)
    t_batched = time.perf_counter() - t0
    n_good = sum(p.good for p in pairs_b)
    print(f"batched+GT: {t_batched:.1f} s for {len(pairs_b)} pairs "
          f"({n_good} good) -> {t_batched/len(pairs_b)*1e3:.0f} ms/pair",
          flush=True)

    t0 = time.perf_counter()
    pairs_s = [datasets.load_rectified_pair(geom, cal, frames[k],
                                            frames[k + 1])
               for k in range(N - 1)]
    t_single = time.perf_counter() - t0
    print(f"per-pair+GT: {t_single:.1f} s for {len(pairs_s)} pairs "
          f"-> {t_single/len(pairs_s)*1e3:.0f} ms/pair", flush=True)
    print(f"speedup: {t_single/t_batched:.1f}x", flush=True)


if __name__ == "__main__":
    main()
