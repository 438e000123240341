"""Headline benchmark: 640x480 frame pairs per second for the complete
per-frame online program on one GPU, with the dense matching core beside it.

``value`` is the full pipeline — everything the reference's online loop
runs per frame (/root/reference/depth_estimation_api.lua:134-198):
undistort -> ego-motion (Shi-Tomasi corners + pyramidal LK + RANSAC
essential) -> rotation compensation -> conv trunk -> fused match ->
decode -> warp-mask erosion -> confidence gate -> bad-frame zeroing ->
depth rule (computeDepthMapFromFlow,
/root/reference/ardrone/ardrone_api.cpp:127-136), batched B=128 uint8
frames (api_batched.BatchedDepthEstimator, fast-mode settings).

``matching_core`` is device resize to the 320x180 working resolution +
conv trunk + fused match + depth rule, no ego-motion.

Each number is B / (median seconds per call), every call ended by
``jax.block_until_ready``. Prints exactly one JSON line with the device
(platform, kind, count) and the card's name and power limit. Exits
non-zero without computing anything when JAX finds no GPU.

    python bench.py
"""

import json
import subprocess
import sys
import time

import numpy as np

BATCH = 128
H_IN, W_IN = 480, 640
N_RUNS = 20


def median_seconds(fn) -> float:
    import jax
    jax.block_until_ready(fn())                  # compile + warm up
    ts = []
    for _ in range(N_RUNS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main() -> int:
    import jax
    import jax.numpy as jnp

    d = jax.devices()
    if d[0].platform != "gpu":
        print(f"bench: no GPU (JAX platform {d[0].platform!r})",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    from depth_estimation_tpu.api_batched import BatchedDepthEstimator
    from depth_estimation_tpu.data.images import scale_batched_device
    from depth_estimation_tpu.geometry import Geometry
    from depth_estimation_tpu.geometry3d.calibration import ARDRONE
    from depth_estimation_tpu.models.flow import FlowModel, crop_features_center
    from depth_estimation_tpu.ops import matching

    # canonical working resolution and model shape
    # (/root/reference/opticalflow.lua:122-140: inputs 640x480, matching at
    # 320x180, 10 features, 16x16 window)
    g = Geometry(hImg=180, wImg=320, layers=((3, 16, 16, 10),),
                 maxh=16, maxw=16)
    model = FlowModel(g)
    params = model.init(jax.random.PRNGKey(0))

    @jax.jit
    def core(params, frames1, frames2):
        small1 = scale_batched_device(frames1.astype(jnp.float32) / 255.0,
                                      g.hImg, g.wImg)
        small2 = scale_batched_device(frames2.astype(jnp.float32) / 255.0,
                                      g.hImg, g.wImg)
        f1 = crop_features_center(g, model.features(params, small1))
        f2 = model.features(params, small2)
        idx, ey, ex, pmax = matching.match_flow_fused(f1, f2, g.maxh, g.maxw)
        # depth from x-flow (translation magnitude m = 1)
        j = jnp.arange(ex.shape[-1], dtype=jnp.float32)[None, None, :]
        absflow = jnp.abs(ex)
        depth = jnp.where(absflow < 0.1, jnp.inf,
                          jnp.abs(j - ex.shape[-1] / 2.0)
                          / jnp.maximum(absflow, 0.1))
        return ex, ey, depth, pmax

    # textured uint8 frames (Shi-Tomasi tracks, the essential fit is
    # non-degenerate), made on the device
    base = jax.random.uniform(jax.random.PRNGKey(1), (BATCH, 120, 160, 3))
    tex = jax.image.resize(base, (BATCH, H_IN, W_IN, 3), "bilinear")
    t1 = (tex * 255).astype(jnp.uint8)
    t2 = (jnp.roll(tex, -3, axis=2) * 255).astype(jnp.uint8)

    core_s = median_seconds(lambda: core(params, t1, t2))

    est = BatchedDepthEstimator(
        g, params, ARDRONE, head="mean", match_dtype=jnp.bfloat16,
        warp_dtype=jnp.bfloat16, compensation="decode", lk_iters=5,
        ransac_samples=48, state_dtype=jnp.bfloat16, ego_downsample=2,
        corner_selector="topk", lk_search=24)
    est.reset(t1)
    full_s = median_seconds(lambda: est.next_frames(t2))

    print(json.dumps({
        "metric": ("640x480 frame pairs/s, complete online pipeline "
                   "(undistort+ego-motion+compensation+match+masks+depth); "
                   "matching_core = resize+trunk+match+depth only"),
        "value": BATCH / full_s,
        "unit": "frame pairs/s",
        "matching_core": BATCH / core_s,
        "batch": BATCH,
        "runs": N_RUNS,
        "card": card,
        "device": {"platform": d[0].platform, "kind": d[0].device_kind,
                   "count": len(d)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
