"""Device-mesh parallelism: batch data-parallel over the cards of a host.

The reference has no distributed execution at all (SURVEY.md §2.5) — its only
compute parallelism is an OpenMP thread pool
(/root/reference/opticalflow.lua:118). Here flow inference is embarrassingly
parallel per frame pair, so we shard the frame/patch batch across a flat 1-D
``dp`` mesh axis with ``NamedSharding`` and let XLA insert the (only needed)
collectives — an all-reduce of gradients in training, nothing at all in
inference. The mesh is flat because NVLink joins a host's cards all to all.
The model is tiny (KBs of conv weights), so parameters are replicated;
tensor/pipeline sharding would only add traffic between cards for this
workload and is deliberately not used.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(devices: Optional[Sequence] = None, axis: str = "dp") -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.asarray(devices), (axis,))


def auto_mesh(dp: str = "auto", axis: str = "dp") -> Optional[Mesh]:
    """Resolve a CLI ``--dp`` value to a mesh (or None = stay single-device).

    'auto'  -> all visible devices when there is more than one,
    'off'/'0'/'1' -> None,
    'N'     -> the first N devices (errors if fewer are attached).
    This is THE user surface for §2.5 parallelism: every CLI that can
    shard (trainers, rectify, GT/dataset builds) funnels through it.
    """
    if dp in ("off", "0", "1", "none"):
        return None
    devices = jax.devices()
    if dp == "auto":
        return make_mesh(devices, axis) if len(devices) > 1 else None
    n = int(dp)
    if n > len(devices):
        raise SystemExit(f"--dp {n}: only {len(devices)} devices attached")
    return make_mesh(devices[:n], axis)


def shard_batch(x, mesh: Mesh, axis: str = "dp"):
    """Place a batched pytree with the leading axis split across the mesh."""
    sh = NamedSharding(mesh, P(axis))
    return jax.tree.map(lambda a: jax.device_put(a, sh), x)


def replicate(x, mesh: Mesh):
    sh = NamedSharding(mesh, P())
    return jax.tree.map(lambda a: jax.device_put(a, sh), x)


def pad_to_multiple(x: np.ndarray, m: int):
    """Pad the leading axis to a multiple of m (static shapes for pjit)."""
    n = x.shape[0]
    pad = (-n) % m
    if pad:
        x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], axis=0)
    return x, n


def sharded_train_step(trainer, mesh: Mesh, axis: str = "dp",
                       n_batch: int = 4):
    """Wrap a Trainer's jitted step with explicit shardings: batch split on
    ``dp``, params/opt state replicated. XLA derives the gradient psum.
    ``n_batch`` = how many batch-leading args follow the state (4 for the
    single-scale Trainer's (p1, p2, itarget, soft_t), 3 for the
    MultiscaleTrainer's (crops1, crops2, itarget))."""
    batch_sh = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())

    step = jax.jit(
        trainer._step_fn,
        in_shardings=(rep,) + (batch_sh,) * n_batch,
        out_shardings=(rep, rep),
    )
    return step


def spatial_sharded_flow_fn(model, mesh: Mesh, axis: str = "sp"):
    """Context-parallel analog for correlation workloads (SURVEY.md §5): ONE
    frame pair is split across devices along image rows; each device pulls
    the halo rows its matcher window + conv footprint need from its
    neighbor below via ppermute, computes its slice of features + matching
    locally, and the row-sharded outputs concatenate to the full-frame
    result. The last shard's missing halo arrives as ppermute zeros —
    identical to running the unsharded model on a zero-bottom-padded frame.

    Returns fn(params, img1 (H, W, C), img2) -> (idx, ey, ex, pmax) with
    H = n_devices * rows_per_shard (pad the frame to a multiple first).
    """
    g = model.geometry
    n = mesh.devices.size
    halo = (g.maxh - 1) + (g.hKernel - 1)
    perm = [(i + 1, i) for i in range(n - 1)]   # pull rows from below

    def local(params, s1, s2):
        # s1, s2: (Hs, W, C) local row shards
        h1 = jax.lax.ppermute(s1[:halo], axis, perm)
        h2 = jax.lax.ppermute(s2[:halo], axis, perm)
        e1 = jnp.concatenate([s1, h1], axis=0)
        e2 = jnp.concatenate([s2, h2], axis=0)
        from ..models.flow import crop_features_center
        from ..ops import matching
        f1full = model.features(params, e1)
        f2 = model.features(params, e2)
        # crop f1 left/right by the half-window; rows start at halfh1 like
        # the unsharded path, keeping Hs output rows per shard
        f1 = f1full[g.halfh1:g.halfh1 + s1.shape[0],
                    g.halfw1:f1full.shape[1] - g.halfw2, :]
        f2 = f2[:s1.shape[0] + g.maxh - 1]
        return matching.match_flow_fused(f1, f2, g.maxh, g.maxw)

    mapped = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    return jax.jit(mapped)


def sharded_flow_fn(model, mesh: Mesh, axis: str = "dp"):
    """Batched flow inference sharded over the mesh: (B, H, W, C) pairs ->
    per-pair decoded flow, B split across devices. Uses shard_map so each
    device runs its own matcher kernel on its local shard (the kernel is a
    per-pair program; no cross-device communication exists in this op)."""

    def local_forward(params, img1, img2):
        # forward_fused is natively batched (batch = kernel grid dim)
        return model.forward_fused(params, img1, img2)

    mapped = jax.shard_map(
        local_forward,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=P(axis),
        check_vma=False,   # Pallas outputs carry no vma metadata
    )
    return jax.jit(mapped)


def sharded_pipeline_prep(est, mesh: Mesh, axis: str = "dp"):
    """dp-sharded form of BatchedDepthEstimator's frame prep (normalize /
    resize / undistort / conv trunk): frames split on the leading stream
    dim, params replicated. Pairs with sharded_pipeline_step — together
    they run the COMPLETE per-frame online program over the mesh with the
    stream state living sharded on device between steps."""
    mapped = jax.shard_map(
        est._prep_fn, mesh=mesh,
        in_specs=(P(), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    return jax.jit(mapped)


def sharded_pipeline_step(est, mesh: Mesh, axis: str = "dp"):
    """dp-sharded BatchedDepthEstimator._step: every stage of the online
    per-frame program (undistort -> ego-motion -> rotation compensation ->
    fused match -> masks -> depth) is per-stream, so the whole step
    partitions as pure data parallelism — shard_map splits the stream
    batch, each device runs its own matcher kernel + ego pipeline on its
    local shard, and no collective is emitted (use jax.debug or the
    compiled HLO to confirm). Stream state (previous frames + features)
    stays sharded between steps."""
    mapped = jax.shard_map(
        est._step_fn, mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    # same state-donation rule as the unsharded step (api_batched):
    # per-device state shards are dead after the step
    return jax.jit(mapped, donate_argnums=(1, 2))


def spatial_sharded_multiscale_fn(model, mesh: Mesh, axis: str = "sp"):
    """Row-sharded MULTISCALE full-image forward: ONE frame pair split
    across devices along image rows, each device computing its row slice of
    ``MultiscaleFlowModel.forward_full`` EXACTLY (same concatenated-codec
    distribution) with two halo exchanges.

    Index map (see forward_full, models/multiscale.py): at pyramid ratio r
    the output dist row yc needs downsampled rows
    [yc - pad_top, yc + hPatch2 - 2 - pad_top] (conv footprint + matcher
    window; hP = hPatch2 - 1 = hKernel + maxh - 2 splits into the
    pad_patch_border (pad_top, pad_bot)). A shard owning full-res rows
    [i*Hs, (i+1)*Hs) therefore needs input halos of rmax*pad_top rows from
    the device ABOVE and rmax*pad_bot rows from BELOW — both fetched with
    one ppermute each; edge devices receive zeros, which coincide exactly
    with pad_patch_border's zero rows, so the sharded result equals the
    unsharded one bitwise (equality-tested on the 8-mesh,
    tests/test_parallel.py).

    Constraint: hImg must divide evenly: hImg % (n_devices * rmax) == 0.
    Returns fn(params, img1 (hImg, wImg, C), img2) -> (hImg, wImg,
    n_indices) multiscale distribution, row-sharded across the mesh.
    """
    from ..models import multiscale as ms
    from ..ops import matching

    g = model.geometry
    n = mesh.devices.size
    ratios = tuple(g.ratios)
    rmax = max(ratios)
    assert g.hImg % (n * rmax) == 0, (g.hImg, n, rmax)
    Hs = g.hImg // n
    hP = g.hPatch2 - 1
    wp = g.wPatch2 - 1
    pad_top, pad_bot = hP // 2, hP - hP // 2
    T = rmax * pad_top                      # top halo (full-res rows)
    Bm = rmax * pad_bot                     # bottom halo
    assert Hs >= max(T, Bm), (
        f"shard height {Hs} smaller than the halo ({T}/{Bm} rows): "
        f"halos come from ONE neighbor; use fewer devices or taller frames")
    perm_top = [(i, i + 1) for i in range(n - 1)]   # receive from above
    perm_bot = [(i + 1, i) for i in range(n - 1)]   # receive from below

    def local(params, s1, s2):
        def ext(s):
            top = jax.lax.ppermute(s[Hs - T:], axis, perm_top)
            bot = jax.lax.ppermute(s[:Bm], axis, perm_bot)
            return jnp.concatenate([top, s, bot], axis=0)

        e1, e2 = ext(s1), ext(s2)
        dists = []
        for s_i, r in enumerate(ratios):
            start = T // r - pad_top
            L = Hs // r + hP
            wpad = ((0, 0), (wp // 2, wp - wp // 2), (0, 0))
            d1 = jnp.pad(ms.avg_downsample(e1, r)[start:start + L], wpad)
            d2 = jnp.pad(ms.avg_downsample(e2, r)[start:start + L], wpad)
            # per-scale filter variables when the geometry trains unshared
            # filters (share_filters=False), the shared trunk otherwise
            p = model._scale_params(params, s_i)
            f1f = model.filter.apply(p, d1)
            f2 = model.filter.apply(p, d2)
            f1 = f1f[g.halfh1:g.halfh1 + Hs // r,
                     g.halfw1:f1f.shape[1] - g.halfw2, :]
            costs = matching.match_ssd(f1, f2, g.maxh, g.maxw)
            dist = jax.nn.softmax(-costs, axis=-1)
            if r > 1:
                dist = jnp.repeat(jnp.repeat(dist, r, axis=0), r, axis=1)
                dist = dist[:Hs, :g.wImg]
            dists.append(dist.reshape(Hs, g.wImg, -1))
        fused = ms.apply_cascade(g, params, dists)
        return ms.middle_removal_concat(g, fused)

    mapped = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    return jax.jit(mapped)


def spatial_sharded_radial_fn(net, mesh: Mesh, axis: str = "sp"):
    """Row-sharded RADIAL (polar 1-D) matcher: the polar pair is split along
    rows (radii); each device pulls the one-sided bottom halo its conv
    footprint + hWin search needs from the device below via ppermute and
    computes its slice of ``RadialFlowNetwork.flow``. The last shard's halo
    arrives as zeros — identical to running the unsharded matcher on a
    zero-bottom-padded polar pair (the same convention as
    spatial_sharded_flow_fn; equality-tested in tests/test_parallel.py).

    Returns fn(params, polar_prev (H, W, C), polar_curr) -> (flow, min_cost)
    with H = n_devices * rows_per_shard.
    """
    from ..ops import matching

    n = mesh.devices.size
    halo = (net.h_kernel - 1) + (net.h_win - 1)
    perm = [(i + 1, i) for i in range(n - 1)]       # pull rows from below

    def local(params, s1, s2):
        h1 = jax.lax.ppermute(s1[:halo], axis, perm)
        h2 = jax.lax.ppermute(s2[:halo], axis, perm)
        e1 = jnp.concatenate([s1, h1], axis=0)
        e2 = jnp.concatenate([s2, h2], axis=0)
        fp = net.filter.apply(params, e1)[:s1.shape[0]]
        fc = net.filter.apply(params, e2)[:s1.shape[0] + net.h_win - 1]
        costs = matching.match_ssd_radial(fp, fc, net.h_win)
        return (jnp.argmin(costs, axis=-1).astype(jnp.int32),
                jnp.min(costs, axis=-1))

    mapped = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    return jax.jit(mapped)


# ---------------------------------------------------------------------------
# dp-sharded GT generation / dataset builds (the offline workload)
# ---------------------------------------------------------------------------

def _dp_shard_map(body, mesh: Mesh, axis: str, n_out: int, n_in: int = 2):
    """shard_map a per-pair-independent batched ``body`` over ``axis``.

    These offline builds are embarrassingly parallel over pairs, so
    `shard_map` (not `jit(in_shardings=...)`) is the right tool: each
    device traces ``body`` at the LOCAL batch shape, which compiles to the
    same executable as a single-device run at that shape — so every pair's
    result is BITWISE identical to an unsharded run on its local chunk
    (tests/test_parallel.py pins this). GSPMD partitioning of the global
    program would instead reorder dot products by a few ulp, and the
    ego-motion RANSAC inlier gate turns ulp drift into wholesale
    divergence on knife-edge pairs. Caveat (measured, tests/test_cli_dp.py):
    XLA may still fuse the shard_map body differently from a standalone
    jit at the same shape, so vs a FULL-BATCH unsharded build a knife-edge
    RANSAC pair can land on a different (still valid) fit; the sharded
    build itself is deterministic."""
    mapped = jax.shard_map(
        body, mesh=mesh,
        in_specs=tuple(P(axis) for _ in range(n_in)),
        out_specs=tuple(P(axis) for _ in range(n_out)) if n_out > 1
        else P(axis),
        check_vma=False,
    )
    return jax.jit(mapped)


def sharded_celiu_fn(mesh: Mesh, axis: str = "dp", **solver_kw):
    """dp-sharded celiu variational GT — the offline workload the reference
    actually batch-runs (/root/reference/groundtruth_opticalflow_celiu.lua:8-76,
    a serial loop over pairs there). The explicit-batch solver
    (flow/celiu.py coarse2fine_flow_batched) runs per device on its local
    pair chunk; no cross-device collectives at all.
    ``solver_kw`` = the solver schedule (alpha, ratio, min_width, n_outer,
    n_inner, n_sor, ...). B must be a multiple of the mesh size
    (pad_to_multiple). Returns fn(im1s, im2s) -> (vx, vy, warped), all
    dp-sharded and per-pair bitwise-equal to a single-device run at the
    local batch shape."""
    from ..flow.celiu import coarse2fine_flow_batched

    def body(im1s, im2s):
        return coarse2fine_flow_batched(im1s, im2s, **solver_kw)

    return _dp_shard_map(body, mesh, axis, n_out=3)


def sharded_rectify_fn(mesh: Mesh, cal, h: int, w: int, axis: str = "dp"):
    """dp-sharded SFM-rectification dataset build: the fused
    undistort -> ego-motion -> scale -> rotation-warp device program
    (data/datasets.py _rectify_batch_device) with the pair stack split
    across the mesh. Per-pair work is independent — no collectives.
    Returns fn(prevs, imgs) -> (prev_s, img_s, warped, mask, n_inl, n_fnd),
    per-pair bitwise-equal to a single-device run at the local batch shape
    (see _dp_shard_map for why shard_map, not GSPMD)."""
    from ..data import datasets as ds

    def body(prevs, imgs):
        return ds._rectify_batch_device(
            prevs, imgs, cal.K, tuple(cal.distortion), h, w,
            cal.sfm.max_points, cal.sfm.points_quality)

    return _dp_shard_map(body, mesh, axis, n_out=6)


def sharded_polar_load_fn(mesh: Mesh, cal, h_img: int, w_img: int,
                          h_input: int, w_input: int, w_kernel: int,
                          axis: str = "dp", clean_pixels: bool = False):
    """dp-sharded radial/polar dataset build: the fused
    ego-motion -> epipole -> rotation removal -> polar warps program
    (data/datasets.py _polar_batch_device) with the pair stack split across
    the mesh. Returns fn(prevs, imgs) -> the program's 9-tuple, dp-sharded
    and per-pair bitwise-equal to a single-device run at the local batch
    shape (see _dp_shard_map). With ``clean_pixels`` the returned fn takes
    (prevs, imgs, pixel_prevs, pixel_imgs) — the clean-targets regime
    where GT/geometry frames and patch-pixel frames are different
    recordings (train_radial's -gtd flag)."""
    from ..data import datasets as ds

    if clean_pixels:
        def body(prevs, imgs, pix_prevs, pix_imgs):
            return ds._polar_batch_device(
                prevs, imgs, cal.K, cal.wImg, cal.hImg, h_img, w_img,
                h_input, w_input, w_kernel,
                cal.sfm.max_points, cal.sfm.points_quality,
                pixel_prevs=pix_prevs, pixel_imgs=pix_imgs)
        return _dp_shard_map(body, mesh, axis, n_out=9, n_in=4)

    def body(prevs, imgs):
        return ds._polar_batch_device(
            prevs, imgs, cal.K, cal.wImg, cal.hImg, h_img, w_img,
            h_input, w_input, w_kernel,
            cal.sfm.max_points, cal.sfm.points_quality)

    return _dp_shard_map(body, mesh, axis, n_out=9)


def sharded_exhaustive_gt_fn(geom, mesh: Mesh, method: str = "max",
                             axis: str = "dp"):
    """dp-sharded cross-correlation GT (the trainer's default GT,
    /root/reference/groundtruth_opticalflow.lua:29-86 run per pair there):
    the box-filter patch-SSD program (data/groundtruth._exhaustive_batch_jit)
    with the pair stack split across the mesh. Per-pair independent — no
    collectives. Returns fn(imgs1, imgs2) -> (fy, fx, conf), dp-sharded."""
    from ..data import groundtruth as gt

    def body(a, b):
        return gt._exhaustive_batch_jit(geom, a, b, method)

    return _dp_shard_map(body, mesh, axis, n_out=3)
