"""Exhaustive cross-correlation groundtruth flow (the 'cross-correlation' GT).

Rebuilds getOpticalFlowFast (/root/reference/groundtruth_opticalflow.lua:29-86):
the reference unfolds kh*kw patches into kh*kw*C-channel feature maps and
reuses nn.SpatialMatching — i.e. GT flow is the brute-force patch-SSD WTA.

Reformulation: instead of materializing the unfolded features
(kh*kw*C channels — 177 MB at 320x180/16x16), patch SSD is computed as a
box-filter over the per-pixel squared difference for each displacement:

    cost[y, x, d] = boxsum_{kh x kw}( sum_c (im1c - shift(im2, d))^2 )[y, x]

which is mathematically identical (sum over patch of pointwise SSD) at a
fraction of the memory traffic. Decoding reuses the model's processOutput so
WTA/tie-break conventions are shared with the matcher, exactly as the
reference shares nn.SpatialMatching between model and GT.

Disk caching mirrors the reference's parameter-encoded layout
(/root/reference/groundtruth_opticalflow.lua:134-174):
``flow/<W>x<H>/<maxw>x<kw>/max/<delta>/<name>.npz``.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import Geometry
from ..models import flow as flow_model


def gt_geometry(geom: Geometry) -> Geometry:
    """The GT runs the matcher with the GT window/kernel on raw pixels
    (geometryGT construction, /root/reference/groundtruth_opticalflow.lua:30-44)."""
    return Geometry(
        hImg=geom.hImg,
        wImg=geom.wImg,
        layers=((geom.in_channels, geom.hKernelGT, geom.wKernelGT,
                 geom.hKernelGT * geom.wKernelGT * geom.in_channels),),
        maxh=geom.maxhGT,
        maxw=geom.maxwGT,
        maxhGT=geom.maxhGT,
        maxwGT=geom.maxwGT,
        hKernelGT=geom.hKernelGT,
        wKernelGT=geom.wKernelGT,
        output_extraction_method="max",
        training_mode=False,
    )


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def patch_ssd_costs(
    img1: jnp.ndarray, img2: jnp.ndarray,
    kh: int, kw: int, maxh: int, maxw: int,
) -> jnp.ndarray:
    """Cost volume of exhaustive patch matching.

    img1, img2: (H, W, C) frames. img1 is cropped by the half-window
    internally (prepareInput convention). Returns
    (H - maxh - kh + 2, W - maxw - kw + 2, maxh * maxw) SSD costs.
    """
    H, W, C = img1.shape
    h1 = -(-maxh // 2) - 1     # ceil(maxh/2) - 1
    w1 = -(-maxw // 2) - 1
    img1c = img1[h1:H - maxh // 2, w1:W - maxw // 2, :]
    Hc, Wc = img1c.shape[0], img1c.shape[1]

    # stack per-displacement pixel errors on the LAST axis first, then one
    # box-sum over all of them: the displacement dim (maxh*maxw, e.g. 256)
    # rides the 128-wide lane dimension, so the reduce_window tiles cleanly.
    # (The per-displacement 2-D reduce_window formulation lowers, under
    # vmap, to (B, H, W, 1)-shaped temps whose trailing singleton gets
    # 128x lane padding — 43 GB of HLO temps for an 8-pair batch.)
    errs = []
    for dy in range(maxh):
        for dx in range(maxw):
            diff = img1c - jax.lax.slice(
                img2, (dy, dx, 0), (dy + Hc, dx + Wc, C)
            )
            errs.append(jnp.sum(diff * diff, axis=-1))
    e = jnp.stack(errs, axis=-1)                      # (Hc, Wc, D)
    return jax.lax.reduce_window(
        e, 0.0, jax.lax.add, (kh, kw, 1), (1, 1, 1), "VALID"
    )


def exhaustive_flow(
    geom: Geometry, img1: jnp.ndarray, img2: jnp.ndarray,
    method: str = "max",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full-frame GT flow: returns (flow_y, flow_x, confidences), each
    (hImg, wImg), zero outside the valid matching interior — the contract of
    getOpticalFlowFast (/root/reference/groundtruth_opticalflow.lua:81-86).
    ``method``: 'max' (WTA, groundtruth='cross-correlation') or 'mean'
    (soft-argmax, groundtruth='cc-mean' — the {max,mean} cache split of
    :296-304)."""
    gg = gt_geometry(geom)
    costs = patch_ssd_costs(
        jnp.asarray(img1), jnp.asarray(img2),
        gg.hKernelGT, gg.wKernelGT, gg.maxh, gg.maxw,
    )
    dist = jax.nn.softmax(-costs, axis=-1)
    out = flow_model.process_output(gg, dist, process_full=True,
                                    threshold=None, method=method)
    outc = flow_model.process_output(gg, dist, process_full=True,
                                     threshold=0.0, method=method)
    return (np.asarray(out.full[0]), np.asarray(out.full[1]),
            np.asarray(outc.full_confidences))


@functools.partial(jax.jit, static_argnums=(0, 3))
def _exhaustive_batch_jit(geom: Geometry, imgs1: jnp.ndarray,
                          imgs2: jnp.ndarray, method: str = "max"):
    gg = gt_geometry(geom)

    def one(img1, img2):
        costs = patch_ssd_costs(img1, img2, gg.hKernelGT, gg.wKernelGT,
                                gg.maxh, gg.maxw)
        dist = jax.nn.softmax(-costs, axis=-1)
        out = flow_model.process_output(gg, dist, process_full=True,
                                        threshold=None, method=method)
        outc = flow_model.process_output(gg, dist, process_full=True,
                                         threshold=0.0, method=method)
        return out.full[0], out.full[1], outc.full_confidences

    return jax.vmap(one)(imgs1, imgs2)


def exhaustive_flow_batched(
    geom: Geometry, imgs1: np.ndarray, imgs2: np.ndarray, chunk: int = 8,
    method: str = "max", mesh=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched getOpticalFlowFast over a (B, H, W, C) stack of pairs:
    ceil(B/chunk) dispatches + one fetch each, vs a dispatch + 3 fetches
    per pair — the batched GT stage. ``chunk`` bounds
    the transient per-pair cost volume (~59 MB at 320x180, 16x16 window);
    the tail chunk is padded to the chunk size so only one program
    compiles.

    With ``mesh`` (a dp Mesh) each chunk is additionally split across the
    mesh devices (parallel.mesh.sharded_exhaustive_gt_fn): chunk stays the
    PER-DEVICE cost-volume bound, so a dispatch covers chunk * n_devices
    pairs. Per-pair results are bitwise-equal to the unsharded path (each
    device runs the same per-chunk program)."""
    B = imgs1.shape[0]
    sharded_fn = None
    if mesh is not None and mesh.devices.size > 1:
        from ..parallel.mesh import sharded_exhaustive_gt_fn
        sharded_fn = sharded_exhaustive_gt_fn(geom, mesh, method)
        chunk = chunk * mesh.devices.size
    fys, fxs, confs = [], [], []
    for s in range(0, B, chunk):
        a = np.asarray(imgs1[s:s + chunk], np.float32)
        b = np.asarray(imgs2[s:s + chunk], np.float32)
        n = a.shape[0]
        if n < chunk:
            reps = [(0, chunk - n)] + [(0, 0)] * (a.ndim - 1)
            a = np.pad(a, reps, mode="edge")
            b = np.pad(b, reps, mode="edge")
        if sharded_fn is not None:
            fy, fx, conf = sharded_fn(jnp.asarray(a), jnp.asarray(b))
        else:
            fy, fx, conf = _exhaustive_batch_jit(geom, jnp.asarray(a),
                                                 jnp.asarray(b), method)
        fys.append(np.asarray(fy)[:n])
        fxs.append(np.asarray(fx)[:n])
        confs.append(np.asarray(conf)[:n])
    return (np.concatenate(fys), np.concatenate(fxs), np.concatenate(confs))


# ---------------------------------------------------------------------------
# Disk cache (parameter-encoded paths, like the reference)
# ---------------------------------------------------------------------------

def _cache_path(root: str, geom: Geometry, delta: int, name: str,
                method: str = "max") -> str:
    # the reference's {max,mean} cache split (groundtruth_opticalflow.lua
    # :296-304): 'cross-correlation' -> max/, 'cc-mean' -> mean/
    return os.path.join(
        root, "flow", f"{geom.wImg}x{geom.hImg}",
        f"{geom.maxwGT}x{geom.wKernelGT}", method, str(delta), name + ".npz"
    )


def liu_flow(
    img1: jnp.ndarray, img2: jnp.ndarray,
    alpha: float = 0.005, ratio: float = 0.75, min_width: int = 30,
    n_outer: int = 5, n_inner: int = 1, n_sor: int = 40,
) -> Tuple[np.ndarray, np.ndarray]:
    """The 'liu' GT alternative: Ce Liu variational flow with the reference
    trainer's parameters (/root/reference/groundtruth_opticalflow_celiu.lua:9-14).
    Returns (flow_y, flow_x)."""
    from ..flow.celiu import coarse2fine_flow
    vx, vy, _ = coarse2fine_flow(img1, img2, alpha=alpha, ratio=ratio,
                                 min_width=min_width, n_outer=n_outer,
                                 n_inner=n_inner, n_sor=n_sor)
    return np.asarray(vy), np.asarray(vx)


def liu_cache_path(root: str, geom: Geometry, delta: int, name: str) -> str:
    return os.path.join(
        root, "flow_liu", f"{geom.wImg}x{geom.hImg}", str(delta), name + ".npz"
    )


def store_cached_liu_flow(root: str, geom: Geometry, delta: int, name: str,
                          fy, fx) -> None:
    path = liu_cache_path(root, geom, delta, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, fy=fy, fx=fx)


def cached_liu_flow(root: str, geom: Geometry, delta: int, name: str,
                    img1, img2, **kw) -> Tuple[np.ndarray, np.ndarray]:
    """Disk-cached liu GT (the reference caches PNG-encoded (v+128)/255,
    groundtruth_opticalflow_celiu.lua:63-67; we cache float npz under
    ``flow_liu/...`` with the same parameter-encoded layout)."""
    path = liu_cache_path(root, geom, delta, name)
    if os.path.exists(path):
        z = np.load(path)
        if z["fy"].shape == (geom.hImg, geom.wImg):
            return z["fy"], z["fx"]
    fy, fx = liu_flow(jnp.asarray(img1), jnp.asarray(img2), **kw)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, fy=fy, fx=fx)
    return fy, fx


def load_cached_flow(root: str, geom: Geometry, delta: int, name: str,
                     method: str = "max"
                     ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Cache read with the reference's size check (recompute on mismatch,
    /root/reference/groundtruth_opticalflow.lua:167-188). None on miss."""
    path = _cache_path(root, geom, delta, name, method)
    if os.path.exists(path):
        z = np.load(path)
        fy, fx, conf = z["fy"], z["fx"], z["conf"]
        if fy.shape == (geom.hImg, geom.wImg):
            return fy, fx, conf
    return None


def store_cached_flow(root: str, geom: Geometry, delta: int, name: str,
                      fy: np.ndarray, fx: np.ndarray,
                      conf: np.ndarray, method: str = "max") -> None:
    path = _cache_path(root, geom, delta, name, method)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, fy=fy, fx=fx, conf=conf)


def cached_exhaustive_flow(
    root: str, geom: Geometry, delta: int, name: str,
    img1: jnp.ndarray, img2: jnp.ndarray, method: str = "max",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Compute-on-miss GT cache."""
    hit = load_cached_flow(root, geom, delta, name, method)
    if hit is not None:
        return hit
    fy, fx, conf = exhaustive_flow(geom, img1, img2, method)
    store_cached_flow(root, geom, delta, name, fy, fx, conf, method)
    return fy, fx, conf
