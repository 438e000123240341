"""Dataset pipelines: SFM-rectified loaders, lazy dataset objects, radial
(polar) per-pair transforms.

Rebuilds three generations of the reference's data plumbing:
  * the SFM-rectified pair loader (loadRectifiedImageOpticalFlow2,
    /root/reference/groundtruth_opticalflow.lua:253-348): undistort ->
    ego-motion -> bad-frame rejection -> rotation-compensate the previous
    frame -> cached exhaustive GT flow on the (warped prev, current) pair,
    quantized ``floor(flow + 0.5)``;
  * the v2 OO dataset with lazy caches and patch getters
    (/root/reference/version2/data.lua:11-213);
  * the radial/polar per-pair transform (load_dataset,
    /root/reference/radial/radial_opticalflow_data.lua:182-288): ego-motion
    -> epipole e2 = K T / T3 scaled to network resolution -> rotation
    removal -> border-zeroed warp mask -> epipole-centered polar warps with
    angular kernel padding -> GT projected onto the radial direction
    (project_groundtruth :113-129) and saturated (:131-136).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import Geometry
from ..geometry3d import egomotion as ego
from ..geometry3d import polar as polar_ops
from ..geometry3d import undistort as undist
from ..geometry3d.calibration import Calibration
from . import groundtruth as gt_mod
from .images import ImageLoader, load_image, scale, scale_np


# ---------------------------------------------------------------------------
# cartesian SFM-rectified pairs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RectifiedPair:
    prev_warped: np.ndarray      # rotation-compensated previous frame
    image: np.ndarray            # current frame
    mask: np.ndarray             # warp validity
    flow: Optional[np.ndarray]   # (2, H, W) quantized GT flow
    conf: Optional[np.ndarray]
    good: bool                   # inlier-ratio gate


def load_rectified_pair(
    geom: Geometry, cal: Calibration, prev: np.ndarray, img: np.ndarray,
    cache_root: Optional[str] = None, name: str = "",
    compute_gt: bool = True, groundtruth: str = "cross-correlation",
) -> RectifiedPair:
    """SFM-rectified pair. ``groundtruth`` selects the GT generator
    (learning.groundtruth, /root/reference/groundtruth_opticalflow.lua:255,
    297-304): 'cross-correlation' (exhaustive WTA), 'cc-mean' (exhaustive
    soft-argmax) or 'liu' (variational solver)."""
    prev_u = undist.undistort_image(jnp.asarray(prev), cal.K, cal.distortion)
    img_u = undist.undistort_image(jnp.asarray(img), cal.K, cal.distortion)
    em = ego.get_ego_motion(prev_u, img_u, cal.K,
                            max_points=cal.sfm.max_points,
                            quality=cal.sfm.points_quality,
                            tracker="full")
    ratio = float(em.n_inliers) / max(float(em.n_found), 1.0)
    h, w = geom.hImg, geom.wImg
    prev_s = scale(prev_u, h, w)
    img_s = scale(img_u, h, w)
    if ratio < cal.bad_image_threshold:
        z = np.zeros((h, w), np.float32)
        return RectifiedPair(np.asarray(prev_s), np.asarray(img_s), z,
                             None, None, False)
    Ks = cal.K.copy()
    Ks[0] *= w / cal.wImg
    Ks[1] *= h / cal.hImg
    warped = undist.remove_ego_motion(prev_s, Ks, em.R)
    ones = jnp.ones((h, w, 1), jnp.float32)
    mask = np.asarray(undist.remove_ego_motion(ones, Ks, em.R)[..., 0] > 0.5,
                      np.float32)
    flow = conf = None
    if compute_gt:
        fy, fx, conf = _compute_gt(geom, warped, img_s, cache_root, name,
                                   groundtruth)
        # the reference quantizes GT: (flow+0.5):floor()
        # (groundtruth_opticalflow.lua:345)
        flow = np.floor(np.stack([fy, fx]) + 0.5).astype(np.float32)
    return RectifiedPair(np.asarray(warped), np.asarray(img_s), mask,
                         flow, conf, True)


def _compute_gt(geom, warped, img_s, cache_root, name, groundtruth):
    """GT generator dispatch (learning.groundtruth): exhaustive matching
    with WTA ('cross-correlation') or soft-argmax ('cc-mean') decode, or
    the variational solver ('liu')."""
    if groundtruth == "liu":
        if cache_root is not None and name:
            fy, fx = gt_mod.cached_liu_flow(cache_root, geom, 1, name,
                                            np.asarray(warped),
                                            np.asarray(img_s))
        else:
            fy, fx = gt_mod.liu_flow(warped, img_s)
        return fy, fx, None
    method = "mean" if groundtruth == "cc-mean" else "max"
    if cache_root is not None and name:
        return gt_mod.cached_exhaustive_flow(
            cache_root, geom, 1, name, warped, img_s, method)
    return gt_mod.exhaustive_flow(geom, warped, img_s, method)


def load_mc_pair(
    geom: Geometry, cal: Calibration, prev: np.ndarray, img: np.ndarray,
    cache_root: Optional[str] = None, name: str = "",
    compute_gt: bool = True, n_track_points: int = 200,
) -> RectifiedPair:
    """4-DoF homography rectification backend (trainer ``-mc mc``).

    The reference's mc data path (loadRectifiedImageOpticalFlow,
    /root/reference/groundtruth_opticalflow.lua:197-250) reads offline
    ``rectified_images/`` produced by motion_correction()
    (/root/reference/motion_correction.lua:243-258): GoodFeaturesToTrack
    (count=200) + PyrLK + lsq_trans_ransac + WarpAffine. As shipped that
    loader hard-errors (``error("cf code")`` :235) on the acknowledged bug
    that the *second* image was the one being corrected (TODO :234). We
    implement the intended semantics inline: fit the 4-DoF model from the
    current frame back to the previous one and warp the PREVIOUS frame into
    the current frame's coordinates, so the output pair has the same
    orientation as the sfm backend (PARITY.md documents the deviation).
    """
    from ..geometry3d import egomotion as mc_ego

    h, w = geom.hImg, geom.wImg
    prev_s = scale(jnp.asarray(prev), h, w)
    img_s = scale(jnp.asarray(img), h, w)
    # features on the previous frame, tracked forward to the current frame.
    # lsq_trans builds the warp that UNDOES the fitted motion (H maps
    # out-frame coords -> in-frame coords), so fitting prev -> cur yields H:
    # cur coords -> prev coords, the backward warp that rectifies prev.
    pts, pvalid = mc_ego.good_features_to_track(
        jnp.asarray(prev_s), n_track_points, cal.sfm.points_quality)
    pts_cur, status = mc_ego.track_lk(prev_s, img_s, pts)
    valid = np.asarray(pvalid & status)
    pts_np = np.asarray(pts)
    prev_np = np.asarray(pts_cur)
    n_valid = int(valid.sum())
    if n_valid < 8:
        z = np.zeros((h, w), np.float32)
        return RectifiedPair(np.asarray(prev_s), np.asarray(img_s), z,
                             None, None, False)
    # static shapes for the jitted RANSAC: repeat valid points into the
    # invalid slots instead of dynamically shrinking the array
    sel = np.where(valid)[0]
    fill = sel[np.arange(n_track_points) % n_valid]
    idx = np.where(valid, np.arange(n_track_points), fill)
    H, inliers = mc_ego.lsq_trans_ransac(
        jnp.asarray(pts_np[idx]), jnp.asarray(prev_np[idx]), w / 2, h / 2)
    if float(inliers) / n_track_points < cal.bad_image_threshold:
        z = np.zeros((h, w), np.float32)
        return RectifiedPair(np.asarray(prev_s), np.asarray(img_s), z,
                             None, None, False)
    warped = mc_ego.warp_affine(prev_s, H)
    ones = jnp.ones((h, w), jnp.float32)
    mask = np.asarray(mc_ego.warp_affine(ones, H) > 0.5, np.float32)
    flow = conf = None
    if compute_gt:
        if cache_root is not None and name:
            fy, fx, conf = gt_mod.cached_exhaustive_flow(
                cache_root, geom, 1, name + "_mc", warped, img_s)
        else:
            fy, fx, conf = gt_mod.exhaustive_flow(geom, warped, img_s)
        flow = np.floor(np.stack([fy, fx]) + 0.5).astype(np.float32)
    return RectifiedPair(np.asarray(warped), np.asarray(img_s), mask,
                         flow, conf, True)


def load_plain_pair(
    geom: Geometry, cal: Calibration, prev: np.ndarray, img: np.ndarray,
    cache_root: Optional[str] = None, name: str = "",
    compute_gt: bool = True,
) -> RectifiedPair:
    """No rectification (trainer without -mc): raw scaled consecutive frames
    (loadImageOpticalFlow, /root/reference/groundtruth_opticalflow.lua:156-195)."""
    h, w = geom.hImg, geom.wImg
    # host-side resize: no device scale + fetch per frame (scale_np matches
    # scale, tested)
    prev_s = scale_np(np.asarray(prev), h, w)
    img_s = scale_np(np.asarray(img), h, w)
    mask = np.ones((h, w), np.float32)
    flow = conf = None
    if compute_gt:
        if cache_root is not None and name:
            fy, fx, conf = gt_mod.cached_exhaustive_flow(
                cache_root, geom, 1, name + "_raw", prev_s, img_s)
        else:
            fy, fx, conf = gt_mod.exhaustive_flow(geom, prev_s, img_s)
        flow = np.floor(np.stack([fy, fx]) + 0.5).astype(np.float32)
    return RectifiedPair(prev_s, img_s, mask, flow, conf, True)


_PAIR_LOADERS = {"sfm": load_rectified_pair, "mc": load_mc_pair,
                 None: load_plain_pair}


# ---------------------------------------------------------------------------
# batched rectification: one device program for a whole stack of pairs
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7))
def _rectify_batch_device(prevs, imgs, K, dist, h: int, w: int,
                          max_points: int, quality: float):
    """Fused undistort -> ego-motion -> scale -> rotation-warp for a stack
    of (B, H, W, C) frame pairs, vmapped into ONE XLA program instead of
    ~7 dispatches + fetches per pair on the eager path. Uses the same
    scale / tracker / RANSAC key as the per-pair path, so outputs match."""
    from .images import scale as _scale

    K = jnp.asarray(K, jnp.float32)
    sx = w / prevs.shape[2]
    sy = h / prevs.shape[1]
    Ks = K.at[0].mul(sx).at[1].mul(sy)

    key = jax.random.PRNGKey(1)           # get_ego_motion's default key

    def one(prev, img):
        prev_u = undist.undistort_image(prev, K, dist)
        img_u = undist.undistort_image(img, K, dist)
        pts, pvalid = ego.good_features_to_track(prev_u, max_points, quality)
        pts2, status = ego.track_lk(prev_u, img_u, pts)
        em = ego.get_ego_motion_from_matches(pts, pts2, pvalid & status, K,
                                             key=key)
        prev_s = _scale(prev_u, h, w)
        img_s = _scale(img_u, h, w)
        warped = undist.remove_ego_motion(prev_s, Ks, em.R)
        ones = jnp.ones((h, w, 1), jnp.float32)
        mask = undist.remove_ego_motion(ones, Ks, em.R)[..., 0] > 0.5
        return (prev_s, img_s, warped, mask.astype(jnp.float32),
                em.n_inliers, em.n_found)

    return jax.vmap(one)(prevs, imgs)


def load_rectified_pairs_batched(
    geom: Geometry, cal: Calibration, frames: List[np.ndarray],
    cache_root: Optional[str] = None, names: Optional[List[str]] = None,
    compute_gt: bool = True, delta: int = 1,
    groundtruth: str = "cross-correlation", mesh=None,
) -> List[RectifiedPair]:
    """Batched loadRectifiedImageOpticalFlow2 over consecutive frames:
    the whole rectification stack runs as one jitted program for all pairs
    (one dispatch + one scalar fetch instead of ~7 round-trips per pair).
    GT flow still goes through the per-pair disk cache.

    With ``mesh`` (a dp Mesh — the CLI --dp flag) the pair stack is split
    across the mesh devices for BOTH the rectification program
    (parallel.mesh.sharded_rectify_fn) and the GT build (sharded
    exhaustive matcher, or the dp-sharded explicit-batch celiu solver for
    'liu'). Each device runs the per-pair program at its LOCAL batch
    shape; vs the full-batch unsharded program XLA's fusion order differs
    at the ulp level (tests/test_cli_dp.py pins the tolerance)."""
    pairs_prev = np.stack(frames[:-delta]).astype(np.float32)
    pairs_img = np.stack(frames[delta:]).astype(np.float32)
    if mesh is not None and mesh.devices.size > 1:
        from ..parallel import mesh as pm
        rect_fn = pm.sharded_rectify_fn(mesh, cal, geom.hImg, geom.wImg)
        pp, n_real = pm.pad_to_multiple(pairs_prev, mesh.devices.size)
        pi, _ = pm.pad_to_multiple(pairs_img, mesh.devices.size)
        outs = rect_fn(jnp.asarray(pp), jnp.asarray(pi))
        prev_s, img_s, warped, mask, n_inl, n_fnd = (
            np.asarray(o)[:n_real] for o in outs)
    else:
        prev_s, img_s, warped, mask, n_inl, n_fnd = _rectify_batch_device(
            jnp.asarray(pairs_prev), jnp.asarray(pairs_img), cal.K,
            tuple(cal.distortion), geom.hImg, geom.wImg,
            cal.sfm.max_points, cal.sfm.points_quality)
    n_inl = np.asarray(n_inl)
    n_fnd = np.asarray(n_fnd)
    prev_s = np.asarray(prev_s)
    img_s = np.asarray(img_s)
    warped = np.asarray(warped)
    mask = np.asarray(mask)

    B = pairs_prev.shape[0]
    good = [float(n_inl[k]) / max(float(n_fnd[k]), 1.0)
            >= cal.bad_image_threshold for k in range(B)]

    # GT: serve cache hits from disk, compute all misses in chunked batched
    # dispatches (one fetch per chunk instead of 3 per pair)
    gts: Dict[int, Tuple] = {}
    if compute_gt and groundtruth == "liu" and mesh is not None \
            and mesh.devices.size > 1:
        # dp-sharded liu GT: cache hits from disk, all misses through the
        # explicit-batch solver split across the mesh (sharded_celiu_fn —
        # explicit batch, so the B>=4 vmap crash does not apply)
        from ..parallel import mesh as pm
        misses = []
        for k in range(B):
            if not good[k]:
                continue
            name = names[k] if names else ""
            if cache_root is not None and name:
                path = gt_mod.liu_cache_path(cache_root, geom, 1, name)
                if os.path.exists(path):
                    z = np.load(path)
                    if z["fy"].shape == (geom.hImg, geom.wImg):
                        gts[k] = (z["fy"], z["fx"], None)
                        continue
            misses.append(k)
        if misses:
            celiu_fn = pm.sharded_celiu_fn(
                mesh, alpha=0.005, ratio=0.75, min_width=30,
                n_outer=5, n_inner=1, n_sor=40)
            im1, n_real = pm.pad_to_multiple(
                np.asarray(warped)[misses], mesh.devices.size)
            im2, _ = pm.pad_to_multiple(
                np.asarray(img_s)[misses], mesh.devices.size)
            vx, vy, _w = celiu_fn(jnp.asarray(im1), jnp.asarray(im2))
            vx, vy = np.asarray(vx)[:n_real], np.asarray(vy)[:n_real]
            for j, k in enumerate(misses):
                gts[k] = (vy[j], vx[j], None)
                name = names[k] if names else ""
                if cache_root is not None and name:
                    gt_mod.store_cached_liu_flow(cache_root, geom, 1, name,
                                                 vy[j], vx[j])
    elif compute_gt and groundtruth == "liu":
        # per pair, with the disk cache
        for k in range(B):
            if good[k]:
                name = names[k] if names else ""
                gts[k] = _compute_gt(geom, warped[k], img_s[k],
                                     cache_root, name, "liu")
    elif compute_gt:
        method = "mean" if groundtruth == "cc-mean" else "max"
        misses = []
        for k in range(B):
            if not good[k]:
                continue
            name = names[k] if names else ""
            if cache_root is not None and name:
                hit = gt_mod.load_cached_flow(cache_root, geom, 1, name,
                                              method)
                if hit is not None:
                    gts[k] = hit
                    continue
            misses.append(k)
        if misses:
            fy, fx, conf = gt_mod.exhaustive_flow_batched(
                geom, warped[misses], img_s[misses], method=method,
                mesh=mesh)
            for j, k in enumerate(misses):
                gts[k] = (fy[j], fx[j], conf[j])
                name = names[k] if names else ""
                if cache_root is not None and name:
                    gt_mod.store_cached_flow(cache_root, geom, 1, name,
                                             fy[j], fx[j], conf[j], method)

    out = []
    for k in range(B):
        if not good[k]:
            out.append(RectifiedPair(
                prev_s[k], img_s[k],
                np.zeros((geom.hImg, geom.wImg), np.float32),
                None, None, False))
            continue
        flow = conf = None
        if compute_gt:
            fy, fx, conf = gts[k]
            flow = np.floor(np.stack([fy, fx]) + 0.5).astype(np.float32)
        out.append(RectifiedPair(warped[k], img_s[k], mask[k], flow, conf,
                                 True))
    return out


def load_data_optical_flow(
    geom: Geometry, cal: Calibration, directory: str, n_images: int,
    first: int = 0, delta: int = 1, cache_root: Optional[str] = None,
    motion_correction: Optional[str] = "sfm",
    groundtruth: str = "cross-correlation", mesh=None,
) -> Dict[str, list]:
    """Dataset assembly (loadDataOpticalFlowCCLiu,
    /root/reference/groundtruth_opticalflow.lua:350-413): consecutive frames
    from ``directory/images/``, rectified by the selected backend
    (``motion_correction``: 'sfm' | 'mc' | None — the trainer's -mc flag,
    :370-413), with GT flow per pair. ``mesh`` (dp Mesh) shards the
    batched 'sfm' rectification + GT build across devices (the CLI --dp
    flag; the per-pair 'mc'/None backends ignore it)."""
    raw = {"images": [], "warped_images": [], "masks": [], "flow": []}
    loader = ImageLoader(directory, cal.hImg, cal.wImg, first)
    if motion_correction == "sfm":
        # batched path: every (delta-strided) frame, one fused device
        # program for the whole rectification stack
        frames = []
        while len(frames) < n_images:
            for _ in range(delta - 1 if frames else 0):
                loader.get_next_frame()
            f = loader.get_next_frame()
            if f is None:
                break
            frames.append(f)
        if len(frames) < 2:
            raise ValueError(f"need >= 2 frames under {directory}")
        names = [f"{first + k * delta:09d}" for k in range(len(frames) - 1)]
        pairs = load_rectified_pairs_batched(geom, cal, frames,
                                             cache_root, names,
                                             groundtruth=groundtruth,
                                             mesh=mesh)
        for pair in pairs:
            raw["images"].append(pair.image)
            raw["warped_images"].append(pair.prev_warped)
            raw["masks"].append(pair.mask)
            raw["flow"].append(pair.flow if pair.good else None)
        raw["images"].append(scale_np(np.asarray(frames[-1]),
                                      geom.hImg, geom.wImg))
        return raw

    pair_loader = _PAIR_LOADERS[motion_correction]
    prev = loader.get_next_frame()
    for k in range(n_images - 1):
        for _ in range(delta - 1):
            loader.get_next_frame()
        img = loader.get_next_frame()
        if img is None:
            break
        pair = pair_loader(geom, cal, prev, img,
                           cache_root, f"{first + k * delta:09d}")
        raw["images"].append(pair.image)
        raw["warped_images"].append(pair.prev_warped)
        raw["masks"].append(pair.mask)
        raw["flow"].append(pair.flow if pair.good else None)
        prev = img
    # trailing frame for the last pair's second image
    raw["images"].append(prev if isinstance(prev, np.ndarray) else np.asarray(prev))
    return raw


# ---------------------------------------------------------------------------
# v2-style lazy dataset object
# ---------------------------------------------------------------------------

class FlowDataset:
    """Lazy per-frame caches over an image directory (version2/data.lua
    new_dataset): full/scaled images, rectified previous frames, masks, GT."""

    def __init__(self, geom: Geometry, cal: Calibration, directory: str,
                 delta: int = 1, cache_root: Optional[str] = None):
        self.geom = geom
        self.cal = cal
        self.dir = directory
        self.delta = delta
        self.cache_root = cache_root
        imgdir = os.path.join(directory, "images")
        self.names = sorted(
            f for f in os.listdir(imgdir) if f.endswith((".jpg", ".png")))
        self._full: Dict[int, np.ndarray] = {}
        self._pairs: Dict[int, RectifiedPair] = {}

    def __len__(self) -> int:
        return len(self.names)

    def get_full_image(self, i: int) -> np.ndarray:
        if i not in self._full:
            img = load_image(os.path.join(self.dir, "images", self.names[i]))
            if img.shape[:2] != (self.cal.hImg, self.cal.wImg):
                img = scale_np(img, self.cal.hImg, self.cal.wImg)
            self._full[i] = img
        return self._full[i]

    def get_image(self, i: int) -> np.ndarray:
        return self._pair(i).image

    def get_prev_image(self, i: int) -> np.ndarray:
        """Rectified (rotation-compensated) previous frame
        (version2/data.lua:85-104)."""
        return self._pair(i).prev_warped

    def get_mask(self, i: int) -> np.ndarray:
        return self._pair(i).mask

    def get_gt(self, i: int) -> Optional[np.ndarray]:
        return self._pair(i).flow

    def _pair(self, i: int) -> RectifiedPair:
        assert i >= self.delta, "no previous frame"
        if i not in self._pairs:
            self._pairs[i] = load_rectified_pair(
                self.geom, self.cal,
                self.get_full_image(i - self.delta), self.get_full_image(i),
                self.cache_root, self.names[i].split(".")[0])
        return self._pairs[i]

    def get_patches(self, n: int, rng: np.random.RandomState,
                    learning=None):
        """Patch sampler with mask/flow-window rejection
        (version2/data.lua:169-210) — delegates to training.sample_patches."""
        from ..geometry import Learning
        from ..training.train import sample_patches
        learning = learning or Learning()
        # interleave (warped_prev, image) pairs; flow valid only from a
        # warped frame to its own current frame
        images, flows, masks = [], [], []
        for i in range(self.delta, len(self)):
            p = self._pair(i)
            if not p.good:
                continue
            images.extend([p.prev_warped, p.image])
            flows.extend([p.flow, None])
            masks.extend([p.mask, None])
        assert images, "no good pairs in dataset"
        flows = flows[:-1]
        masks = masks[:-1]
        return sample_patches(self.geom, learning, images, flows, masks,
                              n, rng)


# ---------------------------------------------------------------------------
# radial / polar pipeline
# ---------------------------------------------------------------------------

def flow_norm(flow: np.ndarray) -> np.ndarray:
    return np.sqrt(flow[0] ** 2 + flow[1] ** 2) + 1e-12


def project_groundtruth(flow: np.ndarray, gds: np.ndarray, e2) -> Tuple[np.ndarray, np.ndarray]:
    """Project cartesian GT flow onto the radial (epipolar) direction
    (project_groundtruth, /root/reference/radial/radial_opticalflow_data.lua:113-129).
    Returns (proj (H, W) int-valued, gds updated in the same & >= 0 sense)."""
    H, W = flow.shape[1], flow.shape[2]
    ys = np.arange(H, dtype=np.float32)[:, None] - float(e2[1])
    xs = np.arange(W, dtype=np.float32)[None, :] - float(e2[0])
    radial = np.stack([np.broadcast_to(ys, (H, W)),
                       np.broadcast_to(xs, (H, W))])
    n = flow_norm(radial)
    radial = radial / n
    projf = flow[0] * radial[0] + flow[1] * radial[1]
    proj = np.floor(projf + 0.5)
    gds = gds * (projf >= 0)
    return proj.astype(np.float32), gds.astype(np.float32)


def saturate_groundtruth(flow: np.ndarray, gds: np.ndarray, maxflow: float):
    """Clamp projected GT to maxflow and invalidate clamped pixels
    (radial_opticalflow_data.lua:131-136)."""
    sat = (flow <= maxflow).astype(np.float32)
    flow = flow * sat + (1 - sat) * maxflow
    gds = gds * sat
    return flow, gds


@dataclasses.dataclass
class PolarPair:
    polar_image: np.ndarray
    polar_prev_image: np.ndarray
    polar_mask: np.ndarray
    e2: np.ndarray
    good: bool
    polar_gt: Optional[np.ndarray] = None
    polar_gt_mask: Optional[np.ndarray] = None


def load_polar_pair(
    cal: Calibration, prev: np.ndarray, img: np.ndarray,
    h_img: int, w_img: int, h_input: int, w_input: int, w_kernel: int,
    geom_gt: Optional[Geometry] = None, max_flow: Optional[float] = None,
) -> PolarPair:
    """One step of the radial load_dataset loop
    (radial_opticalflow_data.lua:182-288) — delegates to the fused device
    program (one dispatch instead of ~8 per pair).
    ``load_polar_pair_reference`` keeps the
    step-by-step host formulation the equivalence test pins against."""
    return load_polar_pairs_batched(
        cal, [np.asarray(prev), np.asarray(img)], h_img, w_img,
        h_input, w_input, w_kernel, geom_gt, max_flow)[0]


def load_polar_pair_reference(
    cal: Calibration, prev: np.ndarray, img: np.ndarray,
    h_img: int, w_img: int, h_input: int, w_input: int, w_kernel: int,
    geom_gt: Optional[Geometry] = None, max_flow: Optional[float] = None,
) -> PolarPair:
    """Step-by-step per-pair formulation (the literal
    radial_opticalflow_data.lua:182-288 port); kept as the semantic
    reference for the batched/fused path."""
    em = ego.get_ego_motion(jnp.asarray(prev), jnp.asarray(img), cal.K,
                            max_points=cal.sfm.max_points,
                            quality=cal.sfm.points_quality,
                            tracker="full")
    ratio = float(em.n_inliers) / max(float(em.n_found), 1.0)
    e2_full = np.asarray(ego.epipole(cal.K, em.T))
    e2 = e2_full * (w_img / cal.wImg)
    if ratio < cal.bad_image_threshold:
        z = np.zeros((h_input, w_input), np.float32)
        return PolarPair(z, z, z, e2, False)

    img_s = scale(jnp.asarray(img), h_img, w_img)
    prev_s = scale(jnp.asarray(prev), h_img, w_img)
    Ks = cal.K.copy()
    Ks[0] *= w_img / cal.wImg
    Ks[1] *= h_img / cal.hImg
    prev_w = undist.remove_ego_motion(prev_s, Ks, em.R)
    ones = jnp.ones((h_img, w_img, 1), jnp.float32)
    mask = np.asarray(undist.remove_ego_motion(ones, Ks, em.R)[..., 0] > 0.5,
                      np.float32)
    # zero the outermost border (radial_opticalflow_data.lua:233-239)
    mask[0, :] = 0
    mask[-1, :] = 0
    mask[:, 0] = 0
    mask[:, -1] = 0

    rmax = polar_ops.get_rmax(h_img, w_img, e2)
    grid = polar_ops.get_c2p_grid(
        w_img, h_img, w_input, h_input, float(e2[0]), float(e2[1]),
        lpadding=(w_kernel - 1) // 2, rpadding=(w_kernel - 1) - (w_kernel - 1) // 2,
        rmax=rmax)
    p_img = np.asarray(polar_ops.warp_grid(img_s, grid))
    p_prev = np.asarray(polar_ops.warp_grid(prev_w, grid))
    p_mask = np.asarray(
        polar_ops.warp_grid(jnp.asarray(mask)[..., None], grid)[..., 0] > 0,
        np.float32)

    p_gt = p_gt_mask = None
    if geom_gt is not None:
        fy, fx, conf = gt_mod.exhaustive_flow(geom_gt, np.asarray(prev_w),
                                              np.asarray(img_s))
        flow = np.stack([fy, fx])
        gds = (conf > 0).astype(np.float32) * mask
        proj, gds = project_groundtruth(flow, gds, e2)
        if max_flow is not None:
            # max_flow is in POLAR ROWS (hWin - 1); the projected GT is in
            # cartesian radial pixels, so the saturation threshold converts
            # by rmax/hInput (radial_opticalflow_data.lua:273)
            proj, gds = saturate_groundtruth(
                proj, gds, max_flow * float(rmax) / h_input)
        proj = proj * gds
        both = np.stack([proj, gds])[:, None]  # (2, 1, H, W) channel dim
        warped = np.asarray(polar_ops.warp_grid(
            jnp.asarray(np.moveaxis(both[:, 0], 0, -1)), grid))
        # cartesian radial pixels -> polar rows: the polar warp maps
        # r in [0, rmax] onto hInput rows, so a radial displacement of d
        # pixels is d*hInput/rmax rows (radial_opticalflow_data.lua:278)
        p_gt = warped[..., 0] * (h_input / float(rmax))
        p_gt_mask = (warped[..., 1] > 0.99).astype(np.float32)
    return PolarPair(p_img, p_prev, p_mask, e2, True, p_gt, p_gt_mask)


def _rmax_traced(h: int, w: int, ex, ey):
    """get_rmax with traced epipole (floor(sqrt(max corner distance^2)),
    radial_opticalflow_polar.lua:4-10)."""
    d = jnp.maximum(
        jnp.maximum(ex * ex + ey * ey, (w - ex) ** 2 + ey * ey),
        jnp.maximum(ex * ex + (h - ey) ** 2, (w - ex) ** 2 + (h - ey) ** 2))
    return jnp.floor(jnp.sqrt(d))


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6, 7, 8, 9, 10))
def _polar_batch_device(prevs, imgs, K, cal_w: int, cal_h: int,
                        h_img: int, w_img: int, h_input: int, w_input: int,
                        w_kernel: int, max_points: int = 400,
                        quality: float = 0.001,
                        pixel_prevs=None, pixel_imgs=None):
    """Fused ego-motion -> epipole -> rotation removal -> polar warps for a
    (B, H, W, C) stack of frame pairs — one XLA program (the batched
    radial_opticalflow_data.lua:182-288 loop; the per-pair eager form costs
    ~8 dispatches and fetches).

    ``pixel_prevs``/``pixel_imgs`` (optional, same shapes) split the frame
    roles: geometry (ego-motion, epipole, polar grid, masks) and the
    cartesian intermediates the GT matcher consumes come from
    ``prevs``/``imgs``, while the returned polar PIXEL images are the
    pixel frames warped through that same geometry. This is the
    clean-targets training regime (train on noisy pixels, supervise with
    GT from the aligned clean frames) — and exactly the fair-evaluation
    construction of the noisy quality rows."""
    from .images import scale as _scale

    K = jnp.asarray(K, jnp.float32)
    Ks = K.at[0].mul(w_img / cal_w).at[1].mul(h_img / cal_h)
    key = jax.random.PRNGKey(1)
    lp = (w_kernel - 1) // 2
    rp = (w_kernel - 1) - lp
    if pixel_prevs is None:
        pixel_prevs, pixel_imgs = prevs, imgs

    def one(prev, img, pix_prev, pix_img):
        pts, pvalid = ego.good_features_to_track(prev, max_points, quality)
        pts2, status = ego.track_lk(prev, img, pts)
        em = ego.get_ego_motion_from_matches(pts, pts2, pvalid & status, K,
                                             key=key)
        e2 = ego.epipole(K, em.T) * (w_img / cal_w)
        img_s = _scale(img, h_img, w_img)
        prev_s = _scale(prev, h_img, w_img)
        prev_w = undist.remove_ego_motion(prev_s, Ks, em.R)
        ones = jnp.ones((h_img, w_img, 1), jnp.float32)
        mask = (undist.remove_ego_motion(ones, Ks, em.R)[..., 0]
                > 0.5).astype(jnp.float32)
        border = jnp.zeros((h_img, w_img), jnp.float32).at[1:-1, 1:-1].set(1.0)
        mask = mask * border
        rmax = _rmax_traced(h_img, w_img, e2[0], e2[1])
        grid = polar_ops.get_c2p_grid(w_img, h_img, w_input, h_input,
                                      e2[0], e2[1], lpadding=lp,
                                      rpadding=rp, rmax=rmax)
        # pixel frames ride the geometry frames' transform chain (when the
        # two sets are identical XLA CSEs the duplicate warps away)
        pix_img_s = _scale(pix_img, h_img, w_img)
        pix_prev_w = undist.remove_ego_motion(_scale(pix_prev, h_img, w_img),
                                              Ks, em.R)
        p_img = polar_ops.warp_grid(pix_img_s, grid)
        p_prev = polar_ops.warp_grid(pix_prev_w, grid)
        p_mask = (polar_ops.warp_grid(mask[..., None], grid)[..., 0]
                  > 0).astype(jnp.float32)
        return (p_img, p_prev, p_mask, e2, em.n_inliers, em.n_found,
                prev_w, img_s, mask)

    return jax.vmap(one)(prevs, imgs, pixel_prevs, pixel_imgs)


@functools.partial(jax.jit, static_argnums=(5, 6, 7, 8, 9))
def _polar_gt_batch_device(flows_y, flows_x, confs, masks, e2s,
                           h_img: int, w_img: int, h_input: int,
                           w_input: int, w_kernel: int,
                           max_flow: float = jnp.inf):
    """Vmapped GT projection onto the radial direction + saturation +
    polar warp (project_groundtruth/saturate, radial_opticalflow_data.lua
    :113-136, :254-281)."""
    lp = (w_kernel - 1) // 2
    rp = (w_kernel - 1) - lp

    def one(fy, fx, conf, mask, e2):
        ys = jnp.arange(h_img, dtype=jnp.float32)[:, None] - e2[1]
        xs = jnp.arange(w_img, dtype=jnp.float32)[None, :] - e2[0]
        n = jnp.sqrt(ys * ys + xs * xs) + 1e-12
        projf = (fy * ys + fx * xs) / n
        proj = jnp.floor(projf + 0.5)
        gds = (conf > 0).astype(jnp.float32) * mask * (projf >= 0)
        rmax = _rmax_traced(h_img, w_img, e2[0], e2[1])
        # max_flow is in POLAR ROWS (hWin - 1); saturate in cartesian
        # radial pixels at max_flow*rmax/hInput
        # (radial_opticalflow_data.lua:273)
        max_flow_cart = max_flow * rmax / h_input
        sat = (proj <= max_flow_cart).astype(jnp.float32)
        proj = jnp.where(sat > 0, proj, max_flow_cart)  # inf-safe clamp
        gds = gds * sat
        proj = proj * gds
        grid = polar_ops.get_c2p_grid(w_img, h_img, w_input, h_input,
                                      e2[0], e2[1], lpadding=lp,
                                      rpadding=rp, rmax=rmax)
        both = jnp.stack([proj, gds], axis=-1)
        warped = polar_ops.warp_grid(both, grid)
        # cartesian radial pixels -> polar rows (hInput/rmax,
        # radial_opticalflow_data.lua:278)
        return (warped[..., 0] * (h_input / rmax),
                (warped[..., 1] > 0.99).astype(jnp.float32))

    return jax.vmap(one)(flows_y, flows_x, confs, masks, e2s)


def load_polar_pairs_batched(
    cal: Calibration, frames: List[np.ndarray],
    h_img: int, w_img: int, h_input: int, w_input: int, w_kernel: int,
    geom_gt: Optional[Geometry] = None, max_flow: Optional[float] = None,
    delta: int = 1, pixel_frames: Optional[List[np.ndarray]] = None,
    mesh=None,
) -> List[PolarPair]:
    """Batched radial load_dataset: the whole ego-motion/polar-warp stack
    for all consecutive pairs runs as one device program; GT (if requested)
    goes through the chunked batched exhaustive matcher and one more
    vmapped projection/warp program. Semantics per pair match
    load_polar_pair (same tracker key and scale).

    ``pixel_frames`` (optional, index-aligned with ``frames``) splits the
    frame roles: ``frames`` drive geometry + GT, ``pixel_frames`` supply
    the polar pixel images — the clean-targets regime (see
    _polar_batch_device)."""
    prevs = jnp.asarray(np.stack(frames[:-delta]).astype(np.float32))
    imgs = jnp.asarray(np.stack(frames[delta:]).astype(np.float32))
    pix_prevs = pix_imgs = None
    if pixel_frames is not None:
        if len(pixel_frames) != len(frames):
            raise ValueError("pixel_frames must be index-aligned with "
                             f"frames ({len(pixel_frames)} vs {len(frames)})")
        pix_prevs = jnp.asarray(
            np.stack(pixel_frames[:-delta]).astype(np.float32))
        pix_imgs = jnp.asarray(
            np.stack(pixel_frames[delta:]).astype(np.float32))
    if mesh is not None and mesh.devices.size > 1:
        # dp-sharded build (the CLI --dp flag): pair stack split across
        # the mesh; per-pair equal to the unsharded program up to XLA's
        # local-batch-shape fusion reordering (ulp level)
        from ..parallel import mesh as pm
        nd = mesh.devices.size
        polar_fn = pm.sharded_polar_load_fn(
            mesh, cal, h_img, w_img, h_input, w_input, w_kernel,
            clean_pixels=pix_prevs is not None)
        pp, n_real = pm.pad_to_multiple(np.asarray(prevs), nd)
        pi, _ = pm.pad_to_multiple(np.asarray(imgs), nd)
        if pix_prevs is not None:
            xp, _ = pm.pad_to_multiple(np.asarray(pix_prevs), nd)
            xi, _ = pm.pad_to_multiple(np.asarray(pix_imgs), nd)
            outs = polar_fn(jnp.asarray(pp), jnp.asarray(pi),
                            jnp.asarray(xp), jnp.asarray(xi))
        else:
            outs = polar_fn(jnp.asarray(pp), jnp.asarray(pi))
        (p_img, p_prev, p_mask, e2s, n_inl, n_fnd,
         prev_w, img_s, masks) = (jnp.asarray(np.asarray(o)[:n_real])
                                  for o in outs)
    else:
        (p_img, p_prev, p_mask, e2s, n_inl, n_fnd,
         prev_w, img_s, masks) = _polar_batch_device(
            prevs, imgs, cal.K, cal.wImg, cal.hImg, h_img, w_img,
            h_input, w_input, w_kernel,
            cal.sfm.max_points, cal.sfm.points_quality,
            pixel_prevs=pix_prevs, pixel_imgs=pix_imgs)
    n_inl = np.asarray(n_inl)
    n_fnd = np.asarray(n_fnd)
    e2s_np = np.asarray(e2s)
    B = prevs.shape[0]
    good = [float(n_inl[k]) / max(float(n_fnd[k]), 1.0)
            >= cal.bad_image_threshold for k in range(B)]

    gt_polar = gt_mask_polar = None
    if geom_gt is not None:
        fy, fx, conf = gt_mod.exhaustive_flow_batched(
            geom_gt, np.asarray(prev_w), np.asarray(img_s), chunk=2,
            mesh=mesh)
        gt_polar, gt_mask_polar = _polar_gt_batch_device(
            jnp.asarray(fy), jnp.asarray(fx), jnp.asarray(conf),
            masks, e2s, h_img, w_img, h_input, w_input, w_kernel,
            float(max_flow) if max_flow is not None else float("inf"))
        gt_polar = np.asarray(gt_polar)
        gt_mask_polar = np.asarray(gt_mask_polar)

    p_img = np.asarray(p_img)
    p_prev = np.asarray(p_prev)
    p_mask = np.asarray(p_mask)
    out = []
    for k in range(B):
        if not good[k]:
            z = np.zeros((h_input, w_input), np.float32)
            out.append(PolarPair(z, z, z, e2s_np[k], False))
            continue
        out.append(PolarPair(
            p_img[k], p_prev[k], p_mask[k], e2s_np[k], True,
            None if gt_polar is None else gt_polar[k],
            None if gt_mask_polar is None else gt_mask_polar[k]))
    return out


def smooth_epipole(prev_e2: Optional[np.ndarray], e2: np.ndarray,
                   h_img: int, w_img: int, alpha: float = 0.5) -> np.ndarray:
    """EMA epipole smoothing with out-of-frame fallback
    (/root/reference/radial/test_radial_opticalflow.lua:173-181)."""
    if prev_e2 is None:
        return e2
    if not (0 <= e2[0] < w_img and 0 <= e2[1] < h_img):
        return prev_e2
    return alpha * e2 + (1 - alpha) * prev_e2


def generate_polar_training_patches(
    pair: PolarPair, h_patch: int, w_patch: int, h_win: int,
    n: int, rng: np.random.RandomState,
):
    """Polar patch sampler with mask + GT-mask rejection
    (generate_training_patches, radial_opticalflow_data.lua:306-343).

    Patches are exactly (h_patch, w_patch) with h_patch = hKernel + hWin - 1
    — the trainer network produces ONE matcher output row per patch
    (getTrainerNetwork's Reshape(hWin)) and the target is the GT at that
    row's receptive-field center, hOffset = ceil(hKernel/2) - 1, matching
    the reference sampler. (A prior revision sliced h_patch + hWin - 1
    rows, giving hWin output rows against single-row targets — the trainer
    head optimized a misaligned objective; exposed by the dossier's radial
    quality row.) Deviation: the reference reads the GT at the patch's
    LEFT column (wOffset = 0); we read it at the output column's
    receptive-field center, which is what the flow value at the output
    pixel actually is. Masks must be valid over the whole prev patch
    (mask_patch:lt(0.1):sum() == 0).

    Returns (prev_patches, curr_patches, targets) with targets in
    [0, h_win)."""
    H, W = pair.polar_image.shape[:2]
    if H < h_patch or W < w_patch:
        raise ValueError(
            f"polar image {H}x{W} smaller than the patch {h_patch}x{w_patch}")
    h_kernel = h_patch - h_win + 1
    h_off = (h_kernel + 1) // 2 - 1          # ceil(hKernel/2) - 1
    w_off = w_patch // 2
    p1, p2, ts = [], [], []
    tries = 0
    while len(ts) < n and tries < n * 300:
        tries += 1
        # randint's high bound is exclusive: +1 so the last valid origin
        # (touching the largest radius, where radial flow is largest) is
        # sampled too
        y = rng.randint(0, H - h_patch + 1)
        x = rng.randint(0, W - w_patch + 1)
        yc, xc = y + h_off, x + w_off
        if pair.polar_mask[y:y + h_patch, x:x + w_patch].min() < 0.1:
            continue
        if pair.polar_gt_mask is not None:
            gx = min(xc, pair.polar_gt_mask.shape[1] - 1)
            gy = min(yc, pair.polar_gt_mask.shape[0] - 1)
            if pair.polar_gt_mask[gy, gx] < 0.5:
                continue
            t = pair.polar_gt[gy, gx]
        else:
            t = 0.0
        t = float(np.floor(t + 0.5))
        if not (0 <= t < h_win):
            continue
        p1.append(pair.polar_prev_image[y:y + h_patch, x:x + w_patch])
        p2.append(pair.polar_image[y:y + h_patch, x:x + w_patch])
        ts.append(int(t))
    if not ts:
        return None
    return (np.stack(p1).astype(np.float32), np.stack(p2).astype(np.float32),
            np.asarray(ts, np.int32))
