"""Batched FULL online pipeline: B independent streams per device dispatch.

The batched-throughput version of the complete per-frame program of
``api.DepthEstimator._step`` (/root/reference/depth_estimation_api.lua:134-198):
undistort -> ego-motion (Shi-Tomasi + pyramidal LK + RANSAC essential) ->
rotation-compensate previous FEATURE maps (the reference's prefilter split,
:147) -> fused match -> decode -> warp-mask erosion -> confidence gate ->
branchless bad-frame zeroing, plus the x-flow -> depth rule
(ARdroneAPI::computeDepthMapFromFlow, /root/reference/ardrone/ardrone_api.cpp:127-136).

Batching notes:
  * the fused matcher batches natively (batch = kernel grid dimension);
  * ego-motion's windowed ops use the batch-LAST layouts of
    geometry3d/egomotion.py; LK patch sampling is batched matmuls;
  * the per-item feature warps keep the reference's UNCONDITIONAL 4-tap
    semantics via speculative dispatch (undistort.remove_ego_motion_exact):
    a grid-arithmetic predicate routes the whole batch through the banded
    shift-sum warp when every in-frame displacement is in-band (every frame
    the pipeline keeps), falling back to the flat take_along_axis gather
    (undistort.remove_ego_motion_batched) otherwise;
    compensation='warp_banded' uses the banded warp unconditionally (exact
    within the search margin, band-masked beyond);
  * the warp-validity mask is computed analytically (pure range test on the
    homography grid, undistort.ego_motion_valid_mask) instead of warping a
    ones-image through the gather path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import codecs
from .data import images
from .geometry import Geometry
from .geometry3d import undistort as undist
from .geometry3d.calibration import Calibration
from .geometry3d import egomotion as ego
from .models import flow as flow_model
from .ops import extract, matching


class BatchedDepthEstimator:
    """B independent frame streams advanced one frame per dispatch — the
    amortized-throughput regime. State (previous undistorted frames +
    feature maps) stays on device.

    ``match_dtype``: feature storage type inside the fused matcher (bf16 is
    an inference-only option within the precision budget, PERF.md).
    """

    def __init__(self, geometry: Geometry, params, cal: Calibration,
                 head: str = "mean", match_dtype=jnp.float32,
                 warp_dtype=None, ego_downsample: int = 1,
                 compensation: str = "warp", lk_iters: int = 10,
                 ransac_samples: int = 64, state_dtype=None,
                 match_block: int = 4, warp_band: int = 8,
                 corner_selector: str = "topk", lk_search: int = 32):
        """Throughput knobs (all off by default = the parity path):
          * match_dtype / warp_dtype: bf16 feature storage in the fused
            matcher / the rotation-compensation gather (inference-only
            precision options);
          * ego_downsample: estimate ego-motion on an s x s average-pooled
            working frame — R is resolution-independent (K rescales), the
            corner/LK/RANSAC stages cost ~1/s^2, and the rotation estimate
            agrees to sub-milliradian on real motion (tested);
          * compensation: 'warp' = the reference's exact order (warp the
            previous FEATURE maps by K R K^-1 with unconditional 4-tap
            semantics, then match) — speculatively dispatched: the banded
            shift-sum warp when every in-frame displacement is within
            warp_band (a grid-arithmetic predicate; true on every frame
            the pipeline keeps), the flat gather otherwise
            (undistort.remove_ego_motion_exact); 'decode' =
            the gather-free reformulation: match the UNWARPED features and
            subtract the analytic rotation-flow field delta(p) =
            (K R K^-1)p - p from the decoded flow. For |delta| within the
            search margin this measures the same physical flow — the true
            correspondence stays inside the window, just displaced — while
            keeping features un-interpolated and eliminating the one
            gather-bound stage of the pipeline. Costs search margin
            (|delta| eats window range; such frames fail the inlier gate
            anyway) and indexes the field at p instead of h^-1(p) (a
            sub-pixel attribution shift for small rotations). Agreement
            with 'warp' on small rotations is tested; 'warp_banded' = the
            same warp-then-match order through the gather-free banded
            shift-sum warp (undistort.remove_ego_motion_banded): output
            values are EXACT (not approximated) wherever the rotation
            displacement stays within the matcher's search margin, and
            pixels beyond it are masked — the same coverage cost decode
            mode pays, at the reference's stage order;
          * lk_iters: per-level LK iterations (10 = the parity default);
          * ransac_samples: essential-RANSAC sample count (64 = parity);
          * state_dtype: storage type of the on-device stream state
            (previous frames + feature maps) — bf16 halves the state
            read/write traffic per step; compute still runs f32/matcher
            rules downstream;
          * match_block: fused-matcher tile height (pure blocking factor,
            outputs identical). "auto" = measure the candidates once per
            shape/dtype on the live device during reset() and persist the
            winner (ops/autotune.py);
          * corner_selector: 'topk' = the parity selection (global
            top-max_points Shi-Tomasi peaks); 'grid' = sort-free per-cell
            argmax (egomotion._grid_select) — no lax.top_k over the flat
            score map: the cell form is two reshape-reduces AND enforces
            the spatial spread the
            reference gets from OpenCV's minDistance rule. Rotation
            agreement between the two is tested
            (tests/test_batched_pipeline.py);
          * lk_search: LK cached-search-window side (32 = conservative
            default). Per-level residual capture is (lk_search - win - 1)
            px; classic pyramid LK captures only ~win/2 px per level, so
            24 (margin 8 >= win/2 at win=15) keeps the reference's
            effective envelope while shrinking the window matmuls, corr
            convs, and per-iteration einsums (~S- and (S-kw+1)^2-shaped).
            Rotation agreement 24-vs-32 is tested
            (tests/test_batched_pipeline.py).
        """
        geometry.validate()
        assert head in ("mean", "max")
        assert compensation in ("warp", "warp_banded", "decode")
        assert corner_selector in ("topk", "grid")
        assert match_block == "auto" or int(match_block) > 0
        # 'auto': measured once per shape/dtype on the live device during
        # reset() (ops/autotune.py), persisted next to the compile cache
        self._match_block = match_block
        self._match_dtype = match_dtype
        assert ego_downsample in (1, 2, 4)
        self.geometry = geometry
        self.params = params
        self.cal = cal
        self.head = head
        self.model = flow_model.FlowModel(geometry)
        g = geometry
        Ks = cal.K.copy()
        Ks[0] *= g.wImg / cal.wImg
        Ks[1] *= g.hImg / cal.hImg
        self.K_scaled = Ks

        @jax.jit
        def _prep(params, frames):
            """Normalize / downscale / undistort / filter a batch of frames
            (ONE conv trunk pass per frame — the prefilter split)."""
            if frames.dtype == jnp.uint8:
                frames = frames.astype(jnp.float32) / 255.0
            # separable-matmul resize — same kernel as jax.image.resize
            # (data/images.py)
            frames = images.scale_batched_device(frames, g.hImg, g.wImg)
            # fixed sampling map shared by the batch: undistortion's grid
            # does not depend on the data, so the whole batch goes through
            # one gather program (vmap over items with identical indices)
            u = jax.vmap(
                lambda f: undist.undistort_image(f, Ks, cal.distortion)
            )(frames)
            feats = self.model.features(params, u)
            if state_dtype is not None:
                u = u.astype(state_dtype)
                feats = feats.astype(state_dtype)
            return u, feats

        def _step(params, last_u, last_feats, frames):
            B = frames.shape[0]
            u, feats = _prep(params, frames)
            if ego_downsample > 1:
                from .models.multiscale import avg_downsample
                e1 = avg_downsample(last_u, ego_downsample)
                e2 = avg_downsample(u, ego_downsample)
                K_ego = Ks.copy()
                K_ego[:2] /= ego_downsample
            else:
                e1, e2, K_ego = last_u, u, Ks
            em = ego.get_ego_motion_batched(
                e1, e2, K_ego, max_points=cal.sfm.max_points,
                quality=cal.sfm.points_quality, lk_iters=lk_iters,
                n_samples=ransac_samples, selector=corner_selector,
                lk_search=lk_search)
            ratio = em.n_inliers.astype(jnp.float32) / jnp.maximum(
                em.n_found.astype(jnp.float32), 1.0)
            good = ratio >= cal.bad_image_threshold
            eye = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (B, 3, 3))
            R = jnp.where(good[:, None, None], em.R, eye)

            Hf, Wf = last_feats.shape[1], last_feats.shape[2]
            if compensation == "warp":
                # unconditional 4-tap warp semantics, speculatively
                # dispatched: the banded shift-sum warp when the whole
                # batch's displacements are in-band (every frame the
                # pipeline keeps), the flat gather otherwise — see
                # undistort.remove_ego_motion_exact
                warped = undist.remove_ego_motion_exact(
                    last_feats, Ks, R, band=warp_band, dtype=warp_dtype)
                wmask = undist.ego_motion_valid_mask(Ks, R, Hf, Wf)
                f1 = flow_model.crop_features_center(g, warped)
            elif compensation == "warp_banded":
                warped = undist.remove_ego_motion_banded(
                    last_feats, Ks, R, band=warp_band, dtype=warp_dtype)
                wmask = undist.ego_motion_valid_mask(
                    Ks, R, Hf, Wf, band=warp_band)
                f1 = flow_model.crop_features_center(g, warped)
            else:
                # gather-free: match unwarped features; the analytic
                # rotation flow is subtracted from the decode below, and
                # its magnitude bounds the usable search margin (mask)
                dxs, dys = undist.homography_grid(Ks, R, Hf, Wf)
                jgrid = jnp.arange(Wf, dtype=jnp.float32)[None, None, :]
                igrid = jnp.arange(Hf, dtype=jnp.float32)[None, :, None]
                rot_x = dxs - jgrid                       # (B, Hf, Wf)
                rot_y = dys - igrid
                # valid where the displaced correspondence stays inside
                # the centered search window (margin 1 for the soft tail)
                margin_y = min(g.halfh1, g.halfh2) - 1
                margin_x = min(g.halfw1, g.halfw2) - 1
                wmask = ((jnp.abs(rot_y) <= margin_y)
                         & (jnp.abs(rot_x) <= margin_x)).astype(jnp.float32)
                f1 = flow_model.crop_features_center(g, last_feats)
            mb = self._match_block
            assert mb != "auto", "call reset() first (resolves 'auto')"
            if head == "mean":
                # confidence gate fused into the matcher kernel (want_conf):
                # equals confidences_from_marginal on the marginal
                # (equivalence-tested) without materializing the
                # (B, maxh, H, W) marginal
                idx, ey, ex, pmax, confs = matching.match_flow_fused(
                    f1, feats, g.maxh, g.maxw, match_dtype, True,
                    block_rows=mb)
                y, x = ey, ex
            else:
                idx, ey, ex, pmax = matching.match_flow_fused(
                    f1, feats, g.maxh, g.maxw, match_dtype, block_rows=mb)
                wy, wx = codecs.decode(g, idx)
                y = wy.astype(jnp.float32)
                x = wx.astype(jnp.float32)
                confs = jnp.ones_like(pmax)

            H, W = y.shape[1:]
            hoff = (g.hImg - H) // 2
            woff = (g.wImg - W) // 2
            if compensation == "decode":
                # add the rotation flow back: pure rotation makes the raw
                # match read -delta (prev content appears at h^-1(q)), so
                # the physical flow is d + delta
                ry = rot_y[:, g.halfh1:g.halfh1 + H, g.halfw1:g.halfw1 + W]
                rx = rot_x[:, g.halfh1:g.halfh1 + H, g.halfw1:g.halfw1 + W]
                y = y + ry
                x = x + rx
            xflow = jnp.zeros((B, g.hImg, g.wImg), jnp.float32)
            xflow = xflow.at[:, hoff:hoff + H, woff:woff + W].set(x)
            fullc = jnp.zeros((B, g.hImg, g.wImg), jnp.float32)
            fullc = fullc.at[:, hoff:hoff + H, woff:woff + W].set(confs)

            m = wmask[:, g.halfh1:g.halfh1 + H, g.halfw1:g.halfw1 + W]
            m = extract.enlarge_mask_batched(m > 0.5, g.hKernel, g.wKernel)
            fullm = jnp.zeros((B, g.hImg, g.wImg), jnp.float32)
            fullm = fullm.at[:, hoff:hoff + H, woff:woff + W].set(
                m.astype(jnp.float32))
            mask = fullm * fullc

            xflow = jnp.where(good[:, None, None], xflow, 0.0)
            mask = jnp.where(good[:, None, None], mask, 0.0)

            # depth from x-flow (translation magnitude m = 1)
            cx = g.wImg / 2.0
            j = jnp.arange(g.wImg, dtype=jnp.float32)[None, None, :]
            absflow = jnp.abs(xflow)
            depth = jnp.where(absflow < 0.1, jnp.inf,
                              jnp.abs(j - cx) / jnp.maximum(absflow, 0.1))
            return u, feats, xflow, mask, depth, good

        self._prep = _prep
        self._prep_fn = _prep.__wrapped__          # unjitted (for sharding)
        self._step_fn = _step                      # unjitted (for sharding)
        # donate the stream state: last_u/last_feats are dead after the
        # step (next_frames replaces them), so XLA reuses their buffers for
        # the new state in place — halves the state's device-memory
        # footprint, which is what bounds the stream count at large B.
        # (CPU backends that can't donate just warn and copy; correctness
        # is unchanged.)
        self._step = jax.jit(_step, donate_argnums=(1, 2))
        self.last_u = None
        self.last_feats = None

    def shard(self, mesh, axis: str = "dp") -> "BatchedDepthEstimator":
        """Shard the stream batch across a device mesh: every stage of the
        per-frame program (prep, ego-motion, compensation, fused match,
        masks, depth) is per-stream, so the step partitions as pure dp —
        shard_map splits the leading batch dim, state stays sharded on
        device between steps, and no collective is needed. Returns self;
        reset/next_frames keep their API. Batch must be divisible by the
        mesh axis size."""
        from .parallel import mesh as pmesh
        self._prep = pmesh.sharded_pipeline_prep(self, mesh, axis)
        self._step = pmesh.sharded_pipeline_step(self, mesh, axis)
        return self

    def reset(self, first_frames) -> None:
        self.last_u, self.last_feats = self._prep(
            self.params, jnp.asarray(first_frames))
        if self._match_block == "auto":
            # resolve against the REAL feature shapes, eagerly, before
            # _step is first traced (ops/autotune.py — measured once per
            # shape/dtype/backend, persisted)
            from .ops import autotune
            g = self.geometry
            f1 = flow_model.crop_features_center(g, self.last_feats)
            self._match_block = autotune.best_block_rows(
                tuple(f1.shape), tuple(self.last_feats.shape),
                g.maxh, g.maxw, dtype=self._match_dtype,
                want_conf=self.head == "mean")

    def next_frames(self, frames):
        """Advance every stream by one frame. Returns (xflow, mask, depth,
        good), all on device; state updates internally."""
        assert self.last_u is not None, "call reset(first_frames) first"
        u, feats, xflow, mask, depth, good = self._step(
            self.params, self.last_u, self.last_feats, jnp.asarray(frames))
        self.last_u = u
        self.last_feats = feats
        return xflow, mask, depth, good


def make_batched_pipeline(geometry: Geometry, cal: Calibration,
                          head: str = "mean", match_dtype=jnp.float32,
                          **knobs):
    """Independent-PAIRS form of the batched pipeline: a jitted
    ``fn(params, frames1, frames2) -> (xflow, mask, depth, good)`` that
    preps both frames of every pair (the offline / dataset regime —
    streaming callers should use ``BatchedDepthEstimator``, which preps one
    frame per step like the reference's online loop). Shapes: frames
    (B, h, w, 3) any input resolution; outputs (B, hImg, wImg) + good (B,).
    ``knobs`` pass through to BatchedDepthEstimator (compensation,
    warp_band, lk_iters, ... — same accuracy contracts).
    """
    est = BatchedDepthEstimator(geometry, None, cal, head=head,
                                match_dtype=match_dtype, **knobs)

    @jax.jit
    def _jitted(params, frames1, frames2):
        last_u, last_feats = est._prep(params, frames1)
        _, _, xflow, mask, depth, good = est._step_fn(
            params, last_u, last_feats, frames2)
        return xflow, mask, depth, good

    def pipeline(params, frames1, frames2):
        if est._match_block == "auto":
            # resolve the block size eagerly before the first trace
            # (reset() holds the resolution logic; params is per-call here)
            est.params = params
            est.reset(frames1)
        return _jitted(params, frames1, frames2)

    return pipeline
