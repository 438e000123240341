"""Public streaming inference API — the depth_estimation_api.lua rebuild.

``DepthEstimator.next_frame_depth()``: frame in -> (scaled frame, x-flow,
mask) out, with the reference's exact pipeline
(/root/reference/depth_estimation_api.lua:134-198):

  undistort -> ego-motion (R, T, inlier ratio) -> scale -> rotation-compensate
  the PREVIOUS frame's *feature maps* (the prefilter split: the conv trunk
  runs once per frame, :30-31,147) -> filter current frame -> bad-frame
  rejection (inliers/found < bad_image_threshold -> zeros, :159-162) ->
  matcher + decode -> mask erosion by the matcher footprint -> center the
  mask -> gate by confidences.

The whole dense path (undistort, filter, warp, match, decode, mask) is one
jitted device program per frame; only frame IO, the inlier-ratio
branch, and state rotation stay on host. Per-stage timing via utils.timer
(the reference prints per-stage latencies; same here with report()).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import codecs
from .geometry import Geometry
from .geometry3d import undistort as undist
from .geometry3d.calibration import Calibration
from .geometry3d import egomotion as ego
from .models import flow as flow_model
from .ops import extract, matching
from .utils.timer import Timers
from .data.images import scale as img_scale


class DepthEstimator:
    """Holds model params + previous-frame device state (features, frame)."""

    def __init__(self, geometry: Geometry, params, cal: Calibration,
                 head: str = "mean", sync_timers: bool = False,
                 ego_resolution: str = "working"):
        """ego_resolution:
          * "working" (default) — ego-motion is estimated at the model's
            working resolution, on the same downscaled-then-undistorted
            frame the matcher consumes. The full-resolution undistortion
            (a 2-D gather at 640x480) disappears entirely; the
            rotation estimate is the same physical quantity from 4x fewer
            pixels (sub-degree agreement, tested in tests/test_api.py).
          * "full" — the reference's exact order (undistort at camera
            resolution, ego-motion there, then scale:
            /root/reference/depth_estimation_api.lua:139-144).
        """
        geometry.validate()
        assert ego_resolution in ("working", "full")
        self.geometry = geometry
        self.params = params
        self.cal = cal
        self.head = head
        self.ego_resolution = ego_resolution
        self.model = flow_model.FlowModel(geometry)
        self.timers = Timers(sync_device=sync_timers)
        # K scaled to the model's working resolution
        sy = geometry.hImg / cal.hImg
        sx = geometry.wImg / cal.wImg
        Ks = cal.K.copy()
        Ks[0] *= sx
        Ks[1] *= sy
        self.K_scaled = Ks
        self.last_im: Optional[np.ndarray] = None
        self.last_filtered = None

        g = geometry

        @jax.jit
        def _prep(params, frame):
            # uint8 camera frames are accepted and normalized ON DEVICE:
            # byte upload is 4x less host->device traffic, and uint8 is
            # what a camera produces
            if frame.dtype == jnp.uint8:
                frame = frame.astype(jnp.float32) / 255.0
            if ego_resolution == "full":
                u = undist.undistort_image(frame, cal.K, cal.distortion)
                small = img_scale(u, g.hImg, g.wImg)
            else:
                # scale first, undistort at working res (the composition is
                # the same continuous map; only resampling order differs).
                # Frames already at working resolution (host-side downscale,
                # see data.images.scale_np) skip the device resize.
                if frame.shape[:2] != (g.hImg, g.wImg):
                    frame = img_scale(frame, g.hImg, g.wImg)
                u = small = undist.undistort_image(
                    frame, self.K_scaled, cal.distortion)
            return u, small, self.model.features(params, small)

        @jax.jit
        def _match(params, last_filtered, filtered, R):
            # rotation-compensate previous features; warp validity = mask
            warped = undist.remove_ego_motion(last_filtered, self.K_scaled, R)
            ones = jnp.ones(last_filtered.shape[:2] + (1,), jnp.float32)
            mask = undist.remove_ego_motion(ones, self.K_scaled, R)[..., 0]
            f1 = flow_model.crop_features_center(g, warped)
            # fused matcher: match + softmax + WTA + soft-argmax in one
            # pass, never materializing the (H*W*maxh*maxw) cost volume
            if head == "mean":
                # getOutputConfidences2's gate: thresholded extraction on the
                # y-marginal (/root/reference/opticalflow_model.lua:192-198),
                # computed INSIDE the fused kernel (want_conf) — equal to
                # extract.confidences_from_marginal on the marginal
                # (equivalence-tested) without writing the marginal out
                idx, ey, ex, pmax, confs = matching.match_flow_fused(
                    f1, filtered, g.maxh, g.maxw, want_conf=True)
                y, x = ey, ex
            else:
                idx, ey, ex, pmax = matching.match_flow_fused(
                    f1, filtered, g.maxh, g.maxw)
                wy, wx = codecs.decode(g, idx)
                y = wy.astype(jnp.float32)
                x = wx.astype(jnp.float32)
                confs = jnp.ones_like(pmax)
            H, W = y.shape
            # full-frame assembly
            hoff = (g.hImg - H) // 2
            woff = (g.wImg - W) // 2
            full = jnp.zeros((2, g.hImg, g.wImg), jnp.float32)
            full = full.at[0, hoff:hoff + H, woff:woff + W].set(y)
            full = full.at[1, hoff:hoff + H, woff:woff + W].set(x)
            fullc = jnp.zeros((g.hImg, g.wImg), jnp.float32)
            fullc = fullc.at[hoff:hoff + H, woff:woff + W].set(confs)
            # mask pipeline (:172-182): take the warp-validity of the f1
            # positions actually matched, erode by the matcher footprint,
            # embed centered in the full frame, gate by confidences
            m = jax.lax.slice(mask, (g.halfh1, g.halfw1),
                              (g.halfh1 + H, g.halfw1 + W))
            m = extract.enlarge_mask(m > 0.5, g.hKernel, g.wKernel)
            fullm = jnp.zeros((g.hImg, g.wImg), jnp.float32)
            fullm = fullm.at[hoff:hoff + H, woff:woff + W].set(
                m.astype(jnp.float32))
            return full, fullm * fullc

        self._prep = _prep
        self._match = _match

        # One-dispatch-per-frame fused step: undistort/scale/filter the new
        # frame, ego-motion against the previous frame, rotation-compensated
        # match, and BRANCHLESS bad-frame gating (jnp.where instead of a
        # host-synced ratio check), so the whole frame is one program with
        # no host sync inside.
        ego_K = cal.K if ego_resolution == "full" else self.K_scaled

        def _step(params, last_im, last_filtered, frame):
            u, small, feats = _prep(params, frame)
            em = ego.get_ego_motion(
                last_im, u, ego_K,
                max_points=cal.sfm.max_points,
                quality=cal.sfm.points_quality)
            ratio = em.n_inliers.astype(jnp.float32) / jnp.maximum(
                em.n_found.astype(jnp.float32), 1.0)
            good = ratio >= cal.bad_image_threshold
            R = jnp.where(good, em.R, jnp.eye(3, dtype=jnp.float32))
            full, mask_d = _match(params, last_filtered, feats, R)
            full = jnp.where(good, full, 0.0)
            mask_d = jnp.where(good, mask_d, 0.0)
            return u, small, feats, full, mask_d, good

        self._step = jax.jit(_step)

        # Streaming variant: everything the consumer needs in ONE packed
        # half-precision array, so the streaming loop fetches exactly one
        # buffer per frame. Layout: (2, hImg, wImg) f16 =
        # [xflow, mask * confidences].
        def _step_packed(params, last_im, last_filtered, frame):
            u, small, feats, full, mask_d, good = _step(
                params, last_im, last_filtered, frame)
            packed = jnp.stack([full[1], mask_d]).astype(jnp.float16)
            return u, small, feats, packed

        self._step_packed = jax.jit(_step_packed)

    def reset(self, first_frame: np.ndarray) -> None:
        u, small, feats = self._prep(self.params, jnp.asarray(first_frame))
        self.last_im = u                  # kept on device
        self.last_im_scaled = small
        self.last_filtered = feats

    def next_frame_depth(self, frame: np.ndarray, fetch: bool = True):
        """Returns (im_scaled (H, W, C), xflow (H, W), mask (H, W)).

        One device dispatch per frame (see _step); with fetch=False the
        returned arrays stay on device (zero host syncs — chain them into
        further device work)."""
        assert self.last_im is not None, "call reset(first_frame) first"
        t = self.timers
        t.tic("frame")
        u, small, feats, full, mask_d, good = self._step(
            self.params, self.last_im, self.last_filtered,
            jnp.asarray(frame))
        t.toc("frame", mask_d if t.sync_device else None)
        self.last_im = u
        self.last_im_scaled = small
        self.last_filtered = feats
        if fetch:
            return np.asarray(small), np.asarray(full[1]), np.asarray(mask_d)
        return small, full[1], mask_d

    def next_frame_packed(self, frame):
        """Streaming fast path: one device dispatch, ONE fetchable output —
        a (2, hImg, wImg) float16 array [xflow, mask*confidences]. The caller
        fetches it (np.asarray), typically from a fetcher thread with a few
        frames in flight (see cli/tools.py cmd_stream --pipeline)."""
        assert self.last_im is not None, "call reset(first_frame) first"
        u, small, feats, packed = self._step_packed(
            self.params, self.last_im, self.last_filtered,
            jnp.asarray(frame))
        self.last_im = u
        self.last_im_scaled = small
        self.last_filtered = feats
        return packed

    def stream(self, lag: int = 3, fetch_threads: int = 4):
        """Overlapped per-frame streaming: a PipelinedStream keeping ``lag``
        frames in flight so device compute, the result fetch, and
        host-side prep of the NEXT frame all overlap."""
        return PipelinedStream(self, lag=lag, fetch_threads=fetch_threads)


class PipelinedStream:
    """K-frames-in-flight wrapper over DepthEstimator.next_frame_packed.

    Why it exists: the synchronous per-frame path pays, IN SERIES, the
    host->device upload, the device compute, and the result fetch per
    frame. Dispatches are async in JAX, so overlap needs no device-side
    change — only the discipline of (a) keeping ``lag`` frames in flight
    before blocking on a result and (b) fetching on worker threads so a
    slow fetch never blocks the dispatch of frame N+1. The per-frame rate
    is then bound by max(host prep, device compute, per-dispatch overhead);
    config5 of benchmarks/bench_configs.py is this wrapper.

    Results come out in frame order, ``lag`` frames behind the pushes:

        stream = est.stream(lag=3)
        for frame in frames:
            out = stream.push(frame)      # (2, H, W) f16 np array or None
            if out is not None: consume(out)
        for out in stream.drain():        # the last ``lag`` results
            consume(out)
    """

    def __init__(self, est: "DepthEstimator", lag: int = 3,
                 fetch_threads: int = 4):
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        assert lag >= 1
        self.est = est
        self.lag = lag
        self._pend = deque()
        self._pool = ThreadPoolExecutor(fetch_threads)

    def push(self, frame) -> Optional[np.ndarray]:
        """Dispatch one frame; return the packed result of frame
        (current - lag), or None while the pipeline fills."""
        packed = self.est.next_frame_packed(frame)
        self._pend.append(self._pool.submit(np.asarray, packed))
        if len(self._pend) > self.lag:
            return self._pend.popleft().result()
        return None

    def drain(self):
        """Yield the in-flight tail results (call after the last push)."""
        while self._pend:
            yield self._pend.popleft().result()

    def close(self):
        for _ in self.drain():
            pass
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# Batched (B-streams-per-dispatch) pipeline lives in api_batched.py
from .api_batched import BatchedDepthEstimator, make_batched_pipeline  # noqa: E402,F401
