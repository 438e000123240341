"""Small tools: rectification batch, model download, streaming driver,
offline video pipeline, microbenchmark.

Rebuilds the reference's tooling scripts:
  * rectify: precompute undistorted + ego-motion-rectified frames for a
    dataset (rectify_groundtruth_for_celiu.lua:1-73);
  * download: list/fetch models from a remote host over ssh/scp
    (download_model.lua:4-226, non-interactive variant);
  * stream: prefiltered streaming loop with running per-stage timing
    (depth_estimation_opticalflow.lua:59-158);
  * video: full offline pipeline frames -> flow -> depth -> HSL panels ->
    mp4 (test_opticalflow.lua:36-394);
  * time-matching: the matcher/filter/decode microbenchmark
    (tests/time_matching.lua:20-48).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np


def cmd_rectify(args) -> int:
    from ..data import images as img_mod
    from ..data.datasets import load_rectified_pair
    from ..geometry import Geometry
    from ..geometry3d import calibration as calmod
    from ..parallel import mesh as pm
    from ..utils.viz import save_image

    cal = calmod.PRESETS[args.calibration]
    g = Geometry(hImg=cal.hImg, wImg=cal.wImg)
    loader = img_mod.ImageLoader(args.directory, cal.hImg, cal.wImg,
                                 args.first)
    und_dir = os.path.join(args.directory, "undistorted_images")
    rect_dir = os.path.join(args.directory, "rectified_images")
    os.makedirs(und_dir, exist_ok=True)
    os.makedirs(rect_dir, exist_ok=True)
    mesh = pm.auto_mesh(args.dp)
    if mesh is not None:
        # dp-sharded batch path (the CLI surface for sharded_rectify_fn):
        # consecutive frames processed in chunks of 16 pairs PER DEVICE,
        # the whole chunk one sharded device program
        import jax.numpy as jnp
        nd = mesh.devices.size
        print(f"dp mesh: {nd} devices ({mesh.devices.flat[0].platform})")
        rect_fn = pm.sharded_rectify_fn(mesh, cal, cal.hImg, cal.wImg)
        chunk = 16 * nd
        k = args.first
        n_done = 0
        frames = [loader.get_next_frame()]
        done = frames[0] is None
        while not done:
            # fill a chunk of consecutive pairs (last frame carries over)
            while len(frames) - 1 < chunk:
                if args.num and n_done + len(frames) - 1 >= args.num:
                    break
                img = loader.get_next_frame()
                if img is None:
                    break
                frames.append(img)
            if len(frames) < 2:
                break
            done = len(frames) - 1 < chunk
            prevs = np.stack(frames[:-1]).astype(np.float32)
            imgs = np.stack(frames[1:]).astype(np.float32)
            pp, n_real = pm.pad_to_multiple(prevs, nd)
            pi, _ = pm.pad_to_multiple(imgs, nd)
            _, img_s, warped, _, _, _ = rect_fn(jnp.asarray(pp),
                                                jnp.asarray(pi))
            img_s = np.asarray(img_s)[:n_real]
            warped = np.asarray(warped)[:n_real]
            for j in range(n_real):
                save_image(os.path.join(und_dir, f"{k:09d}.png"),
                           img_s[j].transpose(2, 0, 1))
                save_image(os.path.join(rect_dir, f"{k:09d}.png"),
                           warped[j].transpose(2, 0, 1))
                k += 1
            n_done += n_real
            frames = frames[-1:]       # overlap: last frame starts next chunk
        print(f"rectified {n_done} pairs")
        return 0
    prev = loader.get_next_frame()
    k = args.first
    while True:
        img = loader.get_next_frame()
        if img is None or (args.num and k - args.first >= args.num):
            break
        pair = load_rectified_pair(g, cal, prev, img, compute_gt=False)
        save_image(os.path.join(und_dir, f"{k:09d}.png"),
                   pair.image.transpose(2, 0, 1))
        save_image(os.path.join(rect_dir, f"{k:09d}.png"),
                   pair.prev_warped.transpose(2, 0, 1))
        prev = img
        k += 1
    print(f"rectified {k - args.first} pairs")
    return 0


def _recency_star(date_str: str, today: str) -> str:
    """The reference's recency marker (download_model.lua:111-124):
    ' **' for today's files, ' *' within 2 days, '' otherwise."""
    if not date_str:
        return ""
    if date_str == today:
        return " **"
    try:
        import datetime as _dt
        d1 = _dt.date.fromisoformat(date_str)
        d2 = _dt.date.fromisoformat(today)
        if (d2 - d1).days % 365 < 2:
            return " *"
    except ValueError:
        pass
    return ""


def _select_menu(entries, today: str, input_fn, specials=()):
    """Numbered menu with recency stars (selectFile,
    download_model.lua:126-150). entries: [(name, date)]. Returns the
    chosen entry, a special string the user typed, or None."""
    if not entries:
        print("No files in specified directory")
        return None
    for i, (name, date) in enumerate(entries, 1):
        print(f"({i}) {name}{_recency_star(date, today)}")
    while True:
        s = input_fn()
        if s in specials:
            return s
        if s == "" and len(entries) == 1:
            return entries[0]
        try:
            i = int(s)
        except (TypeError, ValueError):
            continue
        if 1 <= i <= len(entries):
            return entries[i - 1]


def _select_epoch(entries, input_fn):
    """Epoch menu (selectEpoch, download_model.lua:152-177): requires a
    contiguous 0..N run, empty input = last. entries: [(name, date, n)]."""
    entries = sorted(entries, key=lambda e: e[2])
    ns = [e[2] for e in entries]
    if not ns or ns[0] != 0 or ns[-1] != len(ns) - 1:
        print("Missing epochs, can't perform model selection")
        return None
    print(f"Select epoch: 0..{ns[-1]} (default = last)")
    while True:
        s = input_fn()
        if s == "":
            return entries[-1]
        try:
            i = int(s)
        except (TypeError, ValueError):
            continue
        if 0 <= i <= ns[-1]:
            return entries[i]


def _epoch_number(name: str):
    """'e12' (this repo's checkpoints) or 'model_of__e12' (the reference's
    torch files) -> 12; otherwise None."""
    import re
    m = re.fullmatch(r"(?:model_of__)?e(\d+)(?:\.bin)?", name)
    return int(m.group(1)) if m else None


def _ssh_lister(host):
    def lister(path):
        out = subprocess.run(
            ["ssh", host, f"ls -l --time-style=+%F {path}"],
            capture_output=True, text=True, timeout=30, check=True)
        entries = []
        for line in out.stdout.splitlines():
            # with --time-style=+%F the name is everything after column 6
            # (maxsplit keeps filenames containing spaces intact)
            parts = line.split(None, 6)
            if len(parts) >= 7 and (line[0] == "d" or line[0] == "-"):
                entries.append((parts[6], parts[5]))
        return entries
    return lister


def cmd_download_interactive(args, lister=None, input_fn=input,
                             today=None) -> int:
    """Interactive model browser (download_model.lua:179-226 prompt):
    descend the remote model hierarchy one numbered menu at a time (recency
    stars on fresh entries), pick an epoch at the leaf (contiguous-run
    check, default last), scp it down. ``lister``/``input_fn`` are
    injectable for tests."""
    import datetime as _dt

    if today is None:
        today = _dt.date.today().isoformat()
    if lister is None:
        try:
            lister = _ssh_lister(args.host)
            lister(args.remote_dir)
        except (FileNotFoundError, subprocess.SubprocessError) as e:
            print(f"ssh unavailable: {e}", file=sys.stderr)
            return 1

    path = args.remote_dir
    while True:
        try:
            entries = lister(path)
        except (FileNotFoundError, subprocess.SubprocessError) as e:
            print(f"listing failed for {path}: {e}", file=sys.stderr)
            return 1
        if entries is None or not entries:
            print("No files in specified directory")
            return 1
        epochs = [(n, d, _epoch_number(n)) for n, d in entries
                  if _epoch_number(n) is not None]
        if epochs:
            pick = _select_epoch(epochs, input_fn)
            if pick is None:
                return 1
            target = f"{path}/{pick[0]}"
            break
        pick = _select_menu(entries, today, input_fn)
        if pick is None:
            return 1
        path = f"{path}/{pick[0]}"

    os.makedirs(args.output_dir, exist_ok=True)
    print(f"fetching {target}")
    subprocess.run(["scp", "-r", f"{args.host}:{target}", args.output_dir],
                   check=True)
    return 0


def cmd_download(args) -> int:
    """ssh/scp model fetch (gated on ssh availability)."""
    if getattr(args, "interactive", False):
        return cmd_download_interactive(args)
    try:
        out = subprocess.run(
            ["ssh", args.host, f"ls -1 {args.remote_dir}"],
            capture_output=True, text=True, timeout=30, check=True)
    except (FileNotFoundError, subprocess.SubprocessError) as e:
        print(f"ssh unavailable: {e}", file=sys.stderr)
        return 1
    models = [m for m in out.stdout.splitlines() if m.strip()]
    if args.filter:
        models = [m for m in models if args.filter in m]
    if not models:
        print("no models found")
        return 1
    target = models[-1] if args.latest else models[0]
    print(f"fetching {target}")
    subprocess.run(["scp", "-r", f"{args.host}:{args.remote_dir}/{target}",
                    args.output_dir], check=True)
    return 0


def cmd_stream(args) -> int:
    """Streaming frame-pair loop with per-stage timing.

    Two regimes (the reference's streaming driver prints per-stage running
    means, depth_estimation_opticalflow.lua:141-147 — same here):
      * synchronous (default): fetch every frame's outputs before the next —
        per-frame latency includes one full host round trip;
      * --pipeline K: single-frame-in/single-frame-out with K frames in
        flight — outputs of frame n are fetched (on a fetcher thread) while
        frame n+1..n+K compute, hiding the fetch behind device compute.
    """
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from ..api import DepthEstimator
    from ..data import images as img_mod
    from ..geometry3d import calibration as calmod
    from ..models import io as model_io

    geom, lrn, params, _ = model_io.load_model(args.model)
    cal = calmod.PRESETS[args.calibration]
    est = DepthEstimator(geom, params, cal, head=args.head,
                         sync_timers=not args.pipeline)
    if getattr(args, "camera", None):
        loader = img_mod.ImageCamera(cal.hImg, cal.wImg, device=args.camera)
    else:
        loader = img_mod.ImageLoader(args.directory, cal.hImg, cal.wImg,
                                     args.first)
    first = loader.get_next_frame()
    est.reset(first)

    def fetch_packed(out):
        # plain blocking fetch on the fetcher thread (no is_ready()
        # polling); keep >= 3 frames in flight so the buffer exists by
        # fetch time.
        a = np.asarray(out)
        return a[0].astype(np.float32), a[1].astype(np.float32)

    from ..utils.viewer import LiveViewer
    viewer = LiveViewer("stream: x-flow", enabled=bool(args.show))
    if args.show and viewer.backend == "none":
        print("--show: no display available, continuing headless")

    def show_flow(xflow, mask):
        # displayResult convention: gray = flow/16 + 0.5, masked black
        viewer.show((np.asarray(xflow) / 16.0 + 0.5) * np.asarray(mask))

    pool = ThreadPoolExecutor(4) if args.pipeline else None
    pend: deque = deque()
    n = 0
    t0 = time.perf_counter()
    while True:
        frame = loader.get_next_frame()
        if frame is None or (args.num and n >= args.num):
            break
        if args.pipeline:
            # host-side downscale to working res before upload: the
            # working-res uint8 frame is 6x smaller than the camera frame
            fsmall = img_mod.scale_np(frame, geom.hImg, geom.wImg)
            pend.append(pool.submit(
                fetch_packed, est.next_frame_packed(fsmall)))
            if len(pend) > args.pipeline:
                xflow, mask = pend.popleft().result()
                show_flow(xflow, mask)
        else:
            im, xflow, mask = est.next_frame_depth(frame)
            show_flow(xflow, mask)
        n += 1
        print(f"frame {n}: {est.timers.report()}  "
              f"FPS: {n / (time.perf_counter() - t0):.2f}")
    while pend:
        xflow, mask = pend.popleft().result()
        show_flow(xflow, mask)
    viewer.close()
    if n:
        dt = time.perf_counter() - t0
        print(f"total: {n} frames in {dt:.2f}s -> {n / dt:.2f} FPS")
    return 0


def cmd_video(args) -> int:
    """Offline pipeline: frames -> flow+depth panels -> mp4.

    Full stage list of /root/reference/test_opticalflow.lua:276-394:
    undistort -> ego-motion -> warp previous scaled frame -> ONE model
    forward decoded three ways ('max' WTA, 'mean' soft-argmax, thresholded
    extraction for the confidence mask :347-358) -> warp-mask erosion ->
    middle-disc mask x extraction mask (:259-273,361) -> bad-frame zeroing
    (:293-299) -> masked flows -> median postprocess on mask_total (:376) ->
    panel rows [prev | warped | current] and [x-flow | y-flow | radial depth]
    (displayResult :236-257), plus a third row for the 'mean' decode (the
    reference computes it and ships its display commented out :380-381) ->
    ffmpeg mp4 at 10 fps (:394). The whole dense path is ONE jitted device
    program per frame; the PNG fetch is the only host transfer.
    """
    import math

    import jax
    import jax.numpy as jnp

    from ..data import images as img_mod
    from ..geometry3d import calibration as calmod
    from ..geometry3d import egomotion as ego
    from ..geometry3d import polar as polar_ops
    from ..geometry3d import undistort as undist
    from ..models import flow as flow_model
    from ..models import io as model_io
    from ..ops import extract, postprocess
    from ..utils.viz import export_video, save_image

    geom, lrn, params, _ = model_io.load_model(args.model)
    g = geom
    cal = calmod.PRESETS[args.calibration]
    model = flow_model.FlowModel(g)
    sy, sx = g.hImg / cal.hImg, g.wImg / cal.wImg
    Khalf = cal.K.copy()
    Khalf[0] *= sx
    Khalf[1] *= sy
    maskmiddle = extract.middle_disc_mask(g.hImg, g.wImg, 25.0)

    def decode_assemble(dist_hw, head_mean):
        if head_mean:
            ey, ex = flow_model.soft_argmax(g, dist_hw)
            H, W = ey.shape
        else:
            out = flow_model.process_output(g, dist_hw, process_full=False)
            ey = out.y.astype(jnp.float32)
            ex = out.x.astype(jnp.float32)
            H, W = ey.shape
        hoff = (g.hImg - H) // 2
        woff = (g.wImg - W) // 2
        full = jnp.zeros((2, g.hImg, g.wImg), jnp.float32)
        full = full.at[0, hoff:hoff + H, woff:woff + W].set(ey)
        full = full.at[1, hoff:hoff + H, woff:woff + W].set(ex)
        return full

    def flow_row(full, mask):
        """displayResult flow panels (:240-245): gray = flow/16 + 0.5 under
        the mask, invalid pixels 0.5 in blue only."""
        vx = (full[1] / 16.0 + 0.5) * mask
        vy = (full[0] / 16.0 + 0.5) * mask
        bx = vx + (1.0 - mask) * 0.5
        by = vy + (1.0 - mask) * 0.5
        px = jnp.stack([vx, vx, bx])
        py = jnp.stack([vy, vy, by])
        return px, py

    @jax.jit
    def step(params, last_im, last_im_scaled, frame):
        im = undist.undistort_image(frame, cal.K, cal.distortion)
        em = ego.get_ego_motion(last_im, im, cal.K,
                                max_points=cal.sfm.max_points,
                                quality=cal.sfm.points_quality)
        ratio = em.n_inliers.astype(jnp.float32) / jnp.maximum(
            em.n_found.astype(jnp.float32), 1.0)
        good = ratio >= cal.bad_image_threshold
        R = jnp.where(good, em.R, jnp.eye(3, dtype=jnp.float32))
        im_scaled = img_mod.scale(im, g.hImg, g.wImg)
        warped = undist.remove_ego_motion(last_im_scaled, Khalf, R)
        wmask = undist.remove_ego_motion(
            jnp.ones((g.hImg, g.wImg, 1), jnp.float32), Khalf, R)[..., 0]

        costs = model.costs(params, warped, im_scaled)
        dist = jax.nn.softmax(-costs, axis=-1)
        full_max = decode_assemble(dist, False)
        full_mean = decode_assemble(dist, True)
        # thresholded-extraction confidence mask (k=2, :358)
        pm = flow_model.process_output(g, dist, process_full=True,
                                       threshold=2.0)
        H = dist.shape[0]
        bh = math.ceil((g.hImg - H) / 2)
        bw = math.ceil((g.wImg - dist.shape[1]) / 2)
        mask = extract.enlarge_mask(wmask > 0.5, 2 * bh + 1, 2 * bw + 1)
        mask = mask.astype(jnp.float32)
        mask_entropy = pm.full_confidences * maskmiddle
        if args.entropy_thr > 0.0:
            # opt-in uncertainty gate: entropy of the window distribution
            # (ops/extract.py entropy_mask), embedded into the full frame
            egate = extract.entropy_mask(dist, args.entropy_thr)
            full_gate = jnp.zeros((g.hImg, g.wImg), jnp.float32)
            eh, ew = egate.shape
            yo = (g.hImg - eh) // 2
            xo = (g.wImg - ew) // 2
            full_gate = full_gate.at[yo:yo + eh, xo:xo + ew].set(
                egate.astype(jnp.float32))
            mask_entropy = mask_entropy * full_gate
        # bad-frame zeroing (:293-299)
        mask = jnp.where(good, mask, 0.0)
        mask_entropy = jnp.where(good, mask_entropy, 0.0)
        full_max_m = full_max * mask[None]
        full_mean_m = full_mean * mask[None]
        mask_total = mask * mask_entropy
        flow_pp = postprocess.post_process_image(full_max_m, mask_total,
                                                 args.post_win, "med")
        flow_pp_mean = postprocess.post_process_image(
            full_mean_m, mask_total, args.post_win, "med")

        # radial depth panel from the postprocessed flow (:246-255)
        rad, radconf = polar_ops.radial_depth_cartesian(
            flow_pp, (Khalf[0, 2], Khalf[1, 2]), g.wImg / 2.0)
        radconf = radconf * mask * mask_entropy
        depth_rgb = polar_ops.depth2color((rad / 200.0) * radconf, radconf)
        rad2, radconf2 = polar_ops.radial_depth_cartesian(
            flow_pp_mean, (Khalf[0, 2], Khalf[1, 2]), g.wImg / 2.0)
        radconf2 = radconf2 * mask * mask_entropy
        depth_rgb2 = polar_ops.depth2color((rad2 / 200.0) * radconf2, radconf2)

        # panel assembly ON DEVICE: 3 rows x 3 cols
        px, py = flow_row(full_max_m, mask)
        px2, py2 = flow_row(full_mean_m, mask)
        row0 = jnp.concatenate([jnp.transpose(last_im_scaled, (2, 0, 1)),
                                jnp.transpose(warped, (2, 0, 1)),
                                jnp.transpose(im_scaled, (2, 0, 1))], axis=2)
        row1 = jnp.concatenate([px, py, depth_rgb], axis=2)
        row2 = jnp.concatenate([px2, py2, depth_rgb2], axis=2)
        panel = jnp.concatenate([row0, row1, row2], axis=1)
        return im, im_scaled, jnp.clip(panel, 0.0, 1.0)

    loader = img_mod.ImageLoader(args.directory, cal.hImg, cal.wImg,
                                 args.first)
    os.makedirs(args.output_dir, exist_ok=True)
    import jax.numpy as jnp
    first = loader.get_next_frame()
    last_im = undist.undistort_image(jnp.asarray(first), cal.K,
                                     cal.distortion)
    last_im_scaled = img_mod.scale(last_im, geom.hImg, geom.wImg)
    k = 0
    from ..utils.viewer import LiveViewer
    viewer = LiveViewer("video: panels", enabled=bool(args.show))
    if args.show and viewer.backend == "none":
        print("--show: no display available, continuing headless")
    while True:
        frame = loader.get_next_frame()
        if frame is None or (args.num and k >= args.num):
            break
        last_im, last_im_scaled, panel = step(params, last_im,
                                              last_im_scaled,
                                              jnp.asarray(frame))
        panel_np = np.asarray(panel)
        save_image(os.path.join(args.output_dir, f"{k:09d}.png"), panel_np)
        viewer.show(panel_np)
        k += 1
    ok = export_video(args.output_dir, os.path.join(args.output_dir, "out.mp4"),
                      fps=10)
    print(f"wrote {k} panels; video={'ok' if ok else 'ffmpeg unavailable'}")
    return 0


def cmd_time_matching(args) -> int:
    """Microbenchmark: filter vs matcher vs decode over random frames
    (tests/time_matching.lua:20-48), each call ended by block_until_ready."""
    import jax
    import jax.numpy as jnp
    from ..geometry import Geometry
    from ..models.flow import FlowModel, crop_features_center
    from ..ops import matching

    g = Geometry(hImg=180, wImg=320, layers=((3, 16, 16, 10),),
                 maxh=16, maxw=16)
    model = FlowModel(g)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    img1 = jnp.asarray(rng.rand(g.hImg, g.wImg, 3), jnp.float32)
    img2 = jnp.asarray(rng.rand(g.hImg, g.wImg, 3), jnp.float32)

    filt = jax.jit(lambda p, a: model.features(p, a))
    def full(p, a, b):
        f1 = crop_features_center(g, model.features(p, a))
        f2 = model.features(p, b)
        return matching.match_flow_fused(f1, f2, g.maxh, g.maxw)
    fullj = jax.jit(full)

    def bench(fn, *a):
        jax.block_until_ready(fn(*a))
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = fn(*a)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / args.iters

    t_filter = bench(filt, params, img1)
    t_full = bench(fullj, params, img1, img2)
    print(f"filter: {t_filter * 1e3:.3f} ms   "
          f"filter+match+decode: {t_full * 1e3:.3f} ms   "
          f"({1.0 / t_full:.0f} fps)")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="det-tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("rectify")
    r.add_argument("directory")
    r.add_argument("--calibration", default="ardrone")
    r.add_argument("--first", type=int, default=0)
    r.add_argument("--num", type=int, default=0)
    r.add_argument("--dp", default="auto", metavar="auto|off|N",
                   help="data-parallel device mesh for the rectification "
                        "batch ('auto' = all devices when >1; see "
                        "parallel/mesh.py sharded_rectify_fn)")

    d = sub.add_parser("download")
    d.add_argument("host")
    d.add_argument("--remote-dir", default="models")
    d.add_argument("--filter", default="")
    d.add_argument("--latest", action="store_true")
    d.add_argument("--interactive", action="store_true",
                   help="menu-driven model browser (the download_model.lua "
                        "prompt: filter/learning/images menus with recency "
                        "stars, epoch selection)")
    d.add_argument("--output-dir", default=".")

    s = sub.add_parser("stream")
    s.add_argument("model")
    s.add_argument("directory")
    s.add_argument("--camera", default=None, metavar="DEV",
                   help="capture live from a V4L2 device (e.g. /dev/video0) "
                        "instead of reading numbered files — the reference's "
                        "_online driver regime "
                        "(depth_estimation_opticalflow_online.lua:55-105)")
    s.add_argument("--calibration", default="ardrone")
    s.add_argument("--head", default="mean")
    s.add_argument("--first", type=int, default=0)
    s.add_argument("--num", type=int, default=0)
    s.add_argument("--show", action="store_true",
                   help="live x-flow window when a display exists "
                        "(headless fallback is a no-op; utils/viewer.py)")
    s.add_argument("--pipeline", type=int, default=0, metavar="K",
                   help="frames in flight (0 = synchronous)")

    v = sub.add_parser("video")
    v.add_argument("model")
    v.add_argument("directory")
    v.add_argument("--calibration", default="ardrone")
    v.add_argument("--output-dir", default="video_out")
    v.add_argument("--post-win", type=int, default=3)
    v.add_argument("--entropy-thr", type=float, default=0.0, metavar="H",
                   help="optional extra confidence gate: drop pixels whose "
                        "window-distribution Shannon entropy exceeds H "
                        "(0 = off; ln(maxh*maxw) is the max possible)")
    v.add_argument("--first", type=int, default=0)
    v.add_argument("--num", type=int, default=0)
    v.add_argument("--show", action="store_true",
                   help="live panel window when a display exists "
                        "(headless fallback is a no-op; utils/viewer.py)")

    t = sub.add_parser("time-matching")
    t.add_argument("--iters", type=int, default=10)

    e = sub.add_parser("export",
                       help="write a hermetic serving artifact (StableHLO "
                            "with weights embedded, serving.py)")
    e.add_argument("model")
    e.add_argument("--out", default=None)
    e.add_argument("--pipeline", action="store_true",
                   help="export the COMPLETE batched online program "
                        "instead of the flow forward")
    e.add_argument("--batch", type=int, default=32)
    e.add_argument("--cal", default=None, help=".cal file (pipeline export)")
    e.add_argument("--bf16", action="store_true",
                   help="bf16 matcher feature storage (forward export)")
    e.add_argument("--hw", type=int, nargs=2, default=None,
                   metavar=("H", "W"),
                   help="artifact input dims for radial (polar grid, "
                        "default 200 200) and legacy-depth (frame, "
                        "default 360 640) exports")

    args = p.parse_args(argv)
    from ..serving import cmd_export
    return {"rectify": cmd_rectify, "download": cmd_download,
            "stream": cmd_stream, "video": cmd_video,
            "time-matching": cmd_time_matching,
            "export": cmd_export}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
