"""Chip smoke test: drive the online depth pipeline once on an NVIDIA GPU.

Uses the model the repo ships at full width, ``examples/car_model`` (320x180
working resolution, trunk 3->8->10 with 5x5 then 12x12 convolutions, 16x16
search window), loaded with ``models.io.load_model``. Frames are uint8
640x480 textures made on the device from ``--seed``. Phases:

  matcher     the fused Triton matcher at B=128 (150x290 matched pixels,
              K=10) against the plain reference under
              ``jax.default_matmul_precision("highest")``; the bf16 storage
              budget; both timed (median and p90 of 20 runs).
  batched     ``BatchedDepthEstimator`` (ARDRONE calibration, B=128, the
              fast-mode settings of bench.py) for a few steps in each
              compensation mode; ``memory_analysis()`` of the step.
  cpu_parity  the same batched program at B=2 on the GPU and on the CPU,
              strictly with the rotation pinned and the GPU at "highest"
              matmul precision.
  online      ``DepthEstimator``: reset, next_frame_depth, stream(lag=3).
  train       the single-scale ``Trainer`` at the car model's geometry,
              B=256: the loss is finite and falls on a fixed batch.

With ``--four-cards`` it runs only the data-parallel paths, on 4 cards,
each against the same computation unsharded on one card: the sharded B=128
pipeline (``BatchedDepthEstimator.shard``) and one sharded train step
(``parallel.mesh.sharded_train_step``).

    python chip_smoke.py
    python chip_smoke.py --four-cards

It exits non-zero, printing no result, when JAX finds no GPU or when any
phase fails. Before the last line it prints the card's name and power
limit; the last line is one JSON object
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CAR_MODEL = os.path.join(ROOT, "examples", "car_model")
BATCH = 128
FRAME_HW = (480, 640)

# the fast-mode settings of bench.py's full-pipeline measurement
FAST = dict(head="mean", match_dtype="bfloat16", warp_dtype="bfloat16",
            lk_iters=5, ransac_samples=48, state_dtype="bfloat16",
            ego_downsample=2, corner_selector="topk", lk_search=24)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def fast_knobs(compensation: str) -> dict:
    import jax.numpy as jnp
    k = dict(FAST, compensation=compensation)
    for name in ("match_dtype", "warp_dtype", "state_dtype"):
        k[name] = jnp.dtype(k[name]).type
    return k


def frames(seed: int, batch: int, steps: int):
    """``steps`` uint8 frame batches (batch, 480, 640, 3) of a smooth random
    texture panning 3 px per frame to the left, made on the device."""
    import jax
    import jax.numpy as jnp
    base = jax.random.uniform(jax.random.PRNGKey(seed), (batch, 120, 160, 3))
    tex = jax.image.resize(base, (batch,) + FRAME_HW + (3,), "bilinear")
    return [(jnp.roll(tex, -3 * k, axis=2) * 255).astype(jnp.uint8)
            for k in range(steps)]


def timed(fn, n: int = 20):
    """(median ms, p90 ms, n) of ``fn()`` ended by block_until_ready."""
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    ts = np.asarray(ts) * 1e3
    return float(np.median(ts)), float(np.percentile(ts, 90)), n


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def car_features(g, params, seed: int, batch: int):
    """Car-model features (f1 cropped, f2) of two consecutive frames."""
    import jax
    from depth_estimation_tpu.data.images import scale_batched_device
    from depth_estimation_tpu.models.flow import (FlowModel,
                                                  crop_features_center)
    model = FlowModel(g)

    @jax.jit
    def feats(fr):
        small = scale_batched_device(fr.astype(np.float32) / 255.0,
                                     g.hImg, g.wImg)
        return model.features(params, small)

    t1, t2 = frames(seed, batch, 2)
    return crop_features_center(g, feats(t1)), feats(t2)


def phase_matcher(g, params, seed: int, batch: int = BATCH) -> dict:
    """Fused kernel vs the plain reference, f32 and bf16 storage; the
    kernel (both storage types) and XLA's plain form (f32) timed."""
    import jax
    import jax.numpy as jnp
    from depth_estimation_tpu.ops import matching
    f1, f2 = car_features(g, params, seed, batch)
    mh, mw = g.maxh, g.maxw
    thr = 0.11
    kern = jax.jit(lambda a, b, dt: matching.match_flow_fused(
        a, b, mh, mw, dt, True, thr), static_argnums=2)
    plain = jax.jit(lambda a, b, dt: matching.match_flow_reference(
        a, b, mh, mw, dt, True, thr), static_argnums=2)

    @jax.jit
    def gate_margin(a, b):
        # distance of the y-marginal's maximum from the gate threshold
        costs = jax.vmap(lambda x, y: matching.match_ssd(x, y, mh, mw))(a, b)
        p = jax.nn.softmax(-costs, axis=-1)
        marg = p.reshape(p.shape[:-1] + (mh, mw)).sum(-1)
        return jnp.abs(marg.max(-1) - thr)

    with jax.default_matmul_precision("highest"):
        ref = [np.asarray(o) for o in plain(f1, f2, jnp.float32)]
        margin = np.asarray(gate_margin(f1, f2))
    got = [np.asarray(o) for o in kern(f1, f2, jnp.float32)]
    idx_mismatch = float((got[0] != ref[0]).mean())
    dyx = max(float(np.abs(got[1] - ref[1]).max()),
              float(np.abs(got[2] - ref[2]).max()))
    dp = float((np.abs(got[3] - ref[3]) / ref[3]).max())
    away = margin > 1e-5
    conf_away = float((got[4] == ref[4])[away].mean())
    check(idx_mismatch <= 1e-4, f"idx mismatch {idx_mismatch}")
    check(dyx <= 1e-4, f"ey/ex max |diff| {dyx} px")
    check(dp <= 1e-5, f"pmax max rel diff {dp}")
    check(conf_away == 1.0, f"conf gate agreement away from thr {conf_away}")

    b16 = [np.asarray(o) for o in kern(f1, f2, jnp.bfloat16)]
    epe = float(np.sqrt((b16[1] - got[1]) ** 2 + (b16[2] - got[2]) ** 2).mean())
    check(epe <= 0.1, f"bf16 mean EPE vs f32 {epe} px")

    times = {
        "kernel_f32_ms": timed(lambda: kern(f1, f2, jnp.float32)),
        "kernel_bf16_ms": timed(lambda: kern(f1, f2, jnp.bfloat16)),
        "xla_f32_ms": timed(lambda: plain(f1, f2, jnp.float32)),
    }
    return dict(shape=list(f1.shape), idx_mismatch=idx_mismatch,
                eyx_max_abs_px=dyx, pmax_max_rel=dp,
                conf_agree_away_from_thr=conf_away,
                conf_pixels_near_thr=int((~away).sum()),
                bf16_mean_epe_px=epe, **times)


def run_batched(est, seq):
    """reset on the first batch, then one step per following batch."""
    import jax
    est.reset(seq[0])
    outs = [est.next_frames(fr) for fr in seq[1:]]
    jax.block_until_ready(outs)
    return [[np.asarray(o) for o in out] for out in outs]


def check_outputs(out, batch: int, g) -> dict:
    xflow, mask, depth, good = out
    check(xflow.shape == (batch, g.hImg, g.wImg), f"xflow {xflow.shape}")
    check(np.isfinite(xflow).all(), "non-finite xflow")
    check(((mask >= 0) & (mask <= 1)).all(), "mask outside [0, 1]")
    check(not np.isnan(depth).any(), "NaN depth")
    sel = (mask > 0.5) & good[:, None, None]
    check(good.mean() >= 0.5, f"good-frame fraction {good.mean()}")
    check(sel.mean() >= 0.05, f"kept-pixel fraction {sel.mean()}")
    return dict(good=float(good.mean()), kept=float(sel.mean()),
                median_xflow_px=float(np.median(xflow[sel])))


def phase_batched(g, params, seed: int, batch: int = BATCH) -> dict:
    import jax
    from depth_estimation_tpu.api_batched import BatchedDepthEstimator
    from depth_estimation_tpu.geometry3d.calibration import ARDRONE
    seq = frames(seed, batch, 4)
    res = {}
    for comp in ("warp", "warp_banded", "decode"):
        est = BatchedDepthEstimator(g, params, ARDRONE, **fast_knobs(comp))
        t0 = time.perf_counter()
        outs = run_batched(est, seq)
        r = check_outputs(outs[-1], batch, g)
        r["first_steps_s"] = time.perf_counter() - t0
        r["step_ms"] = timed(lambda: est.next_frames(seq[1]), n=10)
        if comp == "warp":
            mem = est._step.lower(est.params, est.last_u, est.last_feats,
                                  seq[1]).compile().memory_analysis()
            r["memory_analysis"] = {
                k: getattr(mem, k) for k in dir(mem)
                if k.endswith("_in_bytes") and not k.startswith("host")}
        res[comp] = r
    return res


@contextlib.contextmanager
def pinned_rotation(angle: float):
    """Replace the ego-motion estimate of the batched pipeline by a fixed
    yaw rotation with every track an inlier, on every platform alike."""
    import jax.numpy as jnp
    from depth_estimation_tpu.geometry3d import egomotion as ego
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)

    def fixed(imgs1, imgs2, K, max_points=400, **_):
        B = imgs1.shape[0]
        n = jnp.full((B,), max_points, jnp.int32)
        return ego.EgoMotion(jnp.broadcast_to(jnp.asarray(R), (B, 3, 3)),
                             jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]),
                                              (B, 3)), n, n)

    real = ego.get_ego_motion_batched
    ego.get_ego_motion_batched = fixed
    try:
        yield
    finally:
        ego.get_ego_motion_batched = real


def phase_cpu_parity(g, params, seed: int, batch: int = 2) -> dict:
    """The batched program on the GPU and on the CPU, same frames.

    Pinned rotation, GPU matmuls and convolutions at "highest" precision
    (strict): with the ego-motion estimate replaced by the same fixed
    rotation on both platforms, the rest of the program (resize, undistort,
    trunk, compensation warp, matcher, decode, masks) must agree: prep
    outputs within 2^-6 of their largest magnitude (the bf16 stream state
    may round one ulp apart where f32 sums run in another order), median
    |x-flow| within 0.05 px and masks on 99% of pixels (only pixels at the
    confidence threshold may flip).

    Pinned rotation at default precision (reported): f32 convolutions and
    resize matmuls may run in TF32 on the card (10-bit mantissa), which
    moves the trunk's features by about a bf16 ulp and the soft-argmax by a
    few hundredths of a pixel.

    Estimated rotation (default precision): the fixed-sample RANSAC
    essential fit moves R by ~1e-2 rad under 1e-3 input perturbations on
    the CPU itself, i.e. several tenths of a pixel of rotation flow, so
    here only the good-frame flags and 95% mask agreement are checked."""
    import jax
    from depth_estimation_tpu.api_batched import BatchedDepthEstimator
    from depth_estimation_tpu.geometry3d.calibration import ARDRONE
    seq = [np.asarray(f) for f in frames(seed, batch, 2)]

    def run(kn, device=None):
        est = BatchedDepthEstimator(g, params, ARDRONE, **kn)
        with jax.default_device(device):
            out = run_batched(est, seq)[-1]
            prep = [np.asarray(a, np.float32)
                    for a in est._prep(params, seq[1])]
        return out, prep

    def compare(gpu, cpu_out):
        (xg, mg, _, gg), (xc, mc, _, gc) = gpu, cpu_out
        kept = (mg > 0.5) & (mc > 0.5)
        check(kept.mean() >= 0.05, f"kept-pixel fraction {kept.mean()}")
        return (float(np.median(np.abs(xg - xc)[kept])),
                float(((mg > 0.5) == (mc > 0.5)).mean()),
                bool((gg == gc).all()))

    cpu = jax.devices("cpu")[0]
    with pinned_rotation(0.01):
        cpu_out, prep_c = run(fast_knobs("warp"), cpu)
        with jax.default_matmul_precision("highest"):
            gpu, prep_g = run(fast_knobs("warp"))
        gpu_tf32, _ = run(fast_knobs("warp"))
    prep_rel = max(float(np.abs(a - b).max() / np.abs(b).max())
                   for a, b in zip(prep_g, prep_c))
    dx, agree, good_eq = compare(gpu, cpu_out)
    dx_tf32, agree_tf32, _ = compare(gpu_tf32, cpu_out)
    check(prep_rel <= 2.0 ** -6, f"prep max rel diff {prep_rel}")
    check(good_eq, "good flags differ with the rotation pinned")
    check(dx <= 0.05, f"pinned: median |x-flow gpu - cpu| {dx} px")
    check(agree >= 0.99, f"pinned: mask agreement {agree}")

    gpu, _ = run(fast_knobs("decode"))
    cpu_out, _ = run(fast_knobs("decode"), cpu)
    dx_est, agree_est, good_est = compare(gpu, cpu_out)
    check(good_est, "good flags differ")
    check(agree_est >= 0.95, f"estimated: mask agreement {agree_est}")
    return dict(prep_max_rel_diff=prep_rel,
                pinned_median_abs_dxflow_px=dx, pinned_mask_agreement=agree,
                pinned_default_precision_median_abs_dxflow_px=dx_tf32,
                pinned_default_precision_mask_agreement=agree_tf32,
                estimated_median_abs_dxflow_px=dx_est,
                estimated_mask_agreement=agree_est)


def phase_online(g, params, seed: int) -> dict:
    from depth_estimation_tpu.api import DepthEstimator
    from depth_estimation_tpu.geometry3d.calibration import ARDRONE
    seq = [np.asarray(f[0]) for f in frames(seed, 1, 10)]
    est = DepthEstimator(g, params, ARDRONE)
    est.reset(seq[0])
    ts = []
    for fr in seq[1:4]:
        t0 = time.perf_counter()
        im, xflow, mask = est.next_frame_depth(fr)
        ts.append(time.perf_counter() - t0)
        check(xflow.shape == (g.hImg, g.wImg), f"xflow {xflow.shape}")
        check(np.isfinite(xflow).all() and np.isfinite(mask).all(),
              "non-finite next_frame_depth output")
    est.reset(seq[3])
    outs = []
    with est.stream(lag=3) as st:
        for fr in seq[4:]:
            o = st.push(fr)
            if o is not None:
                outs.append(o)
        outs.extend(st.drain())
    check(len(outs) == len(seq) - 4, f"stream returned {len(outs)}")
    check(all(o.shape == (2, g.hImg, g.wImg) and np.isfinite(o).all()
              for o in outs), "bad stream output")
    return dict(next_frame_depth_s=ts, streamed=len(outs))


def fixed_patch_batch(g, seed: int, n: int):
    """A PatchDataset of n patch pairs whose targets are real shifts of a
    random texture."""
    from depth_estimation_tpu import codecs
    from depth_estimation_tpu.training.train import PatchDataset
    rng = np.random.RandomState(seed)
    hp, wp, m = g.hPatch2, g.wPatch2, max(g.maxh, g.maxw)
    tex = rng.rand(n, hp + 2 * m, wp + 2 * m, 3).astype(np.float32)
    dy = rng.randint(-g.halfh1, g.halfh2 + 1, n)
    dx = rng.randint(-g.halfw1, g.halfw2 + 1, n)
    p2 = tex[:, m:m + hp, m:m + wp]
    # p1[y, x] = p2[y + dy, x + dx]: the target displacement is (dy, dx)
    p1 = np.stack([tex[i, m + dy[i]:m + dy[i] + hp, m + dx[i]:m + dx[i] + wp]
                   for i in range(n)])
    it = np.asarray(codecs.encode(g, dy, dx), np.int32)
    return PatchDataset(p1, p2, np.stack([dy, dx], 1).astype(np.float32), it)


def phase_train(g, learning, seed: int, batch: int = 256) -> dict:
    import jax
    from depth_estimation_tpu.models.flow import FlowModel
    from depth_estimation_tpu.training.train import Trainer
    lrn = dataclasses.replace(learning, batch_size=batch)
    trainer = Trainer(FlowModel(g), lrn)
    state = trainer.init(jax.random.PRNGKey(seed))
    ds = fixed_patch_batch(g, seed, batch)
    losses = []
    for _ in range(6):
        state, stats = trainer.epoch(state, ds)
        losses.append(stats["loss"])
    check(bool(np.isfinite(losses).all()), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    return dict(losses=losses)


def phase_four_cards_pipeline(g, params, seed: int,
                              batch: int = BATCH) -> dict:
    """The sharded B=128 pipeline on 4 cards against the unsharded one on
    card 0. Both run the same per-stream program; tolerances as in
    cpu_parity (TF32 and the per-card batch size may change which
    convolution algorithm XLA picks)."""
    import jax
    from depth_estimation_tpu.api_batched import BatchedDepthEstimator
    from depth_estimation_tpu.geometry3d.calibration import ARDRONE
    from depth_estimation_tpu.parallel import mesh as pmesh
    seq = frames(seed, batch, 3)
    kn = fast_knobs("decode")
    one = run_batched(BatchedDepthEstimator(g, params, ARDRONE, **kn), seq)
    mesh = pmesh.make_mesh(jax.devices()[:4], axis="dp")
    est4 = BatchedDepthEstimator(g, params, ARDRONE, **kn).shard(mesh)
    four = run_batched(est4, seq)
    (x1, m1, _, g1), (x4, m4, _, g4) = one[-1], four[-1]
    check_outputs(four[-1], batch, g)
    both = (m1 > 0.5) & (m4 > 0.5)
    dx = float(np.median(np.abs(x1 - x4)[both]))
    agree = float(((m1 > 0.5) == (m4 > 0.5)).mean())
    check(float((g1 == g4).mean()) >= 0.99, "good flags differ")
    check(dx <= 0.05, f"median |x-flow 4 cards - 1 card| {dx} px")
    check(agree >= 0.99, f"mask agreement {agree}")
    return dict(median_abs_dxflow_px=dx, mask_agreement=agree,
                step_ms_4cards=timed(lambda: est4.next_frames(seq[1]), 10))


def phase_four_cards_train(g, learning, seed: int, batch: int = 256) -> dict:
    """One sharded train step (gradient all-reduce over 4 cards) against the
    unsharded step on one card."""
    import jax
    from depth_estimation_tpu import codecs
    from depth_estimation_tpu.models.flow import FlowModel
    from depth_estimation_tpu.parallel import mesh as pmesh
    from depth_estimation_tpu.training.train import Trainer
    trainer = Trainer(FlowModel(g),
                      dataclasses.replace(learning, batch_size=batch))
    state = trainer.init(jax.random.PRNGKey(seed))
    ds = fixed_patch_batch(g, seed, batch)
    soft = np.zeros((batch, codecs.n_indices(g)), np.float32)
    args = (ds.patches1, ds.patches2, ds.itargets, soft)
    s1, aux1 = trainer._step(state, *args)
    mesh = pmesh.make_mesh(jax.devices()[:4], axis="dp")
    step = pmesh.sharded_train_step(trainer, mesh)
    s4, aux4 = step(pmesh.replicate(state, mesh), *pmesh.shard_batch(args,
                                                                      mesh))
    dl = abs(float(aux1["loss"]) - float(aux4["loss"])) / abs(
        float(aux1["loss"]))
    dp = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
             for a, b in zip(jax.tree.leaves(s1.params),
                             jax.tree.leaves(s4.params)))
    check(dl <= 1e-3, f"loss rel diff {dl}")
    check(dp <= 1e-4, f"params max |diff| {dp}")
    return dict(loss_rel_diff=dl, params_max_abs_diff=dp)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the data-parallel paths on 4 cards")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import jax
    from depth_estimation_tpu.models import io as mio

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})",
              file=sys.stderr)
        return 2
    need = 4 if args.four_cards else 1
    if len(devices) < need:
        print(f"chip_smoke: {need} GPUs needed, {len(devices)} found",
              file=sys.stderr)
        return 2
    name = card()
    g, learning, params, _ = mio.load_model(CAR_MODEL)
    if args.four_cards:
        phases = [
            ("four_cards_pipeline",
             lambda: phase_four_cards_pipeline(g, params, args.seed)),
            ("four_cards_train",
             lambda: phase_four_cards_train(g, learning, args.seed)),
        ]
    else:
        phases = [
            ("matcher", lambda: phase_matcher(g, params, args.seed)),
            ("batched", lambda: phase_batched(g, params, args.seed)),
            ("cpu_parity", lambda: phase_cpu_parity(g, params, args.seed)),
            ("online", lambda: phase_online(g, params, args.seed)),
            ("train", lambda: phase_train(g, learning, args.seed)),
        ]
    failed = []
    for pname, fn in phases:
        t0 = time.perf_counter()
        try:
            res, ok = fn(), True
        except Exception as e:  # report every phase, then fail the run
            traceback.print_exc()
            res, ok = {"error": f"{type(e).__name__}: {e}"}, False
            failed.append(pname)
        print(json.dumps({"phase": pname, "ok": ok, "card": name,
                          "wall_s": time.perf_counter() - t0, **res}),
              flush=True)
    print(name, flush=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
