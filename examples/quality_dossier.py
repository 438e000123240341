"""Quality dossier: train-to-quality demonstration + the published accuracy
table (README "Quality" section).

What it does (all on whatever backend JAX picks):

1. Generates a synthetic-warp training sequence from the bundled reference
   image (/root/reference/celiu/car1.jpg — read-only fixture): 180x320
   crops shifted by a known integer displacement per frame (the
   cartesian-GT "testme" generator pattern,
   /root/reference/radial/radial_opticalflow_groundtruth.lua:170-210),
   so dense analytic GT exists for every pair.
2. Trains through the real CLI (cli/opticalflow.main) until the score
   plateaus: single-scale on cross-correlation GT, single-scale on liu
   (variational) GT, and the multiscale pyramid model; per-epoch
   test_acc/full_acc histories land in the checkpoints, and the learning
   curve PNG is exported.
3. Scores every trained model with the reference's own metrics
   (score_opticalflow.lua:27-70 via training/score.eval_flow): patch
   accuracy, full-image accuracy, meanDst/stdDst — against the analytic
   GT, the cc GT field, and the liu GT field.
4. Measures the bf16 inference options' flow deltas vs the f32 path on
   real imagery (the car pair + a sequence pair): mean EPE delta for
   match_flow_fused with bf16/f16 storage and the multiscale staged
   bf16/f16 decode. The precision policy (CLAUDE.md) requires <= 0.1 px.

Standalone rows (merged into the JSON via --radial-only /
--radial-noisy-only / --v2-only / --legacy-only) extend the table to every
remaining trainable model family: the radial polar 1-D matcher (clean and
photometric-noise scenes), the version2 simplified network, and the
legacy direct-depth classifier — each trained through its real CLI and
scored on held-out data.

Writes examples/quality_dossier.json + quality_curves.png and prints the
markdown table that README embeds.

Usage: python examples/quality_dossier.py [--epochs N] [--out DIR]
"""

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def _register_dossier_cal():
    """Idempotently register the 320x180 dossier calibration preset."""
    from depth_estimation_tpu.geometry3d import calibration as calmod
    if "dossier320x180" not in calmod.PRESETS:
        calmod.PRESETS["dossier320x180"] = dataclasses.replace(
            calmod.RECTIFIED_GOPRO_SMALL, name="dossier320x180",
            wImg=320, hImg=180, cx=160.0, cy=90.0)


# per-transition shifts (dy, dx): VARYING so the matching task is
# non-trivial (a constant shift would make every patch the same class and
# patch accuracy vacuously 1.0); all within the 16x16 window's centered
# range [-7, 8]
SHIFTS = [(1, 2), (0, -3), (2, 1), (-1, 3), (3, -2), (0, 4), (1, 2)]


def make_warp_sequence(out_dir: str, n: int = 8):
    """Shifted 180x320 crops of car1.jpg: frame k+1's content is frame k's
    shifted by SHIFTS[k] -> true flow on pair k is exactly SHIFTS[k]
    everywhere (img1[y, x] == img2[y + dy, x + dx], the prepareTarget
    convention). Returns (root, true flow of the LAST pair)."""
    from PIL import Image
    from depth_estimation_tpu.data.images import load_image, scale

    H, W = 180, 320
    shifts = SHIFTS[:n - 1]
    # cumulative crop offsets, back from the last frame
    offs = [(0, 0)]
    for dy, dx in reversed(shifts):
        offs.insert(0, (offs[0][0] + dy, offs[0][1] + dx))
    oy = [o[0] for o in offs]
    ox = [o[1] for o in offs]
    my = max(oy) - min(oy) + 8
    mx = max(ox) - min(ox) + 8
    big = np.asarray(scale(load_image("/root/reference/celiu/car1.jpg"),
                           H + my, W + mx))
    d = os.path.join(out_dir, "images")
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        off_y = 4 + oy[i] - min(oy)
        off_x = 4 + ox[i] - min(ox)
        im = big[off_y:off_y + H, off_x:off_x + W]
        Image.fromarray((np.clip(im, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(d, f"{i:09d}.png"))
    flow = np.zeros((2, H, W), np.float32)
    flow[0] = shifts[-1][0]
    flow[1] = shifts[-1][1]
    return out_dir, flow


def train(root: str, out: str, epochs: int, gt: str, multiscale: int = 0,
          n_frames: int = 8, n_train: int = 3000, lr: float = 0.02,
          share_filters: bool = True, n_features: int = 10,
          kernel1: int = None, num_layers: int = 1, kernel2: int = 16,
          layer_two_size: int = 8, layer_two_connections: int = 4,
          soft_targets: float = None, resume: bool = False):
    from depth_estimation_tpu.cli import opticalflow

    if kernel1 is None:
        kernel1 = 16 if not multiscale else 5
    args = [
        "--root-directory", root,
        "--num-input-images", str(n_frames),
        "--n-train-set", str(n_train), "--n-test-set",
        str(max(n_train // 4, 64)),
        "--num-epochs", str(epochs),
        "--n-features", str(n_features),
        "--kernel1-size", str(kernel1),
        "--num-layers", str(num_layers),
        "--kernel2-size", str(kernel2),
        "--layer-two-size", str(layer_two_size),
        "--layer-two-connections", str(layer_two_connections),
        "--window-size", "16",
        "--gt-window-size", "16",
        "--learning-rate", str(lr),
        "--batch-size", "32",
        "--calibration", "dossier320x180",
        "--motion-correction", "none",
        "--groundtruth", gt,
        "--renew-train-set",
        "--output-model-dir", out,
    ]
    if multiscale:
        args += ["--multiscale", str(multiscale)]
        if share_filters:
            args += ["--share-filters"]
    if soft_targets is not None:
        args += ["--soft-targets", str(soft_targets)]
    if resume:
        args += ["--resume"]
    rc = opticalflow.main(args)
    assert rc == 0
    (name,) = os.listdir(out)
    return os.path.join(out, name)


def _ms_variant_quality(work: str, key: str, epochs: int = 400,
                        n_frames: int = 8, n_train: int = 3000,
                        **train_overrides):
    """Shared body for the multiscale ABLATION rows: train a multiscale
    variant through the same CLI/sequence as the main multiscale row and
    score the same held-out pair. The main row's plateau (~0.35 patch
    acc) is attributed in the README to the foveated design's
    quantization + the 5x5 shared filter's capacity; each variant row
    isolates one leg of that attribution. Records under ``key``."""
    import jax.numpy as jnp
    from depth_estimation_tpu import codecs
    from depth_estimation_tpu.models import io as model_io
    from depth_estimation_tpu.models.multiscale import MultiscaleFlowModel
    from depth_estimation_tpu.training import score as score_mod
    from PIL import Image

    _register_dossier_cal()
    root, true_flow = make_warp_sequence(os.path.join(work, "seq"),
                                         n=n_frames)
    mdir = os.path.join(work, f"models_{key}")
    # resume only from a NON-EMPTY model dir: a run that crashed after
    # mkdir but before the first save leaves an empty dir (round-3 advisor
    # finding), and os.listdir()[0] would raise instead of retraining.
    # An under-trained checkpoint (a run killed mid-flight) is continued
    # through the trainer's --resume for the remaining epochs.
    if not (os.path.isdir(mdir) and os.listdir(mdir)):
        mpath = train(root, mdir, epochs, "cross-correlation", multiscale=3,
                      n_frames=n_frames, n_train=n_train,
                      **train_overrides)
    else:
        mpath = os.path.join(mdir, os.listdir(mdir)[0])
        done = len(json.load(open(os.path.join(mpath, "meta.json")))["score"])
        if done < epochs:
            print(f"{key}: checkpoint at epoch {done} < {epochs} — resuming")
            mpath = train(root, mdir, epochs, "cross-correlation",
                          multiscale=3, n_frames=n_frames, n_train=n_train,
                          resume=True, **train_overrides)

    meta = json.load(open(os.path.join(mpath, "meta.json")))
    hist = meta["score"]
    k6, k7 = n_frames - 2, n_frames - 1
    f6 = np.asarray(Image.open(os.path.join(
        root, "images", f"{k6:09d}.png")), np.float32) / 255.0
    f7 = np.asarray(Image.open(os.path.join(
        root, "images", f"{k7:09d}.png")), np.float32) / 255.0
    geom, _, params, _ = model_io.load_model(mpath)
    model = MultiscaleFlowModel(geom)
    idx, _ = model.decode_full(params, jnp.asarray(f6), jnp.asarray(f7))
    wy, wx = codecs.decode(geom, idx)
    full = np.stack([np.asarray(wy, np.float32), np.asarray(wx, np.float32)])
    s = score_mod.eval_flow(geom, full, true_flow)
    return {"epochs": len(hist),
            "final_patch_acc": round(hist[-1]["test_acc"], 4),
            "best_patch_acc": round(max(h["test_acc"] for h in hist), 4),
            "history_test_acc": [round(h["test_acc"], 4) for h in hist],
            "full_acc_analytic": round(s.accuracy, 4),
            "meanDst_analytic": round(s.mean_dst, 4)}


def ms_unshared_quality(work: str, **kw):
    """Multiscale row WITHOUT filter sharing (per-scale filters — the
    reference's share_filters=false branch,
    opticalflow_model_multiscale.lua:219-225): measures how much of the
    main row's plateau is the SHARING specifically.
    Records ``multiscale_ccGT_unshared``."""
    return _ms_variant_quality(work, "multiscale_ccGT_unshared",
                               share_filters=False, **kw)


def ms_capacity_quality(work: str, **kw):
    """Multiscale row with DOUBLED filter capacity (7x7 kernels, 20
    features instead of the reference's 5x5 x 10,
    opticalflow_model_multiscale.lua:219-225 geometry defaults): measures
    how much of the main row's plateau is first-layer CAPACITY. (Measured
    answer: little — the dominant trainable residual turned out to be
    receptive field + depth, closed by the ms_ref2layer row below.)
    Records ``multiscale_ccGT_capacity``."""
    return _ms_variant_quality(work, "multiscale_ccGT_capacity",
                               n_features=20, kernel1=7, **kw)


def ms_ref2layer_quality(work: str, **kw):
    """Multiscale row at the REFERENCE'S OWN default network: 2 layers,
    kernels 5 + 16 - 1 = 20x20 receptive field, 8-feature sparse middle
    layer (opticalflow.lua defaults: -nl 2 -k1s 5 -k2s 16 -s2 8 -s2c 4),
    unshared per-scale filters (-sf defaults false,
    opticalflow_model_multiscale.lua:219-225). The main multiscale rows
    train a single 5x5 conv — a far smaller receptive field than the
    reference ever uses; this row measures the plateau at the reference's
    actual architecture. Records ``multiscale_ccGT_ref2layer``."""
    return _ms_variant_quality(work, "multiscale_ccGT_ref2layer",
                               share_filters=False, num_layers=2,
                               kernel1=5, kernel2=16, **kw)


def ms_ref2layer_soft_quality(work: str, **kw):
    """ref2layer + the reference's remaining training lever: soft Gaussian
    targets (-st, sigma^2 = 1 — prepareTarget's soft branch,
    opticalflow_model.lua:298-315, lifted to the multiscale codec; see
    MultiscaleTrainer). Round-4 verdict item: the trained ref2layer row
    CLEARED the lossless-feature oracle, so the plateau attribution needed
    the reference's untried training levers measured.
    Records ``multiscale_ccGT_ref2layer_soft``. Epoch budget 200: the
    ref2layer baseline itself recorded 164 epochs with its plateau
    reached by ~150 (history in the JSON), so 200 is comparable and a
    400-epoch run would mostly train past a demonstrated plateau."""
    kw.setdefault("epochs", 200)
    return _ms_variant_quality(work, "multiscale_ccGT_ref2layer_soft",
                               share_filters=False, num_layers=2,
                               kernel1=5, kernel2=16, soft_targets=1.0,
                               **kw)


def ms_ref2wide_quality(work: str, **kw):
    """ref2layer widened (the other reference lever — nFeatures and layer
    sizes are free parameters of its design, opticalflow.lua:31-44):
    16-feature middle layer with 8-way sparse fan-in, 20 output features,
    same 20x20 receptive field. Records ``multiscale_ccGT_ref2wide``.
    Epoch budget 200 (see ms_ref2layer_soft_quality)."""
    kw.setdefault("epochs", 200)
    return _ms_variant_quality(work, "multiscale_ccGT_ref2wide",
                               share_filters=False, num_layers=2,
                               kernel1=5, kernel2=16, layer_two_size=16,
                               layer_two_connections=8, n_features=20,
                               **kw)


class _Im2ColFilter:
    """Lossless 'filter': features at each pixel are the raw kh x kw x C
    patch itself, so feature-SSD == patch-SSD — the identity-kernel oracle
    trick of the reference's own tests (test_multiscale.lua:44-55, raised
    to the full patch). Plugs into MultiscaleFlowModel in place of
    ConvFilter to measure the DESIGN ceiling with perfect features."""

    def __init__(self, kh: int, kw: int):
        self.kh, self.kw = kh, kw

    def init(self, rng, dummy):
        return {}

    def apply(self, params, x):
        import jax.numpy as jnp
        kh, kw = self.kh, self.kw
        H, W = x.shape[0], x.shape[1]
        slices = [x[ky:H - kh + 1 + ky, kx:W - kw + 1 + kx]
                  for ky in range(kh) for kx in range(kw)]
        return jnp.concatenate(slices, axis=-1)


_ORACLE_FNS = {}


def _oracle_ms_decode(geom, img1, img2):
    """Full-image WTA decode of the REAL multiscale pipeline (per-ratio
    avg-pool downsample, per-scale SSD matcher + softmax, cascade,
    middle-band removal, concat-codec WTA with the middle tie-break) with
    the conv trunk replaced by lossless patch features (_Im2ColFilter).
    The NO-LEARNING floor at that receptive field — not a ceiling: the
    ref2layer trained row beats the 16x16 oracle (0.487 vs 0.386 full
    acc) because learned nonlinear features shape the per-scale score
    distributions the cascade mixes, which raw-patch SSD cannot."""
    import jax
    import jax.numpy as jnp
    from depth_estimation_tpu.models.multiscale import MultiscaleFlowModel

    if geom not in _ORACLE_FNS:
        model = MultiscaleFlowModel(geom)
        model.filter = _Im2ColFilter(geom.hKernel, geom.wKernel)
        _ORACLE_FNS[geom] = jax.jit(
            lambda i1, i2: model.decode_full({}, i1, i2)[0])
    idx = _ORACLE_FNS[geom](jnp.asarray(img1), jnp.asarray(img2))
    return np.asarray(idx)


def multiscale_ceiling(work: str, n_frames: int = 8):
    """The multiscale DESIGN-CEILING oracles (no training; round-3 verdict
    item 1). Two ceilings, both on the dossier sequence the trained rows
    score on:

    (a) ``codec``: the analytic flow of every pair encoded through the
        multiscale band codec (codecs.yx2x_multi_scalar — nearest
        representable displacement) and decoded back. Errors here are pure
        index quantization: displacements off the finest scale's range
        land on coarse cells that decode to multiples of the ratio
        (x2yxMulti semantics, opticalflow_model_multiscale.lua:83-132).

    (b) ``oracle_k16`` / ``oracle_k5``: the real pipeline (downsample,
        per-scale softmax, cascade, band removal, WTA) run with LOSSLESS
        patch features at the GT kernel (16x16, the cc-GT matcher's own
        resolution) and at the trained rows' receptive field (5x5). The
        gap between these and (a) is downsample matching ambiguity — a
        coarse scale sees off-grid displacements as half-texel shifts and
        cannot resolve the codec's ceil-quantized cell reliably; the gap
        between them and the trained rows is what training can recover.

    Per pair k the analytic flow is SHIFTS[k] everywhere, so per-pair
    scores are exact. Reports per-pair and mean metrics: exact-index
    agreement with the encoded target (the patch-accuracy analogue),
    eval_flow full accuracy/meanDst vs the analytic field, plus the
    held-out pair's row (the number comparable to the trained rows'
    full_acc_analytic)."""
    import dataclasses as _dc
    import jax.numpy as jnp
    from PIL import Image
    from depth_estimation_tpu import codecs
    from depth_estimation_tpu.geometry import Geometry
    from depth_estimation_tpu.training import score as score_mod

    _register_dossier_cal()
    root, _ = make_warp_sequence(os.path.join(work, "seq"), n=n_frames)
    H, W = 180, 320
    shifts = SHIFTS[:n_frames - 1]

    # the trained multiscale rows' geometry: window 16, 3 scales ->
    # per-scale 4x4 window, ratios (1, 2, 4) (cli/opticalflow.py mirrors
    # opticalflow.lua:175-186)
    def geo(k):
        return Geometry(hImg=H, wImg=W, layers=((3, k, k, 3 * k * k),),
                        maxh=4, maxw=4, maxhGT=16, maxwGT=16,
                        hKernelGT=16, wKernelGT=16, multiscale=True,
                        ratios=(1, 2, 4),
                        output_extraction_method="max")

    g16, g5 = geo(16), geo(5)
    frames = [np.asarray(Image.open(os.path.join(
        root, "images", f"{i:09d}.png")), np.float32) / 255.0
        for i in range(n_frames)]

    out = {"codec": {"per_pair": []}, "oracle_k16": {"per_pair": []},
           "oracle_k5": {"per_pair": []}}
    for k, (dy, dx) in enumerate(shifts):
        true = np.zeros((2, H, W), np.float32)
        true[0], true[1] = dy, dx
        enc = codecs.yx2x_multi_scalar(g16, dy, dx)
        qy, qx = codecs.x2yx_multi_scalar(g16, enc)
        dec = np.zeros((2, H, W), np.float32)
        dec[0], dec[1] = qy, qx
        s = score_mod.eval_flow(g16, dec, true)
        out["codec"]["per_pair"].append(
            {"shift": [dy, dx], "decoded": [int(qy), int(qx)],
             "full_acc": round(s.accuracy, 4),
             "meanDst": round(s.mean_dst, 4)})
        for key, g in (("oracle_k16", g16), ("oracle_k5", g5)):
            idx = _oracle_ms_decode(g, frames[k], frames[k + 1])
            wy, wx = codecs.decode(g, idx)
            full = np.stack([np.asarray(wy, np.float32),
                             np.asarray(wx, np.float32)])
            s = score_mod.eval_flow(g, full, true)
            hb, wb = score_mod.borders(g)
            exact = float((idx[hb:H - hb, wb:W - wb] == enc).mean())
            out[key]["per_pair"].append(
                {"shift": [dy, dx], "exact_index_acc": round(exact, 4),
                 "full_acc": round(s.accuracy, 4),
                 "meanDst": round(s.mean_dst, 4)})

    for key in out:
        rows = out[key]["per_pair"]
        out[key]["mean_full_acc"] = round(
            float(np.mean([r["full_acc"] for r in rows])), 4)
        out[key]["mean_meanDst"] = round(
            float(np.mean([r["meanDst"] for r in rows])), 4)
        if "exact_index_acc" in rows[0]:
            out[key]["mean_exact_index_acc"] = round(
                float(np.mean([r["exact_index_acc"] for r in rows])), 4)
        out[key]["held_out_full_acc"] = rows[-1]["full_acc"]
        out[key]["held_out_meanDst"] = rows[-1]["meanDst"]
    return out


def redraw_curves_from_json():
    """Redraw quality_curves.png from the JSON's recorded epoch histories
    (every row carrying ``history_test_acc``) — unlike the main run's
    checkpoint-reading plot this includes the --*-only ablation rows, whose
    training state lives in _dossier_work and is not committed."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    path = os.path.join(HERE, "quality_dossier.json")
    data = json.load(open(path))
    fig, ax = plt.subplots(figsize=(8, 5))
    for name in sorted(data):
        row = data[name]
        hist = row.get("history_test_acc") if isinstance(row, dict) else None
        if hist:
            ax.plot(range(len(hist)), hist, linewidth=1.1,
                    label=f"{name} ({len(hist)} ep)")
    ax.set_xlabel("epoch")
    ax.set_ylabel("held-out patch accuracy")
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    out = os.path.join(HERE, "quality_curves.png")
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print("curves:", out)
    return out


def full_image_scores(model, geom, params, img1, img2, gts):
    """Decode a full frame and score it against each GT field."""
    import jax.numpy as jnp
    from depth_estimation_tpu.models import flow as flow_model
    from depth_estimation_tpu.training import score as score_mod

    dist = model.scores(params, jnp.asarray(img1), jnp.asarray(img2))
    dec = flow_model.process_output(geom, dist, process_full=True)
    full = np.asarray(dec.full)
    out = {}
    for name, gt in gts.items():
        if gt is None:
            continue
        s = score_mod.eval_flow(geom, full, gt)
        out[name] = {"full_acc": round(s.accuracy, 4),
                     "meanDst": round(s.mean_dst, 4),
                     "stdDst": round(s.std_dst, 4)}
    return out, full


def bf16_epe_deltas(geom, params, img1, img2):
    """Mean EPE between the f32 fused decode and each reduced-precision
    storage option of the fused matcher (bf16, f16), and with the trunk
    itself run on bf16 images."""
    import jax.numpy as jnp
    from depth_estimation_tpu.models.flow import FlowModel, crop_features_center
    from depth_estimation_tpu.ops import matching

    model = FlowModel(geom)
    f1 = crop_features_center(geom, model.features(params, jnp.asarray(img1)))
    f2 = model.features(params, jnp.asarray(img2))
    # trunk-in-bf16 option: cast the IMAGES to bf16 so the conv itself
    # runs in bf16 (TrunkConv computes in the input dtype); the matcher
    # then reads already-bf16 features. Measured against the all-f32
    # reference because that is what the <=0.1 px budget is defined on.
    f1b = crop_features_center(
        geom, model.features(params, jnp.asarray(img1, jnp.bfloat16)))
    f2b = model.features(params, jnp.asarray(img2, jnp.bfloat16))

    def flow_of(dtype, feats=(f1, f2)):
        _, ey, ex, _ = matching.match_flow_fused(
            feats[0], feats[1], geom.maxh, geom.maxw, dtype)
        return np.stack([np.asarray(ey), np.asarray(ex)])

    ref = flow_of(jnp.float32)
    outs = {}
    for name, fl in (
        ("fused_bf16", flow_of(jnp.bfloat16)),
        ("fused_f16", flow_of(jnp.float16)),
        ("trunk_bf16_fused_bf16", flow_of(jnp.bfloat16, (f1b, f2b))),
    ):
        d = np.sqrt(((fl - ref) ** 2).sum(0))
        outs[name] = {"mean_epe_delta_px": round(float(d.mean()), 4),
                      "p99_epe_delta_px": round(float(np.percentile(d, 99)), 4)}
    return outs


def multiscale_bf16_delta(geom, params, img1, img2):
    """Multiscale staged decode: WTA flow delta bf16 vs f32 (the staged
    decode is WTA, so the delta is the mean L2 of the decoded integer
    displacements)."""
    import jax.numpy as jnp
    from depth_estimation_tpu import codecs
    from depth_estimation_tpu.models.multiscale import MultiscaleFlowModel

    outs = {}
    f32 = MultiscaleFlowModel(geom)
    i1, i2 = jnp.asarray(img1), jnp.asarray(img2)
    idx32, _ = f32.decode_full(params, i1, i2)
    y32, x32 = codecs.decode(geom, idx32)
    for name, dtype in (("multiscale_staged_bf16", jnp.bfloat16),
                        ("multiscale_staged_f16", jnp.float16)):
        m = MultiscaleFlowModel(geom, decode_dtype=dtype)
        idx16, _ = m.decode_full(params, i1, i2)
        y16, x16 = codecs.decode(geom, idx16)
        d = np.sqrt((np.asarray(y32 - y16) ** 2
                     + np.asarray(x32 - x16) ** 2))
        outs[name] = {
            "mean_epe_delta_px": round(float(d.mean()), 4),
            "wta_agreement": round(float((np.asarray(idx32)
                                          == np.asarray(idx16)).mean()), 4)}
    return outs


def radial_quality(work: str, epochs: int = 120, n_train: int = 4000,
                   h_win: int = 8, res: int = 96, lr: float = 0.03,
                   noise: float = 0.0,
                   net_spec: str = "[[3,5,5,10],'tanh']",
                   n_frames: int = 7,
                   zoom=(1.06, 1.12),
                   n_scenes: int = 1,
                   clean_gt: bool = False,
                   tag: str = ""):
    """Radial (polar 1-D) matcher quality row: train through the real CLI
    (cli/train_radial.main) on a synthetic forward-motion scene — two
    depth planes zooming outward from the center epipole, the
    test_radial_opticalflow regime
    (/root/reference/radial/test_radial_opticalflow.lua) — then score
    HELD-OUT patches from the final, never-trained-on pair: patch accuracy
    (the reference's own train/test metric,
    radial/train_radial_opticalflow.lua) and mean |WTA - target| radial
    EPE in polar rows. For context the row also records the raw-pixel
    SSD-WTA baseline on the same held-out patches — the no-learning
    reference point, which on this clean synthetic scene sits near the
    ceiling set by cc-GT noise + polar resampling; the learned 10-channel
    matcher is expected to approach it (measured: within ~2% patch acc),
    not beat it, since the inputs carry no photometric noise for learned
    features to filter.

    ``noise`` > 0 adds per-frame INDEPENDENT Gaussian pixel noise (sigma
    in [0,1] image units) to every training frame — the regime where
    learned features earn their keep: the cc-GT's 16x16 patches average
    the noise out (targets stay usable), raw-pixel SSD on the matcher's
    small windows does not, and the trained filters learn to smooth.
    Evaluation is on a FRESH noisy 2-frame scene (new texture seed, same
    zoom/noise distributions; GT from its clean frames — see the fairness
    note in the body). This is the ``radial_noisy`` dossier row; the
    learned matcher is expected to BEAT the raw-SSD baseline here."""
    import jax
    import jax.numpy as jnp
    import flax.serialization
    from PIL import Image
    from depth_estimation_tpu.flow.celiu import bilinear_sample, gaussian_smooth
    from depth_estimation_tpu.geometry import Geometry
    from depth_estimation_tpu.geometry3d import calibration as calmod
    from depth_estimation_tpu.cli import train_radial
    from depth_estimation_tpu.data import datasets as ds_mod
    from depth_estimation_tpu.models.radial import RadialFlowNetwork

    cal = calmod.PRESETS["rectified_gopro_small"]
    H, W = cal.hImg, cal.wImg
    rng = np.random.RandomState(11)

    def make_base():
        b = np.asarray(gaussian_smooth(
            jnp.asarray(rng.rand(H, W, 3).astype(np.float32)), 0.8, 2))
        return np.clip(b * 1.5, 0, 1).astype(np.float32)

    def forward_step(img, s_top, s_bottom):
        cy, cx = H / 2, W / 2
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        s = np.where(yy < cy, s_top, s_bottom)
        xs = cx + (xx - cx) / s
        ys = cy + (yy - cy) / s
        return np.asarray(bilinear_sample(jnp.asarray(img),
                                          jnp.asarray(xs), jnp.asarray(ys)))

    # sigma in the dataset/model dir names: different-sigma corpora must
    # not share image files, GT caches, or weights
    ds_name = (f"radial_seq_noisy_s{noise:g}" + ("_ms" if n_scenes > 1
               else "") if noise else "radial_seq")
    if clean_gt:
        # the clean-targets mechanism-isolation row (round-3 verdict item
        # 4): SAME noisy pixels, but supervision comes from the aligned
        # CLEAN frames via the trainer's --gt-dataset flag. Distinct
        # dataset/model names keep corpora and weights separate.
        assert noise, "clean_gt only makes sense with noise > 0"
        ds_name += "_cleangt"
    gt_ds_name = ds_name + "_gt"
    seq = os.path.join(work, ds_name, "images")
    os.makedirs(seq, exist_ok=True)
    if clean_gt:
        seq_gt = os.path.join(work, gt_ds_name, "images")
        os.makedirs(seq_gt, exist_ok=True)
    frames = []
    # n_scenes > 1 writes SEVERAL short fresh-texture chains back-to-back
    # into one numbered directory (scene-specific feature overfitting is
    # exactly what the noisy row's fresh-scene evaluation exposed; short
    # chains also keep texture from zoom-washing). The seam pairs between
    # scenes are unrelated images, dropped via the trainer's
    # --scene-length flag — measured: the ego-motion inlier gate alone
    # passed 23/23 pairs including all five seams (an essential matrix
    # fits unrelated-texture LK tracks above the bad-frame threshold), so
    # seam handling must be deterministic, not gate-based.
    for s in range(n_scenes):
        img = make_base()
        for i in range(n_frames):
            save = img
            if noise:
                save = np.clip(img + rng.randn(H, W, 3).astype(np.float32)
                               * noise, 0, 1)
            Image.fromarray((save * 255).astype(np.uint8)).save(
                os.path.join(seq, f"{s * n_frames + i:09d}.png"))
            if clean_gt:
                Image.fromarray((img * 255).astype(np.uint8)).save(
                    os.path.join(seq_gt, f"{s * n_frames + i:09d}.png"))
            frames.append(save)
            # strong two-plane zoom: radial flow spans most of the hWin
            # window after the cartesian->polar-row rescale (hInput/rmax
            # ~ 0.37 here). Long chains need a gentler zoom — content
            # magnifies multiplicatively and texture washes out (a
            # 12-frame chain at the default zoom leaves the last pair
            # with 0.5% GT coverage)
            img = forward_step(img, zoom[0], zoom[1])

    # ``tag`` separates model dirs for architecture variants trained on the
    # SAME corpus (e.g. the wide-feature-bank row): corpus/GT caches shared,
    # weights distinct
    omd = os.path.join(work, ("models_" + ds_name).replace("_seq", "") + tag)
    weights = os.path.join(omd, f"e{epochs - 1}.msgpack")
    if not os.path.exists(weights):
        # single scene: train on frames 0..n-3 only, the (n-2)->(n-1) pair
        # is held out. Multi-scene (noisy row): train on ALL scenes — the
        # held-out pair is a fresh never-seen scene, not a tail pair.
        n_train_imgs = (n_scenes * n_frames if n_scenes > 1
                        else n_frames - 2)
        rc = train_radial.main([
            "-rd", work, "-ds", ds_name, "-cal", cal.name,
            "-ni", str(n_train_imgs), "-hi", str(res), "-wi", str(res),
            "-hwin", str(h_win), "-net", net_spec, "-r", str(lr),
            "-n", str(n_train), "-e", str(epochs), "-omd", omd]
            + (["-sl", str(n_frames)] if n_scenes > 1 else [])
            + (["-gtd", gt_ds_name] if clean_gt else []))
        assert rc == 0, "radial training failed"

    import ast
    layers = tuple(x if isinstance(x, str) else tuple(x)
                   for x in ast.literal_eval(net_spec))
    net = RadialFlowNetwork(layers, h_win)
    params = net.init(jax.random.PRNGKey(0))
    with open(weights, "rb") as f:
        params = flax.serialization.from_bytes(params, f.read())

    # held-out pair through the SAME loader + patch sampler as training
    geom_gt = Geometry(hImg=H, wImg=W, layers=((3, 16, 16, 768),),
                       maxh=16, maxw=16, maxhGT=16, maxwGT=16,
                       hKernelGT=16, wKernelGT=16)
    if noise:
        # Fair-evaluation pair: geometry + GT from the CLEAN frames, patch
        # PIXELS from the noisy ones. Scoring both matchers against cc-GT
        # computed on the noisy pair itself is confounded — the GT is an
        # SSD-family estimator over the same noisy inputs, so the raw-SSD
        # baseline shares its error directions with the "truth" and reads
        # inflated accuracy (measured: raw patch acc 0.53 vs noisy-GT at
        # sigma 0.1, ABOVE its clean-scene 0.52 — noise cannot make true
        # matching easier). Clean-frame GT breaks the correlation: the
        # loader's geometry (ego-motion -> epipole -> polar grid) is
        # replicated from the clean pair and the noisy frames are warped
        # through the SAME grid, so patch positions/targets align.
        #
        # The pair itself is a FRESH 2-frame scene (new texture seed, same
        # zoom + noise distributions): the training sequence's own tail is
        # zoom-washed by frame 12 (cc-GT coverage collapses to a ~34-patch
        # sliver with one flow value — statistically meaningless), while a
        # never-seen first-step scene has full texture, broad GT coverage,
        # and makes the held-out claim strictly stronger (new scene, not
        # just new noise).
        import dataclasses as _dc
        from depth_estimation_tpu.geometry3d import egomotion as ego
        from depth_estimation_tpu.geometry3d import undistort as undist
        from depth_estimation_tpu.geometry3d import polar as polar_ops
        from depth_estimation_tpu.data.images import scale as _scale
        erng = np.random.RandomState(12)
        eval_base = np.asarray(gaussian_smooth(
            jnp.asarray(erng.rand(H, W, 3).astype(np.float32)), 0.8, 2))
        clean_prev = np.clip(eval_base * 1.5, 0, 1).astype(np.float32)
        clean_img = forward_step(clean_prev, zoom[0], zoom[1])
        noisy_prev = np.clip(clean_prev + erng.randn(H, W, 3)
                             .astype(np.float32) * noise, 0, 1)
        noisy_img = np.clip(clean_img + erng.randn(H, W, 3)
                            .astype(np.float32) * noise, 0, 1)
        pair = ds_mod.load_polar_pair_reference(
            cal, clean_prev, clean_img, H, W, res, res, net.w_kernel,
            geom_gt=geom_gt, max_flow=h_win - 1)
        assert pair.good, "held-out clean pair rejected by the loader"
        em = ego.get_ego_motion(jnp.asarray(clean_prev),
                                jnp.asarray(clean_img), cal.K,
                                max_points=cal.sfm.max_points,
                                quality=cal.sfm.points_quality,
                                tracker="full")
        e2 = np.asarray(ego.epipole(cal.K, em.T)) * (W / cal.wImg)
        Ks = cal.K.copy()
        Ks[0] *= W / cal.wImg
        Ks[1] *= H / cal.hImg
        rmax = polar_ops.get_rmax(H, W, e2)
        wk = net.w_kernel
        grid = polar_ops.get_c2p_grid(
            W, H, res, res, float(e2[0]), float(e2[1]),
            lpadding=(wk - 1) // 2, rpadding=(wk - 1) - (wk - 1) // 2,
            rmax=rmax)
        img_s = _scale(jnp.asarray(noisy_img), H, W)
        prev_s = _scale(jnp.asarray(noisy_prev), H, W)
        prev_w = undist.remove_ego_motion(prev_s, Ks, em.R)
        pair = _dc.replace(
            pair,
            polar_image=np.asarray(polar_ops.warp_grid(img_s, grid)),
            polar_prev_image=np.asarray(polar_ops.warp_grid(prev_w, grid)))
    else:
        pair = ds_mod.load_polar_pair(cal, frames[n_frames - 2],
                                      frames[n_frames - 1], H, W, res, res,
                                      net.w_kernel, geom_gt=geom_gt,
                                      max_flow=h_win - 1)
    assert pair.good, "held-out pair rejected by the loader"
    h_patch = net.h_kernel + h_win - 1
    got = ds_mod.generate_polar_training_patches(
        pair, h_patch, net.w_kernel, h_win, 800, np.random.RandomState(99))
    assert got, "no held-out patches"
    p1, p2, ts = got
    logp = jax.vmap(lambda a, b: net.log_scores(params, jnp.asarray(a),
                                                jnp.asarray(b)))(p1, p2)
    pred = np.asarray(jnp.argmax(logp.reshape(logp.shape[0], -1), -1))
    ts = np.asarray(ts)
    acc = float((pred == ts).mean())
    epe = float(np.abs(pred - ts).mean())
    # raw-pixel SSD-WTA baseline on the same patches (what matching the
    # unlearned input directly achieves against the same clean-frame GT
    # the model rows are scored on — see the fresh-scene eval above)
    hk = net.h_kernel
    ssd_hits, ssd_err = 0, 0.0
    for a, b, t in zip(p1, p2, ts):
        ss = [float(np.sum((b[o:o + hk] - a[:hk]) ** 2))
              for o in range(h_win)]
        w = int(np.argmin(ss))
        ssd_hits += int(w == t)
        ssd_err += abs(w - int(t))
    out = {"epochs": epochs, "held_out_patches": int(len(ts)),
           "patch_acc": round(acc, 4),
           "mean_radial_epe_px": round(epe, 4),
           "raw_ssd_patch_acc": round(ssd_hits / len(ts), 4),
           "raw_ssd_epe_px": round(ssd_err / len(ts), 4)}
    if noise:
        out["noise_sigma"] = noise
    if clean_gt:
        out["training_targets"] = "clean-frame ccGT (--gt-dataset)"
    return out


def v2_quality(work: str, epochs: int = 30, n_train: int = 3000):
    """version2 network quality row: train the simplified contrastive-norm
    + single 17x17-conv siamese matcher through the real CLI
    (cli/train_v2.main, rebuilding /root/reference/version2/train.lua) on
    the same synthetic-warp sequence as the main table, training on pairs
    0-1 .. 5-6 only; score the final epoch on (a) 800 held-out patches
    sampled from the never-trained-on last pair (patch accuracy, the
    reference's own training metric) and (b) the full held-out frame
    decoded with the standard WTA pipeline against the analytic flow
    (full accuracy + meanDst/stdDst, score_opticalflow.lua:27-70)."""
    import jax
    import jax.numpy as jnp
    import flax.serialization
    from PIL import Image
    from depth_estimation_tpu.cli import train_v2
    from depth_estimation_tpu.data import datasets as ds_mod
    from depth_estimation_tpu.geometry3d import calibration as calmod
    from depth_estimation_tpu.models.flow import process_output
    from depth_estimation_tpu.models.version2 import V2Network, V2Params
    from depth_estimation_tpu.training import score as score_mod

    _register_dossier_cal()
    cal = calmod.PRESETS["dossier320x180"]
    root, true_flow = make_warp_sequence(os.path.join(work, "seq"))
    omd = os.path.join(work, "models_v2")
    weights = os.path.join(omd, f"e{epochs - 1}")
    if not os.path.exists(weights):
        rc = train_v2.main([
            "-rd", root, "-cal", "dossier320x180", "-ni", "7",
            "-n", str(n_train), "-e", str(epochs), "-bs", "32",
            "-omd", omd])
        assert rc == 0, "v2 training failed"

    net = V2Network(V2Params(wImg=cal.wImg, hImg=cal.hImg))
    geom = net.geometry
    params = net.init(jax.random.PRNGKey(0))
    with open(weights, "rb") as f:
        params = flax.serialization.from_bytes(params, f.read())

    # held-out patches: pair 6->7 was excluded from training by -ni 7
    ds = ds_mod.FlowDataset(geom, cal, root, cache_root=root)
    ds.names = ds.names[6:8]
    patches = ds.get_patches(800, np.random.RandomState(99))
    logp = jax.vmap(lambda a, b: net.log_scores(params, a, b))(
        jnp.asarray(patches.patches1), jnp.asarray(patches.patches2))
    pred = np.asarray(jnp.argmax(logp.reshape(logp.shape[0], -1), -1))
    acc = float((pred == np.asarray(patches.itargets)).mean())

    # full held-out frame through the standard WTA decode vs analytic flow
    f6 = np.asarray(Image.open(os.path.join(root, "images",
                                            "000000006.png")),
                    np.float32) / 255.0
    f7 = np.asarray(Image.open(os.path.join(root, "images",
                                            "000000007.png")),
                    np.float32) / 255.0
    dist = net.log_scores(params, jnp.asarray(f6), jnp.asarray(f7))
    dec = process_output(geom, dist, process_full=True)
    s = score_mod.eval_flow(geom, np.asarray(dec.full), true_flow)
    return {"epochs": epochs, "held_out_patches": int(len(pred)),
            "patch_acc": round(acc, 4),
            "full_acc_analytic": round(s.accuracy, 4),
            "meanDst_analytic": round(s.mean_dst, 4),
            "stdDst_analytic": round(s.std_dst, 4)}


def legacy_depth_quality(work: str, epochs: int = 25, n_train: int = 2000,
                         n_test: int = 400):
    """Legacy direct-depth classifier quality row: train through the real
    CLI (cli/depth_estimation.main, rebuilding
    /root/reference/depth_estimation.lua:188-338) on a synthetic scene
    where TEXTURE correlates with depth (near half striped, far half flat;
    the CNN's subtractive normalization removes brightness cues), frames
    0..3 only. Reports the reference's own per-epoch metric — held-out
    patch test accuracy (:304-334) — plus the near/far separation of the
    inference-on-image class map (:340-404) on a never-trained-on frame
    whose noise realization the model has not seen."""
    from PIL import Image
    from depth_estimation_tpu.cli import depth_estimation

    h, w = 180, 320
    root = os.path.join(work, "legacy")
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "depths"), exist_ok=True)
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    stripes = 0.5 + 0.4 * np.sin(2 * np.pi * (xx + yy) / 4.0)
    for i in range(6):
        img = np.full((h, w), 0.5, np.float32)
        img[:, : w // 2] = stripes[:, : w // 2]
        img += rng.rand(h, w).astype(np.float32) * 0.05
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(root, "images", f"{i:09d}.png"))
        # far plane at 7 m, NOT some huge value: the reference's balanced
        # sampler draws integer-depth bins only inside [0, 2*cutDepth)
        # (groundtruth_discrete.lua:48-57), so a far plane beyond
        # 2*cutDepth would be structurally unsampleable and the test set
        # would collapse to the near class. The near half gets a
        # DETERMINISTIC point majority (90 vs 60) so the median-depth rule
        # always puts cutDepth at 5 (> half the mass strictly below it) —
        # with an even split, cutDepth can land at 8 and ceil(7/8) folds
        # the far plane into class 1 as well
        xs = np.concatenate([rng.randint(0, w // 2, 90),
                             rng.randint(w // 2, w, 60)]).astype(np.float32)
        ys = rng.randint(0, h, 150).astype(np.float32)
        depth = np.where(xs < w // 2, 4.0, 7.0).astype(np.float32)
        np.savez(os.path.join(root, "depths", f"{i:09d}.npz"),
                 x=xs, y=ys, depth=depth)

    out = os.path.join(work, "legacy_model")
    if not os.path.exists(os.path.join(out, "meta.json")):
        # train on frames 0..3 only; frame 4 (pair 4->5) never trains
        rc = depth_estimation.main([
            "-rd", root, "-d", "1", "-ni", "4",
            "-n", str(n_train), "-m", str(n_test), "-e", str(epochs),
            "-nc", "2", "-hi", str(h), "-wi", str(w), "-bs", "32",
            "-o", out])
        assert rc == 0, "legacy depth training failed"
    rc = depth_estimation.main([
        "-rd", root, "-d", "1", "-ni", "6", "-hi", str(h), "-wi", str(w),
        "-o", out, "-lw", out, "-i", "4"])
    assert rc == 0, "legacy depth inference failed"
    meta = json.load(open(os.path.join(out, "meta.json")))
    hist = meta["score"]
    z = np.load(os.path.join(out, "depth_classes_000000004.npz"))
    cm = z["classes"]
    near_left = float((cm[:, : cm.shape[1] // 2] == 0).mean())
    near_right = float((cm[:, cm.shape[1] // 2:] == 0).mean())
    return {"epochs": len(hist),
            "final_test_acc": round(hist[-1]["test_acc"], 4),
            "best_test_acc": round(max(x["test_acc"] for x in hist), 4),
            "heldout_frame_near_frac_left": round(near_left, 4),
            "heldout_frame_near_frac_right": round(near_right, 4)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=14)
    # the multiscale pyramid needs far more steps than the single-scale
    # matcher to plateau on this sequence (round-3 VERDICT item 8): its own
    # epoch budget, default 8x the single-scale one
    ap.add_argument("--ms-epochs", type=int, default=None)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--train-size", type=int, default=3000)
    ap.add_argument("--out", default=os.path.join(HERE, "_dossier_work"))
    ap.add_argument("--radial-only", action="store_true",
                    help="compute just the radial quality row and merge it "
                         "into the existing quality_dossier.json")
    ap.add_argument("--radial-noisy-only", action="store_true",
                    help="the radial row on photometric-noise scenes — "
                         "multi-scene training, fresh-scene evaluation")
    ap.add_argument("--radial-noisy-wide-only", action="store_true",
                    help="the noisy radial row with a 32-channel feature "
                         "bank (same corpus/eval) — tests the stated "
                         "noise-averaging mechanism")
    ap.add_argument("--radial-noisy-clean-gt-only", action="store_true",
                    help="the noisy radial row retrained with CLEAN-frame "
                         "GT targets (same noisy pixels; isolates the "
                         "corrupted-cc-GT mechanism from raw-SSD's "
                         "noise-averaging advantage)")
    ap.add_argument("--noise-sigma", type=float, default=None,
                    help="override the noisy row's pixel-noise sigma "
                         "(records under radial_noisy_sigma<val>)")
    ap.add_argument("--v2-only", action="store_true",
                    help="compute just the version2 network quality row")
    ap.add_argument("--legacy-only", action="store_true",
                    help="compute just the legacy depth-classifier quality "
                         "row")
    ap.add_argument("--ms-unshared-only", action="store_true",
                    help="multiscale row without filter sharing (the "
                         "share_filters=false branch) — measures how much "
                         "of the main row's plateau is the sharing")
    ap.add_argument("--ms-capacity-only", action="store_true",
                    help="multiscale row with doubled first-layer capacity "
                         "(7x7 kernels, 20 features) — measures how much "
                         "of the main row's plateau is filter capacity")
    ap.add_argument("--ms-ceiling-only", action="store_true",
                    help="the multiscale DESIGN-CEILING oracles (no "
                         "training): codec quantization + lossless-feature "
                         "pipeline decode at 16x16 and 5x5 receptive fields")
    ap.add_argument("--ms-ref2layer-only", action="store_true",
                    help="multiscale row at the reference's own default "
                         "network (2 layers, 5+16-1=20x20 receptive field, "
                         "unshared)")
    ap.add_argument("--ms-ref2layer-soft-only", action="store_true",
                    help="ref2layer + soft Gaussian targets (-st 1.0) — "
                         "the reference's remaining training lever on the "
                         "best architecture row")
    ap.add_argument("--ms-ref2wide-only", action="store_true",
                    help="ref2layer widened (16-feature sparse middle "
                         "layer, 20 output features) — the deeper/wider "
                         "lever")
    ap.add_argument("--curves-only", action="store_true",
                    help="redraw quality_curves.png from the JSON's "
                         "recorded histories (includes ablation rows)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (set before backend init)")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    if args.curves_only:
        redraw_curves_from_json()
        return

    nsig = args.noise_sigma if args.noise_sigma is not None else 0.1
    noisy_key = ("radial_noisy" if args.noise_sigma is None
                 else f"radial_noisy_sigma{nsig:g}")
    only = [("radial", args.radial_only, radial_quality),
            (noisy_key, args.radial_noisy_only,
             # 6 scenes x 4 frames (18 usable pairs, fresh texture per
             # scene): single-scene training overfits the scene — on the
             # fresh-scene evaluation a 12-frame single-scene model scored
             # 0.36 patch acc vs raw SSD's 0.45 (train acc 0.81: a pure
             # generalization gap). Short chains also keep texture from
             # zoom-washing (a 12-frame chain at the default zoom leaves
             # the last pair with 0.5% GT coverage). Seam pairs between
             # scenes are dropped via the trainer's --scene-length flag.
             lambda work: radial_quality(
                 work, epochs=150, n_train=9000, noise=nsig,
                 net_spec="[[3,5,5,10],'tanh',[10,5,5,10]]",
                 n_frames=4, zoom=(1.045, 1.085), n_scenes=6)),
            ("radial_noisy_wide", args.radial_noisy_wide_only,
             # round-4 verdict item 8: the stated remaining mechanism (raw
             # SSD averages noise over 243 pixels vs 10 learned channels)
             # implies a WIDER feature bank should close the gap —
             # 32-channel layers (nFeatures is a free parameter of the
             # reference design, radial_opticalflow_network.lua:6-30),
             # same corpus/noise/eval as radial_noisy
             lambda work: radial_quality(
                 work, epochs=150, n_train=9000, noise=nsig,
                 net_spec="[[3,5,5,32],'tanh',[32,5,5,32]]",
                 n_frames=4, zoom=(1.045, 1.085), n_scenes=6,
                 tag="_wide32")),
            ("radial_noisy_cleanGT", args.radial_noisy_clean_gt_only,
             # identical corpus/noise/eval to radial_noisy, but training
             # targets come from the aligned clean frames (-gtd)
             lambda work: radial_quality(
                 work, epochs=150, n_train=9000, noise=nsig,
                 net_spec="[[3,5,5,10],'tanh',[10,5,5,10]]",
                 n_frames=4, zoom=(1.045, 1.085), n_scenes=6,
                 clean_gt=True)),
            ("version2", args.v2_only, v2_quality),
            ("legacy_depth", args.legacy_only, legacy_depth_quality),
            ("multiscale_ccGT_unshared", args.ms_unshared_only,
             ms_unshared_quality),
            ("multiscale_ccGT_capacity", args.ms_capacity_only,
             ms_capacity_quality),
            ("multiscale_ceiling", args.ms_ceiling_only, multiscale_ceiling),
            ("multiscale_ccGT_ref2layer", args.ms_ref2layer_only,
             ms_ref2layer_quality),
            ("multiscale_ccGT_ref2layer_soft", args.ms_ref2layer_soft_only,
             ms_ref2layer_soft_quality),
            ("multiscale_ccGT_ref2wide", args.ms_ref2wide_only,
             ms_ref2wide_quality)]
    if any(flag for _, flag, _ in only):
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(HERE, "quality_dossier.json")
        done = {}
        for key, flag, fn in only:
            if flag:
                done[key] = fn(args.out)
        # load-merge-write only AFTER the (long) row computation: a stale
        # read held across training would clobber rows written meanwhile
        data = json.load(open(path)) if os.path.exists(path) else {}
        data.update(done)
        with open(path, "w") as f:
            json.dump(data, f, indent=1)
        print(json.dumps(done, indent=1))
        return

    import jax.numpy as jnp
    from depth_estimation_tpu.geometry3d import calibration as calmod
    from depth_estimation_tpu.models import io as model_io
    from depth_estimation_tpu.models.flow import FlowModel
    from depth_estimation_tpu.models.multiscale import MultiscaleFlowModel
    from depth_estimation_tpu.data.images import load_image, scale
    from depth_estimation_tpu.data import datasets as ds_mod
    from depth_estimation_tpu.training.curves import plot_learning_curves

    _register_dossier_cal()

    os.makedirs(args.out, exist_ok=True)
    root, true_flow = make_warp_sequence(os.path.join(args.out, "seq"),
                                         n=args.frames)

    results = {"sequence": {"frames": args.frames,
                            "flow": [int(true_flow[0, 0, 0]),
                                     int(true_flow[1, 0, 0])],
                            "resolution": "180x320"}}

    runs = [
        ("single_scale_ccGT", "cross-correlation", 0),
        ("single_scale_liuGT", "liu", 0),
        ("multiscale_ccGT", "cross-correlation", 3),
    ]
    model_dirs = {}
    ms_epochs = args.ms_epochs or args.epochs * 8
    for name, gt, ms in runs:
        mdir = os.path.join(args.out, "models_" + name)
        if not os.path.exists(mdir):
            print(f"=== training {name} ({gt}, ms={ms}) ===", flush=True)
            model_dirs[name] = train(root, mdir,
                                     ms_epochs if ms else args.epochs, gt,
                                     multiscale=ms, n_frames=args.frames,
                                     n_train=args.train_size)
        else:
            model_dirs[name] = os.path.join(mdir, os.listdir(mdir)[0])
        meta = json.load(open(os.path.join(model_dirs[name], "meta.json")))
        hist = meta["score"]
        results[name] = {
            "epochs": len(hist),
            "final_patch_acc": round(hist[-1]["test_acc"], 4),
            "best_patch_acc": round(max(h["test_acc"] for h in hist), 4),
            "history_test_acc": [round(h["test_acc"], 4) for h in hist],
        }
        if "full_acc" in hist[-1]:
            results[name]["final_full_acc"] = round(hist[-1]["full_acc"], 4)
            results[name]["final_full_meandst"] = round(
                hist[-1]["full_meandst"], 4)

    # held-out evaluation pair: frames 6 -> 7 (never consecutive-pair
    # sampling can't exclude them from training; the regime matches the
    # reference's own eval-on-train-sequence scoring, score_opticalflow.lua)
    from PIL import Image
    k6, k7 = args.frames - 2, args.frames - 1
    f6 = np.asarray(Image.open(os.path.join(
        root, "images", f"{k6:09d}.png")), np.float32) / 255.0
    f7 = np.asarray(Image.open(os.path.join(
        root, "images", f"{k7:09d}.png")), np.float32) / 255.0

    # GT fields for scoring: analytic truth + each generator's output
    geom0, lrn0, params0, _ = model_io.load_model(
        model_dirs["single_scale_ccGT"])
    from depth_estimation_tpu.data import groundtruth as gt_mod
    cc_fy, cc_fx, _ = gt_mod.exhaustive_flow(geom0, f6, f7)
    liu_fy, liu_fx = gt_mod.liu_flow(f6, f7)
    gts = {"analytic": true_flow,
           "ccGT": np.stack([cc_fy, cc_fx]),
           "liuGT": np.stack([liu_fy, liu_fx])}

    model0 = FlowModel(geom0)
    sc, _ = full_image_scores(model0, geom0, params0, f6, f7, gts)
    results["single_scale_ccGT"]["full_image_vs"] = sc

    geom1, _, params1, _ = model_io.load_model(model_dirs["single_scale_liuGT"])
    sc1, _ = full_image_scores(FlowModel(geom1), geom1, params1, f6, f7, gts)
    results["single_scale_liuGT"]["full_image_vs"] = sc1

    geom2, _, params2, _ = model_io.load_model(model_dirs["multiscale_ccGT"])
    import jax
    from depth_estimation_tpu import codecs
    from depth_estimation_tpu.training import score as score_mod
    ms_model = MultiscaleFlowModel(geom2)
    idx, _ = ms_model.decode_full(params2, jnp.asarray(f6), jnp.asarray(f7))
    wy, wx = codecs.decode(geom2, idx)
    full_ms = np.stack([np.asarray(wy, np.float32),
                        np.asarray(wx, np.float32)])
    ms_scores = {}
    for gname, gt in gts.items():
        s = score_mod.eval_flow(geom2, full_ms, gt)
        ms_scores[gname] = {"full_acc": round(s.accuracy, 4),
                            "meanDst": round(s.mean_dst, 4),
                            "stdDst": round(s.std_dst, 4)}
    results["multiscale_ccGT"]["full_image_vs"] = ms_scores

    # bf16 option deltas on real imagery: the car pair + the held-out pair
    car1 = np.asarray(scale(load_image("/root/reference/celiu/car1.jpg"),
                            180, 320))
    car2 = np.asarray(scale(load_image("/root/reference/celiu/car2.jpg"),
                            180, 320))
    results["bf16_deltas_car_pair"] = bf16_epe_deltas(geom0, params0,
                                                      car1, car2)
    results["bf16_deltas_seq_pair"] = bf16_epe_deltas(geom0, params0, f6, f7)
    results["bf16_deltas_car_pair"].update(
        multiscale_bf16_delta(geom2, params2, car1, car2))

    # learning curves PNG across the three runs
    curves_dir = os.path.join(args.out, "all_models")
    os.makedirs(curves_dir, exist_ok=True)
    for name in model_dirs:
        dst = os.path.join(curves_dir, name)
        if not os.path.exists(dst):
            os.symlink(model_dirs[name], dst)
    png = plot_learning_curves(curves_dir,
                               os.path.join(HERE, "quality_curves.png"))

    # merge OVER the existing JSON: the standalone rows (radial, version2,
    # legacy_depth) are produced by separate --*-only runs and must survive
    # a main-table regeneration
    path = os.path.join(HERE, "quality_dossier.json")
    merged = json.load(open(path)) if os.path.exists(path) else {}
    merged.update(results)
    # this run measured the bf16/f16 deltas itself: record the device that
    # produced them
    import jax as _jax
    merged["precision_table_device"] = _jax.devices()[0].device_kind
    results = merged
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results, indent=1))

    # markdown table for README
    print("\n| model | GT | patch acc | full acc (analytic) | "
          "meanDst (analytic) | meanDst (liu) |")
    print("|---|---|---|---|---|---|")
    for name, gt, _ in runs:
        r = results[name]
        fa = r["full_image_vs"]["analytic"]
        fl = r["full_image_vs"]["liuGT"]
        print(f"| {name} | {gt} | {r['final_patch_acc']:.3f} | "
              f"{fa['full_acc']:.3f} | {fa['meanDst']:.3f} | "
              f"{fl['meanDst']:.3f} |")
    print("\nbf16 deltas (car pair):",
          json.dumps(results["bf16_deltas_car_pair"]))
    print("curves:", png)


if __name__ == "__main__":
    main()
