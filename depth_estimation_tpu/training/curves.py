"""Per-epoch scoring + learning curves — score_opticalflow.lua tooling.

score_epoch (/root/reference/score_opticalflow.lua:235-311): per epoch,
patch accuracy (exact-index) + mean NLL on a held-out patch set, and
full-image accuracy/meanDst on a few frames. getLearningScores /
getLearningCurve (:136-233): read score histories back from checkpoint dirs
and plot accuracy curves (matplotlib instead of gnuplot). The threshold
sweep of do_score_opticalflow.lua:55-83 is sweep_thresholds.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import Geometry, Learning
from ..utils.device_cache import DeviceCache
from . import score as score_mod

# score_epoch runs once per training epoch on a FIXED eval set; cache its
# uploads across calls instead of re-uploading every epoch
_patch_uploads = DeviceCache()
_pair_uploads = DeviceCache()


def score_epoch(model, params, geom: Geometry, lrn: Learning, test_ds,
                pairs: Optional[list] = None, flows: Optional[list] = None,
                n_images: int = 2) -> Dict:
    """Returns {'test_acc', 'test_err', 'full_acc', 'full_meandst'}.

    ``pairs``: list of (im1, im2) frame pairs; ``flows[k]`` is the GT flow
    of ``pairs[k]`` — for the rectified datasets that is the (warped prev,
    current) pair the GT was computed on, NOT two consecutive currents
    (scoring currents[k] -> currents[k+1] against the warped[k] ->
    currents[k] field reads ~0 accuracy on a model that is actually
    near-exact on its own pairing)."""
    from ..models import flow as flow_model

    out: Dict = {}
    # patch accuracy + NLL (evalOpticalFlowPatches, :72-113)
    tp1, tp2 = _patch_uploads.get(test_ds.patches1, test_ds.patches2)
    logp = jax.vmap(lambda a, b: model.log_scores(params, a, b))(tp1, tp2)
    logp = np.asarray(logp.reshape(logp.shape[0], -1))
    pred = logp.argmax(-1)
    it = np.asarray(test_ds.itargets)
    out["test_acc"] = float((pred == it).mean())
    out["test_err"] = float(-logp[np.arange(len(it)), it].mean())

    # full-image accuracy + meanDst (evalOpticalFlowFull, :115-134)
    if pairs and flows:
        nk = min(n_images, len(flows))
        pairs_d = _pair_uploads.get(*[im for pr in pairs[:nk] for im in pr])
        accs, dsts = [], []
        for k in range(nk):
            if flows[k] is None:
                continue
            im1, im2 = pairs_d[2 * k], pairs_d[2 * k + 1]
            dist = model.scores(params, im1, im2)
            dec = flow_model.process_output(geom, dist, process_full=True)
            s = score_mod.eval_flow(geom, np.asarray(dec.full), flows[k])
            accs.append(s.accuracy)
            dsts.append(s.mean_dst)
        if accs:
            out["full_acc"] = float(np.mean(accs))
            out["full_meandst"] = float(np.mean(dsts))
    return out


def get_learning_scores(models_dir: str) -> Dict[str, List[Dict]]:
    """Collect score histories from checkpoint directories
    (getLearningScores, :136-214)."""
    curves = {}
    for name in sorted(os.listdir(models_dir)):
        meta_path = os.path.join(models_dir, name, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            if meta.get("score"):
                curves[name] = meta["score"]
    return curves


def backfill_scores(models_dir: str, test_ds, images: Optional[list] = None,
                    flows: Optional[list] = None, n_images: int = 2
                    ) -> List[str]:
    """Repair checkpoints whose score history is missing — the reference's
    getLearningScores(..., fix_file) path
    (/root/reference/score_opticalflow.lua:136-214): for each checkpoint
    directory under ``models_dir`` with an empty 'score', rebuild the model,
    recompute score_epoch on the provided test set, and rewrite meta.json
    with the backfilled history. Returns the repaired directory names.

    ``images``/``flows`` are the plain-sequence form (``flows[k]`` maps
    ``images[k] -> images[k+1]``); they are paired up before scoring."""
    pairs = ([(images[k], images[k + 1]) for k in range(len(images) - 1)]
             if images else None)
    from ..models import flow as flow_model
    from ..models import io as model_io

    fixed = []
    for name in sorted(os.listdir(models_dir)):
        path = os.path.join(models_dir, name)
        meta_path = os.path.join(path, "meta.json")
        if not os.path.exists(meta_path):
            continue
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("score"):
            continue
        geom, lrn, params, meta = model_io.load_model(path)
        if geom.multiscale:
            continue   # multiscale scores come from the fovea trainer
        model = flow_model.FlowModel(geom)
        score = score_epoch(model, params, geom, lrn, test_ds,
                            pairs, flows, n_images)
        score["epoch"] = meta.get("epoch", 0)
        score["backfilled"] = True
        meta["score"] = [score]
        with open(meta_path, "w") as f:
            json.dump(meta, f, indent=1)
        fixed.append(name)
    return fixed


def plot_learning_curves(models_dir: str, out_path: str,
                         key: str = "test_acc") -> Optional[str]:
    """Accuracy curves across checkpoints (getLearningCurve, :216-233)."""
    curves = get_learning_scores(models_dir)
    if not curves:
        return None
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(8, 5))
    for name, hist in curves.items():
        ys = [h.get(key) for h in hist if key in h]
        if ys:
            ax.plot(range(len(ys)), ys, label=name[:60])
    ax.set_xlabel("epoch")
    ax.set_ylabel(key)
    ax.legend(fontsize=6)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def sweep_thresholds(model, params, geom: Geometry, pairs, flows,
                     thresholds=(0.0, 0.2, 0.4, 0.6, 0.8)) -> List[Dict]:
    """Confidence-threshold sweep over full-image decoding
    (do_score_opticalflow.lua:55-83): per threshold, the fraction of pixels
    kept and their accuracy.

    ``pairs[k]`` is the (im1, im2) frame pair ``flows[k]`` belongs to —
    the same explicit-pair contract as score_epoch (for rectified datasets
    that is (warped prev, current), NOT two consecutive currents)."""
    from ..models import flow as flow_model

    # upload the eval pairs once, not once per threshold
    pairs_d = [(jnp.asarray(im1), jnp.asarray(im2)) for im1, im2 in pairs]
    results = []
    for thr in thresholds:
        kept, good = 0, 0
        total = 0
        for k in range(len(flows)):
            if flows[k] is None:
                continue
            im1, im2 = pairs_d[k]
            dist = model.scores(params, im1, im2)
            dec = flow_model.process_output(geom, dist, process_full=True,
                                            threshold=thr)
            hb, wb = score_mod.borders(geom)
            conf = np.asarray(dec.full_confidences)[hb:-hb, wb:-wb]
            diff = np.abs(np.asarray(dec.full) - flows[k]).sum(0)[hb:-hb, wb:-wb]
            sel = conf > 0.5
            kept += int(sel.sum())
            good += int((diff[sel] == 0).sum())
            total += diff.size
        results.append({"threshold": float(thr),
                        "kept_frac": kept / max(total, 1),
                        "acc_at_kept": good / max(kept, 1)})
    return results
