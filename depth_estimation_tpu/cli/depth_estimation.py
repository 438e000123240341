"""Legacy direct-depth trainer/inference CLI — the depth_estimation.lua rebuild.

Drives the repo's original (pre-flow) approach end-to-end
(/root/reference/depth_estimation.lua):

  * flags (:20-45): dataset root/images/delta, discrete class count with
    optional manual cut-depth, train/test sizes, epochs, model output;
  * discrete training (:188-338): class-balanced 32x32 patch sampling over
    sparse SFM depth points (generateDataDiscrete), the classic CNN
    (subtractive-norm conv/pool stack + SpatialClassifier), SGD with the
    reference's fixed config {lr=1e-2, lrd=5e-7} (:254-257), per-epoch
    accuracy + confusion summary, cutDepth/maxDepth saved with the model
    (:335-337);
  * inference-on-image (:340-404, the -i path): load frame pair (i, i+delta)
    as grayscale, forward the CNN fully-convolutionally at image scale, emit
    the per-pixel argmax class map (binary near/far panel for 2 classes).

Deviations: patches train as one batched jitted step per
minibatch instead of per-sample feval; inference runs the conv stack on the
full image in a single XLA program (the reference does the same via
SpatialClassifier's shared linear).

Usage: python -m depth_estimation_tpu.cli.depth_estimation -rd data/ [-i N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Legacy direct depth classifier")
    p.add_argument("-n", "--n-train-set", type=int, default=2000)
    p.add_argument("-m", "--n-test-set", type=int, default=500)
    p.add_argument("-ni", "--num-input-images", type=int, default=10)
    p.add_argument("-e", "--num-epochs", type=int, default=10)
    p.add_argument("-o", "--output-model", default="legacy_depth_model")
    p.add_argument("-d", "--delta", type=int, default=10)
    p.add_argument("-rd", "--root-directory", default="./data")
    p.add_argument("-i", "--input-image", type=int, default=None,
                   help="run inference on image number i (uses pair i, i+delta)")
    p.add_argument("-cd", "--cut-depth", type=float, default=None)
    p.add_argument("-nc", "--num-classes", type=int, default=2)
    p.add_argument("-hi", "--h-img", type=int, default=360)
    p.add_argument("-wi", "--w-img", type=int, default=640)
    p.add_argument("-bs", "--batch-size", type=int, default=32)
    p.add_argument("-lw", "--load-model", default=None,
                   help="load a saved model instead of training")
    return p


PATCH = 32  # geometry.hPatch/wPatch (/root/reference/depth_estimation.lua:58-61)


def _to_gray(img: np.ndarray) -> np.ndarray:
    if img.ndim == 3 and img.shape[2] == 3:
        return img @ np.asarray([0.299, 0.587, 0.114], np.float32)
    return img[..., 0] if img.ndim == 3 else img


def load_depth_dataset(root: str, n_images: int, delta: int,
                       h: int, w: int):
    """Frame pairs (grayscale, stacked on channels) + sparse depth points,
    scaled to (h, w) — loadData (/root/reference/depth_estimation.lua:70-86,
    load_data.lua:6-124)."""
    from ..data.depth_legacy import load_raw_depth_data
    from ..data.images import load_image, scale_np

    frames = load_raw_depth_data(root)[:n_images]
    images, kept = [], []
    for fr in frames:
        i = int(fr["name"])
        pair = []
        for j in (i, i + delta):
            path = None
            for ext in (".jpg", ".png"):
                cand = os.path.join(root, "images", f"{j:09d}{ext}")
                if os.path.exists(cand):
                    path = cand
                    break
            if path is None:
                break
            img = load_image(path)
            hs, ws = img.shape[:2]
            g = _to_gray(img.astype(np.float32))
            if (hs, ws) != (h, w):
                g = scale_np(g[..., None], h, w)[..., 0]
                fr = dict(fr, x=fr["x"] * (w / ws), y=fr["y"] * (h / hs))
            pair.append(g)
        if len(pair) == 2:
            images.append(np.stack(pair, axis=-1))  # (h, w, 2)
            kept.append(fr)
    return kept, images


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import jax
    import jax.numpy as jnp
    import optax

    from ..data.depth_legacy import DepthDiscretizer, generate_data_discrete
    from ..models.legacy_depth import DepthClassifierCNN
    from ..training.train import sgd_torch

    frames, images = load_depth_dataset(
        args.root_directory, args.num_input_images, args.delta,
        args.h_img, args.w_img)
    if not frames:
        print("no annotated frames found under", args.root_directory)
        return 1

    model = DepthClassifierCNN(n_classes=args.num_classes)
    rng = np.random.RandomState(1)  # torch.manualSeed(1)

    if args.load_model:
        from ..models.io import from_bytes
        with open(os.path.join(args.load_model, "params.msgpack"), "rb") as f:
            blob = f.read()
        with open(os.path.join(args.load_model, "meta.json")) as f:
            meta = json.load(f)
        params = model.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, PATCH, PATCH, 2), jnp.float32))
        params = from_bytes(params, blob)
        disc = DepthDiscretizer(meta["n_classes"], meta["cut_depth"],
                                meta["bin_step"])
    else:
        train_p, train_c, disc = generate_data_discrete(
            frames, images, PATCH, PATCH, args.num_classes,
            args.n_train_set, rng)
        test_p, test_c, _ = generate_data_discrete(
            frames, images, PATCH, PATCH, args.num_classes,
            args.n_test_set, rng)
        if args.cut_depth is not None:  # -cd manual override (:175-177)
            disc.cut_depth = args.cut_depth
            disc.bin_step = int(2 * disc.cut_depth / disc.n_classes) or 1
        print(f"cutDepth={disc.cut_depth} classes={disc.n_classes} "
              f"train={len(train_c)} test={len(test_c)}")

        params = model.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, PATCH, PATCH, 2), jnp.float32))
        # the reference hard-codes this SGD config (:254-257)
        tx = sgd_torch(1e-2, 5e-7)
        opt_state = tx.init(params)

        @jax.jit
        def step(params, opt_state, patches, classes0):
            def loss_fn(p):
                logits = model.apply(p, patches)[:, 0, 0, :]
                ll = optax.softmax_cross_entropy_with_integer_labels(
                    logits, classes0)
                return ll.mean(), jnp.argmax(logits, -1)
            (loss, pred), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss, pred

        @jax.jit
        def infer(params, patches):
            return jnp.argmax(model.apply(params, patches)[:, 0, 0, :], -1)

        bs = args.batch_size
        n = (len(train_c) // bs) * bs
        history = []
        # one corpus upload, on-device batch gathers (utils/device_cache.py)
        train_p_d = jnp.asarray(train_p)
        train_c0_d = jnp.asarray(train_c - 1)
        test_p_d = jnp.asarray(test_p)
        for epoch in range(args.num_epochs):
            order = np.arange(n)
            rng.shuffle(order)
            losses, preds = [], []
            conf = np.zeros((args.num_classes, args.num_classes), np.int64)
            for b in range(0, n, bs):
                sel = order[b:b + bs]
                params, opt_state, loss, pred = step(
                    params, opt_state, train_p_d[sel], train_c0_d[sel])
                losses.append(loss)
                preds.append((sel, pred))
            # one batched fetch, not a scalar fetch per step
            losses = jax.device_get(losses)
            for sel, pred in zip([s for s, _ in preds],
                                 jax.device_get([p for _, p in preds])):
                np.add.at(conf, (train_c[sel] - 1, pred), 1)
            acc = np.trace(conf) / max(conf.sum(), 1)
            tpred = np.asarray(infer(params, test_p_d))
            tacc = float((tpred == test_c - 1).mean())
            print(f"epoch {epoch}: loss {np.mean(losses):.4f} "
                  f"train acc {acc:.3f} test acc {tacc:.3f}")
            print("confusion:\n", conf)
            history.append({"loss": float(np.mean(losses)),
                            "train_acc": float(acc), "test_acc": tacc})

        # save with cutDepth/maxDepth metadata (:335-337)
        from ..models.io import to_bytes
        os.makedirs(args.output_model, exist_ok=True)
        with open(os.path.join(args.output_model, "params.msgpack"), "wb") as f:
            f.write(to_bytes(params))
        with open(os.path.join(args.output_model, "meta.json"), "w") as f:
            json.dump({"n_classes": disc.n_classes,
                       "cut_depth": disc.cut_depth,
                       "bin_step": disc.bin_step,
                       "patch": PATCH,
                       # per-epoch accuracy history (the reference prints
                       # these per epoch, depth_estimation.lua:304-334; we
                       # persist them so the quality dossier can report
                       # final/best held-out accuracy)
                       "score": history}, f)

    if args.input_image is not None:
        # inference-on-image (:340-404): forward the CNN fully-convolutionally
        idx = [i for i, fr in enumerate(frames)
               if int(fr["name"]) == args.input_image]
        if not idx:
            print(f"image {args.input_image} has no annotated frame")
            return 1
        pair = jnp.asarray(images[idx[0]][None])
        classmap = np.asarray(
            jnp.argmax(model.apply(params, pair)[0], axis=-1))
        out = os.path.join(args.output_model,
                           f"depth_classes_{args.input_image:09d}")
        np.savez(out + ".npz", classes=classmap)
        from ..utils.viz import save_image
        # near = white (class 1 of 1-based = index 0), far = black
        save_image(out + ".png", (classmap == 0).astype(np.float32))
        print("class map:", out + ".png", "shape", classmap.shape,
              "near fraction", float((classmap == 0).mean()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
