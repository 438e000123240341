"""version2 trainer CLI — the version2/train.lua rebuild: train the
simplified contrastive-norm + single-conv network on cross-correlation GT
patches; saves the flat parameter payload per epoch (the reference stores a
bare parameter vector, 'models/e<N>_no_bin')."""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Train the version2 network")
    p.add_argument("-rd", "--root-directory", default="data/")
    p.add_argument("-cal", "--calibration", default="rectified_gopro_small")
    p.add_argument("-ni", "--num-input-images", type=int, default=10)
    p.add_argument("-n", "--n-train-set", type=int, default=1000)
    p.add_argument("-e", "--num-epochs", type=int, default=10)
    p.add_argument("-r", "--learning-rate", type=float, default=1e-2)
    p.add_argument("-bs", "--batch-size", type=int, default=32)
    p.add_argument("-win", "--window", type=int, default=17)
    p.add_argument("-ker", "--kernel", type=int, default=17)
    p.add_argument("-nf", "--n-features", type=int, default=32)
    p.add_argument("-nk", "--normalization-k", type=int, default=17)
    p.add_argument("-omd", "--output-model-dir", default="models_v2")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import optax

    from ..data import datasets as ds_mod
    from ..geometry import Learning
    from ..geometry3d import calibration as calmod
    from ..models.io import to_bytes
    from ..models.version2 import V2Network, V2Params
    from ..training.train import sample_patches, sgd_torch

    cal = calmod.PRESETS[args.calibration]
    datap = V2Params(wImg=cal.wImg, hImg=cal.hImg,
                     normalization_k=args.normalization_k,
                     layers=((3, args.kernel, args.kernel, args.n_features),),
                     hWin=args.window, wWin=args.window)
    net = V2Network(datap)
    geom = net.geometry

    ds = ds_mod.FlowDataset(geom, cal, args.root_directory,
                            cache_root=args.root_directory)
    # -ni limits the frames consumed (previously parsed but unused)
    ds.names = ds.names[: args.num_input_images]
    rng = np.random.RandomState(0)
    patches = ds.get_patches(args.n_train_set, rng, Learning())

    params = net.init(jax.random.PRNGKey(0))
    tx = sgd_torch(args.learning_rate)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, b1, b2, bt):
        def loss_fn(prm):
            logp = jax.vmap(lambda a, b: net.log_scores(prm, a, b))(b1, b2)
            logp = logp.reshape(logp.shape[0], -1)
            ll = jnp.take_along_axis(logp, bt[:, None], axis=-1)[:, 0]
            acc = (jnp.argmax(logp, -1) == bt).mean()
            return -ll.mean(), acc
        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, acc

    os.makedirs(args.output_model_dir, exist_ok=True)
    bs = args.batch_size
    n = (len(patches) // bs) * bs
    # one corpus upload, on-device batch gathers
    p1_d = jnp.asarray(patches.patches1)
    p2_d = jnp.asarray(patches.patches2)
    ts_d = jnp.asarray(patches.itargets)
    for epoch in range(args.num_epochs):
        order = rng.permutation(n)
        losses, accs = [], []
        for b in range(0, n, bs):
            sel = order[b:b + bs]
            params, opt_state, loss, acc = step(
                params, opt_state, p1_d[sel], p2_d[sel], ts_d[sel])
            losses.append(loss)
            accs.append(acc)
        # one device->host fetch per epoch (see training/train.py)
        losses = jax.device_get(losses)
        accs = jax.device_get(accs)
        print(f"epoch {epoch}: loss {np.mean(losses):.4f} "
              f"acc {np.mean(accs):.3f}")
        with open(os.path.join(args.output_model_dir, f"e{epoch}"), "wb") as f:
            f.write(to_bytes(params))
        # sidecar meta so `tools export` can rebuild the network without
        # the training flags (the reference stores only the bare payload,
        # version2/train.lua; dirs without meta.json still load as
        # version2 via serving.detect_family's bare-e<N> fallback)
        import json
        with open(os.path.join(args.output_model_dir, "meta.json"),
                  "w") as f:
            json.dump({"version": 1, "family": "version2",
                       "wImg": datap.wImg, "hImg": datap.hImg,
                       "normalization_k": datap.normalization_k,
                       "layers": [list(l) for l in datap.layers],
                       "hWin": datap.hWin, "wWin": datap.wWin}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
