"""Radial (polar 1-D) flow trainer CLI — train_radial_opticalflow.lua rebuild.

Mirrors /root/reference/radial/train_radial_opticalflow.lua:20-130: network
spec parseable from a string flag (-net "[[3,1,17,5],'tanh',...]"), polar
input size, hWin classes, NLL training over the radial window, per-epoch
evaluation, weights-only checkpoints.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="Train the radial polar flow net")
    p.add_argument("-net", "--network", default="[[3,5,5,10],'tanh',[10,5,5,10]]",
                   help="layer spec: list of [cin,kh,kw,cout] and 'tanh'")
    p.add_argument("-hwin", "--h-win", type=int, default=15)
    p.add_argument("-hi", "--h-input", type=int, default=200)
    p.add_argument("-wi", "--w-input", type=int, default=200)
    p.add_argument("-rd", "--root-directory", default="data/")
    p.add_argument("-ds", "--dataset", default="")
    p.add_argument("-cal", "--calibration", default="gopro")
    p.add_argument("-ni", "--num-input-images", type=int, default=10)
    p.add_argument("-d", "--delta", type=int, default=1)
    p.add_argument("-n", "--n-train-set", type=int, default=1000)
    p.add_argument("-e", "--num-epochs", type=int, default=10)
    p.add_argument("-r", "--learning-rate", type=float, default=1e-2)
    p.add_argument("-lrd", "--learning-rate-decay", type=float, default=1e-5)
    p.add_argument("-bs", "--batch-size", type=int, default=32)
    p.add_argument("-omd", "--output-model-dir", default="models_radial")
    p.add_argument("-mf", "--max-flow", type=float, default=None)
    p.add_argument("-gtd", "--gt-dataset", default=None,
                   help="name of an index-aligned sibling dataset (under "
                        "the same root directory) whose frames drive "
                        "ego-motion geometry and GT targets, while patch "
                        "PIXELS come from --dataset. The clean-targets "
                        "training regime for noisy corpora: GT computed "
                        "on the clean recording, features learned on the "
                        "noisy one.")
    p.add_argument("--dp", default="auto", metavar="auto|off|N",
                   help="data-parallel device mesh: shards the polar "
                        "dataset/GT build and the training batches across "
                        "the attached devices ('auto' = all when >1)")
    p.add_argument("-sl", "--scene-length", type=int, default=0,
                   help="frames per scene when the dataset dir holds "
                        "several back-to-back recordings: pairs crossing "
                        "a scene boundary are dropped deterministically. "
                        "Counts loaded (post--delta) frames. 0 = one "
                        "continuous sequence. The ego-motion inlier gate "
                        "alone is not a seam detector — an essential "
                        "matrix fits unrelated-texture LK tracks above "
                        "the bad-frame threshold surprisingly often.")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import jax
    import jax.numpy as jnp
    import optax

    from ..data import datasets as ds_mod
    from ..data import images as img_mod
    from ..data.groundtruth import gt_geometry
    from ..geometry import Geometry
    from ..geometry3d import calibration as calmod
    from ..models.radial import RadialFlowNetwork
    from ..training.train import sgd_torch

    layers = tuple(
        tuple(l) if isinstance(l, list) else l
        for l in ast.literal_eval(args.network)
    )
    net = RadialFlowNetwork(layers, args.h_win)
    cal = calmod.PRESETS[args.calibration]
    max_flow = args.max_flow if args.max_flow is not None else args.h_win - 1

    # load frames and build polar pairs with projected GT
    loader = img_mod.ImageLoader(os.path.join(args.root_directory,
                                              args.dataset),
                                 cal.hImg, cal.wImg)
    geom_gt = Geometry(hImg=cal.hImg, wImg=cal.wImg,
                       layers=((3, 16, 16, 768),),
                       maxh=16, maxw=16, maxhGT=16, maxwGT=16,
                       hKernelGT=16, wKernelGT=16)
    frames = []
    while len(frames) < args.num_input_images:
        for _ in range(args.delta - 1 if frames else 0):
            loader.get_next_frame()
        f = loader.get_next_frame()
        if f is None:
            break
        frames.append(f)
    if len(frames) < 2:
        print("no usable pairs", file=sys.stderr)
        return 1
    gt_frames = None
    if args.gt_dataset:
        # clean-targets regime: swap the roles — GT/geometry from the
        # sibling dataset's frames, pixels from this one's
        gt_loader = img_mod.ImageLoader(
            os.path.join(args.root_directory, args.gt_dataset),
            cal.hImg, cal.wImg)
        gt_frames = []
        while len(gt_frames) < len(frames):
            for _ in range(args.delta - 1 if gt_frames else 0):
                gt_loader.get_next_frame()
            f = gt_loader.get_next_frame()
            if f is None:
                break
            gt_frames.append(f)
        if len(gt_frames) != len(frames):
            print(f"--gt-dataset {args.gt_dataset} is not index-aligned "
                  f"({len(gt_frames)} frames vs {len(frames)})",
                  file=sys.stderr)
            return 1
    # --dp: shard the dataset/GT build and training over a device mesh
    from ..parallel import mesh as pm
    mesh = pm.auto_mesh(args.dp)
    if mesh is not None:
        print(f"dp mesh: {mesh.devices.size} devices "
              f"({mesh.devices.flat[0].platform})")
        if args.batch_size % mesh.devices.size:
            print(f"batch size {args.batch_size} not divisible by the "
                  f"{mesh.devices.size}-device mesh", file=sys.stderr)
            return 1
    # batched loader: the whole ego-motion/polar-warp/GT stack for every
    # pair runs in a handful of device programs (load_polar_pairs_batched)
    sl = args.scene_length
    pairs = [p for k, p in enumerate(ds_mod.load_polar_pairs_batched(
        cal, gt_frames if gt_frames is not None else frames,
        cal.hImg, cal.wImg,
        args.h_input, args.w_input, net.w_kernel,
        geom_gt=geom_gt, max_flow=max_flow,
        pixel_frames=frames if gt_frames is not None else None,
        mesh=mesh))
        if p.good and (not sl or k // sl == (k + 1) // sl)]
    if not pairs:
        print("no usable pairs", file=sys.stderr)
        return 1
    print(f"{len(pairs)}/{len(frames) - 1} pairs usable")

    rng = np.random.RandomState(0)
    h_patch = net.h_kernel + args.h_win - 1
    w_patch = net.w_kernel
    batches = []
    for pair in pairs:
        got = ds_mod.generate_polar_training_patches(
            pair, h_patch, w_patch, args.h_win,
            args.n_train_set // len(pairs), rng)
        if got:
            batches.append(got)
    p1 = np.concatenate([b[0] for b in batches])
    p2 = np.concatenate([b[1] for b in batches])
    ts = np.concatenate([b[2] for b in batches])

    params = net.init(jax.random.PRNGKey(0))
    tx = sgd_torch(args.learning_rate, args.learning_rate_decay)
    opt_state = tx.init(params)

    def step_fn(params, opt_state, b1, b2, bt):
        def loss_fn(prm):
            logp = jax.vmap(lambda a, b: net.log_scores(prm, a, b))(b1, b2)
            logp = logp.reshape(logp.shape[0], -1)
            ll = jnp.take_along_axis(logp, bt[:, None], axis=-1)[:, 0]
            acc = (jnp.argmax(logp, -1) == bt).mean()
            return -ll.mean(), acc
        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, acc

    if mesh is not None:
        # batch split on dp, params/opt replicated — XLA derives the
        # gradient all-reduce (same pattern as parallel.sharded_train_step)
        from jax.sharding import NamedSharding, PartitionSpec as P
        rep = NamedSharding(mesh, P())
        bsh = NamedSharding(mesh, P("dp"))
        step = jax.jit(step_fn,
                       in_shardings=(rep, rep, bsh, bsh, bsh),
                       out_shardings=(rep, rep, rep, rep))
    else:
        step = jax.jit(step_fn)

    os.makedirs(args.output_model_dir, exist_ok=True)
    bs = args.batch_size
    n = (len(ts) // bs) * bs
    # upload the corpus once and gather batches on device instead of
    # re-uploading data[sel] every step
    p1_d, p2_d, ts_d = jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(ts)
    for epoch in range(args.num_epochs):
        order = rng.permutation(n)
        losses, accs = [], []
        for b in range(0, n, bs):
            sel = order[b:b + bs]
            params, opt_state, loss, acc = step(
                params, opt_state, p1_d[sel], p2_d[sel], ts_d[sel])
            losses.append(loss)
            accs.append(acc)
        # one device->host fetch per epoch, not a scalar fetch per step
        losses = jax.device_get(losses)
        accs = jax.device_get(accs)
        if losses:
            print(f"epoch {epoch}: loss {np.mean(losses):.4f} "
                  f"acc {np.mean(accs):.3f}")
        else:
            # fewer patches than one batch — nothing trained this epoch
            print(f"epoch {epoch}: no full batch "
                  f"({len(ts)} patches < batch_size {bs})")
        # weights-only save, format version 1
        # (/root/reference/radial/radial_opticalflow_network.lua:122-132)
        from ..models.io import to_bytes
        with open(os.path.join(args.output_model_dir, f"e{epoch}.msgpack"),
                  "wb") as f:
            f.write(to_bytes(params))
        with open(os.path.join(args.output_model_dir, "meta.json"), "w") as f:
            json.dump({"version": 1, "layers": list(map(list, (
                l if isinstance(l, str) else list(l) for l in layers))),
                "hWin": args.h_win}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
