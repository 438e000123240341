"""Radial online tester CLI — test_radial_opticalflow.lua rebuild.

The full polar streaming loop (/root/reference/radial/test_radial_opticalflow.lua:82-245):
per frame: undistort -> ego-motion -> epipole + EMA smoothing (alpha 0.5,
out-of-frame fallback) -> epipole-centered polar warp of current + rotation-
compensated previous frame -> radial matcher forward -> WTA flow -> polar->
cartesian warp-back -> flow2depth -> HSL color panel written to disk.
"""

from __future__ import annotations

import argparse
import ast
import os
import sys

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="Radial polar depth streaming")
    p.add_argument("-net", "--network", default="[[3,5,5,10],'tanh',[10,5,5,10]]")
    p.add_argument("-w", "--weights", default=None, help="msgpack weights")
    p.add_argument("-hwin", "--h-win", type=int, default=15)
    p.add_argument("-hi", "--h-input", type=int, default=200)
    p.add_argument("-wi", "--w-input", type=int, default=200)
    p.add_argument("-rd", "--root-directory", default="data/")
    p.add_argument("-cal", "--calibration", default="gopro")
    p.add_argument("-ni", "--num-images", type=int, default=10)
    p.add_argument("-o", "--output-dir", default="radial_out")
    p.add_argument("-ki", "--k-infty", type=float, default=1.0)
    p.add_argument("-cmp", "--compare-dense", action="store_true",
                   help="also render a dense-variational-flow depth panel "
                        "per frame (the reference compares against OpenCV "
                        "Farneback, test_radial_opticalflow.lua:231-237; "
                        "the in-repo celiu solver is the stand-in)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import jax
    import jax.numpy as jnp

    from ..data import datasets as ds_mod
    from ..data import images as img_mod
    from ..geometry3d import calibration as calmod
    from ..geometry3d import polar as polar_ops
    from ..models.radial import RadialFlowNetwork
    from ..utils.viz import save_image
    from ..utils.timer import Timers

    layers = tuple(tuple(l) if isinstance(l, list) else l
                   for l in ast.literal_eval(args.network))
    net = RadialFlowNetwork(layers, args.h_win)
    params = net.init(jax.random.PRNGKey(0))
    if args.weights:
        from ..models.io import from_bytes
        with open(args.weights, "rb") as f:
            params = from_bytes(params, f.read())

    cal = calmod.PRESETS[args.calibration]
    loader = img_mod.ImageLoader(args.root_directory, cal.hImg, cal.wImg)
    os.makedirs(args.output_dir, exist_ok=True)
    timers = Timers(sync_device=True)

    prev = loader.get_next_frame()
    e2_smooth = None
    k = 0
    while True:
        img = loader.get_next_frame()
        if img is None or k >= args.num_images:
            break
        timers.tic("pair")
        pair = ds_mod.load_polar_pair(
            cal, prev, img, args.h_input, args.w_input,
            args.h_input, args.w_input, net.w_kernel)
        e2_smooth = ds_mod.smooth_epipole(e2_smooth, pair.e2,
                                          args.h_input, args.w_input)
        if pair.good:
            flow, cost = net.flow(params, jnp.asarray(pair.polar_prev_image),
                                  jnp.asarray(pair.polar_image))
            flow = np.asarray(flow, np.float32)
            # warp flow back to cartesian space around the epipole
            k_out = polar_ops.get_k_output(args.h_input, net.h_kernel,
                                           args.h_win)
            h_out = int(args.h_input * k_out)
            w_out = int(args.w_input * k_out)
            p2c = polar_ops.get_p2c_grid(
                flow.shape[1], flow.shape[0], w_out, h_out,
                float(e2_smooth[0]) * k_out, float(e2_smooth[1]) * k_out,
                rmax=polar_ops.get_rmax(args.h_input, args.w_input, e2_smooth)
                * k_out)
            cart_flow = np.asarray(polar_ops.warp_grid(
                jnp.asarray(flow)[..., None], p2c))[..., 0]
            depth, confs = polar_ops.flow2depth(
                h_out, w_out, jnp.asarray(cart_flow),
                (float(e2_smooth[0]) * k_out, float(e2_smooth[1]) * k_out),
                args.k_infty)
            rgb = polar_ops.depth2color(depth, confs)
            save_image(os.path.join(args.output_dir, f"{k:09d}.png"),
                       np.asarray(rgb))
            if args.compare_dense:
                # dense-flow baseline column: flow magnitude -> depth panel
                # (reference: sfm2.getOpticalFlow Farneback + flow2depth,
                # test_radial_opticalflow.lua:231-237)
                from ..flow import get_optical_flow
                timers.tic("dense")
                ps = img_mod.scale(jnp.asarray(prev), args.h_input,
                                   args.w_input)
                cs = img_mod.scale(jnp.asarray(img), args.h_input,
                                   args.w_input)
                u, v = get_optical_flow(ps, cs, ratio=0.75,
                                        n_outer=3, n_sor=20)
                mag = jnp.sqrt(u * u + v * v)
                ddepth, dconfs = polar_ops.flow2depth(
                    args.h_input, args.w_input, mag,
                    (float(e2_smooth[0]), float(e2_smooth[1])), args.k_infty)
                drgb = polar_ops.depth2color(ddepth, dconfs)
                save_image(os.path.join(args.output_dir,
                                        f"{k:09d}_dense.png"),
                           np.asarray(drgb))
                timers.toc("dense")
        timers.toc("pair")
        prev = img
        k += 1
    print(timers.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
