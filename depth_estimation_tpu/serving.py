"""Serving exports: hermetic StableHLO artifacts of the inference programs.

The deployment regime the reference handles with its C++ API boundary
(/root/reference/depth_estimation_api.lua consumed from ardrone/ C++): a
serving host should not need the research package, its model classes, or
checkpoint parsing — just a program and its weights. The natural artifact
is a serialized `jax.export` module: the jitted inference program
with the trained parameters folded in as constants, versioned StableHLO,
reloadable with jax alone and jit-compiled on the serving host (the
persistent compilation cache, utils/compcache.py, makes that a one-time
cost per host).

Exporters cover every trainable model family (5/5):
  * export_flow_forward — the flagship single-scale fused forward
    (filter -> fused Pallas match -> WTA/soft-argmax) and the multiscale
    full-image WTA decode;
  * export_pipeline_pairs — the COMPLETE batched online program of
    api_batched.make_batched_pipeline (undistort -> ego-motion ->
    compensation -> match -> masks -> depth) over B frame pairs;
  * export_radial_forward — the polar 1-D matcher's tester decode
    (radial_opticalflow_network.lua getTesterNetwork semantics);
  * export_v2_forward — the version2 simplified matcher's full-frame WTA
    flow decode;
  * export_legacy_depth — the legacy depth classifier's fully-convolutional
    inference-on-image class map (depth_estimation.lua:340-404).

Artifacts are lowered for the platform they are exported on. Use
`load_exported(path).call(*args)` to serve. The matcher kernel lowers to a
Triton custom call on CUDA, which jax.export does not serialize without an
explicit opt-in; exporting on the GPU is open work (ROADMAP R7).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
from jax import export as jax_export

from .geometry import Geometry


def export_jitted(fn, example_args, path: str | None = None) -> bytes:
    """Serialize jitted ``fn`` traced at ``example_args`` (a StableHLO
    artifact with any closed-over arrays embedded as constants). Returns
    the bytes; also writes them to ``path`` when given."""
    exp = jax_export.export(jax.jit(fn))(*example_args)
    data = exp.serialize()
    if path is not None:
        with open(path, "wb") as fh:
            fh.write(data)
    return data


def load_exported(path_or_bytes):
    """Deserialize an artifact; returns the jax.export.Exported — call it
    via ``.call(*args)`` (jit-compiles on first use on the serving host)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as fh:
            data = fh.read()
    return jax_export.deserialize(data)


def export_flow_forward(geometry: Geometry, params, path: str | None = None,
                        dtype=jnp.float32) -> bytes:
    """Flow forward with ``params`` embedded. Single-scale geometry:
    models/flow.py forward_fused, artifact signature (hImg, wImg, 3) x2 ->
    (idx, ey, ex, pmax); multiscale geometry: the full-image multiscale
    WTA decode (decode_full), signature -> (flow_y, flow_x) int32 maps.
    ``dtype`` = matcher feature storage / staged-decode compute type (bf16
    is the single-scale in-budget inference option, README)."""
    g = geometry
    if g.multiscale:
        from .models.multiscale import MultiscaleFlowModel
        model = MultiscaleFlowModel(g, decode_dtype=dtype)

        def forward(img1, img2):
            return model.decode_full(params, img1, img2)
    else:
        from .models.flow import FlowModel, crop_features_center
        from .ops import matching
        model = FlowModel(g)

        def forward(img1, img2):
            f1 = crop_features_center(g, model.features(params, img1))
            f2 = model.features(params, img2)
            return matching.match_flow_fused(f1, f2, g.maxh, g.maxw, dtype)

    ex = jnp.zeros((g.hImg, g.wImg, 3), jnp.float32)
    return export_jitted(forward, (ex, ex), path)


def export_pipeline_pairs(geometry: Geometry, params, cal,
                          batch: int, frame_hw=(480, 640),
                          path: str | None = None, **knobs) -> bytes:
    """The complete batched per-frame program (api_batched
    .make_batched_pipeline) with ``params`` embedded: artifact signature
    (B, h, w, 3) uint8 x2 -> (xflow, mask, depth, good). ``knobs`` pass
    through to BatchedDepthEstimator (compensation, corner_selector,
    match_dtype, ...)."""
    from . import api_batched as apib
    pipeline = apib.make_batched_pipeline(geometry, cal, **knobs)
    h, w = frame_hw
    ex = jnp.zeros((batch, h, w, 3), jnp.uint8)
    return export_jitted(lambda a, b: pipeline(params, a, b), (ex, ex), path)


def export_radial_forward(layers, h_win: int, params, polar_hw=(200, 200),
                          path: str | None = None) -> bytes:
    """Radial tester decode with ``params`` embedded
    (test_radial_opticalflow.lua:205-207 WTA semantics via
    models/radial.py RadialFlowNetwork.flow): artifact signature
    (H, W, C) f32 polar pair -> (radial flow int32 (H', W'),
    min cost (H', W'))."""
    from .models.radial import RadialFlowNetwork
    net = RadialFlowNetwork(layers, h_win)
    h, w = polar_hw
    ex = jnp.zeros((h, w, layers[0][0]), jnp.float32)
    return export_jitted(lambda a, b: net.flow(params, a, b), (ex, ex), path)


def export_v2_forward(datap, params, path: str | None = None) -> bytes:
    """version2 full-frame WTA flow decode with ``params`` embedded
    (version2/network.lua matcher over the whole frame): artifact
    signature (hImg, wImg, 3) f32 x2 -> (flow_y, flow_x int32 maps,
    min cost)."""
    from . import codecs
    from .models.version2 import V2Network
    net = V2Network(datap)
    g = net.geometry

    def forward(img1, img2):
        costs = net.costs(params, img1, img2)
        idx = jnp.argmin(costs, axis=-1).astype(jnp.int32)
        dy, dx = codecs.decode(g, idx)
        return dy, dx, jnp.min(costs, axis=-1)

    ex = jnp.zeros((g.hImg, g.wImg, 3), jnp.float32)
    return export_jitted(forward, (ex, ex), path)


def export_legacy_depth(n_classes: int, params, frame_hw=(360, 640),
                        path: str | None = None) -> bytes:
    """Legacy depth classifier, fully-convolutional inference-on-image
    (depth_estimation.lua:340-404) with ``params`` embedded: artifact
    signature (H, W, 2) f32 frame-pair stack -> (H', W') int32 depth-class
    map (class 0 = nearest bin)."""
    from .models.legacy_depth import DepthClassifierCNN
    model = DepthClassifierCNN(n_classes=n_classes)
    h, w = frame_hw
    ex = jnp.zeros((h, w, 2), jnp.float32)

    def forward(x):
        return jnp.argmax(model.apply(params, x[None])[0],
                          axis=-1).astype(jnp.int32)

    return export_jitted(forward, (ex,), path)


def detect_family(model_dir: str):
    """Classify a trained model dir by its checkpoint layout. Returns
    (family, meta_dict_or_None) with family in
    {'flow', 'radial', 'v2', 'depth'}:
      * flow — models/io.py layout (meta.json carries 'geometry');
      * radial — cli/train_radial.py layout (meta.json with layers/hWin,
        weights in e<N>.msgpack);
      * v2 — cli/train_v2.py layout (meta.json with family='version2', or
        pre-meta dirs holding only bare e<N> payloads — the reference's
        own convention, version2/train.lua 'models/e<N>_no_bin');
      * depth — cli/depth_estimation.py layout (meta.json with
        n_classes/cut_depth)."""
    import json
    mp = os.path.join(model_dir, "meta.json")
    if os.path.exists(mp):
        with open(mp) as fh:
            meta = json.load(fh)
        if "geometry" in meta:
            return "flow", meta
        if meta.get("family") == "version2":
            return "v2", meta
        if "n_classes" in meta:
            return "depth", meta
        if "hWin" in meta and "layers" in meta:
            return "radial", meta
        raise ValueError(f"unrecognized meta.json keys in {model_dir}: "
                         f"{sorted(meta)}")
    if any(e.startswith("e") and e[1:].isdigit()
           for e in os.listdir(model_dir)):
        return "v2", None
    raise ValueError(f"{model_dir} is not a recognized model directory")


def _latest_epoch_payload(model_dir: str, suffix: str) -> bytes:
    eps = [int(e[1:len(e) - len(suffix)] or -1) for e in os.listdir(model_dir)
           if e.startswith("e") and e.endswith(suffix)
           and e[1:len(e) - len(suffix)].isdigit()]
    if not eps:
        raise FileNotFoundError(
            f"no e<N>{suffix} checkpoints in {model_dir}")
    with open(os.path.join(model_dir, f"e{max(eps)}{suffix}"), "rb") as fh:
        return fh.read()


def cmd_export(args) -> int:
    """`tools export`: write a serving artifact for a trained model dir.
    The model family (single/multiscale flow, radial, version2, legacy
    depth) is autodetected from the checkpoint layout."""
    import jax.random

    from .models.io import from_bytes

    family, meta = detect_family(args.model)
    out = args.out or os.path.join(args.model, "serving.stablehlo")
    if family == "flow":
        from .models import io as mio
        g, _, params, _ = mio.load_model(args.model)
        if args.pipeline:
            from .geometry3d import calibration as calmod
            cal = (calmod.Calibration.load(args.cal) if args.cal
                   else calmod.ARDRONE)
            data = export_pipeline_pairs(g, params, cal, args.batch,
                                         path=out)
        else:
            dt = jnp.bfloat16 if args.bf16 else jnp.float32
            data = export_flow_forward(g, params, path=out, dtype=dt)
    elif family == "radial":
        from .models.radial import RadialFlowNetwork
        layers = tuple(tuple(l) if isinstance(l, list) else l
                       for l in meta["layers"])
        net = RadialFlowNetwork(layers, meta["hWin"])
        params = from_bytes(
            net.init(jax.random.PRNGKey(0)),
            _latest_epoch_payload(args.model, ".msgpack"))
        hw = tuple(args.hw) if args.hw else (200, 200)
        data = export_radial_forward(layers, meta["hWin"], params,
                                     polar_hw=hw, path=out)
    elif family == "v2":
        from .models.version2 import V2Network, V2Params
        if meta is not None:
            datap = V2Params(
                wImg=meta["wImg"], hImg=meta["hImg"],
                normalization_k=meta["normalization_k"],
                layers=tuple(tuple(l) for l in meta["layers"]),
                hWin=meta["hWin"], wWin=meta["wWin"])
        else:
            datap = V2Params()
        net = V2Network(datap)
        params = from_bytes(
            net.init(jax.random.PRNGKey(0)),
            _latest_epoch_payload(args.model, ""))
        data = export_v2_forward(datap, params, path=out)
    else:  # depth
        from .models.legacy_depth import DepthClassifierCNN
        model = DepthClassifierCNN(n_classes=meta["n_classes"])
        patch = meta.get("patch", 48)
        template = model.init(jax.random.PRNGKey(0),
                              jnp.zeros((1, patch, patch, 2), jnp.float32))
        with open(os.path.join(args.model, "params.msgpack"), "rb") as fh:
            params = from_bytes(template, fh.read())
        hw = tuple(args.hw) if args.hw else (360, 640)
        data = export_legacy_depth(meta["n_classes"], params, frame_hw=hw,
                                   path=out)
    print(f"wrote {out} ({family}, {len(data)} bytes, platform "
          f"{jax.default_backend()})")
    return 0
