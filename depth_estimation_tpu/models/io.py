"""Model serialization — the version-9 checkpoint format, rebuilt.

The reference saves {version=9, model_descr, weights dict, geometry, learning,
score} into a directory whose name encodes every hyperparameter
(saveModel, /root/reference/opticalflow_model_io.lua:98-164), and the loader
rebuilds the graph from the stored constructor and copies named weights
(loadModel :166-207, loadWeightsFrom :209-220; versions < 9 rejected :170-171).

Here: geometry/learning dataclasses serialize to JSON (the "constructor" is
the Geometry itself — models are pure functions of it), params serialize to
the msgpack layout of flax.serialization (``to_bytes``/``from_bytes`` below
read and write it without flax or msgpack installed), and the directory name
encodes the key
hyperparameters for the same greppable-filesystem workflow. Loading rejects
other format versions; ``load_weights_into`` supports the reference's
finetune path (-lw flag, /root/reference/opticalflow.lua:231-233).
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Any, Optional, Tuple

import numpy as np

from ..geometry import Geometry, Learning

FORMAT_VERSION = 9  # kept aligned with the reference's current version


# ---------------------------------------------------------------------------
# The msgpack layout of flax.serialization.to_bytes, for param trees: nested
# maps with str keys; arrays as ext type 1 holding msgpack
# [shape, dtype name, C-order bytes]; numpy scalars as ext type 3 (same
# payload). Keys are written sorted, the order jax pytrees flatten dicts in.
# ---------------------------------------------------------------------------

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def _pack(x, out: bytearray) -> None:
    if isinstance(x, dict):
        n = len(x)
        out += (bytes([0x80 | n]) if n < 16 else
                b"\xde" + struct.pack(">H", n) if n < 1 << 16 else
                b"\xdf" + struct.pack(">I", n))
        for k in sorted(x):
            _pack(str(k), out)
            _pack(x[k], out)
    elif isinstance(x, (list, tuple)):
        n = len(x)
        out += (bytes([0x90 | n]) if n < 16 else
                b"\xdc" + struct.pack(">H", n) if n < 1 << 16 else
                b"\xdd" + struct.pack(">I", n))
        for v in x:
            _pack(v, out)
    elif isinstance(x, str):
        b = x.encode()
        n = len(b)
        out += (bytes([0xa0 | n]) if n < 32 else
                b"\xd9" + struct.pack(">B", n) if n < 1 << 8 else
                b"\xda" + struct.pack(">H", n) if n < 1 << 16 else
                b"\xdb" + struct.pack(">I", n))
        out += b
    elif isinstance(x, (bytes, bytearray)):
        n = len(x)
        out += (b"\xc4" + struct.pack(">B", n) if n < 1 << 8 else
                b"\xc5" + struct.pack(">H", n) if n < 1 << 16 else
                b"\xc6" + struct.pack(">I", n))
        out += x
    elif isinstance(x, bool) or x is None:
        out += {None: b"\xc0", False: b"\xc2", True: b"\xc3"}[x]
    elif isinstance(x, int):
        if 0 <= x < 128 or -32 <= x < 0:
            out += struct.pack(">b" if x < 0 else ">B", x)
        elif x >= 0:
            for code, fmt, lim in ((0xcc, ">B", 8), (0xcd, ">H", 16),
                                   (0xce, ">I", 32), (0xcf, ">Q", 64)):
                if x < 1 << lim:
                    out += bytes([code]) + struct.pack(fmt, x)
                    break
        else:
            for code, fmt, lim in ((0xd0, ">b", 7), (0xd1, ">h", 15),
                                   (0xd2, ">i", 31), (0xd3, ">q", 63)):
                if x >= -(1 << lim):
                    out += bytes([code]) + struct.pack(fmt, x)
                    break
    elif isinstance(x, float):
        out += b"\xcb" + struct.pack(">d", x)
    else:
        arr = np.asarray(x)
        if arr.dtype.hasobject:
            raise TypeError(f"cannot serialize {type(x).__name__}")
        payload = bytearray()
        _pack([list(arr.shape), arr.dtype.name, arr.tobytes("C")], payload)
        code = _EXT_NPSCALAR if isinstance(x, np.generic) else _EXT_NDARRAY
        n = len(payload)
        if n in (1, 2, 4, 8, 16):
            out += bytes([{1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}[n]])
        else:
            out += (b"\xc7" + struct.pack(">B", n) if n < 1 << 8 else
                    b"\xc8" + struct.pack(">H", n) if n < 1 << 16 else
                    b"\xc9" + struct.pack(">I", n))
        out += bytes([code]) + payload


def _unpack(b: bytes, i: int):
    """Decode one object at offset i; returns (object, next offset)."""
    def need(j):
        if j > len(b):
            raise ValueError(f"msgpack unpack error: payload truncated "
                             f"({len(b)} bytes, {j} needed)")

    need(i + 1)
    c = b[i]
    i += 1

    def take(fmt):
        n = struct.calcsize(fmt)
        need(i + n)
        return struct.unpack(fmt, b[i:i + n])[0], i + n

    if c < 0x80:
        return c, i
    if c >= 0xe0:
        return c - 0x100, i
    if 0x80 <= c <= 0x8f or c in (0xde, 0xdf):
        n, i = ((c & 0x0f, i) if c <= 0x8f else
                take(">H" if c == 0xde else ">I"))
        d = {}
        for _ in range(n):
            k, i = _unpack(b, i)
            d[k], i = _unpack(b, i)
        return d, i
    if 0x90 <= c <= 0x9f or c in (0xdc, 0xdd):
        n, i = ((c & 0x0f, i) if c <= 0x9f else
                take(">H" if c == 0xdc else ">I"))
        lst = []
        for _ in range(n):
            v, i = _unpack(b, i)
            lst.append(v)
        return lst, i
    if 0xa0 <= c <= 0xbf or c in (0xd9, 0xda, 0xdb):
        n, i = ((c & 0x1f, i) if c <= 0xbf else
                take({0xd9: ">B", 0xda: ">H", 0xdb: ">I"}[c]))
        need(i + n)
        return b[i:i + n].decode(), i + n
    if c in (0xc4, 0xc5, 0xc6):
        n, i = take({0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}[c])
        need(i + n)
        return bytes(b[i:i + n]), i + n
    if c in (0xc0, 0xc2, 0xc3):
        return {0xc0: None, 0xc2: False, 0xc3: True}[c], i
    fixed = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
             0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
    if c in fixed:
        return take(fixed[c])
    if 0xd4 <= c <= 0xd8 or c in (0xc7, 0xc8, 0xc9):
        n, i = (({0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}[c], i)
                if c >= 0xd4 else
                take({0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}[c]))
        need(i + 1 + n)
        code, data = b[i], b[i + 1:i + 1 + n]
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        (shape, dtype, buf), _ = _unpack(data, 0)
        if dtype == "bfloat16":
            import jax.numpy as jnp
            dtype = jnp.bfloat16
        arr = np.frombuffer(buf, dtype=dtype).reshape(shape)
        return (arr[()] if code == _EXT_NPSCALAR else arr), i + 1 + n
    raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")


def to_bytes(tree) -> bytes:
    """Serialize a param tree (nested dicts of arrays) to the msgpack bytes
    flax.serialization.to_bytes writes for it."""
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


def msgpack_restore(payload: bytes):
    """Decode the bytes of ``to_bytes`` into nested dicts of numpy arrays."""
    tree, end = _unpack(payload, 0)
    if end != len(payload):
        raise ValueError(f"trailing bytes after msgpack object ({end} of "
                         f"{len(payload)} read)")
    return tree


def from_bytes(template, payload: bytes):
    """Restore the bytes of ``to_bytes`` into the structure of ``template``
    (flax.serialization.from_bytes semantics): the key sets must match at
    every level; leaves come from the payload."""
    def restore(t, s, path):
        if isinstance(t, dict):
            if not isinstance(s, dict) or set(map(str, t)) != set(s):
                raise ValueError(
                    f"checkpoint structure mismatch at {path or '/'}: "
                    f"expected keys {sorted(map(str, t))}, found "
                    f"{sorted(s) if isinstance(s, dict) else type(s).__name__}")
            return {k: restore(v, s[str(k)], f"{path}/{k}")
                    for k, v in t.items()}
        return s
    return restore(template, msgpack_restore(payload), "")


def model_dir_name(geom: Geometry, learning: Learning) -> str:
    """Hyperparameter-encoded directory name (describeModel/saveModel path
    encoding, /root/reference/opticalflow_model_io.lua:50-147)."""
    layers = "-".join("_".join(map(str, l)) for l in geom.layers)
    parts = [
        f"model={layers}",
        f"win={geom.maxh}x{geom.maxw}",
        f"img={geom.hImg}x{geom.wImg}",
        f"ms={'-'.join(map(str, geom.ratios)) if geom.multiscale else 'no'}"
        + ("" if not geom.multiscale or geom.share_filters else ",sf=0"),
        f"head={geom.output_extraction_method}",
        f"crit={learning.criterion}",
        f"lr={learning.rate}",
        f"lrd={learning.rate_decay}",
        f"wd={learning.weight_decay}",
    ]
    return ",".join(parts)


def save_model(
    path: str, geom: Geometry, learning: Learning, params: Any,
    score_history: Optional[list] = None, epoch: int = 0,
) -> str:
    """Writes <path>/{meta.json, params.msgpack}. Returns the directory."""
    os.makedirs(path, exist_ok=True)
    meta = {
        "version": FORMAT_VERSION,
        "geometry": dataclasses.asdict(geom),
        "learning": dataclasses.asdict(learning),
        "score": score_history or [],
        "epoch": epoch,
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    with open(os.path.join(path, "params.msgpack"), "wb") as f:
        f.write(to_bytes(params))
    return path


def load_model(path: str) -> Tuple[Geometry, Learning, Any, dict]:
    """Rebuild (geometry, learning, params, meta) from disk. Rejects other
    format versions like the reference loader."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("version") != FORMAT_VERSION:
        raise ValueError(
            f"checkpoint version {meta.get('version')} unsupported "
            f"(need {FORMAT_VERSION})"
        )
    gd = meta["geometry"]
    gd["layers"] = tuple(tuple(l) for l in gd["layers"])
    gd["ratios"] = tuple(gd["ratios"])
    geom = Geometry(**gd)
    learning = Learning(**meta["learning"])
    # template params to restore into
    from .flow import FlowModel
    import jax
    if geom.multiscale:
        from .multiscale import MultiscaleFlowModel
        model = MultiscaleFlowModel(geom)
    else:
        model = FlowModel(geom)
    template = model.init(jax.random.PRNGKey(0))
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        payload = f.read()
    # Migration: before the unshared-filters branch existed, the CLI
    # recorded share_filters=False (its default without -sf) while the
    # model always trained the SHARED tree — those checkpoints carry a
    # shared params payload under an unshared meta. Detect that
    # STRUCTURALLY (the unshared tree has a top-level 'scales' key; the
    # shared payload does not) rather than by catching restore errors,
    # so a genuinely-unshared checkpoint that fails restore for another
    # reason (truncation, version skew) surfaces its real exception.
    if geom.multiscale and not geom.share_filters:
        keys = set(msgpack_restore(payload).keys())
        if "scales" not in keys:
            # trained shared: restore with the shared template and return
            # the corrected geometry
            geom = dataclasses.replace(geom, share_filters=True)
            from .multiscale import MultiscaleFlowModel
            model = MultiscaleFlowModel(geom)
            template = model.init(jax.random.PRNGKey(0))
    params = from_bytes(template, payload)
    return geom, learning, params, meta


def load_weights_into(path: str, template: Any) -> Any:
    """Finetune path: restore weights into an existing params template
    (loadWeightsFrom, /root/reference/opticalflow_model_io.lua:209-220)."""
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        return from_bytes(template, f.read())
