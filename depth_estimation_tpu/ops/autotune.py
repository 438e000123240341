"""Shape-keyed autotuning for the fused matcher's tile height.

``block_rows`` is a pure blocking factor — outputs are identical for any
value (pinned by tests/test_matching.py) — but the fastest value depends on
shape, dtype and batch. ``best_block_rows`` measures the candidates ONCE per
(shapes, dtype, backend) on the live device and persists the winner beside
the compilation cache (utils/compcache.cache_dir()/autotune.json), so every
later process starts tuned.

This is an EXPLICIT pre-pass: resolve the block size before building a
jitted program (``BatchedDepthEstimator(match_block="auto")`` resolves
during ``reset()``, where the real feature shapes exist). Kernels themselves
never see "auto" — timing under a tracer is meaningless.
"""

from __future__ import annotations

import json
import os
import time

# tile heights the Triton-route kernel accepts (powers of two)
CANDIDATES = (2, 4, 8, 16)

# Bump when the matcher kernel changes in a way that can shift the fastest
# block size: the persisted winners must be invalidated explicitly (the
# compile cache invalidates itself on code changes; this store does not).
TUNE_VERSION = 3

_cache = None
# winners from partial/failed sweeps: process-local only, never persisted
_session_only: dict = {}


def _store_path() -> str:
    from ..utils.compcache import cache_dir
    return os.path.join(cache_dir(), "autotune.json")


def _load() -> dict:
    global _cache
    if _cache is None:
        _cache = {}
        p = _store_path()
        if os.path.exists(p):
            with open(p) as fh:
                _cache = json.load(fh)
    return _cache


def _save() -> None:
    p = _store_path()
    os.makedirs(os.path.dirname(p), exist_ok=True)
    with open(p, "w") as fh:
        json.dump(_cache, fh, indent=1, sort_keys=True)


def _default_timer(fn, n: int = 5) -> float:
    """Median seconds per call, each call ended by block_until_ready."""
    import jax
    import numpy as np
    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def pick(key: str, run_candidate, candidates=CANDIDATES, timer=None) -> int:
    """Return the cached winner for ``key``, measuring each candidate via
    ``run_candidate(c)`` on a miss. Candidates that raise (e.g. need more
    registers or shared memory than a block may have) are skipped — but a
    sweep with ANY failure is only cached in-process, never persisted: a
    winner written to disk must come from a complete sweep."""
    cache = _load()
    if key in cache:
        return int(cache[key])
    if key in _session_only:
        return int(_session_only[key])
    timer = timer or _default_timer
    best, best_t, failed = None, float("inf"), 0
    for c in candidates:
        try:
            t = timer(lambda: run_candidate(c))
        except Exception:
            failed += 1
            continue
        if t < best_t:
            best, best_t = c, t
    if best is None:
        # nothing measured at all: fall back for this process only
        best = candidates[0]
    if failed:
        _session_only[key] = int(best)
        return int(best)
    cache[key] = int(best)
    _save()
    return int(best)


def best_block_rows(f1_shape, f2_shape, maxh: int, maxw: int,
                    dtype=None, want_conf: bool = False,
                    conf_threshold: float = 0.11,
                    candidates=CANDIDATES, timer=None) -> int:
    """Resolve the fastest ``block_rows`` of ``match_flow_fused`` for a call
    signature by measuring on the live device (cached persistently).
    Shapes are the concrete (B?, H, W, K) feature shapes the pipeline will
    pass."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from . import matching
    dtype = dtype or jnp.float32
    dname = jnp.dtype(dtype).name
    key = (f"v{TUNE_VERSION}:jax{jax.__version__}:"
           f"fused:{jax.default_backend()}:{tuple(f1_shape)}:"
           f"{tuple(f2_shape)}:{maxh}x{maxw}:{dname}:"
           f"conf={int(want_conf)}")
    rng = np.random.RandomState(0)
    f1 = jnp.asarray(rng.rand(*f1_shape), jnp.float32)
    f2 = jnp.asarray(rng.rand(*f2_shape), jnp.float32)

    def run(c):
        return matching.match_flow_fused(f1, f2, maxh, maxw, dtype,
                                         want_conf, conf_threshold, c)

    return pick(key, run, candidates, timer)
