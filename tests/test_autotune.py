"""Matcher block-size autotuning (ops/autotune.py): winner selection,
persistence, and the estimator's match_block='auto' resolution path."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from depth_estimation_tpu.ops import autotune


@pytest.fixture
def tuned_store(tmp_path, monkeypatch):
    """Point the autotune store (and compile-cache dir) at a tmp dir and
    reset the in-process cache."""
    d = str(tmp_path / "cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", d)
    monkeypatch.setattr(autotune, "_cache", None)
    monkeypatch.setattr(autotune, "_session_only", {})
    yield d
    autotune._cache = None


def test_pick_selects_fastest_and_persists(tuned_store):
    calls = []

    def timer(fn):
        calls.append(1)
        return {0: 3.0, 1: 1.0, 2: 2.0}[len(calls) - 1]

    got = autotune.pick("k1", lambda c: c, candidates=(8, 16, 32),
                        timer=timer)
    assert got == 16
    with open(os.path.join(tuned_store, "autotune.json")) as fh:
        assert json.load(fh)["k1"] == 16

    def exploding_timer(fn):
        raise AssertionError("cache hit must not re-measure")

    autotune._cache = None            # fresh process simulation: reload disk
    assert autotune.pick("k1", lambda c: c, timer=exploding_timer) == 16


def test_pick_skips_failing_candidates(tuned_store):
    def run(c):
        if c == 8:
            raise RuntimeError("out of shared memory")
        return c

    def timer(fn):
        fn()
        return 1.0

    assert autotune.pick("k2", run, candidates=(8, 16), timer=timer) == 16


def test_partial_sweep_not_persisted(tuned_store):
    """A sweep with any failing candidate is answered in-process but never
    written to disk — a transient device error must not freeze a winner
    measured from an incomplete sweep (nor an unmeasured fallback)."""
    def run(c):
        if c == 8:
            raise RuntimeError("transient device error")
        return c

    def timer(fn):
        fn()
        return 1.0

    assert autotune.pick("k3", run, candidates=(8, 16), timer=timer) == 16

    def exploding_timer(fn):
        raise AssertionError("session cache must answer without re-measure")

    assert autotune.pick("k3", run, candidates=(8, 16),
                         timer=exploding_timer) == 16
    p = os.path.join(tuned_store, "autotune.json")
    assert not os.path.exists(p) or "k3" not in json.load(open(p))

    # all candidates failing: fallback winner, same no-persist rule
    def all_fail(c):
        raise RuntimeError("device unreachable")

    assert autotune.pick("k4", all_fail, candidates=(8, 16),
                         timer=timer) == 8
    assert not os.path.exists(p) or "k4" not in json.load(open(p))


@pytest.mark.slow
def test_estimator_auto_block_matches_fixed(tuned_store):
    """match_block='auto' resolves during reset() and the step output is
    bitwise identical to a fixed block (pure blocking factor)."""
    import dataclasses
    from depth_estimation_tpu.api_batched import BatchedDepthEstimator
    from depth_estimation_tpu.geometry import Geometry
    from depth_estimation_tpu.geometry3d import calibration as calmod
    from depth_estimation_tpu.models.flow import FlowModel

    hp, wp = 48, 64
    cal = dataclasses.replace(
        calmod.RECTIFIED_GOPRO_SMALL, name="at", wImg=wp, hImg=hp,
        fx=60.0, fy=60.0, cx=wp / 2, cy=hp / 2,
        sfm=dataclasses.replace(calmod.RECTIFIED_GOPRO_SMALL.sfm,
                                max_points=64))
    g = Geometry(hImg=hp, wImg=wp, layers=((3, 5, 5, 6),), maxh=4, maxw=4)
    params = FlowModel(g).init(jax.random.PRNGKey(0))

    rng = np.random.RandomState(0)
    base = rng.rand(2, hp // 4, wp // 4, 3).astype(np.float32)
    f1 = jnp.asarray(jax.image.resize(jnp.asarray(base), (2, hp, wp, 3),
                                      "bilinear"))
    f2 = jnp.asarray(np.roll(np.asarray(f1), -1, axis=2))

    # fake timer: avoid 4 interpret-mode compiles; still exercises the
    # candidate closures' construction and the persistence path
    times = {2: 2.5, 4: 2.0, 8: 1.0, 16: 3.0}
    seen = []

    def timer(fn):
        seen.append(1)
        return times[autotune.CANDIDATES[len(seen) - 1]]

    import depth_estimation_tpu.ops.autotune as at
    orig = at._default_timer
    at._default_timer = timer
    try:
        est = BatchedDepthEstimator(g, params, cal, match_block="auto")
        est.reset(f1)
    finally:
        at._default_timer = orig
    assert est._match_block == 8

    est_fixed = BatchedDepthEstimator(g, params, cal, match_block=8)
    est_fixed.reset(f1)
    got = est.next_frames(f2)
    want = est_fixed.next_frames(f2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
