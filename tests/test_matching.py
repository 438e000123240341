"""Matcher op tests, modeled on the reference's analytic invariants:
brute-force SSD argmin equality (/root/reference/tests/test_multiscale.lua:135-166)
and WTA decode with middle tie-break (/root/reference/opticalflow_model.lua:153-161).
The fused kernel runs in the Pallas interpreter on the CPU; the tests
marked ``gpu`` run it compiled on a card."""

import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from depth_estimation_tpu import codecs
from depth_estimation_tpu.geometry import Geometry
from depth_estimation_tpu.ops import matching


def brute_force_ssd(f1, f2, maxh, maxw):
    H, W, K = f1.shape
    out = np.zeros((H, W, maxh * maxw), np.float32)
    for y in range(H):
        for x in range(W):
            for dy in range(maxh):
                for dx in range(maxw):
                    d = f1[y, x] - f2[y + dy, x + dx]
                    out[y, x, dy * maxw + dx] = np.sum(d * d)
    return out


@pytest.mark.parametrize("maxh,maxw,K", [(8, 8, 3), (5, 7, 10), (16, 1, 4)])
def test_match_ssd_brute_force(maxh, maxw, K):
    rng = np.random.RandomState(0)
    H, W = 6, 9
    f1 = rng.randn(H, W, K).astype(np.float32)
    f2 = rng.randn(H + maxh - 1, W + maxw - 1, K).astype(np.float32)
    got = np.asarray(matching.match_ssd(jnp.asarray(f1), jnp.asarray(f2), maxh, maxw))
    want = brute_force_ssd(f1, f2, maxh, maxw)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_match_recovers_known_shift():
    """Identity-features trick: f2 is f1 shifted by a known displacement, so
    the WTA must recover it exactly (reference test_patches2 semantics)."""
    g = Geometry(maxh=8, maxw=8)
    rng = np.random.RandomState(1)
    H, W, K = 12, 14, 6
    big = rng.rand(H + g.maxh - 1, W + g.maxw - 1, K).astype(np.float32)
    # truth displacement (centered): dy=2, dx=-1
    dy_c, dx_c = 2, -1
    dy_w, dx_w = dy_c + g.halfh1, dx_c + g.halfw1
    f1 = big[dy_w:dy_w + H, dx_w:dx_w + W]
    costs = matching.match_ssd(jnp.asarray(f1), jnp.asarray(big), g.maxh, g.maxw)
    idx = matching.wta_from_costs(costs, codecs.middle_index(g))
    ry, rx = codecs.decode(g, idx)
    assert np.all(np.asarray(ry) == dy_c)
    assert np.all(np.asarray(rx) == dx_c)


def test_wta_middle_tiebreak():
    g = Geometry(maxh=4, maxw=4)
    mid = codecs.middle_index(g)
    D = g.maxh * g.maxw
    costs = np.ones((2, 2, D), np.float32)
    # pixel (0,0): unique min away from middle -> picks it
    costs[0, 0, 3] = 0.1
    # pixel (0,1): min tie between cell 2 and middle -> picks middle
    costs[0, 1, 2] = 0.5
    costs[0, 1, mid] = 0.5
    # pixel (1,0): middle is the unique min
    costs[1, 0, mid] = 0.0
    idx = np.asarray(matching.wta_from_costs(jnp.asarray(costs), mid))
    assert idx[0, 0] == 3
    assert idx[0, 1] == mid
    assert idx[1, 0] == mid


def _fused_interpret(f1, f2, maxh, maxw, block_rows=4):
    return matching.match_flow_fused(
        jnp.asarray(f1), jnp.asarray(f2), maxh, maxw, block_rows=block_rows)


@pytest.mark.parametrize("maxh,maxw", [(8, 8), (5, 7)])
def test_fused_matches_reference_path(maxh, maxw):
    rng = np.random.RandomState(2)
    H, W, K = 10, 16, 5
    f1 = rng.randn(H, W, K).astype(np.float32)
    f2 = rng.randn(H + maxh - 1, W + maxw - 1, K).astype(np.float32)

    costs = matching.match_ssd(jnp.asarray(f1), jnp.asarray(f2), maxh, maxw)
    mid = (math.ceil(maxh / 2) - 1) * maxw + (math.ceil(maxw / 2) - 1)
    want_idx = np.asarray(matching.wta_from_costs(costs, mid))
    p = np.asarray(matching.softmax_scores(costs))
    off_y = np.arange(maxh * maxw) // maxw - (math.ceil(maxh / 2) - 1)
    off_x = np.arange(maxh * maxw) % maxw - (math.ceil(maxw / 2) - 1)
    want_ey = (p * off_y).sum(-1)
    want_ex = (p * off_x).sum(-1)
    want_pmax = p.max(-1)

    idx, ey, ex, pmax = _fused_interpret(f1, f2, maxh, maxw)
    np.testing.assert_array_equal(np.asarray(idx), want_idx)
    np.testing.assert_allclose(np.asarray(ey), want_ey, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ex), want_ex, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(pmax), want_pmax, rtol=1e-4, atol=1e-5)


def test_fused_row_padding():
    """H not a multiple of block_rows exercises the padding path."""
    maxh = maxw = 4
    rng = np.random.RandomState(3)
    H, W, K = 7, 9, 3
    f1 = rng.randn(H, W, K).astype(np.float32)
    f2 = rng.randn(H + maxh - 1, W + maxw - 1, K).astype(np.float32)
    costs = matching.match_ssd(jnp.asarray(f1), jnp.asarray(f2), maxh, maxw)
    mid = (math.ceil(maxh / 2) - 1) * maxw + (math.ceil(maxw / 2) - 1)
    want_idx = np.asarray(matching.wta_from_costs(costs, mid))
    idx, *_ = _fused_interpret(f1, f2, maxh, maxw, block_rows=4)
    np.testing.assert_array_equal(np.asarray(idx), want_idx)


def test_radial_matching():
    hwin = 6
    rng = np.random.RandomState(4)
    H, W, K = 8, 10, 4
    f1 = rng.randn(H, W, K).astype(np.float32)
    f2 = rng.randn(H + hwin - 1, W, K).astype(np.float32)
    got = np.asarray(matching.match_ssd_radial(jnp.asarray(f1), jnp.asarray(f2), hwin))
    want = brute_force_ssd(f1, f2, hwin, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)




def test_entropy_mask():
    from depth_estimation_tpu.ops import extract
    peaked = np.zeros(16, np.float32); peaked[3] = 1.0
    flat = np.full(16, 1 / 16, np.float32)
    m = np.asarray(extract.entropy_mask(
        jnp.asarray(np.stack([peaked, flat])), threshold=1.0))
    assert m[0] and not m[1]


def test_fused_marginal_output():
    """The plain form's 'mean'-head gate marginalizes the softmax over dx
    (getOutputConfidences2, /root/reference/opticalflow_model.lua:192-193)
    before the thresholded extraction: it equals
    extract.mean_head_confidences on the full window distribution, and the
    base outputs do not depend on want_conf."""
    from depth_estimation_tpu.ops import extract
    maxh, maxw = 6, 4
    rng = np.random.RandomState(7)
    H, W, K = 9, 12, 5
    f1 = (0.3 * rng.randn(H, W, K)).astype(np.float32)
    f2 = (0.3 * rng.randn(H + maxh - 1, W + maxw - 1, K)).astype(np.float32)

    costs = matching.match_ssd(jnp.asarray(f1), jnp.asarray(f2), maxh, maxw)
    p = matching.softmax_scores(costs)
    # a threshold at which the gate splits this input's pixels
    want = np.asarray(extract.mean_head_confidences(p, maxh, maxw, 0.2))
    outs = matching.match_flow_reference(jnp.asarray(f1), jnp.asarray(f2),
                                         maxh, maxw, jnp.float32, True, 0.2)
    assert outs[4].shape == (H, W)
    np.testing.assert_array_equal(np.asarray(outs[4]) > 0.5, want)
    assert 0 < want.sum() < want.size
    base = matching.match_flow_reference(jnp.asarray(f1), jnp.asarray(f2),
                                         maxh, maxw)
    for a, b in zip(outs[:4], base):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_entropy_mask_exact_values_and_monotonicity():
    """entropy_mask thresholds Shannon entropy of the window distribution:
    uniform over n cells has entropy exactly ln(n); mixing a peaked
    distribution toward uniform increases entropy monotonically."""
    from depth_estimation_tpu.ops import extract
    n = 64
    uniform = np.full(n, 1.0 / n, np.float32)
    # exact boundary: ln(64) = 4.1589; threshold just below/above
    ln_n = float(np.log(n))
    m_below = np.asarray(extract.entropy_mask(
        jnp.asarray(uniform[None]), threshold=ln_n - 1e-3))
    m_above = np.asarray(extract.entropy_mask(
        jnp.asarray(uniform[None]), threshold=ln_n + 1e-3))
    assert not m_below[0] and m_above[0]
    # monotonicity in the mixing coefficient
    peak = np.zeros(n, np.float32)
    peak[7] = 1.0
    hs = []
    for lam in (0.0, 0.25, 0.5, 0.75, 1.0):
        p = (1 - lam) * peak + lam * uniform
        p = p / p.sum()
        pc = np.clip(p, 1e-12, 1.0)
        hs.append(float(-(pc * np.log(pc)).sum()))
        # mask agrees with the hand-computed entropy on both sides
        for eps in (-1e-3, 1e-3):
            m = np.asarray(extract.entropy_mask(
                jnp.asarray(p[None]), threshold=hs[-1] + eps))
            assert bool(m[0]) == (eps > 0)
    assert all(a < b for a, b in zip(hs, hs[1:]))


def test_fused_kernel_bf16_parity():
    """The bf16 feature path of match_flow_fused must agree with f32 on the
    WTA index nearly everywhere and on soft-argmax within bf16 tolerance."""
    rng = np.random.RandomState(7)
    maxh = maxw = 8
    H, W, K = 24, 32, 6
    f1 = jnp.asarray(rng.rand(H, W, K), jnp.float32)
    f2 = jnp.asarray(rng.rand(H + maxh - 1, W + maxw - 1, K), jnp.float32)
    o32 = matching.match_flow_fused(f1, f2, maxh, maxw)
    o16 = matching.match_flow_fused(f1, f2, maxh, maxw, jnp.bfloat16,
                                    block_rows=8)
    idx_agree = (np.asarray(o32[0]) == np.asarray(o16[0])).mean()
    assert idx_agree > 0.9, idx_agree
    np.testing.assert_allclose(np.asarray(o32[1]), np.asarray(o16[1]),
                               atol=0.25)
    np.testing.assert_allclose(np.asarray(o32[3]), np.asarray(o16[3]),
                               atol=0.05)


def test_fused_block_rows_is_pure_blocking():
    """block_rows only tiles the row grid — every output must be identical
    across tile heights."""
    maxh, maxw = 6, 4
    rng = np.random.RandomState(13)
    H, W, K = 40, 24, 5
    f1 = jnp.asarray(rng.randn(H, W, K).astype(np.float32))
    f2 = jnp.asarray(rng.randn(H + maxh - 1, W + maxw - 1, K).astype(
        np.float32))
    ref = matching.match_flow_fused(f1, f2, maxh, maxw, block_rows=4)
    for block in (2, 8, 16):
        out = matching.match_flow_fused(f1, f2, maxh, maxw, block_rows=block)
        for a, b in zip(ref, out):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fused_conf_gate_matches_marginal_extraction():
    """want_conf=True appends the 'mean'-head confidence gate computed
    in-kernel; it must equal confidences_from_marginal on the plain form's
    y-marginal (the extract_output score is > 0 iff any marginal entry
    clears the threshold — all rank weights are positive)."""
    from depth_estimation_tpu.ops import extract
    maxh, maxw = 6, 4
    rng = np.random.RandomState(11)
    H, W, K = 9, 12, 5
    # small feature magnitudes -> soft distributions that straddle the
    # threshold (both gate outcomes exercised)
    f1 = (0.3 * rng.randn(H, W, K)).astype(np.float32)
    f2 = (0.3 * rng.randn(H + maxh - 1, W + maxw - 1, K)).astype(np.float32)
    costs = matching.match_ssd(jnp.asarray(f1), jnp.asarray(f2), maxh, maxw)
    p = matching.softmax_scores(costs)
    marg = p.reshape(H, W, maxh, maxw).sum(-1)
    wants = []
    for thr in (0.11, 0.2):
        want = np.asarray(extract.confidences_from_marginal(marg, thr))
        outs = matching.match_flow_fused(
            jnp.asarray(f1), jnp.asarray(f2), maxh, maxw, jnp.float32, True,
            thr)
        conf = np.asarray(outs[4])
        assert conf.shape == (H, W)
        assert set(np.unique(conf)) <= {0.0, 1.0}
        np.testing.assert_array_equal(conf > 0.5, want)
        wants.append(want)
    # both outcomes exercised somewhere across the thresholds
    assert any(0 < w.sum() < w.size for w in wants)


@pytest.mark.parametrize("B,H,W,K,maxh,maxw,dtype,want_conf", [
    (2, 10, 13, 3, 5, 7, jnp.float32, True),     # B>1, maxh != maxw
    (1, 9, 40, 5, 6, 4, jnp.float32, False),     # W spans two tiles
    (3, 7, 33, 4, 8, 8, jnp.bfloat16, True),     # bf16 storage
    (2, 6, 11, 4, 4, 6, jnp.float16, True),      # f16 storage
])
def test_fused_kernel_matches_plain_form(B, H, W, K, maxh, maxw, dtype,
                                         want_conf):
    """The kernel (Triton route, interpreted here) against the plain form
    at the same storage type, on shapes whose H and W are not powers of
    two: identical WTA index and gate, f32-rounding-level expectations."""
    rng = np.random.RandomState(B * 100 + H)
    f1 = jnp.asarray(0.4 * rng.randn(B, H, W, K), jnp.float32)
    f2 = jnp.asarray(0.4 * rng.randn(B, H + maxh - 1, W + maxw - 1, K),
                     jnp.float32)
    got = matching.match_flow_fused(f1, f2, maxh, maxw, dtype, want_conf)
    want = matching.match_flow_reference(f1, f2, maxh, maxw, dtype,
                                         want_conf)
    assert len(got) == len(want) == (5 if want_conf else 4)
    assert all(g.shape == (B, H, W) for g in got)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    for a, b in zip(got[1:4], want[1:4]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=2e-6)
    if want_conf:
        np.testing.assert_array_equal(np.asarray(got[4]),
                                      np.asarray(want[4]))


def test_fused_kernel_batch_items_independent():
    """A batched call equals per-item calls (batch is a grid dimension)."""
    rng = np.random.RandomState(21)
    f1 = jnp.asarray(rng.randn(3, 6, 9, 3), jnp.float32)
    f2 = jnp.asarray(rng.randn(3, 9, 12, 3), jnp.float32)
    both = matching.match_flow_fused(f1, f2, 4, 4, jnp.float32, True)
    for b in range(3):
        one = matching.match_flow_fused(f1[b], f2[b], 4, 4, jnp.float32, True)
        for a, c in zip(both, one):
            np.testing.assert_array_equal(np.asarray(a)[b], np.asarray(c))


@pytest.mark.parametrize("platform,ok", [("cuda", True), ("rocm", False)])
def test_fused_kernel_implementation_by_platform(platform, ok):
    """The one place the implementation is chosen: lowering for CUDA emits
    the Triton kernel; the CPU runs the interpreter (every test above); any
    other platform fails to lower instead of falling back."""
    shapes = (jax.ShapeDtypeStruct((2, 150, 290, 10), jnp.float32),
              jax.ShapeDtypeStruct((2, 165, 305, 10), jnp.float32))
    fn = jax.jit(lambda a, b: matching.match_flow_fused(
        a, b, 16, 16, jnp.float32, True))
    traced = fn.trace(*shapes)
    if ok:
        text = traced.lower(lowering_platforms=(platform,)).as_text()
        assert "xla.gpu.triton" in text
    else:
        with pytest.raises(Exception, match="platform"):
            traced.lower(lowering_platforms=(platform,))


@pytest.mark.gpu
def test_fused_kernel_on_gpu_matches_plain_form(gpu_env):
    """The compiled kernel on the card against the plain form at the car
    model's real widths (the chip_smoke.py matcher phase, at B=4)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import chip_smoke as cs\n"
            "from depth_estimation_tpu.models import io\n"
            "g, _, params, _ = io.load_model(cs.CAR_MODEL)\n"
            "print(cs.phase_matcher(g, params, 0, batch=4))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env=gpu_env, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
