"""Banded (gather-free) rotation-compensation warp: contract tests of
geometry3d/undistort.remove_ego_motion_banded against the 4-tap gather
(remove_ego_motion_batched) and the band-validity mask."""

import numpy as np
import jax.numpy as jnp

from depth_estimation_tpu.geometry3d import undistort as undist
from depth_estimation_tpu.geometry3d.calibration import ARDRONE


def _setup(B=2, H=48, W=64, C=3, seed=0, angles=(0.013, -0.021)):
    rng = np.random.RandomState(seed)
    imgs = jnp.asarray(rng.rand(B, H, W, C).astype(np.float32))
    Ks = ARDRONE.K.copy()
    Ks[0] *= W / ARDRONE.wImg
    Ks[1] *= H / ARDRONE.hImg
    R = jnp.asarray(np.stack([
        np.array([[np.cos(a), -np.sin(a), 0.01 * a],
                  [np.sin(a), np.cos(a), 0.0],
                  [0.0, 0.0, 1.0]], np.float32) for a in angles[:B]]))
    return imgs, Ks, R, H, W


def test_banded_warp_matches_gather_in_band():
    """Inside the band the banded shift-sum IS the 4-tap bilinear gather."""
    imgs, Ks, R, H, W = _setup(seed=3)
    band = 8
    gathered = undist.remove_ego_motion_batched(imgs, Ks, R)
    got = undist.remove_ego_motion_banded(imgs, Ks, R, band)
    ok = np.asarray(undist.ego_motion_valid_mask(Ks, R, H, W, band=band))
    m = np.broadcast_to(ok[..., None] > 0.5, got.shape)
    d = np.abs(np.asarray(got) - np.asarray(gathered))
    assert m.mean() > 0.5
    assert d[m].max() < 1e-4


def test_banded_warp_zero_outside_band_mask():
    """Pixels the band-validity mask drops (displacement beyond ``band`` or
    out of frame) are exactly zero, for a rotation large enough that some
    in-frame pixels fall outside a small band."""
    imgs, Ks, R, H, W = _setup(seed=5, angles=(0.08, -0.1))
    band = 2
    got = np.asarray(undist.remove_ego_motion_banded(imgs, Ks, R, band))
    ok = np.asarray(undist.ego_motion_valid_mask(Ks, R, H, W, band=band))
    full = np.asarray(undist.ego_motion_valid_mask(Ks, R, H, W))
    assert ((full > 0.5) & (ok < 0.5)).any()   # the band really cuts
    assert np.all(got[ok < 0.5] == 0.0)


def test_banded_warp_items_independent():
    """Each batch item is warped by its own rotation: the batched call
    equals per-item calls."""
    imgs, Ks, R, H, W = _setup(seed=7)
    both = np.asarray(undist.remove_ego_motion_banded(imgs, Ks, R, 6))
    for b in range(2):
        one = np.asarray(undist.remove_ego_motion_banded(
            imgs[b:b + 1], Ks, R[b:b + 1], 6))
        np.testing.assert_allclose(both[b], one[0], atol=1e-6)


def test_banded_warp_bf16_storage_close_to_f32():
    """bf16 storage of the shifted reads changes values only by the bf16
    rounding of the image (weights and accumulation stay f32)."""
    imgs, Ks, R, H, W = _setup(seed=9)
    f32 = np.asarray(undist.remove_ego_motion_banded(imgs, Ks, R, 6))
    b16 = undist.remove_ego_motion_banded(imgs, Ks, R, 6, jnp.bfloat16)
    assert b16.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(b16), f32, atol=1e-2)
