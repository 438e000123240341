"""End-to-end M1 slice: GT generation -> patch sampling -> SGD training ->
scoring -> checkpoint save/load. Mirrors the reference's trainer contract
(/root/reference/opticalflow.lua:267-363) at test scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from depth_estimation_tpu import codecs
from depth_estimation_tpu.data import groundtruth
from depth_estimation_tpu.geometry import Geometry, Learning
from depth_estimation_tpu.models import flow as flow_model
from depth_estimation_tpu.models import io as model_io
from depth_estimation_tpu.training import train as training


def tiny_geometry():
    return Geometry(
        hImg=48, wImg=56,
        layers=((3, 5, 5, 8),),
        maxh=6, maxw=6, maxhGT=6, maxwGT=6, hKernelGT=5, wKernelGT=5,
    )


def synthetic_sequence(g, n=3, seed=0):
    """Images where frame i+1 is frame i shifted by a known (dy, dx)."""
    rng = np.random.RandomState(seed)
    base = rng.rand(g.hImg + 20, g.wImg + 20, 3).astype(np.float32)
    shifts = [(1, -2), (2, 1)][: n - 1]
    images, flows = [], []
    oy, ox = 10, 10
    for k in range(n):
        images.append(base[oy:oy + g.hImg, ox:ox + g.wImg].copy())
        if k < n - 1:
            dy, dx = shifts[k]
            oy, ox = oy + dy, ox + dx
            f = np.zeros((2, g.hImg, g.wImg), np.float32)
            f[0] = dy
            f[1] = dx
            flows.append(f)
    return images, flows


def test_sgd_torch_lr_decay():
    tx = training.sgd_torch(1.0, learning_rate_decay=1.0)
    params = {"w": jnp.ones(3)}
    state = tx.init(params)
    g = {"w": jnp.ones(3)}
    up1, state = tx.update(g, state, params)
    up2, state = tx.update(g, state, params)
    up3, state = tx.update(g, state, params)
    np.testing.assert_allclose(np.asarray(up1["w"]), -1.0)       # lr/(1+0)
    np.testing.assert_allclose(np.asarray(up2["w"]), -0.5)       # lr/(1+1)
    np.testing.assert_allclose(np.asarray(up3["w"]), -1.0 / 3)   # lr/(1+2)


def test_patch_sampler_respects_window_and_targets():
    g = tiny_geometry()
    images, flows = synthetic_sequence(g)
    rng = np.random.RandomState(0)
    ds = training.sample_patches(g, Learning(), images, flows, None, 32, rng)
    assert len(ds) == 32
    assert ds.patches1.shape == (32, g.hPatch2, g.wPatch2, 3)
    for k in range(32):
        dy, dx = ds.targets_yx[k]
        assert -g.halfh1 <= dy <= g.halfh2
        assert int(ds.itargets[k]) == codecs.yx2x(g, int(dy), int(dx))


@pytest.mark.parametrize("criterion", ["nll", "mse", "soft"])
def test_training_improves(criterion):
    g = tiny_geometry()
    lrn = Learning(rate=2e-1 if criterion != "mse" else 5e-2,
                   rate_decay=0.0, n_epochs=3, criterion=criterion,
                   soft_targets=(criterion == "soft"), batch_size=16)
    images, flows = synthetic_sequence(g)
    rng = np.random.RandomState(1)
    ds = training.sample_patches(g, lrn, images, flows, None, 64, rng)

    model = flow_model.FlowModel(g)
    trainer = training.Trainer(model, lrn)
    state = trainer.init(jax.random.PRNGKey(0))

    state, m0 = trainer.epoch(state, ds, shuffle_rng=np.random.RandomState(2))
    first_loss = m0["loss"]
    for _ in range(4):
        state, m = trainer.epoch(state, ds, shuffle_rng=np.random.RandomState(2))
    assert m["loss"] < first_loss, (first_loss, m)
    assert m["acc"] >= m0["acc"] - 0.05


def test_checkpoint_roundtrip(tmp_path):
    g = tiny_geometry()
    lrn = Learning()
    model = flow_model.FlowModel(g)
    params = model.init(jax.random.PRNGKey(3))
    d = str(tmp_path / model_io.model_dir_name(g, lrn))
    model_io.save_model(d, g, lrn, params, score_history=[{"acc": 0.5}], epoch=2)
    g2, lrn2, params2, meta = model_io.load_model(d)
    assert g2 == g and lrn2 == lrn
    assert meta["epoch"] == 2
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(params2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # version check
    import json, os
    mp = os.path.join(d, "meta.json")
    meta_bad = json.load(open(mp)); meta_bad["version"] = 8
    json.dump(meta_bad, open(mp, "w"))
    with pytest.raises(ValueError):
        model_io.load_model(d)


def test_nan_guard_skips_update():
    g = tiny_geometry()
    lrn = Learning(rate=0.1, criterion="nll", batch_size=4)
    model = flow_model.FlowModel(g)
    trainer = training.Trainer(model, lrn)
    state = trainer.init(jax.random.PRNGKey(0))
    p1 = jnp.full((4, g.hPatch2, g.wPatch2, 3), jnp.nan)
    p2 = jnp.zeros((4, g.hPatch2, g.wPatch2, 3))
    it = jnp.zeros((4,), jnp.int32)
    st = jnp.zeros((4, g.maxh * g.maxw), jnp.float32)
    new_state, aux = trainer._step(state, p1, p2, it, st)
    assert not bool(aux["grad_ok"])
    for a, b in zip(jax.tree.leaves(state.params), jax.tree.leaves(new_state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_multiscale_fovea_training_improves():
    from depth_estimation_tpu.models.multiscale import MultiscaleFlowModel

    g = Geometry(
        hImg=72, wImg=80,
        layers=((3, 5, 5, 8),),
        maxh=4, maxw=4, maxhGT=8, maxwGT=8, hKernelGT=5, wKernelGT=5,
        multiscale=True, ratios=(1, 2),
    )
    lrn = Learning(rate=0.3, rate_decay=0.0, criterion="nll", batch_size=8)
    images, flows = synthetic_sequence(g, n=3, seed=4)
    rng = np.random.RandomState(5)
    ds = training.sample_foveas(g, lrn, _interleave(images, flows)[0],
                                _interleave(images, flows)[1], None, 32, rng)
    assert len(ds) == 32
    model = MultiscaleFlowModel(g)
    trainer = training.MultiscaleTrainer(model, lrn)
    state = trainer.init(jax.random.PRNGKey(0))
    state, m0 = trainer.epoch(state, ds, shuffle_rng=np.random.RandomState(6))
    for _ in range(3):
        state, m = trainer.epoch(state, ds,
                                 shuffle_rng=np.random.RandomState(6))
    assert m["loss"] < m0["loss"], (m0, m)


def _interleave(images, flows):
    seq_i, seq_f = [], []
    for k in range(len(flows)):
        seq_i.extend([images[k], images[k + 1]])
        seq_f.extend([flows[k], None])
    return seq_i, seq_f[:-1]


def test_backfill_scores_repairs_scoreless_checkpoints(tmp_path):
    """getLearningScores(..., fix_file) path: a checkpoint saved without a
    score history gets one recomputed and written back
    (/root/reference/score_opticalflow.lua:136-214)."""
    import json
    from depth_estimation_tpu.models import io as model_io
    from depth_estimation_tpu.models.flow import FlowModel
    from depth_estimation_tpu.training.curves import (backfill_scores,
                                                      get_learning_scores)

    g = tiny_geometry()
    images, flows = synthetic_sequence(g)
    rng = np.random.RandomState(0)
    ds = training.sample_patches(g, Learning(), images, flows, None, 16, rng)
    model = FlowModel(g)
    params = model.init(jax.random.PRNGKey(0))
    mdir = tmp_path / "models"
    model_io.save_model(str(mdir / "broken"), g, Learning(), params,
                        score_history=None, epoch=3)
    assert get_learning_scores(str(mdir)) == {}
    fixed = backfill_scores(str(mdir), ds, images, flows)
    assert fixed == ["broken"]
    meta = json.load(open(mdir / "broken" / "meta.json"))
    assert len(meta["score"]) == 1
    s = meta["score"][0]
    assert s["backfilled"] and s["epoch"] == 3
    assert 0.0 <= s["test_acc"] <= 1.0 and np.isfinite(s["test_err"])
    # second run is a no-op
    assert backfill_scores(str(mdir), ds, images, flows) == []


def test_score_epoch_full_eval_scores_the_gt_pairing():
    """score_epoch's full-image eval must run on the (im1, im2) pair each
    GT field belongs to. Regression: the flow trainer passed consecutive
    CURRENT frames while the GT mapped (warped prev -> current) — an
    identity-filter model that is exact on its own pairing read ~0 full
    accuracy (see score_epoch docstring)."""
    from depth_estimation_tpu.models.filters import identity_filter_params
    from depth_estimation_tpu.training.curves import score_epoch

    g = Geometry(hImg=48, wImg=56, layers=((1, 5, 5, 25),),
                 maxh=6, maxw=6, maxhGT=6, maxwGT=6,
                 hKernelGT=5, wKernelGT=5)
    rng = np.random.RandomState(3)
    base = rng.rand(g.hImg + 12, g.wImg + 12, 1).astype(np.float32)
    dy, dx = 1, -2
    im1 = base[6:6 + g.hImg, 6:6 + g.wImg].copy()
    # im1's patch at p reappears in im2 at p + (dy, dx): crop im2's window
    # shifted the OPPOSITE way in source coordinates
    im2 = base[6 - dy:6 - dy + g.hImg, 6 - dx:6 - dx + g.wImg].copy()
    f = np.zeros((2, g.hImg, g.wImg), np.float32)
    f[0], f[1] = dy, dx
    ds = training.sample_patches(g, Learning(), [im1, im2], [f], None, 8,
                                 np.random.RandomState(0))
    model = flow_model.FlowModel(g)
    params = identity_filter_params(g)
    s = score_epoch(model, params, g, Learning(), ds, [(im1, im2)], [f])
    assert s["full_acc"] == 1.0, s
    assert s["full_meandst"] == 0.0, s
    # the buggy pairing (a frame matched against itself here) must NOT
    # score as if it solved the GT pair
    s_bad = score_epoch(model, params, g, Learning(), ds, [(im2, im2)], [f])
    assert s_bad["full_acc"] < 0.5, s_bad


def test_device_cache_uploads_once_per_dataset():
    """Epoch loops must not re-upload an unchanged dataset
    (utils/device_cache.py). Identity-keyed one-slot cache:
    same host objects -> same device buffers; new objects -> re-upload."""
    from depth_estimation_tpu.utils.device_cache import DeviceCache

    cache = DeviceCache()
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    b = np.arange(3, dtype=np.int32)
    da1, db1 = cache.get(a, b)
    da2, db2 = cache.get(a, b)
    assert da1 is da2 and db1 is db2          # cache hit: no new upload
    np.testing.assert_array_equal(np.asarray(da1), a)

    a_new = a + 1.0                           # renewed dataset: must re-upload
    da3, db3 = cache.get(a_new, b)
    assert da3 is not da1
    np.testing.assert_array_equal(np.asarray(da3), a_new)

    # None entries pass through and participate in the key
    dn, = cache.get(None)
    assert dn is None

    # arity change is a miss, not an error
    (da4,) = cache.get(a)
    np.testing.assert_array_equal(np.asarray(da4), a)


def test_multiscale_soft_targets_training_improves():
    """-st for the multiscale fovea trainer: DistNLL over the concatenated
    multiscale index space, Gaussian placed at each index's decoded offset
    (prepareTarget's soft branch lifted to the codec — see
    MultiscaleTrainer docstring for why the reference's own clamped
    multiscale+soft path is not the semantics to copy)."""
    from depth_estimation_tpu.models.multiscale import MultiscaleFlowModel

    g = Geometry(
        hImg=72, wImg=80,
        layers=((3, 5, 5, 8),),
        maxh=4, maxw=4, maxhGT=8, maxwGT=8, hKernelGT=5, wKernelGT=5,
        multiscale=True, ratios=(1, 2),
    )
    lrn = Learning(rate=0.3, rate_decay=0.0, criterion="soft",
                   soft_targets=True, st_sigma2=1.0, batch_size=8)
    images, flows = synthetic_sequence(g, n=3, seed=4)
    rng = np.random.RandomState(5)
    ds = training.sample_foveas(g, lrn, _interleave(images, flows)[0],
                                _interleave(images, flows)[1], None, 32, rng)
    model = MultiscaleFlowModel(g)
    trainer = training.MultiscaleTrainer(model, lrn)
    state = trainer.init(jax.random.PRNGKey(0))
    state, m0 = trainer.epoch(state, ds, shuffle_rng=np.random.RandomState(6))
    for _ in range(3):
        state, m = trainer.epoch(state, ds,
                                 shuffle_rng=np.random.RandomState(6))
    assert m["loss"] < m0["loss"], (m0, m)
    assert m["acc"] >= m0["acc"] - 0.1
