"""Training: Torch-semantics SGD, criteria, patch sampler, epoch loop.

Rebuilds the trainer core of /root/reference/opticalflow.lua:267-363 as a
jitted batched train step (the reference runs batch-1 SGD on a 2012 CPU;
here patches are batched — mathematically the same objective, far better
device utilization). The per-step learning rate follows torch optim.sgd exactly:
``lr_t = lr / (1 + nevals * learningRateDecay)`` with weight decay folded
into the gradient.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterator, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .. import codecs
from ..geometry import Geometry, Learning
from ..models import flow as flow_model
from ..utils.device_cache import DeviceCache


# ---------------------------------------------------------------------------
# torch optim.sgd semantics as an optax transformation
# ---------------------------------------------------------------------------

def sgd_torch(learning_rate: float, learning_rate_decay: float = 0.0,
              weight_decay: float = 0.0) -> optax.GradientTransformation:
    """lr_t = lr / (1 + t * decay); grad += wd * param. Mirrors the exact
    update the reference relies on (optim.sgd with learningRateDecay,
    /root/reference/opticalflow.lua:221-225,338)."""

    def init_fn(params):
        return {"count": jnp.zeros([], jnp.int32)}

    def update_fn(updates, state, params=None):
        count = state["count"]
        lr = learning_rate / (1.0 + count.astype(jnp.float32) * learning_rate_decay)
        if weight_decay:
            updates = jax.tree.map(lambda g, p: g + weight_decay * p,
                                   updates, params)
        updates = jax.tree.map(lambda g: -lr * g, updates)
        return updates, {"count": count + 1}

    return optax.GradientTransformation(init_fn, update_fn)


# ---------------------------------------------------------------------------
# Criteria
# ---------------------------------------------------------------------------

def make_loss_fn(model: flow_model.FlowModel, learning: Learning):
    """Returns loss(params, patch1 (B,h,w,c), patch2, itarget (B,), soft (B,D))
    -> (scalar loss, aux dict). Criterion selection mirrors
    /root/reference/opticalflow.lua:237-246."""
    g = model.geometry

    def nll(params, p1, p2, itarget, soft_t):
        logp = jax.vmap(lambda a, b: model.log_scores(params, a, b))(p1, p2)
        logp = logp.reshape(logp.shape[0], -1)          # patches -> (B, D)
        ll = jnp.take_along_axis(logp, itarget[:, None], axis=-1)[:, 0]
        loss = -jnp.mean(ll)
        pred = jnp.argmax(logp, axis=-1)
        return loss, {"acc": jnp.mean((pred == itarget).astype(jnp.float32))}

    def soft(params, p1, p2, itarget, soft_t):
        logp = jax.vmap(lambda a, b: model.log_scores(params, a, b))(p1, p2)
        logp = logp.reshape(logp.shape[0], -1)
        t = soft_t / jnp.clip(soft_t.sum(-1, keepdims=True), 1e-8)
        loss = -jnp.mean(jnp.sum(t * logp, axis=-1))
        pred = jnp.argmax(logp, axis=-1)
        return loss, {"acc": jnp.mean((pred == itarget).astype(jnp.float32))}

    def mse(params, p1, p2, itarget, soft_t):
        dist = jax.vmap(lambda a, b: model.scores(params, a, b))(p1, p2)
        dist = dist.reshape(dist.shape[0], -1)
        ey, ex = flow_model.soft_argmax(g, dist)
        off = codecs.window_offsets(g).astype(jnp.float32)
        ty = off[itarget, 0]
        tx = off[itarget, 1]
        loss = jnp.mean((ey - ty) ** 2 + (ex - tx) ** 2)
        good = ((ey - ty) ** 2 + (ex - tx) ** 2) < 1.0
        return loss, {"acc": jnp.mean(good.astype(jnp.float32))}

    return {"nll": nll, "soft": soft, "mse": mse}[learning.criterion]


# ---------------------------------------------------------------------------
# Patch sampler (generateDataOpticalFlowCCLiu port)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PatchDataset:
    """Sampled training patches with encoded targets. Patch geometry follows
    /root/reference/groundtruth_opticalflow.lua:483-567: the patch center is
    offset by ceil(maxhGT/2) + ceil(hKernelGT/2) - 2 + 1 from the crop corner,
    and samples whose GT flow falls outside the search window (or whose mask
    fails at the kernel corners) are rejected."""
    patches1: np.ndarray   # (N, hPatch2, wPatch2, C)
    patches2: np.ndarray
    targets_yx: np.ndarray  # (N, 2) raw GT displacement
    itargets: np.ndarray    # (N,) encoded flat window index

    def __len__(self):
        return len(self.itargets)


def _host_arrays(xs: Optional[list]) -> Optional[list]:
    """Materialize a list of (possibly device-resident) arrays on host.
    The samplers scalar-index flows/masks thousands of times in their
    rejection loops; every scalar read of a device array is a device->host
    transfer, so they read host copies."""
    if xs is None:
        return None
    return [None if x is None else np.asarray(x) for x in xs]


def sample_patches(
    geom: Geometry, learning: Learning,
    images: list, flows: list, masks: Optional[list],
    n_samples: int, rng: np.random.RandomState,
) -> PatchDataset:
    """images: list of (H, W, C); flows[i] = (2, H, W) GT flow from images[i]
    to images[i+1]; masks[i] optional validity mask."""
    images = _host_arrays(images)
    flows = _host_arrays(flows)
    masks = _host_arrays(masks)
    hoff = -(-geom.maxhGT // 2) + -(-geom.hKernelGT // 2) - 1
    woff = -(-geom.maxwGT // 2) + -(-geom.wKernelGT // 2) - 1
    if geom.multiscale:
        import math
        mh, mw = geom.maxh * geom.rmax, geom.maxw * geom.rmax
        lo_h, hi_h = -math.ceil(mh / 2) + 1, mh // 2
        lo_w, hi_w = -math.ceil(mw / 2) + 1, mw // 2
    else:
        lo_h, hi_h = -geom.halfh1, geom.halfh2
        lo_w, hi_w = -geom.halfw1, geom.halfw2

    p1, p2, tyx, its = [], [], [], []
    hP, wP = geom.hPatch2, geom.wPatch2
    hk = -(-geom.hKernel // 2)
    wk = -(-geom.wKernel // 2)
    tries = 0
    while len(its) < n_samples and tries < n_samples * 200:
        tries += 1
        i = rng.randint(0, len(flows))
        if flows[i] is None:
            continue
        y0 = rng.randint(0, geom.hImg - geom.maxhGT - geom.hKernelGT - 1)
        x0 = rng.randint(0, geom.wImg - geom.maxwGT - geom.wKernelGT - 1)
        yc, xc = y0 + hoff, x0 + woff
        fy = flows[i][0][yc, xc]
        fx = flows[i][1][yc, xc]
        if not (lo_h <= fy <= hi_h and lo_w <= fx <= hi_w):
            continue
        if masks is not None and masks[i] is not None:
            m = masks[i]
            if not (m[yc - hk, xc - wk] > 0.5 and m[yc + hk, xc - wk] > 0.5
                    and m[yc + hk, xc + wk] > 0.5 and m[yc - hk, xc + wk] > 0.5):
                continue
        p1.append(images[i][y0:y0 + hP, x0:x0 + wP])
        p2.append(images[i + 1][y0:y0 + hP, x0:x0 + wP])
        tyx.append((fy, fx))
        its.append(int(codecs.encode_np(geom, fy, fx)))
    return PatchDataset(
        np.stack(p1).astype(np.float32), np.stack(p2).astype(np.float32),
        np.asarray(tyx, np.float32), np.asarray(its, np.int32),
    )


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Foveated (multiscale) patch sampling + trainer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FoveaDataset:
    """Fovea training samples: full image pairs + per-sample fovea centers
    (the getElemFovea contract, /root/reference/groundtruth_opticalflow.lua:515-519):
    the model crops its own per-scale patches around (y, x)."""
    images1: np.ndarray   # (N_img, H, W, C) stacked (warped prev frames)
    images2: np.ndarray   # (N_img, H, W, C) stacked (current frames)
    img_idx: np.ndarray   # (N,) int32 into the stacks
    ys: np.ndarray        # (N,) int32 fovea rows
    xs: np.ndarray        # (N,) int32 fovea cols
    targets_yx: np.ndarray
    itargets: np.ndarray
    # coarsest-footprint crops materialized at sampler time — the trainer
    # consumes these (static-shape batch, MultiscaleFlowModel
    # .forward_fovea_batch) instead of dynamic-slicing full frames on device
    crops1: np.ndarray = None   # (N, rmax*hPatch2, rmax*wPatch2, C)
    crops2: np.ndarray = None

    def __len__(self):
        return len(self.itargets)


def sample_foveas(
    geom: Geometry, learning: Learning,
    images: list, flows: list, masks: Optional[list],
    n_samples: int, rng: np.random.RandomState,
) -> FoveaDataset:
    """Multiscale sampler: like sample_patches but keeps full frames and
    fovea coordinates; rejects foveas whose coarsest-scale crop leaves the
    frame or whose GT is outside the high-res window."""
    import math
    images = _host_arrays(images)
    flows = _host_arrays(flows)
    masks = _host_arrays(masks)
    assert geom.multiscale
    mh, mw = geom.maxh * geom.rmax, geom.maxw * geom.rmax
    lo_h, hi_h = -math.ceil(mh / 2) + 1, mh // 2
    lo_w, hi_w = -math.ceil(mw / 2) + 1, mw // 2
    Hc, Wc = geom.rmax * geom.hPatch2, geom.rmax * geom.wPatch2
    y_lo = math.ceil(Hc / 2) - 1
    x_lo = math.ceil(Wc / 2) - 1
    H, W = geom.hImg, geom.wImg

    i1, i2, iy, ix, tyx, its = [], [], [], [], [], []
    img_map = {}
    tries = 0
    while len(its) < n_samples and tries < n_samples * 300:
        tries += 1
        k = rng.randint(0, len(flows))
        if flows[k] is None:
            continue
        yc = rng.randint(y_lo, H - (Hc - y_lo))
        xc = rng.randint(x_lo, W - (Wc - x_lo))
        fy = flows[k][0][yc, xc]
        fx = flows[k][1][yc, xc]
        if not (lo_h <= fy <= hi_h and lo_w <= fx <= hi_w):
            continue
        if masks is not None and masks[k] is not None:
            if masks[k][yc, xc] < 0.5:
                continue
        if k not in img_map:
            img_map[k] = len(img_map)
        i1.append(img_map[k])
        iy.append(yc)
        ix.append(xc)
        tyx.append((fy, fx))
        its.append(int(codecs.encode_np(geom, fy, fx)))
    order = sorted(img_map, key=img_map.get)
    stack1 = np.stack([images[k] for k in order]).astype(np.float32)
    stack2 = np.stack([images[k + 1] for k in order]).astype(np.float32)
    i1a = np.asarray(i1, np.int32)
    iya = np.asarray(iy, np.int32)
    ixa = np.asarray(ix, np.int32)
    # materialize the coarsest-footprint crop per sample (same pixels
    # forward_fovea dynamic-slices; static-shape batch for the trainer)
    c1 = np.empty((len(i1a), Hc, Wc, stack1.shape[-1]), np.float32)
    c2 = np.empty_like(c1)
    for s in range(len(i1a)):
        y0 = iya[s] - y_lo
        x0 = ixa[s] - x_lo
        c1[s] = stack1[i1a[s], y0:y0 + Hc, x0:x0 + Wc]
        c2[s] = stack2[i1a[s], y0:y0 + Hc, x0:x0 + Wc]
    return FoveaDataset(
        stack1, stack2, i1a, iya, ixa,
        np.asarray(tyx, np.float32), np.asarray(its, np.int32),
        crops1=c1, crops2=c2,
    )


class MultiscaleTrainer:
    """NLL trainer over the foveated multiscale model (the -ms path of
    /root/reference/opticalflow.lua:284-336). With learning.soft_targets
    the criterion is the DistNLL port over the multiscale index space: a
    Gaussian exp(-d^2/sigma^2) placed at each index's DECODED centered
    displacement (codecs.window_offsets), normalized per sample — the
    principled lift of prepareTarget's soft branch
    (/root/reference/opticalflow_model.lua:298-315) to the concatenated
    multiscale codec. (The reference's own multiscale+soft path clamps
    targets to the PER-SCALE window [-1..2] — maxh is the coarsest-scale
    window there (prepareTarget:279-290) — which discards nearly every
    fovea target; that is its pathology, not a semantics worth porting.)"""

    def __init__(self, model, learning: Learning):
        self.model = model
        self.learning = learning
        self.tx = sgd_torch(learning.rate, learning.rate_decay,
                            learning.weight_decay)

        def loss_fn(params, crops1, crops2, itarget, soft_t):
            # static-shape batched forward over pre-cropped footprints:
            # dense conv/matmul work, no vmap of dynamic slices
            logp = model.forward_fovea_batch(params, crops1, crops2)
            if learning.soft_targets:
                t = soft_t / jnp.clip(soft_t.sum(-1, keepdims=True), 1e-8)
                loss = -jnp.mean(jnp.sum(t * logp, axis=-1))
            else:
                ll = jnp.take_along_axis(logp, itarget[:, None],
                                         axis=-1)[:, 0]
                loss = -jnp.mean(ll)
            pred = jnp.argmax(logp, axis=-1)
            return loss, {
                "acc": jnp.mean((pred == itarget).astype(jnp.float32))}

        def step(state, crops1, crops2, itarget, soft_t):
            (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                state.params, crops1, crops2, itarget, soft_t)
            gsum = sum(jnp.sum(x) for x in jax.tree.leaves(grads))
            ok = jnp.isfinite(gsum)
            grads = jax.tree.map(lambda x: jnp.where(ok, x, 0.0), grads)
            updates, opt_state = self.tx.update(grads, state.opt_state,
                                                state.params)
            params = optax.apply_updates(state.params, updates)
            return TrainState(params, opt_state, state.step + 1), dict(
                aux, loss=loss, grad_ok=ok)

        self._step_fn = step
        self._step = jax.jit(step)
        self._mesh_n = 1
        # dataset uploads are cached across epoch() calls: an unchanged
        # dataset moves to the device once (utils/device_cache.py)
        self._uploads = DeviceCache()

    def use_mesh(self, mesh, axis: str = "dp"):
        """Engage a device mesh: re-jit the step with the fovea batch split
        on ``dp`` and params/opt state replicated (parallel/mesh.py). The
        CLI's --dp flag lands here."""
        from ..parallel import mesh as pm
        self._step = pm.sharded_train_step(self, mesh, axis, n_batch=4)
        self._mesh_n = mesh.devices.size

    def init(self, rng):
        params = self.model.init(rng)
        return TrainState(params, self.tx.init(params),
                          jnp.zeros([], jnp.int32))

    def epoch(self, state, ds: FoveaDataset, batch_size: Optional[int] = None,
              shuffle_rng=None):
        bs = batch_size or self.learning.batch_size
        if bs % self._mesh_n:
            raise SystemExit(
                f"batch size {bs} is not divisible by the {self._mesh_n}-"
                f"device dp mesh — pick -bs a multiple of {self._mesh_n}")
        n = (len(ds) // bs) * bs
        order = np.arange(n)
        if shuffle_rng is not None:
            shuffle_rng.shuffle(order)
        assert ds.crops1 is not None, \
            "FoveaDataset without materialized crops (rebuild via sample_foveas)"
        g = self.model.geometry
        D = codecs.n_indices(g)
        crops1, crops2, itargets, targets_yx = self._uploads.get(
            ds.crops1, ds.crops2, ds.itargets, ds.targets_yx)
        losses, accs = [], []
        for b in range(0, n, bs):
            sel = order[b:b + bs]
            if self.learning.soft_targets:
                _, soft_t = flow_model.prepare_target(
                    g, self.learning, targets_yx[sel])
            else:
                soft_t = jnp.zeros((bs, D), jnp.float32)
            state, aux = self._step(
                state, crops1[sel], crops2[sel], itargets[sel], soft_t)
            losses.append(aux["loss"])
            accs.append(aux["acc"])
        # ONE device->host fetch per epoch, not a scalar fetch per step
        losses = [float(x) for x in jax.device_get(losses)]
        accs = [float(x) for x in jax.device_get(accs)]
        return state, {"loss": float(np.mean(losses)),
                       "acc": float(np.mean(accs))}


class TrainState(NamedTuple):
    params: dict
    opt_state: dict
    step: jnp.ndarray


class Trainer:
    def __init__(self, model: flow_model.FlowModel, learning: Learning):
        self.model = model
        self.learning = learning
        self.tx = sgd_torch(learning.rate, learning.rate_decay,
                            learning.weight_decay)
        self.loss_fn = make_loss_fn(model, learning)

        def step(state: TrainState, p1, p2, itarget, soft_t):
            (loss, aux), grads = jax.value_and_grad(self.loss_fn, has_aux=True)(
                state.params, p1, p2, itarget, soft_t)
            # NaN guard: skip the update on non-finite grads (reference
            # aborts, /root/reference/opticalflow.lua:332-334 — we skip, which
            # is the production-sane variant, and report it in aux).
            gsum = sum(jnp.sum(x) for x in jax.tree.leaves(grads))
            ok = jnp.isfinite(gsum)
            grads = jax.tree.map(lambda x: jnp.where(ok, x, 0.0), grads)
            updates, opt_state = self.tx.update(grads, state.opt_state,
                                                state.params)
            params = optax.apply_updates(state.params, updates)
            aux = dict(aux, loss=loss, grad_ok=ok)
            return TrainState(params, opt_state, state.step + 1), aux

        self._step_fn = step          # unjitted (for sharded re-jit)
        self._step = jax.jit(step)
        self._mesh_n = 1
        self._uploads = DeviceCache()  # see MultiscaleTrainer / device_cache.py

    def use_mesh(self, mesh, axis: str = "dp"):
        """Engage a device mesh: re-jit the step with the patch batch split
        on ``dp`` and params/opt state replicated (parallel/mesh.py) — XLA
        inserts the gradient all-reduce. The CLI's --dp flag lands here."""
        from ..parallel import mesh as pm
        self._step = pm.sharded_train_step(self, mesh, axis, n_batch=4)
        self._mesh_n = mesh.devices.size

    def init(self, rng) -> TrainState:
        params = self.model.init(rng)
        return TrainState(params, self.tx.init(params), jnp.zeros([], jnp.int32))

    def epoch(self, state: TrainState, ds: PatchDataset,
              batch_size: Optional[int] = None, shuffle_rng=None):
        bs = batch_size or self.learning.batch_size
        if bs % self._mesh_n:
            raise SystemExit(
                f"batch size {bs} is not divisible by the {self._mesh_n}-"
                f"device dp mesh — pick -bs a multiple of {self._mesh_n}")
        n = (len(ds) // bs) * bs
        order = np.arange(n)
        if shuffle_rng is not None:
            shuffle_rng.shuffle(order)
        g = self.model.geometry
        D = codecs.n_indices(g)
        # one upload per dataset (cached across epochs), on-device gathers
        # per batch instead of uploading data[sel] every step
        patches1, patches2, itargets, targets_yx = self._uploads.get(
            ds.patches1, ds.patches2, ds.itargets, ds.targets_yx)
        losses, accs = [], []
        for b in range(0, n, bs):
            sel = order[b:b + bs]
            if self.learning.soft_targets:
                _, soft_t = flow_model.prepare_target(
                    g, self.learning, targets_yx[sel])
            else:
                soft_t = jnp.zeros((bs, D), jnp.float32)
            state, aux = self._step(
                state, patches1[sel], patches2[sel], itargets[sel], soft_t,
            )
            losses.append(aux["loss"])
            accs.append(aux["acc"])
        # ONE device->host fetch per epoch (see MultiscaleTrainer.epoch)
        losses = [float(x) for x in jax.device_get(losses)]
        accs = [float(x) for x in jax.device_get(accs)]
        return state, {"loss": float(np.mean(losses)),
                       "acc": float(np.mean(accs))}
