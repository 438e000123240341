"""Identity-keyed host->device upload cache.

Why this exists: a training loop that re-uploads an unchanged dataset
every epoch moves O(epochs x dataset bytes) over the host link for
nothing. Upload the dataset ONCE, keep the device buffers, and gather
per-batch selections ON DEVICE with a tiny index vector instead of
uploading ``data[sel]`` every step. ``DeviceCache`` is the one-slot
helper that makes the "once" part safe across epoch calls: it returns the
same device arrays while the caller passes the identical host arrays
(identity keys, with strong references held so ids cannot be recycled),
and re-uploads when the data actually changes (per-epoch renewal regimes
miss the cache by design — fresh data must move once, which is the
unavoidable minimum).
"""

from __future__ import annotations

import jax.numpy as jnp


class DeviceCache:
    """One-slot upload cache: ``get(a, b, ...) -> (a_dev, b_dev, ...)``.

    Passing the same host array objects returns the previously uploaded
    device arrays; passing anything else (different objects, different
    count) re-uploads everything. ``None`` entries pass through as
    ``None`` (and participate in the identity key).
    """

    def __init__(self):
        self._src = None   # strong refs keep ids valid while cached
        self._dev = None

    def get(self, *arrays):
        if self._src is None or len(arrays) != len(self._src) or any(
                a is not b for a, b in zip(arrays, self._src)):
            self._dev = tuple(None if a is None else jnp.asarray(a)
                              for a in arrays)
            self._src = arrays
        return self._dev
