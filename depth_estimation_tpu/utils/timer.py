"""Named-span timing — the Tic/Toc + torch.Timer equivalent.

The reference inserts nn.Tic/nn.Toc marker modules into model graphs and
keeps running per-stage averages in the streaming drivers
(/root/reference/opticalflow_model_multiscale.lua:178-180,
depth_estimation_opticalflow.lua:60-66,141-147). Here: a Timers registry of
named spans with running means; with ``sync_device`` a span ends only when
its device result is ready (``jax.block_until_ready``).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


def sync(x) -> None:
    """Wait until every device array in ``x`` is computed."""
    import jax
    jax.block_until_ready(x)


class Timers:
    def __init__(self, sync_device: bool = False):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.sync_device = sync_device

    @contextlib.contextmanager
    def span(self, name: str, result=None):
        t0 = time.perf_counter()
        holder = {}
        yield holder
        if self.sync_device and holder.get("out") is not None:
            sync(holder["out"])
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def tic(self, name: str) -> float:
        t = time.perf_counter()
        self._tics = getattr(self, "_tics", {})
        self._tics[name] = t
        return t

    def toc(self, name: str, out=None) -> float:
        if self.sync_device and out is not None:
            sync(out)
        dt = time.perf_counter() - self._tics[name]
        self.totals[name] += dt
        self.counts[name] += 1
        return dt

    def means(self) -> Dict[str, float]:
        return {k: self.totals[k] / max(self.counts[k], 1) for k in self.totals}

    def report(self) -> str:
        return " ".join(f"{k}={v * 1e3:.2f}ms" for k, v in
                        sorted(self.means().items()))


@contextlib.contextmanager
def profiled_span(name: str):
    """jax.profiler named span (the Tic/Toc markers' trace equivalent):
    shows up in TensorBoard/perfetto traces captured with
    jax.profiler.start_trace()."""
    import jax
    with jax.profiler.TraceAnnotation(name):
        yield


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """Capture a device profile into log_dir (view with tensorboard or
    perfetto)."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
