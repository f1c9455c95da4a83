"""Spans and counters of the port's layers.

`span(name)` marks a layer boundary: a ``torch.profiler.record_function``
range while a torch profiler runs, so the range lands in the profiler's
trace beside the device work it launched, on the same clock.  With no
profiler running it returns a shared no-op after one flag test (entering
``record_function`` itself costs about 12 us on the host even then).
There is no switch: tracing is on exactly while a profiler runs.  Every
span name starts with ``lpe.``.

`count(name, n)` adds to `counters`, a plain dict that always counts;
`reset()` clears it.  Each counter is bumped where the host already knows
the value, so none adds a device sync.

Spans (parent first; a child nests inside its parent on the calling
thread):

  lpe.batch                   one BatchedMatcher / MultiClassBatchedMatcher step
    lpe.entry.h2d             the frames' copy to the device
    lpe.entry.condition       raw camera frames conditioned on the device
                              (mono -> 3 channels, blur, crop)
    lpe.preprocess            K1, pyrDown, K2 x4, DepthNormal
      lpe.preprocess.depth_normal   DepthNormal's quantization and median
    lpe.pool                  the pooled matcher
      lpe.pool.coarse         the group and cell bounds, the coarse pool
      lpe.sync                each flag read on the host (``.item()``)
      lpe.pool.fine           the g x g bound to the fine compaction
      lpe.pool.exact          the exact pooled GEMM and the selects
        lpe.pool.select       the selects: each frame's pool rows gathered
                              once, one select a class over its own columns
      lpe.pool.fallback       the exhaustive scores and their selects
        lpe.pool.fallback.select  the selects (TK on a card)
    lpe.merge                 the merged matcher: its classes' candidates in one sorted list
    lpe.walk                  walk plan, K3, argmax
    lpe.split                 the merged matcher: the walked matches per class, re-gated
  lpe.train                   one train_from_stl call
    lpe.trainer.dispatch      queueing a chunk's render and quantizations
    lpe.trainer.wait          waiting for a chunk on the host
    lpe.trainer.extract       the host's extraction of a chunk
      lpe.extract.grad        one level's gradient features
      lpe.extract.norm        one level's normal features (with the EDT)

Counters:

  batch                 steps through a pooled matcher
  sync                  host syncs of the matchers on a card: flag reads,
                        the frames' copies to the card and host numbers
                        copied to it (each waits for the stream)
  pool.coarse_overflow  the coarse pool overflowed
  pool.fine_overflow    the fine pool overflowed
  pool.select_overflow  a select range overflowed, the coarse pool did not
  pool.coarse_total     the coarse pool's true survivors, summed over steps
  pool.coarse_slots     the coarse pool's slots, summed over steps (read
                        in the coarse flag's transfer: the fill costs no sync)
  pool.fine_total       the fine pool's true survivors, summed over the steps
                        whose fine stage ran
  pool.fine_slots       the fine pool's slots, summed over the same steps
                        (read in the fine flag's transfer: no sync of its own)
  condition.frames      frames conditioned on the device
  multiclass.batch      steps through MultiClassBatchedMatcher
  multiclass.classes    its per-class selects: one a class a step
  extract.views         views that reach templates.extract_template
  extract.candidates    candidates that enter the scattered selection
  launch.<kernel>       launches of each hand-written kernel
"""

from __future__ import annotations

import time

import torch
import torch.autograd.profiler as _profiler

counters: dict[str, int] = {}

# The hand-written kernels, each counted as `launch.<kernel>` by its wrapper.
KERNELS = ("quantize_cg", "spread_response", "walk_scores", "raster_zbuffer", "refine_scores",
           "depth_normal", "exact_scores", "select_topk", "bound_margins")


class _Off:
    """The span of an untraced run: enters and leaves at no cost."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A context manager: a record_function range called `name` while a
    torch profiler runs, else a no-op."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


class timed:
    """`span(name)` that also adds its host seconds to `sums[key]`."""

    __slots__ = ("name", "sums", "key", "_span", "_t0")

    def __init__(self, name: str, sums: dict, key: str):
        self.name, self.sums, self.key = name, sums, key

    def __enter__(self):
        self._span = span(self.name)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.sums[self.key] += time.perf_counter() - self._t0
        return self._span.__exit__(*exc)


def count(name: str, n: int = 1) -> None:
    counters[name] = counters.get(name, 0) + n


def reset() -> None:
    counters.clear()


def launches() -> dict[str, int]:
    """The `launch.<kernel>` counters of every hand-written kernel, by
    kernel name (0 for one that was not launched)."""
    return {k: counters.get(f"launch.{k}", 0) for k in KERNELS}
