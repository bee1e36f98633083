"""Spans of the program on the profiler's clock.

``span(name)`` marks a block of host code as a ``torch.profiler`` range
while a profiler session runs (``engine/profiler.device_trace``, or any
``torch.profiler.profile``): the range lands in the session's Chrome trace
as a ``user_annotation``, on the clock of the device's kernels, so a trace
says which span launched each kernel and which span the host was in while
the device sat idle.  With no session running, a span is one check of the
profiler's flag (tens of ns): no ``record_function``, no allocation, no
CUDA call.  There is no other switch.

The spans (PERF.md §3 lists them with what reads each):

* ``models/mvsnet.MVSNet.forward``: ``mvsnet.forward``; ``mvsnet.feature``;
  per stage k = 1..3 ``mvsnet.s{k}.sample`` and, per pass p = ``main`` /
  ``refine``, ``mvsnet.s{k}.{p}.cost``, ``mvsnet.s{k}.{p}.costreg`` and
  ``mvsnet.s{k}.{p}.head``.  Under ``agg_mode="adaptive"`` each source
  view's gate (the weight net, the sigmoid and the product) is a span
  ``mvsnet.s{k}.{p}.gate`` inside the pass's ``cost`` span, V - 1 of them
  a pass (``models/mvsnet.MVSNet._gate``).  Under
  remat the recomputed feature net, cost passes and cost U-Nets open their
  spans again inside the backward;
* ``models/transmvsnet.TransMVSNet.forward``: ``mvsnet.forward``;
  ``mvsnet.feature``, holding ``mvsnet.arf.s{k}`` around each of the three
  ARF heads (k = 1..3); ``mvsnet.fmt`` (the position encoding, the eight
  transformer layers and the pathway); per stage k ``mvsnet.s{k}.sample``,
  ``mvsnet.s{k}.main.cost`` (the pair passes and the weighted view sum;
  at stage 1 it holds one ``mvsnet.s1.main.view_weight`` per source view,
  the pixel-wise view-weight net), ``mvsnet.s{k}.main.costreg`` and
  ``mvsnet.s{k}.main.head``.  No name ends in ``.gate``;
* ``engine/steps`` train step: ``train.step`` around ``train.forward``,
  ``train.loss``, ``train.backward``, ``train.metrics`` and
  ``train.optimizer``;
* ``parallel/mesh.shard_batch``: ``train.h2d``;
* ``engine/train.Trainer.train``: ``train.load``, each fetch of a batch
  from the loader.

Counters beside the spans, printed on ``engine/profiler``'s ``breakdown``
lines: ``models/transmvsnet.fmt_stats()`` (the transformer's layer calls
by kind, self and cross, and the query tokens they took) and
``ops/deform_conv.stats()`` (deformable convolutions and their sampled
taps), besides ``ops/warp_correlate.adaptive_stats()`` and
``models/blocks.fold_stats()``.
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler
from torch.autograd.profiler import record_function

# the first word of every span's name
PREFIXES = ("mvsnet.", "train.")

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: the ``torch.profiler`` range ``name`` while a
    profiler session runs, else a shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return record_function(name)
