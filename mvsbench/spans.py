"""Spans recorded from the benchmark's own files around calls into the
program's layers (a copy of the pattern of the program's
``engine/profiler.breakdown`` / ``train_breakdown`` at commit 1e68102).

On a CUDA device a span is a pair of CUDA events on the current stream, so
it measures device time without a synchronisation; on the CPU (the
benchmark's own tests) it is the host clock.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class Spans:
    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.events: dict[str, list] = defaultdict(list)

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def start(self, name: str) -> None:
        self.events[name].append([self._mark(), None])

    def end(self, name: str) -> None:
        self.events[name][-1][1] = self._mark()

    @contextlib.contextmanager
    def span(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.end(name)

    def totals_ms(self) -> dict[str, float]:
        """{name: summed milliseconds over its closed spans}."""
        if self.cuda:
            torch.cuda.synchronize()
        out = {}
        for name, pairs in self.events.items():
            done = [(s, e) for s, e in pairs if e is not None]
            out[name] = sum(s.elapsed_time(e) if self.cuda else (e - s) * 1e3 for s, e in done)
        return out


def wrap(owner, attr: str, spans: Spans, name: str, stack: contextlib.ExitStack) -> None:
    """Replaces ``owner.attr`` by a wrapper that records a span ``name``
    around each call, restored when ``stack`` closes."""
    real = getattr(owner, attr)

    def timed(*args, **kwargs):
        with spans.span(name):
            return real(*args, **kwargs)

    setattr(owner, attr, timed)
    stack.callback(setattr, owner, attr, real)


def module_span(module: torch.nn.Module, spans: Spans, name: str,
                stack: contextlib.ExitStack) -> None:
    """A span ``name`` around each forward of ``module``."""
    pre = module.register_forward_pre_hook(lambda m, a: spans.start(name))
    post = module.register_forward_hook(lambda m, a, o: spans.end(name))
    stack.callback(pre.remove)
    stack.callback(post.remove)
