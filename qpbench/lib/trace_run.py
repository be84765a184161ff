"""The traced run: the profile of a short window, the calls made in it, and
the shapes the work counts need.  Per-layer readers take one of these."""

from __future__ import annotations

import contextlib

from . import profile, spec


class TraceRun:
    def __init__(self, ctx, shape: dict):
        self.ctx = ctx
        self.config, self.cell = ctx.config, ctx.cell
        self.shape = dict(shape)
        self.calls = []          # one dict a call, in order
        self.records = []
        self.lo = self.hi = 0.0

    @contextlib.contextmanager
    def window(self):
        """Profile the block as the span ``bench/window``."""
        from iadmm_tpu_torch.utils.profiling import annotate
        self.ctx.sync()
        with profile.Profile(self.ctx.cuda) as prof:
            with annotate("bench/window"):
                yield self
                self.ctx.sync()
        self.records = prof.records
        self.lo, self.hi = profile.window(self.records)

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def busy_s(self) -> float:
        return profile.busy_s(self.records, self.lo, self.hi)

    def count(self, kernel: str, **shape) -> dict:
        return spec.count(kernel, {**self.shape, **shape})

    def device_s(self, span: str, exclude=(), skip=(), only=()) -> float:
        """Device seconds of the operations that start inside ``span``,
        less those inside each span of ``exclude`` and those whose name
        holds a string of ``skip``; with ``only``, just those whose name
        holds one of its strings."""
        ops = set(profile.ops_in(self.records, span))
        for ex in exclude:
            ops -= set(profile.ops_in(self.records, ex))
        return sum(r[3] for r in ops if not any(k in r[1] for k in skip)
                   and (not only or any(k in r[1] for k in only)))

    def kernels(self, span: str) -> int:
        """Kernels launched inside ``span`` (copies and sets left out)."""
        return sum(r[0] == "kernel" for r in profile.ops_in(self.records,
                                                            span))

    def breakdown(self) -> dict:
        return profile.breakdown(self.records, self.lo, self.hi)
