"""Monitoring utilities.

The reference's only instrumentation is wall-clock ``Time[]``, objective
``Obj[]`` and evolution ``Dif[]`` arrays plus printf progress
(``CP_PFDR_graph_quadratic_d1_l1.cpp:255-258,323-329``).  The solvers here
return the same trace arrays; this module adds the device profiler hook.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np


class SolveTrace(NamedTuple):
    """User-facing monitoring contract (reference ``Time``/``Obj``/``Dif``)."""
    time: np.ndarray
    obj: np.ndarray
    dif: np.ndarray

    def summary(self) -> str:
        parts = [f"{len(self.time) - 1} iterations"]
        if len(self.time):
            parts.append(f"{self.time[-1]:.3f}s")
        if len(self.obj):
            parts.append(f"objective {self.obj[0]:.6g} -> {self.obj[-1]:.6g}")
        if len(self.dif):
            parts.append(f"final evolution {self.dif[-1]:.3g}")
        return ", ".join(parts)


class StageProfiler:
    """Wall-clock per-stage accumulator for the cut-pursuit outer loop,
    enabled by ``CP_PROFILE=1`` (the analog of the reference's per-stage
    verbose timing, ``CP_PFDR_graph_quadratic_d1_l1.cpp:323-329``).  Call
    :meth:`tick` after each stage; :meth:`report` prints the breakdown."""

    def __init__(self, enabled: bool | None = None):
        import os
        import time
        self.enabled = (os.environ.get("CP_PROFILE") == "1"
                        if enabled is None else enabled)
        self._clock = time.monotonic
        self._t = self._clock() if self.enabled else 0.0
        self.stages: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def tick(self, stage: str):
        if not self.enabled:
            return
        now = self._clock()
        self.stages[stage] = self.stages.get(stage, 0.0) + (now - self._t)
        self.counts[stage] = self.counts.get(stage, 0) + 1
        self._t = now

    def report(self, label: str = "cut-pursuit"):
        if not self.enabled or not self.stages:
            return
        import sys
        total = sum(self.stages.values())
        print(f"[CP_PROFILE] {label}: {total * 1000:.1f} ms total",
              file=sys.stderr)
        for k, v in sorted(self.stages.items(), key=lambda kv: -kv[1]):
            n = self.counts[k]
            print(f"[CP_PROFILE]   {k:24s} {v * 1000:8.1f} ms "
                  f"({100 * v / total:5.1f}%)  x{n}  "
                  f"{v * 1000 / max(n, 1):7.2f} ms/call", file=sys.stderr)


@contextlib.contextmanager
def profile(log_dir: str):
    """Wraps a solve in a ``jax.profiler`` trace (view with TensorBoard or
    xprof); the device equivalent of the reference's CLOCK_MONOTONIC timers."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
