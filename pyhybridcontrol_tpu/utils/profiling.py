"""Tracing/profiling helpers (SURVEY.md §5: jax.profiler Perfetto traces
+ solver counters as the observability surface; the reference has none).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import jax
import numpy as np


@contextlib.contextmanager
def trace(log_dir: str = "profile_trace"):
    """Capture a Perfetto/profiler trace of the enclosed device work:

        with profiling.trace("out/trace"):
            solve_miqp_bnb(...)  # view via xprof/tensorboard
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def wall_timer(label: str = "", sync: Optional[object] = None):
    """Host wall-clock timing with optional device sync on exit."""
    t0 = time.perf_counter()
    box = {}
    try:
        yield box
    finally:
        if sync is not None:
            for leaf in jax.tree_util.tree_leaves(sync):
                if hasattr(leaf, "block_until_ready"):
                    leaf.block_until_ready()
                    break
        box["seconds"] = time.perf_counter() - t0
        if label:
            print(f"[{label}] {box['seconds']*1e3:.2f} ms")


def bnb_stats(result) -> dict:
    """Summarize a BnbResult into the §5 counter set (nodes, waves,
    bound gap) as plain floats for logging."""
    obj = float(np.asarray(result.obj))
    open_b = float(np.asarray(result.best_open_bound))
    gap = (obj - open_b) if open_b < 1e29 else 0.0
    return dict(
        obj=obj,
        found=bool(np.asarray(result.found)),
        waves=int(np.asarray(result.waves)),
        nodes_solved=int(np.asarray(result.nodes_solved)),
        overflow=bool(np.asarray(result.overflow)),
        bound_gap=gap,
    )
