"""Mesh / sharding helpers (SURVEY.md §2b ``dist/collective``).

The framework's parallel axes over a device mesh:

  * ``scen`` — data parallelism over independent MIQP instances /
    scenario rollouts (BASELINE configs 4–5). Pure sharding: XLA inserts
    no collectives except at reductions the caller asks for.
  * ``pool`` — one MIQP's B&B node pool sharded across devices;
    per-wave incumbent all-reduce + child exchange ride the interconnect
    (NVLink between the cards of one host; sharded_bnb.py).

Multi-host: the same meshes span hosts via ``jax.distributed.initialize``
(standard JAX SPMD); nothing here is host-count-aware by design.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(axis_sizes: Sequence[Tuple[str, int]],
              devices=None) -> Mesh:
    """Build a named mesh, e.g. make_mesh([("scen", 4), ("pool", 2)])."""
    names = tuple(n for n, _ in axis_sizes)
    sizes = tuple(s for _, s in axis_sizes)
    if devices is None:
        devices = jax.devices()
    n = int(np.prod(sizes))
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(sizes)
    return Mesh(dev, names)


def scenario_sharding(mesh: Mesh, axis: str = "scen") -> NamedSharding:
    """Sharding for a batch of independent instances: leading dim split
    over ``axis``, everything else replicated."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
