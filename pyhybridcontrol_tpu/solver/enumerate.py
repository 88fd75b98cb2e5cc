"""Device-side exhaustive MIQP enumeration (SURVEY.md §7 "minimum
end-to-end slice"): solve ALL 2^nb binary assignments as one batched ADMM
call and reduce with argmin. For small binary counts this beats B&B
outright — 1024 relaxations is one batched solve — and it doubles
as the on-device parity reference for the B&B engine.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from pyhybridcontrol_tpu.ops.admm import BoxQP, admm_solve
from pyhybridcontrol_tpu.ops.condense import DeviceQP

BIG = 1e30


def _all_assignments(nb: int) -> np.ndarray:
    """(2^nb, nb) float array of all binary assignments (host, static)."""
    codes = np.arange(2 ** nb, dtype=np.uint32)
    return ((codes[:, None] >> np.arange(nb)[None, :]) & 1).astype(np.float32)


@partial(jax.jit, static_argnames=("iters", "feas_tol"))
def _enumerate_solve(spec: BoxQP, qp: DeviceQP, f, h, assignments,
                     iters: int = 100, feas_tol: float = 1e-3):
    nb = len(qp.binary_idx)
    bidx = jnp.asarray(np.asarray(qp.binary_idx, dtype=np.int32))
    B = assignments.shape[0]
    lb = jnp.broadcast_to(qp.lb, (B, qp.n)).at[:, bidx].set(assignments)
    ub = jnp.broadcast_to(qp.ub, (B, qp.n)).at[:, bidx].set(assignments)
    res = admm_solve(spec, jnp.broadcast_to(f, (B, qp.n)),
                     jnp.broadcast_to(h, (B, qp.m)), lb, ub, iters=iters)
    feasible = res.r_prim_rel < feas_tol
    objs = jnp.where(feasible, res.obj, BIG)
    k = jnp.argmin(objs)
    return res.x[k], objs[k], assignments[k], feasible


def solve_miqp_enumerate_device(spec: BoxQP, qp: DeviceQP, f, h,
                                iters: int = 100, feas_tol: float = 1e-3):
    """Exact-enumeration MIQP on device.

    Returns (x*, obj*, bits*, feasible_mask). f/h from ``qp.assemble``.
    """
    assignments = jnp.asarray(_all_assignments(qp.n_binary))
    return _enumerate_solve(spec, qp, f, h, assignments,
                            iters=iters, feas_tol=feas_tol)
