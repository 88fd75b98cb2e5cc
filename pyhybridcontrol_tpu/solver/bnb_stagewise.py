"""Long-horizon MIQP: branch-and-bound over the stagewise O(N) QP path
(ops/stagewise.py) — the same wave loop as solver/bnb.py through the
backend protocol, with node relaxations solved by the block-tridiagonal
(Riccati-like) stagewise ADMM instead of the dense condensed kernel.

Use when N is large enough that the condensed H (O(N²·nv²)) or its
KKT inverse stops fitting / paying off — the stagewise path is
O(N·b²) memory and per-iteration FLOPs, so MIQPs with horizons in the
hundreds stay on the device.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from pyhybridcontrol_tpu.ops.stagewise import (
    StagewiseQP, stagewise_admm_solve, stagewise_dual_bound)
from pyhybridcontrol_tpu.solver.bnb import BnbResult, BnbSpec, _bnb_loop


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class StagewiseBackend:
    """Backend adapter: flat decision vector ξ ∈ R^{N·b} over the
    stagewise frame. ``h`` packs the stacked (l, u) row bounds.

    ``sw_probe``: optional stiff-ρ prep for dive probes — fixed-binary
    solves converge ~6× faster at ρ×10 while relaxed nodes are
    ρ-insensitive (see solver/bnb.py CondensedBackend.admm_probe).
    Warm iterates pass unchanged: x/z live in the primal/constraint
    frame and the OSQP-form y converges to the multiplier itself,
    independent of ρ."""

    sw: StagewiseQP
    sw_probe: object = dataclasses.field(default=None)
    # horizon-coupled extra-row upper bounds (assemble_stagewise_ext;
    # node-INDEPENDENT — branching only moves binary boxes, so one
    # per-solve vector serves every node). None when sw.n_ext == 0.
    ext_u: object = dataclasses.field(default=None)
    parallel_sweeps: bool = dataclasses.field(
        default=False, metadata=dict(static=True))

    @property
    def n(self):
        return self.sw.N * self.sw.b

    @property
    def lb(self):
        return self.sw.lb_xi.reshape(-1)

    @property
    def ub(self):
        return self.sw.ub_xi.reshape(-1)

    @property
    def binary_idx(self):
        """Branching coordinates. Under move blocking, a blocked binary
        INPUT branches only at block-LEADER stages — the tied stages'
        values are forced by the blocking equality rows inside every
        relaxation (ops/stagewise.py module docstring), so branching
        them would only duplicate work. Unblocked binaries (δ) branch
        per stage as before."""
        sw = self.sw
        if not sw.blk_cols:
            return tuple(k * sw.b + int(i)
                         for k in range(sw.N) for i in sw.binary_idx_v)
        blocked = set(sw.blk_cols)
        g = sw.blk_groups
        out = []
        for k in range(sw.N):
            leader = (k == 0) or (g[k] != g[k - 1])
            for i in sw.binary_idx_v:
                if int(i) in blocked and not leader:
                    continue
                out.append(k * sw.b + int(i))
        return tuple(out)

    @property
    def warm_size(self):
        # z and y each carry the n_ext extra-row tail after the staged
        # rows — the B&B loop treats warm vectors as opaque flats
        return self.sw.N * self.sw.m_k + self.sw.n_ext

    def solve(self, f, h, lb, ub, iters, warm=None):
        sw = self.sw
        batch = f.shape[:-1]
        q = f.reshape(batch + (sw.N, sw.b))
        l = h[..., 0, :, :]
        u = h[..., 1, :, :]
        m_st = sw.N * sw.m_k
        warm_ext = None
        if warm is not None:
            xw, zw, yw = warm
            if sw.n_ext:
                warm_ext = (zw[..., m_st:], yw[..., m_st:])
            warm = (xw.reshape(batch + (sw.N, sw.b)),
                    zw[..., :m_st].reshape(batch + (sw.N, sw.m_k)),
                    yw[..., :m_st].reshape(batch + (sw.N, sw.m_k)))
        res = stagewise_admm_solve(
            sw, q, l, u, iters=iters,
            lb_xi=lb.reshape(batch + (sw.N, sw.b)),
            ub_xi=ub.reshape(batch + (sw.N, sw.b)),
            warm=warm, parallel_sweeps=self.parallel_sweeps,
            ext_u=self.ext_u, warm_ext=warm_ext)
        z_flat = res.z.reshape(batch + (m_st,))
        y_flat = res.y.reshape(batch + (m_st,))
        if sw.n_ext:
            z_flat = jnp.concatenate([z_flat, res.z_ext], axis=-1)
            y_flat = jnp.concatenate([y_flat, res.y_ext], axis=-1)
        return dataclasses.replace(
            res, x=res.x.reshape(batch + (self.n,)),
            z=z_flat, y=y_flat, z_ext=None, y_ext=None)

    def solve_probe(self, f, h, lb, ub, iters, warm=None):
        if self.sw_probe is None:
            return self.solve(f, h, lb, ub, iters, warm=warm)
        return StagewiseBackend(
            self.sw_probe, ext_u=self.ext_u,
            parallel_sweeps=self.parallel_sweeps).solve(f, h, lb, ub,
                                                        iters, warm=warm)

    def node_bound(self, res, f, h, lb, ub):
        sw = self.sw
        batch = f.shape[:-1]
        q = f.reshape(batch + (sw.N, sw.b))
        l = h[..., 0, :, :]
        u = h[..., 1, :, :]
        lb_xi = lb.reshape(batch + (sw.N, sw.b))
        ub_xi = ub.reshape(batch + (sw.N, sw.b))
        nbox = sw.nx + sw.nc
        l = l.at[..., :, nbox:nbox + sw.b].set(lb_xi)
        u = u.at[..., :, nbox:nbox + sw.b].set(ub_xi)
        m_st = sw.N * sw.m_k
        res = dataclasses.replace(
            res,
            x=res.x.reshape(batch + (sw.N, sw.b)),
            y=res.y[..., :m_st].reshape(batch + (sw.N, sw.m_k)),
            z=res.z[..., :m_st].reshape(batch + (sw.N, sw.m_k)),
            y_ext=(res.y[..., m_st:] if sw.n_ext else None),
            z_ext=(res.z[..., m_st:] if sw.n_ext else None))
        return stagewise_dual_bound(sw, q, l, u, res, ext_u=self.ext_u)

    def broadcast_data(self, f, h, W):
        return (jnp.broadcast_to(f, (W,) + f.shape),
                jnp.broadcast_to(h, (W,) + h.shape))


def pack_stagewise_data(q, l, u):
    """(q, l, u) from ``assemble_stagewise`` → flat (f, h) for the B&B
    backend: f = q flattened, h = stacked [l; u]."""
    return q.reshape(-1), jnp.stack([l, u], axis=0)


@partial(jax.jit, static_argnames=("spec", "parallel_sweeps"))
def solve_miqp_bnb_stagewise(sw: StagewiseQP, q, l, u,
                             spec: BnbSpec = BnbSpec(),
                             init_incumbent=None,
                             sw_probe=None,
                             parallel_sweeps: bool = False,
                             ext_u=None) -> BnbResult:
    """B&B over the stagewise frame. (q, l, u) from
    ``assemble_stagewise(sw, x0, W, prices)``. Returns BnbResult with
    ``x`` the flat ξ (reshape to (N, b); v_k = ξ_k[:nv]).
    ``sw_probe``: optional stiff-ρ StagewiseQP for dive probes.
    ``parallel_sweeps``: log-depth associative-scan K sweeps (long
    horizons / horizon-sharded meshes; ops/stagewise._solve_K_assoc).
    ``ext_u``: horizon-coupled extra-row bounds
    (``assemble_stagewise_ext``) — required when ``sw.n_ext > 0``;
    node-independent, so relaxations, probes and Falk bounds all close
    over the same vector."""
    f, h = pack_stagewise_data(q, l, u)
    return _bnb_loop(StagewiseBackend(sw, sw_probe, ext_u=ext_u,
                                      parallel_sweeps=parallel_sweeps),
                     f, h, spec, init_incumbent=init_incumbent)
