"""Decentralized micro-grid coordination (SURVEY.md §3.5 "per-agent
decomposed variants" of the aggregate solve): dual decomposition on the
grid coupling constraint.

Instead of one joint MIQP over all agents (agents/micro_grid.py), each
dual round solves every agent's OWN horizon MIQP with the shared
congestion price λ added to its energy cost:

    agent i:  min  J_i(V_i) + Σ_k λ_k · P_i · u_{i,k}
    master:   λ_k ← [λ_k + α (Σ_i P_i u*_{i,k} − P_max)]₊

Device shape: all agents share one model structure, so each dual round is a
single ``vmap``-batched B&B over the agent axis — M agents cost one
batched solve, and the agent axis shards over a mesh (`scen`) for
multi-chip fleets. The master update is a tiny reduction (the ICI
all-reduce on a pod).

MIQP duality gap means exact coupling feasibility is not guaranteed at
convergence; a final *rationing projection* keeps the step implementable
(greedy: switch off excess heaters with the highest temperature — they
need the energy least).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from pyhybridcontrol_tpu.models.dewh import DewhParams, dewh_model
from pyhybridcontrol_tpu.models.grid import GridParams
from pyhybridcontrol_tpu.ops.admm import prepare_admm_mpc
from pyhybridcontrol_tpu.ops.condense import CondensedMpc
from pyhybridcontrol_tpu.solver.bnb import BnbSpec, solve_miqp_bnb
from pyhybridcontrol_tpu.utils.structdict import StructDict


class DecentralizedMicroGrid:
    """M identical-structure DEWH agents + dual-price coordination."""

    def __init__(self, dewh_params: Sequence[DewhParams],
                 grid: Optional[GridParams] = None, N: int = 8,
                 T_set: float = 60.0,
                 bnb_spec: Optional[BnbSpec] = None,
                 dual_rounds: int = 5, dual_step: float = 2e-4,
                 soft_comfort: bool = True):
        from pyhybridcontrol_tpu.models.dewh import dewh_weights

        self.dewh_params = list(dewh_params)
        self.M = len(self.dewh_params)
        self.grid = grid or GridParams()
        self.N = N
        self.dual_rounds = dual_rounds
        self.dual_step = dual_step
        self.bnb_spec = bnb_spec or BnbSpec(capacity=128, wave_size=16,
                                            qp_iters=200)
        # one condensed problem — agents share the model structure
        self.model = dewh_model(self.dewh_params[0])
        c = CondensedMpc(self.model, N, dewh_weights(T_set=T_set))
        if soft_comfort:
            nc = self.model.info.ncons
            c = c.with_soft_constraints(
                [k * nc + r for k in range(N) for r in (0, 1)],
                lin_pen=5.0, quad_pen=1.0)
        self.qp = c.device_qp()
        self.admm = prepare_admm_mpc(c)
        self.P_h = np.array([p.P_h for p in self.dewh_params])
        self.x = jnp.tile(jnp.asarray([55.0, 0.0]), (self.M, 1))
        self.k = 0

        spec = self.bnb_spec
        qp, admm = self.qp, self.admm

        @jax.jit
        def batched_feedback(x0s, price_seqs):
            def one(x0, pq):
                f, h = qp.assemble(x0, None, None, pq)
                r = solve_miqp_bnb(admm, qp, f, h, spec)
                return qp.full_v(r.x), r.obj, r.found

            return jax.vmap(one)(x0s, price_seqs)

        self._batched_feedback = batched_feedback

    def reset(self, x0s):
        self.x = jnp.asarray(np.stack(x0s), jnp.float32)
        self.k = 0

    def feedback(self) -> StructDict:
        """One control step: dual rounds of batched agent MIQPs +
        rationing projection. Returns u (M,), λ, power trace."""
        N, M = self.N, self.M
        # per-agent tariff on the agent's OWN u column (col 0 of its nv)
        nv = self.model.info.nv
        base_price = np.zeros((M, N, nv))
        for k in range(N):
            price = self.grid.price_at(self.k + k)
            for i, p in enumerate(self.dewh_params):
                base_price[i, k, 0] = price * p.P_h * p.Ts / 3.6e6
        lam = np.zeros(N)
        u_prof = None
        for _ in range(self.dual_rounds):
            prices = base_price.copy()
            for i in range(M):
                prices[i, :, 0] += lam * self.P_h[i]
            v_seqs, objs, founds = self._batched_feedback(
                self.x, jnp.asarray(prices, jnp.float32))
            u_prof = np.round(np.asarray(v_seqs)[:, :, 0])   # (M, N)
            agg = u_prof.T @ self.P_h                        # (N,)
            viol = agg - self.grid.P_max
            lam = np.maximum(0.0, lam + self.dual_step * viol)
            if np.all(viol <= 1e-6):
                break
        # rationing projection on the FIRST step only (the applied one):
        # drop warmest heaters until the coupling holds
        u0 = u_prof[:, 0].copy()
        temps = np.asarray(self.x)[:, 0]
        order = np.argsort(-temps)       # warmest first
        for i in order:
            if u0 @ self.P_h <= self.grid.P_max + 1e-6:
                break
            u0[i] = 0.0
        return StructDict(u=u0, lam=lam, agg_power=float(u0 @ self.P_h),
                          found=bool(np.asarray(founds).all()),
                          v_seqs=v_seqs)

    def sim_step(self, omega_k=None) -> StructDict:
        sol = self.feedback()
        xs = []
        for i in range(self.M):
            w = (jnp.asarray([omega_k[i]], jnp.float32)
                 if omega_k is not None else None)
            u = jnp.asarray([sol.u[i]], jnp.float32)
            d = jnp.round(sol.v_seqs[i, 0, 1:2])
            xs.append(self.model.step(self.x[i], u, d, None, w))
        self.x = jnp.stack(xs)
        self.k += 1
        return sol
