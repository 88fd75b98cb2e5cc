"""MpcController: the user-facing receding-horizon controller
(functional replica of the reference's ``MpcController`` — SURVEY.md §2a:
owns evolution matrices + weights + decision variables, assembles the
problem, ``feedback(x0, …) → solve MIQP → first input``).

Device-native redesign: instead of CVXPY variables + a Gurobi call, ``build``
condenses once (host fp64 → DeviceQP) and compiles a jitted device
feedback function; ``feedback`` is then a single device-program call.
Derived data is version-cached: rebuilds happen only when the horizon,
weights, or transforms change (the reference's versioning-mixin role).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax.numpy as jnp
import numpy as np

from pyhybridcontrol_tpu.mld.model import MldModel
from pyhybridcontrol_tpu.ops.admm import prepare_admm_mpc
from pyhybridcontrol_tpu.ops.condense import CondensedMpc, MpcWeights
from pyhybridcontrol_tpu.solver.bnb import BnbSpec, solve_miqp_bnb
from pyhybridcontrol_tpu.solver.enumerate import solve_miqp_enumerate_device
from pyhybridcontrol_tpu.ops.stagewise import (
    assemble_stagewise, prepare_stagewise)
from pyhybridcontrol_tpu.utils.structdict import StructDict


class MpcController:
    def __init__(self, model: MldModel, N: int,
                 weights: Optional[MpcWeights] = None,
                 solver: str = "bnb",
                 bnb_spec: Optional[BnbSpec] = None,
                 qp_iters: int = 150,
                 rho: float = 1.0,
                 sw_parallel: bool = False):
        self.model = model
        self.N = N
        self.weights = weights or MpcWeights()
        self.solver = solver
        self.bnb_spec = bnb_spec or BnbSpec(qp_iters=qp_iters)
        self.qp_iters = qp_iters
        self.rho = rho
        # stagewise-only: log-depth associative-scan K sweeps instead of
        # the sequential scans — for very long horizons / horizon-sharded
        # meshes (ops/stagewise._solve_K_assoc; SURVEY.md §5 long-context)
        self.sw_parallel = sw_parallel
        self._soft = None          # (rows, lin_pen, quad_pen)
        self._tree = None          # ScenarioTree (stochastic MPC)
        self._tree_consensus = False
        self._scen_mesh = None     # (Mesh, axis) for consensus trees
        self._blocking = None      # groups
        self._terminal = None      # (E_N, f_N)
        self._extra = None         # (A_v, b, B_x, B_w)
        self._built_version = None
        self._version = 0
        self._cmpc = None
        self._qp = None
        self._admm = None
        self._fb_batch_cache = {}  # (version, arg signature) → jitted fn

    # -- configuration (each bumps the version → lazy rebuild) -----------
    def set_std_obj_weights(self, **kw) -> "MpcController":
        """Update per-class weights (reference ``set_std_obj_weights``)."""
        for k, v in kw.items():
            if not hasattr(self.weights, k):
                raise AttributeError(f"unknown weight {k!r}")
            setattr(self.weights, k, v)
        self._version += 1
        return self

    def set_horizon(self, N: int) -> "MpcController":
        self.N = N
        self._version += 1
        return self

    def set_soft_constraints(self, rows: Sequence[int], lin_pen=1e3,
                             quad_pen=0.0) -> "MpcController":
        self._soft = (list(rows), lin_pen, quad_pen)
        self._version += 1
        return self

    def set_move_blocking(self, groups: Sequence[int]) -> "MpcController":
        self._blocking = list(groups)
        self._version += 1
        return self

    def set_terminal_constraint(self, E_N, f_N) -> "MpcController":
        self._terminal = (np.asarray(E_N), np.asarray(f_N))
        self._version += 1
        return self

    def set_extra_constraints(self, A_v, b, B_x=None, B_w=None
                              ) -> "MpcController":
        """Horizon-coupled rows in full-v layout (e.g. min-up/down
        unit-commitment logic — models/dewh.py ``min_up_down_rows``)."""
        self._extra = (np.asarray(A_v), np.asarray(b), B_x, B_w)
        self._version += 1
        return self

    def set_scenario_tree(self, tree, consensus: bool = False,
                          scen_mesh=None) -> "MpcController":
        """Stochastic MPC over an ``ops.scenario_tree.ScenarioTree``:
        the joint problem couples S probability-weighted scenario copies
        with non-anticipativity; ``feedback`` then returns the (shared)
        first-stage input and auto-supplies the tree's own disturbance
        paths as the forecast. ``v_seq`` in the result is the stacked
        (S·N, nv) scenario plan.

        ``consensus=False`` (default): one dense joint condensed QP —
        O((S·N·nv)²) memory, single chip. ``consensus=True``: the
        device-sharded consensus-ADMM formulation
        (ops/consensus_tree.py) — per-scenario QPs + group-mean
        collectives, scaling to trees that exceed one chip's HBM; pass
        ``scen_mesh=(mesh, axis_name)`` to span a device mesh.

        With ``solver='stagewise'`` the tree rides the O(N) block-
        tridiagonal frame instead (ops/stagewise_tree.py — always the
        consensus formulation; ``consensus`` is ignored): long-horizon
        tree MPC, composing natively with soft rows, move blocking,
        terminal sets and horizon-coupled extra rows (applied PER
        SCENARIO — the budget must hold on every tree path)."""
        g0 = np.asarray(tree.groups)[:, 0]
        if not np.all(g0 == g0[0]):
            raise ValueError(
                "scenario tree branches at step 0: every scenario is its "
                "own information set, so there is no shared first-stage "
                "input for feedback to return. Branch at step >= 1 "
                "(here-and-now control requires a common step-0 decision)")
        self._tree = tree
        self._tree_consensus = bool(consensus)
        self._scen_mesh = scen_mesh
        self._version += 1
        return self

    # -- build -------------------------------------------------------------
    def build(self) -> "MpcController":
        """Condense + prepare solver data (idempotent per version)."""
        if self._built_version == self._version and self._cmpc is not None:
            return self
        if self.solver == "stagewise":
            # long-horizon path: O(N) block-tridiagonal frame. Δu/Qy
            # weights, soft stage constraints (prox form), move blocking
            # (adjacent-stage equality rows + leader-only branching),
            # terminal sets (last-stage rows), scenario TREES
            # (consensus selector rows + group-mean prox —
            # ops/stagewise_tree.py, round 4) and horizon-coupled extra
            # rows (rank-r bordered Woodbury solve —
            # ops/stagewise.py::_solve_K_bordered, round 4) all ride
            # natively — including extra rows × trees (per-SCENARIO
            # row semantics: the budget must hold on every tree path,
            # matching the condensed joint frame's block-replicated
            # rows; the shared bordered factors batch over scenarios).
            kw = dict(soft=self._soft, blocking=self._blocking,
                      terminal=self._terminal, extra=self._extra)
            if self._tree is not None:
                from pyhybridcontrol_tpu.ops.stagewise_tree import (
                    prepare_stagewise_tree)

                if self._tree.N != self.N:
                    raise ValueError(
                        f"tree N={self._tree.N} != horizon N={self.N}")
                self._swt = prepare_stagewise_tree(
                    self.model, self._tree, self.weights, rho=self.rho,
                    **kw)
                self._swt_probe = prepare_stagewise_tree(
                    self.model, self._tree, self.weights,
                    rho=self.rho * 10.0, **kw)
                self._sw = None
                self._sw_probe = None
                self._cmpc = None
                self._admm_probe = None
                self._built_version = self._version
                return self
            self._sw = prepare_stagewise(self.model, self.N, self.weights,
                                         rho=self.rho, **kw)
            # stiff-rho prep for dive probes (see solver/bnb.py);
            # extra rows ride both preps (same bordered structure,
            # stiff-rho Woodbury factors of its own)
            self._sw_probe = prepare_stagewise(
                self.model, self.N, self.weights, rho=self.rho * 10.0,
                **kw)
            self._cmpc = None
            self._admm_probe = None
            self._built_version = self._version
            return self
        if self._tree is not None and (
                self._soft is not None or self._blocking is not None
                or self._extra is not None or self._terminal is not None):
            raise ValueError(
                "scenario-tree MPC composes with plain stage problems; "
                "apply soft/blocking/extra/terminal transforms to the "
                "joint problem via ops.scenario_tree directly")
        term = dict()
        if self._terminal is not None:
            term = dict(terminal_E=self._terminal[0],
                        terminal_f=self._terminal[1])
        c = CondensedMpc(self.model, self.N, self.weights, **term)
        if self._tree is not None and self._tree_consensus:
            from pyhybridcontrol_tpu.ops.consensus_tree import (
                prepare_tree_consensus)

            self._tqp = prepare_tree_consensus(c, self._tree,
                                               rho=self.rho)
            self._tqp_probe = prepare_tree_consensus(
                c, self._tree, rho=self.rho * 10.0)
            self._cmpc = c
            self._qp = None
            self._admm = None
            self._admm_probe = None
            self._repair = None
            self._built_version = self._version
            return self
        if self._tree is not None:
            from pyhybridcontrol_tpu.ops.scenario_tree import (
                build_scenario_tree_qp)

            c = build_scenario_tree_qp(c, self._tree)
        if self._extra is not None:
            A_v, b, B_x, B_w = self._extra
            c = c.with_extra_constraints(A_v, b, B_x, B_w)
        if self._blocking is not None:
            c = c.with_move_blocking(self._blocking)
        if self._soft is not None:
            rows, lin, quad = self._soft
            c = c.with_soft_constraints(rows, lin, quad)
        self._cmpc = c
        self._qp = c.device_qp()
        self._admm = prepare_admm_mpc(c, rho=self.rho)
        # stiff-rho prep for dive probes: fixed-binary (implied-
        # equality) solves converge ~6x faster at rho*10 while relaxed
        # nodes are rho-insensitive (solver/bnb.py CondensedBackend)
        self._admm_probe = (prepare_admm_mpc(c, rho=self.rho * 10.0)
                            if self.solver == "bnb" else None)
        # rollout-repair incumbent heuristic: valid only when the
        # decision frame is the full per-step v (optionally + slacks)
        self._repair = None
        if (self.solver == "bnb" and self._blocking is None
                and self._tree is None and self.model.info.nxb == 0):
            from pyhybridcontrol_tpu.solver.repair import prepare_repair

            rkw = {}
            if self._soft is not None:
                rows, lin, quad = self._soft
                nc = self.model.info.ncons
                stage_rows = sorted({r % nc for r in rows})
                rkw = dict(soft_rows=stage_rows,
                           soft_lin=float(np.mean(np.atleast_1d(lin))),
                           soft_quad=float(np.mean(np.atleast_1d(quad))))
            rspec = prepare_repair(self.model, self.weights, **rkw)
            if rspec is not None:
                layout = "soft" if self._soft is not None else "plain"
                self._repair = (rspec, layout)
        self._built_version = self._version
        return self

    @property
    def repair(self):
        self.build()
        return self._repair

    @property
    def condensed(self) -> CondensedMpc:
        self.build()
        return self._cmpc

    @property
    def device_qp(self):
        self.build()
        return self._qp

    @property
    def admm(self):
        self.build()
        return self._admm

    @property
    def admm_probe(self):
        self.build()
        return self._admm_probe

    # -- feedback ----------------------------------------------------------
    def feedback(self, x0, omega_forecast=None, price_seq=None,
                 u_prev=None) -> StructDict:
        """One control step: measure → solve MIQP → first input.

        Returns StructDict(u, delta, z, v_seq, obj, found, nodes).
        """
        self.build()
        x0 = jnp.asarray(x0, jnp.float32)
        info = self.model.info
        if omega_forecast is not None and info.nomega == 0:
            raise ValueError(
                "omega_forecast given but the model has no disturbance "
                "channel (nomega=0)")
        if price_seq is not None:
            S = (self._tree.omega_paths.shape[0]
                 if self._tree is not None else 1)
            if np.shape(price_seq)[0] not in (self.N, S * self.N):
                raise ValueError(
                    f"price_seq must have N={self.N} rows (per control "
                    f"step), got {np.shape(price_seq)}")
        if self.solver == "stagewise":
            if self._tree is not None:
                return self._feedback_tree_stagewise(x0, price_seq,
                                                     u_prev)
            return self._feedback_stagewise(x0, omega_forecast, price_seq,
                                            u_prev)
        if self._tree is not None and self._tree_consensus:
            return self._feedback_tree_consensus(x0, price_seq, u_prev)
        qp, admm = self._qp, self._admm
        if omega_forecast is None and self._tree is not None:
            # the tree's own disturbance paths, stacked scenario-major
            t = self._tree
            omega_forecast = np.asarray(t.omega_paths, np.float32).reshape(
                t.omega_paths.shape[0] * t.omega_paths.shape[1], -1)
        W = (jnp.asarray(omega_forecast, jnp.float32)
             if omega_forecast is not None else None)
        if (self._tree is not None and price_seq is not None
                and len(price_seq) == self.N):
            from pyhybridcontrol_tpu.ops.scenario_tree import tree_price_seq

            price_seq = tree_price_seq(self._tree, np.asarray(price_seq))
        Pq = (jnp.asarray(price_seq, jnp.float32)
              if price_seq is not None else None)
        up = (jnp.asarray(u_prev, jnp.float32)
              if u_prev is not None else None)
        f, h = qp.assemble(x0, W, up, Pq)
        if self.solver == "bnb":
            seed = None
            if self._repair is not None:
                from pyhybridcontrol_tpu.solver.repair import (
                    root_repair_incumbent)

                rspec, layout = self._repair
                seed = root_repair_incumbent(
                    admm, qp, rspec, x0, f, h, W=W, price_seq=Pq,
                    qp_iters=self.bnb_spec.qp_iters, layout=layout,
                    feas_tol=self.bnb_spec.feas_tol)
            res = solve_miqp_bnb(admm, qp, f, h, self.bnb_spec,
                                 init_incumbent=seed,
                                 admm_probe=self._admm_probe)
            x, obj, found = res.x, res.obj, res.found
            nodes = res.nodes_solved
            # certified relative optimality gap (the reference exposes
            # Gurobi's MIPGap the same way): 0 when the frontier was
            # exhausted; folds overflow-dropped bounds (solver/bnb.py)
            bo = res.best_open_bound
            gap = jnp.where(found & jnp.isfinite(bo) & (bo < obj),
                            (obj - bo) / jnp.maximum(1.0, jnp.abs(obj)),
                            0.0)
        elif self.solver == "enumerate":
            x, obj, _, feas = solve_miqp_enumerate_device(
                admm, qp, f, h, iters=self.qp_iters)
            found = jnp.any(feas)
            nodes = jnp.asarray(2 ** qp.n_binary, jnp.int32)
            gap = jnp.asarray(0.0, jnp.float32)   # exhaustive
        else:
            raise ValueError(f"unknown solver {self.solver!r}")
        v_seq = qp.full_v(x)
        info = self.model.info
        v0 = v_seq[0]
        return StructDict(
            u=v0[info.u_slice], delta=v0[info.delta_slice],
            z=v0[info.z_slice], v_seq=v_seq, obj=obj, found=found,
            nodes=nodes, gap=gap)

    def feedback_batch(self, x0s, omega_forecasts=None, price_seq=None,
                       u_prevs=None, mesh=None, engine="auto",
                       pooled_wave: int = 1024,
                       pool_slots: int = 0) -> StructDict:
        """Solve a batch of independent control steps as ONE device
        program — the BASELINE config-4 workload through the controller
        API instead of the low-level loop layer.

        ``engine``: "auto" (default — picks "pooled" whenever eligible),
        "vmap" (jit(vmap(feedback)) — every solver/tree combination) or
        "pooled" (solver="bnb", no scenario tree, single-device —
        solver/bnb_pooled.py: all instances' B&B nodes in one global
        pool, so instances neither lock-step nor relax in tiny
        per-instance batches).
        ``pooled_wave``/``pool_slots`` size the pooled
        search; the per-instance node budget matches bnb_spec
        (max_waves rescales to the global wave size).

        ``x0s`` (B, nx); ``omega_forecasts``/``u_prevs`` optionally carry
        the same leading batch dim; ``price_seq`` is shared. With
        ``mesh`` the batch is placed sharded over its ``scen`` axis, so
        the same call spans a multi-chip slice unchanged. The compiled
        program is cached per (build version, argument signature);
        re-calls with new data at the same shapes are compile-free.
        """
        self.build()
        import jax

        x0s = jnp.asarray(x0s, jnp.float32)
        W = (jnp.asarray(omega_forecasts, jnp.float32)
             if omega_forecasts is not None else None)
        Pq = (jnp.asarray(price_seq, jnp.float32)
              if price_seq is not None else None)
        up = (jnp.asarray(u_prevs, jnp.float32)
              if u_prevs is not None else None)
        if engine == "auto":
            # pooled whenever eligible: bnb solver, dense-joint or no
            # scenario tree, no mesh placement (the pooled pool is
            # single-program; mesh batches go through vmap + scenario
            # sharding). Dense-joint trees pool via rep-map branching
            # (solver/bnb_pooled.py branch_map); consensus trees keep
            # the vmap engine (their solve is not a CondensedBackend).
            engine = ("pooled" if (self.solver == "bnb"
                                   and (self._tree is None
                                        or not self._tree_consensus)
                                   and mesh is None)
                      else "vmap")
        if engine == "pooled":
            return self._feedback_batch_pooled(x0s, W, Pq, up,
                                               pooled_wave, pool_slots)
        key = (self._version, self.solver, W is not None, Pq is not None,
               up is not None)
        fn = self._fb_batch_cache.get(key)
        if fn is None:
            fn = jax.jit(jax.vmap(
                lambda x, W_, Pq_, up_: self.feedback(x, W_, Pq_, up_),
                in_axes=(0, 0 if W is not None else None, None,
                         0 if up is not None else None)))
            self._fb_batch_cache[key] = fn
        if mesh is not None:
            from pyhybridcontrol_tpu.parallel.mesh import scenario_sharding

            x0s = jax.device_put(x0s, scenario_sharding(mesh))
        return fn(x0s, W, Pq, up)

    def _feedback_batch_pooled(self, x0s, W, Pq, up, pooled_wave,
                               pool_slots) -> StructDict:
        """feedback_batch engine="pooled": one global node pool over the
        batch (solver/bnb_pooled.py). Same per-instance results contract
        as the vmapped engine; ``nodes`` is the GLOBAL node count (the
        pool does not attribute solves to instances)."""
        import dataclasses as _dc

        import jax

        from pyhybridcontrol_tpu.solver.bnb_pooled import (
            solve_miqp_bnb_pooled)

        if self.solver != "bnb":
            raise ValueError(
                f'engine="pooled" requires solver="bnb", got '
                f'{self.solver!r}')
        if self._tree is not None and self._tree_consensus:
            raise ValueError('engine="pooled" supports dense-joint '
                             "scenario trees (rep-map branching); "
                             "batch CONSENSUS trees via the vmap "
                             "engine")
        qp, admm = self._qp, self._admm
        B = x0s.shape[0]
        branch_map = None
        if self._tree is not None:
            # a tree is one MIQP of the joint condensed frame
            # (ops/scenario_tree.build_scenario_tree_qp) — it slots
            # into the global pool like any instance once branching is
            # rep-mapped: each (info-set, step, var) group of binary
            # copies branches as ONE decision (VERDICT r4 item 7; the
            # ops/stagewise_tree.py trick on the condensed frame).
            t, info = self._tree, self.model.info
            S = t.S
            nVs = self._cmpc.nV // S          # single-scenario width
            nv, nud = info.nv, info.nu + info.ndelta
            bidx = np.nonzero(self._cmpc.binary_mask)[0]
            groups: dict = {}
            bm = np.empty(len(bidx), int)
            for ti, col in enumerate(bidx):
                s_, off = divmod(int(col), nVs)
                k_, j_ = divmod(off, nv)
                key = ((int(t.groups[s_][k_]), k_, j_) if j_ < nud
                       else ("own", ti))
                bm[ti] = groups.setdefault(key, len(groups))
            branch_map = bm
            if W is None:
                # the tree supplies its own disturbance paths,
                # identical for every instance (feedback() semantics)
                if t.omega_paths.size:
                    W = jnp.asarray(
                        np.asarray(t.omega_paths, np.float32).reshape(
                            1, S * t.N, -1))
                    W = jnp.broadcast_to(W, (B,) + W.shape[1:])
            if (Pq is not None and Pq.shape[0] == self.N):
                from pyhybridcontrol_tpu.ops.scenario_tree import (
                    tree_price_seq)

                Pq = jnp.asarray(tree_price_seq(t, np.asarray(Pq)),
                                 jnp.float32)
        f, h = jax.vmap(
            lambda x, W_, up_: qp.assemble(x, W_, up_, Pq),
            in_axes=(0, 0 if W is not None else None,
                     0 if up is not None else None))(x0s, W, up)
        seed = None
        if self._repair is not None:
            from pyhybridcontrol_tpu.solver.repair import (
                root_repair_incumbent)

            rspec, layout = self._repair
            seed = jax.vmap(
                lambda x, f_, h_, W_: root_repair_incumbent(
                    admm, qp, rspec, x, f_, h_, W=W_, price_seq=Pq,
                    qp_iters=self.bnb_spec.qp_iters, layout=layout,
                    feas_tol=self.bnb_spec.feas_tol),
                in_axes=(0, 0, 0, 0 if W is not None else None))(
                    x0s, f, h, W)
        spec = self.bnb_spec
        # global wave cannot exceed the pool; spec.capacity only needs
        # to satisfy the wave_size <= capacity construction check (the
        # pooled driver sizes its pool from pool_slots)
        P = pool_slots or 32 * B
        gwave = min(pooled_wave, P)
        # equal per-instance node budget at the global wave size
        gw = max(1, (B * spec.max_waves * spec.wave_size
                     + gwave - 1) // gwave)
        pspec = _dc.replace(spec, wave_size=gwave,
                            capacity=max(spec.capacity, gwave),
                            max_waves=gw)
        res = solve_miqp_bnb_pooled(
            admm, qp, f, h, pspec, pool_slots=P,
            init_incumbent=seed, admm_probe=self._admm_probe,
            branch_map=branch_map)
        v_seq = jax.vmap(qp.full_v)(res.x)          # (B, N, nv)
        info = self.model.info
        v0 = v_seq[:, 0]
        nodes = jnp.broadcast_to(res.nodes_solved, (B,))
        bo = res.best_open_bound
        gap = jnp.where(res.found & jnp.isfinite(bo) & (bo < res.obj),
                        (res.obj - bo)
                        / jnp.maximum(1.0, jnp.abs(res.obj)), 0.0)
        return StructDict(
            u=v0[:, info.u_slice], delta=v0[:, info.delta_slice],
            z=v0[:, info.z_slice], v_seq=v_seq, obj=res.obj,
            found=res.found, nodes=nodes, gap=gap)

    def _feedback_tree_consensus(self, x0, price_seq, u_prev=None):
        """Consensus-ADMM tree MIQP (ops/consensus_tree.py): per-
        scenario QPs + non-anticipativity via group-mean collectives,
        optionally spanning ``scen_mesh``. The tree supplies its own
        disturbance paths; ``price_seq`` is the single-scenario (N, nv)
        sequence (UNWEIGHTED — probabilities live in the iteration)."""
        from pyhybridcontrol_tpu.ops.consensus_tree import (
            assemble_tree, solve_tree_miqp)

        tqp = self._tqp
        Pq = (jnp.asarray(price_seq, jnp.float32)
              if price_seq is not None else None)
        up = (jnp.asarray(u_prev, jnp.float32)
              if u_prev is not None else None)
        f, h = assemble_tree(tqp, x0, price_seq=Pq, u_prev=up)
        res = solve_tree_miqp(tqp, f, h, self.bnb_spec,
                              scen_mesh=self._scen_mesh,
                              tqp_probe=self._tqp_probe)
        info = self.model.info
        V = res.x.reshape(tqp.S, tqp.N, info.nv)
        v0 = V[0, 0]
        return StructDict(
            u=v0[info.u_slice], delta=v0[info.delta_slice],
            z=v0[info.z_slice],
            v_seq=V.reshape(tqp.S * tqp.N, info.nv), obj=res.obj,
            found=res.found, nodes=res.nodes_solved)

    def _feedback_tree_stagewise(self, x0, price_seq, u_prev=None):
        """Scenario-tree MIQP over the stagewise O(N) frame
        (ops/stagewise_tree.py): long-horizon tree MPC — per-scenario
        block-tridiagonal relaxations + group-mean consensus prox,
        optionally spanning ``scen_mesh``. The tree supplies its own
        disturbance paths; ``price_seq`` is the single-scenario (N, nv)
        sequence (UNWEIGHTED — probabilities live in the iteration)."""
        from pyhybridcontrol_tpu.ops.stagewise_tree import (
            assemble_stagewise_tree, solve_tree_miqp_stagewise)

        swt = self._swt
        Pq = (jnp.asarray(price_seq, jnp.float32)
              if price_seq is not None else None)
        up = (jnp.asarray(u_prev, jnp.float32)
              if u_prev is not None else None)
        q, l, u = assemble_stagewise_tree(swt, x0, price_seq=Pq,
                                          u_prev=up)
        ext_u = None
        if swt.sw.n_ext:
            from pyhybridcontrol_tpu.ops.stagewise_tree import (
                assemble_stagewise_tree_ext)
            ext_u = assemble_stagewise_tree_ext(swt, jnp.asarray(x0))
        res = solve_tree_miqp_stagewise(
            swt, q, l, u, self.bnb_spec, swt_probe=self._swt_probe,
            parallel_sweeps=self.sw_parallel,
            scen_mesh=self._scen_mesh, ext_u=ext_u)
        info = self.model.info
        sw = swt.sw
        xi = res.x.reshape(swt.S, sw.N, sw.b)
        v_seq = xi[:, :, : sw.nv]
        v0 = v_seq[0, 0]
        bo = res.best_open_bound
        gap = jnp.where(res.found & jnp.isfinite(bo) & (bo < res.obj),
                        (res.obj - bo)
                        / jnp.maximum(1.0, jnp.abs(res.obj)), 0.0)
        return StructDict(
            u=v0[info.u_slice], delta=v0[info.delta_slice],
            z=v0[info.z_slice],
            v_seq=v_seq.reshape(swt.S * sw.N, info.nv), obj=res.obj,
            found=res.found, nodes=res.nodes_solved, gap=gap,
            x_seq=xi[:, :, sw.nv:])

    def _feedback_stagewise(self, x0, omega_forecast, price_seq,
                            u_prev=None):
        from pyhybridcontrol_tpu.solver.bnb_stagewise import (
            solve_miqp_bnb_stagewise)

        sw = self._sw
        W = (jnp.asarray(omega_forecast, jnp.float32)
             if omega_forecast is not None else None)
        Pq = (jnp.asarray(price_seq, jnp.float32)
              if price_seq is not None else None)
        up = (jnp.asarray(u_prev, jnp.float32)
              if u_prev is not None else None)
        q, l, u = assemble_stagewise(sw, x0, W, Pq, u_prev=up)
        ext_u = None
        if sw.n_ext:
            from pyhybridcontrol_tpu.ops.stagewise import (
                assemble_stagewise_ext)
            ext_u = assemble_stagewise_ext(sw, jnp.asarray(x0), W)
        res = solve_miqp_bnb_stagewise(sw, q, l, u, self.bnb_spec,
                                       sw_probe=self._sw_probe,
                                       parallel_sweeps=self.sw_parallel,
                                       ext_u=ext_u)
        xi = res.x.reshape(sw.N, sw.b)
        v_seq = xi[:, : sw.nv]
        info = self.model.info
        v0 = v_seq[0]
        return StructDict(
            u=v0[info.u_slice], delta=v0[info.delta_slice],
            z=v0[info.z_slice], v_seq=v_seq, obj=res.obj,
            found=res.found, nodes=res.nodes_solved, x_seq=xi[:, sw.nv:])
