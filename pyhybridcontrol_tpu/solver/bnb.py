"""Device-resident branch-and-bound MIQP engine (SURVEY.md §2b ``solver/bnb``
— replaces Gurobi's B&B core, redesigned for XLA's static-shape model).

Design: a *fixed-capacity node pool* with an active mask instead of a
dynamic frontier (SURVEY.md §7 "hard parts"). Each **wave** (one iteration
of a jitted ``lax.while_loop``):

  1. select the W best-bound active nodes (``lax.top_k`` — best-first),
  2. solve their QP relaxations as ONE batched ADMM call (dense matmuls),
  3. solve W *probe* QPs — binaries fixed to the rounded relaxation —
     which is the primal dive heuristic: every feasible probe is a true
     MIQP upper bound, so the incumbent drops early and pruning bites,
  4. prune (infeasible / bound ≥ incumbent − gap / integral relaxation),
  5. branch the survivors on their most-fractional binary: child-0
     overwrites the parent slot, child-1 takes a free slot (best-bound
     children win slots on overflow; overflow is reported — the result is
     then a certified-feasible but possibly suboptimal sequence).

A node is (fix_mask, fix_val) over the binary indices — bounds tightening
only — so the ADMM KKT inverse is shared by every node (see ops/admm.py).
Everything is static-shape; the whole solve is one device program with no
host round-trips. Incumbent monotonicity + bound-validity invariants are
property-tested (SURVEY.md §4.6).

Multi-device: ``parallel/sharded_bnb.py`` shards the pool over a mesh and
all-reduces the incumbent each wave.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from pyhybridcontrol_tpu.ops.admm import BoxQP
from pyhybridcontrol_tpu.ops.condense import DeviceQP

BIG = 1e30


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CondensedBackend:
    """Default QP backend: condensed DeviceQP + dense ADMM. The B&B
    loop only touches this interface, so alternative solvers (the
    stagewise O(N) path — solver/bnb_stagewise.py) plug in the same
    wave loop.

    ``admm_probe``: optional second ADMM prep with a stiffer ρ used for
    DIVE-PROBE solves only. Fully-fixed-binary problems are the
    degenerate implied-equality case (CLAUDE.md): at ρ=1 they plateau
    just above feas_tol for thousands of iterations, at ρ=10 they
    reach primal feasibility in ~200 (measured, dewh UC: 1.5e-5 at 200
    vs 1.7e-3 at 400) — while relaxed-node solves are ρ-insensitive.
    Stiff ρ alone is NOT enough: it parks at primal-feasible points
    whose OBJECTIVE is still far off (battery leaves: feasible to 7e-7
    with obj +4.9e-2 vs the exact leaf optimum), and the incumbent
    gate only checks r_prim. Probes therefore run TWO PHASES on the
    same iteration budget — stiff-ρ for feasibility, then base-ρ
    warm-chained for objective descent. One extra n² K⁻¹; the scaled
    frame (Ruiz D/E) is identical, so warm starts pass between the
    preps unchanged."""

    admm: BoxQP
    qp: DeviceQP
    admm_probe: Optional[BoxQP] = None

    @property
    def n(self):
        return self.qp.n

    @property
    def lb(self):
        return self.qp.lb

    @property
    def ub(self):
        return self.qp.ub

    @property
    def binary_idx(self):
        return self.qp.binary_idx

    @property
    def warm_size(self):
        return self.admm.m_total

    def solve(self, f, h, lb, ub, iters, warm=None):
        from pyhybridcontrol_tpu.ops.admm import admm_solve

        return admm_solve(self.admm, f, h, lb, ub, iters=iters, warm=warm)

    def solve_probe(self, f, h, lb, ub, iters, warm=None):
        from pyhybridcontrol_tpu.ops.admm import admm_solve

        if self.admm_probe is None:
            return admm_solve(self.admm, f, h, lb, ub, iters=iters,
                              warm=warm)
        k = iters // 2
        r1 = admm_solve(self.admm_probe, f, h, lb, ub, iters=k, warm=warm)
        return admm_solve(self.admm, f, h, lb, ub, iters=iters - k,
                          warm=(r1.x, r1.z, r1.y))

    def node_bound(self, res, f, h, lb, ub):
        from pyhybridcontrol_tpu.ops.admm import admm_dual_bound

        return admm_dual_bound(self.admm, f, h, lb, ub, res)

    def node_cert(self, res, f, h, lb, ub):
        """Falk cert + per-binary presolve data (ops/admm.py
        ``admm_node_cert``): reduced-cost flip deltas and implied
        binary boxes — enables node-presolve fixing in the wave loop."""
        from pyhybridcontrol_tpu.ops.admm import admm_node_cert

        return admm_node_cert(self.admm, f, h, lb, ub, res,
                              self.binary_idx)

    def broadcast_data(self, f, h, W):
        return (jnp.broadcast_to(f, (W,) + f.shape),
                jnp.broadcast_to(h, (W,) + h.shape))


@dataclasses.dataclass(frozen=True)
class BnbSpec:
    """Static B&B configuration."""

    capacity: int = 512          # node-pool slots
    wave_size: int = 64          # nodes relaxed per wave
    max_waves: int = 64
    qp_iters: int = 100
    feas_tol: float = 1e-3       # "converged" primal-residual tolerance
    infeas_tol: float = 0.5      # residual fallback for "clearly
    # infeasible" — primary detection is the ADMM dual certificate
    # (AdmmResult.infeas_cert); anything between feas_tol and this is
    # "unconverged": branch anyway on the parent bound rather than
    # wrongly pruning a hard-but-feasible relaxation (degenerate PWA
    # relaxations sit at large residuals for thousands of iterations).
    int_tol: float = 1e-3        # integrality tolerance on relaxed binaries
    gap: float = 1e-4            # absolute pruning gap margin
    inc_tol: float = 0.0         # INCUMBENT acceptance primal tolerance;
    # 0 → feas_tol. A probe iterate accepted at r≈feas_tol can report
    # an objective ~|y|·r away from the true leaf optimum; the
    # certified clamp in do_probe (max with the leaf's dual bound)
    # removes the gross-underestimate side, and this knob lets
    # parity-critical runs demand near-converged incumbents (well-
    # conditioned two-phase probes reach 1e-5–1e-7: dewh 1.5e-5 @200
    # iters, battery 7e-7). Consensus-tree probes legitimately plateau
    # near 1e-4 while feasible, so the strict setting is opt-in.
    warm_start: bool = True      # children inherit parent ADMM iterates
    # (x, z, y) through the node pool — fewer iterations to re-converge
    probe_iters: int = 0         # iterations for dive probes / leaf
    # evaluation; 0 → same as qp_iters. Degenerate big-M leaves need
    # several thousand iterations to certify (see PERF.md).
    rel_gap: float = 0.0         # relative MIPGap termination (the
    # reference's Gurobi MIPGap option, SURVEY.md §2a): stop once
    # (incumbent − best open bound) ≤ rel_gap·max(1, |incumbent|).
    # 0 → run to optimality/pool exhaustion/max_waves.
    probe_patience: int = 0      # probe gating: 0 → dive-probe every
    # wave (always-on); k>0 → once probes have failed to improve the
    # incumbent k waves in a row, probe only every (k+1)-th wave
    # (periodic retry; a success resets the counter and full probing
    # resumes) — cuts k/(k+1) of the probe QP work in the common tail
    # where pruning alone finishes. The gate is decided BEFORE the
    # wave; leaf/integral nodes
    # met on a gated wave are DEFERRED to the next probing wave, so
    # every incumbent still comes from the probe + certified clamp.
    branching: str = "pseudocost"   # "pseudocost" (reliability-style
    # scores learned from observed bound degradations, most-fractional
    # fallback while uninitialized), "most_frac" (round-1 behavior), or
    # "flipdelta" (certified one-sided strong-branching score from the
    # Falk cert's flip deltas — free; measured −23% nodes on UC/dewh,
    # but WORSE on hull-PWA where one-sided scores mislead, hence not
    # the default; needs presolve_fix, falls back to most_frac).
    presolve_fix: bool = True    # node presolve from the Falk cert's
    # per-binary data (backends exposing node_cert): reduced-cost
    # fixing (bound + flip_delta_j ≥ incumbent − gap proves the flip
    # side of binary j cannot win → fix to the tangent side) and
    # implied-integrality fixing (the node's implied box excludes one
    # integral value). Fixings apply to the node's children, shrinking
    # the subtree; both are certificate-backed, so the returned optimum
    # is unchanged (gap-semantics identical to bound pruning).
    pool_norm: str = "none"      # pooled-driver (solver/bnb_pooled.py)
    # selection normalization: "none" ranks nodes by raw bound (exactly
    # fair for homogeneous batches — the scenario/batched-feedback use
    # case), "relgap" by (bound − incumbent)/max(1,|incumbent|) of the
    # owning instance, so heterogeneous objective SCALES share waves by
    # relative remaining gap instead of the low-scale instances
    # monopolizing every selection. Ignored by the single-instance loop.
    depth_tiebreak: float = 0.0  # best-first tie-break: selection
    # priority becomes bound − depth_tiebreak·depth. Frontier bounds
    # cluster on exact plateaus (both children inherit the same
    # max(parent, cert)), where top_k's index tie-break degenerates to
    # breadth-first — the engine then explores wide and shallow and the
    # certified gap stalls (measured on config 2: 4% at 7400 nodes vs
    # 681 nodes for an exact-bound SEQUENTIAL best-first). A small
    # depth preference restores diving on plateaus. Search-order only —
    # bounds/pruning are unchanged, so the returned optimum and every
    # certificate stay exact. Scale it well below the gap you care
    # about (it perturbs selection, not correctness).
    sb_iters: int = 0            # batched ROOT strong branching: 0 = off;
    # k>0 → after the root relaxation, ALL 2·nb candidate children
    # (each unfixed binary fixed to 0 and to 1) are solved as ONE
    # batched QP of k iterations, warm-started from the root iterate —
    # batched work a CPU solver cannot afford but a device wave
    # absorbs (~2 waves of extra work at nb=60). The certified child
    # bounds then (a) initialize the pseudo-cost tables with REAL
    # observed degradations instead of the f·(1−f) bootstrap, (b) fix
    # binaries whose one side is dual-certificate infeasible (child
    # (j,v) infeasible ⇒ δ_j = 1−v in every feasible point), and
    # (c) lift the root bound to max_j min(bound_j0, bound_j1) — valid
    # because every integral point has δ_j ∈ {0,1}, so the better of
    # the two child bounds over the worse branch is a bound on ALL of
    # them. Only the dual infeasibility certificate may fix (a large
    # residual at few iterations is just "unconverged").
    sb_fix: bool = False         # enable the (b)/(c) arms above. OFF by
    # default: both are only as sound as the certificates' ARITHMETIC —
    # on the earlier accelerator's emulated fp32 the same program that
    # wins on CPU produced a 3.7%-worse incumbent (63.26 vs 61.0),
    # consistent with a borderline certificate fixing away the optimal
    # subtree. Pseudo-cost seeding (a) is search-order-only and always
    # safe. Turn this on for CPU/fp64-grade runs or after validating
    # the cert margins on the target arithmetic.
    dive_slots: int = 0          # wave slots reserved for the DEEPEST
    # active nodes (ties broken best-bound): a guaranteed diving lane
    # alongside best-first selection. Why: the engine's ONLY incumbent
    # source is the dive probe, and a probe is feasible only when the
    # node's rounded relaxation is a consistent trajectory — on
    # degenerate hull faces (config 2: 44 binaries fractional at the
    # root) shallow nodes' roundings are jointly contradictory, and a
    # best-first order that stalls on a bound plateau then starves the
    # incumbent channel for the entire run (measured three ways: chip
    # root_iters×sb shipped the 84.03 repair seed for 64 waves; adding
    # 80 CGLP cut rows reproduced the same 84.05 starvation on CPU;
    # baseline orders escape only by luck of the face vertex). The dive
    # lane guarantees depth progress ~1 level/wave, so within ~nb waves
    # some probes run from fully-consistent subtrees. Search-order
    # only: bounds, pruning and certificates are unchanged.
    root_iters: int = 0          # extra-converged root relaxation: the
    # root is ONE solve whose bound gates the entire search — if it
    # does not reach feas_tol within qp_iters, every descendant
    # inherits a −∞ bound and pruning/rel_gap never engage (measured:
    # battery N=24 TOU root needs ~3000 iters vs per-node 300).
    # root_iters > qp_iters pre-solves the root for (root_iters −
    # qp_iters) iterations and stores the iterates as its warm start,
    # so the wave-1 root solve finishes the remaining qp_iters from
    # there. 0 → off. Needs warm_start.

    def __post_init__(self):
        if self.wave_size > self.capacity:
            # would otherwise surface as a cryptic lax.top_k shape error
            # deep inside the jitted wave loop
            raise ValueError(
                f"wave_size ({self.wave_size}) cannot exceed pool "
                f"capacity ({self.capacity})")
        if self.capacity < 2 or self.wave_size < 1:
            raise ValueError("need capacity >= 2 and wave_size >= 1")
        if self.branching not in ("pseudocost", "most_frac", "flipdelta"):
            raise ValueError(f"unknown branching {self.branching!r}")
        if self.rel_gap < 0 or self.probe_patience < 0:
            raise ValueError("rel_gap and probe_patience must be >= 0")
        if self.sb_iters < 0:
            raise ValueError("sb_iters must be >= 0")
        if self.depth_tiebreak < 0:
            raise ValueError("depth_tiebreak must be >= 0")
        if not 0 <= self.dive_slots < self.wave_size:
            raise ValueError("need 0 <= dive_slots < wave_size")
        if self.pool_norm not in ("none", "relgap"):
            raise ValueError(f"unknown pool_norm {self.pool_norm!r}")


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BnbState:
    fix_mask: jnp.ndarray     # (C, nb) bool
    fix_val: jnp.ndarray      # (C, nb) f32
    x_pool: jnp.ndarray       # (C, n) parent primal (original units)
    z_pool: jnp.ndarray       # (C, m̄) parent z (scaled frame)
    y_pool: jnp.ndarray       # (C, m̄) parent dual (scaled frame)
    bound: jnp.ndarray        # (C,) parent relaxation lower bound
    active: jnp.ndarray       # (C,) bool
    depth: jnp.ndarray        # (C,) i32
    branch_var: jnp.ndarray   # (C,) i32 — binary this node was created by
    #                           branching on (−1 for the root/seeded)
    branch_dir: jnp.ndarray   # (C,) i32 — 0 (fixed to 0) / 1 (fixed to 1)
    branch_frac: jnp.ndarray  # (C,) f32 — parent's relaxed value of that
    #                           binary (pseudo-cost denominator)
    pc_sum: jnp.ndarray       # (nb, 2) pseudo-cost accumulators: observed
    pc_cnt: jnp.ndarray       # (nb, 2) per-unit bound degradation by dir
    inc_obj: jnp.ndarray      # () incumbent objective
    inc_x: jnp.ndarray        # (n,) incumbent solution
    inc_found: jnp.ndarray    # () bool
    wave: jnp.ndarray         # () i32
    nodes_solved: jnp.ndarray  # () i32
    overflow: jnp.ndarray     # () bool
    alive: jnp.ndarray        # () bool — any active node (globally, when
    #                           a global_any_active hook is installed)
    probe_stale: jnp.ndarray  # () i32 — waves since a probe improved the
    #                           incumbent (probe gating)
    best_open: jnp.ndarray    # () f32 — min bound over open nodes
    #                           (globally reduced; rel_gap termination)
    dropped_min: jnp.ndarray  # () f32 — min bound over children DROPPED
    #                           on pool overflow: their subtrees are
    #                           never explored, so every best_open /
    #                           certified-gap statement must fold this
    #                           in or the gap would silently exclude
    #                           lost regions (BIG when nothing dropped)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BnbResult:
    x: jnp.ndarray
    obj: jnp.ndarray
    found: jnp.ndarray
    waves: jnp.ndarray
    nodes_solved: jnp.ndarray
    overflow: jnp.ndarray
    best_open_bound: jnp.ndarray   # min bound over still-open nodes (gap)


def _init_state(qp, spec: BnbSpec, dtype, m_total: int
                ) -> BnbState:
    C, nb, n = spec.capacity, len(qp.binary_idx), qp.n
    mw = m_total if spec.warm_start else 1
    nw = n if spec.warm_start else 1
    return BnbState(
        fix_mask=jnp.zeros((C, nb), bool),
        fix_val=jnp.zeros((C, nb), dtype),
        x_pool=jnp.zeros((C, nw), dtype),
        z_pool=jnp.zeros((C, mw), dtype),
        y_pool=jnp.zeros((C, mw), dtype),
        bound=jnp.full((C,), -BIG, dtype),
        active=jnp.zeros((C,), bool).at[0].set(True),
        depth=jnp.zeros((C,), jnp.int32),
        branch_var=jnp.full((C,), -1, jnp.int32),
        branch_dir=jnp.zeros((C,), jnp.int32),
        branch_frac=jnp.full((C,), 0.5, dtype),
        pc_sum=jnp.zeros((max(nb, 1), 2), dtype),
        pc_cnt=jnp.zeros((max(nb, 1), 2), dtype),
        inc_obj=jnp.asarray(BIG, dtype),
        inc_x=jnp.zeros((n,), dtype),
        inc_found=jnp.asarray(False),
        wave=jnp.asarray(0, jnp.int32),
        nodes_solved=jnp.asarray(0, jnp.int32),
        overflow=jnp.asarray(False),
        alive=jnp.asarray(True),
        probe_stale=jnp.asarray(0, jnp.int32),
        best_open=jnp.asarray(-BIG, dtype),
        dropped_min=jnp.asarray(BIG, dtype),
    )


def _bnb_loop(backend, f, h, spec: BnbSpec,
              root_active: bool = True,
              exchange_children=None,
              reduce_incumbent=None,
              global_any_active=None,
              root_device_pred=None,
              init_incumbent=None,
              reduce_min=None,
              init_node=None) -> BnbResult:
    """Shared B&B wave loop. The optional hooks are the multi-device
    seams (SURVEY.md §2b ``dist/collective``):

      exchange_children(pytree) — permute the child-1 batch across devices
        (load balancing); identity when single-device.
      reduce_incumbent(obj, x, found) — all-reduce-min the incumbent.
      global_any_active(bool) — OR-reduce the termination flag.
      reduce_min(x) — all-reduce-min of the best open bound (rel_gap
        termination must see the GLOBAL bound so every device stops on
        the same wave).

    Called directly for single-chip solves and from inside ``shard_map``
    for pool-sharded solves (parallel/sharded_bnb.py).
    """
    nb = len(backend.binary_idx)
    if nb == 0:
        res = backend.solve(f, h, backend.lb, backend.ub, spec.qp_iters)
        zero = jnp.asarray(0, jnp.int32)
        return BnbResult(res.x, res.obj, res.r_prim_rel < spec.feas_tol,
                         zero, jnp.asarray(1, jnp.int32),
                         jnp.asarray(False), res.obj)
    bidx = jnp.asarray(np.asarray(backend.binary_idx, np.int32))
    W = spec.wave_size
    dtype = jnp.result_type(f)
    state = _init_state(backend, spec, dtype, backend.warm_size)
    if not root_active:
        state = dataclasses.replace(
            state, active=jnp.zeros_like(state.active))
    if root_device_pred is not None:
        # SPMD: only the root device's pool starts with the root node
        state = dataclasses.replace(
            state, active=state.active & root_device_pred)
    if init_incumbent is not None:
        # seed from a heuristic (e.g. rollout repair — solver/repair.py):
        # any feasible point is a valid upper bound from wave 0.
        obj0, x0V, ok0 = init_incumbent
        state = dataclasses.replace(
            state,
            inc_obj=jnp.where(ok0, obj0.astype(state.inc_obj.dtype),
                              state.inc_obj),
            inc_x=jnp.where(ok0, x0V.astype(state.inc_x.dtype),
                            state.inc_x),
            inc_found=state.inc_found | ok0)
    if spec.root_iters > spec.qp_iters and spec.warm_start:
        # pre-converge the root relaxation (see BnbSpec.root_iters)
        r0 = backend.solve(f, h, backend.lb, backend.ub,
                           spec.root_iters - spec.qp_iters)
        state = dataclasses.replace(
            state,
            x_pool=state.x_pool.at[0].set(r0.x.astype(state.x_pool.dtype)),
            z_pool=state.z_pool.at[0].set(r0.z.astype(state.z_pool.dtype)),
            y_pool=state.y_pool.at[0].set(r0.y.astype(state.y_pool.dtype)))
    if init_node is not None:
        # inject a candidate ASSIGNMENT as a fully-fixed pool node (the
        # closed-loop carried-plan warm start — SURVEY.md §3.3). Unlike
        # a heuristic incumbent, no extra QP solve happens up front: the
        # node rides wave 1 next to the root (bound −BIG → top
        # priority), its relaxation IS the fixed-binary solve, and the
        # probe turns it into an incumbent if feasible. Zero marginal
        # cost — wave 1 has W slots and uses two.
        bv0, okn, xw = init_node
        state = dataclasses.replace(
            state,
            active=state.active.at[1].set(
                okn if root_device_pred is None
                else okn & root_device_pred),
            fix_mask=state.fix_mask.at[1].set(jnp.ones((nb,), bool)),
            fix_val=state.fix_val.at[1].set(bv0.astype(dtype)))
        if spec.warm_start and xw is not None:
            state = dataclasses.replace(
                state,
                x_pool=state.x_pool.at[1].set(
                    xw.astype(state.x_pool.dtype)))

    def node_bounds(fm, fv):
        """(W, n) lb/ub for nodes given fixed-binary masks/values."""
        Wb = fm.shape[0]
        lb = jnp.broadcast_to(backend.lb, (Wb, backend.n))
        ub = jnp.broadcast_to(backend.ub, (Wb, backend.n))
        lb = lb.at[:, bidx].set(jnp.where(fm, fv, 0.0))
        ub = ub.at[:, bidx].set(jnp.where(fm, fv, 1.0))
        return lb, ub

    fb, hb = backend.broadcast_data(f, h, W)

    node_bound_root = getattr(backend, "node_bound", None)
    if spec.sb_iters > 0 and node_bound_root is not None:
        # -- batched root strong branching (BnbSpec.sb_iters) ------------
        # All 2·nb candidate children as ONE batched solve: real
        # pseudo-cost initialization, certificate-backed root fixing,
        # and the max_j min(child bounds) root-bound lift. Everything
        # below is certified (Falk bounds valid at any iterate; only
        # the dual infeasibility certificate may fix), so the returned
        # optimum is unchanged — search order and pruning improve.
        warm0 = ((state.x_pool[0], state.z_pool[0], state.y_pool[0])
                 if spec.warm_start and spec.root_iters > spec.qp_iters
                 else None)
        r_root = backend.solve(f, h, backend.lb, backend.ub,
                               spec.qp_iters, warm=warm0)
        rb = node_bound_root(r_root, f, h, backend.lb, backend.ub)
        root_bound = jnp.where(jnp.isfinite(rb), rb, -BIG)
        xb0 = jnp.clip(r_root.x[bidx], 0.0, 1.0)
        # candidate matrix: rows [0,nb) fix δ_j=0, [nb,2nb) =1
        SB = 2 * nb
        jrow = jnp.arange(SB, dtype=jnp.int32) % nb
        vrow = jnp.arange(SB, dtype=jnp.int32) >= nb
        fmc = jax.nn.one_hot(jrow, nb, dtype=bool)
        fvc = jnp.where(fmc & vrow[:, None], 1.0, 0.0).astype(dtype)
        lbc, ubc = node_bounds(fmc, fvc)
        fc, hc = backend.broadcast_data(f, h, SB)
        warmc = (jnp.broadcast_to(r_root.x, (SB,) + r_root.x.shape),
                 jnp.broadcast_to(r_root.z, (SB,) + r_root.z.shape),
                 jnp.broadcast_to(r_root.y, (SB,) + r_root.y.shape))
        # the (b)/(c) arms below fix variables and lift bounds off these
        # certificates: they are as sound as the spec's cert arithmetic
        # (BoxQP.dd_cert)
        rcand = backend.solve(fc, hc, lbc, ubc, spec.sb_iters, warm=warmc)
        certc = node_bound_root(rcand, fc, hc, lbc, ubc)
        certc = jnp.where(jnp.isfinite(certc),
                          jnp.maximum(certc, root_bound), root_bound)
        infc = rcand.infeas_cert      # dual certificate ONLY (a large
        # residual at sb_iters is just "unconverged", never a fixing)
        certc = jnp.where(infc, BIG, certc)
        cert0, cert1 = certc[:nb], certc[nb:]
        inf0, inf1 = infc[:nb], infc[nb:]
        # (a) pseudo-cost seeding with real per-unit degradations;
        # infeasible children count as the largest finite gain observed
        gain0 = jnp.maximum(jnp.where(inf0, 0.0, cert0) - root_bound, 0.0)
        gain1 = jnp.maximum(jnp.where(inf1, 0.0, cert1) - root_bound, 0.0)
        gmax = jnp.maximum(jnp.max(jnp.maximum(gain0, gain1)), 1.0)
        gain0 = jnp.where(inf0, gmax, gain0)
        gain1 = jnp.where(inf1, gmax, gain1)
        pc_sum = (state.pc_sum
                  .at[:nb, 0].add(gain0 / jnp.maximum(xb0, 1e-3))
                  .at[:nb, 1].add(gain1 / jnp.maximum(1.0 - xb0, 1e-3)))
        pc_cnt = state.pc_cnt.at[:nb, :].add(1.0)
        state = dataclasses.replace(state, pc_sum=pc_sum, pc_cnt=pc_cnt)
        if spec.sb_fix:
            # (b) root fixing: side v certified infeasible, or (with an
            # incumbent seed) certified unable to beat it → fix to 1−v
            lose0 = inf0 | (state.inc_found
                            & (cert0 >= state.inc_obj - spec.gap))
            lose1 = inf1 | (state.inc_found
                            & (cert1 >= state.inc_obj - spec.gap))
            fixj = lose0 | lose1
            valj = jnp.where(lose0, 1.0, 0.0).astype(dtype)
            # (c) root-bound lift: every integral point has δ_j ∈ {0,1}
            lift = jnp.max(jnp.minimum(cert0, cert1))
            lift = jnp.maximum(lift, root_bound)
            state = dataclasses.replace(
                state,
                fix_mask=state.fix_mask.at[0].set(
                    state.fix_mask[0] | fixj),
                fix_val=state.fix_val.at[0].set(
                    jnp.where(fixj, valj, state.fix_val[0])),
                bound=state.bound.at[0].set(
                    jnp.maximum(state.bound[0], lift)))
        if spec.warm_start:
            state = dataclasses.replace(
                state,
                x_pool=state.x_pool.at[0].set(
                    r_root.x.astype(state.x_pool.dtype)),
                z_pool=state.z_pool.at[0].set(
                    r_root.z.astype(state.z_pool.dtype)),
                y_pool=state.y_pool.at[0].set(
                    r_root.y.astype(state.y_pool.dtype)))

    def cond(s: BnbState):
        live = s.alive & (s.wave < spec.max_waves)
        if spec.rel_gap > 0:
            # relative MIPGap stop (reference Gurobi-option parity):
            # best_open is the globally-reduced min open bound of the
            # previous wave, so the decision is identical on every
            # device (lock-step SPMD safe).
            tol = spec.rel_gap * jnp.maximum(1.0, jnp.abs(s.inc_obj))
            live &= ~(s.inc_found & (s.inc_obj - s.best_open <= tol))
        return live

    def body(s: BnbState) -> BnbState:
        # -- 1. best-first selection (+ optional dive lane) ---------------
        pri_val = s.bound
        if spec.depth_tiebreak > 0:
            pri_val = pri_val - spec.depth_tiebreak * s.depth
        pri = jnp.where(s.active, pri_val, BIG)
        if spec.dive_slots > 0:
            # reserve dive_slots for the DEEPEST active nodes (ties →
            # best bound): the guaranteed diving lane (BnbSpec.
            # dive_slots). Best-first picks W−k first; the dive top_k
            # then runs over the REMAINING nodes (selected ones masked
            # out), so the two lanes never collide on a slot.
            k = spec.dive_slots
            neg, sel_b = jax.lax.top_k(-pri, W - k)
            taken = jnp.zeros_like(s.active).at[sel_b].set(True)
            dive_pri = jnp.where(
                s.active & ~taken,
                s.depth.astype(pri.dtype)
                - jnp.clip(s.bound, -BIG, BIG) * 1e-9,
                -BIG)
            dval, sel_d = jax.lax.top_k(dive_pri, k)
            # fewer active-unselected nodes than k → top_k returns
            # arbitrary (-BIG) slots, possibly DUPLICATING a best-first
            # pick: such entries are invalidated AND redirected to the
            # out-of-bounds sentinel slot, so their scatters DROP
            # (default jax scatter OOB semantics) instead of racing the
            # best-first copy's writes on the shared slot (last-write-
            # wins would silently deactivate an expanded node — a
            # dropped subtree with no overflow flag).
            valid_d = s.active[sel_d] & (dval > -BIG)
            sel_d = jnp.where(dval > -BIG, sel_d, spec.capacity)
            sel = jnp.concatenate([sel_b, sel_d])
            valid = jnp.concatenate([s.active[sel_b], valid_d])
        else:
            neg, sel = jax.lax.top_k(-pri, W)
            valid = s.active[sel]
        fm = s.fix_mask[sel]
        fv = s.fix_val[sel]
        parent_bound = s.bound[sel]

        # -- 2. batched relaxations + gated dive probe --------------------
        lb, ub = node_bounds(fm, fv)
        warm = ((s.x_pool[sel], s.z_pool[sel], s.y_pool[sel])
                if spec.warm_start else None)
        node_bound = getattr(backend, "node_bound", None)
        node_cert = (getattr(backend, "node_cert", None)
                     if spec.presolve_fix and nb > 0 else None)
        piters = spec.probe_iters or spec.qp_iters
        acc_tol = spec.inc_tol or spec.feas_tol

        # probe gate, decided BEFORE the wave (round-3): the round-2
        # gate also probed whenever the selection held integral/leaf
        # nodes — but that reads the relaxation, serializing relax →
        # decision → probe.
        # Leaves no longer need it: integral/leaf relaxations become
        # incumbents directly (harvest below) and unresolved leaves are
        # DEFERRED to the next probing wave instead of pruned.
        if spec.probe_patience == 0:
            probe_ran = jnp.asarray(True)
        else:
            retry = (s.wave % jnp.int32(spec.probe_patience + 1)) == 0
            probe_ran = (~s.inc_found | retry
                         | (s.probe_stale < spec.probe_patience))

        def wave_probe(_):
            relax = backend.solve(fb, hb, lb, ub, spec.qp_iters, warm=warm)
            xb = relax.x[:, bidx]
            pv = jnp.where(fm, fv, jnp.round(jnp.clip(xb, 0.0, 1.0)))
            lb_p, ub_p = node_bounds(jnp.ones_like(fm), pv)
            probe = backend.solve_probe(
                fb, hb, lb_p, ub_p, piters,
                warm=(relax.x, relax.z, relax.y))
            ok = (probe.r_prim_rel < acc_tol) & valid
            pobj = probe.obj
            if node_bound is not None:
                # Clamp the candidate with the leaf's certified dual
                # bound: a feas_tol-feasible but unconverged probe
                # iterate can report an objective BELOW the true leaf
                # optimum (measured: −42.93 vs −42.69, 0.57%),
                # corrupting both the reported incumbent and pruning.
                pcert = node_bound(probe, fb, hb, lb_p, ub_p)
                pobj = jnp.where(jnp.isfinite(pcert),
                                 jnp.maximum(pobj, pcert), pobj)
            return relax, jnp.where(ok, pobj, BIG), probe.x, ok

        def wave_noprobe(_):
            relax = backend.solve(fb, hb, lb, ub, spec.qp_iters,
                                  warm=warm)
            return (relax, jnp.full((W,), BIG, dtype),
                    jnp.zeros_like(relax.x), jnp.zeros((W,), bool))

        if spec.probe_patience == 0:
            relax, probe_obj, probe_x, probe_ok = wave_probe(None)
        else:
            relax, probe_obj, probe_x, probe_ok = jax.lax.cond(
                probe_ran, wave_probe, wave_noprobe, None)

        converged = relax.r_prim_rel < spec.feas_tol
        infeasible = relax.infeas_cert | (relax.r_prim_rel > spec.infeas_tol)
        presolve = None
        if node_cert is not None:
            # CERTIFIED dual bound + per-binary presolve data (flip
            # deltas for reduced-cost fixing, implied binary boxes) —
            # same price as node_bound plus a few elementwise ops.
            cert, flip_delta, retain_side, imp_lo, imp_hi = node_cert(
                relax, fb, hb, lb, ub)
            presolve = (flip_delta, retain_side, imp_lo, imp_hi)
            cert_fin = jnp.isfinite(cert)
            cert = jnp.where(cert_fin, cert, parent_bound)
            lower = jnp.where(valid & ~infeasible,
                              jnp.maximum(parent_bound, cert), BIG)
            bound_certified = True
        elif node_bound is not None:
            # CERTIFIED dual bound (ops/admm.py admm_dual_bound): valid
            # for any iterate, so every node gets a usable bound and
            # bound-pruning needs no convergence gate. relax.obj of a
            # merely primal-feasible iterate can overestimate the true
            # relaxation value by ~1e-2 — enough to wrongly prune
            # optimal subtrees at gap=1e-4 (battery family, measured).
            cert = node_bound(relax, fb, hb, lb, ub)
            cert_fin = jnp.isfinite(cert)
            cert = jnp.where(cert_fin, cert, parent_bound)
            lower = jnp.where(valid & ~infeasible,
                              jnp.maximum(parent_bound, cert), BIG)
            bound_certified = True
        else:
            # trustworthy only when converged; otherwise inherit the
            # parent bound (still valid) so child ordering stays sane.
            lower = jnp.where(
                valid & converged, relax.obj,
                jnp.where(valid & ~infeasible, parent_bound, BIG))
            bound_certified = False

        xb = relax.x[:, bidx]
        rounded = jnp.round(jnp.clip(xb, 0.0, 1.0))
        frac = jnp.where(fm, 0.0, jnp.abs(xb - rounded))
        max_frac = jnp.max(frac, axis=1) if nb > 0 else jnp.zeros(W)
        integral = max_frac < spec.int_tol
        fully_fixed = jnp.all(fm, axis=1)   # leaf: nothing left to branch

        # -- 2b. pseudo-cost observation --------------------------------
        # Each solved node whose bound is trustworthy reports the bound
        # degradation caused by the branching that created it, per unit
        # of the parent's fractional distance in that direction
        # (classic pseudo-costs, cf. Achterberg's reliability
        # branching). Accumulators live in the loop state; in sharded
        # runs each device learns from its own pool (statistics differ
        # but bounds stay exact — search quality only).
        bv = s.branch_var[sel]
        bdir = s.branch_dir[sel]
        bf = jnp.clip(s.branch_frac[sel], 0.0, 1.0)
        obs = valid & converged & (bv >= 0)
        gain = jnp.maximum(lower - parent_bound, 0.0)
        denom = jnp.where(bdir == 1, 1.0 - bf, bf)
        contrib = jnp.where(obs, gain / jnp.maximum(denom, 1e-3), 0.0)
        bv_safe = jnp.where(obs, bv, nb)             # OOB → dropped
        pc_sum = s.pc_sum.at[bv_safe, bdir].add(contrib, mode="drop")
        pc_cnt = s.pc_cnt.at[bv_safe, bdir].add(
            obs.astype(s.pc_cnt.dtype), mode="drop")

        # -- 3. incumbent update (probe candidates only) ------------------
        # Incumbents flow EXCLUSIVELY through the high-iteration probe
        # + certified clamp: a first harvest design recorded integral
        # relaxations directly, but a qp_iters iterate's objective can
        # sit BELOW the true optimum by more than the cert gap — the
        # round-3 parity sweep caught the device reporting objectives
        # 7e-4 rel UNDER the fp64 oracle. Leaf candidates met on gated
        # waves are deferred instead (see prune below).
        k = jnp.argmin(probe_obj)
        better = probe_obj[k] < s.inc_obj
        inc_obj = jnp.where(better, probe_obj[k], s.inc_obj)
        inc_x = jnp.where(better, probe_x[k], s.inc_x)
        inc_found = s.inc_found | (better & probe_ok[k])
        probe_stale = jnp.where(
            probe_ran & better, 0,
            s.probe_stale + probe_ran.astype(jnp.int32))
        if reduce_incumbent is not None:
            inc_obj, inc_x, inc_found = reduce_incumbent(
                inc_obj, inc_x, inc_found)

        # -- 4. prune ----------------------------------------------------
        bound_prune = (lower >= inc_obj - spec.gap)
        if not bound_certified:
            bound_prune &= converged
        # DEFER leaf candidates on probe-gated waves: a fully-fixed or
        # integral node would otherwise be pruned without its value
        # ever being recorded (only the probe + certified clamp may
        # produce incumbents — see the incumbent update above). The
        # node stays active with its tightened bound and resolves on
        # the next probing wave (the periodic retry bounds the wait to
        # `patience` waves); on probing waves behavior is identical to
        # round 2.
        leaf_unresolved = (valid & ~infeasible & ~probe_ran
                           & (fully_fixed | (converged & integral)))
        prune = ((~valid) | infeasible
                 | (fully_fixed & ~leaf_unresolved)
                 | bound_prune
                 | (converged & integral & ~leaf_unresolved))
        expand = valid & ~prune

        # -- 4b. node presolve (certificate-backed binary fixing) --------
        if presolve is not None:
            flip_delta, retain_side, imp_lo, imp_hi = presolve
            unfixed = ~fm
            ok_node = (valid & ~infeasible)[:, None]
            # reduced-cost fixing: flipping binary j provably cannot
            # beat the incumbent → fix j to the tangent-retained side
            flip_bound = jnp.maximum(
                parent_bound[:, None],
                jnp.where(cert_fin[:, None], cert[:, None] + flip_delta,
                          -BIG))
            rc = (unfixed & ok_node & inc_found
                  & (flip_bound >= inc_obj - spec.gap))
            # implied-integrality fixing: the node's implied box
            # excludes one integral value of the binary
            imp1 = unfixed & ok_node & (imp_lo > 1e-2)
            imp0 = unfixed & ok_node & (imp_hi < 1.0 - 1e-2)
            newv = jnp.where(imp1, 1.0,
                             jnp.where(imp0, 0.0,
                                       jnp.where(rc, retain_side, fv)))
            fm2 = fm | rc | imp0 | imp1
            fv2 = jnp.where(fm, fv, newv)
        else:
            fm2, fv2 = fm, fv

        # -- 5. branch ---------------------------------------------------
        # certified bounds are valid at ANY iterate — children inherit
        # them unconditionally; only the uncertified fallback needs the
        # convergence gate.
        if bound_certified:
            child_bound = jnp.where(expand, jnp.maximum(parent_bound,
                                                        lower),
                                    parent_bound)
        else:
            child_bound = jnp.maximum(
                parent_bound, jnp.where(converged, lower, parent_bound))
        xbc = jnp.clip(xb, 0.0, 1.0)
        if spec.branching == "pseudocost":
            # product rule over estimated down/up degradations; vars
            # without observations use the global per-direction mean
            # (1.0 before any observation exists → score reduces to
            # f·(1−f), i.e. most-fractional-at-0.5 bootstrap).
            cnt_tot = jnp.sum(pc_cnt, axis=0)                    # (2,)
            gavg = jnp.where(cnt_tot > 0,
                             jnp.sum(pc_sum, axis=0)
                             / jnp.maximum(cnt_tot, 1.0), 1.0)
            avg = pc_sum / jnp.maximum(pc_cnt, 1.0)              # (nb,2)
            est = jnp.where(pc_cnt > 0, avg, gavg[None, :])
            sc = (jnp.maximum(est[None, :, 0] * xbc, 1e-8)
                  * jnp.maximum(est[None, :, 1] * (1.0 - xbc), 1e-8))
            # keep genuinely fractional vars preferred over near-
            # integral ones regardless of cost estimates
            sc = sc * jnp.maximum(frac, 1e-4)
            score = jnp.where(fm2, -1.0, sc)
        elif spec.branching == "flipdelta" and presolve is not None:
            # certified one-sided strong-branching score for free: the
            # Falk flip delta is the PROVEN bound increase of the
            # tangent-disfavoured child. Blend with fractionality so
            # integral-but-stiff vars don't dominate.
            score = jnp.where(fm2, -1.0,
                              flip_delta * jnp.maximum(frac, 1e-4))
        else:
            score = jnp.where(fm2, -1.0, frac)
        jstar = jnp.argmax(score, axis=1)
        # presolve may fix EVERYTHING: the node becomes its own leaf —
        # child-0 keeps (fm2, fv2) unbranched (probed/pruned when next
        # selected), child-1 is dead.
        has_branch = jnp.any(~fm2, axis=1)
        branch_hot = (jax.nn.one_hot(jstar, nb, dtype=bool)
                      & has_branch[:, None])
        cfm = fm2 | branch_hot
        cfv0 = jnp.where(branch_hot, 0.0, fv2)
        cfv1 = jnp.where(branch_hot, 1.0, fv2)
        cdepth = s.depth[sel] + 1
        cbf = jnp.take_along_axis(xbc, jstar[:, None], axis=1)[:, 0]
        cbv = jnp.where(has_branch, jstar, -1).astype(jnp.int32)
        # flip-delta child bound: the Falk cert's flip delta is the
        # PROVEN extra bound of the child fixed to the tangent-
        # disfavoured side of jstar — frontier bounds then lead the
        # parent level by one step (the exact sequential tree solves
        # every child's relaxation at creation; this recovers that for
        # free on one side). Certified → best_open/gap stay exact.
        if presolve is not None:
            fd_j = jnp.take_along_axis(flip_delta, jstar[:, None],
                                       axis=1)[:, 0]
            rs_j = jnp.take_along_axis(retain_side, jstar[:, None],
                                       axis=1)[:, 0]
            flip_to1 = rs_j < 0.5          # flipped child fixes j to 1
            cb_extra = jnp.where(cert_fin & has_branch,
                                 cert + jnp.maximum(fd_j, 0.0), -BIG)
            child0_bound = jnp.where(
                ~flip_to1, jnp.maximum(child_bound, cb_extra),
                child_bound)
            child1_bound = jnp.where(
                flip_to1, jnp.maximum(child_bound, cb_extra),
                child_bound)
        else:
            child0_bound = child1_bound = child_bound

        # deactivate all selected nodes, then write child-0 into the
        # parent slot (inactive when not expanding — scatter is unmasked
        # but guarded by `expand` in the active flag).
        active = s.active.at[sel].set(False)
        fix_mask = s.fix_mask.at[sel].set(jnp.where(expand[:, None], cfm, fm))
        fix_val = s.fix_val.at[sel].set(jnp.where(expand[:, None], cfv0, fv))
        bound = s.bound.at[sel].set(jnp.where(expand, child0_bound,
                                              child_bound))
        depth = s.depth.at[sel].set(cdepth)
        branch_var = s.branch_var.at[sel].set(
            jnp.where(expand, cbv, s.branch_var[sel]))
        branch_dir = s.branch_dir.at[sel].set(
            jnp.where(expand, 0, s.branch_dir[sel]))
        branch_frac = s.branch_frac.at[sel].set(
            jnp.where(expand, cbf, s.branch_frac[sel]))
        active = active.at[sel].set(expand)
        if spec.warm_start:
            x_pool = s.x_pool.at[sel].set(relax.x)
            z_pool = s.z_pool.at[sel].set(relax.z)
            y_pool = s.y_pool.at[sel].set(relax.y)
        else:
            x_pool, z_pool, y_pool = s.x_pool, s.z_pool, s.y_pool

        # child-1 → free slots; best-bound children win on overflow.
        # Multi-device: the child-1 batch is exchanged across devices
        # first (load balancing — SURVEY.md §5 "node redistribution").
        c1 = dict(fm=cfm, fv=cfv1, bound=child1_bound, depth=cdepth,
                  live=expand & has_branch, bv=cbv, bf=cbf)
        if spec.warm_start:
            c1.update(xw=relax.x, zw=relax.z, yw=relax.y)
        if exchange_children is not None:
            c1 = exchange_children(c1)
        cfm1, cfv1x = c1["fm"], c1["fv"]
        cb1, cd1, clive = c1["bound"], c1["depth"], c1["live"]

        free_score = jnp.where(active, -1.0, 1.0)
        fs_val, free_slots = jax.lax.top_k(free_score, W)
        slot_free = fs_val > 0.0
        order = jnp.argsort(jnp.where(clive, cb1, BIG))
        # i-th best child → i-th free slot
        tgt = free_slots
        src = order
        write_ok = slot_free & clive[src]
        tgt_safe = jnp.where(write_ok, tgt, spec.capacity)  # drop OOB
        fix_mask = fix_mask.at[tgt_safe].set(cfm1[src], mode="drop")
        fix_val = fix_val.at[tgt_safe].set(cfv1x[src], mode="drop")
        bound = bound.at[tgt_safe].set(cb1[src], mode="drop")
        depth = depth.at[tgt_safe].set(cd1[src], mode="drop")
        branch_var = branch_var.at[tgt_safe].set(c1["bv"][src], mode="drop")
        branch_dir = branch_dir.at[tgt_safe].set(1, mode="drop")
        branch_frac = branch_frac.at[tgt_safe].set(c1["bf"][src],
                                                   mode="drop")
        active = active.at[tgt_safe].set(True, mode="drop")
        if spec.warm_start:
            x_pool = x_pool.at[tgt_safe].set(c1["xw"][src], mode="drop")
            z_pool = z_pool.at[tgt_safe].set(c1["zw"][src], mode="drop")
            y_pool = y_pool.at[tgt_safe].set(c1["yw"][src], mode="drop")
        drop_mask = clive[src] & ~slot_free
        overflow = s.overflow | jnp.any(drop_mask)
        dropped_min = jnp.minimum(
            s.dropped_min,
            jnp.min(jnp.where(drop_mask, cb1[src], BIG)))

        alive = jnp.any(active)
        if global_any_active is not None:
            alive = global_any_active(alive)
        best_open = jnp.minimum(
            jnp.min(jnp.where(active, bound, BIG)), dropped_min)
        if reduce_min is not None:
            best_open = reduce_min(best_open)

        return BnbState(
            fix_mask=fix_mask, fix_val=fix_val,
            x_pool=x_pool, z_pool=z_pool, y_pool=y_pool,
            bound=bound, active=active,
            depth=depth,
            branch_var=branch_var, branch_dir=branch_dir,
            branch_frac=branch_frac, pc_sum=pc_sum, pc_cnt=pc_cnt,
            inc_obj=inc_obj, inc_x=inc_x, inc_found=inc_found,
            wave=s.wave + 1,
            nodes_solved=s.nodes_solved + jnp.sum(valid.astype(jnp.int32)),
            overflow=overflow, alive=alive,
            probe_stale=probe_stale, best_open=best_open,
            dropped_min=dropped_min)

    s = jax.lax.while_loop(cond, body, state)
    best_open = jnp.minimum(
        jnp.min(jnp.where(s.active, s.bound, BIG)), s.dropped_min)
    if reduce_min is not None:
        best_open = reduce_min(best_open)
    return BnbResult(x=s.inc_x, obj=s.inc_obj, found=s.inc_found,
                     waves=s.wave, nodes_solved=s.nodes_solved,
                     overflow=s.overflow, best_open_bound=best_open)


def _jitted_bnb(admm, qp, admm_probe, spec: BnbSpec):
    """Jitted wave loop CLOSING OVER the prepared (admm, qp, admm_probe),
    so repeated solves of one prepared problem reuse one compiled
    program.

    Memoized ON the admm spec (utils/prepcache.py — replaces the round-2
    module-level id()-keyed cache): the runner dies with the spec, and
    because the closure holds qp/admm_probe strongly, the id() key
    components cannot alias while the entry exists."""
    from pyhybridcontrol_tpu.utils.prepcache import cached_on

    def build():
        backend = CondensedBackend(admm, qp, admm_probe)

        @jax.jit
        def run(f, h, init_incumbent, init_node):
            return _bnb_loop(backend, f, h, spec,
                             init_incumbent=init_incumbent,
                             init_node=init_node)

        return run

    return cached_on(admm, ("bnb_run", id(qp), id(admm_probe), spec),
                     build)


def solve_miqp_bnb(admm: BoxQP, qp: DeviceQP, f, h,
                   spec: BnbSpec = BnbSpec(),
                   init_incumbent=None, init_node=None,
                   admm_probe: Optional[BoxQP] = None) -> BnbResult:
    """Solve  min ½VᵀHV + fᵀV  s.t. GV ≤ h, lb ≤ V ≤ ub, V[bidx] ∈ {0,1}
    entirely on device. f, h from ``qp.assemble(x0, W, ...)``.
    ``init_incumbent``: optional (obj, V, ok) heuristic seed.
    ``init_node``: optional (bvals, ok, x_warm|None) candidate binary
    assignment injected as a fully-fixed wave-1 node (the closed-loop
    carried-plan warm start).
    ``admm_probe``: optional stiff-ρ ADMM prep for dive probes (see
    CondensedBackend — ~6× fewer iterations on fixed-binary leaves).

    When ``admm`` is a prepared (concrete) BoxQP — eager calls, or calls
    from inside a jit that CLOSES OVER it (loop/closed_loop.py,
    control/mpc.py) — the solve runs as a cached jitted closure. When
    ``admm`` arrives as a traced jit argument the loop is inlined into
    the caller's trace."""
    if isinstance(admm.P, jax.core.Tracer):
        return _bnb_loop(CondensedBackend(admm, qp, admm_probe), f, h,
                         spec, init_incumbent=init_incumbent,
                         init_node=init_node)
    return _jitted_bnb(admm, qp, admm_probe, spec)(
        f, h, init_incumbent, init_node)
