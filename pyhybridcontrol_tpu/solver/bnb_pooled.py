"""Pooled multi-instance branch-and-bound: B independent MIQPs (same
condensed matrices, per-instance f/h — e.g. a batch of scenarios or a
batched control step) solved in ONE global node pool.

Why not ``vmap(solve_miqp_bnb)`` (the round-1/2 config-4 path)?  Two
structural taxes of the vmapped form:

1. **Lock-step waves.** Under ``vmap`` every instance runs the
   while_loop until the SLOWEST instance terminates; an instance that
   closes its tree in 3 waves keeps burning full wave solves for 30.
2. **Starved solves.** Each wave relaxes only ``wave_size`` (8–32)
   nodes per instance: a (B, W, n) batch of tiny matmuls, each instance
   its own small problem inside one vmapped program.

The pooled driver removes both: all instances' open nodes live in one
(P,)-slot pool tagged with an instance id, each wave selects the
globally best ``wave_size`` nodes (instances that finished simply stop
contributing), and the wave's relaxation+probe batch is a single
(W, n) solve with W in the hundreds to thousands. Total wave
count ≈ total-tree-nodes / W instead of B × max-per-instance-waves.

Per-instance state (incumbent, best open bound) is kept as (B,) vectors
updated with scatter-min; bounds/pruning are exact per instance — the
pooling changes ONLY the schedule, not the search semantics. Pseudo-cost
statistics are shared across instances (same matrices, same branching
structure — cross-instance learning is a feature).

**Packed pool layout.** A wave's time beyond its solves is ~15 small
pool-machinery ops (gathers/scatters/top_k) whose cost is per op, not
per byte (measured on the earlier accelerator; PERF.md), so the pool
stores its
per-node state PACKED, trading tiny elementwise pack/unpack (fused by
XLA) for fewer gather/scatter kernels per wave:

- ``meta``  (P, 8) f32: [bound, depth, branch_var, branch_dir,
  branch_frac, inst, active, pad] — ONE gather + ONE parent scatter +
  ONE child scatter where the unpacked layout needed 7 of each.
- ``fixenc`` (P, nb) f32: −1 = unfixed, 0/1 = fixed value — halves the
  fix_mask/fix_val traffic (mask = enc ≥ 0, val = max(enc, 0)).
- ``warm`` (P, n+2·mt) f32: x ‖ z ‖ y concatenated — one array instead
  of three.

int32 ids (inst, branch_var, depth) live as f32 in ``meta``: exact up
to 2^24, far beyond any pool/instance/binary count here.

Selection note: global best-first ranks nodes by RAW bound value by
default, which is exactly fair for homogeneous batches (the scenario/
batched-feedback use case). Wildly heterogeneous objective scales can
opt into ``BnbSpec.pool_norm="relgap"``: nodes are ranked by
(bound − incumbent)/max(1,|incumbent|) of their OWNING instance (its
certified relative-gap contribution), so low-scale instances stop
monopolizing waves; instances without incumbents rank first.
``BnbSpec.probe_patience`` gates the dive-probe batches with the same
pre-wave periodic-retry + leaf-deferral semantics as the
single-instance loop (solver/bnb.py).

SURVEY.md §2b solver/bnb + kernels/qp_admm: this is the component that
routes the B&B hot loop through the speed-of-light kernel path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from pyhybridcontrol_tpu.ops.admm import BoxQP
from pyhybridcontrol_tpu.ops.condense import DeviceQP
from pyhybridcontrol_tpu.solver.bnb import (
    BIG, BnbResult, BnbSpec, CondensedBackend)

# meta column indices
_BOUND, _DEPTH, _BVAR, _BDIR, _BFRAC, _INST, _ACTIVE, _PAD = range(8)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class KernelCondensedBackend(CondensedBackend):
    """Back-compat alias of CondensedBackend."""


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PooledState:
    # packed pool (P slots, global over instances) — see module docstring
    meta: jnp.ndarray          # (P, 8) f32 packed per-node metadata
    node: jnp.ndarray          # (P, nbr+n+2mt) f32: fixenc ‖ x ‖ z ‖ y
    #                            (fixenc: −1 unfixed / 0 / 1 fixed;
    #                            round-5 packing — fixenc and warm were
    #                            separate arrays, costing one extra
    #                            gather and two extra scatters per wave
    #                            at the measured ~0.05–0.07 ms/op
    #                            dispatch grain)
    # shared pseudo-costs, packed (nb, 2 dirs, 2): [..., 0] = sum of
    # per-unit degradations, [..., 1] = observation count — ONE
    # scatter-add per wave instead of two
    pc: jnp.ndarray
    # per-instance incumbents; x and found are packed (B, n+1) with
    # found as the trailing 0/1 column — one winner scatter, not two
    inc_obj: jnp.ndarray       # (B,)
    inc_xf: jnp.ndarray        # (B, n+1)
    # loop bookkeeping
    wave: jnp.ndarray
    nodes_solved: jnp.ndarray
    overflow: jnp.ndarray
    alive: jnp.ndarray
    probe_stale: jnp.ndarray   # () i32 — waves since a probe improved
    #                            ANY instance's incumbent (probe gating,
    #                            same semantics as solver/bnb.py)
    best_open: jnp.ndarray     # (B,) min open bound per instance
    dropped_min: jnp.ndarray   # (B,) min bound over overflow-dropped
    #                            children per instance (see solver/
    #                            bnb.py — lost subtrees must stay in
    #                            every best_open / gap statement)


def _pooled_loop(backend, f, h, spec: BnbSpec, pool_slots: int,
                 init_node=None, init_incumbent=None,
                 branch_map=None) -> BnbResult:
    """f (B, n), h (B, m_ineq). Returns BnbResult with (B,)-leading
    incumbent fields and scalar wave/node counters.

    ``branch_map`` (scenario-TREE instances — VERDICT r4 item 7):
    (nb,) int array mapping each binary COORDINATE to its information-
    set group; the pool then stores one fix-encoding per GROUP and one
    branching decision fixes every member coordinate (the rep-map trick
    of ops/stagewise_tree.py, transplanted to the condensed joint
    frame). Member relaxation values are averaged for fractionality /
    probe rounding (non-anticipativity rows push them equal; a per-
    member rounding can split a 0.5 tie across members and hand the
    probe a contradictory assignment). With a branch_map node presolve
    fixing is disabled
    (per-coordinate flip deltas do not group-certify); the certified
    Falk node bound is unchanged."""
    B, n = f.shape
    nb = len(backend.binary_idx)
    bidx = jnp.asarray(backend.binary_idx)
    P = pool_slots
    W = spec.wave_size
    mt = backend.warm_size
    dtype = f.dtype
    if P < 2 * B:
        raise ValueError(f"pool_slots {P} < 2*B (roots + warm nodes)")
    if branch_map is not None:
        import numpy as _np

        bm_np = _np.asarray(branch_map, _np.int32)
        nbr = int(bm_np.max()) + 1 if len(bm_np) else 0
        rep_of = jnp.asarray(bm_np)                    # (nb,) group id
        # column-normalized membership: xr = xb @ Mavg  (group means)
        Mavg_np = _np.zeros((len(bm_np), nbr), _np.float32)
        Mavg_np[_np.arange(len(bm_np)), bm_np] = 1.0
        Mavg_np /= _np.maximum(Mavg_np.sum(axis=0, keepdims=True), 1.0)
        Mavg = jnp.asarray(Mavg_np)
    else:
        nbr = nb
        rep_of = None

    def node_bounds(enc):
        Wb = enc.shape[0]
        encf = enc if rep_of is None else enc[:, rep_of]
        fm = encf >= 0.0
        lb = jnp.broadcast_to(backend.lb, (Wb, backend.n))
        ub = jnp.broadcast_to(backend.ub, (Wb, backend.n))
        lb = lb.at[:, bidx].set(jnp.maximum(encf, 0.0))
        ub = ub.at[:, bidx].set(jnp.where(fm, jnp.maximum(encf, 0.0),
                                          1.0))
        return lb, ub

    # ---- init: B roots in slots 0..B-1 -----------------------------------
    meta0 = jnp.zeros((P, 8), dtype)
    meta0 = meta0.at[:, _BOUND].set(-BIG)
    meta0 = meta0.at[:, _BVAR].set(-1.0)
    meta0 = meta0.at[:B, _INST].set(jnp.arange(B, dtype=dtype))
    meta0 = meta0.at[:B, _ACTIVE].set(1.0)
    nwid = nbr + n + 2 * mt
    s = PooledState(
        meta=meta0,
        node=jnp.zeros((P, nwid), dtype).at[:, :nbr].set(-1.0),
        pc=jnp.zeros((nbr, 2, 2), dtype),
        inc_obj=jnp.full((B,), BIG, dtype),
        inc_xf=jnp.zeros((B, n + 1), dtype),
        wave=jnp.asarray(0, jnp.int32),
        nodes_solved=jnp.asarray(0, jnp.int32),
        overflow=jnp.asarray(False),
        alive=jnp.asarray(True),
        probe_stale=jnp.asarray(0, jnp.int32),
        best_open=jnp.full((B,), -BIG, dtype),
        dropped_min=jnp.full((B,), BIG, dtype),
    )
    if init_incumbent is not None:
        obj0, x0V, ok0 = init_incumbent
        s = dataclasses.replace(
            s,
            inc_obj=jnp.where(ok0, obj0.astype(dtype), s.inc_obj),
            inc_xf=jnp.where(
                ok0[:, None],
                jnp.concatenate([x0V.astype(dtype),
                                 jnp.ones((B, 1), dtype)], axis=-1),
                s.inc_xf))
    if spec.root_iters > spec.qp_iters and spec.warm_start:
        lb0, ub0 = node_bounds(s.node[:B, :nbr])
        r0 = backend.solve(f, h, lb0, ub0,
                           spec.root_iters - spec.qp_iters)
        w0 = jnp.concatenate([r0.x, r0.z, r0.y], axis=-1).astype(dtype)
        s = dataclasses.replace(s, node=s.node.at[:B, nbr:].set(w0))
    if init_node is not None:
        # carried-plan warm start per instance: fully-fixed candidate
        # assignments in slots B..2B-1 (bound −BIG → ride wave 1; their
        # relaxation IS the fixed-binary solve, the probe turns them
        # into incumbents — zero extra up-front QP solves).
        bv0, okn, xw = init_node
        sl = jnp.arange(B, 2 * B)
        meta = s.meta.at[sl, _INST].set(jnp.arange(B, dtype=dtype))
        meta = meta.at[sl, _ACTIVE].set(okn.astype(dtype))
        s = dataclasses.replace(
            s, meta=meta,
            node=s.node.at[sl, :nbr].set(
                jnp.clip(bv0.astype(dtype), 0.0, 1.0)))
        if spec.warm_start and xw is not None:
            s = dataclasses.replace(
                s, node=s.node.at[sl, nbr:nbr + n].set(
                    xw.astype(dtype)))

    def cond(s: PooledState):
        live = s.alive & (s.wave < spec.max_waves)
        if spec.rel_gap > 0:
            tol = spec.rel_gap * jnp.maximum(1.0, jnp.abs(s.inc_obj))
            inst_done = ((s.inc_xf[:, -1] > 0.0)
                         & (s.inc_obj - s.best_open <= tol))
            live &= ~jnp.all(inst_done)
        return live

    def body(s: PooledState) -> PooledState:
        # -- 1. global best-first selection ------------------------------
        pool_active = s.meta[:, _ACTIVE] > 0.0
        pool_bound = s.meta[:, _BOUND]
        pool_inst = s.meta[:, _INST].astype(jnp.int32)
        if spec.pool_norm == "relgap":
            # heterogeneous batches: rank by the node's RELATIVE room
            # below its own instance's incumbent, not the raw bound —
            # otherwise instances with systematically lower objective
            # scales monopolize every wave. Instances without an
            # incumbent yet rank first (−BIG: they need work most).
            inc_i = s.inc_obj[pool_inst]
            norm = ((pool_bound - inc_i)
                    / jnp.maximum(1.0, jnp.abs(inc_i)))
            pri_val = jnp.where(s.inc_xf[pool_inst, -1] > 0.0, norm,
                                -BIG)
        else:
            pri_val = pool_bound
        pri = jnp.where(pool_active, pri_val, BIG)
        _, sel = jax.lax.top_k(-pri, W)
        m_sel = s.meta[sel]                   # ONE gather for 7 fields
        valid = m_sel[:, _ACTIVE] > 0.0
        ni = m_sel[:, _INST].astype(jnp.int32)
        parent_bound = m_sel[:, _BOUND]
        n_sel = s.node[sel]                   # ONE gather: enc ‖ x‖z‖y
        enc = n_sel[:, :nbr]
        fm = enc >= 0.0
        fv = jnp.maximum(enc, 0.0)

        # -- 2. batched relaxations + gated dive probe (ONE (W, n) batch
        # each — see solver/bnb.py) ---------------------------------------
        fb = f[ni]
        hb = h[ni]
        lb, ub = node_bounds(enc)
        if spec.warm_start:
            w_sel = n_sel[:, nbr:]            # packed with the gather
            warm = (w_sel[:, :n], w_sel[:, n:n + mt], w_sel[:, n + mt:])
        else:
            warm = None
        piters = spec.probe_iters or spec.qp_iters
        acc_tol = spec.inc_tol or spec.feas_tol

        # pre-wave probe gate (same semantics as solver/bnb.py: leaves
        # self-report via the relax harvest; unresolved leaves defer)
        if spec.probe_patience == 0:
            probe_ran = jnp.asarray(True)
        else:
            retry = (s.wave % jnp.int32(spec.probe_patience + 1)) == 0
            inc_found_all = jnp.all(s.inc_xf[:, -1] > 0.0)
            probe_ran = (~inc_found_all | retry
                         | (s.probe_stale < spec.probe_patience))

        def wave_probe(_):
            relax = backend.solve(fb, hb, lb, ub, spec.qp_iters, warm=warm)
            xb = relax.x[:, bidx]
            if rep_of is not None:
                # group-mean before rounding: one dive value per
                # information set (see _pooled_loop docstring)
                xb = jnp.matmul(xb, Mavg, precision="highest")
            pv = jnp.where(fm, fv, jnp.round(jnp.clip(xb, 0.0, 1.0)))
            lb_p, ub_p = node_bounds(pv)
            probe = backend.solve_probe(
                fb, hb, lb_p, ub_p, piters,
                warm=(relax.x, relax.z, relax.y))
            ok = (probe.r_prim_rel < acc_tol) & valid
            # certified-clamp: see solver/bnb.py — a feas_tol iterate's
            # objective can sit BELOW the true leaf optimum.
            pcert = backend.node_bound(probe, fb, hb, lb_p, ub_p)
            pobj = jnp.where(jnp.isfinite(pcert),
                             jnp.maximum(probe.obj, pcert), probe.obj)
            return relax, jnp.where(ok, pobj, BIG), probe.x, ok

        def wave_noprobe(_):
            relax = backend.solve(fb, hb, lb, ub, spec.qp_iters,
                                  warm=warm)
            return (relax, jnp.full((W,), BIG, dtype),
                    jnp.zeros_like(relax.x), jnp.zeros((W,), bool))

        if spec.probe_patience == 0:
            relax, cand, probe_x, probe_ok = wave_probe(None)
        else:
            relax, cand, probe_x, probe_ok = jax.lax.cond(
                probe_ran, wave_probe, wave_noprobe, None)

        converged = relax.r_prim_rel < spec.feas_tol
        infeasible = (relax.infeas_cert
                      | (relax.r_prim_rel > spec.infeas_tol))
        # certified dual bound + per-binary presolve data — valid for
        # ANY iterate (ops/admm.py admm_node_cert; see solver/bnb.py
        # for why relax.obj alone wrongly prunes). Rep-map runs skip
        # the fixing data: per-COORDINATE flip deltas do not certify a
        # whole-group flip (members' tangent sides may disagree).
        if spec.presolve_fix and nb > 0 and rep_of is None:
            cert, flip_delta, retain_side, imp_lo, imp_hi = \
                backend.node_cert(relax, fb, hb, lb, ub)
            presolve = (flip_delta, retain_side, imp_lo, imp_hi)
        else:
            cert = backend.node_bound(relax, fb, hb, lb, ub)
            presolve = None
        cert_fin = jnp.isfinite(cert)
        cert = jnp.where(cert_fin, cert, parent_bound)
        lower = jnp.where(valid & ~infeasible,
                          jnp.maximum(parent_bound, cert), BIG)

        xb = relax.x[:, bidx]
        if rep_of is not None:
            xb = jnp.matmul(xb, Mavg, precision="highest")  # (W, nbr)
        rounded = jnp.round(jnp.clip(xb, 0.0, 1.0))
        frac = jnp.where(fm, 0.0, jnp.abs(xb - rounded))
        max_frac = jnp.max(frac, axis=1) if nbr > 0 else jnp.zeros(W)
        integral = max_frac < spec.int_tol
        fully_fixed = jnp.all(fm, axis=1)

        # -- 2b. shared pseudo-cost observation --------------------------
        bv = m_sel[:, _BVAR].astype(jnp.int32)
        bdir = m_sel[:, _BDIR].astype(jnp.int32)
        bf = jnp.clip(m_sel[:, _BFRAC], 0.0, 1.0)
        obs = valid & converged & (bv >= 0)
        gain = jnp.maximum(lower - parent_bound, 0.0)
        denom = jnp.where(bdir == 1, 1.0 - bf, bf)
        contrib = jnp.where(obs, gain / jnp.maximum(denom, 1e-3), 0.0)
        bv_safe = jnp.where(obs, bv, nbr)
        pc = s.pc.at[bv_safe, bdir].add(
            jnp.stack([contrib, obs.astype(dtype)], axis=-1),
            mode="drop")

        # -- 3. per-instance incumbent update (probe candidates only —
        # see solver/bnb.py for why relax-harvesting was rejected):
        # scatter-min on obj, then a deterministic unique-winner scatter
        # for the plan (lowest wave row wins ties so sharded/unsharded
        # compilations agree).
        inc_obj = s.inc_obj.at[ni].min(cand)
        improved = probe_ok & (cand < s.inc_obj[ni]) & (cand <= inc_obj[ni])
        probe_stale = jnp.where(
            probe_ran & jnp.any(improved), 0,
            s.probe_stale + probe_ran.astype(jnp.int32))
        rows = jnp.arange(W)
        first = jnp.full((B,), W, jnp.int32).at[ni].min(
            jnp.where(improved, rows, W).astype(jnp.int32))
        winner = improved & (rows == first[ni])
        tgt = jnp.where(winner, ni, B)
        inc_xf = s.inc_xf.at[tgt].set(
            jnp.concatenate([probe_x,
                             jnp.ones(probe_x.shape[:-1] + (1,), dtype)],
                            axis=-1), mode="drop")
        inc_found = inc_xf[:, -1] > 0.0

        # -- 4. prune (per-instance incumbent); defer leaf candidates
        # on probe-gated waves (see solver/bnb.py) -----------------------
        leaf_unresolved = (valid & ~infeasible & ~probe_ran
                           & (fully_fixed | (converged & integral)))
        prune = ((~valid) | infeasible
                 | (fully_fixed & ~leaf_unresolved)
                 | (lower >= inc_obj[ni] - spec.gap)
                 | (converged & integral & ~leaf_unresolved))
        expand = valid & ~prune

        # -- 4b. node presolve (see solver/bnb.py — per-INSTANCE
        # incumbent gates the reduced-cost test here) ---------------------
        if presolve is not None:
            flip_delta, retain_side, imp_lo, imp_hi = presolve
            unfixed = ~fm
            ok_node = (valid & ~infeasible)[:, None]
            flip_bound = jnp.maximum(
                parent_bound[:, None],
                jnp.where(cert_fin[:, None], cert[:, None] + flip_delta,
                          -BIG))
            rc = (unfixed & ok_node & inc_found[ni][:, None]
                  & (flip_bound >= (inc_obj[ni] - spec.gap)[:, None]))
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
        # them unconditionally (see solver/bnb.py).
        child_bound = jnp.where(expand,
                                jnp.maximum(parent_bound, lower),
                                parent_bound)
        xbc = jnp.clip(xb, 0.0, 1.0)
        if spec.branching == "pseudocost":
            pc_sum = pc[..., 0]
            pc_cnt = pc[..., 1]
            cnt_tot = jnp.sum(pc_cnt, axis=0)
            gavg = jnp.where(cnt_tot > 0,
                             jnp.sum(pc_sum, axis=0)
                             / jnp.maximum(cnt_tot, 1.0), 1.0)
            avg = pc_sum / jnp.maximum(pc_cnt, 1.0)
            est = jnp.where(pc_cnt > 0, avg, gavg[None, :])
            sc = (jnp.maximum(est[None, :, 0] * xbc, 1e-8)
                  * jnp.maximum(est[None, :, 1] * (1.0 - xbc), 1e-8))
            sc = sc * jnp.maximum(frac, 1e-4)
            score = jnp.where(fm2, -1.0, sc)
        else:
            score = jnp.where(fm2, -1.0, frac)
        jstar = jnp.argmax(score, axis=1)
        # presolve may fix EVERYTHING: child-0 keeps (fm2, fv2) as its
        # own leaf, child-1 is dead (see solver/bnb.py).
        has_branch = jnp.any(~fm2, axis=1)
        branch_hot = (jax.nn.one_hot(jstar, nbr, dtype=bool)
                      & has_branch[:, None])
        enc2 = jnp.where(fm2, fv2, -1.0)      # post-presolve encoding
        cenc0 = jnp.where(branch_hot, 0.0, enc2)
        cenc1 = jnp.where(branch_hot, 1.0, enc2)
        cdepth = m_sel[:, _DEPTH] + 1.0
        cbf = jnp.take_along_axis(xbc, jstar[:, None], axis=1)[:, 0]
        cbv = jnp.where(has_branch, jstar, -1).astype(dtype)
        # flip-delta child bound (see solver/bnb.py): certified one-
        # level bound lead for the tangent-disfavoured child — free.
        if presolve is not None:
            fd_j = jnp.take_along_axis(flip_delta, jstar[:, None],
                                       axis=1)[:, 0]
            rs_j = jnp.take_along_axis(retain_side, jstar[:, None],
                                       axis=1)[:, 0]
            flip_to1 = rs_j < 0.5
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

        # child-0 overwrites the parent slot (instance id unchanged):
        # ONE packed meta scatter + fixenc + warm
        m_child0 = jnp.stack([
            child0_bound, cdepth, cbv,
            jnp.zeros((W,), dtype),                      # dir 0
            cbf, m_sel[:, _INST], expand.astype(dtype),
            jnp.zeros((W,), dtype)], axis=1)
        m_parent = jnp.where(expand[:, None], m_child0,
                             m_sel.at[:, _ACTIVE].set(0.0)
                             .at[:, _BOUND].set(child_bound))
        meta = s.meta.at[sel].set(m_parent)
        enc_parent = jnp.where(expand[:, None], cenc0, enc)
        if spec.warm_start:
            w_new = jnp.concatenate([relax.x, relax.z, relax.y],
                                    axis=-1).astype(dtype)
        else:
            w_new = n_sel[:, nbr:]
        n_parent = jnp.concatenate([enc_parent, w_new], axis=-1)
        node_arr = s.node.at[sel].set(n_parent)   # ONE packed scatter

        # child-1 → globally free slots (best-bound children win)
        free_score = jnp.where(meta[:, _ACTIVE] > 0.0, -1.0, 1.0)
        fs_val, free_slots = jax.lax.top_k(free_score, W)
        slot_free = fs_val > 0.0
        c1live = expand & has_branch
        order = jnp.argsort(jnp.where(c1live, child1_bound, BIG))
        write_ok = slot_free & c1live[order]
        tgt_safe = jnp.where(write_ok, free_slots, P)
        m_child1 = jnp.stack([
            child1_bound, cdepth, cbv,
            jnp.ones((W,), dtype),                       # dir 1
            cbf, m_sel[:, _INST],
            jnp.ones((W,), dtype),                       # active
            jnp.zeros((W,), dtype)], axis=1)
        meta = meta.at[tgt_safe].set(m_child1[order], mode="drop")
        n_child1 = jnp.concatenate([cenc1, w_new], axis=-1)
        node_arr = node_arr.at[tgt_safe].set(n_child1[order],
                                             mode="drop")
        drop_mask = c1live[order] & ~slot_free
        overflow = s.overflow | jnp.any(drop_mask)
        dropped_min = s.dropped_min.at[
            jnp.where(drop_mask, ni[order], B)].min(
            jnp.where(drop_mask, child1_bound[order], BIG), mode="drop")

        new_active = meta[:, _ACTIVE] > 0.0
        alive = jnp.any(new_active)
        best_open = jnp.minimum(
            jnp.full((B,), BIG, dtype).at[
                meta[:, _INST].astype(jnp.int32)].min(
                jnp.where(new_active, meta[:, _BOUND], BIG)),
            dropped_min)

        return PooledState(
            meta=meta, node=node_arr,
            pc=pc,
            inc_obj=inc_obj, inc_xf=inc_xf,
            wave=s.wave + 1,
            nodes_solved=(s.nodes_solved
                          + jnp.sum(valid.astype(jnp.int32))),
            overflow=overflow, alive=alive, probe_stale=probe_stale,
            best_open=best_open, dropped_min=dropped_min)

    s = jax.lax.while_loop(cond, body, s)
    act = s.meta[:, _ACTIVE] > 0.0
    best_open = jnp.minimum(
        jnp.full((B,), BIG, dtype).at[
            s.meta[:, _INST].astype(jnp.int32)].min(
            jnp.where(act, s.meta[:, _BOUND], BIG)),
        s.dropped_min)
    return BnbResult(x=s.inc_xf[:, :-1], obj=s.inc_obj,
                     found=s.inc_xf[:, -1] > 0.0,
                     waves=s.wave, nodes_solved=s.nodes_solved,
                     overflow=s.overflow, best_open_bound=best_open)


def _jitted_pooled(admm, qp, admm_probe, spec: BnbSpec, P: int,
                   branch_map=None):
    """Jitted pooled loop closing over concrete problem data — same
    rationale and memoization policy as solver/bnb.py ``_jitted_bnb``
    (the runner is cached ON the admm spec via utils/prepcache.py)."""
    from pyhybridcontrol_tpu.utils.prepcache import cached_on

    def build():
        backend = KernelCondensedBackend(admm=admm, qp=qp,
                                         admm_probe=admm_probe)

        @jax.jit
        def run(f, h, init_incumbent, init_node):
            return _pooled_loop(backend, f, h, spec, P,
                                init_node=init_node,
                                init_incumbent=init_incumbent,
                                branch_map=branch_map)

        return run

    return cached_on(admm, ("pooled_run", id(qp), id(admm_probe), spec, P,
                            branch_map),
                     build)


def solve_miqp_bnb_pooled(admm: BoxQP, qp: DeviceQP, f, h,
                          spec: BnbSpec = BnbSpec(),
                          pool_slots: int = 0,
                          init_incumbent=None, init_node=None,
                          admm_probe: Optional[BoxQP] = None,
                          branch_map=None) -> BnbResult:
    """Solve B MIQPs sharing one condensed structure in a single pooled
    B&B. f (B, n), h (B, m_ineq) from a vmapped ``qp.assemble``.

    ``pool_slots``: total pool size (0 → 32·B). A traced jit-argument
    ``admm`` inlines the loop into the caller's trace.

    ``branch_map``: optional (nb,) information-set group ids for
    scenario-TREE instances — one branching decision then fixes every
    member binary of the set (see ``_pooled_loop``; ``init_node``
    binary values must be given in rep space when set).

    Returns a BnbResult whose x/obj/found/best_open_bound carry the
    (B,) instance axis; waves/nodes_solved are global scalars."""
    B = f.shape[0]
    P = pool_slots or max(32 * B, 2 * B)
    if branch_map is not None:
        import numpy as _np

        branch_map = tuple(int(g) for g in _np.asarray(branch_map))
    if isinstance(admm.P, jax.core.Tracer):
        backend = KernelCondensedBackend(admm=admm, qp=qp,
                                         admm_probe=admm_probe)
        return _pooled_loop(backend, f, h, spec, P,
                            init_node=init_node,
                            init_incumbent=init_incumbent,
                            branch_map=branch_map)
    return _jitted_pooled(admm, qp, admm_probe, spec, P, branch_map)(
        f, h, init_incumbent, init_node)
