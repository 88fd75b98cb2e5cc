"""Greedy rollout-repair incumbent heuristic for the MIQP engine.

Problem: the B&B dive probe rounds ALL binaries of a relaxation at once;
for models whose binaries are structurally coupled to the trajectory
(PWA region indicators with Σδ=1, big-M product logic) independent
rounding is almost never feasible, so no incumbents appear and pruning
never starts (observed: 5k nodes, zero incumbents on BASELINE config 2).

Fix (this module): *sequential* repair — simulate the closed trajectory
forward; at each step k, enumerate all 2^{nb_step} per-step binary
patterns and solve, for each, a TINY stage QP in the continuous
variables (u, z):

    min ‖u − ū_k‖² + stage_cost(u, δ, z)
    s.t. E x_k + F1 u + F2 δ + F3 z + F4 ω_k ≤ f5,  u ∈ box

where ū_k is the relaxation's continuous input (the thing worth
preserving) and x_k is the *exact* state reached so far. The best
feasible candidate advances the state. By construction the result
satisfies every stage constraint; its condensed objective is evaluated
exactly and offered as an incumbent.

Device shape: one `lax.scan` over k carrying x_k, with the 2^{nb_step}
candidates solved as one batched ADMM call per step (all steps share one
tiny KKT inverse). Cost ≈ N · 2^{nb_step} micro-QPs — noise next to the
wave relaxations. Not valid under move blocking (the repaired sequence
need not be blocked) — gate on T_full being the identity.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from pyhybridcontrol_tpu.mld.model import MldModel
from pyhybridcontrol_tpu.ops.admm import BoxQP, admm_solve, prepare_admm
from pyhybridcontrol_tpu.ops.condense import MpcWeights, _sq, _vec

BIG = 1e30


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class RepairSpec:
    """Prepared per-model repair data."""

    admm: BoxQP                 # stage QP over w = [u; z]
    candidates: jnp.ndarray     # (2^nbs, nbs) binary patterns
    F2E: jnp.ndarray            # (nc, nbs) binary columns of [F1_b | F2]
    Fw_cont: jnp.ndarray        # (nc, nu_c + nz) continuous columns
    E: jnp.ndarray              # (nc, nx)
    F4: jnp.ndarray             # (nc, nw)
    f5: jnp.ndarray             # (nc,)
    # dynamics application
    A: jnp.ndarray
    B_cont: jnp.ndarray         # (nx, nu_c + nz)
    B_bin: jnp.ndarray          # (nx, nbs)
    B4: jnp.ndarray
    b5: jnp.ndarray
    # stage-cost pieces over (w, bin)
    Rw: jnp.ndarray             # (nw_c, nw_c) quad on w
    rw: jnp.ndarray             # (nw_c,)
    r_bin: jnp.ndarray          # (nbs,) linear cost of binaries
    Qx_la: jnp.ndarray          # (nx, nx) one-step-lookahead state weight
    qx_la: jnp.ndarray          # (nx,) lookahead linear (incl x_ref)
    # index maps into the per-step v = [u; δ; z]
    cont_idx: jnp.ndarray       # (nu_c + nz,) positions in v
    bin_idx: jnp.ndarray        # (nbs,) positions in v
    u_cont_idx: jnp.ndarray     # (nu_c,) positions of continuous u in w
    # soft-row handling (stage-local): hard-row mask + penalties
    hard_mask: jnp.ndarray      # (nc,) bool — rows enforced exactly
    soft_lin: jnp.ndarray       # (nc,) linear penalty (0 on hard rows)
    soft_quad: jnp.ndarray      # (nc,)
    slack_lin: jnp.ndarray      # (ns,) linear penalty in slack order
    proximity: float = dataclasses.field(metadata=dict(static=True))
    nbs: int = dataclasses.field(metadata=dict(static=True))
    n_slack: int = dataclasses.field(metadata=dict(static=True))


def prepare_repair(model: MldModel, weights: Optional[MpcWeights] = None,
                   proximity: float = 1.0, rho: float = 1.0,
                   max_step_binaries: int = 10,
                   soft_rows=None, soft_lin: float = 5.0,
                   soft_quad: float = 1.0) -> Optional[RepairSpec]:
    """Build the repair data. Returns None if the model has too many
    per-step binaries to enumerate (2^nbs candidate limit).

    ``soft_rows``: stage-LOCAL constraint-row indices that the
    controller softened — the repair then allows (and penalizes) their
    violation too, instead of declaring such candidates infeasible."""
    w = weights or MpcWeights()
    info = model.info
    m = model.numpy_mats()
    nbs = info.nv_binary
    if nbs == 0 or nbs > max_step_binaries:
        return None
    vb = info.v_binary_mask
    cont_mask = ~vb
    nv = info.nv

    # columns of the stage system over v = [u; δ; z]
    Fv = np.hstack([m.F1, m.F2, m.F3])
    Bv = np.hstack([m.B1, m.B2, m.B3])
    F_bin = Fv[:, vb]
    F_cont = Fv[:, cont_mask]
    B_bin = Bv[:, vb]
    B_cont = Bv[:, cont_mask]

    # stage cost over v (same convention as condense: J = vᵀRv + rᵀv)
    Rv = np.zeros((nv, nv))
    Rv[info.u_slice, info.u_slice] = _sq(w.Ru, info.nu)
    Rv[info.delta_slice, info.delta_slice] = _sq(w.Qdelta, info.ndelta)
    Rv[info.z_slice, info.z_slice] = _sq(w.Rz, info.nz)
    rv = np.concatenate([_vec(w.ru, info.nu), _vec(w.qdelta, info.ndelta),
                         _vec(w.rz, info.nz)])
    # one-step lookahead: score candidates by x_{k+1}ᵀQx x_{k+1} too —
    # without it the greedy choice ignores ALL state cost and picks
    # binaries on v-cost alone (measured 6x worse incumbents).
    Qx_la = _sq(w.Qx, info.nx)
    qx_la = _vec(w.qx, info.nx)
    if w.x_ref is not None:
        qx_la = qx_la - 2.0 * (Qx_la @ _vec(w.x_ref, info.nx))

    nc = info.ncons
    soft = np.zeros(nc, dtype=bool)
    if soft_rows is not None:
        soft[np.asarray(list(soft_rows), int)] = True
    lam = np.where(soft, soft_lin, 0.0)
    mu = np.where(soft, soft_quad, 0.0)

    nw_c = int(cont_mask.sum())
    Rw = 2.0 * Rv[np.ix_(cont_mask, cont_mask)]
    # + proximity on the continuous-u components
    u_cont_in_w = np.nonzero(np.arange(nv)[cont_mask] < info.nu)[0]
    for i in u_cont_in_w:
        Rw[i, i] += 2.0 * proximity
    # slack variables for the soft rows extend the stage QP
    ns = int(soft.sum()) if nw_c > 0 else 0
    if ns:
        Ssel = np.zeros((nc, ns))
        Ssel[np.nonzero(soft)[0], np.arange(ns)] = 1.0
        F_cont_ext = np.hstack([F_cont, -Ssel])
        Rw_ext = np.zeros((nw_c + ns, nw_c + ns))
        Rw_ext[:nw_c, :nw_c] = Rw
        Rw_ext[nw_c:, nw_c:] = 2.0 * np.diag(mu[soft])
        H = Rw_ext + 1e-6 * np.eye(nw_c + ns)
        admm = prepare_admm(F_cont_ext, H, rho=rho)
    else:
        H = Rw + 1e-6 * np.eye(nw_c)
        admm = prepare_admm(F_cont, H, rho=rho)

    codes = np.arange(2 ** nbs, dtype=np.uint32)
    cand = ((codes[:, None] >> np.arange(nbs)[None, :]) & 1
            ).astype(np.float32)

    return RepairSpec(
        admm=admm,
        candidates=jnp.asarray(cand),
        F2E=jnp.asarray(F_bin, jnp.float32),
        Fw_cont=jnp.asarray(F_cont, jnp.float32),
        E=jnp.asarray(m.E, jnp.float32),
        F4=jnp.asarray(m.F4, jnp.float32),
        f5=jnp.asarray(m.f5[:, 0], jnp.float32),
        A=jnp.asarray(m.A, jnp.float32),
        B_cont=jnp.asarray(B_cont, jnp.float32),
        B_bin=jnp.asarray(B_bin, jnp.float32),
        B4=jnp.asarray(m.B4, jnp.float32),
        b5=jnp.asarray(m.b5[:, 0], jnp.float32),
        Rw=jnp.asarray(Rw, jnp.float32),
        rw=jnp.asarray(rv[cont_mask], jnp.float32),
        r_bin=jnp.asarray(rv[vb], jnp.float32),
        Qx_la=jnp.asarray(Qx_la, jnp.float32),
        qx_la=jnp.asarray(qx_la, jnp.float32),
        cont_idx=jnp.asarray(np.nonzero(cont_mask)[0], jnp.int32),
        bin_idx=jnp.asarray(np.nonzero(vb)[0], jnp.int32),
        u_cont_idx=jnp.asarray(u_cont_in_w, jnp.int32),
        hard_mask=jnp.asarray(~soft),
        soft_lin=jnp.asarray(lam, jnp.float32),
        soft_quad=jnp.asarray(mu, jnp.float32),
        slack_lin=jnp.asarray(lam[soft] if ns else np.zeros(0),
                              jnp.float32),
        proximity=float(proximity), nbs=nbs, n_slack=ns)


def repair_sequence(spec: RepairSpec, x0, u_ref_seq, W=None,
                    price_seq=None, qp_iters: int = 60,
                    feas_tol: float = 1e-3):
    """Greedy forward repair. u_ref_seq: (N, nu_c+nz) target continuous
    parts (relaxation solution, reordered to w-frame by the caller via
    ``spec.cont_idx``). Returns (v_seq (N, nv), ok (bool)).
    price_seq: (N, nv) per-step linear cost (applied to both parts)."""
    N = u_ref_seq.shape[0]
    C = spec.candidates.shape[0]
    nw_c = spec.Fw_cont.shape[1]
    nv = len(spec.cont_idx) + len(spec.bin_idx)

    if W is None:
        W = jnp.zeros((N, spec.B4.shape[1]), jnp.float32)
    if price_seq is None:
        price_seq = jnp.zeros((N, nv), jnp.float32)

    big_box = jnp.full(nw_c, BIG)

    def step(x, inp):
        u_ref, w_k, price = inp
        # rhs per candidate: f5 − E x − F4 ω − F_bin δc
        hp = lambda a, b: jnp.matmul(a, b, precision="highest")
        base = spec.f5 - hp(spec.E, x) - hp(spec.F4, w_k)
        h = base[None, :] - hp(spec.candidates, spec.F2E.T)       # (C, nc)
        if nw_c == 0:
            # all-binary stage (e.g. DEWH heater + startup flag): no
            # stage QP — hard rows checked exactly, soft rows penalized
            viol = jnp.maximum(-h, 0.0)                       # (C, nc)
            feas = jnp.all(jnp.where(spec.hard_mask[None, :],
                                     h >= -feas_tol, True), axis=-1)
            cont_obj = (hp(viol, spec.soft_lin)
                        + hp(viol * viol, spec.soft_quad))
            w_sol = jnp.zeros((C, 0))
        else:
            nw_tot = nw_c + spec.n_slack
            q = (-2.0 * spec.proximity
                 * jnp.zeros(nw_c).at[spec.u_cont_idx].set(
                     u_ref[spec.u_cont_idx])
                 + spec.rw + price[spec.cont_idx])
            if spec.n_slack:
                q = jnp.concatenate([q, spec.slack_lin])
            qb = jnp.broadcast_to(q, (C, nw_tot))
            lo = jnp.full(nw_tot, -BIG).at[nw_c:].set(0.0)
            hi = jnp.full(nw_tot, BIG)
            res = admm_solve(spec.admm, qb, h,
                             jnp.broadcast_to(lo, (C, nw_tot)),
                             jnp.broadcast_to(hi, (C, nw_tot)),
                             iters=qp_iters)
            feas = res.r_prim_rel < feas_tol
            cont_obj = res.obj
            w_sol = res.x[:, :nw_c]
        bin_cost = hp(spec.candidates, spec.r_bin
                      + price[spec.bin_idx])
        # one-step-lookahead state cost per candidate
        x_next_c = (hp(spec.A, x)[None, :] + hp(w_sol, spec.B_cont.T)
                    + hp(spec.candidates, spec.B_bin.T)
                    + hp(spec.B4, w_k)[None, :] + spec.b5[None, :])
        la = (jnp.einsum("ci,ij,cj->c", x_next_c, spec.Qx_la, x_next_c,
                         precision="highest")
              + hp(x_next_c, spec.qx_la))
        total = jnp.where(feas, cont_obj + bin_cost + la, BIG)
        k = jnp.argmin(total)
        wk = w_sol[k]
        ck = spec.candidates[k]
        ok = feas[k]
        v = (jnp.zeros(nv).at[spec.cont_idx].set(wk)
             .at[spec.bin_idx].set(ck))
        x_next = (spec.A @ x + spec.B_cont @ wk + spec.B_bin @ ck
                  + spec.B4 @ w_k + spec.b5)
        return x_next, (v, ok)

    _, (v_seq, oks) = jax.lax.scan(step, x0, (u_ref_seq, W, price_seq))
    return v_seq, jnp.all(oks)


def root_repair_incumbent(admm, qp, rspec: RepairSpec, x0, f, h,
                          W=None, price_seq=None, qp_iters: int = 150,
                          layout: str = "plain", feas_tol: float = 1e-3,
                          stage_iters: int = 150):
    """Root-relaxation + greedy repair → B&B incumbent seed
    ``(obj, V, ok)`` in the solver's decision frame.

    ``layout``: "plain" (decision == full per-step v) or "soft"
    (decision == [v_flat; slacks] — slacks filled from row violations).
    Move-blocked problems cannot be seeded this way (repaired sequences
    are not blocked) — callers must not request repair then.
    """
    relax = admm_solve(admm, f, h, qp.lb, qp.ub, iters=qp_iters)
    v_seq_rel = qp.full_v(relax.x)                      # (N, nv)
    u_ref = v_seq_rel[:, rspec.cont_idx]
    # stage_iters: 60 suffices for big-M stage QPs, but disaggregated
    # (hull) stages carry per-region copies + aggregation rows and need
    # ~150 to clear feas_tol (measured: 60 → resid 1.0, 150 → 1.7e-5)
    v_seq, ok = repair_sequence(rspec, x0, u_ref, W=W,
                                price_seq=price_seq, qp_iters=stage_iters,
                                feas_tol=feas_tol)
    v_flat = v_seq.reshape(-1)
    if layout == "plain":
        V = v_flat
    elif layout == "soft":
        ns = qp.n - v_flat.shape[0]
        # soft rows carry −I on the slack block: s_r = max(0, violation)
        Gv = jnp.matmul(qp.G[:, : v_flat.shape[0]], v_flat,
                        precision="highest")
        viol = jnp.maximum(Gv - h, 0.0)
        Ssel = -qp.G[:, v_flat.shape[0]:]               # (m, ns), 0/1
        s = jnp.matmul(Ssel.T, viol, precision="highest")
        V = jnp.concatenate([v_flat, s])
    else:
        raise ValueError(f"repair cannot seed layout {layout!r}")
    # validate against the FULL constraint system (incl. horizon-coupled
    # rows the per-step repair does not see)
    resid = jnp.max(jnp.matmul(qp.G, V, precision="highest") - h)
    ok = ok & (resid <= feas_tol)
    # the seed objective prunes B&B nodes — bf16 drift here is a
    # soundness bug, not a perf detail
    obj = (0.5 * jnp.dot(V, jnp.matmul(qp.H, V, precision="highest"),
                         precision="highest") + jnp.sum(f * V))
    return obj, V, ok
