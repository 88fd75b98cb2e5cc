"""Batched ADMM QP solver (OSQP-style splitting) — the node-relaxation
engine of the MIQP solver (SURVEY.md §2b ``kernels/qp_admm``; replaces the
reference stack's Gurobi QP core + cvxcore).

Problem form (everything the condensation layer emits maps onto this):

    min ½ xᵀP x + qᵀx   s.t.   l ≤ A x ≤ u,   A = [G; I]

so one constraint block carries the stage constraints (G x ≤ h ⇒ l=−∞,u=h)
and one carries the box (lb ≤ x ≤ ub) — B&B nodes tighten ONLY l,u rows of
the box block, so the KKT matrix K = P + σI + ρ AᵀA is *shared by every
node of every control step* and is inverted once on the host in float64.
Each ADMM iteration is then three dense matmuls:

    x̃ ← K⁻¹ (σ x − q + Aᵀ(ρ z − y))      (B,n)  = (B,m̄)(m̄,n)(n,n)
    z̃ ← A x̃                              (B,m̄) = (B,n)(n,m̄)
    z  ← Π_[l,u](α z̃ + (1−α) z + y/ρ);   y ← y + ρ(α z̃ + (1−α) z_old − z)

which batch over B&B nodes / scenarios as dense matmuls — this is why
the device form of branch-and-bound is wave-parallel (SURVEY.md §2b).

Fixed iteration count (lock-step, no host sync, XLA-static); final primal/
dual residuals are returned so callers can detect non-converged or
infeasible nodes (big-M nodes with contradictory fixed binaries do not
converge — their primal residual stays large).

Row equilibration: constraint rows of A are scaled to ~unit ∞-norm on the
host (cheap Ruiz-style row pass) which is what makes a single scalar ρ
workable across big-M rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pyhybridcontrol_tpu.ops.condense import CondensedMpc

BIG = 1e30


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BoxQP:
    """Prepared ADMM problem data (pytree of device arrays).

    Static per (condensed problem, ρ, σ): Ruiz-scaled P̂, Â, K⁻¹ and the
    D/E/c scalings (ops/scaling.py). Per-solve data (q, h, lb, ub) is
    passed to ``admm_solve`` in ORIGINAL units and scaled on the fly
    (two cheap elementwise ops — the iteration loop runs fully scaled).
    """

    P: jnp.ndarray          # (n, n) scaled quadratic  P̂ = c·DPD
    A: jnp.ndarray          # (m̄, n) scaled stacked constraints  Â = E[A]D
    Kinv: jnp.ndarray       # (n, n) inverse of P̂ + σI + ρ ÂᵀÂ
    D: jnp.ndarray          # (n,) column scaling, x = D x̂
    E: jnp.ndarray          # (m̄,) row scaling over [G; I]
    cost_scale: jnp.ndarray  # () scalar c
    rho_vec: jnp.ndarray    # (m̄,) per-row ρ (binary box rows get the
    #                         OSQP equality-row boost — they become l==u
    #                         at every fixed-binary B&B node)
    rho: float = dataclasses.field(metadata=dict(static=True))
    sigma: float = dataclasses.field(metadata=dict(static=True))
    alpha: float = dataclasses.field(metadata=dict(static=True))
    m_ineq: int = dataclasses.field(metadata=dict(static=True))  # rows of G
    # Matmul precision. On a GPU, float32 products at DEFAULT precision
    # may run in TF32 on the tensor cores (about three decimal digits),
    # which stalls ADMM convergence; "highest" keeps true fp32. "high"
    # is TF32 on the GPU.
    precision: str = dataclasses.field(
        default="highest", metadata=dict(static=True))
    # Certificate arithmetic: True → the Falk dual bound and the
    # primal-infeasibility certificate evaluate their REDUCTIONS with
    # double-float compensated sums (utils/dd.py — fp64-grade without
    # fp64 arithmetic). The matmuls stay fp32 ``precision`` (CLAUDE.md
    # mandates "highest" for solver dots); it is the tangent/support/gap
    # sums whose terms cancel (1e2-scale terms certifying 1e-3-scale
    # bounds) that fp32 summation gets wrong — measured shipping
    # 3.7%-worse incumbents when certs drove strong-branching fixing
    # (PERF.md, hardware-independent findings). Off by default: dd
    # costs ~10 elementwise ops per term and
    # perturbs golden node counts; certificate-driven features
    # (BnbSpec.sb_fix) should run on dd_cert preps.
    dd_cert: bool = dataclasses.field(
        default=False, metadata=dict(static=True))

    @property
    def n(self) -> int:
        return self.P.shape[-1]

    @property
    def m_total(self) -> int:
        return self.A.shape[-2]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class AdmmResult:
    x: jnp.ndarray        # (..., n) primal solution
    obj: jnp.ndarray      # (...,) ½xᵀPx + qᵀx
    r_prim: jnp.ndarray   # (...,) ∞-norm primal residual (original units)
    r_prim_rel: jnp.ndarray  # (...,) r_prim / max(1, |Ax|∞) — the
    #                          scale-invariant feasibility measure
    r_dual: jnp.ndarray   # (...,) ∞-norm dual residual
    infeas_cert: jnp.ndarray  # (...,) bool — OSQP primal-infeasibility
    #   certificate from the dual step direction δy: Aᵀδy ≈ 0 with
    #   uᵀ[δy]₊ + lᵀ[δy]₋ < 0 proves no feasible point exists. Unlike a
    #   residual threshold this never fires on slow-but-feasible
    #   problems (degenerate PWA relaxations take thousands of
    #   iterations while sitting at large residuals).
    y: jnp.ndarray        # (..., m̄) dual (scaled) — for warm starts
    z: jnp.ndarray        # (..., m̄)
    # horizon-coupled extra-row segment (stagewise bordered frame only
    # — ops/stagewise.py StagewiseQP.n_ext). None everywhere else;
    # both are data fields whose None collapses to an empty subtree,
    # so existing pytree consumers are unaffected.
    z_ext: Optional[jnp.ndarray] = None   # (..., r)
    y_ext: Optional[jnp.ndarray] = None   # (..., r)


def prepare_admm(G: np.ndarray, H: np.ndarray, *, rho: float = 1.0,
                 sigma: float = 1e-6, alpha: float = 1.6,
                 q_typical: Optional[np.ndarray] = None,
                 binary_idx=None, rho_eq_scale: float = 10.0,
                 boost_rows=None, boost_scale: float = 30.0,
                 eq_rows=None,
                 dtype=jnp.float32, precision: str = "highest",
                 dd_cert: bool = False) -> BoxQP:
    """Host-side (float64) preparation: Ruiz equilibration + K⁻¹.

    ``binary_idx``: box rows of those variables get ρ·rho_eq_scale (they
    turn into equalities at fixed-binary B&B nodes — OSQP §5.2 boosts
    equality rows the same way). ``eq_rows``: constraint rows that are
    true equalities (e.g. scenario-consensus selector rows) — same
    rho_eq_scale boost.
    """
    from pyhybridcontrol_tpu.ops.scaling import ruiz_equilibrate

    G = np.asarray(G, dtype=np.float64)
    H = np.asarray(H, dtype=np.float64)
    m, n = G.shape
    A = np.vstack([G, np.eye(n)])
    q0 = (np.zeros(n) if q_typical is None
          else np.asarray(q_typical, np.float64))
    D, E, c = ruiz_equilibrate(H, A, q0)
    Ph = c * (D[:, None] * H * D[None, :])
    Ah = E[:, None] * A * D[None, :]
    rho_vec = np.full(m + n, float(rho))
    if binary_idx is not None and len(binary_idx):
        rho_vec[m + np.asarray(binary_idx, int)] = rho * rho_eq_scale
    if eq_rows is not None and len(eq_rows):
        rho_vec[np.asarray(eq_rows, int)] = rho * rho_eq_scale
    if boost_rows is not None and len(boost_rows):
        # near-equality constraint rows (big-M product rows) get a
        # static stiffness boost — see ops/condense.py z_rows
        rho_vec[np.asarray(boost_rows, int)] *= boost_scale
    K = Ph + sigma * np.eye(n) + (Ah.T * rho_vec[None, :]) @ Ah
    Kinv = np.linalg.inv(K)
    return BoxQP(
        P=jnp.asarray(Ph, dtype),
        A=jnp.asarray(Ah, dtype),
        Kinv=jnp.asarray(Kinv, dtype),
        D=jnp.asarray(D, dtype),
        E=jnp.asarray(E, dtype),
        cost_scale=jnp.asarray(c, dtype),
        rho_vec=jnp.asarray(rho_vec, dtype),
        rho=float(rho), sigma=float(sigma), alpha=float(alpha), m_ineq=m,
        precision=precision, dd_cert=dd_cert,
    )


def prepare_admm_mpc(cmpc: CondensedMpc, **kw) -> BoxQP:
    """Prepare the ADMM data for a condensed MPC problem. The typical
    linear term (f at x0=0) informs the Ruiz cost normalization."""
    kw.setdefault("q_typical", cmpc.f0)
    kw.setdefault("binary_idx", cmpc.binary_idx)
    kw.setdefault("boost_rows", getattr(cmpc, "z_rows", None))
    return prepare_admm(cmpc.G, cmpc.H, **kw)


def _bounds(spec: BoxQP, h, lb, ub):
    """Stacked, Ruiz-row-scaled [l̂, û]: constraint block + box block."""
    m = spec.m_ineq
    l = jnp.concatenate([jnp.full(h.shape[:-1] + (m,), -BIG, h.dtype),
                         jnp.clip(lb * spec.E[m:], -BIG, BIG)], axis=-1)
    u = jnp.concatenate([h * spec.E[:m],
                         jnp.clip(ub * spec.E[m:], -BIG, BIG)], axis=-1)
    return l, u


def admm_solve(spec: BoxQP, q, h, lb, ub, iters: int = 100,
               warm: Optional[Tuple[jnp.ndarray, ...]] = None) -> AdmmResult:
    """Solve one (or a leading-batch of) box-QPs with ``iters`` fixed ADMM
    iterations. Inputs in ORIGINAL units (scaling is internal); all of
    q/h/lb/ub may carry identical leading batch dims.
    Pure jnp: jit/vmap/shard_map-compatible.

    Returned residuals are in original units; ``x``/``obj`` unscaled;
    ``y``/``z`` stay in the scaled frame (only reuse them as ``warm``).
    """
    rho, alpha, sigma = spec.rho_vec, spec.alpha, spec.sigma
    c = spec.cost_scale
    qh = c * spec.D * q
    l, u = _bounds(spec, h, lb, ub)
    batch = qh.shape[:-1]
    n, mt = spec.n, spec.m_total
    if warm is None:
        x = jnp.zeros(batch + (n,), qh.dtype)
        z = jnp.clip(jnp.zeros(batch + (mt,), qh.dtype), l, u)
        y = jnp.zeros(batch + (mt,), qh.dtype)
    else:
        # warm = (x in ORIGINAL units, z scaled, y scaled) — i.e. exactly
        # (res.x, res.z, res.y) of a previous AdmmResult
        x0w, z0w, y0w = warm
        x = x0w / spec.D
        z = jnp.clip(z0w, l, u)
        y = y0w

    AT = spec.A.T
    prec = spec.precision

    def mm(a, b):
        return jnp.matmul(a, b, precision=prec)

    def body(_, carry):
        x, z, y, _ = carry
        w = rho * z - y
        xt = mm(sigma * x - qh + mm(w, spec.A), spec.Kinv.T)
        zt = mm(xt, AT)
        zr = alpha * zt + (1.0 - alpha) * z
        z_new = jnp.clip(zr + y / rho, l, u)
        y_new = y + rho * (zr - z_new)
        return xt, z_new, y_new, y_new - y

    dy0 = jnp.zeros_like(y)
    x, z, y, dy = jax.lax.fori_loop(0, iters, body, (x, z, y, dy0))

    # residuals/objective unscaled back to original units
    Ax = mm(x, AT)
    Ax_orig = Ax / spec.E
    viol = jnp.abs(Ax - jnp.clip(Ax, l, u)) / spec.E
    r_prim = jnp.max(viol, axis=-1)
    # per-ROW relative violation: a global denominator lets large-scale
    # rows (kW-level coupling) mask unit-scale logic-row violations
    r_rel = jnp.max(viol / jnp.maximum(1.0, jnp.abs(Ax_orig)), axis=-1)
    dual = (mm(x, spec.P.T) + qh + mm(y, spec.A)) / (spec.D * c)
    r_dual = jnp.max(jnp.abs(dual), axis=-1)
    obj = (0.5 * jnp.sum(x * mm(x, spec.P.T), axis=-1)
           + jnp.sum(qh * x, axis=-1)) / c
    x_orig = spec.D * x

    # primal-infeasibility certificate (OSQP §3.4) from δy of the last
    # iteration, in the scaled frame: Aᵀδy ≈ 0 ∧ supp(δy) respects the
    # infinite bounds ∧ uᵀ[δy]₊ + lᵀ[δy]₋ < 0.
    dy_norm = jnp.max(jnp.abs(dy), axis=-1)
    Atdy = jnp.max(jnp.abs(mm(dy, spec.A)), axis=-1)
    fin_u = u < 0.9 * BIG
    fin_l = l > -0.9 * BIG
    dyp = jnp.maximum(dy, 0.0)
    dyn_ = jnp.minimum(dy, 0.0)
    if spec.dd_cert:
        # compensated support/gap sums (see BoxQP.dd_cert): the gap sum
        # cancels big-M-scale u·δy terms down to an eps_c·|δy| decision
        # margin — exactly the shape plain fp32 summation corrupts.
        # (A̅ᵀδy stays a precision-"highest" matmul: its test threshold
        # eps_c·‖δy‖ is ~5e3× the fp32 dot's rounding envelope here.)
        from pyhybridcontrol_tpu.utils.dd import dd_dot, dd_sum

        support = dd_sum(jnp.where(~fin_u, dyp, 0.0)
                         + jnp.where(~fin_l, -dyn_, 0.0), axis=-1)
        # per row at most one of [δy]₊/[δy]₋ is nonzero, so the bound
        # coefficient is u (δy>0) or l (δy<0) and Dot2 gets the exact
        # per-term product error too
        coef = jnp.where(dy > 0.0, jnp.where(fin_u, u, 0.0),
                         jnp.where(fin_l, l, 0.0))
        gap_term = dd_dot(coef, dy, axis=-1)
    else:
        support = (jnp.sum(jnp.where(~fin_u, dyp, 0.0), axis=-1)
                   + jnp.sum(jnp.where(~fin_l, -dyn_, 0.0), axis=-1))
        gap_term = (jnp.sum(jnp.where(fin_u, u * dyp, 0.0), axis=-1)
                    + jnp.sum(jnp.where(fin_l, l * dyn_, 0.0), axis=-1))
    eps_c = 1e-4
    infeas_cert = ((dy_norm > 1e-12)
                   & (Atdy <= eps_c * dy_norm)
                   & (support <= eps_c * dy_norm)
                   & (gap_term <= -eps_c * dy_norm))
    return AdmmResult(x=x_orig, obj=obj, r_prim=r_prim,
                      r_prim_rel=r_rel, r_dual=r_dual,
                      infeas_cert=infeas_cert, y=y, z=z)


def admm_dual_bound(spec: BoxQP, q, h, lb, ub, res: AdmmResult):
    """CERTIFIED lower bound on the box-QP optimum from the final ADMM
    iterate — valid for ANY iterate, converged or not (Falk-style
    partial-dualization bound; no matrix inverse anywhere).

    Dualize ONLY the G rows with ŷ_G ≥ 0 and keep the variable box as
    an explicit constraint; then underestimate the inner box-QP by its
    supporting tangent at the current iterate x̄ (convexity):

        p* ≥ −ŷ_Gᵀû_G + f₀(x̄) + Σᵢ min ∇ᵢ·(x′ᵢ − x̄ᵢ)  over x′∈[lb,ub]
        f₀(x) = ½xᵀP̂x + ŵᵀx,   ŵ = q̂ + Â_Gᵀŷ_G,   ∇ = P̂x̄ + ŵ

    Valid for ANY x̄ and ANY ŷ_G ≥ 0 by weak duality + convexity, and
    TIGHT at the optimum: there ∇ equals minus the box multipliers, so
    complementary slackness zeroes every tangent term and the bound
    collapses to the optimal value.

    Why not the textbook dual g(y) = −½wᵀP̂⁻¹w − S(y): condensed big-M
    Hessians are numerically SINGULAR (pwa_spring P̂ is not fp32-
    invertible at all), so P̂⁻¹ has ~1e6-scale entries and the fp32
    quad form loses ~12 absolute on an objective of 13 — the "bound"
    lands ABOVE the true leaf optimum and prunes optimal subtrees
    (measured: cert 24.99 vs leaf optimum 12.92 on pwa_spring N=3).
    The tangent bound touches nothing larger than P̂x̄ and the box
    widths, so its fp32 error is parity-grade.

    Replaces "trust relax.obj when the residual is small" in the B&B:
    relax.obj of a merely primal-feasible iterate can over/under-
    estimate the true relaxation optimum by ~1e-2 (battery leaves,
    measured), which with a 1e-4 prune gap silently mis-prunes. Costs
    two extra matmuls per node (≈1 iteration).

    Variables with an infinite (BIG-clipped) bound on the side the
    tangent descends toward yield −BIG — the caller (solver/bnb.py)
    falls back to the parent bound on non-finite certs.

    Returns the bound in ORIGINAL units, same leading batch as res.obj.
    """
    return _falk_cert(spec, q, h, lb, ub, res)[0]


def _falk_cert(spec: BoxQP, q, h, lb, ub, res: AdmmResult,
               binary_idx=None):
    """Shared Falk-cert computation (see ``admm_dual_bound``).

    Returns ``(bound, extras)`` — extras is None unless ``binary_idx``
    is given, in which case it is a tuple of per-binary node-presolve
    data (see ``admm_node_cert``)."""
    prec = spec.precision
    c = spec.cost_scale
    qh = c * spec.D * q
    m = spec.m_ineq
    xh = res.x / spec.D

    def mm(a, b):
        return jnp.matmul(a, b, precision=prec)

    # G-row duals: l=−BIG one-sided rows (see _bounds), so feasible
    # duals are the nonnegative ones; clamping is always valid.
    yG = jnp.maximum(res.y[..., :m], 0.0)
    uG = h * spec.E[:m]
    dirv = mm(yG, spec.A[:m])
    Px = mm(xh, spec.P.T)
    # variable box in the x̂ frame (x = D x̂). Big-M condensed QPs leave
    # u/z auxiliaries formally unbounded (pwa_spring: 18/27 vars) while
    # the G rows bound them (z ≤ Mδ …) — without finite boxes the
    # tangent term of any variable with a 1e-6 gradient residual is
    # −1e24 and the bound is valid-but-useless. Two interval-arithmetic
    # tightening passes over Â_G recover the implied finite boxes.
    lbh = jnp.clip(lb / spec.D, -BIG, BIG)
    ubh = jnp.clip(ub / spec.D, -BIG, BIG)
    lbh, ubh = _implied_box(spec.A[:m], uG, lbh, ubh, passes=2)
    # dual line search: g(α·y_G) is concave in α and the bound is valid
    # for every α ≥ 0 — take the per-element max over a few candidates.
    # Mid-convergence ADMM duals are often actively harmful (pwa root
    # at 200 iters: α=1 gives −78, α=0 gives the TIGHT bound −4.6e-5);
    # converged duals want α=1. The matmuls (Âᵀy_G, P̂x̄) are shared, so
    # extra candidates cost only elementwise work.
    if spec.dd_cert:
        # compensated reductions (see BoxQP.dd_cert): the tangent terms
        # ``used`` carry opposite-signed 1e2-scale entries certifying
        # 1e-3-scale bounds — plain fp32 summation was the measured
        # failure mode of chip strong branching (VERDICT r4 item 2).
        from pyhybridcontrol_tpu.utils.dd import dd_dot, dd_sum

        def rdot(u_, v_):
            return dd_dot(u_, v_, axis=-1)

        rsum = dd_sum
    else:
        def rdot(u_, v_):
            return jnp.sum(u_ * v_, axis=-1)

        def rsum(u_, axis=-1):
            return jnp.sum(u_, axis=axis)

    f0q = 0.5 * rdot(xh, Px)
    S1 = rdot(yG, uG)
    bound = grad = used = None
    for a in (0.0, 0.5, 1.0):
        w_a = qh + a * dirv if a else qh
        grad_a = Px + w_a
        used_a = jnp.minimum(grad_a * (lbh - xh), grad_a * (ubh - xh))
        bound_a = (f0q + rdot(w_a, xh)
                   + rsum(used_a) - a * S1) / c
        if bound is None:
            bound, grad, used = bound_a, grad_a, used_a
        else:
            take = bound_a > bound
            bound = jnp.where(take, bound_a, bound)
            grad = jnp.where(take[..., None], grad_a, grad)
            used = jnp.where(take[..., None], used_a, used)
    if binary_idx is None:
        return bound, None
    bidx = jnp.asarray(binary_idx)
    Db = spec.D[bidx]
    gb = grad[..., bidx]
    xb = xh[..., bidx]
    ub_used = used[..., bidx]
    # tangent-retained integral side, and the certified objective DELTA
    # of forcing the binary to the OTHER side: the flipped subproblem's
    # tangent term is exact (the coordinate is a point), every other
    # term is unchanged, so  bound_flip = bound + flip_delta  is a
    # valid lower bound for the forced-flip child (reduced-cost fixing)
    retain = (gb < 0.0).astype(res.x.dtype)       # grad≥0 → keep 0-side
    flipval = (1.0 - retain) / Db                 # opposite side, x̂
    flip_delta = (gb * (flipval - xb) - ub_used) / c
    # implied binary box back in 0/1 units (implied-integrality fixing)
    imp_lo = lbh[..., bidx] * Db
    imp_hi = ubh[..., bidx] * Db
    return bound, (flip_delta, retain, imp_lo, imp_hi)


def admm_node_cert(spec: BoxQP, q, h, lb, ub, res: AdmmResult,
                   binary_idx):
    """Falk cert plus per-binary node-presolve data.

    Returns ``(bound, flip_delta, retain_side, imp_lo, imp_hi)``, all
    with res.obj's leading batch plus a trailing (nb,) axis:

    - ``flip_delta`` ≥ 0: certified objective increase of forcing the
      binary to the side OPPOSITE the tangent's choice — with incumbent
      U, ``bound + flip_delta ≥ U − gap`` proves the flip side cannot
      beat the incumbent, so the binary may be fixed to ``retain_side``
      at this node and all descendants (reduced-cost fixing).
    - ``imp_lo``/``imp_hi``: the binary's implied box in 0/1 units —
      ``imp_lo > ε`` proves every feasible point has the binary at 1,
      ``imp_hi < 1−ε`` at 0 (implied-integrality fixing).
    """
    bound, extras = _falk_cert(spec, q, h, lb, ub, res,
                               binary_idx=binary_idx)
    return (bound,) + extras


def _implied_box(A, u, lbh, ubh, passes: int = 2):
    """Implied variable bounds from one-sided rows  A x ≤ u  plus the
    current box — the classic MIP-presolve interval tightening, run on
    device per node (u/lbh/ubh may carry leading batch dims).

    For row i:  A_ij x_j ≤ u_i − Σ_{k≠j} min(A_ik lb_k, A_ik ub_k), so
    A_ij > 0 tightens ub_j and A_ij < 0 tightens lb_j. Rows/terms with
    unbounded contributors yield ±BIG-scale candidates that tighten
    nothing. Valid for the node AND its descendants (their feasible
    sets are subsets). Tightened bounds may cross on infeasible nodes
    (contradictory fixed binaries) — every finite value is then
    vacuously a valid bound for an empty feasible set."""
    Ap = jnp.maximum(A, 0.0)
    An = jnp.minimum(A, 0.0)
    eps = 1e-6
    pos = A > eps
    neg = A < -eps
    for _ in range(passes):
        # contrib[..., i, j] = min over the box of A_ij x_j. BIG-scale
        # contributions (unbounded variables) are tracked SEPARATELY
        # from the finite sum: u_i + BIG − BIG in floating point
        # silently absorbs u_i (measured: a 'x_0 ≤ 5' row tightened to
        # x_0 ≤ 0 and invalidated the whole bound on battery leaves).
        # A column may tighten only when every OTHER contributor in its
        # row is finite — then the arithmetic is exact by construction.
        contrib = jnp.clip(Ap * lbh[..., None, :] + An * ubh[..., None, :],
                           -BIG, BIG)
        # "unbounded" at a deliberately LOW threshold: a coefficient
        # times a ±1e30 box lands anywhere (0.2·1e30 = 2e29), and any
        # contribution that dwarfs u_i absorbs it in floating point
        # (u − 2e29 + 2e29 = 0 silently dropped u, over-tightening —
        # measured on battery 'x_0 ≤ 5' rows). ≥1e8 tightens nothing
        # useful anyway, so classifying it unbounded only loses slack.
        big = jnp.abs(contrib) >= 1e8
        fin = jnp.where(big, 0.0, contrib)
        fin_sum = jnp.sum(fin, axis=-1)                    # (..., m)
        abs_sum = jnp.sum(jnp.abs(fin), axis=-1)
        nbig = jnp.sum(big, axis=-1)                       # (..., m)
        others_fin = (nbig[..., :, None] - big.astype(nbig.dtype)) == 0
        # conservative slack ≫ fp32 summation error of the finite
        # terms: rounding may only LOOSEN the implied bound, never
        # tighten it past the true one.
        safety = 1e-5 * abs_sum + 1e-6 * jnp.abs(u)
        avail = jnp.where(
            others_fin,
            u[..., :, None] - (fin_sum[..., :, None] - fin)
            + safety[..., :, None],
            BIG)                                           # u−Σ_{k≠j}
        ub_cand = jnp.where(pos & others_fin,
                            avail / jnp.where(pos, A, 1.0), BIG)
        lb_cand = jnp.where(neg & others_fin,
                            avail / jnp.where(neg, A, -1.0), -BIG)
        ubh = jnp.minimum(ubh, jnp.clip(jnp.min(ub_cand, axis=-2),
                                        -BIG, BIG))
        lbh = jnp.maximum(lbh, jnp.clip(jnp.max(lb_cand, axis=-2),
                                        -BIG, BIG))
    return lbh, ubh


def admm_solve_batch(spec: BoxQP, q, h, lb, ub, iters: int = 100):
    """Explicit-batch convenience: q (B,n) or (n,), lb/ub (B,n)."""
    B = lb.shape[0]
    qb = jnp.broadcast_to(q, (B,) + q.shape[-1:]) if q.ndim == 1 else q
    hb = jnp.broadcast_to(h, (B,) + h.shape[-1:]) if h.ndim == 1 else h
    return admm_solve(spec, qb, hb, lb, ub, iters=iters)


def admm_solve_mixed(spec: BoxQP, q, h, lb, ub, iters: int = 100,
                     low_frac: float = 0.8, low_precision: str = "high",
                     warm=None) -> AdmmResult:
    """Two-phase precision schedule: the first ``low_frac`` of the
    iterations run at ``low_precision`` matmuls (TF32 on the GPU), the
    tail at the spec's full precision, warm-chained. Measured ~+20%
    solves/s at N=20 for ~1e-3-relative objective noise — opt-in for
    throughput-bound scenario studies; keep full precision for B&B
    bounds and parity work. Shares all problem arrays (precision is a
    static field), so no extra memory."""
    k = int(iters * low_frac)
    if k <= 0 or k >= iters:
        return admm_solve(spec, q, h, lb, ub, iters=iters, warm=warm)
    lo = dataclasses.replace(spec, precision=low_precision)
    r1 = admm_solve(lo, q, h, lb, ub, iters=k, warm=warm)
    return admm_solve(spec, q, h, lb, ub, iters=iters - k,
                      warm=(r1.x, r1.z, r1.y))
