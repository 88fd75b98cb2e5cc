"""Stagewise (sparse, O(N)) MPC QP solver — the long-horizon path
(SURVEY.md §5 "long-context / sequence parallelism": condensed form is
O(N²) memory; for large N switch to the stagewise form solved by a
Riccati-like block-tridiagonal factorization inside the QP solver).

Formulation. Stage variables ξ_k = [v_k; x_{k+1}], k = 0…N−1 (block size
b = nv + nx — states are NOT eliminated). OSQP-form rows per stage:

    dynamics (equality, l=u):  x_{k+1} − Bv v_k − A x_k = b5 + B4 ω_k
    stage ineq:                E x_k + Fv v_k ≤ f5 − F4 ω_k
    box:                       lb_k ≤ ξ_k ≤ ub_k

x_k lives in ξ_{k−1} (x_0 is data, folded into the k=0 bounds), so every
row couples at most (ξ_{k−1}, ξ_k): AᵀA — and hence the ADMM KKT matrix
K = P + σI + Aᵀdiag(ρ)A — is block-tridiagonal. K is factored ONCE on
the host (fp64 block LU, the Riccati-like sweep); each ADMM iteration
applies A/Aᵀ stage-locally (batched small matmuls over (B, N) on the
device) and solves Kξ = t with two length-N ``lax.scan`` sweeps carrying a
(B, b) block. Memory and FLOPs are O(N·b²) per solve instead of the
condensed path's O(N²·nv²) — the horizon is the sequence axis and this
is its O(N) attention-free treatment.

Same per-row-ρ equality boost as ops/admm.py: dynamics rows (true
equalities) get ρ·rho_eq_scale, binary box rows likewise.

Supported weights: Qx/QxN/qx/qxN, Ru/ru, Qdelta/qdelta, Rz/rz, x_ref,
per-step price sequences, Δu rate (Rdu, u_{−1} at feedback) and
y-output costs (Qy/qy). Δu and Qy couple consecutive stages, so the
objective P is block-TRIdiagonal (P_off) rather than block-diagonal —
K keeps the exact same block-tridiagonal LU, the off blocks just gain
a P term.

Move blocking and terminal sets (SURVEY.md §2a; round-3): both ride as
extra per-stage ROWS, so they preserve block-tridiagonality exactly —
no decision reshaping as in the condensed path (ops/condense.py
``with_move_blocking`` rebuilds V in the blocked frame; here the
decision stays the full per-step ξ):

  * blocking: contiguous step-groups become adjacent-stage equality
    rows  u_k − u_{k−1} = 0  for every non-leader stage (vacuous ±BIG
    bounds at block leaders — an unconstrained consensus row is exact:
    its fixed point is z=Aξ, y=0). Branching shrinks the same way as
    the condensed path: blocked binary-input coordinates branch only at
    block-LEADER stages (solver/bnb_stagewise.py reads
    ``blk_groups``/``blk_cols``); the equality rows propagate the fixed
    value to the tied stages inside every relaxation.
  * terminal set  E_N x_N ≤ f_N: stage-local rows on x_{k+1}, real at
    k = N−1 and vacuous elsewhere.

Both row families join the dual bound (``stagewise_dual_bound``): tied
blocking rows carry free-sign equality duals (rhs 0 → no S term),
terminal rows nonnegative duals on the finite last stage.

Soft constraints take the prox route (no slack variables): a soft
inequality row with penalty lin·s + quad·s² (s = violation) is the
exact proximal z-update  z = u + max(ρ(v−u) − lin, 0)/(ρ + 2·quad)
for v beyond the bound — closed-form, elementwise on the VPU, O(0)
extra memory, and the objective adds the penalty explicitly so B&B
bounds stay exact. Parity with the condensed slack formulation is
tested (tests/test_stagewise.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from pyhybridcontrol_tpu.mld.model import MldModel
from pyhybridcontrol_tpu.ops.admm import AdmmResult
from pyhybridcontrol_tpu.ops.condense import MpcWeights, _sq, _vec

BIG = 1e30


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class StagewiseQP:
    """Prepared stagewise ADMM data (pytree). Shapes: b = nv+nx block,
    m_k = nx + ncons + b rows per stage."""

    # per-stage constraint blocks (shared across k)
    Bv: jnp.ndarray          # (nx, nv)
    A_dyn: jnp.ndarray       # (nx, nx)
    E: jnp.ndarray           # (nc, nx)
    Fv: jnp.ndarray          # (nc, nv)
    # objective (block tridiagonal: Δu / Qy couple consecutive stages)
    P_diag: jnp.ndarray      # (N, b, b) diagonal blocks
    P_off: jnp.ndarray       # (N, b, b) P_{k,k−1}; [0] zero
    q0: jnp.ndarray          # (N, b) constant linear term
    # feedback-time linear-term maps (zero matrices when unused)
    Rdu2: jnp.ndarray        # (nu, nu) 2·Rdu — q[0,:nu] −= Rdu2 u_prev
    M_vy: jnp.ndarray        # (nv, ny) 2·DvᵀQy — y-data → v linear term
    M_xy: jnp.ndarray        # (nx, ny) 2·CᵀQy  — y-data → x linear term
    Cy: jnp.ndarray          # (ny, nx) output C (y_0 carries C x_0 data)
    D4y: jnp.ndarray         # (ny, nw) output disturbance map
    # soft constraints (prox form; zeros = hard row)
    soft_lin: jnp.ndarray    # (N, m_k) linear penalty per row
    soft_quad: jnp.ndarray   # (N, m_k) quadratic penalty per row
    # move blocking (equality-row form): tie[k,j] = 1 ⇔ blocked coord
    # blk_cols[j] of stage k is tied to stage k−1 (non-leader)
    tie: jnp.ndarray         # (N, n_blk); (N, 0) when no blocking
    # terminal set rows E_t x_N ≤ f_t (vacuous before the last stage)
    Et: jnp.ndarray          # (n_term, nx)
    ft: jnp.ndarray          # (n_term,)
    # K factorization (block LU): forward L, diagonal-inverse U⁻¹, and
    # the back-substitution coupler C_k = U_k⁻¹ K_{k,k+1}
    L: jnp.ndarray           # (N, b, b), L[0] unused
    Uinv: jnp.ndarray        # (N, b, b)
    C: jnp.ndarray           # (N, b, b), C[N-1] unused
    # bounds templates
    lb_xi: jnp.ndarray       # (N, b) variable box
    ub_xi: jnp.ndarray       # (N, b)
    f5: jnp.ndarray          # (nc,)
    b5: jnp.ndarray          # (nx,)
    B4: jnp.ndarray          # (nx, nw)
    F4: jnp.ndarray          # (nc, nw)
    rho_rows: jnp.ndarray    # (N, m_k) per-row ρ
    N: int = dataclasses.field(metadata=dict(static=True))
    nx: int = dataclasses.field(metadata=dict(static=True))
    nv: int = dataclasses.field(metadata=dict(static=True))
    nc: int = dataclasses.field(metadata=dict(static=True))
    sigma: float = dataclasses.field(metadata=dict(static=True))
    alpha: float = dataclasses.field(metadata=dict(static=True))
    binary_idx_v: tuple = dataclasses.field(metadata=dict(static=True))
    has_soft: bool = dataclasses.field(metadata=dict(static=True))
    # static blocking layout: v-coords carried by the blk rows (empty =
    # no blocking) and the step-group ids (leaders branch; solver/
    # bnb_stagewise.py)
    blk_cols: tuple = dataclasses.field(default=(),
                                        metadata=dict(static=True))
    blk_groups: tuple = dataclasses.field(default=(),
                                          metadata=dict(static=True))
    n_term: int = dataclasses.field(default=0,
                                    metadata=dict(static=True))
    # consensus selector rows (scenario-tree non-anticipativity —
    # ops/stagewise_tree.py): n_cons extra rows per stage, each the
    # identity on ξ_k coordinate j (j < n_cons, i.e. the u/δ part of
    # v_k), with vacuous ±BIG bounds. Stage-LOCAL, so block-
    # tridiagonality is untouched; the tree solver overrides their
    # z-update with the probability-weighted group mean over scenarios
    # (the exact consensus prox — cf. ops/consensus_tree.py).
    n_cons: int = dataclasses.field(default=0,
                                    metadata=dict(static=True))
    # horizon-coupled EXTRA rows  A_v·V ≤ b + Bx·x0 + Bw·W  (round 4 —
    # the last condensed-only capability: min-up/down unit-commitment
    # logic at long N). They are GLOBAL rows (touch many stages), so
    # they live as their own constraint segment and the x-update's
    # K + Aextᵀρₑ Aext solve is a rank-r BORDERED extension of the
    # block-tridiagonal K via Woodbury: x = K⁻¹t − KiU·Cw·(Uᵀ K⁻¹ t)
    # with KiU = K⁻¹Aextᵀ prefactored on the host (r block-tridiag
    # solves) and Cw = (diag(1/ρₑ) + Aext K⁻¹ Aextᵀ)⁻¹ an r×r constant
    # — O(N·b·r) extra work per iteration, O(N) memory preserved.
    Aext: jnp.ndarray = None     # (r, N, b) coefficients on ξ
    bext: jnp.ndarray = None     # (r,)
    Bx_ext: jnp.ndarray = None   # (r, nx)
    Bw_ext: jnp.ndarray = None   # (r, N·nw)
    rho_ext: jnp.ndarray = None  # (r,)
    KiU: jnp.ndarray = None      # (N, b, r)
    Cw: jnp.ndarray = None       # (r, r)
    n_ext: int = dataclasses.field(default=0,
                                   metadata=dict(static=True))

    @property
    def b(self) -> int:
        return self.nv + self.nx

    @property
    def n_blk(self) -> int:
        return len(self.blk_cols)

    @property
    def m_k(self) -> int:
        return (self.nx + self.nc + self.b + self.n_blk + self.n_term
                + self.n_cons)


def prepare_stagewise(model: MldModel, N: int,
                      weights: Optional[MpcWeights] = None,
                      rho: float = 1.0, rho_eq_scale: float = 10.0,
                      sigma: float = 1e-6, alpha: float = 1.6,
                      reg: float = 1e-8, soft=None,
                      blocking=None, block_deltas: bool = False,
                      terminal=None, consensus: int = 0,
                      extra=None,
                      dtype=jnp.float32) -> StagewiseQP:
    """Host fp64 build: stage blocks + block-tridiagonal LU of K.

    ``soft``: optional (rows, lin_pen, quad_pen) with ``rows`` indexing
    stage-inequality rows over the horizon as ``k*ncons + r`` (the same
    convention as ``CondensedMpc.with_soft_constraints``).
    ``blocking``: optional length-N step-group ids (nondecreasing,
    contiguous — the ``with_move_blocking`` convention): the input u is
    held constant within each group via adjacent-stage equality rows
    (module docstring). ``block_deltas=True`` ties δ as well.
    ``terminal``: optional (E_N, f_N) terminal-set rows on x_N.
    ``consensus``: number of leading v-coordinates per stage (the
    shared-decision u/δ block) that get a consensus selector row — see
    ``StagewiseQP.n_cons``; only ops/stagewise_tree.py sets this.
    ``extra``: optional horizon-coupled rows ``(A_v, b, B_x, B_w)`` in
    the ``MpcController.set_extra_constraints`` convention —
    A_v·V ≤ b + B_x·x0 + B_w·vec(W) with V the stacked per-stage v.
    Handled as a rank-r BORDERED extension of K (Woodbury; see the
    ``StagewiseQP.Aext`` field comment): O(N·b·r) extra work per ADMM
    iteration, O(N) memory preserved."""
    w = weights or MpcWeights()
    info = model.info
    if info.nxb > 0:
        raise ValueError(
            "stagewise solver does not support binary states (nxb>0): "
            "branching runs over per-step v binaries only. Use the "
            "condensed path, which enforces state integrality via "
            "auxiliary binaries (ops/condense.py)")
    m = model.numpy_mats()
    nx, nv, nc = info.nx, info.nv, info.ncons
    b = nv + nx
    Bv = np.hstack([m.B1, m.B2, m.B3])
    Fv = np.hstack([m.F1, m.F2, m.F3])

    # objective blocks (same user convention as condense.py: ×2 internal)
    Qx = _sq(w.Qx, nx)
    QxN = _sq(w.QxN, nx) if w.QxN is not None else Qx
    Rv = np.zeros((nv, nv))
    Rv[info.u_slice, info.u_slice] = _sq(w.Ru, info.nu)
    Rv[info.delta_slice, info.delta_slice] = _sq(w.Qdelta, info.ndelta)
    Rv[info.z_slice, info.z_slice] = _sq(w.Rz, info.nz)
    rv = np.concatenate([_vec(w.ru, info.nu), _vec(w.qdelta, info.ndelta),
                         _vec(w.rz, info.nz)])
    qx = _vec(w.qx, nx)
    qxN = _vec(w.qxN, nx) if w.qxN is not None else qx

    P_diag = np.zeros((N, b, b))
    P_off = np.zeros((N, b, b))        # P_{k,k−1}
    q0 = np.zeros((N, b))
    for k in range(N):
        Qk = QxN if k == N - 1 else Qx
        qk = qxN if k == N - 1 else qx
        if w.x_ref is not None:
            qk = qk - 2.0 * (Qk @ _vec(w.x_ref, nx))
        P_diag[k, :nv, :nv] = 2.0 * Rv
        P_diag[k, nv:, nv:] = 2.0 * Qk
        P_diag[k] += reg * np.eye(b)
        q0[k, :nv] = rv
        q0[k, nv:] = qk

    # Δu rate cost (condense.py:282 convention: Δu_k = u_k − u_{k−1},
    # k = 0..N−1, u_{−1} supplied at feedback → assemble-time q term)
    nu = info.nu
    Rdu2 = np.zeros((nu, nu))
    if w.Rdu is not None and nu > 0:
        Rdu2 = 2.0 * _sq(w.Rdu, nu)
        for k in range(N):
            P_diag[k, :nu, :nu] += Rdu2            # from Δu_k
            if k < N - 1:
                P_diag[k, :nu, :nu] += Rdu2        # from Δu_{k+1}
            if k >= 1:
                P_off[k, :nu, :nu] -= Rdu2         # u_k·u_{k−1} cross

    # y-output cost over y_0..y_{N−1}: y_k = C x_k + Dv v_k + D4 ω_k +
    # d5 (condense.py:265). x_k is ξ_{k−1}'s x-part (k≥1; x_0 is data →
    # assemble-time), v_k is ξ_k's v-part → one more cross-stage block.
    ny = m.C.shape[0]
    Dv = np.hstack([m.D1, m.D2, m.D3])
    M_vy = np.zeros((nv, ny))
    M_xy = np.zeros((nx, ny))
    if (w.Qy is not None or w.qy is not None) and ny > 0:
        Qy = _sq(w.Qy, ny)
        qy = _vec(w.qy, ny)
        M_vy = 2.0 * Dv.T @ Qy
        M_xy = 2.0 * m.C.T @ Qy
        d5 = m.d5[:, 0]
        gy = 2.0 * (Qy @ d5) + qy                  # constant y-data part
        for k in range(N):
            P_diag[k, :nv, :nv] += 2.0 * Dv.T @ Qy @ Dv
            q0[k, :nv] += Dv.T @ gy
            if k >= 1:
                P_diag[k - 1, nv:, nv:] += 2.0 * m.C.T @ Qy @ m.C
                q0[k - 1, nv:] += m.C.T @ gy
                P_off[k, :nv, nv:] += M_vy @ m.C   # v_k · x_k cross

    # ---- move blocking / terminal rows (module docstring) --------------
    nu_model = info.nu
    blk_cols: tuple = ()
    blk_groups: tuple = ()
    tie = np.zeros((N, 0))
    if blocking is not None:
        groups = [int(g) for g in blocking]
        if len(groups) != N:
            raise ValueError(f"blocking needs {N} group ids, got "
                             f"{len(groups)}")
        if groups[0] != 0 or any(g2 - g1 not in (0, 1) for g1, g2 in
                                 zip(groups, groups[1:])):
            raise ValueError("blocking groups must start at 0 and be "
                             "contiguous nondecreasing (condensed "
                             "with_move_blocking convention)")
        cols = list(range(nu_model))
        if block_deltas:
            cols += list(range(info.delta_slice.start,
                               info.delta_slice.stop))
        blk_cols = tuple(cols)
        blk_groups = tuple(groups)
        tie = np.zeros((N, len(cols)))
        for k in range(1, N):
            if groups[k] == groups[k - 1]:
                tie[k, :] = 1.0
    n_blk = len(blk_cols)
    if terminal is not None:
        Et = np.atleast_2d(np.asarray(terminal[0], np.float64))
        ft = np.asarray(terminal[1], np.float64).reshape(-1)
        if Et.shape != (len(ft), nx):
            raise ValueError(f"terminal E must be ({len(ft)}, {nx}), "
                             f"got {Et.shape}")
    else:
        Et = np.zeros((0, nx))
        ft = np.zeros((0,))
    n_term = len(ft)

    n_cons = int(consensus)
    if n_cons < 0 or n_cons > nv:
        raise ValueError(f"consensus must be in [0, nv={nv}]")

    # soft stage-inequality rows → per-row prox penalties
    m_k_rows = nx + nc + b + n_blk + n_term + n_cons
    soft_lin = np.zeros((N, m_k_rows))
    soft_quad = np.zeros((N, m_k_rows))
    if soft is not None:
        rows, lin_pen, quad_pen = soft
        rows = np.asarray(rows, dtype=int)
        lin_a = np.broadcast_to(np.asarray(lin_pen, float), rows.shape)
        quad_a = np.broadcast_to(np.asarray(quad_pen, float), rows.shape)
        if np.any(rows < 0) or np.any(rows >= N * nc):
            raise ValueError(
                f"soft rows must lie in [0, N*ncons={N * nc})")
        k_idx, r_idx = rows // nc, rows % nc
        soft_lin[k_idx, nx + r_idx] = lin_a
        soft_quad[k_idx, nx + r_idx] = quad_a

    # per-stage A blocks. Row layout:
    # [dyn(nx); ineq(nc); box(b); blk(n_blk); term(n_term)].
    # "own" block J_k (cols = ξ_k), "prev" block M_k (cols = ξ_{k−1}).
    # J: dyn rows [−Bv, I]; ineq rows [Fv, 0]; box rows I_b;
    #    blk rows S (selector of blk_cols in v); term rows [0, Et]
    # M: dyn rows [0, −A]; ineq rows [0, E]; box 0; blk −tie_k∘S; term 0
    m_k = m_k_rows

    # ---- K = P + σI + Aᵀdiag(ρ)A (block tridiagonal), host fp64 ----
    rho_rows = np.full(m_k, rho)
    rho_rows[:nx] = rho * rho_eq_scale          # dynamics equalities
    vb_mask = info.v_binary_mask
    box_rho = np.full(b, rho)
    box_rho[:nv][vb_mask] = rho * rho_eq_scale  # binary boxes
    rho_rows[nx + nc:nx + nc + b] = box_rho
    if n_blk:                                   # blocking equalities
        rho_rows[nx + nc + b:nx + nc + b + n_blk] = rho * rho_eq_scale
    if n_cons:                                  # consensus equalities
        rho_rows[nx + nc + b + n_blk + n_term:] = rho * rho_eq_scale
    rho_full = np.tile(rho_rows, (N, 1))

    J = np.zeros((m_k, b))
    J[:nx, :nv] = -Bv
    J[:nx, nv:] = np.eye(nx)
    J[nx:nx + nc, :nv] = Fv
    J[nx + nc:nx + nc + b, :] = np.eye(b)
    S_blk = np.zeros((n_blk, b))
    for j, cj in enumerate(blk_cols):
        S_blk[j, cj] = 1.0
    J[nx + nc + b:nx + nc + b + n_blk] = S_blk
    if n_term:
        J[nx + nc + b + n_blk:nx + nc + b + n_blk + n_term, nv:] = Et
    if n_cons:                                  # consensus selectors
        J[nx + nc + b + n_blk + n_term:, :n_cons] = np.eye(n_cons)
    M = np.zeros((m_k, b))
    M[:nx, nv:] = -m.A
    M[nx:nx + nc, nv:] = m.E
    # blk M-part is −tie_k∘S: per-STAGE (handled below)

    R = np.diag(rho_rows)
    K_diag = np.zeros((N, b, b))
    K_off = np.zeros((N, b, b))       # K_{k,k-1} = J'R M  ... careful:
    # rows of stage k touch ξ_k (J) and ξ_{k−1} (M):
    #   K_{k,k}   += JᵀRJ  (from stage-k rows) + MᵀRM (from stage-k+1 rows)
    #   K_{k,k−1}  = (stage-k rows): JᵀR M   → couples ξ_k(row-own) ξ_{k−1}
    JtRJ = J.T @ R @ J
    MtRM = M.T @ R @ M
    JtRM = J.T @ R @ M
    rho_blk = rho * rho_eq_scale
    bc = np.asarray(blk_cols, int)
    for k in range(N):
        K_diag[k] = P_diag[k] + sigma * np.eye(b) + JtRJ
        if k + 1 < N:
            K_diag[k] += MtRM
            if n_blk:
                # stage-(k+1) blk rows' M-part: (−tie∘S)ᵀρ(−tie∘S)
                K_diag[k][bc, bc] += rho_blk * tie[k + 1] ** 2
        if k >= 1:
            K_off[k] = JtRM + P_off[k]   # K_{k,k−1} (constraint + obj)
            if n_blk:
                # stage-k blk rows: JᵀR M = Sᵀρ(−tie_k∘S)
                K_off[k][bc, bc] += -rho_blk * tie[k]
    # Note: stage-0 rows have no ξ_{−1}; their M-part references x_0 which
    # is DATA (enters l/u), so M does not contribute to K at k=0. ✓
    # (tie[0] = 0 by construction, so the blk terms respect this too.)

    # block LU: U_0 = K_00; L_k = K_{k,k−1} U_{k−1}⁻¹; U_k = K_kk − L_k K_{k−1,k}
    def block_lu(diag, off):
        L = np.zeros((N, b, b))
        Uinv = np.zeros((N, b, b))
        C = np.zeros((N, b, b))
        U_prev = None
        off_T = np.transpose(off, (0, 2, 1))   # M_{k−1,k} = (M_{k,k−1})ᵀ
        for k in range(N):
            if k == 0:
                U = diag[0]
            else:
                L[k] = off[k] @ np.linalg.inv(U_prev)
                U = diag[k] - L[k] @ off_T[k]
            Uinv[k] = np.linalg.inv(U)
            U_prev = U
        for k in range(N - 1):
            C[k] = Uinv[k] @ off_T[k + 1]      # coupler for back-subst
        return L, Uinv, C

    L, Uinv, C = block_lu(K_diag, K_off)

    # ---- horizon-coupled extra rows: host-side Woodbury factors ----
    nw = m.B4.shape[1]
    n_ext = 0
    ext_fields = dict(Aext=None, bext=None, Bx_ext=None, Bw_ext=None,
                      rho_ext=None, KiU=None, Cw=None)
    if extra is not None:
        A_v, b_e = extra[0], extra[1]
        B_x = extra[2] if len(extra) > 2 else None
        B_w = extra[3] if len(extra) > 3 else None
        A_v = np.atleast_2d(np.asarray(A_v, np.float64))
        r_ext = A_v.shape[0]
        if A_v.shape[1] != N * nv:
            raise ValueError(
                f"extra A_v must have N*nv={N * nv} columns (stacked "
                f"per-stage v — the stagewise frame has no aux "
                f"columns), got {A_v.shape[1]}")
        bext_np = np.broadcast_to(
            np.asarray(b_e, np.float64).reshape(-1), (r_ext,)).copy()
        Bx_np = (np.zeros((r_ext, nx)) if B_x is None
                 else np.asarray(B_x, np.float64).reshape(r_ext, nx))
        Bw_np = (np.zeros((r_ext, N * nw)) if B_w is None
                 else np.asarray(B_w, np.float64).reshape(r_ext, N * nw))
        Aext_np = np.zeros((r_ext, N, b))
        Aext_np[:, :, :nv] = A_v.reshape(r_ext, N, nv)
        rho_ext_np = np.full(r_ext, rho)           # one-sided ineq rows
        # KiU = K⁻¹ Aextᵀ via the fp64 LU sweeps (r simultaneous RHS)
        rhs = np.transpose(Aext_np, (1, 2, 0))     # (N, b, r)
        ys = np.zeros_like(rhs)
        prev = np.zeros((b, r_ext))
        for k in range(N):
            ys[k] = rhs[k] - (L[k] @ prev if k else 0.0)
            prev = ys[k]
        xs = np.zeros_like(rhs)
        nxt = np.zeros((b, r_ext))
        for k in range(N - 1, -1, -1):
            xs[k] = Uinv[k] @ ys[k] - (C[k] @ nxt if k < N - 1 else 0.0)
            nxt = xs[k]
        KiU_np = xs
        cap = (np.diag(1.0 / rho_ext_np)
               + np.einsum("rkb,kbs->rs", Aext_np, KiU_np))
        Cw_np = np.linalg.inv(cap)
        n_ext = r_ext
        _as = lambda a: jnp.asarray(a, dtype)
        ext_fields = dict(Aext=_as(Aext_np), bext=_as(bext_np),
                          Bx_ext=_as(Bx_np), Bw_ext=_as(Bw_np),
                          rho_ext=_as(rho_ext_np), KiU=_as(KiU_np),
                          Cw=_as(Cw_np))

    # variable boxes
    lb_xi = np.full((N, b), -BIG)
    ub_xi = np.full((N, b), BIG)
    lb_xi[:, :nv][:, vb_mask] = 0.0
    ub_xi[:, :nv][:, vb_mask] = 1.0

    as_ = lambda a: jnp.asarray(a, dtype)
    return StagewiseQP(
        Bv=as_(Bv), A_dyn=as_(m.A), E=as_(m.E), Fv=as_(Fv),
        P_diag=as_(P_diag), P_off=as_(P_off), q0=as_(q0),
        Rdu2=as_(Rdu2), M_vy=as_(M_vy), M_xy=as_(M_xy),
        Cy=as_(m.C), D4y=as_(m.D4),
        soft_lin=as_(soft_lin), soft_quad=as_(soft_quad),
        tie=as_(tie), Et=as_(Et), ft=as_(ft),
        L=as_(L), Uinv=as_(Uinv), C=as_(C),
        lb_xi=as_(lb_xi), ub_xi=as_(ub_xi),
        f5=as_(m.f5[:, 0]), b5=as_(m.b5[:, 0]), B4=as_(m.B4),
        F4=as_(m.F4), rho_rows=as_(rho_full),
        N=N, nx=nx, nv=nv, nc=nc, sigma=float(sigma), alpha=float(alpha),
        binary_idx_v=tuple(int(i) for i in np.nonzero(vb_mask)[0]),
        has_soft=bool(soft_lin.any() or soft_quad.any()),
        blk_cols=blk_cols, blk_groups=blk_groups, n_term=n_term,
        n_cons=n_cons, n_ext=n_ext, **ext_fields)


# ---------------------------------------------------------------------------
# structured operators (batched over leading dims; stage axis = -2)
# ---------------------------------------------------------------------------


def _apply_A(sw: StagewiseQP, xi):
    """A ξ: (…, N, b) → (…, N, m_k)."""
    v = xi[..., :, : sw.nv]
    xnext = xi[..., :, sw.nv:]                    # x_{k+1}
    xprev = jnp.concatenate(
        [jnp.zeros_like(xnext[..., :1, :]), xnext[..., :-1, :]], axis=-2)
    dyn = (xnext - jnp.einsum("ij,...kj->...ki", sw.Bv, v, precision="highest")
           - jnp.einsum("ij,...kj->...ki", sw.A_dyn, xprev, precision="highest"))
    ineq = (jnp.einsum("ij,...kj->...ki", sw.Fv, v, precision="highest")
            + jnp.einsum("ij,...kj->...ki", sw.E, xprev, precision="highest"))
    parts = [dyn, ineq, xi]
    if sw.n_blk:
        cols = jnp.asarray(sw.blk_cols)
        vb = v[..., :, cols]
        vbprev = jnp.concatenate(
            [jnp.zeros_like(vb[..., :1, :]), vb[..., :-1, :]], axis=-2)
        parts.append(vb - sw.tie * vbprev)        # u_k − tie_k·u_{k−1}
    if sw.n_term:
        parts.append(jnp.einsum("ij,...kj->...ki", sw.Et, xnext,
                                precision="highest"))
    if sw.n_cons:
        parts.append(v[..., :, :sw.n_cons])      # consensus selectors
    return jnp.concatenate(parts, axis=-1)


def _apply_AT(sw: StagewiseQP, w):
    """Aᵀ w: (…, N, m_k) → (…, N, b)."""
    nx, nc, nv, b = sw.nx, sw.nc, sw.nv, sw.b
    wd = w[..., :, :nx]
    wi = w[..., :, nx:nx + nc]
    wb = w[..., :, nx + nc:nx + nc + b]
    out_v = (-jnp.einsum("ij,...ki->...kj", sw.Bv, wd, precision="highest")
             + jnp.einsum("ij,...ki->...kj", sw.Fv, wi, precision="highest"))
    # x_{k+1} (ξ_k's x part) appears in dyn_k (+I), dyn_{k+1} (−A),
    # ineq_{k+1} (E)
    wd_next = jnp.concatenate(
        [wd[..., 1:, :], jnp.zeros_like(wd[..., :1, :])], axis=-2)
    wi_next = jnp.concatenate(
        [wi[..., 1:, :], jnp.zeros_like(wi[..., :1, :])], axis=-2)
    out_x = (wd - jnp.einsum("ij,...ki->...kj", sw.A_dyn, wd_next, precision="highest")
             + jnp.einsum("ij,...ki->...kj", sw.E, wi_next, precision="highest"))
    if sw.n_blk:
        # blk row k touches u_k (+1) and u_{k−1} (−tie_k)
        i0 = nx + nc + b
        wk = w[..., :, i0:i0 + sw.n_blk]
        wk_next = jnp.concatenate(
            [wk[..., 1:, :], jnp.zeros_like(wk[..., :1, :])], axis=-2)
        tie_next = jnp.concatenate(
            [sw.tie[1:], jnp.zeros_like(sw.tie[:1])], axis=0)
        cols = jnp.asarray(sw.blk_cols)
        out_v = out_v.at[..., :, cols].add(wk - tie_next * wk_next)
    if sw.n_term:
        i1 = nx + nc + b + sw.n_blk
        wt = w[..., :, i1:i1 + sw.n_term]
        out_x = out_x + jnp.einsum("ij,...ki->...kj", sw.Et, wt,
                                   precision="highest")
    if sw.n_cons:
        wc = w[..., :, nx + nc + b + sw.n_blk + sw.n_term:]
        out_v = out_v.at[..., :, :sw.n_cons].add(wc)
    return jnp.concatenate([out_v, out_x], axis=-1) + wb


def _apply_P(sw: StagewiseQP, x):
    """P x with block-tridiagonal P:
    (Px)_k = P_kk x_k + P_{k,k−1} x_{k−1} + P_{k+1,k}ᵀ x_{k+1}."""
    Px = jnp.einsum("kij,...kj->...ki", sw.P_diag, x,
                    precision="highest")
    xprev = jnp.concatenate(
        [jnp.zeros_like(x[..., :1, :]), x[..., :-1, :]], axis=-2)
    Px = Px + jnp.einsum("kij,...kj->...ki", sw.P_off, xprev,
                         precision="highest")
    xnext = jnp.concatenate(
        [x[..., 1:, :], jnp.zeros_like(x[..., :1, :])], axis=-2)
    P_off_next = jnp.concatenate(
        [jnp.transpose(sw.P_off[1:], (0, 2, 1)),
         jnp.zeros_like(sw.P_off[:1])], axis=0)
    return Px + jnp.einsum("kij,...kj->...ki", P_off_next, xnext,
                           precision="highest")


def _solve_K(sw: StagewiseQP, r, factors=None):
    """K⁻¹ r via the block LU sweeps. r: (…, N, b) → (…, N, b).
    ``factors``: optional (L, Uinv, C) triple to solve with a
    different block-tridiagonal factorization."""
    Lf, Uf, Cf = factors if factors is not None else (sw.L, sw.Uinv, sw.C)
    r_t = jnp.moveaxis(r, -2, 0)                  # (N, …, b)

    def fwd(carry, inp):
        rk, Lk = inp
        yk = rk - jnp.einsum("ij,...j->...i", Lk, carry,
                             precision="highest")
        return yk, yk

    y0 = jnp.zeros_like(r_t[0])
    _, ys = jax.lax.scan(fwd, y0, (r_t, Lf))

    def bwd(carry, inp):
        yk, Uk, Ck = inp
        xk = (jnp.einsum("ij,...j->...i", Uk, yk, precision="highest")
              - jnp.einsum("ij,...j->...i", Ck, carry,
                           precision="highest"))
        return xk, xk

    x0 = jnp.zeros_like(r_t[0])
    _, xs = jax.lax.scan(bwd, x0, (ys, Uf, Cf), reverse=True)
    return jnp.moveaxis(xs, 0, -2)


def _affine_prefix(M, v):
    """All prefixes of the affine recurrence y_k = M_k y_{k−1} + v_k
    (y_{−1}=0) in O(log N) depth via ``lax.associative_scan`` — affine
    maps compose associatively: (M_b, v_b)∘(M_a, v_a) =
    (M_b M_a, M_b v_a + v_b). M: (N, b, b); v: (N, …, b) with the batch
    axes BETWEEN the scan axis and the vector axis."""

    def comb(a, b):
        Ma, va = a
        Mb, vb = b
        return (jnp.einsum("cij,cjk->cik", Mb, Ma, precision="highest"),
                jnp.einsum("cij,c...j->c...i", Mb, va,
                           precision="highest") + vb)

    _, ys = jax.lax.associative_scan(comb, (M, v), axis=0)
    return ys


def _solve_K_assoc(sw: StagewiseQP, r, factors=None):
    """K⁻¹ r with log-depth sweeps — the horizon-parallel twin of
    ``_solve_K`` (SURVEY.md §5 long-context row: the substitution
    recurrences are the sequence axis; composing them as affine maps
    under an associative scan gives the ring/log-depth treatment, and
    XLA partitions the scan when the N axis is sharded over a mesh).
    Extra work vs the sequential sweeps is O(N b³) matrix composition —
    negligible at MPC block sizes; depth drops from O(N) to O(log N).
    Exact same factorization (L, U⁻¹, C) as ``_solve_K``."""
    Lf, Uf, Cf = factors if factors is not None else (sw.L, sw.Uinv, sw.C)
    r_t = jnp.moveaxis(r, -2, 0)                  # (N, …, b)
    ys = _affine_prefix(-Lf, r_t)                 # forward: y = r − L y⁻
    # backward x_k = U⁻¹_k y_k − C_k x_{k+1}: flip to a forward map
    vy = jnp.einsum("cij,c...j->c...i", Uf, ys, precision="highest")
    xs = _affine_prefix(-Cf[::-1], vy[::-1])[::-1]
    return jnp.moveaxis(xs, 0, -2)


def _solve_K_bordered(sw: StagewiseQP, t, parallel_sweeps: bool = False):
    """(K + Aextᵀ diag(ρₑ) Aext)⁻¹ t — the x-update solve when
    horizon-coupled extra rows are present. Woodbury on top of the
    block-tridiagonal sweeps: x = K⁻¹t − KiU·(Cw·(Aext·K⁻¹t)) with the
    prepared fp64 factors KiU = K⁻¹Aextᵀ and Cw = (ρₑ⁻¹ + Aext K⁻¹
    Aextᵀ)⁻¹ (``prepare_stagewise``). NOTE: assumes the PREPARED K —
    do not combine with a ``factors`` override."""
    base = (_solve_K_assoc if parallel_sweeps else _solve_K)(sw, t)
    if not sw.n_ext:
        return base
    s = jnp.einsum("rkb,...kb->...r", sw.Aext, base,
                   precision="highest")
    corr = jnp.einsum("rs,...s->...r", sw.Cw, s, precision="highest")
    return base - jnp.einsum("kbr,...r->...kb", sw.KiU, corr,
                             precision="highest")


def assemble_stagewise_ext(sw: StagewiseQP, x0, W=None):
    """Per-solve upper bounds for the horizon-coupled extra rows:
    u_ext = b + B_x·x0 + B_w·vec(W). Pass as ``ext_u`` to
    ``stagewise_admm_solve`` / ``stagewise_dual_bound`` /
    ``solve_miqp_bnb_stagewise``."""
    u_ext = sw.bext + jnp.matmul(sw.Bx_ext, x0, precision="highest")
    if W is None:
        # ADVICE r4: silently treating W=0 when the extra rows DO
        # depend on the disturbance would hand back wrong bounds —
        # refuse loudly (a genuinely disturbance-free B_w is all-zero
        # columns or zero-width, both fine to skip).
        if sw.Bw_ext.shape[1] > 0 and bool(np.any(np.asarray(sw.Bw_ext))):
            raise ValueError(
                "assemble_stagewise_ext: Bw_ext has nonzero entries "
                "(disturbance-dependent extra rows) but no omega "
                "forecast W was passed — supply W explicitly")
    elif sw.Bw_ext.shape[1] > 0:
        u_ext = u_ext + jnp.matmul(sw.Bw_ext, W.reshape(-1),
                                   precision="highest")
    return u_ext


def block_lu_device(K_diag, K_off):
    """Device-side block-tridiagonal LU (the factorization twin of the
    host ``block_lu`` in ``prepare_stagewise``): a ``lax.scan`` over
    stages carrying U_{k−1}. Use when K must be (re)factored inside a
    jitted program — per-node ρ schedules, on-device re-preparation at
    long N where a host round-trip per refactor would dominate. fp32 on
    the device (the host path stays fp64 for the ill-conditioned big-M case —
    see CLAUDE.md numerics rules); parity is tested against the host
    factors. Returns (L, Uinv, C) shaped like ``StagewiseQP.L/Uinv/C``."""
    N, b, _ = K_diag.shape
    off_T = jnp.swapaxes(K_off, -1, -2)           # K_{k−1,k} = K_{k,k−1}ᵀ
    eye = jnp.eye(b, dtype=K_diag.dtype)

    def step(U_prev, inp):
        Kd, Ko, KoT = inp
        Uinv_prev = jnp.linalg.solve(U_prev, eye)
        Lk = jnp.matmul(Ko, Uinv_prev, precision="highest")
        Uk = Kd - jnp.matmul(Lk, KoT, precision="highest")
        return Uk, (Lk, Uk)

    # seed with U_{−1} = I and K_{0,−1} = 0 so the k=0 step degenerates
    # to L_0 = 0, U_0 = K_00 without a special case.
    _, (L, U) = jax.lax.scan(step, eye, (K_diag, K_off, off_T))
    Uinv = jnp.linalg.solve(U, jnp.broadcast_to(eye, U.shape))
    C = jnp.concatenate([
        jnp.einsum("kij,kjl->kil", Uinv[:-1], off_T[1:],
                   precision="highest"),
        jnp.zeros_like(Uinv[:1])], axis=0)
    return L, Uinv, C


def stagewise_dual_bound(sw: StagewiseQP, q, l, u, res: AdmmResult,
                         ext_u=None):
    """Certified lower bound from the final iterate — the stagewise
    analogue of ops/admm.py ``admm_dual_bound`` (see there for the
    derivation, tightness argument, and why a P⁻¹-based dual function
    is numerically unsound on singular big-M Hessians).

    Dualizes the dynamics rows (free sign; l=u) and the hard stage-
    inequality rows (clamped ≥ 0), keeps the variable box explicit,
    and underestimates the inner box-QP by its tangent at the iterate.
    Soft rows are not constraints: their duals are zeroed and their
    (≥ 0) penalty dropped — both directions keep the bound valid.
    Box widths for the formally unbounded stage variables (z aux, x)
    come from a per-stage implied-bounds pass (``_implied_box_stage``).
    Returns the bound with the same leading batch as res.obj."""
    nx, nc = sw.nx, sw.nc
    nbox = nx + nc
    bb = nbox + sw.b
    xi = res.x
    y = res.y.at[..., :, nbox:bb].set(0.0)        # box rows not dualized
    # dynamics rows: equality (l=u) → free sign. ineq rows: one-sided
    # (l=−BIG) → clamp to the nonnegative feasible duals.
    y = y.at[..., :, nx:nbox].max(0.0)
    if sw.n_blk:
        # blocking rows: tied stages are equalities (free-sign dual,
        # rhs 0 → no S term); leader stages are vacuous (dual must be 0
        # or S would pick up a BIG bound)
        y = y.at[..., :, bb:bb + sw.n_blk].multiply(sw.tie)
    if sw.n_term:
        # terminal rows: one-sided; only the finite (last-stage) rows
        # may carry a dual
        i1 = bb + sw.n_blk
        ut = u[..., :, i1:i1 + sw.n_term]
        yt = jnp.where(ut < 0.9 * BIG,
                       jnp.maximum(y[..., :, i1:i1 + sw.n_term], 0.0),
                       0.0)
        y = y.at[..., :, i1:i1 + sw.n_term].set(yt)
    if sw.n_cons:
        # consensus rows are not dualized here: zeroing their duals
        # DROPS the non-anticipativity coupling, i.e. bounds the
        # decoupled per-scenario relaxation — still a valid lower
        # bound of the tree problem (ops/stagewise_tree.py weights the
        # per-scenario bounds by p_s).
        y = y.at[..., :, bb + sw.n_blk + sw.n_term:].set(0.0)
    if sw.has_soft:
        soft = (sw.soft_lin > 0) | (sw.soft_quad > 0)
        y = jnp.where(soft, 0.0, y)
    w = q + _apply_AT(sw, y)
    S_ext = 0.0
    if sw.n_ext:
        # horizon-coupled extra rows: one-sided A_e x ≤ u_e → clamp the
        # dual ≥ 0 (and zero it on vacuous BIG rows so S stays finite);
        # fold Aextᵀy_e into the tangent's linear term and u_e·y_e
        # into S — the same Falk dualization as the stage rows
        if ext_u is None:
            raise ValueError("sw has n_ext extra rows: pass ext_u")
        ye = jnp.maximum(res.y_ext, 0.0)
        ye = jnp.where(ext_u < 0.9 * BIG, ye, 0.0)
        w = w + jnp.einsum("rkb,...r->...kb", sw.Aext, ye,
                           precision="highest")
        S_ext = jnp.sum(ext_u * ye, axis=-1)
    grad = _apply_P(sw, xi) + w
    lbe, ube = _implied_box_stage(sw, l, u)
    tangent = jnp.sum(jnp.minimum(grad * (lbe - xi), grad * (ube - xi)),
                      axis=(-2, -1))
    f0 = (0.5 * jnp.sum(xi * _apply_P(sw, xi), axis=(-2, -1))
          + jnp.sum(w * xi, axis=(-2, -1)))
    # S over the dualized rows: dyn l=u → u·y; ineq y≥0 → u·[y]₊ = u·y;
    # blk tied rows u=0 and term finite rows u=f_t (masked y zeroes the
    # BIG-bound rows, so summing u·y over [bb:] is exact)
    S = (jnp.sum(u[..., :, :nbox] * y[..., :, :nbox], axis=(-2, -1))
         + jnp.sum(u[..., :, bb:] * y[..., :, bb:], axis=(-2, -1))
         + S_ext)
    return f0 + tangent - S


def _implied_box_stage(sw: StagewiseQP, l, u, passes: int = 2):
    """Implied variable boxes for the tangent bound, from the per-stage
    rows. Stage-k hard rows over ζ_k = (x_k, v_k, x_{k+1}):

        ineq_k:  E x_k + Fv v_k ≤ u_ineq_k        (soft rows masked out)
        dyn_k:  ±(x_{k+1} − A x_k − Bv v_k) ≤ ±rhs_dyn_k   (equality)

    x_k is ξ_{k−1}'s x block (box [0,0] at k=0 — the data x_0's terms
    are already folded into l/u by the assembler, so its columns are
    vacuous). All stages tighten in parallel (shared matrix, vmapped
    interval pass); ``passes`` outer rounds propagate information
    across neighbouring stages through the shared x blocks."""
    from pyhybridcontrol_tpu.ops.admm import _implied_box

    nx, nc, nv, N = sw.nx, sw.nc, sw.nv, sw.N
    nbox = nx + nc
    Z = jnp.zeros((nc, nx), l.dtype)
    I = jnp.eye(nx, dtype=l.dtype)
    M = jnp.concatenate([
        jnp.concatenate([sw.E, sw.Fv, Z], axis=1),
        jnp.concatenate([-sw.A_dyn, -sw.Bv, I], axis=1),
        jnp.concatenate([sw.A_dyn, sw.Bv, -I], axis=1),
    ], axis=0)                                    # (nc+2nx, nx+nv+nx)
    u_ineq = u[..., :, nx:nbox]
    if sw.has_soft:
        soft_i = ((sw.soft_lin > 0)
                  | (sw.soft_quad > 0))[..., :, nx:nbox]
        u_ineq = jnp.where(soft_i, BIG, u_ineq)
    rhs_dyn = u[..., :, :nx]
    rhs = jnp.concatenate([u_ineq, rhs_dyn, -rhs_dyn], axis=-1)
    # box rows only — blocking/terminal rows sit past nbox+b and do not
    # join this pass (skipping rows is always conservative/valid)
    lb_box = l[..., :, nbox:nbox + sw.b]          # (…, N, b) [v_k; x_{k+1}]
    ub_box = u[..., :, nbox:nbox + sw.b]
    for _ in range(passes):
        lx = lb_box[..., :, nv:]                  # x_{k+1} boxes
        ux = ub_box[..., :, nv:]
        zero = jnp.zeros_like(lx[..., :1, :])
        lxp = jnp.concatenate([zero, lx[..., :-1, :]], axis=-2)  # x_k
        uxp = jnp.concatenate([zero, ux[..., :-1, :]], axis=-2)
        lz = jnp.concatenate([lxp, lb_box], axis=-1)  # (…, N, nx+b)
        uz = jnp.concatenate([uxp, ub_box], axis=-1)
        lz, uz = _implied_box(M, rhs, lz, uz, passes=1)
        # v_k and x_{k+1} from stage k; x_{k+1} also from stage k+1's
        # leading x_k columns (shift back) — intersect.
        lb_box = lz[..., :, nx:]
        ub_box = uz[..., :, nx:]
        lx_from_next = jnp.concatenate(
            [lz[..., 1:, :nx],
             jnp.full_like(lz[..., :1, :nx], -BIG)], axis=-2)
        ux_from_next = jnp.concatenate(
            [uz[..., 1:, :nx],
             jnp.full_like(uz[..., :1, :nx], BIG)], axis=-2)
        lb_box = lb_box.at[..., :, nv:].max(lx_from_next)
        ub_box = ub_box.at[..., :, nv:].min(ux_from_next)
    return lb_box, ub_box


def assemble_stagewise(sw: StagewiseQP, x0, W=None, price_seq=None,
                       u_prev=None):
    """Per-solve data: q (N,b), l/u (N,m_k) from (x0, forecasts, prices,
    previous input). price_seq: (N, nv) per-step linear weight on v.
    u_prev: (nu,) previous applied input — the Δu_0 = u_0 − u_prev
    linear term (needed only when Rdu weights are set)."""
    N, nx, nc, nv, b = sw.N, sw.nx, sw.nc, sw.nv, sw.b
    q = sw.q0
    if price_seq is not None:
        q = q.at[..., :, :nv].add(price_seq)
    if u_prev is not None and sw.Rdu2.shape[0] > 0:
        nu = sw.Rdu2.shape[0]
        q = q.at[..., 0, :nu].add(
            -jnp.matmul(u_prev, sw.Rdu2.T, precision="highest"))
    # y-output cost data terms: y_k's data part is D4 ω_k (+ C x_0 at
    # k=0, where x_0 is measurement not decision)
    ydat0 = jnp.matmul(x0, sw.Cy.T, precision="highest")   # (ny,)
    if W is not None and sw.D4y.shape[1] > 0:
        yw = jnp.matmul(W, sw.D4y.T, precision="highest")   # (N, ny)
        ydat0 = ydat0 + yw[0]
        q = q.at[..., 1:, :nv].add(
            jnp.einsum("vy,ky->kv", sw.M_vy, yw[1:],
                       precision="highest"))
        q = q.at[..., :-1, nv:].add(
            jnp.einsum("xy,ky->kx", sw.M_xy, yw[1:],
                       precision="highest"))
    q = q.at[..., 0, :nv].add(
        jnp.matmul(ydat0, sw.M_vy.T, precision="highest"))
    dyn_rhs = jnp.broadcast_to(sw.b5, (N, nx))
    ineq_ub = jnp.broadcast_to(sw.f5, (N, nc))
    if W is not None and sw.B4.shape[1] > 0:
        dyn_rhs = dyn_rhs + jnp.matmul(W, sw.B4.T, precision="highest")
        ineq_ub = ineq_ub - jnp.matmul(W, sw.F4.T, precision="highest")
    # k=0: x_0 is data → move its A/E terms to the bounds
    dyn_rhs = dyn_rhs.at[0].add(
        jnp.matmul(x0, sw.A_dyn.T, precision="highest"))
    ineq_ub = ineq_ub.at[0].add(
        -jnp.matmul(x0, sw.E.T, precision="highest"))
    l_parts = [dyn_rhs, jnp.full_like(ineq_ub, -BIG), sw.lb_xi]
    u_parts = [dyn_rhs, ineq_ub, sw.ub_xi]
    if sw.n_blk:
        # tied stages: equality u_k − u_{k−1} = 0; leaders: vacuous
        zero = jnp.zeros((N, sw.n_blk), q.dtype)
        l_parts.append(jnp.where(sw.tie > 0, zero, -BIG))
        u_parts.append(jnp.where(sw.tie > 0, zero, BIG))
    if sw.n_term:
        l_parts.append(jnp.full((N, sw.n_term), -BIG, q.dtype))
        u_term = jnp.full((N, sw.n_term), BIG, q.dtype)
        u_parts.append(u_term.at[N - 1].set(sw.ft))
    if sw.n_cons:
        # consensus rows never clip in the box sense — the tree
        # solver's z-update replaces them with the group mean
        l_parts.append(jnp.full((N, sw.n_cons), -BIG, q.dtype))
        u_parts.append(jnp.full((N, sw.n_cons), BIG, q.dtype))
    l = jnp.concatenate(l_parts, axis=-1)
    u = jnp.concatenate(u_parts, axis=-1)
    return q, l, u


def stagewise_admm_solve(sw: StagewiseQP, q, l, u, iters: int = 200,
                         lb_xi=None, ub_xi=None, warm=None,
                         parallel_sweeps: bool = False,
                         consensus_z=None, ext_u=None,
                         warm_ext=None) -> AdmmResult:
    """Fixed-iteration ADMM in the stagewise frame. q (…,N,b), l/u
    (…,N,m_k) from ``assemble_stagewise``; optional per-node variable
    boxes lb_xi/ub_xi (…,N,b) override the box-row bounds (B&B);
    ``warm``: (x, z, y) of a prior AdmmResult in this frame.
    ``parallel_sweeps``: solve Kξ=t with the log-depth associative-scan
    sweeps (``_solve_K_assoc``) instead of the sequential scans — pick
    this for very long horizons or when the N axis is sharded over a
    device mesh (horizon/sequence parallelism; SURVEY.md §5).
    ``consensus_z``: optional callable replacing the z-update on the
    trailing ``sw.n_cons`` consensus rows (the scenario group-mean prox
    — ops/stagewise_tree.py); their residual then measures the
    split-variable gap |Ax − z| (the non-anticipativity residual) and
    their dy is masked out of the infeasibility certificate.
    ``ext_u``: (…, r) upper bounds for the horizon-coupled extra rows
    (``assemble_stagewise_ext``) — REQUIRED when ``sw.n_ext > 0``; the
    extras get their own z/y segment (returned in ``res.z_ext`` /
    ``res.y_ext``) and the x-update runs the bordered Woodbury solve.
    ``warm_ext``: optional (z_ext, y_ext) of a prior result."""
    if lb_xi is not None:
        nbox = sw.nx + sw.nc
        l = l.at[..., :, nbox:nbox + sw.b].set(lb_xi)
        u = u.at[..., :, nbox:nbox + sw.b].set(ub_xi)
    rho = sw.rho_rows
    alpha, sigma = sw.alpha, sw.sigma
    soft = (sw.soft_lin > 0) | (sw.soft_quad > 0)     # (N, m_k)
    any_soft = sw.has_soft                            # static → traceable
    batch = q.shape[:-2]
    if warm is None:
        x = jnp.zeros(batch + (sw.N, sw.b), q.dtype)
        z = jnp.clip(jnp.zeros(batch + (sw.N, sw.m_k), q.dtype), l, u)
        y = jnp.zeros_like(z)
    else:
        x, z, y = warm
        z = jnp.clip(z, l, u)

    r_ext = sw.n_ext
    if r_ext:
        if ext_u is None:
            raise ValueError("sw has n_ext extra rows: pass ext_u from "
                             "assemble_stagewise_ext")
        rho_e = sw.rho_ext
        if warm_ext is None:
            z_e = jnp.minimum(jnp.zeros(batch + (r_ext,), q.dtype),
                              ext_u)
            y_e = jnp.zeros_like(z_e)
        else:
            z_e, y_e = warm_ext
            z_e = jnp.minimum(z_e, ext_u)
    else:
        z_e = jnp.zeros(batch + (0,), q.dtype)
        y_e = z_e

    mc = sw.m_k - sw.n_cons                           # consensus rows

    def z_update(s):
        """Box projection on hard rows; exact penalty prox on soft rows
        (upper-side: min lin·t + quad·t² + ρ/2(z−s)², t = (z−u)₊);
        group-mean consensus prox on the trailing n_cons rows."""
        z_hard = jnp.clip(s, l, u)
        if any_soft:
            t = (rho * (s - u) - sw.soft_lin) / (rho + 2.0 * sw.soft_quad)
            z_soft = jnp.where(s > u, u + jnp.maximum(t, 0.0),
                               jnp.maximum(s, l))
            z_hard = jnp.where(soft, z_soft, z_hard)
        if consensus_z is not None and sw.n_cons:
            z_hard = z_hard.at[..., :, mc:].set(
                consensus_z(s[..., :, mc:]))
        return z_hard

    def body(_, carry):
        x, z, y, _, z_e, y_e, _ = carry
        w = rho * z - y
        t = sigma * x - q + _apply_AT(sw, w)
        if r_ext:
            w_e = rho_e * z_e - y_e
            t = t + jnp.einsum("rkb,...r->...kb", sw.Aext, w_e,
                               precision="highest")
        xt = _solve_K_bordered(sw, t, parallel_sweeps)
        zt = _apply_A(sw, xt)
        zr = alpha * zt + (1.0 - alpha) * z
        z_new = z_update(zr + y / rho)
        y_new = y + rho * (zr - z_new)
        if r_ext:
            zt_e = jnp.einsum("rkb,...kb->...r", sw.Aext, xt,
                              precision="highest")
            zr_e = alpha * zt_e + (1.0 - alpha) * z_e
            z_e_new = jnp.minimum(zr_e + y_e / rho_e, ext_u)
            y_e_new = y_e + rho_e * (zr_e - z_e_new)
        else:
            z_e_new, y_e_new = z_e, y_e
        return (xt, z_new, y_new, y_new - y,
                z_e_new, y_e_new, y_e_new - y_e)

    x, z, y, dy, z_e, y_e, dy_e = jax.lax.fori_loop(
        0, iters, body,
        (x, z, y, jnp.zeros_like(y), z_e, y_e, jnp.zeros_like(y_e)))

    Ax = _apply_A(sw, x)
    # hard rows: distance to the box; soft rows: split-variable gap
    # |Ax − z| (violation beyond the bound is *allowed*, paid in obj)
    viol = jnp.abs(Ax - jnp.clip(Ax, l, u))
    if any_soft:
        viol = jnp.where(soft, jnp.abs(Ax - z), viol)
    if consensus_z is not None and sw.n_cons:
        # consensus rows: non-anticipativity residual (z = group mean)
        viol = viol.at[..., :, mc:].set(jnp.abs(Ax - z)[..., :, mc:])
    r_prim = jnp.max(viol, axis=(-2, -1))
    r_rel = jnp.max(viol / jnp.maximum(1.0, jnp.abs(Ax)), axis=(-2, -1))
    Px = _apply_P(sw, x)
    dual = Px + q + _apply_AT(sw, y)
    if r_ext:
        Ax_e = jnp.einsum("rkb,...kb->...r", sw.Aext, x,
                          precision="highest")
        viol_e = jnp.maximum(Ax_e - ext_u, 0.0)    # one-sided upper
        r_prim = jnp.maximum(r_prim, jnp.max(viol_e, axis=-1))
        r_rel = jnp.maximum(
            r_rel, jnp.max(viol_e / jnp.maximum(1.0, jnp.abs(Ax_e)),
                           axis=-1))
        dual = dual + jnp.einsum("rkb,...r->...kb", sw.Aext, y_e,
                                 precision="highest")
    r_dual = jnp.max(jnp.abs(dual), axis=(-2, -1))
    obj = (0.5 * jnp.sum(x * Px, axis=(-2, -1))
           + jnp.sum(q * x, axis=(-2, -1)))
    if any_soft:
        sviol = jnp.where(soft, jnp.maximum(Ax - u, 0.0), 0.0)
        obj = obj + jnp.sum(sw.soft_lin * sviol
                            + sw.soft_quad * sviol * sviol,
                            axis=(-2, -1))
    # primal-infeasibility certificate (see ops/admm.py). Soft rows can
    # never witness infeasibility (their violation is purchasable), so
    # their dual-change contribution is masked out of the certificate;
    # consensus rows likewise (cross-scenario consensus infeasibility
    # is not certified — same policy as ops/consensus_tree.py).
    if any_soft:
        dy = jnp.where(soft, 0.0, dy)
    if sw.n_cons:
        dy = dy.at[..., :, mc:].set(0.0)
    dy_norm = jnp.max(jnp.abs(dy), axis=(-2, -1))
    Atdy_full = _apply_AT(sw, dy)
    if r_ext:
        Atdy_full = Atdy_full + jnp.einsum(
            "rkb,...r->...kb", sw.Aext, dy_e, precision="highest")
    Atdy = jnp.max(jnp.abs(Atdy_full), axis=(-2, -1))
    fin_u = u < 0.9 * BIG
    fin_l = l > -0.9 * BIG
    dyp = jnp.maximum(dy, 0.0)
    dyn_ = jnp.minimum(dy, 0.0)
    support = (jnp.sum(jnp.where(~fin_u, dyp, 0.0), axis=(-2, -1))
               + jnp.sum(jnp.where(~fin_l, -dyn_, 0.0), axis=(-2, -1)))
    gap_term = (jnp.sum(jnp.where(fin_u, u * dyp, 0.0), axis=(-2, -1))
                + jnp.sum(jnp.where(fin_l, l * dyn_, 0.0), axis=(-2, -1)))
    if r_ext:
        # extra rows are one-sided −∞ < A_e x ≤ u_e: a negative dy_e
        # witnesses the unbounded lower side and must vanish; positive
        # dy_e contributes u_e (finite) to the gap term
        dy_norm = jnp.maximum(dy_norm, jnp.max(jnp.abs(dy_e), axis=-1))
        dyp_e = jnp.maximum(dy_e, 0.0)
        fin_ue = ext_u < 0.9 * BIG
        support = (support
                   + jnp.sum(-jnp.minimum(dy_e, 0.0), axis=-1)
                   + jnp.sum(jnp.where(~fin_ue, dyp_e, 0.0), axis=-1))
        gap_term = gap_term + jnp.sum(
            jnp.where(fin_ue, ext_u * dyp_e, 0.0), axis=-1)
    eps_c = 1e-4
    cert = ((dy_norm > 1e-12) & (Atdy <= eps_c * dy_norm)
            & (support <= eps_c * dy_norm)
            & (gap_term <= -eps_c * dy_norm))
    return AdmmResult(x=x, obj=obj, r_prim=r_prim,
                      r_prim_rel=r_rel, r_dual=r_dual,
                      infeas_cert=cert, y=y, z=z,
                      z_ext=(z_e if r_ext else None),
                      y_ext=(y_e if r_ext else None))
