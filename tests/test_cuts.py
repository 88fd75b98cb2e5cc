"""Lift-and-project split cuts (ops/cuts.py): machine-checked validity
and MIQP-invariance (SURVEY.md §4.6-style invariants for the cut
generator; VERDICT r4 item 3)."""

import jax  # noqa: F401  (conftest forces the CPU mesh)
import numpy as np

from pyhybridcontrol_tpu.models.pwa_examples import (
    pwa_spring_mld, pwa_weights)
from pyhybridcontrol_tpu.ops.condense import CondensedMpc
from pyhybridcontrol_tpu.ops.cuts import _lifted_rows, with_split_cuts

X0_LO = np.array([0.5, -1.0])
X0_HI = np.array([2.5, 1.0])
X0N = np.array([1.5, 0.0])


def _gen(N, **kw):
    cpw = CondensedMpc(pwa_spring_mld(on_off=True, formulation="hull"),
                       N, pwa_weights())
    cut, diag = with_split_cuts(cpw, X0_LO, X0_HI, X0N,
                                return_diagnostics=True, **kw)
    return cpw, cut, diag


def test_split_cuts_valid_exhaustive():
    """EVERY binary assignment of an enumerable instance: the maximum
    cut violation over the assignment's feasible (V, x0) set — an LP
    per (assignment, cut) over the lifted polytope — must be ≤ the
    feasibility tolerance. This is the machine check of the CGLP's
    validity argument (disjunction over each split, weak LP duality on
    each branch)."""
    from scipy.optimize import linprog

    cpw, cut, diag = _gen(2, n_per_round=3, rounds=2, n_tilts=1)
    assert diag.n_cuts >= 1, "generator produced no cuts to check"
    nV = cpw.H.shape[0]
    bidx = np.asarray(cpw.binary_idx)
    nb = len(bidx)
    C, d = _lifted_rows(np.asarray(cpw.G, float),
                        np.asarray(cpw.h0, float),
                        np.asarray(cpw.Hx, float),
                        cpw.lb, cpw.ub, X0_LO, X0_HI)
    mbase = cpw.G.shape[0]
    cutsA = cut.G[mbase:]
    cutsHx = cut.Hx[mbase:]
    cutsb = cut.h0[mbase:]
    Aeq = np.zeros((nb, C.shape[1]))
    Aeq[np.arange(nb), bidx] = 1.0
    worst = -np.inf
    feas_assignments = 0
    for code in range(2 ** nb):
        b = np.array([(code >> i) & 1 for i in range(nb)], float)
        any_feas = False
        for aV, ax, bb in zip(cutsA, cutsHx, cutsb):
            cobj = np.zeros(C.shape[1])
            cobj[:nV] = -aV           # max aV·V − ax_cut·x0 (Hx = −a_x)
            cobj[nV:] = ax
            r = linprog(cobj, A_ub=C, b_ub=d, A_eq=Aeq, b_eq=b,
                        bounds=[(None, None)] * C.shape[1],
                        method="highs")
            if r.status == 2:
                break                 # infeasible assignment
            assert r.success, f"violation LP failed: {r.message}"
            any_feas = True
            worst = max(worst, -r.fun - bb)
        feas_assignments += any_feas
    assert feas_assignments > 0
    assert worst <= 1e-7, f"cut violated by an integral point: {worst}"


def test_split_cuts_preserve_miqp_optimum():
    """The MIQP optimum is unchanged by the cuts at multiple x0 inside
    the trust box (fp64 enumeration oracle on both problems)."""
    from pyhybridcontrol_tpu.solver.oracle import (
        solve_miqp_enumeration_oracle)

    cpw, cut, diag = _gen(2, n_per_round=3, rounds=2, n_tilts=1)
    assert diag.n_cuts >= 1
    for x0 in (X0N, np.array([0.8, 0.6])):
        fo, ho = cpw.assemble_np(x0)
        orc0 = solve_miqp_enumeration_oracle(
            cpw.H, fo, cpw.G, ho, cpw.lb, cpw.ub, cpw.binary_idx)
        f1, h1 = cut.assemble_np(x0)
        orc1 = solve_miqp_enumeration_oracle(
            cut.H, f1, cut.G, h1, cut.lb, cut.ub, cut.binary_idx)
        assert orc0.status == orc1.status == "optimal"
        assert abs(orc0.obj - orc1.obj) <= 1e-6 * max(1.0, abs(orc0.obj))


def test_split_cuts_raise_root_bound_small():
    """On the tight trust box the N=3 root relaxation bound strictly
    increases (measured +0.27 absolute; the N=20 bench instance's
    5.5% gap does NOT close this way — documented negative result,
    PERF.md)."""
    _, _, diag = _gen(3, n_per_round=3, rounds=2, n_tilts=1)
    assert diag.root_bound_after > diag.root_bound_before + 0.05


def test_split_cuts_refuse_disturbance_channel():
    import pytest

    from pyhybridcontrol_tpu.mld.info import MldInfo
    from pyhybridcontrol_tpu.mld.model import MldModel
    from pyhybridcontrol_tpu.models.double_integrator import (
        default_weights, switched_double_integrator)

    base = switched_double_integrator()
    m = base.numpy_mats()
    omega_di = MldModel.from_matrices(
        MldInfo(nx=2, nu=1, ndelta=1, nz=1, nomega=1, ny=2,
                ncons=base.info.ncons),
        A=m.A, B1=m.B1, B3=m.B3, B4=np.array([[0.0], [1.0]]),
        C=m.C, E=m.E, F1=m.F1, F2=m.F2, F3=m.F3, f5=m.f5)
    c = CondensedMpc(omega_di, 4, default_weights())
    with pytest.raises(ValueError, match="disturbance"):
        with_split_cuts(c, [-1, -1], [1, 1], [0, 0])
