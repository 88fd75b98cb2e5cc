"""QP kernel + MIQP solver tests (SURVEY.md §4.2/§4.3/§4.6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyhybridcontrol_tpu.models.double_integrator import (
    switched_double_integrator, default_weights)
from pyhybridcontrol_tpu.ops.admm import (
    admm_solve, prepare_admm, prepare_admm_mpc)
from pyhybridcontrol_tpu.ops.condense import CondensedMpc
from pyhybridcontrol_tpu.solver.bnb import BnbSpec, solve_miqp_bnb
from pyhybridcontrol_tpu.solver.enumerate import solve_miqp_enumerate_device
from pyhybridcontrol_tpu.solver.oracle import (
    solve_miqp_enumeration_oracle, solve_qp_oracle)


def _random_qp(rng, n=16, m=24, cond=10.0):
    U = np.linalg.qr(rng.normal(size=(n, n)))[0]
    eigs = np.logspace(0, np.log10(cond), n)
    H = U @ np.diag(eigs) @ U.T
    f = rng.normal(size=n)
    G = rng.normal(size=(m, n))
    h = rng.uniform(0.5, 2.0, size=m)   # origin strictly feasible
    lb = np.full(n, -3.0)
    ub = np.full(n, 3.0)
    return H, f, G, h, lb, ub


@pytest.mark.parametrize("cond", [3.0, 30.0, 300.0])
def test_admm_matches_oracle_random_qps(rng, cond):
    """SURVEY.md §4.2: ADMM vs fp64 oracle, condition-number sweep."""
    H, f, G, h, lb, ub = _random_qp(rng, cond=cond)
    oracle = solve_qp_oracle(H, f, G, h, lb, ub)
    assert oracle.status == "optimal"
    spec = prepare_admm(G, H, rho=0.1)
    res = admm_solve(spec, jnp.asarray(f, jnp.float32),
                     jnp.asarray(h, jnp.float32), jnp.asarray(lb, jnp.float32),
                     jnp.asarray(ub, jnp.float32), iters=800)
    assert float(res.r_prim) < 1e-3
    np.testing.assert_allclose(float(res.obj), oracle.obj,
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(res.x), oracle.x,
                               rtol=0.05, atol=5e-3)


def test_admm_batch_determinism(rng):
    """Batch-of-K solve is bitwise identical run-to-run (§4.2)."""
    H, f, G, h, lb, ub = _random_qp(rng)
    spec = prepare_admm(G, H)
    K = 32
    fs = jnp.asarray(rng.normal(size=(K, 16)), jnp.float32)
    hb = jnp.broadcast_to(jnp.asarray(h, jnp.float32), (K, 24))
    lbb = jnp.broadcast_to(jnp.asarray(lb, jnp.float32), (K, 16))
    ubb = jnp.broadcast_to(jnp.asarray(ub, jnp.float32), (K, 16))
    solve = jax.jit(lambda q: admm_solve(spec, q, hb, lbb, ubb, iters=100))
    r1 = solve(fs)
    r2 = solve(fs)
    assert np.array_equal(np.asarray(r1.x), np.asarray(r2.x))


def test_admm_batch_matches_single(rng):
    H, f, G, h, lb, ub = _random_qp(rng)
    spec = prepare_admm(G, H)
    K = 8
    fs = jnp.asarray(rng.normal(size=(K, 16)), jnp.float32)
    hb = jnp.broadcast_to(jnp.asarray(h, jnp.float32), (K, 24))
    lbb = jnp.broadcast_to(jnp.asarray(lb, jnp.float32), (K, 16))
    ubb = jnp.broadcast_to(jnp.asarray(ub, jnp.float32), (K, 16))
    batch = admm_solve(spec, fs, hb, lbb, ubb, iters=50)
    single = admm_solve(spec, fs[3], hb[3], lbb[3], ubb[3], iters=50)
    np.testing.assert_allclose(np.asarray(batch.x[3]), np.asarray(single.x),
                               rtol=1e-5, atol=1e-6)


def test_admm_infeasible_detection(rng):
    """Contradictory rows ⇒ primal residual stays large."""
    n = 8
    H = np.eye(n)
    f = np.zeros(n)
    G = np.vstack([np.eye(n)[:1], -np.eye(n)[:1]])
    h = np.array([1.0, -2.0])   # x0 ≤ 1 and x0 ≥ 2
    spec = prepare_admm(G, H)
    res = admm_solve(spec, jnp.zeros(n), jnp.asarray(h, jnp.float32),
                     jnp.full(n, -10.0), jnp.full(n, 10.0), iters=600)
    assert float(res.r_prim) > 1e-2


# ---- MIQP: enumeration vs oracle vs B&B (§4.3) -------------------------

@pytest.fixture(scope="module")
def miqp():
    model = switched_double_integrator()
    N = 6
    c = CondensedMpc(model, N, default_weights())
    qp = c.device_qp()
    spec = prepare_admm_mpc(c)
    return model, N, c, qp, spec


X0S = [np.array([2.0, 0.0]), np.array([-1.5, 1.0]), np.array([0.3, -0.7]),
       np.array([4.0, 2.0])]


@pytest.mark.parametrize("x0", X0S, ids=[str(x) for x in X0S])
def test_enumeration_parity_vs_oracle(miqp, x0):
    model, N, c, qp, spec = miqp
    f, h = qp.assemble(jnp.asarray(x0, jnp.float32))
    x, obj, bits, feas = solve_miqp_enumerate_device(spec, qp, f, h, iters=600)
    fo, ho = c.assemble_np(x0)
    oracle = solve_miqp_enumeration_oracle(c.H, fo, c.G, ho, c.lb, c.ub,
                                           c.binary_idx)
    assert oracle.status == "optimal"
    # compare cost within tolerance (ties in binary patterns allowed, §7)
    assert abs(float(obj) - oracle.obj) <= 1e-3 * max(1.0, abs(oracle.obj))


@pytest.mark.parametrize("x0", X0S, ids=[str(x) for x in X0S])
def test_bnb_matches_enumeration(miqp, x0):
    model, N, c, qp, spec = miqp
    f, h = qp.assemble(jnp.asarray(x0, jnp.float32))
    _, obj_enum, _, _ = solve_miqp_enumerate_device(spec, qp, f, h, iters=600)
    res = solve_miqp_bnb(spec, qp, f, h,
                         BnbSpec(capacity=256, wave_size=16, max_waves=64,
                                 qp_iters=600))
    assert bool(res.found)
    assert not bool(res.overflow)
    assert abs(float(res.obj) - float(obj_enum)) <= 1e-3 * max(
        1.0, abs(float(obj_enum)))


def test_bnb_solution_is_feasible(miqp):
    model, N, c, qp, spec = miqp
    x0 = np.array([2.0, 0.0])
    f, h = qp.assemble(jnp.asarray(x0, jnp.float32))
    res = solve_miqp_bnb(spec, qp, f, h,
                         BnbSpec(capacity=256, wave_size=16, qp_iters=600))
    x = np.asarray(res.x, np.float64)
    fo, ho = c.assemble_np(x0)
    assert (c.G @ x - ho).max() < 1e-2          # constraint feasibility
    b = x[c.binary_idx]
    assert np.abs(b - np.round(b)).max() < 1e-2  # integrality


def test_bnb_explores_fewer_nodes_than_enumeration(miqp):
    model, N, c, qp, spec = miqp
    x0 = np.array([2.0, 0.0])
    f, h = qp.assemble(jnp.asarray(x0, jnp.float32))
    res = solve_miqp_bnb(spec, qp, f, h,
                         BnbSpec(capacity=256, wave_size=16, qp_iters=600))
    assert int(res.nodes_solved) < 2 ** len(c.binary_idx)


def test_bnb_infeasible_problem(miqp):
    model, N, c, qp, spec = miqp
    x0 = np.array([50.0, 0.0])    # outside state box
    f, h = qp.assemble(jnp.asarray(x0, jnp.float32))
    res = solve_miqp_bnb(spec, qp, f, h,
                         BnbSpec(capacity=128, wave_size=8, qp_iters=800))
    assert not bool(res.found)


def test_admm_mixed_precision_schedule(rng):
    """Mixed-precision schedule matches the full-precision solve (on
    CPU both phases are exact fp32 — this pins the warm-chaining)."""
    from pyhybridcontrol_tpu.ops.admm import admm_solve_mixed

    H, f, G, h, lb, ub = _random_qp(rng)
    spec = prepare_admm(G, H)
    fj = jnp.asarray(f, jnp.float32)
    hj = jnp.asarray(h, jnp.float32)
    lbj = jnp.asarray(lb, jnp.float32)
    ubj = jnp.asarray(ub, jnp.float32)
    full = admm_solve(spec, fj, hj, lbj, ubj, iters=200)
    mixed = admm_solve_mixed(spec, fj, hj, lbj, ubj, iters=200)
    np.testing.assert_allclose(float(mixed.obj), float(full.obj),
                               rtol=1e-3, atol=1e-3)
    assert float(mixed.r_prim_rel) < 5e-3


def test_infeasibility_certificate(rng):
    """The dual certificate fires on truly infeasible problems and stays
    quiet on slow-but-feasible ones (the PWA failure mode)."""
    n = 8
    H = np.eye(n)
    f = np.zeros(n)
    G = np.vstack([np.eye(n)[:1], -np.eye(n)[:1]])
    h = np.array([1.0, -2.0])        # x0 ≤ 1 ∧ x0 ≥ 2: infeasible
    spec = prepare_admm(G, H)
    res = admm_solve(spec, jnp.zeros(n), jnp.asarray(h, jnp.float32),
                     jnp.full(n, -10.0), jnp.full(n, 10.0), iters=500)
    assert bool(res.infeas_cert), "certificate missed a true infeasibility"

    # feasible problem: certificate must NOT fire even at few iterations
    Hf, ff, Gf, hf, lbf, ubf = _random_qp(rng)
    spec2 = prepare_admm(Gf, Hf)
    res2 = admm_solve(spec2, jnp.asarray(ff, jnp.float32),
                      jnp.asarray(hf, jnp.float32),
                      jnp.asarray(lbf, jnp.float32),
                      jnp.asarray(ubf, jnp.float32), iters=30)
    assert not bool(res2.infeas_cert)


def test_infeasibility_certificate_batched(rng):
    """In a batch, the certificate fires on the one contradictory
    instance (x0 ≤ 1 ∧ x0 ≥ 2) and on no feasible one."""
    n, B = 8, 128
    G = np.vstack([np.eye(n)[:1], -np.eye(n)[:1]])
    spec = prepare_admm(G, np.eye(n))
    fs = jnp.asarray(rng.normal(size=(B, n)).astype(np.float32))
    hs = jnp.broadcast_to(jnp.asarray([1.0, 2.0], jnp.float32), (B, 2))
    hs = hs.at[0].set(jnp.asarray([1.0, -2.0]))
    res = admm_solve(spec, fs, hs, jnp.full((B, n), -10.0),
                     jnp.full((B, n), 10.0), iters=400)
    cert = np.asarray(res.infeas_cert)
    assert cert[0] and not cert[1:].any()


def test_admm_warm_start_continues_exactly(rng):
    """60 iterations warm-started from a 60-iteration result equal 120
    cold iterations: (x, z, y) is the whole iteration state."""
    c = CondensedMpc(switched_double_integrator(), 6, default_weights())
    qp, spec = c.device_qp(), prepare_admm_mpc(c)
    B = 32
    x0s = jnp.asarray(rng.normal(size=(B, 2)).astype(np.float32))
    fs, hs = jax.vmap(qp.assemble)(x0s)
    lb = jnp.broadcast_to(qp.lb, (B, qp.n))
    ub = jnp.broadcast_to(qp.ub, (B, qp.n))
    cold = admm_solve(spec, fs, hs, lb, ub, iters=120)
    r1 = admm_solve(spec, fs, hs, lb, ub, iters=60)
    warm = admm_solve(spec, fs, hs, lb, ub, iters=60,
                      warm=(r1.x, r1.z, r1.y))
    np.testing.assert_allclose(np.asarray(warm.obj), np.asarray(cold.obj),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(warm.x), np.asarray(cold.x),
                               rtol=1e-5, atol=1e-5)


def test_shared_spec_two_jitted_programs(rng):
    """Two different @jax.jit programs sharing ONE prepared BoxQP, each
    closing over it, both run and agree (a prepared spec holds only
    concrete arrays, so no trace-local constant can leak between
    programs)."""
    n, m = 6, 4
    L = rng.normal(size=(n, n))
    spec = prepare_admm(rng.normal(size=(m, n)), L @ L.T + n * np.eye(n))
    B = 128
    q = jnp.asarray(rng.normal(size=(B, n)).astype(np.float32))
    h = jnp.ones((B, m), jnp.float32)
    lb, ub = -jnp.ones((B, n)), jnp.ones((B, n))

    @jax.jit
    def prog1(q):
        return admm_solve(spec, q, h, lb, ub, iters=200).obj

    @jax.jit
    def prog2(q):          # different program (iters) — second trace
        return admm_solve(spec, q, h, lb, ub, iters=300).obj

    np.testing.assert_allclose(np.asarray(prog1(q)), np.asarray(prog2(q)),
                               rtol=1e-4, atol=1e-4)


def test_bnb_random_structure_miqp_fuzz(rng):
    """Random-structure MIQPs (not from any model family) vs the fp64
    oracle: PSD H, random inequality rows, random binary subset with a
    planted feasible assignment."""
    from pyhybridcontrol_tpu.mld.info import MldInfo
    from pyhybridcontrol_tpu.ops.condense import DeviceQP

    for trial in range(6):
        n, m, nb = 12, 10, 4
        M = rng.normal(size=(n, n))
        H = M @ M.T + n * np.eye(n)
        f = rng.normal(size=n) * 2.0
        G = rng.normal(size=(m, n))
        bidx = tuple(sorted(rng.choice(n, size=nb, replace=False)))
        xfeas = rng.uniform(0.2, 0.8, size=n)
        for j in bidx:
            xfeas[j] = float(rng.integers(0, 2))   # planted assignment
        h = G @ xfeas + rng.uniform(0.1, 1.0, size=m)
        lb, ub = np.zeros(n), np.ones(n)

        admm = prepare_admm(G, H, q_typical=f, binary_idx=np.array(bidx))
        j32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
        qp = DeviceQP(H=j32(H), f0=j32(f), Fx=jnp.zeros((n, 1)),
                      Fw=jnp.zeros((n, 0)), Fup=jnp.zeros((n, 0)),
                      G=j32(G), h0=j32(h), Hx=jnp.zeros((m, 1)),
                      Hw=jnp.zeros((m, 0)), lb=j32(lb), ub=j32(ub),
                      T_full=jnp.eye(n), binary_idx=bidx, N=1,
                      info=MldInfo(nx=1, nu=n, ncons=m))
        r = solve_miqp_bnb(admm, qp, jnp.asarray(f, jnp.float32),
                           jnp.asarray(h, jnp.float32),
                           BnbSpec(capacity=64, wave_size=16,
                                   qp_iters=300, max_waves=24))
        orc = solve_miqp_enumeration_oracle(H, f, G, h, lb, ub,
                                            list(bidx))
        assert orc.status == "optimal"
        assert bool(r.found), f"trial {trial}: no incumbent"
        rel = abs(float(r.obj) - orc.obj) / max(1.0, abs(orc.obj))
        assert rel < 2e-3, f"trial {trial}: rel {rel:.2e}"


def test_dd_dot_accuracy():
    """utils/dd.py error-free transforms survive the live backend's
    compiler (a reassociating compiler silently degrades dd to plain
    fp32 — dd_selfcheck measures the catastrophic-cancellation error)."""
    from pyhybridcontrol_tpu.utils.dd import dd_dot, dd_selfcheck

    assert dd_selfcheck() < 1e-7

    # random cancelling dots vs fp64 ground truth: dd tracks fp64 to
    # ~fp32-ulp of the RESULT; plain fp32 sum loses ~eps·n·Σ|terms|
    rng = np.random.default_rng(7)
    a = np.concatenate([rng.normal(size=256) * 1e5,
                        rng.normal(size=64)]).astype(np.float32)
    b = np.concatenate([rng.normal(size=256) * 1e-5,
                        rng.normal(size=64)]).astype(np.float32)
    want = float(np.dot(a.astype(np.float64), b.astype(np.float64)))
    got = float(jax.jit(dd_dot)(jnp.asarray(a), jnp.asarray(b)))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want))


def test_falk_cert_dd_valid_and_consistent(miqp):
    """dd_cert=True Falk bounds stay VALID (≤ the fp64 relaxation
    optimum) and agree with the fp32 evaluation to the fp32 rounding
    envelope on a well-scaled problem (the dd payoff is where the sums
    feed fixing decisions)."""
    from pyhybridcontrol_tpu.ops.admm import admm_dual_bound

    model, N, c, qp, spec = miqp
    import dataclasses

    spec_dd = dataclasses.replace(spec, dd_cert=True)
    x0 = np.array([2.0, 0.0])
    f, h = qp.assemble(jnp.asarray(x0, jnp.float32))
    fo, ho = c.assemble_np(x0)
    relax = solve_qp_oracle(c.H, fo, c.G, ho, c.lb, c.ub)
    assert relax.status == "optimal"
    res = admm_solve(spec, f, h, qp.lb, qp.ub, iters=400)
    b32 = float(admm_dual_bound(spec, f, h, qp.lb, qp.ub, res))
    bdd = float(admm_dual_bound(spec_dd, f, h, qp.lb, qp.ub, res))
    tol = 1e-4 * max(1.0, abs(relax.obj))
    assert bdd <= relax.obj + tol, "dd Falk bound above the relaxation"
    assert abs(bdd - b32) <= 1e-3 * max(1.0, abs(b32))


def test_bnb_sb_fix_dd_matches_enumeration(miqp):
    """Root strong branching with the certificate arms ON (sb_fix=True)
    over dd_cert preps returns the enumeration optimum — the end-to-end
    CPU check of the compensated-certificate path."""
    import dataclasses

    model, N, c, qp, spec = miqp
    spec_dd = dataclasses.replace(spec, dd_cert=True)
    x0 = np.array([2.0, 0.0])
    f, h = qp.assemble(jnp.asarray(x0, jnp.float32))
    _, obj_enum, _, _ = solve_miqp_enumerate_device(spec, qp, f, h,
                                                    iters=600)
    res = solve_miqp_bnb(spec_dd, qp, f, h,
                         BnbSpec(capacity=256, wave_size=16, max_waves=64,
                                 qp_iters=600, sb_iters=200, sb_fix=True,
                                 root_iters=1200))
    assert bool(res.found)
    assert abs(float(res.obj) - float(obj_enum)) <= 1e-3 * max(
        1.0, abs(float(obj_enum)))
