"""Round-2 B&B search-quality controls (VERDICT item 4; SURVEY.md §2a
"solver options", §2b solver/bnb): relative MIPGap termination, dive-probe
gating, pseudo-cost branching — all must preserve the optimum found by
the round-1 configuration while reducing work."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyhybridcontrol_tpu.models.double_integrator import (
    switched_double_integrator, default_weights)
from pyhybridcontrol_tpu.ops.admm import prepare_admm_mpc
from pyhybridcontrol_tpu.ops.condense import CondensedMpc
from pyhybridcontrol_tpu.solver.bnb import BnbSpec, solve_miqp_bnb

BIG = 1e30


@pytest.fixture(scope="module")
def prob():
    model = switched_double_integrator()
    c = CondensedMpc(model, 6, default_weights())
    qp = c.device_qp()
    admm = prepare_admm_mpc(c)
    x0 = np.array([2.0, 0.0], np.float32)
    f, h = qp.assemble(jnp.asarray(x0))
    return qp, admm, f, h


def _base(**kw):
    return BnbSpec(capacity=128, wave_size=8, max_waves=64, qp_iters=400,
                   **kw)


def test_rel_gap_stop_is_valid_and_earlier(prob):
    qp, admm, f, h = prob
    exact = solve_miqp_bnb(admm, qp, f, h, _base())
    loose = solve_miqp_bnb(admm, qp, f, h, _base(rel_gap=0.5))
    assert bool(loose.found)
    # a rel_gap incumbent is still a TRUE upper bound within the gap
    tol = 0.5 * max(1.0, abs(float(exact.obj)))
    assert float(exact.obj) <= float(loose.obj) <= float(exact.obj) + tol
    assert int(loose.waves) <= int(exact.waves)
    # and the certified gap at exit really is within tolerance
    bo = float(loose.best_open_bound)
    if bo < BIG * 0.99:   # stopped BY the gap (not by pool exhaustion)
        assert float(loose.obj) - bo <= tol + 1e-5


def test_tight_rel_gap_matches_exact(prob):
    qp, admm, f, h = prob
    exact = solve_miqp_bnb(admm, qp, f, h, _base())
    tight = solve_miqp_bnb(admm, qp, f, h, _base(rel_gap=1e-6))
    np.testing.assert_allclose(float(tight.obj), float(exact.obj),
                               rtol=1e-5, atol=1e-5)


def test_probe_gating_preserves_optimum(prob):
    qp, admm, f, h = prob
    ref = solve_miqp_bnb(admm, qp, f, h, _base())
    gated = solve_miqp_bnb(admm, qp, f, h, _base(probe_patience=2))
    assert bool(gated.found)
    np.testing.assert_allclose(float(gated.obj), float(ref.obj),
                               rtol=1e-5, atol=1e-5)
    # clean termination still empties the frontier
    assert float(gated.best_open_bound) >= BIG * 0.99


def test_branching_rules_agree_on_optimum(prob):
    qp, admm, f, h = prob
    pc = solve_miqp_bnb(admm, qp, f, h, _base(branching="pseudocost"))
    mf = solve_miqp_bnb(admm, qp, f, h, _base(branching="most_frac"))
    assert bool(pc.found) and bool(mf.found)
    np.testing.assert_allclose(float(pc.obj), float(mf.obj),
                               rtol=1e-5, atol=1e-5)


def test_pseudocost_determinism(prob):
    qp, admm, f, h = prob
    spec = _base(branching="pseudocost", probe_patience=3, rel_gap=1e-4)
    r1 = solve_miqp_bnb(admm, qp, f, h, spec)
    r2 = solve_miqp_bnb(admm, qp, f, h, spec)
    assert float(r1.obj) == float(r2.obj)
    assert int(r1.nodes_solved) == int(r2.nodes_solved)
    assert int(r1.waves) == int(r2.waves)


def test_spec_validation_new_fields():
    with pytest.raises(ValueError):
        BnbSpec(branching="strong")
    with pytest.raises(ValueError):
        BnbSpec(rel_gap=-0.1)
    with pytest.raises(ValueError):
        BnbSpec(probe_patience=-1)


def test_sharded_rel_gap_lockstep(prob):
    """rel_gap termination must consume the globally-reduced bound so the
    SPMD wave loops exit together (no collective mismatch/deadlock)."""
    from jax.sharding import Mesh
    from pyhybridcontrol_tpu.parallel.sharded_bnb import (
        solve_miqp_bnb_sharded)

    qp, admm, f, h = prob
    devs = np.array(jax.devices()[:4])
    mesh = Mesh(devs, ("pool",))
    spec = BnbSpec(capacity=64, wave_size=8, max_waves=64, qp_iters=400,
                   rel_gap=1e-6, probe_patience=2)
    r = solve_miqp_bnb_sharded(admm, qp, f, h, spec, mesh)
    solo = solve_miqp_bnb(admm, qp, f, h, _base())
    assert bool(np.asarray(r.found).ravel()[0])
    np.testing.assert_allclose(float(np.asarray(r.obj).ravel()[0]),
                               float(solo.obj), rtol=1e-4, atol=1e-4)


def test_presolve_fix_preserves_optimum(prob):
    """Node presolve (reduced-cost + implied-integrality fixing from the
    Falk cert, BnbSpec.presolve_fix) must return the same optimum."""
    qp, admm, f, h = prob
    on = solve_miqp_bnb(admm, qp, f, h, _base(presolve_fix=True))
    off = solve_miqp_bnb(admm, qp, f, h, _base(presolve_fix=False))
    assert bool(on.found) and bool(off.found)
    np.testing.assert_allclose(float(on.obj), float(off.obj),
                               rtol=1e-4, atol=1e-4)


def test_presolve_fix_shrinks_uc_tree():
    """Min-up/down unit-commitment rows are where implied-integrality
    fixing propagates: the config-3-style DEWH problem must solve with
    a much smaller tree at the identical incumbent (measured 844 -> 28
    mean nodes over the closed loop; single solve asserted >=3x here)."""
    from pyhybridcontrol_tpu.loop.closed_loop import (
        closed_loop, make_mpc_step)
    from pyhybridcontrol_tpu.models.dewh import (
        DewhParams, dewh_energy_price_seq, dewh_model, dewh_weights,
        min_up_down_rows)

    p = DewhParams()
    m = dewh_model(p)
    N = 24
    c = CondensedMpc(m, N, dewh_weights())
    A_v, bex = min_up_down_rows(N, m.info.nv, min_up=2)
    c = c.with_extra_constraints(A_v, bex)
    c = c.with_move_blocking([k // 2 for k in range(N)])
    nc = m.info.ncons
    c = c.with_soft_constraints(
        [k * nc + r for k in range(N) for r in (0, 1)],
        lin_pen=5.0, quad_pen=1.0)
    qp, admm = c.device_qp(), prepare_admm_mpc(c)
    probe = prepare_admm_mpc(c, rho=10.0)
    T = 6
    rng = np.random.default_rng(0)
    draws = (0.5 * (rng.uniform(0, 1, (T + N, 1)) < 0.25)
             ).astype(np.float32)
    prices = dewh_energy_price_seq(np.full(T + N, 0.15), p,
                                   nv=m.info.nv).astype(np.float32)
    kw = dict(capacity=512, wave_size=64, max_waves=32, qp_iters=200,
              gap=1e-3)
    out = {}
    for pf in (True, False):
        step = make_mpc_step(m, qp, admm, method="bnb",
                             bnb_spec=BnbSpec(presolve_fix=pf, **kw),
                             admm_probe=probe)
        out[pf] = closed_loop(m, step, jnp.asarray([55.0, 0.0]), T,
                              omega_traj=jnp.asarray(draws),
                              price_traj=jnp.asarray(prices))
    on, off = out[True], out[False]
    assert bool(np.all(np.asarray(on.found)))
    assert bool(np.all(np.asarray(off.found)))
    # identical control trajectory, >=3x fewer nodes over the loop
    np.testing.assert_allclose(np.asarray(on.vs), np.asarray(off.vs),
                               rtol=1e-3, atol=1e-3)
    n_on = int(np.sum(np.asarray(on.nodes)))
    n_off = int(np.sum(np.asarray(off.nodes)))
    assert n_on * 3 <= n_off, (n_on, n_off)


def test_probe_gating_recovers_from_poor_seed():
    """Regression: the probe gate must RE-OPEN periodically while stale.
    With a poor seeded incumbent on a deep hull-PWA tree (probes are the
    only incumbent source early on; leaves never enter the best-first
    selection within the wave cap), a permanently-closing gate leaves
    the incumbent at the seed — measured 84.03 vs 61.01 on config 2
    before the periodic-retry fix. Gated and ungated runs must agree."""
    from pyhybridcontrol_tpu.models.pwa_examples import (
        pwa_spring_mld, pwa_weights)

    from pyhybridcontrol_tpu.solver.repair import (
        prepare_repair, root_repair_incumbent)

    m = pwa_spring_mld(on_off=True, formulation="hull")
    c = CondensedMpc(m, 20, pwa_weights())
    qp, admm = c.device_qp(), prepare_admm_mpc(c)
    probe = prepare_admm_mpc(c, rho=10.0)
    rspec = prepare_repair(m, pwa_weights())
    x0 = jnp.asarray([1.5, 0.0])
    f, h = qp.assemble(x0)
    seed = root_repair_incumbent(admm, qp, rspec, x0, f, h, qp_iters=400)
    seed_obj = float(seed[0])
    gated = solve_miqp_bnb(
        admm, qp, f, h,
        BnbSpec(capacity=1024, wave_size=128, max_waves=16, qp_iters=200,
                probe_iters=1000, gap=1e-3, probe_patience=3),
        init_incumbent=seed, admm_probe=probe)
    assert bool(gated.found)
    # the repair seed is ~84; probing-every-wave reaches 61.33 by wave
    # 16 (the bench config-2 point); the gated run must escape the seed
    assert float(gated.obj) < seed_obj - 1.0, (float(gated.obj), seed_obj)


def test_depth_tiebreak_preserves_optimum_and_certificates(prob):
    """depth_tiebreak is SEARCH-ORDER only (BnbSpec.depth_tiebreak):
    bounds, pruning, incumbents, and the certified best-open bound must
    be unchanged in validity — the returned optimum matches the dt=0
    run, and the exit certificate still brackets it. (Round-4 plateau
    countermeasure: on exact bound plateaus top_k's index tie-break
    degenerates to breadth-first; a small depth preference restores
    diving.)"""
    qp, admm, f, h = prob
    base = solve_miqp_bnb(admm, qp, f, h, _base())
    for dt in (1e-3, 1e-2):
        dived = solve_miqp_bnb(admm, qp, f, h, _base(depth_tiebreak=dt))
        assert bool(dived.found)
        np.testing.assert_allclose(float(dived.obj), float(base.obj),
                                   rtol=1e-4, atol=1e-4)
        bo = float(dived.best_open_bound)
        if bo < BIG * 0.99:
            assert bo <= float(dived.obj) + 1e-4


def test_flipdelta_branching_preserves_optimum(prob):
    qp, admm, f, h = prob
    fd = solve_miqp_bnb(admm, qp, f, h, _base(branching="flipdelta"))
    pc = solve_miqp_bnb(admm, qp, f, h, _base())
    assert bool(fd.found) and bool(pc.found)
    np.testing.assert_allclose(float(fd.obj), float(pc.obj),
                               rtol=1e-4, atol=1e-4)


def test_rel_gap_stop_fires_early_on_hull_pwa():
    """config-2b semantics in-suite (VERDICT r2 item 9): on a hull-PWA
    instance the certified rel_gap stop must terminate the search EARLY
    (waves < both max_waves and the exact run's tree-exhaustion wave)
    with a certified gap at or under the target, and an incumbent within
    the target of the exact optimum."""
    from pyhybridcontrol_tpu.models.pwa_examples import (
        pwa_spring_mld, pwa_weights)
    from pyhybridcontrol_tpu.solver.repair import (
        prepare_repair, root_repair_incumbent)

    m = pwa_spring_mld(on_off=True, formulation="hull")
    c = CondensedMpc(m, 10, pwa_weights())
    qp, admm = c.device_qp(), prepare_admm_mpc(c)
    probe = prepare_admm_mpc(c, rho=10.0)
    rspec = prepare_repair(m, pwa_weights())
    x0 = jnp.asarray([1.5, 0.0])
    f, h = qp.assemble(x0)
    seed = root_repair_incumbent(admm, qp, rspec, x0, f, h, qp_iters=400)

    def run(rel_gap):
        return solve_miqp_bnb(
            admm, qp, f, h,
            BnbSpec(capacity=512, wave_size=64, max_waves=48,
                    qp_iters=200, probe_iters=600, gap=1e-3,
                    probe_patience=3, rel_gap=rel_gap),
            init_incumbent=seed, admm_probe=probe)

    exact = run(0.0)          # runs to tree exhaustion (~18 waves)
    gapped = run(0.05)
    assert bool(exact.found) and bool(gapped.found)
    assert int(gapped.waves) < 48
    assert int(gapped.waves) < int(exact.waves)
    go, gb = float(gapped.obj), float(gapped.best_open_bound)
    assert np.isfinite(gb)
    cert = (go - gb) / max(1.0, abs(go))
    assert 0.0 <= cert <= 0.05 + 1e-6
    # the incumbent itself is within the certified gap of the optimum
    assert go <= float(exact.obj) * (1 + 0.05) + 1e-6


def test_strong_branching_preserves_optimum(prob):
    """Root strong branching (BnbSpec.sb_iters, round 4): one batched
    solve of all 2*nb candidate children seeds pseudo-costs, fixes
    certificate-losing binaries and lifts the root bound -- none of
    which may change the returned optimum."""
    qp, admm, f, h = prob
    base = solve_miqp_bnb(admm, qp, f, h, _base())
    sb = solve_miqp_bnb(admm, qp, f, h,
                        _base(sb_iters=200, sb_fix=True))
    assert bool(sb.found)
    np.testing.assert_allclose(float(sb.obj), float(base.obj),
                               rtol=1e-5, atol=1e-4)


def test_strong_branching_root_lift_is_valid(prob):
    """The max_j min(child bounds) root lift must stay a LOWER bound:
    with rel_gap off and the tree fully explored, best_open_bound on
    exit is BIG (tree exhausted) and the incumbent equals the optimum;
    with an immediate wave cap the lifted root bound must sit at or
    under the optimum (a lift ABOVE it would falsely certify)."""
    qp, admm, f, h = prob
    exact = solve_miqp_bnb(admm, qp, f, h, _base())
    one = solve_miqp_bnb(
        admm, qp, f, h,
        BnbSpec(capacity=128, wave_size=8, max_waves=1, qp_iters=400,
                sb_iters=400, sb_fix=True))
    bo = float(one.best_open_bound)
    if bo < BIG * 0.99:
        assert bo <= float(exact.obj) + 1e-4


def test_strong_branching_with_incumbent_seed(prob):
    """With an incumbent seed the reduced-cost arm of the root fixing
    engages (child bound >= inc - gap -> fix the other side); the
    optimum must survive because the seed IS the optimum here."""
    qp, admm, f, h = prob
    exact = solve_miqp_bnb(admm, qp, f, h, _base())
    seed = (exact.obj, exact.x, exact.found)
    sb = solve_miqp_bnb(admm, qp, f, h,
                        _base(sb_iters=300, sb_fix=True),
                        init_incumbent=seed)
    assert bool(sb.found)
    np.testing.assert_allclose(float(sb.obj), float(exact.obj),
                               rtol=1e-5, atol=1e-4)


def test_dive_slots_matches_enumeration(prob):
    """The dive lane (BnbSpec.dive_slots) is search-order only: the
    returned optimum must equal the enumeration oracle's, and no
    subtree may be silently dropped (the OOB-sentinel path when fewer
    active nodes exist than dive slots — wave 1 has exactly one)."""
    from pyhybridcontrol_tpu.solver.enumerate import (
        solve_miqp_enumerate_device)

    qp, admm, f, h = prob
    _, obj_enum, _, _ = solve_miqp_enumerate_device(
        admm, qp, f, h, iters=600)
    for k in (1, 6):
        res = solve_miqp_bnb(admm, qp, f, h, _base(dive_slots=k))
        assert bool(res.found)
        assert not bool(res.overflow)
        assert abs(float(res.obj) - float(obj_enum)) <= 1e-3 * max(
            1.0, abs(float(obj_enum)))


def test_profiling_utils():
    from pyhybridcontrol_tpu.utils.profiling import bnb_stats, wall_timer

    model = switched_double_integrator()
    c = CondensedMpc(model, 6, default_weights())
    qp, admm = c.device_qp(), prepare_admm_mpc(c)
    f, h = qp.assemble(jnp.asarray([2.0, 0.0]))
    with wall_timer("solve", sync=None) as t:
        r = solve_miqp_bnb(admm, qp, f, h,
                           BnbSpec(capacity=64, wave_size=8, qp_iters=200))
        r.obj.block_until_ready()
    assert t["seconds"] > 0
    stats = bnb_stats(r)
    assert stats["found"] and stats["nodes_solved"] > 0
    assert np.isfinite(stats["obj"])
