"""MpcController behavior: version-cached rebuilds, weight updates,
output-cost (Qy) objective path, terminal constraints."""

import jax.numpy as jnp
import numpy as np
import pytest

from pyhybridcontrol_tpu.control.mpc import MpcController
from pyhybridcontrol_tpu.models.double_integrator import (
    switched_double_integrator, default_weights)
from pyhybridcontrol_tpu.ops.condense import CondensedMpc, MpcWeights


def test_version_cached_build():
    model = switched_double_integrator()
    ctrl = MpcController(model, 6, default_weights())
    ctrl.build()
    c1 = ctrl.condensed
    ctrl.build()
    assert ctrl.condensed is c1            # no rebuild
    ctrl.set_std_obj_weights(Ru=np.array([0.5]))
    assert ctrl.condensed is not c1        # weight change → rebuild
    with pytest.raises(AttributeError):
        ctrl.set_std_obj_weights(nope=1.0)


def test_horizon_change_rebuilds():
    model = switched_double_integrator()
    ctrl = MpcController(model, 6, default_weights())
    n1 = ctrl.device_qp.n
    ctrl.set_horizon(8)
    assert ctrl.device_qp.n == n1 // 6 * 8


def test_output_cost_objective(rng):
    """Qy on y = Cx (+D v): objective differences match hand-computed
    stage sums (covers the Γy path of the condensation)."""
    model = switched_double_integrator()
    N = 5
    w = MpcWeights(Qy=np.array([2.0, 0.0]), Ru=np.array([0.1]))
    c = CondensedMpc(model, N, w)
    m = model.numpy_mats()
    x0 = rng.normal(size=2)

    def stage_cost(V):
        x = x0.copy()
        Bv = np.hstack([m.B1, m.B2, m.B3])
        J = 0.0
        for k in range(N):
            y = m.C @ x  # D terms are zero for this model
            J += 2.0 * y[0] ** 2 + 0.1 * V[k, 0] ** 2
            x = m.A @ x + Bv @ V[k] + m.b5[:, 0]
        return J

    f, _ = c.assemble_np(x0)
    V1 = rng.uniform(-1, 1, size=(N, 3))
    V2 = rng.uniform(-1, 1, size=(N, 3))
    qd = (0.5 * V1.reshape(-1) @ c.H @ V1.reshape(-1) + f @ V1.reshape(-1)
          - 0.5 * V2.reshape(-1) @ c.H @ V2.reshape(-1) - f @ V2.reshape(-1))
    np.testing.assert_allclose(qd, stage_cost(V1) - stage_cost(V2),
                               rtol=1e-6, atol=1e-6)


def test_terminal_constraint_enforced():
    """E_N x_N ≤ f_N forces the terminal state into a box."""
    model = switched_double_integrator()
    w = default_weights()
    EN = np.array([[1.0, 0.0], [-1.0, 0.0]])
    fN = np.array([0.1, 0.1])              # |p_N| ≤ 0.1
    ctrl = MpcController(model, 10, w, solver="enumerate", qp_iters=500)
    ctrl.set_terminal_constraint(EN, fN)
    sol = ctrl.feedback(jnp.asarray([1.5, 0.0]))
    assert bool(sol.found)
    # roll the planned sequence forward: terminal position inside box
    xs, _ = model.lsim(jnp.asarray([1.5, 0.0]), sol.v_seq)
    assert abs(float(xs[-1][0])) <= 0.1 + 5e-2


def test_feedback_with_forecast_and_prices():
    from tests.test_scenario_tree import _omega_model

    model = _omega_model()
    ctrl = MpcController(model, 4, default_weights(), solver="bnb")
    W = np.full((4, 1), 0.5, np.float32)
    prices = np.zeros((4, model.info.nv), np.float32)
    prices[:, 0] = 0.2
    sol = ctrl.feedback(jnp.asarray([1.0, 0.0]), omega_forecast=W,
                        price_seq=prices, u_prev=np.array([0.3]))
    assert bool(sol.found)
    assert sol.v_seq.shape == (4, model.info.nv)


def test_stagewise_solver_option():
    """solver='stagewise': long-horizon feedback through the controller."""
    model = switched_double_integrator()
    from pyhybridcontrol_tpu.solver.bnb import BnbSpec

    ctrl = MpcController(model, 40, default_weights(), solver="stagewise",
                         bnb_spec=BnbSpec(capacity=128, wave_size=8,
                                          qp_iters=400, max_waves=16))
    sol = ctrl.feedback(jnp.asarray([2.0, 0.0]))
    assert bool(sol.found)
    assert sol.v_seq.shape == (40, model.info.nv)
    assert sol.x_seq.shape == (40, model.info.nx)
    # blocking/terminal ride natively since round 3, horizon-coupled
    # extra rows (incl. x trees) since round 4 — parity coverage in
    # tests/test_stagewise.py and tests/test_stagewise_tree.py
    ctrl2 = MpcController(model, 10, default_weights(), solver="stagewise")
    ctrl2.set_move_blocking([k // 2 for k in range(10)])
    ctrl2.build()
    ctrl3 = MpcController(model, 10, default_weights(), solver="stagewise")
    ctrl3.set_extra_constraints(np.zeros((1, 10 * model.info.nv)),
                                np.ones(1))
    ctrl3.build()                     # builds: bordered Woodbury path
    assert ctrl3._sw.n_ext == 1


def test_feedback_batch_matches_single():
    model = switched_double_integrator()
    ctrl = MpcController(model, 6, default_weights(),
                         bnb_spec=__import__(
                             "pyhybridcontrol_tpu.solver.bnb",
                             fromlist=["BnbSpec"]).BnbSpec(
                             capacity=64, wave_size=8, qp_iters=200,
                             max_waves=24))
    rng = np.random.default_rng(11)
    x0s = jnp.asarray(rng.normal(size=(8, 2)).astype(np.float32))
    # engine="auto" (default) resolves to the pooled driver for a plain
    # bnb controller — per-instance results must still match feedback
    batch = ctrl.feedback_batch(x0s)
    assert batch.u.shape == (8, 1) and bool(jnp.all(batch.found))
    for i in range(3):
        single = ctrl.feedback(x0s[i])
        np.testing.assert_allclose(np.asarray(batch.obj[i]),
                                   np.asarray(single.obj),
                                   rtol=1e-3, atol=1e-3)
    assert len(ctrl._fb_batch_cache) == 0   # pooled path, not vmap
    # explicit vmap engine: same answers, compiled-program cache reused
    batch_v = ctrl.feedback_batch(x0s, engine="vmap")
    np.testing.assert_allclose(np.asarray(batch_v.obj),
                               np.asarray(batch.obj), rtol=1e-3,
                               atol=1e-3)
    assert len(ctrl._fb_batch_cache) == 1
    again = ctrl.feedback_batch(x0s + 0.01, engine="vmap")
    assert len(ctrl._fb_batch_cache) == 1
    assert bool(jnp.all(again.found))


def test_feedback_batch_sharded_mesh():
    import jax
    from jax.sharding import PartitionSpec as P

    from pyhybridcontrol_tpu.parallel.mesh import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    model = switched_double_integrator()
    ctrl = MpcController(model, 6, default_weights(), solver="enumerate",
                         qp_iters=200)
    rng = np.random.default_rng(12)
    x0s = jnp.asarray(rng.normal(size=(16, 2)).astype(np.float32))
    plain = ctrl.feedback_batch(x0s)
    mesh = make_mesh([("scen", 8)])
    sharded = ctrl.feedback_batch(x0s, mesh=mesh)
    np.testing.assert_allclose(np.asarray(sharded.obj),
                               np.asarray(plain.obj), rtol=1e-3, atol=1e-3)
    devs = {s.device for s in sharded.u.addressable_shards}
    assert len(devs) == 8


def test_feedback_batch_stagewise_solver():
    ctrl = MpcController(switched_double_integrator(), 12,
                         default_weights(), solver="stagewise")
    rng = np.random.default_rng(7)
    x0s = jnp.asarray(rng.normal(size=(4, 2)).astype(np.float32))
    batch = ctrl.feedback_batch(x0s)
    assert batch.u.shape == (4, 1) and bool(jnp.all(batch.found))
    single = ctrl.feedback(x0s[0])
    np.testing.assert_allclose(np.asarray(batch.obj[0]),
                               np.asarray(single.obj), rtol=1e-4,
                               atol=1e-5)


def test_feedback_input_validation():
    ctrl = MpcController(switched_double_integrator(), 6,
                         default_weights(), solver="enumerate",
                         qp_iters=50)
    x0 = jnp.asarray(np.array([1.0, 0.0], np.float32))
    with pytest.raises(ValueError, match="nomega=0"):
        ctrl.feedback(x0, omega_forecast=np.zeros((6, 1), np.float32))
    with pytest.raises(ValueError, match="price_seq"):
        ctrl.feedback(x0, price_seq=np.zeros((3, 3), np.float32))


def test_feedback_batch_pooled_engine():
    """engine="pooled" routes the batch through one global node pool
    (solver/bnb_pooled.py) and matches the vmapped engine's per-
    instance objectives."""
    from pyhybridcontrol_tpu.solver.bnb import BnbSpec

    model = switched_double_integrator()
    ctrl = MpcController(model, 6, default_weights(),
                         bnb_spec=BnbSpec(capacity=64, wave_size=8,
                                          qp_iters=200, max_waves=24))
    rng = np.random.default_rng(5)
    x0s = jnp.asarray(rng.normal(size=(8, 2)).astype(np.float32))
    ref = ctrl.feedback_batch(x0s)
    pooled = ctrl.feedback_batch(x0s, engine="pooled", pooled_wave=32,
                                 pool_slots=512)
    assert pooled.u.shape == ref.u.shape
    assert bool(jnp.all(pooled.found))
    np.testing.assert_allclose(np.asarray(pooled.obj), np.asarray(ref.obj),
                               rtol=1e-3, atol=1e-3)
    # engine guards
    ctrl_sw = MpcController(model, 6, default_weights(),
                            solver="stagewise")
    with pytest.raises(ValueError):
        ctrl_sw.feedback_batch(x0s, engine="pooled")


def test_feedback_reports_certified_gap():
    """sol.gap — the reference's Gurobi-MIPGap analogue: 0 on exhausted
    frontiers, positive when the search stopped with open nodes."""
    model = switched_double_integrator()
    from pyhybridcontrol_tpu.solver.bnb import BnbSpec

    ctrl = MpcController(model, 6, default_weights(),
                         bnb_spec=BnbSpec(capacity=128, wave_size=16,
                                          qp_iters=300, max_waves=32))
    sol = ctrl.feedback(jnp.asarray([2.0, 0.0]))
    assert bool(sol.found) and float(sol.gap) == 0.0
    # truncated search: one wave only → open nodes remain → gap > 0
    ctrl2 = MpcController(model, 6, default_weights(),
                          bnb_spec=BnbSpec(capacity=128, wave_size=4,
                                           qp_iters=300, max_waves=2))
    sol2 = ctrl2.feedback(jnp.asarray([2.0, 0.0]))
    if bool(sol2.found):
        assert float(sol2.gap) >= 0.0
    # batched (pooled) path carries a per-instance gap vector
    batch = ctrl.feedback_batch(jnp.asarray([[2.0, 0.0], [1.0, -0.5]]))
    assert batch.gap.shape == (2,)
    assert bool(jnp.all(batch.gap >= 0.0))


def test_feedback_then_feedback_batch_shared_controller():
    """MpcController.feedback (one jitted program) followed by
    feedback_batch (a second program, pooled engine) on the SAME
    controller: both close over one prepared admm spec and agree."""
    from pyhybridcontrol_tpu.solver.bnb import BnbSpec

    model = switched_double_integrator()
    ctl = MpcController(model, 6, default_weights(),
                        bnb_spec=BnbSpec(capacity=256, wave_size=128,
                                         max_waves=12, qp_iters=60))
    r1 = ctl.feedback(jnp.asarray([2.0, 0.0]))
    assert bool(r1.found)
    x0s = jnp.asarray([[2.0, 0.0], [-1.0, 0.5]], jnp.float32)
    rb = ctl.feedback_batch(x0s, engine="pooled", pooled_wave=128,
                            pool_slots=512)
    assert bool(np.asarray(rb.found)[0])
    np.testing.assert_allclose(float(np.asarray(rb.obj)[0]),
                               float(r1.obj), rtol=1e-3, atol=1e-3)
