"""io/ (checkpoint, logging), configs, CLI, and PWA benchmark model."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyhybridcontrol_tpu.configs import BENCHMARK_CONFIGS, get_config
from pyhybridcontrol_tpu.io.checkpoint import load_checkpoint, save_checkpoint
from pyhybridcontrol_tpu.io.logging import StructuredLog
from pyhybridcontrol_tpu.models.pwa_examples import (
    pwa_spring_mld, pwa_spring_system, pwa_weights)


def test_checkpoint_roundtrip(tmp_path):
    state = {"x": jnp.arange(5.0), "k": jnp.asarray(3),
             "nested": {"m": jnp.eye(2)}}
    p = str(tmp_path / "ck.bin")
    save_checkpoint(p, state, step=7, metadata={"cfg": "test"})
    blank = jax.tree_util.tree_map(jnp.zeros_like, state)
    restored, step, meta = load_checkpoint(p, blank)
    assert step == 7 and meta == {"cfg": "test"}
    np.testing.assert_array_equal(np.asarray(restored["x"]), np.arange(5.0))
    np.testing.assert_array_equal(np.asarray(restored["nested"]["m"]),
                                  np.eye(2))


def test_checkpoint_atomic_overwrite(tmp_path):
    p = str(tmp_path / "ck.bin")
    save_checkpoint(p, {"a": jnp.zeros(3)}, step=1)
    save_checkpoint(p, {"a": jnp.ones(3)}, step=2)
    restored, step, _ = load_checkpoint(p, {"a": jnp.zeros(3)})
    assert step == 2
    np.testing.assert_array_equal(np.asarray(restored["a"]), np.ones(3))


def test_checkpoint_inspection_keeps_dtypes(tmp_path):
    """target=None returns the raw leaves in order, dtypes and shapes
    intact (bool, int, float, 0-d)."""
    state = {"a": jnp.asarray(True), "b": jnp.arange(3, dtype=jnp.int32),
             "c": jnp.ones((2, 2), jnp.float32)}
    p = str(tmp_path / "ck.bin")
    save_checkpoint(p, state, step=2)
    leaves, step, meta = load_checkpoint(p)
    assert step == 2 and meta == {}
    assert [l.dtype for l in leaves] == [np.bool_, np.int32, np.float32]
    assert [l.shape for l in leaves] == [(), (3,), (2, 2)]
    np.testing.assert_array_equal(leaves[1], np.arange(3))


def test_checkpoint_rejects_structure_mismatch(tmp_path):
    p = str(tmp_path / "ck.bin")
    save_checkpoint(p, {"a": jnp.zeros(3), "b": jnp.zeros(2)})
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(p, {"a": jnp.zeros(3)})


def test_checkpoint_process_shards(tmp_path):
    """Each process writes and reads its own ``-procNNN`` shard."""
    p = str(tmp_path / "ck.bin")
    for i in range(2):
        out = save_checkpoint(p, {"x": jnp.full(2, float(i))},
                              process_index=i)
        assert out == f"{p}-proc{i:03d}"
    for i in range(2):
        st, _, _ = load_checkpoint(p, {"x": jnp.zeros(2)}, process_index=i)
        np.testing.assert_array_equal(np.asarray(st["x"]), [i, i])


def test_structured_log_jsonl(tmp_path):
    p = str(tmp_path / "log.jsonl")
    log = StructuredLog(p, run_name="t")
    log.log(0, cost=1.5, x=np.array([1.0, 2.0]))
    log.log(1, cost=2.5, x=np.array([3.0, 4.0]))
    log.close()
    lines = [json.loads(l) for l in open(p)]
    assert len(lines) == 2
    assert lines[1]["cost"] == 2.5
    assert lines[0]["x"] == [1.0, 2.0]
    df = log.to_pandas()
    assert len(df) == 2
    pq = str(tmp_path / "log.parquet")
    log.to_parquet(pq)
    import pandas as pd

    back = pd.read_parquet(pq)
    assert len(back) == 2 and back["cost"].tolist() == [1.5, 2.5]
    assert list(back["x"][0]) == [1.0, 2.0]


def test_configs_complete():
    """All five BASELINE configs exist and build valid models."""
    assert set(BENCHMARK_CONFIGS) == {
        "double_integrator", "pwa_actuator", "thermal_uc",
        "scenario_batch", "sharded_bnb"}
    for name, cfg in BENCHMARK_CONFIGS.items():
        model, kw = cfg.build()
        assert model.info.nx > 0
        assert "weights" in kw
    with pytest.raises(KeyError):
        get_config("nope")


def test_cli_runner_double_integrator(capsys):
    from pyhybridcontrol_tpu.run import main
    main(["--config", "double_integrator", "--steps", "4", "--cpu"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(out)
    assert rec["config"] == "double_integrator"
    assert rec["found_frac"] == 1.0


# ---- PWA benchmark model (config 2) -----------------------------------

def test_pwa_spring_mld_gating(rng):
    m = pwa_spring_mld(on_off=True)
    info = m.info
    assert info.nu == 2 and info.u_types == ("c", "b")
    assert info.nz == 5          # 4 PWA products + gate
    sys = pwa_spring_system()
    # actuator ON: effective force = u_force; OFF: = 0
    for u_on, eff in ((1.0, 0.7), (0.0, 0.0)):
        x = np.array([0.5, -0.2])
        u_force = 0.7
        want = sys.simulate_step(x, np.array([eff]))
        # feasible (δ, z): region 1 active (x1 ≥ 0)
        delta = np.array([1.0, 0.0])
        z = np.zeros(5)
        reg = sys.regions[0]
        z[:2] = reg.A @ x + reg.B @ np.array([eff]) + reg.c
        z[4] = eff
        r = m.constraint_residual(
            jnp.asarray(x, jnp.float32),
            jnp.asarray([u_force, u_on], jnp.float32),
            jnp.asarray(delta, jnp.float32), jnp.asarray(z, jnp.float32))
        assert float(np.max(np.asarray(r))) < 1e-5, f"u_on={u_on}"
        got = m.step(jnp.asarray(x, jnp.float32),
                     jnp.asarray([u_force, u_on], jnp.float32),
                     jnp.asarray(delta, jnp.float32),
                     jnp.asarray(z, jnp.float32))
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-5)


def test_pwa_gating_rejects_leak():
    """Actuator off but force leaking through must be infeasible."""
    m = pwa_spring_mld(on_off=True)
    x = np.array([0.5, 0.0])
    delta = np.array([1.0, 0.0])
    z = np.zeros(5)
    z[4] = 0.7   # claims gated force though actuator off
    sys = pwa_spring_system()
    reg = sys.regions[0]
    z[:2] = reg.A @ x + reg.B @ np.array([0.7]) + reg.c
    r = m.constraint_residual(
        jnp.asarray(x, jnp.float32), jnp.asarray([0.7, 0.0], jnp.float32),
        jnp.asarray(delta, jnp.float32), jnp.asarray(z, jnp.float32))
    assert float(np.max(np.asarray(r))) > 0.1


def test_closed_loop_checkpoint_resume(tmp_path):
    """SURVEY.md §5 fault tolerance: a closed-loop study interrupted at
    step k and resumed from its checkpoint matches the uninterrupted
    run exactly."""
    import jax.numpy as jnp

    from pyhybridcontrol_tpu.loop import closed_loop, make_mpc_step
    from pyhybridcontrol_tpu.models.double_integrator import (
        default_weights, switched_double_integrator)
    from pyhybridcontrol_tpu.ops.admm import prepare_admm_mpc
    from pyhybridcontrol_tpu.ops.condense import CondensedMpc
    from pyhybridcontrol_tpu.solver.bnb import BnbSpec

    model = switched_double_integrator()
    c = CondensedMpc(model, 6, default_weights())
    step = make_mpc_step(model, c.device_qp(), prepare_admm_mpc(c),
                         method="bnb",
                         bnb_spec=BnbSpec(capacity=64, wave_size=8,
                                          qp_iters=300))
    x0 = jnp.asarray([2.0, 0.0])
    full = closed_loop(model, step, x0, T=8)

    # run half, checkpoint the carried state, "crash", resume
    half = closed_loop(model, step, x0, T=4)
    p = str(tmp_path / "study.ck")
    state = {"x": half.xs[-1], "u_prev": half.vs[-1][:1],
             "plan": half.plan, "plan_ok": half.plan_ok,
             "k": jnp.asarray(4)}
    save_checkpoint(p, state, step=4, metadata={"cfg": "resume-test"})
    blank = jax.tree_util.tree_map(jnp.zeros_like, state)
    restored, k0, _ = load_checkpoint(p, blank)
    rest = closed_loop(model, step, restored["x"], T=4,
                       u_prev0=restored["u_prev"],
                       prev_plan=(restored["plan"], restored["plan_ok"]))
    np.testing.assert_allclose(np.asarray(rest.xs[1:]),
                               np.asarray(full.xs[5:]), atol=1e-4)
    np.testing.assert_allclose(np.asarray(rest.objs),
                               np.asarray(full.objs[4:]), atol=1e-3)
