#!/usr/bin/env python3
"""Smoke run of the hybrid-MPC engine on the GPU, through the entry
points users call, at the stated sizes of the shipped configs.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --multi   # four cards: the sharded paths only

Phases (one line each, then a final JSON line):

1. device        platform, kind, count, memory limit
2. recipe        double integrator N=8, device enumeration vs the fp64
                 enumeration oracle (the verify recipe)
3. relaxation    the batched ADMM relaxation on the card at the primary
                 shape and at the configs' wave batches, against an fp64
                 host replica of the same iteration; median times
4. main path     config-2 ``MpcController.feedback``, config-4
                 ``feedback_batch`` (1024 instances, pooled engine, a
                 seeded sample checked against the fp64 oracle) and the
                 1024-unit DEWH fleet through ``closed_loop_batch``
5. goldens       the committed closed-loop goldens replayed on the card
                 at the tests' own tolerances
6. processes     ``python -m pyhybridcontrol_tpu.run`` (plain, and a
                 checkpoint/resume pair) and ``python -m
                 pyhybridcontrol_tpu.serve`` on stdin

``--multi`` runs config 5 (pool-sharded B&B on a ("pool", 4) mesh) and a
scenario-sharded ``feedback_batch`` on a ("scen", 4) mesh, each against
its single-card counterpart, and prints every card's memory in use.

Any failed check raises, so the run exits nonzero. The script refuses
to run, and prints no result, when JAX's first device is not a GPU.
One process owns the cards: the children of phase 6 run one at a time
while this process waits, and both allocate on demand.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def log(phase, **kv):
    print(f"[{phase}] " + json.dumps(kv, default=float), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def median_ms(fn, reps=10):
    """(median ms over ``reps`` runs after one warm-up, last output)."""
    import jax
    import numpy as np

    out = jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts)), out


def gpu_device():
    """The first JAX device, or SystemExit when it is not a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX's first device is "
                         f"{dev.platform!r}, not a GPU; nothing was run")
    return dev


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out


# ---- phase 1 ------------------------------------------------------------

def phase_device(dev, n_expected):
    import jax

    stats = dev.memory_stats() or {}
    n = len(jax.devices())
    log("1 device", platform=dev.platform, kind=dev.device_kind, count=n,
        bytes_limit=stats.get("bytes_limit"))
    check(n >= n_expected, f"need {n_expected} GPUs, found {n}")


# ---- phase 2 ------------------------------------------------------------

def phase_recipe():
    import jax.numpy as jnp
    import numpy as np

    from pyhybridcontrol_tpu.models import (
        di_default_weights, switched_double_integrator)
    from pyhybridcontrol_tpu.ops import CondensedMpc
    from pyhybridcontrol_tpu.ops.admm import prepare_admm_mpc
    from pyhybridcontrol_tpu.solver import (
        solve_miqp_enumerate_device, solve_miqp_enumeration_oracle)

    c = CondensedMpc(switched_double_integrator(), 8, di_default_weights())
    qp, spec = c.device_qp(), prepare_admm_mpc(c)
    x0 = np.array([2.0, 0.0], np.float32)
    f, h = qp.assemble(jnp.asarray(x0))
    x, obj, bits, feas = solve_miqp_enumerate_device(spec, qp, f, h,
                                                     iters=600)
    fo, ho = c.assemble_np(x0)
    oracle = solve_miqp_enumeration_oracle(c.H, fo, c.G, ho, c.lb, c.ub,
                                           c.binary_idx)
    bits = [int(b) for b in np.asarray(bits)]
    log("2 recipe", obj=float(obj), oracle=float(oracle.obj), bits=bits)
    check(abs(float(obj) - oracle.obj) < 1e-3, "recipe: device vs oracle")
    check(abs(float(obj) + 42.6865) < 1e-3, "recipe: objective")
    check(bits == [1, 1, 1, 1, 0, 0, 0, 0], "recipe: binary assignment")


# ---- phase 3 ------------------------------------------------------------

def admm_fp64(spec, q, h, lb, ub, iters):
    """The iteration of ``ops.admm.admm_solve`` in fp64 numpy, from the
    prepared (fp32) data — the independent reference for the card."""
    import numpy as np

    f64 = lambda a: np.asarray(a, np.float64)
    P, A, Kinv = f64(spec.P), f64(spec.A), f64(spec.Kinv)
    D, E, rho = f64(spec.D), f64(spec.E), f64(spec.rho_vec)
    c, m = float(spec.cost_scale), spec.m_ineq
    qh = c * D * f64(q)
    lo = np.concatenate([np.full(f64(h).shape, -1e30),
                         np.clip(f64(lb) * E[m:], -1e30, 1e30)], -1)
    hi = np.concatenate([f64(h) * E[:m],
                         np.clip(f64(ub) * E[m:], -1e30, 1e30)], -1)
    x = np.zeros_like(qh)
    z = np.clip(np.zeros(lo.shape), lo, hi)
    y = np.zeros(lo.shape)
    for _ in range(iters):
        x = (spec.sigma * x - qh + (rho * z - y) @ A) @ Kinv.T
        zr = spec.alpha * (x @ A.T) + (1.0 - spec.alpha) * z
        z_new = np.clip(zr + y / rho, lo, hi)
        y = y + rho * (zr - z_new)
        z = z_new
    obj = (0.5 * np.sum(x * (x @ P.T), -1) + np.sum(qh * x, -1)) / c
    return D * x, obj


def relax_cases():
    """(name, model, weights, N, batch, iters): the primary batch and
    the wave batches the configs relax."""
    from pyhybridcontrol_tpu.configs import get_config
    from pyhybridcontrol_tpu.models.double_integrator import (
        default_weights, switched_double_integrator)

    out = [("primary", switched_double_integrator(), default_weights(),
            20, 4096, 100)]
    for name in ("double_integrator", "pwa_actuator", "thermal_uc",
                 "scenario_batch"):
        cfg = get_config(name)
        model, kw = cfg.build()
        wave = 1024 if name == "scenario_batch" else cfg.bnb.wave_size
        out.append((name, model, kw["weights"], cfg.N, wave,
                    cfg.bnb.qp_iters))
    return out


def phase_relaxation(card):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pyhybridcontrol_tpu.ops.admm import admm_solve, prepare_admm_mpc
    from pyhybridcontrol_tpu.ops.condense import CondensedMpc

    rng = np.random.default_rng(0)
    for name, model, w, N, B, iters in relax_cases():
        c = CondensedMpc(model, N, w)
        qp, spec = c.device_qp(), prepare_admm_mpc(c)
        x0 = np.zeros((B, model.info.nx), np.float32)
        x0 += 0.3 * rng.normal(size=x0.shape).astype(np.float32)
        if name == "thermal_uc":
            x0[:, 0] += 55.0
        fs, hs = jax.vmap(qp.assemble)(jnp.asarray(x0))
        lb = jnp.broadcast_to(qp.lb, (B, qp.n))
        ub = jnp.broadcast_to(qp.ub, (B, qp.n))
        run = jax.jit(lambda f, h: admm_solve(spec, f, h, lb, ub,
                                              iters=iters))
        ms, res = median_ms(lambda: run(fs, hs))
        k = min(B, 64)
        x_ref, obj_ref = admm_fp64(spec, fs[:k], hs[:k], lb[:k], ub[:k],
                                   iters)
        obj = np.asarray(res.obj[:k], np.float64)
        rel = float(np.max(np.abs(obj - obj_ref)
                           / np.maximum(1.0, np.abs(obj_ref))))
        dx = float(np.max(np.abs(np.asarray(res.x[:k]) - x_ref)))
        log("3 relaxation", case=name, n=qp.n, m=int(spec.m_ineq), batch=B,
            iters=iters, median_ms=ms, card=card, sample=k,
            max_rel_obj_gap=rel, max_abs_x_gap=dx)
        check(bool(jnp.all(jnp.isfinite(res.obj))), f"{name}: finite")
        check(rel <= 1e-4 and dx <= 1e-3, f"{name}: vs fp64 replica")


# ---- phase 4 ------------------------------------------------------------

def controller(name):
    from pyhybridcontrol_tpu.configs import get_config
    from pyhybridcontrol_tpu.control.mpc import MpcController

    cfg = get_config(name)
    model, kw = cfg.build()
    ctrl = MpcController(model, cfg.N, bnb_spec=cfg.bnb,
                         qp_iters=cfg.bnb.qp_iters, **kw)
    return cfg, model, ctrl


def phase_main_path():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pyhybridcontrol_tpu.solver.oracle import (
        solve_miqp_enumeration_oracle)

    # config 2: hybrid PWA plant, hull formulation, N=20
    _, _, ctrl2 = controller("pwa_actuator")
    t0 = time.perf_counter()
    r = jax.block_until_ready(ctrl2.feedback(jnp.asarray([1.5, 0.0])))
    log("4 main", solve="config2 feedback", found=bool(r.found),
        obj=float(r.obj), certified_gap=float(r.gap), nodes=int(r.nodes),
        wall_s=time.perf_counter() - t0)
    check(bool(r.found) and np.isfinite(float(r.obj)), "config 2 found")

    # config 4: 1024 instances through the pooled engine
    cfg4, model4, ctrl4 = controller("scenario_batch")
    rng = np.random.default_rng(4)
    x4 = rng.normal(size=(cfg4.batch, model4.info.nx)).astype(np.float32)
    t0 = time.perf_counter()
    r4 = jax.block_until_ready(ctrl4.feedback_batch(jnp.asarray(x4)))
    wall = time.perf_counter() - t0
    cm = ctrl4._cmpc
    sample = rng.choice(cfg4.batch, 16, replace=False)
    gaps = []
    for i in sample:
        fo, ho = cm.assemble_np(x4[i].astype(np.float64))
        o = solve_miqp_enumeration_oracle(cm.H, fo, cm.G, ho, cm.lb, cm.ub,
                                          cm.binary_idx)
        gaps.append(abs(float(r4.obj[i]) - o.obj) / max(1.0, abs(o.obj)))
    log("4 main", solve="config4 feedback_batch", batch=cfg4.batch,
        found_frac=float(jnp.mean(r4.found)),
        max_certified_gap=float(jnp.max(r4.gap)), wall_s=wall,
        oracle_sample=len(sample), max_rel_gap_vs_oracle=max(gaps))
    check(bool(jnp.all(r4.found)), "config 4 found everywhere")
    check(max(gaps) <= 1e-3, "config 4 sample vs fp64 oracle")

    # the DEWH fleet: 1024 units, closed loop through the pooled engine
    from pyhybridcontrol_tpu.loop.closed_loop import (
        closed_loop_batch, make_mpc_step_batch)
    from pyhybridcontrol_tpu.models.dewh import (
        DewhParams, dewh_energy_price_seq, dewh_model, dewh_weights)
    from pyhybridcontrol_tpu.ops.admm import prepare_admm_mpc
    from pyhybridcontrol_tpu.ops.condense import CondensedMpc
    from pyhybridcontrol_tpu.solver.bnb import BnbSpec

    p = DewhParams()
    m = dewh_model(p)
    N, B, T = 24, 1024, 3
    c = CondensedMpc(m, N, dewh_weights())
    nc = m.info.ncons
    c = c.with_soft_constraints([k * nc + r for k in range(N)
                                 for r in (0, 1)], lin_pen=5.0, quad_pen=1.0)
    qp, admm = c.device_qp(), prepare_admm_mpc(c)
    step = make_mpc_step_batch(
        m, qp, admm, bnb_spec=BnbSpec(capacity=1024, wave_size=1024,
                                      max_waves=1024, qp_iters=150,
                                      probe_patience=3),
        pool_slots=8 * B, admm_probe=prepare_admm_mpc(c, rho=10.0))
    draws = (0.5 * (rng.uniform(0, 1, (B, T + N, 1)) < 0.25)
             ).astype(np.float32)
    prices = dewh_energy_price_seq(np.full(T + N, 0.15), p,
                                   nv=m.info.nv).astype(np.float32)
    x0s = np.tile(np.array([55.0, 0.0], np.float32), (B, 1))
    x0s[:, 0] += rng.uniform(-3, 3, B).astype(np.float32)
    t0 = time.perf_counter()
    rf = jax.block_until_ready(closed_loop_batch(
        m, step, jnp.asarray(x0s), T, omega_trajs=jnp.asarray(draws),
        price_traj=jnp.asarray(prices)))
    log("4 main", solve="DEWH fleet closed_loop_batch", units=B, steps=T,
        N=N, found_frac=float(jnp.mean(rf.found)),
        finite=bool(jnp.all(jnp.isfinite(rf.xs))),
        wall_s=time.perf_counter() - t0)
    check(bool(jnp.all(rf.found)), "DEWH fleet found everywhere")
    check(bool(jnp.all(jnp.isfinite(rf.xs))), "DEWH fleet finite")


# ---- phase 5 ------------------------------------------------------------

def _test_module(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_goldens():
    from pyhybridcontrol_tpu.models.double_integrator import (
        default_weights, switched_double_integrator)
    from pyhybridcontrol_tpu.ops.admm import prepare_admm_mpc
    from pyhybridcontrol_tpu.ops.condense import CondensedMpc

    g = _test_module("test_goldens")
    cl = _test_module("test_closed_loop")
    model = switched_double_integrator()
    c = CondensedMpc(model, 6, default_weights())
    ctrl1 = (model, c, c.device_qp(), prepare_admm_mpc(c))
    for label, fn in (
            ("config1", lambda: cl.test_golden_trajectory_regression(ctrl1)),
            ("config2 big-M", g.test_golden_config2_pwa),
            ("config2 hull", g.test_golden_config2_pwa_hull),
            ("config3", g.test_golden_config3_thermal_uc),
            ("DEWH loop", g.test_golden_dewh_loop)):
        t0 = time.perf_counter()
        fn()                       # asserts at the test's tolerances
        log("5 goldens", golden=label, match=True,
            wall_s=time.perf_counter() - t0)


# ---- phase 6 ------------------------------------------------------------

def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"
    return env


def _run_cli(*args):
    out = subprocess.run(
        [sys.executable, "-m", "pyhybridcontrol_tpu.run",
         "--config", "double_integrator", *args],
        capture_output=True, text=True, env=_child_env(), timeout=600)
    check(out.returncode == 0, f"run {args}: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def phase_processes():
    plain = _run_cli("--steps", "3")
    log("6 processes", surface="run", **plain)
    check(plain["found_frac"] == 1.0, "run: found")
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "study.ckpt")
        first = _run_cli("--steps", "2", "--checkpoint", ck,
                         "--checkpoint-every", "2")
        rest = _run_cli("--steps", "3", "--checkpoint", ck,
                        "--checkpoint-every", "2", "--resume")
    total = first["total_cost"] + rest["total_cost"]
    log("6 processes", surface="run checkpoint+resume",
        resumed_from=rest["resumed_from"], total_cost=total,
        plain_total_cost=plain["total_cost"])
    check(rest["resumed_from"] == 2 and rest["steps"] == 1, "resume point")
    check(abs(total - plain["total_cost"])
          <= 1e-3 * max(1.0, abs(plain["total_cost"])), "resume total")

    proc = subprocess.Popen(
        [sys.executable, "-m", "pyhybridcontrol_tpu.serve",
         "--config", "double_integrator"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_child_env())
    try:
        def ask(req):
            proc.stdin.write(json.dumps(req) + "\n")
            proc.stdin.flush()
            return json.loads(proc.stdout.readline())

        ready = json.loads(proc.stdout.readline())
        check(ready.get("platform") == "gpu", f"serve ready: {ready}")
        check(ask({"cmd": "ping"}).get("pong"), "serve ping")
        one = ask({"x": [1.0, -0.5]})
        two = ask({"x": [[1.0, -0.5], [0.2, 0.7]]})
        proc.stdin.write('{"cmd": "quit"}\n')
        proc.stdin.flush()
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log("6 processes", surface="serve", ready=ready, single=one,
        batch=two, rc=rc)
    check(rc == 0 and one["found"] and all(two["found"]), "serve answers")
    check(abs(two["obj"][0] - one["obj"]) <= 1e-3 * (1 + abs(one["obj"])),
          "serve: batched row equals the single solve")


# ---- --multi --------------------------------------------------------------

def phase_multi():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pyhybridcontrol_tpu.models.pwa_examples import (
        pwa_spring_mld, pwa_weights)
    from pyhybridcontrol_tpu.ops.admm import prepare_admm_mpc
    from pyhybridcontrol_tpu.ops.condense import CondensedMpc
    from pyhybridcontrol_tpu.parallel import (
        make_mesh, solve_miqp_bnb_sharded)
    from pyhybridcontrol_tpu.solver.bnb import BnbSpec, solve_miqp_bnb
    from pyhybridcontrol_tpu.solver.repair import (
        prepare_repair, root_repair_incumbent)

    ndev = 4
    # config 5: one hard MIQP, its node pool split over the cards
    model, w = pwa_spring_mld(on_off=True), pwa_weights()
    c = CondensedMpc(model, 14, w)
    qp, admm = c.device_qp(), prepare_admm_mpc(c)
    x0 = jnp.asarray([1.5, 0.0], jnp.float32)
    f, h = qp.assemble(x0)
    seed = root_repair_incumbent(admm, qp, prepare_repair(model, w), x0,
                                 f, h, qp_iters=300)
    mesh = make_mesh([("pool", ndev)])
    per_card = BnbSpec(capacity=1024, wave_size=64 * ndev, max_waves=40,
                       qp_iters=300)
    t0 = time.perf_counter()
    rs = jax.block_until_ready(solve_miqp_bnb_sharded(
        admm, qp, f, h, per_card, mesh, init_incumbent=seed))
    t_sh = time.perf_counter() - t0
    single = BnbSpec(capacity=1024 * ndev, wave_size=64 * ndev,
                     max_waves=40, qp_iters=300)
    t0 = time.perf_counter()
    r1 = jax.block_until_ready(solve_miqp_bnb(admm, qp, f, h, single,
                                              init_incumbent=seed))
    t_1 = time.perf_counter() - t0
    rel = abs(float(rs.obj) - float(r1.obj)) / max(1.0, abs(float(r1.obj)))
    log("M config5", mesh="pool x4", slots_per_card=1024,
        found=bool(rs.found), obj=float(rs.obj), nodes=int(rs.nodes_solved),
        single_card_obj=float(r1.obj), single_card_slots=1024 * ndev,
        rel_gap=rel, wall_s_sharded=t_sh, wall_s_single=t_1)
    check(bool(rs.found) and bool(r1.found), "config 5 found")
    check(rel <= 1e-3, "config 5: sharded incumbent equals single card")

    # scenario-sharded batch vs the single-card vmap engine
    from pyhybridcontrol_tpu.control.mpc import MpcController
    from pyhybridcontrol_tpu.models.double_integrator import (
        default_weights, switched_double_integrator)

    ctrl = MpcController(switched_double_integrator(), 10,
                         default_weights(),
                         bnb_spec=BnbSpec(capacity=64, wave_size=16,
                                          max_waves=24, qp_iters=100))
    rng = np.random.default_rng(5)
    xs = jnp.asarray(rng.normal(size=(1024, 2)).astype(np.float32))
    smesh = make_mesh([("scen", ndev)])
    t0 = time.perf_counter()
    rm = jax.block_until_ready(ctrl.feedback_batch(xs, mesh=smesh))
    t_m = time.perf_counter() - t0
    r1 = jax.block_until_ready(ctrl.feedback_batch(xs, engine="vmap"))
    d_obj = float(jnp.max(jnp.abs(rm.obj - r1.obj)
                          / jnp.maximum(1.0, jnp.abs(r1.obj))))
    log("M scenarios", mesh="scen x4", batch=1024,
        found_frac=float(jnp.mean(rm.found)), max_rel_obj_gap=d_obj,
        same_found=bool(jnp.all(rm.found == r1.found)), wall_s=t_m)
    check(d_obj <= 1e-3 and bool(jnp.all(rm.found == r1.found)),
          "scenario-sharded batch equals the single-card batch")

    stats = [d.memory_stats() or {} for d in jax.devices()[:ndev]]
    in_use = [m.get("bytes_in_use", 0) for m in stats]
    log("M memory", bytes_in_use=in_use,
        peak_bytes_in_use=[m.get("peak_bytes_in_use", 0) for m in stats])
    check(all(b > 0 for b in in_use), "every card holds work")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: the sharded paths and their "
                         "single-card counterparts only")
    args = ap.parse_args(argv)
    # allocate on demand, so the children of phase 6 can open the card
    os.environ.setdefault("XLA_PYTHON_CLIENT_PREALLOCATE", "false")
    dev = gpu_device()
    import jax

    from pyhybridcontrol_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    card = card_line()
    print(f"card: {card} | jax {jax.__version__} | XLA_FLAGS="
          f"{os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    t0 = time.perf_counter()
    if args.multi:
        phase_device(dev, 4)
        phase_multi()
    else:
        phase_device(dev, 1)
        phase_recipe()
        phase_relaxation(card)
        phase_main_path()
        phase_goldens()
        phase_processes()
    print(f"card: {card} | all phases passed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
