"""CLI runner:  python -m pyhybridcontrol_tpu.run --config <name>
[--steps T] [--batch B] [--log out.jsonl] [--checkpoint ckpt.bin]
[--checkpoint-every K] [--resume] [--solver bnb|enumerate] [--cpu]

Runs one BASELINE benchmark config end-to-end (closed loop or batched
solve), prints per-run metrics, optionally writes structured logs and a
final checkpoint (SURVEY.md §5 config/flag system).

Long studies: ``--checkpoint ckpt --checkpoint-every K`` snapshots the
loop state (x_k, u_prev, step) every K control steps; re-running with
``--resume`` continues from the snapshot — the SURVEY.md §5
checkpoint/resume story at the CLI surface (recovery granularity = K
steps; each chunk is one device program).
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pyhybridcontrol_tpu.run")
    ap.add_argument("--config", required=True)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--solver", default="bnb",
                    choices=["bnb", "enumerate"])
    ap.add_argument("--log", default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="snapshot loop state every K steps (needs "
                         "--checkpoint; enables --resume)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the --checkpoint snapshot")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (8 virtual devices); without it "
                         "the run refuses a CPU-only JAX")
    args = ap.parse_args(argv)

    if args.cpu:
        import os

        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from pyhybridcontrol_tpu.utils.runtime import (
        enable_compile_cache, require_accelerator)

    require_accelerator(allow_cpu=args.cpu)
    enable_compile_cache()

    import jax.numpy as jnp
    import numpy as np

    from pyhybridcontrol_tpu.configs import get_config
    from pyhybridcontrol_tpu.control.mpc import MpcController
    from pyhybridcontrol_tpu.io.logging import StructuredLog
    from pyhybridcontrol_tpu.loop import closed_loop, make_mpc_step
    from pyhybridcontrol_tpu.models.dewh import min_up_down_rows

    cfg = get_config(args.config)
    T = args.steps or cfg.T
    B = args.batch or cfg.batch
    model, ckw = cfg.build()

    ctrl = MpcController(model, cfg.N, solver=args.solver, bnb_spec=cfg.bnb,
                         qp_iters=cfg.bnb.qp_iters, **ckw)
    if cfg.soft_rows:
        ctrl.set_soft_constraints(list(cfg.soft_rows), lin_pen=5.0,
                                  quad_pen=1.0)
    if cfg.move_blocking:
        ctrl.set_move_blocking(list(cfg.move_blocking))
    if cfg.name == "thermal_uc":
        A_v, b = min_up_down_rows(cfg.N, model.info.nv, min_up=2)
        if len(b):
            ctrl.set_extra_constraints(A_v, b)
    ctrl.build()

    step = make_mpc_step(model, ctrl.device_qp, ctrl.admm,
                         method=args.solver, bnb_spec=cfg.bnb,
                         qp_iters=cfg.bnb.qp_iters, repair=ctrl.repair,
                         admm_probe=ctrl.admm_probe)

    rng = np.random.default_rng(0)
    nx = model.info.nx
    if cfg.name.startswith("thermal"):
        x0 = np.tile([55.0, 0.0], nx // 2)[:nx]
    else:
        x0 = rng.uniform(-2, 2, size=nx)
    x0 = jnp.asarray(x0, jnp.float32)

    t0 = time.perf_counter()
    if B > 1:
        x0s = jnp.asarray(rng.uniform(-2, 2, size=(B, nx)).astype(np.float32))
        run = jax.jit(jax.vmap(lambda x: closed_loop(model, step, x, T)))
        res = run(x0s)
        res.objs.block_until_ready()
        wall = time.perf_counter() - t0
        n_solves = B * T
        print(json.dumps({
            "config": cfg.name, "batch": B, "steps": T,
            "wall_s": round(wall, 3),
            "miqp_solves_per_s": round(n_solves / wall, 1),
            "found_frac": float(np.mean(np.asarray(res.found))),
        }))
    elif args.checkpoint_every and args.checkpoint:
        import os as _os

        from pyhybridcontrol_tpu.io.checkpoint import (
            load_checkpoint, save_checkpoint)
        from pyhybridcontrol_tpu.loop.closed_loop import ClosedLoopResult

        info = model.info
        n_plan = step.n_dec if getattr(step, "carries_plan", False) else 0
        k0, u_prev, plan = 0, None, None
        if args.resume and _os.path.exists(args.checkpoint):
            target = {"u_prev": jnp.zeros(info.nu, jnp.float32),
                      "x": jnp.zeros(info.nx, jnp.float32),
                      "plan": jnp.zeros(n_plan, jnp.float32),
                      "plan_ok": jnp.asarray(False)}
            state, k0, _meta = load_checkpoint(args.checkpoint, target)
            x0 = jnp.asarray(state["x"])
            u_prev = jnp.asarray(state["u_prev"])
            if n_plan:
                plan = (state["plan"], state["plan_ok"])
        if k0 >= T:
            print(json.dumps({"config": cfg.name, "steps": 0,
                              "resumed_from": k0,
                              "note": "study already complete"}))
            return
        chunks = []
        k = k0
        while k < T:
            kk = min(args.checkpoint_every, T - k)
            r = closed_loop(model, step, x0, kk, u_prev0=u_prev,
                            prev_plan=plan)
            r.objs.block_until_ready()
            chunks.append(r)
            x0 = r.xs[-1]
            u_prev = r.vs[-1][info.u_slice]
            if n_plan:
                plan = (r.plan, r.plan_ok)
            k += kk
            save_checkpoint(args.checkpoint,
                            {"u_prev": u_prev, "x": x0,
                             "plan": (r.plan if n_plan else
                                      jnp.zeros(0, jnp.float32)),
                             "plan_ok": r.plan_ok}, step=k,
                            metadata={"config": cfg.name, "T": T})
        res = ClosedLoopResult(
            xs=jnp.concatenate([chunks[0].xs]
                               + [r.xs[1:] for r in chunks[1:]]),
            vs=jnp.concatenate([r.vs for r in chunks]),
            ys=jnp.concatenate([r.ys for r in chunks]),
            objs=jnp.concatenate([r.objs for r in chunks]),
            found=jnp.concatenate([r.found for r in chunks]),
            nodes=jnp.concatenate([r.nodes for r in chunks]),
            plan=chunks[-1].plan, plan_ok=chunks[-1].plan_ok)
        wall = time.perf_counter() - t0
        print(json.dumps({
            "config": cfg.name, "steps": T - k0, "resumed_from": k0,
            "wall_s": round(wall, 3),
            "found_frac": float(np.mean(np.asarray(res.found))),
            "total_cost": float(np.sum(np.asarray(res.objs))),
            "mean_nodes": float(np.mean(np.asarray(res.nodes))),
        }))
    else:
        res = closed_loop(model, step, x0, T)
        res.objs.block_until_ready()
        wall = time.perf_counter() - t0
        print(json.dumps({
            "config": cfg.name, "steps": T, "wall_s": round(wall, 3),
            "ms_per_control_step": round(1e3 * wall / T, 2),
            "found_frac": float(np.mean(np.asarray(res.found))),
            "total_cost": float(np.sum(np.asarray(res.objs))),
            "mean_nodes": float(np.mean(np.asarray(res.nodes))),
        }))

    if args.log:
        log = StructuredLog(args.log, run_name=cfg.name)
        if B == 1:
            log.log_closed_loop(res)
        log.close()
    if args.checkpoint and not args.checkpoint_every:
        # (in --checkpoint-every mode the file holds the RESUME state
        # snapshot, which must not be overwritten by the result pytree)
        from pyhybridcontrol_tpu.io.checkpoint import save_checkpoint

        save_checkpoint(args.checkpoint, res, step=T,
                        metadata={"config": cfg.name})


if __name__ == "__main__":
    main()
