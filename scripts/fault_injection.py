"""Fault-injection test (SURVEY.md §5 failure detection / recovery):
a 2-process closed-loop study with the per-step MIQP pool-sharded over
both processes' devices. Worker 1 is killed mid-study; the launcher
restarts both workers, which resume from the last per-step checkpoint,
and the final trajectory must match an uninterrupted single-process
reference exactly.

Run:  python scripts/fault_injection.py
Exit 0 iff the resumed distributed trajectory matches the reference.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _repo not in sys.path:
    sys.path.insert(0, _repo)

PORT = int(os.environ.get("FAULT_PORT", "12387"))
LOCAL_DEVICES = 2
T_TOTAL = 5
FAULT_STEP = 2
CKPT = os.path.join(tempfile.gettempdir(), "hybrid_mpc_fault_ck")
REF = os.path.join(tempfile.gettempdir(), "hybrid_mpc_fault_ref.json")
TRAJ = os.path.join(tempfile.gettempdir(), "fault_traj_dist.json")


def _build():
    import jax.numpy as jnp

    from pyhybridcontrol_tpu.models.double_integrator import (
        default_weights, switched_double_integrator)
    from pyhybridcontrol_tpu.ops.admm import prepare_admm_mpc
    from pyhybridcontrol_tpu.ops.condense import CondensedMpc

    model = switched_double_integrator()
    c = CondensedMpc(model, 6, default_weights())
    return model, c.device_qp(), prepare_admm_mpc(c)


def worker(process_id, num_processes, fault: bool, resume: bool) -> int:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={LOCAL_DEVICES}"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(f"localhost:{PORT}", num_processes,
                               process_id)
    import jax.numpy as jnp
    import numpy as np

    from pyhybridcontrol_tpu.io.checkpoint import (
        load_checkpoint, save_checkpoint)
    from pyhybridcontrol_tpu.parallel import make_mesh, solve_miqp_bnb_sharded
    from pyhybridcontrol_tpu.solver.bnb import BnbSpec

    model, qp, admm = _build()
    mesh = make_mesh([("pool", num_processes * LOCAL_DEVICES)])
    spec = BnbSpec(capacity=64, wave_size=8, qp_iters=400)
    info = model.info

    k0 = 0
    x = jnp.asarray([2.0, 0.0])
    if resume and os.path.exists(CKPT + "-proc000"):
        state, k0, _ = load_checkpoint(CKPT, {"x": x, "k": jnp.asarray(0)},
                                       process_index=0)
        x = jnp.asarray(state["x"])
        print(f"[proc {process_id}] resuming from step {k0}", flush=True)

    traj = []
    for k in range(k0, T_TOTAL):
        f, h = qp.assemble(x)
        r = solve_miqp_bnb_sharded(admm, qp, f, h, spec, mesh)
        v0 = qp.full_v(r.x)[0]
        u, d, z = info.split_v(v0)
        x = model.step(x, u, d, z)
        traj.append([float(v) for v in np.asarray(jax.device_get(x))])
        if process_id == 0:
            save_checkpoint(CKPT, {"x": x, "k": jnp.asarray(k + 1)},
                            step=k + 1, process_index=0)
        if fault and k + 1 == FAULT_STEP and process_id == 1:
            print(f"[proc 1] injecting fault at step {k+1}", flush=True)
            os._exit(17)

    if process_id == 0:
        with open(TRAJ, "w") as fp:
            json.dump({"final_x": traj[-1]}, fp)
        print(f"[proc 0] final x = {traj[-1]}", flush=True)
    jax.distributed.shutdown()
    return 0


def reference() -> None:
    """Uninterrupted single-process reference trajectory."""
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={LOCAL_DEVICES}"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from pyhybridcontrol_tpu.solver.bnb import BnbSpec, solve_miqp_bnb

    model, qp, admm = _build()
    spec = BnbSpec(capacity=64, wave_size=8, qp_iters=400)
    info = model.info
    x = jnp.asarray([2.0, 0.0])
    for k in range(T_TOTAL):
        f, h = qp.assemble(x)
        r = solve_miqp_bnb(admm, qp, f, h, spec)
        v0 = qp.full_v(r.x)[0]
        u, d, z = info.split_v(v0)
        x = model.step(x, u, d, z)
    with open(REF, "w") as fp:
        json.dump({"final_x": [float(v) for v in np.asarray(x)]}, fp)
    print("[ref] final x =", [float(v) for v in np.asarray(x)], flush=True)


def _spawn(num_processes, fault, resume, timeout=240, port=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = _repo + os.pathsep + env.get("PYTHONPATH", "")
    if port is not None:
        env["FAULT_PORT"] = str(port)
    procs = []
    for k in range(num_processes):
        args = [sys.executable, os.path.abspath(__file__),
                "--process-id", str(k)]
        if fault:
            args.append("--fault")
        if resume:
            args.append("--resume")
        procs.append(subprocess.Popen(args, cwd=_repo, env=env))
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=timeout))
        except subprocess.TimeoutExpired:
            # survivor hung on a collective after its peer died — the
            # failure-detection event. Kill THIS exact child pid.
            p.kill()
            p.wait()
            rcs.append("killed-after-peer-loss")
    return rcs


def launcher() -> int:
    for f in (CKPT, CKPT + "-proc000", REF, TRAJ):
        if os.path.exists(f):
            os.unlink(f)
    # reference run (in-process)
    reference()
    # phase 1: run with fault → worker 1 dies; worker 0 may hang on the
    # collective and is killed by the launcher timeout
    rcs = _spawn(2, fault=True, resume=False, timeout=100, port=12387)
    print("phase-1 exit codes:", rcs, flush=True)
    assert 17 in rcs, "fault was not injected"
    assert os.path.exists(CKPT + "-proc000"), (
        "no checkpoint was written before fault")
    # phase 2: restart both, resume from checkpoint
    rcs = _spawn(2, fault=False, resume=True, timeout=240, port=12411)
    print("phase-2 exit codes:", rcs, flush=True)
    assert all(rc == 0 for rc in rcs), rcs
    dist = json.load(open(TRAJ))["final_x"]
    ref = json.load(open(REF))["final_x"]
    ok = all(abs(a - b) <= 1e-3 for a, b in zip(dist, ref))
    print(f"dist final {dist} vs ref {ref} → "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--fault", action="store_true")
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args()
    if args.process_id is None:
        sys.exit(launcher())
    sys.exit(worker(args.process_id, 2, args.fault, args.resume))
