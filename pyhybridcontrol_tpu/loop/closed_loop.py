"""Receding-horizon closed-loop engine (SURVEY.md §3.4 redesigned):
the reference's per-step Python loop (feedback → Gurobi → apply → log)
becomes ONE jitted device program — a ``lax.scan`` over control steps with
the MIQP solver (B&B or enumeration) inlined — and batches over scenarios
with ``vmap`` (BASELINE config 4: 1024 instances/chip). The host only
supplies x0/disturbances and reads back stacked logs.

Logs are device arrays stacked over time (SURVEY.md §5 observability):
state/input/δ/z trajectories, per-step MIQP objective, node counts.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from pyhybridcontrol_tpu.mld.model import MldModel
from pyhybridcontrol_tpu.ops.admm import BoxQP
from pyhybridcontrol_tpu.ops.condense import DeviceQP
from pyhybridcontrol_tpu.solver.bnb import BnbSpec, solve_miqp_bnb
from pyhybridcontrol_tpu.solver.enumerate import (
    _all_assignments, _enumerate_solve)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ClosedLoopResult:
    xs: jnp.ndarray        # (T+1, nx) state trajectory
    vs: jnp.ndarray        # (T, nv) applied per-step decision [u; δ; z]
    ys: jnp.ndarray        # (T, ny) outputs
    objs: jnp.ndarray      # (T,) per-step MIQP objective (no offset)
    found: jnp.ndarray     # (T,) solver reported a feasible incumbent
    nodes: jnp.ndarray     # (T,) B&B nodes solved (0 for enumeration)
    # final carried plan (warm-start state): pass as ``prev_plan`` when
    # resuming a chunked/checkpointed study so the resumed trajectory
    # is bit-identical to the uninterrupted one. (plan, plan_ok) are
    # zeros/False when the step does not carry a plan.
    plan: jnp.ndarray      # (n,) last solved decision vector
    plan_ok: jnp.ndarray   # () bool


def make_mpc_step(model: MldModel, qp: DeviceQP, admm: BoxQP,
                  method: str = "bnb",
                  bnb_spec: Optional[BnbSpec] = None,
                  qp_iters: int = 100,
                  repair=None, shift_warm: bool = True,
                  admm_probe=None) -> Callable:
    """Build the single-control-step function
    ``step(x, W, price_seq, u_prev[, prev]) ->
    (v_seq (N,nv), obj, found, nodes, V)``.

    ``method``: "bnb" (device B&B) or "enumerate" (exact, 2^nb batched QPs).
    ``repair``: optional (RepairSpec, layout) — seeds the B&B incumbent
    with the greedy rollout-repair heuristic (solver/repair.py).
    ``shift_warm``: receding-horizon warm start (SURVEY.md §3.3) — when
    the previous step's solution ``prev=(V, ok)`` is supplied (the
    ``closed_loop`` scan carries it), the previous plan's binary
    assignment shifted one stage (permuted by ``qp.binary_shift``;
    identity under move blocking, where a one-stage shift is not
    representable) is injected as a fully-fixed wave-1 B&B node: its
    relaxation is the fixed-binary re-optimization, the probe turns it
    into an incumbent, and no extra QP solve happens — zero marginal
    cost per step. Pure jnp — jit/vmap/scan/shard_map composable.
    """
    spec = bnb_spec or BnbSpec()
    if method == "enumerate":
        assignments = jnp.asarray(_all_assignments(qp.n_binary))
    if repair is not None:
        from pyhybridcontrol_tpu.solver.repair import root_repair_incumbent
    use_shift = (method == "bnb" and shift_warm
                 and qp.n_binary > 0
                 and len(qp.binary_shift) == qp.n_binary)

    def step(x, W=None, price_seq=None, u_prev=None, prev=None):
        f, h = qp.assemble(x, W, u_prev, price_seq)
        if method == "bnb":
            seed = None
            init_node = None
            if repair is not None:
                rspec, layout = repair
                seed = root_repair_incumbent(
                    admm, qp, rspec, x, f, h, W=W, price_seq=price_seq,
                    qp_iters=spec.qp_iters, layout=layout,
                    feas_tol=spec.feas_tol)
            if use_shift and prev is not None:
                Vp, okp = prev
                bidx = jnp.asarray(qp.binary_idx)
                bprev = jnp.round(jnp.clip(Vp[bidx], 0.0, 1.0))
                bvals = bprev[jnp.asarray(qp.binary_shift)]
                init_node = (bvals, okp, Vp)
            res = solve_miqp_bnb(admm, qp, f, h, spec,
                                 init_incumbent=seed,
                                 init_node=init_node,
                                 admm_probe=admm_probe)
            v_seq = qp.full_v(res.x)
            return v_seq, res.obj, res.found, res.nodes_solved, res.x
        elif method == "enumerate":
            xV, obj, _, feas = _enumerate_solve(
                admm, qp, f, h, assignments, iters=qp_iters)
            v_seq = qp.full_v(xV)
            return (v_seq, obj, jnp.any(feas), jnp.asarray(0, jnp.int32),
                    xV)
        else:
            raise ValueError(f"unknown method {method!r}")

    step.carries_plan = use_shift
    step.n_dec = qp.n
    return step


@partial(jax.jit, static_argnames=("mpc_step", "T", "carries_plan"))
def _closed_loop_scan(model: MldModel, mpc_step, x0, T: int,
                      omega_traj, price_traj, u_prev0,
                      carries_plan: bool = False, plan0=None):
    info = model.info

    def body(carry, k):
        x, u_prev = carry[0], carry[1]
        W = (jax.lax.dynamic_slice_in_dim(omega_traj, k, omega_traj.shape[0] - T)
             if omega_traj is not None else None)
        P = (jax.lax.dynamic_slice_in_dim(price_traj, k, price_traj.shape[0] - T)
             if price_traj is not None else None)
        if carries_plan:
            out = mpc_step(x, W, P, u_prev, prev=(carry[2], carry[3]))
        else:
            out = mpc_step(x, W, P, u_prev)
        v_seq, obj, found, nodes = out[:4]
        v0 = v_seq[0]
        u, d, z = info.split_v(v0)
        w_k = omega_traj[k] if omega_traj is not None else None
        y = model.output(x, u, d, z, w_k)
        x_next = model.step(x, u, d, z, w_k)
        new_carry = (x_next, u)
        if carries_plan:
            new_carry += (out[4], found)
        return new_carry, (x_next, v0, y, obj, found, nodes)

    carry0 = (x0, u_prev0)
    if carries_plan:
        carry0 += (plan0 if plan0 is not None
                   else (jnp.zeros((mpc_step.n_dec,), x0.dtype),
                         jnp.asarray(False)))
    carryT, (xs, vs, ys, objs, found, nodes) = jax.lax.scan(
        body, carry0, jnp.arange(T))
    xs = jnp.concatenate([x0[None], xs], axis=0)
    if carries_plan:
        plan, plan_ok = carryT[2], carryT[3]
    else:
        plan, plan_ok = jnp.zeros((0,), x0.dtype), jnp.asarray(False)
    return ClosedLoopResult(xs=xs, vs=vs, ys=ys, objs=objs, found=found,
                            nodes=nodes, plan=plan, plan_ok=plan_ok)


def make_mpc_step_batch(model: MldModel, qp: DeviceQP, admm: BoxQP,
                        bnb_spec: Optional[BnbSpec] = None,
                        pool_slots: int = 0,
                        admm_probe=None,
                        shift_warm: bool = True) -> Callable:
    """Batched control step over B scenarios through the POOLED
    multi-instance B&B (solver/bnb_pooled.py) — the closed-loop form of
    the config-4 engine: per step, ALL B instances' nodes share one
    global pool and every wave is one batched solve, instead of
    B lock-stepped per-instance searches under vmap.

    ``step(xs (B,nx), Ws (B,N,nω)|None, price_seq (N,nv)|None,
    u_prevs (B,nu)|None, prev=(V (B,n), ok (B,))|None) →
    (v0 (B,nv), obj, found, nodes, V)``. ``prev`` injects each
    instance's previous plan, binaries shifted one stage, as a
    fully-fixed wave-1 node (the carried-plan warm start — SURVEY.md
    §3.3; zero marginal QP cost)."""
    from pyhybridcontrol_tpu.solver.bnb_pooled import solve_miqp_bnb_pooled

    spec = bnb_spec or BnbSpec()
    use_shift = (shift_warm and qp.n_binary > 0
                 and len(qp.binary_shift) == qp.n_binary)

    def step(xs, Ws=None, price_seq=None, u_prevs=None, prev=None):
        def one(x, W, up):
            return qp.assemble(x, W, up, price_seq)

        in_axes = (0, None if Ws is None else 0,
                   None if u_prevs is None else 0)
        f, h = jax.vmap(one, in_axes=in_axes)(xs, Ws, u_prevs)
        init_node = None
        if use_shift and prev is not None:
            Vp, okp = prev                              # (B, n), (B,)
            bidx = jnp.asarray(qp.binary_idx)
            bprev = jnp.round(jnp.clip(Vp[:, bidx], 0.0, 1.0))
            bvals = bprev[:, jnp.asarray(qp.binary_shift)]
            init_node = (bvals, okp, Vp)
        res = solve_miqp_bnb_pooled(admm, qp, f, h, spec,
                                    pool_slots=pool_slots,
                                    init_node=init_node,
                                    admm_probe=admm_probe)
        v_seq = jax.vmap(qp.full_v)(res.x)              # (B, N, nv)
        return (v_seq[:, 0], res.obj, res.found, res.nodes_solved,
                res.x)

    step.carries_plan = use_shift
    step.n_dec = qp.n
    return step


@partial(jax.jit, static_argnames=("step_batch", "T"))
def closed_loop_batch(model: MldModel, step_batch, x0s, T: int,
                      omega_trajs=None, price_traj=None
                      ) -> ClosedLoopResult:
    """T-step receding-horizon simulation of B scenarios fully on
    device with the POOLED per-step engine (``make_mpc_step_batch``) —
    the chip-scale closed-LOOP study (BASELINE config 4 run through
    time instead of single-shot). x0s (B, nx); ``omega_trajs``
    (B, T+N, nω) per-scenario actual disturbances (perfect next-N
    forecast); ``price_traj`` (T+N, nv) shared. Logs are stacked
    (T, B, …); ``nodes`` is the GLOBAL pooled node count per step."""
    info = model.info
    B = x0s.shape[0]
    carries = bool(getattr(step_batch, "carries_plan", False))

    def body(carry, k):
        x, u_prev = carry[0], carry[1]
        Ws = (jax.lax.dynamic_slice_in_dim(
            omega_trajs, k, omega_trajs.shape[1] - T, axis=1)
            if omega_trajs is not None else None)
        P = (jax.lax.dynamic_slice_in_dim(
            price_traj, k, price_traj.shape[0] - T)
            if price_traj is not None else None)
        prev = (carry[2], carry[3]) if carries else None
        v0, obj, found, nodes, V = step_batch(x, Ws, P, u_prev,
                                              prev=prev)
        u, d, z = jax.vmap(info.split_v)(v0)
        w_k = omega_trajs[:, k] if omega_trajs is not None else None
        w_ax = None if w_k is None else 0
        y = jax.vmap(model.output, in_axes=(0, 0, 0, 0, w_ax))(
            x, u, d, z, w_k)
        x_next = jax.vmap(model.step, in_axes=(0, 0, 0, 0, w_ax))(
            x, u, d, z, w_k)
        new_carry = (x_next, u)
        if carries:
            new_carry += (V, found)
        return new_carry, (x_next, v0, y, obj, found, nodes)

    u_prev0 = jnp.zeros((B, info.nu), x0s.dtype)
    carry0 = (x0s, u_prev0)
    if carries:
        carry0 += (jnp.zeros((B, step_batch.n_dec), x0s.dtype),
                   jnp.zeros((B,), bool))
    carryT, (xs, vs, ys, objs, found, nodes) = jax.lax.scan(
        body, carry0, jnp.arange(T))
    xs = jnp.concatenate([x0s[None], xs], axis=0)     # (T+1, B, nx)
    if carries:
        plan, plan_ok = carryT[2], carryT[3]
    else:
        plan = jnp.zeros((0,), x0s.dtype)
        plan_ok = jnp.asarray(False)
    return ClosedLoopResult(xs=xs, vs=vs, ys=ys, objs=objs, found=found,
                            nodes=nodes, plan=plan, plan_ok=plan_ok)


def closed_loop(model: MldModel, mpc_step, x0, T: int,
                omega_traj=None, price_traj=None,
                u_prev0=None, prev_plan=None) -> ClosedLoopResult:
    """Run a T-step receding-horizon simulation fully on device.

    ``omega_traj``: (T+N, nomega) actual disturbances — the controller
    sees the next-N window at each step (perfect forecast; pass a
    different forecast model by wrapping ``mpc_step``).
    ``price_traj``: (T+N, nv) per-step linear cost sequence (e.g. TOU
    tariffs on selected v entries).
    When ``mpc_step`` was built with ``shift_warm`` (the default for
    B&B steps from :func:`make_mpc_step`), each step's MIQP is seeded
    with the previous step's plan shifted one stage — the scan carries
    the plan; ``prev_plan=(V, ok)`` optionally seeds step 0 (e.g. when
    resuming a chunked study).
    Batched scenarios: vmap over x0 / omega_traj leading axes.
    """
    if u_prev0 is None:
        u_prev0 = jnp.zeros((model.info.nu,),
                            x0.dtype if hasattr(x0, "dtype") else jnp.float32)
    carries = bool(getattr(mpc_step, "carries_plan", False))
    plan0 = None
    if carries and prev_plan is not None:
        V0, ok0 = prev_plan
        plan0 = (jnp.asarray(V0).astype(
                     x0.dtype if hasattr(x0, "dtype") else jnp.float32),
                 jnp.asarray(ok0))
    return _closed_loop_scan(model, mpc_step, x0, T, omega_traj,
                             price_traj, u_prev0, carries_plan=carries,
                             plan0=plan0)
