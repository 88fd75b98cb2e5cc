"""Agent layer (reference L3, SURVEY.md §2a/§3.4): an Agent binds a
simulation model + control model + controller; the receding-horizon loop
is  measure x_k → feedback → apply u_k → step dynamics → log.

Two execution modes, per the device-first design:

  * interactive host loop (``sim_step`` / ``run``) — reference-style
    step-at-a-time control with pandas history logging, for studies that
    inspect or intervene mid-run;
  * compiled device loop (``run_compiled``) — delegates to
    ``loop.closed_loop`` (one scan program; use for long horizons and
    batched scenario studies).

History is kept as stacked arrays and exported to a pandas DataFrame with
a DatetimeIndex at the control period Ts (the reference's time-series
handling, SURVEY.md §2a).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from pyhybridcontrol_tpu.control.mpc import MpcController
from pyhybridcontrol_tpu.loop.closed_loop import closed_loop, make_mpc_step
from pyhybridcontrol_tpu.mld.model import MldModel
from pyhybridcontrol_tpu.utils.structdict import StructDict


class Agent:
    """Identity + simulation model."""

    _count = 0

    def __init__(self, sim_model: MldModel, name: Optional[str] = None):
        Agent._count += 1
        self.name = name or f"agent_{Agent._count}"
        self.sim_model = sim_model
        self.x = jnp.zeros(sim_model.info.nx)
        self.k = 0
        self._hist = []

    def reset(self, x0):
        self.x = jnp.asarray(x0, jnp.float32)
        self.k = 0
        self._hist = []

    def record(self, **kw):
        self._hist.append(dict(k=self.k, **kw))

    def history(self, Ts: Optional[float] = None, t0=None):
        """Sim log as pandas DataFrame (DatetimeIndex when Ts given)."""
        import pandas as pd

        if not self._hist:
            return pd.DataFrame()
        rows = []
        for rec in self._hist:
            row = {}
            for key, val in rec.items():
                a = np.asarray(val)
                if a.ndim == 0:
                    row[key] = a.item()
                else:
                    for i, v in enumerate(a.reshape(-1)):
                        row[f"{key}{i}"] = float(v)
            rows.append(row)
        df = pd.DataFrame(rows)
        if Ts is not None:
            start = t0 or "2020-01-01"
            df.index = pd.date_range(start=start, periods=len(df),
                                     freq=f"{int(Ts)}s")
        return df


class ControlledAgent(Agent):
    """Agent + control model (may differ from the simulation model —
    e.g. control on the nominal model, simulate with disturbances)."""

    def __init__(self, sim_model: MldModel,
                 control_model: Optional[MldModel] = None,
                 name: Optional[str] = None):
        super().__init__(sim_model, name)
        self.control_model = control_model or sim_model


class MpcAgent(ControlledAgent):
    def __init__(self, sim_model: MldModel, controller: MpcController,
                 control_model: Optional[MldModel] = None,
                 name: Optional[str] = None):
        super().__init__(sim_model, control_model, name)
        ci, si = controller.model.info, sim_model.info
        # the controller's plan (u, δ, z) is applied verbatim to the sim
        # model, and the sim state is handed back — dims must line up
        # (shape coincidences otherwise make wrong pairings run silently)
        if (ci.nx, ci.nu, ci.ndelta, ci.nz) != (si.nx, si.nu, si.ndelta,
                                                si.nz):
            raise ValueError(
                f"controller model dims (nx,nu,nδ,nz)="
                f"{(ci.nx, ci.nu, ci.ndelta, ci.nz)} do not match sim "
                f"model {(si.nx, si.nu, si.ndelta, si.nz)}")
        self.controller = controller
        self._u_prev = None

    def feedback(self, omega_forecast=None, price_seq=None) -> StructDict:
        """Solve the MIQP at the current state → planned decision."""
        return self.controller.feedback(
            self.x, omega_forecast=omega_forecast, price_seq=price_seq,
            u_prev=self._u_prev)

    def sim_step(self, omega_k=None, omega_forecast=None, price_seq=None
                 ) -> StructDict:
        """One receding-horizon step: feedback → apply → advance → log."""
        sol = self.feedback(omega_forecast, price_seq)
        w = jnp.asarray(omega_k, jnp.float32) if omega_k is not None else None
        y = self.sim_model.output(self.x, sol.u, sol.delta, sol.z, w)
        x_next = self.sim_model.step(self.x, sol.u, sol.delta, sol.z, w)
        self.record(x=self.x, u=sol.u, delta=sol.delta, z=sol.z, y=y,
                    obj=sol.obj, found=sol.found, omega=omega_k)
        self.x = x_next
        self.k += 1
        self._u_prev = sol.u
        return sol

    def run(self, T: int, omega_traj=None, price_traj=None,
            Ts: Optional[float] = None):
        """Host-loop simulation for T steps (reference-style)."""
        N = self.controller.N
        for _ in range(T):
            k = self.k
            w_k = omega_traj[k] if omega_traj is not None else None
            W = (omega_traj[k : k + N] if omega_traj is not None else None)
            Pq = (price_traj[k : k + N] if price_traj is not None else None)
            self.sim_step(w_k, W, Pq)
        return self.history(Ts)

    def run_compiled(self, T: int, omega_traj=None, price_traj=None):
        """Whole-trajectory device loop (loop.closed_loop)."""
        ctrl = self.controller
        ctrl.build()
        step = make_mpc_step(
            self.control_model, ctrl.device_qp, ctrl.admm,
            method=ctrl.solver if ctrl.solver in ("bnb", "enumerate")
            else "bnb",
            bnb_spec=ctrl.bnb_spec, qp_iters=ctrl.qp_iters)
        res = closed_loop(
            self.sim_model, step, jnp.asarray(self.x, jnp.float32), T,
            omega_traj=None if omega_traj is None
            else jnp.asarray(omega_traj, jnp.float32),
            price_traj=None if price_traj is None
            else jnp.asarray(price_traj, jnp.float32))
        return res
