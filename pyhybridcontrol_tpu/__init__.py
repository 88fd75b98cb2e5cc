"""A hybrid-MPC engine on an accelerator.

A brand-new JAX/XLA framework with the capabilities of
``michchr/pyhybridcontrol`` (MLD modeling + receding-horizon MIQP control,
per SURVEY.md; the reference mount is empty so parity is specified against
SURVEY.md [LIT]/[BASELINE] and the in-repo exact oracle).

Layer map (bottom → top, SURVEY.md §1):

    L0  utils/      StructDict pytree, matrix block assembly, caching
    L1  mld/        MldInfo, MldModel (Bemporad–Morari MLD form), PWA→MLD
    L2a ops/        horizon condensation, batched ADMM QP
    L2b solver/     device-resident branch-and-bound MIQP, exact oracles
    L3  loop/       receding-horizon closed-loop engine (scan/vmap)
    L3  control/    MpcController (weights, soft constraints, feedback)
    L3  agents/     Agent / MpcAgent / micro-grid coordination
    L0' parallel/   mesh + shard_map sharding of pools/scenarios
    L4  models/     double integrator, PWA, DEWH, grid/tariff, unit commitment
"""

__version__ = "0.1.0"

from pyhybridcontrol_tpu.utils.structdict import StructDict, named_struct_dict
from pyhybridcontrol_tpu.mld.info import MldInfo, VarTypes
from pyhybridcontrol_tpu.mld.model import MldModel
from pyhybridcontrol_tpu.mld.pwa import PwaRegion, PwaSystem, pwa_to_mld
from pyhybridcontrol_tpu.mld.symbolic import MldTemplate
from pyhybridcontrol_tpu.mld.compose import aggregate_mld
from pyhybridcontrol_tpu.ops.condense import CondensedMpc, DeviceQP, MpcWeights
from pyhybridcontrol_tpu.control.mpc import MpcController
from pyhybridcontrol_tpu.agents.agent import Agent, ControlledAgent, MpcAgent
from pyhybridcontrol_tpu.loop.closed_loop import closed_loop, make_mpc_step
from pyhybridcontrol_tpu.solver.bnb import BnbSpec, solve_miqp_bnb

__all__ = [
    "StructDict", "named_struct_dict", "MldInfo", "MldModel", "VarTypes",
    "PwaRegion", "PwaSystem", "pwa_to_mld", "MldTemplate", "aggregate_mld",
    "CondensedMpc", "DeviceQP", "MpcWeights", "MpcController",
    "Agent", "ControlledAgent", "MpcAgent", "closed_loop", "make_mpc_step",
    "BnbSpec", "solve_miqp_bnb", "__version__",
]
