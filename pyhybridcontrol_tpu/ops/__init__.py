from pyhybridcontrol_tpu.ops.condense import CondensedMpc, DeviceQP, MpcWeights
from pyhybridcontrol_tpu.ops.admm import (
    BoxQP,
    admm_solve,
    admm_solve_batch,
    prepare_admm,
)

__all__ = [
    "CondensedMpc",
    "DeviceQP",
    "MpcWeights",
    "BoxQP",
    "admm_solve",
    "admm_solve_batch",
    "prepare_admm",
]
