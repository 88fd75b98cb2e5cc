"""MldModel: container + validator + dynamics of an MLD system.

Functional replica of the reference's ``MldModel`` (SURVEY.md §2a, §3.1):
holds the 18 Bemporad–Morari matrices, validates them against an MldInfo,
and provides the one-step dynamics / output / constraint-residual maps.

Design differences from the reference:
  * The matrix bundle is a JAX pytree (StructDict of jnp arrays), so an
    MldModel flows through jit/vmap/scan directly — ``step`` is traced
    once and fused by XLA; batched models are just stacked leaves.
  * No scipy.sparse: dense fp32 on device (fp64 numpy retained on host
    for condensation/oracle paths).
  * Missing matrices default to zeros of the right shape, so models with
    no ω / no y / no z cost nothing at trace time (XLA folds zero terms).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from pyhybridcontrol_tpu.mld.info import MldInfo
from pyhybridcontrol_tpu.utils.structdict import StructDict
from pyhybridcontrol_tpu.utils.matrix_utils import atleast_2d_col

MATRIX_NAMES = (
    "A", "B1", "B2", "B3", "B4", "b5",
    "C", "D1", "D2", "D3", "D4", "d5",
    "E", "F1", "F2", "F3", "F4", "f5",
)

_SHAPES = {
    "A": ("nx", "nx"), "B1": ("nx", "nu"), "B2": ("nx", "ndelta"),
    "B3": ("nx", "nz"), "B4": ("nx", "nomega"), "b5": ("nx", 1),
    "C": ("ny", "nx"), "D1": ("ny", "nu"), "D2": ("ny", "ndelta"),
    "D3": ("ny", "nz"), "D4": ("ny", "nomega"), "d5": ("ny", 1),
    "E": ("ncons", "nx"), "F1": ("ncons", "nu"), "F2": ("ncons", "ndelta"),
    "F3": ("ncons", "nz"), "F4": ("ncons", "nomega"), "f5": ("ncons", 1),
}


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class MldModel:
    """MLD system. ``mats`` is the pytree of matrices; ``info`` is static."""

    mats: StructDict
    info: MldInfo = dataclasses.field(metadata=dict(static=True))

    # -- construction ------------------------------------------------------
    @classmethod
    def from_matrices(cls, info: Optional[MldInfo] = None, *, dtype=jnp.float32,
                      validate: bool = True, **mats) -> "MldModel":
        """Build from any subset of the 18 MLD matrices.

        If ``info`` is None it is inferred from the shapes given (the
        reference's MldInfo shape-inference role, SURVEY.md §3.1).
        Missing matrices become zeros.
        """
        np_mats = {k: atleast_2d_col(np.asarray(v, dtype=np.float64))
                   for k, v in mats.items() if v is not None}
        if info is None:
            info = _infer_info(np_mats)
        dims = {"nx": info.nx, "nu": info.nu, "ndelta": info.ndelta,
                "nz": info.nz, "nomega": info.nomega, "ny": info.ny,
                "ncons": info.ncons, 1: 1}
        full = StructDict()
        for name in MATRIX_NAMES:
            r, c = _SHAPES[name]
            shape = (dims[r], dims[c])
            if name in np_mats:
                m = np_mats[name]
                if m.shape != shape:
                    raise ValueError(
                        f"MLD matrix {name}: shape {m.shape} != {shape}")
                full[name] = m
            else:
                full[name] = np.zeros(shape, dtype=np.float64)
        if validate:
            info.validate_shapes(full)
        full = StructDict({k: jnp.asarray(v, dtype=dtype)
                           for k, v in full.items()})
        return cls(mats=full, info=info)

    def numpy_mats(self) -> StructDict:
        """Host-side float64 copy of the matrix bundle (for condensation
        and oracle paths)."""
        return StructDict({k: np.asarray(v, dtype=np.float64)
                           for k, v in self.mats.items()})

    # -- dynamics ----------------------------------------------------------
    def step(self, x, u=None, delta=None, z=None, omega=None):
        """x⁺ = A x + B1 u + B2 δ + B3 z + B4 ω + b5.

        All args broadcast over leading batch dims; any of u/δ/z/ω may be
        None (treated as zero). Shapes: x (..., nx) → (..., nx).
        """
        m = self.mats
        xp = _mm(m.A, _col(x)) + m.b5
        for mat, val in ((m.B1, u), (m.B2, delta), (m.B3, z), (m.B4, omega)):
            if val is not None and mat.shape[1] > 0:
                xp = xp + _mm(mat, _col(val))
        return _like(xp, x)

    def output(self, x, u=None, delta=None, z=None, omega=None):
        """y = C x + D1 u + D2 δ + D3 z + D4 ω + d5."""
        m = self.mats
        y = _mm(m.C, _col(x)) + m.d5
        for mat, val in ((m.D1, u), (m.D2, delta), (m.D3, z), (m.D4, omega)):
            if val is not None and mat.shape[1] > 0:
                y = y + _mm(mat, _col(val))
        return y[..., :, 0]

    def constraint_residual(self, x, u=None, delta=None, z=None, omega=None):
        """E x + F1 u + F2 δ + F3 z + F4 ω − f5 (≤ 0 when feasible)."""
        m = self.mats
        r = _mm(m.E, _col(x)) - m.f5
        for mat, val in ((m.F1, u), (m.F2, delta), (m.F3, z), (m.F4, omega)):
            if val is not None and mat.shape[1] > 0:
                r = r + _mm(mat, _col(val))
        return r[..., :, 0]

    def step_v(self, x, v, omega=None):
        """One step driven by the stacked decision v = [u; δ; z]."""
        u, delta, z = self.info.split_v(v)
        return self.step(x, u, delta, z, omega)

    def lsim(self, x0, v_seq, omega_seq=None):
        """Simulate T steps under a decision sequence via ``lax.scan``.

        v_seq: (T, nv); omega_seq: (T, nomega) or None.
        Returns (x_seq (T+1, nx), y_seq (T, ny)).
        """
        T = v_seq.shape[0]
        if omega_seq is None:
            omega_seq = jnp.zeros((T, self.info.nomega), v_seq.dtype)

        def body(x, inp):
            v, w = inp
            u, d, z = self.info.split_v(v)
            y = self.output(x, u, d, z, w)
            xn = self.step(x, u, d, z, w)
            return xn, (xn, y)

        _, (xs, ys) = jax.lax.scan(body, x0, (v_seq, omega_seq))
        return jnp.concatenate([x0[None], xs], axis=0), ys


def _col(a):
    return a[..., :, None]


def _mm(a, b):
    # true fp32: a GPU may otherwise run float32 products in TF32, and the
    # closed loops integrate these steps over time
    return jnp.matmul(a, b, precision="highest")


def _like(col, x):
    return col[..., :, 0]


def _infer_info(np_mats) -> MldInfo:
    def dim(names, axis, default=0):
        for n in names:
            if n in np_mats:
                return np_mats[n].shape[axis]
        return default

    nx = dim(("A", "B1", "B2", "B3", "B4", "b5"), 0)
    nu = dim(("B1", "D1", "F1"), 1)
    ndelta = dim(("B2", "D2", "F2"), 1)
    nz = dim(("B3", "D3", "F3"), 1)
    nomega = dim(("B4", "D4", "F4"), 1)
    ny = dim(("C", "D1", "D2", "D3", "D4", "d5"), 0)
    ncons = dim(("E", "F1", "F2", "F3", "F4", "f5"), 0)
    return MldInfo(nx=nx, nu=nu, ndelta=ndelta, nz=nz, nomega=nomega,
                   ny=ny, ncons=ncons)
