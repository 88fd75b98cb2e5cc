"""Parameterized MLD templates (reference capability: sympy-symbolic MLD
matrices materialized from a parameter struct, SURVEY.md §2a/§3.1).

Device-first redesign: instead of sympy expression matrices + lambdify, a
template is a plain Python builder ``params → {matrix_name: array}``
evaluated at materialization time (host, float64). This keeps the
materialization step traceable-free (construction-time only, like the
reference), needs no symbolic dependency, and supports the same workflow:

    tmpl = MldTemplate(build_fn, required=("Ts", "C_w"))
    model = tmpl.materialize(StructDict(Ts=900.0, C_w=4.2e3, ...))

Materialized models are cached per parameter values (the reference's
version-tagged caching of derived quantities, SURVEY.md §2a "utils
decorators/versioning").
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np

from pyhybridcontrol_tpu.mld.info import MldInfo
from pyhybridcontrol_tpu.mld.model import MldModel


class MldTemplate:
    def __init__(self, builder: Callable[..., Dict],
                 required: Sequence[str] = (),
                 info: Optional[MldInfo] = None,
                 dtype=None):
        self._builder = builder
        self._required = tuple(required)
        self._info = info
        self._dtype = dtype
        self._cache: Dict = {}

    def materialize(self, params=None, **kw) -> MldModel:
        p = dict(params or {})
        p.update(kw)
        missing = [k for k in self._required if k not in p]
        if missing:
            raise ValueError(f"missing MLD template parameters: {missing}")
        key = _param_key(p)
        if key is not None and key in self._cache:
            return self._cache[key]
        mats = self._builder(**p)
        kwargs = {}
        if self._dtype is not None:
            kwargs["dtype"] = self._dtype
        model = MldModel.from_matrices(self._info, **mats, **kwargs)
        if key is not None:
            self._cache[key] = model
        return model

    __call__ = materialize


def from_sympy(symbolic_mats, info: Optional[MldInfo] = None,
               dtype=None) -> MldTemplate:
    """Build an MldTemplate from sympy expression matrices — the
    reference's exact symbolic workflow (SURVEY.md §3.1: sympy matrices
    + free symbols → lambdify → numeric materialization with parameter
    values).

        import sympy as sp
        Ts, tau = sp.symbols("Ts tau")
        tmpl = from_sympy({"A": sp.Matrix([[1, Ts], [0, 1 - Ts/tau]]),
                           "B1": sp.Matrix([[0], [Ts/tau]])})
        model = tmpl.materialize(Ts=0.25, tau=2.0)
    """
    import sympy as sp

    mats = {k: sp.Matrix(v) for k, v in symbolic_mats.items()}
    symbols = sorted(
        {s for m in mats.values() for s in m.free_symbols},
        key=lambda s: s.name)
    names = [s.name for s in symbols]
    fns = {k: sp.lambdify(symbols, m, modules="numpy")
           for k, m in mats.items()}

    def builder(**params):
        vals = [params[n] for n in names]
        return {k: np.asarray(fn(*vals), dtype=np.float64)
                for k, fn in fns.items()}

    return MldTemplate(builder, required=tuple(names), info=info,
                       dtype=dtype)


def _param_key(p):
    try:
        return tuple(sorted(
            (k, float(v) if np.isscalar(v) else _arr_key(v))
            for k, v in p.items()))
    except (TypeError, ValueError):
        return None  # unhashable params → skip caching


def _arr_key(v):
    a = np.asarray(v)
    return (a.shape, a.dtype.str, a.tobytes())
