"""Double-float ("double-double" over fp32) compensated arithmetic for
certificate reductions (VERDICT r4 item 2; SURVEY.md §7 "QP accuracy in
bf16/fp32").

The device solvers run in fp32. The B&B engine's *certificates* — the Falk
dual bound, the primal-infeasibility support/gap sums, and the strong-
branching candidate scores built from them — are short reductions whose
terms cancel (tangent terms of opposite sign at 1e2 scale certifying
bounds at 1e-3 scale), and plain fp32 summation was measured shipping
3.7%-worse incumbents when those certs drove fixing decisions
(PERF.md, strong-branching finding). This module provides
error-free-transformation building blocks and a compensated dot/sum
whose result tracks fp64 to ~1ulp-of-fp64-in-fp32-pairs, while the
surrounding matmuls stay fp32 ``precision="highest"`` (CLAUDE.md).

Algorithms: Knuth TwoSum and Dekker Split/TwoProduct (fp32 split
constant 2^12+1), Ogita-Rump-Oishi cascaded (Sum2/Dot2) accumulation.
These are the published compensated-arithmetic kernels (Ogita, Rump &
Oishi, "Accurate Sum and Dot Product", SISC 2005) implemented as
vectorized jnp ops — no data-dependent control flow, jit/vmap-safe.

Correctness on a given backend depends on the compiler NOT reassociating
float adds ((a+b)-a must not fold to b). XLA's algebraic simplifier is
value-safe for floats by default; ``dd_selfcheck()`` verifies the
error-free property at runtime on the live backend and is asserted in
the test suite (tests/test_qp_solvers.py::test_dd_dot_accuracy); the
chip arm runs through ``scripts/config2_sb_ab.py --dd``, which prepares
the ADMM specs with ``dd_cert=True``.
"""

from __future__ import annotations

import jax.numpy as jnp

_SPLIT = None  # computed per dtype: 2^ceil(p/2)+1


def _split_const(dtype):
    # Dekker splitting constant: fp32 (p=24) → 2^12+1; fp64 (p=53) → 2^27+1
    if jnp.dtype(dtype) == jnp.dtype(jnp.float64):
        return 134217729.0
    return 4097.0


def two_sum(a, b):
    """Error-free sum: returns (s, e) with s = fl(a+b), s+e == a+b
    exactly (Knuth). Branch-free, any shape."""
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


def _split(a):
    c = _split_const(a.dtype) * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Error-free product: returns (p, e) with p = fl(a*b), p+e == a*b
    exactly (Dekker; no fma dependence — if XLA contracts the hi*hi-p
    term into an fma the result only gets MORE exact)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def dd_sum(x, axis=-1):
    """Compensated sum along ``axis`` (Ogita-Rump-Oishi Sum2 as a
    log-depth pairwise tree): the running value is a (hi, lo) pair, and
    pair+pair addition accumulates the exact TwoSum error of the hi
    parts. Error ~ eps² · condition vs eps·n for plain fp32 sum.
    Returns a plain array (hi + lo re-rounded)."""
    hi, lo = _dd_sum_pair(x, jnp.zeros_like(x), axis=axis)
    return hi + lo


def _dd_sum_pair(hi, lo, axis=-1):
    """Tree-reduce (hi, lo) term pairs along ``axis`` to a scalar pair."""
    hi = jnp.moveaxis(hi, axis, -1)
    lo = jnp.moveaxis(lo, axis, -1)
    n = hi.shape[-1]
    # pad to a power of two with exact zeros (identity of TwoSum)
    p2 = 1 << max(0, (n - 1).bit_length())
    if p2 != n:
        pad = [(0, 0)] * (hi.ndim - 1) + [(0, p2 - n)]
        hi = jnp.pad(hi, pad)
        lo = jnp.pad(lo, pad)
    while hi.shape[-1] > 1:
        h0, h1 = hi[..., 0::2], hi[..., 1::2]
        l0, l1 = lo[..., 0::2], lo[..., 1::2]
        s, e = two_sum(h0, h1)
        hi, lo = s, e + (l0 + l1)
    return hi[..., 0], lo[..., 0]


def dd_dot(a, b, axis=-1):
    """Compensated dot product along ``axis`` (Ogita-Rump-Oishi Dot2):
    TwoProduct each term, tree-sum the (value, error) pairs. Result is
    as if computed in ~2x the working precision then rounded once —
    fp64-grade for fp32 inputs. Cost: ~10 elementwise ops per term
    (elementwise work, negligible next to the matmuls it sits beside)."""
    p, e = two_prod(a, b)
    hi, lo = _dd_sum_pair(p, e, axis=axis)
    return hi + lo


def dd_selfcheck():
    """Runtime verification that the error-free transforms survive the
    live backend's compiler (a reassociating compiler folds the TwoSum
    error to 0 and dd silently degrades to plain fp32). Returns the
    relative error of a catastrophically-cancelling dot product — ~1e-7
    or better when dd is working, ~1e-2 when broken."""
    import jax

    n = 64
    big = (1.0 + jnp.arange(n, dtype=jnp.float32) / n) * 1e7
    a = jnp.concatenate([big, -big, jnp.ones((8,), jnp.float32)])
    b = jnp.ones_like(a).at[n:2 * n].set(1.0 + 2.0 ** -12)
    got = jax.jit(dd_dot)(a, b)
    import numpy as np

    want = float(np.dot(np.asarray(a, np.float64),
                        np.asarray(b, np.float64)))
    return abs(float(got) - want) / max(1.0, abs(want))
