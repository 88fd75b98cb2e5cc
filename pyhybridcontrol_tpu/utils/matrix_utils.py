"""Block-matrix assembly helpers (reference layer L0, SURVEY.md §2a
``utils/matrix_utils``: block-Toeplitz / block-diag stacking, 2-D column
coercion).

All functions are namespace-generic: they accept ``xp`` (numpy or
jax.numpy). Condensation runs them with numpy float64 on the host at build
time for accuracy; jnp for traced/differentiable paths. No scipy.sparse —
on the device, dense blocks beat sparse formats at MPC scale (N ≤ ~64),
and XLA has no sparse kernels worth using here.
"""

from __future__ import annotations

import numpy as np


def atleast_2d_col(a, xp=np, dtype=None):
    """Coerce to a 2-D column: scalars → (1,1), 1-D (n,) → (n,1)."""
    a = xp.asarray(a, dtype=dtype)
    if a.ndim == 0:
        return a.reshape(1, 1)
    if a.ndim == 1:
        return a.reshape(-1, 1)
    return a


def block_diag(blocks, xp=np):
    """Dense block-diagonal of a list of 2-D arrays."""
    blocks = [xp.asarray(b) for b in blocks]
    if not blocks:
        return xp.zeros((0, 0))
    rows = sum(b.shape[0] for b in blocks)
    cols = sum(b.shape[1] for b in blocks)
    out = xp.zeros((rows, cols), dtype=blocks[0].dtype)
    r = c = 0
    for b in blocks:
        if xp is np:
            out[r : r + b.shape[0], c : c + b.shape[1]] = b
        else:  # jnp functional update
            out = out.at[r : r + b.shape[0], c : c + b.shape[1]].set(b)
        r += b.shape[0]
        c += b.shape[1]
    return out


def block_diag_rep(block, n, xp=np):
    """Block-diagonal with ``block`` repeated ``n`` times.

    Uses an einsum-style kron with eye so it stays cheap and traceable.
    """
    block = xp.asarray(block)
    m, k = block.shape
    eye = xp.eye(n, dtype=block.dtype)
    out = xp.einsum("ij,kl->ikjl", eye, block)
    return out.reshape(n * m, n * k)


def block_toeplitz(first_col_blocks, n_cols=None, xp=np):
    """Lower-triangular block-Toeplitz from a list of blocks.

    ``first_col_blocks = [T0, T1, ..., T_{N-1}]`` produces

        [[T0                ]
         [T1  T0            ]
         [T2  T1  T0        ]
         [...          T0   ]]

    the input-response operator of horizon condensation (SURVEY.md §3.2).
    """
    blocks = [xp.asarray(b) for b in first_col_blocks]
    n = len(blocks)
    if n_cols is None:
        n_cols = n
    m, k = blocks[0].shape
    out = xp.zeros((n * m, n_cols * k), dtype=blocks[0].dtype)
    for i in range(n):
        for j in range(n_cols):
            if i - j >= 0 and i - j < n:
                b = blocks[i - j]
                if xp is np:
                    out[i * m : (i + 1) * m, j * k : (j + 1) * k] = b
                else:
                    out = out.at[i * m : (i + 1) * m, j * k : (j + 1) * k].set(b)
    return out


def matrix_powers(A, n, xp=np):
    """[I, A, A², …, Aⁿ] (n+1 entries)."""
    A = xp.asarray(A)
    out = [xp.eye(A.shape[0], dtype=A.dtype)]
    for _ in range(n):
        out.append(out[-1] @ A)
    return out
