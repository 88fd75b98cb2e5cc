"""Checkpoint/resume (SURVEY.md §5): snapshot closed-loop / B&B state so
long scenario studies and multi-host runs resume after failure.

The reference has no checkpointing (re-runs from scratch); here any
pytree (BnbState, ClosedLoopResult, custom study state) is written as
its flattened leaves in one numpy ``.npz`` blob behind a JSON header
(step counter and user metadata), with an atomic write-rename. The blob
is read back with ``allow_pickle=False``, so loading runs no code.
Multi-host: each process writes its own shard file (``…-procNNN``) —
restore with the same process count.
"""

from __future__ import annotations

import io
import json
import os
import tempfile
from typing import Any, Optional, Tuple

import jax
import numpy as np


def _shard_path(path: str, process_index: Optional[int]) -> str:
    if process_index is None and jax.process_count() > 1:
        process_index = jax.process_index()
    if process_index is not None:
        path = f"{path}-proc{process_index:03d}"
    return path


def save_checkpoint(path: str, state: Any, step: int = 0,
                    metadata: Optional[dict] = None,
                    process_index: Optional[int] = None) -> str:
    """Atomically serialize ``state`` (any pytree) to ``path``."""
    path = _shard_path(path, process_index)
    # flattened leaves: works for EVERY pytree (dicts, StructDicts,
    # register_dataclass results like ClosedLoopResult / BnbState)
    leaves = jax.tree_util.tree_leaves(state)
    buf = io.BytesIO()
    np.savez(buf, **{f"leaf_{i:05d}": np.asarray(l)
                     for i, l in enumerate(leaves)})
    meta = json.dumps({"step": int(step), "meta": metadata or {}}).encode()
    out_dir = os.path.dirname(os.path.abspath(path))
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out_dir)
    try:
        with os.fdopen(fd, "wb") as fp:
            fp.write(len(meta).to_bytes(8, "little"))
            fp.write(meta)
            fp.write(buf.getvalue())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def load_checkpoint(path: str, target: Any = None,
                    process_index: Optional[int] = None
                    ) -> Tuple[Any, int, dict]:
    """Restore (state, step, metadata); ``target`` supplies the pytree
    structure (e.g. a freshly-initialized state). With ``target=None``
    the raw leaf list is returned (inspection mode)."""
    path = _shard_path(path, process_index)
    with open(path, "rb") as fp:
        mlen = int.from_bytes(fp.read(8), "little")
        meta = json.loads(fp.read(mlen).decode())
        blob = fp.read()
    with np.load(io.BytesIO(blob), allow_pickle=False) as raw:
        leaves = [raw[k] for k in sorted(raw.files)]
    if target is None:
        state = leaves
    else:
        t_leaves, treedef = jax.tree_util.tree_flatten(target)
        if len(t_leaves) != len(leaves):
            raise ValueError(
                f"checkpoint has {len(leaves)} leaves, target expects "
                f"{len(t_leaves)} — structure mismatch")
        state = jax.tree_util.tree_unflatten(treedef, leaves)
    return state, meta["step"], meta["meta"]
