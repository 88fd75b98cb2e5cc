"""Per-object derived-data cache for prepared problem specs.

Module-level ``id()``-keyed caches invite two bugs: (a) ``id()`` reuse
after garbage collection aliasing two different prepared problems, and
(b) unbounded growth — entries hold strong references forever. This
helper is ONE policy instead: derived data (jitted wave-loop runners)
lives in a dict ON the prepared-spec object itself, so it is garbage-
collected with the spec, never aliases across objects, and module state
stays immutable.

Trace-safety is the builder's responsibility, not the cache's: anything
stored here must be CONCRETE (host numpy, or device arrays created
under ``jax.ensure_compile_time_eval()``) so it can be reused by any
number of jitted programs. Round 2's driver-bench crash
(``UnexpectedTracerError`` on the second jitted program sharing a
prepared BoxQP) was exactly a trace-local constant escaping through a
module-level cache.
"""

from __future__ import annotations

_SLOT = "_phc_derived_cache"


def cached_on(obj, key, build):
    """Return ``build()`` memoized under ``key`` in a dict stored on
    ``obj``. ``key`` must be hashable; entries live exactly as long as
    ``obj`` does. Entries that close over other objects keep them alive
    (so ``id()``-based key components cannot alias while cached)."""
    cache = obj.__dict__.get(_SLOT)
    if cache is None:
        cache = {}
        obj.__dict__[_SLOT] = cache
    ent = cache.get(key)
    if ent is None:
        ent = build()
        cache[key] = ent
    return ent
