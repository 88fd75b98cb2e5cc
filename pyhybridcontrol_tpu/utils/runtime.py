"""Process set-up shared by the entry points (``run``, ``serve``,
``bench.py``, ``chip_smoke.py``): where compiled programs are cached,
and the refusal to fall back to the CPU unannounced."""

from __future__ import annotations

import os

# the checkout: the directory that holds the package
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here; otherwise the cache lives in
    ``<checkout>/.jax_cache`` (listed in ``.gitignore``)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_accelerator(allow_cpu: bool = False) -> str:
    """Return the platform of JAX's first device; raise when it is the
    CPU and the caller did not ask for the CPU (``--cpu``), so a
    missing or broken GPU plugin cannot pass as a run on the card."""
    import jax

    platform = jax.devices()[0].platform
    if platform == "cpu" and not allow_cpu:
        raise RuntimeError(
            "JAX found no accelerator (its first device is the CPU); "
            "pass --cpu to run on the CPU on purpose")
    return platform
