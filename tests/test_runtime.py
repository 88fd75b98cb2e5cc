"""Process set-up of the entry points (utils/runtime.py): the compile
cache location, the refusal to run on a CPU-only JAX without --cpu, and
chip_smoke.py's device check and host reference."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyhybridcontrol_tpu.utils import runtime

_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config():
    """Restore JAX's compile-cache setting after a test changes it."""
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_follows_env(monkeypatch, tmp_path, cache_config):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; nothing is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.enable_compile_cache()
    assert path == os.path.join(_repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_require_accelerator_allows_cpu_on_request():
    assert runtime.require_accelerator(allow_cpu=True) == "cpu"
    with pytest.raises(RuntimeError, match="no accelerator"):
        runtime.require_accelerator()


def test_run_refuses_cpu_without_flag():
    from pyhybridcontrol_tpu.run import main

    with pytest.raises(RuntimeError, match="--cpu"):
        main(["--config", "double_integrator", "--steps", "1"])


def test_serve_refuses_cpu_without_flag():
    from pyhybridcontrol_tpu.serve import main

    with pytest.raises(RuntimeError, match="--cpu"):
        main(["--config", "double_integrator"])


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(_repo, "chip_smoke.py")],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode != 0
    assert "not a GPU" in out.stderr
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("config", ["double_integrator", "pwa_actuator"])
def test_chip_smoke_fp64_replica_matches_admm(config, rng):
    """chip_smoke.py's host fp64 ADMM, the reference the card's
    relaxation is held to, runs the same iteration as admm_solve."""
    import importlib.util

    from pyhybridcontrol_tpu.configs import get_config
    from pyhybridcontrol_tpu.ops.admm import admm_solve, prepare_admm_mpc
    from pyhybridcontrol_tpu.ops.condense import CondensedMpc

    spec_ = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_repo, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(cs)
    cfg = get_config(config)
    model, kw = cfg.build()
    c = CondensedMpc(model, 6, kw["weights"])
    qp, spec = c.device_qp(), prepare_admm_mpc(c)
    B = 8
    x0 = 0.3 * rng.normal(size=(B, model.info.nx)).astype(np.float32)
    fs, hs = jax.vmap(qp.assemble)(jnp.asarray(x0))
    lb = jnp.broadcast_to(qp.lb, (B, qp.n))
    ub = jnp.broadcast_to(qp.ub, (B, qp.n))
    res = admm_solve(spec, fs, hs, lb, ub, iters=150)
    x_ref, obj_ref = cs.admm_fp64(spec, fs, hs, lb, ub, 150)
    np.testing.assert_allclose(np.asarray(res.obj), obj_ref,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(res.x), x_ref, atol=1e-3)
