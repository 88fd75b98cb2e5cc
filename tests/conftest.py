"""Test env: force CPU with 8 virtual devices (SURVEY.md §4.5) so sharding
logic is unit-testable without several cards, and tests never hold a GPU.
The platform is set through jax.config right after import, before any
backend is used, so it holds even where JAX_PLATFORMS is not set. What
runs on the card is driven by ``python chip_smoke.py`` (``--multi`` for
four cards).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# ---- fast lane (VERDICT r3 item 10) -----------------------------------
# The suite is dominated by subprocess DCN/fault-injection tests, fp64
# oracle enumerations and long-horizon parity sweeps. Tests measured
# ≥ ~8 s on the 4-core host are marked `slow` HERE (one central list
# keyed on nodeid-without-params; parametrized variants inherit), so
#   python -m pytest tests/ -q -m "not slow"   # fast lane, ~5 min
# covers every module while the full suite stays the merge gate.
_SLOW = {
    "tests/test_battery.py::test_battery_feedback_oracle_parity",
    "tests/test_binary_states.py::test_binary_state_solve_matches_oracle",
    "tests/test_bnb_pooled.py::test_pooled_matches_vmapped",
    "tests/test_bnb_pooled.py::test_pooled_scenario_tree_matches_oracle",
    "tests/test_bnb_properties.py::test_incumbent_monotone_in_wave_budget",
    "tests/test_bnb_properties.py::test_overflow_keeps_gap_conservative",
    "tests/test_bnb_search.py::test_presolve_fix_shrinks_uc_tree",
    "tests/test_bnb_search.py::test_probe_gating_recovers_from_poor_seed",
    "tests/test_bnb_search.py::test_rel_gap_stop_fires_early_on_hull_pwa",
    "tests/test_bnb_stagewise.py::test_stagewise_hull_model_matches_condensed",
    "tests/test_cli.py::test_bench_crash_isolation",
    "tests/test_cli.py::test_run_cli_chunked_checkpoint_and_resume",
    "tests/test_cli.py::test_serve_tcp_coalescing",
    "tests/test_consensus_tree.py::test_consensus_matches_dense_joint",
    "tests/test_consensus_tree.py::test_consensus_sharded_mesh",
    "tests/test_controller.py::test_feedback_batch_matches_single",
    "tests/test_controller.py::test_feedback_batch_pooled_engine",
    "tests/test_controller.py::test_feedback_batch_stagewise_solver",
    "tests/test_controller.py::test_feedback_reports_certified_gap",
    "tests/test_controller.py::test_feedback_with_forecast_and_prices",
    "tests/test_examples.py::test_dewh_dsm_study",
    "tests/test_examples.py::test_double_integrator_study",
    "tests/test_examples.py::test_micro_grid_study",
    "tests/test_examples.py::test_pwa_formulation_study",
    "tests/test_examples.py::test_scenario_tree_study",
    "tests/test_examples.py::test_serve_loop",
    "tests/test_goldens.py::test_golden_config2_pwa",
    "tests/test_goldens.py::test_golden_config2_pwa_hull",
    "tests/test_mld.py::test_pwa_three_region_miqp_parity",
    "tests/test_models_dewh.py::test_micro_grid_coordinator_respects_coupling",
    "tests/test_models_dewh.py::test_unit_commitment_condensed",
    "tests/test_multiprocess.py::test_fault_injection_and_resume",
    "tests/test_multiprocess.py::test_two_process_sharded_bnb",
    "tests/test_parallel.py::test_pool_sharded_bnb_deterministic",
    "tests/test_parallel.py::test_pool_sharded_bnb_matches_single",
    "tests/test_parallel.py::test_pool_sharded_infeasible",
    "tests/test_parallel.py::test_pool_sharded_with_repair_seed",
    "tests/test_presolve.py::test_presolve_miqp_invariant_pwa",
    "tests/test_qp_solvers.py::test_bnb_random_structure_miqp_fuzz",
    "tests/test_qp_solvers.py::test_enumeration_parity_vs_oracle",
    "tests/test_repair.py::test_pwa_bnb_with_repair_finds_incumbent",
    "tests/test_sharded_scenarios.py::test_sharded_closed_loop_batch",
    "tests/test_stagewise.py::test_stagewise_batched",
    "tests/test_stagewise.py::test_stagewise_blocking_miqp_parity_N60",
    "tests/test_stagewise.py::test_stagewise_features_long_horizon",
    "tests/test_stagewise.py::test_stagewise_long_horizon_memory",
    "tests/test_stagewise.py::test_stagewise_rdu_qy_parity",
    "tests/test_stagewise.py::test_stagewise_soft_parity_binding",
    "tests/test_stagewise.py::test_stagewise_terminal_miqp_parity",
    "tests/test_stagewise.py::test_stagewise_terminal_parity_condensed_N60",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.nodeid.split("[")[0] in _SLOW:
            item.add_marker(pytest.mark.slow)
