"""The settings ``torch_suite_env`` gives a test session: each xdist
worker's share of the cores, the disk cache of compiled XLA programs and
the time limit on each port test. Declaring the plugin here loads it for
every session that collects this module; the module's ``test_torch_``
prefix keeps it out of the ``slow`` marker, so tier-1 runs it."""

import glob
import os
import re
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest_plugins = ["torch_suite_env"]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def suite_env(request):
    plugin = request.config.pluginmanager.get_plugin("torch_suite_env")
    assert plugin is not None
    return plugin


def test_thread_budget_follows_xdist(suite_env):
    flags = os.environ.get("XLA_FLAGS", "").split()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if not workers:
        # outside xdist the libraries keep their own defaults
        assert not [f for f in flags if "multi_thread_eigen" in f
                    or "intra_op_parallelism" in f]
        return
    cores = len(os.sched_getaffinity(0))
    share = cores // workers if cores >= workers else 1
    assert torch.get_num_threads() == share
    assert torch.get_num_interop_threads() == 1
    assert flags.count("--xla_cpu_multi_thread_eigen=false") == 1
    assert flags.count(f"intra_op_parallelism_threads={share}") == 1
    assert suite_env.FLAGS_BEFORE_BACKEND


def _suite_env_probe(x):
    return x * 3 + 1


def test_compile_cache_outside_repo_and_written():
    cache_dir = jax.config.jax_compilation_cache_dir
    assert cache_dir
    assert os.path.commonpath([os.path.realpath(cache_dir), REPO]) != REPO
    out = jax.jit(_suite_env_probe)(jnp.arange(5, dtype=jnp.int32))
    np.testing.assert_array_equal(np.asarray(out), np.arange(5) * 3 + 1)
    assert glob.glob(os.path.join(cache_dir, "jit__suite_env_probe-*"))


@pytest.fixture()
def short_time_limit(suite_env):
    """Turn the running test's limit down to 0.2 s."""
    remaining, _ = signal.getitimer(signal.ITIMER_REAL)
    assert 0 < remaining <= suite_env.TIME_LIMIT_S
    signal.setitimer(signal.ITIMER_REAL, 0.2)


def test_time_limit_fails_a_hang_by_name(short_time_limit, request):
    start = time.monotonic()
    with pytest.raises(pytest.fail.Exception,
                       match=re.escape(request.node.nodeid)):
        while time.monotonic() - start < 30:
            time.sleep(0.01)
    assert time.monotonic() - start < 5
