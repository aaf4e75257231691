"""A pytest plugin that keeps a parallel run of the test suite inside its time.

``test_torch_suite_env.py`` loads it through ``pytest_plugins``, so every
session that collects that module (tier-1 and ``make test`` among them)
gets it. Collection imports every test module before the first test runs,
and no module starts JAX's backend or compiles at import, so the settings
below are in place before XLA reads them; ``FLAGS_BEFORE_BACKEND`` records
that, and the guard test asserts it.

- Under pytest-xdist each worker takes an equal share of the machine's
  cores for PyTorch's and XLA:CPU's thread pools: six workers would
  otherwise run twelve pools of 8 threads on 8 cores. A run outside xdist
  keeps the libraries' defaults. Subprocesses inherit ``XLA_FLAGS``.
- Compiled XLA programs go to a disk cache that every worker and every
  module shares, so the ``jax.clear_caches()`` that ``conftest.py`` runs
  between modules costs a load, not a compile. JAX keys an entry by its
  program, compile options, XLA flags and jax version; XLA:CPU refuses an
  entry built for other CPU features, and JAX then compiles anew.
- Each test of the port (``test_torch_*`` modules) is bounded by
  ``TIME_LIMIT_S`` from its setup to its teardown: a hang fails that test
  by name instead of running the session out of time.
"""

import faulthandler
import os
import signal
import sys
import tempfile

import jax
import pytest
import torch
from jax._src import xla_bridge

FLAGS_BEFORE_BACKEND = not xla_bridge.backends_are_initialized()

_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _workers:
    _budget = max(1, len(os.sched_getaffinity(0)) // _workers)
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_cpu_multi_thread_eigen" not in _flags:
        _flags += " --xla_cpu_multi_thread_eigen=false"
    if "intra_op_parallelism_threads" not in _flags:
        _flags += f" intra_op_parallelism_threads={_budget}"
    os.environ["XLA_FLAGS"] = _flags.strip()
    torch.set_num_threads(_budget)
    torch.set_num_interop_threads(1)

jax.config.update("jax_compilation_cache_dir",
                  os.path.join(tempfile.gettempdir(), "vcp_tests_xla_cache"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

# Above the longest wait inside a port test (the 900 s test_torch_mesh.py
# gives its reference subprocess), which so comes first, and over four
# times the longest item seen under a loaded 6-worker run (217 s, most of
# it a module fixture).
TIME_LIMIT_S = 1000


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    module = getattr(item, "module", None)
    if module is None or not module.__name__.startswith("test_torch_"):
        return (yield)

    def expire(signum, frame):
        # SIGALRM interrupts Python code and the standard library's waits;
        # subprocess.run kills its child on the way out.
        faulthandler.dump_traceback(sys.__stderr__, all_threads=True)
        pytest.fail(f"{item.nodeid} ran past the {TIME_LIMIT_S} s limit",
                    pytrace=False)

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, TIME_LIMIT_S)
    try:
        return (yield)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
