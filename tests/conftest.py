"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests see 1 device; the
multi-device checks (test_dist.py, test_pencil_fft.py, test_dist_interp.py)
spawn subprocesses via ``run_multidevice`` because XLA locks the device
count at first jax init.

Markers (fast tier: ``pytest -m "not slow"``, see ROADMAP):
    slow — subprocess-spawning / minutes-long cases
    dist — exercises the multi-device repro.dist path

Randomness: every test draws through the shared seeded fixtures below
(``rng`` for numpy streams, ``jax_key`` for jax PRNG keys), all derived
from ONE session seed.  ``REPRO_TEST_SEED=<int>`` re-seeds the whole
suite — the flake-hunting knob: a failure that appears under one seed
and not another is a tolerance problem, not a logic problem.  ``rng`` is
function-scoped so each test owns a deterministic stream regardless of
which subset of the suite runs (a session-scoped stream made any
``-k``-selected run draw different numbers than the full suite).
"""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: subprocess-spawning or minutes-long test")
    config.addinivalue_line("markers", "dist: exercises the multi-device repro.dist path")
    config.addinivalue_line("markers", "gpu: needs a CUDA card (tests/test_torch_cuda.py)")


def run_multidevice(body: str, devices: int = 8, timeout: int = 520) -> str:
    """Run a test body in a fresh interpreter with N placeholder devices."""
    code = textwrap.dedent(
        f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={devices}"
        import sys
        sys.path.insert(0, {os.path.join(ROOT, "src")!r})
        import jax, jax.numpy as jnp, numpy as np
        TEST_SEED = int(os.environ.get("REPRO_TEST_SEED", "0"))
        """
    ) + textwrap.dedent(body)
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=timeout
    )
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}"
    return proc.stdout


TEST_SEED = int(os.environ.get("REPRO_TEST_SEED", "0"))


@pytest.fixture(scope="session")
def test_seed():
    """The suite-wide base seed (override with REPRO_TEST_SEED=<int>)."""
    return TEST_SEED


@pytest.fixture
def rng(test_seed):
    return np.random.default_rng(test_seed)


@pytest.fixture
def jax_key(test_seed):
    return jax.random.PRNGKey(test_seed)


@pytest.fixture(scope="session")
def single_mesh():
    return jax.make_mesh((1,), ("data",))
