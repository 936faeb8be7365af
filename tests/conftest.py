"""Shared test fixtures.

NOTE: XLA_FLAGS / device-count manipulation is deliberately NOT done here —
smoke tests and benches must see the real single CPU device. Multi-device
tests spawn subprocesses that set XLA_FLAGS before importing jax.
"""
import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _no_nan_debug():
    # keep default flags; placeholder for future global toggles
    yield


def assert_allclose(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(
        np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64), rtol=rtol, atol=atol
    )


SUBPROCESS_ENV = dict(os.environ)
SUBPROCESS_ENV.pop("XLA_FLAGS", None)


def run_multidevice(code: str, n_devices: int = 8, timeout: int = 600):
    """Run `code` in a subprocess with n virtual CPU devices."""
    import subprocess

    env = dict(SUBPROCESS_ENV)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=timeout, env=env
    )
    if proc.returncode != 0:
        raise AssertionError(
            f"subprocess failed (rc={proc.returncode})\nstdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
        )
    return proc.stdout


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (and nvcc); skipped where there is none"
    )
