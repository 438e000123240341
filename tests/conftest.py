"""Test harness config: run everything on an 8-device virtual CPU mesh so
multi-device sharding paths are exercised without a GPU. Tests that need a
card are marked ``gpu``: they run their check in a child process that JAX
starts on the GPU (this process stays on the CPU), and skip where there is
no card. On the machine with the card:

    python -m pytest tests -m gpu -p no:cacheprovider
"""

import os
import subprocess
import sys

# Must be set before jax is imported anywhere.
os.environ["JAX_PLATFORMS"] = "cpu"
# Persistent-compilation-cache loads on CPU log two spurious ERROR lines per
# cached executable (XLA pseudo-feature mismatch, utils/compcache.py) —
# suppress XLA C++ logging below FATAL unless the caller asked otherwise.
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

# an explicit config update wins over any plugin's platform choice
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: interpret-mode Pallas / long-compile / training tests "
        "excluded from the smoke tier")
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU (runs its check in a child process on the "
        "card; skips without one)")
    config.addinivalue_line(
        "markers",
        "smoke: fast tier — auto-applied to every test NOT marked slow, so "
        "`pytest -m smoke` covers every module's fast paths (<5 min warm)")


def pytest_collection_modifyitems(config, items):
    # smoke = complement of slow, by construction: new tests are smoke
    # until someone measures them slow, and no module can silently drop
    # out of the smoke tier.
    for item in items:
        if "slow" not in item.keywords:
            item.add_marker(pytest.mark.smoke)


@pytest.fixture
def gpu_env():
    """Environment for a child process that JAX starts on the GPU; skips the
    test when JAX finds no GPU there."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    probe = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300)
    if probe.stdout.strip().splitlines()[-1:] != ["gpu"]:
        pytest.skip("no GPU: JAX's default platform here is "
                    f"{probe.stdout.strip() or probe.stderr[-200:]!r}")
    return env
