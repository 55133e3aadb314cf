"""Test harness config: run everything on a virtual 8-device CPU mesh.

``XLA_FLAGS`` must be set before the first backend initialization; the
platform is pinned to the CPU through ``jax.config``, so a machine with a
GPU still runs the suite on the CPU mesh.  Tests that need the card carry
the ``chip`` marker and skip here (pytest.ini).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

# Persistent XLA compilation cache (utils/compilation_cache.py): the suite
# is compile-dominated, and cached executables cut a repeat run sharply.
from rcgan_tpu.utils.compilation_cache import enable as _enable_xla_cache  # noqa: E402

_enable_xla_cache()

assert jax.default_backend() == "cpu", jax.default_backend()

import pytest  # noqa: E402

# Fast tier: unit/oracle modules only (measured ~2.5 min together on a 1-CPU
# box).  E2e apps/train/parallel/eval tests stay in the full tier.
_SMOKE_MODULES = {
    "test_ops", "test_utils", "test_confusion", "test_losses", "test_data",
    "test_native", "test_models",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = getattr(item.module, "__name__", "").rsplit(".", 1)[-1]
        if mod in _SMOKE_MODULES and "slow" not in item.keywords:
            item.add_marker(pytest.mark.smoke)
