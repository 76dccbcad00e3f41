"""Test configuration: force an 8-device virtual CPU platform.

Multi-device hardware is not available in CI; sharding/mesh tests run on a
virtual 8-device CPU mesh (`__graft_entry__.dryrun_multichip` compiles the
multi-device path the same way).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")
# CLI subprocesses spawned by tests pin the CPU backend too
os.environ.setdefault("BIRDNET_TPU_PLATFORM", "cpu")
# hermetic: no persistent compile cache written into the checkout by
# concurrent test workers (inherited by CLI subprocesses as well)
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "0"

import jax  # noqa: E402

# the config flag wins over any platform plugin's own defaults (must run
# before backend init)
jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng_key():
    import jax

    return jax.random.PRNGKey(0)
