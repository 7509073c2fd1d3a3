"""Test configuration: a CPU backend with 8 virtual devices.

Multi-chip sharding tests run on a virtual CPU mesh
(``xla_force_host_platform_device_count``); engine math is exact integer
arithmetic, so results do not depend on the backend.  ``pytest -m gpu``
leaves the platform to JAX so the ``gpu``-marked tests can reach a card.
"""

import os

import jax


def pytest_configure(config):
    if config.getoption("markexpr") != "gpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    # NO persistent compile cache for the suite: with jax 0.9.0 the cache
    # writer segfaulted reproducibly while serializing one of the
    # engine-step executables on the CPU (``put_executable_and_time`` ->
    # zstandard in the faulthandler dump).
    jax.config.update("jax_enable_compilation_cache", False)
