"""Run-time set-up shared by the entry scripts.

``bench.py``, ``chip_smoke.py`` and ``__graft_entry__.py`` call
:func:`use_compile_cache` first thing; importing the library sets no
cache.  :func:`card_line` and :func:`device_record` name the hardware a
result was measured on.
"""

import os
import subprocess

import jax

# One fixed path per checkout: the directory is part of the cache's key,
# so a path that moved between runs would never hit.
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def use_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is left for JAX to read;
    otherwise the cache goes to ``<checkout>/.jax_cache``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR


def card_line() -> str:
    """The cards' name and power limit, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def device_record() -> dict:
    """Platform, device kind and count as JAX reports them, plus the
    card line on a GPU (None elsewhere)."""
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "card": card_line() if devs[0].platform == "gpu" else None,
    }
