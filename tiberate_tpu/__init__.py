"""tiberate_tpu — a CKKS fully-homomorphic-encryption framework in JAX.

A from-scratch JAX/XLA implementation with the full capability surface
of the reference GPU library (visualDust/tiberate-fhe): CKKS keygen,
encode/encrypt, homomorphic add/mult/rescale/relinearize, key switching,
Galois rotations/conjugation, ChaCha20 CSPRNG with discrete-Gaussian and
stochastic-rounding samplers, multi-shard RNS partitioning, and extensions
(threshold-FHE MPC, ciphertext packing, HE-NN layers, benchmarks).

Design notes (a redesign, not a port):

* polynomials live as single ``[C, N]`` int64 arrays (RNS channel-major),
  shardable over a ``jax.sharding.Mesh`` axis instead of per-device tensor
  lists,
* modular arithmetic is branchless 31-bit-half Montgomery REDC in int64,
  compiled by XLA (int32 in the 30-bit lane),
* the NTT is expressed as reshape-only butterfly stages (no gathers),
* randomness is counter-mode ChaCha20 with globally-indexed counters, so
  shards regenerate identical "repeating channel" streams with zero
  communication,
* engine methods are jit-compiled per level (shapes are static per level).

64-bit integer types require jax x64 mode; enable it on import.
"""

import jax as _jax

_jax.config.update("jax_enable_x64", True)

from tiberate_tpu import errors  # noqa: E402
from tiberate_tpu.config import CkksConfig, Preset  # noqa: E402

__version__ = "0.1.0"

__all__ = ["CkksConfig", "Preset", "errors", "__version__"]


def __getattr__(name):
    # Lazy heavyweight imports so `import tiberate_tpu` stays light.
    if name == "CkksEngine":
        from tiberate_tpu.engine import CkksEngine

        return CkksEngine
    if name in (
        "Ciphertext",
        "CiphertextTriplet",
        "Plaintext",
        "SecretKey",
        "PublicKey",
        "EvaluationKey",
        "KeySwitchKey",
        "RotationKey",
        "GaloisKey",
        "ConjugationKey",
        "DataStruct",
        "FLAGS",
    ):
        import tiberate_tpu.typing as _t

        return getattr(_t, name)
    raise AttributeError(f"module 'tiberate_tpu' has no attribute {name!r}")
