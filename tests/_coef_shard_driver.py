"""Driver: coefficient-sharded NTT vs unsharded, 8-device CPU mesh."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import numpy as np

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tiberate_tpu.context.ntt_context import LevelPack
from tiberate_tpu.ops import mont, ntt as jntt
from tiberate_tpu.ops.mont import ModPack
from tiberate_tpu.parallel.coef_sharded import make_coef_sharded_ntt
from tiberate_tpu.utils.primes import find_the_next_prime

logN = int(os.environ.get("TIBERATE_COEF_LOGN", "12"))
N = 1 << logN
qs = [
    find_the_next_prime(2**60 - 1, 2 * N, up=False),
    find_the_next_prime(2**40 - 1, 2 * N, up=False),
]
C = len(qs)
pack = ModPack.from_q(qs)
psi, ipsi = jntt.make_psi_tables(qs, logN)
R62 = 1 << 62
psi_m = jnp.asarray(
    np.array([[p * R62 % q for p in row] for row, q in zip(psi, qs)],
             dtype=np.int64)
)
ipsi_m = jnp.asarray(
    np.array([[p * R62 % q for p in row] for row, q in zip(ipsi, qs)],
             dtype=np.int64)
)
Ninv = jnp.asarray(
    np.array([[pow(N, -1, q) * R62 % q] for q in qs], dtype=np.int64)
)
Rs = jnp.asarray(np.array([[R62 * R62 % q] for q in qs], dtype=np.int64))
lp = LevelPack(pack=pack, psi=psi_m, ipsi=ipsi_m, Ninv=Ninv, Rs=Rs,
               Rs_scale=Rs)

mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("coef",))
ntt_fn, intt_fn = make_coef_sharded_ntt(lp, logN, mesh, axis="coef")

rng = np.random.default_rng(0)
a = np.stack([rng.integers(0, 2 * q, N) for q in qs]).astype(np.int64)
x = jax.device_put(jnp.asarray(a), NamedSharding(mesh, P(None, "coef")))

got_fwd = np.asarray(jax.jit(ntt_fn)(x))
exp_fwd = np.asarray(jntt.ntt(jnp.asarray(a), psi_m, pack))
print("coef-sharded NTT bit-exact:", bool((got_fwd == exp_fwd).all()))

got_rt = np.asarray(jax.jit(lambda v: intt_fn(ntt_fn(v)))(x))
exp_rt = np.asarray(
    jntt.intt(jntt.ntt(jnp.asarray(a), psi_m, pack), ipsi_m, Ninv, pack)
)
print("coef-sharded roundtrip bit-exact:", bool((got_rt == exp_rt).all()))

# collectives actually present in the compiled program
hlo = jax.jit(ntt_fn).lower(x).compile().as_text()
print("collective-permute in HLO:", "collective-permute" in hlo)
