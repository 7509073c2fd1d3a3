"""Two-process jax.distributed driver (spawned by test_parallel.py).

Usage: python _multihost_driver.py <process_id> <num_processes> <port>

Each process runs the SAME program (the multi-host JAX idiom replacing the
reference's scheduler/worker RPC, ``extension/multigpu.py:27-183``):
initialize the runtime, verify same-seed keygen matches across hosts,
ship an externally-held key from process 0 to everyone, scatter each
host's local ciphertext batch onto the global mesh, and run one sharded
op over it.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from tiberate_tpu.parallel import multihost as mh

pidx, pcount = mh.init_multihost(
    coordinator=f"localhost:{port}", num_processes=nproc, process_id=pid
)
assert (pidx, pcount) == (pid, nproc), (pidx, pcount)
assert jax.device_count() == 2 * nproc, jax.device_count()
assert len(jax.local_devices()) == 2

from jax.experimental import multihost_utils

from tiberate_tpu.config.toy import toy_config
from tiberate_tpu.engine import CkksEngine

cfg = toy_config(logN=6, num_scales=3, num_special_primes=1, scale_bits=30)
eng = CkksEngine(cfg, seed=11, nonce=3)

# 1. same-seed keygen is bit-identical across hosts (the cheap path the
# docstring promises: no bytes need to move for engine-generated keys)
pk0 = np.asarray(eng.pk.data[0])
gathered = multihost_utils.process_allgather(pk0)
assert gathered.shape[0] == nproc
for r in range(1, nproc):
    assert (gathered[0] == gathered[r]).all(), "same-seed keys differ"

# 2. externally loaded key: ONLY process 0 holds the real bytes (as if
# loaded from npz); everyone ends up with process 0's values
real = np.asarray(eng.sk.data)
ext = real if pidx == 0 else np.zeros_like(real)
got = np.asarray(mh.broadcast_key(ext, from_process=0))
assert (got == real).all(), "broadcast_key did not replicate host 0 bytes"

# 3. per-host batch scatter onto the global mesh + one sharded op
mesh = mh.global_mesh(batch=nproc, rns=2, coef=1)
m = np.linspace(-1, 1, eng.num_slots) * (pidx + 1)
ct = eng.encodecrypt(m)
local = [np.asarray(ct.data[0])]
g = mh.scatter_batch([local], mesh)[0]
assert g.shape[0] == nproc, g.shape

from jax.sharding import NamedSharding, PartitionSpec as P

doubled = jax.jit(
    lambda x: x * 2,
    out_shardings=NamedSharding(mesh, P("batch", "rns", None)),
)(g)
back = multihost_utils.global_array_to_host_local_array(
    doubled, mesh, P("batch", "rns", None)
)
assert (np.asarray(back)[0] == 2 * local[0]).all()

print(f"multihost OK pidx={pidx}/{pcount}")
