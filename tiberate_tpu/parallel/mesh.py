"""Device-mesh plumbing for sharded CKKS.

The JAX replacement for the reference's two distribution mechanisms
(SURVEY.md §2.2):

* in-process multi-GPU RNS decomposition (per-device tensor lists with
  pinned-host broadcast hops, reference ``rns_partition.py:34-47`` +
  ``ckks_engine.py:988-1046``)  ->  a ``jax.sharding.Mesh`` with the
  RNS-channel axis named ``"rns"`` and the coefficient axis ``"coef"``;
  GSPMD inserts the collectives the reference hand-rolled,
* torch RPC multi-process distribution (``extension/multigpu.py``)  ->
  multi-host jax.distributed running the same single program.

Axes:

* ``rns``  — shards the C (RNS channel) axis: the reference's main axis.
* ``coef`` — shards the N (coefficient) axis: what the reference never did,
  needed for logN>=17 multi-host (butterfly-stage all-to-all).
* ``batch`` — data-parallel over independent ciphertexts (packing workloads).
"""

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices=None, rns=None, coef=None, devices=None) -> Mesh:
    """Create a (rns, coef) mesh over the first ``n_devices`` devices.

    Defaults to all devices on the rns axis.
    """
    devs = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if rns is None and coef is None:
        rns, coef = n, 1
    elif rns is None:
        rns = n // coef
    elif coef is None:
        coef = n // rns
    assert rns * coef == n, f"mesh {rns}x{coef} != {n} devices"
    arr = np.array(devs).reshape(rns, coef)
    return Mesh(arr, axis_names=("rns", "coef"))


def ct_sharding(mesh: Mesh) -> NamedSharding:
    """[C, N] polynomial: channels over 'rns', coefficients over 'coef'."""
    return NamedSharding(mesh, P("rns", "coef"))


def col_sharding(mesh: Mesh) -> NamedSharding:
    """[C, 1] per-channel constants: sharded over 'rns', replicated coef."""
    return NamedSharding(mesh, P("rns", None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_leveled(x, mesh: Mesh):
    """Shard a [C, N] (or [C, 1]) array onto the mesh."""
    if x.ndim >= 2 and x.shape[-1] > 1:
        return jax.device_put(x, ct_sharding(mesh))
    return jax.device_put(x, col_sharding(mesh))


def shard_ciphertext(ct, mesh: Mesh):
    """Move a Ciphertext's data onto the mesh (rns x coef)."""
    from tiberate_tpu.typing import Ciphertext

    data = tuple(jax.device_put(d, ct_sharding(mesh)) for d in ct.data)
    return Ciphertext(
        data=data, flags=ct._flags, level=ct.level, **ct.misc
    )
