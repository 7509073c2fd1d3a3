"""Multi-host runtime plumbing.

The JAX replacement for the reference's torch-RPC scheduler/worker
topology (``tiberate/extension/multigpu.py``: rank 0 scheduler holding RRefs
to per-GPU WorkerContexts, keys shipped through CPU, closures pickled over
TensorPipe).  In JAX the idiom is the opposite: ONE program runs on
every host (``jax.distributed``), the mesh spans all chips, and "sending
work to a worker" is just sharding.  What remains of the reference's API is
initialization, key broadcast, and host-local batch scattering — provided
here.
"""

import numpy as np

import jax


def init_multihost(coordinator=None, num_processes=None, process_id=None):
    """Initialize the multi-host runtime (idempotent; no-op single-host).

    Single-process when ``num_processes`` is None or 1; otherwise give
    the coordinator address, process count and this process's id.
    Returns (process_index, process_count).
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_index(), jax.process_count()


def global_mesh(rns=None, coef=None, batch=1):
    """A mesh over ALL devices of the (possibly multi-host) runtime.

    Axis order (batch, rns, coef); axes that cross hosts should be the
    outermost (batch) so collectives over rns/coef stay inside a host.
    """
    devs = jax.devices()
    n = len(devs)
    per = n // batch
    if rns is None and coef is None:
        rns, coef = per, 1
    elif coef is None:
        coef = per // rns
    elif rns is None:
        rns = per // coef
    assert batch * rns * coef == n
    from jax.sharding import Mesh

    return Mesh(
        np.array(devs).reshape(batch, rns, coef),
        axis_names=("batch", "rns", "coef"),
    )


def broadcast_key(key_struct, from_process: int = 0):
    """Make key material identical on all hosts.

    With the counter-mode CSPRNG seeded identically this is free (every
    host regenerates the same keys); for EXTERNALLY loaded keys (npz from
    disk on one host — the reference's scheduler-to-worker key shipping,
    ``multigpu.py:87-117``) the bytes cross DCN here: the source process
    contributes the real arrays, every other process passes same-shaped
    placeholders, and all return the source's values.
    """
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        key_struct = jax.tree_util.tree_map(
            lambda x: np.asarray(x) if hasattr(x, "shape") else x,
            key_struct,
        )
        key_struct = multihost_utils.broadcast_one_to_all(
            key_struct,
            is_source=jax.process_index() == from_process,
        )
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    devs = jax.devices()
    mesh = Mesh(np.array(devs), axis_names=("all",))
    repl = NamedSharding(mesh, PartitionSpec())
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, repl) if hasattr(x, "shape") else x,
        key_struct,
    )


def scatter_batch(cts, mesh, axis="batch"):
    """Scatter a host-local list of ciphertext arrays over the batch axis.

    Single-process: a plain sharded placement.  Multi-process: each host
    contributes ITS OWN local batch and the result is the global array
    whose ``axis`` dimension concatenates all hosts' batches (the
    reference's scheduler handing each worker its slice, inverted:
    workers bring their slices and the mesh assembles the whole).
    """
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    stacked = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *cts
    )
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        return multihost_utils.host_local_array_to_global_array(
            stacked, mesh, P(axis)
        )
    sh = NamedSharding(mesh, P(axis))
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sh), stacked
    )
