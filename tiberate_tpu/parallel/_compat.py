"""``jax.shard_map`` with value-replication checking off by default."""

import jax


def shard_map(f, mesh, in_specs, out_specs, check=False):
    """``jax.shard_map`` with ``check_vma`` off by default (the switchers'
    gather-then-slice bodies are not VMA-typable)."""
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=check)
