"""Coefficient-axis-sharded negacyclic NTT under ``shard_map``.

The scaling axis the reference never had (SURVEY.md §5): a single
polynomial's butterflies always lived on one GPU
(``ntt_cuda.cu:89-100``).  Here the N axis is sharded contiguously over a
mesh axis; the first ``log2(D)`` Cooley-Tukey stages pair elements across
shards and exchange partner blocks over the interconnect
(``lax.ppermute``, which XLA lowers to NCCL), after which every
remaining stage is shard-local:

    stage s < log2(D):   partner = shard ^ (D >> (s+1))
                         exchange blocks, both sides compute their half
    stage s >= log2(D):  the standard reshape butterfly on the local block,
                         with the shard's slice of the twiddle bank

The inverse transform mirrors the schedule (local GS stages first, then
the cross-shard stages in reverse).  Outputs are bit-identical to the
unsharded ``ops.ntt`` path — same math, same ordering.

This is the logN>=17 multi-host building block: with mesh =
(hosts x cards), the outermost pairings cross hosts and the rest stay on
the NVLink inside a host.
"""

import jax
import jax.numpy as jnp
from jax import lax
from tiberate_tpu.parallel._compat import shard_map
from jax.sharding import PartitionSpec as P

from tiberate_tpu.ops import mont


def _butterfly_ct(U, V, S, pack):
    """U' = U + S*V, V' = U - S*V (lazy [0,2q))."""
    W = mont.mont_mult_raw(S, V, pack.ql, pack.qh, pack.kl, pack.kh)
    return (
        mont.mont_add(U, W, pack),
        mont.mont_sub(U, W, pack),
    )


def _butterfly_gs(U, V, S, pack):
    """U' = U + V, V' = S * (U - V)."""
    W = mont.mont_add(U, V, pack)
    D_ = mont.mont_sub(U, V, pack)
    Vn = mont.mont_mult_raw(D_, S, pack.ql, pack.qh, pack.kl, pack.kh)
    return W, Vn


def _local_ct_stages(x, i, start_stage, psi, pack, logN, D, axis):
    C, N_loc = x.shape
    N = N_loc * D
    for s in range(start_stage, logN):
        m = 1 << s
        t = N >> (s + 1)
        m_loc = m // D  # groups fully inside this shard
        xv = x.reshape(C, m_loc, 2, t)
        U = xv[:, :, 0]
        V = xv[:, :, 1]
        # shard i owns global groups [i*m_loc, (i+1)*m_loc)
        S = lax.dynamic_slice(
            psi, (jnp.int32(0), (m + i * m_loc).astype(jnp.int32)),
            (C, m_loc),
        )[:, :, None]
        U, V = _butterfly_ct(U, V, S, pack.expand(1))
        x = jnp.stack([U, V], axis=2).reshape(C, N_loc)
    return x


def _local_gs_stages(x, i, down_to_stage, ipsi, pack, logN, D, axis):
    C, N_loc = x.shape
    N = N_loc * D
    for s in range(logN - 1, down_to_stage - 1, -1):
        m = 1 << s
        t = N >> (s + 1)
        m_loc = m // D
        xv = x.reshape(C, m_loc, 2, t)
        U = xv[:, :, 0]
        V = xv[:, :, 1]
        S = lax.dynamic_slice(
            ipsi, (jnp.int32(0), (m + i * m_loc).astype(jnp.int32)),
            (C, m_loc),
        )[:, :, None]
        U, V = _butterfly_gs(U, V, S, pack.expand(1))
        x = jnp.stack([U, V], axis=2).reshape(C, N_loc)
    return x


def _cross_stage_twiddle(table, s, i, N, N_loc):
    """Twiddle rows for the cross-shard stage s on shard i.

    At stage s every element of a shard belongs to ONE group pair; the
    twiddle index is m + (global_U_index >> log2(2t)).  For contiguous
    shards this is constant per (sub-block of the shard): with
    m = 2^s <= D/2 groups spanning 2t = N/m elements, shard i covers
    groups [i*m//D ...]; since m <= D/2, a shard covers m/D < 1 group —
    exactly one value per shard: m + (i*N_loc) // (2t), broadcast.
    """
    m = 1 << s
    t = N >> (s + 1)
    gidx = (m + (i * N_loc) // (2 * t)).astype(jnp.int32)
    C = table.shape[0]
    return lax.dynamic_slice(table, (jnp.int32(0), gidx), (C, 1))


def ntt_block(x_blk, psi, pack, logN: int, D: int, axis: str):
    """Coefficient-sharded forward NTT body — callable inside ANY
    shard_map where ``axis`` is a manual mesh axis (the engine's
    coef-explicit step and the keyswitch switchers embed it directly).
    x_blk: [C, N/D] local block, Montgomery domain; bit-identical to the
    unsharded ``ops.ntt.ntt``."""
    n_cross = D.bit_length() - 1  # log2(D)
    assert 1 << n_cross == D, "axis size must be a power of two"
    N = x_blk.shape[-1] * D
    i = lax.axis_index(axis)
    # cross-shard CT stages
    for s in range(n_cross):
        half = D >> (s + 1)
        perm = [(j, j ^ half) for j in range(D)]
        other = lax.ppermute(x_blk, axis, perm)
        is_U = (i & half) == 0
        U = jnp.where(is_U, x_blk, other)
        V = jnp.where(is_U, other, x_blk)
        S = _cross_stage_twiddle(psi, s, i, N, N // D)
        Un, Vn = _butterfly_ct(U, V, S, pack)
        x_blk = jnp.where(is_U, Un, Vn)
    return _local_ct_stages(x_blk, i, n_cross, psi, pack, logN, D, axis)


def intt_block(x_blk, ipsi, Ninv, pack, logN: int, D: int, axis: str):
    """Coefficient-sharded inverse NTT body (Montgomery-staying, folds
    N^-1 like ``ops.ntt.intt``); see :func:`ntt_block`."""
    n_cross = D.bit_length() - 1
    assert 1 << n_cross == D, "axis size must be a power of two"
    N = x_blk.shape[-1] * D
    i = lax.axis_index(axis)
    x_blk = _local_gs_stages(x_blk, i, n_cross, ipsi, pack, logN, D, axis)
    # cross-shard GS stages, reverse order
    for s in range(n_cross - 1, -1, -1):
        half = D >> (s + 1)
        perm = [(j, j ^ half) for j in range(D)]
        other = lax.ppermute(x_blk, axis, perm)
        is_U = (i & half) == 0
        U = jnp.where(is_U, x_blk, other)
        V = jnp.where(is_U, other, x_blk)
        S = _cross_stage_twiddle(ipsi, s, i, N, N // D)
        Un, Vn = _butterfly_gs(U, V, S, pack)
        x_blk = jnp.where(is_U, Un, Vn)
    # fold in N^-1 (stay Montgomery, like ops.ntt.intt)
    return mont.mont_mult(x_blk, Ninv, pack)


def make_coef_sharded_ntt(lp, logN: int, mesh, axis: str = "coef"):
    """Builds (ntt_fn, intt_fn) over [C, N] arrays with N sharded on `axis`.

    lp: a LevelPack (full-channel view); transforms stay in the Montgomery
    domain (enter/exit composition is up to the caller, matching
    ``ops.ntt.ntt``/``intt``).
    """
    D = mesh.shape[axis]
    pack = lp.pack
    psi = lp.psi
    ipsi = lp.ipsi
    Ninv = lp.Ninv

    def ntt_shard(x_blk):
        return ntt_block(x_blk, psi, pack, logN, D, axis)

    def intt_shard(x_blk):
        return intt_block(x_blk, ipsi, Ninv, pack, logN, D, axis)

    spec = P(None, axis)
    ntt_fn = shard_map(ntt_shard, mesh=mesh, in_specs=(spec,),
                       out_specs=spec)
    intt_fn = shard_map(intt_shard, mesh=mesh, in_specs=(spec,),
                        out_specs=spec)
    return ntt_fn, intt_fn
