"""Negacyclic NTT / iNTT on ``[..., C, N]`` uint64 RNS tensors.

A JAX redesign of the reference CUDA NTT (``csrc/cuda/ntt_cuda.cu``).
The reference launches one gather-based butterfly kernel per stage using
precomputed "painted" even/odd index tables (``ntt_context.py:81-134``).
Here each stage is expressed as a pure *reshape*, with no index tables:

    stage ``logm`` (m = 2^logm groups, t = N / 2m):
        view x as [..., m, 2, t]; U = x[..., 0, :], O = x[..., 1, :]
        V = mont_mult(psi[m + i], O)     (CT butterfly, forward)
        x <- [U + V, U - V]  (lazy mod 2q)

which XLA fuses into one elementwise kernel per stage with zero index
traffic.  The twiddle bank ``psi`` is the bit-reversed ψ power series in
Montgomery form — the same table the reference precomputes
(``ntt_context.py:42-78``) — so transforms are bit-identical to the
reference kernels stage by stage.

Forward = Cooley-Tukey decimation-in-time (natural order in, bit-reversed
out); inverse = Gentleman-Sande (bit-reversed in, natural out), with the
``N^-1 R`` fold-in exactly like ``intt_cuda``.  Fused variants mirror the
reference op set: ``enter_ntt``, ``intt_exit``, ``intt_exit_reduce``,
``intt_exit_reduce_signed``.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp

from tiberate_tpu.ops import mont
from tiberate_tpu.ops.mont import ModPack


@lru_cache(maxsize=1)
def _use_pair() -> bool:
    """Opt-in (TIBERATE_PAIR_NTT=1) explicit uint32-pair REDC for the
    NTT butterflies, bit-exact with the int64 path on the nonnegative
    domain.  Off by default; not measured on a GPU (ROADMAP D2)."""
    import os

    return os.environ.get("TIBERATE_PAIR_NTT") == "1"


def _ntt_i64(x, psi, pack: ModPack):
    """int64 forward butterflies (signed-complete path)."""
    N = x.shape[-1]
    logN = N.bit_length() - 1
    lead = x.shape[:-1]

    for logm in range(logN):
        m = 1 << logm
        t = N >> (logm + 1)
        xv = x.reshape(*lead, m, 2, t)
        U = xv[..., 0, :]
        O = xv[..., 1, :]
        # Twiddle for group i is psi[m + i], broadcast over t coefficients.
        S = psi[:, m : 2 * m].reshape(
            *((1,) * (len(lead) - 1)), -1, m, 1
        )
        V = mont.mont_mult_raw(
            S, O, pack.ql[..., None], pack.qh[..., None],
            pack.kl[..., None], pack.kh[..., None],
        )
        _2q = pack._2q[..., None]
        UplusV = U + V
        UminusV = U + _2q - V
        UplusV = jnp.where(UplusV < _2q, UplusV, UplusV - _2q)
        UminusV = jnp.where(UminusV < _2q, UminusV, UminusV - _2q)
        x = jnp.stack([UplusV, UminusV], axis=-2).reshape(*lead, N)
    return x


def _pair_consts(pack: ModPack):
    from tiberate_tpu.ops import pallas_mont as pm

    u32 = lambda a: a.astype(jnp.uint32)
    q2lo, q2hi = pm.to_pair(pack._2q)
    return (
        u32(pack.ql), u32(pack.qh), u32(pack.kl), u32(pack.kh), q2lo, q2hi
    )


def _ntt_pair(x, psi, pack: ModPack, Rs=None):
    """uint32-pair forward butterflies (nonnegative domain only).

    Bit-identical to the int64 path for inputs in [0, 2^62)."""
    from tiberate_tpu.ops import pallas_mont as pm

    N = x.shape[-1]
    logN = N.bit_length() - 1
    lead = x.shape[:-1]
    ex = (...,) + (None,) * 1

    ql, qh, kl, kh, q2lo, q2hi = _pair_consts(pack)
    lo, hi = pm.to_pair(x)
    plo, phi = pm.to_pair(psi)
    if Rs is not None:
        rlo, rhi = pm.to_pair(Rs)
        lo, hi = pm.mont_mult_pair(lo, hi, rlo, rhi, ql, qh, kl, kh)

    bshape = (1,) * (len(lead) - 1)
    for logm in range(logN):
        m = 1 << logm
        t = N >> (logm + 1)
        vl = lo.reshape(*lead, m, 2, t)
        vh = hi.reshape(*lead, m, 2, t)
        Ul, Uh = vl[..., 0, :], vh[..., 0, :]
        Ol, Oh = vl[..., 1, :], vh[..., 1, :]
        Sl = plo[:, m : 2 * m].reshape(*bshape, -1, m, 1)
        Sh = phi[:, m : 2 * m].reshape(*bshape, -1, m, 1)
        Wl, Wh = pm.mont_mult_pair(
            Sl, Sh, Ol, Oh, ql[ex], qh[ex], kl[ex], kh[ex]
        )
        el, eh = pm.mont_add_pair(Ul, Uh, Wl, Wh, q2lo[ex], q2hi[ex])
        sl, sh = pm.mont_sub_pair(Ul, Uh, Wl, Wh, q2lo[ex], q2hi[ex])
        lo = jnp.stack([el, sl], axis=-2).reshape(*lead, N)
        hi = jnp.stack([eh, sh], axis=-2).reshape(*lead, N)
    return pm.from_pair(lo, hi)


def ntt(x, psi, pack: ModPack, signed: bool = False):
    """Forward negacyclic NTT, in Montgomery domain, lazy [0,2q) bounds.

    x: [..., C, N] int64 (Montgomery form, < 2q; with ``signed`` negative
    representatives are also accepted — int64 path only).
    psi: [C, N] — bit-reversed ψ power series in Montgomery form.
    """
    if not signed and _use_pair() and pack.ql.dtype == jnp.int64:
        return _ntt_pair(x, psi, pack)
    return _ntt_i64(x, psi, pack)


def intt_core(x, ipsi, pack: ModPack):
    """Inverse butterflies only (Gentleman-Sande), no N^-1 scaling."""
    N = x.shape[-1]
    logN = N.bit_length() - 1
    lead = x.shape[:-1]

    for logm in range(logN, 0, -1):
        h = 1 << (logm - 1)  # number of groups
        t = N >> logm
        xv = x.reshape(*lead, h, 2, t)
        U = xv[..., 0, :]
        V = xv[..., 1, :]
        S = ipsi[:, h : 2 * h].reshape(
            *((1,) * (len(lead) - 1)), -1, h, 1
        )
        _2q = pack._2q[..., None]
        W = U + V
        W = jnp.where(W < _2q, W, W - _2q)
        D = U + _2q - V
        D = jnp.where(D < _2q, D, D - _2q)
        Vn = mont.mont_mult_raw(
            S, D, pack.ql[..., None], pack.qh[..., None],
            pack.kl[..., None], pack.kh[..., None],
        )
        x = jnp.stack([W, Vn], axis=-2).reshape(*lead, N)
    return x


def _intt_pair(x, ipsi, Ninv, pack: ModPack, epilogue: str = "mont"):
    """uint32-pair inverse butterflies + N^-1 fold + optional epilogue."""
    from tiberate_tpu.ops import pallas_mont as pm

    N = x.shape[-1]
    logN = N.bit_length() - 1
    lead = x.shape[:-1]
    ex = (...,) + (None,)

    ql, qh, kl, kh, q2lo, q2hi = _pair_consts(pack)
    lo, hi = pm.to_pair(x)
    plo, phi = pm.to_pair(ipsi)

    bshape = (1,) * (len(lead) - 1)
    for logm in range(logN, 0, -1):
        h = 1 << (logm - 1)
        t = N >> logm
        vl = lo.reshape(*lead, h, 2, t)
        vh = hi.reshape(*lead, h, 2, t)
        Ul, Uh = vl[..., 0, :], vh[..., 0, :]
        Vl, Vh = vl[..., 1, :], vh[..., 1, :]
        Sl = plo[:, h : 2 * h].reshape(*bshape, -1, h, 1)
        Sh = phi[:, h : 2 * h].reshape(*bshape, -1, h, 1)
        wl, wh = pm.mont_add_pair(Ul, Uh, Vl, Vh, q2lo[ex], q2hi[ex])
        dl, dh = pm.mont_sub_pair(Ul, Uh, Vl, Vh, q2lo[ex], q2hi[ex])
        nl, nh = pm.mont_mult_pair(
            Sl, Sh, dl, dh, ql[ex], qh[ex], kl[ex], kh[ex]
        )
        lo = jnp.stack([wl, nl], axis=-2).reshape(*lead, N)
        hi = jnp.stack([wh, nh], axis=-2).reshape(*lead, N)

    nlo, nhi = pm.to_pair(Ninv)
    lo, hi = pm.mont_mult_pair(lo, hi, nlo, nhi, ql, qh, kl, kh)
    if epilogue in ("exit", "exit_reduce"):
        lo, hi = pm.mont_reduce_pair(lo, hi, ql, qh, kl, kh)
    if epilogue == "exit_reduce":
        qlo, qhi = pm.to_pair(pack._2q >> 1)
        lo, hi = pm.reduce_2q_pair(lo, hi, qlo, qhi)
    return pm.from_pair(lo, hi)


def intt(x, ipsi, Ninv, pack: ModPack):
    """Inverse NTT staying in the Montgomery domain.

    Ninv: [C, 1] = N^-1 * R mod q (plain-int storage); the final mont_mult
    folds both the 1/N normalization and keeps the R factor, matching the
    reference ``intt_cuda`` (``csrc/cuda/ntt_cuda.cu:229-310``).
    """
    if _use_pair() and pack.ql.dtype == jnp.int64:
        return _intt_pair(x, ipsi, Ninv, pack, epilogue="mont")
    x = intt_core(x, ipsi, pack)
    return mont.mont_mult(x, Ninv, pack)


def enter_ntt(x, Rs, psi, pack: ModPack):
    """mont_enter then forward NTT (reference ``enter_ntt_cuda``).

    Inputs are unsigned residues (tile_unsigned/reduce_2q outputs)."""
    if _use_pair() and pack.ql.dtype == jnp.int64:
        return _ntt_pair(x, psi, pack, Rs=Rs)
    return _ntt_i64(mont.mont_enter(x, Rs, pack), psi, pack)


def intt_exit(x, ipsi, Ninv, pack: ModPack):
    """iNTT then exit Montgomery (reference ``intt_exit_cuda``)."""
    if _use_pair() and pack.ql.dtype == jnp.int64:
        return _intt_pair(x, ipsi, Ninv, pack, epilogue="exit")
    return mont.mont_reduce(intt(x, ipsi, Ninv, pack), pack)


def intt_exit_reduce(x, ipsi, Ninv, pack: ModPack):
    if _use_pair() and pack.ql.dtype == jnp.int64:
        return _intt_pair(x, ipsi, Ninv, pack, epilogue="exit_reduce")
    return mont.reduce_2q(intt_exit(x, ipsi, Ninv, pack), pack)


def intt_exit_reduce_signed(x, ipsi, Ninv, pack: ModPack):
    return mont.make_signed(intt_exit_reduce(x, ipsi, Ninv, pack), pack)


# ----------------------------------------------------------------------
# Host-side table construction (numpy / python ints).
# ----------------------------------------------------------------------


def primitive_root_2N(q: int, N: int) -> int:
    """Smallest-witness primitive 2N-th root of unity mod q.

    Same search as the reference (``ntt_context.py:14-22``): scan x = 2, 3, …
    and take g = x^((q-1)/2N); accept when g^N != 1 (so ord(g) = 2N).
    """
    _2N = 2 * N
    if (q - 1) % _2N != 0:
        raise ValueError(f"q={q} is not NTT-friendly for N={N} (q != 1 mod 2N)")
    K = (q - 1) // _2N
    for x in range(2, N):
        g = pow(x, K, q)
        if pow(g, N, q) != 1:
            return g
    raise RuntimeError(f"no primitive 2N-th root found for q={q}")


def bit_reverse(a: int, nbits: int) -> int:
    r = 0
    for _ in range(nbits):
        r = (r << 1) | (a & 1)
        a >>= 1
    return r


def make_psi_tables(q_list, logN: int):
    """Bit-reversed ψ / ψ^-1 power series per prime (plain ints).

    Returns (psi, ipsi): lists of length len(q_list), each a list of N ints:
    ``psi[c][j] = ψ_c^{bitrev(j, logN)} mod q_c`` — the same twiddle layout
    the reference builds in ``ntt_context.py:42-78``.
    """
    N = 1 << logN
    brind = [bit_reverse(i, logN) for i in range(N)]
    psi_out, ipsi_out = [], []
    for q in q_list:
        g = primitive_root_2N(q, N)
        gi = pow(g, -1, q)
        # power series then bit-reverse-index
        ps = [1] * N
        ips = [1] * N
        for i in range(1, N):
            ps[i] = ps[i - 1] * g % q
            ips[i] = ips[i - 1] * gi % q
        psi_out.append([ps[b] for b in brind])
        ipsi_out.append([ips[b] for b in brind])
    return psi_out, ipsi_out


def negacyclic_ntt_oracle(coeffs, q: int, logN: int):
    """O(N^2) exact negacyclic transform evaluation for tests.

    Evaluates the polynomial at ψ^(2*bitrev(j)+1)?  No — instead of fixing an
    output permutation analytically, tests compare round-trips and pointwise
    products, which are permutation-independent.  This helper returns the
    *sorted multiset-free* canonical evaluation at ψ^(2k+1) in natural k
    order for cross-checks of convolution identities.
    """
    N = 1 << logN
    g = primitive_root_2N(q, N)
    out = []
    for k in range(N):
        root = pow(g, 2 * k + 1, q)
        acc = 0
        x = 1
        for c in coeffs:
            acc = (acc + c * x) % q
            x = x * root % q
        out.append(acc)
    return out
