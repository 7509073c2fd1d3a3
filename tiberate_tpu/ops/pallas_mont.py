"""uint32-pair (64-bit limb) modular arithmetic in plain ``jnp``.

62-bit residues travel as ``(lo, hi)`` uint32 pairs and every multiply is
built from 16-bit splits whose partial products fit 32 bits, for
backends whose vector units lack 64-bit integer multiplies.  Used by the
opt-in pair NTT (``ops/ntt.py``, ``TIBERATE_PAIR_NTT=1``).  The algorithms are the same
31-bit-half Montgomery REDC as ``ops/mont.py`` (and the reference CUDA,
``csrc/cuda/mont_cuda_kernel.cuh:11-60``), restricted to the *unsigned*
[0, 2^62) domain — the NTT/elementwise hot paths only see nonnegative
representatives; signed paths (rescale deltas, basis-extension digits)
stay on the int64 jnp implementation.

All helpers are plain jnp-on-uint32 functions: they run identically under
XLA on any backend and in numpy-backed tests — bit-exactness is validated
against ``mont.mont_mult`` directly.
"""

import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32
M16 = np.uint32(0xFFFF)
M31 = np.uint32(0x7FFFFFFF)
M30 = np.uint32(0x3FFFFFFF)


def to_pair(x):
    """int64/uint64 array -> (lo, hi) uint32 pair (outside kernels)."""
    x = x.astype(jnp.uint64)
    return (
        (x & jnp.uint64(0xFFFFFFFF)).astype(U32),
        (x >> jnp.uint64(32)).astype(U32),
    )


def from_pair(lo, hi, dtype=jnp.int64):
    """(lo, hi) uint32 pair -> int64 array (outside kernels)."""
    return (
        lo.astype(jnp.uint64) | (hi.astype(jnp.uint64) << jnp.uint64(32))
    ).astype(dtype)


# ----------------------------------------------------------------------
# Pair primitives (all uint32, usable inside Mosaic kernels).
# ----------------------------------------------------------------------


def sp16(x):
    """16-bit halves of a u32 (hoist for repeated mul31 operands)."""
    return x & M16, x >> U32(16)


def mul31(x, y, xs=None, ys=None):
    """31-bit x 31-bit -> 62-bit as (lo, hi).  x, y < 2^31.
    ``xs``/``ys``: optional pre-split halves from :func:`sp16`.  The low
    lane is the native u32 multiply; the high lane's carry folds through
    mm + (ll >> 16), which cannot overflow for 31-bit operands."""
    x0, x1 = xs if xs is not None else sp16(x)  # x1 < 2^15
    y0, y1 = ys if ys is not None else sp16(y)
    ll = x0 * y0
    mm = x1 * y0 + x0 * y1  # < 2^32: no overflow for 31-bit inputs
    hi = x1 * y1 + ((mm + (ll >> U32(16))) >> U32(16))
    return x * y, hi


def add64(alo, ahi, blo, bhi):
    lo = alo + blo
    carry = (lo < alo).astype(U32)
    return lo, ahi + bhi + carry


def add64_u32(alo, ahi, b):
    lo = alo + b
    carry = (lo < alo).astype(U32)
    return lo, ahi + carry


def sub64(alo, ahi, blo, bhi):
    lo = alo - blo
    borrow = (alo < blo).astype(U32)
    return lo, ahi - bhi - borrow


def lt64(alo, ahi, blo, bhi):
    return (ahi < bhi) | ((ahi == bhi) & (alo < blo))


def le64(alo, ahi, blo, bhi):
    return (ahi < bhi) | ((ahi == bhi) & (alo <= blo))


def shr31(lo, hi):
    """Logical right shift by 31 of a pair (value < 2^64)."""
    return (lo >> U32(31)) | (hi << U32(1)), hi >> U32(31)


def shl31(lo, hi):
    """Left shift by 31 (mod 2^64)."""
    return lo << U32(31), (hi << U32(31)) | (lo >> U32(1))


def split31(lo, hi):
    """value -> (low 31 bits, value >> 31).  High part must fit uint32,
    i.e. value < 2^63."""
    return lo & M31, (hi << U32(1)) | (lo >> U32(31))


# ----------------------------------------------------------------------
# Montgomery REDC on pairs.
# Per-channel constants ql/qh/kl/kh are plain uint32 (each < 2^31).
# ----------------------------------------------------------------------


def mont_mult_pair(alo, ahi, blo, bhi, ql, qh, kl, kh):
    """a * b * R^-1 with R = 2^62; a, b in [0, 2^62); result < 2q.

    Bit-identical to ``mont.mont_mult_raw`` on unsigned inputs.
    """
    al, ah = split31(alo, ahi)  # a < 2^62 -> ah < 2^31
    bl, bh = split31(blo, bhi)
    als, ahs = sp16(al), sp16(ah)
    bls, bhs = sp16(bl), sp16(bh)

    glo, ghi = mul31(al, bl, als, bls)  # gamma < 2^62
    b1 = mul31(ah, bl, ahs, bls)
    b2 = mul31(al, bh, als, bhs)
    btlo, bthi = add64(*b1, *b2)  # beta < 2^63
    aplo, aphi = mul31(ah, bh, ahs, bhs)  # alpha < 2^62

    gammal, gammah = split31(glo, ghi)  # gammah < 2^31
    betal, betah = split31(btlo, bthi)  # betah < 2^32 (fits u32)
    gls = sp16(gammal)

    # upper = gammal*kh + (gammah + betal)*kl      (mod 2^64)
    t = gammah + betal  # < 2^32
    plo, phi = mul31(t & M31, kl)
    tbit = t >> U32(31)  # 0 or 1
    # + tbit * (kl << 31)
    plo, phi = add64(plo, phi, tbit * (kl << U32(31)),
                     tbit * (kl >> U32(1)))
    ulo, uhi = add64(*mul31(gammal, kh, gls), plo, phi)

    # s = ((upper << 31) + gammal*kl) & (2^62 - 1)
    slo, shi = shl31(ulo, uhi)
    slo, shi = add64(slo, shi, *mul31(gammal, kl, gls))
    shi = shi & M30

    sl, sh = split31(slo, shi)  # sh < 2^31
    sls, shs = sp16(sl), sp16(sh)

    # sqb = sh*ql + sl*qh
    sqlo, sqhi = add64(*mul31(sh, ql, shs), *mul31(sl, qh, sls))  # < 2^63
    sqbl, sqbh = split31(sqlo, sqhi)  # sqbh < 2^32

    # carry = ((gamma + sl*ql) >> 31 + betal + sqbl) >> 31
    c1lo, c1hi = add64(glo, ghi, *mul31(sl, ql, sls))
    c1lo, c1hi = shr31(c1lo, c1hi)
    c2lo, c2hi = add64_u32(c1lo, c1hi, betal)
    c2lo, c2hi = add64_u32(c2lo, c2hi, sqbl)
    c2lo, c2hi = shr31(c2lo, c2hi)

    rlo, rhi = add64(aplo, aphi, *mul31(sh, qh, shs))
    rlo, rhi = add64_u32(rlo, rhi, betah)
    rlo, rhi = add64_u32(rlo, rhi, sqbh)
    rlo, rhi = add64(rlo, rhi, c2lo, c2hi)
    return rlo, rhi


def mont_reduce_pair(xlo, xhi, ql, qh, kl, kh):
    """x * R^-1 (REDC exit), x in [0, 2^62)."""
    xl, xh = split31(xlo, xhi)
    xls = sp16(xl)
    # xkb = xh*kl + xl*kh
    xklo, xkhi = add64(*mul31(xh, kl), *mul31(xl, kh, xls))
    slo, shi = shl31(xklo, xkhi)
    slo, shi = add64(slo, shi, *mul31(xl, kl, xls))
    shi = shi & M30
    sl, sh = split31(slo, shi)
    sls, shs = sp16(sl), sp16(sh)

    sqlo, sqhi = add64(*mul31(sh, ql, shs), *mul31(sl, qh, sls))
    sqbl, sqbh = split31(sqlo, sqhi)

    c1lo, c1hi = add64(xlo, xhi, *mul31(sl, ql, sls))
    c1lo, c1hi = shr31(c1lo, c1hi)
    c2lo, c2hi = add64_u32(c1lo, c1hi, sqbl)
    c2lo, c2hi = shr31(c2lo, c2hi)

    rlo, rhi = add64_u32(*mul31(sh, qh, shs), sqbh)
    rlo, rhi = add64(rlo, rhi, c2lo, c2hi)
    return rlo, rhi


def mont_add_pair(alo, ahi, blo, bhi, q2lo, q2hi):
    slo, shi = add64(alo, ahi, blo, bhi)
    keep = lt64(slo, shi, q2lo, q2hi)
    dlo, dhi = sub64(slo, shi, q2lo, q2hi)
    return jnp.where(keep, slo, dlo), jnp.where(keep, shi, dhi)


def mont_sub_pair(alo, ahi, blo, bhi, q2lo, q2hi):
    slo, shi = add64(alo, ahi, q2lo, q2hi)
    slo, shi = sub64(slo, shi, blo, bhi)
    keep = lt64(slo, shi, q2lo, q2hi)
    dlo, dhi = sub64(slo, shi, q2lo, q2hi)
    return jnp.where(keep, slo, dlo), jnp.where(keep, shi, dhi)


def reduce_2q_pair(alo, ahi, qlo, qhi):
    keep = lt64(alo, ahi, qlo, qhi)
    dlo, dhi = sub64(alo, ahi, qlo, qhi)
    return jnp.where(keep, alo, dlo), jnp.where(keep, ahi, dhi)
