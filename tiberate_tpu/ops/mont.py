"""Branchless Montgomery modular arithmetic on ``int64`` RNS tensors.

A JAX reimplementation of the reference CUDA kernels
(``csrc/cuda/mont_cuda_kernel.cuh``, ``csrc/cuda/mont_cuda.cu``): identical
31-bit-half REDC with ``R = 2^62`` and the lazy ``[0, 2q)`` representative
convention (no conditional subtraction, valid because ``4q < R``).

Signedness matters: the reference kernels run on *signed* int64
(``scalar_t = int64_t``) — arithmetic right shifts and signed compares — and
the engine deliberately feeds negative representatives through REDC (e.g. the
``d - rescaler`` difference in rescale, the ``a - state`` deltas in basis
extension, sign-flipped rotation outputs).  We therefore use jnp.int64
throughout; XLA's int64 mul/add wrap mod 2^64 exactly like the GPU, ``>>`` is
arithmetic, and comparisons are signed, so every kernel here is bit-identical
to its CUDA counterpart on *any* input the reference accepts.

All functions are pure (jit-friendly) and operate on arrays shaped
``[..., C, N]`` with per-channel constants shaped ``[C, 1]``.

Glossary (matches the reference):

* ``mont_mult(a, b)``  -> ``a * b * R^-1`` (REDC), lazy [0, 2q) bounds
* ``mont_enter(a)``    -> ``a * R``  (multiply by R^2 then REDC)
* ``mont_reduce(a)``   -> ``a * R^-1`` (exit Montgomery domain)
* ``mont_add/sub``     -> lazy add/sub in [0, 2q)
* ``reduce_2q``        -> [0, 2q) -> [0, q)
* ``make_signed``      -> [0, q) -> centered (-q/2, q/2]
* ``make_unsigned``    -> centered -> [0, q)
* ``tile_unsigned``    -> broadcast signed [N] poly into [C, N] unsigned RNS
"""

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

I64 = jnp.int64

HALF_BITS = 31
NBITS = 62
LB_MASK = np.int64((1 << HALF_BITS) - 1)
FB_MASK = np.int64((1 << NBITS) - 1)

# 30-bit buffer_bit_length mode: int32 storage, 15-bit halves, R = 2^30 —
# the same templated kernel the reference dispatches for int32 tensors
# (``csrc/mont.cpp:17-24`` DISPATCH over scalar_t).  Constants are selected
# from the operand dtype so every function below serves both modes.
HALF_BITS_30 = 15
NBITS_30 = 30
LB_MASK_30 = np.int32((1 << HALF_BITS_30) - 1)
FB_MASK_30 = np.int32((1 << NBITS_30) - 1)


def _mode(ql):
    """(half_bits, lb_mask, fb_mask) from the constant dtype."""
    if ql.dtype == jnp.int32:
        return HALF_BITS_30, LB_MASK_30, FB_MASK_30
    return HALF_BITS, LB_MASK, FB_MASK


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class ModPack:
    """Per-channel Montgomery constants, each shaped ``[C, 1]`` int64.

    The packed equivalent of the reference's ``mont_pack``/``_2q`` argument
    tuples (``ntt_context.py:309-332``).
    """

    ql: jax.Array
    qh: jax.Array
    kl: jax.Array
    kh: jax.Array
    _2q: jax.Array

    def tree_flatten(self):
        return (self.ql, self.qh, self.kl, self.kh, self._2q), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def num_channels(self):
        return self.ql.shape[0]

    def __getitem__(self, sl):
        """Slice the channel axis (static slices only, for level views)."""
        return ModPack(
            ql=self.ql[sl],
            qh=self.qh[sl],
            kl=self.kl[sl],
            kh=self.kh[sl],
            _2q=self._2q[sl],
        )

    def expand(self, extra_dims: int):
        """Append singleton dims for broadcasting against [..., C, N, ...]."""
        if extra_dims == 0:
            return self
        idx = (Ellipsis,) + (None,) * extra_dims
        return ModPack(
            ql=self.ql[idx],
            qh=self.qh[idx],
            kl=self.kl[idx],
            kh=self.kh[idx],
            _2q=self._2q[idx],
        )

    @classmethod
    def from_q(cls, q_list, R_bits=NBITS):
        """Build from a list of python-int moduli (R_bits: 62 or 30)."""
        q = [int(x) for x in q_list]
        R = 1 << R_bits
        half = R_bits // 2
        mask = (1 << half) - 1
        dt = np.int32 if R_bits == NBITS_30 else np.int64
        k = [(R * pow(R, -1, qi) - 1) // qi for qi in q]
        col = lambda v: jnp.array(np.array(v, dtype=dt).reshape(-1, 1))
        return cls(
            ql=col([qi & mask for qi in q]),
            qh=col([qi >> half for qi in q]),
            kl=col([ki & mask for ki in k]),
            kh=col([ki >> half for ki in k]),
            _2q=col([qi << 1 for qi in q]),
        )


def _split(x, half=HALF_BITS, mask=LB_MASK):
    # Arithmetic right shift, bitwise mask — exactly the CUDA split.
    return x & mask, x >> half


def mont_mult_raw(a, b, ql, qh, kl, kh):
    """Core REDC: returns ``a*b*R^-1`` with the lazy [0,2q) bound.

    Bit-identical to ``mont_mult_scalar_cuda_kernel``
    (``csrc/cuda/mont_cuda_kernel.cuh:11-60``) including behavior on signed
    inputs; the 30-bit mode runs the identical dataflow on int32 with
    15-bit halves (what the reference's int32 template instantiates).
    """
    half, mask, fb = _mode(ql)
    al, ah = _split(a, half, mask)
    bl, bh = _split(b, half, mask)

    alpha = ah * bh
    beta = ah * bl + al * bh
    gamma = al * bl

    gammal, gammah = _split(gamma, half, mask)
    betal, betah = _split(beta, half, mask)

    upper = gammal * kh
    upper = upper + (gammah + betal) * kl
    upper = upper << half
    s = (upper + gammal * kl) & fb

    sl, sh = _split(s, half, mask)
    sqb = sh * ql + sl * qh
    sqbl, sqbh = _split(sqb, half, mask)

    carry = (gamma + sl * ql) >> half
    carry = (carry + betal + sqbl) >> half

    return alpha + betah + sqbh + carry + sh * qh


def mont_reduce_raw(x, ql, qh, kl, kh):
    """REDC of a single operand: returns ``x * R^-1`` (exit Montgomery).

    Bit-identical to ``mont_reduce_cuda_kernel``
    (``csrc/cuda/mont_cuda_kernel.cuh:90-137``).
    """
    half, mask, fb = _mode(ql)
    xl, xh = _split(x, half, mask)
    xkb = xh * kl + xl * kh
    s = ((xkb << half) + xl * kl) & fb

    sl, sh = _split(s, half, mask)
    sqb = sh * ql + sl * qh
    sqbl, sqbh = _split(sqb, half, mask)
    carry = (x + sl * ql) >> half
    carry = (carry + sqbl) >> half

    return sqbh + carry + sh * qh


# ----------------------------------------------------------------------
# Packed wrappers.
# ----------------------------------------------------------------------


def mont_mult(a, b, pack: ModPack):
    return mont_mult_raw(a, b, pack.ql, pack.qh, pack.kl, pack.kh)


def mont_enter(a, Rs, pack: ModPack):
    """a -> a * R, with Rs = R^2 mod q per channel (``[C, 1]``)."""
    return mont_mult_raw(a, Rs, pack.ql, pack.qh, pack.kl, pack.kh)


def mont_reduce(a, pack: ModPack):
    return mont_reduce_raw(a, pack.ql, pack.qh, pack.kl, pack.kh)


def mont_add(a, b, pack: ModPack):
    """Lazy modular add: inputs in [0,2q), output in [0,2q)."""
    s = a + b
    return jnp.where(s < pack._2q, s, s - pack._2q)


def mont_sub(a, b, pack: ModPack):
    """Lazy modular sub: inputs in [0,2q), output in [0,2q)."""
    s = a + pack._2q - b
    return jnp.where(s < pack._2q, s, s - pack._2q)


def reduce_2q(a, pack: ModPack):
    """[0, 2q) -> [0, q) (signed compare, like ``reduce_2q_cuda_kernel``)."""
    q = pack._2q >> 1
    return jnp.where(a < q, a, a - q)


def make_signed(a, pack: ModPack):
    """[0, q) -> centered representative in (-q/2, q/2].

    Matches ``make_signed_cuda_kernel`` (``mont_cuda_kernel.cuh:168-184``).
    """
    q = pack._2q >> 1
    q_half = q >> 1
    return jnp.where(a <= q_half, a, a - q)


def make_unsigned(a, pack: ModPack):
    """Centered representative -> [0, q)."""
    q = pack._2q >> 1
    return jnp.where(a < 0, a + q, a)


def tile_unsigned(a, pack: ModPack):
    """Broadcast a signed ``[..., N]`` polynomial (values in (-q, q)) into
    unsigned ``[..., C, N]`` RNS residues.

    Matches ``tile_unsigned_cuda`` (``csrc/cuda/mont_cuda.cu:340-356``).
    RNG/codec outputs arrive as int64; cast to the pack's storage dtype
    (int32 in the 30-bit mode, where inputs are < 2^28 by construction).
    """
    q = pack._2q >> 1
    a = jnp.asarray(a).astype(pack.ql.dtype)[..., None, :]
    tiled = jnp.broadcast_to(
        a, (*a.shape[:-2], pack.num_channels, a.shape[-1])
    )
    return jnp.where(tiled < 0, tiled + q, tiled)


# ----------------------------------------------------------------------
# Slow exact oracle (python ints) for parity tests.
# ----------------------------------------------------------------------


def mont_mult_oracle(a: int, b: int, q: int, R_bits: int = NBITS) -> int:
    """Schoolbook REDC with python ints; same representative as mont_mult."""
    R = 1 << R_bits
    k = (R * pow(R, -1, q) - 1) // q
    x = a * b
    s = (x * k) % R
    t = x + s * q
    assert t % R == 0
    return t >> R_bits
