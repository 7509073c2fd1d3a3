"""CKKS codec: canonical-embedding encode/decode and slot permutations.

Behavioral equivalent of the reference ``tiberate/utils/encoding.py``.  The
codec is host-side, low-rate work where fp64 precision matters more than
throughput, so it runs in numpy (complex128) on the host and no float
matmul or FFT reaches the device.  Device-side pieces (rotation /
conjugation coefficient permutations) return index/sign tables applied as
jnp gathers by the engine.

Math: encode = pre-permute slots (circular-shift ∘ folded canonical
permutation conjugation), twist by ``e^{-iπn/N}``, FFT, keep real part,
scale, stochastic-round; decode reverses with the ``skewer``.  Rotation by
delta = signed coefficient permutation induced by the Galois map ``X ->
X^{3^delta}`` — a permutation of the polynomial itself, no NTT involved
(reference ``encoding.py:275-293``).
"""

from functools import lru_cache

import numpy as np


def padding(m, num_slots: int):
    if isinstance(m, (int, float, complex)):
        m = [m]
    m = np.asarray(m)
    if m.ndim != 1:
        raise ValueError(f"message must be 1-D, got {m.ndim}-D")
    if len(m) > num_slots:
        raise ValueError(f"message too long: {len(m)} > {num_slots} slots")
    return np.pad(m, (0, num_slots - len(m)))


# ---------------------------------------------------------------
# Permutations.
# ---------------------------------------------------------------


def circular_shift_permutation(N, shift=1):
    left = np.roll(np.arange(N // 2), shift)
    right = np.roll(np.arange(N // 2), -shift) + N // 2
    return np.concatenate([left, right])


def canon_permutation(N, k=1):
    """mu_p(n) = p*n mod 2N with p = 2k+1 (length 2N)."""
    M = 2 * N
    p = int(2 * k + 1)
    return p * np.arange(M) % M


def fold_permutation(p):
    """Fold the FFT at Nyquist: select odd entries, map (x-1)/2."""
    return (p[1::2] - 1) // 2


def permutation_cycles(perm):
    pi = {i: int(perm[i]) for i in range(len(perm))}
    cycles = []
    while pi:
        start = next(iter(pi))
        cur = pi[start]
        nxt = pi[cur]
        cycle = []
        while True:
            cycle.append(cur)
            del pi[cur]
            cur = nxt
            if nxt in pi:
                nxt = pi[nxt]
            else:
                break
        cycles.append(cycle)
    return cycles


def conjugate_permutation(p, q):
    """Conjugate permutations p and q by stacking p on top of q."""
    pc = permutation_cycles(p)
    qc = permutation_cycles(q)
    if [len(c) for c in pc] != [len(c) for c in qc]:
        raise ValueError("cycle structures must match")
    pe = np.array([i for c in pc for i in c])
    qe = np.array([i for c in qc for i in c])
    r = np.zeros_like(p)
    r[qe] = pe
    return r


def inverse_permutation(p):
    return np.arange(len(p))[np.argsort(p)]


@lru_cache(maxsize=None)
def prepost_perms(N):
    """(pre_perm [N/2], post_perm [N]) for poly degree N."""
    circ_shift = circular_shift_permutation(N)
    canon_perm = canon_permutation(N)
    fold_perm = fold_permutation(canon_perm)
    post_perm = conjugate_permutation(circ_shift, fold_perm)
    pre_perm = inverse_permutation(post_perm)[: N // 2]
    return pre_perm, post_perm


@lru_cache(maxsize=None)
def _twister(N):
    return np.exp(-1j * np.pi * np.arange(N, dtype=np.float64) / N)


@lru_cache(maxsize=None)
def _skewer(N):
    return np.exp(1j * np.pi * np.arange(N, dtype=np.float64) / N)


def pre_permute(m, pre_perm):
    """[N/2] slots -> [N] conjugate-mirrored pre-permuted message."""
    N2 = len(m) * 2
    permed = np.zeros(N2, dtype=np.complex128)
    permed[pre_perm] = m
    return permed + np.conj(permed)[::-1]


def post_permute(m, post_perm):
    permed = np.zeros_like(m)
    permed[post_perm] = m
    return permed


# ---------------------------------------------------------------
# Negacyclic FFT.
# ---------------------------------------------------------------


def _fft(x, norm):
    return np.fft.fft(x, norm=norm)


def _ifft(x, norm):
    return np.fft.ifft(x, norm=norm)


def m2poly(m, twister, norm="backward"):
    return (_fft(m, norm) * twister).real


def poly2m(poly, skewer, norm="backward"):
    return _ifft(poly * skewer, norm)


# ---------------------------------------------------------------
# Rotation / conjugation coefficient permutations (table builders).
# ---------------------------------------------------------------


@lru_cache(maxsize=None)
def rotation_perm_tables(N: int, leap: int):
    """Gather tables for the Galois coefficient permutation with the given
    leap: returns (src_index [N] int32, sign [N] int64) such that
    ``out[j] = sign[j] * x[src_index[j]]``.

    The scatter form (reference ``encoding.py:275-293``) is
    ``out[perm_folded[i]] = perm_sign[i] * x[i]``; we invert it into a
    gather, which needs no scatter on the device.
    """
    perm = canon_permutation(N, leap)[:N]
    perm_folded = perm % N
    perm_sign = 1 - 2 * ((perm // N) % 2)  # (-1)^(perm//N)
    src = np.empty(N, dtype=np.int64)
    src[perm_folded] = np.arange(N)
    sign = np.empty(N, dtype=np.int64)
    sign[perm_folded] = perm_sign
    return src.astype(np.int32), sign


def rotate_leap(delta: int, N: int) -> int:
    """leap k such that rotation by delta uses p = 2k+1 = 3^(delta mod N)."""
    shift = delta % N
    return (pow(3, shift, 2 * N) - 1) // 2 % (2 * N)


def conjugate_leap(N: int) -> int:
    return N - 1


def rotate_np(m, delta):
    """Numpy rotation (for the oracle / host paths). m: [..., N]."""
    N = m.shape[-1]
    src, sign = rotation_perm_tables(N, rotate_leap(delta, N))
    return sign * m[..., src]


def conjugate_np(m):
    N = m.shape[-1]
    src, sign = rotation_perm_tables(N, conjugate_leap(N))
    return sign * m[..., src]


# ---------------------------------------------------------------
# Encode / decode.
# ---------------------------------------------------------------


def encode(
    m,
    rng=None,
    scale=2**40,
    deviation=1.0,
    norm="forward",
    return_without_scaling=False,
):
    """Message slots [N/2] -> signed integer coefficients [N] (numpy int64).

    With ``return_without_scaling`` the raw float coefficients are returned
    (used by the engine's bias_guard DC split, reference
    ``ckks_engine.py:1806-1826``).
    """
    m = np.asarray(m)
    N = len(m) * 2
    pre_perm, _ = prepost_perms(N)
    mm = m * deviation
    mm = pre_permute(mm, pre_perm)
    coeffs = m2poly(mm, _twister(N), norm)
    if return_without_scaling:
        return coeffs
    return rng.randround(coeffs * np.float64(scale))


def encode_batch(
    ms,
    rng=None,
    scale=2**40,
    deviation=1.0,
    norm="forward",
    return_without_scaling=False,
):
    """Batched :func:`encode`: [B, N/2] message slots -> [B, N] signed
    integer coefficients, ONE vectorized FFT + ONE device stochastic-
    rounding dispatch for the whole batch (the reference encodes
    on-device, ``encoding.py:202-216``; per-message host FFT + rounding
    serializes the batched-inference hot loop).  Bit-identical
    to B sequential :func:`encode` calls (``Csprng.randround_batch``
    reproduces the sequential counter trajectory exactly)."""
    ms = np.asarray(ms)
    if ms.ndim != 2:
        raise ValueError(f"expected [B, slots] messages, got {ms.shape}")
    B, slots = ms.shape
    N = 2 * slots
    pre_perm, _ = prepost_perms(N)
    permed = np.zeros((B, N), dtype=np.complex128)
    permed[:, pre_perm] = ms * deviation
    mm = permed + np.conj(permed)[:, ::-1]
    coeffs = (_fft(mm, norm) * _twister(N)).real
    if return_without_scaling:
        return coeffs
    return rng.randround_batch(coeffs * np.float64(scale))


def decode_batch(ms, scale=2**40, correction=1.0, norm="forward"):
    """Batched :func:`decode`: [B, N] coefficients -> [B, N] complex
    slots (pre-truncation), one vectorized iFFT."""
    ms = np.asarray(ms)
    N = ms.shape[-1]
    _, post_perm = prepost_perms(N)
    mm = _ifft(ms * _skewer(N), norm) / scale * correction
    out = np.zeros_like(mm)
    out[:, post_perm] = mm
    return out


def decode(
    m,
    scale=2**40,
    correction=1.0,
    norm="forward",
    return_without_scaling=False,
):
    """Signed integer coefficients [N] -> complex slots [N] (pre-truncation)."""
    m = np.asarray(m)
    N = len(m)
    _, post_perm = prepost_perms(N)
    if return_without_scaling:
        mm = poly2m(m, _skewer(N), norm=norm)
        return post_permute(mm, post_perm)
    mm = poly2m(m, _skewer(N), norm=norm) / scale * correction
    return post_permute(mm, post_perm)
