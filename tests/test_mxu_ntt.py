"""int8 4-step NTT: residue parity vs the radix-2 kernels (CPU-runnable).

The 4-step transform must produce the SAME residues (mod q) as ops/ntt.py
in the same output order for every variant; lazy [0, 2q) representatives
may differ, so comparisons go through reduce_2q.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tiberate_tpu.ops import mont, mxu_ntt
from tiberate_tpu.ops import ntt as ntt_ops
from tiberate_tpu.ops.mont import ModPack
from tiberate_tpu.utils.primes import find_the_next_prime


def _setup(logN, qbits_list, seed=0):
    """Primes of the requested widths (mixed groups), tables, data."""
    N = 1 << logN
    q = []
    start = {}
    for qb in qbits_list:
        s = start.get(qb, 2**qb - 1)
        p = find_the_next_prime(s, 2 * N, up=False)
        start[qb] = p - 2
        q.append(p)
    C = len(q)
    pack = ModPack.from_q(q)
    psi_t, ipsi_t = ntt_ops.make_psi_tables(q, logN)
    R = 1 << 62
    psi = jnp.array(
        np.array([[p * R % qi for p in row] for row, qi in zip(psi_t, q)],
                 dtype=np.int64))
    ipsi = jnp.array(
        np.array([[p * R % qi for p in row] for row, qi in zip(ipsi_t, q)],
                 dtype=np.int64))
    Ninv = jnp.array(
        np.array([pow(N, -1, qi) * R % qi for qi in q],
                 dtype=np.int64).reshape(-1, 1))
    Rs = jnp.array(
        np.array([R * R % qi for qi in q], dtype=np.int64).reshape(-1, 1))
    rng = np.random.default_rng(seed)
    x = jnp.array(
        np.stack([rng.integers(0, qi, N, dtype=np.int64) for qi in q]))
    fwd = mxu_ntt.build_tables(q, logN)
    inv = mxu_ntt.build_tables(q, logN, inverse=True)
    return q, pack, psi, ipsi, Ninv, Rs, x, fwd, inv


def _r2q(a, pack):
    return np.asarray(mont.reduce_2q(a, pack))


@pytest.mark.parametrize("logN,qbits", [
    (6, [40, 40, 60]),          # mixed limb groups
    (7, [60]),
    (9, [40, 60, 60]),          # odd logN: N1 != N2
])
def test_forward_matches_radix2(logN, qbits):
    q, pack, psi, ipsi, Ninv, Rs, x, fwd, inv = _setup(logN, qbits)
    want = _r2q(ntt_ops.ntt(x, psi, pack), pack)
    got = _r2q(mxu_ntt.ntt(x, fwd), pack)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("logN,qbits", [(6, [40, 60]), (9, [40, 40, 60])])
def test_enter_variant(logN, qbits):
    q, pack, psi, ipsi, Ninv, Rs, x, fwd, inv = _setup(logN, qbits)
    want = _r2q(ntt_ops.enter_ntt(x, Rs, psi, pack), pack)
    got = _r2q(mxu_ntt.ntt(x, fwd, enter=True), pack)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("logN,qbits", [(6, [40, 60]), (9, [40, 40, 60])])
def test_inverse_variants(logN, qbits):
    q, pack, psi, ipsi, Ninv, Rs, x, fwd, inv = _setup(logN, qbits)
    y = ntt_ops.ntt(x, psi, pack)
    want_mont = _r2q(ntt_ops.intt(y, ipsi, Ninv, pack), pack)
    got_mont = _r2q(mxu_ntt.intt(y, inv, epilogue="mont"), pack)
    np.testing.assert_array_equal(got_mont, want_mont)

    want_exit = _r2q(ntt_ops.intt_exit(y, ipsi, Ninv, pack), pack)
    got_exit = _r2q(mxu_ntt.intt(y, inv, epilogue="exit"), pack)
    np.testing.assert_array_equal(got_exit, want_exit)


def test_roundtrip_and_lazy_inputs():
    """Roundtrip through the 4-step pair and lazy [0, 2q) inputs."""
    logN = 8
    q, pack, psi, ipsi, Ninv, Rs, x, fwd, inv = _setup(logN, [40, 60])
    # lazy inputs: x + q (still < 2q)
    x_lazy = x + pack._2q // 2
    got = _r2q(mxu_ntt.intt(mxu_ntt.ntt(x_lazy, fwd), inv, "mont"), pack)
    np.testing.assert_array_equal(got, _r2q(x_lazy, pack))


def test_batched_leading_dims():
    """[parts, C, N] and [B, parts, C, N] shapes."""
    logN = 6
    q, pack, psi, ipsi, Ninv, Rs, x, fwd, inv = _setup(logN, [40, 60])
    rng = np.random.default_rng(3)
    C, N = x.shape
    xb = jnp.array(
        rng.integers(0, 2**40, (2, 3, C, N), dtype=np.int64)
        % np.asarray(pack._2q >> 1)[None, None]
    )
    want = _r2q(ntt_ops.ntt(xb, psi, pack), pack)
    got = _r2q(mxu_ntt.ntt(xb, fwd), pack)
    np.testing.assert_array_equal(got, want)


def test_level_slicing():
    """Channel-sliced tables == slicing the full transform."""
    logN = 6
    q, pack, psi, ipsi, Ninv, Rs, x, fwd, inv = _setup(
        logN, [40, 40, 60, 60])
    full = _r2q(mxu_ntt.ntt(x, fwd), pack)
    for lvl in (1, 2, 3):
        sub = mxu_ntt.ntt(x[lvl:], fwd[lvl:])
        np.testing.assert_array_equal(
            _r2q(sub, pack[lvl:]), full[lvl:]
        )
    # stop-bounded slice (ordinary view dropping specials)
    sub = mxu_ntt.ntt(x[1:3], fwd[1:3])
    np.testing.assert_array_equal(_r2q(sub, pack[1:3]), full[1:3])


def test_engine_mxu_vs_radix2_bit_exact():
    """Full engine A/B: the int8 4-step engine produces bit-identical
    ciphertexts and decrypts to the same values as the radix-2 engine
    (same seed)."""
    from tiberate_tpu.config.toy import toy_config
    from tiberate_tpu.engine import CkksEngine

    cfg = toy_config(logN=8, num_scales=4, num_special_primes=2,
                     scale_bits=40)
    kw = dict(seed=11, nonce=7)
    eng_a = CkksEngine(cfg, transform="radix2", **kw)
    eng_b = CkksEngine(cfg, transform="int8_4step", **kw)
    assert eng_b.transform == "int8_4step"
    assert eng_b.params.lp(0, False).mxu_fwd is not None

    m1 = np.linspace(-1, 1, eng_a.num_slots)
    m2 = np.cos(np.linspace(0, 3, eng_a.num_slots))

    outs = []
    for eng in (eng_a, eng_b):
        ct1 = eng.encodecrypt(m1)
        ct2 = eng.encodecrypt(m2)
        ct = eng.cc_mult(ct1, ct2)
        ct = eng.cc_add(ct, ct)
        rot = eng.rotate_offset(ct, 3)
        conj = eng.conjugate(ct)
        outs.append((ct, rot, conj, eng))

    (ct_a, rot_a, conj_a, A), (ct_b, rot_b, conj_b, B) = outs
    for da, db in zip(ct_a.data + rot_a.data + conj_a.data,
                      ct_b.data + rot_b.data + conj_b.data):
        np.testing.assert_array_equal(np.asarray(da), np.asarray(db))

    got = B.decryptcode(ct_b, is_real=True)
    want = 2 * m1 * m2
    assert np.abs(got - want).max() < 2e-3
