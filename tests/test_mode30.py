"""30-bit ``buffer_bit_length`` mode: int32 storage, 15-bit-half REDC.

The reference supports this mode via the same templated kernels
(``/root/reference/tiberate/config/ckks_config.py:93-96``,
``csrc/mont.cpp:17-24`` int32 DISPATCH); here the identical dataflow runs
on int32 with mode constants selected from the operand dtype.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tiberate_tpu.config.toy import toy_config
from tiberate_tpu.engine import CkksEngine
from tiberate_tpu.ops import mont
from tiberate_tpu.ops import ntt as ntt_ops
from tiberate_tpu.ops.mont import ModPack
from tiberate_tpu.utils.primes import find_the_next_prime

TOL = 1e-2  # 25-bit scales are noisier than 40-bit ones


def _pack30(logN=8):
    N = 1 << logN
    q = [
        find_the_next_prime(2**28 - 1, 2 * N, up=False),
        find_the_next_prime(2**25 + 1, 2 * N, up=True),
    ]
    return q, ModPack.from_q(q, R_bits=30)


def test_mont_roundtrip_int32():
    q, pack = _pack30()
    assert pack.ql.dtype == jnp.int32
    rng = np.random.default_rng(1)
    x = jnp.array(
        np.stack([rng.integers(0, qi, 64, dtype=np.int32) for qi in q])
    )
    Rs = jnp.array(
        np.array([(1 << 60) % qi for qi in q],  # R^2 = 2^60 for R = 2^30
                 dtype=np.int32).reshape(-1, 1)
    )
    y = mont.mont_enter(x, Rs, pack)
    z = mont.mont_reduce(y, pack)
    z = mont.reduce_2q(z, pack)
    np.testing.assert_array_equal(np.asarray(z), np.asarray(x))


def test_ntt_roundtrip_int32():
    logN = 8
    N = 1 << logN
    q, pack = _pack30(logN)
    R = 1 << 30
    psi_t, ipsi_t = ntt_ops.make_psi_tables(q, logN)
    psi = jnp.array(
        np.array([[p * R % qi for p in row] for row, qi in zip(psi_t, q)],
                 dtype=np.int32))
    ipsi = jnp.array(
        np.array([[p * R % qi for p in row] for row, qi in zip(ipsi_t, q)],
                 dtype=np.int32))
    Ninv = jnp.array(
        np.array([pow(N, -1, qi) * R % qi for qi in q],
                 dtype=np.int32).reshape(-1, 1))
    rng = np.random.default_rng(2)
    x = jnp.array(
        np.stack([rng.integers(0, qi, N, dtype=np.int32) for qi in q]))
    y = ntt_ops.ntt(x, psi, pack)
    assert y.dtype == jnp.int32
    back = mont.reduce_2q(ntt_ops.intt(y, ipsi, Ninv, pack), pack)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(x))


@pytest.fixture(scope="module")
def eng30():
    cfg = toy_config(logN=8, num_scales=4, num_special_primes=2,
                     scale_bits=21, buffer_bit_length=30)
    return CkksEngine(cfg, seed=5, nonce=2)


def test_engine30_encrypt_decrypt(eng30):
    m = np.linspace(-1, 1, eng30.num_slots)
    ct = eng30.encodecrypt(m)
    assert ct.data[0].dtype == jnp.int32
    out = eng30.decryptcode(ct, is_real=True)
    assert np.abs(out - m).max() < TOL


def test_engine30_mult_chain(eng30):
    m1 = np.linspace(-1, 1, eng30.num_slots)
    m2 = np.cos(np.linspace(0, 3, eng30.num_slots))
    ct1 = eng30.encodecrypt(m1)
    ct2 = eng30.encodecrypt(m2)
    ct = eng30.cc_mult(ct1, ct2)
    out = eng30.decryptcode(ct, is_real=True)
    assert np.abs(out - m1 * m2).max() < TOL
    ct = eng30.cc_mult(ct, eng30.encodecrypt(m1, level=ct.level))
    out = eng30.decryptcode(ct, is_real=True)
    assert np.abs(out - m1 * m1 * m2).max() < 10 * TOL


def test_engine30_rotation_add_scalar(eng30):
    m = np.linspace(-1, 1, eng30.num_slots)
    ct = eng30.encodecrypt(m)
    rot = eng30.rotate_offset(ct, 2)
    out = eng30.decryptcode(rot, is_real=True)
    assert np.abs(out - np.roll(m, 2)).max() < TOL

    ct2 = eng30.add_scalar(ct, 0.5)
    out2 = eng30.decryptcode(ct2, is_real=True)
    assert np.abs(out2 - (m + 0.5)).max() < TOL


def test_engine30_mxu_ab():
    """30-bit int8 4-step == 30-bit radix-2, bit-exact ciphertexts."""
    cfg = toy_config(logN=8, num_scales=3, num_special_primes=2,
                     scale_bits=21, buffer_bit_length=30)
    kw = dict(seed=9, nonce=4)
    eng_a = CkksEngine(cfg, transform="radix2", **kw)
    eng_b = CkksEngine(cfg, transform="int8_4step", **kw)
    m1 = np.linspace(-1, 1, eng_a.num_slots)
    m2 = np.sin(np.linspace(0, 2, eng_a.num_slots))
    outs = []
    for eng in (eng_a, eng_b):
        ct = eng.cc_mult(eng.encodecrypt(m1), eng.encodecrypt(m2))
        outs.append(ct)
    for da, db in zip(outs[0].data, outs[1].data):
        np.testing.assert_array_equal(np.asarray(da), np.asarray(db))
