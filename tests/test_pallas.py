"""uint32-pair modular arithmetic (``ops/pallas_mont.py``): bit-exact
against the int64 REDC of ``ops/mont.py``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tiberate_tpu.ops import mont, pallas_mont as pm
from tiberate_tpu.ops.mont import ModPack

QS = [1152921504606830593, 1099510054913]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    pack = ModPack.from_q(QS)
    a = np.stack([rng.integers(0, 2 * q, 2048) for q in QS]).astype(np.int64)
    b = np.stack([rng.integers(0, 2 * q, 2048) for q in QS]).astype(np.int64)
    return pack, a, b


def test_pair_roundtrip(data):
    _, a, _ = data
    lo, hi = pm.to_pair(jnp.asarray(a))
    back = np.asarray(pm.from_pair(lo, hi))
    np.testing.assert_array_equal(back, a)


def test_mont_mult_pair_bit_exact(data):
    pack, a, b = data
    exp = np.asarray(mont.mont_mult(a, b, pack))
    alo, ahi = pm.to_pair(jnp.asarray(a))
    blo, bhi = pm.to_pair(jnp.asarray(b))
    ql = np.asarray(pack.ql).astype(np.uint32)
    qh = np.asarray(pack.qh).astype(np.uint32)
    kl = np.asarray(pack.kl).astype(np.uint32)
    kh = np.asarray(pack.kh).astype(np.uint32)
    got = np.asarray(
        pm.from_pair(*pm.mont_mult_pair(alo, ahi, blo, bhi, ql, qh, kl, kh))
    )
    np.testing.assert_array_equal(got, exp)


def test_mont_reduce_add_sub_pair_bit_exact(data):
    pack, a, b = data
    alo, ahi = pm.to_pair(jnp.asarray(a))
    blo, bhi = pm.to_pair(jnp.asarray(b))
    ql = np.asarray(pack.ql).astype(np.uint32)
    qh = np.asarray(pack.qh).astype(np.uint32)
    kl = np.asarray(pack.kl).astype(np.uint32)
    kh = np.asarray(pack.kh).astype(np.uint32)
    q2 = pm.to_pair(pack._2q)
    q1 = pm.to_pair(pack._2q >> 1)

    np.testing.assert_array_equal(
        np.asarray(pm.from_pair(*pm.mont_reduce_pair(alo, ahi, ql, qh, kl,
                                                     kh))),
        np.asarray(mont.mont_reduce(a, pack)),
    )
    np.testing.assert_array_equal(
        np.asarray(pm.from_pair(*pm.mont_add_pair(alo, ahi, blo, bhi, *q2))),
        np.asarray(mont.mont_add(a, b, pack)),
    )
    np.testing.assert_array_equal(
        np.asarray(pm.from_pair(*pm.mont_sub_pair(alo, ahi, blo, bhi, *q2))),
        np.asarray(mont.mont_sub(a, b, pack)),
    )
    np.testing.assert_array_equal(
        np.asarray(pm.from_pair(*pm.reduce_2q_pair(alo, ahi, *q1))),
        np.asarray(mont.reduce_2q(a, pack)),
    )
