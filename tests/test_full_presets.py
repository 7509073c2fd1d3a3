"""Full-preset (logN14/15/16) end-to-end tests — the BASELINE.json parity
configs.  Heavy (minutes of XLA CPU compiles), so gated behind
``TIBERATE_FULL_TESTS=1``; the driver's fast suite runs the toy-ring
equivalents in test_engine.py.
"""

import os

import numpy as np
import pytest

from tiberate_tpu.engine import CkksEngine
from tiberate_tpu.typing import Plaintext

pytestmark = pytest.mark.skipif(
    os.environ.get("TIBERATE_FULL_TESTS") != "1",
    reason="set TIBERATE_FULL_TESTS=1 to run full-size preset tests",
)


@pytest.fixture(scope="module")
def eng():
    return CkksEngine("logN14", seed=7, nonce=3)


def test_logN14_roundtrip_and_ops(eng):
    rng = np.random.default_rng(0)
    m1 = rng.uniform(-1, 1, eng.num_slots)
    m2 = rng.uniform(-1, 1, eng.num_slots)
    ct1, ct2 = eng.encodecrypt(m1), eng.encodecrypt(m2)

    assert np.abs(eng.decryptcode(ct1, is_real=True) - m1).max() < 1e-6
    out = eng.decryptcode(eng.cc_mult(ct1, ct2), is_real=True)
    assert np.abs(out - m1 * m2).max() < 1e-5

    out = eng.decryptcode(eng.rotate_offset(ct1, 5), is_real=True)
    assert np.abs(out - np.roll(m1, 5)).max() < 1e-5

    pt = Plaintext(m2)
    out = eng.decryptcode(eng.pc_mult(pt, ct1), is_real=True)
    assert np.abs(out - m1 * m2).max() < 1e-5


def test_logN14_deep_chain(eng):
    """Multiply chain through the full level budget, error stays bounded
    (the reference's lat_of_each_level error sweep)."""
    rng = np.random.default_rng(1)
    m = rng.uniform(-1, 1, eng.num_slots)
    ct = eng.encodecrypt(m)
    expect = m.copy()
    level_cap = eng.num_levels - 1
    while ct.level < level_cap:
        ct = eng.cc_mult(ct, eng.level_up(eng.encodecrypt(m), ct.level))
        expect = expect * m
        err = np.abs(eng.decryptcode(ct, is_real=True) - expect).max()
        assert err < 1e-3, (ct.level, err)


def test_known_answer_determinism():
    """Fixed seed -> fixed ciphertext bits (regression anchor)."""
    a = CkksEngine("logN14", seed=1234, nonce=1)
    m = np.linspace(-1, 1, a.num_slots)
    ct = a.encodecrypt(m)
    d0 = np.asarray(ct.data[0])
    b = CkksEngine("logN14", seed=1234, nonce=1)
    ct2 = b.encodecrypt(m)
    np.testing.assert_array_equal(d0, np.asarray(ct2.data[0]))


def test_logN17_construction():
    """The largest preset builds (params, psi banks, partitions)."""
    from tiberate_tpu.config import CkksConfig
    from tiberate_tpu.context.ntt_context import CkksParams

    cfg = CkksConfig.parse("logN17")
    assert cfg.N == 2**17 and cfg.num_special_primes == 6
    params = CkksParams(cfg)
    assert params.psi.shape == (len(cfg.q), cfg.N)
    assert len(params.parts[0]) == params.rnsPart.num_partitions + 1


def test_logN14_mode30_e2e():
    """30-bit buffer mode at a REAL ring size (logN14, int32 residues):
    encrypt -> cc_mult -> rotate -> decrypt within 30-bit noise."""
    eng = CkksEngine(
        dict(logN=14, buffer_bit_length=30, scale_bits=25,
             num_special_primes=2, num_scales=8),
        seed=11,
    )
    assert eng.params.dtype == np.int32 or str(
        eng.ckksCfg.buffer_bit_length) == "30"
    m = np.linspace(-1, 1, eng.num_slots)
    ct = eng.encodecrypt(m)
    out = eng.decryptcode(eng.cc_mult(ct, ct), is_real=True)
    assert np.abs(out - m * m).max() < 5e-3
    rot = eng.rotate_offset(ct, 3)
    assert np.abs(
        eng.decryptcode(rot, is_real=True) - np.roll(m, 3)
    ).max() < 5e-3


def test_logN17_e2e():
    """logN17 end to end: pins the math at the largest preset ring."""
    eng = CkksEngine("logN17", seed=3, nonce=1)
    rng = np.random.default_rng(5)
    m1 = rng.uniform(-1, 1, eng.num_slots)
    m2 = rng.uniform(-1, 1, eng.num_slots)
    ct1, ct2 = eng.encodecrypt(m1), eng.encodecrypt(m2)
    assert np.abs(eng.decryptcode(ct1, is_real=True) - m1).max() < 1e-6
    out = eng.decryptcode(eng.cc_mult(ct1, ct2), is_real=True)
    assert np.abs(out - m1 * m2).max() < 1e-4
