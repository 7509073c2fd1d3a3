"""Multi-device sharding tests.

Multi-device runs happen in subprocesses pinned to the CPU, each with its
own count of virtual devices (``xla_force_host_platform_device_count`` is
read once per process).
"""

import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow  # fast suite: pytest -m 'not slow'

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("ndev", [4, 8])
def test_dryrun_multichip(ndev):
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        NDEV=str(ndev),
        PYTHONPATH=REPO,
        XLA_FLAGS=f"--xla_force_host_platform_device_count={ndev}",
    )
    code = (
        "import __graft_entry__ as g; "
        f"g.dryrun_multichip({ndev})"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        env=env,
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=1500,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"dryrun_multichip({ndev})" in out.stdout


def test_dryrun_two_host_layout():
    """The 2-host scaling layout SCALING.md's >=80% row is modeled on —
    batch=8 x rns=2 — compiles AND executes on 16 virtual devices with
    the explicit-collective structure (one all_gather, zero all-reduce;
    VERDICT r3 #7)."""
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        NDEV="16",
        GRAFT_DRYRUN_MESH="8,2,1",
        PYTHONPATH=REPO,
        XLA_FLAGS="--xla_force_host_platform_device_count=16",
    )
    code = "import __graft_entry__ as g; g.dryrun_multichip(16)"
    out = subprocess.run(
        [sys.executable, "-c", code],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=3000,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "mesh=(batch=8, rns=2, coef=1)" in out.stdout
    assert "rns_switch=on" in out.stdout
    assert "all_gather=1 all_reduce=0" in out.stdout


def test_entry_compiles():
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        PYTHONPATH=REPO,
    )
    code = (
        "import jax, __graft_entry__ as g; "
        "fn, args = g.entry(); "
        "out = jax.jit(fn)(*args); jax.block_until_ready(out); "
        "print('entry ok')"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        env=env,
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=1500,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "entry ok" in out.stdout


def test_engine_mesh_mode():
    """CkksEngine(mesh=...) shards keys + fresh ciphertexts over
    (rns x coef) and every op stays bit-identical to the unsharded engine
    (same seed => same ciphertexts; placement must not change the math)."""
    import numpy as np

    import jax
    from tiberate_tpu.config.toy import toy_config
    from tiberate_tpu.engine import CkksEngine
    from tiberate_tpu.parallel.mesh import make_mesh

    assert jax.device_count() >= 4, "conftest provides 8 virtual devices"
    mesh = make_mesh(4, rns=2, coef=2)

    cfg = toy_config(logN=7, num_scales=4, num_special_primes=2,
                     scale_bits=30)
    ref = CkksEngine(cfg, seed=42, nonce=5)
    eng = CkksEngine(cfg, seed=42, nonce=5, mesh=mesh)

    m1 = np.linspace(-1, 1, eng.num_slots)
    m2 = np.cos(np.linspace(0, 3, eng.num_slots))
    ct1, ct2 = eng.encodecrypt(m1), eng.encodecrypt(m2)
    rt1, rt2 = ref.encodecrypt(m1), ref.encodecrypt(m2)

    # placement: sharded over the mesh, not single-device
    assert len(ct1.data[0].sharding.device_set) == 4
    # math: bit-identical to the unsharded engine
    for a, b in zip(ct1.data + ct2.data, rt1.data + rt2.data):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    out = eng.cc_mult(ct1, ct2)
    ref_out = ref.cc_mult(rt1, rt2)
    for a, b in zip(out.data, ref_out.data):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    dec = eng.decryptcode(out, is_real=True)
    assert np.abs(dec - m1 * m2).max() < 1e-3

    # rotation (galois path) works sharded too
    rot = eng.rotate_offset(ct1, 3)
    dec_rot = eng.decryptcode(rot, is_real=True)
    assert np.abs(dec_rot - np.roll(m1, 3)).max() < 1e-3


def test_rns_sharded_keyswitch():
    """shard_map keyswitch over a 2-device 'rns' mesh is bit-exact vs the
    unsharded path (subprocess: needs a multi-device CPU platform)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests", "_rns_shard_driver.py")],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=1500,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "bit-exact: True" in out.stdout
    # distributed epilogue: one input all_gather, no other collective
    assert "single-gather epilogue: True" in out.stdout
    # special rows round-robined over shards (near-perfect work scaling)
    assert "scatter_special bit-exact: True" in out.stdout
    # engine integration: make_mult_step on a (batch, rns) engine mesh
    # uses the shard_map switcher — bit-exact, one all_gather total
    assert "engine mesh step bit-exact: True" in out.stdout
    assert "engine one-gather structure: True" in out.stdout


def test_multihost_two_process():
    """2-process jax.distributed CPU cluster: init, same-seed key parity,
    external-key broadcast (host 0 -> all), per-host batch scatter, one
    sharded op (covers parallel/multihost.py end-to-end)."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [
        subprocess.Popen(
            [sys.executable,
             os.path.join(REPO, "tests", "_multihost_driver.py"),
             str(i), "2", str(port)],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i}: {err[-2000:]}"
        assert f"multihost OK pidx={i}/2" in out


def test_coef_sharded_ntt():
    """Coefficient-axis-sharded NTT (cross-shard butterfly exchange via
    ppermute) is bit-exact vs the unsharded transform on an 8-device mesh."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests", "_coef_shard_driver.py")],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=1500,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "NTT bit-exact: True" in out.stdout
    assert "roundtrip bit-exact: True" in out.stdout
    assert "collective-permute in HLO: True" in out.stdout


@pytest.mark.skipif(
    not os.environ.get("TIBERATE_FULL_TESTS"),
    reason="logN17 sharded execution is slow; set TIBERATE_FULL_TESTS=1",
)
def test_dryrun_multichip_logN17():
    """The logN17 preset's documented operating mode EXECUTES: the full
    cc_mult step (rescale -> tensor -> relinearize/keyswitch) runs
    decrypt-checked on an 8-device virtual (batch, rns, coef) mesh with
    the explicit-collective structure asserted (PERFORMANCE.md
    'multi-chip is the intended operating mode at logN17';
    VERDICT r3 #4)."""
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        NDEV="8",
        GRAFT_DRYRUN_PRESET="logN17",
        PYTHONPATH=REPO,
        XLA_FLAGS="--xla_force_host_platform_device_count=8",
    )
    code = "import __graft_entry__ as g; g.dryrun_multichip(8)"
    out = subprocess.run(
        [sys.executable, "-c", code],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=5400,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "preset=logN17" in out.stdout
    assert "rns_switch=on" in out.stdout
    assert "all_reduce=0" in out.stdout


@pytest.mark.skipif(
    not os.environ.get("TIBERATE_FULL_TESTS"),
    reason="logN17 sharded execution is slow; set TIBERATE_FULL_TESTS=1",
)
def test_coef_sharded_ntt_logN17():
    """The multi-host logN17 enabler actually EXECUTES at logN17: the
    coefficient-sharded NTT runs bit-exact on an 8-device virtual mesh
    at N = 2^17 (BASELINE 'multi-host sharded NTT, logN=17' row)."""
    env = dict(os.environ, PYTHONPATH=REPO, TIBERATE_COEF_LOGN="17")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests", "_coef_shard_driver.py")],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=3000,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "NTT bit-exact: True" in out.stdout
    assert "roundtrip bit-exact: True" in out.stdout
    assert "collective-permute in HLO: True" in out.stdout
