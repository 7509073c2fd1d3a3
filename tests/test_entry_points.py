"""The transform choice, the compile-cache helper and the entry scripts.

``chip_smoke.py`` and ``bench.py`` refuse to run without a GPU; their
four-card phase runs here on virtual CPU devices at a toy size, and the
full-width GPU-vs-CPU parity runs only on a card (``-m gpu``).
"""

import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

from tiberate_tpu.config.toy import toy_config
from tiberate_tpu.engine import CkksEngine
from tiberate_tpu.ops import transform
from tiberate_tpu.utils import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("bits", [62, 30])
@pytest.mark.parametrize("logN", [8, 15, 17])
def test_cpu_runs_radix2(logN, bits):
    assert transform.choose_transform("cpu", logN, bits) == "radix2"


@pytest.mark.parametrize("bits", [62, 30])
def test_gpu_runs_the_measured_default(bits):
    got = transform.choose_transform("gpu", 15, bits)
    assert got == transform._GPU_DEFAULT[bits]
    assert got in transform.TRANSFORMS


@pytest.mark.parametrize("name", ["pallas", "fused_pallas", "mxu"])
def test_no_pallas_transform_is_accepted(name):
    with pytest.raises(ValueError):
        transform.choose_transform("gpu", 15, 62, requested=name)
    params = inspect.signature(CkksEngine).parameters
    assert not any("pallas" in p for p in params)


def test_unknown_platform_is_an_error():
    with pytest.raises(ValueError):
        transform.choose_transform("rocm", 15, 62)


def test_engine_takes_its_transform_from_the_platform():
    eng = CkksEngine(toy_config(logN=6), seed=1)
    assert eng.transform == "radix2"
    assert eng.params.lp(0, False).mxu_fwd is None


@pytest.fixture
def cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_the_environment(monkeypatch, cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    before = jax.config.jax_compilation_cache_dir
    assert runtime.use_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_one_path_in_the_checkout(monkeypatch,
                                                            cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = runtime.use_compile_cache()
    assert first == runtime.use_compile_cache()
    assert first == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == first


@pytest.mark.parametrize("script,env", [
    ("chip_smoke.py", {}),
    ("chip_smoke.py --four", {}),
    ("bench.py", {"TIBERATE_BENCH_PRESET": "logN15"}),
])
def test_scripts_refuse_to_run_without_a_gpu(script, env):
    out = subprocess.run(
        [sys.executable, *script.split()],
        env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **env),
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "needs" in out.stderr


def test_four_card_step_on_virtual_devices():
    """The ``--four`` phase at a toy size on four virtual CPU devices:
    sharded over rns, bit-exact with one device, decrypt-checked."""
    cfg = toy_config(logN=7, num_scales=4, num_special_primes=2,
                     scale_bits=30)
    chip_smoke.four_card_step(cfg, jax.devices()[:4], tol=1e-3)


@pytest.fixture
def gpu_and_cpu():
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (python -m pytest tests -m gpu)")
    return devs[0], jax.devices("cpu")[0]


@pytest.mark.gpu
@pytest.mark.parametrize("preset", chip_smoke.PRESETS)
def test_full_width_gpu_matches_cpu(preset, gpu_and_cpu):
    """chip_smoke phase 3 at full width: the fused step and both
    transform paths are bit-exact with the CPU."""
    _, cpu = gpu_and_cpu
    tol = chip_smoke.TOL[30 if preset.endswith("_30") else 62]
    eng = CkksEngine(preset, seed=7)
    step, args, evk, prm, out = chip_smoke.fused_batched_step(eng, tol)
    chip_smoke.step_matches_cpu(step, args, evk, prm, out, cpu)
    chip_smoke.transforms_match_cpu(preset, cpu)
    assert np.isfinite(eng.decryptcode(
        eng.encodecrypt(np.zeros(eng.num_slots)), is_real=True)).all()
