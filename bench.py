"""Benchmark rows for the fused cc_mult step and the forward NTT on a GPU.

    python bench.py                             # the four rows below
    TIBERATE_BENCH_PRESET=toy python bench.py   # CPU smoke: one toy row

Default rows, each one JSON line printed as soon as it is measured (the
62-bit logN15 step is the primary row and prints last):

* cc_mult step (rescale -> tensor product -> relinearize with key
  switching) at ``logN15_30``, ``logN17_30`` and ``logN15``, a batch of
  distinct ciphertext pairs under one ``jax.vmap``;
* the forward NTT (``enter_ntt``) of level-0 ``[C, N]`` polynomials at
  ``logN17``.

Each row gives items per second, ms per item, the median and every one of
three timed loops (each ends in ``block_until_ready``), the compile
seconds, the device's peak bytes in use, the decrypt error of every
ciphertext in the batch (step rows), the engine's transform, and the
device as JAX reports it beside the card's name and power limit.

``TIBERATE_BENCH_PRESET`` pins one preset (``TIBERATE_BENCH_KIND`` =
``step`` or ``ntt``); ``TIBERATE_BENCH_ITERS`` and
``TIBERATE_BENCH_BATCH`` set calls per loop and the batch.  Without the
toy preset a GPU is required.  Any failed row ends the run non-zero.
"""

import json
import os
import statistics
import sys
import time

LOOPS = 3
DEFAULT_ROWS = (("logN15_30", "step"), ("logN17", "ntt"),
                ("logN17_30", "step"), ("logN15", "step"))


def time_loops(fn, iters, loops=LOOPS):
    """Seconds per call: (median, every loop) over ``loops`` loops of
    ``iters`` calls, each loop ending in ``block_until_ready``."""
    import jax

    jax.block_until_ready(fn())
    per_call = []
    for _ in range(loops):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        jax.block_until_ready(out)
        per_call.append((time.perf_counter() - t0) / iters)
    return statistics.median(per_call), per_call


def build_engine(preset, transform=None):
    from tiberate_tpu.engine import CkksEngine

    if preset == "toy":
        from tiberate_tpu.config.toy import toy_config

        preset = toy_config(logN=8, num_scales=4, num_special_primes=2,
                            scale_bits=30)
    # "_30"-suffixed presets (e.g. logN15_30) parse to the 30-bit
    # buffer-mode twin via CkksConfig.parse_30bit
    return CkksEngine(preset, seed=7, transform=transform)


def prepare_step(eng, batch):
    """The compiled batch-``batch`` fused cc_mult step and its inputs.

    Returns (call, check, compile_s): ``call()`` runs one batched step;
    ``check(out)`` returns the largest decrypt error over the batch."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tiberate_tpu.parallel.sharded import make_mult_step, mult_step_params
    from tiberate_tpu.typing import Ciphertext

    rng = np.random.default_rng(7)
    ms1 = [rng.uniform(-1, 1, eng.num_slots) for _ in range(batch)]
    ms2 = [rng.uniform(-1, 1, eng.num_slots) for _ in range(batch)]
    cts1 = eng.encodecrypt_batch(ms1)
    cts2 = eng.encodecrypt_batch(ms2)
    args = tuple(jnp.stack([ct.data[i] for ct in cts])
                 for cts, i in ((cts1, 0), (cts1, 1), (cts2, 0), (cts2, 1)))
    evk = tuple(eng.evk.data)
    prm = mult_step_params(eng, level=0, pre_rescale=True)
    step = make_mult_step(eng, level=0, pre_rescale=True)
    batched = jax.jit(jax.vmap(step, in_axes=(0, 0, 0, 0, None, None)))
    t0 = time.perf_counter()
    compiled = batched.lower(*args, evk, prm).compile()
    compile_s = time.perf_counter() - t0

    def check(out):
        err = 0.0
        for b in range(batch):
            ct = Ciphertext(data=(out[0][b], out[1][b]), level=1,
                            logN=eng.ckksCfg.logN, creator_hash=eng.hash)
            dec = eng.decryptcode(ct, is_real=True)
            err = max(err, float(np.abs(dec - ms1[b] * ms2[b]).max()))
        return err

    return (lambda: compiled(*args, evk, prm)), check, compile_s


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def step_row(eng, preset, iters, batch, device):
    call, check, compile_s = prepare_step(eng, batch)
    med, loops = time_loops(call, iters)
    return {
        "metric": f"cc_mult_{preset}_ct_per_s",
        "value": batch / med,
        "unit": "ciphertexts/s",
        "extra": {
            "ms_per_ct": med / batch * 1e3,
            "loops_ms_per_ct": [t / batch * 1e3 for t in loops],
            "batch": batch,
            "decrypt_max_err": check(call()),
            "compile_s": compile_s,
            "peak_bytes_in_use": _peak_bytes(),
            "transform": eng.transform,
            "device": device,
        },
    }


def ntt_row(eng, preset, iters, batch, device):
    """Forward NTT (enter_ntt) of ``batch`` level-0 [C, N] polynomials
    per call."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tiberate_tpu.engine import ckks_engine as E

    lp = eng.params.lp(0, False)
    C, N = lp.num_channels, eng.params.N
    rng = np.random.default_rng(3)
    q = np.array(eng.params.q[: eng.params.P])[:, None]
    x = jnp.asarray(rng.integers(0, q, (batch, C, N)),
                    dtype=eng.params.dtype)
    # lp rides as an argument: closed over, its tables would be baked
    # into the program as literals
    f = jax.jit(jax.vmap(E._enter_ntt, in_axes=(0, None)))
    t0 = time.perf_counter()
    compiled = f.lower(x, lp).compile()
    compile_s = time.perf_counter() - t0
    med, loops = time_loops(lambda: compiled(x, lp), iters)
    return {
        "metric": f"enter_ntt_{preset}_transforms_per_s",
        "value": batch / med,
        "unit": "transforms/s",
        "extra": {
            "ms_per_transform": med / batch * 1e3,
            "loops_ms_per_transform": [t / batch * 1e3 for t in loops],
            "channels": C,
            "batch": batch,
            "compile_s": compile_s,
            "peak_bytes_in_use": _peak_bytes(),
            "transform": eng.transform,
            "device": device,
        },
    }


def main():
    import jax

    from tiberate_tpu.utils.runtime import device_record, use_compile_cache

    iters = int(os.environ.get("TIBERATE_BENCH_ITERS", "10"))
    batch = int(os.environ.get("TIBERATE_BENCH_BATCH", "8"))
    pinned = os.environ.get("TIBERATE_BENCH_PRESET")
    rows = ([(pinned, os.environ.get("TIBERATE_BENCH_KIND", "step"))]
            if pinned else DEFAULT_ROWS)

    platform = jax.devices()[0].platform
    if platform != "gpu" and pinned != "toy":
        sys.exit(f"bench.py: needs a GPU, JAX found {platform}; "
                 "TIBERATE_BENCH_PRESET=toy runs the CPU smoke row")
    use_compile_cache()
    device = device_record()
    for preset, kind in rows:
        eng = build_engine(preset)
        row = {"step": step_row, "ntt": ntt_row}[kind]
        print(json.dumps(row(eng, preset, iters, batch, device)),
              flush=True)


if __name__ == "__main__":
    main()
