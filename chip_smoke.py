"""End-to-end smoke run of the CKKS engine on NVIDIA GPUs.

    python chip_smoke.py           # one card: phases 1-4 below
    python chip_smoke.py --four    # four cards: the rns-sharded logN16 step

One card, in one process:

1. Device: JAX must report a GPU; prints its kind, the device count and
   the card's name and power limit (``nvidia-smi``).
2. Public API at ``logN15`` (62-bit lane) and ``logN15_30`` (30-bit lane):
   ``encodecrypt``, ``cc_mult``, a rotation, ``cc_add`` and
   ``decryptcode`` against numpy, then the batch-8 fused ``cc_mult`` step
   that ``bench.py`` times (``make_mult_step`` under ``jax.vmap``).
3. Bit-exact parity with the CPU: the same jitted fused step on one
   ciphertext pair on ``jax.devices("cpu")[0]``, and both transform paths
   (radix-2, int8 4-step) at the preset's full channel count on both
   lanes.
4. Set-up costs: compile seconds, ``compiled.memory_analysis()`` and the
   card's peak bytes in use, printed per compiled step.

``--four`` runs only the four-card phase and the one-card step it is
compared with.  Every check raises on failure, so a failed phase exits
non-zero and prints no result.  The last line of stdout is one JSON
object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

import argparse
import dataclasses
import json
import re
import sys
import time

import numpy as np

# 62-bit residues keep decrypt error near 1e-8; the 30-bit lane's 25-bit
# scale leaves about 1e-3.
TOL = {62: 1e-5, 30: 1e-2}
PRESETS = ("logN15", "logN15_30")
BATCH = 8


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def require_gpu(count):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < count:
        sys.exit(f"chip_smoke: needs {count} GPU(s); JAX found "
                 f"{len(devs)} {devs[0].platform} device(s)")
    return devs


def _peak_bytes(dev):
    stats = dev.memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def compile_reported(name, jitted, *args):
    """Compile ``jitted`` for ``args`` and print its set-up costs."""
    t0 = time.perf_counter()
    compiled = jitted.lower(*args).compile()
    secs = time.perf_counter() - t0
    ma = compiled.memory_analysis()
    mem = ("n/a" if ma is None else
           f"args={ma.argument_size_in_bytes} "
           f"out={ma.output_size_in_bytes} temp={ma.temp_size_in_bytes} "
           f"code={ma.generated_code_size_in_bytes}")
    print(f"[{name}] compile_s={secs:.2f} memory_analysis: {mem}",
          flush=True)
    return compiled


def _max_err(got, want):
    return float(np.abs(np.asarray(got) - want).max())


def _engine(cfg, **kw):
    from tiberate_tpu.engine import CkksEngine

    return CkksEngine(cfg, seed=7, **kw)


def _messages(eng, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, eng.num_slots) for _ in range(n)]


# ----------------------------------------------------------------------
# Phase 2: the public API, then the fused batched step.
# ----------------------------------------------------------------------


def public_api(cfg, tol):
    """encodecrypt, cc_mult, a rotation, cc_add and decryptcode against
    numpy; returns the engine."""
    eng = _engine(cfg)
    m1, m2 = _messages(eng, 2, seed=7)
    t0 = time.perf_counter()
    ct1, ct2 = eng.encodecrypt(m1), eng.encodecrypt(m2)
    prod = eng.cc_mult(ct1, ct2)
    rot = ct1 >> 3
    total = eng.cc_add(ct1, ct2)
    dec = {k: eng.decryptcode(c, is_real=True)
           for k, c in (("encrypt", ct1), ("cc_mult", prod),
                        ("rotate_3", rot), ("cc_add", total))}
    secs = time.perf_counter() - t0
    errs = {
        "encrypt": _max_err(dec["encrypt"], m1),
        "cc_mult": _max_err(dec["cc_mult"], m1 * m2),
        "rotate_3": _max_err(dec["rotate_3"], np.roll(m1, 3)),
        "cc_add": _max_err(dec["cc_add"], m1 + m2),
    }
    print(f"[api {eng.ckksCfg.logN}/{eng.ckksCfg.buffer_bit_length}] "
          f"transform={eng.transform} first_call_s={secs:.2f} "
          f"max_abs_err={errs} tol={tol}", flush=True)
    for k, e in errs.items():
        check(e <= tol, f"{k} decrypt error {e} > {tol}")
    return eng


def fused_batched_step(eng, tol, batch=BATCH):
    """The batch-``batch`` fused cc_mult step bench.py times; returns
    (step, args, evk, prm, out)."""
    import jax
    import jax.numpy as jnp

    from tiberate_tpu.parallel.sharded import make_mult_step, mult_step_params
    from tiberate_tpu.typing import Ciphertext

    ms1 = _messages(eng, batch, seed=11)
    ms2 = _messages(eng, batch, seed=12)
    cts1 = eng.encodecrypt_batch(ms1)
    cts2 = eng.encodecrypt_batch(ms2)
    args = tuple(jnp.stack([ct.data[i] for ct in cts])
                 for cts, i in ((cts1, 0), (cts1, 1), (cts2, 0), (cts2, 1)))
    evk = tuple(eng.evk.data)
    prm = mult_step_params(eng, level=0, pre_rescale=True)
    step = make_mult_step(eng, level=0, pre_rescale=True)
    batched = jax.jit(jax.vmap(step, in_axes=(0, 0, 0, 0, None, None)))
    tag = f"step {eng.ckksCfg.logN}/{eng.ckksCfg.buffer_bit_length} x{batch}"
    compiled = compile_reported(tag, batched, *args, evk, prm)
    out = jax.block_until_ready(compiled(*args, evk, prm))
    err = 0.0
    for b in range(batch):
        ct = Ciphertext(data=(out[0][b], out[1][b]), level=1,
                        logN=eng.ckksCfg.logN, creator_hash=eng.hash)
        err = max(err, _max_err(eng.decryptcode(ct, is_real=True),
                                ms1[b] * ms2[b]))
    print(f"[{tag}] max_abs_err={err} tol={tol}", flush=True)
    check(err <= tol, f"batched step decrypt error {err} > {tol}")
    return step, args, evk, prm, out


# ----------------------------------------------------------------------
# Phase 3: bit-exact parity with the CPU.
# ----------------------------------------------------------------------

_FLOAT_DOT = re.compile(
    r"stablehlo\.dot_general.*->\s*tensor<[^>]*x(f16|bf16|f32|f64)>")


def step_matches_cpu(step, args, evk, prm, batched_out, cpu):
    """The jitted fused step on one ciphertext pair, here and on ``cpu``:
    outputs must be equal (all device arithmetic is exact integers)."""
    import jax

    single = jax.jit(step)
    one = tuple(a[0] for a in args) + (evk, prm)
    lowered = single.lower(*one)
    n_float = len(_FLOAT_DOT.findall(lowered.as_text()))
    print(f"[step parity] float dot_generals in the step: {n_float}",
          flush=True)
    check(n_float == 0, "the fused step has a float matmul")
    here = jax.block_until_ready(
        compile_reported("step x1", single, *one)(*one))
    one_cpu = jax.device_put(one, cpu)
    there = compile_reported("step x1 cpu", single, *one_cpu)(*one_cpu)
    same = all(np.array_equal(np.asarray(h), np.asarray(t))
               for h, t in zip(here, there))
    same_batched = all(np.array_equal(np.asarray(h), np.asarray(b[0]))
                       for h, b in zip(here, batched_out))
    print(f"[step parity] device == cpu: {same}; "
          f"x1 == batched[0]: {same_batched}", flush=True)
    check(same, "fused step differs from the CPU")
    check(same_batched, "fused step x1 differs from the batched step")


def _int8_dot_targets(hlo):
    """What XLA handed the int8 contractions to: custom-call targets and
    custom fusion kinds in the optimized HLO."""
    calls = set(re.findall(r'custom_call_target="([^"]+)"', hlo))
    kinds = set(re.findall(r'"kind":"(__[A-Za-z_]+)"', hlo))
    dots = len(re.findall(r"\bdot\(", hlo))
    return sorted(calls | kinds), dots


def transforms_match_cpu(cfg, cpu):
    """Forward (enter) and inverse (exit) NTT of one random [C, N] block
    at the config's full channel count, by both transform paths, here and
    on ``cpu``: residues mod q must agree everywhere, and the round trip
    must return the input."""
    import jax
    import jax.numpy as jnp

    from tiberate_tpu.config import CkksConfig
    from tiberate_tpu.context.ntt_context import CkksParams
    from tiberate_tpu.engine import ckks_engine as E
    from tiberate_tpu.ops.mxu_ntt import LIMB_BITS

    if isinstance(cfg, str):
        cfg = CkksConfig.parse(cfg)
    params = CkksParams(cfg)
    params.enable_mxu_ntt()
    lp_int8 = params.lp(0, True)
    lp_r2 = dataclasses.replace(lp_int8, mxu_fwd=None, mxu_inv=None)
    q = np.array(params.q, dtype=object)[:, None]
    C, N = lp_int8.num_channels, params.N
    rng = np.random.default_rng(5)
    x = jnp.asarray(np.stack([rng.integers(0, int(qi), N) for qi in
                              params.q]).astype(params.dtype))

    # int32 accumulator bound: each diagonal sums at most L products of
    # 7-bit limbs over a contraction block of K = max(P1, P2) rows
    lim = max(g.L for g in lp_int8.mxu_fwd.groups) * max(
        lp_int8.mxu_fwd.P1, lp_int8.mxu_fwd.P2) * ((1 << LIMB_BITS) - 1) ** 2
    print(f"[ntt {cfg.logN}/{cfg.buffer_bit_length}] C={C} int8 "
          f"accumulator bound {lim} < 2^31: {lim < 2**31}", flush=True)
    check(lim < 2**31, "int8 4-step accumulator can overflow int32")

    def fwd_inv(x, lp):
        y = E._enter_ntt(x, lp)
        return y, E._intt_exit(y, lp)

    f = jax.jit(fwd_inv)
    res = {}
    for name, lp in (("radix2", lp_r2), ("int8_4step", lp_int8)):
        tag = f"ntt {cfg.logN}/{cfg.buffer_bit_length} {name}"
        comp = compile_reported(tag, f, x, lp)
        if name == "int8_4step":
            targets, dots = _int8_dot_targets(comp.as_text())
            print(f"[{tag}] dot ops in the HLO: {dots}; custom calls and "
                  f"fusion kinds: {targets}", flush=True)
        here = comp(x, lp)
        x_c, lp_c = jax.device_put((x, lp), cpu)
        there = compile_reported(tag + " cpu", f, x_c, lp_c)(x_c, lp_c)
        for h, t in zip(here, there):
            hm = np.asarray(h).astype(object) % q
            check(np.array_equal(hm, np.asarray(t).astype(object) % q),
                  f"{tag}: device residues differ from the CPU")
        back = np.asarray(here[1]).astype(object) % q
        check(np.array_equal(back, np.asarray(x).astype(object)),
              f"{tag}: inverse(forward(x)) != x")
        res[name] = np.asarray(here[0]).astype(object) % q
        print(f"[{tag}] device == cpu mod q: True; roundtrip: True",
              flush=True)
    check(np.array_equal(res["radix2"], res["int8_4step"]),
          "radix-2 and int8 4-step residues differ")
    print(f"[ntt {cfg.logN}/{cfg.buffer_bit_length}] radix2 == int8_4step "
          f"mod q: True", flush=True)


# ----------------------------------------------------------------------
# Four cards: the rns-sharded fused step against one card.
# ----------------------------------------------------------------------


def four_card_step(cfg, devices, tol):
    """The fused cc_mult step with RNS channels sharded over ``devices``
    (mesh batch=1 x rns=D x coef=1, the shard_map keyswitch of
    ``parallel/rns_sharded``, radix-2 transforms), checked for decrypt
    error, bit-exact equality with the unsharded step on ``devices[0]``,
    its collectives and the placement of its inputs and outputs."""
    import jax
    from jax.sharding import Mesh

    from tiberate_tpu.parallel.sharded import (
        make_mult_step, mult_step_params, prepare_step_ksk)
    from tiberate_tpu.typing import Ciphertext

    D = len(devices)
    mesh = Mesh(np.array(devices).reshape(1, D, 1),
                axis_names=("batch", "rns", "coef"))
    # the shard_map keyswitch runs radix-2; the rest of the step follows
    eng = _engine(cfg, mesh=mesh, transform="radix2")
    # the first level whose post-rescale channel count divides the axis
    P = eng.params.P
    level = next(lv for lv in range(eng.num_levels - 1)
                 if (P - lv - 1) % D == 0)
    m1, m2 = _messages(eng, 2, seed=7)
    ct1 = eng.encodecrypt(m1, level=level)
    ct2 = eng.encodecrypt(m2, level=level)
    args = (ct1.data[0], ct1.data[1], ct2.data[0], ct2.data[1])

    prm = mult_step_params(eng, level=level, pre_rescale=True)
    check(prm["rns_tables"] is not None, "rns switcher did not engage")
    ksk = prepare_step_ksk(eng, level=level, pre_rescale=True)
    step = jax.jit(make_mult_step(eng, level=level, pre_rescale=True))
    tag = f"rns x{D} step {eng.ckksCfg.logN} level {level}"
    compiled = compile_reported(tag, step, *args, ksk, prm)
    hlo = compiled.as_text()
    n_ag, n_ar = hlo.count("all-gather"), hlo.count("all-reduce")
    print(f"[{tag}] collectives: all-gather={n_ag} all-reduce={n_ar}",
          flush=True)
    check(n_ag >= 1, "no all-gather in the sharded step")
    check(n_ar == 0, f"{n_ar} all-reduces in the sharded step")

    out = jax.block_until_ready(compiled(*args, ksk, prm))
    C_out = out[0].shape[0]
    for name, a in (("input ct0", args[0]), ("output ct0", out[0]),
                    ("output ct1", out[1])):
        devs = a.sharding.device_set
        rows = sorted({s.data.shape[0] for s in a.addressable_shards})
        print(f"[{tag}] {name}: {a.shape[0]} rows on {len(devs)} devices, "
              f"rows per shard {rows}", flush=True)
        check(devs == set(devices), f"{name} is not on all {D} devices")
    for o in out:
        check(not o.sharding.is_fully_replicated
              and all(s.data.shape[0] == C_out // D
                      for s in o.addressable_shards),
              "output is not sharded over the rns axis")

    ct = Ciphertext(data=out, level=level + 1, logN=eng.ckksCfg.logN,
                    creator_hash=eng.hash)
    err = _max_err(eng.decryptcode(ct, is_real=True), m1 * m2)
    print(f"[{tag}] max_abs_err={err} tol={tol}", flush=True)
    check(err <= tol, f"sharded step decrypt error {err} > {tol}")

    step_u = jax.jit(make_mult_step(eng, level=level, pre_rescale=True,
                                    rns_shard=False))
    prm_u = mult_step_params(eng, level=level, pre_rescale=True,
                             rns_shard=False)
    one = jax.device_put((*args, tuple(eng.evk.data), prm_u), devices[0])
    ref = compile_reported(f"one-card step {eng.ckksCfg.logN}", step_u,
                           *one)(*one)
    same = all(np.array_equal(np.asarray(r), np.asarray(o))
               for r, o in zip(ref, out))
    print(f"[{tag}] sharded == one card: {same}", flush=True)
    check(same, "sharded step differs from the one-card step")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card rns-sharded step")
    opts = ap.parse_args(argv)
    count = 4 if opts.four else 1

    import jax

    from tiberate_tpu.utils.runtime import card_line, use_compile_cache

    devs = require_gpu(count)
    print(f"device: {devs[0].platform} {devs[0].device_kind} "
          f"x{len(devs)}", flush=True)
    print(f"card: {card_line()}", flush=True)
    print(f"compile cache: {use_compile_cache()}", flush=True)
    cpu = jax.devices("cpu")[0]

    if opts.four:
        four_card_step("logN16", devs[:4], TOL[62])
    else:
        for preset in PRESETS:
            tol = TOL[30 if preset.endswith("_30") else 62]
            eng = public_api(preset, tol)
            step, args, evk, prm, out = fused_batched_step(eng, tol)
            step_matches_cpu(step, args, evk, prm, out, cpu)
            transforms_match_cpu(preset, cpu)
            print(f"[{preset}] peak_bytes_in_use="
                  f"{_peak_bytes(devs[0])}", flush=True)
            del eng, step, args, evk, prm, out

    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)


if __name__ == "__main__":
    main()
