import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from jax.sharding import Mesh

from tiberate_tpu.config.toy import toy_config
from tiberate_tpu.engine import CkksEngine
from tiberate_tpu.parallel.rns_sharded import make_rns_sharded_switcher

# C_ord=4, C_sp=6 at level 0 -> divisible by D=2
cfg = toy_config(logN=7, num_scales=3, num_special_primes=2, scale_bits=30)
eng = CkksEngine(cfg, seed=5, nonce=2)
evk = eng.evk

rng = np.random.default_rng(0)
C = eng.params.P  # level 0 ordinary channels
a = np.stack([rng.integers(0, q, eng.params.N)
              for q in eng.params.q[:C]]).astype(np.int64)

# unsharded reference
c0_ref, c1_ref = eng.create_switcher(jnp.asarray(a), evk, level=0)

# sharded over 2- and 4-device rns meshes (C_ord=4 -> ro=2 and ro=1)
ok = True
for D in (2, 4):
    mesh = Mesh(np.array(jax.devices()[:D]), axis_names=("rns",))
    switcher = make_rns_sharded_switcher(eng, 0, mesh, axis="rns")
    fn = jax.jit(lambda x: switcher(x, tuple(evk.data)))
    c0_s, c1_s = fn(jnp.asarray(a))
    ok0 = (np.asarray(c0_ref) == np.asarray(c0_s)).all()
    ok1 = (np.asarray(c1_ref) == np.asarray(c1_s)).all()
    ok = ok and ok0 and ok1
    if D == 2:
        sharding = c0_s.sharding

# the epilogue is fully local: exactly ONE all-gather (the input state
# broadcast), no other collective, in the compiled module
hlo = fn.lower(jnp.asarray(a)).compile().as_text()
n_ag = hlo.count("all-gather")
n_other = sum(hlo.count(c) for c in
              ("all-reduce", "reduce-scatter", "collective-permute",
               "all-to-all"))
print("rns-sharded keyswitch bit-exact:", bool(ok))
print("collectives: all_gather=%d other=%d" % (n_ag, n_other))
print("single-gather epilogue:", n_ag <= 2 and n_other == 0)
print("shardings:", sharding)

# scatter_special: special rows round-robined over the shards (near-
# perfect work scaling, one extra tiny all_gather) — still bit-exact
ok_sc = True
for D in (2, 4):
    mesh = Mesh(np.array(jax.devices()[:D]), axis_names=("rns",))
    switcher = make_rns_sharded_switcher(eng, 0, mesh, axis="rns",
                                         scatter_special=True)
    fn_sc = jax.jit(lambda x: switcher(x, tuple(evk.data)))
    c0_s, c1_s = fn_sc(jnp.asarray(a))
    ok_sc = (ok_sc
             and (np.asarray(c0_ref) == np.asarray(c0_s)).all()
             and (np.asarray(c1_ref) == np.asarray(c1_s)).all())
print("scatter_special bit-exact:", bool(ok_sc))

# --- engine integration: make_mult_step on a
# (batch, rns) engine mesh routes relinearize through this shard_map
# switcher — bit-exact vs the unsharded step, and the WHOLE compiled
# step contains exactly ONE all_gather and NO other collective.
from jax.sharding import NamedSharding, PartitionSpec as P
from tiberate_tpu.parallel.sharded import (
    make_mult_step, mult_step_params, prepare_step_ksk)

mesh2 = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
             axis_names=("batch", "rns"))
eng_m = CkksEngine(cfg, seed=5, nonce=2, mesh=mesh2)
rng2 = np.random.default_rng(1)
B = 4
ms1 = [rng2.uniform(-1, 1, eng_m.num_slots) for _ in range(B)]
ms2 = [rng2.uniform(-1, 1, eng_m.num_slots) for _ in range(B)]
cts1 = [eng_m.encodecrypt(m) for m in ms1]
cts2 = [eng_m.encodecrypt(m) for m in ms2]
stack = lambda cts, i: jnp.stack([ct.data[i] for ct in cts])
ct_shard = NamedSharding(mesh2, P("batch", "rns", None))
args = tuple(jax.device_put(stack(c, i), ct_shard) for c, i in
             ((cts1, 0), (cts1, 1), (cts2, 0), (cts2, 1)))
step = make_mult_step(eng_m, level=0, pre_rescale=False)
prm = mult_step_params(eng_m, level=0, pre_rescale=False)
assert prm["rns_tables"] is not None, "rns switcher did not engage"
evk_parts = prepare_step_ksk(eng_m, level=0, pre_rescale=False)
batched = jax.jit(jax.vmap(step, in_axes=(0, 0, 0, 0, None, None),
                           spmd_axis_name="batch"))
o0, o1 = batched(*args, evk_parts, prm)

# unsharded single-example reference from the SAME engine (the key
# streams depend on rng call order, so a twin engine would derive a
# different evk): force the GSPMD path with rns_shard=False
step_u = make_mult_step(eng_m, level=0, pre_rescale=False, rns_shard=False)
prm_u = mult_step_params(eng_m, level=0, pre_rescale=False, rns_shard=False)
evk_u = tuple(eng_m.evk.data)
ok_m = True
for b in range(B):
    r0, r1 = jax.jit(step_u)(cts1[b].data[0], cts1[b].data[1],
                             cts2[b].data[0], cts2[b].data[1], evk_u, prm_u)
    ok_m = (ok_m and (np.asarray(r0) == np.asarray(o0[b])).all()
            and (np.asarray(r1) == np.asarray(o1[b])).all())
print("engine mesh step bit-exact:", bool(ok_m))

hlo_m = batched.lower(*args, evk_parts, prm).compile().as_text()
ag_m = hlo_m.count("all-gather")
other_m = sum(hlo_m.count(c) for c in
              ("all-reduce", "reduce-scatter", "collective-permute",
               "all-to-all"))
print("engine mesh step collectives: all_gather=%d other=%d"
      % (ag_m, other_m))
print("engine one-gather structure:", ag_m == 1 and other_m == 0)
