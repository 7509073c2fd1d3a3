"""Sharded full-step builders: one jit over a complete homomorphic op.

``make_mult_step`` fuses the reference's hottest stack — rescale ->
tensor-product -> relinearize (incl. key switching, SURVEY.md §3.3) — into a
single compiled program.  Under a mesh, inputs carry NamedShardings and
GSPMD inserts the collectives: the part-sum "all-reduce realized as explicit
loops" of the reference (``ckks_engine.py:1048-1058``) becomes a psum over
the ``rns`` axis; the pinned-buffer rescaler broadcast
(``ckks_engine.py:1224-1236``) becomes an all-gather of one channel row.
"""

import os

from tiberate_tpu.engine.ckks_engine import (
    _ccmult_tensor_core,
    _intt_exit_reduce,
    _relin_core,
    _rescale_core,
)
from tiberate_tpu.ops import mont


def _rns_axis(eng, work_level):
    """The engine-mesh rns axis name when the explicit-collective
    shard_map keyswitch applies (axis present, >1 device, channel count
    divisible), else None."""
    mesh = getattr(eng, "mesh", None)
    if mesh is None or "rns" not in mesh.axis_names:
        return None
    D = mesh.shape["rns"]
    if D <= 1 or eng._lp(work_level, False).num_channels % D:
        return None
    return "rns"


def _coef_axis(eng):
    """The engine-mesh coef axis name when the polynomial-coefficient
    dimension is sharded (>1 device) — routes the step's transforms
    through explicit ppermute butterflies (parallel/coef_sharded)
    instead of GSPMD halo all-reduces."""
    mesh = getattr(eng, "mesh", None)
    if mesh is None or "coef" not in mesh.axis_names:
        return None
    if mesh.shape["coef"] <= 1 or eng.params.N % mesh.shape["coef"]:
        return None
    return "coef"


import functools


@functools.lru_cache(maxsize=16)
def _rns_switcher(eng, work_level, axis, caxis=None):
    """The shard_map keyswitch for the engine mesh (parallel/rns_sharded):
    scatter_special kicks in past D=2, where every shard recomputing all
    S special rows stops the per-shard work from shrinking; override
    with TIBERATE_SCATTER_SPECIAL=0/1.  Cached per (engine, level): the
    same instance serves make_mult_step, mult_step_params and
    prepare_step_ksk."""
    from tiberate_tpu.parallel.rns_sharded import make_rns_sharded_switcher

    D = eng.mesh.shape[axis]
    env = os.environ.get("TIBERATE_SCATTER_SPECIAL")
    scatter = (D > 2 and caxis is None) if env is None else env == "1"
    return make_rns_sharded_switcher(eng, work_level, eng.mesh, axis=axis,
                                     scatter_special=scatter,
                                     coef_axis=caxis)


@functools.lru_cache(maxsize=16)
def _coef_cores(eng, work_level, caxis, raxis):
    """Coef-explicit transform cores for the engine-mesh step: the
    tensor product's four enter-NTTs and the relinearize inverse NTTs
    under a shard_map manual over (rns, coef), with cross-shard
    butterfly pairings as lax.ppermute exchanges
    (``parallel/coef_sharded``).  LevelPack tables ride as operands so
    they stay runtime buffers (not HLO literals)."""
    import jax.numpy as jnp  # noqa: F401 — parity with sibling builders
    from jax.sharding import PartitionSpec as P

    from tiberate_tpu.parallel import coef_sharded
    from tiberate_tpu.parallel._compat import shard_map

    mesh = eng.mesh
    Dc = mesh.shape[caxis]
    logN = eng.ckksCfg.logN
    sx = P(raxis, caxis)     # [C, N] data blocks
    st = P(raxis)            # per-channel tables ([C, ...], coef-replicated)

    def tensor_body(x0, x1, y0, y1, psi, Rs, pk):
        outs = []
        for v in (x0, x1, y0, y1):
            v = mont.mont_enter(v, Rs, pk)
            outs.append(coef_sharded.ntt_block(v, psi, pk, logN, Dc,
                                               caxis))
        X0, X1, Y0, Y1 = outs
        d0 = mont.mont_mult(X0, Y0, pk)
        d1 = mont.mont_add(
            mont.mont_mult(X0, Y1, pk), mont.mont_mult(X1, Y0, pk), pk
        )
        d2 = mont.mont_mult(X1, Y1, pk)
        return d0, d1, d2

    tensor_sm = shard_map(
        tensor_body, mesh=mesh,
        in_specs=(sx, sx, sx, sx, st, st, st),
        out_specs=(sx, sx, sx),
    )

    def intt_body(x, ipsi, Ninv, pk):
        x = coef_sharded.intt_block(x, ipsi, Ninv, pk, logN, Dc, caxis)
        return mont.reduce_2q(mont.mont_reduce(x, pk), pk)

    intt_sm = shard_map(intt_body, mesh=mesh,
                        in_specs=(sx, st, st, st), out_specs=sx)

    def tensor(a0, a1, b0, b1, lp):
        return tensor_sm(a0, a1, b0, b1, lp.psi, lp.Rs, lp.pack)

    def intt_exit_reduce(x, lp):
        return intt_sm(x, lp.ipsi, lp.Ninv, lp.pack)

    return tensor, intt_exit_reduce


def prepare_step_ksk(eng, level: int = 0, pre_rescale: bool = True,
                     ksk=None):
    """The ksk argument for :func:`make_mult_step`'s step function.

    Engine-mesh rns mode: the pre-split, pre-sharded ``RnsKsk`` (slicing
    a sharded ksk inside the jit would reshard at every shard_map
    boundary — prepare it eagerly instead).  Otherwise the ksk data."""
    work_level = level + 1 if pre_rescale else level
    axis = _rns_axis(eng, work_level)
    if axis:
        sw = _rns_switcher(eng, work_level, axis, _coef_axis(eng))
        return sw.prepare_ksk(tuple((ksk or eng.evk).data))
    return tuple((ksk or eng.evk).data)


def mult_step_params(eng, level: int = 0, pre_rescale: bool = True,
                     rns_shard=None):
    """The parameter pytree for :func:`make_mult_step`'s step function.

    Passed as a jit ARGUMENT (not a closure constant): closed-over arrays
    are baked into the HLO as literals, which at production ring sizes
    makes the program megabytes-to-gigabytes large.
    """
    work_level = level + 1 if pre_rescale else level
    axis = _rns_axis(eng, work_level) if rns_shard in (None, True) else None
    return dict(
        rescale_scale=(
            eng.params.rescale_scales[level] if pre_rescale else None
        ),
        lp_next=eng._lp(work_level, False) if pre_rescale else None,
        lp_ord=eng._lp(work_level, False),
        lp_sp=eng._lp(work_level, True),
        parts=tuple(eng.params.parts[work_level]),
        PiRs=tuple(eng.params.PiRs[work_level]),
        # explicit-collective keyswitch tables (engine mesh, rns axis):
        # ride as runtime buffers, like everything else in this pytree
        rns_tables=(
            _rns_switcher(eng, work_level, axis, _coef_axis(eng)).tables
            if axis else None
        ),
    )


def make_mult_step(eng, level: int = 0, pre_rescale: bool = True,
                   rns_shard=None):
    """Returns step_fn(a0, a1, b0, b1, ksk_parts, prm) -> (ct0, ct1).

    ``prm`` is the :func:`mult_step_params` pytree; pass it per call so
    the tables ride as runtime buffers.  Fuses the reference's hottest
    stack: rescale -> tensor-product -> relinearize/keyswitch.
    """
    S = eng.ckksCfg.num_special_primes
    if pre_rescale:
        round_at = eng.params.q[level] // 2
    work_level = level + 1 if pre_rescale else level
    alloc = tuple(eng.params.parts_alloc[work_level])
    axis = (_rns_axis(eng, work_level)
            if rns_shard in (None, True) else None)
    caxis = _coef_axis(eng) if axis else None
    switcher = _rns_switcher(eng, work_level, axis, caxis) if axis else None
    coef_cores = (_coef_cores(eng, work_level, caxis, axis)
                  if caxis else None)

    def step(a0, a1, b0, b1, ksk_parts, prm):
        if pre_rescale:
            rs, lpn = prm["rescale_scale"], prm["lp_next"]
            a0 = _rescale_core(a0, rs, lpn, round_at, True)
            a1 = _rescale_core(a1, rs, lpn, round_at, True)
            b0 = _rescale_core(b0, rs, lpn, round_at, True)
            b1 = _rescale_core(b1, rs, lpn, round_at, True)
        if coef_cores is not None:
            # coef>1 engine mesh: explicit ppermute butterflies for the
            # tensor product + relinearize transforms (zero GSPMD halo
            # all-reduces; parallel/coef_sharded)
            tensor_x, intt_x = coef_cores
            d0, d1, d2 = tensor_x(a0, a1, b0, b1, prm["lp_ord"])
            lp_ord = prm["lp_ord"]
            d0 = intt_x(d0, lp_ord)
            d1 = intt_x(d1, lp_ord)
            d2 = intt_x(d2, lp_ord)
            c0, c1 = switcher(d2, ksk_parts, prm["rns_tables"])
            ct0 = mont.reduce_2q(d0 + c0, lp_ord.pack)
            ct1 = mont.reduce_2q(d1 + c1, lp_ord.pack)
            return ct0, ct1
        d0, d1, d2 = _ccmult_tensor_core(a0, a1, b0, b1, prm["lp_ord"])
        if switcher is not None:
            # Engine-mesh rns axis: relinearize through the explicit-
            # collective shard_map keyswitch (one all_gather per switch,
            # parallel/rns_sharded.py) instead of GSPMD propagation —
            # the communication structure of the reference's multi-GPU
            # loop (``ckks_engine.py:988-1058``) as XLA collectives.
            # ``ksk_parts`` must be the PLAIN ksk .data tuple here (the
            # switcher does its own part selection + slicing); batch
            # callers vmap with spmd_axis_name="batch".
            lp_ord = prm["lp_ord"]
            d0 = _intt_exit_reduce(d0, lp_ord)
            d1 = _intt_exit_reduce(d1, lp_ord)
            d2 = _intt_exit_reduce(d2, lp_ord)
            c0, c1 = switcher(d2, ksk_parts, prm["rns_tables"])
            ct0 = mont.reduce_2q(d0 + c0, lp_ord.pack)
            ct1 = mont.reduce_2q(d1 + c1, lp_ord.pack)
            return ct0, ct1
        ksk_sel = tuple(ksk_parts[g] for g in alloc)
        return _relin_core(
            d0, d1, d2, ksk_sel, prm["parts"], prm["lp_sp"],
            prm["lp_ord"], prm["PiRs"], work_level, S,
        )

    return step


def make_encdec_roundtrip(eng, level: int = 0):
    """Returns a jittable decrypt-side step for scaling tests."""
    from tiberate_tpu.engine.ckks_engine import _decrypt_double_core

    lp = eng._lp(level, False)
    C = lp.num_channels

    def step(ct0, ct1, sk):
        scaled, _ = _decrypt_double_core(
            ct0, ct1, sk, lp, eng.params.base_lp(),
            eng.params.final_scalar[level], eng._rounding_half,
            base_at=C - 1, final_round=True,
        )
        return scaled

    return step
