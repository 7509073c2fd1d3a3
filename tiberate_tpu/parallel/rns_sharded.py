"""RNS-channel-sharded key switching under ``shard_map``.

The explicit-collective realization of the reference's multi-GPU keyswitch
(SURVEY.md §2.2 / §3.3): where the reference stages per-part basis-extension
states through pinned host buffers to every GPU
(``ckks_engine.py:988-1046``) and sums part products with python loops
(``:1048-1058``), here the RNS-channel axis is sharded over a mesh axis:

* the state broadcast becomes ONE ``all_gather`` of the ordinary channels
  (the mixed-radix digits are computed replicated — they are tiny),
* each shard extends every part onto its own ``C_ord/D`` ordinary rows
  PLUS all ``S`` special rows (replicated: S is 1-2, so recomputing the
  special rows everywhere is O(S*N) — far cheaper than any collective),
  NTTs them locally (the coefficient axis is unsharded, so butterflies
  never cross shards), multiplies with its rows of the ksk, and
  accumulates — the part-sum needs no collective,
* because every shard holds current copies of the S special rows, the
  successive P-division epilogue runs fully distributed — each shard
  divides its own rows — with NO further collective; per-shard epilogue
  compute is O((C_ord/D + S) * N).

Total collectives per switch: one all_gather of [C_ord/D, N] blocks.
XLA lowers the collectives to NCCL; the mesh follows the algorithm, since
the cards of one host reach each other all to all over NVLink.
Requires the ordinary channel count to divide the axis size.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from tiberate_tpu.parallel._compat import shard_map


class RnsKsk(NamedTuple):
    """Pre-split ksk rows for the sharded switchers (``prepare_ksk``):
    ``o`` ordinary rows (sharded over the rns axis), ``s`` special rows
    (replicated; round-robined in scatter_special mode)."""

    o: tuple
    s: tuple

from tiberate_tpu.engine.ckks_engine import _pre_extend
from tiberate_tpu.ops import mont, ntt
from tiberate_tpu.ops.mont import ModPack


def _split_pack(pack: ModPack, cut):
    lo = ModPack(ql=pack.ql[:cut], qh=pack.qh[:cut], kl=pack.kl[:cut],
                 kh=pack.kh[:cut], _2q=pack._2q[:cut])
    hi = ModPack(ql=pack.ql[cut:], qh=pack.qh[cut:], kl=pack.kl[cut:],
                 kh=pack.kh[cut:], _2q=pack._2q[cut:])
    return lo, hi


def _cat_pack(a: ModPack, b: ModPack):
    return ModPack(
        ql=jnp.concatenate([a.ql, b.ql]),
        qh=jnp.concatenate([a.qh, b.qh]),
        kl=jnp.concatenate([a.kl, b.kl]),
        kh=jnp.concatenate([a.kh, b.kh]),
        _2q=jnp.concatenate([a._2q, b._2q]),
    )


def make_rns_sharded_switcher(eng, level: int, mesh, axis: str = "rns",
                              scatter_special: bool = False,
                              coef_axis: str | None = None):
    """Builds ``switcher(a, ksk_parts) -> (c0, c1)`` with 'rns'-sharded
    channels; bit-identical to ``eng.create_switcher`` output.

    a: [C_ord, N] (coefficient domain, [0, q)); ksk_parts: the engine ksk
    ``.data`` tuple (full [P+S, N] arrays).  Returns ordinary [C_ord, N],
    block-sharded over ``axis``.

    ``scatter_special``: instead of every shard replicating all S special
    rows (per-shard work (C/D + S) rows/part, which stops scaling once
    C/D nears S), the special rows are round-robined over the
    shards too (padded with duplicates when S < D) and their values
    exchanged by ONE tiny all_gather ([ceil(S/D), N] per shard) before
    the P-division epilogue.  Per-shard work drops to
    (C + S)/D rows/part — near-perfect scaling — at the price of a
    second (small) collective.

    Each shard runs the radix-2 transforms (``ops/ntt.py``).

    ``coef_axis``: also shard the polynomial coefficient axis (manual
    over BOTH mesh axes): the radix-2 butterflies' cross-shard pairings
    run as explicit ``lax.ppermute`` exchanges (``parallel/coef_sharded``)
    instead of GSPMD halo all-reduces, and the rns state all_gather moves
    [C/D_r, N/D_c] blocks.  Forces the replicated-special epilogue.
    """
    lp_ord = eng._lp(level, False)
    lp_sp = eng._lp(level, True)
    parts = tuple(eng.params.parts[level])
    alloc = eng.params.parts_alloc[level]
    PiRs = tuple(eng.params.PiRs[level])
    S = eng.params.S
    Pn = eng.params.P  # ordinary prime count (global)
    C_ord = lp_ord.num_channels
    C_sp = lp_sp.num_channels
    D = mesh.shape[axis]
    assert C_ord % D == 0, (
        f"ordinary channel count {C_ord} must divide the "
        f"'{axis}' axis size {D}"
    )
    ro = C_ord // D
    rb = ro + S

    # --- channel-axis-first table stacks (one P(axis) spec shards all) ---
    pack_o, pack_s = _split_pack(lp_sp.pack, C_ord)
    PiRs_st = jnp.stack(PiRs)  # [S, C_sp, 1]
    ot = dict(
        psi=lp_sp.psi[:C_ord], ipsi=lp_sp.ipsi[:C_ord],
        Ninv=lp_sp.Ninv[:C_ord], Rs=lp_sp.Rs[:C_ord],
        pack=pack_o,
        PiRs=jnp.swapaxes(PiRs_st[:, :C_ord], 0, 1),  # [C_ord, S, 1]
        L=tuple(
            None if p.L_enter is None
            else jnp.swapaxes(p.L_enter[:, level:Pn], 0, 1)  # [C_ord,a-1,1]
            for p in parts
        ),
    )
    st = dict(
        psi=lp_sp.psi[C_ord:], ipsi=lp_sp.ipsi[C_ord:],
        Ninv=lp_sp.Ninv[C_ord:], Rs=lp_sp.Rs[C_ord:],
        pack=pack_s,
        PiRs=PiRs_st[:, C_ord:],  # [S, S, 1]
        L=tuple(
            None if p.L_enter is None else p.L_enter[:, Pn:]  # [a-1, S, 1]
            for p in parts
        ),
    )
    # digit-recursion packs: alpha rows each, tiny — safe as constants
    plp_packs = tuple(
        lp_ord[part.lo : part.hi].pack for part in parts
    )

    if coef_axis is not None and mesh.shape[coef_axis] <= 1:
        coef_axis = None
    if coef_axis is not None:
        scatter_special = False
    Dc = mesh.shape[coef_axis] if coef_axis else 1
    logN = eng.ckksCfg.logN

    if scatter_special:
        return _make_scatter_special(
            mesh, axis, parts, alloc, level, Pn, S, D, ro,
            ot, st, pack_s, plp_packs,
        )

    def shard_fn(a_blk, ot, st, ksk_o, ksk_s):
        # 1. state broadcast: gather the ordinary channels once.
        a = lax.all_gather(a_blk, axis, tiled=True)  # [C_ord, N]
        N = a.shape[-1]

        # own rows = [ro ordinary] + [all S special] (replicated tail)
        pack = _cat_pack(ot["pack"], st["pack"])
        psi = jnp.concatenate([ot["psi"], st["psi"]])
        ipsi = jnp.concatenate([ot["ipsi"], st["ipsi"]])
        Ninv = jnp.concatenate([ot["Ninv"], st["Ninv"]])
        Rs = jnp.concatenate([ot["Rs"], st["Rs"]])
        PiRs_blk = jnp.concatenate(
            [jnp.swapaxes(ot["PiRs"], 0, 1), st["PiRs"]], axis=1
        )  # [S, rb, 1]

        d0 = None
        d1 = None
        for k, part in enumerate(parts):
            # 2. mixed-radix digits, replicated (alpha rows only)
            class _Plp:  # _pre_extend only touches .pack
                pack = plp_packs[k]

            state = _pre_extend(a[part.lo : part.hi], part, _Plp)
            # 3. extend onto own rows, in Montgomery form
            ext = jnp.broadcast_to(state[0], (rb, N))
            ext = mont.mont_enter(ext, Rs, pack)
            if part.alpha > 1:
                Lc = jnp.concatenate(
                    [jnp.swapaxes(ot["L"][k], 0, 1), st["L"][k]], axis=1
                )  # [alpha-1, rb, 1]
                for j in range(part.alpha - 1):
                    Y = jnp.broadcast_to(state[j + 1], (rb, N))
                    Y = mont.mont_mult(Y, Lc[j], pack)
                    ext = mont.mont_add(ext, Y, pack)
            kcat0 = jnp.concatenate([ksk_o[2 * k], ksk_s[2 * k]])
            kcat1 = jnp.concatenate([ksk_o[2 * k + 1], ksk_s[2 * k + 1]])
            # 4. local NTT; with a coef axis the cross-shard butterfly
            # stages exchange partner blocks by explicit ppermute
            if coef_axis is not None:
                from tiberate_tpu.parallel.coef_sharded import ntt_block

                ext = ntt_block(ext, psi, pack, logN, Dc, coef_axis)
            else:
                ext = ntt.ntt(ext, psi, pack)
            t0 = mont.mont_mult(ext, kcat0, pack)
            t1 = mont.mont_mult(ext, kcat1, pack)
            if d0 is None:
                d0, d1 = t0, t1
            else:
                d0 = mont.mont_add(d0, t0, pack)
                d1 = mont.mont_add(d1, t1, pack)

        # 5. fully-local epilogue: iNTT own rows, then successive
        # P-division — every shard holds current special rows, so each
        # iteration is pure local row arithmetic.
        if coef_axis is not None:
            from tiberate_tpu.parallel.coef_sharded import intt_block

            d0 = mont.reduce_2q(mont.mont_reduce(
                intt_block(d0, ipsi, Ninv, pack, logN, Dc, coef_axis),
                pack), pack)
            d1 = mont.reduce_2q(mont.mont_reduce(
                intt_block(d1, ipsi, Ninv, pack, logN, Dc, coef_axis),
                pack), pack)
        else:
            d0 = ntt.intt_exit_reduce(d0, ipsi, Ninv, pack)
            d1 = ntt.intt_exit_reduce(d1, ipsi, Ninv, pack)

        Rs_o, pack_o_blk = ot["Rs"], ot["pack"]
        d0 = d0.at[:ro].set(mont.mont_enter(d0[:ro], Rs_o, pack_o_blk))
        d1 = d1.at[:ro].set(mont.mont_enter(d1[:ro], Rs_o, pack_o_blk))
        for P_ind in range(S):
            PiRi = PiRs_blk[P_ind]
            for which in (0, 1):
                d = d0 if which == 0 else d1
                row = jnp.broadcast_to(d[rb - 1 - P_ind], (rb, N))
                row = row.at[:ro].set(
                    mont.mont_enter(row[:ro], Rs_o, pack_o_blk)
                )
                d = mont.mont_sub(d, row, pack)
                d = mont.mont_mult(d, PiRi, pack)
                if which == 0:
                    d0 = d
                else:
                    d1 = d

        c0 = mont.reduce_2q(
            mont.mont_reduce(d0[:ro], pack_o_blk), pack_o_blk
        )
        c1 = mont.reduce_2q(
            mont.mont_reduce(d1[:ro], pack_o_blk), pack_o_blk
        )
        # own ordinary rows (output block-sharded like the input)
        return c0, c1

    ca = coef_axis  # None -> coefficient dim replicated (single name)
    sharded = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(axis, ca), P(axis), P(), P(axis, ca), P(None, ca)),
        out_specs=(P(axis, ca), P(axis, ca)),
    )

    def _split_ksk(ksk_parts_full):
        ksk_o, ksk_s = [], []
        for g in alloc:
            k0, k1 = ksk_parts_full[g]
            ksk_o += [k0[level:Pn], k1[level:Pn]]
            ksk_s += [k0[Pn:], k1[Pn:]]
        return tuple(ksk_o), tuple(ksk_s)

    def prepare_ksk(ksk_parts_full):
        """Eagerly pre-split + pre-shard the ksk rows for in-jit use:
        ordinary rows over ``axis``, special rows replicated.  Slicing a
        sharded ksk INSIDE the jit would force GSPMD resharding
        collectives at every shard_map boundary."""
        ksk_o, ksk_s = _split_ksk(ksk_parts_full)
        sh_o = NamedSharding(mesh, P(axis, ca))
        sh_s = NamedSharding(mesh, P(None, ca))
        return RnsKsk(
            tuple(jax.device_put(k, sh_o) for k in ksk_o),
            tuple(jax.device_put(k, sh_s) for k in ksk_s),
        )

    def switcher(a, ksk, tables=None):
        """a: [C_ord, N]; ksk: engine ksk .data tuple, or the
        :func:`prepare_ksk` pre-split/pre-sharded form (preferred inside
        larger jits).

        ``tables`` (default: the closure's (ot, st)) lets an outer
        jit pass the twiddle/constant tables as RUNTIME arguments instead
        of baking them into the HLO as literals (``switcher.tables`` is
        the matching pytree — thread it through e.g.
        ``mult_step_params``).
        """
        ot_, st_ = tables if tables is not None else (ot, st)
        if isinstance(ksk, RnsKsk):
            ksk_o, ksk_s = ksk.o, ksk.s
        else:
            ksk_o, ksk_s = _split_ksk(ksk)
        return sharded(a, ot_, st_, ksk_o, ksk_s)

    switcher.tables = (ot, st)
    switcher.prepare_ksk = prepare_ksk
    return switcher


def _make_scatter_special(mesh, axis, parts, alloc, level, Pn,
                          S, D, ro, ot, st, pack_s, plp_packs):
    """The scatter_special switcher: special rows round-robined over the
    shards (padded with duplicates when S < D), one extra tiny
    all_gather of the special accumulator rows before the epilogue."""
    rps = -(-S // D)                 # special rows per shard (padded)
    total = D * rps
    src = [i if i < S else i % S for i in range(total)]

    def take(v):
        return v[jnp.array(src)]

    pack_p = ModPack(ql=take(st["pack"].ql), qh=take(st["pack"].qh),
                     kl=take(st["pack"].kl), kh=take(st["pack"].kh),
                     _2q=take(st["pack"]._2q))
    stp = dict(
        psi=take(st["psi"]), ipsi=take(st["ipsi"]),
        Ninv=take(st["Ninv"]), Rs=take(st["Rs"]), pack=pack_p,
        L=tuple(
            None if Lk is None
            else take(jnp.swapaxes(Lk, 0, 1))   # [total, a-1, 1]
            for Lk in st["L"]
        ),
    )
    stsm = dict(pack=pack_s, PiRs=st["PiRs"])   # replicated, tiny

    def shard_fn(a_blk, ot, stp, stsm, ksk_o, ksk_sp):
        a = lax.all_gather(a_blk, axis, tiled=True)  # [C_ord, N]
        N = a.shape[-1]
        rb_s = ro + rps                  # own rows this shard transforms

        pack = _cat_pack(ot["pack"], stp["pack"])
        psi = jnp.concatenate([ot["psi"], stp["psi"]])
        ipsi = jnp.concatenate([ot["ipsi"], stp["ipsi"]])
        Ninv = jnp.concatenate([ot["Ninv"], stp["Ninv"]])
        Rs = jnp.concatenate([ot["Rs"], stp["Rs"]])

        d0 = None
        d1 = None
        for k, part in enumerate(parts):
            class _Plp:  # _pre_extend only touches .pack
                pack = plp_packs[k]

            state = _pre_extend(a[part.lo : part.hi], part, _Plp)
            ext = jnp.broadcast_to(state[0], (rb_s, N))
            ext = mont.mont_enter(ext, Rs, pack)
            if part.alpha > 1:
                Lc = jnp.concatenate(
                    [jnp.swapaxes(ot["L"][k], 0, 1),
                     jnp.swapaxes(stp["L"][k], 0, 1)], axis=1
                )  # [alpha-1, rb_s, 1]
                for j in range(part.alpha - 1):
                    Y = jnp.broadcast_to(state[j + 1], (rb_s, N))
                    Y = mont.mont_mult(Y, Lc[j], pack)
                    ext = mont.mont_add(ext, Y, pack)
            kcat0 = jnp.concatenate([ksk_o[2 * k], ksk_sp[2 * k]])
            kcat1 = jnp.concatenate([ksk_o[2 * k + 1], ksk_sp[2 * k + 1]])
            ext = ntt.ntt(ext, psi, pack)
            t0 = mont.mont_mult(ext, kcat0, pack)
            t1 = mont.mont_mult(ext, kcat1, pack)
            if d0 is None:
                d0, d1 = t0, t1
            else:
                d0 = mont.mont_add(d0, t0, pack)
                d1 = mont.mont_add(d1, t1, pack)

        d0 = ntt.intt_exit_reduce(d0, ipsi, Ninv, pack)
        d1 = ntt.intt_exit_reduce(d1, ipsi, Ninv, pack)

        # exchange special accumulator rows (the ONLY extra collective:
        # [rps, N] per shard; padded duplicates drop out of the slice)
        sp0 = lax.all_gather(d0[ro:], axis, tiled=True)[:S]
        sp1 = lax.all_gather(d1[ro:], axis, tiled=True)[:S]

        # fully-local P-division epilogue on [ro + S] rows, as in the
        # replicated-special path
        rb = ro + S
        pack_rb = _cat_pack(ot["pack"], stsm["pack"])
        PiRs_blk = jnp.concatenate(
            [jnp.swapaxes(ot["PiRs"], 0, 1), stsm["PiRs"]], axis=1
        )  # [S, rb, 1]
        Rs_o, pack_o_blk = ot["Rs"], ot["pack"]
        e0 = jnp.concatenate([d0[:ro], sp0])
        e1 = jnp.concatenate([d1[:ro], sp1])
        e0 = e0.at[:ro].set(mont.mont_enter(e0[:ro], Rs_o, pack_o_blk))
        e1 = e1.at[:ro].set(mont.mont_enter(e1[:ro], Rs_o, pack_o_blk))
        for P_ind in range(S):
            PiRi = PiRs_blk[P_ind]
            for which in (0, 1):
                d = e0 if which == 0 else e1
                row = jnp.broadcast_to(d[rb - 1 - P_ind], (rb, N))
                row = row.at[:ro].set(
                    mont.mont_enter(row[:ro], Rs_o, pack_o_blk)
                )
                d = mont.mont_sub(d, row, pack_rb)
                d = mont.mont_mult(d, PiRi, pack_rb)
                if which == 0:
                    e0 = d
                else:
                    e1 = d

        c0 = mont.reduce_2q(
            mont.mont_reduce(e0[:ro], pack_o_blk), pack_o_blk
        )
        c1 = mont.reduce_2q(
            mont.mont_reduce(e1[:ro], pack_o_blk), pack_o_blk
        )
        return c0, c1

    sharded = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(), P(axis), P(axis)),
        out_specs=(P(axis), P(axis)),
    )

    def _split_ksk(ksk_parts_full):
        ksk_o, ksk_sp = [], []
        idx = jnp.array(src)
        for g in alloc:
            k0, k1 = ksk_parts_full[g]
            ksk_o += [k0[level:Pn], k1[level:Pn]]
            ksk_sp += [k0[Pn:][idx], k1[Pn:][idx]]
        return tuple(ksk_o), tuple(ksk_sp)

    def prepare_ksk(ksk_parts_full):
        """Pre-split + pre-shard (see the replicated-special variant);
        the round-robined special rows are sharded over ``axis`` too."""
        ksk_o, ksk_sp = _split_ksk(ksk_parts_full)
        sh = NamedSharding(mesh, P(axis))
        return RnsKsk(
            tuple(jax.device_put(k, sh) for k in ksk_o),
            tuple(jax.device_put(k, sh) for k in ksk_sp),
        )

    def switcher(a, ksk, tables=None):
        """a: [C_ord, N]; ksk: engine ksk .data tuple or the
        :func:`prepare_ksk` form.
        ``tables``: see the replicated-special ``switcher`` docstring."""
        ot_, stp_, stsm_ = (tables if tables is not None
                            else (ot, stp, stsm))
        if isinstance(ksk, RnsKsk):
            ksk_o, ksk_sp = ksk.o, ksk.s
        else:
            ksk_o, ksk_sp = _split_ksk(ksk)
        return sharded(a, ot_, stp_, stsm_, ksk_o, ksk_sp)

    switcher.tables = (ot, stp, stsm)
    switcher.prepare_ksk = prepare_ksk
    return switcher
