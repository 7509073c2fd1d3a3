"""The CKKS scheme engine — a JAX redesign of the reference
``tiberate/engine/ckks_engine.py`` (2488 LoC).

Structural differences from the reference (behavioral parity preserved):

* polynomials are single ``[C, N]`` int64 arrays (RNS-channel-major) instead
  of per-GPU tensor lists; level views are static row slices,
* every hot path is a module-level jit-compiled pure function taking a
  :class:`LevelPack` pytree — one compiled program per level, the equivalent
  of the reference's ``pre_package`` argument-tuple cache
  (``ntt_context.py:572-680``) but fused end-to-end by XLA,
* the pinned-host-buffer broadcasts of the reference multi-GPU path
  (``ckks_engine.py:988-1046, 1224-1236``) disappear: cross-shard movement
  becomes XLA collectives when the channel axis is sharded over a mesh (see
  ``tiberate_tpu.parallel``),
* RNG state stepping and fp64 FFT encode stay on host; everything after
  sampling runs on device.

Method-for-method parity with the reference CkksEngine API (SURVEY.md §2.1):
keygen, encode/decode, encrypt/decrypt, encodecrypt/decryptcode (bias_guard
3-prime CRT DC reconstruction), cc_add/sub/mult, pc_add/pc_mult, mc_add/
mc_mult, scalar ops, rescale (exact rounding), relinearize, key switching
(mixed-radix basis extension), rotations, conjugation, negate, level_up, and
the stats suite (sum/mean/cov/pow/sqrt/var/std/randn).
"""

import functools
import logging
import math
from hashlib import sha256
from uuid import uuid4

import jax
import jax.numpy as jnp
import numpy as np

from tiberate_tpu import errors
from tiberate_tpu.config import CkksConfig, Preset
from tiberate_tpu.context.ntt_context import CkksParams, LevelPack, PartPack
from tiberate_tpu.ops import mont, mxu_ntt, ntt
from tiberate_tpu.ops.transform import choose_transform
from tiberate_tpu.rng.csprng import Csprng
from tiberate_tpu.typing import (
    FLAGS,
    Ciphertext,
    CiphertextTriplet,
    ConjugationKey,
    EvaluationKey,
    GaloisKey,
    KeySwitchKey,
    Plaintext,
    PublicKey,
    RotationKey,
    SecretKey,
    register_default_engine,
)
from tiberate_tpu.utils import encoding as codec
from tiberate_tpu.utils.massive import decompose_rot_offsets

logger = logging.getLogger("tiberate_tpu")

# ======================================================================
# Jitted cores.  LevelPack/PartPack ride through jit as pytrees; part
# layout and level index are static so XLA sees fixed shapes.
# ======================================================================


def _enter_ntt(x, lp):
    if lp.mxu_fwd is not None:
        return mxu_ntt.ntt(x, lp.mxu_fwd, enter=True)
    return ntt.enter_ntt(x, lp.Rs, lp.psi, lp.pack)


def _ntt_plain(x, lp, signed=False):
    """Forward NTT of Montgomery-form input (no entry).

    ``signed`` routes through the radix-2 int64 path (key-material
    rotation feeds sign-flipped representatives; the int8 4-step path is
    unsigned-only).
    """
    if lp.mxu_fwd is not None and not signed:
        return mxu_ntt.ntt(x, lp.mxu_fwd, enter=False)
    return ntt.ntt(x, lp.psi, lp.pack, signed=signed)


def _intt_exit(x, lp):
    if lp.mxu_inv is not None:
        return mxu_ntt.intt(x, lp.mxu_inv, epilogue="exit")
    return ntt.intt_exit(x, lp.ipsi, lp.Ninv, lp.pack)


def _intt_exit_reduce(x, lp):
    if lp.mxu_inv is not None:
        return mont.reduce_2q(
            mxu_ntt.intt(x, lp.mxu_inv, epilogue="exit"), lp.pack
        )
    return ntt.intt_exit_reduce(x, lp.ipsi, lp.Ninv, lp.pack)


@jax.jit
def _encrypt_core(pt, dc_rns, e0, e1, v, pk0, pk1, lp: LevelPack):
    """pt/e0/e1/v: [N] signed int64; pk0/pk1: [C, N]; dc_rns: [C] bias-guard
    DC residues (zeros when bias_guard off).  -> (ct0, ct1).

    Mirrors reference encrypt/encodecrypt (``ckks_engine.py:546-617,
    1835-1878``).
    """
    pk = lp.pack
    e0_t = mont.tile_unsigned(e0, pk)
    e1_t = mont.tile_unsigned(e1, pk)
    pt_t = mont.tile_unsigned(pt, pk)
    pt_t = pt_t.at[:, 0].add(dc_rns.astype(pt_t.dtype))
    pt_t = mont.mont_enter(pt_t, lp.Rs_scale, pk)
    pt_t = mont.mont_reduce(pt_t, pk)
    pte0 = mont.mont_add(pt_t, e0_t, pk)

    v_t = _enter_ntt(mont.tile_unsigned(v, pk), lp)
    vpk0 = _intt_exit(mont.mont_mult(v_t, pk0, pk), lp)
    vpk1 = _intt_exit(mont.mont_mult(v_t, pk1, pk), lp)

    ct0 = mont.reduce_2q(mont.mont_add(vpk0, pte0, pk), pk)
    ct1 = mont.reduce_2q(mont.mont_add(vpk1, e1_t, pk), pk)
    return ct0, ct1


# One compiled encrypt per call (the body is ~20 elementwise ops, so
# eager dispatch would dominate it), and the batch form for
# encodecrypt_batch.
_encrypt_core_jit = jax.jit(_encrypt_core)
_encrypt_batch_core = jax.jit(
    jax.vmap(_encrypt_core, in_axes=(0, 0, 0, 0, 0, None, None, None))
)


def _final_scale(pt, base_lp, final_scalar, rounding_half, base_at,
                 final_round):
    """Common decrypt epilogue: (base - scaler) * q_lvl^-1, signed, rounded.

    Reference ``ckks_engine.py:1959-2015`` (sans bias guard, handled by the
    caller on host).
    """
    bpk = base_lp.pack
    base = pt[base_at][None, :]
    scaler = pt[0][None, :]
    scaled = mont.mont_sub(base, scaler, bpk)
    scaled = mont.mont_mult(scaled, final_scalar, bpk)
    scaled = mont.reduce_2q(scaled, bpk)
    scaled = mont.make_signed(scaled, bpk)
    if final_round:
        rounder = (scaler > rounding_half).astype(scaled.dtype)
        scaled = scaled + rounder
    return scaled


@functools.partial(jax.jit, static_argnames=("base_at", "final_round"))
def _decrypt_double_core(ct0, ct1, sk, lp, base_lp, final_scalar,
                         rounding_half, base_at, final_round):
    """Reference decrypt_double (``ckks_engine.py:688-739``)."""
    pk = lp.pack
    a = _enter_ntt(ct1, lp)
    sa = _intt_exit(mont.mont_mult(a, sk, pk), lp)
    pt = mont.reduce_2q(mont.mont_add(ct0, sa, pk), pk)
    scaled = _final_scale(pt, base_lp, final_scalar, rounding_half,
                          base_at, final_round)
    return scaled, pt


@functools.partial(jax.jit, static_argnames=("base_at", "final_round"))
def _decrypt_triplet_core(d0, d1, d2, sk, lp, base_lp, final_scalar,
                          rounding_half, base_at, final_round):
    """Reference decrypt_triplet (``ckks_engine.py:621-685``)."""
    pk = lp.pack
    d0x = _intt_exit_reduce(d0, lp)
    d1_s = mont.mont_mult(d1, sk, pk)
    s2 = mont.mont_mult(sk, sk, pk)
    d2_s2 = mont.mont_mult(d2, s2, pk)
    d1_s = _intt_exit(d1_s, lp)
    d2_s2 = _intt_exit(d2_s2, lp)
    pt = mont.mont_add(d0x, d1_s, pk)
    pt = mont.mont_add(pt, d2_s2, pk)
    pt = mont.reduce_2q(pt, pk)
    scaled = _final_scale(pt, base_lp, final_scalar, rounding_half,
                          base_at, final_round)
    return scaled, pt


# ----------------------------------------------------------------------
# Key switching (the hard 20%: reference create_switcher,
# ``ckks_engine.py:954-1127``).
# ----------------------------------------------------------------------


def _pre_extend(a_part, part: PartPack, plp: LevelPack):
    """Mixed-radix (Garner) digits of the part residues.

    a_part: [alpha, N] values in [0, q); returns [alpha, N] digits.
    Reference ``ckks_engine.py:844-903``.
    """
    alpha = part.alpha
    rows = [a_part[0]] * alpha
    for i in range(alpha - 1):
        pk = plp.pack
        ql, qh = pk.ql[i + 1], pk.qh[i + 1]
        kl, kh = pk.kl[i + 1], pk.kh[i + 1]
        y = a_part[i + 1] - rows[i + 1]
        y = mont.mont_mult_raw(y, part.Y_scalar[i], ql, qh, kl, kh)
        rows[i + 1] = y
        if i + 2 < alpha:
            suffix = pk[i + 2 : alpha]
            ynew = mont.mont_mult_raw(
                y[None, :], part.L_scalar[i],
                suffix.ql, suffix.qh, suffix.kl, suffix.kh,
            )
            for j, r in enumerate(range(i + 2, alpha)):
                rows[r] = rows[r] + ynew[j]
    return jnp.stack(rows)


def _extend(state, part: PartPack, lp_sp: LevelPack, lvl: int):
    """Basis-extend mixed-radix digits onto the full with-special basis.

    Returns [C_sp, N] in Montgomery form.  Reference
    ``ckks_engine.py:906-951``.
    """
    C = lp_sp.num_channels
    N = state.shape[-1]
    ext = jnp.broadcast_to(state[0], (C, N))
    ext = mont.mont_enter(ext, lp_sp.Rs, lp_sp.pack)
    for i in range(part.alpha - 1):
        Y = jnp.broadcast_to(state[i + 1], (C, N))
        Y = mont.mont_mult(Y, part.L_enter[i][lvl:], lp_sp.pack)
        ext = mont.mont_add(ext, Y, lp_sp.pack)
    return ext


def _switcher_body(a, ksk_parts, parts, lp_sp, lp_ord, PiRs, lvl, S,
                   exit_ntt):
    """create_switcher on one logical shard; returns (c0, c1) ordinary.

    The reference's per-device loops, pinned-buffer hops and part-sum
    all-reduce (``ckks_engine.py:978-1058``) collapse to a part loop whose
    partial products accumulate in-register; on a sharded mesh the final
    accumulation becomes a psum over the channel axis.
    """
    if exit_ntt:
        a = _intt_exit_reduce(a, lp_ord)

    # One chain per part (extend -> NTT -> two key products -> add); see
    # PERF.md for why the parts are not stacked into one transform.
    d0 = None
    d1 = None
    for part, (k0, k1) in zip(parts, ksk_parts):
        plp = lp_ord[part.lo : part.hi]
        state = _pre_extend(a[part.lo : part.hi], part, plp)
        ext = _extend(state, part, lp_sp, lvl)
        ext = _ntt_plain(ext, lp_sp)
        t0 = mont.mont_mult(ext, k0[lvl:], lp_sp.pack)
        t1 = mont.mont_mult(ext, k1[lvl:], lp_sp.pack)
        if d0 is None:
            d0, d1 = t0, t1
        else:
            d0 = mont.mont_add(d0, t0, lp_sp.pack)
            d1 = mont.mont_add(d1, t1, lp_sp.pack)

    d0 = _intt_exit_reduce(d0, lp_sp)
    d1 = _intt_exit_reduce(d1, lp_sp)

    # Divide by P: successive rescale from the outermost special prime
    # (reference ``ckks_engine.py:1068-1124``).
    C = lp_ord.num_channels
    C_sp = lp_sp.num_channels
    N = d0.shape[-1]

    d0 = d0.at[:C].set(mont.mont_enter(d0[:C], lp_ord.Rs, lp_ord.pack))
    d1 = d1.at[:C].set(mont.mont_enter(d1[:C], lp_ord.Rs, lp_ord.pack))

    for P_ind in range(S):
        PiRi = PiRs[P_ind]
        for dname in (0, 1):
            d = d0 if dname == 0 else d1
            P0 = jnp.broadcast_to(d[C_sp - 1 - P_ind], (C_sp, N))
            P0 = P0.at[:C].set(
                mont.mont_enter(P0[:C], lp_ord.Rs, lp_ord.pack)
            )
            d = mont.mont_sub(d, P0, lp_sp.pack)
            d = mont.mont_mult(d, PiRi, lp_sp.pack)
            if dname == 0:
                d0 = d
            else:
                d1 = d

    c0 = mont.reduce_2q(mont.mont_reduce(d0[:C], lp_ord.pack), lp_ord.pack)
    c1 = mont.reduce_2q(mont.mont_reduce(d1[:C], lp_ord.pack), lp_ord.pack)
    return c0, c1


@functools.partial(jax.jit, static_argnames=("lvl", "S", "exit_ntt"))
def _switcher_core(a, ksk_parts, parts, lp_sp, lp_ord, PiRs, lvl, S,
                   exit_ntt):
    return _switcher_body(a, ksk_parts, parts, lp_sp, lp_ord, PiRs, lvl, S,
                          exit_ntt)


@functools.partial(jax.jit, static_argnames=("lvl", "S", "exit_ntt"))
def _switch_key_core(ct0, a, ksk_parts, parts, lp_sp, lp_ord, PiRs, lvl, S,
                     exit_ntt):
    """switch_key: new ct0 = ct0 + c0, new ct1 = c1
    (reference ``ckks_engine.py:1167-1184``)."""
    c0, c1 = _switcher_body(a, ksk_parts, parts, lp_sp, lp_ord, PiRs, lvl,
                            S, exit_ntt)
    new0 = mont.reduce_2q(mont.mont_add(ct0, c0, lp_ord.pack), lp_ord.pack)
    return new0, c1


@jax.jit
def _ccmult_tensor_core(x0, x1, y0, y1, lp):
    """Tensor product in the NTT domain (reference ``ckks_engine.py:1328-
    1339``): d0 = x0y0, d1 = x0y1 + x1y0, d2 = x1y1."""
    pk = lp.pack
    x0 = _enter_ntt(x0, lp)
    x1 = _enter_ntt(x1, lp)
    y0 = _enter_ntt(y0, lp)
    y1 = _enter_ntt(y1, lp)
    d0 = mont.mont_mult(x0, y0, pk)
    d1 = mont.mont_add(
        mont.mont_mult(x0, y1, pk), mont.mont_mult(x1, y0, pk), pk
    )
    d2 = mont.mont_mult(x1, y1, pk)
    return d0, d1, d2


@functools.partial(jax.jit, static_argnames=("lvl", "S"))
def _relin_core(d0, d1, d2, ksk_parts, parts, lp_sp, lp_ord, PiRs, lvl, S):
    """relinearize (reference ``ckks_engine.py:1358-1394``)."""
    d0 = _intt_exit_reduce(d0, lp_ord)
    d1 = _intt_exit_reduce(d1, lp_ord)
    d2 = _intt_exit_reduce(d2, lp_ord)
    c0, c1 = _switcher_body(d2, ksk_parts, parts, lp_sp, lp_ord, PiRs, lvl,
                            S, False)
    ct0 = mont.reduce_2q(d0 + c0, lp_ord.pack)
    ct1 = mont.reduce_2q(d1 + c1, lp_ord.pack)
    return ct0, ct1


@functools.partial(jax.jit, static_argnames=("round_at", "exact_rounding"))
def _rescale_core(d, rescale_scale, lp_next, round_at, exact_rounding):
    """Drop the top RNS channel with exact rounding (reference
    ``ckks_engine.py:1192-1284``).  d: [C, N] in [0, q)."""
    rescaler = d[0]
    data = d[1:] - rescaler[None, :]
    data = mont.mont_mult(data, rescale_scale, lp_next.pack)
    if exact_rounding:
        rounder = (rescaler > round_at).astype(data.dtype)
        data = data + rounder[None, :]
    # REDC of a signed difference can land marginally below zero (> -q/4);
    # normalize so ciphertexts keep the [0, q) invariant the unsigned
    # transform paths (int8 4-step, uint32-pair NTT) rely on.
    data = mont.make_unsigned(data, lp_next.pack)
    return mont.reduce_2q(data, lp_next.pack)


@jax.jit
def _cc_add_core(a, b, lp):
    return mont.reduce_2q(mont.mont_add(a, b, lp.pack), lp.pack)


@jax.jit
def _cc_sub_core(a, b, lp):
    return mont.reduce_2q(mont.mont_sub(a, b, lp.pack), lp.pack)


@jax.jit
def _rotate_data_core(d, src, sign, lp):
    """Galois coefficient permutation + make_unsigned + reduce_2q
    (reference ``ckks_engine.py:1429-1450``)."""
    out = sign.astype(d.dtype)[None, :] * d[..., src]
    out = mont.make_unsigned(out, lp.pack)
    return mont.reduce_2q(out, lp.pack)


@jax.jit
def _perm_ntt_core(d, src, sign, lp):
    """Coefficient permutation of key material, then the signed forward
    NTT, as one program (reference ``ckks_engine.py:1408-1411``)."""
    out = sign.astype(d.dtype)[None, :] * d[..., src]
    return _ntt_plain(out, lp, signed=True)


@jax.jit
def _pc_add_core(pt_m, ct0, lp):
    """pt (cached, = pt*scale*R) + ct: reference ``ckks_engine.py:2119-
    2127``."""
    pk = lp.pack
    new0 = mont.mont_enter(ct0, lp.Rs, pk)
    s = mont.mont_add(pt_m, new0, pk)
    s = mont.mont_reduce(s, pk)
    return mont.reduce_2q(s, pk)


@jax.jit
def _pc_mult_core(pt_ntt, ct0, ct1, lp):
    """pt (cached, NTT+mont) * ct: reference ``ckks_engine.py:2149-2160``."""
    pk = lp.pack
    c0 = _enter_ntt(ct0, lp)
    c1 = _enter_ntt(ct1, lp)
    d0 = _intt_exit_reduce(mont.mont_mult(pt_ntt, c0, pk), lp)
    d1 = _intt_exit_reduce(mont.mont_mult(pt_ntt, c1, pk), lp)
    return d0, d1


@jax.jit
def _mont_scalar_core(d, scalar_col, lp):
    out = mont.mont_mult(d, scalar_col, lp.pack)
    return mont.reduce_2q(out, lp.pack)


@jax.jit
def _add_scalar_core(ct0, scalar_col, lp):
    out = ct0.at[:, 0].add(scalar_col[:, 0])
    return mont.reduce_2q(out, lp.pack)


@jax.jit
def _negate_core(d, lp):
    """Negation normalized to [0, q) (the reference stores the signed
    representative, ``ckks_engine.py:2086-2095``; same residue class, and
    the unsigned invariant keeps the fast NTT paths valid)."""
    s = mont.make_signed(-d, lp.pack)
    return mont.make_unsigned(s, lp.pack)


@jax.jit
def _prepare_pc_add_cache(pt, lp):
    pk = lp.pack
    pt_t = mont.tile_unsigned(pt, pk)
    return mont.mont_enter(pt_t, lp.Rs_scale, pk)


@jax.jit
def _prepare_pc_mult_cache(pt, lp):
    pk = lp.pack
    pt_t = mont.tile_unsigned(pt, pk)
    return _enter_ntt(pt_t, lp)


@jax.jit
def _keygen_sk_core(ternary, lp):
    """uniform ternary -> NTT+Montgomery secret key
    (reference ``ckks_engine.py:467-485``)."""
    u = mont.tile_unsigned(ternary, lp.pack)
    return _enter_ntt(u, lp)


@jax.jit
def _keygen_pk_core(e, a, sk, lp):
    """pk = (e - a*s, a) (reference ``ckks_engine.py:488-538``)."""
    pk = lp.pack
    e_t = mont.tile_unsigned(e, pk)
    e_t = _enter_ntt(e_t, lp)
    sa = mont.mont_mult(a, sk, pk)
    pk0 = mont.mont_sub(e_t, sa, pk)
    return pk0


@functools.partial(jax.jit, static_argnames=("lo", "alpha"))
def _ksk_shard_core(pk0, Psk, lo, alpha, pack_part):
    """Add the P-scaled source-key shard into a ksk part's pk0
    (reference ``ckks_engine.py:805-830``)."""
    sl = pk0[lo : lo + alpha]
    upd = mont.mont_add(sl, Psk, pack_part)
    return pk0.at[lo : lo + alpha].set(upd)


# ======================================================================
# The engine.
# ======================================================================


class _RotkCache:
    """``engine.rotk`` view: subscripting generates keys on demand,
    membership checks consult only the existing store."""

    def __init__(self, eng):
        self._eng = eng

    def __getitem__(self, delta: int):
        return self._eng.get_rotation_key(delta)

    def __contains__(self, delta) -> bool:
        return delta in self._eng._rotk_store

    def keys(self):
        return self._eng._rotk_store.keys()

    def __iter__(self):
        return iter(self._eng._rotk_store)

    def __len__(self):
        return len(self._eng._rotk_store)


class CkksEngine:
    """CKKS engine over a single logical shard (mesh-shardable arrays).

    Drop-in capability match for the reference engine; see module docstring.
    """

    def __init__(
        self,
        ckks_config: CkksConfig | dict | Preset | str | None = None,
        devices=None,  # accepted for API parity; sharding via parallel/
        allow_sk_gen: bool = True,
        bias_guard: bool = True,
        norm: str = "forward",
        seed=None,
        nonce=None,
        transform: str | None = None,
        mesh=None,
    ):
        if ckks_config is None:
            ckks_config = Preset.logN15
        if isinstance(ckks_config, CkksConfig) or (
            hasattr(ckks_config, "q") and hasattr(ckks_config, "logN")
        ):
            # Accept any duck-typed config carrying a prime chain (used by
            # tests with toy ring sizes outside the preset cache).
            self.ckksCfg = ckks_config
        else:
            self.ckksCfg = CkksConfig.parse(ckks_config)

        self.params = CkksParams(self.ckksCfg)
        self.montCtx = self.params.montCtx
        self.rnsPart = self.params.rnsPart

        # The NTT implementation (ops/transform.py): radix-2 butterflies
        # or the int8 4-step, from the platform the engine's arrays live
        # on, the ring size and the lane width.
        platform = (mesh.devices.flat[0].platform if mesh is not None
                    else jax.default_backend())
        self.transform = choose_transform(
            platform, self.ckksCfg.logN, self.ckksCfg.buffer_bit_length,
            requested=transform,
        )
        if self.transform == "int8_4step":
            self.params.enable_mxu_ntt()

        # Engine-native sharding (the reference engine was natively
        # multi-device, ``ckks_engine.py:988-1058``; here the equivalent is
        # a device mesh): when ``mesh`` is given, every key and every fresh
        # ciphertext is laid out with RNS channels over the 'rns' axis and
        # polynomial coefficients over the 'coef' axis, and GSPMD inserts
        # the collectives inside the existing jit cores.
        self.mesh = mesh
        self._data_sharding = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            axes = mesh.axis_names
            spec = PartitionSpec(
                "rns" if "rns" in axes else None,
                "coef" if "coef" in axes else None,
            )
            self._data_sharding = NamedSharding(mesh, spec)

        self.rng = Csprng(
            num_coefs=self.ckksCfg.N,
            num_channels=[self.params.P],
            num_repeating_channels=max(self.ckksCfg.num_special_primes, 2),
            sigma=self.ckksCfg.sigma,
            seed=seed,
            nonce=nonce,
        )

        self.bias_guard = bias_guard
        self.norm = norm
        self.id = str(uuid4())

        self.allow_sk_gen = allow_sk_gen
        self.__sk = None
        self.__pk = None
        self.__evk = None
        self.__gk = None
        self.__rotk = {}
        self.__conjk = None

        register_default_engine(self.ckksCfg.logN, self)
        logger.info(
            "CkksEngine %s ready: logN=%d levels=%d special=%d "
            "transform=%s",
            self.id[:8], self.ckksCfg.logN, self.num_levels,
            self.ckksCfg.num_special_primes, self.transform,
        )

    # ------------------------------------------------------------------
    # Introspection.
    # ------------------------------------------------------------------

    @property
    def num_levels(self) -> int:
        return self.ckksCfg.num_scales

    @property
    def num_slots(self) -> int:
        return self.ckksCfg.N // 2

    @property
    @functools.cache
    def hash(self) -> str:
        q_str = ",".join(map(str, self.montCtx.q))
        return sha256(f"{self.ckksCfg!r}_{q_str}".encode()).hexdigest()

    def __str__(self):
        return f"{self.__class__.__name__} ({self.id}) {self.ckksCfg}"

    @property
    def deviations(self):
        return self.params.deviations

    @property
    def corrections(self):
        return self.params.corrections

    @property
    def base_prime(self):
        return self.params.base_prime

    def _meta(self):
        return dict(logN=self.ckksCfg.logN, creator_hash=self.hash)

    def _shard(self, x):
        """Lay a [..., C, N] array onto the engine mesh (no-op without one).

        Axes whose mesh extent does not divide the array dimension are
        dropped from the placement spec (``device_put`` requires exact
        divisibility); GSPMD still re-shards activations freely inside the
        jitted ops, propagating from whichever operands ARE sharded.
        """
        if self.mesh is None or not hasattr(x, "ndim") or x.ndim < 2:
            return x
        from jax.sharding import NamedSharding, PartitionSpec

        mesh = self.mesh
        names = []
        for dim, axis in zip(x.shape[-2:], ("rns", "coef")):
            ok = axis in mesh.axis_names and dim % mesh.shape[axis] == 0
            names.append(axis if ok else None)
        spec = PartitionSpec(*((None,) * (x.ndim - 2) + tuple(names)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    def to_mesh(self, obj):
        """Move a ciphertext/triplet's buffers onto the engine mesh."""
        if self._data_sharding is None:
            return obj
        return type(obj)(
            data=tuple(self._shard(d) for d in obj.data),
            flags=obj._flags, level=obj.level, **obj.misc,
        )

    def _lp(self, lvl, special=False):
        return self.params.lp(lvl, special)

    @functools.cache
    def _fused_mult_step(self, level: int):
        from tiberate_tpu.parallel.sharded import make_mult_step

        return jax.jit(make_mult_step(self, level, pre_rescale=True))

    @functools.cache
    def _fused_mult_prm(self, level: int):
        from tiberate_tpu.parallel.sharded import mult_step_params

        return mult_step_params(self, level, pre_rescale=True)

    def _lp_for(self, ds):
        return self._lp(ds.level, ds.has_flag(FLAGS.INCLUDE_SPECIAL))

    @property
    def _rounding_half(self):
        # reference decrypt rounding prime: q list index [-S-2]
        # (``ckks_engine.py:679-683``)
        return self.params.q[-self.ckksCfg.num_special_primes - 2] // 2

    # ------------------------------------------------------------------
    # Key properties with invalidation cascade (reference
    # ``ckks_engine.py:289-388``).
    # ------------------------------------------------------------------

    @property
    def sk(self) -> SecretKey:
        if self.__sk is None:
            if not self.allow_sk_gen:
                raise RuntimeError("Secret key generation is disabled.")
            self.sk = self._create_secret_key()
            logger.debug("created a new secret key")
        return self.__sk

    @sk.setter
    def sk(self, sk: SecretKey):
        self.__pk = None
        self.__evk = None
        self.__gk = None
        self.__rotk = {}
        self.__conjk = None
        self.__sk = sk

    @property
    def pk(self) -> PublicKey:
        if self.__pk is None:
            self.__pk = self._create_public_key(self.sk)
        return self.__pk

    @pk.setter
    def pk(self, pk: PublicKey):
        self.__pk = pk

    @property
    def evk(self) -> EvaluationKey:
        if self.__evk is None:
            self.__evk = self._create_evk(self.sk)
            logger.debug("created a new evaluation key")
        return self.__evk

    @evk.setter
    def evk(self, evk: EvaluationKey):
        self.__evk = evk

    @property
    def gk(self) -> GaloisKey:
        if self.__gk is None:
            self.__gk = self._create_galois_key(self.sk)
        return self.__gk

    @gk.setter
    def gk(self, gk: GaloisKey):
        self.__gk = gk

    @property
    def rotk(self) -> "_RotkCache":
        """Rotation-key cache; ``engine.rotk[delta]`` generates on first
        access (the reference's CachedDict, ``ckks_engine.py:360-368``)."""
        return _RotkCache(self)

    @rotk.setter
    def rotk(self, rotk):
        self.__rotk = dict(rotk)

    @property
    def _rotk_store(self) -> dict:
        return self.__rotk

    def get_rotation_key(self, delta: int) -> RotationKey:
        """Rotation-key cache with on-demand generation (the reference's
        CachedDict rotk, ``ckks_engine.py:360-368``)."""
        if delta not in self.__rotk:
            if not self.allow_sk_gen:
                raise RuntimeError(
                    f"No rotation key for delta={delta} and key generation "
                    f"is disabled."
                )
            self.__rotk[delta] = self._create_rotation_key(delta, sk=self.sk)
            logger.debug("created rotation key for delta=%d", delta)
        return self.__rotk[delta]

    @property
    def conjk(self) -> ConjugationKey:
        if self.__conjk is None:
            self.__conjk = self.create_conjugation_key(self.sk)
        return self.__conjk

    # ------------------------------------------------------------------
    # Encode / decode (host codec + device upload).
    # ------------------------------------------------------------------

    def encode(self, m, level: int = 0, padding=True, scale=None):
        """Message -> signed integer coefficients [N] on device."""
        deviation = self.deviations[level]
        if padding:
            m = codec.padding(m, num_slots=self.num_slots)
        encoded = codec.encode(
            m,
            scale=scale or self.ckksCfg.scale,
            rng=self.rng,
            deviation=deviation,
            norm=self.norm,
        )
        return jnp.array(encoded)

    def decode(self, m, level=0, is_real: bool = False):
        """Signed coefficient array [N] (or [1, N]) -> message slots."""
        correction = self.corrections[level]
        m = np.asarray(m).reshape(-1)
        decoded = codec.decode(
            m, scale=self.ckksCfg.scale, correction=correction,
            norm=self.norm,
        )
        decoded = decoded[: self.num_slots]
        return decoded.real if is_real else decoded

    # ------------------------------------------------------------------
    # Key generation.
    # ------------------------------------------------------------------

    def _create_secret_key(self, include_special: bool = True) -> SecretKey:
        ternary = self.rng.randint(amax=3, shift=-1, repeats=1)[0]
        lp = self._lp(0, include_special)
        sk_data = self._shard(_keygen_sk_core(ternary, lp))
        return SecretKey(
            data=sk_data,
            flags=(FLAGS.INCLUDE_SPECIAL if include_special else FLAGS(0))
            | FLAGS.MONTGOMERY_STATE
            | FLAGS.NTT_STATE,
            level=0,
            **self._meta(),
        )

    def _create_public_key(
        self, sk: SecretKey = None, *, include_special: bool = False, a=None
    ) -> PublicKey:
        """pk = (e - a*s, a), optionally under a common random ``a`` (MPC)."""
        sk = sk or self.sk
        if include_special and not sk.has_flag(FLAGS.INCLUDE_SPECIAL):
            raise errors.SecretKeyNotIncludeSpecialPrime()

        lp = self._lp(0, include_special)
        C = lp.num_channels
        e = self.rng.discrete_gaussian(repeats=1)[0]

        repeats = (
            self.ckksCfg.num_special_primes
            if sk.has_flag(FLAGS.INCLUDE_SPECIAL)
            else 0
        )
        if a is None:
            if include_special:
                amax = self.params.q
            else:
                amax = self.params.q[: self.params.P]
            a = self.rng.randint(amax=amax, repeats=repeats)
        a = jnp.asarray(a).astype(self.params.dtype)
        sk_data = sk.data[:C]
        pk0 = _keygen_pk_core(e, a, sk_data, lp)

        return PublicKey(
            data=(self._shard(pk0), self._shard(a)),
            flags=(FLAGS.INCLUDE_SPECIAL if include_special else FLAGS(0))
            | FLAGS.MONTGOMERY_STATE
            | FLAGS.NTT_STATE,
            level=0,
            **self._meta(),
        )

    def create_key_switching_key(
        self, sk_from: SecretKey, sk_to: SecretKey, a=None, a_seed=None
    ) -> KeySwitchKey:
        """Per-partition P-scaled source-key shards folded into fresh
        public keys under sk_to (reference ``ckks_engine.py:777-841``).

        ``a_seed``: draw the uniform ``a`` components from a dedicated
        CSPRNG keyed by this seed — the key is then *seed-expandable*:
        :meth:`compress_ksk` drops the ``a`` halves (half the key bytes)
        and :meth:`expand_ksk` regenerates them from the stored seed, a
        capability the reference lacks (its keys always ship both
        halves, ``ckks_engine.py:777-841``)."""
        for k in (sk_from, sk_to):
            if not k.has_flag(FLAGS.NTT_STATE):
                raise errors.NTTStateError(expected=True)
            if not k.has_flag(FLAGS.MONTGOMERY_STATE):
                raise errors.MontgomeryStateError(expected=True)
        if a_seed is not None:
            assert a is None, "pass either a or a_seed"
            a = self._expand_ksk_a(a_seed)

        P = self.params.P
        lp_ord = self._lp(0, False)
        Psk = mont.mont_mult(
            sk_from.data[:P], self.params.mont_PR, lp_ord.pack
        )

        ksk_parts = []
        for part_id, part in enumerate(self.params.parts[0]):
            crs = a[part_id] if a is not None else None
            pk = self._create_public_key(sk_to, include_special=True, a=crs)
            pk0, pk1 = pk.data
            part_pack = self.params.pack[part.g0 : part.g0 + part.alpha]
            pk0 = _ksk_shard_core(
                pk0, Psk[part.lo : part.hi], part.g0, part.alpha, part_pack
            )
            ksk_parts.append((self._shard(pk0), self._shard(pk1)))

        return KeySwitchKey(
            data=tuple(ksk_parts),
            flags=FLAGS.INCLUDE_SPECIAL
            | FLAGS.MONTGOMERY_STATE
            | FLAGS.NTT_STATE,
            level=0,
            a_seed=a_seed,
            **self._meta(),
        )

    def _seed_rng(self, a_seed: int):
        return Csprng(
            num_coefs=self.ckksCfg.N,
            num_channels=[self.params.P],
            num_repeating_channels=max(self.ckksCfg.num_special_primes, 2),
            sigma=self.ckksCfg.sigma,
            seed=a_seed,
            nonce=0x5EED,
        )

    def _expand_ksk_a(self, a_seed: int):
        """Deterministic per-part uniform ``a`` polynomials from a seed
        (a fresh counter-mode CSPRNG with the engine's channel model)."""
        rng = self._seed_rng(a_seed)
        return [
            rng.randint(amax=self.params.q,
                        repeats=self.ckksCfg.num_special_primes)
            for _ in self.params.parts[0]
        ]

    def create_public_key(self, sk: SecretKey = None, *,
                          include_special: bool = False, a_seed=None
                          ) -> PublicKey:
        """Public keygen with optional seed-expandable ``a``
        (see :meth:`create_key_switching_key`); ``compress_pk`` /
        ``expand_pk`` halve the stored bytes."""
        a = None
        if a_seed is not None:
            rng = self._seed_rng(a_seed)
            amax = (self.params.q if include_special
                    else self.params.q[: self.params.P])
            reps = (self.ckksCfg.num_special_primes if include_special
                    else 0)
            a = rng.randint(amax=amax, repeats=reps)
        pk = self._create_public_key(sk, include_special=include_special,
                                     a=a)
        pk.misc["a_seed"] = a_seed
        pk.misc["include_special"] = bool(include_special)
        return pk

    def compress_pk(self, pk: PublicKey) -> PublicKey:
        """Drop the regenerable ``a`` half of a seed-expanded public
        key."""
        if pk.misc.get("a_seed") is None:
            raise ValueError(
                "only keys created with a_seed= are compressible"
            )
        return PublicKey(
            data=(pk.data[0],), flags=pk._flags, level=pk.level,
            **dict(pk.misc, compressed=True),
        )

    def expand_pk(self, cpk: PublicKey) -> PublicKey:
        if not cpk.misc.get("compressed"):
            return cpk
        rng = self._seed_rng(cpk.misc["a_seed"])
        special = bool(cpk.misc.get("include_special"))
        amax = (self.params.q if special
                else self.params.q[: self.params.P])
        reps = self.ckksCfg.num_special_primes if special else 0
        a = jnp.asarray(
            rng.randint(amax=amax, repeats=reps)
        ).astype(self.params.dtype)
        pk0 = cpk.data[0] if isinstance(cpk.data, tuple) else cpk.data
        misc = dict(cpk.misc)
        misc.pop("compressed", None)
        return PublicKey(
            data=(pk0, self._shard(a)), flags=cpk._flags, level=cpk.level,
            **misc,
        )

    def compress_ksk(self, ksk: KeySwitchKey) -> KeySwitchKey:
        """Drop the regenerable ``a`` halves of a seed-expanded key
        (created with ``a_seed=``): the result carries half the bytes and
        round-trips save/load; :meth:`expand_ksk` restores it."""
        if ksk.misc.get("a_seed") is None:
            raise ValueError(
                "only keys created with a_seed= are compressible"
            )
        return KeySwitchKey(
            data=tuple(k0 for k0, _ in ksk.data),
            flags=ksk._flags,
            level=ksk.level,
            **dict(ksk.misc, compressed=True),
        )

    def expand_ksk(self, cksk: KeySwitchKey) -> KeySwitchKey:
        """Regenerate a compressed key's ``a`` halves from its seed."""
        if not cksk.misc.get("compressed"):
            return cksk
        a_list = self._expand_ksk_a(cksk.misc["a_seed"])
        data = tuple(
            (k0, self._shard(jnp.asarray(a).astype(self.params.dtype)))
            for k0, a in zip(cksk.data, a_list)
        )
        misc = dict(cksk.misc)
        misc.pop("compressed", None)
        return KeySwitchKey(
            data=data, flags=cksk._flags, level=cksk.level, **misc
        )

    def _create_evk(self, sk: SecretKey = None) -> EvaluationKey:
        sk = sk or self.sk
        lp = self._lp(0, True)
        sk2_data = mont.mont_mult(sk.data, sk.data, lp.pack)
        sk2 = SecretKey(
            data=sk2_data,
            flags=FLAGS.MONTGOMERY_STATE | FLAGS.NTT_STATE
            | FLAGS.INCLUDE_SPECIAL,
            level=0,
            **self._meta(),
        )
        return EvaluationKey.wrap(self.create_key_switching_key(sk2, sk))

    # ------------------------------------------------------------------
    # Encrypt / decrypt.
    # ------------------------------------------------------------------

    def encrypt(self, pt, pk: PublicKey = None, *, level: int = 0
                ) -> Ciphertext:
        """Encrypt encoded coefficients pt ([N] int64 array)."""
        pk = pk or self.pk
        include_special = pk.has_flag(FLAGS.INCLUDE_SPECIAL)
        lp = self._lp(level, include_special)
        C = lp.num_channels

        e0e1 = self.rng.discrete_gaussian(repeats=2)
        v = self.rng.randint(amax=2, shift=0, repeats=1)[0]

        pk0, pk1 = (d[level : level + C] for d in pk.data)
        dc_rns = jnp.zeros((C,), dtype=self.params.dtype)

        ct0, ct1 = _encrypt_core_jit(
            jnp.asarray(pt), dc_rns, e0e1[0], e0e1[1], v, pk0, pk1, lp
        )
        ct0, ct1 = self._shard(ct0), self._shard(ct1)
        return Ciphertext(
            data=(ct0, ct1),
            flags=(FLAGS.INCLUDE_SPECIAL if include_special else FLAGS(0)),
            level=level,
            **self._meta(),
        )

    def decrypt_triplet(self, ct_mult: CiphertextTriplet,
                        sk: SecretKey = None, *, final_round=True):
        sk = sk or self.sk
        if not ct_mult.has_flag(FLAGS.NTT_STATE):
            raise errors.NTTStateError(expected=True)
        if not ct_mult.has_flag(FLAGS.MONTGOMERY_STATE):
            raise errors.MontgomeryStateError(expected=True)
        if not sk.has_flag(FLAGS.NTT_STATE):
            raise errors.NTTStateError(expected=True)

        level = ct_mult.level
        lp = self._lp(level, False)
        C = lp.num_channels
        sk_data = sk.data[level : level + C]
        d0, d1, d2 = ct_mult.data
        scaled, _ = _decrypt_triplet_core(
            d0, d1, d2, sk_data, lp, self.params.base_lp(),
            self.params.final_scalar[level], self._rounding_half,
            base_at=C - 1, final_round=final_round,
        )
        return scaled

    def decrypt_double(self, ct: Ciphertext, sk: SecretKey = None, *,
                       final_round=True):
        sk = sk or self.sk
        if ct.has_flag(FLAGS.NTT_STATE):
            raise errors.NTTStateError(expected=False)
        if ct.has_flag(FLAGS.MONTGOMERY_STATE):
            raise errors.MontgomeryStateError(expected=False)
        if not sk.has_flag(FLAGS.NTT_STATE):
            raise errors.NTTStateError(expected=True)

        level = ct.level
        lp = self._lp(level, False)
        C = lp.num_channels
        sk_data = sk.data[level : level + C]
        # Ordinary rows come first in the [C(+S), N] layout; slicing to C
        # rows puts the base prime at row C-1 whether or not the ciphertext
        # carries special channels (the reference's -S-1 indexing on
        # unsliced tensors, ``ckks_engine.py:714-721``).
        base_at = C - 1
        scaled, _ = _decrypt_double_core(
            ct.data[0][:C], ct.data[1][:C], sk_data, lp,
            self.params.base_lp(), self.params.final_scalar[level],
            self._rounding_half, base_at=base_at, final_round=final_round,
        )
        return scaled

    def decrypt(self, ct, sk: SecretKey = None, *, final_round=True):
        sk = sk or self.sk
        if isinstance(ct, CiphertextTriplet):
            return self.decrypt_triplet(ct, sk, final_round=final_round)
        return self.decrypt_double(ct, sk, final_round=final_round)

    # ------------------------------------------------------------------
    # Fused encodecrypt / decryptcode (reference ``ckks_engine.py:1791-
    # 2035``) with bias_guard DC handling.
    # ------------------------------------------------------------------

    def encodecrypt(self, m, pk: PublicKey = None, *, level: int = 0,
                    padding=True) -> Ciphertext:
        pk = pk or self.pk
        if padding:
            m = codec.padding(m, num_slots=self.num_slots)
        deviation = self.deviations[level]

        include_special = pk.has_flag(FLAGS.INCLUDE_SPECIAL)
        lp = self._lp(level, include_special)
        C = lp.num_channels
        dc_rns = np.zeros(C, dtype=self.params.dtype)

        if self.bias_guard:
            pt = codec.encode(
                m, scale=self.ckksCfg.scale, norm=self.norm,
                deviation=deviation, rng=self.rng,
                return_without_scaling=True,
            )
            dc_integral = float(pt[0]) // 1
            pt = pt.copy()
            pt[0] -= dc_integral
            dc_scale = int(dc_integral) * int(self.ckksCfg.scale)
            dest = range(level, level + C)
            dc_rns = np.array(
                [dc_scale % self.params.q[i] for i in dest],
                dtype=self.params.dtype,
            )
            pt = self.rng.randround(pt * np.float64(self.ckksCfg.scale))
        else:
            pt = codec.encode(
                m, scale=self.ckksCfg.scale, norm=self.norm,
                deviation=deviation, rng=self.rng,
            )

        e0e1 = self.rng.discrete_gaussian(repeats=2)
        v = self.rng.randint(amax=2, shift=0, repeats=1)[0]
        pk0, pk1 = (d[level : level + C] for d in pk.data)

        ct0, ct1 = _encrypt_core_jit(
            jnp.asarray(pt), jnp.asarray(dc_rns), e0e1[0], e0e1[1], v,
            pk0, pk1, lp,
        )
        ct0, ct1 = self._shard(ct0), self._shard(ct1)
        return Ciphertext(
            data=(ct0, ct1),
            flags=(FLAGS.INCLUDE_SPECIAL if include_special else FLAGS(0)),
            level=level,
            **self._meta(),
        )

    def encodecrypt_batch(self, ms, pk: PublicKey = None, *,
                          level: int = 0, padding=True) -> list:
        """Encrypt a batch of messages with ONE vectorized encode — a
        single host FFT call + a single device stochastic-rounding
        dispatch for the whole batch (``codec.encode_batch``), instead
        of per-message host work in the serving hot loop (the
        reference encodes on-device, ``encoding.py:202-216``).
        Ciphertexts are bit-identical to sequential :meth:`encodecrypt`
        calls when bias_guard is off (the batched rounding reproduces
        the sequential counter trajectory exactly); with bias_guard the
        per-message DC split is vectorized the same way."""
        pk = pk or self.pk
        if padding:
            ms = [codec.padding(m, num_slots=self.num_slots) for m in ms]
        ms = np.stack([np.asarray(m) for m in ms])
        deviation = self.deviations[level]
        include_special = pk.has_flag(FLAGS.INCLUDE_SPECIAL)
        lp = self._lp(level, include_special)
        C = lp.num_channels
        B = ms.shape[0]
        scale = self.ckksCfg.scale
        dc_rns = np.zeros((B, C), dtype=self.params.dtype)

        if self.bias_guard:
            pts = codec.encode_batch(
                ms, scale=scale, norm=self.norm, deviation=deviation,
                rng=self.rng, return_without_scaling=True,
            )
            dc_integral = np.floor(pts[:, 0])
            pts = pts.copy()
            pts[:, 0] -= dc_integral
            dest = range(level, level + C)
            dc_rns = np.array(
                [[int(d) * int(scale) % self.params.q[i] for i in dest]
                 for d in dc_integral],
                dtype=self.params.dtype,
            )
            pts = self.rng.randround_batch(pts * np.float64(scale))
        else:
            pts = codec.encode_batch(
                ms, scale=scale, norm=self.norm, deviation=deviation,
                rng=self.rng,
            )

        pk0, pk1 = (d[level : level + C] for d in pk.data)
        # ONE batched noise draw (sequential counter trajectory, see
        # Csprng.encrypt_noise_batch) + ONE vmapped encrypt dispatch:
        # the per-message loop was ~20 eager device calls per message
        e_all, v_all = self.rng.encrypt_noise_batch(B)
        ct0s, ct1s = _encrypt_batch_core(
            jnp.asarray(pts), jnp.asarray(dc_rns),
            e_all[:, 0], e_all[:, 1], v_all, pk0, pk1, lp,
        )
        cts = []
        for b in range(B):
            cts.append(Ciphertext(
                data=(self._shard(ct0s[b]), self._shard(ct1s[b])),
                flags=(FLAGS.INCLUDE_SPECIAL if include_special
                       else FLAGS(0)),
                level=level,
                **self._meta(),
            ))
        return cts

    def decryptcode(self, ct, sk: SecretKey = None, *, is_real=False,
                    final_round=True):
        sk = sk or self.sk
        if not sk.has_flag(FLAGS.NTT_STATE):
            raise errors.NTTStateError(expected=True)
        if not sk.has_flag(FLAGS.MONTGOMERY_STATE):
            raise errors.MontgomeryStateError(expected=True)

        level = ct.level
        lp = self._lp(level, False)
        C = lp.num_channels
        sk_data = sk.data[level : level + C]
        len_left = C
        use_bias_guard = (len_left >= 3) and self.bias_guard

        if not isinstance(ct, CiphertextTriplet):
            sk_data = sk.data[level : level + C]

        if isinstance(ct, CiphertextTriplet):
            if not ct.has_flag(FLAGS.NTT_STATE):
                raise errors.NTTStateError(expected=True)
            if not ct.has_flag(FLAGS.MONTGOMERY_STATE):
                raise errors.MontgomeryStateError(expected=True)
            base_at = C - 1
            d0, d1, d2 = ct.data
            core = functools.partial(
                _decrypt_triplet_core, d0, d1, d2,
            )
        else:
            if ct.has_flag(FLAGS.NTT_STATE):
                raise errors.NTTStateError(expected=False)
            if ct.has_flag(FLAGS.MONTGOMERY_STATE):
                raise errors.MontgomeryStateError(expected=False)
            # Base prime is always row C-1 after slicing to ordinary rows.
            base_at = C - 1
            core = functools.partial(
                _decrypt_double_core, ct.data[0][:C], ct.data[1][:C],
            )

        if use_bias_guard:
            # Pull the three DC residues, zero them, and CRT-reconstruct
            # the DC value exactly (reference ``ckks_engine.py:1969-1999``).
            _, pt = core(
                sk_data, lp, self.params.base_lp(),
                self.params.final_scalar[level], self._rounding_half,
                base_at=base_at, final_round=False,
            )
            # pull only the three DC residues (see decryptcode_batch)
            pt_h = np.asarray(pt[(base_at, 0, 1), 0])
            dc0 = int(pt_h[0])
            dc1 = int(pt_h[1])
            dc2 = int(pt_h[2])

            q = self.params.q
            q0 = q[level + base_at]
            q1 = q[level]
            q2 = q[level + 1]
            Q = q0 * q1 * q2
            Q0, Q1, Q2 = q1 * q2, q0 * q2, q0 * q1
            dc = (
                dc0 * pow(Q0, -1, q0) * Q0
                + dc1 * pow(Q1, -1, q1) * Q1
                + dc2 * pow(Q2, -1, q2) * Q2
            ) % Q
            dc = dc if dc <= Q // 2 else dc - Q
            dc = (dc + (q1 - 1)) // q1

            # Redo the final scaling with zeroed DC slots.
            pt_z = pt.at[base_at, 0].set(0).at[0, 0].set(0)
            scaled = _final_scale_host(
                pt_z, self.params.base_lp(),
                self.params.final_scalar[level], self._rounding_half,
                base_at, final_round,
            )
        else:
            dc = 0
            scaled, _ = core(
                sk_data, lp, self.params.base_lp(),
                self.params.final_scalar[level], self._rounding_half,
                base_at=base_at, final_round=final_round,
            )

        correction = self.corrections[level]
        decoded = codec.decode(
            np.asarray(scaled).reshape(-1),
            scale=self.ckksCfg.scale, correction=correction,
            norm=self.norm, return_without_scaling=True,
        )
        decoded = decoded[: self.num_slots]
        decoded = decoded / self.ckksCfg.scale * correction
        if use_bias_guard:
            decoded = decoded + dc / self.ckksCfg.scale * correction
        return decoded.real if is_real else decoded

    def decryptcode_batch(self, cts, sk: SecretKey = None, *,
                          is_real=False, final_round=True):
        """Decrypt + decode a batch of (double) ciphertexts with ONE
        compiled vmapped decrypt core and ONE vectorized host decode
        (``codec.decode_batch``) — the decode-side counterpart of
        :meth:`encodecrypt_batch` (reference decodes per message on
        GPU, ``encoding.py:341-362``; a host-FFT-per-message loop
        serializes the batched-inference pipeline).  All ciphertexts
        must share a level; per-message results match
        :meth:`decryptcode` up to decode-float summation order."""
        sk = sk or self.sk
        if not sk.has_flag(FLAGS.NTT_STATE):
            raise errors.NTTStateError(expected=True)
        if not sk.has_flag(FLAGS.MONTGOMERY_STATE):
            raise errors.MontgomeryStateError(expected=True)
        level = cts[0].level
        if any(ct.level != level for ct in cts):
            raise errors.NotMatchType(
                origin="mixed ciphertext levels", to="decryptcode_batch"
            )
        for ct in cts:
            if ct.has_flag(FLAGS.NTT_STATE):
                raise errors.NTTStateError(expected=False)
        lp = self._lp(level, False)
        C = lp.num_channels
        sk_rows = sk.data[level : level + C]
        base_at = C - 1
        use_bias_guard = (C >= 3) and self.bias_guard
        ct0 = jnp.stack([ct.data[0][:C] for ct in cts])
        ct1 = jnp.stack([ct.data[1][:C] for ct in cts])
        B = ct0.shape[0]

        if use_bias_guard:
            # batched 3-prime CRT DC reconstruction (reference
            # ``ckks_engine.py:1969-1999``): the per-message host part
            # is three integers each
            _, pts = _decrypt_double_batch_core(
                ct0, ct1, sk_rows, lp, self.params.base_lp(),
                self.params.final_scalar[level], self._rounding_half,
                base_at=base_at, final_round=False,
            )
            # pull ONLY the three DC residues per message, not the whole
            # [B, C, N] pts: 3 integers of information each
            pts_h = np.asarray(pts[:, (base_at, 0, 1), 0])
            q = self.params.q
            q0 = q[level + base_at]
            q1 = q[level]
            q2 = q[level + 1]
            Q = q0 * q1 * q2
            m0 = pow(q1 * q2, -1, q0) * q1 * q2
            m1 = pow(q0 * q2, -1, q1) * q0 * q2
            m2 = pow(q0 * q1, -1, q2) * q0 * q1
            dcs = []
            for b in range(B):
                dc = (
                    int(pts_h[b, 0]) * m0
                    + int(pts_h[b, 1]) * m1
                    + int(pts_h[b, 2]) * m2
                ) % Q
                dc = dc if dc <= Q // 2 else dc - Q
                dcs.append((dc + (q1 - 1)) // q1)
            pt_z = pts.at[:, base_at, 0].set(0).at[:, 0, 0].set(0)
            scaled = _final_scale_batch(
                pt_z, self.params.base_lp(),
                self.params.final_scalar[level], self._rounding_half,
                base_at, final_round,
            )
        else:
            dcs = [0] * B
            scaled, _ = _decrypt_double_batch_core(
                ct0, ct1, sk_rows, lp, self.params.base_lp(),
                self.params.final_scalar[level], self._rounding_half,
                base_at=base_at, final_round=final_round,
            )

        correction = self.corrections[level]
        decoded = codec.decode_batch(
            np.asarray(scaled).reshape(B, -1),
            scale=self.ckksCfg.scale, correction=correction,
            norm=self.norm,
        )[:, : self.num_slots]
        if use_bias_guard:
            decoded = decoded + (
                np.asarray(dcs, dtype=np.float64)[:, None]
                / self.ckksCfg.scale * correction
            )
        return decoded.real if is_real else decoded

    # ------------------------------------------------------------------
    # Key switching / multiplication.
    # ------------------------------------------------------------------

    def _ksk_args(self, ksk: KeySwitchKey, level: int):
        parts = tuple(self.params.parts[level])
        alloc = self.params.parts_alloc[level]
        ksk_parts = tuple(ksk.data[g] for g in alloc)
        return ksk_parts, parts

    def create_switcher(self, a, ksk: KeySwitchKey, level: int,
                        exit_ntt: bool = False):
        ksk_parts, parts = self._ksk_args(ksk, level)
        return _switcher_core(
            a, ksk_parts, parts,
            self._lp(level, True), self._lp(level, False),
            tuple(self.params.PiRs[level]),
            level, self.ckksCfg.num_special_primes, exit_ntt,
        )

    def switch_key(self, ct: Ciphertext, ksk: KeySwitchKey) -> Ciphertext:
        level = ct.level
        ksk_parts, parts = self._ksk_args(ksk, level)
        new0, new1 = _switch_key_core(
            ct.data[0], ct.data[1], ksk_parts, parts,
            self._lp(level, True), self._lp(level, False),
            tuple(self.params.PiRs[level]),
            level, self.ckksCfg.num_special_primes,
            ct.has_flag(FLAGS.NTT_STATE),
        )
        return Ciphertext(
            data=(new0, new1), flags=ct._flags, level=level, **self._meta()
        )

    def rescale(self, ct: Ciphertext, exact_rounding=True) -> Ciphertext:
        level = ct.level
        next_level = level + 1
        if next_level >= self.num_levels:
            raise errors.MaximumLevelError(
                level=level, level_max=self.num_levels
            )
        lp_next = self._lp(next_level, False)
        round_at = self.params.q[level] // 2
        d0 = _rescale_core(
            ct.data[0], self.params.rescale_scales[level], lp_next,
            round_at, exact_rounding,
        )
        d1 = _rescale_core(
            ct.data[1], self.params.rescale_scales[level], lp_next,
            round_at, exact_rounding,
        )
        return Ciphertext(
            data=(d0, d1), level=next_level, **self._meta()
        )

    def cc_mult(self, a: Ciphertext, b: Ciphertext,
                evk: EvaluationKey = None, *, pre_rescale=True,
                post_relin=True):
        a, b = self.align_level(a, b)

        # Fast path: the whole rescale -> tensor -> relinearize/keyswitch
        # pipeline as ONE compiled program per level (~1.8x over chained
        # per-op dispatches; measured 40.6 -> 23 ms at logN15).
        # (cached prm embeds evk-derived in-part diagonal keys, so the
        # cached fast path only serves the engine's own evk)
        if pre_rescale and post_relin and (evk is None or evk is self.evk):
            if a.level + 1 >= self.num_levels:
                raise errors.MaximumLevelError(
                    level=a.level, level_max=self.num_levels
                )
            step = self._fused_mult_step(a.level)
            ksk = (evk or self.evk).data
            ct0, ct1 = step(a.data[0], a.data[1], b.data[0], b.data[1],
                            tuple(ksk), self._fused_mult_prm(a.level))
            return Ciphertext(
                data=(ct0, ct1), level=a.level + 1, **self._meta()
            )

        if pre_rescale:
            x = self.rescale(a)
            y = self.rescale(b)
        else:
            x, y = a, b
        level = x.level
        lp = self._lp(level, False)
        d0, d1, d2 = _ccmult_tensor_core(
            x.data[0], x.data[1], y.data[0], y.data[1], lp
        )
        ct_mult = CiphertextTriplet(
            data=(d0, d1, d2),
            flags=FLAGS.NTT_STATE | FLAGS.MONTGOMERY_STATE
            | FLAGS.NEED_RELINERIZE,
            level=level,
            **self._meta(),
        )
        if post_relin:
            ct_mult = self.relinearize(ct_mult, evk or self.evk)
        return ct_mult

    def square(self, ct: Ciphertext, evk: EvaluationKey = None, *,
               pre_rescale=True, post_relin=True):
        """ct^2 (referenced but left undefined in the reference, used by
        ``var``; ``ckks_engine.py:2472``)."""
        return self.cc_mult(ct, ct, evk, pre_rescale=pre_rescale,
                            post_relin=post_relin)

    def relinearize(self, ct_triplet: CiphertextTriplet,
                    evk: EvaluationKey = None) -> Ciphertext:
        evk = evk or self.evk
        if not ct_triplet.has_flag(FLAGS.NTT_STATE):
            raise errors.NTTStateError(expected=True)
        if not ct_triplet.has_flag(FLAGS.MONTGOMERY_STATE):
            raise errors.MontgomeryStateError(expected=True)
        level = ct_triplet.level
        ksk_parts, parts = self._ksk_args(evk, level)
        ct0, ct1 = _relin_core(
            *ct_triplet.data, ksk_parts, parts,
            self._lp(level, True), self._lp(level, False),
            tuple(self.params.PiRs[level]),
            level, self.ckksCfg.num_special_primes,
        )
        return Ciphertext(data=(ct0, ct1), level=level, **self._meta())

    # ------------------------------------------------------------------
    # Rotations / conjugation.
    # ------------------------------------------------------------------

    def _create_rotation_key(self, delta: int, a=None, sk: SecretKey = None
                             ) -> RotationKey:
        sk = sk or self.sk
        P = self.params.P
        lp = self._lp(0, False)
        sk_ord = _intt_exit_to_mont(sk.data[:P], lp)
        src, sign = codec.rotation_perm_tables(
            self.params.N, codec.rotate_leap(delta, self.params.N)
        )
        rotated = _perm_ntt_core(sk_ord, jnp.asarray(src), jnp.asarray(sign),
                                 lp)
        # Only ordinary rows are consumed by ksk creation; pad specials
        # with the (unused) original rows to keep shapes.
        full = sk.data.at[:P].set(rotated)
        sk_rot = SecretKey(
            data=full,
            flags=FLAGS.MONTGOMERY_STATE | FLAGS.NTT_STATE
            | FLAGS.INCLUDE_SPECIAL,
            level=0,
            **self._meta(),
        )
        return RotationKey.wrap(
            self.create_key_switching_key(sk_rot, sk, a=a), delta=delta
        )

    def rotate_single(self, ct: Ciphertext, rotk: RotationKey,
                      post_key_switching=True) -> Ciphertext:
        level = ct.level
        lp = self._lp_for(ct)
        src, sign = codec.rotation_perm_tables(
            self.params.N, codec.rotate_leap(rotk.delta, self.params.N)
        )
        src = jnp.asarray(src)
        sign = jnp.asarray(sign)
        rot_data = tuple(
            _rotate_data_core(d, src, sign, lp) for d in ct.data
        )
        rotated = Ciphertext(
            data=rot_data, flags=ct._flags, level=level, **self._meta()
        )
        if post_key_switching:
            rotated = self.switch_key(rotated, rotk)
        return rotated

    def rotate_offset(self, ct: Ciphertext, offset: int,
                      return_decomposed_offsets=False) -> Ciphertext:
        if offset == 0:
            return ct
        if offset in self.rotk:
            return self.rotate_single(ct, self.get_rotation_key(offset))
        offsets = decompose_rot_offsets(offset, self.num_slots,
                                        rotks=self.rotk)
        for delta in offsets:
            ct = self.rotate_single(ct, self.get_rotation_key(delta))
        if return_decomposed_offsets:
            return ct, offsets
        return ct

    def rotate_galois(self, ct: Ciphertext, gk: GaloisKey = None, *,
                      delta: int, return_circuit=False):
        """Deprecated; redirected to rotate_offset like the reference
        (``ckks_engine.py:1486-1502``)."""
        return self.rotate_offset(
            ct, delta, return_decomposed_offsets=return_circuit
        )

    def _create_galois_key(self, sk: SecretKey = None) -> GaloisKey:
        sk = sk or self.sk
        deltas = [2**i for i in range(self.ckksCfg.logN - 1)]
        parts = [self._create_rotation_key(d, sk=sk) for d in deltas]
        return GaloisKey(
            data=parts,
            flags=FLAGS.MONTGOMERY_STATE | FLAGS.NTT_STATE
            | FLAGS.INCLUDE_SPECIAL,
            level=0,
            **self._meta(),
        )

    def create_conjugation_key(self, sk: SecretKey = None
                               ) -> ConjugationKey:
        sk = sk or self.sk
        if not sk.has_flag(FLAGS.NTT_STATE):
            raise errors.NTTStateError(expected=True)
        P = self.params.P
        lp = self._lp(0, False)
        sk_ord = _intt_exit_to_mont(sk.data[:P], lp)
        src, sign = codec.rotation_perm_tables(
            self.params.N, codec.conjugate_leap(self.params.N)
        )
        conj = _perm_ntt_core(sk_ord, jnp.asarray(src), jnp.asarray(sign), lp)
        full = sk.data.at[:P].set(conj)
        sk_conj = SecretKey(
            data=full,
            flags=FLAGS.MONTGOMERY_STATE | FLAGS.NTT_STATE
            | FLAGS.INCLUDE_SPECIAL,
            level=0,
            **self._meta(),
        )
        return ConjugationKey.wrap(
            self.create_key_switching_key(sk_conj, sk)
        )

    def conjugate(self, ct: Ciphertext, conjk: ConjugationKey = None
                  ) -> Ciphertext:
        conjk = conjk or self.conjk
        level = ct.level
        lp = self._lp_for(ct)
        src, sign = codec.rotation_perm_tables(
            self.params.N, codec.conjugate_leap(self.params.N)
        )
        src = jnp.asarray(src)
        sign = jnp.asarray(sign)
        conj_data = tuple(
            _rotate_data_core(d, src, sign, lp) for d in ct.data
        )
        conj_ct = Ciphertext(
            data=conj_data, flags=ct._flags, level=level, **self._meta()
        )
        return self.switch_key(conj_ct, conjk)

    def negate(self, ct: Ciphertext) -> Ciphertext:
        lp = self._lp_for(ct)
        data = tuple(_negate_core(d, lp) for d in ct.data)
        return Ciphertext(
            data=data, flags=ct._flags, level=ct.level, **self._meta()
        )

    # ------------------------------------------------------------------
    # Add / sub.
    # ------------------------------------------------------------------

    def cc_add_double(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        if a.has_flag(FLAGS.NTT_STATE) or b.has_flag(FLAGS.NTT_STATE):
            raise errors.NTTStateError(expected=False)
        a, b = self.align_level(a, b)
        level = a.level
        lp = self._lp(level, False)
        c0 = _cc_add_core(a.data[0], b.data[0], lp)
        c1 = _cc_add_core(a.data[1], b.data[1], lp)
        return Ciphertext(data=(c0, c1), level=level, **self._meta())

    def cc_add_triplet(self, a: CiphertextTriplet, b: CiphertextTriplet
                       ) -> CiphertextTriplet:
        if not (a.has_flag(FLAGS.NTT_STATE) and b.has_flag(FLAGS.NTT_STATE)):
            raise errors.NTTStateError(expected=True)
        level = a.level
        lp = self._lp(level, False)
        data = tuple(
            _cc_add_core(x, y, lp) for x, y in zip(a.data, b.data)
        )
        return CiphertextTriplet(
            data=data,
            flags=FLAGS.MONTGOMERY_STATE | FLAGS.NTT_STATE
            | FLAGS.NEED_RELINERIZE,
            level=level,
            **self._meta(),
        )

    def cc_add(self, a, b):
        if isinstance(a, Ciphertext) and isinstance(b, Ciphertext):
            return self.cc_add_double(a, b)
        if isinstance(a, CiphertextTriplet) and isinstance(
            b, CiphertextTriplet
        ):
            return self.cc_add_triplet(a, b)
        raise errors.DifferentTypeError(a=type(a), b=type(b))

    def cc_sub_double(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        if a.has_flag(FLAGS.NTT_STATE) or b.has_flag(FLAGS.NTT_STATE):
            raise errors.NTTStateError(expected=False)
        a, b = self.align_level(a, b)
        level = a.level
        lp = self._lp(level, False)
        c0 = _cc_sub_core(a.data[0], b.data[0], lp)
        c1 = _cc_sub_core(a.data[1], b.data[1], lp)
        return Ciphertext(data=(c0, c1), level=level, **self._meta())

    def cc_sub_triplet(self, a: CiphertextTriplet, b: CiphertextTriplet
                       ) -> CiphertextTriplet:
        if not (a.has_flag(FLAGS.NTT_STATE) and b.has_flag(FLAGS.NTT_STATE)):
            raise errors.NTTStateError(expected=True)
        level = a.level
        lp = self._lp(level, False)
        data = tuple(
            _cc_sub_core(x, y, lp) for x, y in zip(a.data, b.data)
        )
        return CiphertextTriplet(
            data=data,
            flags=FLAGS.MONTGOMERY_STATE | FLAGS.NTT_STATE
            | FLAGS.NEED_RELINERIZE,
            level=level,
            **self._meta(),
        )

    def cc_sub(self, a, b):
        if isinstance(a, Ciphertext) and isinstance(b, Ciphertext):
            return self.cc_sub_double(a, b)
        if isinstance(a, CiphertextTriplet) and isinstance(
            b, CiphertextTriplet
        ):
            return self.cc_sub_triplet(a, b)
        raise errors.DifferentTypeError(a=type(a), b=type(b))

    # ------------------------------------------------------------------
    # Level up.
    # ------------------------------------------------------------------

    def level_up(self, ct: Ciphertext, dst_level: int) -> Ciphertext:
        if ct.level == dst_level:
            return ct
        new_ct = self.rescale(ct)
        src_level = ct.level + 1

        diff_deviation = self.deviations[dst_level] / np.sqrt(
            self.deviations[src_level]
        )
        deviated_delta = round(self.ckksCfg.scale * diff_deviation)

        drop = dst_level - src_level
        d0 = new_ct.data[0][drop:] if drop > 0 else new_ct.data[0]
        d1 = new_ct.data[1][drop:] if drop > 0 else new_ct.data[1]

        q = self.params.q
        R = self.montCtx.R
        dest = range(dst_level, self.params.P)
        multiplier = jnp.array(
            np.array(
                [(deviated_delta * R) % q[i] for i in dest],
                dtype=self.params.dtype,
            ).reshape(-1, 1)
        )
        lp = self._lp(dst_level, False)
        d0 = _mont_scalar_core(d0, multiplier, lp)
        d1 = _mont_scalar_core(d1, multiplier, lp)
        return Ciphertext(data=(d0, d1), level=dst_level, **self._meta())

    # ------------------------------------------------------------------
    # Plaintext / scalar ops.
    # ------------------------------------------------------------------

    def _pt_cached(self, pt: Plaintext, level: int, op: str):
        if op not in pt.cache[level]:
            m = pt.src * math.sqrt(self.deviations[level + 1])
            encoded = self.encode(m, level, scale=pt.scale)
            lp = self._lp(level, False)
            if op == "pc_add":
                pt.cache[level][op] = _prepare_pc_add_cache(encoded, lp)
            else:
                pt.cache[level][op] = _prepare_pc_mult_cache(encoded, lp)
        return pt.cache[level][op]

    def pc_add(self, pt: Plaintext, ct: Ciphertext) -> Ciphertext:
        level = ct.level
        pt_ = self._pt_cached(pt, level, "pc_add")
        lp = self._lp(level, False)
        new0 = _pc_add_core(pt_, ct.data[0], lp)
        return Ciphertext(
            data=(new0, ct.data[1]), flags=ct._flags, level=level,
            **self._meta(),
        )

    def pc_mult(self, pt: Plaintext, ct: Ciphertext, post_rescale=True
                ) -> Ciphertext:
        level = ct.level
        pt_ = self._pt_cached(pt, level, "pc_mult")
        lp = self._lp(level, False)
        d0, d1 = _pc_mult_core(pt_, ct.data[0], ct.data[1], lp)
        new_ct = Ciphertext(data=(d0, d1), level=level, **self._meta())
        if post_rescale:
            new_ct = self.rescale(new_ct)
        return new_ct

    def mc_mult(self, m, ct: Ciphertext, post_rescale=True) -> Ciphertext:
        return self.pc_mult(Plaintext(m), ct, post_rescale=post_rescale)

    def mc_add(self, m, ct: Ciphertext) -> Ciphertext:
        return self.pc_add(Plaintext(m), ct)

    def _scalar_col(self, values_per_prime, level):
        dest = range(level, self.params.P)
        return jnp.array(
            np.array(
                [values_per_prime[i] for i in dest],
                dtype=self.params.dtype,
            ).reshape(-1, 1)
        )

    def mult_int_scalar(self, ct: Ciphertext, scalar) -> Ciphertext:
        R = self.montCtx.R
        mont_scalar = [
            (int(scalar) * R) % qi for qi in self.params.q
        ]
        col = self._scalar_col(mont_scalar, ct.level)
        lp = self._lp(ct.level, False)
        d0 = _mont_scalar_core(ct.data[0], col, lp)
        d1 = _mont_scalar_core(ct.data[1], col, lp)
        return Ciphertext(data=(d0, d1), level=ct.level, **self._meta())

    def mult_scalar(self, ct: Ciphertext, scalar) -> Ciphertext:
        R = self.montCtx.R
        scaled_scalar = int(
            scalar * self.ckksCfg.scale
            * np.sqrt(self.deviations[ct.level + 1]) + 0.5
        )
        mont_scalar = [(scaled_scalar * R) % qi for qi in self.params.q]
        col = self._scalar_col(mont_scalar, ct.level)
        lp = self._lp(ct.level, False)
        d0 = _mont_scalar_core(ct.data[0], col, lp)
        d1 = _mont_scalar_core(ct.data[1], col, lp)
        new_ct = Ciphertext(data=(d0, d1), level=ct.level, **self._meta())
        return self.rescale(new_ct)

    def add_scalar(self, ct: Ciphertext, scalar) -> Ciphertext:
        scaled_scalar = int(
            scalar * self.ckksCfg.scale * self.deviations[ct.level] + 0.5
        )
        if self.norm == "backward":
            scaled_scalar *= self.ckksCfg.N
        scaled_scalar *= self.ckksCfg.int_scale
        vals = [scaled_scalar % qi for qi in self.params.q]
        col = self._scalar_col(vals, ct.level)
        lp = self._lp(ct.level, False)
        new0 = _add_scalar_core(ct.data[0], col, lp)
        return Ciphertext(
            data=(new0, ct.data[1]), flags=ct._flags, level=ct.level,
            **self._meta(),
        )

    # ------------------------------------------------------------------
    # Misc / statistics (reference ``ckks_engine.py:2307-2489``).
    # ------------------------------------------------------------------

    def align_level(self, ct0, ct1):
        diff = ct0.level - ct1.level
        if diff < 0:
            return self.level_up(ct0, ct1.level), ct1
        if diff > 0:
            return ct0, self.level_up(ct1, ct0.level)
        return ct0, ct1

    def refresh(self):
        self.rng.refresh()

    def reduce_error(self, ct):
        return self.mult_scalar(ct, 1.0)

    def sum(self, ct: Ciphertext) -> Ciphertext:
        new_ct = ct
        for roti in range(self.ckksCfg.logN - 1):
            rotk = self.get_rotation_key(2**roti)
            rot_ct = self.rotate_single(new_ct, rotk)
            new_ct = self.cc_add(rot_ct, new_ct)
        return new_ct

    def mean(self, ct: Ciphertext, *, alpha=1) -> Ciphertext:
        new_ct = self.mc_mult(
            m=np.full(self.num_slots, 1 / self.num_slots / alpha), ct=ct
        )
        for roti in range(self.ckksCfg.logN - 1):
            rotk = self.get_rotation_key(2**roti)
            rot_ct = self.rotate_single(new_ct, rotk)
            new_ct = self.cc_add(rot_ct, new_ct)
        return new_ct

    def cov(self, ct_a: Ciphertext, ct_b: Ciphertext,
            evk: EvaluationKey = None) -> Ciphertext:
        evk = evk or self.evk
        cta_mean = self.mean(ct_a)
        ctb_mean = self.mean(ct_b)
        cta_dev = self.cc_sub(ct_a, cta_mean)
        ctb_dev = self.cc_sub(ct_b, ctb_mean)
        return self.mc_mult(
            m=np.full(self.num_slots, 1 / (self.num_slots - 1)),
            ct=self.cc_mult(cta_dev, ctb_dev, evk),
        )

    def pow(self, ct: Ciphertext, power: int, evk: EvaluationKey = None
            ) -> Ciphertext:
        evk = evk or self.evk
        current_exponent = 2
        pow_list = [ct]
        while current_exponent <= power:
            pow_list.append(self.cc_mult(pow_list[-1], pow_list[-1], evk))
            current_exponent *= 2
        remaining = power - current_exponent // 2
        new_ct = pow_list[-1]
        while remaining > 0:
            pow_ind = math.floor(math.log2(remaining))
            new_ct, pow_term = self.align_level(new_ct, pow_list[pow_ind])
            new_ct = self.cc_mult(new_ct, pow_term, evk)
            remaining -= 2**pow_ind
        return new_ct

    def sqrt(self, ct: Ciphertext, evk: EvaluationKey = None, e=0.0001,
             alpha=0.0001) -> Ciphertext:
        """Wilkes square-root iteration (reference
        ``ckks_engine.py:2395-2415``)."""
        a = ct
        b = ct
        evk = evk or self.evk
        while e <= 1 - alpha:
            k = float(np.roots([1 - e**3, -6 + 6 * e**2, 9 - 9 * e])[1])
            t = self.mult_scalar(a, k)
            b0 = self.add_scalar(t, -3)
            b1 = self.mult_scalar(b, (k**0.5) / 2)
            b0, b1 = self.align_level(b0, b1)
            b = self.cc_mult(b0, b1, evk)

            a0 = self.mult_scalar(a, (k**3) / 4)
            t = self.add_scalar(a, -3 / k)
            a1 = self.cc_mult(t, t, evk)
            a0, a1 = self.align_level(a0, a1)
            a = self.cc_mult(a0, a1, evk)
            e = k * (3 - k) ** 2 / 4
        return b

    def randn(self, amin=-1, amax=1, decimal_places: int = 10, level=0,
              return_src=False):
        def integral_bits_available():
            max_bits = math.floor(math.log2(self.base_prime))
            return max_bits - self.ckksCfg.scale_bits

        if amin is None:
            amin = -(2 ** integral_bits_available())
        if amax is None:
            amax = 2 ** integral_bits_available()
        base = 10**decimal_places
        a = np.random.randint(
            amin * base, amax * base, self.num_slots
        ) / base
        b = np.random.randint(
            amin * base, amax * base, self.num_slots
        ) / base
        sample = a + b * 1j
        encrypted = self.encodecrypt(sample, level=level)
        return (encrypted, sample) if return_src else encrypted

    def var(self, ct: Ciphertext, evk: EvaluationKey = None, *,
            post_relin=False) -> Ciphertext:
        evk = evk or self.evk
        ct_mean = self.mean(ct)
        dev = self.cc_sub(ct, ct_mean)
        dev = self.square(dev, evk, post_relin=post_relin)
        if not post_relin:
            dev = self.relinearize(dev, evk)
        return self.mean(dev)

    def std(self, ct: Ciphertext, evk: EvaluationKey = None,
            post_relin=False) -> Ciphertext:
        ct_var = self.var(ct, evk or self.evk, post_relin=post_relin)
        return self.sqrt(ct_var, evk or self.evk)


# ----------------------------------------------------------------------
# Small helper cores used above.
# ----------------------------------------------------------------------


@jax.jit
def _intt_exit_to_mont(x, lp):
    """iNTT keeping the Montgomery factor (the reference applies plain
    ``intt`` to rotate key material, ``ckks_engine.py:1408-1411``)."""
    if lp.mxu_inv is not None:
        return mxu_ntt.intt(x, lp.mxu_inv, epilogue="mont")
    return ntt.intt(x, lp.ipsi, lp.Ninv, lp.pack)


@functools.partial(jax.jit, static_argnames=("base_at", "final_round"))
def _final_scale_host(pt, base_lp, final_scalar, rounding_half, base_at,
                      final_round):
    return _final_scale(pt, base_lp, final_scalar, rounding_half, base_at,
                        final_round)


@functools.partial(jax.jit, static_argnames=("base_at", "final_round"))
def _decrypt_double_batch_core(ct0, ct1, sk, lp, base_lp, final_scalar,
                               rounding_half, base_at, final_round):
    """vmapped :func:`_decrypt_double_core` over stacked [B, C, N]
    ciphertext pairs — one compiled program per level for the whole
    batch (``decryptcode_batch``)."""
    return jax.vmap(
        lambda a, b: _decrypt_double_core(
            a, b, sk, lp, base_lp, final_scalar, rounding_half,
            base_at=base_at, final_round=final_round,
        )
    )(ct0, ct1)


@functools.partial(jax.jit, static_argnames=("base_at", "final_round"))
def _final_scale_batch(pt, base_lp, final_scalar, rounding_half, base_at,
                       final_round):
    return jax.vmap(
        lambda p: _final_scale(p, base_lp, final_scalar, rounding_half,
                               base_at, final_round)
    )(pt)
