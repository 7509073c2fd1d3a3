"""Device-resident CKKS parameter context (the NTTContext equivalent).

A JAX redesign of the reference ``tiberate/context/ntt_context.py``.
Where the reference builds per-GPU lists of parameter tensors and a
``prepack`` dictionary of argument tuples per (level, mult_type, part)
(``ntt_context.py:572-680``), here every parameter is ONE contiguous array
over the full prime basis ``[scale primes..., base, specials...]`` ordered so
that a *level view* is a static slice:

* ordinary channels at level ``lvl``: rows ``lvl : P``
* with-special channels at level ``lvl``: rows ``lvl : P+S``

Static slices trace cleanly under ``jit`` (one compiled engine per level,
the prepack equivalent), and the channel axis is the natural mesh-sharding
axis.  Key-switch decomposition parts are contiguous row ranges of the same
arrays, so part packs are also slices.

Basis-extension constants per part (``Y_scalar``, ``L_scalar``, ``L_enter``)
follow the reference math exactly (``ntt_context.py:419-554``):
``Y_scalar[i] = L[i]^-1·R mod m[i+1]``, ``L_scalar[i][j] = L[i]·R mod m[j]``,
``L_enter[i][c] = L[i]·R^2 mod q_c`` over the full with-special basis.
"""

import math
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from tiberate_tpu.config import CkksConfig
from tiberate_tpu.context.mont_context import MontgomeryContext
from tiberate_tpu.context.rns_partition import RnsPartition
from tiberate_tpu.ops import ntt as ntt_ops
from tiberate_tpu.ops.mont import ModPack


def _col(vals, dtype=np.int64):
    return jnp.array(np.array(vals, dtype=dtype).reshape(-1, 1))


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class LevelPack:
    """Everything the kernels need for one (level, include_special) view.

    ``mxu_fwd``/``mxu_inv`` (optional) carry the int8 4-step tables
    (``ops/mxu_ntt.py``).  When present, the engine's NTT helpers use
    them for unsigned transforms; otherwise the radix-2 butterflies.
    """

    pack: ModPack           # ql/qh/kl/kh/_2q, [C, 1]
    psi: jax.Array          # [C, N] Montgomery-form bit-reversed twiddles
    ipsi: jax.Array         # [C, N]
    Ninv: jax.Array         # [C, 1] N^-1 R mod q
    Rs: jax.Array           # [C, 1] R^2 mod q
    Rs_scale: jax.Array     # [C, 1] R^2 * scale mod q
    mxu_fwd: object = None  # mxu_ntt.MxuNttTables | None
    mxu_inv: object = None  # mxu_ntt.MxuNttTables | None

    def tree_flatten(self):
        return (
            (self.pack, self.psi, self.ipsi, self.Ninv, self.Rs,
             self.Rs_scale, self.mxu_fwd, self.mxu_inv),
            None,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def num_channels(self):
        return self.psi.shape[0]

    def __getitem__(self, sl):
        return LevelPack(
            pack=self.pack[sl],
            psi=self.psi[sl],
            ipsi=self.ipsi[sl],
            Ninv=self.Ninv[sl],
            Rs=self.Rs[sl],
            Rs_scale=self.Rs_scale[sl],
            mxu_fwd=None if self.mxu_fwd is None else self.mxu_fwd[sl],
            mxu_inv=None if self.mxu_inv is None else self.mxu_inv[sl],
        )


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class PartPack:
    """Key-switch decomposition part: basis-extension constants.

    ``prime_idx`` are the part's global prime indices (contiguous);
    ``lo/hi`` the local row range into the *ordinary* data at this level.
    """

    lo: int = field(metadata={"static": True})
    hi: int = field(metadata={"static": True})
    g0: int = field(metadata={"static": True})   # first global prime index
    Y_scalar: jax.Array | None   # [alpha-1, 1] (mod m[i+1])
    L_scalar: tuple              # tuple of [alpha-i-2, 1] arrays
    L_enter: jax.Array | None    # [alpha-1, C_special_at_level0, 1]

    def tree_flatten(self):
        return (self.Y_scalar, self.L_scalar, self.L_enter), (
            self.lo, self.hi, self.g0,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        lo, hi, g0 = aux
        return cls(lo=lo, hi=hi, g0=g0, Y_scalar=children[0],
                   L_scalar=children[1], L_enter=children[2])

    @property
    def alpha(self):
        return self.hi - self.lo


class CkksParams:
    """Host-built, device-resident parameter bundle for one CkksConfig."""

    def __init__(self, cfg: CkksConfig):
        if cfg.buffer_bit_length not in (30, 62):
            raise NotImplementedError(
                f"buffer_bit_length={cfg.buffer_bit_length}; the reference "
                "supports 62 (int64) and 30 (int32) modes"
            )
        self.cfg = cfg
        self.montCtx = MontgomeryContext.from_ckks_config(cfg)
        self.num_ordinary_primes = cfg.num_scales + 1
        self.num_special_primes = cfg.num_special_primes
        self.rnsPart = RnsPartition(
            self.num_ordinary_primes, self.num_special_primes, 1
        )

        P = self.num_ordinary_primes
        S = self.num_special_primes
        N = cfg.N
        R = self.montCtx.R
        q = self.montCtx.q
        self.q = q
        self.P = P
        self.S = S
        self.N = N
        self.logN = cfg.logN
        self.buffer_bit_length = cfg.buffer_bit_length
        self.dtype = np.int32 if cfg.buffer_bit_length == 30 else np.int64
        col = lambda vals: _col(vals, self.dtype)

        # --- full-basis parameter arrays -------------------------------
        self.pack = ModPack.from_q(q, R_bits=cfg.buffer_bit_length)
        psi, ipsi = ntt_ops.make_psi_tables(q, cfg.logN)
        self.psi = jnp.array(
            np.array(
                [[p * R % qi for p in row] for row, qi in zip(psi, q)],
                dtype=self.dtype,
            )
        )
        self.ipsi = jnp.array(
            np.array(
                [[p * R % qi for p in row] for row, qi in zip(ipsi, q)],
                dtype=self.dtype,
            )
        )
        self.Ninv = col([pow(N, -1, qi) * R % qi for qi in q])
        self.Rs = col(self.montCtx.R_square)
        self.Rs_scale = col(
            [(Rsq * cfg.int_scale) % qi
             for Rsq, qi in zip(self.montCtx.R_square, q)]
        )

        self._full = LevelPack(
            pack=self.pack, psi=self.psi, ipsi=self.ipsi,
            Ninv=self.Ninv, Rs=self.Rs, Rs_scale=self.Rs_scale,
        )
        self._lp_cache = {}

        self.num_levels = cfg.num_scales  # usable multiplicative levels

        # --- key-switch part structure per level -----------------------
        # Parts partition the *ordinary* primes [lvl..P-1] into contiguous
        # groups aligned to the fixed level-0 partitioning (groups of S,
        # plus the base prime as its own part), reference
        # rns_partition.py:105-187.
        self.parts = []          # parts[lvl] = list[PartPack]
        self.parts_alloc = []    # parts_alloc[lvl] = list of global part ids
        for lvl in range(self.num_levels):
            self.parts.append(self._build_parts(lvl))
            # global ksk part id of each live part (parts drop from front)
            first_part = lvl // S if S > 0 else 0
            n_parts = len(self.parts[lvl])
            self.parts_alloc.append(
                list(range(first_part, first_part + n_parts))
            )

        # --- rescale constants -----------------------------------------
        # rescale_scales[lvl][c] = q_lvl^-1 * R mod q_i for i in [lvl+1..P-1]
        self.rescale_scales = []
        for lvl in range(self.num_levels):
            m0 = q[lvl]
            dest = range(lvl + 1, P)
            self.rescale_scales.append(
                col([pow(m0, -1, q[i]) * R % q[i] for i in dest])
            )

        # --- keyswitch P-division constants ----------------------------
        # PiRs[lvl][P_ind]: P_j^-1 * R mod q_i over with-special channels
        # at the level, zero-padded on the top P_ind+1 rows (those rows
        # become dead during successive division; reference
        # ckks_engine.py:166-220 builds the unpadded variant).
        P_primes = q[P : P + S][::-1]
        self.PiRs = []
        for lvl in range(self.num_levels):
            dest = list(range(lvl, P)) + list(range(P, P + S))
            per_level = []
            for P_ind, Pj in enumerate(P_primes):
                cover = dest[: len(dest) - P_ind - 1]
                vals = [pow(Pj, -1, q[i]) * R % q[i] for i in cover]
                vals += [0] * (P_ind + 1)
                per_level.append(col(vals))
            self.PiRs.append(per_level)

        # mont_PR[c] = P * R mod q_c over ordinary channels at level 0
        # (reference ckks_engine.py:222-237).
        P_prod = math.prod(P_primes)
        self.mont_PR = col([(P_prod * R) % q[i] for i in range(P)])

        # --- decode constants (reference ckks_engine.py:239-270) -------
        scale = cfg.scale
        self.alpha = [
            (scale / np.float64(qi)) ** 2 for qi in q[: cfg.num_scales]
        ]
        self.deviations = [1.0]
        for al in self.alpha:
            self.deviations.append(self.deviations[-1] ** 2 * al)

        self.final_q = [q[lvl] for lvl in range(self.num_levels)]
        self.final_alpha = [
            (scale / np.float64(fq)) for fq in self.final_q
        ]
        self.corrections = [
            1.0 / (d * fa)
            for d, fa in zip(self.deviations, self.final_alpha)
        ]
        self.base_prime = q[P - 1]
        self.final_scalar = [
            col([pow(fq, -1, self.base_prime) * R % self.base_prime])
            for fq in self.final_q
        ]

    # ------------------------------------------------------------------

    def lp(self, lvl: int, special: bool) -> LevelPack:
        """Level view: static channel slice of the full parameter arrays."""
        key = (lvl, special)
        if key not in self._lp_cache:
            # with-special view = rows [lvl:P] ++ [P:P+S] == rows [lvl:],
            # because specials sit at the end of the basis.
            sl = slice(lvl, None) if special else slice(lvl, self.P)
            self._lp_cache[key] = self._full[sl]
        return self._lp_cache[key]

    def enable_mxu_ntt(self):
        """Attach the matmul-form 4-step NTT tables (``ops/mxu_ntt``).

        Unsigned transforms then run as int8 limb contractions; the
        signed key-material path keeps the radix-2 butterflies.
        """
        if getattr(self, "_mxu_enabled", False):
            return
        from tiberate_tpu.ops import mxu_ntt

        fwd = mxu_ntt.build_tables(
            self.q, self.logN, mont_R_bits=self.buffer_bit_length
        )
        inv = mxu_ntt.build_tables(
            self.q, self.logN, mont_R_bits=self.buffer_bit_length,
            inverse=True,
        )
        self._full = LevelPack(
            pack=self.pack, psi=self.psi, ipsi=self.ipsi,
            Ninv=self.Ninv, Rs=self.Rs, Rs_scale=self.Rs_scale,
            mxu_fwd=fwd, mxu_inv=inv,
        )
        self._lp_cache = {}
        self._mxu_enabled = True

    def base_lp(self) -> LevelPack:
        """The base-prime-only view (last ordinary channel)."""
        return self._full[self.P - 1 : self.P]

    def part_lp(self, part: PartPack, lvl: int) -> LevelPack:
        """Level view of one part's primes (contiguous global rows)."""
        return self._full[part.g0 : part.g0 + part.alpha]

    # ------------------------------------------------------------------

    def _build_parts(self, lvl):
        """Parts over ordinary primes [lvl..P-1], aligned to the fixed
        level-0 grouping: group i covers global primes [iS..(i+1)S), the
        base prime is its own part."""
        P, S = self.P, self.S
        out = []
        gi = lvl // S
        while gi * S < P - 1:
            glo = max(gi * S, lvl)
            ghi = min((gi + 1) * S, P - 1)
            if ghi > glo:
                out.append(self._make_part(glo, ghi, glo - lvl))
            gi += 1
        # base prime part
        out.append(self._make_part(P - 1, P, P - 1 - lvl))
        return out

    def _make_part(self, glo, ghi, local_lo):
        """Basis-extension constants for primes [glo..ghi)."""
        alpha = ghi - glo
        q = self.q
        R = self.montCtx.R
        m = [q[i] for i in range(glo, ghi)]
        P, S = self.P, self.S

        if alpha == 1:
            return PartPack(
                lo=local_lo, hi=local_lo + 1, g0=glo,
                Y_scalar=None, L_scalar=(), L_enter=None,
            )

        L = [m[0]]
        for i in range(1, alpha - 1):
            L.append(L[-1] * m[i])

        Y_scalar = []
        L_scalar = []
        for i in range(alpha - 1):
            Y_scalar.append(pow(L[i], -1, m[i + 1]) * R % m[i + 1])
            if (i + 2) < alpha:
                L_scalar.append(
                    _col([(L[i] * R) % m[j] for j in range(i + 2, alpha)], self.dtype)
                )

        # L_enter over the full with-special basis at level 0 (sliced per
        # level by the engine); L_enter[i][c] = L[i] * R^2 mod q_c.
        dest = list(range(P + S))
        L_enter = np.array(
            [
                [
                    (L[i] * self.montCtx.R_square[c]) % q[c]
                    for c in dest
                ]
                for i in range(alpha - 1)
            ],
            dtype=self.dtype,
        )[..., None]

        return PartPack(
            lo=local_lo, hi=local_lo + alpha, g0=glo,
            Y_scalar=_col(Y_scalar, self.dtype),
            L_scalar=tuple(L_scalar),
            L_enter=jnp.array(L_enter),
        )
