"""Multiparty (threshold) FHE extension.

Behavioral equivalent of the reference ``tiberate/extension/mpc.py`` (which
is bit-rotted — references ``self.ckksCtx``/``self.clone``/``pk._replace``
that no longer exist; the protocols here are the repaired versions):

* common-reference-string public keys: every party builds ``pk_i = (e_i -
  a*sk_i, a)`` under a shared uniform ``a``,
* collective public key: ``cpk = (sum_i pk_i[0], a)`` — encryptions under
  cpk decrypt under the joint key ``S = sum_i sk_i``,
* distributed decryption: one party computes the *head* (``ct0 + a*sk_1``),
  the rest compute *partials* (``a*sk_i``); fusion sums and decodes,
* multiparty key-switching / rotation / Galois keys by additive share
  aggregation under per-part CRS,
* evaluation-key generation by the 3-round share-sum -> mult-by-sk ->
  share-sum protocol.

The "repeating channel" ChaCha20 counters make the shared ``a``
available on every shard with zero communication (SURVEY.md §2.2).
"""

import numpy as np

import jax.numpy as jnp

from tiberate_tpu import errors
from tiberate_tpu.engine.ckks_engine import CkksEngine, _final_scale_host
from tiberate_tpu.ops import mont, ntt
from tiberate_tpu.typing import (
    FLAGS,
    Ciphertext,
    DataStruct,
    EvaluationKey,
    GaloisKey,
    KeySwitchKey,
    PublicKey,
    RotationKey,
    SecretKey,
)
from tiberate_tpu.utils import encoding as codec


class CkksEngineMPCExtension(CkksEngine):
    # ------------------------------------------------------------------
    # Collective public keys.
    # ------------------------------------------------------------------

    def multiparty_public_crs(self, pk: PublicKey):
        """Extract the common random polynomial ``a`` from a public key."""
        return jnp.array(pk.data[1])

    def multiparty_create_public_key(
        self, sk: SecretKey, a=None, include_special: bool = False
    ) -> PublicKey:
        """Party-local pk share under the (optionally shared) ``a``."""
        return self._create_public_key(
            sk, include_special=include_special, a=a
        )

    def multiparty_create_collective_public_key(
        self, pks: list[PublicKey]
    ) -> PublicKey:
        pk0 = pks[0]
        include_special = pk0.has_flag(FLAGS.INCLUDE_SPECIAL)
        lp = self._lp(0, include_special)
        b = pks[0].data[0]
        for pk in pks[1:]:
            b = mont.mont_add(b, pk.data[0], lp.pack)
        return PublicKey(
            data=(b, pks[0].data[1]),
            flags=pk0._flags,
            level=pk0.level,
            **self._meta(),
        )

    # ------------------------------------------------------------------
    # Distributed decryption.
    # ------------------------------------------------------------------

    def _partial_sa(self, ct: Ciphertext, sk: SecretKey):
        level = ct.level
        lp = self._lp(level, False)
        C = lp.num_channels
        sk_data = sk.data[level : level + C]
        a = ntt.enter_ntt(ct.data[1][:C], lp.Rs, lp.psi, lp.pack)
        sa = ntt.intt_exit(
            mont.mont_mult(a, sk_data, lp.pack), lp.ipsi, lp.Ninv, lp.pack
        )
        return sa

    def multiparty_decrypt_head(self, ct: Ciphertext, sk: SecretKey):
        """ct0 + a*sk for the initiating party."""
        if ct.has_flag(FLAGS.NTT_STATE):
            raise errors.NTTStateError(expected=False)
        if not sk.has_flag(FLAGS.NTT_STATE):
            raise errors.NTTStateError(expected=True)
        lp = self._lp(ct.level, False)
        C = lp.num_channels
        sa = self._partial_sa(ct, sk)
        return mont.mont_add(ct.data[0][:C], sa, lp.pack)

    def multiparty_decrypt_partial(self, ct: Ciphertext, sk: SecretKey):
        """a*sk for each non-initiating party."""
        if ct.has_flag(FLAGS.NTT_STATE):
            raise errors.NTTStateError(expected=False)
        if not sk.has_flag(FLAGS.NTT_STATE):
            raise errors.NTTStateError(expected=True)
        return self._partial_sa(ct, sk)

    def multiparty_decrypt_fusion(
        self, pcts: list, level: int = 0, final_round: bool = True,
        is_real: bool = False,
    ):
        """Sum partial decryptions, scale, and decode to a message."""
        lp = self._lp(level, False)
        C = lp.num_channels
        pt = pcts[0]
        for pct in pcts[1:]:
            pt = mont.mont_add(pt, pct, lp.pack)
        pt = mont.reduce_2q(pt, lp.pack)

        scaled = _final_scale_host(
            pt, self.params.base_lp(), self.params.final_scalar[level],
            self._rounding_half, base_at=C - 1, final_round=final_round,
        )
        decoded = codec.decode(
            np.asarray(scaled).reshape(-1),
            scale=self.ckksCfg.scale,
            correction=self.corrections[level],
            norm=self.norm,
        )[: self.num_slots]
        return decoded.real if is_real else decoded

    # ------------------------------------------------------------------
    # Multiparty key switching / rotation / Galois.
    # ------------------------------------------------------------------

    def multiparty_create_key_switching_key(
        self, sk_src: SecretKey, sk_dst: SecretKey, a=None
    ) -> KeySwitchKey:
        """Same construction as the single-party ksk, under per-part CRS."""
        return self.create_key_switching_key(sk_src, sk_dst, a=a)

    def multiparty_create_rotation_key(
        self, sk: SecretKey, delta: int, a=None
    ) -> RotationKey:
        return self._create_rotation_key(delta, a=a, sk=sk)

    def _sum_ksk_shares(self, ksks: list, component=(0,)):
        """Additive aggregation of ksk parts across parties."""
        lp = self._lp(0, True)
        parts = []
        for part_idx in range(len(ksks[0].data)):
            comps = list(ksks[0].data[part_idx])
            for other in ksks[1:]:
                for c in component:
                    comps[c] = mont.mont_add(
                        comps[c], other.data[part_idx][c], lp.pack
                    )
            parts.append(tuple(comps))
        return parts

    def multiparty_generate_rotation_key(
        self, rotks: list[RotationKey]
    ) -> RotationKey:
        parts = self._sum_ksk_shares(rotks, component=(0,))
        return RotationKey(
            data=tuple(parts),
            flags=rotks[0]._flags,
            level=rotks[0].level,
            **{**rotks[0].misc},
        )

    def generate_rotation_crs(self, rotk: RotationKey | KeySwitchKey):
        return [part[1] for part in rotk.data]

    def generate_galois_crs(self, galk: GaloisKey):
        return [
            [part[1] for part in rotk.data] for rotk in galk.data
        ]

    def multiparty_create_galois_key(
        self, sk: SecretKey, a: list
    ) -> GaloisKey:
        deltas = [2**i for i in range(self.ckksCfg.logN - 1)]
        parts = [
            self.multiparty_create_rotation_key(sk, deltas[i], a=a[i])
            for i in range(len(deltas))
        ]
        return GaloisKey(
            data=parts,
            flags=FLAGS.NTT_STATE | FLAGS.MONTGOMERY_STATE
            | FLAGS.INCLUDE_SPECIAL,
            level=0,
            **self._meta(),
        )

    def multiparty_generate_galois_key(
        self, galks: list[GaloisKey]
    ) -> GaloisKey:
        rotks = []
        for rot_idx in range(len(galks[0].data)):
            rotks.append(
                self.multiparty_generate_rotation_key(
                    [g.data[rot_idx] for g in galks]
                )
            )
        return GaloisKey(
            data=rotks,
            flags=galks[0]._flags,
            level=galks[0].level,
            **{**galks[0].misc},
        )

    # ------------------------------------------------------------------
    # Multiparty evaluation key (3-round protocol).
    # ------------------------------------------------------------------

    def multiparty_sum_evk_share(self, evks_share: list[DataStruct]):
        parts = self._sum_ksk_shares(evks_share, component=(0,))
        return EvaluationKey(
            data=tuple(parts),
            flags=evks_share[0]._flags,
            level=evks_share[0].level,
            **{**evks_share[0].misc},
        )

    def multiparty_mult_evk_share_sum(
        self, evk_sum: DataStruct, sk: SecretKey
    ):
        lp = self._lp(0, True)
        parts = []
        for p0, p1 in evk_sum.data:
            parts.append(
                (
                    mont.mont_mult(p0, sk.data, lp.pack),
                    mont.mont_mult(p1, sk.data, lp.pack),
                )
            )
        return EvaluationKey(
            data=tuple(parts),
            flags=evk_sum._flags,
            level=evk_sum.level,
            **{**evk_sum.misc},
        )

    def multiparty_sum_evk_share_mult(
        self, evk_sum_mult: list[DataStruct]
    ):
        parts = self._sum_ksk_shares(evk_sum_mult, component=(0, 1))
        return EvaluationKey(
            data=tuple(parts),
            flags=evk_sum_mult[0]._flags,
            level=evk_sum_mult[0].level,
            **{**evk_sum_mult[0].misc},
        )
