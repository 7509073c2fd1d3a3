"""Counter-mode ChaCha20 CSPRNG with fused range-mapping samplers.

A JAX equivalent of the reference ``tiberate/rng/csprng/csprng.py`` plus
the fused CUDA kernels it drives (``randint_cuda.cu``,
``discrete_gaussian_cuda.cu``, ``randround_cuda.cu``).  The channel model is
preserved exactly:

* state rows = (channels + repeating_channels) x L, L = N/4 — each row is one
  ChaCha20 block (16 words) yielding 4 samples,
* row counters are the global stream index, so *repeating* channels produce
  identical streams on every shard without communication (reference
  ``csprng.py:29-43,144-154``) — this is how the shared public randomness
  ``a`` exists everywhere,
* after each generation the targeted rows' counters advance by
  ``inc = (total_channels + repeating) * L``.

Sampling kernels (bit-identical to the reference CUDA):

* ``randint``: 128-bit uniform (4 words, layout w0:b32-63 w1:b0-31 w2:b96-127
  w3:b64-95) -> ``(u * q) >> 128`` multiply-shift into [0, q), plus shift,
* ``discrete_gaussian``: 127-bit uniform CDT binary-tree inversion (σ=3.2),
  sign from the LSB of the high word,
* ``randround``: stochastic rounding of f64 coefficients against 32-bit
  uniform thresholds (round-to-nearest-even on frac*2^32).
"""

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tiberate_tpu.rng.chacha20 import (
    NOTHING_UP_MY_SLEEVE,
    chacha20_block,
    step_counter,
)
from tiberate_tpu.rng.discrete_gaussian_sampler import (
    build_CDT_binary_search_tree,
)

U32 = jnp.uint32
U64 = jnp.uint64
# numpy scalar: module import must not create device arrays (backend may
# not exist yet in CLI contexts); jnp ops accept numpy operands.
M32 = np.uint64(0xFFFFFFFF)


def _umul64hi(a, b):
    """High 64 bits of a 64x64-bit product, via 32-bit halves."""
    al = a & M32
    ah = a >> U64(32)
    bl = b & M32
    bh = b >> U64(32)
    lo = al * bl
    mid1 = al * bh
    mid2 = ah * bl
    hi = ah * bh
    carry = ((lo >> U64(32)) + (mid1 & M32) + (mid2 & M32)) >> U64(32)
    return hi + (mid1 >> U64(32)) + (mid2 >> U64(32)) + carry


def _words_to_u128_parts(w):
    """[..., 16] uint32 keystream -> (x_low, x_hi_lo, x_hi_hi) per sample.

    Word layout matches the reference ``COMBINE_TWO`` usage
    (``randint_cuda.cu:59-88``): for sample i of 4, using words 4i..4i+3,
    x_low = (w0 << 32) | w1 (bits 0..63), w3 = bits 64..95, w2 = bits 96..127.
    Returns uint64 arrays of shape [..., 4].
    """
    w = w.astype(U64).reshape(*w.shape[:-1], 4, 4)
    x_low = (w[..., 0] << U64(32)) | w[..., 1]
    xhl = w[..., 3]  # bits 64..95
    xhh = w[..., 2]  # bits 96..127
    return x_low, xhl, xhh


@partial(jax.jit, static_argnames=("shift",))
def _randint_from_words(words, q, shift: int):
    """words: [rows, 16] uint32; q: [rows] uint64 -> samples [rows, 4] uint64.

    sample = (u128 * q) >> 128 + shift, exactly the carry chain of
    ``randint_fast_cuda_kernel`` (``csrc/cuda/randint_cuda.cu:57-94``).
    """
    x_low, xhl, xhh = _words_to_u128_parts(words)
    p = q[:, None]
    alpha = _umul64hi(p, x_low)
    pl = p & M32
    ph = p >> U64(32)
    plxhl = pl * xhl
    plxhh = pl * xhh
    phxhl = ph * xhl
    phxhh = ph * xhh
    carry = ((plxhl & M32) + (alpha & M32)) >> U64(32)
    carry = (
        carry + (plxhl >> U64(32)) + (alpha >> U64(32)) + (phxhl & M32)
        + (plxhh & M32)
    ) >> U64(32)
    sample = carry + (phxhl >> U64(32)) + (plxhh >> U64(32)) + phxhh
    if shift:
        sample = sample + jnp.uint64(np.uint64(np.int64(shift)))
    return sample


@partial(jax.jit, static_argnames=("depth",))
def _dgauss_from_words(words, btree_lo, btree_hi, depth: int):
    """CDT inversion sampling. words [rows,16] -> samples [rows,4] int64."""
    x_low, xhl, xhh = _words_to_u128_parts(words)
    x_high = (xhh << U64(32)) | xhl
    sign_bit = (x_high & U64(1)).astype(jnp.int64)
    x_high = x_high >> U64(1)

    current = jnp.zeros(x_low.shape, dtype=jnp.int32)
    counter = 0
    jump = 1
    for _ in range(depth):
        node_lo = btree_lo[counter + current]
        node_hi = btree_hi[counter + current]
        ge = (x_high > node_hi) | ((x_high == node_hi) & (x_low >= node_lo))
        current = 2 * current + ge.astype(jnp.int32)
        counter += jump
        jump *= 2
    return (sign_bit * 2 - 1) * current.astype(jnp.int64)


@partial(jax.jit, static_argnames=("B", "depth", "inc"))
def _encrypt_noise_core(rows_t, rows_u, btree_lo, btree_hi, q_rows,
                        B: int, depth: int, inc: int):
    """Device core of :meth:`Csprng.encrypt_noise_batch`: ChaCha the
    B-replicated counter trajectories of the two repeating channels and
    sample.  A k-fold counter advance as ONE uint32 add carries exactly
    like k sequential ``step_counter`` calls while ``k * inc < 2^32``
    (same invariant :meth:`randround_batch` relies on)."""
    ks = jnp.arange(B, dtype=jnp.uint32)
    tA = jax.vmap(lambda k: step_counter(rows_t, 2 * k * inc))(ks)
    tB = jax.vmap(lambda k: step_counter(rows_u, k * inc))(ks)
    # per-message row order matches discrete_gaussian(repeats=2):
    # [channel t rows (e0), channel u rows (e1)]
    tgt_dg = jnp.concatenate([tA, tB], axis=1).reshape(-1, 16)
    e = _dgauss_from_words(
        chacha20_block(tgt_dg), btree_lo, btree_hi, depth
    )
    tR = jax.vmap(lambda k: step_counter(rows_t, (2 * k + 1) * inc))(ks)
    v = _randint_from_words(
        chacha20_block(tR.reshape(-1, 16)), q_rows, 0
    )
    new_t = step_counter(rows_t, 2 * B * inc)
    new_u = step_counter(rows_u, B * inc)
    return e, v, new_t, new_u


class Csprng:
    def __init__(
        self,
        num_coefs=2**15,
        num_channels=None,
        num_repeating_channels=2,
        sigma=3.2,
        seed=None,
        nonce=None,
    ):
        self.num_coefs = num_coefs
        self.num_channels = (
            [8] if num_channels is None else list(num_channels)
        )
        # Single logical shard: all channels in one state tensor.  (On a
        # sharded mesh every shard rebuilds the rows it owns from the same
        # global counters, reproducing the reference multi-GPU layout.)
        self.shares = (
            self.num_channels
            if len(self.num_channels) == 1
            else [sum(self.num_channels)]
        )
        self.total_num_channels = sum(self.shares)
        self.num_repeating_channels = num_repeating_channels
        self.sigma = sigma

        self.L = self.num_coefs // 4

        btree, self.btree_size, self.tree_depth = (
            build_CDT_binary_search_tree(security_bits=128, sigma=sigma)
        )
        self.btree = btree
        self._btree_lo = jnp.array(btree[:, 0])
        self._btree_hi = jnp.array(btree[:, 1])

        self.inc = (
            self.total_num_channels + self.num_repeating_channels
        ) * self.L
        self.repeating_start = self.total_num_channels * self.L

        inc = self.inc

        @jax.jit
        def _chacha_and_step(target):
            return chacha20_block(target), step_counter(target, inc)

        self._chacha_and_step = _chacha_and_step

        @jax.jit
        def _randround_core(coef, words):
            # Device-side stochastic rounding (the reference's fused
            # ``randround_cuda.cu:6-53``): threshold-compare the fraction
            # against one uint32 per coefficient, entirely on-device.
            rand = words.reshape(-1).astype(jnp.int64)
            sign = jnp.sign(coef)
            abs_coef = jnp.abs(coef)
            integ = jnp.floor(abs_coef)
            frac = abs_coef - integ
            ifrac = jnp.rint(frac * jnp.float64(2**32)).astype(jnp.int64)
            rounded = (rand < ifrac).astype(jnp.float64)
            return (sign * (integ + rounded)).astype(jnp.int64)

        self._randround_core = _randround_core

        self.refresh(seed, nonce)

    # ------------------------------------------------------------------
    # State management.
    # ------------------------------------------------------------------

    def refresh(self, seed=None, nonce=None):
        if nonce is None and isinstance(seed, int):
            # An explicit seed must be FULLY deterministic: draw key and
            # nonce from one seeded stream (the first 8 words match what
            # _generate_words(32, seed) produced, so explicit-nonce users
            # are unaffected) instead of an os.urandom nonce.
            words = np.random.default_rng(seed).integers(0, 2**32, 10)
            self.key = [int(x) for x in words[:8]]
            self.nonce = [int(x) for x in words[8:]]
        else:
            self.key = self._generate_words(32, seed)
            self.nonce = self._generate_words(8, nonce)
        rows = (
            self.total_num_channels + self.num_repeating_channels
        ) * self.L
        state = np.zeros((rows, 16), dtype=np.uint32)
        state[:, 0:4] = NOTHING_UP_MY_SLEEVE
        state[:, 4:12] = np.array(self.key, dtype=np.uint32)
        state[:, 12] = np.arange(rows, dtype=np.uint32)
        state[:, 14:16] = np.array(self.nonce, dtype=np.uint32)
        self.states = jnp.array(state)

    @staticmethod
    def _generate_words(nbytes, seed=None, part_bytes=4):
        if seed is None:
            raw = os.urandom(nbytes)
            return [
                int.from_bytes(raw[i : i + part_bytes], "little")
                for i in range(0, nbytes, part_bytes)
            ]
        if isinstance(seed, int):
            rng = np.random.default_rng(seed)
            return [
                int(x) for x in rng.integers(0, 2**32, nbytes // part_bytes)
            ]
        return [int(s) & 0xFFFFFFFF for s in seed]

    @property
    def channeled_states(self):
        return self.states.reshape(-1, self.L, 16)

    def _target_rows(self, start_channel, end_channel):
        return start_channel * self.L, end_channel * self.L

    def _generate(self, start_channel, end_channel):
        """ChaCha the selected channel rows; step their counters."""
        r0, r1 = self._target_rows(start_channel, end_channel)
        target = self.states[r0:r1]
        words, stepped = self._chacha_and_step(target)
        self.states = self.states.at[r0:r1].set(stepped)
        return words

    # ------------------------------------------------------------------
    # Public sampling API (mirrors the reference RandNumGen interface).
    # ------------------------------------------------------------------

    def randbytes(self, shares=None, repeats=0, reshape=False):
        nch = self.total_num_channels if shares is None else shares
        start = self.total_num_channels - nch
        end = self.total_num_channels + repeats
        words = self._generate(start, end)
        if reshape:
            return words.reshape(-1, self.L, 16)
        return words

    def randint(self, amax=3, shift=0, repeats=0):
        """Uniform ints in [shift, amax + shift).

        amax: scalar, or per-channel list of moduli (then channels used =
        len(amax), with the last ``repeats`` of them in repeating channels).
        Returns int64 array [channels, num_coefs].
        """
        if not isinstance(amax, (list, tuple, np.ndarray)):
            amax = [amax]
        nch = len(amax) - repeats  # non-repeating channels used
        start = self.total_num_channels - nch
        end = self.total_num_channels + repeats
        words = self._generate(start, end)
        q_rows = np.repeat(
            np.array([int(a) for a in amax], dtype=np.uint64), self.L
        )
        samples = _randint_from_words(words, jnp.array(q_rows), int(shift))
        return samples.reshape(-1, self.num_coefs).astype(jnp.int64)

    def discrete_gaussian(self, non_repeats=0, repeats=1):
        nch = non_repeats
        start = self.total_num_channels - nch
        end = self.total_num_channels + repeats
        words = self._generate(start, end)
        samples = _dgauss_from_words(
            words, self._btree_lo, self._btree_hi, self.tree_depth
        )
        return samples.reshape(-1, self.num_coefs)

    def encrypt_noise_batch(self, B: int, amax: int = 2):
        """Noise draws for B encryptions in TWO ChaCha dispatches.

        Bit-identical to B sequential iterations of the encrypt loop's
        draw pair ``(discrete_gaussian(repeats=2),
        randint(amax=amax, shift=0, repeats=1)[0])``: per message the
        first repeating channel serves e0 then v (two counter steps of
        ``inc``), the second serves e1 (one step) — replica k's rows
        are the stored states advanced to exactly where call k would
        have found them, like :meth:`randround_batch`.
        Returns ``(e [B, 2, N] float, v [B, N] int64)``.
        """
        if B == 1:
            e = self.discrete_gaussian(repeats=2)
            v = self.randint(amax=amax, shift=0, repeats=1)[0]
            return e[None], v[None]
        L = self.L
        r0 = self.repeating_start
        rows_t = self.states[r0 : r0 + L]
        rows_u = self.states[r0 + L : r0 + 2 * L]
        q_rows = jnp.asarray(np.full(B * L, amax, dtype=np.uint64))
        e, v, new_t, new_u = _encrypt_noise_core(
            rows_t, rows_u, self._btree_lo, self._btree_hi, q_rows,
            B=B, depth=self.tree_depth, inc=self.inc,
        )
        self.states = (
            self.states.at[r0 : r0 + L].set(new_t)
            .at[r0 + L : r0 + 2 * L].set(new_u)
        )
        return (e.reshape(B, 2, self.num_coefs),
                v.reshape(B, self.num_coefs).astype(jnp.int64))

    def randround(self, coef):
        """Stochastically round f64 coefficients [N] — on device.

        Uses the first N/16 state rows as the threshold stream, like the
        reference (``csprng.py:312-325``); round-to-nearest-even of
        frac * 2^32 mirrors CUDA ``__double2ll_rn``.  The compare/round
        is a jitted device kernel (reference ``randround_cuda.cu:6-53``);
        returns a device int64 array.
        """
        coef = jnp.asarray(coef, dtype=jnp.float64)
        L16 = self.num_coefs // 16
        target = self.states[:L16]
        words, stepped = self._chacha_and_step(target)
        self.states = self.states.at[:L16].set(stepped)
        return self._randround_core(coef, words)

    def randround_batch(self, coefs):
        """Stochastically round a BATCH of f64 coefficients [B, N] in one
        device dispatch — bit-identical to B sequential :meth:`randround`
        calls: replica k's threshold states are the stored states with
        counters advanced by k * inc (exactly where call k would have
        found them), and the stored counters advance by B * inc."""
        coefs = jnp.asarray(coefs, dtype=jnp.float64)
        B = coefs.shape[0]
        if B == 1:
            return self.randround(coefs[0])[None]
        L16 = self.num_coefs // 16
        base = self.states[:L16]
        targets = jnp.concatenate(
            [step_counter(base, k * self.inc) if k else base
             for k in range(B)]
        )                                   # [B*L16, 16]
        words = chacha20_block(targets)
        self.states = self.states.at[:L16].set(
            step_counter(base, B * self.inc)
        )
        return self._randround_core(
            coefs.reshape(-1), words
        ).reshape(B, -1)
