"""Vectorized ChaCha20 block function on uint32 state tensors.

A JAX equivalent of the reference CUDA kernel
(``csrc/cuda/chacha20_cuda.cu:6-40``): counter-mode ChaCha20 where each state
row holds the 16 32-bit words of one block; 10 double-rounds then the
feed-forward add; the block counter lives at word 12 (low) / 13 (carry) and is
advanced by ``step`` after each generation.

The reference stores 32-bit words in int64 lanes (GPU needs 64-bit lanes for
the unmasked adds); here we store genuine uint32 lanes — adds wrap mod 2^32
natively, which is exactly the ``& MASK`` semantics of the reference macros
(``csrc/cuda/chacha20_cuda.h:9-40``).  Outputs are bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32


def _rotl(x, n):
    return (x << U32(n)) | (x >> U32(32 - n))


def _quarter_round(x, a, b, c, d):
    xa, xb, xc, xd = x[a], x[b], x[c], x[d]
    xa = xa + xb
    xd = _rotl(xd ^ xa, 16)
    xc = xc + xd
    xb = _rotl(xb ^ xc, 12)
    xa = xa + xb
    xd = _rotl(xd ^ xa, 8)
    xc = xc + xd
    xb = _rotl(xb ^ xc, 7)
    x[a], x[b], x[c], x[d] = xa, xb, xc, xd


def chacha20_block(state):
    """One ChaCha20 block per row.

    state: [..., 16] uint32.  Returns (random_words, new_state) where
    random_words = working_state + input_state (the keystream block) and
    new_state is *unchanged* — counter stepping is the caller's job
    (see :func:`step_counter`), matching the reference split where the kernel
    writes ``dest`` and bumps ``input`` separately.
    """
    x = [state[..., i] for i in range(16)]
    for _ in range(10):
        _quarter_round(x, 0, 4, 8, 12)
        _quarter_round(x, 1, 5, 9, 13)
        _quarter_round(x, 2, 6, 10, 14)
        _quarter_round(x, 3, 7, 11, 15)
        _quarter_round(x, 0, 5, 10, 15)
        _quarter_round(x, 1, 6, 11, 12)
        _quarter_round(x, 2, 7, 8, 13)
        _quarter_round(x, 3, 4, 9, 14)
    working = jnp.stack(x, axis=-1)
    return working + state


def step_counter(state, step):
    """Advance the 64-bit block counter at words 12 (low) / 13 (high).

    Matches the reference kernel epilogue (``chacha20_cuda.cu:36-39``).
    """
    low = state[..., 12]
    new_low = low + jnp.uint32(step)
    carry = (new_low < low).astype(U32)  # wrapped => carry
    new_high = state[..., 13] + carry
    return state.at[..., 12].set(new_low).at[..., 13].set(new_high)


@jax.jit
def chacha20(state, step):
    """Generate one keystream block per row and step counters.

    Returns (random_words [..., 16] uint32, new_state).
    """
    words = chacha20_block(state)
    return words, step_counter(state, step)


# "expand 32-byte k" constants, little-endian words.
NOTHING_UP_MY_SLEEVE = np.frombuffer(b"expand 32-byte k", dtype="<u4").copy()


def chacha20_block_oracle(state_words):
    """Pure-python RFC-7539 block function for golden tests.

    state_words: list of 16 ints (32-bit). Returns list of 16 ints.
    """
    M = 0xFFFFFFFF

    def rotl(x, n):
        return ((x << n) | (x >> (32 - n))) & M

    x = list(state_words)

    def qr(a, b, c, d):
        x[a] = (x[a] + x[b]) & M
        x[d] = rotl(x[d] ^ x[a], 16)
        x[c] = (x[c] + x[d]) & M
        x[b] = rotl(x[b] ^ x[c], 12)
        x[a] = (x[a] + x[b]) & M
        x[d] = rotl(x[d] ^ x[a], 8)
        x[c] = (x[c] + x[d]) & M
        x[b] = rotl(x[b] ^ x[c], 7)

    for _ in range(10):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    return [(a + b) & M for a, b in zip(x, state_words)]
