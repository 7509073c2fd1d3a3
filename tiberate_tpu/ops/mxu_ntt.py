"""Matmul-form (4-step) negacyclic NTT as int8 limb contractions.

An alternative to the per-stage butterfly NTT: where the reference
launches one CUDA butterfly kernel per stage (``csrc/cuda/ntt_cuda.cu:89-100``)
and ``ops/ntt.py`` runs the same dataflow as elementwise reshape-arithmetic,
this module reshapes N = N1 x N2 and evaluates the transform as two *modular
matrix multiplications* by constant twiddle matrices with an elementwise
twiddle fold between them — moving the O(N logN) butterfly arithmetic into
int8 ``dot_general``s with int32 accumulation (the tensor-core idea of GPU
NTTs such as TensorFHE) and leaving only O(N) elementwise epilogues.

Math (verified bit-exact against ``ops/ntt.py``; n = N2*n1 + n2, output
index j = r1*N2 + r2, br = bit-reversal):

    W1[r1, n1] = psi^{N2 * n1 * (2*br(r1) + 1)}
    T [r1, n2] = psi^{n2 * (2*br(r1) + 1)}
    W2[n2, r2] = psi^{2 * N1 * n2 * br(r2)}
    ntt(x)  = ((W1 @ X) * T) @ W2        (== radix-2 CT output, same order)
    intt(y) = transposed pipeline with psi^-1 tables and an N^-1 fold:
              A^T = ((W2i^T @ Y^T) * Ti^T) @ W1i^T — the same
              (left-matmul, twiddle, right-matmul) code path run on the
              transposed matrix view with swapped (N1, N2) roles.

Exact modular matmuls on int8 operands:

* operands split into L 7-bit limbs; L chosen *per RNS channel group* from
  the prime width (6 limbs for ~40-bit scale primes, 9 for ~60-bit
  message/special primes) — roughly halving limb-pair products vs a
  uniform 62-bit split,
* constant matrices are stored as **block-Toeplitz limb matrices**
  (``Wtoe[k-block, j-block] = W_limb[k-j]``) so a single int8
  ``dot_general`` emits the limb-convolution diagonals
  ``S_k = sum_{i+j=k} W_i @ X_j`` directly (int32-exact, < 2^27),
* diagonals recombine in ceil((2L-1)/6) int64 groups
  ``G_g = sum_{k in [6g, 6g+6)} S_k << 7(k-6g)`` (each < 2^61) folded by
  one Montgomery multiply per group; the step-A fold constants carry the
  mid twiddle as full ``T * 2^{42g} * R mod q`` planes (the twiddle
  multiply costs nothing beyond the recombination REDCs), and the step-B
  fold columns carry the op-variant constant (R for enter_ntt, N^-1 for
  intt, N^-1 R^-1 for intt_exit) — ONE table set serves all variants.

Outputs are lazy ``[0, 2q)`` like the radix-2 kernels; residues are
bit-identical after ``reduce_2q`` (lazy representatives may differ).
Signed inputs are NOT supported — the engine routes signed key-material
transforms through the radix-2 path.
"""

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from tiberate_tpu.ops import mont
from tiberate_tpu.ops import ntt as ntt_ops
from tiberate_tpu.ops.mont import ModPack

LIMB_BITS = 7
LIMB_MASK = (1 << LIMB_BITS) - 1
GROUP_K = 6                        # diagonals per recombination group
GROUP_BITS = LIMB_BITS * GROUP_K   # 42


def limbs_for_bits(nbits: int) -> int:
    return -(-nbits // LIMB_BITS)


def _br_vec(n: int, nb: int) -> np.ndarray:
    """Bit-reversal permutation vector of length n = 2^nb."""
    out = np.zeros(n, dtype=np.int64)
    for i in range(n):
        out[i] = int(bin(i + n)[3:][::-1], 2) if nb else 0
    return out


def _toeplitz_limbs(W_u64: np.ndarray, L: int) -> np.ndarray:
    """uint64 [K1, K2] -> int8 block-Toeplitz [(2L-1)*K1, L*K2].

    Row-block k, col-block j holds limb (k - j), so ``Wtoe @ stack_j(X_j)``
    emits limb-convolution diagonals S_k stacked along output rows.
    """
    K1, K2 = W_u64.shape
    out = np.zeros(((2 * L - 1) * K1, L * K2), dtype=np.int8)
    limb = [
        ((W_u64 >> np.uint64(LIMB_BITS * i)) & np.uint64(LIMB_MASK))
        .astype(np.int8)
        for i in range(L)
    ]
    for k in range(2 * L - 1):
        for j in range(L):
            i = k - j
            if 0 <= i < L:
                out[k * K1 : (k + 1) * K1, j * K2 : (j + 1) * K2] = limb[i]
    return out


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class GroupTables:
    """One channel group: contiguous channels sharing a limb count L."""

    L: int                  # static
    c0: int                 # static: first channel within this view
    c1: int                 # static
    W1toe: jax.Array        # [Cg, (2L-1)*P1, L*P1] int8
    W2toe: jax.Array        # [Cg, L*P2, (2L-1)*P2] int8
    TA: tuple               # per group g: [Cg, P1, P2] int64 fold planes
    pack: ModPack

    def tree_flatten(self):
        return (self.W1toe, self.W2toe, self.TA, self.pack), (
            self.L, self.c0, self.c1,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        L, c0, c1 = aux
        return cls(L, c0, c1, *children)

    @property
    def n_groups(self):
        return -(-(2 * self.L - 1) // GROUP_K)


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class MxuNttTables:
    """One direction's tables (forward or inverse) over a channel range.

    P1/P2 are the *pipeline* matrix sizes: (N1, N2) for the forward
    direction, (N2, N1) for the inverse (transposed pipeline).  ``swap``
    marks the inverse direction (input/output matrix views transposed).
    ``scalars``: variant -> tuple of [C, 1] int64 step-B fold columns.
    """

    groups: tuple
    scalars: dict
    P1: int
    P2: int
    swap: bool

    def tree_flatten(self):
        names = tuple(sorted(self.scalars))
        return (
            (self.groups, tuple(self.scalars[k] for k in names)),
            (names, self.P1, self.P2, self.swap),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        names, P1, P2, swap = aux
        groups, svals = children
        return cls(groups, dict(zip(names, svals)), P1, P2, swap)

    def __getitem__(self, sl: slice):
        """Channel slice (level views)."""
        start = sl.start or 0
        stop = sl.stop
        groups = []
        for g in self.groups:
            lo = max(g.c0, start)
            hi = g.c1 if stop is None else min(g.c1, stop)
            if hi <= lo:
                continue
            a, b = lo - g.c0, hi - g.c0
            groups.append(
                GroupTables(
                    L=g.L, c0=lo - start, c1=hi - start,
                    W1toe=g.W1toe[a:b], W2toe=g.W2toe[a:b],
                    TA=tuple(t[a:b] for t in g.TA),
                    pack=g.pack[a:b],
                )
            )
        scalars = {
            k: tuple(col[start:stop] for col in cols)
            for k, cols in self.scalars.items()
        }
        return MxuNttTables(tuple(groups), scalars, self.P1, self.P2,
                            self.swap)


def _power_series(psi: int, q: int, n: int, scale: int = 1) -> np.ndarray:
    """uint64 [n]: scale * psi^e mod q for e in [0, n)."""
    out = np.empty(n, dtype=np.uint64)
    v = scale % q
    for e in range(n):
        out[e] = v
        v = v * psi % q
    return out


def build_tables(q, logN: int, *, logN1: int | None = None,
                 R_bits: int = 62, mont_R_bits: int | None = None,
                 inverse: bool = False) -> MxuNttTables:
    """Build one direction's tables for the prime list ``q`` (python ints).

    Twiddle convention matches ``ops/ntt.py::make_psi_tables`` (same
    primitive-root search), so outputs are residue-identical to the
    radix-2 kernels.

    ``R_bits`` is the *internal* recombination-REDC radix (62: the fold
    REDCs always run in int64); ``mont_R_bits`` is the engine's Montgomery
    domain (62 or 30) that the enter/exit variant constants refer to.
    """
    N = 1 << logN
    if logN1 is None:
        logN1 = logN // 2
    logN2 = logN - logN1
    N1, N2 = 1 << logN1, 1 << logN2
    R = 1 << R_bits
    R_mont = 1 << (mont_R_bits if mont_R_bits is not None else R_bits)
    _2N = 2 * N
    q = [int(x) for x in q]

    br1 = _br_vec(N1, logN1)
    br2 = _br_vec(N2, logN2)
    n1v = np.arange(N1, dtype=np.int64)
    n2v = np.arange(N2, dtype=np.int64)
    # exponent index matrices (mod 2N)
    eW1 = (N2 * np.outer(n1v, 2 * br1 + 1).T) % _2N        # [r1, n1]
    eT = (np.outer(2 * br1 + 1, n2v)) % _2N                # [r1, n2]
    eW2 = (2 * N1 * np.outer(n2v, br2)) % _2N              # [n2, r2]

    # channel groups by limb count (lazy operands < 2^{bitlen+1})
    Ls = [limbs_for_bits(qi.bit_length() + 1) for qi in q]
    bounds = [0]
    for c in range(1, len(q)):
        if Ls[c] != Ls[c - 1]:
            bounds.append(c)
    bounds.append(len(q))

    groups = []
    for c0, c1 in zip(bounds[:-1], bounds[1:]):
        L = Ls[c0]
        n_groups = -(-(2 * L - 1) // GROUP_K)
        W1_t, W2_t, TA_t = [], [], [[] for _ in range(n_groups)]
        for qi in q[c0:c1]:
            psi = ntt_ops.primitive_root_2N(qi, N)
            if inverse:
                psi = pow(psi, -1, qi)
            ps = _power_series(psi, qi, _2N)
            W1 = ps[eW1]          # [r1, n1] uint64
            W2 = ps[eW2]          # [n2, r2]
            if inverse:
                # Transposed pipeline (see module docstring):
                #   left matrix  = W2i^T = psi^-1-built W2 as-is [n2, r2]
                #   right matrix = W1i^T = psi^-1-built W1 as-is [r1, n1]
                #   twiddle      = Ti^T  [n2, r1]
                left, right = W2, W1
                eTA = eT.T        # [n2, r1]
            else:
                left, right = W1, W2
                eTA = eT          # [r1, n2]
            W1_t.append(_toeplitz_limbs(left, L))
            # Right operand Toeplitz: row-block j, col-block k = limb_{k-j}
            # == toeplitz(right^T)^T.
            W2_t.append(_toeplitz_limbs(right.T.copy(), L).T.copy())
            for g in range(n_groups):
                cg = pow(2, GROUP_BITS * g, qi) * R % qi
                ps_g = _power_series(psi, qi, _2N, scale=cg)
                TA_t[g].append(ps_g[eTA].astype(np.int64))

        groups.append(
            GroupTables(
                L=L, c0=c0, c1=c1,
                W1toe=jnp.array(np.stack(W1_t)),
                W2toe=jnp.array(np.stack(W2_t)),
                TA=tuple(jnp.array(np.stack(t)) for t in TA_t),
                pack=ModPack.from_q(q[c0:c1]),
            )
        )

    def fold_cols(c_list):
        n_groups_max = max(g.n_groups for g in groups)
        return tuple(
            jnp.array(
                np.array(
                    [
                        pow(2, GROUP_BITS * g, qi) * ci * R % qi
                        for qi, ci in zip(q, c_list)
                    ],
                    dtype=np.int64,
                ).reshape(-1, 1)
            )
            for g in range(n_groups_max)
        )

    if inverse:
        Ninv = [pow(N, -1, qi) for qi in q]
        NinvRinv = [pow(N * R_mont, -1, qi) for qi in q]
        scalars = {"mont": fold_cols(Ninv), "exit": fold_cols(NinvRinv)}
        P1, P2 = N2, N1
    else:
        scalars = {
            "plain": fold_cols([1] * len(q)),
            "enter": fold_cols([R_mont % qi for qi in q]),
        }
        P1, P2 = N1, N2
    return MxuNttTables(tuple(groups), scalars, P1, P2, inverse)


# ----------------------------------------------------------------------
# The transform.
# ----------------------------------------------------------------------


def _limb_stack(x, L, axis):
    parts = [
        ((x >> (LIMB_BITS * j)) & LIMB_MASK).astype(jnp.int8)
        for j in range(L)
    ]
    return jnp.concatenate(parts, axis=axis)


def _recombine(S, L, K, folds, pack, axis):
    """int32 diagonal blocks -> folded int64 value in [0, 2q).

    S: diagonals stacked along ``axis`` in (2L-1) blocks of size K;
    folds: per-group arrays broadcastable against the [..., K, M] output.
    """
    nd = 2 * L - 1
    n_groups = -(-nd // GROUP_K)
    out = None
    for g in range(n_groups):
        k0 = g * GROUP_K
        k1 = min(k0 + GROUP_K, nd)
        acc = None
        for k in range(k0, k1):
            Sk = jax.lax.slice_in_dim(S, k * K, (k + 1) * K, axis=axis)
            term = Sk.astype(jnp.int64) << (LIMB_BITS * (k - k0))
            acc = term if acc is None else acc + term
        folded = mont.mont_mult_raw(
            acc, folds[g], pack.ql, pack.qh, pack.kl, pack.kh
        )
        if out is None:
            out = folded
        else:
            s = out + folded
            out = jnp.where(s < pack._2q, s, s - pack._2q)
    return out


def _transform_group(x, g: GroupTables, fold_cols, P1, P2):
    """x: [*lead, Cg, P1, P2] int64 in [0, 2^62) -> same shape, [0, 2q)."""
    L = g.L
    lead = x.shape[:-3]
    nb = len(lead)
    ex1 = (...,) + (None,) * (1 + nb)   # [Cg,1] -> rank 3+nb broadcast

    # step A: diagonals = W1toe @ limb-rows(x)
    Xs = _limb_stack(x, L, axis=-2)             # [*lead, Cg, L*P1, P2]
    dnA = (((2,), (nb + 1,)), ((0,), (nb,)))
    S = jax.lax.dot_general(
        g.W1toe, Xs, dnA, preferred_element_type=jnp.int32
    )                                            # [Cg, (2L-1)P1, *lead, P2]
    packA = mont.ModPack(
        ql=g.pack.ql[ex1], qh=g.pack.qh[ex1], kl=g.pack.kl[ex1],
        kh=g.pack.kh[ex1], _2q=g.pack._2q[ex1],
    )
    if nb:
        idx = (slice(None), slice(None)) + (None,) * nb + (slice(None),)
        TA = tuple(t[idx] for t in g.TA)
    else:
        TA = g.TA
    U = _recombine(S, L, P1, TA, packA, axis=1)
    # U: [Cg, P1, *lead, P2] in [0, 2q)

    # step B: diagonals = limb-cols(U) @ W2toe
    Us = _limb_stack(U, L, axis=-1)             # [Cg, P1, *lead, L*P2]
    dnB = (((2 + nb,), (1,)), ((0,), (0,)))
    S2 = jax.lax.dot_general(
        Us, g.W2toe, dnB, preferred_element_type=jnp.int32
    )                                            # [Cg, P1, *lead, (2L-1)P2]
    foldB = tuple(c[ex1] for c in fold_cols)
    out = _recombine(S2, L, P2, foldB, packA, axis=-1)
    # [Cg, P1, *lead, P2] -> [*lead, Cg, P1, P2]
    if nb:
        out = jnp.moveaxis(out, tuple(range(2, 2 + nb)), tuple(range(nb)))
    return out


def _apply(x, tables: MxuNttTables, variant: str):
    """x: [..., C, N] int64 lazy [0, 2q) -> [..., C, N] lazy [0, 2q)."""
    P1, P2 = tables.P1, tables.P2
    lead = x.shape[:-2]
    C = x.shape[-2]
    if tables.swap:
        xm = x.reshape(*lead, C, P2, P1)
        xm = jnp.swapaxes(xm, -1, -2)
    else:
        xm = x.reshape(*lead, C, P1, P2)
    outs = []
    for g in tables.groups:
        fold = tuple(
            col[g.c0 : g.c1] for col in tables.scalars[variant]
        )[: g.n_groups]
        outs.append(
            _transform_group(xm[..., g.c0 : g.c1, :, :], g, fold, P1, P2)
        )
    out = outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=-3)
    if tables.swap:
        out = jnp.swapaxes(out, -1, -2)
    # recombination runs in int64; 30-bit-mode outputs (< 2q < 2^29) cast
    # back to the engine's int32 storage
    return out.reshape(*lead, C, P1 * P2).astype(x.dtype)


def ntt(x, fwd: MxuNttTables, enter: bool = False):
    """Forward negacyclic NTT (domain-preserving, like ops/ntt.ntt).

    ``enter=True`` folds mont_enter (x -> x*R), like enter_ntt.
    """
    return _apply(x, fwd, "enter" if enter else "plain")


def intt(x, inv: MxuNttTables, epilogue: str = "mont"):
    """Inverse NTT.  epilogue "mont" keeps the R factor (like ops/ntt.intt);
    "exit" folds R^-1 (like intt_exit)."""
    return _apply(x, inv, epilogue)
