"""Rate-1/2 K=7 convolutional code + Viterbi decoder, vectorized.

The industry-standard (133, 171)_8 code.  Encoding is two XOR-of-shifts
streams; Viterbi decoding is a ``lax.scan`` over time with the full
64-state path-metric vector updated by vectorized add-compare-select
(all butterflies at once), then a backward traceback scan over the
stored decision bits.  Supports hard decisions (Hamming branch metrics)
and soft decisions (negative-correlation metrics on ±1 LLR-ish inputs).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

K = 7
NSTATES = 64
G0 = 0o133
G1 = 0o171


def _parity(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x ^= x >> 4
    x ^= x >> 2
    x ^= x >> 1
    return (x & 1).astype(np.uint8)


# Precomputed transition tables: for state s (6 bits of history,
# newest in the MSB) and input bit b, the register is (b << 6) | s.
_REG = (np.arange(2)[:, None] << 6) | np.arange(NSTATES)[None, :]
_OUT0 = _parity(_REG & G0)      # (2, 64) first output bit
_OUT1 = _parity(_REG & G1)      # (2, 64) second output bit
_NEXT = (_REG >> 1).astype(np.int32)   # (2, 64) next state
# predecessor view: state s has two predecessors p0/p1 with input bit
# = s >> 5 (the newest history bit of s)
_PRED = np.zeros((NSTATES, 2), np.int32)
_PBIT = np.zeros((NSTATES,), np.int32)
_POUT = np.zeros((NSTATES, 2, 2), np.uint8)  # [s, which_pred, stream]
for _b in range(2):
    for _s in range(NSTATES):
        ns = _NEXT[_b, _s]
        idx = _s & 1  # low bit of the predecessor distinguishes the two
        _PRED[ns, idx] = _s
        _PBIT[ns] = _b
        _POUT[ns, idx, 0] = _OUT0[_b, _s]
        _POUT[ns, idx, 1] = _OUT1[_b, _s]


# Rate-3/4 puncturing of the rate-1/2 mother code: per 3 input steps
# (6 coded bits, [c0 c1] pairs) transmit [11, 10, 01] — the standard
# puncture pattern for (133, 171), free distance 5.  Erasure positions
# re-enter the Viterbi branch metrics as soft 0 (no preference), so the
# decoder below needs no changes.
_PUNCT_34 = np.array([1, 1, 1, 0, 0, 1], dtype=bool)


@functools.lru_cache(maxsize=256)
def _punct_idx(n_coded: int) -> np.ndarray:
    """Indices of transmitted positions in an n_coded-bit mother block."""
    reps = -(-n_coded // 6)
    mask = np.tile(_PUNCT_34, reps)[:n_coded]
    return np.nonzero(mask)[0]


def punctured_len_34(n_coded: int) -> int:
    return len(_punct_idx(n_coded))


def puncture_34(coded: jax.Array) -> jax.Array:
    """[..., n_coded] rate-1/2 output -> [..., ~2n/3] transmitted bits."""
    idx = _punct_idx(coded.shape[-1])
    return coded[..., idx]


def depuncture_34(soft: jax.Array, n_coded: int) -> jax.Array:
    """Transmitted soft values -> [..., n_coded] with 0.0 erasures."""
    idx = _punct_idx(n_coded)
    out = jnp.zeros((*soft.shape[:-1], n_coded), soft.dtype)
    return out.at[..., idx].set(soft)


@functools.lru_cache(maxsize=128)
def block_interleaver(m: int) -> np.ndarray:
    """Deterministic pseudorandom interleaver for an m-bit coded block.

    Both ends derive it from the block length alone (no negotiation).
    Channel impairments are bursty in wire position (contiguous weak
    subcarriers, impulse noise spanning several line-code levels); the
    permutation spreads each burst across the block so it lands within
    the Viterbi decoder's ~K-bit correction span."""
    return np.random.default_rng(0x1EAF ^ m).permutation(m)


def conv_encode(bits: jax.Array) -> jax.Array:
    """uint8[N] -> uint8[2*(N+K-1)] (zero-terminated / flushed)."""
    bits = jnp.concatenate(
        [bits.astype(jnp.uint8), jnp.zeros(K - 1, jnp.uint8)])
    n = bits.shape[0]
    taps0 = [i for i in range(K) if (G0 >> (K - 1 - i)) & 1]
    taps1 = [i for i in range(K) if (G1 >> (K - 1 - i)) & 1]
    # bits padded with leading zeros (shift register starts cleared);
    # output at time t looks at bits[t], bits[t-1], ..., bits[t-6]
    padded = jnp.concatenate([jnp.zeros(K - 1, jnp.uint8), bits])

    def stream(taps):
        acc = jnp.zeros(n, jnp.uint8)
        for i in taps:
            acc = acc ^ padded[K - 1 - i: K - 1 - i + n]
        return acc

    c0, c1 = stream(taps0), stream(taps1)
    return jnp.stack([c0, c1], axis=-1).reshape(-1)


# Trellis steps fused per scan iteration.  Each radix-1 butterfly ACS
# step is a handful of tiny ops, so per-iteration overhead dominates;
# the butterfly generalizes over k steps (pred^k(s) = 2^k (s mod 2^(6-k)) + j for
# j in [0, 2^k)), so k steps fuse into ONE gather-free expand +
# max/argmax with k-times fewer scan iterations and k-times fewer
# traceback steps.  Decisions are bit-identical to radix 1: path
# values keep the sequential f32 add order ((m + bm1) + bm2)..., and
# the flattened argmax's smallest-index tie rule IS the sequential
# rule (final-step choice breaks ties first — axis order (c_k .. c_1);
# tests/test_convcode.py pins equality).  Env-tunable for A/B runs.
import os as _os

VITERBI_RADIX = int(_os.environ.get("TM_VITERBI_RADIX", "4"))
assert VITERBI_RADIX in (1, 2, 4, 8)

# Scan unroll in fused-block units: max(1, 8 // k) by default.
# Env-tunable for A/B runs; decisions are unroll-invariant.  Resolved
# OUTSIDE the jit boundary (viterbi_decode) so in-process flips
# retrace instead of hitting the cache.
VITERBI_UNROLL = int(_os.environ.get("TM_VITERBI_UNROLL", "0"))  # 0=auto


def viterbi_decode(received: jax.Array, n_bits: int,
                   soft: bool = False, radix: int | None = None
                   ) -> jax.Array:
    """Decode 2*(n_bits+K-1) received values -> uint8[n_bits].

    `received`: hard bits (0/1) or soft values in [-1, +1] where +1
    means "coded bit 1" (set soft=True).  `radix` (default: the module
    flag VITERBI_RADIX) fuses that many trellis steps per scan
    iteration — decision-identical for all values.  The default is
    resolved OUTSIDE the jit boundary so in-process flag flips (A/B
    tools, tests) retrace instead of hitting the radix=None cache."""
    k = VITERBI_RADIX if radix is None else radix
    unroll = VITERBI_UNROLL if VITERBI_UNROLL > 0 else max(1, 8 // k)
    return _viterbi_jit(received, n_bits, soft, k, unroll)


@functools.partial(jax.jit,
                   static_argnames=("n_bits", "soft", "radix", "unroll"))
def _viterbi_jit(received: jax.Array, n_bits: int,
                 soft: bool, radix: int, unroll: int = 0) -> jax.Array:
    k = radix
    n_steps = n_bits + K - 1
    r = received.reshape(n_steps, 2).astype(jnp.float32)
    if not soft:
        r = 2.0 * r - 1.0  # map to ±1

    pout = jnp.asarray(_POUT, jnp.float32) * 2.0 - 1.0  # (64, 2, 2) ±1

    big = jnp.float32(1e9)
    init = jnp.full((NSTATES,), -big).at[0].set(0.0)

    # GATHER-FREE add-compare-select: the shift-register trellis is a
    # butterfly — state s's two predecessors are 2(s % 32) and
    # 2(s % 32) + 1 (verified against _PRED), so metrics[_PRED] is
    # jnp.tile(m.reshape(32, 2), (2, 1)) — no metrics[pred] gather.
    def expand(acc, rt):
        """acc (64, *prev_choices) path values at the current level ->
        (64, 2, *prev_choices) after one more trellis step: new axis 1
        is this step's predecessor choice (sequential f32 add order)."""
        bm = pout[:, :, 0] * rt[0] + pout[:, :, 1] * rt[1]   # (64, 2)
        tail = acc.shape[1:]
        pred = jnp.tile(acc.reshape(32, 2, *tail),
                        (2,) + (1,) * (len(tail) + 1))       # (64,2,*t)
        return pred + bm.reshape(NSTATES, 2, *([1] * len(tail)))

    def step_block(metrics, rb):
        """Fused k-step ACS; rb is (k, 2).  Choice j flattens the
        choice axes (c_k, ..., c_1) — MSB = the block-final step."""
        acc = metrics
        for i in range(k):
            acc = expand(acc, rb[i])
        flat = acc.reshape(NSTATES, 1 << k)
        new = jnp.max(flat, axis=1)
        choice = jnp.argmax(flat, axis=1).astype(jnp.int32)
        return new, choice

    q = n_steps // k
    rem = n_steps - q * k
    u = unroll if unroll > 0 else max(1, 8 // k)
    final, choices = jax.lax.scan(
        step_block, init, r[: q * k].reshape(q, k, 2),
        unroll=min(q, u))                                    # (q, 64)
    ch_rem = []
    for i in range(rem):  # static tail, same fused form at k=1
        final, ch = _single(final, r[q * k + i])
        ch_rem.append(ch)

    # traceback from state 0 (flushed); choice lookup via a one-hot
    # sum (a per-step dynamic index is a gather under vmap), and the
    # predecessor/input-bit tables collapse to arithmetic:
    # _PRED[s, c] = 2 (s % 32) + c, _PBIT[s] = s >> 5.
    sts = jnp.arange(NSTATES)

    def undo(state, c):
        """One reverse trellis step: emitted input bit + predecessor."""
        return 2 * (state % 32) + c, (state >> 5).astype(jnp.uint8)

    state = jnp.int32(0)
    bits_tail = []
    for i in range(rem - 1, -1, -1):   # undo the static tail first
        c = jnp.sum(jnp.where(sts == state, ch_rem[i], 0))
        state, bit = undo(state, c)
        bits_tail.append(bit)
    bits_tail = bits_tail[::-1]

    def back(state, ch_t):
        j = jnp.sum(jnp.where(sts == state, ch_t, 0))
        bits = []
        s = state
        for i in range(k):             # undo steps k..1 of the block
            c = (j >> (k - 1 - i)) & 1
            s, bit = undo(s, c)
            bits.append(bit)
        return s, jnp.stack(bits[::-1])   # ascending time within block

    _, blk_bits = jax.lax.scan(back, state, choices,
                               reverse=True, unroll=min(q, u))
    bits = blk_bits.reshape(q * k)
    if bits_tail:
        bits = jnp.concatenate([bits, jnp.stack(bits_tail)])
    return bits.astype(jnp.uint8)[:n_bits]


def _single(metrics, rt):
    """Radix-1 ACS for the static remainder tail (same math/ties as
    step_block at k=1; choice stored as i32 0/1)."""
    pout = jnp.asarray(_POUT, jnp.float32) * 2.0 - 1.0
    bm = pout[:, :, 0] * rt[0] + pout[:, :, 1] * rt[1]
    cand = jnp.tile(metrics.reshape(32, 2), (2, 1)) + bm
    new = jnp.max(cand, axis=1)
    choice = jnp.argmax(cand, axis=1).astype(jnp.int32)
    return new, choice
