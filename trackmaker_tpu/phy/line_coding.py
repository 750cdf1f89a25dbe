"""Line codes as batched array programs.

The reference implements Manchester and 4B5B+NRZI as sequential Rust loops
(``src/phy/line_coding.rs``).  Here both are reshaped/vectorized:

* **Manchester** (line_coding.rs:74-123): bit 0 -> [+1,-1], 1 -> [-1,+1],
  each level repeated `samples_per_level` times; decode compares half-bit
  means.  Encode/decode are pure reshapes + reductions — embarrassingly
  parallel over bits and frames.

* **4B5B + NRZI** (line_coding.rs:202-293): nibbles map through the 4B5B
  table, then NRZI ('1' inverts the level, starting from +1 — the reference
  encoder takes ``&self`` so every call starts at +1.0, line_coding.rs:228).
  The sequential level carry becomes a parity-of-prefix-sum (cumsum), and
  the decoder's "skip near-zero averages" carry (line_coding.rs:265-269)
  becomes a last-valid-value ``associative_scan``.

All functions take the bit/sample axis last and vmap/broadcast over leading
batch axes.  Decoders return fixed-size outputs plus validity masks —
pad-and-mask instead of early exits (the reference *breaks* on an invalid
4B5B symbol, line_coding.rs:277-289; we mark everything from the first
invalid symbol onward as invalid, which is decision-equivalent).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from trackmaker_tpu.core.config import FOUR_B_FIVE_B, MANCHESTER, PhyConfig

# 4B5B code table (line_coding.rs:138-155).
FOURB_FIVEB_ENCODE = np.array(
    [0b11110, 0b01001, 0b10100, 0b10101, 0b01010, 0b01011, 0b01110, 0b01111,
     0b10010, 0b10011, 0b10110, 0b10111, 0b11010, 0b11011, 0b11100, 0b11101],
    dtype=np.int32,
)

# Inverse table: 5-bit symbol -> nibble, -1 for invalid symbols.
FOURB_FIVEB_DECODE = np.full(32, -1, dtype=np.int32)
for _nib, _sym in enumerate(FOURB_FIVEB_ENCODE):
    FOURB_FIVEB_DECODE[_sym] = _nib

# (table lookups below use jnp.asarray at the call site: module-level
# device puts would initialize the jax backend at import time, and
# package import must never touch devices — see core/bitops.py)

# Preamble bit pattern (line_coding.rs:13-21): (pattern_bytes-1) bytes of
# 0x33 (bits 00110011) followed by the sync byte 0x5A (bits 01011010).
SYNC_BYTE_BITS = (0, 1, 0, 1, 1, 0, 1, 0)
PATTERN_BYTE_BITS = (0, 0, 1, 1, 0, 0, 1, 1)


def preamble_bits(pattern_bytes: int) -> np.ndarray:
    bits = PATTERN_BYTE_BITS * (pattern_bytes - 1) + SYNC_BYTE_BITS
    return np.asarray(bits, dtype=np.uint8)


# ---------------------------------------------------------------------------
# Manchester
# ---------------------------------------------------------------------------


def manchester_encode(bits: jax.Array, samples_per_level: int) -> jax.Array:
    """uint8[..., N] -> f32[..., N*2*spl]."""
    b = bits.astype(jnp.float32)
    first = 1.0 - 2.0 * b   # bit 0 -> +1, bit 1 -> -1
    second = -first
    levels = jnp.stack([first, second], axis=-1)          # (..., N, 2)
    flat = levels.reshape(*levels.shape[:-2], levels.shape[-2] * 2)
    return jnp.repeat(flat, samples_per_level, axis=-1)


def manchester_decode(samples: jax.Array, samples_per_level: int) -> jax.Array:
    """f32[..., N*2*spl] -> uint8[..., N]; first-half>second-half => 0."""
    spl = samples_per_level
    n = samples.shape[-1] // (2 * spl)
    x = samples[..., : n * 2 * spl].reshape(*samples.shape[:-1], n, 2, spl)
    halves = jnp.mean(x, axis=-1)
    return (halves[..., 0] <= halves[..., 1]).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# 4B5B + NRZI
# ---------------------------------------------------------------------------


def fourb5b_code_bits(bits: jax.Array) -> jax.Array:
    """uint8[..., N] frame bits -> uint8[..., ceil(N/4)*5] coded bits."""
    n = bits.shape[-1]
    n_nib = -(-n // 4)
    pad = n_nib * 4 - n
    if pad:
        bits = jnp.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    nib_bits = bits.reshape(*bits.shape[:-1], n_nib, 4).astype(jnp.int32)
    weights = jnp.asarray([8, 4, 2, 1], dtype=jnp.int32)
    nibbles = jnp.sum(nib_bits * weights, axis=-1)
    symbols = jnp.asarray(FOURB_FIVEB_ENCODE)[nibbles]    # (..., n_nib)
    shifts = jnp.arange(4, -1, -1, dtype=jnp.int32)
    coded = (symbols[..., None] >> shifts) & 1             # (..., n_nib, 5)
    return coded.reshape(*coded.shape[:-2], n_nib * 5).astype(jnp.uint8)


def nrzi_encode_levels(coded_bits: jax.Array) -> jax.Array:
    """Coded bits -> NRZI levels ±1 (f32), starting level +1."""
    flips = jnp.cumsum(coded_bits.astype(jnp.int32), axis=-1)
    return jnp.where(flips % 2 == 0, 1.0, -1.0).astype(jnp.float32)


def fourb5b_encode(bits: jax.Array, samples_per_level: int) -> jax.Array:
    """uint8[..., N] -> f32[..., ceil(N/4)*5*spl]."""
    coded = fourb5b_code_bits(bits)
    levels = nrzi_encode_levels(coded)
    return jnp.repeat(levels, samples_per_level, axis=-1)


def _last_valid_scan(avg: jax.Array, valid: jax.Array) -> jax.Array:
    """For each position i: the last `avg[j]` with j < i and valid[j],
    else +1.0 (the NRZI initial level).  Associative-scan formulation of
    the reference's sequential ``last_avg`` carry (line_coding.rs:251-269).
    """
    init_shape = (*avg.shape[:-1], 1)
    vals = jnp.concatenate([jnp.ones(init_shape, avg.dtype), avg[..., :-1]], -1)
    ok = jnp.concatenate(
        [jnp.ones(init_shape, bool), valid[..., :-1]], -1)

    def combine(a, b):
        av, ao = a
        bv, bo = b
        return jnp.where(bo, bv, av), ao | bo

    out_vals, _ = jax.lax.associative_scan(combine, (vals, ok), axis=-1)
    return out_vals


def fourb5b_decode(
    samples: jax.Array, samples_per_level: int, eps: float = 1e-6
) -> tuple[jax.Array, jax.Array]:
    """f32[..., M] -> (bits uint8[..., n_sym5*4], bit_valid bool[..., same]).

    n_sym5 = (M // spl) // 5 complete 5-bit symbols.  `bit_valid` is True up
    to (and excluding) the first invalid 4B5B symbol — mirroring the
    reference's decode-and-break behavior.
    """
    spl = samples_per_level
    n_lvl = samples.shape[-1] // spl
    n_sym = n_lvl // 5
    n_lvl = n_sym * 5
    x = samples[..., : n_lvl * spl].reshape(*samples.shape[:-1], n_lvl, spl)
    avg = jnp.mean(x, axis=-1)                            # (..., n_lvl)

    valid = jnp.abs(avg) > eps
    prev = _last_valid_scan(avg, valid)
    coded = (prev * avg < 0.0).astype(jnp.int32)          # transition -> 1

    sym_bits = coded.reshape(*coded.shape[:-1], n_sym, 5)
    weights = jnp.asarray([16, 8, 4, 2, 1], dtype=jnp.int32)
    symbols = jnp.sum(sym_bits * weights, axis=-1)        # (..., n_sym)
    nibbles = jnp.asarray(FOURB_FIVEB_DECODE)[symbols]    # -1 if invalid
    sym_ok = nibbles >= 0
    # valid-prefix: symbol i usable only if all symbols <= i are valid
    prefix_ok = jnp.cumprod(sym_ok.astype(jnp.int32), axis=-1).astype(bool)

    nib = jnp.maximum(nibbles, 0)
    shifts = jnp.arange(3, -1, -1, dtype=jnp.int32)
    bits = ((nib[..., None] >> shifts) & 1).astype(jnp.uint8)
    bits = bits.reshape(*bits.shape[:-2], n_sym * 4)
    bit_ok = jnp.repeat(prefix_ok, 4, axis=-1)
    return bits, bit_ok


def fourb5b_decode_opt(
    samples: jax.Array, samples_per_level: int, eps: float = 1e-6
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Optimistic 4B5B decode: assumes no near-zero level averages, so
    the reference's last-valid-average carry (line_coding.rs:265-269)
    degenerates to the immediate predecessor — pure elementwise ops, no
    associative scan.  Returns ``(bits, bit_ok, near_zero_levels)``;
    callers must treat any near-zero level *inside the decoded frame* as
    non-conformant and re-decode with :func:`fourb5b_decode` (the carry
    could change the bits without producing an invalid symbol).
    """
    spl = samples_per_level
    n_lvl = samples.shape[-1] // spl
    n_sym = n_lvl // 5
    n_lvl = n_sym * 5
    x = samples[..., : n_lvl * spl].reshape(*samples.shape[:-1], n_lvl, spl)
    avg = jnp.mean(x, axis=-1)                            # (..., n_lvl)
    near0 = jnp.abs(avg) <= eps

    init_shape = (*avg.shape[:-1], 1)
    prev = jnp.concatenate(
        [jnp.ones(init_shape, avg.dtype), avg[..., :-1]], -1)
    coded = (prev * avg < 0.0).astype(jnp.int32)

    sym_bits = coded.reshape(*coded.shape[:-1], n_sym, 5)
    weights = jnp.asarray([16, 8, 4, 2, 1], dtype=jnp.int32)
    symbols = jnp.sum(sym_bits * weights, axis=-1)
    nibbles = jnp.asarray(FOURB_FIVEB_DECODE)[symbols]
    sym_ok = nibbles >= 0
    prefix_ok = jnp.cumprod(sym_ok.astype(jnp.int32), axis=-1).astype(bool)

    nib = jnp.maximum(nibbles, 0)
    shifts = jnp.arange(3, -1, -1, dtype=jnp.int32)
    bits = ((nib[..., None] >> shifts) & 1).astype(jnp.uint8)
    bits = bits.reshape(*bits.shape[:-2], n_sym * 4)
    bit_ok = jnp.repeat(prefix_ok, 4, axis=-1)
    return bits, bit_ok, near0


# ---------------------------------------------------------------------------
# Polymorphic dispatch + preamble
# ---------------------------------------------------------------------------


def encode(cfg: PhyConfig, bits: jax.Array) -> jax.Array:
    if cfg.line_coding == MANCHESTER:
        return manchester_encode(bits, cfg.samples_per_level)
    if cfg.line_coding == FOUR_B_FIVE_B:
        return fourb5b_encode(bits, cfg.samples_per_level)
    raise ValueError(cfg.line_coding)


def decode(cfg: PhyConfig, samples: jax.Array) -> tuple[jax.Array, jax.Array]:
    """-> (bits, bit_valid).  Manchester bits are always valid."""
    if cfg.line_coding == MANCHESTER:
        bits = manchester_decode(samples, cfg.samples_per_level)
        return bits, jnp.ones(bits.shape, bool)
    if cfg.line_coding == FOUR_B_FIVE_B:
        return fourb5b_decode(samples, cfg.samples_per_level)
    raise ValueError(cfg.line_coding)


import functools


@functools.lru_cache(maxsize=None)
def preamble_waveform(cfg: PhyConfig) -> np.ndarray:
    """Line-coded preamble samples — a small host-side (NumPy) constant so
    it can be baked into jitted programs without tracing."""
    bits = preamble_bits(cfg.preamble_pattern_bytes).astype(np.int64)
    spl = cfg.samples_per_level
    if cfg.line_coding == MANCHESTER:
        first = 1.0 - 2.0 * bits
        levels = np.stack([first, -first], axis=-1).reshape(-1)
        return np.repeat(levels, spl).astype(np.float32)
    if cfg.line_coding == FOUR_B_FIVE_B:
        nibbles = bits.reshape(-1, 4) @ np.asarray([8, 4, 2, 1])
        symbols = FOURB_FIVEB_ENCODE[nibbles]
        coded = ((symbols[:, None] >> np.arange(4, -1, -1)) & 1).reshape(-1)
        levels = np.where(np.cumsum(coded) % 2 == 0, 1.0, -1.0)
        return np.repeat(levels, spl).astype(np.float32)
    raise ValueError(cfg.line_coding)
