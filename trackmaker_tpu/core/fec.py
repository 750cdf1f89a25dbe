"""Forward error correction, vectorized.

The reference has no FEC (its report lists 5-15% frame loss and leans on
ARQ).  Batched array FEC is nearly free on the device and moves the OFDM QPSK
cliff several dB:

* **Hamming(7,4)** with single-error correction: encode is a bit-matrix
  product over GF(2); decode computes the 3-bit syndrome for every
  codeword in parallel and flips the indicated bit.
* **Block interleaver**: spreads burst errors (narrowband fades hit
  adjacent subcarriers) across codewords; plain transpose.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

# G: 4 data bits -> 7 coded bits [d1 d2 d3 d4 p1 p2 p3]
_G = np.asarray([
    [1, 0, 0, 0, 1, 1, 0],
    [0, 1, 0, 0, 1, 0, 1],
    [0, 0, 1, 0, 0, 1, 1],
    [0, 0, 0, 1, 1, 1, 1],
], dtype=np.uint8)

# H: parity check (3 x 7); syndrome = H c^T
_H = np.asarray([
    [1, 1, 0, 1, 1, 0, 0],
    [1, 0, 1, 1, 0, 1, 0],
    [0, 1, 1, 1, 0, 0, 1],
], dtype=np.uint8)

# syndrome value (as integer b2b1b0 from H rows) -> bit position to flip,
# 7 = no flip
_SYN2BIT = np.full(8, 7, dtype=np.int32)
for _i in range(7):
    _s = (_H[0, _i] << 2) | (_H[1, _i] << 1) | _H[2, _i]
    _SYN2BIT[_s] = _i


def hamming74_encode(bits: jax.Array) -> jax.Array:
    """uint8[..., 4k] -> uint8[..., 7k] (pad input to a multiple of 4)."""
    n = bits.shape[-1]
    pad = (-n) % 4
    if pad:
        bits = jnp.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    nib = bits.reshape(*bits.shape[:-1], -1, 4).astype(jnp.uint8)
    code = (nib @ jnp.asarray(_G)) % 2
    return code.reshape(*code.shape[:-2], -1).astype(jnp.uint8)


def hamming74_decode(coded: jax.Array) -> jax.Array:
    """uint8[..., 7k] -> uint8[..., 4k], correcting one bit/codeword."""
    n = coded.shape[-1]
    assert n % 7 == 0
    cw = coded.reshape(*coded.shape[:-1], -1, 7).astype(jnp.uint8)
    syn = (cw @ jnp.asarray(_H.T)) % 2                       # (..., k, 3)
    syn_val = (syn[..., 0] << 2) | (syn[..., 1] << 1) | syn[..., 2]
    flip_pos = jnp.asarray(_SYN2BIT)[syn_val]                # (..., k)
    flip = (jnp.arange(7) == flip_pos[..., None]).astype(jnp.uint8)
    fixed = (cw ^ flip) & 1
    data = fixed[..., :4]
    return data.reshape(*data.shape[:-2], -1).astype(jnp.uint8)


def interleave(bits: jax.Array, depth: int) -> jax.Array:
    """Block interleaver along the last axis (pad with zeros)."""
    n = bits.shape[-1]
    cols = -(-n // depth)
    pad = depth * cols - n
    if pad:
        bits = jnp.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    m = bits.reshape(*bits.shape[:-1], depth, cols)
    return jnp.swapaxes(m, -1, -2).reshape(*bits.shape[:-1], depth * cols)


def deinterleave(bits: jax.Array, depth: int, out_len: int) -> jax.Array:
    n = bits.shape[-1]
    cols = n // depth
    m = bits.reshape(*bits.shape[:-1], cols, depth)
    return jnp.swapaxes(m, -1, -2).reshape(*bits.shape[:-1], n)[..., :out_len]


def coded_len(n_bits: int) -> int:
    """Hamming(7,4) output length for n data bits."""
    return (-(-n_bits // 4)) * 7
