"""Bit packing and CRC8 as JAX array ops.

The reference implements these as scalar Rust loops
(``src/phy/crc.rs:7-75``).  Here they become vectorized array programs:

* MSB-first byte<->bit conversion is a broadcasted shift+mask / weighted sum,
  `vmap`-able over any batch of frames.
* CRC8 (poly 0x07, init 0x00 — src/phy/crc.rs:4) is a byte-at-a-time table
  lookup folded over the message with ``lax.scan``; the 256-entry table is
  precomputed host-side.  Variable-length messages are handled with
  pad-and-mask so a whole batch of frames CRC-checks in one fused program.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

CRC8_POLY = 0x07


def _build_crc8_table(poly: int = CRC8_POLY) -> np.ndarray:
    table = np.zeros(256, dtype=np.uint8)
    for byte in range(256):
        crc = byte
        for _ in range(8):
            crc = ((crc << 1) ^ poly) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
        table[byte] = crc
    return table


CRC8_TABLE = _build_crc8_table()
# NOTE: no module-level jnp.asarray here — a device put at import time
# initializes the jax backend, and `import trackmaker_tpu` must never
# touch devices (importing must not pick or reserve an accelerator).

# ---------------------------------------------------------------------------
# Host (NumPy) versions — used by the host-side MAC/NET runtime and oracles.
# ---------------------------------------------------------------------------


def crc8_host(data: bytes | np.ndarray) -> int:
    """CRC8 of a byte string (host-side; matches src/phy/crc.rs:7-22)."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
    crc = np.uint8(0)
    for b in arr:
        crc = CRC8_TABLE[crc ^ b]
    return int(crc)


def bytes_to_bits_host(data: bytes | np.ndarray) -> np.ndarray:
    """MSB-first unpack (src/phy/crc.rs:54-60)."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
    return np.unpackbits(arr)


def bits_to_bytes_host(bits: np.ndarray) -> np.ndarray:
    """MSB-first pack; trailing partial byte is zero-padded on the right
    (src/phy/crc.rs:63-75)."""
    bits = np.asarray(bits, dtype=np.uint8)
    return np.packbits(bits)


# ---------------------------------------------------------------------------
# JAX versions — batched, jittable.
# ---------------------------------------------------------------------------


def unpack_bits(bytes_arr: jax.Array) -> jax.Array:
    """uint8[..., N] -> uint8[..., N*8], MSB first."""
    bytes_arr = bytes_arr.astype(jnp.uint8)
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    bits = (bytes_arr[..., :, None] >> shifts) & jnp.uint8(1)
    return bits.reshape(*bytes_arr.shape[:-1], bytes_arr.shape[-1] * 8)


def pack_bits(bits: jax.Array) -> jax.Array:
    """uint8[..., N*8] -> uint8[..., N], MSB first. Length must be a
    multiple of 8 (pad upstream; mirrors zero-fill of src/phy/crc.rs:39-51)."""
    n = bits.shape[-1]
    assert n % 8 == 0, "pack_bits needs a multiple of 8 bits"
    bits = bits.reshape(*bits.shape[:-1], n // 8, 8).astype(jnp.uint8)
    weights = (jnp.uint8(1) << jnp.arange(7, -1, -1, dtype=jnp.uint8))
    return jnp.sum(bits * weights, axis=-1, dtype=jnp.uint8)


_CRC8_DIST_CACHE: dict[int, np.ndarray] = {}


def _crc8_distance_table(n: int) -> np.ndarray:
    """T[d, b] = CRC8 of byte b followed by d zero bytes, for d in [0, n).

    CRC8 with init 0x00 and no final XOR is linear over GF(2), so the CRC
    of a message is the XOR of each byte's contribution at its distance
    from the end — turning the sequential fold into a parallel gather+XOR.
    """
    sizes = [k for k in _CRC8_DIST_CACHE if k >= n]
    if sizes:
        return _CRC8_DIST_CACHE[min(sizes)][:n]
    table = np.zeros((n, 256), dtype=np.uint8)
    table[0] = CRC8_TABLE
    for d in range(1, n):
        table[d] = CRC8_TABLE[table[d - 1]]
    _CRC8_DIST_CACHE.clear()
    _CRC8_DIST_CACHE[n] = table
    return table


def crc8_parallel(data: jax.Array, length: jax.Array | None = None) -> jax.Array:
    """Parallel CRC8 over uint8[..., N] with optional per-item `length`.

    Same contract as :func:`crc8` but O(log N) depth (gather + XOR
    reduction) instead of a length-N scan — used inside the frame decode
    loop where the CRC sits on the critical path.
    """
    data = data.astype(jnp.uint8)
    n = data.shape[-1]
    if n == 0:
        return jnp.zeros(data.shape[:-1], dtype=jnp.uint8)
    if length is None:
        length = jnp.full(data.shape[:-1], n, dtype=jnp.int32)
    else:
        length = jnp.broadcast_to(
            jnp.asarray(length, jnp.int32), data.shape[:-1])
    table = jnp.asarray(_crc8_distance_table(n).reshape(-1))
    idx = jnp.arange(n, dtype=jnp.int32)
    dist = length[..., None] - 1 - idx          # distance from message end
    contrib = table[jnp.clip(dist, 0) * 256 + data.astype(jnp.int32)]
    contrib = jnp.where(idx < length[..., None], contrib, 0)
    return jax.lax.reduce(
        contrib, np.uint8(0), jax.lax.bitwise_xor, [data.ndim - 1])


_CRC8_BITMAT_CACHE: dict[int, np.ndarray] = {}


def _crc8_bit_matrix(n_bytes: int) -> np.ndarray:
    """M[j, :] (n_bytes*8, 8): CRC contribution bits of message bit j in a
    fixed n_bytes-long message (MSB-first within bytes)."""
    if n_bytes in _CRC8_BITMAT_CACHE:
        return _CRC8_BITMAT_CACHE[n_bytes]
    dist = _crc8_distance_table(n_bytes)
    m = np.zeros((n_bytes * 8, 8), dtype=np.float32)
    for i in range(n_bytes):
        d = n_bytes - 1 - i
        for k in range(8):
            contrib = dist[d, 1 << (7 - k)]
            m[i * 8 + k] = [(contrib >> (7 - b)) & 1 for b in range(8)]
    _CRC8_BITMAT_CACHE[n_bytes] = m
    return m


def crc8_bits_matmul(bits: jax.Array, length_bytes: jax.Array) -> jax.Array:
    """CRC8 from *bit* arrays via one GF(2) matmul.

    `bits`: uint8/f32[..., N*8] MSB-first message bits, zero beyond
    `length_bytes` bytes.  Exploits that leading zero bytes don't change
    a zero-init CRC: the message is cyclically rolled right so it ends
    at the buffer end, then a fixed-length bit matrix gives the CRC as
    (bits @ M) mod 2 — no per-byte table gathers on the critical path.
    """
    n = bits.shape[-1]
    assert n % 8 == 0
    n_bytes = n // 8
    m = jnp.asarray(_crc8_bit_matrix(n_bytes))
    shift = (jnp.asarray(n_bytes, jnp.int32) - length_bytes) * 8
    rolled = _roll_last(bits.astype(jnp.float32), shift)
    crc_bits = jnp.einsum("...n,nk->...k", rolled, m,
                          precision=jax.lax.Precision.HIGHEST) % 2.0
    weights = jnp.asarray([128, 64, 32, 16, 8, 4, 2, 1], jnp.float32)
    return jnp.sum(crc_bits * weights, axis=-1).astype(jnp.uint8)


_CRC8_UNZERO_CACHE: dict[int, np.ndarray] = {}


def _crc8_unzero_table(max_z: int) -> np.ndarray:
    """U[z] (8, 8) GF(2) matrices with crc_bits(m) = crc_bits(m·0^z) @ U[z]:
    appending one zero byte maps crc -> CRC8_TABLE[crc], which is linear
    over GF(2) and invertible (poly 0x07 has a nonzero constant term), so
    a fixed-length CRC over a zero-padded buffer can be corrected to the
    true variable-length CRC with one 8x8 GF(2) matrix — no dynamic roll
    (which lowers to a gather) on the hot path."""
    if max_z in _CRC8_UNZERO_CACHE:
        return _CRC8_UNZERO_CACHE[max_z]
    # A: crc -> crc after one appended zero byte, as an 8x8 GF(2) matrix
    # acting on MSB-first bit rows.
    a = np.zeros((8, 8), dtype=np.uint8)
    for b in range(8):
        out = CRC8_TABLE[1 << (7 - b)]
        a[b] = [(out >> (7 - k)) & 1 for k in range(8)]
    # invert A over GF(2)
    m = np.concatenate([a.copy(), np.eye(8, dtype=np.uint8)], axis=1)
    for col in range(8):
        piv = col + int(np.argmax(m[col:, col]))
        m[[col, piv]] = m[[piv, col]]
        for r in range(8):
            if r != col and m[r, col]:
                m[r] ^= m[col]
    a_inv = m[:, 8:]
    u = np.zeros((max_z + 1, 8, 8), dtype=np.float32)
    u[0] = np.eye(8)
    for z in range(1, max_z + 1):
        u[z] = (u[z - 1] @ a_inv) % 2
    _CRC8_UNZERO_CACHE[max_z] = u
    return u


def crc8_bits_fixed_unzero(
    bits: jax.Array, length_bytes: jax.Array, n_bytes: int
) -> jax.Array:
    """CRC8 of the first `length_bytes` bytes of an `n_bytes`-long bit
    buffer whose bytes beyond `length_bytes` are ZERO.

    Computes the fixed-length CRC with one static GF(2) matmul, then
    un-appends the (n_bytes - length_bytes) trailing zero bytes with the
    precomputed inverse-update matrix — fully dense, batching over any
    leading axes (unlike :func:`crc8_bits_matmul`, whose dynamic roll
    lowers to a per-item gather)."""
    assert bits.shape[-1] == n_bytes * 8
    m = jnp.asarray(_crc8_bit_matrix(n_bytes))
    hi = jax.lax.Precision.HIGHEST
    crc_bits = jnp.einsum(
        "...n,nk->...k", bits.astype(jnp.float32), m, precision=hi) % 2.0
    z = jnp.clip(n_bytes - length_bytes, 0, n_bytes)
    u = jnp.asarray(_crc8_unzero_table(n_bytes))          # (n+1, 8, 8)
    onehot = jax.nn.one_hot(z, n_bytes + 1, dtype=jnp.float32)
    uz = jnp.einsum("...z,zjk->...jk", onehot, u, precision=hi)
    fixed = jnp.einsum("...j,...jk->...k", crc_bits, uz,
                       precision=hi) % 2.0
    weights = jnp.asarray([128, 64, 32, 16, 8, 4, 2, 1], jnp.float32)
    return jnp.sum(fixed * weights, axis=-1).astype(jnp.uint8)


def _roll_last(x: jax.Array, shift: jax.Array) -> jax.Array:
    """Roll right along the last axis with a traced shift — one
    contiguous dynamic slice of the doubled array (no index gather)."""
    n = x.shape[-1]
    x2 = jnp.concatenate([x, x], axis=-1)
    start = (n - shift % n) % n
    starts = (jnp.int32(0),) * (x.ndim - 1) + (start.astype(jnp.int32),)
    return jax.lax.dynamic_slice(x2, starts, (*x.shape[:-1], n))


def crc8(data: jax.Array, length: jax.Array | None = None) -> jax.Array:
    """CRC8 over `data` (uint8[..., N]) with optional per-item `length`.

    `length` (int32[...]) masks the tail: bytes at index >= length do not
    update the CRC, so a batch of variable-length payloads padded to a
    common N yields each payload's true CRC in one scan.
    """
    data = data.astype(jnp.uint8)
    batch_shape = data.shape[:-1]
    n = data.shape[-1]
    if length is None:
        length = jnp.full(batch_shape, n, dtype=jnp.int32)
    else:
        length = jnp.broadcast_to(jnp.asarray(length, jnp.int32), batch_shape)

    table = jnp.asarray(CRC8_TABLE, dtype=jnp.uint8)

    def step(crc, xs):
        byte, idx = xs
        nxt = table[(crc ^ byte).astype(jnp.int32)]
        return jnp.where(idx < length, nxt, crc), None

    init = jnp.zeros(batch_shape, dtype=jnp.uint8)
    # scan over the byte axis (moved to leading position)
    data_t = jnp.moveaxis(data, -1, 0)
    idx = jnp.arange(n, dtype=jnp.int32)
    crc, _ = jax.lax.scan(step, init, (data_t, idx))
    return crc
