"""PHY frame codec: [Len:2][CRC8:1][Type:1][Seq:1][Src:1][Dst:1][Data:N].

Byte layout mirrors the reference (``src/phy/frame.rs:74-102``): big-endian
2-byte payload length, CRC8 over the *payload only* (frame.rs:83), then
type/seq/src/dst, then data.  Two implementations live here:

* a host-side ``Frame`` dataclass used by the MAC/NET runtime, and
* batched JAX builders/parsers used inside the device encode/decode programs,
  which operate on padded ``uint8[B, 7+max_len]`` arrays with explicit
  per-frame lengths (pad-and-mask — no dynamic shapes under jit).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from trackmaker_tpu.core import bitops
from trackmaker_tpu.core.config import (
    FRAME_TYPE_ACK,
    FRAME_TYPE_DATA,
    PHY_HEADER_BYTES,
)

__all__ = [
    "Frame",
    "build_frame_bytes",
    "parse_header",
    "FRAME_TYPE_DATA",
    "FRAME_TYPE_ACK",
    "PHY_HEADER_BYTES",
]


@dataclass
class Frame:
    """Host-side PHY frame (reference src/phy/frame.rs:33-41)."""

    frame_type: int
    sequence: int
    src: int
    dst: int
    data: bytes = field(default=b"")

    @classmethod
    def new_data(cls, sequence: int, src: int, dst: int, data: bytes) -> "Frame":
        return cls(FRAME_TYPE_DATA, sequence, src, dst, bytes(data))

    @classmethod
    def new_ack(cls, sequence: int, src: int, dst: int, data: bytes = b"") -> "Frame":
        return cls(FRAME_TYPE_ACK, sequence, src, dst, bytes(data))

    def to_bytes(self) -> bytes:
        n = len(self.data)
        hdr = bytes([
            (n >> 8) & 0xFF,
            n & 0xFF,
            bitops.crc8_host(self.data),
            self.frame_type & 0xFF,
            self.sequence & 0xFF,
            self.src & 0xFF,
            self.dst & 0xFF,
        ])
        return hdr + self.data

    def to_bits(self) -> np.ndarray:
        return bitops.bytes_to_bits_host(self.to_bytes())

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Frame | None":
        """Parse+validate; None on bad type/CRC (src/phy/frame.rs:147-177)."""
        if len(raw) < PHY_HEADER_BYTES:
            return None
        n = (raw[0] << 8) | raw[1]
        crc, ftype, seq, src, dst = raw[2], raw[3], raw[4], raw[5], raw[6]
        if ftype not in (FRAME_TYPE_DATA, FRAME_TYPE_ACK):
            return None
        if len(raw) < PHY_HEADER_BYTES + n:
            return None
        data = raw[PHY_HEADER_BYTES:PHY_HEADER_BYTES + n]
        if bitops.crc8_host(data) != crc:
            return None
        return cls(ftype, seq, src, dst, data)

    @classmethod
    def from_bits(cls, bits: np.ndarray) -> "Frame | None":
        return cls.from_bytes(bitops.bits_to_bytes_host(bits).tobytes())


# ---------------------------------------------------------------------------
# Batched JAX codec
# ---------------------------------------------------------------------------


def build_frame_bytes(
    payload: jax.Array,       # uint8[B, max_len] zero-padded payloads
    length: jax.Array,        # int32[B] true payload lengths
    frame_type: jax.Array,    # int32/uint8[B]
    sequence: jax.Array,
    src: jax.Array,
    dst: jax.Array,
) -> jax.Array:
    """Serialize a batch of frames -> uint8[B, 7+max_len] (zero-padded).

    Bytes past 7+length are zero; callers carry `length` alongside.
    """
    payload = payload.astype(jnp.uint8)
    b, max_len = payload.shape
    length = length.astype(jnp.int32)
    crc = bitops.crc8(payload, length)

    col = jnp.arange(max_len, dtype=jnp.int32)
    masked = jnp.where(col[None, :] < length[:, None], payload, 0)

    hdr = jnp.stack(
        [
            (length >> 8).astype(jnp.uint8),
            (length & 0xFF).astype(jnp.uint8),
            crc,
            frame_type.astype(jnp.uint8),
            sequence.astype(jnp.uint8),
            src.astype(jnp.uint8),
            dst.astype(jnp.uint8),
        ],
        axis=-1,
    )
    return jnp.concatenate([hdr, masked], axis=-1)


def parse_header(frame_bytes: jax.Array) -> dict[str, jax.Array]:
    """Parse header fields from uint8[..., >=7] frame byte arrays.

    Returns dict of length/crc/frame_type/sequence/src/dst plus
    `type_valid` mirroring FrameType::from_u8 (src/phy/frame.rs:20-26).
    """
    fb = frame_bytes.astype(jnp.int32)
    length = (fb[..., 0] << 8) | fb[..., 1]
    ftype = fb[..., 3]
    return {
        "length": length,
        "crc": fb[..., 2],
        "frame_type": ftype,
        "sequence": fb[..., 4],
        "src": fb[..., 5],
        "dst": fb[..., 6],
        "type_valid": (ftype == FRAME_TYPE_DATA) | (ftype == FRAME_TYPE_ACK),
    }


def verify_frames(
    frame_bytes: jax.Array,   # uint8[B, 7+max_len]
) -> dict[str, jax.Array]:
    """Header parse + CRC verify for a batch of decoded frame byte arrays.

    `crc_ok` is computed over payload[0:length] with pad-and-mask; callers
    combine it with their own length-sanity and dst filters (the decoder's
    checks at src/phy/decoder.rs:277-355).
    """
    hdr = parse_header(frame_bytes)
    payload = frame_bytes[..., PHY_HEADER_BYTES:]
    max_len = payload.shape[-1]
    length = jnp.clip(hdr["length"], 0, max_len)
    crc = bitops.crc8(payload, length)
    hdr["crc_ok"] = (crc.astype(jnp.int32) == hdr["crc"]) & hdr["type_valid"]
    return hdr
