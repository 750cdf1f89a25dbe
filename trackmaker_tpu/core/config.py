"""Runtime configuration for the acoustic-modem framework.

The reference keeps all tunables as compile-time constants
(``src/utils/consts.rs:1-75``) and its own benchmark harness has to rewrite
that file with regexes and rebuild the binary to sweep parameters
(``tools/test.py:150-188``).  Here every parameter is a *runtime* value on a
frozen, hashable dataclass so a single jitted program can be specialized per
config (configs are static args to ``jax.jit``) and parameter sweeps are just
Python loops.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


MANCHESTER = "manchester"
FOUR_B_FIVE_B = "4b5b"

# Frame byte layout: [Len:2][CRC8:1][Type:1][Seq:1][Src:1][Dst:1][Data:N]
# (reference src/phy/frame.rs:74-102, src/utils/consts.rs:48)
PHY_HEADER_BYTES = 7

FRAME_TYPE_DATA = 0x01
FRAME_TYPE_ACK = 0x02


@dataclass(frozen=True)
class PhyConfig:
    """Physical-layer parameters (reference src/utils/consts.rs:19-48)."""

    sample_rate: int = 48_000
    samples_per_level: int = 3
    preamble_pattern_bytes: int = 2
    max_frame_data_size: int = 128
    inter_frame_gap_samples: int = 48  # 1 ms at 48 kHz (consts.rs:39-44)
    line_coding: str = MANCHESTER
    correlation_threshold: float = 0.9  # src/phy/decoder.rs:57

    # Decoder sizing (static shapes for the device decode program).
    # max_frame_bytes mirrors src/phy/decoder.rs:61 (2x max payload).
    @property
    def max_frame_bytes(self) -> int:
        return self.max_frame_data_size * 2

    @property
    def header_bits(self) -> int:
        return 8 * PHY_HEADER_BYTES

    def replace(self, **kw) -> "PhyConfig":
        return dataclasses.replace(self, **kw)

    # -- line-code arithmetic (shape computations must be Python ints) -----
    def samples_for_bits(self, num_bits: int) -> int:
        """Samples occupied by `num_bits` frame bits after line coding.

        Mirrors LineCode::samples_for_bits (src/phy/line_coding.rs:125-127,
        295-300).
        """
        if self.line_coding == MANCHESTER:
            return num_bits * self.samples_per_level * 2
        elif self.line_coding == FOUR_B_FIVE_B:
            num_nibbles = (num_bits + 3) // 4
            return num_nibbles * 5 * self.samples_per_level
        raise ValueError(f"unknown line coding {self.line_coding!r}")

    @property
    def preamble_len(self) -> int:
        """Preamble length in samples (pattern_bytes*8 line-coded bits)."""
        return self.samples_for_bits(self.preamble_pattern_bytes * 8)

    @property
    def sync_len(self) -> int:
        """Sync word (last preamble byte, 8 bits) length in samples."""
        return self.samples_for_bits(8)

    @property
    def sync_margin(self) -> int:
        """±1-bit sync realignment margin (src/phy/decoder.rs:173-176)."""
        return self.samples_for_bits(1)

    @property
    def header_samples(self) -> int:
        return self.samples_for_bits(self.header_bits)

    @property
    def max_frame_samples(self) -> int:
        """Samples for the largest frame (header + max payload)."""
        total_bits = (PHY_HEADER_BYTES + self.max_frame_bytes) * 8
        return self.samples_for_bits(total_bits)

    def frame_samples(self, data_len: int) -> int:
        """Samples for one encoded frame body (without preamble)."""
        return self.samples_for_bits((PHY_HEADER_BYTES + data_len) * 8)


@dataclass(frozen=True)
class MacConfig:
    """MAC parameters (reference src/utils/consts.rs:46-63)."""

    ack_timeout_ms: int = 200
    energy_threshold: float = 0.5
    energy_detection_samples: int = 20
    difs_duration_ms: int = 20
    cw_min: int = 1
    cw_max: int = 100
    slot_time_ms: int = 5
    max_retries: int = 16


@dataclass(frozen=True)
class NetConfig:
    """Network-layer parameters (reference src/utils/consts.rs:65-74)."""

    ip_ttl: int = 64
    mtu: int = 200           # DEFAULT_MTU, consts.rs:68
    acoustic_mtu: int = 140  # router fragmentation MTU, src/net/router.rs:2290
    ping_packet_count: int = 10
    ping_payload_size: int = 32
    ping_timeout_ms: int = 2000
    ping_interval_ms: int = 1000
