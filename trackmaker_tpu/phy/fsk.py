"""Binary FSK modem — vectorized, noncoherent (BASELINE config 1 family).

The reference's Project-1 modem family is ASK/FSK single-carrier
(docs/proj/proj1.md); ``examples/ask.rs`` implements the ASK variant and
this is the FSK sibling, batch-first: phase-continuous synthesis is a
``cumsum`` over per-sample frequency, and noncoherent demodulation is a
batched quadrature (I/Q) energy comparison per bit — two small matmuls
over the reshaped bit windows.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from trackmaker_tpu.core import bitops
from trackmaker_tpu.core.framing import Frame
from trackmaker_tpu.dsp.osc import chirp_cached


@dataclasses.dataclass(frozen=True)
class FskConfig:
    sample_rate: int = 48_000
    f0_hz: float = 4_000.0      # bit 0 tone
    f1_hz: float = 8_000.0      # bit 1 tone
    samples_per_bit: int = 48   # 1 kbps
    preamble_len: int = 440
    chirp_lo_hz: float = 2_000.0
    chirp_hi_hz: float = 10_000.0
    guard_samples: int = 32
    sync_threshold: float = 0.5
    amplitude: float = 1.0


@functools.partial(jax.jit, static_argnums=0)
def modulate_bits(cfg: FskConfig, bits: jax.Array) -> jax.Array:
    """uint8[B, N] -> f32[B, preamble+guard+N*spb], phase-continuous."""
    b, n = bits.shape
    freq = jnp.where(bits > 0, cfg.f1_hz, cfg.f0_hz).astype(jnp.float32)
    freq = jnp.repeat(freq, cfg.samples_per_bit, axis=-1)
    phase = 2.0 * jnp.pi * jnp.cumsum(freq, axis=-1) / cfg.sample_rate
    body = cfg.amplitude * jnp.sin(phase)
    pre = jnp.asarray(chirp_cached(
        cfg.preamble_len, cfg.chirp_lo_hz, cfg.chirp_hi_hz, cfg.sample_rate))
    pre = jnp.broadcast_to(pre, (b, cfg.preamble_len))
    guard = jnp.zeros((b, cfg.guard_samples), jnp.float32)
    return jnp.concatenate([pre, guard, body], axis=-1)


@functools.partial(jax.jit, static_argnums=(0, 2))
def demodulate_at(cfg: FskConfig, rx: jax.Array, n_bits: int,
                  starts: jax.Array) -> jax.Array:
    """Noncoherent demod of frames whose preambles start at `starts`."""
    spb = cfg.samples_per_bit
    total = n_bits * spb
    off = cfg.preamble_len + cfg.guard_samples
    pad = jnp.concatenate(
        [rx.astype(jnp.float32), jnp.zeros(total + off + 8, jnp.float32)])
    t = jnp.arange(spb, dtype=jnp.float32) / cfg.sample_rate
    basis = jnp.stack([
        jnp.sin(2 * jnp.pi * cfg.f0_hz * t),
        jnp.cos(2 * jnp.pi * cfg.f0_hz * t),
        jnp.sin(2 * jnp.pi * cfg.f1_hz * t),
        jnp.cos(2 * jnp.pi * cfg.f1_hz * t),
    ], axis=1)                                        # (spb, 4)

    def one(start):
        seg = jax.lax.dynamic_slice(pad, (start + off,), (total,))
        wins = seg.reshape(n_bits, spb)
        iq = jnp.dot(wins, basis,
                     precision=jax.lax.Precision.HIGHEST)  # (n_bits, 4)
        e0 = iq[:, 0] ** 2 + iq[:, 1] ** 2
        e1 = iq[:, 2] ** 2 + iq[:, 3] ** 2
        return (e1 > e0).astype(jnp.uint8)

    return jax.vmap(one)(jnp.asarray(starts, jnp.int32))


class FskModem:
    """Frame facade mirroring OfdmModem's API."""

    def __init__(self, cfg: FskConfig = FskConfig()):
        self.cfg = cfg

    def encode_frames(self, frames: list[Frame],
                      gap_samples: int = 256) -> np.ndarray:
        assert frames
        lens = {len(f.to_bytes()) for f in frames}
        assert len(lens) == 1, "group equal-length frames"
        bits = np.stack(
            [bitops.bytes_to_bits_host(f.to_bytes()) for f in frames])
        waves = np.asarray(modulate_bits(self.cfg, jnp.asarray(bits)))
        parts = []
        for i, w in enumerate(waves):
            parts.append(w)
            if i < len(waves) - 1:
                parts.append(np.zeros(gap_samples, np.float32))
        return np.concatenate(parts)

    def decode(self, rx: np.ndarray, frame_bytes_len: int,
               max_frames: int = 64) -> list[Frame]:
        from trackmaker_tpu.phy.ofdm import OfdmConfig, find_preambles
        sync_cfg = OfdmConfig(
            preamble_len=self.cfg.preamble_len,
            chirp_lo_hz=self.cfg.chirp_lo_hz,
            chirp_hi_hz=self.cfg.chirp_hi_hz,
            sync_threshold=self.cfg.sync_threshold)
        starts = np.asarray(find_preambles(
            sync_cfg, jnp.asarray(rx), max_frames))
        starts = starts[starts >= 0]
        if len(starts) == 0:
            return []
        bits = np.asarray(demodulate_at(
            self.cfg, jnp.asarray(rx), frame_bytes_len * 8,
            jnp.asarray(starts)))
        out = []
        for row in bits:
            f = Frame.from_bits(row)
            if f is not None:
                out.append(f)
        return out
