"""PHY encoder: frames -> 48 kHz waveforms, batched on the device.

The reference encodes one frame at a time on the CPU
(``src/phy/encoder.rs:43-92``: preamble ‖ line-coded frame bits, frames
joined with silence gaps).  Here encoding is a single jitted array program
over a whole *batch* of equal-length frames — bit unpacking, line coding and
preamble concat are fused by XLA — and a host-side helper serializes mixed
batches into one track.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from trackmaker_tpu.core import bitops, framing
from trackmaker_tpu.core.config import PhyConfig
from trackmaker_tpu.phy import line_coding


@functools.partial(jax.jit, static_argnums=0)
def encode_frame_bytes(cfg: PhyConfig, frame_bytes: jax.Array) -> jax.Array:
    """uint8[B, NB] serialized frames -> f32[B, preamble+samples(NB*8)].

    All frames in the batch must have the same *true* byte length NB
    (header + payload); group by length host-side (payloads in a file
    transfer are uniform except the tail chunk, so this costs at most two
    compiled programs per transfer).
    """
    bits = bitops.unpack_bits(frame_bytes)
    body = line_coding.encode(cfg, bits)
    pre = jnp.asarray(line_coding.preamble_waveform(cfg))
    pre = jnp.broadcast_to(pre, (*body.shape[:-1], pre.shape[-1]))
    return jnp.concatenate([pre, body], axis=-1)


class PhyEncoder:
    """Host facade mirroring the reference PhyEncoder API."""

    def __init__(self, cfg: PhyConfig):
        self.cfg = cfg
        self.preamble = line_coding.preamble_waveform(cfg)

    @property
    def preamble_len(self) -> int:
        return len(self.preamble)

    def _check(self, frame: framing.Frame) -> None:
        # A payload over the DECODER body cap (max_frame_bytes =
        # decoder.rs:61's 2x max payload) would encode fine (the length
        # header is 16-bit) but no conforming decoder ever returns it —
        # fail loudly at the producer instead of silently on the air.
        # The cap is deliberately NOT max_frame_data_size: the
        # reference's own IP path ships frames above it (DEFAULT_MTU =
        # 200 > MAX_FRAME_DATA_SIZE = 128, utils/consts.rs:37,68 +
        # acoustic_interface.rs:45) and they round-trip because the
        # decoder accepts bodies up to the 2x cap — a quirk the ping /
        # fragmentation flow depends on.
        if len(frame.data) > self.cfg.max_frame_bytes:
            raise ValueError(
                f"frame payload {len(frame.data)} B exceeds the decoder "
                f"body cap max_frame_bytes={self.cfg.max_frame_bytes}; "
                "fragment at the MAC/transfer layer (link/transfer.py)")

    def encode_frame(self, frame: framing.Frame) -> np.ndarray:
        self._check(frame)
        raw = np.frombuffer(frame.to_bytes(), dtype=np.uint8)
        out = encode_frame_bytes(self.cfg, jnp.asarray(raw[None]))
        return np.asarray(out[0])

    def encode_frames(
        self, frames: list[framing.Frame], gap_samples: int | None = None
    ) -> np.ndarray:
        """Serialize frames with inter-frame silence gaps
        (src/phy/encoder.rs:70-92).  Batches equal-length frames into
        shared jit calls, then splices on host."""
        gap = (self.cfg.inter_frame_gap_samples
               if gap_samples is None else gap_samples)
        if not frames:
            return np.zeros(0, dtype=np.float32)
        for f in frames:
            self._check(f)

        by_len: dict[int, list[int]] = {}
        raws = [np.frombuffer(f.to_bytes(), dtype=np.uint8) for f in frames]
        for i, r in enumerate(raws):
            by_len.setdefault(len(r), []).append(i)

        waves: dict[int, np.ndarray] = {}
        for n, idxs in by_len.items():
            batch = jnp.asarray(np.stack([raws[i] for i in idxs]))
            out = np.asarray(encode_frame_bytes(self.cfg, batch))
            for row, i in enumerate(idxs):
                waves[i] = out[row]

        parts = []
        for i in range(len(frames)):
            parts.append(waves[i])
            if i < len(frames) - 1:
                parts.append(np.zeros(gap, dtype=np.float32))
        return np.concatenate(parts)
