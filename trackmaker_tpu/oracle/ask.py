"""Scalar NumPy oracle for the ASK/chirp modem (examples/ask.rs test path).

Sequential transliteration of the sender (ask.rs:571-638) and the
receiver's sync/decode state machine (ask.rs:668-796), used to
differentially test the batched device modem in ``trackmaker_tpu.phy.ask``.
"""

from __future__ import annotations

import numpy as np

from trackmaker_tpu.dsp.osc import carrier_np, chirp_np

PREAMBLE_LEN = 440
SAMPLES_PER_BIT = 44
FRAME_BITS = 100
FRAME_BITS_CRC = 108  # 100 + 8 placeholder CRC bits (ask.rs:611-613)
DECODE_SAMPLES = SAMPLES_PER_BIT * FRAME_BITS_CRC  # 4752


def build_frames(text: bytes, num_frames: int = 100) -> np.ndarray:
    """100 frames x 100 bits: 8-bit frame id (1-indexed) + 92 text bits,
    wrapping (ask.rs:545-569).  Matches the reference's wrap quirk: on
    exhaustion it resets the cursor and immediately consumes bit 0."""
    text_bits = np.unpackbits(np.frombuffer(text, dtype=np.uint8))
    frames = np.zeros((num_frames, FRAME_BITS), dtype=np.uint8)
    bit_index = 0
    for i in range(num_frames):
        fid = i + 1
        for j in range(8):
            frames[i, j] = (fid >> (7 - j)) & 1
        for j in range(8, FRAME_BITS):
            if bit_index >= len(text_bits):
                bit_index = 0
            frames[i, j] = text_bits[bit_index]
            bit_index += 1
    return frames


def modulate(frames: np.ndarray, sample_rate: int = 48000,
             fc: float = 10000.0,
             gaps: np.ndarray | None = None,
             rng: np.random.Generator | None = None) -> np.ndarray:
    """Frames -> one track with per-frame chirp preamble and random
    0..99-sample gaps before/after each frame (ask.rs:607-638)."""
    n = len(frames)
    car = carrier_np(48000, fc, sample_rate)
    pre = chirp_np(PREAMBLE_LEN, 2000.0, 10000.0, sample_rate)
    if gaps is None:
        rng = rng or np.random.default_rng(1)
        gaps = rng.integers(0, 100, size=(n, 2))
    parts = []
    for i in range(n):
        bits = np.concatenate([frames[i], np.zeros(8, np.uint8)])
        amp = np.where(bits == 1, 1.0, -1.0).astype(np.float32)
        wave = np.repeat(amp, SAMPLES_PER_BIT) * car[:DECODE_SAMPLES]
        parts.append(np.zeros(gaps[i, 0], np.float32))
        parts.append(np.concatenate([pre, wave]).astype(np.float32))
        parts.append(np.zeros(gaps[i, 1], np.float32))
    return np.concatenate(parts)


def demodulate(rx: np.ndarray, sample_rate: int = 48000,
               fc: float = 10000.0) -> list[tuple[int, np.ndarray]]:
    """Sequential receiver (ask.rs:693-796). Returns (frame_id,
    92 payload bits) for each frame whose id check passes."""
    rx = np.asarray(rx, np.float32)
    pre = chirp_np(PREAMBLE_LEN, 2000.0, 10000.0, sample_rate)
    carrier_decode = carrier_np(len(rx), fc, sample_rate)

    power = np.float32(0.0)
    start_index = 0
    sync_fifo = np.zeros(PREAMBLE_LEN, np.float32)
    sync_max = np.float32(0.0)
    decode_fifo: list[float] = []
    state = 0
    results: list[tuple[int, np.ndarray]] = []

    for i in range(len(rx)):
        s = rx[i]
        power = power * np.float32(1.0 - 1.0 / 64.0) + s * s / np.float32(64.0)
        if state == 0:
            sync_fifo[:-1] = sync_fifo[1:]
            sync_fifo[-1] = s
            sync_power = float(sync_fifo @ pre) / 200.0
            if sync_power > power * 2.0 and sync_power > sync_max \
                    and sync_power > 0.05:
                sync_max = sync_power
                start_index = i
            elif i > start_index + 200 and start_index != 0:
                sync_max = np.float32(0.0)
                sync_fifo[:] = 0.0
                state = 1
                decode_fifo = list(rx[start_index + 1 : i])
        else:
            decode_fifo.append(s)
            if len(decode_fifo) == DECODE_SAMPLES:
                window = np.asarray(decode_fifo, np.float32)
                csl = carrier_decode[:DECODE_SAMPLES]
                prod = window * csl
                smooth = np.empty(DECODE_SAMPLES, np.float32)
                for j in range(DECODE_SAMPLES):
                    lo = max(j - 5, 0)
                    hi = min(j + 6, DECODE_SAMPLES)
                    smooth[j] = prod[lo:hi].sum() / (hi - lo)
                bits = np.zeros(FRAME_BITS_CRC, dtype=bool)
                for j in range(FRAME_BITS_CRC):
                    lo = 10 + j * SAMPLES_PER_BIT
                    hi = min(30 + j * SAMPLES_PER_BIT, DECODE_SAMPLES)
                    if lo < DECODE_SAMPLES and lo < hi:
                        bits[j] = smooth[lo:hi].sum() > 0
                fid = 0
                for k in range(8):
                    if bits[k]:
                        fid += 1 << (7 - k)
                if 0 < fid <= 100:
                    results.append((fid, bits[8:FRAME_BITS].astype(np.uint8)))
                start_index = 0
                decode_fifo = []
                state = 0
    return results


def bits_to_text(all_bits: np.ndarray) -> bytes:
    n = (len(all_bits) // 8) * 8
    return np.packbits(all_bits[:n]).tobytes()
