"""AWGN + clock-offset robustness sweeps (BASELINE config 4).

The reference's only fault injector is the physical room; its report
gives frame-loss anecdotes (5-15% SNR-dependent, docs/proj/report.md:532).
Here the channel is parameterized and the whole sweep — modulate, corrupt
at every SNR, batch-decode, count bit/frame errors — is a few batched
device programs.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from trackmaker_tpu.core.config import PHY_HEADER_BYTES, PhyConfig
from trackmaker_tpu.core.framing import Frame
from trackmaker_tpu.dsp import channel
from trackmaker_tpu.phy.decoder import decode_capture
from trackmaker_tpu.phy.encoder import PhyEncoder


def _build_capture(cfg: PhyConfig, n_frames: int, payload_len: int,
                   seed: int):
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 256, (n_frames, payload_len), dtype=np.uint8)
    frames = [Frame.new_data(i & 0xFF, 1, 2, payloads[i].tobytes())
              for i in range(n_frames)]
    wave = PhyEncoder(cfg).encode_frames(frames, gap_samples=240)
    return payloads, wave


def _score(res, payloads: np.ndarray) -> tuple[int, int, int]:
    """-> (bit_errors, decoded_frames, compared_bits).

    CRC-valid frames are matched to the sent frame by sequence number;
    since CRC8 passed, payloads are overwhelmingly exact — bit errors
    show up as *frame loss*, which is the honest acoustic-PHY metric.
    """
    n_frames, payload_len = payloads.shape
    valid = np.asarray(res.valid)
    seqs = np.asarray(res.sequence)
    fb = np.asarray(res.frame_bytes)
    bit_err = 0
    decoded = 0
    for k in np.nonzero(valid)[0]:
        s = seqs[k]
        if s >= n_frames:
            continue
        got = fb[k, PHY_HEADER_BYTES:PHY_HEADER_BYTES + payload_len]
        want = payloads[s]
        bit_err += int(np.unpackbits(got ^ want).sum())
        decoded += 1
    return bit_err, decoded, decoded * payload_len * 8


def ber_sweep(cfg: PhyConfig | None = None,
              snr_dbs=(-2, 0, 2, 4, 6, 8, 10, 15),
              n_frames: int = 32, payload_len: int = 64,
              seed: int = 0) -> list[dict]:
    """Frame-loss / BER vs SNR on the line-coded PHY."""
    cfg = cfg or PhyConfig()
    payloads, wave = _build_capture(cfg, n_frames, payload_len, seed)
    x = jnp.asarray(wave)
    results = []
    for i, snr in enumerate(snr_dbs):
        key = jax.random.PRNGKey(seed * 1000 + i)
        noisy = channel.awgn(key, x, float(snr))
        res = decode_capture(cfg, noisy, 2, max_frames=n_frames + 8)
        bit_err, decoded, bits = _score(res, payloads)
        results.append({
            "snr_db": float(snr),
            "frames_sent": n_frames,
            "frames_decoded": decoded,
            "frame_loss_pct": 100.0 * (n_frames - decoded) / n_frames,
            "payload_bit_errors": bit_err,
            "ber": bit_err / bits if bits else None,
        })
    return results


def coded_ber_sweep(snr_dbs=(-8, -6, -4, -2, 0, 2, 4, 6),
                    n_frames: int = 16, payload_len: int = 64,
                    seed: int = 0, line_coding: str = "manchester",
                    rate34: bool = False) -> list[dict]:
    """Frame loss vs SNR for the Viterbi-coded line-coded PHYs
    (phy/coded.py) against the uncoded decoder at the SAME detection
    threshold — the coded cliff sits >=4 dB left (tests/test_coded_phy
    pins it).  Detection threshold is lowered identically for both so
    the sweep measures coding, not the correlator (normalized preamble
    correlation decays as 1/sqrt(1+sigma^2)).  `line_coding` picks the
    waveform (manchester / 4b5b); `rate34` punctures to rate 3/4."""
    from trackmaker_tpu.phy.coded import (
        CodedFourB5BPhy, CodedManchesterPhy)

    cfg = PhyConfig(line_coding=line_coding,
                    correlation_threshold=0.45)
    phy_cls = (CodedManchesterPhy if line_coding == "manchester"
               else CodedFourB5BPhy)
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 256, (n_frames, payload_len),
                            dtype=np.uint8)
    frames = [Frame.new_data(i & 0xFF, 1, 2, payloads[i].tobytes())
              for i in range(n_frames)]
    wave_u = PhyEncoder(cfg).encode_frames(frames, gap_samples=240)
    phy = phy_cls(cfg, local_addr=2, rate34=rate34)
    wave_c = phy.encode_frames(frames, gap_samples=240)
    sig_pow = float(np.mean(np.square(wave_u[np.abs(wave_u) > 0])))
    results = []
    for i, snr in enumerate(snr_dbs):
        sigma = float(np.sqrt(sig_pow / (10.0 ** (snr / 10.0))))
        r = np.random.default_rng(seed * 1000 + i)
        noisy_u = wave_u + r.normal(0, sigma, len(wave_u)).astype(
            np.float32)
        res = decode_capture(cfg, jnp.asarray(noisy_u), 2,
                             max_frames=n_frames + 8)
        _be, dec_u, _b = _score(res, payloads)
        phy.reset()
        noisy_c = np.concatenate(
            [wave_c, np.zeros(4000, np.float32)])
        noisy_c = noisy_c + r.normal(0, sigma, len(noisy_c)).astype(
            np.float32)
        got = phy.process_samples(noisy_c)
        dec_c = sum(
            1 for f in got
            if f.sequence < n_frames
            and f.data == payloads[f.sequence].tobytes())
        results.append({
            "snr_db": float(snr),
            "frames_sent": n_frames,
            "uncoded_loss_pct": 100.0 * (n_frames - dec_u) / n_frames,
            "coded_loss_pct": 100.0 * (n_frames - dec_c) / n_frames,
        })
    return results


def clock_offset_sweep(cfg: PhyConfig | None = None,
                       ppms=(0, 50, 100, 200, 500, 1000, 2000, 5000),
                       n_frames: int = 32, payload_len: int = 64,
                       snr_db: float = 20.0, seed: int = 0) -> list[dict]:
    """Frame loss vs sample-clock mismatch (sender vs receiver)."""
    cfg = cfg or PhyConfig()
    payloads, wave = _build_capture(cfg, n_frames, payload_len, seed)
    x = jnp.asarray(wave)
    key = jax.random.PRNGKey(seed)
    results = []
    for ppm in ppms:
        skewed = channel.clock_offset(x, float(ppm))
        noisy = channel.awgn(key, skewed, snr_db)
        res = decode_capture(cfg, noisy, 2, max_frames=n_frames + 8)
        _be, decoded, _bits = _score(res, payloads)
        results.append({
            "clock_ppm": float(ppm),
            "frames_sent": n_frames,
            "frames_decoded": decoded,
            "frame_loss_pct": 100.0 * (n_frames - decoded) / n_frames,
        })
    return results
