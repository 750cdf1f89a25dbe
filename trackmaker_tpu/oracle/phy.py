"""Scalar NumPy oracle for the PHY encode/decode chain.

Behavioral transliteration of the reference pipeline (``src/phy/encoder.rs``,
``src/phy/decoder.rs``, ``src/phy/line_coding.rs``) used to differentially
test the batched device implementation.  Kept deliberately sequential and
simple — this is the spec, not the fast path.
"""

from __future__ import annotations

import numpy as np

from trackmaker_tpu.core import bitops
from trackmaker_tpu.core.config import (
    FOUR_B_FIVE_B,
    MANCHESTER,
    PHY_HEADER_BYTES,
    FRAME_TYPE_DATA,
    PhyConfig,
)
from trackmaker_tpu.core.framing import Frame
from trackmaker_tpu.phy.line_coding import (
    FOURB_FIVEB_DECODE,
    FOURB_FIVEB_ENCODE,
    preamble_bits,
)


def _encode_bits(cfg: PhyConfig, bits: np.ndarray) -> np.ndarray:
    spl = cfg.samples_per_level
    if cfg.line_coding == MANCHESTER:
        out = np.empty(len(bits) * 2 * spl, dtype=np.float32)
        for i, b in enumerate(bits):
            first = 1.0 if b == 0 else -1.0
            out[i * 2 * spl : i * 2 * spl + spl] = first
            out[i * 2 * spl + spl : (i + 1) * 2 * spl] = -first
        return out
    elif cfg.line_coding == FOUR_B_FIVE_B:
        n_nib = -(-len(bits) // 4)
        coded = []
        for i in range(n_nib):
            nib = 0
            chunk = bits[i * 4 : i * 4 + 4]
            for j, b in enumerate(chunk):
                if b:
                    nib |= 1 << (3 - j)
            sym = FOURB_FIVEB_ENCODE[nib]
            coded.extend((sym >> (4 - j)) & 1 for j in range(5))
        level = 1.0
        out = np.empty(len(coded) * spl, dtype=np.float32)
        for i, cb in enumerate(coded):
            if cb == 1:
                level = -level
            out[i * spl : (i + 1) * spl] = level
        return out
    raise ValueError(cfg.line_coding)


def _decode_bits(cfg: PhyConfig, samples: np.ndarray) -> np.ndarray:
    spl = cfg.samples_per_level
    if cfg.line_coding == MANCHESTER:
        n = len(samples) // (2 * spl)
        bits = np.empty(n, dtype=np.uint8)
        for i in range(n):
            first = samples[i * 2 * spl : i * 2 * spl + spl].sum() / spl
            second = samples[i * 2 * spl + spl : (i + 1) * 2 * spl].sum() / spl
            bits[i] = 0 if first > second else 1
        return bits
    elif cfg.line_coding == FOUR_B_FIVE_B:
        n_sym_levels = len(samples) // spl
        last_avg = 1.0
        bits_out = []
        cur_sym = 0
        bit_count = 0
        for i in range(n_sym_levels):
            avg = samples[i * spl : (i + 1) * spl].sum() / spl
            bit = 1 if last_avg * avg < 0.0 else 0
            if abs(avg) > 1e-6:
                last_avg = avg
            cur_sym = ((cur_sym << 1) | bit) & 0x1F
            bit_count += 1
            if bit_count == 5:
                nib = FOURB_FIVEB_DECODE[cur_sym]
                if nib < 0:
                    break  # reference stops on invalid symbol
                bits_out.extend((nib >> (3 - j)) & 1 for j in range(4))
                cur_sym = 0
                bit_count = 0
        return np.asarray(bits_out, dtype=np.uint8)
    raise ValueError(cfg.line_coding)


class OracleEncoder:
    """Mirrors PhyEncoder (src/phy/encoder.rs:43-92)."""

    def __init__(self, cfg: PhyConfig):
        self.cfg = cfg
        self.preamble = _encode_bits(
            cfg, preamble_bits(cfg.preamble_pattern_bytes))

    def encode_frame(self, frame: Frame) -> np.ndarray:
        bits = bitops.bytes_to_bits_host(frame.to_bytes())
        body = _encode_bits(self.cfg, bits)
        return np.concatenate([self.preamble, body])

    def encode_frames(self, frames, gap_samples: int | None = None) -> np.ndarray:
        gap = self.cfg.inter_frame_gap_samples if gap_samples is None else gap_samples
        parts = []
        for i, f in enumerate(frames):
            parts.append(self.encode_frame(f))
            if i < len(frames) - 1:
                parts.append(np.zeros(gap, dtype=np.float32))
        return np.concatenate(parts) if parts else np.zeros(0, np.float32)


class OracleDecoder:
    """Mirrors PhyDecoder's streaming state machine (src/phy/decoder.rs)."""

    SEARCHING = 0
    DECODING = 1

    def __init__(self, cfg: PhyConfig, local_addr: int):
        self.cfg = cfg
        self.local_addr = local_addr
        self.preamble = _encode_bits(
            cfg, preamble_bits(cfg.preamble_pattern_bytes))
        self.preamble_energy = float(np.sqrt(np.sum(self.preamble ** 2)))
        self.threshold = cfg.correlation_threshold
        self.buf = np.zeros(0, dtype=np.float32)
        self.offset = 0
        self.state = self.SEARCHING
        self.frame_start = 0
        self.max_frame_bytes = cfg.max_frame_bytes
        self.events: list[dict] = []  # decode decisions, for debugging tests

    # -- decoder.rs:68-112
    def process_samples(self, samples: np.ndarray) -> list[Frame]:
        decoded: list[Frame] = []
        self.buf = np.concatenate([self.buf, np.asarray(samples, np.float32)])
        while True:
            if self.state == self.SEARCHING:
                used = self._search()
            else:
                used = self._decode_frame(decoded)
            if used is None:
                break
            self.offset += used
        # drain, keeping a preamble-1 overlap (decoder.rs:89-109)
        keep = max(len(self.preamble) - 1, 0)
        drain_end = max(self.offset - keep, 0)
        if drain_end > 0:
            self.buf = self.buf[drain_end:]
            self.offset -= drain_end
            if self.state == self.DECODING:
                self.frame_start = max(self.frame_start - drain_end, 0)
        return decoded

    # -- decoder.rs:123-238
    def _search(self):
        area = self.buf[self.offset:]
        L = len(self.preamble)
        if len(area) < L:
            return None
        window_count = len(area) - L + 1
        energy = float(np.sum(area[:L] ** 2))
        for i in range(window_count):
            window = area[i : i + L]
            if energy < 1e-6:
                corr = 0.0
            else:
                corr = float(window @ self.preamble) / (
                    np.sqrt(energy) * self.preamble_energy)
            if corr >= self.threshold:
                sync_len = self.cfg.sync_len
                sync_pattern = self.preamble[L - sync_len:]
                sync_energy = float(np.sqrt(np.sum(sync_pattern ** 2)))
                margin = self.cfg.sync_margin
                expected = i + L - sync_len
                lo = max(expected - margin, 0)
                hi = min(expected + margin, len(area) - sync_len)
                best_corr, best_off = -1.0, expected
                for j in range(lo, hi + 1):
                    w = area[j : j + sync_len]
                    dot = float(w @ sync_pattern)
                    we = float(np.sum(w ** 2))
                    c = dot / (np.sqrt(we) * sync_energy) if (
                        we > 1e-6 and sync_energy > 1e-6) else 0.0
                    if c > best_corr:
                        best_corr, best_off = c, j
                self.frame_start = self.offset + best_off + sync_len
                self.state = self.DECODING
                self.events.append(
                    {"kind": "preamble", "at": self.offset + i,
                     "refined": self.offset + best_off, "corr": corr})
                return i
            if i + 1 < window_count:
                leaving = area[i]
                entering = area[i + L]
                energy = max(energy - leaving * leaving
                             + entering * entering, 0.0)
        return window_count

    # -- decoder.rs:242-356
    def _decode_frame(self, out: list[Frame]):
        cfg = self.cfg
        hdr_samples = cfg.header_samples
        if len(self.buf) < self.frame_start + hdr_samples:
            return None
        hdr_bits = _decode_bits(
            cfg, self.buf[self.frame_start : self.frame_start + hdr_samples])
        hdr_bytes = bitops.bits_to_bytes_host(hdr_bits)
        ok_header = len(hdr_bytes) >= PHY_HEADER_BYTES and hdr_bytes[3] in (1, 2)
        if not ok_header:
            self.state = self.SEARCHING
            self.events.append({"kind": "bad_header", "at": self.frame_start})
            return hdr_samples
        data_len = (int(hdr_bytes[0]) << 8) | int(hdr_bytes[1])
        ftype = int(hdr_bytes[3])
        dst = int(hdr_bytes[6])
        if (ftype == FRAME_TYPE_DATA and data_len == 0) or (
                data_len > self.max_frame_bytes):
            self.state = self.SEARCHING
            self.events.append({"kind": "bad_len", "len": data_len})
            return 1
        total_bits = (PHY_HEADER_BYTES + data_len) * 8
        total_samples = cfg.samples_for_bits(total_bits)
        if len(self.buf) < self.frame_start + total_samples:
            return None
        frame_bits = _decode_bits(
            cfg, self.buf[self.frame_start : self.frame_start + total_samples])
        consumed = len(self.preamble) + cfg.samples_for_bits(len(frame_bits))
        if len(frame_bits) < total_bits:
            self.state = self.SEARCHING
            self.events.append({"kind": "line_decode_fail"})
            return consumed
        if dst != self.local_addr:
            self.state = self.SEARCHING
            self.events.append({"kind": "not_for_us", "dst": dst})
            return consumed
        frame = Frame.from_bits(frame_bits[:total_bits])
        self.state = self.SEARCHING
        if frame is not None:
            out.append(frame)
            self.events.append({"kind": "frame", "seq": frame.sequence})
        else:
            self.events.append({"kind": "crc_fail"})
        return consumed
