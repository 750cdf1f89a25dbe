"""Viterbi-coded line-coded PHYs — FEC under the CRC for the
Manchester and 4B5B+NRZI waveforms, with an optional rate-3/4
punctured mode.

Motivation anchor: the reference measured 5-15% frame loss on real
acoustic links and recovered purely by ARQ retransmission
(docs/proj/report.md:532); every lost frame costs a full timeout +
airtime.  A rate-1/2 K=7 convolutional code under the CRC converts most
of those losses into clean decodes, moving the frame-loss cliff left
(see ``tests/test_coded_phy.py``) and cutting retransmissions at equal
SNR (``bench/sweep.py`` contended runs).  Puncturing to rate 3/4
(core/convcode.py) recovers 1.5x of the airtime when the channel is
good enough.

Wire format per frame (vs ``src/phy/frame.rs`` framing, which this
wraps): preamble ‖ wire(interleaved [punctured] conv(header 56b)) ‖
wire(interleaved [punctured] conv(payload 8L)).  Header and payload are
independently flushed conv blocks so the length Viterbi-decodes from a
fixed-size prefix; each block's waveform restarts the line code fresh
(NRZI level +1), keeping blocks independent.

Soft metrics per waveform:

* **Manchester**: mean(second half) - mean(first half) per bit — the
  sign convention of ``line_coding.manchester_decode``.
* **4B5B+NRZI**: the level-transition metric ``-l[t-1]*l[t]``
  (positive = transition = wire bit 1, ``line_coding.rs:243-265``'s
  comparison as a product), then a max-log-MAP soft demapper over the
  16-entry 4B5B code table: LLR of data bit j = max codeword score
  with bit j=1 minus max with bit j=0.  Wire-bit softs never reach the
  Viterbi directly — only table-consistent 4-bit LLRs do, so the 4B5B
  run-length guarantees survive coding.

Device shape: soft demod is dynamic-slice + reshape + mean + one
(n_sym, 5) x (5, 16) matmul (fixed shapes, static max sizes); Viterbi
is the vectorized add-compare-select scan in core/convcode.py.  The
streaming facade mirrors OfdmStreamPhyV2 so the MAC stack runs
unchanged over either PHY (duck type: encode_frames / process_samples
/ reset / frame_samples).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from trackmaker_tpu.core import bitops
from trackmaker_tpu.core.config import FOUR_B_FIVE_B, MANCHESTER, PhyConfig
from trackmaker_tpu.core.convcode import (
    block_interleaver,
    conv_encode,
    depuncture_34,
    punctured_len_34,
    puncture_34,
    viterbi_decode,
)
from trackmaker_tpu.core.framing import Frame
from trackmaker_tpu.phy import line_coding


@functools.partial(jax.jit, static_argnums=(0, 2))
def _soft_bits(spl: int, padded: jax.Array, n_bits: int,
               start: jax.Array) -> jax.Array:
    """Soft Manchester values for n_bits bits starting at sample
    `start`: mean(second half) - mean(first half) (positive = bit 1,
    matching line_coding.manchester_decode's comparison)."""
    seg = jax.lax.dynamic_slice(padded, (start,), (n_bits * 2 * spl,))
    halves = jnp.mean(seg.reshape(n_bits, 2, spl), axis=-1)
    return halves[:, 1] - halves[:, 0]


@functools.lru_cache(maxsize=2)
def _demap_tables() -> tuple[np.ndarray, np.ndarray]:
    """(codewords ±1 (16, 5), data-bit membership (16, 4))."""
    cw = ((line_coding.FOURB_FIVEB_ENCODE[:, None]
           >> np.arange(4, -1, -1)) & 1).astype(np.float32) * 2.0 - 1.0
    nb = ((np.arange(16)[:, None]
           >> np.arange(3, -1, -1)) & 1).astype(bool)
    return cw, nb


@functools.partial(jax.jit, static_argnums=(0, 2))
def _soft_bits_4b5b(spl: int, padded: jax.Array, n_sym: int,
                    start: jax.Array) -> jax.Array:
    """Max-log-MAP soft 4B5B demap of n_sym symbols starting at sample
    `start`: level averages -> transition metrics (fresh NRZI level +1)
    -> per-data-bit LLRs over the 16-codeword table.  Returns
    f32[n_sym * 4], positive = coded bit 1."""
    n_lvl = n_sym * 5
    seg = jax.lax.dynamic_slice(padded, (start,), (n_lvl * spl,))
    avg = jnp.mean(seg.reshape(n_lvl, spl), axis=-1)
    prev = jnp.concatenate([jnp.ones(1, avg.dtype), avg[:-1]])
    tr = -(prev * avg)                       # >0 <=> transition <=> 1
    cw, nb = _demap_tables()
    scores = jnp.dot(tr.reshape(n_sym, 5), jnp.asarray(cw).T,
                     precision=jax.lax.Precision.HIGHEST)  # (n_sym, 16)
    nbj = jnp.asarray(nb)                                 # (16, 4)
    neg_inf = jnp.float32(-1e30)
    pos = jnp.max(jnp.where(nbj.T[None], scores[:, None, :], neg_inf),
                  axis=-1)                                # (n_sym, 4)
    neg = jnp.max(jnp.where(~nbj.T[None], scores[:, None, :], neg_inf),
                  axis=-1)
    return (pos - neg).reshape(n_sym * 4)


class _CodedPhyBase:
    """Shared streaming logic for the coded line-coded PHYs."""

    HDR_BITS = 56
    HDR_CODED = 2 * (56 + 6)          # 124 mother-code bits

    def __init__(self, cfg: PhyConfig, max_frame_bytes: int,
                 local_addr: int | None, rate34: bool):
        self.cfg = cfg
        self.local_addr = local_addr
        self.max_frame_bytes = max_frame_bytes
        self.rate34 = rate34
        self.pre = line_coding.preamble_waveform(cfg)
        self.preamble_len = len(self.pre)
        self.hdr_kept = self._kept(self.HDR_CODED)
        self.max_kept = self._kept_payload(max_frame_bytes - 7)
        self._buf = np.zeros(0, np.float32)

    # -- code arithmetic ----------------------------------------------

    def _kept(self, n_coded: int) -> int:
        return punctured_len_34(n_coded) if self.rate34 else n_coded

    @staticmethod
    def _payload_coded(n_payload_bytes: int) -> int:
        return 2 * (8 * n_payload_bytes + 6)

    def _kept_payload(self, n_payload_bytes: int) -> int:
        return self._kept(self._payload_coded(n_payload_bytes))

    def frame_samples(self, n_payload: int) -> int:
        return (self.preamble_len + self._wire_samples(self.hdr_kept)
                + self._wire_samples(self._kept_payload(n_payload)))

    # -- waveform hooks (subclass) ------------------------------------

    def _wire_samples(self, n_kept: int) -> int:
        raise NotImplementedError

    def _encode_kept(self, kept_bits: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _soft_kept(self, padded: jax.Array, n_kept_max: int,
                   start: int) -> np.ndarray:
        """Soft values for the first n_kept_max transmitted bits of a
        block starting at sample `start` (static max size)."""
        raise NotImplementedError

    def _soft_kept_traced(self, padded: jax.Array, n_kept_max: int,
                          start: jax.Array) -> jax.Array:
        """Traceable form of :meth:`_soft_kept` (jnp in, jnp out) for
        the batched decoder; `start` may be a traced scalar."""
        raise NotImplementedError

    # -- batched device decode (equal-length frames) ---------------------

    def batched_decode_fn(self, n_frames: int, payload_len: int):
        """Build a jittable ``x[B, T] -> (starts[B, F], bits[B, F,
        56 + 8*payload_len])`` batch decoder for equal-length coded
        frames: pattern sync (block-bitmap crossings + masked-argmax
        refine), soft demod per block, deinterleave (static inverse
        permutation), [depuncture,] and the vectorized-ACS Viterbi —
        one fixed-shape program, vmapped over captures and frames.
        This is the path the bench's coded rows measure; the streaming
        `process_samples` facade stays the
        MAC-side spec (tests pin the two against each other)."""
        from trackmaker_tpu.sync import find_pattern_starts

        cfg = self.cfg
        kept_h, kept_p = self.hdr_kept, self._kept_payload(payload_len)
        hdr_wire = self._wire_samples(kept_h)
        pay_wire = self._wire_samples(kept_p)
        pay_coded = self._payload_coded(payload_len)
        n_pay_bits = 8 * payload_len
        inv_h = np.argsort(block_interleaver(kept_h))
        inv_p = np.argsort(block_interleaver(kept_p))
        pre_np = np.asarray(self.pre)
        tail = (self.preamble_len + hdr_wire + pay_wire
                + 16 * cfg.samples_per_level + 64)

        # static-permutation deinterleave as a one-hot matmul:
        # P[i, j] = 1 iff j == inv[i] has exactly one 1.0 per output,
        # so the HIGHEST-precision matmul is an exact f32 pick
        pm_h = np.zeros((kept_h, kept_h), np.float32)
        pm_h[np.arange(kept_h), inv_h] = 1.0
        pm_p = np.zeros((kept_p, kept_p), np.float32)
        pm_p[np.arange(kept_p), inv_p] = 1.0

        def decode_block(soft, pm, n_coded, n_bits):
            deint = jnp.einsum("...j,ij->...i", soft, jnp.asarray(pm),
                               precision=jax.lax.Precision.HIGHEST)
            if self.rate34:
                deint = depuncture_34(deint, n_coded)
            return viterbi_decode(deint, n_bits, soft=True)

        frame_len = self.frame_samples(payload_len)

        def one(rx):
            starts = find_pattern_starts(
                rx, pre_np, cfg.correlation_threshold, n_frames,
                min_sep=frame_len)
            pad = jnp.concatenate(
                [rx.astype(jnp.float32), jnp.zeros(tail, jnp.float32)])
            body = jnp.maximum(starts, 0) + self.preamble_len

            def frame(b):
                sh = self._soft_kept_traced(pad, kept_h, b)
                hdr = decode_block(sh[:kept_h], pm_h,
                                   self.HDR_CODED, self.HDR_BITS)
                sp = self._soft_kept_traced(pad, kept_p, b + hdr_wire)
                pay = decode_block(sp[:kept_p], pm_p,
                                   pay_coded, n_pay_bits)
                return jnp.concatenate([hdr, pay])

            return starts, jax.vmap(frame)(body)

        return jax.jit(jax.vmap(one))

    def decode_equal_frames(self, caps: np.ndarray, n_frames: int,
                            payload_len: int) -> list[list[Frame]]:
        """Host facade over :meth:`batched_decode_fn`: decode a batch
        of captures each holding `n_frames` equal-length frames;
        returns per-capture CRC-valid Frame lists."""
        fn = self.batched_decode_fn(n_frames, payload_len)
        starts, bits = fn(jnp.asarray(caps, jnp.float32))
        starts, bits = np.asarray(starts), np.asarray(bits)
        out: list[list[Frame]] = []
        for b in range(bits.shape[0]):
            row = []
            for k in range(bits.shape[1]):
                if starts[b, k] < 0:
                    continue
                f = Frame.from_bits(bits[b, k])
                if f is None:
                    continue
                if (self.local_addr is not None
                        and f.dst != self.local_addr):
                    continue
                row.append(f)
            out.append(row)
        return out

    # -- encoder side --------------------------------------------------

    def _encode_block(self, bits: np.ndarray) -> np.ndarray:
        coded = conv_encode(jnp.asarray(bits))
        if self.rate34:
            coded = puncture_34(coded)
        kept = np.asarray(coded)
        return self._encode_kept(kept[block_interleaver(len(kept))])

    def encode_frame(self, frame: Frame) -> np.ndarray:
        fb = frame.to_bytes()
        hdr = bitops.bytes_to_bits_host(fb[:7])
        pay = bitops.bytes_to_bits_host(fb[7:]) if len(fb) > 7 \
            else np.zeros(0, np.uint8)
        return np.concatenate([self.pre, self._encode_block(hdr),
                               self._encode_block(pay)])

    def encode_frames(self, frames: list[Frame],
                      gap_samples: int = 256) -> np.ndarray:
        parts = []
        for i, f in enumerate(frames):
            parts.append(self.encode_frame(f))
            if i < len(frames) - 1:
                parts.append(np.zeros(gap_samples, np.float32))
        return np.concatenate(parts) if parts else np.zeros(0, np.float32)

    # -- streaming decoder side ----------------------------------------

    def reset(self) -> None:
        self._buf = np.zeros(0, np.float32)

    def _decode_block(self, soft_kept: np.ndarray, n_coded: int,
                      n_bits: int) -> np.ndarray:
        deint = np.empty_like(soft_kept)
        deint[block_interleaver(len(soft_kept))] = soft_kept
        s = jnp.asarray(deint)
        if self.rate34:
            s = depuncture_34(s, n_coded)
        return np.asarray(viterbi_decode(s, n_bits, soft=True))

    def process_samples(self, samples: np.ndarray) -> list[Frame]:
        from trackmaker_tpu.sync import correlate
        self._buf = np.concatenate(
            [self._buf, np.asarray(samples, np.float32)])
        cfg = self.cfg
        if len(self._buf) < self.preamble_len + 1:
            return []
        out: list[Frame] = []
        bucket = 4096
        hdr_wire = self._wire_samples(self.hdr_kept)
        need = (len(self._buf) + hdr_wire
                + self._wire_samples(self.max_kept) + 8)
        while bucket < need:
            bucket *= 2
        padded = np.zeros(bucket, np.float32)
        padded[: len(self._buf)] = self._buf
        pj = jnp.asarray(padded)
        corr = np.asarray(correlate.normalized_xcorr(
            pj, jnp.asarray(self.pre)))
        hits = np.nonzero(
            corr[: max(len(self._buf) - self.preamble_len + 1, 0)]
            >= cfg.correlation_threshold)[0]
        consumed = 0
        k = 0
        # the 0x33 pattern bytes are 4-bit-periodic, so a partially
        # overlapped window can cross a lowered threshold a full
        # pattern period before true alignment — refine over the whole
        # preamble span (the next frame is >= frame_samples away)
        refine = self.preamble_len
        while k < len(hits):
            i = int(hits[k])
            if i < consumed:
                k += 1
                continue
            s = i + int(np.argmax(corr[i: i + refine]))
            body = s + self.preamble_len
            if body + hdr_wire > len(self._buf):
                break  # header still arriving
            soft_h = self._soft_kept(pj, self.hdr_kept, body)
            hdr_bits = self._decode_block(
                soft_h[: self.hdr_kept], self.HDR_CODED, self.HDR_BITS)
            hdr = np.packbits(hdr_bits)
            data_len = (int(hdr[0]) << 8) | int(hdr[1])
            if data_len > self.max_frame_bytes - 7:
                consumed = s + self.preamble_len
                k += 1
                continue
            kept_p = self._kept_payload(data_len)
            frame_end = (body + hdr_wire + self._wire_samples(kept_p))
            if frame_end > len(self._buf):
                break  # wait for the rest of this frame
            if data_len:
                soft_p = self._soft_kept(
                    pj, self.max_kept, body + hdr_wire)
                pay_bits = self._decode_block(
                    soft_p[:kept_p], self._payload_coded(data_len),
                    8 * data_len)
            else:
                pay_bits = np.zeros(0, np.uint8)
            f = Frame.from_bits(np.concatenate([hdr_bits, pay_bits]))
            consumed = frame_end
            k += 1
            if f is None:
                continue
            if self.local_addr is not None and f.dst != self.local_addr:
                continue
            out.append(f)
        if consumed:
            keep = max(consumed - (self.preamble_len - 1), 0)
            self._buf = self._buf[keep:]
        elif len(self._buf) > 10 * 48_000:
            self._buf = self._buf[-self.preamble_len:]
        return out


class CodedManchesterPhy(_CodedPhyBase):
    """Streaming coded-Manchester PHY (MAC duck type)."""

    def __init__(self, cfg: PhyConfig = PhyConfig(),
                 max_frame_bytes: int = 263,
                 local_addr: int | None = None,
                 rate34: bool = False):
        assert cfg.line_coding == MANCHESTER, \
            "CodedManchesterPhy is defined on the Manchester waveform"
        super().__init__(cfg, max_frame_bytes, local_addr, rate34)

    def _wire_samples(self, n_kept: int) -> int:
        return n_kept * 2 * self.cfg.samples_per_level

    def _encode_kept(self, kept_bits: np.ndarray) -> np.ndarray:
        return np.asarray(line_coding.manchester_encode(
            jnp.asarray(kept_bits), self.cfg.samples_per_level))

    def _soft_kept(self, padded, n_kept_max, start):
        return np.asarray(_soft_bits(
            self.cfg.samples_per_level, padded, n_kept_max,
            jnp.int32(start)))

    def _soft_kept_traced(self, padded, n_kept_max, start):
        return _soft_bits(self.cfg.samples_per_level, padded,
                          n_kept_max, start.astype(jnp.int32))


class CodedFourB5BPhy(_CodedPhyBase):
    """Streaming coded 4B5B+NRZI PHY (MAC duck type).

    1.6x the coded-Manchester wire density (3.75 vs 6 samples per
    transmitted bit at spl=3) at the same code rate; the soft demapper
    marginalizes the transition metrics over the 4B5B table
    (max-log-MAP), so invalid 5-bit symbols are never "decoded" — the
    nearest valid codewords compete directly in LLR space."""

    def __init__(self, cfg: PhyConfig = PhyConfig(
                     line_coding=FOUR_B_FIVE_B),
                 max_frame_bytes: int = 263,
                 local_addr: int | None = None,
                 rate34: bool = False):
        assert cfg.line_coding == FOUR_B_FIVE_B, \
            "CodedFourB5BPhy is defined on the 4B5B+NRZI waveform"
        super().__init__(cfg, max_frame_bytes, local_addr, rate34)

    @staticmethod
    def _n_sym(n_kept: int) -> int:
        return -(-n_kept // 4)

    def _wire_samples(self, n_kept: int) -> int:
        return self._n_sym(n_kept) * 5 * self.cfg.samples_per_level

    def _encode_kept(self, kept_bits: np.ndarray) -> np.ndarray:
        pad = (-len(kept_bits)) % 4
        if pad:
            kept_bits = np.concatenate(
                [kept_bits, np.zeros(pad, np.uint8)])
        return np.asarray(line_coding.fourb5b_encode(
            jnp.asarray(kept_bits), self.cfg.samples_per_level))

    def _soft_kept(self, padded, n_kept_max, start):
        return np.asarray(_soft_bits_4b5b(
            self.cfg.samples_per_level, padded, self._n_sym(n_kept_max),
            jnp.int32(start)))

    def _soft_kept_traced(self, padded, n_kept_max, start):
        return _soft_bits_4b5b(
            self.cfg.samples_per_level, padded, self._n_sym(n_kept_max),
            start.astype(jnp.int32))[:n_kept_max]
