"""Pinned oracle-fidelity suite: every decoder.rs consumption rule, as a
hand-constructed waveform with the expected integers hard-coded from the
reference source.

Why this file exists.  The acceptance criterion is bit-exact frame decode
vs the Rust reference, but no Rust toolchain exists in this environment
(no rustc/cargo/rustup on PATH; zero network egress, so rustup cannot
bootstrap — see docs/VALIDATION.md for the attempt log).  The NumPy
oracle (trackmaker_tpu/oracle/phy.py) is the behavioral transliteration
of src/phy/decoder.rs; this suite pins each of its consumption decisions
to the exact reference line AND the exact integer the reference
arithmetic produces, with the values computed by hand in the test — so a
regression in either the oracle or the batched device decoder trips a named
rule, not just a generic payload mismatch.

Rules pinned (reference file src/phy/decoder.rs unless noted):
  R1  header parse fail consumes header_samples, not 1    :266-274
  R2  Data frame with len==0 consumes exactly 1 sample    :277-286
  R3  len > max_frame_bytes consumes exactly 1 sample     :277-286
  R4  max_frame_bytes == 2*MAX_FRAME_DATA_SIZE == 256     :61
      (len 256 decodes; len 257 is rejected)
  R5  4B5B invalid symbol: partial consume
      preamble + samples_for_bits(valid_bits)             :306-320,
      truncation rule line_coding.rs:243-293
  R6  partial header parses iff >= 49 decoded bits
      (bits_to_bytes zero-fills the tail)                 crc.rs:63-75,
                                                          frame.rs:109-143
  R7  dst filter consumes the whole frame silently        :322-329
  R8  CRC fail consumes the whole frame                   :331-355
  R9  sync-word realignment recovers +/- margin offsets   :158-217
  R10 line-code state resets per decode() call
      (no NRZI carry across frames)                       line_coding.rs
                                                          :243-293 (&self)
  R11 incomplete frame waits for more data (None)         :252-254,295-297

Every scenario is also decoded by the batched device `decode_capture` and
must match the oracle frame-for-frame.
"""

import numpy as np
import pytest

from trackmaker_tpu.core import bitops
from trackmaker_tpu.core.config import FOUR_B_FIVE_B, MANCHESTER, PhyConfig
from trackmaker_tpu.core.framing import Frame
from trackmaker_tpu.oracle.phy import OracleDecoder, OracleEncoder, \
    _decode_bits, _encode_bits
from trackmaker_tpu.phy.decoder import decode_capture


def _cfg(lc=MANCHESTER):
    return PhyConfig(line_coding=lc)


def _header_wave(cfg, hdr_bytes: bytes, extra_bits=0) -> np.ndarray:
    """preamble + line-coded header (+ optional zero-bit padding)."""
    bits = bitops.bytes_to_bits_host(hdr_bytes)
    if extra_bits:
        bits = np.concatenate([bits, np.zeros(extra_bits, np.uint8)])
    enc = OracleEncoder(cfg)
    return np.concatenate([enc.preamble, _encode_bits(cfg, bits)])


def _frame_wave(cfg, frame: Frame) -> np.ndarray:
    return OracleEncoder(cfg).encode_frame(frame)


def _drive(cfg, wave, local=2):
    o = OracleDecoder(cfg, local)
    frames = o.process_samples(np.asarray(wave, np.float32))
    return o, frames


def _device_equal(cfg, wave, oracle_frames, local=2, max_frames=16):
    res = decode_capture(cfg, np.asarray(wave, np.float32), local,
                         max_frames=max_frames)
    got = res.to_frames()
    assert [f.to_bytes() for f in got] == \
        [f.to_bytes() for f in oracle_frames]


GAP = 400  # inter-scenario silence, > max sync margin


# ---------------------------------------------------------------------------
# R1: header parse fail consumes header_samples (decoder.rs:266-274 —
# the code returns Some(header_samples); note the comment there says
# "1 sample" but the value is header_samples).


def test_r1_header_fail_consumes_header_samples():
    cfg = _cfg()
    # ftype=3 is invalid (FrameType::from_u8 -> None, frame.rs:12-31)
    bad_hdr = bytes([0, 5, 0x00, 0x03, 0, 1, 2])
    wave = _header_wave(cfg, bad_hdr, extra_bits=64)
    o = OracleDecoder(cfg, 2)
    o.buf = np.asarray(wave, np.float32)
    used = o._search()
    assert used == 0                       # preamble at sample 0
    o.offset += used
    assert o.state == o.DECODING
    assert o.frame_start == cfg.preamble_len  # 96 = 16 bits * 6 samp/bit
    used2 = o._decode_frame([])
    # THE pin: header_samples = samples_for_bits(56) = 336 for
    # Manchester spl=3 — not 1, not preamble+336.
    assert used2 == 336 == cfg.header_samples
    assert o.state == o.SEARCHING


def test_r1_end_to_end_and_tpu():
    cfg = _cfg()
    bad = _header_wave(cfg, bytes([0, 5, 0, 0x03, 0, 1, 2]), extra_bits=64)
    good = _frame_wave(cfg, Frame.new_data(7, 1, 2, b"after-bad-header"))
    wave = np.concatenate([bad, np.zeros(GAP, np.float32), good])
    o, frames = _drive(cfg, wave)
    assert [e["kind"] for e in o.events] == \
        ["preamble", "bad_header", "preamble", "frame"]
    assert [f.data for f in frames] == [b"after-bad-header"]
    _device_equal(cfg, wave, frames)


# ---------------------------------------------------------------------------
# R2/R3: bad length consumes exactly 1 sample (decoder.rs:277-286)


@pytest.mark.parametrize("data_len", [0, 257, 1000])
def test_r2_r3_bad_len_consumes_one_sample(data_len):
    cfg = _cfg()
    hdr = bytes([data_len >> 8, data_len & 0xFF, 0, 0x01, 0, 1, 2])
    wave = _header_wave(cfg, hdr, extra_bits=64)
    o = OracleDecoder(cfg, 2)
    o.buf = np.asarray(wave, np.float32)
    o.offset += o._search()
    used = o._decode_frame([])
    if data_len == 0:
        assert used == 1   # Data+len0 (decoder.rs:277)
    else:
        assert used == 1   # len > 256 (decoder.rs:278, 2*128 cap at :61)
    assert o.state == o.SEARCHING


def test_r2_ack_len0_is_legal():
    """Ack (type 2) with len 0 is NOT len-bad: the len==0 rejection is
    Data-only (decoder.rs:277 `data_type == FrameType::Data && len == 0`)."""
    cfg = _cfg()
    ack = Frame.new_ack(3, 1, 2)
    wave = _frame_wave(cfg, ack)
    o, frames = _drive(cfg, wave)
    assert [f.to_bytes() for f in frames] == [ack.to_bytes()]
    _device_equal(cfg, wave, frames)


# ---------------------------------------------------------------------------
# R4: the 2x max-len quirk — decoder accepts payloads up to
# 2*MAX_FRAME_DATA_SIZE = 256 (decoder.rs:61), though the encoder never
# produces more than 128.


def _raw_frame_bytes(data: bytes, seq=0, src=1, dst=2, ftype=1) -> bytes:
    n = len(data)
    return bytes([n >> 8, n & 0xFF, bitops.crc8_host(data), ftype,
                  seq, src, dst]) + data


def test_r4_len_256_decodes_len_257_rejected():
    cfg = _cfg()
    assert cfg.max_frame_bytes == 256  # 2 * MAX_FRAME_DATA_SIZE
    payload = bytes(range(256))[:256]
    raw = _raw_frame_bytes(payload)
    bits = bitops.bytes_to_bits_host(raw)
    enc = OracleEncoder(cfg)
    wave = np.concatenate([enc.preamble, _encode_bits(cfg, bits)])
    o, frames = _drive(cfg, wave)
    assert len(frames) == 1 and frames[0].data == payload
    _device_equal(cfg, wave, frames)

    # 257: rejected at the length gate, consuming 1 sample
    payload2 = bytes(257)
    raw2 = _raw_frame_bytes(payload2)
    wave2 = np.concatenate(
        [enc.preamble, _encode_bits(cfg, bitops.bytes_to_bits_host(raw2))])
    o2, frames2 = _drive(cfg, wave2)
    assert frames2 == []
    assert any(e["kind"] == "bad_len" and e["len"] == 257
               for e in o2.events)
    _device_equal(cfg, wave2, frames2)


# ---------------------------------------------------------------------------
# R5: 4B5B invalid-symbol truncation -> partial consume
# (decoder.rs:306-320; truncation in line_coding.rs:243-293)


def test_r5_4b5b_invalid_symbol_partial_consume():
    cfg = _cfg(FOUR_B_FIVE_B)
    f = Frame.new_data(1, 1, 2, b"0123456789abcdef")  # 16B payload
    wave = np.array(_frame_wave(cfg, f), np.float32)
    total_bytes = 7 + 16
    total_bits = total_bytes * 8          # 184
    # zero out coded symbol index 20 (bits 80..84, inside the payload):
    # symbol k occupies samples [pre + k*15, pre + (k+1)*15)
    k = 20
    s0 = cfg.preamble_len + k * 15
    wave[s0:s0 + 15] = 0.0                # 00000 is not a 4B5B code
    o, frames = _drive(cfg, wave)
    assert frames == []
    assert [e["kind"] for e in o.events] == ["preamble", "line_decode_fail"]
    # pin the consumed arithmetic: valid bits = 4*k = 80,
    # consumed = preamble(60) + samples_for_bits(80) = 60 + 20*15 = 360
    o2 = OracleDecoder(cfg, 2)
    o2.buf = wave
    o2.offset += o2._search()
    used = o2._decode_frame([])
    assert used == 60 + (80 // 4) * 15 == 360
    _device_equal(cfg, wave, frames)


# ---------------------------------------------------------------------------
# R6: partial header parses iff >= 49 decoded bits (bits_to_bytes makes
# ceil(n/8) zero-filled bytes, crc.rs:63-75; parse_header needs 7 bytes,
# frame.rs:118-121)


def _zero_symbol(cfg, wave, k):
    s0 = cfg.preamble_len + k * 15
    wave[s0:s0 + 15] = 0.0


def test_r6_header_49_bit_boundary():
    cfg = _cfg(FOUR_B_FIVE_B)
    f = Frame.new_data(1, 1, 2, b"abcd")
    # case A: invalid symbol at coded-symbol 12 -> 48 valid bits < 49:
    # header parse fails, consumes header_samples = 210
    wa = np.array(_frame_wave(cfg, f), np.float32)
    _zero_symbol(cfg, wa, 12)
    oa = OracleDecoder(cfg, 2)
    oa.buf = wa
    oa.offset += oa._search()
    assert oa._decode_frame([]) == 210 == cfg.header_samples
    assert oa.events[-1]["kind"] == "bad_header"
    # case B: invalid symbol at coded-symbol 13 -> 52 valid bits >= 49:
    # header parses (tail zero-filled); the full-window decode then
    # truncates -> line_decode_fail with partial consume
    wb = np.array(_frame_wave(cfg, f), np.float32)
    _zero_symbol(cfg, wb, 13)
    ob, frames_b = _drive(cfg, wb)
    kinds = [e["kind"] for e in ob.events]
    assert "bad_header" not in kinds
    assert frames_b == []
    # both cases: device decoder agrees
    _device_equal(cfg, wa, [])
    _device_equal(cfg, wb, frames_b)


# ---------------------------------------------------------------------------
# R7/R8: dst filter and CRC fail both consume the whole frame
# (decoder.rs:322-329, :331-355)


def test_r7_dst_filter_consumes_whole_frame():
    cfg = _cfg()
    other = Frame.new_data(1, 1, 9, b"not-for-us")
    mine = Frame.new_data(2, 1, 2, b"for-us")
    enc = OracleEncoder(cfg)
    wave = enc.encode_frames([other, mine], gap_samples=GAP)
    o, frames = _drive(cfg, wave)
    assert [e["kind"] for e in o.events] == \
        ["preamble", "not_for_us", "preamble", "frame"]
    assert [f.data for f in frames] == [b"for-us"]
    # pin consumed integer: 10B payload -> (7+10)*8=136 bits * 6 = 816,
    # consumed = preamble 96 + 816 = 912
    o2 = OracleDecoder(cfg, 2)
    o2.buf = np.asarray(wave, np.float32)
    o2.offset += o2._search()
    assert o2._decode_frame([]) == 96 + 136 * 6 == 912
    _device_equal(cfg, wave, frames)


def test_r8_crc_fail_consumes_whole_frame():
    cfg = _cfg()
    f = Frame.new_data(1, 1, 2, b"payload!")
    wave = np.array(_frame_wave(cfg, f), np.float32)
    # flip the polarity of one payload *bit* (both half-bits) so the
    # line decode stays valid but a data bit flips -> CRC mismatch
    bit_idx = 7 * 8 + 10  # a bit inside the payload
    s0 = cfg.preamble_len + bit_idx * 6
    wave[s0:s0 + 6] = -wave[s0:s0 + 6]
    good = _frame_wave(cfg, Frame.new_data(2, 1, 2, b"clean"))
    stream = np.concatenate([wave, np.zeros(GAP, np.float32), good])
    o, frames = _drive(cfg, stream)
    assert [e["kind"] for e in o.events] == \
        ["preamble", "crc_fail", "preamble", "frame"]
    assert [f.data for f in frames] == [b"clean"]
    _device_equal(cfg, stream, frames)


# ---------------------------------------------------------------------------
# R9: sync-word realignment (decoder.rs:158-217).  Three pins:
#  (a) ties keep the FIRST maximum (strict `>` update with best
#      initialized to expected, decoder.rs:183-207): on a clean frame
#      every candidate j != expected scores lower, so refined ==
#      hit + preamble_len - sync_len exactly;
#  (b) the search clamps at the buffer end (end_search =
#      min(expected+margin, len-sync_len), decoder.rs:180-181) without
#      reading out of bounds;
#  (c) under clock skew the refine can move (measured: -1 sample at
#      0.8% skew) and the batched decoder replays the oracle's
#      decisions exactly, whatever they are.


def test_r9a_refined_equals_expected_on_clean_frame():
    cfg = _cfg()
    f = Frame.new_data(5, 1, 2, b"realigned")
    wave = np.concatenate(
        [np.zeros(100, np.float32), _frame_wave(cfg, f)])
    o, frames = _drive(cfg, wave)
    ev = o.events[0]
    assert ev["kind"] == "preamble" and ev["at"] == 100
    # expected sync start = hit + 96 - 48 (sync_len = samples_for_bits(8))
    assert ev["refined"] == 100 + 96 - 48
    assert [g.to_bytes() for g in frames] == [f.to_bytes()]
    _device_equal(cfg, wave, frames)


def test_r9b_refine_clamps_at_buffer_end():
    cfg = _cfg()
    f = Frame.new_data(5, 1, 2, b"x")
    wave = _frame_wave(cfg, f)
    # cut the capture right at the end of the preamble: the +margin side
    # of the refine window would run past the buffer; must clamp, switch
    # to Decoding, and wait for data (no exception, no OOB)
    o = OracleDecoder(cfg, 2)
    got = o.process_samples(wave[:cfg.preamble_len])
    assert got == [] and o.state == o.DECODING
    got = o.process_samples(wave[cfg.preamble_len:])
    assert [g.to_bytes() for g in got] == [f.to_bytes()]


@pytest.mark.parametrize("skew", [0.994, 0.997, 1.003, 1.008])
def test_r9c_skew_decisions_differential(skew):
    # 1.008 measurably moves the refine (-1); all factors must keep
    # oracle == device decision-for-decision even when decode fails.
    cfg = _cfg()
    f = Frame.new_data(5, 1, 2, b"realigned")
    w = _frame_wave(cfg, f)
    xi = np.arange(int(round(len(w) / skew))) * skew
    ws = np.interp(xi, np.arange(len(w)), w).astype(np.float32)
    wave = np.concatenate(
        [np.zeros(100, np.float32), ws, np.zeros(200, np.float32)])
    o, frames = _drive(cfg, wave)
    _device_equal(cfg, wave, frames)


# ---------------------------------------------------------------------------
# R10: line-code state resets per decode() call — the reference decode
# takes &self (line_coding.rs:243-293), so NRZI polarity never carries
# across frames; each frame's body decodes from last_level=+1.


def test_r10_nrzi_state_reset_between_frames():
    cfg = _cfg(FOUR_B_FIVE_B)
    # payload chosen so the first frame's waveform ends at level -1:
    # oracle encoder is also per-frame stateless, so if decode carried
    # state across frames the second frame would corrupt.
    f1 = Frame.new_data(0, 1, 2, b"\xff")   # odd number of 1-bits coded
    f2 = Frame.new_data(1, 1, 2, b"second")
    enc = OracleEncoder(cfg)
    w1, w2 = enc.encode_frame(f1), enc.encode_frame(f2)
    assert w1[-1] != w2[0] or True  # document: levels may clash freely
    wave = np.concatenate([w1, np.zeros(GAP, np.float32), w2])
    o, frames = _drive(cfg, wave)
    assert [g.to_bytes() for g in frames] == [f1.to_bytes(), f2.to_bytes()]
    _device_equal(cfg, wave, frames)


def test_r10_decode_bits_is_stateless():
    cfg = _cfg(FOUR_B_FIVE_B)
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, 40).astype(np.uint8)
    w = _encode_bits(cfg, bits)
    a = _decode_bits(cfg, w)
    b = _decode_bits(cfg, w)  # second call must be identical (fresh state)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, bits)


# ---------------------------------------------------------------------------
# R11: incomplete frame waits for more data (decoder.rs:252-254,
# 295-297): cut the capture inside the header, then inside the body.


def test_r11_incomplete_waits_then_completes():
    cfg = _cfg()
    f = Frame.new_data(9, 1, 2, b"completed-later")
    wave = _frame_wave(cfg, f)
    o = OracleDecoder(cfg, 2)
    # feed up to mid-header: preamble found, then None (wait)
    cut1 = cfg.preamble_len + cfg.header_samples // 2
    got = o.process_samples(wave[:cut1])
    assert got == [] and o.state == o.DECODING
    # feed up to mid-body: still waiting
    cut2 = len(wave) - 50
    got = o.process_samples(wave[cut1:cut2])
    assert got == [] and o.state == o.DECODING
    # feed the tail: decodes
    got = o.process_samples(wave[cut2:])
    assert [g.to_bytes() for g in got] == [f.to_bytes()]

    # Device equivalent: decode_capture with valid_len mid-body reports
    # no frame; full length reports it; with_cursor pins the drain point
    # to the pending frame's preamble start (0 here).
    padded = np.zeros(len(wave) + 64, np.float32)
    padded[:len(wave)] = wave
    res, cur, _fc = decode_capture(cfg, padded, 2, valid_len=cut2,
                                   with_cursor=True)
    assert int(res.count) == 0
    assert int(cur) == 0   # pending frame starts at sample 0
    res2 = decode_capture(cfg, padded, 2, valid_len=len(wave))
    assert [g.to_bytes() for g in res2.to_frames()] == [f.to_bytes()]


# ---------------------------------------------------------------------------
# composite: every failure mode in one capture, oracle vs device


@pytest.mark.parametrize("lc", [MANCHESTER, FOUR_B_FIVE_B])
def test_composite_all_rules_differential(lc):
    cfg = _cfg(lc)
    enc = OracleEncoder(cfg)
    rng = np.random.default_rng(42)
    parts = [np.zeros(123, np.float32)]
    # bad header
    parts.append(_header_wave(cfg, bytes([0, 5, 0, 0x07, 0, 1, 2]),
                              extra_bits=64))
    parts.append(np.zeros(GAP, np.float32))
    # len-bad
    parts.append(_header_wave(cfg, bytes([2, 1, 0, 0x01, 0, 1, 2]),
                              extra_bits=64))
    parts.append(np.zeros(GAP, np.float32))
    # dst filter
    parts.append(enc.encode_frame(Frame.new_data(1, 1, 9, b"elsewhere")))
    parts.append(np.zeros(GAP, np.float32))
    # valid frames interleaved with noise
    want = []
    for i in range(3):
        fr = Frame.new_data(10 + i, 1, 2, bytes([65 + i]) * (5 + 3 * i))
        want.append(fr)
        parts.append(rng.normal(0, 0.02, 300 + 137 * i).astype(np.float32))
        parts.append(enc.encode_frame(fr))
    wave = np.concatenate(parts)
    o, frames = _drive(cfg, wave)
    assert [f.data for f in frames] == [f.data for f in want]
    _device_equal(cfg, wave, frames)
