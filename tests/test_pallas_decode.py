"""Speculative decoder (phy/spec_decode.py) vs the exact scan.
Covers the decision paths the walk must
replay exactly: header-fail mid-run landings, len-bad single-sample
consumption, dst filter, CRC fail, evil payloads embedding preamble
bytes, incomplete frames at the capture end (valid_len), max_frames
capping, and candidate-table overflow -> exact fallback."""

import numpy as np

import jax.numpy as jnp

from trackmaker_tpu.core import bitops
from trackmaker_tpu.core.config import PhyConfig
from trackmaker_tpu.core.framing import Frame
from trackmaker_tpu.oracle.phy import OracleEncoder
from trackmaker_tpu.phy.decoder import decode_capture
from trackmaker_tpu.phy.spec_decode import decode_capture_spec


def _cfg():
    return PhyConfig()


def _masked(res, b=None):
    sel = (lambda a: a) if b is None else (lambda a: a[b])
    v = np.asarray(sel(res.valid))
    return sorted(
        (int(s), int(q), bytes(fb[:7 + int(ln)]))
        for s, q, ln, fb, ok in zip(
            np.asarray(sel(res.start)), np.asarray(sel(res.sequence)),
            np.asarray(sel(res.length)), np.asarray(sel(res.frame_bytes)),
            v) if ok)


def _spec_vs_exact(cfg, wave, local=2, max_frames=16, n_cand=64,
                   valid_len=None, expect_ok=True):
    x = np.asarray(wave, np.float32)[None]
    res, ok = decode_capture_spec(
        cfg, x, local, max_frames=max_frames, n_cand=n_cand,
        valid_len=valid_len)
    assert bool(np.asarray(ok)[0]) == expect_ok
    exact = decode_capture(cfg, jnp.asarray(wave), local,
                           max_frames=max_frames, valid_len=valid_len)
    if expect_ok:
        assert _masked(res, 0) == _masked(exact)
    return res, exact


def _raw(data, seq=0, src=1, dst=2, ftype=1):
    n = len(data)
    return bytes([n >> 8, n & 0xFF, bitops.crc8_host(data), ftype,
                  seq, src, dst]) + data


def test_spec_basic_frames_and_noise():
    cfg = _cfg()
    enc = OracleEncoder(cfg)
    rng = np.random.default_rng(0)
    parts = []
    for i in range(5):
        parts.append(rng.normal(0, 0.03, 300 + 211 * i).astype(np.float32))
        parts.append(enc.encode_frame(
            Frame.new_data(i, 1, 2, bytes([i]) * (3 + 5 * i))))
    wave = np.concatenate(parts + [np.zeros(1500, np.float32)])
    _spec_vs_exact(cfg, wave)


def test_spec_evil_embedded_preamble():
    """Payload embeds preamble bytes + a CRC-valid frame: the walk must
    consume past the embedded hit exactly like sequential decode."""
    cfg = _cfg()
    enc = OracleEncoder(cfg)
    evil = Frame.new_data(1, 1, 2, bytes([0x33, 0x5A]) + _raw(b"EVIL",
                                                              seq=99))
    tail = Frame.new_data(2, 1, 2, b"tail")
    wave = np.concatenate([
        np.zeros(777, np.float32), enc.encode_frame(evil),
        np.zeros(400, np.float32), enc.encode_frame(tail),
        np.zeros(600, np.float32)])
    res, _ = _spec_vs_exact(cfg, wave)
    assert all(q != 99 for _, q, _ in _masked(res, 0))


def test_spec_dst_filter_and_crc_fail():
    cfg = _cfg()
    enc = OracleEncoder(cfg)
    w1 = enc.encode_frame(Frame.new_data(1, 1, 9, b"foreign"))
    w2 = np.array(enc.encode_frame(Frame.new_data(2, 1, 2, b"corrupt!")),
                  np.float32)
    bit = 7 * 8 + 4
    w2[96 + bit * 6: 96 + (bit + 1) * 6] *= -1.0  # flip a payload bit
    w3 = enc.encode_frame(Frame.new_data(3, 1, 2, b"good"))
    wave = np.concatenate([
        w1, np.zeros(300, np.float32), w2, np.zeros(300, np.float32), w3])
    res, _ = _spec_vs_exact(cfg, wave)
    assert [q for _, q, _ in _masked(res, 0)] == [3]


def test_spec_bad_len_and_bad_type_headers():
    cfg = _cfg()
    enc = OracleEncoder(cfg)
    from trackmaker_tpu.oracle.phy import _encode_bits

    def hdr_wave(hb):
        bits = np.concatenate(
            [bitops.bytes_to_bits_host(hb), np.zeros(64, np.uint8)])
        return np.concatenate([enc.preamble, _encode_bits(cfg, bits)])

    wave = np.concatenate([
        hdr_wave(bytes([0, 0, 0, 1, 0, 1, 2])),     # Data len=0
        np.zeros(300, np.float32),
        hdr_wave(bytes([9, 9, 0, 7, 0, 1, 2])),     # bad frame type
        np.zeros(300, np.float32),
        enc.encode_frame(Frame.new_data(5, 1, 2, b"after")),
        np.zeros(300, np.float32)])
    res, _ = _spec_vs_exact(cfg, wave)
    assert [q for _, q, _ in _masked(res, 0)] == [5]


def test_spec_incomplete_frame_valid_len():
    cfg = _cfg()
    enc = OracleEncoder(cfg)
    w = enc.encode_frame(Frame.new_data(4, 1, 2, b"cut-off-frame"))
    full = np.concatenate([np.zeros(200, np.float32), w,
                           np.zeros(500, np.float32)])
    cut = 200 + len(w) - 40
    res, _ = _spec_vs_exact(cfg, full, valid_len=cut)
    assert _masked(res, 0) == []
    _spec_vs_exact(cfg, full)  # full length decodes


def test_spec_max_frames_cap():
    cfg = _cfg()
    enc = OracleEncoder(cfg)
    frames = [Frame.new_data(i, 1, 2, bytes([i]) * 4) for i in range(8)]
    wave = enc.encode_frames(frames, gap_samples=250)
    # cap = 3 attempts: both paths decode only the first 3
    res, exact = _spec_vs_exact(cfg, wave, max_frames=3)
    assert len(_masked(res, 0)) == 3


def test_spec_dense_hits_complete_or_flagged():
    """Back-to-back preambles: with the fused per-128-lag-row hit
    extraction either every hit is captured (and decisions equal the
    exact path) or the overflow flag trips — never silent truncation.
    The 96-sample preamble spacing gives <= 2 hits per row, so this
    capture now decodes WITHOUT a fallback (the old 512-lag-block
    extractor had to flag it)."""
    cfg = _cfg()
    enc = OracleEncoder(cfg)
    wave = np.concatenate([enc.preamble] * 8 + [np.zeros(3000, np.float32)])
    res, exact = _spec_vs_exact(cfg, wave, max_frames=8)
    assert _masked(res, 0) == _masked(exact)

    # the per-row cap itself: counts > rpb must trip overflow
    from trackmaker_tpu.phy.spec_decode import _compact_hit_rows
    rows = np.full((1, 4, 16), 2**30, np.int32)
    rows[..., 4:] = 0
    rows[0, 1, :4] = [128, 130, 140, 150]
    rows[0, 1, 5:9] = np.asarray([0.91, 0.92, 0.93, 0.94],
                                 np.float32).view(np.int32)
    rows[0, 1, 4] = 5                       # truth: 5 hits in this row
    _c, _cv, _nv, overflow = _compact_hit_rows(jnp.asarray(rows), 16)
    assert bool(np.asarray(overflow)[0])
    rows[0, 1, 4] = 4
    cand, cv, _nv, overflow = _compact_hit_rows(jnp.asarray(rows), 16)
    assert not bool(np.asarray(overflow)[0])
    assert np.asarray(cand)[0, :4].tolist() == [128, 130, 140, 150]
    np.testing.assert_allclose(np.asarray(cv)[0, :4],
                               [0.91, 0.92, 0.93, 0.94], rtol=1e-6)


def test_spec_promiscuous_local_addr():
    cfg = _cfg()
    enc = OracleEncoder(cfg)
    wave = np.concatenate([
        enc.encode_frame(Frame.new_data(1, 1, 9, b"any")),
        np.zeros(300, np.float32),
        enc.encode_frame(Frame.new_data(2, 1, 5, b"dst")),
        np.zeros(300, np.float32)])
    _spec_vs_exact(cfg, wave, local=-1)


def test_fast_wrapper_spec_fallback_merge(monkeypatch):
    """decode_capture_fast on a batch where one row overflows its
    candidate table: the merged output must equal per-row references
    (the overflowed row re-decodes through the exact scan)."""
    from trackmaker_tpu.phy import decoder, spec_decode
    from trackmaker_tpu.phy.decoder import decode_capture_fast

    cfg = _cfg()
    enc = OracleEncoder(cfg)
    few = np.concatenate([
        enc.encode_frame(Frame.new_data(1, 1, 2, b"one")),
        np.zeros(600, np.float32)])
    many = np.concatenate(
        [np.concatenate([enc.encode_frame(
            Frame.new_data(i, 1, 2, bytes([i]) * 3)),
            np.zeros(150, np.float32)]) for i in range(6)])
    t = max(len(few), len(many))
    batch = np.zeros((2, t), np.float32)
    batch[0, :len(few)] = few
    batch[1, :len(many)] = many

    calls = []
    orig = spec_decode.decode_capture_spec_jit

    def small_table(cfg, x, addr, max_frames=64, valid_len=None):
        res, ok = orig(cfg, x, addr, max_frames=max_frames, n_cand=4,
                       valid_len=valid_len)
        calls.append(np.asarray(ok))
        return res, ok

    monkeypatch.setattr(spec_decode, "decode_capture_spec_jit", small_table)
    got = decode_capture_fast(cfg, jnp.asarray(batch), 2, max_frames=16)
    assert calls and calls[0].tolist() == [True, False]
    for b in range(2):
        want = decoder.decode_capture(cfg, jnp.asarray(batch[b]), 2,
                                      max_frames=16)
        assert _masked(got, b) == _masked(want)
    assert len(_masked(got, 1)) == 6


# ---------------------------------------------------------------------------
# 4B5B speculative kernel


def _cfg4():
    from trackmaker_tpu.core.config import FOUR_B_FIVE_B
    return PhyConfig(line_coding=FOUR_B_FIVE_B)


def test_spec_4b5b_basic_and_failures():
    cfg = _cfg4()
    enc = OracleEncoder(cfg)
    rng = np.random.default_rng(1)
    parts = [rng.normal(0, 0.03, 400).astype(np.float32)]
    parts.append(enc.encode_frame(Frame.new_data(1, 1, 2, b"first")))
    parts.append(np.zeros(300, np.float32))
    parts.append(enc.encode_frame(Frame.new_data(2, 1, 9, b"foreign")))
    parts.append(np.zeros(300, np.float32))
    crc_bad = np.array(enc.encode_frame(Frame.new_data(3, 1, 2, b"badcrc")),
                       np.float32)
    bit = 7 * 8 + 3
    sym = bit // 4  # flip one coded symbol's samples -> invalid symbol
    crc_bad[cfg.preamble_len + sym * 15: cfg.preamble_len
            + sym * 15 + 15] *= -1.0
    parts.append(crc_bad)
    parts.append(np.zeros(300, np.float32))
    parts.append(enc.encode_frame(Frame.new_data(4, 1, 2, b"last")))
    parts.append(np.zeros(600, np.float32))
    wave = np.concatenate(parts)
    res, _ = _spec_vs_exact(cfg, wave)
    assert [q for _, q, _ in _masked(res, 0)] == [1, 4]


def test_spec_4b5b_zero_levels_trip_conformance():
    """Exact zero samples inside an attempted frame engage the
    reference's last-valid-average skip (line_coding.rs:265-269), which
    the optimistic kernel cannot replay -> ok=False, and
    decode_capture_fast must fall back to the exact result."""
    cfg = _cfg4()
    enc = OracleEncoder(cfg)
    w = np.array(enc.encode_frame(
        Frame.new_data(1, 1, 2, b"zeroed-levels")), np.float32)
    w[cfg.preamble_len + 20 * 15 + 3: cfg.preamble_len + 20 * 15 + 6] = 0.0
    wave = np.concatenate([w, np.zeros(500, np.float32)])
    x = wave[None]
    _res, ok = decode_capture_spec(cfg, x, 2, max_frames=8, n_cand=32)
    assert not bool(np.asarray(ok)[0])
    # ... and the exact path the fallback re-decodes with must equal the
    # NumPy oracle frame-for-frame on this zero-level capture
    from trackmaker_tpu.oracle.phy import OracleDecoder
    from trackmaker_tpu.phy.decoder import decode_capture
    exact = decode_capture(cfg, jnp.asarray(wave), 2, max_frames=8)
    vmask = np.asarray(exact.valid)
    got = sorted(
        (int(s), bytes(fb[:7 + int(ln)]))
        for s, ln, fb, v in zip(np.asarray(exact.sequence),
                                np.asarray(exact.length),
                                np.asarray(exact.frame_bytes), vmask) if v)
    dec = OracleDecoder(cfg, local_addr=2)
    want = sorted((int(f.seq), bytes(f.to_bytes()[:7 + len(f.data)]))
                  for f in dec.process_samples(wave))
    assert got == want
    # skipped-candidate zeros must NOT trip (gap zeros are everywhere)
    clean = np.concatenate([
        enc.encode_frame(Frame.new_data(2, 1, 2, b"clean")),
        np.zeros(4000, np.float32)])
    _res2, ok2 = decode_capture_spec(cfg, clean[None], 2, max_frames=8,
                                     n_cand=32)
    assert bool(np.asarray(ok2)[0])


def test_spec_4b5b_evil_embedded_and_partial_header():
    cfg = _cfg4()
    enc = OracleEncoder(cfg)
    evil = Frame.new_data(1, 1, 2, bytes([0x33, 0x5A]) + _raw(b"EV",
                                                              seq=99))
    w2 = np.array(enc.encode_frame(Frame.new_data(2, 1, 2, b"hdrcut")),
                  np.float32)
    # invalid symbol at coded-symbol 12 -> 48 valid header bits < 49:
    # header-fail path (consumes header_samples)
    w2[cfg.preamble_len + 12 * 15: cfg.preamble_len + 13 * 15] *= -1.0
    # flipping one symbol's polarity inverts NRZI transitions at its
    # edges; depending on the pattern that may or may not produce an
    # invalid code — differential equality is the real assertion
    wave = np.concatenate([
        np.zeros(200, np.float32), enc.encode_frame(evil),
        np.zeros(400, np.float32), w2,
        np.zeros(400, np.float32),
        enc.encode_frame(Frame.new_data(5, 1, 2, b"tail")),
        np.zeros(500, np.float32)])
    res, _ = _spec_vs_exact(cfg, wave)
    assert all(q != 99 for _, q, _ in _masked(res, 0))


def test_spec_4b5b_incomplete_and_max_frames():
    cfg = _cfg4()
    enc = OracleEncoder(cfg)
    frames = [Frame.new_data(i, 1, 2, bytes([i]) * 5) for i in range(6)]
    wave = enc.encode_frames(frames, gap_samples=250)
    res, _ = _spec_vs_exact(cfg, wave, max_frames=3)
    assert len(_masked(res, 0)) == 3
    full = np.concatenate([wave, np.zeros(200, np.float32)])
    _spec_vs_exact(cfg, full, valid_len=len(wave) - 30)
