"""Blocked decode through the speculative decoder vs sequential
`decode_capture` — the same adversarial seam corpus as
tests/test_parallel_adversarial.py, plus the walk's cursor semantics
(start_cursor / scan_limit / with_cursor) against the exact scan's."""

import numpy as np
import pytest

import jax.numpy as jnp

from trackmaker_tpu.core import bitops
from trackmaker_tpu.core.config import FOUR_B_FIVE_B, MANCHESTER, PhyConfig
from trackmaker_tpu.core.framing import Frame
from trackmaker_tpu.oracle.phy import OracleEncoder
from trackmaker_tpu.parallel.stream import _decode_blocked_spec, halo_size
from trackmaker_tpu.phy.decoder import decode_capture
from trackmaker_tpu.phy.spec_decode import decode_capture_spec


def _raw(data: bytes, seq=0, src=1, dst=2, ftype=1) -> bytes:
    n = len(data)
    return bytes([n >> 8, n & 0xFF, bitops.crc8_host(data), ftype,
                  seq, src, dst]) + data


def _evil_frame(cfg, seq: int, payload: bytes) -> Frame:
    return Frame.new_data(seq, 1, 2,
                          bytes([0x33, 0x5A]) + _raw(payload, seq=99))


def _decoded_set(res):
    return sorted(
        (int(st), int(sq), bytes(fb[: 7 + int(ln)]))
        for v, st, sq, ln, fb in zip(
            np.asarray(res.valid), np.asarray(res.start),
            np.asarray(res.sequence), np.asarray(res.length),
            np.asarray(res.frame_bytes))
        if v)


def _blocked_spec(cfg, wave, n_blocks, mfpb=8, n_cand=32, local=2):
    x = jnp.asarray(wave, jnp.float32)
    res, ok = _decode_blocked_spec(
        cfg, x, local, n_blocks, mfpb, len(wave), n_cand)
    return res, bool(np.asarray(ok))


@pytest.mark.parametrize("lc", [MANCHESTER, FOUR_B_FIVE_B])
def test_blocked_spec_evil_seam_equals_sequential(lc):
    cfg = PhyConfig(line_coding=lc)
    n_blocks = 6
    total = 6 * 16000
    block = total // n_blocks
    evil = _evil_frame(cfg, 1, b"EVIL-EMBEDDED")
    scenarios = [
        (block - 200, evil),
        (2 * block - 40, Frame.new_data(2, 1, 2, b"plain-straddler")),
        (3 * block + 500, _evil_frame(cfg, 3, b"MID-BLOCK")),
        (4 * block - 150, Frame.new_data(4, 1, 9, b"not-for-us")),
        (5 * block + 100, Frame.new_data(5, 1, 2, b"tail")),
    ]
    enc = OracleEncoder(cfg)
    wave = np.zeros(total, np.float32)
    for pos, frame in scenarios:
        w = enc.encode_frame(frame)
        wave[pos: pos + len(w)] = w
    seq = decode_capture(cfg, jnp.asarray(wave), 2, max_frames=32)
    blk, ok = _blocked_spec(cfg, wave, n_blocks)
    assert ok
    assert _decoded_set(blk) == _decoded_set(seq)
    assert all(sq != 99 for _, sq, _ in _decoded_set(blk))
    assert any(sq == 1 for _, sq, _ in _decoded_set(blk))


def test_blocked_spec_chain_of_straddlers():
    """Consumption chains across several seams: the fixpoint must
    propagate through multiple walk-only iterations."""
    cfg = PhyConfig()
    enc = OracleEncoder(cfg)
    w = enc.encode_frame(_evil_frame(cfg, 7, b"CHAIN"))
    n_blocks = 6
    block = halo_size(cfg) + 200
    total = n_blocks * block
    wave = np.zeros(total, np.float32)
    pos, k = block - 60, 0
    while pos + len(w) < total - block and k < 4:
        wave[pos: pos + len(w)] = w
        pos += len(w)
        k += 1
    seq = decode_capture(cfg, jnp.asarray(wave), 2, max_frames=16)
    blk, ok = _blocked_spec(cfg, wave, n_blocks, n_cand=64)
    assert ok
    assert _decoded_set(blk) == _decoded_set(seq)
    assert len(_decoded_set(seq)) == k


def test_blocked_spec_block_smaller_than_halo():
    cfg = PhyConfig()
    enc = OracleEncoder(cfg)
    w = enc.encode_frame(_evil_frame(cfg, 1, b"WIDE"))
    n_blocks = 6
    block = halo_size(cfg) // 2
    total = n_blocks * block
    wave = np.zeros(total, np.float32)
    wave[block - 60: block - 60 + len(w)] = w
    tail = enc.encode_frame(Frame.new_data(2, 1, 2, b"tail"))
    wave[total - len(tail) - 10: total - 10] = tail
    seq = decode_capture(cfg, jnp.asarray(wave), 2, max_frames=16)
    blk, ok = _blocked_spec(cfg, wave, n_blocks)
    assert ok
    assert _decoded_set(blk) == _decoded_set(seq)
    assert {sq for _, sq, _ in _decoded_set(seq)} == {1, 2}


def test_blocked_spec_clean_capture_and_noise():
    cfg = PhyConfig()
    enc = OracleEncoder(cfg)
    rng = np.random.default_rng(5)
    parts = []
    for i in range(5):
        parts.append(rng.normal(0, 0.02, 1200 + 321 * i).astype(np.float32))
        parts.append(enc.encode_frame(
            Frame.new_data(i, 1, 2, bytes([i]) * (4 + i))))
    parts.append(np.zeros(8000, np.float32))
    wave = np.concatenate(parts)
    seq = decode_capture(cfg, jnp.asarray(wave), 2, max_frames=16)
    blk, ok = _blocked_spec(cfg, wave, 4, mfpb=8, n_cand=32)
    assert ok
    assert _decoded_set(blk) == _decoded_set(seq)
    assert len(_decoded_set(seq)) == 5


def test_blocked_spec_4b5b_nonconf_flags_fallback():
    """Zeroed samples inside a frame attempted by the converged walk
    must force ok=False (the wrapper then uses the exact blocked
    path)."""
    cfg = PhyConfig(line_coding=FOUR_B_FIVE_B)
    enc = OracleEncoder(cfg)
    w = np.array(enc.encode_frame(
        Frame.new_data(1, 1, 2, b"zeroed-lv")), np.float32)
    w[cfg.preamble_len + 20 * 15 + 3: cfg.preamble_len + 20 * 15 + 6] = 0.0
    total = 4 * 8000
    wave = np.zeros(total, np.float32)
    wave[8000 - 80: 8000 - 80 + len(w)] = w      # straddles seam 0|1
    _blk, ok = _blocked_spec(cfg, wave, 4)
    assert not ok


def test_spec_cursor_semantics_match_exact():
    """start_cursor / scan_limit / with_cursor on decode_capture_spec
    must replay decode_capture's cursor outputs."""
    cfg = PhyConfig()
    enc = OracleEncoder(cfg)
    rng = np.random.default_rng(3)
    parts = [rng.normal(0, 0.02, 900).astype(np.float32)]
    for i in range(3):
        parts.append(enc.encode_frame(
            Frame.new_data(i, 1, 2, bytes([i + 65]) * (6 + i))))
        parts.append(np.zeros(300 + 130 * i, np.float32))
    wave = np.concatenate(parts)

    for cur0, lim in [(0, None), (0, len(wave) // 2),
                      (len(wave) // 3, None), (2500, 15000)]:
        exact, srch_e, cur_e = decode_capture(
            cfg, jnp.asarray(wave), 2, max_frames=8, with_cursor=True,
            start_cursor=cur0, scan_limit=lim)
        res, ok, srch_s, cur_s = decode_capture_spec(
            cfg, wave[None], 2, max_frames=8, n_cand=32,
            start_cursor=cur0, scan_limit=lim, with_cursor=True)
        assert bool(np.asarray(ok)[0])
        assert int(np.asarray(cur_s)[0]) == int(np.asarray(cur_e)), \
            (cur0, lim)
        assert int(np.asarray(srch_s)[0]) == int(np.asarray(srch_e)), \
            (cur0, lim)
        want = _decoded_set(exact)
        got = sorted(
            (int(st), int(sq), bytes(fb[: 7 + int(ln)]))
            for v, st, sq, ln, fb in zip(
                np.asarray(res.valid[0]), np.asarray(res.start[0]),
                np.asarray(res.sequence[0]), np.asarray(res.length[0]),
                np.asarray(res.frame_bytes[0]))
            if v)
        assert got == want, (cur0, lim)


def test_spec_cursor_incomplete_pending():
    """searched_until must pin to the pending incomplete frame's
    preamble start, exactly like the exact path."""
    cfg = PhyConfig()
    enc = OracleEncoder(cfg)
    w = enc.encode_frame(Frame.new_data(4, 1, 2, b"cut-off"))
    full = np.concatenate([np.zeros(300, np.float32), w,
                           np.zeros(400, np.float32)])
    cut = 300 + len(w) - 50
    exact, srch_e, cur_e = decode_capture(
        cfg, jnp.asarray(full), 2, max_frames=8, valid_len=cut,
        with_cursor=True)
    _res, ok, srch_s, cur_s = decode_capture_spec(
        cfg, full[None], 2, max_frames=8, n_cand=32, valid_len=cut,
        with_cursor=True)
    assert bool(np.asarray(ok)[0])
    assert int(np.asarray(srch_s)[0]) == int(np.asarray(srch_e))
    assert int(np.asarray(cur_s)[0]) == int(np.asarray(cur_e))


def _walk_scalar(fields, start_cursor, scan_limit, max_frames):
    """NumPy transliteration of the sequential consumption walk
    (decoder.rs:242-356 as decode_capture's scan replays it) over a
    sorted candidate table: fields rows 0=pos, 1=consumed,
    2=stop-if-attempted, 3=keep-if-attempted.  Same contract as
    spec_decode._spec_walk."""
    from trackmaker_tpu.phy.spec_decode import _BIGI
    fields = np.asarray(fields, np.int64)
    b, _, c = fields.shape
    out = [np.zeros((b, c), bool), np.zeros((b, c), bool),
           np.zeros(b, np.int64), np.zeros(b, bool), np.zeros(b, np.int64)]
    for r in range(b):
        cur, done, att, pending = int(start_cursor[r]), False, 0, int(_BIGI)
        for k in range(c):
            pos, consumed, stopf, keepf = fields[r, :, k]
            exists = pos < _BIGI and pos < scan_limit[r]
            at = exists and not done and pos >= cur and att < max_frames
            stop = at and stopf > 0
            adv = at and not stop
            out[0][r, k] = adv and keepf > 0
            out[1][r, k] = at
            if adv:
                cur = pos + consumed
            if stop:
                done, pending = True, min(pending, pos)
            att += int(at)
        out[2][r], out[3][r], out[4][r] = cur, done or att < max_frames, \
            pending
    return out


def test_walk_vectorized_equals_smem():
    """The vectorized walk must replay the scalar walk's decisions
    bit-for-bit on randomized candidate tables: ascending positions
    with _BIGI pads, random consumed/stop/keep flags, random cursors and
    scan limits, and max_frames caps that actually bind."""
    from trackmaker_tpu.phy.spec_decode import _BIGI, _spec_walk

    rng = np.random.default_rng(17)
    for trial in range(40):
        b = int(rng.integers(1, 5))
        c = int(rng.choice([8, 32, 128]))
        n_real = rng.integers(0, c + 1, b)
        pos = np.full((b, c), int(_BIGI), np.int64)
        for i in range(b):
            k = int(n_real[i])
            pos[i, :k] = np.sort(rng.integers(0, 40_000, k))
        consumed = rng.integers(1, 3000, (b, c))
        stopf = (rng.random((b, c)) < 0.25).astype(np.int64)
        keepf = (rng.random((b, c)) < 0.6).astype(np.int64)
        fields = jnp.asarray(np.stack(
            [pos, consumed, stopf, keepf], axis=1), jnp.int32)
        cur0 = jnp.asarray(rng.integers(0, 30_000, b), jnp.int32)
        limit = jnp.asarray(rng.choice(
            [20_000, 41_000, int(_BIGI)], b), jnp.int32)
        mf = int(rng.choice([1, 2, 5, c, 2 * c]))

        got = _spec_walk(fields, cur0, limit, mf)
        want = _walk_scalar(np.asarray(fields), np.asarray(cur0),
                            np.asarray(limit), mf)
        names = ("keep", "attempted", "cur_f", "done", "pending")
        for name, g, w in zip(names, got, want):
            assert np.array_equal(np.asarray(g), np.asarray(w)), (
                trial, name, np.asarray(g), np.asarray(w))


def test_walk_unroll_invariance():
    """TM_WALK_UNROLL is a pure scheduling knob: the consumption
    walk's keep/attempted/cursor outputs are identical for any unroll."""
    import jax
    from trackmaker_tpu.phy import spec_decode as pd
    rng = np.random.default_rng(11)
    b, c = 4, 32
    pos = np.sort(rng.integers(0, 50_000, (b, c)), axis=1)
    fields = jnp.asarray(np.stack([
        pos,
        rng.integers(1, 7000, (b, c)),
        (rng.random((b, c)) < 0.15).astype(np.int64),
        (rng.random((b, c)) < 0.9).astype(np.int64),
    ], axis=1), jnp.int32)
    saved = pd.WALK_UNROLL
    try:
        pd.WALK_UNROLL = 8
        ref = jax.tree_util.tree_map(
            np.asarray, pd._spec_walk(fields, 0, int(pd._BIGI), 16))
        for u in (1, 5, 16, 100):
            pd.WALK_UNROLL = u
            got = jax.tree_util.tree_map(
                np.asarray, pd._spec_walk(fields, 0, int(pd._BIGI), 16))
            for a, g in zip(ref, got):
                assert np.array_equal(a, g), u
    finally:
        pd.WALK_UNROLL = saved
