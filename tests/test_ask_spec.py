"""Speculative ASK receiver (phy/ask_spec.py) differentials: the spec
path must equal the exact scan receiver slot-for-slot on conformant
captures, and conformance flags must route the rest to the exact path.

"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from trackmaker_tpu.phy import ask, ask_spec

CFG = ask.AskConfig()


def _spec(wave, max_frames=16, **kw):
    res, ok = ask_spec.demodulate_spec(
        CFG, jnp.asarray(np.asarray(wave, np.float32))[None],
        max_frames=max_frames, **kw)
    return res, bool(np.asarray(ok)[0])


def _assert_equal(wave, max_frames=16):
    wave = np.asarray(wave, np.float32)
    exact = ask.demodulate(CFG, jnp.asarray(wave), max_frames=max_frames)
    spec, ok = _spec(wave, max_frames)
    if not ok:
        return False        # conformance fallback — exactness via ask.demodulate_fast
    for name, a, b in zip(exact._fields, exact, spec):
        assert np.array_equal(np.asarray(a), np.asarray(b)[0]), name
    return True


def test_clean_multiframe_roundtrip():
    frames = ask.build_frames(b"spec path hello", CFG, num_frames=8)
    wave = ask.build_track(CFG, frames, seed=5)
    assert _assert_equal(wave, max_frames=12)
    res, ok = _spec(wave, max_frames=12)
    assert ok
    v = np.asarray(res.valid)[0]
    assert v.sum() == 8
    assert np.array_equal(np.asarray(res.bits)[0][v], frames[:, 8:])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_noisy_matches_scan(seed):
    rng = np.random.default_rng(seed)
    frames = ask.build_frames(b"noise differential", CFG, num_frames=6)
    wave = ask.build_track(CFG, frames, seed=seed)
    wave = wave + rng.normal(0, 0.05, len(wave)).astype(np.float32)
    assert _assert_equal(wave)


def test_zero_gaps():
    frames = ask.build_frames(b"zero gap", CFG, num_frames=5)
    gaps = np.zeros((5, 2), np.int64)
    assert _assert_equal(ask.build_track(CFG, frames, gaps=gaps))


def test_truncations_match():
    frames = ask.build_frames(b"truncate me", CFG, num_frames=4)
    wave = ask.build_track(CFG, frames, seed=3)
    for cut in (1000, 3000, 4700, 5200):
        _assert_equal(wave[: len(wave) - cut])


def test_degenerate_captures():
    _assert_equal(np.zeros(20000, np.float32))
    rng = np.random.default_rng(9)
    _assert_equal(rng.normal(0, 0.2, 30000).astype(np.float32))
    pre = np.asarray(ask._chirp_np(CFG))
    _assert_equal(np.concatenate(
        [np.zeros(500, np.float32), pre, np.zeros(7000, np.float32)]))


def test_overflow_flags_not_silently_wrong():
    """A capture overflowing the candidate table must flag ok=False
    (never silently return a wrong decode)."""
    frames = ask.build_frames(b"x", CFG, num_frames=4)
    wave = ask.build_track(CFG, frames, seed=1)
    res, ok = _spec(wave, max_frames=8, n_cand=2)
    assert not ok


def test_demodulate_fast_merges_fallback_rows(monkeypatch):
    """demodulate_fast must merge spec rows with exact re-decodes of
    flagged rows (forced here via a tiny candidate table)."""
    orig = ask_spec.demodulate_spec_jit

    def tiny(cfg, xb, max_frames=128):
        return orig(cfg, xb, max_frames=max_frames, n_cand=2)

    monkeypatch.setattr(ask_spec, "demodulate_spec_jit", tiny)
    frames = ask.build_frames(b"merge", CFG, num_frames=4)
    wave = ask.build_track(CFG, frames, seed=2)
    got = ask.demodulate_fast(CFG, wave, max_frames=8)
    want = ask.demodulate(CFG, jnp.asarray(wave), max_frames=8)
    for name, a, b in zip(want._fields, want, got):
        assert np.array_equal(np.asarray(a), np.asarray(b)), name


def test_batched_rows_independent():
    """Each batch row decodes as if alone."""
    frames = ask.build_frames(b"batch", CFG, num_frames=3)
    w0 = ask.build_track(CFG, frames, seed=0)
    w1 = ask.build_track(CFG, frames, seed=4)
    t = max(len(w0), len(w1))
    caps = np.zeros((2, t), np.float32)
    caps[0, :len(w0)] = w0
    caps[1, :len(w1)] = w1
    res, ok = ask_spec.demodulate_spec(
        CFG, jnp.asarray(caps), max_frames=6)
    assert np.asarray(ok).all()
    for b, w in enumerate((w0, w1)):
        pad = np.zeros(t, np.float32)
        pad[:len(w)] = w
        solo = ask.demodulate(CFG, jnp.asarray(pad), max_frames=6)
        for name, a, sv in zip(solo._fields, solo, res):
            assert np.array_equal(np.asarray(a), np.asarray(sv)[b]), \
                (b, name)


def test_dense_demod_matches_slot():
    """The dense demod decomposition (two 30-tap sliding dots + strided
    pick + 2-term carrier-phase combination, ask.py:demod_dense) must
    reproduce demod_slot's window sums — same real arithmetic, so the
    raw sums agree to f32 rounding and decisions agree exactly — across
    arbitrary (including unaligned and clipped-negative) peaks."""
    rng = np.random.default_rng(11)
    frames = ask.build_frames(b"dense pin", CFG, num_frames=3)
    wave = ask.build_track(CFG, frames, seed=6).astype(np.float32)
    wave += rng.normal(0, 0.1, len(wave)).astype(np.float32)
    t = len(wave)
    rx = jnp.asarray(wave)

    pad = CFG.frame_samples + 1024 + 8
    rx_pad = jnp.concatenate([rx, jnp.zeros(pad, jnp.float32)])
    car, wts = ask.demod_tables(CFG)
    k, s_per, c_per = ask._demod_dense_tables_np(CFG)
    assert len(k) == CFG.bit_hi - CFG.bit_lo + 2 * CFG.smooth_half
    ds, dc = ask.demod_dense(CFG, rx)
    s_per = jnp.asarray(s_per)
    c_per = jnp.asarray(c_per)

    peaks = np.concatenate([
        rng.integers(0, t - CFG.frame_samples - 2, 32),
        [-4753, -1, 0, 1, 23, 24, t - CFG.frame_samples - 2],
    ]).astype(np.int32)
    for pk in peaks:
        a = ask.demod_slot(CFG, rx_pad, car, wts,
                           jnp.int32(pk), jnp.asarray(True))
        b = ask.demod_slot_dense(CFG, ds, dc, s_per, c_per,
                                 jnp.int32(pk), jnp.asarray(True))
        for name in a:
            assert np.array_equal(np.asarray(a[name]),
                                  np.asarray(b[name])), (pk, name)

    # raw sums agree to f32 rounding (not just decisions)
    p0 = int(peaks[0]) + 1
    win = rx_pad[p0:p0 + CFG.frame_samples]
    sums_ref = np.asarray((win * car) @ wts)
    m = p0 % s_per.shape[0]
    idx = (p0 + CFG.bit_lo - CFG.smooth_half
           + CFG.samples_per_bit * np.arange(CFG.coded_bits))
    sums_dense = np.asarray(c_per[m] * ds[idx] - s_per[m] * dc[idx])
    # atol bounds the f32 drift of carrier_np's direct sin evaluation
    # at window offsets up to 4752 (arg ~6e3 rad) vs the dense path's
    # exact periodic table — ~1e-3 on unit-amplitude windows; decisions
    # (asserted exactly above) sit orders of magnitude away from 0
    np.testing.assert_allclose(sums_dense, sums_ref, rtol=2e-3,
                               atol=3e-3)


def test_spec_vs_oracle():
    """End-to-end: spec path decisions equal the NumPy oracle's."""
    from trackmaker_tpu.oracle import ask as oracle_ask
    frames = ask.build_frames(b"oracle check", CFG, num_frames=5)
    gaps = np.random.default_rng(8).integers(0, 100, size=(5, 2))
    wave = ask.build_track(CFG, frames, gaps=gaps)
    want = oracle_ask.demodulate(wave)
    res, ok = _spec(wave, max_frames=8)
    assert ok
    v = np.asarray(res.valid)[0]
    got = list(zip(np.asarray(res.frame_id)[0][v].tolist(),
                   np.asarray(res.bits)[0][v]))
    assert len(got) == len(want) == 5
    for (gid, gbits), (wid, wbits) in zip(got, want):
        assert gid == wid
        assert np.array_equal(gbits, wbits)


def test_dense_fire_sliding_max_vs_naive():
    """The 128-block sliding-max decomposition in dense_fire_candidates
    must match a naive O(T*w) oracle bit-for-bit (max is exact, so any
    deviation is an indexing bug), across boundary-straddling offsets."""
    w = CFG.peak_guard + 1
    rng = np.random.default_rng(17)
    for t in (w + 1, 511, 512, 513, 1000, 4096 + 200, 40_000):
        sync = rng.normal(0, 1, t).astype(np.float32)
        upd = rng.random(t) < 0.3
        masked = np.where(upd, sync, -np.inf)
        padded = np.concatenate([masked, np.full(w + 1, -np.inf)])
        want = np.array([
            upd[r] and masked[r] >= padded[r + 1: r + w + 1].max()
            for r in range(t)
        ])
        got = np.asarray(ask_spec.dense_fire_candidates(
            CFG, jnp.asarray(sync), jnp.asarray(upd)))
        assert np.array_equal(got, want), t


def test_chain_kernel_vs_scan():
    """The record-chain resolution (ask_spec._resolve_chain) must
    resolve fired/peak identically to a sequential NumPy replay of the
    chain on random windows, including all-masked rows, single-update
    rows, tie values, and fires at the guard boundary."""
    rng = np.random.default_rng(31)
    guard = CFG.peak_guard
    for win in (512, 1024):
        for trial in range(4):
            c1 = 13
            vals = np.full((c1, win), -np.inf, np.float32)
            mask = rng.random((c1, win)) < 0.05
            vals[mask] = rng.normal(1, 0.5, mask.sum()).astype(np.float32)
            # inject exact ties inside some rows
            vals[3, 40] = vals[3, 60] = np.float32(2.5)
            vals[4, :] = -np.inf                      # all-masked row
            vals[5, :] = -np.inf
            vals[5, 7] = 1.0                          # single update
            base = rng.integers(0, 1 << 20, c1).astype(np.int32)
            vj = jnp.asarray(vals)
            idx = base[:, None] + np.arange(win, dtype=np.int32)
            fired_k, peak_k = ask_spec._resolve_chain(
                vj, jnp.asarray(idx), guard)
            # reference: running max / record replayed in NumPy
            m_excl = np.full_like(vals, -np.inf)
            m_excl[:, 1:] = np.maximum.accumulate(vals, axis=1)[:, :-1]
            upd = vals > m_excl
            rec = np.where(upd, idx, np.int64(-2**40))
            rec_incl = np.maximum.accumulate(rec, axis=1)
            rec_excl = np.concatenate(
                [np.full((c1, 1), -2**40), rec_incl[:, :-1]], axis=1)
            fire = (~upd) & (idx > rec_excl + guard) & (m_excl > -np.inf)
            for r in range(c1):
                f = np.nonzero(fire[r])[0]
                want_fired = len(f) > 0
                assert bool(np.asarray(fired_k)[r]) == want_fired, r
                if want_fired:
                    assert int(np.asarray(peak_k)[r]) == \
                        int(rec_excl[r, f[0]]), r
                elif upd[r].any():
                    assert int(np.asarray(peak_k)[r]) == \
                        int(rec_incl[r, -1]), r


def test_demod_slots_dense_matches_slot():
    """The row-gather batched demod must pick bit-identical values to
    the per-slot strided form (one-hot dot at HIGHEST precision is an
    exact pick), across row-boundary-straddling peaks."""
    rng = np.random.default_rng(23)
    rx = rng.normal(0, 0.3, 30000).astype(np.float32)
    k, s_per, c_per = ask._demod_dense_tables_np(CFG)
    s_per = jnp.asarray(s_per)
    c_per = jnp.asarray(c_per)
    ds, dc = ask.demod_dense(CFG, jnp.asarray(rx))
    peaks = jnp.asarray(
        [0, 1, 43, 44, 45, 87, 1000, 30000 - CFG.frame_samples - 2],
        jnp.int32)
    oks = jnp.ones(len(peaks), bool)
    got = ask.demod_slots_dense(CFG, ds, dc, s_per, c_per, peaks, oks)
    for i, p in enumerate(np.asarray(peaks)):
        want = ask.demod_slot_dense(CFG, ds, dc, s_per, c_per,
                                    jnp.int32(p), jnp.asarray(True))
        for name in want:
            assert np.array_equal(np.asarray(want[name]),
                                  np.asarray(got[name])[i]), (name, p)
