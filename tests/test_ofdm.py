"""OFDM modem tests (BASELINE config 2)."""

import numpy as np
import jax.numpy as jnp
import pytest

from trackmaker_tpu.core.framing import Frame
from trackmaker_tpu.dsp import channel
from trackmaker_tpu.phy.ofdm import (
    OfdmConfig, OfdmModem, _bits_to_qpsk, _qpsk_to_bits,
    _spectrum_to_time, _time_to_spectrum, find_preambles)
import jax


def test_qpsk_mapping_roundtrip():
    bits = jnp.asarray(np.random.default_rng(0).integers(0, 2, 64),
                       dtype=jnp.uint8)
    sym = _bits_to_qpsk(bits)
    assert sym.shape == (32,)
    np.testing.assert_allclose(np.abs(np.asarray(sym)), 1.0, atol=1e-6)
    back = _qpsk_to_bits(sym)
    assert np.array_equal(np.asarray(back), np.asarray(bits))


def test_spectrum_time_roundtrip():
    cfg = OfdmConfig()
    rng = np.random.default_rng(1)
    subs = (rng.normal(size=(3, cfg.n_bins))
            + 1j * rng.normal(size=(3, cfg.n_bins))).astype(np.complex64)
    t = _spectrum_to_time(cfg, jnp.asarray(subs))
    assert t.shape == (3, cfg.sym_len)
    # cyclic prefix really is the tail
    np.testing.assert_allclose(
        np.asarray(t[:, :cfg.cp_len]), np.asarray(t[:, -cfg.cp_len:]),
        atol=1e-5)
    back = _time_to_spectrum(cfg, t)
    scale = cfg.amplitude * cfg.n_fft / cfg.n_bins  # rfft∘irfft = identity
    np.testing.assert_allclose(np.asarray(back) / scale, subs, atol=1e-4)


def test_single_frame_roundtrip():
    """Config 2: IFFT modulate + preamble-correlate + FFT demodulate one
    frame."""
    modem = OfdmModem()
    frame = Frame.new_data(3, 1, 2, b"OFDM over sound, on a GPU." * 4)
    wave = modem.encode_frames([frame])
    got = modem.decode(wave, len(frame.to_bytes()))
    assert len(got) == 1
    assert got[0].data == frame.data
    assert got[0].sequence == 3


def test_multi_frame_with_noise_and_gain():
    # 22 dB: the old 18 dB pinned a coin flip — ~4.9k payload bits with
    # min decision margins under 3% of symbol magnitude, passing 3/12
    # seeds for BOTH the exact-window and CP-back-off receivers
    # (statistically identical); 22 dB holds real margin.
    modem = OfdmModem()
    frames = [Frame.new_data(i, 1, 2, bytes([i]) * 96) for i in range(6)]
    wave = modem.encode_frames(frames, gap_samples=500)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        noisy = np.asarray(channel.awgn(key, jnp.asarray(wave) * 0.7,
                                        snr_db=22.0))
        got = modem.decode(noisy, len(frames[0].to_bytes()))
        assert [f.data for f in got] == [f.data for f in frames], seed


def test_channel_phase_equalization():
    """A small echo (multipath) is absorbed by the one-tap equalizer."""
    modem = OfdmModem()
    frame = Frame.new_data(0, 1, 2, b"echoed" * 20)
    wave = modem.encode_frames([frame])
    taps = jnp.asarray([1.0, 0.0, 0.0, 0.25, 0.0, -0.1])
    echoed = np.asarray(channel.multipath(jnp.asarray(wave), taps))
    got = modem.decode(echoed, len(frame.to_bytes()))
    assert len(got) == 1 and got[0].data == frame.data


def test_find_preambles_positions():
    cfg = OfdmConfig()
    modem = OfdmModem(cfg)
    frame = Frame.new_data(0, 1, 2, b"x" * 64)
    wave = modem.encode_frames([frame, frame], gap_samples=1000)
    starts = np.asarray(find_preambles(cfg, jnp.asarray(wave), 8))
    starts = starts[starts >= 0]
    assert len(starts) == 2
    assert abs(int(starts[0]) - 0) <= 2


def _find_preambles_scalar_ref(cfg, rx, max_frames):
    """The pre-round-3 refine form: dynamic_slice window per scan step.

    Kept as the spec for the aligned-row masked-argmax refine in
    `find_preambles` (the production form avoids the per-element
    gathers the traced-start slice lowers to under vmap — CLAUDE.md)."""
    from trackmaker_tpu import sync as sync_mod
    from trackmaker_tpu.core import blockq
    from trackmaker_tpu.dsp.osc import chirp_cached

    pre = chirp_cached(cfg.preamble_len, cfg.chirp_lo_hz, cfg.chirp_hi_hz,
                       cfg.sample_rate)
    corr = sync_mod.normalized_xcorr(rx, pre)
    hits = corr >= cfg.sync_threshold
    tables = blockq.block_tables(hits)
    w = cfg.preamble_len
    corr_pad = jnp.pad(corr, (0, w))

    def step(carry, _):
        cursor, done = carry
        first, has = blockq.first_set_from(tables, cursor)
        first = jnp.where(has, first, 0)
        win = jax.lax.dynamic_slice(corr_pad, (first,), (w,))
        peak = first + jnp.argmax(win)
        new_cursor = peak + cfg.preamble_len
        out = jnp.where(has & ~done, peak, -1)
        return (jnp.where(has, new_cursor, cursor), done | ~has), out

    zero = (rx[0] * 0).astype(jnp.int32)
    (_, _), starts = jax.lax.scan(step, (zero, zero > 0), None,
                                  length=max_frames, unroll=1)
    return starts


def test_demodulate_windows_match_slices():
    """The gather-free windowed spectrum (aligned 2-row fetch +
    hierarchical 4x4 lane-shifted select) must be bit-exact vs dynamic
    slices taken at the same 32-step timing-back-off positions with
    the same de-ramp applied, including at -1 sentinel starts."""
    from trackmaker_tpu.phy.ofdm import _windows_spectrum

    cfg = OfdmConfig()
    n_bits = (7 + 64) * 8
    n_sym = cfg.n_symbols(n_bits)
    nst = 1 + n_sym
    body_off = cfg.preamble_len + cfg.guard_samples

    def spec_slices(rx, starts):
        pad = jnp.concatenate(
            [rx, jnp.zeros(body_off + nst * cfg.sym_len + 2048,
                           jnp.float32)])
        def one(start):
            def sym(k):
                wpos = start + body_off + k * cfg.sym_len + cfg.cp_len
                aligned = (wpos // 32) * 32       # the CP back-off
                return jax.lax.dynamic_slice(pad, (aligned,),
                                             (cfg.n_fft,)), wpos - aligned
            bodies, deltas = zip(*(sym(k) for k in range(nst)))
            spec = jnp.fft.rfft(jnp.stack(bodies), n=cfg.n_fft, axis=-1)
            spec = spec[..., cfg.bin_lo:cfg.bin_hi]
            # identical de-ramp expression to _windows_spectrum so the
            # products stay bit-exact
            delta = jnp.stack(deltas).astype(jnp.float32)
            k_abs = jnp.arange(cfg.bin_lo, cfg.bin_hi, dtype=jnp.float32)
            ramp = jnp.exp(
                1j * (2.0 * jnp.pi / cfg.n_fft)
                * delta[:, None] * k_abs[None, :]).astype(jnp.complex64)
            return spec * ramp
        return jax.vmap(one)(starts)

    modem = OfdmModem(cfg)
    for seed in (0, 1):
        r = np.random.default_rng(seed)
        frames = [Frame.new_data(i, 1, 2, r.integers(
            0, 256, 64, dtype=np.uint8).tobytes()) for i in range(6)]
        wave = modem.encode_frames(frames,
                                   gap_samples=int(r.integers(0, 900)))
        x = jnp.asarray(
            (wave + r.normal(0, 0.05, len(wave))).astype(np.float32))
        starts = find_preambles(cfg, x, 8)       # has -1 padding
        a = np.asarray(_windows_spectrum(cfg, x, starts, n_sym))
        b = np.asarray(spec_slices(x, starts))
        assert np.array_equal(a, b), (seed, np.abs(a - b).max())


def test_ofdm_multipath_echo():
    """Late-echo guard of the 32-step back-off: with sync locked on
    the first arrival, a window backed off delta < 32 samples into the
    CP still tolerates echo delay up to cp_len - 31 = 97 samples.  The
    round-3 128-step back-off left a 1-sample worst case — an echo at
    delay 60 flipped bits whenever the frame arrived at the wrong
    phase mod 128 (ADVICE r3, medium).  Sweep lead-ins so the window
    offset covers all residues; every decode must be exact."""
    modem = OfdmModem()
    frames = [Frame.new_data(i, 1, 2, bytes([40 + i]) * 64)
              for i in range(3)]
    taps = np.zeros(61, np.float32)
    taps[0] = 1.0
    taps[60] = 0.45                      # echo 60 samples late
    r = np.random.default_rng(9)
    for lead in (0, 1, 37, 64, 96, 127):
        wave = modem.encode_frames(frames, gap_samples=517)
        x = np.concatenate([np.zeros(lead, np.float32), wave])
        ech = np.asarray(channel.multipath(jnp.asarray(x),
                                           jnp.asarray(taps)))
        ech = (ech + r.normal(0, 0.01, len(ech))).astype(np.float32)
        got = [f.data for f in modem.decode(ech, 7 + 64, max_frames=3)]
        assert got == [f.data for f in frames], (lead, len(got))


def test_unaligned_config_fallback():
    """Configs failing the back-off preconditions (cp_len < 32 or
    sym_len % 32 != 0) must still decode exactly via the dynamic-slice
    fallback (ADVICE r3: the round-3 assert made cp_len=24 raise)."""
    cfg = OfdmConfig(cp_len=24)
    modem = OfdmModem(cfg)
    frames = [Frame.new_data(i, 1, 2, bytes([7 + i]) * 48)
              for i in range(3)]
    wave = modem.encode_frames(frames, gap_samples=400)
    r = np.random.default_rng(3)
    x = (np.concatenate([np.zeros(11, np.float32), wave])
         + r.normal(0, 0.01, len(wave) + 11)).astype(np.float32)
    got = [f.data for f in modem.decode(x, 7 + 48, max_frames=3)]
    assert got == [f.data for f in frames]


def test_ber_threshold_near_cliff():
    """Statistical sensitivity pin at 17 dB (below the 22 dB
    exact-match test): the raw QPSK BER across seeds must stay under
    2e-3.  A future receiver regression below 22 dB moves this by
    orders of magnitude long before the exact-match test notices
    (ADVICE r3, low)."""
    from trackmaker_tpu.core import bitops
    from trackmaker_tpu.phy.ofdm import demodulate_at, modulate_bits

    cfg = OfdmConfig()
    modem = OfdmModem(cfg)
    frames = [Frame.new_data(i, 1, 2, bytes([i]) * 96) for i in range(6)]
    tx_bits = np.stack([bitops.bytes_to_bits_host(f.to_bytes())
                        for f in frames])
    n_bits = tx_bits.shape[-1]
    wave = modem.encode_frames(frames, gap_samples=500)
    errs = tot = 0
    for seed in range(6):
        key = jax.random.PRNGKey(100 + seed)
        noisy = np.asarray(channel.awgn(key, jnp.asarray(wave) * 0.7,
                                        snr_db=17.0))
        starts = find_preambles(cfg, jnp.asarray(noisy), 6)
        bits = np.asarray(demodulate_at(cfg, jnp.asarray(noisy), n_bits,
                                        starts))
        errs += int((bits != tx_bits).sum())
        tot += bits.size
    assert tot > 0 and errs / tot < 2e-3, (errs, tot)


def test_demodulate_backoff_phase_is_absorbed():
    """The 32-step timing back-off rides a phase ramp into every
    bin; the pilot equalizer must cancel it: demodulated payload bits
    stay exact on clean and noisy captures at misaligned starts."""
    cfg = OfdmConfig()
    n_bits = (7 + 64) * 8
    modem = OfdmModem(cfg)
    r = np.random.default_rng(5)
    payloads = [r.integers(0, 256, 64, dtype=np.uint8).tobytes()
                for _ in range(4)]
    frames = [Frame.new_data(i, 1, 2, p) for i, p in enumerate(payloads)]
    # odd gap + odd lead-in so window offsets sweep all residues mod 128
    for lead in (0, 1, 37, 127):
        wave = modem.encode_frames(frames, gap_samples=613)
        x = np.concatenate([np.zeros(lead, np.float32), wave])
        x = jnp.asarray((x + r.normal(0, 0.02, len(x))).astype(np.float32))
        got = [f.data for f in modem.decode(np.asarray(x), 7 + 64,
                                            max_frames=4)]
        assert got == payloads, (lead, len(got))


def test_find_preambles_matches_scalar_reference():
    """The aligned-row refine must be position-exact (incl. argmax tie
    order) vs the scalar dynamic_slice form, on real captures and on
    pure noise (no/at-end/dense hits)."""
    cfg = OfdmConfig()
    modem = OfdmModem(cfg)
    for seed in (0, 1):
        r = np.random.default_rng(seed)
        frames = [Frame.new_data(i, 1, 2, r.integers(
            0, 256, 48, dtype=np.uint8).tobytes()) for i in range(6)]
        wave = modem.encode_frames(frames,
                                   gap_samples=int(r.integers(0, 900)))
        x = jnp.asarray(
            (wave + r.normal(0, 0.02, len(wave))).astype(np.float32))
        a = np.asarray(find_preambles(cfg, x, 8))
        b = np.asarray(_find_preambles_scalar_ref(cfg, x, 8))
        assert np.array_equal(a, b), (seed, a, b)
    for seed in (2, 3):
        r = np.random.default_rng(seed)
        x = jnp.asarray(r.normal(0, 0.4, int(r.integers(2000, 30000))
                                 ).astype(np.float32))
        a = np.asarray(find_preambles(cfg, x, 8))
        b = np.asarray(_find_preambles_scalar_ref(cfg, x, 8))
        assert np.array_equal(a, b), (seed, a, b)
