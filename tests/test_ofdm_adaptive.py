"""Adaptive bit-loading OFDM: constellation mappers, channel probing,
loading selection on a shaped channel, and loaded end-to-end decode."""

import numpy as np

import jax.numpy as jnp

from trackmaker_tpu.core.framing import Frame
from trackmaker_tpu.phy.ofdm_adaptive import (
    OfdmAdaptiveConfig,
    OfdmAdaptiveModem,
    _bits_to_qam16,
    _qam16_to_bits,
    choose_loading,
    estimate_bin_snr,
    probe_waveform,
)


def test_qam16_mapper_roundtrip():
    # all 16 points: exact roundtrip + unit average constellation power
    allbits = ((np.arange(16)[:, None] >> np.arange(3, -1, -1)) & 1
               ).astype(np.uint8).reshape(1, 64)
    sym = _bits_to_qam16(jnp.asarray(allbits))
    assert abs(float(jnp.mean(jnp.abs(sym) ** 2)) - 1.0) < 1e-5
    assert np.array_equal(np.asarray(_qam16_to_bits(sym)), allbits)
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (5, 64), dtype=np.uint8)
    sym = _bits_to_qam16(jnp.asarray(bits))
    back = np.asarray(_qam16_to_bits(sym))
    assert np.array_equal(back, bits)


def test_uniform_default_roundtrip():
    modem = OfdmAdaptiveModem()          # loading=() -> uniform QPSK
    payloads = [bytes([i]) * 30 for i in range(3)]
    frames = [Frame.new_data(i, 1, 2, p) for i, p in enumerate(payloads)]
    wave = modem.encode_frames(frames, gap_samples=300)
    rng = np.random.default_rng(1)
    noisy = (wave + rng.normal(0, 0.01, len(wave))).astype(np.float32)
    got = modem.decode(noisy, 7 + 30, max_frames=4)
    assert [f.data for f in got] == payloads


def test_mixed_loading_roundtrip():
    cfg = OfdmAdaptiveConfig()
    n = len(cfg.data_bin_idx)
    rng = np.random.default_rng(2)
    loading = tuple(rng.choice([0, 1, 2, 4], size=n,
                               p=[0.1, 0.2, 0.4, 0.3]).tolist())
    modem = OfdmAdaptiveModem(loading=loading)
    payloads = [bytes(range(40)), b"\xff\x00" * 20]
    frames = [Frame.new_data(i, 1, 2, p) for i, p in enumerate(payloads)]
    wave = modem.encode_frames(frames, gap_samples=300)
    noisy = (wave + rng.normal(0, 0.008, len(wave))).astype(np.float32)
    got = modem.decode(noisy, 7 + 40, max_frames=4)
    assert [f.data for f in got] == payloads


def _shaped(x, rng, sigma):
    """Lowpass-shaped channel: strong low bins, ~-24 dB high bins.

    NOTE on sigma: the probe's per-bin SNR estimate carries ~2 dB of
    run-to-run variance (8 symbols), so tests run the loaded link where
    the plateau sits comfortably ABOVE the 16-QAM threshold — at a
    knife-edge plateau the loading is genuinely marginal by design
    (production pairs it with FEC)."""
    taps = 31
    t = np.arange(taps) - taps // 2
    fc = 6000.0 / 48000.0
    h = 2 * fc * np.sinc(2 * fc * t) * np.hamming(taps)
    h = h + 0.06 * np.eye(taps)[taps // 2]       # direct-path leakage
    y = np.convolve(x, h, mode="same")
    return (y + rng.normal(0, sigma, len(y))).astype(np.float32)


def test_probe_reflects_channel_shape_and_loaded_link_decodes():
    cfg = OfdmAdaptiveConfig()
    rng = np.random.default_rng(3)
    probe = probe_waveform(cfg)
    rx = _shaped(np.concatenate([np.zeros(500, np.float32), probe,
                                 np.zeros(800, np.float32)]), rng, 0.004)
    from trackmaker_tpu.phy.ofdm import find_preambles
    s = int(np.asarray(find_preambles(cfg, jnp.asarray(rx), 2))[0])
    assert s >= 0
    snr = np.asarray(estimate_bin_snr(cfg, jnp.asarray(rx), s))
    freqs = (cfg.data_bin_idx + cfg.bin_lo) * 48000.0 / cfg.n_fft
    lo = snr[freqs < 4500].mean()
    hi = snr[freqs > 9000].mean()
    assert lo > 10 * hi, (lo, hi)     # shaping visible in the estimate

    loading = choose_loading(snr)
    lv = np.asarray(loading)
    # strong low bins got more bits than the rolled-off high bins
    assert lv[freqs < 4500].mean() > lv[freqs > 9000].mean()
    assert lv.sum() >= 1

    modem = OfdmAdaptiveModem(cfg, loading=loading)
    payloads = [bytes([7 * i + 1]) * 24 for i in range(3)]
    frames = [Frame.new_data(i, 1, 2, p) for i, p in enumerate(payloads)]
    wave = modem.encode_frames(frames, gap_samples=400)
    rx2 = _shaped(np.concatenate([wave, np.zeros(900, np.float32)]),
                  rng, 0.002)
    got = modem.decode(rx2, 7 + 24, max_frames=4)
    assert [f.data for f in got] == payloads


def test_loading_beats_uniform_16qam_on_shaped_channel():
    """Rate-adaptive sanity: on the shaped channel, probe-chosen loading
    decodes cleanly while uniform 16-QAM (same peak rate class) fails —
    the whole point of bit-loading."""
    cfg = OfdmAdaptiveConfig()
    rng = np.random.default_rng(4)
    probe = probe_waveform(cfg)
    rx = _shaped(np.concatenate([probe, np.zeros(600, np.float32)]),
                 rng, 0.002)
    from trackmaker_tpu.phy.ofdm import find_preambles
    s = int(np.asarray(find_preambles(cfg, jnp.asarray(rx), 2))[0])
    loading = choose_loading(np.asarray(
        estimate_bin_snr(cfg, jnp.asarray(rx), s)))

    payloads = [bytes([i + 3]) * 32 for i in range(2)]
    frames = [Frame.new_data(i, 1, 2, p) for i, p in enumerate(payloads)]

    adaptive = OfdmAdaptiveModem(cfg, loading=loading)
    wave_a = adaptive.encode_frames(frames, gap_samples=400)
    got_a = adaptive.decode(
        _shaped(np.concatenate([wave_a, np.zeros(900, np.float32)]),
                rng, 0.002), 7 + 32, max_frames=4)
    assert [f.data for f in got_a] == payloads

    n = len(cfg.data_bin_idx)
    uniform16 = OfdmAdaptiveModem(cfg, loading=(4,) * n)
    wave_u = uniform16.encode_frames(frames, gap_samples=400)
    got_u = uniform16.decode(
        _shaped(np.concatenate([wave_u, np.zeros(900, np.float32)]),
                rng, 0.002), 7 + 32, max_frames=4)
    assert len(got_u) < len(frames)   # CRC kills the drowned bins' frames


# ---------------------------------------------------------------------------
# Water-filling power allocation (choose_gains)


def test_gain_grid_roundtrip():
    """choose_gains output is on the handshake wire grid: pack/unpack
    reproduces it bit-exactly, so TX and RX configs are identical."""
    from trackmaker_tpu.phy.ofdm_adaptive import (
        choose_gains, pack_gains, quantize_gain, unpack_gains)
    rng = np.random.default_rng(5)
    n = 40
    snr = 10.0 ** (rng.uniform(0.5, 3.0, n))
    loading = tuple(rng.choice([0, 1, 2, 4], size=n).tolist())
    gains = choose_gains(snr, loading)
    assert unpack_gains(pack_gains(gains), n) == gains
    assert all(quantize_gain(g) == g for g in gains)


def test_choose_gains_power_and_margin():
    """Active-bin power is conserved, per-bin power respects the clip,
    and unclipped active bins end at the SAME margin (the water-filling
    defining property), up to wire-grid quantization."""
    from trackmaker_tpu.phy.ofdm_adaptive import choose_gains
    rng = np.random.default_rng(6)
    n = 48
    snr = 10.0 ** (rng.uniform(0.9, 2.6, n))       # 9..26 dB
    loading = choose_loading(snr, guard_bins=0)
    lv = np.asarray(loading)
    assert (lv > 0).sum() >= 8
    gains = np.asarray(choose_gains(snr, loading, max_gain_db=6.0))
    p = gains ** 2
    act = lv > 0
    # total power conserved (quantization leaves ~1%)
    assert abs(p[act].sum() - act.sum()) < 0.03 * act.sum()
    assert np.all(p[act] <= 10 ** 0.6 * 1.06)
    assert np.all(p[act] >= 10 ** -0.6 / 1.06)
    # equal margin on unclipped bins
    t = {1: 8.5, 2: 14.0, 4: 23.0}
    req = np.asarray([10 ** (t[v] / 10) if v else 1.0 for v in lv])
    margin = snr * p / req
    unclipped = act & (p < 10 ** 0.6 / 1.06) & (p > 10 ** -0.6 * 1.06)
    if unclipped.sum() >= 2:
        m = margin[unclipped]
        assert m.max() / m.min() < 1.15, m


def test_gains_loaded_link_roundtrip():
    """Mixed loading + water-filling gains round-trips end to end, and
    a LOADING control frame carries the gains losslessly."""
    from trackmaker_tpu.phy.ofdm_adaptive import (
        choose_gains, make_loading_frame, parse_control)
    cfg = OfdmAdaptiveConfig()
    n = len(cfg.data_bin_idx)
    rng = np.random.default_rng(7)
    snr = 10.0 ** (rng.uniform(1.0, 2.5, n))
    loading = choose_loading(snr, guard_bins=0)
    gains = choose_gains(snr, loading)

    ctrl = make_loading_frame(0, 1, 2, loading, gains)
    kind, l2, g2 = parse_control(ctrl, n)
    assert (kind, l2, g2) == ("loading", loading, gains)

    modem = OfdmAdaptiveModem(cfg, loading=l2, gains=g2)
    payloads = [bytes(range(36)), b"\x5a\xa5" * 18]
    frames = [Frame.new_data(i, 1, 2, p) for i, p in enumerate(payloads)]
    wave = modem.encode_frames(frames, gap_samples=300)
    noisy = (wave + rng.normal(0, 0.008, len(wave))).astype(np.float32)
    got = modem.decode(noisy, 7 + 36, max_frames=4)
    assert [f.data for f in got] == payloads


def test_waterfilling_reduces_bit_errors_on_shaped_channel():
    """The payoff test: at equal total transmit power on the shaped
    channel, probe-chosen gains produce fewer raw bit errors than unit
    gains with the SAME loading — the stranded margin of the strong
    bins buys back errors on the near-threshold ones.

    Noise is set ~12 dB ABOVE the probed level: that is the regime
    water-filling exists for (margins balanced => all bins degrade
    together instead of the weakest failing first).  Measured sweep
    (sigma: unit-errs vs wf-errs over 6 trials): 0.004: 2/0,
    0.006: 14/5, 0.008: 39/13, 0.010: 72/40, 0.013: 128/107 — the
    advantage vanishes far above the margin (both deep under water)
    and at the probe level (both error-free)."""
    from trackmaker_tpu.core import bitops
    from trackmaker_tpu.phy.ofdm import find_preambles
    from trackmaker_tpu.phy.ofdm_adaptive import (
        choose_gains, demodulate_at_adaptive, modulate_bits_adaptive)

    cfg = OfdmAdaptiveConfig()
    rng = np.random.default_rng(8)
    probe = probe_waveform(cfg)
    rx = _shaped(np.concatenate([probe, np.zeros(600, np.float32)]),
                 rng, 0.002)
    s = int(np.asarray(find_preambles(cfg, jnp.asarray(rx), 2))[0])
    snr = np.asarray(estimate_bin_snr(cfg, jnp.asarray(rx), s))
    # cap at 16-QAM: this test isolates the WATER-FILLING effect, and
    # at noise x4 any 64-QAM bins drown for both variants, diluting
    # the unit-vs-wf contrast the assertions pin
    t3 = (8.5, 14.0, 23.0)
    loading = choose_loading(snr, thresholds_db=t3)
    gains = choose_gains(snr, loading, thresholds_db=t3)

    bits = rng.integers(0, 2, (1, 1600), dtype=np.uint8)
    errs = {}
    for name, g in (("unit", None), ("wf", gains)):
        m = OfdmAdaptiveModem(cfg, loading=loading, gains=g)
        wave = np.asarray(modulate_bits_adaptive(
            m.cfg, jnp.asarray(bits), 1600)[0])
        total = 0
        for trial in range(6):
            trng = np.random.default_rng(100 + trial)
            noisy = _shaped(np.concatenate(
                [wave, np.zeros(900, np.float32)]), trng, 0.008)
            st = np.asarray(find_preambles(m.cfg, jnp.asarray(noisy), 1))
            got = np.asarray(demodulate_at_adaptive(
                m.cfg, jnp.asarray(noisy), 1600, jnp.asarray(st)))[0]
            total += int((got != bits[0]).sum())
        errs[name] = total
    assert errs["unit"] >= 20, errs          # regime sanity: real errors
    assert errs["wf"] < 0.6 * errs["unit"], errs


# ---------------------------------------------------------------------------
# 64-QAM loading tier


def test_qam64_mapping_properties():
    """Gray map: bit triple -> level is the inverse of level -> code,
    adjacent amplitudes differ in ONE bit, unit average power, and the
    hard demap inverts the modulator exactly."""
    from trackmaker_tpu.phy.ofdm_adaptive import (
        _GRAY3, _GRAY3_ENC, _bits_to_qam64, _qam64_to_bits)
    g_enc = np.asarray(_GRAY3_ENC)
    assert all(bin(g_enc[i] ^ g_enc[i + 1]).count("1") == 1
               for i in range(7))
    assert all(int(np.asarray(_GRAY3)[g_enc[l]]) == l for l in range(8))
    rng = np.random.default_rng(11)
    bits = jnp.asarray(rng.integers(0, 2, (4, 96), dtype=np.uint8))
    sym = _bits_to_qam64(bits)
    assert np.array_equal(np.asarray(_qam64_to_bits(sym)),
                          np.asarray(bits))
    assert abs(float(np.mean(np.abs(np.asarray(sym)) ** 2)) - 1.0) < 0.1


def test_loading_wire_codec_with_qam64():
    from trackmaker_tpu.phy.ofdm_adaptive import (pack_loading,
                                                  unpack_loading)
    rng = np.random.default_rng(12)
    loading = tuple(int(v) for v in rng.choice([0, 1, 2, 4, 6], size=37))
    assert unpack_loading(pack_loading(loading), 37) == loading


def test_qam64_tier_lifts_throughput_on_strong_channel():
    """A mildly shaped, quiet channel probes ~>30 dB across most bins:
    the 4-tier loading chooses 64-QAM there, carries >=1.15x the bits
    of the 16-QAM-capped loading per symbol (measured 253 vs 215), and
    the loaded frames still round-trip exactly."""
    from trackmaker_tpu.phy.ofdm import find_preambles
    cfg = OfdmAdaptiveConfig()
    rng = np.random.default_rng(13)
    probe = probe_waveform(cfg)
    rx = _shaped(np.concatenate([probe, np.zeros(600, np.float32)]),
                 rng, 0.0006)
    s = int(np.asarray(find_preambles(cfg, jnp.asarray(rx), 2))[0])
    snr = np.asarray(estimate_bin_snr(cfg, jnp.asarray(rx), s))
    load4 = choose_loading(snr)
    load3 = choose_loading(snr, thresholds_db=(8.5, 14.0, 23.0))
    lv = np.asarray(load4)
    assert (lv == 6).sum() >= 8, lv
    m4 = OfdmAdaptiveModem(cfg, loading=load4)
    m3 = OfdmAdaptiveModem(cfg, loading=load3)
    assert m4.bits_per_symbol >= 1.15 * m3.bits_per_symbol

    # round-trip over the PRODUCTION path (the coded stream PHY): the
    # uncoded hard-decision modem at threshold+~5 dB margin is
    # genuinely marginal by design — FEC is what carries 64-QAM
    from trackmaker_tpu.phy.ofdm_adaptive import OfdmAdaptiveStreamPhy
    tx = OfdmAdaptiveStreamPhy(cfg, loading=load4, local_addr=1)
    rx_phy = OfdmAdaptiveStreamPhy(cfg, loading=load4, local_addr=2)
    payloads = [bytes(range(40)), b"\xa5\x5a" * 20, bytes(40)]
    frames = [Frame.new_data(i, 1, 2, p) for i, p in enumerate(payloads)]
    wave = tx.encode_frames(frames)
    noisy = _shaped(np.concatenate([wave, np.zeros(900, np.float32)]),
                    rng, 0.0006)
    got = rx_phy.process_samples(noisy)
    assert [f.data for f in got] == payloads


def test_batched_decode_matches_streaming():
    """The batched device decode (batched_decode_fn) must recover exactly
    the frames the streaming `process_samples` facade does on noisy
    equal-length captures (default loading)."""
    import numpy as np
    from trackmaker_tpu.core.framing import Frame
    from trackmaker_tpu.phy.ofdm_adaptive import OfdmAdaptiveStreamPhy

    phy = OfdmAdaptiveStreamPhy(local_addr=2)
    rng = np.random.default_rng(4)
    n, plen = 4, 48
    frames = [Frame.new_data(i, 1, 2,
                             rng.integers(0, 256, plen,
                                          dtype=np.uint8).tobytes())
              for i in range(n)]
    caps, want = [], []
    for b in range(2):
        wave = phy.encode_frames(frames, gap_samples=301 + 64 * b)
        lead = int(rng.integers(0, 200))
        x = np.concatenate([np.zeros(lead, np.float32), wave,
                            np.zeros(300, np.float32)])
        x = (x + rng.normal(0, 0.02, len(x))).astype(np.float32)
        caps.append(x)
        phy.reset()
        want.append([(f.sequence, f.data)
                     for f in phy.process_samples(x)])
        assert len(want[-1]) == n
    t = max(len(c) for c in caps)
    batch = np.zeros((2, t), np.float32)
    for b, c in enumerate(caps):
        batch[b, :len(c)] = c
    got = phy.decode_equal_frames(batch, n, plen)
    for b in range(2):
        assert [(f.sequence, f.data) for f in got[b]] == want[b]
