"""Viterbi-coded Manchester PHY (phy/coded.py): roundtrip, streaming,
the >=4 dB frame-loss cliff shift vs the uncoded decoder, and fewer ARQ
retransmissions at equal SNR.

Motivation anchor: the reference's report measured 5-15% frame loss
recovered purely by ARQ (docs/proj/report.md:532)."""

import numpy as np
import pytest

from trackmaker_tpu.core.config import MacConfig, PhyConfig
from trackmaker_tpu.core.framing import Frame
from trackmaker_tpu.phy.coded import CodedManchesterPhy

# Detection must outlive demod noise for the comparison to measure
# CODING, not the correlator: normalized preamble correlation decays as
# 1/sqrt(1+sigma^2) under AWGN, so the default 0.9 threshold fails at
# sigma~0.48 where bit errors are still ~0.  Both PHYs get the same
# lowered threshold.
CFG = PhyConfig(correlation_threshold=0.45)


def test_roundtrip_clean_and_streaming():
    phy = CodedManchesterPhy(CFG, local_addr=2)
    frames = [Frame.new_data(0, 1, 2, b"coded manchester"),
              Frame.new_ack(0, 1, 2),
              Frame.new_data(1, 1, 2, bytes(range(100)))]
    wave = phy.encode_frames(frames, gap_samples=300)
    got = []
    for i in range(0, len(wave), 1500):
        got.extend(phy.process_samples(wave[i:i + 1500]))
    assert [(f.frame_type, f.data) for f in got] == [
        (f.frame_type, f.data) for f in frames]


def test_dst_filter_and_noise_rejection():
    phy = CodedManchesterPhy(CFG, local_addr=2)
    assert phy.process_samples(
        np.random.default_rng(0).normal(0, 0.05, 6000)
        .astype(np.float32)) == []
    wave = phy.encode_frames([Frame.new_data(0, 1, 9, b"not yours")])
    assert phy.process_samples(np.concatenate(
        [wave, np.zeros(3000, np.float32)])) == []


def _loss_uncoded(sigma: float, frames, rng) -> float:
    import jax.numpy as jnp
    from trackmaker_tpu.phy.decoder import decode_capture
    from trackmaker_tpu.phy.encoder import PhyEncoder

    wave = PhyEncoder(CFG).encode_frames(frames, gap_samples=300)
    t = 60_000
    cap = np.zeros(t, np.float32)
    cap[:len(wave)] = wave
    cap += rng.normal(0, sigma, t).astype(np.float32)
    res = decode_capture(CFG, jnp.asarray(cap), 2,
                         max_frames=len(frames) + 4)
    valid = np.asarray(res.valid)
    fb = np.asarray(res.frame_bytes)
    ok = 0
    for w in frames:
        for j in np.nonzero(valid)[0]:
            if fb[j, 7:7 + len(w.data)].tobytes() == w.data:
                ok += 1
                break
    return 1.0 - ok / len(frames)


def _loss_coded(sigma: float, frames, rng) -> float:
    phy = CodedManchesterPhy(CFG, local_addr=2)
    wave = phy.encode_frames(frames, gap_samples=300)
    cap = np.concatenate([wave, np.zeros(4000, np.float32)])
    cap = cap + rng.normal(0, sigma, len(cap)).astype(np.float32)
    got = phy.process_samples(cap)
    ok = sum(1 for w in frames
             if any(f.data == w.data and f.sequence == w.sequence
                    for f in got))
    return 1.0 - ok / len(frames)


def _cliff(loss_fn, frames, sigmas, rng) -> float:
    """First sigma whose loss >= 0.5 (the grid is ordered)."""
    for s in sigmas:
        if loss_fn(float(s), frames, rng) >= 0.5:
            return float(s)
    return float(sigmas[-1])


def test_frame_loss_cliff_at_least_4db_left():
    rng = np.random.default_rng(42)
    frames = [Frame.new_data(i, 1, 2, bytes([i]) * 64) for i in range(6)]
    sigmas = np.arange(0.45, 2.5, 0.15)
    cliff_u = _cliff(_loss_uncoded, frames, sigmas, rng)
    cliff_c = _cliff(_loss_coded, frames, sigmas, rng)
    gain_db = 20.0 * np.log10(cliff_c / cliff_u)
    assert gain_db >= 4.0, (cliff_u, cliff_c, gain_db)


def test_fewer_retransmissions_at_equal_snr():
    """Same noisy bus, same MAC, same data: the coded PHY completes the
    ARQ transfer with fewer retransmissions than the uncoded one."""
    from trackmaker_tpu.link.audio import AudioEndpoint
    from trackmaker_tpu.link.bus import SimulatedBus
    from trackmaker_tpu.link.csma import CsmaReceiver, CsmaSender
    from trackmaker_tpu.link.transfer import chunk_payload

    # carrier sense is |s| > energy_threshold: at this noise level the
    # default threshold reads permanently busy, so disable it (same for
    # both runs; a single pair has no contention to sense anyway)
    mac_cfg = MacConfig(energy_threshold=3.0)
    data = b"retransmission comparison payload " * 25
    sigma = 0.9    # uncoded loses most frames here; coded ~0%

    def run(phy_factory):
        bus = SimulatedBus(noise_std=sigma, seed=9)
        ep_tx, ep_rx = AudioEndpoint("tx"), AudioEndpoint("rx")
        kw_tx = {"phy": phy_factory(1)} if phy_factory else {}
        kw_rx = {"phy": phy_factory(2)} if phy_factory else {}
        sender = CsmaSender(ep_tx, CFG, mac_cfg, 1, 2, **kw_tx)
        receiver = CsmaReceiver(ep_rx, CFG, mac_cfg, 2, 1, **kw_rx)
        bus.attach(ep_tx, sender)
        bus.attach(ep_rx, receiver)
        chunks = chunk_payload(data, CFG.max_frame_data_size)
        for c in chunks:
            sender.send(c)
        bus.run(400 * bus.sample_rate,
                until=lambda: sender.finished
                and len(receiver.received) >= len(chunks))
        ok = b"".join(receiver.received) == data
        return sender.retransmissions, ok

    retx_coded, ok_coded = run(
        lambda addr: CodedManchesterPhy(CFG, local_addr=addr))
    retx_uncoded, _ok_uncoded = run(None)
    # the coded link must deliver intact; the uncoded one at this SNR
    # sometimes corrupts payload (CRC8 + CRC-unprotected header at a
    # ~40% frame-error rate) — either way it retransmits heavily
    assert ok_coded
    assert retx_coded < retx_uncoded, (retx_coded, retx_uncoded)
    assert retx_uncoded >= 10, retx_uncoded


# ---------------------------------------------------------------------------
# Rate-3/4 puncturing (core/convcode.py) + the coded 4B5B PHY
# ---------------------------------------------------------------------------


def test_puncture_roundtrip_clean():
    import jax.numpy as jnp
    from trackmaker_tpu.core.convcode import (
        conv_encode, depuncture_34, punctured_len_34, puncture_34,
        viterbi_decode)

    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, 200).astype(np.uint8)
    coded = conv_encode(jnp.asarray(bits))
    kept = puncture_34(coded)
    assert kept.shape[-1] == punctured_len_34(coded.shape[-1])
    # rate: 6 mother bits -> 4 transmitted
    assert abs(kept.shape[-1] / coded.shape[-1] - 2 / 3) < 0.02
    soft = jnp.asarray(np.asarray(kept), np.float32) * 2.0 - 1.0
    dec = viterbi_decode(depuncture_34(soft, coded.shape[-1]),
                         len(bits), soft=True)
    assert np.array_equal(np.asarray(dec), bits)


def test_puncture_corrects_noise():
    import jax.numpy as jnp
    from trackmaker_tpu.core.convcode import (
        conv_encode, depuncture_34, puncture_34, viterbi_decode)

    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, 300).astype(np.uint8)
    coded = conv_encode(jnp.asarray(bits))
    soft = np.asarray(puncture_34(coded), np.float32) * 2.0 - 1.0
    soft += rng.normal(0, 0.55, soft.shape).astype(np.float32)
    dec = viterbi_decode(
        depuncture_34(jnp.asarray(soft), coded.shape[-1]),
        len(bits), soft=True)
    assert np.array_equal(np.asarray(dec), bits)


CFG4 = PhyConfig(line_coding="4b5b", correlation_threshold=0.45)


def _coded_4b5b(rate34=False, addr=2):
    from trackmaker_tpu.phy.coded import CodedFourB5BPhy
    return CodedFourB5BPhy(CFG4, local_addr=addr, rate34=rate34)


@pytest.mark.parametrize("rate34", [False, True])
def test_coded_4b5b_roundtrip_streaming(rate34):
    phy = _coded_4b5b(rate34)
    frames = [Frame.new_data(0, 1, 2, b"coded 4b5b nrzi"),
              Frame.new_ack(0, 1, 2),
              Frame.new_data(1, 1, 2, bytes(range(90)))]
    wave = phy.encode_frames(frames, gap_samples=300)
    got = []
    for i in range(0, len(wave), 1300):
        got.extend(phy.process_samples(wave[i:i + 1300]))
    assert [(f.frame_type, f.data) for f in got] == [
        (f.frame_type, f.data) for f in frames]


@pytest.mark.parametrize("rate34", [False, True])
def test_coded_manchester_rate34_roundtrip(rate34):
    phy = CodedManchesterPhy(CFG, local_addr=2, rate34=rate34)
    frames = [Frame.new_data(5, 1, 2, b"punctured manchester")]
    wave = phy.encode_frames(frames)
    got = phy.process_samples(
        np.concatenate([wave, np.zeros(2000, np.float32)]))
    assert [f.data for f in got] == [frames[0].data]


def test_coded_4b5b_noise_and_dst_filter():
    phy = _coded_4b5b()
    assert phy.process_samples(
        np.random.default_rng(0).normal(0, 0.05, 6000)
        .astype(np.float32)) == []
    wave = phy.encode_frames([Frame.new_data(0, 1, 9, b"not yours")])
    assert phy.process_samples(np.concatenate(
        [wave, np.zeros(3000, np.float32)])) == []


def test_coded_4b5b_denser_than_coded_manchester():
    """Same payload, same code rate: the 4B5B wire is ~1.6x shorter
    (3.75 vs 6 samples per transmitted bit at spl=3), and rate 3/4
    recovers another ~1.45x."""
    m = CodedManchesterPhy(CFG, local_addr=2)
    q = _coded_4b5b()
    q34 = _coded_4b5b(rate34=True)
    n = 64
    body_m = m.frame_samples(n) - m.preamble_len
    body_q = q.frame_samples(n) - q.preamble_len
    body_q34 = q34.frame_samples(n) - q34.preamble_len
    assert body_m / body_q > 1.5, (body_m, body_q)
    assert body_q / body_q34 > 1.4, (body_q, body_q34)


def test_coded_4b5b_corrects_what_uncoded_loses():
    """At a noise level where the uncoded 4B5B decoder corrupts or
    drops most frames, the coded 4B5B PHY still delivers them all."""
    import jax.numpy as jnp
    from trackmaker_tpu.phy.decoder import decode_capture
    from trackmaker_tpu.phy.encoder import PhyEncoder

    rng = np.random.default_rng(11)
    frames = [Frame.new_data(i, 1, 2, bytes([64 + i]) * 48)
              for i in range(6)]
    sigma = 0.75

    wave_u = PhyEncoder(CFG4).encode_frames(frames, gap_samples=300)
    cap = np.concatenate([wave_u, np.zeros(3000, np.float32)])
    cap = cap + rng.normal(0, sigma, len(cap)).astype(np.float32)
    res = decode_capture(CFG4, jnp.asarray(cap), 2,
                         max_frames=len(frames) + 4)
    valid = np.asarray(res.valid)
    fb = np.asarray(res.frame_bytes)
    ok_u = sum(
        1 for w in frames
        if any(fb[j, 7:7 + len(w.data)].tobytes() == w.data
               for j in np.nonzero(valid)[0]))

    phy = _coded_4b5b()
    wave_c = phy.encode_frames(frames, gap_samples=300)
    cap_c = np.concatenate([wave_c, np.zeros(3000, np.float32)])
    cap_c = cap_c + rng.normal(0, sigma, len(cap_c)).astype(np.float32)
    got = phy.process_samples(cap_c)
    ok_c = sum(1 for w in frames
               if any(f.data == w.data and f.sequence == w.sequence
                      for f in got))
    assert ok_c == len(frames), (ok_c, len(frames))
    assert ok_u < len(frames), ok_u


@pytest.mark.parametrize("kind,rate34", [
    ("manchester", False), ("manchester", True),
    ("fourb5b", False), ("fourb5b", True)])
def test_batched_decode_matches_streaming(kind, rate34):
    """The batched device decode (batched_decode_fn: pattern sync + soft
    demod + Viterbi, one fixed-shape program) must recover exactly the
    frames the streaming `process_samples` facade does, on noisy
    multi-frame captures with random lead-in."""
    from trackmaker_tpu.core.config import FOUR_B_FIVE_B
    from trackmaker_tpu.phy.coded import CodedFourB5BPhy

    if kind == "manchester":
        phy = CodedManchesterPhy(CFG, local_addr=2, rate34=rate34)
    else:
        phy = CodedFourB5BPhy(
            PhyConfig(line_coding=FOUR_B_FIVE_B,
                      correlation_threshold=0.45),
            local_addr=2, rate34=rate34)
    rng = np.random.default_rng(11)
    n, plen = 5, 48
    frames = [Frame.new_data(i, 1, 2,
                             rng.integers(0, 256, plen,
                                          dtype=np.uint8).tobytes())
              for i in range(n)]
    caps = []
    want = []
    for b in range(2):
        wave = phy.encode_frames(frames, gap_samples=257 + 31 * b)
        lead = int(rng.integers(0, 300))
        x = np.concatenate([np.zeros(lead, np.float32), wave,
                            np.zeros(400, np.float32)])
        x = (x + rng.normal(0, 0.12, len(x))).astype(np.float32)
        caps.append(x)
        phy.reset()
        want.append([(f.sequence, f.data) for f in
                     phy.process_samples(x)])
        assert len(want[-1]) == n     # stream decode itself must work
    t = max(len(c) for c in caps)
    batch = np.zeros((2, t), np.float32)
    for b, c in enumerate(caps):
        batch[b, :len(c)] = c
    got = phy.decode_equal_frames(batch, n + 2, plen)
    for b in range(2):
        assert [(f.sequence, f.data) for f in got[b]] == want[b]
