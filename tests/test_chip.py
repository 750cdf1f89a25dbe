"""Oracle differentials at real widths on the GPU (marker `chip`).

Each test asks for the `gpu` fixture, which skips it where JAX has no
GPU; `chip_smoke.py` runs this file on the card
(``JAX_PLATFORMS=cuda python -m pytest tests/test_chip.py -m chip``).
Decisions must equal the NumPy oracles of the reference decision for
decision: a product computed at reduced precision (TF32) could move a
window across the 0.9 correlation threshold or flip a sync argmax.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from trackmaker_tpu.core.config import FOUR_B_FIVE_B, MANCHESTER, PhyConfig
from trackmaker_tpu.core.framing import Frame
from trackmaker_tpu.oracle.phy import OracleDecoder, OracleEncoder
from trackmaker_tpu.phy.decoder import decode_capture, decode_capture_fast
from trackmaker_tpu.phy.encoder import PhyEncoder

pytestmark = pytest.mark.chip


def _frames(rng, n, payload):
    return [Frame.new_data(i & 0xFF, 1, 2,
                           rng.integers(0, 256, payload,
                                        dtype=np.uint8).tobytes())
            for i in range(n)]


def _tuples(frames):
    return [(f.sequence, f.src, f.dst, f.data) for f in frames]


@pytest.mark.parametrize("coding", [MANCHESTER, FOUR_B_FIVE_B])
def test_flagship_batch_equals_oracle(gpu, coding):
    """Four noisy flagship-shaped captures (64 frames x 128 B, sigma
    0.15 so some windows sit near the threshold): the batched decode
    equals the oracle on every capture."""
    cfg = PhyConfig(line_coding=coding)
    rng = np.random.default_rng(11)
    frames = _frames(rng, 64, 128)
    wave = PhyEncoder(cfg).encode_frames(frames, gap_samples=200)
    caps = np.stack([wave + rng.normal(0, 0.15, len(wave))
                     .astype(np.float32) for _ in range(4)])
    res = decode_capture_fast(cfg, jnp.asarray(caps), 2, max_frames=72)
    for b in range(len(caps)):
        want = OracleDecoder(cfg, 2).process_samples(caps[b])
        assert _tuples(res.to_frames(b)) == _tuples(want), b


@pytest.mark.parametrize("coding", [MANCHESTER, FOUR_B_FIVE_B])
def test_adversarial_capture_equals_oracle(gpu, coding):
    """Evil payloads embedding the preamble, a foreign destination and a
    corrupted frame: exact scan and speculative decode both equal the
    oracle."""
    cfg = PhyConfig(line_coding=coding)
    enc = OracleEncoder(cfg)
    inner = Frame.new_data(99, 1, 2, b"EMBEDDED").to_bytes()
    parts = [np.zeros(500, np.float32)]
    for i, f in enumerate([
            Frame.new_data(1, 1, 2, bytes([0x33, 0x5A]) + inner),
            Frame.new_data(2, 1, 9, b"foreign"),
            Frame.new_data(3, 1, 2, b"x" * 100),
            Frame.new_data(4, 1, 2, b"last")]):
        w = np.array(enc.encode_frame(f), np.float32)
        if i == 2:
            w[len(w) // 2: len(w) // 2 + 40] *= -1.0
        parts += [w, np.zeros(300 + 50 * i, np.float32)]
    wave = np.concatenate(parts)
    want = _tuples(OracleDecoder(cfg, 2).process_samples(wave))
    exact = decode_capture(cfg, jnp.asarray(wave), 2, max_frames=16)
    fast = decode_capture_fast(cfg, jnp.asarray(wave), 2, max_frames=16)
    assert _tuples(exact.to_frames()) == want
    assert _tuples(fast.to_frames()) == want


def test_ask_batch_equals_oracle(gpu):
    from trackmaker_tpu.oracle import ask as oracle_ask
    from trackmaker_tpu.phy import ask

    cfg = ask.AskConfig()
    frames = ask.build_frames(b"oracle on the card", cfg, num_frames=6)
    gaps = np.random.default_rng(3).integers(0, 100, size=(6, 2))
    track = ask.build_track(cfg, frames, gaps=gaps)
    track = track + np.random.default_rng(4).normal(
        0, 0.05, len(track)).astype(np.float32)
    want = oracle_ask.demodulate(track)
    res = ask.demodulate_fast(cfg, track, max_frames=10)
    v = np.asarray(res.valid)
    got = list(zip(np.asarray(res.frame_id)[v].tolist(),
                   np.asarray(res.bits)[v]))
    assert len(got) == len(want)
    for (gid, gbits), (wid, wbits) in zip(got, want):
        assert gid == wid and np.array_equal(gbits, wbits)
