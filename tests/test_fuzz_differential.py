"""Randomized differential fuzz: decoder vs oracle across seeds/configs.

Every trial builds a random frame train (random payload sizes, gaps,
amplitudes, noise, truncation) and requires the batched device decoder to
produce the oracle's exact frame sequence.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from trackmaker_tpu.core.config import PhyConfig
from trackmaker_tpu.core.framing import Frame
from trackmaker_tpu.oracle.phy import OracleDecoder, OracleEncoder
from trackmaker_tpu.phy.decoder import decode_capture


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("coding", ["manchester", "4b5b"])
def test_fuzz_matches_oracle(coding, seed):
    rng = np.random.default_rng(1000 + seed)
    cfg = PhyConfig(line_coding=coding,
                    samples_per_level=int(rng.choice([2, 3, 4])))
    n = int(rng.integers(3, 10))
    frames = []
    for i in range(n):
        size = int(rng.integers(1, 129))
        dst = int(rng.choice([2, 2, 2, 3]))  # some frames not for us
        frames.append(Frame.new_data(
            i, 1, dst, rng.integers(0, 256, size, dtype=np.uint8)
            .tobytes()))
    enc = OracleEncoder(cfg)
    parts = [np.zeros(int(rng.integers(0, 900)), np.float32)]
    for f in frames:
        parts.append(enc.encode_frame(f) * float(rng.uniform(0.4, 1.0)))
        parts.append(np.zeros(int(rng.integers(0, 700)), np.float32))
    wave = np.concatenate(parts)
    # random corruption: noise + occasional sample zeroing + truncation
    wave = wave + rng.normal(0, rng.uniform(0.01, 0.12),
                             len(wave)).astype(np.float32)
    if rng.random() < 0.4:
        k = int(rng.integers(0, max(len(wave) - 300, 1)))
        wave[k:k + int(rng.integers(10, 300))] = 0.0
    if rng.random() < 0.3:
        wave = wave[: int(len(wave) * rng.uniform(0.6, 0.999))]

    want = OracleDecoder(cfg, 2).process_samples(wave)
    got = decode_capture(cfg, jnp.asarray(wave), 2,
                         max_frames=n + 8).to_frames()
    assert [f.sequence for f in got] == [f.sequence for f in want], (
        coding, seed)
    assert [f.data for f in got] == [f.data for f in want], (coding, seed)
