"""Streaming pipeline: segment-gated decode of sparse live capture."""

import numpy as np
import pytest

from trackmaker_tpu.core.config import PhyConfig
from trackmaker_tpu.core.framing import Frame
from trackmaker_tpu.link.stream import StreamingDecodePipeline
from trackmaker_tpu.phy.encoder import PhyEncoder


def _sparse_capture(cfg, n_frames, silence=20_000, seed=0):
    rng = np.random.default_rng(seed)
    enc = PhyEncoder(cfg)
    frames = [Frame.new_data(i, 1, 2,
                             rng.integers(0, 256, 48,
                                          dtype=np.uint8).tobytes())
              for i in range(n_frames)]
    parts = [np.zeros(silence, np.float32)]
    for f in frames:
        parts.append(enc.encode_frame(f))
        parts.append(np.zeros(silence, np.float32))
    return frames, np.concatenate(parts)


@pytest.mark.parametrize("use_native", [True, False])
def test_streaming_pipeline_sparse(use_native):
    cfg = PhyConfig()
    frames, wave = _sparse_capture(cfg, 6)
    pipe = StreamingDecodePipeline(cfg, 2, use_native=use_native)
    got = []
    for i in range(0, len(wave), 4096):
        got.extend(pipe.push(wave[i:i + 4096]))
    got.extend(pipe.flush())
    assert [f.data for f in got] == [f.data for f in frames]
    # the point of the gate: only a fraction of the stream hit the device
    assert pipe.samples_shipped < 0.6 * pipe.samples_seen
    assert pipe.segments_decoded >= 6


def test_streaming_pipeline_noise_floor():
    cfg = PhyConfig()
    frames, wave = _sparse_capture(cfg, 3, silence=30_000, seed=1)
    noisy = wave + np.random.default_rng(2).normal(
        0, 0.015, len(wave)).astype(np.float32)
    pipe = StreamingDecodePipeline(cfg, 2)
    got = []
    for i in range(0, len(noisy), 8192):
        got.extend(pipe.push(noisy[i:i + 8192]))
    got.extend(pipe.flush())
    assert [f.data for f in got] == [f.data for f in frames]


def test_streaming_pipeline_silence_only():
    cfg = PhyConfig()
    pipe = StreamingDecodePipeline(cfg, 2)
    out = pipe.push(np.zeros(100_000, np.float32))
    out += pipe.flush()
    assert out == []
    assert pipe.segments_decoded == 0
