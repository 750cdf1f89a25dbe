"""StreamingDecodePipeline differential: the pipeline's segment decode
routes through the speculative decoder.  Pin that (a) for every segment the
pipeline actually ships, the speculative decoder's decisions equal the
exact scan's, and (b) decode_capture_fast's bucket-padding + valid_len
calling convention (what stream.py uses) decodes identically to the
unpadded capture.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from trackmaker_tpu.core.config import FOUR_B_FIVE_B, MANCHESTER, PhyConfig
from trackmaker_tpu.core.framing import Frame
from trackmaker_tpu.link.stream import StreamingDecodePipeline
from trackmaker_tpu.phy import spec_decode as pd
from trackmaker_tpu.phy.decoder import decode_capture, decode_capture_fast
from trackmaker_tpu.phy.encoder import PhyEncoder


def _sparse_capture(cfg, n_frames, silence=20_000, seed=0, noise=0.01):
    rng = np.random.default_rng(seed)
    enc = PhyEncoder(cfg)
    frames = [Frame.new_data(i, 1, 2,
                             rng.integers(0, 256, 48,
                                          dtype=np.uint8).tobytes())
              for i in range(n_frames)]
    parts = [np.zeros(silence, np.float32)]
    for f in frames:
        parts.append(np.asarray(enc.encode_frame(f)))
        parts.append(np.zeros(silence, np.float32))
    wave = np.concatenate(parts)
    return frames, wave + rng.normal(0, noise, len(wave)).astype(np.float32)


def _decisions(res):
    """Decision tuple list for valid slots, in frame-start order —
    compaction-insensitive (the spec path packs valid frames into the
    leading slots; the exact path leaves gaps)."""
    valid = np.asarray(res.valid)
    out = []
    for k in np.nonzero(valid)[0]:
        ln = int(np.asarray(res.length)[k])
        out.append((int(np.asarray(res.start)[k]),
                    int(np.asarray(res.sequence)[k]),
                    int(np.asarray(res.src)[k]),
                    int(np.asarray(res.dst)[k]),
                    ln,
                    np.asarray(res.frame_bytes)[k, :7 + ln].tobytes()))
    return sorted(out)


@pytest.mark.parametrize("coding", [MANCHESTER, FOUR_B_FIVE_B])
def test_segment_decode_spec_matches_exact(coding):
    """Every segment the pipeline ships: spec == exact."""
    cfg = PhyConfig(line_coding=coding)
    frames, wave = _sparse_capture(cfg, 5, seed=3)
    segments = []
    orig = StreamingDecodePipeline._decode_segment

    def record(self, seg):
        segments.append(np.array(seg))
        return orig(self, seg)

    pipe = StreamingDecodePipeline(cfg, 2)
    pipe._decode_segment = record.__get__(pipe)
    got = []
    for i in range(0, len(wave), 4096):
        got.extend(pipe.push(wave[i:i + 4096]))
    got.extend(pipe.flush())
    assert [f.data for f in got] == [f.data for f in frames]
    assert segments, "pipeline shipped no segments"

    for seg in segments:
        n = len(seg)
        b = 4096
        while b < n:
            b *= 2
        padded = np.zeros(b, np.float32)
        padded[:n] = seg
        exact = decode_capture(cfg, jnp.asarray(padded), 2,
                               max_frames=32, valid_len=n)
        spec, ok = pd.decode_capture_spec(
            cfg, jnp.asarray(padded)[None], 2, max_frames=32,
            valid_len=jnp.asarray([n]))
        assert bool(np.asarray(ok)[0])
        spec0 = jax.tree_util.tree_map(lambda a: a[0], spec)
        assert _decisions(spec0) == _decisions(exact)


@pytest.mark.parametrize("coding", [MANCHESTER, FOUR_B_FIVE_B])
def test_fast_decode_valid_len_padding(coding):
    """decode_capture_fast(padded, valid_len=n) == decode_capture_fast
    on the unpadded capture — the bucket-padding convention stream.py
    relies on (single capture and batched rows)."""
    cfg = PhyConfig(line_coding=coding)
    frames, wave = _sparse_capture(cfg, 3, silence=4_000, seed=7)
    n = len(wave)
    b = 4096
    while b < n + 9_000:
        b *= 2
    padded = np.zeros(b, np.float32)
    padded[:n] = wave

    want = decode_capture_fast(cfg, jnp.asarray(wave), 2, max_frames=16)
    got = decode_capture_fast(cfg, jnp.asarray(padded), 2, max_frames=16,
                              valid_len=n)
    assert _decisions(got) == _decisions(want)
    assert [f.data for f in got.to_frames()] == [f.data for f in frames]

    # batched: two rows, different true lengths in one padded buffer
    frames2, wave2 = _sparse_capture(cfg, 2, silence=4_000, seed=8)
    n2 = len(wave2)
    batch = np.zeros((2, b), np.float32)
    batch[0, :n] = wave
    batch[1, :n2] = wave2
    res = decode_capture_fast(cfg, jnp.asarray(batch), 2, max_frames=16,
                              valid_len=jnp.asarray([n, n2]))
    row0 = jax.tree_util.tree_map(lambda a: a[0], res)
    row1 = jax.tree_util.tree_map(lambda a: a[1], res)
    assert _decisions(row0) == _decisions(want)
    assert [f.data for f in row1.to_frames()] == [f.data for f in frames2]


@pytest.mark.parametrize("coding", [MANCHESTER, FOUR_B_FIVE_B])
def test_packed_decoder_roundtrip(coding):
    """The one-readback packed segment decode (stream._packed_decoder +
    _parse_packed) yields exactly decode_capture_fast's
    frames on the same padded segment."""
    from trackmaker_tpu.link.stream import (_bucket, _packed_decoder,
                                            _parse_packed)
    cfg = PhyConfig(line_coding=coding)
    frames, wave = _sparse_capture(cfg, 3, silence=6_000, seed=5)
    n = len(wave)
    b = _bucket(n)
    padded = np.zeros(b + 1, np.float32)
    padded[:n] = wave
    padded[b] = n                     # length rides in the buffer
    fn = _packed_decoder(cfg, 32)
    arr = np.asarray(fn(padded, jnp.int32(2)))
    ok, got = _parse_packed(arr)
    assert ok
    ref = decode_capture_fast(cfg, jnp.asarray(padded), 2,
                              max_frames=32, valid_len=n).to_frames()
    assert [bytes(f.to_bytes()) for f in got] == \
        [bytes(f.to_bytes()) for f in ref]
    assert len(got) == 3
