"""Streaming decode pipeline: ring/chunk input -> energy-gated segments
-> bucketed device batch decode.

This is the production path for *live* capture: instead of shipping
every sample to the device (the reference decodes everything inline on
the CPU audio thread), the native segmenter (`runtime.active_regions`)
finds active bursts in O(T) on the host, and only those — padded to a
handful of power-of-2 bucket shapes so XLA compiles a few programs, not
one per length — hit the device decoder.  Sparse channels (the common case:
CSMA means mostly silence) decode at a tiny fraction of the dense cost.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from trackmaker_tpu.core.config import PHY_HEADER_BYTES, PhyConfig
from trackmaker_tpu.core.framing import Frame
from trackmaker_tpu.phy.decoder import decode_capture_fast


def _bucket(n: int, lo: int = 4096) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


@functools.lru_cache(maxsize=64)
def _packed_decoder(cfg: PhyConfig, max_frames: int):
    """Jitted spec decode + single-buffer result pack for the streaming
    hot path: every per-segment device->host fetch (`ok`, then
    to_frames' valid/frame_bytes/length) would be a separate
    synchronizing readback; packing into one uint8 matrix makes it ONE.
    The rare not-ok row falls back to the exact path
    (decode_capture_fast).

    Layout per slot row (uint8, width = frame-capacity + 4):
      [:cap]   frame_bytes (header + payload, zero-padded)
      [cap]    valid flag
      [cap+1]  length low byte   (payload length <= 263 < 2^16)
      [cap+2]  length high byte
      [cap+3]  spec-path ok flag (same value every row)
    """
    from trackmaker_tpu.phy.spec_decode import decode_capture_spec

    @jax.jit
    def f(xn, local_addr):
        # One input array: samples in [:b], true length in slot [b] (f32
        # is integer-exact far beyond any bucket size), so a segment
        # costs one host->device copy, one dispatch and one readback.
        x, vlen = xn[:-1], xn[-1].astype(jnp.int32)
        res, ok = decode_capture_spec(cfg, x[None], local_addr,
                                      max_frames=max_frames,
                                      valid_len=vlen[None])
        fb = res.frame_bytes[0]
        k = fb.shape[0]
        valid = res.valid[0].astype(jnp.uint8)[:, None]
        ln = res.length[0]
        lo = (ln & 0xFF).astype(jnp.uint8)[:, None]
        hi = ((ln >> 8) & 0xFF).astype(jnp.uint8)[:, None]
        okb = jnp.full((k, 1), 0, jnp.uint8) + ok[0].astype(jnp.uint8)
        return jnp.concatenate([fb, valid, lo, hi, okb], axis=1)

    return f


def _parse_packed(arr: np.ndarray) -> tuple[bool, list[Frame]]:
    """(spec_ok, frames) from `_packed_decoder` output."""
    cap = arr.shape[1] - 4
    if not arr[0, cap + 3]:
        return False, []
    out = []
    for row in arr:
        if not row[cap]:
            continue
        ln = int(row[cap + 1]) | (int(row[cap + 2]) << 8)
        f = Frame.from_bytes(row[: PHY_HEADER_BYTES + ln].tobytes())
        assert f is not None
        out.append(f)
    return True, out


class StreamingDecodePipeline:
    def __init__(self, cfg: PhyConfig, local_addr: int,
                 energy_threshold: float = 0.05,
                 max_frames_per_segment: int = 32,
                 use_native: bool = True):
        self.cfg = cfg
        self.local_addr = local_addr
        self.threshold = energy_threshold
        self.max_frames = max_frames_per_segment
        # hang: how much quiet ends a burst; halo: context kept around it
        self.hang = cfg.preamble_len + cfg.inter_frame_gap_samples + 256
        self.halo = cfg.preamble_len + cfg.sync_margin + 8
        self._buf = np.zeros(0, np.float32)
        self._addr_dev = None           # device-resident local_addr
        self._use_native = use_native
        self.segments_decoded = 0
        self.samples_shipped = 0
        self.samples_seen = 0

    def _regions(self, x: np.ndarray) -> np.ndarray:
        if self._use_native:
            try:
                from trackmaker_tpu import runtime
                return runtime.active_regions(
                    x, threshold=self.threshold, hang=self.hang,
                    halo=self.halo)
            except Exception:
                self._use_native = False
        # NumPy fallback: same semantics
        hot = np.abs(x) > self.threshold
        idx = np.nonzero(hot)[0]
        if len(idx) == 0:
            return np.zeros((0, 2), np.int64)
        splits = np.nonzero(np.diff(idx) > self.hang)[0]
        starts = np.concatenate([[idx[0]], idx[splits + 1]])
        ends = np.concatenate([idx[splits], [idx[-1]]]) + 1
        out = np.stack([np.maximum(starts - self.halo, 0),
                        np.minimum(ends + self.halo, len(x))], axis=1)
        merged = [out[0].tolist()]
        for s, e in out[1:]:
            if s <= merged[-1][1]:
                merged[-1][1] = e
            else:
                merged.append([s, e])
        return np.asarray(merged, np.int64)

    def push(self, samples: np.ndarray) -> list[Frame]:
        """Feed a chunk; returns frames from bursts that have *closed*
        (quiet for at least `hang` samples before the buffer tail)."""
        self._buf = np.concatenate(
            [self._buf, np.asarray(samples, np.float32)])
        self.samples_seen += len(samples)
        regions = self._regions(self._buf)
        out: list[Frame] = []
        consumed = 0
        for s, e in regions:
            if e >= len(self._buf) - self.hang:
                break  # burst may still be growing; wait for more input
            out.extend(self._decode_segment(self._buf[s:e]))
            consumed = e
        if consumed:
            self._buf = self._buf[consumed:]
        elif len(regions) == 0 and len(self._buf) > self.hang:
            self._buf = self._buf[-self.hang:]  # drop old silence
        return out

    def flush(self) -> list[Frame]:
        """Decode whatever is buffered (end of stream)."""
        out: list[Frame] = []
        for s, e in self._regions(self._buf):
            out.extend(self._decode_segment(self._buf[s:e]))
        self._buf = np.zeros(0, np.float32)
        return out

    def _decode_segment(self, seg: np.ndarray) -> list[Frame]:
        n = len(seg)
        b = _bucket(n)
        padded = np.zeros(b + 1, np.float32)
        padded[:n] = seg
        padded[b] = n                   # true length rides in the buffer
        # Spec decoder + one-readback packed result where the config
        # allows it (see _packed_decoder); decode_capture_fast otherwise
        # and on the rare spec-path overflow — decisions equal
        # decode_capture up to slot compaction.  Segments are *closed* bursts (quiet
        # tail >= hang), so the segmenter's halo already guarantees no
        # frame straddles the padded tail and cursor semantics aren't
        # needed here.
        self.segments_decoded += 1
        self.samples_shipped += b
        from trackmaker_tpu.phy.spec_decode import spec_supported_cfg
        if spec_supported_cfg(self.cfg):
            if self._addr_dev is None:
                self._addr_dev = jnp.int32(self.local_addr)
            fn = _packed_decoder(self.cfg, self.max_frames)
            arr = np.asarray(fn(padded, self._addr_dev))
            ok, frames = _parse_packed(arr)
            if ok:
                return frames
        res = decode_capture_fast(self.cfg, jnp.asarray(padded[:b]),
                                  self.local_addr,
                                  max_frames=self.max_frames,
                                  valid_len=n)
        return res.to_frames()
