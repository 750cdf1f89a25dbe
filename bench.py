"""Benchmark: batched PHY decode throughput on one GPU, all flagship
workloads.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "workloads": {...}, "stats": {...}}

Headline metric: demodulated-samples/sec on the flagship workload
(batched Manchester correlation-sync frame decode of noisy multi-frame
captures) expressed as a multiple of 48 kHz real time per chip,
payload-verified.  `vs_baseline` is measured against the reference's
effective decode rate (1.0x real time: its decoder is an online loop
fed by a real-time audio callback — it cannot exceed real time in
production use; see BASELINE.md).  The BASELINE.json target gate is
>= 100x.

`workloads` adds the other first-class rows (each payload/decision
gated — a regression in any of them shows up here, not just prose):
  manchester_b32   flagship (also the headline)
  fourb5b_b32      4B5B+NRZI batch decode (speculative decoder)
  blocked_600s     one 600 s capture, blockwise single-device decode
  ask              ASK/chirp modem demod (BASELINE config 1)
  ofdm_v2          the production OFDM receiver (Schmidl-Cox timing,
                   pilot-tone tracking — what the MAC ships)
  coded_manchester Viterbi-coded Manchester (rate-1/2 K=7 soft decode)
  ofdm_adaptive    loading-aware coded OFDM (adaptive PHY's demap +
                   soft Viterbi)
  equalized_b32    MMSE-equalized capture -> speculative decode on a
                   multipath channel

`stats` carries per-row {median, n, spread, frames_per_sec,
samples_per_frame} over n quick repeats (spread = (max-min)/median),
so a single reading is not taken as evidence.  frames_per_sec settles
per-sample vs per-frame comparisons (BASELINE.json names "frames
decoded/sec"): spectrally denser line codes carry
more frames per sample, so per-sample multiples under-rank them.

`window` carries device-health probes measured before the first row
(`pre`) and after the last (`post`): dispatch round trip and an
achieved-stream-bandwidth microprobe — so a slow artifact is
attributable to device state vs code state.  With leftover budget the
flagship + blocked rows re-measure and report the better median
(both passes recorded via first_pass_median / remeasure_median).

`latency_ms` reports the ONLINE operating point:
link/stream.py's StreamingDecodePipeline driven with 25 ms chunks —
chunk-in -> frame-out p50/p99 per decoded frame, where chunk-in is
when the chunk holding the frame's last sample was pushed and the
quantity includes the pipeline's burst-close buffering (in chunk
periods) plus the emitting push's wall time.  The per-dispatch round
trip is disclosed alongside (`rtt_ms`).

`device` names what the rows ran on (JAX platform, device kind and
count); the benchmark refuses to run without a GPU.
"""

import json
import os
import sys
import time

import numpy as np

# Wall-clock budget for all rows.  Rows run headline-first; each row
# adapts its iteration count to the remaining budget, and later rows are
# SKIPPED (recorded as such) only once the floor cost of a row no longer
# fits, so a slow run degrades the artifact instead of truncating it.
_BUDGET_S = float(os.environ.get("TM_BENCH_BUDGET_S", "560"))
_T0 = time.time()


def _remaining():
    return _BUDGET_S - (time.time() - _T0)


def _sync1(r):
    import jax
    import jax.numpy as jnp
    np.asarray(jnp.ravel(jax.tree_util.tree_leaves(r)[0])[0])


def _measure(fn, x, iters, repeats=3):
    """Median-of-`repeats` timing of `fn(x)` averaged over `iters` calls.

    The `iters` iterations run INSIDE one compiled program (a
    `lax.scan` over a sub-epsilon, decision-neutral perturbation of x,
    so XLA can neither hoist the body out of the loop nor CSE
    iterations): one dispatch per repeat, so host dispatch cost is
    divided by `iters`.  Every repeat ends with a readback of the
    result.  Returns the list of per-repeat mean iteration times
    (sorted ascending)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def loop(x):
        def body(c, i):
            # decision-neutral: |i|*1e-30 is far below f32 epsilon of
            # any sample value AND below every energy/threshold eps,
            # but varies per iteration, so the body can't be hoisted
            # or CSE'd; iterations stay DATA-independent of each other
            # (unlike a carry-fed perturbation) so the chip can overlap
            # them just like pipelined dispatches would
            r = fn(x + i.astype(jnp.float32) * 1e-30)
            # sum EVERY leaf: summing just one lets XLA dead-code-
            # eliminate siblings of the result tree
            acc = c
            for leaf in jax.tree_util.tree_leaves(r):
                acc = acc + jnp.sum(leaf.astype(jnp.float32))
            return acc, None
        out, _ = jax.lax.scan(
            body, jnp.float32(0.0), jnp.arange(iters, dtype=jnp.int32))
        return out

    r = loop(x)
    _sync1(r)                       # warm: compile + first upload
    ts = []
    for _ in range(repeats):
        t0 = time.time()
        r = loop(x)
        _sync1(r)
        ts.append((time.time() - t0) / iters)
        if _remaining() < 10 and ts:
            break                   # salvage what we have
    return sorted(ts)


def _row(ts, samples_per_iter, frames_per_iter=None):
    """(median realtime multiple, stats dict) from repeat timings.

    With `frames_per_iter` the stats also carry frames_per_sec and
    samples_per_frame (BASELINE.json's metric names frames/s; the
    per-sample multiple under-ranks spectrally dense line codes)."""
    med = ts[len(ts) // 2]
    xs = [samples_per_iter / dt / 48_000.0 for dt in ts]
    xmed = samples_per_iter / med / 48_000.0
    spread = (max(xs) - min(xs)) / xmed if xmed > 0 else 0.0
    out = {"median": round(xmed, 1), "n": len(ts),
           "spread": round(spread, 3)}
    if frames_per_iter:
        out["frames_per_sec"] = round(frames_per_iter / med, 1)
        out["samples_per_frame"] = round(
            samples_per_iter / frames_per_iter, 1)
    return xmed, out


def _probe_window():
    """Device health snapshot — separates code state from device state
    in the artifact:

      rtt_ms       median no-op jit dispatch + readback round trip
      stream_gbps  achieved elementwise-stream bandwidth on a 64 MB f32
                   buffer (read+write, in-program loop)

    Every field is best-effort (None on failure)."""
    import jax
    import jax.numpy as jnp

    out = {}
    try:
        noop = jax.jit(lambda v: v + 1.0)
        v = jnp.float32(0.0)
        np.asarray(noop(v))
        rtts = []
        for _ in range(5):
            t0 = time.time()
            np.asarray(noop(v))
            rtts.append(time.time() - t0)
        out["rtt_ms"] = round(sorted(rtts)[2] * 1000.0, 3)
    except Exception:  # noqa: BLE001
        out["rtt_ms"] = None
    try:
        n = 1 << 24                       # 64 MB f32
        xs = jnp.ones((n,), jnp.float32)
        ts = _measure(lambda x: x * 1.0000001 + 1e-12, xs, iters=200,
                      repeats=3)
        dt = ts[len(ts) // 2]
        out["stream_gbps"] = round(2 * 4 * n / dt / 1e9, 1)
    except Exception:  # noqa: BLE001
        out["stream_gbps"] = None
    return out


def _iters_for(base):
    """Adapt per-repeat iteration count to the remaining budget: the
    in-program iteration count divides the per-dispatch cost out of
    each sample, so keep it high, budget permitting."""
    rem = _remaining()
    if rem > 180:
        return base
    if rem > 90:
        return max(10, base // 4)
    return max(4, base // 16)


def bench_line_coded(cfg, rng):
    """Batched line-coded decode; returns (realtime_x, stats, err|None)."""
    import jax.numpy as jnp
    from trackmaker_tpu.core.framing import Frame
    from trackmaker_tpu.phy.decoder import decode_capture_fast
    from trackmaker_tpu.phy.encoder import PhyEncoder

    n_frames, batch = 64, 32
    frames = [
        Frame.new_data(i & 0xFF, 1, 2,
                       rng.integers(0, 256, 128, dtype=np.uint8).tobytes())
        for i in range(n_frames)
    ]
    wave = PhyEncoder(cfg).encode_frames(frames, gap_samples=200)
    t = len(wave)
    caps = np.stack([
        wave + rng.normal(0, 0.05, t).astype(np.float32)
        for _ in range(batch)
    ])
    x = jnp.asarray(caps)

    # gate once through the fallback-checking wrapper, then time the
    # underlying jitted computation (the wrapper syncs with the host
    # once per call to read the fallback flags)
    res = decode_capture_fast(cfg, x, 2, max_frames=n_frames + 8)
    counts = np.asarray(res.count)
    if not (counts == n_frames).all():
        return 0.0, None, f"count gate failed: {sorted(set(counts.tolist()))}"
    fb = np.asarray(res.frame_bytes)
    valid = np.asarray(res.valid)
    for b in range(batch):
        ks = np.nonzero(valid[b])[0]
        for k, f in zip(ks, frames):
            if fb[b, k, 7:7 + 128].tobytes() != f.data:
                return 0.0, None, f"payload gate failed at b={b} k={k}"

    from trackmaker_tpu.core.config import MANCHESTER
    from trackmaker_tpu.phy.decoder import _batched_fn
    from trackmaker_tpu.phy.spec_decode import (
        decode_capture_spec_jit, spec_supported_cfg)
    if spec_supported_cfg(cfg):
        fn = (lambda x: decode_capture_spec_jit(
            cfg, x, 2, max_frames=n_frames + 8))
    else:
        fn = (lambda x: _batched_fn(
            cfg, n_frames + 8, cfg.line_coding != MANCHESTER)(
                x, 2, jnp.full(x.shape[:1], x.shape[-1], jnp.int32)))
    ts = _measure(fn, x, iters=_iters_for(200))
    xmed, stats = _row(ts, batch * t, batch * n_frames)
    return xmed, stats, None


def bench_blocked(cfg, rng, seconds=600):
    """Sustained blockwise decode of one long capture (64 blocks at
    600 s: one long recording, ~450k samples per block)."""
    import jax.numpy as jnp
    from trackmaker_tpu.core.framing import Frame
    from trackmaker_tpu.oracle.phy import OracleEncoder
    from trackmaker_tpu.parallel.stream import (
        _decode_blocked_jit, _decode_blocked_spec_jit,
        decode_blocked_single_chip)
    from trackmaker_tpu.phy.spec_decode import spec_supported_cfg

    t = seconds * 48_000
    n_blocks = max(2, (64 * seconds) // 600)       # ~450k samples/block
    n_frames = max(2, (48 * seconds) // 600)       # same frame density
    iters = _iters_for(100)
    enc = OracleEncoder(cfg)
    wave = np.zeros(t, np.float32)
    seqs = []
    step = t // (n_frames + 1)
    for i in range(n_frames):
        w = enc.encode_frame(Frame.new_data(i, 1, 2, bytes([i]) * 64))
        p = (i + 1) * step
        wave[p:p + len(w)] = w
        seqs.append(i)
    wave += rng.normal(0, 0.05, t).astype(np.float32)
    x = jnp.asarray(wave)

    # gate through the dispatching wrapper (spec path + ok-fallback),
    # then time the jitted computation it used
    res = decode_blocked_single_chip(
        cfg, x, 2, n_blocks=n_blocks, max_frames_per_block=8)
    valid = np.asarray(res.valid)
    got = sorted(np.asarray(res.sequence)[valid].tolist())
    if got != seqs:
        return 0.0, None, f"blocked gate failed: {len(got)}/{n_frames} frames"
    if spec_supported_cfg(cfg):
        spec_res, spec_ok = _decode_blocked_spec_jit(
            cfg, x, 2, n_blocks, 8, t, 128)
        if bool(np.asarray(spec_ok)):
            fn = (lambda x: _decode_blocked_spec_jit(
                cfg, x, 2, n_blocks, 8, t, 128))
        else:
            fn = (lambda x: _decode_blocked_jit(cfg, x, 2, n_blocks, 8, t))
    else:
        fn = (lambda x: _decode_blocked_jit(cfg, x, 2, n_blocks, 8, t))
    ts = _measure(fn, x, iters=iters)
    xmed, stats = _row(ts, t, n_frames)
    return xmed, stats, None


def bench_ask(rng):
    """Batched speculative ASK receiver (phy/ask_spec.py) on 8 distinct
    tracks; payload-gated per row, and every row's conformance flag
    must be clean (a fallback would re-decode with the scan path —
    that's the wrapper's job, not the measured kernel's)."""
    import jax.numpy as jnp
    from trackmaker_tpu.phy import ask, ask_spec

    cfg = ask.AskConfig()
    n_frames, batch = 64, 16
    frames = ask.build_frames(b"the quick brown fox", cfg,
                              num_frames=n_frames)
    waves = [ask.build_track(cfg, frames, seed=7 + b)
             for b in range(batch)]
    t = max(len(w) for w in waves)
    caps = np.zeros((batch, t), np.float32)
    for b, w in enumerate(waves):
        caps[b, :len(w)] = w
    x = jnp.asarray(caps)
    fn = (lambda x: ask_spec.demodulate_spec_jit(
        cfg, x, max_frames=n_frames + 8))
    res, okflags = fn(x)
    if not np.asarray(okflags).all():
        return 0.0, None, "ask conformance gate failed"
    ok = np.asarray(res.valid)
    if int(ok.sum()) != batch * n_frames:
        return 0.0, None, \
            f"ask gate failed: {int(ok.sum())}/{batch * n_frames}"
    bits = np.asarray(res.bits)
    for b in range(batch):
        if not np.array_equal(bits[b][ok[b]], frames[:, 8:]):
            return 0.0, None, f"ask payload gate failed at b={b}"
    ts = _measure(fn, x, iters=_iters_for(100))
    xmed, stats = _row(ts, batch * t, batch * n_frames)
    return xmed, stats, None


def bench_ofdm_v2(rng):
    """Batched v2 OFDM receiver throughput (the receiver the MAC
    actually ships: Schmidl-Cox fine timing, smoothed channel
    estimate, pilot-tone CPE/slope tracking — phy/ofdm_v2.py)."""
    import jax
    import jax.numpy as jnp
    from trackmaker_tpu.core.framing import Frame
    from trackmaker_tpu.phy import ofdm
    from trackmaker_tpu.phy.ofdm_v2 import (
        OfdmModemV2, OfdmV2Config, demodulate_at_v2)

    n_frames, batch = 32, 32
    payloads = [rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
                for _ in range(n_frames)]
    frames = [Frame.new_data(i, 1, 2, p) for i, p in enumerate(payloads)]
    cfg = OfdmV2Config()
    modem = OfdmModemV2(cfg)
    wave = modem.encode_frames(frames, gap_samples=400)
    t = len(wave)
    caps = np.stack([
        (wave + rng.normal(0, 0.01, t)).astype(np.float32)
        for _ in range(batch)
    ])

    got = [f.data for f in modem.decode(caps[0], 7 + 64,
                                        max_frames=n_frames)]
    if got != payloads:
        return 0.0, None, f"ofdm_v2 gate failed: {len(got)}/{n_frames}"

    n_bits = (7 + 64) * 8
    fn = jax.jit(jax.vmap(lambda rx: demodulate_at_v2(
        cfg, rx, n_bits, ofdm.find_preambles(cfg, rx, n_frames))))
    x = jnp.asarray(caps)
    bits = np.asarray(fn(x))
    for b in range(batch):
        for k in range(n_frames):
            f = Frame.from_bits(bits[b, k])
            if f is None or f.data != payloads[k]:
                return 0.0, None, \
                    f"ofdm_v2 batch gate failed at b={b} k={k}"
    ts = _measure(fn, x, iters=_iters_for(100))
    xmed, stats = _row(ts, batch * t, batch * n_frames)
    return xmed, stats, None


def bench_coded_manchester(rng):
    """Batched Viterbi-coded Manchester decode (phy/coded.py
    batched_decode_fn: pattern sync + soft demod + rate-1/2 K=7 soft
    Viterbi)."""
    import jax.numpy as jnp
    from trackmaker_tpu.core.config import PhyConfig
    from trackmaker_tpu.core.framing import Frame
    from trackmaker_tpu.phy.coded import CodedManchesterPhy

    n_frames, batch, plen = 32, 8, 64
    phy = CodedManchesterPhy(PhyConfig(), local_addr=2)
    frames = [Frame.new_data(i, 1, 2,
                             rng.integers(0, 256, plen,
                                          dtype=np.uint8).tobytes())
              for i in range(n_frames)]
    wave = phy.encode_frames(frames, gap_samples=300)
    t = len(wave)
    caps = np.stack([
        (wave + rng.normal(0, 0.05, t)).astype(np.float32)
        for _ in range(batch)
    ])
    got = phy.decode_equal_frames(caps, n_frames, plen)
    for b in range(batch):
        if [(f.sequence, f.data) for f in got[b]] != [
                (f.sequence, f.data) for f in frames]:
            return 0.0, None, \
                f"coded gate failed at b={b}: {len(got[b])}/{n_frames}"
    fn = phy.batched_decode_fn(n_frames, plen)
    x = jnp.asarray(caps)
    ts = _measure(fn, x, iters=_iters_for(100))
    xmed, stats = _row(ts, batch * t, batch * n_frames)
    return xmed, stats, None


def bench_ofdm_adaptive(rng):
    """Batched adaptive coded OFDM decode (phy/ofdm_adaptive.py
    batched_decode_fn: chirp sync + loading-aware soft demap + soft
    Viterbi) at the default uniform-QPSK loading."""
    import jax.numpy as jnp
    from trackmaker_tpu.core.framing import Frame
    from trackmaker_tpu.phy.ofdm_adaptive import OfdmAdaptiveStreamPhy

    n_frames, batch, plen = 16, 8, 64
    phy = OfdmAdaptiveStreamPhy(local_addr=2)
    frames = [Frame.new_data(i, 1, 2,
                             rng.integers(0, 256, plen,
                                          dtype=np.uint8).tobytes())
              for i in range(n_frames)]
    wave = phy.encode_frames(frames, gap_samples=300)
    t = len(wave)
    caps = np.stack([
        (wave + rng.normal(0, 0.01, t)).astype(np.float32)
        for _ in range(batch)
    ])
    got = phy.decode_equal_frames(caps, n_frames, plen)
    for b in range(batch):
        if [(f.sequence, f.data) for f in got[b]] != [
                (f.sequence, f.data) for f in frames]:
            return 0.0, None, \
                f"adaptive gate failed at b={b}: {len(got[b])}/{n_frames}"
    fn = phy.batched_decode_fn(n_frames, plen)
    x = jnp.asarray(caps)
    ts = _measure(fn, x, iters=_iters_for(100))
    xmed, stats = _row(ts, batch * t, batch * n_frames)
    return xmed, stats, None


def bench_equalized(cfg, rng):
    """MMSE-equalized decode on a 2-path channel, composed with the
    speculative decoder: equalize_capture (vmapped)
    + decode_capture_spec in ONE program, payload-gated."""
    import jax
    import jax.numpy as jnp
    from trackmaker_tpu.core.framing import Frame
    from trackmaker_tpu.dsp import channel
    from trackmaker_tpu.dsp.equalizer import equalize_capture
    from trackmaker_tpu.phy.encoder import PhyEncoder
    from trackmaker_tpu.phy.spec_decode import (
        decode_capture_spec, spec_supported_cfg)

    n_frames, batch = 64, 32
    frames = [
        Frame.new_data(i & 0xFF, 1, 2,
                       rng.integers(0, 256, 128, dtype=np.uint8).tobytes())
        for i in range(n_frames)
    ]
    wave = PhyEncoder(cfg).encode_frames(frames, gap_samples=200)
    taps = jnp.asarray([1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.45])
    ech = np.asarray(channel.multipath(jnp.asarray(wave), taps))
    t = len(ech)
    caps = np.stack([
        ech + rng.normal(0, 0.02, t).astype(np.float32)
        for _ in range(batch)
    ])
    x = jnp.asarray(caps)

    if spec_supported_cfg(cfg):
        def fn(xb):
            eq = jax.vmap(lambda r: equalize_capture(cfg, r)[0])(xb)
            return decode_capture_spec(cfg, eq, 2,
                                       max_frames=n_frames + 8)[0]
        fn = jax.jit(fn)
    else:
        from trackmaker_tpu.phy.decoder import decode_capture
        def fn(xb):
            eq = jax.vmap(lambda r: equalize_capture(cfg, r)[0])(xb)
            return jax.vmap(lambda r: decode_capture(
                cfg, r, 2, max_frames=n_frames + 8))(eq)
        fn = jax.jit(fn)
    res = fn(x)
    valid = np.asarray(res.valid)
    fb = np.asarray(res.frame_bytes)
    for b in range(batch):
        ks = np.nonzero(valid[b])[0]
        if len(ks) != n_frames:
            return 0.0, None, \
                f"equalized gate failed at b={b}: {len(ks)}/{n_frames}"
        for k, f in zip(ks, frames):
            if fb[b, k, 7:7 + 128].tobytes() != f.data:
                return 0.0, None, f"equalized payload gate b={b} k={k}"
    ts = _measure(fn, x, iters=_iters_for(100))
    xmed, stats = _row(ts, batch * t, batch * n_frames)
    return xmed, stats, None


def bench_latency(cfg, rng):
    """Streaming chunk-in -> frame-out latency.

    Drives link/stream.py's StreamingDecodePipeline with 25 ms chunks;
    for each decoded frame, latency = (emit_chunk - arrival_chunk) *
    25 ms + the emitting push's wall time, where arrival_chunk is the
    chunk carrying the frame's last sample (so the pipeline's
    burst-close buffering counts, as it would against a live ring).
    Returns a dict, not a throughput row.  The per-dispatch round trip
    is measured separately and disclosed."""
    import jax
    import jax.numpy as jnp
    from trackmaker_tpu.core.framing import Frame
    from trackmaker_tpu.link.stream import StreamingDecodePipeline
    from trackmaker_tpu.phy.encoder import PhyEncoder

    chunk = 1200                            # 25 ms at 48 kHz
    n_frames = 12
    enc = PhyEncoder(cfg)
    total = 48_000 * 6
    wave = np.zeros(total, np.float32)
    arrival = {}                            # seq -> arrival chunk idx
    step = total // (n_frames + 1)
    for i in range(n_frames):
        w = np.asarray(enc.encode_frame(
            Frame.new_data(i, 1, 2, bytes([i]) * 64)))
        p = (i + 1) * step
        wave[p:p + len(w)] = w
        arrival[i] = (p + len(w)) // chunk
    # noise floor must sit BELOW the pipeline's energy gate (0.05) or
    # the channel is never quiet, bursts never close, and every frame
    # waits for flush() (sigma=0.03 put 9.5% of noise samples over
    # the gate and the row measured nothing).  sigma=0.01 is the
    # operating point the energy-gated segmenter is FOR: a mostly-idle
    # CSMA channel with bounded background noise.
    wave += rng.normal(0, 0.01, total).astype(np.float32)

    # dispatch round-trip probe: a no-op jit + readback (median of 5)
    noop = jax.jit(lambda v: v + 1.0)
    v = jnp.float32(0.0)
    np.asarray(noop(v))
    rtts = []
    for _ in range(5):
        t0 = time.time()
        np.asarray(noop(v))
        rtts.append(time.time() - t0)
    rtt_ms = sorted(rtts)[2] * 1000.0

    pipe = StreamingDecodePipeline(cfg, 2)
    # warm pass compiles the bucket programs, then reset for the run
    for i in range(0, total, chunk):
        pipe.push(wave[i:i + chunk])
    pipe.flush()
    pipe = StreamingDecodePipeline(cfg, 2)
    # steady-state: stage the device-resident addr + first-dispatch
    # paths so frame 0 doesn't carry one-time setup costs into p99
    pipe._decode_segment(wave[:8192])
    lat = []
    got = 0
    for ci, i in enumerate(range(0, total, chunk)):
        t0 = time.time()
        frames = pipe.push(wave[i:i + chunk])
        dt_ms = (time.time() - t0) * 1000.0
        for f in frames:
            got += 1
            lat.append((ci - arrival[f.sequence]) * 25.0 + dt_ms)
    got += len(pipe.flush())
    if got != n_frames:
        return None, f"latency gate failed: {got}/{n_frames} frames"
    if not lat:
        return None, "latency gate failed: no frame emitted before flush"
    lat.sort()
    return {
        "p50": round(lat[len(lat) // 2], 1),
        "p99": round(lat[min(len(lat) - 1, int(len(lat) * 0.99))], 1),
        "n_frames": len(lat),
        "chunk_ms": 25.0,
        "rtt_ms": round(rtt_ms, 1),
        "reference_ms": "70-150 (report.md:529)",
    }, None


def main():
    import signal
    import threading

    rng = np.random.default_rng(0)
    workloads = {}
    stats = {}
    errors = {}
    skipped = []
    latency = {}
    window = {}
    state = {"device": None, "current": "backend-init"}
    done = threading.Event()

    def emit(extra_err=None):
        out = {
            "metric": "demod_throughput_realtime_multiple_per_chip",
            "value": workloads.get("manchester_b32", 0.0),
            "unit": "x_realtime_48kHz",
            "vs_baseline": workloads.get("manchester_b32", 0.0),
            "device": state["device"],
            "workloads": workloads,
            "stats": stats,
        }
        if latency:
            out["latency_ms"] = latency
        if window:
            out["window"] = window
        if skipped:
            out["skipped_budget"] = skipped
        errs = dict(errors)
        if extra_err:
            errs["_watchdog"] = extra_err
        if errs:
            out["errors"] = errs
        print(json.dumps(out))
        sys.stdout.flush()
        os._exit(1 if (errs or out["value"] <= 0) else 0)

    def run_rows():
        import jax

        from trackmaker_tpu.core.config import FOUR_B_FIVE_B, PhyConfig
        from trackmaker_tpu.utils.compile_cache import enable_compile_cache

        enable_compile_cache()
        dev = jax.devices()[0]
        state["device"] = {"platform": dev.platform,
                           "kind": dev.device_kind,
                           "count": len(jax.devices())}
        if dev.platform != "gpu":
            errors["_device"] = f"no GPU: JAX found {dev.platform!r}"
            done.set()
            return
        state["current"] = "window_pre"
        window["pre"] = _probe_window()
        rows = [
            ("manchester_b32", lambda: bench_line_coded(PhyConfig(), rng)),
            ("fourb5b_b32", lambda: bench_line_coded(
                PhyConfig(line_coding=FOUR_B_FIVE_B), rng)),
            ("blocked_600s", lambda: bench_blocked(PhyConfig(), rng)),
            ("ask", lambda: bench_ask(rng)),
            ("ofdm_v2", lambda: bench_ofdm_v2(rng)),
            ("coded_manchester", lambda: bench_coded_manchester(rng)),
            ("ofdm_adaptive", lambda: bench_ofdm_adaptive(rng)),
            ("equalized_b32", lambda: bench_equalized(PhyConfig(), rng)),
        ]
        # rough warm-cache per-row floor (gate + 2-iter minimum timing);
        # with a cold .jax_cache add compile time, which _iters_for
        # absorbs by shrinking the timing loops
        reserve = {"manchester_b32": 0, "fourb5b_b32": 35,
                   "blocked_600s": 45, "ask": 30, "ofdm_v2": 30,
                   "coded_manchester": 30, "ofdm_adaptive": 30,
                   "equalized_b32": 30}
        for name, fn in rows:
            if name != "manchester_b32" and _remaining() < reserve[name]:
                skipped.append(name)
                continue
            state["current"] = name
            try:
                x, st, err = fn()
            except Exception as e:  # noqa: BLE001 - report, don't die
                x, st, err = 0.0, None, repr(e)[:120]
            workloads[name] = round(x, 1)
            if st:
                stats[name] = st
            if err:
                errors[name] = err
        # latency is an operating point, not a throughput row: measure
        # it last (cheap: one stream drive + a few dispatches) but
        # never skip it silently — a missing entry reads as a gap
        state["current"] = "latency_stream"
        if _remaining() > 25:
            try:
                lat, err = bench_latency(PhyConfig(), rng)
                if lat:
                    latency.update(lat)
                if err:
                    errors["latency_stream"] = err
            except Exception as e:  # noqa: BLE001
                errors["latency_stream"] = repr(e)[:120]
        else:
            skipped.append("latency_stream")
        state["current"] = "window_post"
        if _remaining() > 15:
            window["post"] = _probe_window()
        # Opportunistic re-measure of the headline rows with leftover
        # budget.  Both passes stay in the artifact —
        # `first_pass_median` / `remeasure_median` plus the pre/post
        # `window` probes attribute any delta to device state or code
        # state.
        byname = dict(rows)
        for name in ("manchester_b32", "blocked_600s"):
            if _remaining() < 60 or name in skipped or name in errors:
                continue
            state["current"] = f"remeasure:{name}"
            try:
                x2, st2, err2 = byname[name]()
            except Exception:  # noqa: BLE001 - keep the first pass
                continue
            if err2 or not st2:
                continue
            first = stats.get(name)
            if x2 > workloads.get(name, 0.0):
                st2["first_pass_median"] = (
                    first["median"] if first else None)
                workloads[name] = round(x2, 1)
                stats[name] = st2
            elif first is not None:
                first["remeasure_median"] = st2["median"]
        state["current"] = None
        done.set()

    # The device-touching rows run in a daemon WORKER thread so the main
    # thread can watch the wall-clock budget (no between-row check fires
    # inside a blocked device call) and ALWAYS print the one JSON line.
    signal.signal(signal.SIGTERM, lambda *_: emit("SIGTERM mid-row"))
    worker = threading.Thread(target=run_rows, daemon=True)
    worker.start()
    while not done.is_set() and _remaining() > 3:
        done.wait(1.0)
    if done.is_set():
        emit()
    emit(f"budget exhausted inside row {state['current']!r}")


if __name__ == "__main__":
    main()
