#!/usr/bin/env python
"""Smoke test of the decode path on NVIDIA GPUs, at the sizes users run.

    python chip_smoke.py             # one GPU: every receiver + the CLI
    python chip_smoke.py --cards 4   # four GPUs: the sharded paths only

One GPU: runs the chip-marked oracle tests (tests/test_chip.py) in a
child process first, then, in this process, one phase per receiver
through its public entry point — the flagship batched Manchester and
4B5B decodes (32 noisy captures x 64 frames of 128 B), one 600 s
capture through the blocked decoder, `encode` + batched `decode` of
three WAVs through the CLI, and one batch of the ASK, OFDM v2,
Viterbi-coded Manchester, adaptive OFDM and equalized receivers.  Each
phase checks its payloads or decisions (against the NumPy oracles of
the reference where the oracle is fast enough) and prints one line:
name, ok, compile seconds, warm seconds and the device's
peak_bytes_in_use.  The speculative and exact line-code paths are both
timed, and the correlator is checked against a float64 reference.

Four GPUs (``--cards 4``): the 600 s capture over a 4-card `sp` mesh
(halo ppermute between cards) and the flagship batch over `dp=4`, each
compared decision-for-decision with the one-card decode.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
the line before it names the card and its power limit.  Exits non-zero,
printing no result, without a GPU or when any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# max |f32 correlation - float64 reference|: a few ulps of the O(L)
# window sums at Precision.HIGHEST (TF32 would be ~1e-3)
XCORR_TOL = 2e-5


# ---------------------------------------------------------------------------
# helpers

def _nvidia_smi() -> str:
    """`name, power.limit` of every card, one line each."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _twice(fn):
    """(result, first-call seconds, second-call seconds); the first call
    includes tracing and compilation."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    t1 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, t1 - t0, time.perf_counter() - t1


def _frames(rng, n, payload):
    from trackmaker_tpu.core.framing import Frame
    return [Frame.new_data(i & 0xFF, 1, 2,
                           rng.integers(0, 256, payload,
                                        dtype=np.uint8).tobytes())
            for i in range(n)]


def _decisions(res, row=None):
    """Valid-slot content in start order — compaction-insensitive."""
    sel = (lambda a: np.asarray(a)) if row is None \
        else (lambda a: np.asarray(a)[row])
    return sorted(
        (int(st), int(sq), int(sr), int(ds), bytes(fb[:7 + int(ln)]))
        for v, st, sq, sr, ds, ln, fb in zip(
            sel(res.valid), sel(res.start), sel(res.sequence),
            sel(res.src), sel(res.dst), sel(res.length),
            sel(res.frame_bytes)) if v)


def _as_frames(frames):
    return [(f.sequence, f.src, f.dst, f.data) for f in frames]


def _line_coded_batch(cfg, rng, batch, n_frames, payload, sigma=0.05):
    from trackmaker_tpu.phy.encoder import PhyEncoder
    frames = _frames(rng, n_frames, payload)
    wave = PhyEncoder(cfg).encode_frames(frames, gap_samples=200)
    t = len(wave)
    caps = np.stack([wave + rng.normal(0, sigma, t).astype(np.float32)
                     for _ in range(batch)])
    return frames, caps


def _long_capture(cfg, rng, seconds, n_frames):
    from trackmaker_tpu.core.framing import Frame
    from trackmaker_tpu.oracle.phy import OracleEncoder
    t = int(seconds * cfg.sample_rate)
    enc = OracleEncoder(cfg)
    wave = rng.normal(0, 0.05, t).astype(np.float32)
    frames = []
    step = t // (n_frames + 1)
    for i in range(n_frames):
        f = Frame.new_data(i & 0xFF, 1, 2, bytes([i & 0xFF]) * 64)
        w = enc.encode_frame(f)
        p = (i + 1) * step
        wave[p:p + len(w)] += w
        frames.append(f)
    return frames, wave


# ---------------------------------------------------------------------------
# phases (each returns a dict with at least ok / compile_s / warm_s)

def phase_xcorr(t=433_464):
    """The correlator at flagship capture length vs float64 NumPy."""
    import jax.numpy as jnp
    from trackmaker_tpu.core.config import PhyConfig
    from trackmaker_tpu.phy.line_coding import preamble_waveform
    from trackmaker_tpu.sync.correlate import normalized_xcorr

    pre = preamble_waveform(PhyConfig())
    rng = np.random.default_rng(1)
    x = rng.normal(0, 0.5, t).astype(np.float32)
    x[t // 3: t // 3 + len(pre)] += pre
    xj = jnp.asarray(x)
    got, c_s, w_s = _twice(lambda: normalized_xcorr(xj, jnp.asarray(pre)))
    got = np.asarray(got, np.float64)
    w = np.lib.stride_tricks.sliding_window_view(x.astype(np.float64),
                                                 len(pre))
    p = pre.astype(np.float64)
    energy = np.sum(w * w, axis=-1)
    want = np.where(energy < 1e-6, 0.0,
                    (w @ p) / np.maximum(np.sqrt(energy)
                                         * np.sqrt(p @ p), 1e-30))
    err = float(np.max(np.abs(got - want)))
    return dict(ok=bool(err <= XCORR_TOL), compile_s=c_s, warm_s=w_s,
                max_abs_err=err, tol=XCORR_TOL)


def phase_line_coded(cfg, batch=32, n_frames=64, payload=128,
                     n_oracle=4, seed=0):
    """decode_capture_fast on a noisy batch: every row's payloads, a
    subset's decisions against the oracle, and the speculative vs exact
    scan paths (timed, decisions equal)."""
    import jax.numpy as jnp
    from trackmaker_tpu.oracle.phy import OracleDecoder
    from trackmaker_tpu.phy.decoder import _batched_fn, decode_capture_fast
    from trackmaker_tpu.phy.spec_decode import decode_capture_spec_jit

    rng = np.random.default_rng(seed)
    frames, caps = _line_coded_batch(cfg, rng, batch, n_frames, payload)
    x = jnp.asarray(caps)
    mf = n_frames + 8
    res, c_s, w_s = _twice(lambda: decode_capture_fast(cfg, x, 2,
                                                       max_frames=mf))
    want = _as_frames(frames)
    payload_ok = all(_as_frames(res.to_frames(b)) == want
                     for b in range(batch))
    oracle_ok = all(
        _as_frames(OracleDecoder(cfg, 2).process_samples(caps[b]))
        == _as_frames(res.to_frames(b)) for b in range(min(n_oracle, batch)))

    vlen = jnp.full((batch,), caps.shape[1], jnp.int32)
    (spec, spec_ok), _, spec_s = _twice(
        lambda: decode_capture_spec_jit(cfg, x, 2, max_frames=mf))
    exact, _, exact_s = _twice(
        lambda: _batched_fn(cfg, mf, False)(x, 2, vlen))
    paths_equal = all(_decisions(spec, b) == _decisions(exact, b)
                      for b in range(batch))
    ok = payload_ok and oracle_ok and paths_equal and bool(
        np.asarray(spec_ok).all())
    return dict(ok=ok, compile_s=c_s, warm_s=w_s, payloads=payload_ok,
                oracle=oracle_ok, spec_eq_exact=paths_equal,
                spec_s=spec_s, exact_s=exact_s,
                samples=int(caps.size))


def phase_blocked(seconds=600, n_blocks=64, n_frames=48):
    """One long capture through decode_blocked_single_chip."""
    import jax.numpy as jnp
    from trackmaker_tpu.core.config import PhyConfig
    from trackmaker_tpu.parallel.stream import (
        _decode_blocked_spec_jit, decode_blocked_single_chip)

    cfg = PhyConfig()
    frames, wave = _long_capture(cfg, np.random.default_rng(2), seconds,
                                 n_frames)
    x = jnp.asarray(wave)
    res, c_s, w_s = _twice(lambda: decode_blocked_single_chip(
        cfg, x, 2, n_blocks=n_blocks, max_frames_per_block=8))
    got = sorted(_as_frames(res.to_frames()))
    _, spec_ok = _decode_blocked_spec_jit(cfg, x, 2, n_blocks, 8,
                                          x.shape[-1], 128)
    spec_ok = bool(np.asarray(spec_ok))
    return dict(ok=got == sorted(_as_frames(frames)) and spec_ok,
                compile_s=c_s, warm_s=w_s, frames=len(got), spec_ok=spec_ok,
                samples=int(x.shape[-1]))


def phase_cli(workdir, sizes=(2000, 5000, 700)):
    """`cli encode` of three files, then one batched `cli decode` of the
    three WAVs; the payloads written must equal the inputs, in order."""
    from trackmaker_tpu.cli.main import main as cli

    def run(argv):
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                cli(argv)
        except SystemExit as e:
            return e.code
        return 0

    rng = np.random.default_rng(3)
    datas, wavs = [], []
    for i, n in enumerate(sizes):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        src = os.path.join(workdir, f"in{i}.bin")
        with open(src, "wb") as f:
            f.write(data)
        wav = os.path.join(workdir, f"cap{i}.wav")
        if run(["encode", "--input", src, "--wav", wav]) != 0:
            return dict(ok=False, compile_s=0.0, warm_s=0.0)
        datas.append(data)
        wavs.append(wav)
    out = os.path.join(workdir, "out.bin")
    rcs = []

    def decode():
        rcs.append(run(["decode", *wavs, "--output", out]))

    _, c_s, w_s = _twice(decode)
    with open(out, "rb") as f:
        got = f.read()
    return dict(ok=rcs == [0, 0] and got == b"".join(datas),
                compile_s=c_s, warm_s=w_s, bytes=len(got))


def phase_ask(batch=16, n_frames=64, oracle_frames=5):
    """ask.demodulate_fast on a batch of tracks + the oracle on one."""
    import jax.numpy as jnp
    from trackmaker_tpu.oracle import ask as oracle_ask
    from trackmaker_tpu.phy import ask

    cfg = ask.AskConfig()
    frames = ask.build_frames(b"the quick brown fox", cfg,
                              num_frames=n_frames)
    waves = [ask.build_track(cfg, frames, seed=7 + b) for b in range(batch)]
    t = max(len(w) for w in waves)
    caps = np.zeros((batch, t), np.float32)
    for b, w in enumerate(waves):
        caps[b, :len(w)] = w
    x = jnp.asarray(caps)
    res, c_s, w_s = _twice(
        lambda: ask.demodulate_fast(cfg, x, max_frames=n_frames + 8))
    valid = np.asarray(res.valid)
    bits = np.asarray(res.bits)
    payload_ok = all(np.array_equal(bits[b][valid[b]], frames[:, 8:])
                     for b in range(batch))

    few = ask.build_frames(b"oracle check", cfg, num_frames=oracle_frames)
    gaps = np.random.default_rng(8).integers(0, 100, (oracle_frames, 2))
    track = ask.build_track(cfg, few, gaps=gaps)
    want = oracle_ask.demodulate(track)
    one = ask.demodulate_fast(cfg, track, max_frames=oracle_frames + 3)
    v = np.asarray(one.valid)
    got = list(zip(np.asarray(one.frame_id)[v].tolist(),
                   np.asarray(one.bits)[v]))
    oracle_ok = len(got) == len(want) == oracle_frames and all(
        gi == wi and np.array_equal(gb, wb)
        for (gi, gb), (wi, wb) in zip(got, want))
    return dict(ok=payload_ok and oracle_ok, compile_s=c_s, warm_s=w_s,
                payloads=payload_ok, oracle=oracle_ok)


def phase_ofdm_v2(batch=32, n_frames=32, payload=64):
    """The OFDM v2 receiver: modem.decode on one capture, then the
    batched preamble search + demod over the batch."""
    import jax
    import jax.numpy as jnp
    from trackmaker_tpu.core.framing import Frame
    from trackmaker_tpu.phy import ofdm
    from trackmaker_tpu.phy.ofdm_v2 import (
        OfdmModemV2, OfdmV2Config, demodulate_at_v2)

    rng = np.random.default_rng(4)
    frames = _frames(rng, n_frames, payload)
    cfg = OfdmV2Config()
    modem = OfdmModemV2(cfg)
    wave = modem.encode_frames(frames, gap_samples=400)
    caps = np.stack([(wave + rng.normal(0, 0.01, len(wave)))
                     .astype(np.float32) for _ in range(batch)])
    one = [f.data for f in modem.decode(caps[0], 7 + payload,
                                        max_frames=n_frames)]
    n_bits = (7 + payload) * 8
    fn = jax.jit(jax.vmap(lambda rx: demodulate_at_v2(
        cfg, rx, n_bits, ofdm.find_preambles(cfg, rx, n_frames))))
    x = jnp.asarray(caps)
    bits, c_s, w_s = _twice(lambda: fn(x))
    bits = np.asarray(bits)
    want = [f.data for f in frames]
    got = [[(Frame.from_bits(bits[b, k]) or Frame.new_data(0, 0, 0, b""))
            .data for k in range(n_frames)] for b in range(batch)]
    return dict(ok=one == want and all(g == want for g in got),
                compile_s=c_s, warm_s=w_s)


def phase_coded(batch=8, n_frames=32, payload=64):
    """Viterbi-coded Manchester: the batched decode program."""
    import jax.numpy as jnp
    from trackmaker_tpu.core.config import PhyConfig
    from trackmaker_tpu.phy.coded import CodedManchesterPhy

    rng = np.random.default_rng(5)
    phy = CodedManchesterPhy(PhyConfig(), local_addr=2)
    frames = _frames(rng, n_frames, payload)
    wave = phy.encode_frames(frames, gap_samples=300)
    caps = np.stack([(wave + rng.normal(0, 0.05, len(wave)))
                     .astype(np.float32) for _ in range(batch)])
    fn = phy.batched_decode_fn(n_frames, payload)
    x = jnp.asarray(caps)
    _, c_s, w_s = _twice(lambda: fn(x))
    got = phy.decode_equal_frames(caps, n_frames, payload)
    want = _as_frames(frames)
    return dict(ok=all(_as_frames(g) == want for g in got),
                compile_s=c_s, warm_s=w_s)


def phase_ofdm_adaptive(batch=8, n_frames=16, payload=64):
    """Adaptive coded OFDM: the batched decode program."""
    import jax.numpy as jnp
    from trackmaker_tpu.phy.ofdm_adaptive import OfdmAdaptiveStreamPhy

    rng = np.random.default_rng(6)
    phy = OfdmAdaptiveStreamPhy(local_addr=2)
    frames = _frames(rng, n_frames, payload)
    wave = phy.encode_frames(frames, gap_samples=300)
    caps = np.stack([(wave + rng.normal(0, 0.01, len(wave)))
                     .astype(np.float32) for _ in range(batch)])
    fn = phy.batched_decode_fn(n_frames, payload)
    x = jnp.asarray(caps)
    _, c_s, w_s = _twice(lambda: fn(x))
    got = phy.decode_equal_frames(caps, n_frames, payload)
    want = _as_frames(frames)
    return dict(ok=all(_as_frames(g) == want for g in got),
                compile_s=c_s, warm_s=w_s)


def phase_equalized(batch=32, n_frames=64, payload=128):
    """MMSE equalizer + speculative decode on a 2-path channel, as one
    program."""
    import jax
    import jax.numpy as jnp
    from trackmaker_tpu.core.config import PhyConfig
    from trackmaker_tpu.dsp import channel
    from trackmaker_tpu.dsp.equalizer import equalize_capture
    from trackmaker_tpu.phy.encoder import PhyEncoder
    from trackmaker_tpu.phy.spec_decode import decode_capture_spec

    cfg = PhyConfig()
    rng = np.random.default_rng(7)
    frames = _frames(rng, n_frames, payload)
    wave = PhyEncoder(cfg).encode_frames(frames, gap_samples=200)
    taps = jnp.asarray([1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.45])
    ech = np.asarray(channel.multipath(jnp.asarray(wave), taps))
    caps = np.stack([ech + rng.normal(0, 0.02, len(ech)).astype(np.float32)
                     for _ in range(batch)])

    @jax.jit
    def fn(xb):
        eq = jax.vmap(lambda r: equalize_capture(cfg, r)[0])(xb)
        return decode_capture_spec(cfg, eq, 2, max_frames=n_frames + 8)

    x = jnp.asarray(caps)
    (res, ok), c_s, w_s = _twice(lambda: fn(x))
    want = _as_frames(frames)
    return dict(ok=bool(np.asarray(ok).all()) and all(
        _as_frames(res.to_frames(b)) == want for b in range(batch)),
        compile_s=c_s, warm_s=w_s)


def phase_sharded_blocked(n_cards=4, seconds=600, n_blocks=64,
                          n_frames=48):
    """The long capture over an n-card `sp` mesh vs the one-card
    blocked decode: identical decisions."""
    import jax
    import jax.numpy as jnp
    from trackmaker_tpu.core.config import PhyConfig
    from trackmaker_tpu.parallel import decode_blocked_sharded, make_mesh
    from trackmaker_tpu.parallel.stream import decode_blocked_single_chip

    cfg = PhyConfig()
    frames, wave = _long_capture(cfg, np.random.default_rng(2), seconds,
                                 n_frames)
    mesh = make_mesh(n_cards, dp=1, sp=n_cards)
    per_shard = -(-n_frames // n_cards) + 4
    res, c_s, w_s = _twice(lambda: decode_blocked_sharded(
        cfg, wave, 2, mesh, max_frames_per_block=per_shard))
    one = decode_blocked_single_chip(
        cfg, jax.device_put(jnp.asarray(wave), jax.devices()[0]), 2,
        n_blocks=n_blocks, max_frames_per_block=8)
    same = _decisions(res) == _decisions(one)
    expect = sorted(_as_frames(one.to_frames())) == sorted(
        _as_frames(frames))
    return dict(ok=same and expect, compile_s=c_s, warm_s=w_s,
                frames=len(one.to_frames()))


def phase_dp_batch(n_cards=4, batch=32, n_frames=64, payload=128):
    """The flagship batch over dp=n_cards vs the one-card decode."""
    import jax
    import jax.numpy as jnp
    from trackmaker_tpu.core.config import PhyConfig
    from trackmaker_tpu.parallel import batch_sharded_decode, make_mesh
    from trackmaker_tpu.phy.decoder import decode_capture_fast

    cfg = PhyConfig()
    frames, caps = _line_coded_batch(cfg, np.random.default_rng(0), batch,
                                     n_frames, payload)
    mesh = make_mesh(n_cards, dp=n_cards, sp=1)
    mf = n_frames + 8
    res, c_s, w_s = _twice(lambda: batch_sharded_decode(
        cfg, caps, 2, mesh, max_frames=mf))
    one = decode_capture_fast(
        cfg, jax.device_put(jnp.asarray(caps), jax.devices()[0]), 2,
        max_frames=mf)
    same = all(_decisions(res, b) == _decisions(one, b)
               for b in range(batch))
    want = _as_frames(frames)
    expect = all(_as_frames(one.to_frames(b)) == want for b in range(batch))
    return dict(ok=same and expect, compile_s=c_s, warm_s=w_s)


# ---------------------------------------------------------------------------
# runner

def _chip_tests() -> dict:
    """The chip-marked tests, in a child that exits before this process
    touches the card (one JAX process per card)."""
    import xml.etree.ElementTree as ET

    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cuda")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        xml = os.path.join(d, "chip.xml")
        r = subprocess.run(
            [sys.executable, "-m", "pytest", "tests/test_chip.py", "-m",
             "chip", "-p", "no:cacheprovider", f"--junitxml={xml}"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
        try:
            suite = ET.parse(xml).getroot()
            suite = suite if suite.tag == "testsuite" else suite[0]
            n = {k: int(suite.get(k, 0))
                 for k in ("tests", "failures", "errors", "skipped")}
        except (OSError, ET.ParseError, IndexError):
            n = dict(tests=0, failures=0, errors=0, skipped=0)
    passed = n["tests"] - n["failures"] - n["errors"] - n["skipped"]
    ok = r.returncode == 0 and passed > 0 and passed == n["tests"]
    if not ok:
        print(r.stdout[-4000:] + r.stderr[-4000:], file=sys.stderr)
    return dict(ok=ok, compile_s=0.0, warm_s=time.perf_counter() - t0,
                passed=passed, tests=n["tests"])


def _peak_bytes() -> int:
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def _report(name, out):
    extras = " ".join(
        f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in out.items()
        if k not in ("ok", "compile_s", "warm_s"))
    print(f"phase={name} ok={out['ok']} compile_s={out['compile_s']:.3f} "
          f"warm_s={out['warm_s']:.6f} peak_bytes_in_use={_peak_bytes()} "
          f"{extras}".rstrip(), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)

    try:
        smi = _nvidia_smi()
    except (OSError, subprocess.SubprocessError) as e:
        print(f"no GPU: nvidia-smi failed ({e})", file=sys.stderr)
        return 2
    results = {}
    if args.cards == 1:
        results["chip_tests"] = _chip_tests()

    import jax
    from trackmaker_tpu.utils.compile_cache import enable_compile_cache

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < args.cards:
        print(f"no GPU: JAX found {len(devs)} {devs[0].platform} "
              f"device(s), need {args.cards} gpu", file=sys.stderr)
        return 2
    enable_compile_cache()
    print(f"device platform={devs[0].platform} "
          f"kind={devs[0].device_kind.replace(' ', '_')} count={len(devs)}",
          flush=True)
    if "chip_tests" in results:
        _report("chip_tests", results["chip_tests"])

    try:
        from trackmaker_tpu import runtime
        runtime.ensure_built()
        built = "built"
    except Exception as e:  # noqa: BLE001 - reported, has NumPy fallbacks
        built = f"unavailable:{type(e).__name__}"
    print(f"native_runtime={built}", flush=True)

    from trackmaker_tpu.core.config import FOUR_B_FIVE_B, PhyConfig
    if args.cards == 1:
        phases = [
            ("xcorr", phase_xcorr),
            ("manchester_b32", lambda: phase_line_coded(PhyConfig())),
            ("fourb5b_b32", lambda: phase_line_coded(
                PhyConfig(line_coding=FOUR_B_FIVE_B))),
            ("blocked_600s", phase_blocked),
            ("ask", phase_ask),
            ("ofdm_v2", phase_ofdm_v2),
            ("coded_manchester", phase_coded),
            ("ofdm_adaptive", phase_ofdm_adaptive),
            ("equalized_b32", phase_equalized),
        ]
    else:
        phases = [
            ("sharded_blocked_600s", lambda: phase_sharded_blocked(
                args.cards)),
            ("dp_batch_b32", lambda: phase_dp_batch(args.cards)),
        ]
    for name, fn in phases:
        results[name] = fn()
        _report(name, results[name])
    if args.cards == 1:
        with tempfile.TemporaryDirectory() as d:
            results["cli"] = phase_cli(d)
        _report("cli", results["cli"])

    failed = [k for k, v in results.items() if not v["ok"]]
    if failed:
        print(f"FAILED phases: {failed}", file=sys.stderr)
        return 1
    print(smi.replace("\n", " | "), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
