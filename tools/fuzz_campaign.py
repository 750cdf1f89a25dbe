#!/usr/bin/env python
"""Extended differential fuzz campaign: batched device decoder vs the NumPy
oracle of the reference decoder, across random configs and corruptions.

CI runs 12 seeds (tests/test_fuzz_differential.py); this tool runs an
arbitrary number for deeper soak testing:

    python tools/fuzz_campaign.py --seeds 100 [--coding manchester|4b5b]
                                   [--path exact|fast]

``--path fast`` exercises `decode_capture_fast` (the speculative
decoder with its exact fallback merge) instead of the exact scan.

``--path dd`` soaks the decision-directed equalized decode
(dsp/equalizer.py:decode_capture_dd) over random 2-3-tap multipath
channels: the invariants are (a) no hallucinated frames — every
decoded frame maps to a transmitted frame by (seq, length), with
either an exact payload or a small byte-error count (an 8-bit CRC
collides at 1/256 on the heavily-corrupted frames this path digs out
of the noise — measured: seed 50005 recovers a frame with 6/52 wrong
bytes that passes CRC; the REFERENCE's CRC8 would pass it too, its
decoder just never recovers that frame at all; such collisions are
counted and printed, not failed) — and (b) at least as many frames as
the stock decoder (structural, but the soak would catch a refit that
corrupts the bootstrap result).  Exact oracle equality is NOT the bar
here: dd is a beyond-parity recovery path that usually decodes MORE
than the reference behavior on echoic captures.

"""

import argparse
import sys
import pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
_cache = pathlib.Path(__file__).resolve().parents[1] / ".jax_cache"
jax.config.update("jax_compilation_cache_dir", str(_cache))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from trackmaker_tpu.core.config import PhyConfig  # noqa: E402
from trackmaker_tpu.core.framing import Frame  # noqa: E402
from trackmaker_tpu.oracle.phy import OracleDecoder, OracleEncoder  # noqa: E402
from trackmaker_tpu.phy.decoder import decode_capture  # noqa: E402


def one_trial(coding: str, seed: int, path: str = "exact") -> bool:
    rng = np.random.default_rng(seed)
    cfg = PhyConfig(line_coding=coding,
                    samples_per_level=int(rng.choice([2, 3, 4])))
    n = int(rng.integers(2, 12))
    frames = []
    for i in range(n):
        size = int(rng.integers(1, 129))
        dst = int(rng.choice([2, 2, 2, 3, 9]))
        frames.append(Frame.new_data(
            i, 1, dst,
            rng.integers(0, 256, size, dtype=np.uint8).tobytes()))
    enc = OracleEncoder(cfg)
    parts = [np.zeros(int(rng.integers(0, 1200)), np.float32)]
    for f in frames:
        parts.append(enc.encode_frame(f) * float(rng.uniform(0.3, 1.0)))
        parts.append(np.zeros(int(rng.integers(0, 900)), np.float32))
    wave = np.concatenate(parts)
    wave = wave + rng.normal(0, rng.uniform(0.005, 0.15),
                             len(wave)).astype(np.float32)
    if rng.random() < 0.5:
        k = int(rng.integers(0, max(len(wave) - 400, 1)))
        wave[k:k + int(rng.integers(5, 400))] = 0.0
    if rng.random() < 0.3:
        k = int(rng.integers(0, max(len(wave) - 50, 1)))
        wave[k:k + int(rng.integers(5, 50))] *= -1.0
    if rng.random() < 0.3:
        wave = wave[: int(len(wave) * rng.uniform(0.5, 0.999))]

    if path == "dd":
        from trackmaker_tpu.dsp.channel import multipath
        from trackmaker_tpu.dsp.equalizer import decode_capture_dd
        nt = int(rng.integers(4, 14))
        taps = np.zeros(nt, np.float32)
        taps[0] = 1.0
        taps[nt - 1] = float(rng.uniform(0.2, 0.55))
        if rng.random() < 0.5 and nt > 5:
            taps[int(rng.integers(2, nt - 1))] = float(
                rng.uniform(0.1, 0.3))
        wave = np.asarray(multipath(jnp.asarray(wave),
                                    jnp.asarray(taps)))
        bucket = 4096                  # bound the compile count
        while bucket < len(wave):
            bucket *= 2
        wave = np.concatenate(
            [wave, np.zeros(bucket - len(wave), np.float32)])
        sent = {(f.sequence, f.data) for f in frames if f.dst == 2}
        sent_by_seq = {f.sequence: f.data for f in frames if f.dst == 2}
        stock = decode_capture(cfg, jnp.asarray(wave), 2,
                               max_frames=24).to_frames()
        dd = decode_capture_dd(cfg, wave, 2, max_frames=24)
        got = dd.to_frames()
        ok = True
        for f in got:
            if (f.sequence, f.data) in sent:
                continue
            ref = sent_by_seq.get(f.sequence)
            if ref is not None and len(ref) == len(f.data):
                nerr = sum(a != b for a, b in zip(ref, f.data))
                if nerr <= max(4, len(ref) // 4):
                    print(f"  crc8 collision: seed={seed} seq="
                          f"{f.sequence} {nerr}/{len(ref)} bytes wrong",
                          flush=True)
                    continue
            ok = False            # true hallucination
        return ok and len(got) >= len(stock)

    want = OracleDecoder(cfg, 2).process_samples(wave)
    # bucket the shape so the in-process compile count stays bounded
    bucket = 4096
    while bucket < len(wave):
        bucket *= 2
    padded = np.zeros(bucket, np.float32)
    padded[: len(wave)] = wave
    if path == "fast":
        from trackmaker_tpu.phy.decoder import decode_capture_fast
        # the fast wrapper has no valid_len parameter: feed the exact
        # (unpadded) wave; shapes vary, so compile counts grow — fine
        # for a soak tool
        got = decode_capture_fast(cfg, jnp.asarray(wave), 2,
                                  max_frames=24).to_frames()
    else:
        got = decode_capture(cfg, jnp.asarray(padded), 2, max_frames=24,
                             valid_len=len(wave)).to_frames()
    return ([f.sequence for f in got] == [f.sequence for f in want]
            and [f.data for f in got] == [f.data for f in want])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=50)
    ap.add_argument("--seed-base", type=int, default=50_000)
    ap.add_argument("--coding", choices=["manchester", "4b5b", "both"],
                    default="both")
    ap.add_argument("--path", choices=["exact", "fast", "dd"],
                    default="exact")
    args = ap.parse_args()
    codings = (["manchester", "4b5b"] if args.coding == "both"
               else [args.coding])
    trials, fails = 0, []
    for coding in codings:
        for s in range(args.seeds):
            seed = args.seed_base + s
            trials += 1
            if not one_trial(coding, seed, args.path):
                fails.append((coding, seed))
                print(f"MISMATCH {coding} seed={seed}", flush=True)
            if trials % 20 == 0:
                print(f"{trials} trials, {len(fails)} mismatches",
                      flush=True)
    print(f"DONE: {trials} trials, {len(fails)} mismatches: {fails}")
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
