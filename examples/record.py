"""Audio bring-up loop — the reference's examples/record.rs (287 LoC:
record -> play the recording -> play the sample track while recording
-> replay) rebuilt over the C++ audio shim.

Backends (trackmaker_tpu.runtime.AudioDuplex):
* real ALSA hardware when libasound is present (same code path), or
* the loopback "virtual cable" (playback ring -> capture ring), the
  software twin of the reference's no-JACK loopback test — so the full
  bring-up sequence runs headless, and CI can drive it.

Adds a step the reference's bring-up lacks: encode PHY frames, play
them through the audio path, and decode the capture with the streaming
pipeline — proving the *whole* chain (encoder -> audio I/O -> ring ->
batched device decode) before any hardware session.

Usage: python examples/record.py [--seconds 2] [--device default]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="default")
    ap.add_argument("--fast", action="store_true",
                    help="unpaced loopback (tests/CI)")
    args = ap.parse_args()

    from trackmaker_tpu import runtime as rt
    from trackmaker_tpu.core.config import PhyConfig
    from trackmaker_tpu.core.framing import Frame
    from trackmaker_tpu.link.stream import StreamingDecodePipeline
    from trackmaker_tpu.phy.encoder import PhyEncoder
    from trackmaker_tpu.utils.progress import ProgressBar

    backend = (rt.BACKEND_ALSA if rt.alsa_available()
               else (rt.BACKEND_LOOPBACK_FAST if args.fast
                     else rt.BACKEND_LOOPBACK))
    names = {rt.BACKEND_ALSA: "alsa",
             rt.BACKEND_LOOPBACK: "loopback",
             rt.BACKEND_LOOPBACK_FAST: "loopback-fast"}
    print(f"audio backend: {names[backend]}")
    duplex = rt.AudioDuplex(device=args.device, backend=backend)

    n = int(args.seconds * duplex.rate)

    def pump_capture(total, feed=None, label="REC"):
        """Capture `total` samples, optionally feeding `feed` into the
        playback side (on loopback that is what gets recorded)."""
        bar = ProgressBar(label, total)
        out = []
        fed = 0
        got = 0
        deadline = time.time() + max(args.seconds * 4, 10)
        while got < total and time.time() < deadline:
            if feed is not None and fed < len(feed):
                fed += duplex.play(feed[fed:fed + 8192])
            chunk = duplex.capture(min(8192, total - got))
            if len(chunk) == 0:
                time.sleep(0.005)
                continue
            out.append(chunk)
            got += len(chunk)
            bar.set_position(got)
        bar.finish()
        return (np.concatenate(out) if out
                else np.zeros(0, np.float32))[:total]

    # ---- phase 1: record while playing the sample track (record.rs's
    # "play FLAC while recording" step; on hardware you would hear it)
    try:
        with open("assets/fixtures/sample_ref.flac", "rb") as fh:
            pcm, _sr = rt.flac_decode(fh.read())
            track = pcm[:, 0] if pcm.ndim == 2 else pcm
    except Exception:
        t = np.arange(n) / duplex.rate
        track = (0.4 * np.sin(2 * np.pi * 440 * t)
                 + 0.3 * np.sin(2 * np.pi * 880 * t)).astype(np.float32)
    track = np.asarray(track[:n], np.float32)
    rec = pump_capture(len(track), feed=track, label="REC+PLAY")
    print(f"recorded {len(rec)} samples, rms={np.sqrt(np.mean(rec**2)):.3f}")

    # ---- phase 2: replay the recording through the audio path
    rec2 = pump_capture(len(rec), feed=rec, label="REPLAY")
    if backend != rt.BACKEND_ALSA:
        exact = np.array_equal(rec2, rec)
        print(f"replay round-trip exact: {exact}")

    # ---- phase 3: PHY frames over the audio path + streaming decode
    cfg = PhyConfig()
    frames = [Frame.new_data(i, 1, 2, f"bring-up {i}".encode())
              for i in range(4)]
    wave = PhyEncoder(cfg).encode_frames(frames, gap_samples=2000)
    cap = pump_capture(len(wave), feed=wave.astype(np.float32),
                       label="PHY")
    pipe = StreamingDecodePipeline(cfg, local_addr=2)
    decoded = pipe.push(cap) + pipe.flush()
    ok = [f.data for f in decoded] == [f.data for f in frames]
    print(f"PHY over audio path: {len(decoded)}/{len(frames)} frames, "
          f"payloads exact: {ok}")
    duplex.close()
    sys.stdout.flush()
    if not ok:
        os._exit(1)
    os._exit(0)


if __name__ == "__main__":
    main()
