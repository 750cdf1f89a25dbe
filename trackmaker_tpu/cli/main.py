"""CLI entry points (reference src/main.rs clap subcommands Tx/Rx/Test/
Ping/IpHost/Router/Tun, main.rs:37-203).

With no sound hardware in scope, Tx/Rx run over the sample-accurate
simulated bus, and `encode`/`decode` work offline against WAV/FLAC files
(the batched device workflow the framework is built around).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _cfg_from_args(args):
    from trackmaker_tpu.core.config import PhyConfig
    coding = {"manchester": "manchester", "4b5b": "4b5b"}[args.encoding]
    return PhyConfig(line_coding=coding,
                     samples_per_level=args.samples_per_level,
                     preamble_pattern_bytes=args.preamble_bytes)


def cmd_test(args):
    """Loopback PHY round trip — the reference's canonical check
    (src/main.rs:480-589): bytes -> frames -> waveform -> decode."""
    import numpy as np
    import jax.numpy as jnp
    from trackmaker_tpu.core.framing import Frame
    from trackmaker_tpu.phy.decoder import decode_capture
    from trackmaker_tpu.phy.encoder import PhyEncoder
    from trackmaker_tpu.io import AudioData, dump_to_wav

    cfg = _cfg_from_args(args)
    data = (open(args.input, "rb").read() if args.input
            else (b"The quick brown fox jumps over the lazy dog. " * 16))
    chunks = [data[i:i + cfg.max_frame_data_size]
              for i in range(0, len(data), cfg.max_frame_data_size)]
    frames = [Frame.new_data(i & 0xFF, 1, 2, c)
              for i, c in enumerate(chunks)]
    enc = PhyEncoder(cfg)
    t0 = time.time()
    wave = enc.encode_frames(frames)
    if args.wav:
        dump_to_wav(args.wav, AudioData(cfg.sample_rate, wave))
        print(f"dumped waveform to {args.wav}")
    res = decode_capture(cfg, jnp.asarray(wave), 2,
                         max_frames=len(frames) + 8)
    out = b"".join(f.data for f in res.to_frames())
    dt = time.time() - t0
    ok = out == data
    airtime = len(wave) / cfg.sample_rate
    print(f"encoding: {cfg.line_coding}, frames: {len(frames)}, "
          f"samples: {len(wave)} ({airtime:.2f}s airtime)")
    print(f"decoded {len(out)}/{len(data)} bytes, exact: {ok}")
    if not ok:
        for i, (a, b) in enumerate(zip(data, out)):
            if a != b:
                print(f"first diff at byte {i}: {a:#x} != {b:#x}")
                break
    print(f"effective bitrate: {len(data) * 8 / airtime:.0f} bps "
          f"(wall {dt:.2f}s = {airtime / dt:.0f}x realtime)")
    return 0 if ok else 1


def _phy_factory(name: str):
    """`tm tx --phy`: local_addr -> stream PHY (None = line-coded).

    The MAC is modem-agnostic (one duck type across every family), so
    swapping the waveform under a file transfer is one flag."""
    if name == "line":
        return None
    if name == "ofdm":
        from trackmaker_tpu.phy.ofdm_v2 import OfdmStreamPhyV2
        return lambda a: OfdmStreamPhyV2(local_addr=a)
    if name == "ofdm-adapt":
        from trackmaker_tpu.phy.ofdm_adaptive import OfdmAdaptiveStreamPhy
        return lambda a: OfdmAdaptiveStreamPhy(local_addr=a)
    if name == "fsk":
        from trackmaker_tpu.phy.stream_sc import FskStreamPhy
        return lambda a: FskStreamPhy(local_addr=a)
    if name == "psk":
        from trackmaker_tpu.phy.stream_sc import PskStreamPhy
        return lambda a: PskStreamPhy(local_addr=a)
    raise ValueError(name)


def cmd_tx(args):
    """File send over the simulated bus (pairs with a local rx).

    --arq picks the reliability scheme: the reference's Stop-and-Wait
    (sw, default), or the beyond-parity sliding windows (gbn, sr)."""
    if args.arq == "sw":
        from trackmaker_tpu.link.transfer import run_file_transfer
        stats = run_file_transfer(args.input, args.output,
                                  noise_std=args.noise,
                                  max_duration_s=args.timeout,
                                  phy_factory=_phy_factory(args.phy))
        print(json.dumps(stats, indent=2))
        return 0 if stats["exact"] else 1
    data = open(args.input, "rb").read()
    if args.arq == "gbn":
        from trackmaker_tpu.link.gbn import gbn_transfer as xfer
    else:
        from trackmaker_tpu.link.sr import sr_transfer as xfer
    received, stats = xfer(data, window=args.window,
                           noise_std=args.noise,
                           max_duration_s=args.timeout,
                           phy_factory=_phy_factory(args.phy))
    with open(args.output, "wb") as f:
        f.write(received)
    stats["exact"] = received == data
    print(json.dumps(stats, indent=2))
    return 0 if stats["exact"] else 1


def cmd_ping(args):
    from trackmaker_tpu.net.tools import run_ping_simulation
    stats = run_ping_simulation(
        local_ip=args.source, target_ip=args.target, count=args.count,
        noise_std=args.noise, phy_factory=_phy_factory(args.phy))
    print(f"--- {args.target} ping statistics (simulated acoustic) ---")
    print(f"{stats['sent']} transmitted, {stats['received']} received, "
          f"{stats['loss_pct']:.0f}% loss")
    if stats["rtt_avg_ms"] is not None:
        print(f"rtt min/avg/max = {stats['rtt_min_ms']:.1f}/"
              f"{stats['rtt_avg_ms']:.1f}/{stats['rtt_max_ms']:.1f} ms")
    return 0 if stats["received"] == stats["sent"] else 1


def cmd_decode(args):
    """Offline batch decode of a recorded capture (WAV/FLAC) — the batched
    workhorse path."""
    import jax.numpy as jnp
    from trackmaker_tpu.io import load_audio
    from trackmaker_tpu.phy.decoder import decode_capture

    cfg = _cfg_from_args(args)
    if len(args.capture) > 1:
        return _decode_many(cfg, args)
    samples, sr = load_audio(args.capture[0])
    if sr != cfg.sample_rate:
        print(f"warning: capture is {sr} Hz, config is {cfg.sample_rate}")
    t0 = time.time()
    if args.equalize:
        from trackmaker_tpu.dsp.equalizer import equalize_capture
        eq, info = equalize_capture(cfg, jnp.asarray(samples))
        if bool(info["applied"]):
            print(f"equalizer: trained at sample {int(info['anchor'])} "
                  f"(quality {float(info['quality']):.2f}, "
                  f"noise loading {float(info['lam']):.3f})")
            samples = eq
        else:
            print("equalizer: no preamble above quality 0.5 — passthrough")
    if args.equalize_dd:
        from trackmaker_tpu.dsp.equalizer import decode_capture_dd
        res = decode_capture_dd(cfg, samples, args.addr,
                                max_frames=args.max_frames)
        frames = res.to_frames()
    elif args.clock_search:
        from trackmaker_tpu.dsp.timing import decode_with_clock_search
        res, ppm = decode_with_clock_search(
            cfg, samples, args.addr, max_frames=args.max_frames)
        print(f"clock search picked {ppm:+.0f} ppm")
        frames = res.to_frames()
    elif args.timing_gate:
        from trackmaker_tpu.dsp.timing import decode_with_timing_gate
        res, rec = decode_with_timing_gate(
            cfg, samples, args.addr, max_frames=args.max_frames)
        frames = res.to_frames() + rec.to_frames()
        n_rec = len(rec.to_frames())
        if n_rec:
            print(f"timing gate recovered {n_rec} drifted frame(s)")
    else:
        res = decode_capture(cfg, jnp.asarray(samples), args.addr,
                             max_frames=args.max_frames)
        frames = res.to_frames()
    dt = time.time() - t0
    print(f"decoded {len(frames)} frames from {len(samples)} samples "
          f"in {dt:.2f}s ({len(samples) / sr / max(dt, 1e-9):.0f}x realtime)")
    for f in frames:
        print(f"  seq={f.sequence} src={f.src} dst={f.dst} "
              f"len={len(f.data)}")
    if args.output:
        with open(args.output, "wb") as fh:
            for f in frames:
                fh.write(f.data)
        print(f"payloads written to {args.output}")
    return 0


def _decode_many(cfg, args):
    """Batched multi-capture decode: every file rides ONE jitted call
    (zero-padded to a shared bucket — padding adds no correlation
    candidates, so per-file decisions equal the single-file path).
    This is the batched-device workflow the framework is built around: N
    recordings cost one program launch, not N."""
    import numpy as np
    import jax.numpy as jnp
    from trackmaker_tpu.io import load_audio
    from trackmaker_tpu.phy.decoder import decode_capture_fast

    if (args.clock_search or args.timing_gate or args.equalize
            or args.equalize_dd):
        print("decode: --clock-search/--timing-gate/--equalize[-dd] "
              "are per-capture modes; pass one capture")
        return 2
    rows = []
    for path in args.capture:
        samples, sr = load_audio(path)
        if sr != cfg.sample_rate:
            print(f"warning: {path} is {sr} Hz, config is "
                  f"{cfg.sample_rate}")
        rows.append(np.asarray(samples, np.float32))

    # bucket by next-power-of-two length: padding everything to the
    # longest file would decode a 1 s capture at 600 s cost in a mixed
    # batch, and per-exact-length batches would compile one program per
    # file length.  Buckets bound pad waste at 2x and programs at
    # log2(spread).
    buckets: dict[int, list[int]] = {}
    for i, r in enumerate(rows):
        b = 1 << max(12, (len(r) - 1).bit_length())
        buckets.setdefault(b, []).append(i)

    t0 = time.time()
    counts = [0] * len(rows)
    frames_of: dict[int, list] = {}
    for blen in sorted(buckets):
        idxs = buckets[blen]
        batch = np.zeros((len(idxs), blen), np.float32)
        for k, i in enumerate(idxs):
            batch[k, : len(rows[i])] = rows[i]
        res = decode_capture_fast(cfg, jnp.asarray(batch), args.addr,
                                  max_frames=args.max_frames)
        cnt = np.asarray(res.count)
        for k, i in enumerate(idxs):
            counts[i] = int(cnt[k])
            frames_of[i] = res.to_frames(k)
    dt = time.time() - t0
    total = sum(len(r) for r in rows)
    print(f"decoded {sum(counts)} frames from {len(rows)} captures "
          f"({total} samples, {len(buckets)} bucket(s)) in {dt:.2f}s "
          f"({total / cfg.sample_rate / max(dt, 1e-9):.0f}x realtime "
          f"aggregate)")
    out = open(args.output, "wb") if args.output else None
    for i, path in enumerate(args.capture):
        print(f"  {path}: {counts[i]} frames")
        for f in frames_of[i]:
            print(f"    seq={f.sequence} src={f.src} dst={f.dst} "
                  f"len={len(f.data)}")
            if out:
                out.write(f.data)
    if out:
        out.close()
        print(f"payloads written to {args.output}")
    return 0


def cmd_encode(args):
    import numpy as np
    from trackmaker_tpu.core.framing import Frame
    from trackmaker_tpu.phy.encoder import PhyEncoder
    from trackmaker_tpu.io import AudioData, dump_to_wav

    cfg = _cfg_from_args(args)
    data = open(args.input, "rb").read()
    chunks = [data[i:i + cfg.max_frame_data_size]
              for i in range(0, len(data), cfg.max_frame_data_size)]
    frames = [Frame.new_data(i & 0xFF, args.src, args.dst, c)
              for i, c in enumerate(chunks)]
    wave = PhyEncoder(cfg).encode_frames(frames)
    dump_to_wav(args.wav, AudioData(cfg.sample_rate, wave))
    print(f"{len(frames)} frames -> {len(wave)} samples -> {args.wav}")
    return 0


def cmd_ask_test(args):
    import numpy as np
    import jax.numpy as jnp
    from trackmaker_tpu.phy import ask

    text = open(args.input, "rb").read() if args.input else \
        open("assets/think-different.txt", "rb").read()
    frames = ask.build_frames(text, num_frames=args.frames)
    track = ask.build_track(ask.AskConfig(), frames, seed=1)
    res = ask.demodulate(ask.AskConfig(), jnp.asarray(track),
                         max_frames=args.frames + 8)
    out = ask.assemble_text(res)
    n = int(res.count)
    ok = out[: len(text)] == text[: len(out)]
    print(f"ASK loopback: {n}/{args.frames} frames, prefix exact: {ok}")
    return 0 if ok else 1


def cmd_ofdm_test(args):
    import numpy as np
    from trackmaker_tpu.core.framing import Frame
    from trackmaker_tpu.phy.ofdm import OfdmModem

    text = open(args.input, "rb").read() if args.input else \
        open("assets/think-different.txt", "rb").read()
    modem = OfdmModem(fec=args.fec if args.fec != "none" else False)
    size = 96
    chunks = [text[i:i + size].ljust(size, b"\0")
              for i in range(0, len(text), size)]
    frames = [Frame.new_data(i & 0xFF, 1, 2, c)
              for i, c in enumerate(chunks)]
    wave = modem.encode_frames(frames, gap_samples=300)
    got = modem.decode(wave, len(frames[0].to_bytes()),
                       max_frames=len(frames) + 4)
    out = b"".join(f.data for f in got)[: len(text)]
    ok = out == text
    print(f"OFDM loopback: {len(got)}/{len(frames)} frames, exact: {ok}, "
          f"{len(wave) / 48000:.2f}s airtime")
    return 0 if ok else 1


def cmd_ofdm_adapt(args):
    """Adaptive bit-loading demo: probe a shaped channel, choose a
    per-bin loading, and run a loaded round-trip vs uniform QPSK."""
    import numpy as np
    import jax.numpy as jnp
    from trackmaker_tpu.core.framing import Frame
    from trackmaker_tpu.phy.ofdm import find_preambles
    from trackmaker_tpu.phy.ofdm_adaptive import (
        OfdmAdaptiveConfig, OfdmAdaptiveModem, choose_gains,
        choose_loading, demodulate_at_adaptive, estimate_bin_snr,
        modulate_bits_adaptive, probe_waveform)

    rng = np.random.default_rng(args.seed)
    taps = 31
    tt = np.arange(taps) - taps // 2
    fc = args.cutoff_hz / 48000.0
    h = (2 * fc * np.sinc(2 * fc * tt) * np.hamming(taps)
         + 0.06 * np.eye(taps)[taps // 2])

    def channel(x):
        y = np.convolve(x, h, mode="same")
        return (y + rng.normal(0, args.noise, len(y))).astype(np.float32)

    cfg = OfdmAdaptiveConfig()
    probe = probe_waveform(cfg)
    rx = channel(np.concatenate([probe, np.zeros(600, np.float32)]))
    s = int(np.asarray(find_preambles(cfg, jnp.asarray(rx), 2))[0])
    snr = np.asarray(estimate_bin_snr(cfg, jnp.asarray(rx), s))
    loading = choose_loading(snr)
    lv = np.asarray(loading)
    modem = OfdmAdaptiveModem(cfg, loading=loading)
    uni = len(cfg.data_bin_idx) * 2
    print(f"probe SNR: {10*np.log10(snr.max()):.1f} dB best bin, "
          f"{10*np.log10(max(snr.min(), 1e-12)):.1f} dB worst")
    print(f"loading: {int((lv == 6).sum())}x64QAM "
          f"{int((lv == 4).sum())}x16QAM {int((lv == 2).sum())}"
          f"xQPSK {int((lv == 1).sum())}xBPSK {int((lv == 0).sum())}xoff"
          f" -> {modem.bits_per_symbol} bits/sym"
          f" ({modem.bits_per_symbol / uni:.2f}x uniform QPSK)")

    payloads = [bytes([7 * i + 1]) * 48 for i in range(4)]
    frames = [Frame.new_data(i, 1, 2, p) for i, p in enumerate(payloads)]
    wave = modem.encode_frames(frames, gap_samples=400)
    got = modem.decode(channel(np.concatenate(
        [wave, np.zeros(900, np.float32)])), 7 + 48, max_frames=6)
    ok = [f.data for f in got] == payloads
    print(f"loaded round-trip over the shaped channel: "
          f"{len(got)}/{len(frames)} frames, exact: {ok}")

    # water-filling: same loading, margin-balanced per-bin power; show
    # raw bit errors when the noise rises ~10 dB above the probed level
    gains = choose_gains(snr, loading)
    g = np.asarray(gains)[lv > 0]
    print(f"water-filling gains: {20*np.log10(g.min()):+.2f} dB .. "
          f"{20*np.log10(g.max()):+.2f} dB across active bins")
    bits = rng.integers(0, 2, (1, 1600), dtype=np.uint8)
    hot = args.noise * 4.0
    errs = {}
    for name, gg in (("unit power", None), ("water-filled", gains)):
        mcfg = OfdmAdaptiveModem(cfg, loading=loading, gains=gg).cfg
        w = np.asarray(modulate_bits_adaptive(
            mcfg, jnp.asarray(bits), 1600)[0])
        total = 0
        for trial in range(4):
            noisy = channel(np.concatenate(
                [w, np.zeros(900, np.float32)]))
            noisy = (noisy + rng.normal(
                0, hot, len(noisy))).astype(np.float32)
            st = np.asarray(find_preambles(mcfg, jnp.asarray(noisy), 1))
            out = np.asarray(demodulate_at_adaptive(
                mcfg, jnp.asarray(noisy), 1600, jnp.asarray(st)))[0]
            total += int((out != bits[0]).sum())
        errs[name] = total
        print(f"  raw bit errors at noise x4 ({name}): {total}/6400")
    return 0 if ok else 1


def cmd_ber(args):
    from trackmaker_tpu.bench import ber_sweep, clock_offset_sweep
    cfg = _cfg_from_args(args)
    if args.coded:
        from trackmaker_tpu.bench.ber import coded_ber_sweep
        rate = "3/4" if args.rate34 else "1/2"
        print(f"coded PHY: {cfg.line_coding}, rate {rate}")
        for r in coded_ber_sweep(n_frames=args.frames,
                                 line_coding=cfg.line_coding,
                                 rate34=args.rate34):
            print(f"SNR {r['snr_db']:6.1f} dB: uncoded loss "
                  f"{r['uncoded_loss_pct']:5.1f}%  coded loss "
                  f"{r['coded_loss_pct']:5.1f}%")
        return 0
    res = ber_sweep(cfg, n_frames=args.frames)
    for r in res:
        print(f"SNR {r['snr_db']:6.1f} dB: loss {r['frame_loss_pct']:5.1f}%"
              f"  bit_errors={r['payload_bit_errors']}")
    if args.plot:
        from trackmaker_tpu.bench.viz import plot_ber_curves
        print("wrote", plot_ber_curves(res, args.plot))
    res2 = clock_offset_sweep(cfg, n_frames=args.frames)
    for r in res2:
        print(f"clock {r['clock_ppm']:7.0f} ppm: "
              f"loss {r['frame_loss_pct']:5.1f}%")
    return 0


def cmd_sweep(args):
    from trackmaker_tpu.bench.sweep import mac_parameter_sweep
    data = (open(args.input, "rb").read() if args.input
            else bytes(range(256)))
    res = mac_parameter_sweep(
        data, noise_stds=tuple(args.noise), repeats=args.repeats,
        out_json=args.out)
    for r in res:
        print(f"{r['line_coding']:>10} spl={r['samples_per_level']} "
              f"noise={r['noise_std']}: airtime {r['airtime_s']:.2f}s "
              f"retx={r['retransmissions']} exact={r['exact']}")
    return 0 if all(r["exact"] for r in res) else 1


def cmd_viz(args):
    if args.html:
        from trackmaker_tpu.bench.viz import _load
        from trackmaker_tpu.bench.viz_html import (correlation_debug,
                                                   render_dashboard)
        debug = None
        if args.corr:
            samples, sr = _load(args.capture)
            debug = correlation_debug(samples, sr, mode=args.corr)
        out = render_dashboard(args.capture, args.html, debug=debug)
    else:
        from trackmaker_tpu.bench.viz import plot_dashboard
        out = plot_dashboard(args.capture, args.out)
    print("wrote", out)
    return 0


def cmd_router(args):
    """Run the multi-segment router demo: an acoustic node pings a host
    on the WiFi segment through the router, all on the simulated bus."""
    import importlib.util
    import pathlib
    spec = importlib.util.spec_from_file_location(
        "router_scenario",
        pathlib.Path(__file__).resolve().parents[2]
        / "tests" / "test_router_acoustic.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.test_acoustic_node_pings_wifi_host_via_router()
    print("router demo: acoustic -> router -> wifi host -> back: OK")
    return 0


def cmd_tun(args):
    """Bridge a kernel TUN device onto the simulated acoustic link with
    an echo host on the far side (reference `tun` subcommand; needs
    CAP_NET_ADMIN)."""
    import numpy as np
    from trackmaker_tpu.core.config import MacConfig, NetConfig, PhyConfig
    from trackmaker_tpu.link.audio import AudioEndpoint
    from trackmaker_tpu.link.bus import SimulatedBus
    from trackmaker_tpu.link.interface import AcousticInterface
    from trackmaker_tpu.net.ports import TunPort
    from trackmaker_tpu.net.tools import IpHostApp
    from trackmaker_tpu.net.tun_bridge import TunBridge

    cfg, mac, net = PhyConfig(), MacConfig(), NetConfig()
    bus = SimulatedBus()
    ep_a, ep_b = AudioEndpoint("tun"), AudioEndpoint("host")
    if_a = AcousticInterface(ep_a, cfg, mac, net, local_mac=1)
    if_b = AcousticInterface(ep_b, cfg, mac, net, local_mac=2)
    tun = TunPort(args.name, ip=args.ip, netmask_bits=args.netmask_bits,
                  mtu=net.mtu)
    bridge = TunBridge(if_a, tun, args.ip)
    host = IpHostApp(if_b, args.peer)
    bus.attach(ep_a, bridge)
    bus.attach(ep_b, host)
    print(f"TUN {args.name} up at {args.ip}; echo host at {args.peer}.")
    print(f"Try: ping {args.peer}   (Ctrl-C to stop)")
    try:
        # Event-driven idle wait (ROADMAP "epoll-driven variant"): when
        # both MACs are idle and the medium has been silent for a
        # while (well past the ARQ timeout, so no pending retransmit
        # timer can be starved by frozen sim time), block on the TUN
        # fd instead of spinning bus.step() at 100% CPU; any kernel
        # packet (or the poll timeout) resumes the simulation clock.
        import select as select_mod
        silent_samples = 0
        idle_after = bus.sample_rate  # 1 s of true quiet
        while True:
            bus.step()
            quiet = (if_a.tx_idle and if_b.tx_idle
                     and ep_a.playing_remaining == 0
                     and ep_b.playing_remaining == 0)
            silent_samples = silent_samples + bus.chunk if quiet else 0
            if silent_samples >= idle_after:
                select_mod.select([tun.fd], [], [], 0.05)
    except KeyboardInterrupt:
        print(f"\nbridged {bridge.tx_packets} out / "
              f"{bridge.rx_packets} in packets; "
              f"host answered {host.responded} pings")
    finally:
        tun.close()
    return 0


def interactive() -> list[str]:
    """Menu mode when no subcommand is given (reference src/main.rs:
    428-478 used dialoguer)."""
    options = [
        ("Loopback PHY test (Manchester)", ["test"]),
        ("Loopback PHY test (4B5B)", ["test", "--encoding", "4b5b"]),
        ("ASK modem loopback", ["ask-test"]),
        ("OFDM modem loopback", ["ofdm-test"]),
        ("Simulated acoustic ping", ["ping"]),
        ("Router demo", ["router"]),
        ("BER robustness sweep", ["ber"]),
    ]
    print("trackmaker-tpu — select mode:")
    for i, (label, _) in enumerate(options, 1):
        print(f"  {i}. {label}")
    while True:
        choice = input(f"choice [1-{len(options)}]: ").strip()
        if choice.isdigit() and 1 <= int(choice) <= len(options):
            return options[int(choice) - 1][1]
        print("invalid choice")


def main(argv=None):
    if argv is None and len(sys.argv) <= 1:
        argv = interactive()
    p = argparse.ArgumentParser(
        prog="trackmaker-tpu",
        description="Acoustic modem framework on JAX")
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--encoding", default="manchester",
                        choices=["manchester", "4b5b"])
    common.add_argument("--samples-per-level", type=int, default=3)
    common.add_argument("--preamble-bytes", type=int, default=2)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("test", parents=[common],
                       help="loopback PHY round trip")
    s.add_argument("--input")
    s.add_argument("--wav")
    s.set_defaults(fn=cmd_test)

    s = sub.add_parser("tx", parents=[common], help="file transfer over simulated bus")
    s.add_argument("--input", required=True)
    s.add_argument("--output", required=True)
    s.add_argument("--noise", type=float, default=0.0)
    s.add_argument("--timeout", type=float, default=120.0)
    s.add_argument("--arq", default="sw", choices=["sw", "gbn", "sr"],
                   help="stop-and-wait (reference parity), Go-Back-N, "
                        "or Selective-Repeat")
    s.add_argument("--window", type=int, default=8,
                   help="sliding-window size for gbn/sr")
    s.add_argument("--phy", default="line",
                   choices=["line", "ofdm", "ofdm-adapt", "fsk", "psk"],
                   help="waveform family under the MAC (modem-agnostic "
                        "duck type, any --arq)")
    s.set_defaults(fn=cmd_tx)

    s = sub.add_parser("ping", parents=[common], help="ICMP ping over simulated acoustic")
    s.add_argument("--source", default="192.168.1.1")
    s.add_argument("--target", default="192.168.1.2")
    s.add_argument("--count", type=int, default=10)
    s.add_argument("--noise", type=float, default=0.0)
    s.add_argument("--phy", default="line",
                   choices=["line", "ofdm", "ofdm-adapt", "fsk", "psk"],
                   help="waveform family under the IP stack")
    s.set_defaults(fn=cmd_ping)

    s = sub.add_parser("decode", parents=[common], help="offline decode of WAV/FLAC captures (many files = one batched device call)")
    s.add_argument("capture", nargs="+")
    s.add_argument("--addr", type=int, default=2,
                   help="local MAC; -1 = promiscuous (accept all)")
    s.add_argument("--max-frames", type=int, default=256)
    s.add_argument("--output")
    s.add_argument("--clock-search", action="store_true",
                   help="search a resample-ratio grid (clock skew)")
    s.add_argument("--timing-gate", action="store_true",
                   help="per-frame early-late retry of failed "
                        "candidates (mixed-skew transmitters)")
    s.add_argument("--equalize", action="store_true",
                   help="preamble-trained MMSE equalizer front-end "
                        "(echoic/multipath captures)")
    s.add_argument("--equalize-dd", action="store_true",
                   help="decision-directed equalized decode (refits "
                        "the channel on decoded frames; for captures "
                        "with no clean leading preamble)")
    s.set_defaults(fn=cmd_decode)

    s = sub.add_parser("encode", parents=[common], help="file -> modulated WAV")
    s.add_argument("--input", required=True)
    s.add_argument("--wav", required=True)
    s.add_argument("--src", type=int, default=1)
    s.add_argument("--dst", type=int, default=2)
    s.set_defaults(fn=cmd_encode)

    s = sub.add_parser("ask-test", parents=[common], help="ASK/chirp modem loopback")
    s.add_argument("--input")
    s.add_argument("--frames", type=int, default=100)
    s.set_defaults(fn=cmd_ask_test)

    s = sub.add_parser("ofdm-test", parents=[common], help="OFDM modem loopback")
    s.add_argument("--input")
    s.add_argument("--fec", default="none",
                   choices=["none", "hamming", "conv"])
    s.set_defaults(fn=cmd_ofdm_test)

    s = sub.add_parser("ofdm-adapt",
                       help="adaptive bit-loading demo (probe -> "
                            "loading -> water-filling -> loaded "
                            "round-trip)")
    s.add_argument("--noise", type=float, default=0.002)
    s.add_argument("--cutoff-hz", type=float, default=6000.0)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=cmd_ofdm_adapt)

    s = sub.add_parser("ber", parents=[common],
                       help="AWGN + clock-offset robustness sweep")
    s.add_argument("--frames", type=int, default=16)
    s.add_argument("--plot")
    s.add_argument("--coded", action="store_true",
                   help="compare the Viterbi-coded PHY (of the chosen "
                        "--encoding) against the uncoded decoder")
    s.add_argument("--rate34", action="store_true",
                   help="with --coded: puncture to rate 3/4")
    s.set_defaults(fn=cmd_ber)

    s = sub.add_parser("sweep", parents=[common],
                       help="MAC/PHY parameter sweep (2x2 contended)")
    s.add_argument("--input")
    s.add_argument("--noise", type=float, nargs="*", default=[0.0])
    s.add_argument("--repeats", type=int, default=1)
    s.add_argument("--out")
    s.set_defaults(fn=cmd_sweep)

    s = sub.add_parser("viz", parents=[common],
                       help="waveform/FFT/spectrogram dashboard -> PNG, or "
                            "interactive HTML with --html")
    s.add_argument("capture")
    s.add_argument("--out", default="tmp/dashboard.png")
    s.add_argument("--html", help="write a self-contained interactive "
                   "dashboard (zoom/hover/3-D) to this path instead")
    s.add_argument("--corr", choices=["line", "ask"],
                   help="include the decoder correlation-debug trace")
    s.set_defaults(fn=cmd_viz)

    s = sub.add_parser("router", parents=[common],
                       help="multi-segment router demo (simulated)")
    s.set_defaults(fn=cmd_router)

    s = sub.add_parser("tun", parents=[common],
                       help="kernel TUN bridge over simulated acoustic")
    s.add_argument("--name", default="tm0")
    s.add_argument("--ip", default="10.78.0.1")
    s.add_argument("--peer", default="10.78.0.2")
    s.add_argument("--netmask-bits", type=int, default=24)
    s.set_defaults(fn=cmd_tun)

    args = p.parse_args(argv)
    from trackmaker_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    sys.exit(args.fn(args))


if __name__ == "__main__":
    main()
