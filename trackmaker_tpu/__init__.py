"""trackmaker_tpu — an acoustic-modem DSP framework on JAX.

A from-scratch JAX/XLA reimplementation of the capabilities of
``HeZeBang/TrackMaker-rs`` (an "IP over sound" stack): the physical layer
(line coding, correlation-based preamble synchronization, CRC framing,
modulation/demodulation) runs as batched device array programs; the MAC
(CSMA/CA + Stop-and-Wait ARQ), NET (IPv4/ICMP/fragmentation/NAT/router),
and I/O layers run as a thin host-side runtime driven by device decode
results.

Layer map (mirrors reference src/lib.rs:1-7 exports):

    trackmaker_tpu.core      runtime PhyConfig, bit ops, CRC8, frame codec
    trackmaker_tpu.dsp       oscillators/chirps, FIR filters, channel models
    trackmaker_tpu.sync      correlation sync
    trackmaker_tpu.phy       line codes, encoder, batched decoder, ASK/OFDM
    trackmaker_tpu.link      MAC: CSMA/ARQ, acoustic interface, transfer
    trackmaker_tpu.net       IPv4/ICMP codecs, fragmentation, ARP/NAT/router
    trackmaker_tpu.io        WAV/FLAC readers, dumps, fixtures
    trackmaker_tpu.parallel  device-mesh sharding for batched/blocked decode
    trackmaker_tpu.oracle    NumPy reference implementations (test oracles)
    trackmaker_tpu.runtime   native (C++) host runtime: ring buffers, framing
    trackmaker_tpu.cli       tx/rx/test/ping/ip-host/router entry points
"""

__version__ = "0.1.0"

from trackmaker_tpu.core.config import PhyConfig  # noqa: F401
