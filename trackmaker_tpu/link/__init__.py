"""Link layer: simulated shared acoustic medium + MAC (CSMA/CA + ARQ).

The reference's MAC runs against a real-time JACK audio loop
(``src/mac/csma.rs`` driving ``src/audio/recorder.rs`` buffers).  Here the
medium is an explicit discrete-time simulation (sample-accurate, chunk
driven) and every node is a deterministic tick-based state machine — the
same FSM states and timings (DIFS/slot/ACK-timeout in samples instead of
wall-clock sleeps), but reproducible and runnable at far beyond real time.
PHY encode/decode inside the nodes is the batched device path.
"""

from trackmaker_tpu.link.audio import AppState, AudioEndpoint
from trackmaker_tpu.link.bus import SimulatedBus
from trackmaker_tpu.link.csma import CsmaSender, CsmaReceiver, is_channel_busy

__all__ = [
    "AppState", "AudioEndpoint", "SimulatedBus",
    "CsmaSender", "CsmaReceiver", "is_channel_busy",
]
