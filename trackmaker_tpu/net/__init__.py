"""Network layer: IPv4/ICMP codecs, fragmentation, ARP/NAT, router, tools.

Host-side runtime (none of this is compute-bound; the reference's report
itself notes CSMA/ARQ latency dominates, docs/proj/report.md:535).  The
device boundary stays at the PHY — this layer consumes/produces packet bytes
carried by ``trackmaker_tpu.link``.
"""

from trackmaker_tpu.net.ip import Ipv4Header, IP_HEADER_BYTES
from trackmaker_tpu.net.icmp import IcmpPacket, ICMP_ECHO_REQUEST, ICMP_ECHO_REPLY
from trackmaker_tpu.net.fragmentation import (
    FragmentationInfo, IpFragmenter, IpReassembler)
from trackmaker_tpu.net.arp import ArpTable
from trackmaker_tpu.net.nat import NatTable

PROTO_ICMP = 1
PROTO_TCP = 6
PROTO_UDP = 17

__all__ = [
    "Ipv4Header", "IP_HEADER_BYTES", "IcmpPacket",
    "ICMP_ECHO_REQUEST", "ICMP_ECHO_REPLY",
    "FragmentationInfo", "IpFragmenter", "IpReassembler",
    "ArpTable", "NatTable", "PROTO_ICMP", "PROTO_TCP", "PROTO_UDP",
]
