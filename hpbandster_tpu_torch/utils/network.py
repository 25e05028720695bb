"""NIC-name -> IP resolution and local-nameserver helper.

Ported from ``hpbandster_tpu/utils/network.py``, a copy; the wire format and
the nameserver are the reference's.

Reference: ``hpbandster/utils.py`` (`nic_name_to_host`,
`start_local_nameserver`; SURVEY.md §2 "utils" row). The reference leans on
the ``netifaces`` package; here it is a stdlib-only Linux ``ioctl``
(SIOCGIFADDR) with graceful fallbacks, removing the native dependency.
"""

from __future__ import annotations

import socket
import struct
from typing import Optional, Tuple

__all__ = ["nic_name_to_host", "start_local_nameserver"]

_SIOCGIFADDR = 0x8915


def nic_name_to_host(nic_name: Optional[str] = None) -> str:
    """IPv4 address bound to the named interface; loopback when None/unknown."""
    if nic_name is None:
        return "127.0.0.1"
    try:
        import fcntl  # Linux-only, stdlib

        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            packed = struct.pack("256s", nic_name[:15].encode("utf-8"))
            addr = fcntl.ioctl(s.fileno(), _SIOCGIFADDR, packed)[20:24]
            return socket.inet_ntoa(addr)
    except (OSError, ImportError):
        # unknown NIC or non-Linux: best-effort hostname resolution
        try:
            return socket.gethostbyname(socket.gethostname())
        except OSError:
            return "127.0.0.1"


def start_local_nameserver(
    host: Optional[str] = None,
    port: int = 0,
    nic_name: Optional[str] = None,
) -> Tuple[object, str, int]:
    """Start a nameserver on this machine; returns ``(ns, host, port)``."""
    from hpbandster_tpu_torch.core.nameserver import NameServer

    if host is None:
        host = nic_name_to_host(nic_name)
    ns = NameServer(run_id="local", host=host, port=port)
    h, p = ns.start()
    return ns, h, p
