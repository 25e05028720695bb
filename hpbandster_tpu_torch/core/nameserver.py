"""NameServer — service discovery for the elastic host worker pool.

Ported from ``hpbandster_tpu/core/nameserver.py``, a copy; a port nameserver
serves reference workers and the reverse.

API-compatible with the reference's Pyro4-nameserver wrapper
(``core/nameserver.py``, SURVEY.md §2): ``start() -> (host, port)``,
``shutdown()``, optional credential file in a shared working directory so
cluster workers can bootstrap (same ``HPB_run_<id>_pyro.pkl`` filename
convention). Internally it is a tiny TCP registry (see parallel/rpc.py)
instead of a Pyro4 daemon.
"""

from __future__ import annotations

import logging
import os
import pickle
import threading
import time
from typing import Dict, Optional, Tuple

from hpbandster_tpu_torch.parallel.rpc import RPCServer
from hpbandster_tpu_torch.utils.network import nic_name_to_host

__all__ = ["NameServer"]


class NameServer:
    def __init__(
        self,
        run_id: str,
        working_directory: Optional[str] = None,
        host: Optional[str] = None,
        port: int = 0,
        nic_name: Optional[str] = None,
        logger: Optional[logging.Logger] = None,
    ):
        self.run_id = run_id
        self.working_directory = working_directory
        self.host = host if host is not None else nic_name_to_host(nic_name)
        self.port = port
        self.logger = logger or logging.getLogger("hpbandster_tpu_torch.nameserver")

        self._registry: Dict[str, Tuple[str, float]] = {}  # name -> (uri, t_reg)
        self._lock = threading.Lock()
        self._server: Optional[RPCServer] = None
        self.conf_fn: Optional[str] = None

    # ------------------------------------------------------------ rpc methods
    def _register(self, name: str, uri: str) -> bool:
        with self._lock:
            self._registry[name] = (uri, time.time())
        self.logger.debug("registered %s -> %s", name, uri)
        return True

    def _unregister(self, name: str) -> bool:
        with self._lock:
            return self._registry.pop(name, None) is not None

    def _list(self, prefix: str = "") -> Dict[str, str]:
        with self._lock:
            return {
                name: uri
                for name, (uri, _) in self._registry.items()
                if name.startswith(prefix)
            }

    def _ping(self) -> str:
        return "pong"

    # -------------------------------------------------------------- lifecycle
    def start(self) -> Tuple[str, int]:
        """Start serving; optionally drop a credentials file for cluster use."""
        if self._server is not None:
            return (self.host, self.port)
        self._server = RPCServer(self.host, self.port)
        self._server.register("register", self._register)
        self._server.register("unregister", self._unregister)
        self._server.register("list", self._list)
        self._server.register("ping", self._ping)
        self._server.start()
        self.host, self.port = self._server.host, self._server.port

        if self.working_directory is not None:
            os.makedirs(self.working_directory, exist_ok=True)
            # keep the reference's filename so cluster scripts carry over
            self.conf_fn = os.path.join(
                self.working_directory, f"HPB_run_{self.run_id}_pyro.pkl"
            )
            with open(self.conf_fn, "wb") as fh:
                pickle.dump((self.host, self.port), fh)
        self.logger.info("nameserver running at %s:%d", self.host, self.port)
        return (self.host, self.port)

    def shutdown(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server = None
        if self.conf_fn is not None and os.path.exists(self.conf_fn):
            os.remove(self.conf_fn)
            self.conf_fn = None
