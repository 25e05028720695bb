"""Tiny bounded LRU mapping for process-wide caches.

A copy of ``hpbandster_tpu/utils/lru.py`` (jax-free there too), so the port
imports nothing of the JAX package, with one addition the port needs: an
entry may carry the bytes it pins on a device (:meth:`LRUCache.put`), and
an insert may bound the cache's total bytes as well as its entry count.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional

__all__ = ["LRUCache"]


class LRUCache:
    """Dict-shaped LRU: reads refresh recency, inserts evict the oldest.

    Used for process-wide caches of built bracket runners, where an
    unbounded dict would pin every closed-over dataset for the process
    lifetime while throwaway closures (new identity each call) never hit.
    Thread-safe.
    """

    def __init__(self, maxsize: int = 64):
        self.maxsize = int(maxsize)
        self._data: OrderedDict = OrderedDict()
        #: bytes each entry pins, for the entries put with a size
        self._sizes: Dict[Any, int] = {}
        self._lock = threading.Lock()

    def __contains__(self, key: Any) -> bool:
        with self._lock:
            return key in self._data

    def __getitem__(self, key: Any) -> Any:
        with self._lock:
            value = self._data[key]
            self._data.move_to_end(key)
            return value

    def get(self, key: Any, default: Any = None) -> Any:
        with self._lock:
            if key not in self._data:
                return default
            value = self._data[key]
            self._data.move_to_end(key)
            return value

    def __setitem__(self, key: Any, value: Any) -> None:
        self.put(key, value)

    def put(self, key: Any, value: Any, nbytes: int = 0,
            max_bytes: Optional[int] = None) -> None:
        """Insert ``value`` as the newest entry, pinning ``nbytes``. Then
        evict the oldest other entries while the cache holds more than
        ``maxsize`` entries or, with ``max_bytes``, more than ``max_bytes``
        in all: the new entry always stays, so the total may exceed the
        bound by at most this entry alone."""
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
            self._data[key] = value
            self._sizes[key] = int(nbytes)
            while len(self._data) > 1 and (
                len(self._data) > self.maxsize
                or (max_bytes is not None
                    and sum(self._sizes.values()) > max_bytes)
            ):
                old, _ = self._data.popitem(last=False)
                del self._sizes[old]

    def sizes(self) -> List[int]:
        """The bytes each entry pins, least recently used first."""
        with self._lock:
            return [self._sizes[k] for k in self._data]

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._sizes.clear()
