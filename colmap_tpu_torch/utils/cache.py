"""LRU caches for host-side page management (colmap_tpu/utils/cache.py).

reference behavior: src/colmap/util/cache.h — `LRUCache` (capacity by
element count, loader callback, Get/Evict/Pop/Clear) and
`MemoryConstrainedLRUCache` (capacity by total byte size with per-element
sizes, used by the MVS workspace's bitmap/depth/normal pages,
mvs/workspace.h:46-136 cache_size GB option). Thread-safety is not needed
here: pipelines are single-threaded host loops feeding batched device calls,
so `ThreadSafeLRUCache` has no analog.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Generic, Optional, TypeVar

K = TypeVar("K")
V = TypeVar("V")


class LRUCache(Generic[K, V]):
    """Count-bounded LRU cache with a loader callback."""

    def __init__(self, max_num_elems: int, load_fn: Callable[[K], V]):
        assert max_num_elems > 0
        self.max_num_elems = int(max_num_elems)
        self._load = load_fn
        self._elems: "OrderedDict[K, V]" = OrderedDict()

    def num_elems(self) -> int:
        return len(self._elems)

    def exists(self, key: K) -> bool:
        return key in self._elems

    def get(self, key: K) -> V:
        if key in self._elems:
            self._elems.move_to_end(key)
            return self._elems[key]
        value = self._load(key)
        self._insert(key, value)
        return value

    def _insert(self, key: K, value: V) -> None:
        self._elems[key] = value
        self._elems.move_to_end(key)
        while len(self._elems) > self.max_num_elems:
            self.pop()

    def evict(self, key: K) -> bool:
        return self._elems.pop(key, None) is not None

    def pop(self) -> None:
        if self._elems:
            self._elems.popitem(last=False)

    def clear(self) -> None:
        self._elems.clear()


class MemoryConstrainedLRUCache(LRUCache[K, V]):
    """Byte-bounded LRU cache (reference: util/cache.h:137)."""

    def __init__(
        self,
        max_num_bytes: int,
        load_fn: Callable[[K], V],
        size_fn: Optional[Callable[[V], int]] = None,
    ):
        super().__init__(max_num_elems=2**62, load_fn=load_fn)
        assert max_num_bytes > 0
        self.max_num_bytes = int(max_num_bytes)
        self.num_bytes = 0
        self._size_fn = size_fn or _default_num_bytes
        self._sizes: dict = {}

    def _insert(self, key: K, value: V) -> None:
        size = int(self._size_fn(value))
        self._sizes[key] = size
        self.num_bytes += size
        self._elems[key] = value
        self._elems.move_to_end(key)
        while self.num_bytes > self.max_num_bytes and len(self._elems) > 1:
            self.pop()

    def evict(self, key: K) -> bool:
        if key in self._elems:
            self.num_bytes -= self._sizes.pop(key)
        return super().evict(key)

    def pop(self) -> None:
        if self._elems:
            key, _ = self._elems.popitem(last=False)
            self.num_bytes -= self._sizes.pop(key, 0)

    def clear(self) -> None:
        super().clear()
        self._sizes.clear()
        self.num_bytes = 0


def _default_num_bytes(value) -> int:
    nbytes = getattr(value, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    if isinstance(value, (tuple, list)):
        return sum(_default_num_bytes(v) for v in value)
    return 64  # nominal size for small objects
