"""Keyed binary heap with in-place update/delete by key.

Mirrors the semantics of the reference's scheduler heap
(pkg/scheduler/util/heap.go:127): items are keyed objects ordered by an
arbitrary less-function; Add/Update re-sift in place, Delete removes by key.

`NumericKeyedHeap` is the variant for orderings expressible as a numeric
(a, b, c) triple — both scheduler queues are (scheduling_queue.go
podsCompare and the backoff expiry). Copied from the reference
(`kubernetes_tpu.utils.heap`); the port has no native heap core, so
`NumericKeyedHeap` always runs on `_PyHeapCore`, the reference's twin of
that core, which pops in the same order.
"""
from __future__ import annotations

from typing import Any, Callable, Optional


class KeyedHeap:
    def __init__(self, key_fn: Callable[[Any], str], less_fn: Callable[[Any, Any], bool]):
        self._key_fn = key_fn
        self._less = less_fn
        self._items: list[Any] = []
        self._index: dict[str, int] = {}

    def __len__(self) -> int:
        return len(self._items)

    def __contains__(self, key: str) -> bool:
        return key in self._index

    def get(self, key: str) -> Optional[Any]:
        i = self._index.get(key)
        return self._items[i] if i is not None else None

    def list(self) -> list[Any]:
        return list(self._items)

    def add(self, item: Any) -> None:
        """Insert or replace by key, restoring heap order."""
        key = self._key_fn(item)
        i = self._index.get(key)
        if i is not None:
            self._items[i] = item
            self._sift_down(self._sift_up(i))
        else:
            self._items.append(item)
            self._index[key] = len(self._items) - 1
            self._sift_up(len(self._items) - 1)

    update = add

    def add_if_not_present(self, item: Any) -> None:
        if self._key_fn(item) not in self._index:
            self.add(item)

    def delete(self, key: str) -> Optional[Any]:
        i = self._index.get(key)
        if i is None:
            return None
        item = self._items[i]
        last = len(self._items) - 1
        self._swap(i, last)
        self._items.pop()
        del self._index[key]
        if i < last:
            self._sift_down(self._sift_up(i))
        return item

    def peek(self) -> Optional[Any]:
        return self._items[0] if self._items else None

    def pop(self) -> Optional[Any]:
        if not self._items:
            return None
        return self.delete(self._key_fn(self._items[0]))

    def pop_many(self, limit: int) -> list[Any]:
        """Up to `limit` ascending pops as one call (the heap core's
        batched-drain twin)."""
        out = []
        while len(out) < limit and self._items:
            out.append(self.pop())
        return out

    def add_many(self, items: list) -> None:
        """Batched insert (the heap core's push_many): per-item
        add() semantics, one call."""
        for item in items:
            self.add(item)

    # -- internals ----------------------------------------------------------
    def _swap(self, i: int, j: int) -> None:
        items = self._items
        items[i], items[j] = items[j], items[i]
        self._index[self._key_fn(items[i])] = i
        self._index[self._key_fn(items[j])] = j

    def _sift_up(self, i: int) -> int:
        while i > 0:
            parent = (i - 1) // 2
            if self._less(self._items[i], self._items[parent]):
                self._swap(i, parent)
                i = parent
            else:
                break
        return i

    def _sift_down(self, i: int) -> int:
        n = len(self._items)
        while True:
            smallest = i
            for c in (2 * i + 1, 2 * i + 2):
                if c < n and self._less(self._items[c], self._items[smallest]):
                    smallest = c
            if smallest == i:
                return i
            self._swap(i, smallest)
            i = smallest


class _PyHeapCore:
    """Pure-Python heap core with the reference's heapcore call surface.
    Entries are (key, triple, item); ordering is
    the same ascending numeric triple, so a heap migrated item-by-item
    pops in the identical order (queue triples embed a unique sequence
    number — no ties to reorder)."""

    def __init__(self):
        self._h = KeyedHeap(lambda e: e[0], lambda x, y: x[1] < y[1])

    def add(self, key, a, b, c, item) -> None:
        self._h.add((key, (a, b, c), item))

    def get(self, key):
        e = self._h.get(key)
        return e[2] if e is not None else None

    def delete(self, key):
        e = self._h.delete(key)
        return e[2] if e is not None else None

    def peek(self):
        e = self._h.peek()
        return e[2] if e is not None else None

    def pop(self):
        e = self._h.pop()
        return e[2] if e is not None else None

    def pop_many(self, limit: int) -> list:
        return [e[2] for e in self._h.pop_many(limit)]

    def push_many(self, entries: list) -> None:
        """Batched add: entries are
        (key, a, b, c, payload) tuples, inserted in order."""
        for key, a, b, c, item in entries:
            self.add(key, a, b, c, item)

    def list(self) -> list:
        return [e[2] for e in self._h.list()]

    def __len__(self) -> int:
        return len(self._h)

    def __contains__(self, key: str) -> bool:
        return key in self._h


class NumericKeyedHeap:
    """KeyedHeap specialization: ordering = ascending numeric triple, on
    the pure-Python heap core (`_PyHeapCore`)."""

    def __init__(self, key_fn: Callable[[Any], str],
                 triple_fn: Callable[[Any], tuple]):
        self._key_fn = key_fn
        self._triple = triple_fn
        self._core = _PyHeapCore()

    def __len__(self) -> int:
        return len(self._core)

    def __contains__(self, key: str) -> bool:
        return key in self._core

    def get(self, key: str) -> Optional[Any]:
        return self._core.get(key)

    def list(self) -> list[Any]:
        return self._core.list()

    def add(self, item: Any) -> None:
        a, b, c = self._triple(item)
        self._core.add(self._key_fn(item), float(a), float(b), float(c), item)

    update = add

    def add_many(self, items: list) -> None:
        """Batched insert with per-item add() semantics."""
        key_fn, triple = self._key_fn, self._triple
        entries = []
        for item in items:
            a, b, c = triple(item)
            entries.append((key_fn(item), float(a), float(b), float(c),
                            item))
        self._core.push_many(entries)

    def add_if_not_present(self, item: Any) -> None:
        if self._key_fn(item) not in self._core:
            self.add(item)

    def delete(self, key: str) -> Optional[Any]:
        return self._core.delete(key)

    def peek(self) -> Optional[Any]:
        return self._core.peek()

    def pop(self) -> Optional[Any]:
        return self._core.pop()

    def pop_many(self, limit: int) -> list[Any]:
        """Batched drain: pops up to `limit` items (the activeQ burst
        prologue)."""
        return self._core.pop_many(limit)
