"""Zone-aware node enumeration (reference: internal/cache/node_tree.go:31).

Nodes are grouped by zone; `next()` round-robins across zones so the
scheduler's node walk interleaves failure domains (node_tree.go:165). A full
enumeration of num_nodes names exhausts every zone and resets, so each
scheduling cycle sees the same interleaved order — that order is the node
axis of the device matrix.
"""
from __future__ import annotations

from typing import Optional

from kubernetes_tpu_torch.api.types import Node, get_zone_key


class NodeTree:
    def __init__(self):
        self._tree: dict[str, list[str]] = {}   # zone -> node names
        # zone -> the same names as a set: membership in O(1), so building
        # a tree of N nodes is O(N), not O(N^2)
        self._members: dict[str, set[str]] = {}
        self._zones: list[str] = []             # insertion-ordered zone keys
        self._zone_index = 0
        self._last_index: dict[str, int] = {}   # per-zone cursor
        self._exhausted: set[str] = set()
        self.num_nodes = 0
        self._rotation_cache: Optional[list[int]] = None  # keyed by membership
        # start-zone-index -> full enumeration order (membership-keyed,
        # like the rotation map): a serving loop consumes one enumeration
        # per window against a stable tree, and there are at most
        # len(zones) distinct orders — list_names serves boundary-state
        # enumerations from here instead of walking next() N times
        self._order_cache: dict[int, list[str]] = {}
        # start index of the most recent boundary-state list_names() (None
        # when the last enumeration was mid-state or membership moved):
        # lets the burst driver prove "this enumeration IS
        # order_for_start(r)" in O(1) and keep its device axis stable
        # across rotated windows (cycle 0 rides the rotation program
        # instead of forcing a mirror permute + full re-upload per window)
        self.last_enum_start: Optional[int] = None
        # membership epoch: bumps on add/remove — burst records pin it so a
        # replayed burst can prove the tree it captured is the tree it ran
        self.epoch = 0

    def add_node(self, node: Node) -> None:
        zone = get_zone_key(node)
        names = self._tree.get(zone)
        if names is None:
            names = []
            self._tree[zone] = names
            self._members[zone] = set()
            self._zones.append(zone)
            self._last_index[zone] = 0
        if node.name in self._members[zone]:
            return
        names.append(node.name)
        self._members[zone].add(node.name)
        self.num_nodes += 1
        self._rotation_cache = None
        self._order_cache = {}
        self.last_enum_start = None
        self.epoch += 1

    def remove_node(self, node: Node) -> None:
        zone = get_zone_key(node)
        names = self._tree.get(zone)
        if names is None or node.name not in self._members[zone]:
            return
        names.remove(node.name)
        self._members[zone].discard(node.name)
        self.num_nodes -= 1
        self._rotation_cache = None
        self._order_cache = {}
        self.last_enum_start = None
        self.epoch += 1
        if not names:
            del self._tree[zone]
            del self._members[zone]
            self._zones.remove(zone)
            del self._last_index[zone]
            self._exhausted.discard(zone)
        self._zone_index = 0

    def update_node(self, old: Node, new: Node) -> None:
        if get_zone_key(old) == get_zone_key(new):
            return
        self.remove_node(old)
        self.add_node(new)

    def _reset_exhausted(self) -> None:
        for zone in self._exhausted:
            self._last_index[zone] = 0
        self._exhausted.clear()

    def next(self) -> str:
        """Next node name in zone-interleaved round-robin order."""
        if not self._zones:
            return ""
        while True:
            if len(self._exhausted) == len(self._zones):
                self._reset_exhausted()
            zone = self._zones[self._zone_index]
            self._zone_index = (self._zone_index + 1) % len(self._zones)
            if zone in self._exhausted:
                continue
            idx = self._last_index[zone]
            names = self._tree[zone]
            if idx >= len(names) - 1:
                self._exhausted.add(zone)
            if idx < len(names):
                self._last_index[zone] = idx + 1
                return names[idx]

    def list_names(self) -> list[str]:
        """One full interleaved enumeration — the per-cycle node order.

        At an enumeration BOUNDARY (pristine cursors, or the
        post-enumeration state every full enumeration leaves — the
        scheduling loop's steady state), the order is a pure function of
        the starting zone index, so it is served from the membership-keyed
        order cache and the cursor state advances to exactly what N
        next() calls would leave (cursors at their ends, every zone
        exhausted, zone index at rotation_map()[start]). Mid-enumeration
        states (a consumer that mixed in bare next() calls) keep the
        step-by-step walk."""
        if not self._zones:
            return []
        at_boundary = (len(self._exhausted) == len(self._zones)
                       or (not self._exhausted
                           and not any(self._last_index.values())))
        if not at_boundary:
            self.last_enum_start = None   # mid-state order: not a pure
            return [self.next() for _ in range(self.num_nodes)]
        start = self._zone_index
        order = self._order_cache.get(start)
        if order is None:
            order = self._order_cache[start] = self._simulate(start)[0]
        self._last_index = {z: len(self._tree[z]) for z in self._zones}
        self._exhausted = set(self._zones)
        self._zone_index = self.rotation_map()[start]
        self.last_enum_start = start
        return list(order)

    def all_names(self) -> list[str]:
        """Every member name WITHOUT advancing the enumeration cursor
        (the node-death reconciliation sweep's view)."""
        return [n for ns in self._tree.values() for n in ns]

    # -- rotation structure (device-burst support) ---------------------------
    # A full enumeration's order is determined entirely by the zone index it
    # starts from (cursors reset lazily at the first next() of each
    # enumeration), so there are at most len(zones) distinct per-cycle
    # orders. Burst kernels replay the per-cycle rotation from these.

    def _simulate(self, start: int) -> tuple[list[str], int]:
        """Order + end zone-index of one full enumeration starting at zone
        index `start` with fresh cursors (exact mirror of next())."""
        if not self._zones:
            return [], 0
        z = len(self._zones)
        cursor = {zone: 0 for zone in self._zones}
        exhausted: set[str] = set()
        zi = start
        names: list[str] = []
        while len(names) < self.num_nodes:
            zone = self._zones[zi]
            zi = (zi + 1) % z
            if zone in exhausted:
                continue
            idx = cursor[zone]
            nodes = self._tree[zone]
            if idx >= len(nodes) - 1:
                exhausted.add(zone)
            if idx < len(nodes):
                cursor[zone] = idx + 1
                names.append(nodes[idx])
        return names, zi

    def rotation_map(self) -> list[int]:
        """next_start[r]: the zone index the enumeration AFTER one starting
        at r begins from. next_start[r] == r for all r iff the per-cycle
        order is stable (e.g. equal-size zones). Cached until membership
        changes — burst segments consult this on every launch."""
        if self._rotation_cache is None:
            self._rotation_cache = [
                self._simulate(r)[1] for r in range(max(len(self._zones), 1))]
        return self._rotation_cache

    def order_for_start(self, start: int) -> list[str]:
        return self._simulate(start)[0]

    @property
    def zone_index(self) -> int:
        return self._zone_index

    # -- gang checkpoint/rewind ----------------------------------------------
    def checkpoint(self) -> tuple:
        """Snapshot the enumeration cursor (zone index + per-zone cursors +
        exhausted set). A discarded gang trial restores it so the rotation
        walk replays EXACTLY as if the gang was never attempted — the next
        cycle (gang retry or the singleton behind it) sees the same
        interleaved order either way. Exact across a window with no
        membership changes (the single-threaded scheduling loop's case);
        restore() additionally survives nodes/zones added or REMOVED in
        between (mid-burst node death) by re-grounding the cursor state
        in the current membership."""
        return (self._zone_index, dict(self._last_index),
                set(self._exhausted), self.epoch)

    def restore(self, chk: tuple) -> None:
        zone_index, cursors, exhausted, epoch = chk
        if epoch == self.epoch:
            # membership unchanged: exact cursor replay (the gang/crash
            # rewind contract)
            self._zone_index = zone_index
            self._last_index = dict(cursors)
            self._exhausted = set(exhausted)
            return
        # nodes/zones were added or removed under the checkpoint (mid-burst
        # node death): the recorded cursors describe lists that no longer
        # exist, so exact replay is impossible — re-ground to the
        # post-enumeration state (every zone exhausted, cursors at their
        # ends) so the NEXT enumeration resets and walks the live
        # membership exactly once. The zone index (the rotation cursor) is
        # kept when still valid; a removal already reset it to 0 in both
        # worlds (remove_node), so post-churn rotation stays aligned with
        # a serial oracle that observed the same removal.
        self._last_index = {z: len(self._tree[z]) for z in self._zones}
        self._exhausted = set(self._zones)
        z = max(len(self._zones), 1)
        self._zone_index = zone_index if zone_index < z else 0

    def advance_enumerations(self, count: int) -> None:
        """Fast-forward the tree as if `count` more full enumerations ran.
        Valid only in the post-enumeration state (i.e. after at least one
        full list_names()), where cursors/exhausted are already at their
        end-of-enumeration values and only the zone index walks."""
        if not self._zones or count <= 0:
            return
        nxt = self.rotation_map()
        r = self._zone_index
        seen: dict[int, int] = {}
        walk: list[int] = []
        # the walk over <= z states enters a cycle; close the form
        while count > 0 and r not in seen:
            seen[r] = len(walk)
            walk.append(r)
            r = nxt[r]
            count -= 1
        if count > 0:
            cycle = walk[seen[r]:]
            r = cycle[count % len(cycle)] if cycle else r
        self._zone_index = r
