"""Node-level store: the metadata/telemetry/decision broker (paper §4.1).

The prototype in the paper uses Redis per node.  This reproduction provides an
in-process store with the same API surface (hashes, atomic check-and-set,
pub/sub) so the two control levels never synchronise directly: component
controllers push metrics and local observations; the global controller writes
policy updates; consumers poll or subscribe asynchronously.

The store is deliberately *not* aware of futures or agents — it moves opaque
dicts, exactly like the Redis deployment would.

Change tracking: every mutation advances a store-wide sequence number, and a
per-prefix *delta index* answers "which keys under this prefix moved since
cursor C" in O(changed) — the primitive the global controller's incremental
view collection is built on (Fig. 10 at the 131K-future scale).  The index is
single-consumer per prefix: calling ``scan_changed(prefix, c)`` acknowledges
every delta at or below ``c``, letting the index compact itself down to the
churn between consecutive scans.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Any, Callable, Dict, List, Tuple


class _PrefixIndex:
    """Delta index for one key prefix: live key set + pending change/delete
    journals keyed by store sequence number.  All access under the store lock."""

    __slots__ = ("prefix", "live", "changed", "deleted")

    def __init__(self, prefix: str, live_keys: List[str], seq: int) -> None:
        self.prefix = prefix
        self.live = set(live_keys)
        # key -> seq of its latest unacknowledged change (coalesced: N writes
        # to one key between scans cost one journal entry)
        self.changed: Dict[str, int] = {k: seq for k in live_keys}
        self.deleted: Dict[str, int] = {}

    def touch(self, key: str, seq: int) -> None:
        self.live.add(key)
        self.changed[key] = seq
        self.deleted.pop(key, None)

    def drop(self, key: str, seq: int) -> None:
        if key in self.live:
            self.live.discard(key)
            self.changed.pop(key, None)
            self.deleted[key] = seq


class NodeStore:
    """One per node.  Thread-safe; all operations O(1)/O(fields)."""

    def __init__(self, node_id: str) -> None:
        self.node_id = node_id
        self._lock = threading.RLock()
        self._hashes: Dict[str, Dict[str, Any]] = defaultdict(dict)
        self._subs: Dict[str, List[Callable[[str, Any], None]]] = defaultdict(list)
        # monotonically increasing version per key, for cheap change detection
        self._versions: Dict[str, int] = defaultdict(int)
        # store-wide mutation sequence (delta-scan cursor space) and the
        # registered per-prefix delta indexes
        self._seq = 0
        self._indexes: Dict[str, _PrefixIndex] = {}
        # mutating calls served (benchmarks derive pushes-per-round from this)
        self.write_ops = 0

    # -------------------------------------------------------- change tracking
    def _touch_locked(self, key: str) -> None:
        """Record a write to ``key``.  Caller holds the lock."""
        self._seq += 1
        self._versions[key] += 1
        self.write_ops += 1
        for idx in self._indexes.values():
            if key.startswith(idx.prefix):
                idx.touch(key, self._seq)

    def _drop_locked(self, key: str) -> None:
        """Record the deletion of ``key``.  Caller holds the lock."""
        self._seq += 1
        self._versions[key] += 1
        self.write_ops += 1
        for idx in self._indexes.values():
            if key.startswith(idx.prefix):
                idx.drop(key, self._seq)

    def _ensure_index_locked(self, prefix: str) -> _PrefixIndex:
        idx = self._indexes.get(prefix)
        if idx is None:
            # one-time O(total keys) seeding; every key reads as changed at
            # the current sequence so a cursor-0 scan returns the full set
            live = [k for k in self._hashes if k.startswith(prefix)]
            idx = _PrefixIndex(prefix, live, self._seq)
            self._indexes[prefix] = idx
        return idx

    def cursor(self) -> int:
        """Current change-sequence high-water mark.  A consumer that just
        rebuilt its state from a full ``keys()`` scan should resume delta
        scanning from here."""
        with self._lock:
            return self._seq

    def scan_changed(self, prefix: str,
                     since_cursor: int = 0) -> Tuple[List[str], List[str], int]:
        """Delta scan: ``(changed_keys, deleted_keys, new_cursor)`` for every
        key under ``prefix`` that moved after ``since_cursor``.

        O(churn since the previous scan), not O(keys under the prefix): the
        journal coalesces repeated writes per key, and every scan *drains*
        it — entries above the cursor are returned, entries at or below it
        are acknowledged, and both are compacted away, so the next scan pays
        only for what moved in between (a full-rebuild consumer resets the
        journal just by scanning and discarding).  Single consumer per
        prefix — the global controller owns these cursors; side readers must
        use ``keys()``/``hgetall_many`` instead.
        """
        with self._lock:
            idx = self._ensure_index_locked(prefix)
            changed = [k for k, s in idx.changed.items() if s > since_cursor]
            deleted = [k for k, s in idx.deleted.items() if s > since_cursor]
            idx.changed.clear()
            idx.deleted.clear()
            return changed, deleted, self._seq

    # ---------------------------------------------------------------- hashes
    def hset(self, key: str, field: str, value: Any) -> None:
        with self._lock:
            self._hashes[key][field] = value
            self._touch_locked(key)
            subs = list(self._subs.get(key, ()))
        for fn in subs:
            fn(field, value)

    def hset_many(self, key: str, mapping: Dict[str, Any]) -> None:
        with self._lock:
            self._hashes[key].update(mapping)
            self._touch_locked(key)
            subs = list(self._subs.get(key, ()))
        for fn in subs:
            for f, v in mapping.items():
                fn(f, v)

    def hget(self, key: str, field: str, default: Any = None) -> Any:
        with self._lock:
            return self._hashes.get(key, {}).get(field, default)

    def hgetall(self, key: str) -> Dict[str, Any]:
        with self._lock:
            return dict(self._hashes.get(key, {}))

    def hgetall_many(self, keys: List[str],
                     chunk: int = 2048) -> Dict[str, Dict[str, Any]]:
        """Batched ``hgetall``: one lock acquisition per ``chunk`` keys
        instead of one per key (the collect path reads thousands of mirrors
        per round).  Missing keys are omitted from the result."""
        out: Dict[str, Dict[str, Any]] = {}
        for i in range(0, len(keys), chunk):
            with self._lock:
                for k in keys[i:i + chunk]:
                    h = self._hashes.get(k)
                    if h is not None:
                        out[k] = dict(h)
        return out

    def hdel(self, key: str, field: str) -> bool:
        with self._lock:
            h = self._hashes.get(key)
            if h and field in h:
                del h[field]
                self._touch_locked(key)
                return True
            return False

    def delete(self, key: str) -> None:
        with self._lock:
            self._hashes.pop(key, None)
            self._drop_locked(key)

    def delete_many(self, keys: List[str], chunk: int = 2048) -> None:
        """Batched ``delete`` (future-table GC scrubs mirrors in cohorts)."""
        for i in range(0, len(keys), chunk):
            with self._lock:
                for k in keys[i:i + chunk]:
                    self._hashes.pop(k, None)
                    self._drop_locked(k)

    def keys(self, prefix: str = "") -> List[str]:
        """All keys under ``prefix``.  Backed by the delta index when one is
        registered (O(matching)); otherwise the key set is snapshotted under
        the lock and filtered outside it, so concurrent writers never wait on
        a full-map sweep."""
        with self._lock:
            idx = self._indexes.get(prefix)
            if idx is not None:
                return list(idx.live)
            snapshot = list(self._hashes)
        if not prefix:
            return snapshot
        return [k for k in snapshot if k.startswith(prefix)]

    def version(self, key: str) -> int:
        with self._lock:
            return self._versions.get(key, 0)

    # --------------------------------------------------- atomic check-and-set
    def cas(self, key: str, field: str, expect: Any, value: Any) -> bool:
        """Atomically set ``field`` to ``value`` iff it currently == expect."""
        with self._lock:
            cur = self._hashes.get(key, {}).get(field)
            if cur != expect:
                return False
            self._hashes[key][field] = value
            self._touch_locked(key)
            return True

    def incr(self, key: str, field: str, amount: float = 1) -> float:
        with self._lock:
            cur = self._hashes[key].get(field, 0)
            new = cur + amount
            self._hashes[key][field] = new
            self._touch_locked(key)
            return new

    # ---------------------------------------------------------------- pubsub
    def subscribe(self, key: str, fn: Callable[[str, Any], None]) -> None:
        with self._lock:
            self._subs[key].append(fn)

    def unsubscribe(self, key: str, fn: Callable[[str, Any], None]) -> None:
        with self._lock:
            if fn in self._subs.get(key, []):
                self._subs[key].remove(fn)


class StoreCluster:
    """Directory of per-node stores.

    In the real deployment each node's store is a local Redis and the global
    controller reaches them over the network; here the directory hands out
    references.  ``fetch_latency`` lets benchmarks model the network RTT the
    paper measures in Fig. 10 ("collecting state for 1,024 futures from 64
    nodes takes 76 ms").
    """

    def __init__(self) -> None:
        self._stores: Dict[str, NodeStore] = {}
        self._lock = threading.Lock()

    def get(self, node_id: str) -> NodeStore:
        with self._lock:
            if node_id not in self._stores:
                self._stores[node_id] = NodeStore(node_id)
            return self._stores[node_id]

    def nodes(self) -> List[str]:
        with self._lock:
            return list(self._stores)

    def all_stores(self) -> List[NodeStore]:
        with self._lock:
            return list(self._stores.values())
