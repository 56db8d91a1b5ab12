"""Cross-request radix prefix KV cache: trie + LRU pool + lease pins (the
port of `mmlspark_tpu/serve/prefix_cache.py`; the same trie, digests,
policies and `affinity_key`).

At scale, chat traffic is zipf-distributed — shared system prompts,
few-shot templates, and multi-turn re-sends mean most arriving prompt
tokens were already prefilled by an earlier request.  This pool lets the
serving engine keep those finished prefill rows resident and splice them
into new requests so only the novel suffix is prefilled (docs/serving.md
"Prefix reuse & priority lanes").

Layout: a radix trie at `chunk`-token granularity.  Each edge is the
blake2b digest of one chunk's int32 token bytes; each node stores the KV
cache slots for EXACTLY its own chunk (every array sliced `[:, i*C:
(i+1)*C]` on the slot axis), so a prompt sharing k chunks with a
resident prefix shares k nodes — no per-depth duplication, which is what
makes this a radix pool rather than a flat prompt->row map.  A hit walks
the trie to the deepest resident node and returns the per-chunk payloads
in order; the engine concatenates them back into one row and resumes
chunked prefill at the matched offset (chunk-aligned resume is exactly
how `prefill_chunk` already extends a cache mid-prompt).

Payloads are opaque: a tuple over layers of tuples of tensors whose axis
1 is the slot axis — both cache layouts ride through unchanged (2-tuple
model-dtype (B, W, H, dh); 4-tuple int8 with (B, W, H) scale arrays).
Each chunk payload is a `.clone()` of its slots: a torch slice is a view,
and a view would pin the whole prefill cache it came from (so the byte
budget would count 64 slots of a tensor it keeps alive whole, and an
eviction would free nothing) and would change when that cache is later
written in place.  A node owns exactly `numel() * element_size()` bytes
per tensor, which is what `resident_bytes` counts.
Int8 rows compose for free: ~4x more resident prefixes per HBM byte,
and `quantize_kv`'s round-trip idempotency (the max element maps to
exactly 127) means a stored int8 slot re-quantizes byte-identically at
resume finish.

Policies:
  * LRU over CHUNK nodes (one "row" of budget = one chunk of slots):
    every hit bumps its whole path; eviction picks the stalest
    unleased LEAF (interior nodes are pinned by their descendants —
    evicting an ancestor would orphan the child's resume path).
  * Lease pinning: `acquire` leases every node on the hit path until
    `release`, so an in-flight splice can never lose its donor slots
    mid-resume.  An insert that cannot evict (every candidate leased)
    is REFUSED, never forced — `evictions_refused` counts those.
  * First-writer-wins on insert: byte-identical greedy outputs are the
    correctness contract, so a chunk already resident is left alone
    (chunked-vs-whole prefill parity makes the bytes equal anyway).

Thread-safety: one lock around every operation — the engine loop
acquires/inserts while front-end threads scrape `stats()`.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Optional, Sequence

import numpy as np

# digest width for trie edges: 16 bytes of blake2b over the chunk's
# int32 token bytes — collision-safe at any realistic pool size
_DIGEST_SIZE = 16


def _chunk_digest(tokens: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(np.asarray(tokens, dtype=np.int32))
    return hashlib.blake2b(arr.tobytes(),
                           digest_size=_DIGEST_SIZE).digest()


def _payload_nbytes(payload) -> int:
    return sum(t.numel() * t.element_size()
               for layer in payload for t in layer)


class _Node:
    """One resident chunk of KV slots (or the payload-less root)."""

    __slots__ = ("digest", "parent", "children", "payload", "nbytes",
                 "leases", "stamp", "depth")

    def __init__(self, digest: Optional[bytes], parent: Optional["_Node"],
                 depth: int):
        self.digest = digest
        self.parent = parent
        self.children: dict = {}
        self.payload = None
        self.nbytes = 0
        self.leases = 0
        self.stamp = 0
        self.depth = depth


class PrefixHit:
    """A leased longest-prefix match: `rows[i]` holds chunk i's cache
    slots; the lease (on every path node) holds until `release`."""

    __slots__ = ("nodes", "rows", "n_tokens")

    def __init__(self, nodes: list, rows: list, n_tokens: int):
        self.nodes = nodes
        self.rows = rows
        self.n_tokens = n_tokens


class PrefixCache:
    """LRU pool of radix-trie prefix KV rows with lease pinning."""

    def __init__(self, chunk: int, max_rows: int = 64,
                 max_bytes: Optional[int] = None):
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        if max_rows < 1:
            raise ValueError("max_rows must be >= 1")
        self.chunk = int(chunk)
        self.max_rows = int(max_rows)
        self.max_bytes = int(max_bytes) if max_bytes else None
        self._root = _Node(None, None, 0)
        self._lock = threading.Lock()
        self._clock = 0
        self._rows = 0
        self._bytes = 0
        self._hits = 0
        self._hit_tokens = 0
        self._misses = 0
        self._inserts = 0
        self._evictions = 0
        self._evictions_refused = 0

    # -- lookup ----------------------------------------------------------
    def acquire(self, tokens, limit: Optional[int] = None
                ) -> Optional[PrefixHit]:
        """Longest resident prefix of `tokens`, leased.  `limit` caps the
        matchable token count (the engine passes the largest chunk
        multiple strictly inside the prompt, so the resumed prefill
        always recomputes the last prompt position's logits).  Returns
        None — and counts a miss — when not even one chunk matches."""
        arr = np.asarray(tokens, dtype=np.int32).reshape(-1)
        n = len(arr) if limit is None else min(len(arr), int(limit))
        with self._lock:
            node, path = self._root, []
            for i in range(n // self.chunk):
                digest = _chunk_digest(
                    arr[i * self.chunk:(i + 1) * self.chunk])
                child = node.children.get(digest)
                if child is None:
                    break
                path.append(child)
                node = child
            if not path:
                self._misses += 1
                return None
            self._hits += 1
            self._hit_tokens += len(path) * self.chunk
            self._clock += 1
            for nd in path:
                nd.leases += 1
                nd.stamp = self._clock
            return PrefixHit(path, [nd.payload for nd in path],
                             len(path) * self.chunk)

    def release(self, hit: PrefixHit) -> None:
        """Drop the hit's lease (idempotence is the caller's problem:
        release exactly once, after the splice lands or is abandoned)."""
        with self._lock:
            for nd in hit.nodes:
                nd.leases = max(0, nd.leases - 1)

    # -- insert / evict --------------------------------------------------
    def insert(self, tokens, n_tokens: int, row: Sequence) -> dict:
        """Store the first `n_tokens` slots of `row` (a finished prefill
        cache row, slot axis 1) under the prompt's chunk path.
        `n_tokens` must be a chunk multiple strictly inside the real
        prompt.  Returns {"inserted", "evicted", "refused"} — refused
        means an eviction was needed but every candidate was leased (or
        on the insert path), so deeper chunks were skipped."""
        arr = np.asarray(tokens, dtype=np.int32).reshape(-1)
        n = min(int(n_tokens), len(arr))
        inserted = evicted = 0
        refused = False
        with self._lock:
            node, path = self._root, []
            for i in range(n // self.chunk):
                digest = _chunk_digest(
                    arr[i * self.chunk:(i + 1) * self.chunk])
                child = node.children.get(digest)
                if child is None:
                    # owned copies, never views of the caller's cache
                    payload = tuple(
                        tuple(t[:, i * self.chunk:(i + 1) * self.chunk]
                              .clone() for t in layer)
                        for layer in row)
                    nb = _payload_nbytes(payload)
                    freed = self._make_room(nb, protect=path)
                    if freed is None:
                        refused = True
                        self._evictions_refused += 1
                        break
                    evicted += freed
                    child = _Node(digest, node, node.depth + 1)
                    child.payload = payload
                    child.nbytes = nb
                    node.children[digest] = child
                    self._rows += 1
                    self._bytes += nb
                    self._inserts += 1
                    inserted += 1
                self._clock += 1
                child.stamp = self._clock
                path.append(child)
                node = child
        return {"inserted": inserted, "evicted": evicted,
                "refused": refused}

    def _make_room(self, nbytes: int, protect: list) -> Optional[int]:
        """Evict stale leaves until one more `nbytes` chunk fits; None =
        refused (a needed victim was leased or protected).  Caller holds
        the lock."""
        freed = 0
        guard = {id(nd) for nd in protect}
        while (self._rows + 1 > self.max_rows
               or (self.max_bytes is not None
                   and self._bytes + nbytes > self.max_bytes)):
            victim = self._pick_victim(guard)
            if victim is None:
                return None
            victim.parent.children.pop(victim.digest)
            self._rows -= 1
            self._bytes -= victim.nbytes
            self._evictions += 1
            freed += 1
        return freed

    def _pick_victim(self, guard: set) -> Optional[_Node]:
        """Stalest unleased leaf (interior nodes are pinned by resident
        descendants).  Caller holds the lock."""
        best = None
        stack = [self._root]
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            if (nd.payload is not None and not nd.children
                    and nd.leases == 0 and id(nd) not in guard
                    and (best is None or nd.stamp < best.stamp)):
                best = nd
        return best

    # -- fleet affinity --------------------------------------------------
    @staticmethod
    def affinity_key(tokens, chunk: int) -> str:
        """Stable hex key of the FIRST chunk of a prompt — the router
        hashes this onto a replica index so shared-prefix traffic
        concentrates on one pool instead of diluting N ways.  blake2b
        over the raw int32 bytes, never Python `hash()`: the key must
        agree across processes and restarts."""
        arr = np.ascontiguousarray(
            np.asarray(tokens, dtype=np.int32).reshape(-1)[:int(chunk)])
        return hashlib.blake2b(arr.tobytes(), digest_size=8).hexdigest()

    # -- observability ---------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            lookups = self._hits + self._misses
            leases = 0
            stack = [self._root]
            while stack:
                nd = stack.pop()
                stack.extend(nd.children.values())
                if nd.leases and nd.payload is not None:
                    leases += 1
            return {
                "chunk": self.chunk,
                "max_rows": self.max_rows,
                "max_bytes": self.max_bytes,
                "hits": self._hits,
                "hit_tokens": self._hit_tokens,
                "misses": self._misses,
                "hit_rate": self._hits / lookups if lookups else 0.0,
                "resident_rows": self._rows,
                "resident_bytes": self._bytes,
                "leased_rows": leases,
                "inserts": self._inserts,
                "evictions": self._evictions,
                "evictions_refused": self._evictions_refused,
            }
