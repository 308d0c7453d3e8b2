"""Block-granular radix (trie) prefix cache over KV pages (copied from
``deepspeed_tpu/inference/v2/prefix_cache.py``).

At internet-scale traffic mixes — shared system prompts, multi-turn
conversation replays — most prefill work is *redundant*: the KV for a
shared prefix is recomputed per request even though identical pages
already sit in the device cache. This module makes those pages reusable:
a trie keyed by full-block token tuples maps a prompt's longest
already-materialized prefix to the device block ids holding its KV, so
admission pins those blocks (refcounted sharing) and only the novel
suffix is prefilled. The same idea as vLLM/SGLang radix-prefix caching,
block-granular because pages are the unit the paged-attention kernel
reads and the unit ``BlockedKVCache`` allocates.

Division of labor (the serving policy and the host tier named below are
the JAX package's ``serving/kv_tier.py`` and ``kv_offload.py``; they come to
the port with the serving-layer slice):

* this module is PURE host bookkeeping — trie walk, refcount pins,
  LRU leaf-first eviction planning. The serve tick consults the trie on
  every admission and rebalance, so nothing here may ever touch a device
  tensor;
* page *contents* stay in ``BlockedKVCache``; the engine
  (``InferenceEngineV2``) decides when to consult/insert/evict and owns
  the device-block release that an eviction triggers;
* serving *policy* — when to evict cached blocks vs demote sequences —
  lives in ``serving/kv_tier.py`` (``plan_prefix_evictions``): under
  pressure, unpinned cached blocks are reclaimed FIRST (free capacity
  nobody is using), live sequences demote second, and a pinned shared
  prefix is the last thing to go — and when its last reader demotes,
  the pages travel to the host tier inside that reader's entry instead
  of being discarded.

Sharing-safety invariant: a cached block only ever holds FULL blocks of
already-materialized KV (tokens < ``seen_tokens``). Writes always land
at ``seen_tokens`` and beyond, and admission caps the reused prefix at
``(len(prompt) - 1) // block_size`` full blocks, so the first novel
token starts a fresh private block — no sequence can ever scatter into
a page another reader is attending over.

Pin invariant: a sequence always pins the FULL root path of the blocks
it reuses or registers, so ``child.refs > 0`` implies
``parent.refs > 0`` — which is what makes leaf-first eviction of
``refs == 0`` nodes safe (an evictable node never has a pinned
descendant) and keeps every cached node reachable by a root walk.
"""

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple


class _TrieNode:
    """One full KV block: ``key`` is the block's token tuple, ``block``
    the device block id holding its (fully materialized) pages."""

    __slots__ = ("key", "block", "refs", "children", "parent", "stamp")

    def __init__(self, key: Tuple[int, ...], block: int,
                 parent: Optional["_TrieNode"], stamp: int):
        self.key = key
        self.block = block
        self.refs = 0
        self.children: Dict[Tuple[int, ...], "_TrieNode"] = {}
        self.parent = parent
        self.stamp = stamp


@dataclasses.dataclass
class PrefixCacheStats:
    """Lifetime counters — the deterministic proof surface bench_serve
    reports (conservation: ``hit_tokens`` is exactly the prefill work the
    engine never ran)."""

    lookups: int = 0
    hits: int = 0                 # lookups that matched >= 1 block
    misses: int = 0
    hit_tokens: int = 0           # tokens whose prefill was skipped
    lookup_tokens: int = 0        # tokens offered to the trie
    inserted_blocks: int = 0
    evicted_blocks: int = 0


class PrefixCache:
    """uid-aware radix cache over device KV blocks. All methods are pure
    host bookkeeping; device-block release happens in
    the engine from the block ids ``evict_blocks`` hands back."""

    def __init__(self, block_size: int, max_cached_blocks: int = 0):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.block_size = block_size
        # soft cap on UNPINNED cached blocks (0 = unlimited): the tick
        # evicts down to it so an idle cache can't squat on the whole pool
        self.max_cached_blocks = max_cached_blocks
        self._root = _TrieNode((), -1, None, 0)
        self._clock = 0
        self._nodes = 0
        self._unpinned = 0
        # uid -> pinned root path (admission match + life-time inserts)
        self._pins: Dict[int, List[_TrieNode]] = {}
        # device block id -> owning node (the "cache owns this block" set
        # the engine's release paths partition against)
        self._owner: Dict[int, _TrieNode] = {}
        self.stats = PrefixCacheStats()

    # ------------------------------------------------------------------
    # introspection (pure; consumed by the serve tick every iteration)
    # ------------------------------------------------------------------
    def cached_blocks(self) -> int:
        return self._nodes

    def pinned_blocks(self) -> int:
        return self._nodes - self._unpinned

    def evictable_blocks(self) -> int:
        """Blocks reclaimable on demand (refs == 0). By the pin
        invariant an unpinned node's whole subtree is unpinned, so every
        one of these is reachable by leaf-first eviction."""
        return self._unpinned

    def owns(self, block: int) -> bool:
        return block in self._owner

    def pinned_block_ids(self) -> List[int]:
        """Block ids with refcount > 0 — the set ``BlockedKVCache.release``
        must skip (neither freed nor scale-reset) while readers remain."""
        return [b for b, n in self._owner.items() if n.refs > 0]

    # ------------------------------------------------------------------
    # lookup / pin (the admission path)
    # ------------------------------------------------------------------
    def _keys(self, tokens: Sequence[int], nblocks: int):
        bs = self.block_size
        for i in range(nblocks):
            yield tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])

    def lookup(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached prefix of ``tokens`` in FULL blocks, capped at
        ``(len(tokens) - 1) // block_size`` so at least the last prompt
        token is always computed (its logits seed the first sample) and
        the first novel write starts a fresh block. Returns (block ids,
        matched token count) WITHOUT pinning — ``admit_match`` pins."""
        self._clock += 1
        self.stats.lookups += 1
        self.stats.lookup_tokens += len(tokens)
        limit = max(len(tokens) - 1, 0) // self.block_size
        node = self._root
        blocks: List[int] = []
        for key in self._keys(tokens, limit):
            child = node.children.get(key)
            if child is None:
                break
            child.stamp = self._clock
            blocks.append(child.block)
            node = child
        matched = len(blocks) * self.block_size
        if blocks:
            self.stats.hits += 1
            self.stats.hit_tokens += matched
        else:
            self.stats.misses += 1
        return blocks, matched

    def admit_match(self, uid: int, tokens: Sequence[int]
                    ) -> Tuple[List[int], int]:
        """``lookup`` + pin the matched root path for ``uid``. The block
        ids come back in prefix order, ready to seed the sequence's block
        table."""
        blocks, matched = self.lookup(tokens)
        if blocks:
            node = self._root
            pins = self._pins.setdefault(uid, [])
            for key in self._keys(tokens, len(blocks)):
                node = node.children[key]
                self._pin(node, pins)
        return blocks, matched

    def _pin(self, node: _TrieNode, pins: List[_TrieNode]) -> None:
        if node.refs == 0:
            self._unpinned -= 1
        node.refs += 1
        pins.append(node)

    # ------------------------------------------------------------------
    # insertion (prefill completion + flush-time absorption)
    # ------------------------------------------------------------------
    def insert_from_seq(self, uid: int, tokens: Sequence[int],
                        seq_blocks: Sequence[int], seen_tokens: int,
                        pin: bool = True) -> int:
        """Register ``uid``'s fully-materialized full blocks (tokens
        ``< seen_tokens``) in the trie. Existing nodes are kept (first
        writer wins; a duplicate private block stays private and is
        released at flush); novel blocks transfer ownership to the
        cache. With ``pin=True`` the whole walked path is pinned for
        ``uid`` (the pin invariant); ``pin=False`` is the flush-time
        absorb, leaving new nodes immediately evictable. Returns the
        number of blocks newly registered."""
        self._clock += 1
        full = min(seen_tokens, len(tokens)) // self.block_size
        full = min(full, len(seq_blocks))
        node = self._root
        pins = self._pins.setdefault(uid, []) if pin else None
        added = 0
        for i, key in enumerate(self._keys(tokens, full)):
            child = node.children.get(key)
            if child is None:
                block = int(seq_blocks[i])
                if block in self._owner:
                    # one physical block cannot back two trie nodes —
                    # this arises only if a caller re-absorbs a path the
                    # cache already owns under different tokens (a
                    # bookkeeping bug upstream); refuse to corrupt
                    break
                child = _TrieNode(key, block, node, self._clock)
                node.children[key] = child
                self._owner[block] = child
                self._nodes += 1
                self._unpinned += 1
                added += 1
                self.stats.inserted_blocks += 1
            child.stamp = self._clock
            # pin each path node once per uid (refcounts are per reader,
            # not per visit — re-walking a path must not double-pin)
            if pins is not None and child not in pins:
                self._pin(child, pins)
            node = child
        return added

    # ------------------------------------------------------------------
    # release (flush / demotion)
    # ------------------------------------------------------------------
    def release_seq(self, uid: int) -> None:
        """Drop every pin ``uid`` holds. Blocks whose refcount reaches 0
        STAY cached (evictable) — that retention is the whole point: the
        next request with the same prefix reuses them."""
        for node in self._pins.pop(uid, ()):
            node.refs -= 1
            if node.refs == 0:
                self._unpinned += 1

    # ------------------------------------------------------------------
    # eviction (LRU, leaf-first; planner pure, release in the engine)
    # ------------------------------------------------------------------
    def plan_evictions(self, want: int) -> List[int]:
        """Up to ``want`` block ids to reclaim, oldest-stamp leaves
        first. Only ``refs == 0`` nodes whose children are all also
        selected qualify, so a selected set is always removable without
        orphaning a reachable node. One tree walk + a priority queue
        (Kahn over the child counts, min ``(stamp, block)`` first) —
        O(M log M) in cached nodes, never O(want x M): this plans on the
        serve tick. Pure planning — call ``evict_blocks`` to commit."""
        if want <= 0 or self._unpinned == 0:
            return []
        # one DFS: count each unpinned node's children (pin invariant:
        # an unpinned node's whole subtree is unpinned, so every child
        # of a candidate is itself a candidate or pinned-free)
        pending: Dict[int, int] = {}
        by_id: Dict[int, _TrieNode] = {}
        heap: List[Tuple[int, int, int]] = []
        stack = [self._root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                stack.append(child)
                if child.refs != 0:
                    continue
                pending[id(child)] = len(child.children)
                by_id[id(child)] = child
                if not child.children:
                    heapq.heappush(heap, (child.stamp, child.block,
                                          id(child)))
        out: List[int] = []
        while heap and len(out) < want:
            _stamp, block, nid = heapq.heappop(heap)
            out.append(block)
            parent = by_id[nid].parent
            if parent is None or id(parent) not in pending:
                continue
            pending[id(parent)] -= 1
            if pending[id(parent)] == 0:
                # all children selected: the parent becomes a leaf
                heapq.heappush(heap, (parent.stamp, parent.block,
                                      id(parent)))
        return out

    def evict_blocks(self, blocks: Sequence[int]) -> List[int]:
        """Commit an eviction plan: detach the nodes and forget the
        blocks. Returns the block ids actually evicted (pinned or
        unknown ids are skipped defensively) — the engine releases these
        to the allocator."""
        out: List[int] = []
        for b in blocks:
            node = self._owner.get(b)
            if node is None or node.refs > 0 or node.children:
                continue
            parent = node.parent
            if parent is not None:
                parent.children.pop(node.key, None)
            del self._owner[b]
            self._nodes -= 1
            self._unpinned -= 1
            self.stats.evicted_blocks += 1
            out.append(b)
        return out

    def over_cap_blocks(self) -> int:
        """How many unpinned blocks exceed ``max_cached_blocks`` (0 when
        uncapped) — the per-tick trim the serve policy applies even
        without pressure."""
        if self.max_cached_blocks <= 0:
            return 0
        return max(self._unpinned - self.max_cached_blocks, 0)

    # ------------------------------------------------------------------
    # export (drain-time handoff walk — NOT a hot path)
    # ------------------------------------------------------------------
    def chains(self) -> List[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
        """Every root-to-leaf path as ``(token tuple, block ids)`` — the
        drain-time export surface for fleet prefix handoff. Leaves only:
        an interior node's tokens/blocks are a prefix of each descendant
        leaf's, so leaf chains carry the whole trie without duplication
        (the importer re-splits them block-by-block). Offline by
        contract (retirement), never on the serve tick."""
        out: List[Tuple[Tuple[int, ...], Tuple[int, ...]]] = []
        stack: List[Tuple[_TrieNode, Tuple[int, ...], Tuple[int, ...]]] = [
            (self._root, (), ())]
        while stack:
            node, tokens, blocks = stack.pop()
            if node is not self._root:
                tokens = tokens + node.key
                blocks = blocks + (node.block,)
                if not node.children:
                    out.append((tokens, blocks))
            for child in node.children.values():
                stack.append((child, tokens, blocks))
        return out

    def snapshot(self) -> Dict[str, int]:
        """Counters + occupancy in one dict (the /metrics surface)."""
        s = self.stats
        return {
            "lookups": s.lookups,
            "hits": s.hits,
            "misses": s.misses,
            "hit_tokens": s.hit_tokens,
            "lookup_tokens": s.lookup_tokens,
            "inserted_blocks": s.inserted_blocks,
            "evicted_blocks": s.evicted_blocks,
            "cached_blocks": self._nodes,
            "pinned_blocks": self._nodes - self._unpinned,
            "evictable_blocks": self._unpinned,
        }
