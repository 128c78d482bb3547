"""Refcounted block manager: physical KV blocks, prefix sharing, COW.

The middle layer of the serving engine (scheduler -> block manager ->
runner). It owns every host-side fact about the physical block pool:

  * a free-list allocator over blocks 1..num_blocks-1 (block 0 is the
    reserved null sink idle decode lanes write into),
  * a reference count per live block, so immutable prompt-prefix blocks
    can be shared by many sequences at once,
  * a content-hash index over FULL immutable prompt blocks, keyed by a
    chain hash (block tokens + everything before them), so two prompts
    that share a prefix resolve to the same physical blocks,
  * copy-on-write policy: `is_writable` says whether a sequence may
    write a block in place (it owns the only reference AND the block is
    not published in the index); otherwise the scheduler must copy the
    block into a private one first.

Freed blocks that are still in the index are not returned to the free
list immediately: they park in an LRU "cached-free" pool and keep their
contents, so a later request with the same prefix still hits — the
serving-side analogue of the paper's hold-state-to-avoid-recomputation
tradeoff. Allocation prefers truly-free blocks and evicts cached-free
blocks LRU-first only under pressure, unregistering them.

Host spill tier: with `host_cache_blocks > 0` and fetch/store callbacks
(ModelRunner.fetch_block / upload_blocks), eviction does not discard a
cached block's payload — it is DEMOTED to a capacity-bounded LRU of host
(numpy) payloads keyed by the same content-hash chain keys. A later
match_prefix that runs off the device chain walks the host continuation,
re-allocates device blocks (only from the truly-free list, never by
evicting — the current match may pin cached blocks), uploads the payloads
batched, and re-registers them under their original keys as cached-free
blocks — so the existing share/COW machinery sees an ordinary prefix hit.
Quantized pools demote (q, scale) verbatim, so a round-trip is exact.

Invariants (property-tested in tests/test_block_manager.py):
  * refcounts are never negative; decref of a dead block raises,
  * a block is never simultaneously free and referenced,
  * free + cached-free + live == num_blocks - 1 (conservation),
  * shared (refcount > 1) or indexed blocks are never `is_writable`,
  * alloc returns None, never a partial grant, when short.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NULL_BLOCK = 0

_ROOT = ("root",)  # parent key of a prompt's first block


class PrefixMatch:
    """Result of matching a prompt against the prefix index.

    full_blocks     physical blocks covering whole 'block_size' chunks
    partial_block   a cached block whose first `partial_len` tokens match
                    the prompt's remainder (the first divergent block —
                    shared copy-on-write), or None
    partial_len     matched tokens inside partial_block
    spilled_tokens  tokens whose blocks sit in the HOST tier continuation
                    past the device chain (only set by probe-mode
                    match_prefix(promote=False); a promoting match revives
                    them into full_blocks instead)
    """

    __slots__ = ("full_blocks", "partial_block", "partial_len",
                 "spilled_tokens")

    def __init__(self, full_blocks: List[int],
                 partial_block: Optional[int], partial_len: int,
                 spilled_tokens: int = 0):
        self.full_blocks = full_blocks
        self.partial_block = partial_block
        self.partial_len = partial_len
        self.spilled_tokens = spilled_tokens

    def tokens(self, block_size: int) -> int:
        return len(self.full_blocks) * block_size + self.partial_len

    def blocks(self) -> List[int]:
        out = list(self.full_blocks)
        if self.partial_block is not None:
            out.append(self.partial_block)
        return out


class BlockAllocator:
    """Refcounted free-list allocator with a prompt-prefix content index.

    `block_size` is only needed for the prefix-cache methods
    (match_prefix / register_prefix); a plain allocator can pass 0.

    `host_cache_blocks` > 0 enables the host spill tier; `fetch_block`
    (block id -> host payload) and `store_blocks` (ids, payloads -> None)
    are the device<->host movement callbacks, normally
    ModelRunner.fetch_block / ModelRunner.upload_blocks.
    """

    def __init__(self, num_blocks: int, block_size: int = 0,
                 obs=None, host_cache_blocks: int = 0,
                 fetch_block=None, store_blocks=None):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved)")
        from repro_torch.serving.observability import NULL_OBS
        self._obs = obs or NULL_OBS
        self._c_allocs = self._obs.counter("blocks_allocated_total")
        self._c_evictions = self._obs.counter("cache_evictions_total")
        self._c_demotions = self._obs.counter("host_demotions_total")
        self._c_revivals = self._obs.counter("host_revivals_total")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        # prefix index state (all keyed by physical block id)
        self._index: Dict[int, int] = {}       # chain key -> block
        self._key: Dict[int, int] = {}         # block -> chain key
        self._parent: Dict[int, Tuple] = {}    # block -> parent chain key
        self._tokens: Dict[int, Tuple[int, ...]] = {}
        self._children: Dict[Tuple, set] = {}  # parent key -> {blocks}
        self._cached: "OrderedDict[int, None]" = OrderedDict()  # LRU ref==0
        # host spill tier: chain key -> (parent key, chunk, payload), LRU
        self.host_cache_blocks = int(host_cache_blocks)
        self._fetch = fetch_block
        self._store = store_blocks
        self._host: "OrderedDict[int, Tuple]" = OrderedDict()
        # telemetry
        self.cache_evictions = 0
        self.host_demotions = 0
        self.host_revivals = 0

    # ------------------------------------------------------------------
    # refcounted alloc / free
    # ------------------------------------------------------------------

    @property
    def num_free(self) -> int:
        """Allocatable blocks (truly free + evictable cached-free)."""
        return len(self._free) + len(self._cached)

    @property
    def num_cached(self) -> int:
        return len(self._cached)

    @property
    def num_spilled(self) -> int:
        """Blocks currently held in the host spill tier."""
        return len(self._host)

    @property
    def num_indexed(self) -> int:
        """Blocks currently published in the prefix index (live shared
        blocks + cached-free ones) — how much reusable prefix the pool
        holds, the telemetry behind the router's affinity signal."""
        return len(self._key)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop n private blocks (refcount 1), or None if short. Evicts
        cached-free blocks LRU-first under pressure — never a partial
        grant."""
        if n < 0:
            raise ValueError(n)
        if n > self.num_free:
            return None
        blocks = []
        for _ in range(n):
            if not self._free:
                victim, _ = self._cached.popitem(last=False)  # LRU
                self._evict(victim, demote=True)
                self._free.append(victim)
                self.cache_evictions += 1
                self._c_evictions.inc()
            b = self._free.pop()
            self._ref[b] = 1
            blocks.append(b)
        self._c_allocs.inc(n)
        return blocks

    def _evict(self, block: int, demote: bool = False) -> None:
        """Unregister `block` and its whole indexed descendant subtree —
        once the chain breaks, descendants can never be matched again.
        Cached-free descendants return to the free list immediately;
        live (still-referenced) ones just lose their registration.
        With `demote` (eviction under allocation pressure), the victim
        and its cached-free descendants spill to the host tier first —
        their chain keys stay intact there, so the subtree remains
        revivable even though the device chain broke."""
        stack = [block]
        while stack:
            b = stack.pop()
            key = self._key.get(b)
            if key is not None:
                stack.extend(self._children.get(key, ()))
                if demote and (b == block or b in self._cached):
                    self._demote(b)
            self._unregister(b)
            if b != block and b in self._cached:
                del self._cached[b]
                self._free.append(b)

    def _demote(self, block: int) -> None:
        """Snapshot a registered block's payload into the host LRU."""
        if (not self.host_cache_blocks or self._fetch is None
                or self._store is None):
            return
        key = self._key.get(block)
        if key is None:
            return
        self._host[key] = (self._parent[block], self._tokens[block],
                           self._fetch(block))
        self._host.move_to_end(key)
        while len(self._host) > self.host_cache_blocks:
            self._host.popitem(last=False)
        self.host_demotions += 1
        self._c_demotions.inc()

    def incref(self, block: int) -> None:
        """Take a reference on a live or cached-free block (sharing)."""
        if block == NULL_BLOCK:
            raise ValueError("cannot reference the reserved null block")
        refs = self._ref.get(block, 0)
        if refs == 0:
            if block not in self._cached:
                raise ValueError(f"incref of free/unowned block {block}")
            del self._cached[block]      # revive from the cached-free pool
        self._ref[block] = refs + 1

    def decref(self, block: int) -> None:
        """Drop a reference; at zero the block goes to the cached-free
        pool if it is indexed, else back to the free list."""
        if block == NULL_BLOCK:
            raise ValueError("cannot free the reserved null block")
        refs = self._ref.get(block, 0)
        if refs <= 0:
            raise ValueError(f"double free / unowned block {block}")
        if refs > 1:
            self._ref[block] = refs - 1
            return
        del self._ref[block]
        if block in self._key:
            self._cached[block] = None
            self._cached.move_to_end(block)
        else:
            self._free.append(block)

    def free(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            self.decref(b)

    def is_writable(self, block: int) -> bool:
        """May the (single) owner write this block in place? False for
        shared blocks and for blocks published in the prefix index —
        those must be copied first (copy-on-write)."""
        if block == NULL_BLOCK:
            return False
        return self._ref.get(block, 0) == 1 and block not in self._key

    # ------------------------------------------------------------------
    # content-hash prefix index
    # ------------------------------------------------------------------

    def _chunk_key(self, parent, chunk: Tuple[int, ...]) -> int:
        return hash((parent, chunk))

    def _lookup(self, parent, chunk: Tuple[int, ...]) -> Optional[int]:
        """Indexed block for (parent chain, exact chunk) or None; hash
        collisions are rejected by comparing the stored tokens."""
        key = self._chunk_key(parent, chunk)
        b = self._index.get(key)
        if b is None:
            return None
        if self._parent.get(b) != parent or self._tokens.get(b) != chunk:
            return None                   # hash collision -> miss
        return b

    def match_prefix(self, tokens: np.ndarray,
                     promote: bool = True) -> PrefixMatch:
        """Longest cached prefix of `tokens`. Full chunks match exactly
        through the chain index; the remainder may partially match the
        first tokens of one more cached block — the first divergent
        block, shareable with COW.

        When the device chain runs out, the host tier is consulted:
        with `promote` (the admission path), a host continuation is
        revived into freshly-allocated device blocks (cached-free,
        re-registered under their original keys) and keeps matching;
        with promote=False (the router's affinity probe) the
        continuation is only counted in `spilled_tokens` — the probe
        takes no references and moves no payloads."""
        if not self.block_size:
            return PrefixMatch([], None, 0)
        toks = [int(t) for t in tokens]
        bs = self.block_size
        parent = _ROOT
        full: List[int] = []
        spilled = 0
        for i in range(len(toks) // bs):
            chunk = tuple(toks[i * bs:(i + 1) * bs])
            b = self._lookup(parent, chunk)
            if b is None and promote and self._revive(parent, toks, i):
                b = self._lookup(parent, chunk)
            if b is None:
                if not promote:
                    spilled = self._host_chain_len(parent, toks, i) * bs
                break
            full.append(b)
            parent = self._chunk_key(parent, chunk)
        if len(full) < len(toks) // bs:   # diverged inside full chunks
            rest = tuple(toks[len(full) * bs:(len(full) + 1) * bs])
        else:
            rest = tuple(toks[len(full) * bs:])
        best, best_len = None, 0
        for cand in self._children.get(parent, ()):
            stored = self._tokens[cand]
            d = 0
            for a, c in zip(rest, stored):
                if a != c:
                    break
                d += 1
            if d > best_len:
                best, best_len = cand, d
        if best is not None and best in full:
            best, best_len = None, 0      # already counted as a full match
        return PrefixMatch(full, best, best_len, spilled)

    def _host_chain_len(self, parent, toks: List[int],
                        start_chunk: int) -> int:
        """Length (in blocks) of the host-tier chain continuing `parent`
        along the prompt's chunks. Read-only (the affinity probe)."""
        bs = self.block_size
        n, p = 0, parent
        for i in range(start_chunk, len(toks) // bs):
            chunk = tuple(toks[i * bs:(i + 1) * bs])
            key = self._chunk_key(p, chunk)
            ent = self._host.get(key)
            if ent is None or ent[0] != p or ent[1] != chunk:
                break
            n += 1
            p = key
        return n

    def _revive(self, parent, toks: List[int], start_chunk: int) -> int:
        """Promote the host-tier chain continuation back into device
        blocks. Allocates only from the truly-free list (never evicts —
        cached-free blocks may belong to the match in progress), uploads
        the payloads in one batched store, and re-registers each block
        under its original chain key as cached-free. Returns #revived."""
        if not self._host or self._store is None:
            return 0
        bs = self.block_size
        found = []                       # (key, parent, chunk, payload)
        p = parent
        for i in range(start_chunk, len(toks) // bs):
            if len(found) >= len(self._free):
                break
            chunk = tuple(toks[i * bs:(i + 1) * bs])
            key = self._chunk_key(p, chunk)
            ent = self._host.get(key)
            if (ent is None or ent[0] != p or ent[1] != chunk
                    or key in self._index):
                break
            found.append((key, p, chunk, ent[2]))
            p = key
        if not found:
            return 0
        blocks = self.alloc(len(found))  # free-list only: n <= len(_free)
        if blocks is None:
            return 0
        self._store(blocks, [f[3] for f in found])
        for b, (key, par, chunk, _) in zip(blocks, found):
            del self._host[key]
            self._index[key] = b
            self._key[b] = key
            self._parent[b] = par
            self._tokens[b] = chunk
            self._children.setdefault(par, set()).add(b)
            self.decref(b)               # indexed -> parks cached-free
            self.host_revivals += 1
            self._c_revivals.inc()
        return len(blocks)

    def share(self, match: PrefixMatch) -> None:
        """Commit a match: take one reference on every matched block
        (revives cached-free blocks). Call before the blocks can be
        evicted by a concurrent alloc."""
        for b in match.blocks():
            self.incref(b)

    def unshare(self, match: PrefixMatch) -> None:
        for b in match.blocks():
            self.decref(b)

    def touch(self, blocks: Sequence[int]) -> None:
        """LRU-touch cached-free blocks (a hit makes them hot)."""
        for b in blocks:
            if b in self._cached:
                self._cached.move_to_end(b)

    def register_prefix(self, tokens: np.ndarray,
                        blocks: Sequence[int]) -> int:
        """Publish a prompt's FULL blocks in the index (after its prefill
        completed). `blocks` are the prompt's physical blocks in table
        order. Chunks already indexed keep their canonical block; the
        sequence's duplicate stays private. Returns #newly indexed."""
        if not self.block_size:
            return 0
        toks = [int(t) for t in tokens]
        bs = self.block_size
        parent = _ROOT
        added = 0
        for i in range(len(toks) // bs):
            chunk = tuple(toks[i * bs:(i + 1) * bs])
            key = self._chunk_key(parent, chunk)
            existing = self._lookup(parent, chunk)
            if existing is None and key not in self._index:
                b = blocks[i]
                if b in self._key:        # already published under a
                    parent = key          # different chain — leave it
                    continue
                self._index[key] = b
                self._key[b] = key
                self._parent[b] = parent
                self._tokens[b] = chunk
                self._children.setdefault(parent, set()).add(b)
                added += 1
            parent = key
        return added

    def _unregister(self, block: int) -> None:
        key = self._key.pop(block, None)
        if key is None:
            return
        self._index.pop(key, None)
        parent = self._parent.pop(block, None)
        self._tokens.pop(block, None)
        kids = self._children.get(parent)
        if kids is not None:
            kids.discard(block)
            if not kids:
                del self._children[parent]

    def reset_prefix_cache(self) -> None:
        """Drop the whole index (host tier included); cached-free blocks
        return to the free list. Live shared blocks stay shared (their
        refcounts are untouched) but are no longer discoverable."""
        for b in list(self._key):
            self._unregister(b)
        while self._cached:
            b, _ = self._cached.popitem(last=False)
            self._free.append(b)
        self._host.clear()
