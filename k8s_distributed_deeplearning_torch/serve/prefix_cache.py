"""Prefix-reuse KV cache: a token-block trie over pool PAGE IDS with LRU
eviction under a byte budget.

The port's own copy of ``k8s_distributed_deeplearning_tpu/serve/
prefix_cache.py``. Each edge is a tuple of exactly ``block_tokens`` token
ids, so a node at depth d caches the KV of the first ``d * block_tokens``
tokens of any prompt that reaches it; the trie's block is the pool's page,
and a node holds a page id (one pool reference, taken by the engine's
``page_for_block`` callback at insert), never tensors. A hit MAPS the
node's page into the requesting slot's block table: a host int copy and a
``pool.ref``, no device copy. RoPE enters K at projection time at absolute
positions, so the cached K of positions [s, s + block) is valid for any
prompt sharing those tokens at those offsets, which trie membership means.

Eviction is LRU over LEAF nodes only (an interior node's descendants
extend its prefix) under ``capacity_bytes``. A node pinned by an admission
in progress (``refs > 0``) is never evicted: the engine acquires the
matched path at lookup and releases it once the pages are mapped into the
slot's table. Evicting calls ``release_page`` (the engine derefs the
page), so a page still mapped by a slot lives on. Every node costs
``block_nbytes``, charged at insert and refunded at evict:
``used_bytes == sum(node.nbytes)`` always.
"""
from __future__ import annotations

import itertools
from typing import Callable, Sequence


class _Node:
    """One cached block: ``key`` its token tuple, ``page`` the pool page
    holding its KV (the trie owns one pool reference on it)."""

    __slots__ = ("key", "parent", "children", "page", "nbytes", "refs",
                 "last_used")

    def __init__(self, key, parent, page, nbytes, stamp):
        self.key = key
        self.parent = parent
        self.children: dict[tuple, "_Node"] = {}
        self.page = page
        self.nbytes = nbytes
        self.refs = 0
        self.last_used = stamp


class PrefixCache:
    """Token-block trie of pool page ids with refcounts and LRU eviction.

    ``capacity_bytes <= 0`` builds an always-empty cache (every insert is
    refused before it takes a page reference). ``block_nbytes`` (> 0) is
    the engine's byte cost of one block over every cache tensor;
    ``release_page`` is called with an evicted node's page id.
    """

    def __init__(self, capacity_bytes: int, block_tokens: int = 32,
                 block_nbytes: int | None = None,
                 release_page: Callable[[int], None] | None = None):
        if block_tokens < 1:
            raise ValueError(
                f"block_tokens must be >= 1, got {block_tokens}")
        if block_nbytes is None or block_nbytes <= 0:
            raise ValueError(
                f"block_nbytes is required and must be > 0, got "
                f"{block_nbytes} — the engine computes it from the cache "
                "leaf shapes so fit tests never touch device arrays")
        self.capacity_bytes = int(capacity_bytes)
        self.block_tokens = int(block_tokens)
        self.block_nbytes = int(block_nbytes)
        self.release_page = release_page or (lambda page: None)
        self.used_bytes = 0
        self._root = _Node(None, None, None, 0, -1)
        self._nodes: list[_Node] = []
        self._clock = itertools.count()
        self._evicted_pending = 0
        # Monotonic counters.
        self.hits = 0                  # lookups that matched >= 1 block
        self.misses = 0
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.evictions = 0             # blocks evicted
        self.inserted_blocks = 0
        self.skipped_blocks = 0        # insert candidates that did not fit

    def __len__(self) -> int:
        return len(self._nodes)

    def _key(self, tokens: Sequence[int], i: int) -> tuple:
        b = self.block_tokens
        return tuple(int(t) for t in tokens[i * b:(i + 1) * b])

    def acquire(self, tokens: Sequence[int],
                max_tokens: int | None = None) -> tuple[int, list[_Node]]:
        """Longest cached prefix of *tokens* in whole blocks, capped at
        ``max_tokens`` (default ``len(tokens) - 1``: at least one prompt
        token is always prefilled, so the engine has logits to sample the
        first output token from). Pins and LRU-touches every matched node.
        Returns ``(hit_tokens, pinned_nodes)``; the caller must
        :meth:`release` the nodes once their pages are mapped."""
        limit = len(tokens) - 1 if max_tokens is None else max_tokens
        node, nodes, pos, i = self._root, [], 0, 0
        while pos + self.block_tokens <= limit:
            child = node.children.get(self._key(tokens, i))
            if child is None:
                break
            child.refs += 1
            child.last_used = next(self._clock)
            nodes.append(child)
            node, pos, i = child, pos + self.block_tokens, i + 1
        if pos:
            self.hits += 1
        else:
            self.misses += 1
        self.hit_tokens += pos
        self.lookup_tokens += len(tokens)
        return pos, nodes

    def release(self, nodes: list[_Node]) -> None:
        for nd in nodes:
            if nd.refs <= 0:
                raise RuntimeError("release() without a matching acquire()")
            nd.refs -= 1

    def insert(self, tokens: Sequence[int],
               page_for_block: Callable[[int], int]) -> tuple[int, int]:
        """Insert every whole block of *tokens* not cached yet, calling
        ``page_for_block(i)`` (-> a pool page id with one reference already
        taken for the trie) for NEW blocks only; present blocks are
        LRU-touched. The fit test, and any eviction it forces, runs before
        the callback, so a block that cannot fit never takes a reference;
        the walk stops there (a child without its parent chain would be
        unreachable). Returns ``(new_blocks, evicted_blocks)``."""
        node, new = self._root, 0
        for i in range(len(tokens) // self.block_tokens):
            key = self._key(tokens, i)
            child = node.children.get(key)
            if child is None:
                if not self._make_room(self.block_nbytes):
                    self.skipped_blocks += 1
                    break
                page = page_for_block(i)
                child = _Node(key, node, page, self.block_nbytes,
                              next(self._clock))
                node.children[key] = child
                self._nodes.append(child)
                self.used_bytes += self.block_nbytes
                self.inserted_blocks += 1
                new += 1
            else:
                child.last_used = next(self._clock)
            node = child
        return new, self._drain_evicted()

    def _make_room(self, need: int) -> bool:
        """Evict LRU unpinned leaves until *need* bytes fit; False when
        they cannot (budget too small, or all that is left is pinned)."""
        if need > self.capacity_bytes:
            return False
        while self.used_bytes + need > self.capacity_bytes:
            if not self.evict_lru_unpinned():
                return False
        return True

    def evict_lru_unpinned(self) -> bool:
        """Evict the least recently used unpinned LEAF, releasing its page
        reference; False when nothing is evictable. Also the engine's
        valve under pool pressure: admission evicts trie-only pages one at
        a time until a request fits or the trie runs dry."""
        victim = None
        for nd in self._nodes:
            if nd.children or nd.refs > 0:
                continue
            if victim is None or nd.last_used < victim.last_used:
                victim = nd
        if victim is None:
            return False
        self._evict(victim)
        return True

    def _evict(self, node: _Node) -> None:
        del node.parent.children[node.key]
        self._nodes.remove(node)
        self.used_bytes -= node.nbytes
        self.release_page(node.page)
        node.page = None
        self.evictions += 1
        self._evicted_pending += 1

    def _drain_evicted(self) -> int:
        n = self._evicted_pending
        self._evicted_pending = 0
        return n

    def counters(self) -> dict:
        return {
            "blocks": len(self._nodes),
            "used_bytes": self.used_bytes,
            "capacity_bytes": self.capacity_bytes,
            "block_tokens": self.block_tokens,
            "hits": self.hits,
            "misses": self.misses,
            "hit_tokens": self.hit_tokens,
            "lookup_tokens": self.lookup_tokens,
            "evictions": self.evictions,
            "inserted_blocks": self.inserted_blocks,
            "skipped_blocks": self.skipped_blocks,
        }
