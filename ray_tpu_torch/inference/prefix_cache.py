"""Radix prefix KV cache bookkeeping for the continuous-batching engine.

The port's own copy of ``ray_tpu/inference/prefix_cache.py`` (pure host
Python). Its path fingerprints are bit-equal to the JAX package's: the
Serve router and the disaggregated tiers (serve/handle.py,
serve/disagg.py) compare them across replicas.

Shared prompts (system prompts, few-shot preambles, resumed streams) would
re-run prefill over the same tokens on every request although the KV they
produce is identical. This module keeps a **token trie over completed
prefills**: each node covers exactly one ``prefill_chunk`` of tokens and
references an immutable KV *block*, a ``prefill_chunk``-aligned span in
the engine's block pool (the engine owns the device memory; this module
owns only the addressing, ref-counts and LRU state).

On admission the scheduler asks for the longest chunk-aligned prefix
already in the trie; the engine then *copies* the matched blocks into the
request's scratch cache instead of running prefill over them. Misses
populate the trie when their prefill completes. The match is capped one
token short of the full prompt so the final chunk always prefills (that
pass samples the request's first token, which is what keeps greedy output
bit-identical hit vs miss).

Blocks are ref-counted: a node matched by an in-flight request stays
pinned until its span has been copied into that request's scratch, so LRU
eviction under block pressure never reuses memory a request is about to
read. Eviction is leaf-only (an interior node's children are unreachable
without it) and strictly LRU over unpinned leaves.

Thread model: every call happens under the engine's step lock; nothing
here locks.
"""

from __future__ import annotations

import hashlib
import itertools
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple


def _roll_fp(parent_fp: int, key: Sequence[int]) -> int:
    """Rolling 64-bit path fingerprint: hash of (parent fingerprint, this
    chunk's tokens as little-endian int32). Two prompts share fingerprint
    ``i`` iff they share their first ``(i+1) * chunk_size`` tokens (modulo
    hash collision), so a flat fingerprint SET answers "how deep does this
    replica's trie cover my prompt" without shipping tokens."""
    h = hashlib.blake2b(digest_size=8)
    h.update(parent_fp.to_bytes(8, "little"))
    h.update(struct.pack(f"<{len(key)}i", *(int(t) for t in key)))
    return int.from_bytes(h.digest(), "little")


def chunk_fingerprints(tokens: Sequence[int], chunk_size: int,
                       max_chunks: Optional[int] = None) -> List[int]:
    """Path fingerprints of a prompt's full chunks: element ``i`` covers
    ``tokens[: (i+1) * chunk_size]``. The router computes these for an
    incoming prompt and intersects them with each replica's published
    summary to find the deepest cluster-wide match (serve/disagg.py)."""
    C = int(chunk_size)
    if C <= 0:
        raise ValueError("chunk_size must be positive")
    n = len(tokens) // C
    if max_chunks is not None:
        n = min(n, max(0, int(max_chunks)))
    fps: List[int] = []
    fp = 0
    for c in range(n):
        fp = _roll_fp(fp, tokens[c * C:(c + 1) * C])
        fps.append(fp)
    return fps


class TrieNode:
    """One ``chunk_size``-token edge of the radix trie. ``block`` is the
    engine-assigned block id whose KV span holds this chunk's keys and
    values; ``pins`` counts in-flight requests that matched through this
    node and have not yet copied it out."""

    __slots__ = ("key", "block", "children", "parent", "pins", "stamp",
                 "fp")

    def __init__(self, key: Optional[Tuple[int, ...]], block: Optional[int],
                 parent: Optional["TrieNode"]):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "TrieNode"] = {}
        self.pins = 0
        self.stamp = 0
        # path fingerprint (root -> this node), the unit the cluster-wide
        # routing summary is built from
        self.fp = 0

    def __repr__(self):
        return (f"TrieNode(block={self.block}, pins={self.pins}, "
                f"children={len(self.children)})")


class RadixPrefixCache:
    """Host-side trie + block-pool accounting.

    chunk_size: tokens per trie node / per block (the engine's
        ``prefill_chunk``: spans stay chunk-aligned, so one fixed span
        shape covers every copy).
    n_blocks: total KV blocks the engine carved out of its block pool
        (``prefix_cache_slots * (max_len // prefill_chunk)``).
    """

    def __init__(self, chunk_size: int, n_blocks: int):
        if chunk_size <= 0:
            raise ValueError("chunk_size must be positive")
        self.chunk_size = int(chunk_size)
        self.n_blocks = int(n_blocks)
        self._free: List[int] = list(range(self.n_blocks))
        self._root = TrieNode(None, None, None)
        self._clock = itertools.count(1)
        self.lookups = 0
        self.hits = 0
        self.tokens_saved = 0
        self.evictions = 0
        self.blocks_cached = 0

    def _child(self, node: TrieNode, tokens: Sequence[int], c: int
               ) -> Optional[TrieNode]:
        C = self.chunk_size
        return node.children.get(
            tuple(int(t) for t in tokens[c * C:(c + 1) * C]))

    def _pin(self, nodes: Sequence[TrieNode]):
        stamp = next(self._clock)
        for n in nodes:
            n.pins += 1
            n.stamp = stamp

    # ------------------------------------------------------------- lookup
    def match(self, tokens: Sequence[int]) -> Tuple[int, List[TrieNode]]:
        """Longest chunk-aligned prefix of ``tokens`` present in the trie,
        capped at ``len(tokens) - 1`` so at least one token always runs
        prefill (the pass that samples the first generated token). Matched
        nodes come back PINNED: the caller must ``release()`` them once
        their spans have been copied out."""
        C = self.chunk_size
        node = self._root
        matched: List[TrieNode] = []
        for c in range(max(0, len(tokens) - 1) // C):
            child = self._child(node, tokens, c)
            if child is None:
                break
            matched.append(child)
            node = child
        self.lookups += 1
        if matched:
            self.hits += 1
            self.tokens_saved += len(matched) * C
            self._pin(matched)
        return len(matched) * C, matched

    def release(self, nodes: Sequence[TrieNode]):
        """Unpin a match (the spans are copied, eviction may proceed)."""
        for n in nodes:
            if n.pins > 0:
                n.pins -= 1

    def peek(self, tokens: Sequence[int]) -> int:
        """Longest capped match length WITHOUT pinning, LRU touch, or
        hit/lookup accounting: the read the disaggregated admission path
        and routing decisions use (``match`` is for admissions that will
        copy the blocks out)."""
        node = self._root
        depth = 0
        for c in range(max(0, len(tokens) - 1) // self.chunk_size):
            child = self._child(node, tokens, c)
            if child is None:
                break
            node = child
            depth += 1
        return depth * self.chunk_size

    def walk(self, tokens: Sequence[int], n_chunks: int) -> List[TrieNode]:
        """PINNED nodes for the first ``n_chunks`` chunks of ``tokens``
        present in the trie (contiguous from the root, no one-token-short
        cap, no hit/lookup stats): the KV-export path copies each node's
        block out of the pool and then ``release()``s. Unlike ``match``
        this may cover the whole prompt: the importing engine applies its
        own admission cap."""
        node = self._root
        out: List[TrieNode] = []
        for c in range(max(0, int(n_chunks))):
            child = self._child(node, tokens, c)
            if child is None:
                break
            out.append(child)
            node = child
        if out:
            self._pin(out)
        return out

    def covered_fp(self, tokens: Sequence[int], n_chunks: int
                   ) -> Optional[int]:
        """The path fingerprint of the DEEPEST trie node covering the
        first ``n_chunks`` chunks of ``tokens`` (None when even the first
        chunk is absent). The KV-fabric export path proves a peer's
        requested fingerprint against the live trie with it: a published
        summary is a snapshot and can name blocks evicted since. Stat-free
        and unpinned (the following ``walk`` pins)."""
        node = self._root
        fp = None
        for c in range(max(0, int(n_chunks))):
            child = self._child(node, tokens, c)
            if child is None:
                break
            fp = child.fp
            node = child
        return fp

    def summary(self, top_k: int = 128) -> Dict[str, Any]:
        """Compact trie summary for cluster-wide prefix routing: the
        ``top_k`` most recently touched nodes' path fingerprints, the
        chunk size they were computed at and the blocks cached. No tokens
        leave the replica; the payload is ~8 bytes per cached chunk."""
        rows: List[Tuple[int, int]] = []
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            rows.append((n.stamp, n.fp))
            stack.extend(n.children.values())
        rows.sort(reverse=True)
        return {"fps": [fp for _, fp in rows[:max(0, int(top_k))]],
                "chunk": self.chunk_size,
                "blocks": self.blocks_cached}

    # ------------------------------------------------------------- insert
    def insert(self, tokens: Sequence[int]) -> List[Tuple[int, int]]:
        """Extend the trie over every FULL chunk of ``tokens``. Returns
        ``[(token_offset, block_id), ...]`` for the newly created nodes:
        the caller must fill each block with the KV span at that offset
        before the next engine step. Chunks already present are skipped
        (their KV is identical by construction). Stops at the first chunk
        for which no block can be allocated: the trie only ever holds
        contiguous-from-root prefixes."""
        C = self.chunk_size
        node = self._root
        created: List[Tuple[int, int]] = []
        path: List[TrieNode] = []
        try:
            for c in range(len(tokens) // C):
                child = self._child(node, tokens, c)
                if child is None:
                    block = self._alloc()
                    if block is None:
                        break
                    key = tuple(int(t) for t in tokens[c * C:(c + 1) * C])
                    child = TrieNode(key, block, node)
                    child.fp = _roll_fp(node.fp, key)
                    node.children[key] = child
                    self.blocks_cached += 1
                    created.append((c * C, block))
                # pin the walked path so a later alloc in THIS insert can
                # never evict a node it just created or relies on
                child.pins += 1
                path.append(child)
                child.stamp = next(self._clock)
                node = child
        finally:
            for n in path:
                n.pins -= 1
        return created

    # ----------------------------------------------------------- eviction
    def _alloc(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        victim = self._lru_unpinned_leaf()
        if victim is None:
            return None
        if victim.parent is not None:
            victim.parent.children.pop(victim.key, None)
        victim.parent = None
        self.blocks_cached -= 1
        self.evictions += 1
        return victim.block

    def _lru_unpinned_leaf(self) -> Optional[TrieNode]:
        best: Optional[TrieNode] = None
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif n.pins == 0 and (best is None or n.stamp < best.stamp):
                best = n
        return best

    # -------------------------------------------------------------- stats
    def __len__(self) -> int:
        return self.blocks_cached

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def stats(self) -> Dict[str, Any]:
        return {
            "prefix_lookups": self.lookups,
            "prefix_hits": self.hits,
            "prefix_hit_rate": round(self.hit_rate, 4),
            "prefix_tokens_saved": self.tokens_saved,
            "prefix_blocks_cached": self.blocks_cached,
            "prefix_blocks_free": len(self._free),
            "prefix_evictions": self.evictions,
        }
