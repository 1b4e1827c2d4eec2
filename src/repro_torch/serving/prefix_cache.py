"""Hash-keyed radix prefix cache over the paged quantized KV cache (the
port's copy of `repro.serving.prefix_cache`, pure Python).

At production scale most requests replicate the *same* system-prompt /
few-shot preamble rows.  TransDot's thesis is one shared reconfigurable
datapath replacing FPnew-style replicated lanes; the serving-side mirror
is one shared page pool replacing per-request cache replication — and
prefix sharing completes that move: identical prompt prefixes map onto
the *same* physical pages instead of each request re-prefilling and
re-storing its own copy.  Quantized pages compound the win — a resident
prefix held at format width costs 2–7.5x fewer bytes to keep warm than
an f32 one (`core.kvcache` byte accounting).

Structure — a radix trie at page granularity.  A node is one *full page*
of prompt tokens: its key is the page's token block (a `page_size`-tuple,
hash-keyed through the children dict), its payload the pool page holding
that block's quantized K/V rows for every layer.  A request's prompt
walks the trie block by block from the root; the matched chain's pages
are shared into its block table read-only, and the engine skips the
prefill chunks they cover.

Sharing is safe because of two contracts this module leans on but does
not own:

  refcounts  : `core.kvcache.PageAllocator` counts holders per page.
               The cache itself holds one reference on every node's page
               (taken at `insert`, dropped at eviction), each request
               using the page holds another, and a page only returns to
               the free list at refcount zero — so a shared page is
               never freed or re-handed-out while any block table still
               points at it.
  relayout   : pages hold codes/scales, and attention dequantizes in
               the prologue, so reading a shared page is bit-identical
               to reading a private copy of the same rows.  Sharing is
               pure relayout; a prefix-hit request's greedy outputs are
               bit-identical to the same request served cold
               (`tests/test_torch_serve.py` pins it for the port's
               engine).

Copy-on-write: when a request diverges *inside* a page — its prompt
shares only the first r < page_size rows of a cached block (or simply
ends mid-block) — `match` reports a `cow` source.  The engine copies
those r rows into a private page (`Engine._cow_copy`, pure relayout
again) and the request writes its own divergent rows after them; the
shared source page is never mutated.

Eviction: nodes whose pages have no holder beyond the cache itself
(refcount 1) are cold; under pool pressure `evict` drops the
least-recently-used cold *leaves* first (a parent is always at least as
recently used as any descendant, because every match/insert touches its
whole chain).  Pages in use by a live request (refcount > 1) are pinned.

The scheduler side — taking request references, CoW copies, staging
materialization, skip accounting — lives in `launch.engine`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


class PrefixNode:
    """One cached full page of prompt tokens (a radix-trie edge+node)."""
    __slots__ = ("block", "page", "parent", "children", "last_used")

    def __init__(self, block: tuple, page: int, parent: "PrefixNode"):
        self.block = block           # page_size token ids, the hash key
        self.page = page             # pool page holding the block's rows
        self.parent = parent
        self.children = {}           # block tuple -> PrefixNode
        self.last_used = 0


@dataclasses.dataclass
class PrefixMatch:
    """What `match` found for one prompt.

    pages: fully-shared pages in timeline order (the caller increfs and
    points its block table at them read-only); cow: optional (source
    page, rows) partial tail — the first `rows` of `source page` equal
    the prompt's next tokens, to be copied into a private page; tokens:
    total prompt tokens covered (``page_size * len(pages) + cow rows``),
    i.e. the prefill tokens the engine skips."""
    pages: List[int]
    cow: Optional[Tuple[int, int]]
    tokens: int


class PrefixCache:
    """Radix prefix index over an allocator's page pool.

    The cache holds one allocator reference per node page (taken in
    `insert`, released in `evict`), so cached prefixes stay resident —
    and evictable — independent of the requests that created them."""

    def __init__(self, page_size: int, alloc):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.page_size = page_size
        self.alloc = alloc
        self.root = PrefixNode((), -1, None)     # sentinel, no page
        self.n_nodes = 0
        self._tick = 0                           # LRU clock (match/insert)

    @property
    def n_pages(self) -> int:
        """Pages resident in the cache (one per node)."""
        return self.n_nodes

    def _block(self, tokens, i: int) -> tuple:
        ps = self.page_size
        return tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])

    def match(self, tokens, limit: int) -> PrefixMatch:
        """Longest cached prefix of `tokens`, covering at most `limit`
        tokens (the engine passes ``n_prompt - 1`` so at least one
        prompt token always prefills and yields first-token logits).

        Walks full-page blocks from the root; at the first full-block
        miss (or when fewer than page_size tokens remain under the
        limit) it looks for the child sharing the longest common prefix
        of the partial block — the copy-on-write source.  Touches every
        matched node's LRU stamp."""
        self._tick += 1
        node, pages = self.root, []
        ps = self.page_size
        cap = max(0, min(len(tokens), limit))
        i = 0
        while (i + 1) * ps <= cap:
            child = node.children.get(self._block(tokens, i))
            if child is None:
                break
            child.last_used = self._tick
            pages.append(child.page)
            node = child
            i += 1
        matched = i * ps
        cow = None
        rem = min(cap - matched, ps)
        if rem > 0:
            part = tuple(int(t) for t in tokens[matched:matched + rem])
            best, best_r = None, 0
            for child in node.children.values():
                r = 0
                while r < rem and child.block[r] == part[r]:
                    r += 1
                if r > best_r:
                    best, best_r = child, r
            if best is not None:
                best.last_used = self._tick
                cow = (best.page, best_r)
                matched += best_r
        return PrefixMatch(pages=pages, cow=cow, tokens=matched)

    def insert(self, tokens, pages) -> int:
        """Register a request's full-page prompt blocks after its
        prefill lands (only then do the pages hold the rows).

        `pages` is the request's page list in timeline order; block i
        lives in pages[i].  Existing nodes are kept (first writer wins —
        a concurrent cold duplicate's page simply frees at its finish);
        new nodes take one cache reference on their page.  The partial
        tail block (and any page later shared with generated tokens) is
        never inserted: only pure full-prompt pages are shareable.
        Returns the number of nodes created."""
        self._tick += 1
        node, created = self.root, 0
        n_full = min(len(tokens) // self.page_size, len(pages))
        for i in range(n_full):
            blk = self._block(tokens, i)
            child = node.children.get(blk)
            if child is None:
                child = PrefixNode(blk, int(pages[i]), node)
                node.children[blk] = child
                self.alloc.incref([child.page])
                self.n_nodes += 1
                created += 1
            child.last_used = self._tick
            node = child
        return created

    def evict(self, n: int) -> int:
        """Free up to `n` pages by dropping the coldest zero-external-ref
        leaves (refcount 1 = only the cache holds the page).  Interior
        nodes become leaves as their children go, so repeated eviction
        drains whole cold chains deepest-first.  Returns pages freed."""
        freed = 0
        while freed < n:
            victim = None
            stack = list(self.root.children.values())
            while stack:
                nd = stack.pop()
                stack.extend(nd.children.values())
                if nd.children or self.alloc.refcount(nd.page) != 1:
                    continue                    # interior, or in use
                if victim is None or nd.last_used < victim.last_used:
                    victim = nd
            if victim is None:
                break
            del victim.parent.children[victim.block]
            self.alloc.free([victim.page])      # last holder -> free list
            self.n_nodes -= 1
            freed += 1
        return freed

    def drop_all(self) -> int:
        """Evict every evictable node (shutdown / tests).  Pages still
        referenced by live requests stay resident."""
        return self.evict(self.n_nodes)
