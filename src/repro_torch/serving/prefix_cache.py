"""Radix-tree prefix cache over KV arena pages.

A copy of the JAX package's ``serving/prefix_cache.py`` (stdlib only;
the port keeps its own so that it imports nothing of that package).
The LRU clock and the eviction order are the same, tick for tick, so
the port's cache evicts the same pages as the JAX package's.

The serving-side traffic that makes in-DRAM bulk ops matter is
prompt-prefix reuse: many requests sharing a system prompt.  Pairwise
sharing makes a request name its source sequence by id
(``share_with=``/``shared_len=``) and do the page arithmetic itself;
this cache makes it global and automatic:

* the tree is a trie whose edges are **token-id pages** — a node's key
  is the exact ``page_size``-token tuple stored in one arena page, so a
  root-to-node path spells a committed prompt prefix and maps it to the
  arena pages holding its KV;
* :meth:`RadixPrefixCache.match` walks the longest full-page prefix of
  a new prompt and returns the arena pages to attach;
* nodes hold their own reference on the underlying page (through the
  owner-supplied ``retain``/``release`` callbacks, which bridge into
  :class:`repro_torch.serving.kv_cache.PagedKVCache` refcounting), so
  an indexed prefix survives the request that created it;
* unreferenced subtrees evict **LRU, leaves first**
  (:meth:`evict_lru`): dropping a leaf releases the tree's reference,
  and when no live sequence shares the page it returns to the allocator
  through the normal init-on-free path (a batched RowClone-Init).

Only *full* pages are indexed — a partial tail page is still writable
(decode appends into it), so sharing it would force CoW on every
append.  Matching therefore advances in whole pages: attaching N pages
stands in for the N-page bulk copy a system without sharing would pay.

The tree never touches device memory itself: it is host-side metadata,
and all page lifetime flows through the owner's refcounts.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple


@dataclass
class _RadixNode:
    """One full token page: ``key`` is the page's token-id tuple (the
    edge label from the parent), ``page`` the arena page holding its
    KV.  ``last_used`` is the LRU clock stamp of the last match/insert
    that walked through this node."""

    key: Tuple[int, ...]
    page: int
    parent: Optional["_RadixNode"]
    children: Dict[Tuple[int, ...], "_RadixNode"] = field(default_factory=dict)
    last_used: int = 0


class RadixPrefixCache:
    """Trie of committed prompt prefixes, one node per full KV page.

    ``retain(page)``/``release(page)`` are the refcount bridge into the
    owning :class:`PagedKVCache`: the tree retains a page when it
    indexes it and releases it when the node evicts, so indexed pages
    outlive their creating sequence but still free (and zero, via the
    batched ``page_init`` path) once evicted and unshared.
    """

    def __init__(self, page_size: int, *,
                 retain: Callable[[int], None],
                 release: Callable[[int], None]) -> None:
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.page_size = page_size
        self._retain = retain
        self._release = release
        self._root = _RadixNode(key=(), page=-1, parent=None)
        self._clock = 0
        self.stats = {"hits": 0, "hit_tokens": 0, "misses": 0,
                      "inserts": 0, "nodes": 0, "evictions": 0}

    # ------------------------------ helpers ---------------------------- #

    def _pages_of(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        """Split ``tokens`` into full-page token tuples (the partial
        tail, if any, is dropped — only full pages are indexable)."""
        ps = self.page_size
        n_full = len(tokens) // ps
        return [tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])
                for i in range(n_full)]

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # ------------------------------ queries ---------------------------- #

    def match(self, tokens: Sequence[int]) -> List[int]:
        """Longest-prefix match: the arena pages holding the longest
        committed full-page prefix of ``tokens`` (possibly empty).
        Touches the matched path's LRU stamps; bumps hit/miss stats.
        The caller owns attaching the pages (refcount++ per page)."""
        now = self._tick()
        node = self._root
        pages: List[int] = []
        for key in self._pages_of(tokens):
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = now
            pages.append(child.page)
            node = child
        if pages:
            self.stats["hits"] += 1
            self.stats["hit_tokens"] += len(pages) * self.page_size
        else:
            self.stats["misses"] += 1
        return pages

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Index a committed prompt: ``pages[i]`` holds the KV of the
        i-th full token page.  Existing nodes are kept (first committer
        wins — a duplicate prefill's pages stay owned by its sequence
        alone and die with it); each NEW node retains its page.  Returns
        the number of new nodes created."""
        keys = self._pages_of(tokens)
        if len(pages) < len(keys):
            keys = keys[:len(pages)]
        now = self._tick()
        node = self._root
        created = 0
        for key, page in zip(keys, pages):
            child = node.children.get(key)
            if child is None:
                child = _RadixNode(key=key, page=int(page), parent=node)
                node.children[key] = child
                self._retain(int(page))
                created += 1
                self.stats["nodes"] += 1
                self.stats["inserts"] += 1
            child.last_used = now
            node = child
        return created

    # ------------------------------ eviction --------------------------- #

    def _leaves(self) -> Iterable[_RadixNode]:
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                yield n

    def _drop(self, node: _RadixNode) -> None:
        assert not node.children, "only leaves evict"
        del node.parent.children[node.key]
        self._release(node.page)
        self.stats["nodes"] -= 1
        self.stats["evictions"] += 1

    def evict_lru(self, n_pages: int = 1) -> int:
        """Evict up to ``n_pages`` least-recently-used LEAF nodes
        (evicting a leaf may expose its parent as the next candidate —
        unreferenced subtrees therefore drain leaves-first, deepest
        coldest path first).  Returns the number evicted; 0 means the
        tree is empty."""
        evicted = 0
        while evicted < n_pages:
            leaf = min(self._leaves(), default=None,
                       key=lambda n: n.last_used)
            if leaf is None:
                break
            self._drop(leaf)
            evicted += 1
        return evicted

    def evict_all(self) -> int:
        """Drop every node (releases every tree-held page reference) —
        the shutdown/leak-audit path."""
        total = 0
        while True:
            n = self.evict_lru(1 << 30)
            total += n
            if n == 0:
                return total

    # ------------------------------ views ------------------------------ #

    @property
    def n_nodes(self) -> int:
        return self.stats["nodes"]

    def pages_indexed(self) -> List[int]:
        out = []
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            out.append(n.page)
            stack.extend(n.children.values())
        return out
