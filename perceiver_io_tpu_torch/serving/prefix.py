"""Radix prefix index for cross-request KV sharing (counterpart of
``perceiver_io_tpu/serving/prefix.py``, kept as the port's own copy: the
port imports nothing of the JAX package).

Host-side companion to the refcounted ``PageAllocator``: prompts are chunked
at **page-size granularity**, each full chunk is content-hashed, and the hash
path is walked through a radix tree whose nodes name the resident pool page
holding that chunk's cross-attention KV rows. Admission matches an incoming
prompt against the tree (:meth:`PrefixIndex.match`) and the engine's prefill
skips every matched page; a request that prefilled unshared publishes its
context-region pages back (:meth:`PrefixIndex.insert`) so later arrivals can
share them.

Why page granularity: the paged cache shares whole pages or nothing — a
page-table entry points at an entire page, so a partially-matching chunk
cannot be referenced without also aliasing the mismatched tail rows. The
partial tail chunk of a prompt is therefore never indexed and never matched
(pinned by tests/test_torch_prefix.py).

Why content hashes and not token tuples as keys: the digest is fixed-width
regardless of page size (the tree stays cheap at page_size 128), and the
chunk bytes feed ``blake2b`` so two different chunks practically cannot
collide; the engine additionally only ever shares pages that are live in the
allocator's books, so a stale match can at worst waste a lookup, never alias
freed content — :meth:`expire_pages` removes every node naming a page the
moment the allocator reports it released (``PageAllocator.free`` returns the
newly-released ids exactly for this call).

Deferred inserts (:meth:`PrefixIndex.defer_insert`, the port's own): the
engine publishes a join's run without hashing it or building its nodes while
the tree holds nothing under the run's first chunk key. The insert runs when
a call reads that subtree (a match or insert that starts there), or the
whole index (:meth:`PrefixIndex.pages`, ``len``, :meth:`PrefixIndex.audit`).
A run withdrawn first (:meth:`PrefixIndex.withdraw`, at the free that
releases its pages) never costs its hashes or its nodes, so traffic that
shares nothing pays one chunk hash a join. What the index answers is the
eager index's: the deferred runs under a first key settle, in publish order,
before anything reads or writes that subtree.

Pure bookkeeping: no device arrays, no clocks — like the allocator, the
index state is a pure function of the insert/match/expire history, which is
what lets the engine's ``sharing_audit`` check index/books agreement at
drain.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, FrozenSet, Hashable, Iterable, List, Sequence, Tuple

import numpy as np


def _token_bytes(tokens: Sequence[int]) -> bytes:
    """The tokens as consecutive 8-byte little-endian signed integers."""
    return np.asarray(tokens, dtype="<i8").reshape(-1).tobytes()


def chunk_key(tokens: Sequence[int]) -> bytes:
    """Content hash of one page-size token chunk (the radix edge label): the
    blake2b digest of its tokens' 8-byte little-endian signed integers, the
    JAX package's key byte for byte (hashed in one update, not a token at a
    time)."""
    return hashlib.blake2b(_token_bytes(tokens), digest_size=16).digest()


class _Node:
    __slots__ = ("page", "children", "level", "key")

    def __init__(self, page: int, level: Dict[bytes, "_Node"], key: bytes):
        self.page = page
        self.children: Dict[bytes, "_Node"] = {}
        self.level = level  # the dict this node is registered in
        self.key = key


class PrefixIndex:
    """Radix tree over page-size chunk hashes -> resident page runs."""

    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.page_size = int(page_size)
        self._root: Dict[bytes, _Node] = {}
        # page id -> the nodes naming it (a page appears once per distinct
        # chunk path; republishing the same chunk under a new page moves the
        # node, so this is a one-to-many map only across paths)
        self._by_page: Dict[int, List[_Node]] = {}
        self._nodes = 0
        # owner -> (first chunk key, the run's keys when asked, its pages), in
        # publish order: the inserts not run yet (defer_insert)
        self._deferred: Dict[Hashable, Tuple[bytes, Callable[[], Sequence[bytes]], FrozenSet[int],
                                             Tuple[int, ...]]] = {}

    def __len__(self) -> int:
        self._settle()
        return self._nodes

    def pages(self) -> Tuple[int, ...]:
        """Pool pages the index currently names (sorted) — the engine's
        sharing audit cross-checks each against the allocator's refcounts."""
        self._settle()
        return tuple(sorted(self._by_page))

    def defer_insert(self, owner: Hashable, first_key: bytes, keys: Callable[[], Sequence[bytes]],
                     page_ids: Sequence[int]) -> None:
        """:meth:`insert_keys` of ``keys()`` (whose first key is
        ``first_key``) and ``page_ids``, put off while the tree holds
        nothing under ``first_key``: it runs when a call reads that subtree
        or the whole index, and :meth:`withdraw` drops it when its owner's
        free releases the pages first. With a run already under
        ``first_key`` it runs now (the run may share or repoint nodes
        there)."""
        self._settle(first_key)
        if first_key in self._root:
            self.insert_keys(keys(), page_ids)
            return
        self._deferred[owner] = (first_key, keys, frozenset(int(p) for p in page_ids), tuple(page_ids))

    def withdraw(self, owner: Hashable) -> None:
        """Drop ``owner``'s deferred insert, if it still waits, at the free
        that releases its pages: the subtree under its first key then holds
        its run alone, which that free's :meth:`expire_pages` would remove
        whole."""
        self._deferred.pop(owner, None)

    def _settle(self, first_key: bytes = None) -> None:
        """Run the deferred inserts under ``first_key`` (all of them with
        None), in publish order."""
        due = [owner for owner, entry in self._deferred.items() if first_key is None or entry[0] == first_key]
        for _, keys, _, pages in [self._deferred.pop(owner) for owner in due]:
            self.insert_keys(keys(), pages)

    def chunks(self, tokens: Sequence[int]) -> List[bytes]:
        """Hash keys of every FULL page-size chunk of ``tokens`` (the
        partial tail chunk is dropped — page-granularity sharing)."""
        step = 8 * self.page_size
        data = _token_bytes(tokens)
        return [hashlib.blake2b(data[i : i + step], digest_size=16).digest()
                for i in range(0, len(data) - step + 1, step)]

    def insert(self, tokens: Sequence[int], page_ids: Sequence[int]) -> int:
        """Register a resident run: chunk ``i`` of ``tokens`` lives in pool
        page ``page_ids[i]``. Only the covered full chunks are indexed
        (callers pass the context-region pages of a committed grant).
        Returns the number of NEW nodes created (0 = the whole run was
        already indexed). Re-inserting a chunk path under a different page
        repoints the node at the newer copy."""
        return self.insert_keys(self.chunks(tokens), page_ids)

    def insert_keys(self, keys: Sequence[bytes], page_ids: Sequence[int]) -> int:
        """:meth:`insert` of a prompt whose chunk keys (:meth:`chunks`) the
        caller already holds."""
        keys = list(keys)[: len(page_ids)]
        if keys and self._deferred:
            self._settle(keys[0])
        if len(keys) < len(page_ids):
            raise ValueError(
                f"{len(page_ids)} pages cover more tokens than the "
                f"{len(keys)} full chunks of the prompt"
            )
        created = 0
        level = self._root
        for key, page in zip(keys, page_ids):
            page = int(page)
            node = level.get(key)
            if node is None:
                node = _Node(page, level, key)
                level[key] = node
                self._by_page.setdefault(page, []).append(node)
                self._nodes += 1
                created += 1
            elif node.page != page:
                old = self._by_page.get(node.page)
                if old is not None:
                    old[:] = [n for n in old if n is not node]
                    if not old:
                        del self._by_page[node.page]
                node.page = page
                self._by_page.setdefault(page, []).append(node)
            level = node.children
        return created

    def match(self, tokens: Sequence[int]) -> Tuple[int, ...]:
        """Longest resident prefix run: pool page ids covering the leading
        full chunks of ``tokens``, stopping at the first unindexed chunk.
        Empty tuple = nothing resident (sharing is a no-op)."""
        return self.match_keys(self.chunks(tokens))

    def match_keys(self, keys: Sequence[bytes]) -> Tuple[int, ...]:
        """:meth:`match` of a prompt whose chunk keys the caller already
        holds."""
        if keys and self._deferred:
            self._settle(keys[0])
        pages: List[int] = []
        level = self._root
        for key in keys:
            node = level.get(key)
            if node is None:
                break
            pages.append(node.page)
            level = node.children
        return tuple(pages)

    def match_first(self, first_key: bytes, keys: Callable[[], Sequence[bytes]]) -> Tuple[int, ...]:
        """:meth:`match_keys` of ``keys()``, whose first key is
        ``first_key``: ``keys`` is called only when the index holds a run
        under ``first_key`` (else nothing matches)."""
        self._settle(first_key)
        if first_key not in self._root:
            return ()
        return self.match_keys(keys())

    def expire_pages(self, page_ids: Iterable[int]) -> int:
        """Remove every run that references a released page: the node naming
        it AND its whole subtree (deeper chunks are unreachable for matching
        once an ancestor is gone — a match cannot skip a chunk). Call with
        ``PageAllocator.free``'s return value so recycled pages can never
        satisfy a future match. Returns the number of nodes removed. A
        deferred run that names a released page settles first, as its insert
        would have run before this free."""
        page_ids = [int(p) for p in page_ids]
        for key, _, held, _ in list(self._deferred.values()):
            if not held.isdisjoint(page_ids):
                self._settle(key)
        removed = 0
        for page in page_ids if self._by_page else ():
            for node in list(self._by_page.get(int(page), ())):
                removed += self._drop_subtree(node)
            # the nodes dropped their _by_page entries in _drop_subtree
        return removed

    def _drop_subtree(self, node: _Node) -> int:
        if node.level.get(node.key) is node:
            del node.level[node.key]
        removed = 0
        stack = [node]
        while stack:
            n = stack.pop()
            refs = self._by_page.get(n.page)
            if refs is not None:
                refs[:] = [r for r in refs if r is not n]
                if not refs:
                    del self._by_page[n.page]
            stack.extend(n.children.values())
            n.children.clear()
            self._nodes -= 1
            removed += 1
        return removed

    def audit(self) -> List[str]:
        """Index invariants (empty = clean): node count agrees with the
        tree, and the page map names exactly the pages in the tree."""
        self._settle()
        problems: List[str] = []
        seen = 0
        pages: Dict[int, int] = {}
        stack = list(self._root.values())
        while stack:
            n = stack.pop()
            seen += 1
            pages[n.page] = pages.get(n.page, 0) + 1
            stack.extend(n.children.values())
        if seen != self._nodes:
            problems.append(f"node counter {self._nodes} != {seen} tree nodes")
        mapped = {p: len(v) for p, v in self._by_page.items()}
        if mapped != pages:
            problems.append(f"page map {mapped} != tree pages {pages}")
        return problems
