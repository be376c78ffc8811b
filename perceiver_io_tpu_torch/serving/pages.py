"""Host-side page allocator for the paged KV cache (counterpart of
``perceiver_io_tpu/serving/pages.py``, kept as the port's own copy: the
port imports nothing of the JAX package).

Pure bookkeeping over integer page ids: no device tensors, no clocks, no
randomness, so ``alloc``/``free`` sequences are exactly reproducible. The
device half is ``core.cache.PagedKVCache``; the page-id space here indexes
its pools.

Discipline:

- page 0 is **scratch** (never allocated): unowned page-table entries point
  at it, inactive decode slots write into it harmlessly;
- the free list is LIFO (most-recently-freed first), so the allocation order
  is a pure function of the alloc/free history;
- ``alloc_tokens`` grants whole pages (``ceil(tokens / page_size)``); the
  rounded-up remainder is internal fragmentation, accounted per grant;
- exhaustion is an answer (``None``), not an exception: the engine turns
  "cannot fit now" into backpressure and "can never fit" into a refused
  request;
- pages are refcounted: a grant may reference pages another live grant
  already owns (``alloc_tokens_shared``), and a page returns to the free list
  only when its last holder frees it. ``cow_fork`` is the copy-on-write
  bookkeeping seam (the device copy is the caller's job: the engine's
  ``_fork_shared_append_page`` copies the page in place in its pools).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

SCRATCH_PAGE = 0


@dataclass
class PageStats:
    """The allocator's accounting surface (the gauge/fragmentation feed)."""

    num_pages: int  # allocatable pages (scratch excluded)
    page_size: int
    pages_used: int
    pages_free: int
    grants: int  # live grants
    tokens_reserved: int  # sum of granted token counts
    internal_frag_tokens: int  # granted page slack beyond the token counts
    pages_shared: int = 0  # physical pages referenced by >= 2 live grants

    @property
    def used_frac(self) -> float:
        return self.pages_used / self.num_pages if self.num_pages else 0.0

    @property
    def internal_frag_frac(self) -> float:
        granted = self.pages_used * self.page_size
        return self.internal_frag_tokens / granted if granted else 0.0


class PageAllocator:
    """Fixed-pool page allocator with LIFO free-list reuse.

    :param num_pages: TOTAL pool pages including the reserved scratch page 0
        (mirrors the ``PagedKVCache`` pool's leading dimension).
    :param page_size: tokens per page (fragmentation accounting only).
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved scratch)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.page_size = int(page_size)
        self.total_pages = int(num_pages)
        # LIFO: ascending ids pushed once, so the FIRST allocations are
        # low ids (deterministic), and freed pages come back hottest-first
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._grants: Dict[int, dict] = {}
        # page id -> number of live grants referencing it (absent == 0):
        # entries appear on first grant and leave when the last holder frees,
        # so "all refcounts zero at drain" is literally "the dict is empty"
        self._rc: Dict[int, int] = {}
        self._next_grant = 0
        # rejected operations (double free, drifted grant): every rejection
        # is RECORDED here as well as raised, so a caller that swallowed the
        # exception still leaves an auditable trail — audit() reports them
        self._violations: List[str] = []

    # -- capacity questions --------------------------------------------------

    @property
    def num_allocatable(self) -> int:
        return self.total_pages - 1

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_used(self) -> int:
        return self.num_allocatable - len(self._free)

    def pages_needed(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.page_size)

    def can_ever_fit(self, n_tokens: int) -> bool:
        """Whether an EMPTY pool could hold ``n_tokens`` — the admission-time
        shed test (``kv_pages_exhausted``): a request over this bound would
        wait in queue forever."""
        return self.pages_needed(n_tokens) <= self.num_allocatable

    def can_fit_now(self, n_tokens: int) -> bool:
        return self.pages_needed(n_tokens) <= len(self._free)

    def refcount(self, page: int) -> int:
        """Live-grant references to ``page`` (0 = free or out of pool)."""
        return self._rc.get(page, 0)

    def holders(self, page: int) -> List[int]:
        """Grant ids of every live grant referencing ``page`` (sorted)."""
        return sorted(gid for gid, g in self._grants.items() if page in g["pages"])

    # -- alloc / free --------------------------------------------------------

    def alloc_tokens(self, n_tokens: int) -> Optional["PageGrant"]:
        """Grant whole pages for ``n_tokens`` tokens, or ``None`` when the
        free list cannot cover it (backpressure, not an exception — and not
        a partial grant: it is all-or-nothing so a failed join leaks
        nothing)."""
        n = self.pages_needed(n_tokens)
        if n < 1:
            raise ValueError(f"alloc_tokens needs n_tokens >= 1, got {n_tokens}")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        gid = self._next_grant
        self._next_grant += 1
        for p in pages:
            self._rc[p] = 1
        self._grants[gid] = {"pages": pages, "tokens": int(n_tokens)}
        return PageGrant(gid, tuple(pages), int(n_tokens), self.page_size)

    def alloc_tokens_shared(
        self, n_tokens: int, shared_pages: Sequence[int]
    ) -> Optional["PageGrant"]:
        """Grant pages for ``n_tokens`` where the FIRST ``len(shared_pages)``
        pages are already-resident pages another live grant owns (the radix
        prefix match): each shared page's refcount is bumped, only the
        remainder comes off the free list. All-or-nothing like
        :meth:`alloc_tokens` — a shortfall of fresh pages bumps nothing and
        returns ``None``. Shared pages must be live (refcount >= 1): sharing
        a free or scratch page would alias recycled content and is rejected
        loudly (a matcher bug, not backpressure)."""
        n = self.pages_needed(n_tokens)
        shared = [int(p) for p in shared_pages]
        if len(shared) > n:
            raise ValueError(
                f"shared run ({len(shared)} pages) exceeds the grant "
                f"({n} pages for {n_tokens} tokens)"
            )
        if len(set(shared)) != len(shared):
            raise ValueError(f"shared run holds duplicate pages: {shared}")
        for p in shared:
            if p == SCRATCH_PAGE or self._rc.get(p, 0) < 1:
                raise ValueError(f"shared page {p} is not live (refcount 0)")
        fresh_needed = n - len(shared)
        if fresh_needed > len(self._free):
            return None
        fresh = [self._free.pop() for _ in range(fresh_needed)]
        gid = self._next_grant
        self._next_grant += 1
        for p in shared:
            self._rc[p] += 1
        for p in fresh:
            self._rc[p] = 1
        pages = shared + fresh
        self._grants[gid] = {"pages": pages, "tokens": int(n_tokens)}
        return PageGrant(
            gid, tuple(pages), int(n_tokens), self.page_size, tuple(shared)
        )

    def free(self, grant: "PageGrant") -> List[int]:
        """Drop one reference on each of a grant's pages; pages whose LAST
        reference this was return to the free list (LIFO) and are reported
        back — the caller expires any prefix-index entries naming them
        (recycled pages must never satisfy a future match). A double free (or
        a grant whose pages drifted from the books) is REJECTED — raised AND
        recorded as an :meth:`audit` violation, never a silent free-list
        corruption: the free list is untouched, the books keep their state,
        and the incident stays visible even to a caller that swallowed the
        exception."""
        entry = self._grants.get(grant.grant_id)
        if entry is None:
            held = {p: self.holders(p) for p in grant.pages}
            holder_note = ", ".join(
                f"page {p} held by grants {h}" if h else f"page {p} free"
                for p, h in held.items()
            )
            self._violations.append(
                f"double free rejected: grant {grant.grant_id} "
                f"(pages {list(grant.pages)}) is not live; {holder_note}"
            )
            raise ValueError(f"grant {grant.grant_id} is not live (double free?)")
        if entry["pages"] != list(grant.pages):
            # books keep the grant (the LIVE entry is authoritative); the
            # drifted handle's free is refused wholesale
            self._violations.append(
                f"drifted free rejected: grant {grant.grant_id} claims pages "
                f"{list(grant.pages)}, books say {entry['pages']}"
            )
            raise ValueError(f"grant {grant.grant_id} pages drifted from the books")
        del self._grants[grant.grant_id]
        released: List[int] = []
        for p in entry["pages"]:
            rc = self._rc[p] - 1
            if rc == 0:
                del self._rc[p]
                released.append(p)
            else:
                self._rc[p] = rc
        # freed most-recent-first so reuse order is deterministic
        self._free.extend(reversed(released))
        return released

    def cow_fork(self, grant: "PageGrant", page: int) -> Optional["PageGrant"]:
        """Copy-on-write fork: swap a FRESH page into ``grant`` in place of
        the shared ``page`` (a writer is about to append into a partially-
        filled shared tail page — full shared pages never fork). Drops one
        reference on the shared original and returns the grant's replacement
        handle with the fresh page in the same position (the caller copies
        the device bytes and re-publishes its page table). When the free
        list is empty the fork CANNOT proceed: returns ``None`` with the
        grant untouched — never a torn grant — and the caller sheds
        ``kv_pages_exhausted``."""
        entry = self._grants.get(grant.grant_id)
        if entry is None or entry["pages"] != list(grant.pages):
            raise ValueError(f"cow_fork: grant {grant.grant_id} is not live")
        if page not in entry["pages"]:
            raise ValueError(f"cow_fork: grant {grant.grant_id} does not hold page {page}")
        if self._rc.get(page, 0) < 2:
            raise ValueError(
                f"cow_fork: page {page} is not shared (refcount "
                f"{self._rc.get(page, 0)}) — the sole holder appends in place"
            )
        if not self._free:
            return None
        fresh = self._free.pop()
        self._rc[fresh] = 1
        self._rc[page] -= 1
        idx = entry["pages"].index(page)
        entry["pages"][idx] = fresh
        new_shared = tuple(p for p in grant.shared_pages if p != page)
        return PageGrant(
            grant.grant_id,
            tuple(entry["pages"]),
            grant.tokens,
            self.page_size,
            new_shared,
        )

    def stats(self) -> PageStats:
        tokens = sum(g["tokens"] for g in self._grants.values())
        granted_slots = sum(len(g["pages"]) for g in self._grants.values()) * self.page_size
        return PageStats(
            num_pages=self.num_allocatable,
            page_size=self.page_size,
            pages_used=self.pages_used,
            pages_free=self.pages_free,
            grants=len(self._grants),
            tokens_reserved=tokens,
            internal_frag_tokens=granted_slots - tokens,
            pages_shared=sum(1 for rc in self._rc.values() if rc >= 2),
        )

    def audit(self) -> List[str]:
        """Invariant problems (empty = clean): every page is either free or
        referenced by at least one live grant, every page's refcount equals
        its appearances across live grants (the refcount-balance half of the
        page books), scratch is never owned — plus the rejected-operation
        history (a double free that was raised AND swallowed upstream still
        shows up here)."""
        problems: List[str] = list(self._violations)
        refs: Dict[int, List[int]] = {}
        for gid, g in self._grants.items():
            for p in g["pages"]:
                refs.setdefault(p, []).append(gid)
        for gid, g in self._grants.items():
            if len(set(g["pages"])) != len(g["pages"]):
                problems.append(f"grant {gid} references a page twice: {g['pages']}")
        # refcount balance: the counter IS the appearance count, both ways
        for p, gids in refs.items():
            if self._rc.get(p, 0) != len(gids):
                problems.append(
                    f"page {p} refcount {self._rc.get(p, 0)} != "
                    f"{len(gids)} appearances (grants {sorted(gids)})"
                )
        stale = set(self._rc) - set(refs)
        if stale:
            problems.append(
                f"refcounts for pages no grant references: "
                f"{sorted((p, self._rc[p]) for p in stale)}"
            )
        if SCRATCH_PAGE in refs:
            problems.append("scratch page 0 is owned by a grant")
        if SCRATCH_PAGE in self._free:
            problems.append("scratch page 0 is on the free list")
        free_set = set(self._free)
        if len(free_set) != len(self._free):
            problems.append("free list holds duplicates")
        overlap = free_set & set(refs)
        if overlap:
            problems.append(f"pages both free and owned: {sorted(overlap)}")
        missing = set(range(1, self.total_pages)) - free_set - set(refs)
        if missing:
            problems.append(f"pages leaked (neither free nor owned): {sorted(missing)}")
        return problems


@dataclass(frozen=True)
class PageGrant:
    """One live allocation: the pages a request's cache rows live in.
    ``shared_pages`` names the prefix run this grant references but does not
    exclusively own (empty for an unshared grant) — always a leading,
    page-aligned run of ``pages``."""

    grant_id: int
    pages: tuple
    tokens: int
    page_size: int
    shared_pages: Tuple[int, ...] = field(default=())

    @property
    def n_pages(self) -> int:
        return len(self.pages)

    @property
    def n_shared(self) -> int:
        return len(self.shared_pages)

    @property
    def shared_tokens(self) -> int:
        return self.n_shared * self.page_size

    @property
    def frag_tokens(self) -> int:
        return self.n_pages * self.page_size - self.tokens
