"""Paged KV-cache memory subsystem.

A single global pool of fixed-size *pages* (``page_size`` KV tokens each)
backs every resident request.  Each request owns a *block table* — the
ordered list of physical page ids holding its KV — which grows
page-granularly as decode appends tokens.  The same allocator instance is
shared by the scheduler (admission / preemption decisions), the execution
engine (physical placement + the paged Pallas decode kernel's block
tables) and the discrete-event simulator (page occupancy, preemption and
recompute accounting in the paper-scale sweeps).  See DESIGN.md
§Hardware adaptation for how the logical page pool maps onto TPU-friendly
physical layouts.

Memory charged against the pool:

  * KV reservations — admission reserves ``prompt_len + decode_reserve``
    tokens up front (the scheduler admits only when this fits), so prefill
    never fails mid-flight; decode growth past the reservation allocates
    pages on demand and is what creates *pressure*.
  * Layered-prefill stash — boundary activations carried between layer
    groups are charged as ``stash_factor`` KV-token-equivalents per
    stashed token (``stash_factor ≈ d_model·bytes_act /
    kv_bytes_per_token``) and released when the request's prefill
    completes.

A second, host-side page pool (``n_host_pages``) backs **swap-to-host
preemption**: ``swap_out`` moves a resident request's KV pages to host
pages wholesale (the block table is remembered on the host side, in
logical order), freeing HBM; ``swap_in`` is the DMA-back — it claims fresh
HBM pages and releases the host copy, after which decode resumes with the
KV intact (no recompute epoch).  Host pages are accounted exactly like HBM
pages: a swapped request owns its host pages until swap-in or ``free``.

**Automatic prefix caching** (``prefix_caching=True``, DESIGN.md §Prefix
caching): every FULL page of a completed prompt can be registered in a
content-addressed index keyed by a *chain digest* — the hash of the
page's tokens folded together with the parent page's digest, so a page's
identity includes its entire prefix.  A later admission whose prompt
matches a chain links the shared pages into its block table (refcounted,
zero new pages charged) and starts prefill past the cached boundary.
The first page's parent is the request's chain ``root``: empty unless the
KV also depends on something besides the tokens (an encoder-decoder's
frames: the engine roots each request's chains at a digest of them).
Shared pages are read-only: the partial tail page of a prompt is never
shared, and when a whole prompt is covered by cached full pages the last
matched page is *copy-on-write* — it is dropped from the hit, the new
request re-prefills its tokens into a private page (so it still computes
its first logits), and the hit references only pages it links refcounted.
Refcount-0 shared pages park in an LRU and count as free: they are
reclaimed (oldest first, evicting their index entry) whenever the free
list runs dry, so cached prefixes never block a cold admission.  Shared
pages are excluded from swap: ``swap_out`` moves only a victim's private
pages to host and pins the shared prefix in HBM.

Every device-page release (free / evict / swap-out / spec trim / stash)
funnels through ONE helper, ``_release_pages`` — the single choke point
that makes refcount double-decrements structurally impossible —
and ``check_invariants`` asserts that every physical page is in exactly
one of {free list, LRU, a block table, a stash, pinned-shared} and that
every refcount equals the number of referencing table positions.

The allocator never decides WHO to evict — victim selection
(latest-arrival-first) lives in ``core.base.Scheduler``; the allocator
only enforces that nobody allocates pages it does not have.
"""

from __future__ import annotations

import hashlib
import math
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple


class PagedPoolExhausted(RuntimeError):
    """Raised when an allocation is attempted against an empty pool.

    Under pressure-aware admission + preemption this never surfaces: the
    scheduler checks ``can_admit``/``growth_deficit`` (and preempts) before
    any page is claimed.  It CAN surface when preemption is disabled and
    decode growth outruns the reservation."""


def _page_digest(parent: bytes, tokens: Tuple[int, ...]) -> bytes:
    """Chain digest of one full page: folds the PARENT page's digest into
    the hash, so a block's identity includes its whole prefix."""
    h = hashlib.blake2b(parent, digest_size=16)
    h.update(repr(tokens).encode())
    return h.digest()


@dataclass(frozen=True)
class PrefixHit:
    """Result of matching a prompt against the shared-prefix index.

    ``pages`` are the physical page ids to link (read-only, refcounted);
    ``leaf`` is the digest of the deepest LINKED page (``pages[-1]``) —
    always a chain the engine holds a KV row snapshot for, and always
    refcount-protected once the hit is reserved.  ``cow`` marks a
    fully-covered prompt whose last matched page was dropped from the hit
    (its tokens re-prefill into a private copy-on-write page)."""
    cached_tokens: int = 0
    pages: Tuple[int, ...] = ()
    leaf: Optional[bytes] = None
    cow: bool = False


_NO_HIT = PrefixHit()


@dataclass(frozen=True)
class KVExport:
    """Serializable manifest of one request's KV residency, produced by
    ``export_pages`` for transfer to ANOTHER allocator (the disaggregated
    prefill→decode handoff, DESIGN.md §Disaggregated serving).

    ``chain`` is the leading shared-prefix run in block-table order —
    ``(digest, page_tokens)`` per full shared page — carried so the
    importing side can LINK pages its own index already holds (zero link
    bytes) and register the rest, keeping the chain warm on both pools.
    ``private_tokens`` are the KV tokens whose payload must actually cross
    the inter-pool link if no page of the chain links on import."""
    req_id: int
    length: int
    chain: Tuple[Tuple[bytes, Tuple[int, ...]], ...] = ()
    n_private_pages: int = 0
    private_tokens: int = 0
    host_resident: bool = False


@dataclass(frozen=True)
class KVImport:
    """Outcome of ``import_pages``: how many tokens were served by pages
    already warm on the importing pool (``linked_tokens`` — zero bytes on
    the link) vs. materialized from the transferred payload
    (``moved_tokens``)."""
    linked_tokens: int = 0
    moved_tokens: int = 0
    n_pages: int = 0


@dataclass
class PagedKVAllocator:
    n_pages: int
    page_size: int = 16
    # KV-token-equivalents charged per stashed boundary-activation token
    # (layered prefill's carry state); callers derive it from the model's
    # d_model / kv_bytes_per_token ratio.
    stash_factor: float = 1.0
    # host-side page pool for swap-to-host preemption (0 = swap disabled)
    n_host_pages: int = 0
    # automatic prefix caching: content-hash full prompt pages into a
    # refcounted read-only index (off by default — the raw allocator is
    # also the substrate for caches that must not alias)
    prefix_caching: bool = False
    # cap on refcount-0 shared pages retained in the LRU (None = bounded
    # only by pool pressure)
    prefix_lru_pages: Optional[int] = None
    _free: List[int] = field(default_factory=list)
    _tables: Dict[int, List[int]] = field(default_factory=dict)  # req -> pages
    _lengths: Dict[int, int] = field(default_factory=dict)       # req -> toks
    _stash: Dict[int, List[int]] = field(default_factory=dict)   # req -> pages
    _host_free: List[int] = field(default_factory=list)
    _host_tables: Dict[int, List[int]] = field(default_factory=dict)
    # speculative pre-charge: req -> table size before reserve_spec
    _spec_base: Dict[int, int] = field(default_factory=dict)
    # -- prefix-cache state --------------------------------------------------
    _index: Dict[bytes, int] = field(default_factory=dict)    # digest -> page
    _page_digests: Dict[int, bytes] = field(default_factory=dict)
    _page_tokens: Dict[int, Tuple[int, ...]] = field(default_factory=dict)
    _refs: Dict[int, int] = field(default_factory=dict)       # page -> refcount
    _lru: "OrderedDict[int, None]" = field(default_factory=OrderedDict)
    _hits: Dict[int, PrefixHit] = field(default_factory=dict)  # req -> hit
    # shared prefix pages pinned in HBM while their owner is swapped out
    _swapped_shared: Dict[int, List[int]] = field(default_factory=dict)
    # tokens that crossed the host link in the request's LAST swap (shared
    # pages stay pinned, so this can be less than length)
    _swap_moved: Dict[int, int] = field(default_factory=dict)
    # engine hook: called with the chain digest of every page evicted from
    # the shared index, so cached KV row snapshots can be dropped with it
    on_prefix_evict: Optional[Callable[[bytes], None]] = None
    pages_high_water: int = 0
    host_pages_high_water: int = 0
    n_grow_allocs: int = 0
    # swap traffic accounting (cumulative, in KV tokens moved per direction)
    n_swap_outs: int = 0
    n_swap_ins: int = 0
    swapped_out_tokens: int = 0
    swapped_in_tokens: int = 0
    # prefix-cache accounting (cumulative)
    n_prefix_hits: int = 0
    n_prefix_tokens: int = 0
    n_prefix_cow: int = 0
    n_prefix_evictions: int = 0
    # inter-pool handoff accounting (cumulative, in KV tokens)
    n_exports: int = 0
    n_imports: int = 0
    exported_tokens: int = 0
    import_linked_tokens: int = 0
    import_moved_tokens: int = 0

    def __post_init__(self):
        assert self.n_pages > 0 and self.page_size > 0
        assert self.n_host_pages >= 0
        self._free = list(range(self.n_pages))[::-1]
        self._host_free = list(range(self.n_host_pages))[::-1]

    # -- sizing --------------------------------------------------------------

    def pages_for(self, n_tokens: int) -> int:
        return math.ceil(max(n_tokens, 0) / self.page_size)

    def stash_pages_for(self, n_tokens: int) -> int:
        return self.pages_for(math.ceil(n_tokens * self.stash_factor))

    @property
    def n_free_pages(self) -> int:
        # refcount-0 shared pages are reclaimable on demand: they count as
        # free so cached prefixes never shrink the pool's usable capacity
        return len(self._free) + len(self._lru)

    def pages_in_use(self) -> int:
        return self.n_pages - self.n_free_pages

    @property
    def n_free_host_pages(self) -> int:
        return len(self._host_free)

    def host_pages_in_use(self) -> int:
        return self.n_host_pages - len(self._host_free)

    @property
    def n_shared_pages(self) -> int:
        """Pages currently registered in the shared-prefix index."""
        return len(self._page_digests)

    # -- prefix matching -----------------------------------------------------

    def lookup_prefix(self, prompt_tokens: Optional[Sequence[int]],
                      root: bytes = b"") -> PrefixHit:
        """Walk the shared index along the prompt's full pages (chain
        digests, token content verified page-by-page against collisions).
        Non-mutating — safe for admissibility probes.  A fully-covered
        prompt drops the LAST matched page from the hit (copy-on-write):
        its tokens are re-prefilled into a private page so the request
        still computes final logits, and — the real point — the hit then
        only ever references pages it will LINK refcounted at reserve, so
        no unpinned page can be LRU-reclaimed between the admission
        decision and the engine's row restore."""
        if not self.prefix_caching or prompt_tokens is None \
                or len(prompt_tokens) == 0:
            return _NO_HIT
        ps = self.page_size
        n = len(prompt_tokens)
        pages: List[int] = []
        digests: List[bytes] = []
        parent = root
        for i in range(n // ps):
            toks = tuple(int(t) for t in prompt_tokens[i * ps:(i + 1) * ps])
            d = _page_digest(parent, toks)
            pid = self._index.get(d)
            if pid is None or self._page_tokens.get(pid) != toks:
                break
            pages.append(pid)
            digests.append(d)
            parent = d
        cow = len(pages) * ps >= n
        if cow:
            pages, digests = pages[:-1], digests[:-1]
        if not pages:
            return _NO_HIT
        return PrefixHit(cached_tokens=len(pages) * ps, pages=tuple(pages),
                         leaf=digests[-1], cow=cow)

    def prefix_hit(self, req_id: int) -> PrefixHit:
        """The hit recorded when ``req_id`` was reserved (no-hit default)."""
        return self._hits.get(req_id, _NO_HIT)

    def register_prefix(self, req_id: int,
                        prompt_tokens: Optional[Sequence[int]],
                        root: bytes = b"") -> List[Tuple[bytes, int]]:
        """Publish the FULL pages of a completed prompt into the shared
        index (idempotent — pages already registered under the same chain
        are skipped).  Registration stops at the first page whose chain
        digest is already served by a DIFFERENT physical page (a cohort
        mate won the race) — the remainder stays private and is released
        normally.  Returns the newly registered ``(digest, depth)`` pairs
        so the engine can snapshot KV rows for exactly those chains."""
        if not self.prefix_caching or prompt_tokens is None \
                or len(prompt_tokens) == 0:
            return []
        table = self._tables.get(req_id)
        if table is None:
            return []
        ps = self.page_size
        parent, new = root, []
        for i in range(min(len(prompt_tokens) // ps, len(table))):
            toks = tuple(int(t) for t in prompt_tokens[i * ps:(i + 1) * ps])
            d = _page_digest(parent, toks)
            pid = table[i]
            cur = self._index.get(d)
            if cur == pid:
                parent = d
                continue
            if cur is not None or pid in self._page_digests:
                break
            self._index[d] = pid
            self._page_digests[pid] = d
            self._page_tokens[pid] = toks
            self._refs[pid] = 1          # the owner's table reference
            new.append((d, i + 1))
            parent = d
        return new

    def owned_chains(self, req_id: int,
                     prompt_tokens: Optional[Sequence[int]],
                     root: bytes = b"") -> List[Tuple[bytes, int]]:
        """(digest, depth) pairs in the shared index currently served by
        ``req_id``'s OWN block-table pages.  The engine snapshots its KV
        row under exactly these digests after the prompt completes —
        registration itself happens scheduler-side at plan time, before
        the prefill has executed, so its return value cannot drive the
        snapshot."""
        table = self._tables.get(req_id)
        if not self.prefix_caching or prompt_tokens is None \
                or len(prompt_tokens) == 0 or table is None:
            return []
        ps = self.page_size
        parent, out = root, []
        for i in range(min(len(prompt_tokens) // ps, len(table))):
            toks = tuple(int(t) for t in prompt_tokens[i * ps:(i + 1) * ps])
            d = _page_digest(parent, toks)
            if self._index.get(d) != table[i]:
                break
            out.append((d, i + 1))
            parent = d
        return out

    # -- admission queries ---------------------------------------------------

    def _avail_for(self, hit: PrefixHit) -> int:
        """Pages claimable for NEW allocations once ``hit``'s shared pages
        are linked: the free list plus the reclaimable LRU, minus matched
        pages currently parked in the LRU (linking revives, not consumes,
        them — but they stop being reclaimable)."""
        parked = sum(1 for p in hit.pages if p in self._lru)
        return len(self._free) + len(self._lru) - parked

    def can_admit(self, n_tokens: int, stash_tokens: int = 0,
                  headroom_pages: int = 0,
                  prompt_tokens: Optional[Sequence[int]] = None,
                  root: bytes = b"") -> bool:
        """True iff a reservation for ``n_tokens`` of KV plus the stash
        charge fits the pool RIGHT NOW, leaving ``headroom_pages`` free
        (the scheduler's per-SLO-class admission reserve).  With
        ``prompt_tokens`` the query is prefix-aware: matched shared pages
        are charged zero new pages."""
        hit = self.lookup_prefix(prompt_tokens, root)
        need = (max(0, self.pages_for(n_tokens) - len(hit.pages))
                + self.stash_pages_for(stash_tokens))
        return need + headroom_pages <= self._avail_for(hit)

    def fits_pool(self, n_tokens: int, stash_tokens: int = 0,
                  headroom_pages: int = 0) -> bool:
        """True iff the request could EVER fit (empty pool minus the
        caller's headroom reserve).  Deliberately NOT prefix-aware: shared
        pages can be evicted under pressure, so the worst case must fit
        without cache credit."""
        need = self.pages_for(n_tokens) + self.stash_pages_for(stash_tokens)
        return need + headroom_pages <= self.n_pages

    # -- request lifecycle ---------------------------------------------------

    def owns(self, req_id: int) -> bool:
        """True iff ``req_id`` holds pages in EITHER pool (resident or
        swapped) — i.e. ``free`` has something to release."""
        return req_id in self._tables or req_id in self._host_tables

    def is_resident(self, req_id: int) -> bool:
        return req_id in self._tables

    def is_swapped(self, req_id: int) -> bool:
        return req_id in self._host_tables

    def reserve(self, req_id: int, n_tokens: int, stash_tokens: int = 0,
                prompt_tokens: Optional[Sequence[int]] = None,
                root: bytes = b"") -> PrefixHit:
        """Admission-time reservation: claims pages for ``n_tokens`` of KV
        (prompt + decode reservation) and the stash charge.  With
        ``prompt_tokens``, matched shared prefix pages are LINKED at the
        head of the block table (refcount bumped, revived from the LRU)
        and only the uncached remainder allocates new pages.  Records the
        filled length as the cached token count and returns the hit."""
        assert req_id not in self._tables, req_id
        hit = self.lookup_prefix(prompt_tokens, root)
        need_kv = self.pages_for(n_tokens)
        assert len(hit.pages) <= need_kv, (req_id, hit, n_tokens)
        need_new = need_kv - len(hit.pages)
        need_stash = self.stash_pages_for(stash_tokens)
        if need_new + need_stash > self._avail_for(hit):
            raise PagedPoolExhausted(
                f"reserve({req_id}): need {need_new + need_stash} pages, "
                f"{self.n_free_pages} free of {self.n_pages}")
        table = []
        for pid in hit.pages:
            self._refs[pid] += 1
            self._lru.pop(pid, None)
            table.append(pid)
        for _ in range(need_new):
            table.append(self._take_page())
        self._tables[req_id] = table
        self._stash[req_id] = [self._take_page() for _ in range(need_stash)]
        self._lengths[req_id] = hit.cached_tokens
        if hit.cached_tokens:
            self._hits[req_id] = hit
            self.n_prefix_hits += 1
            self.n_prefix_tokens += hit.cached_tokens
            self.n_prefix_cow += int(hit.cow)
        self._bump_high_water()
        return hit

    def set_length(self, req_id: int, n_tokens: int) -> None:
        """Record the filled KV length (monotone); never allocates."""
        assert n_tokens <= len(self._tables[req_id]) * self.page_size, \
            (req_id, n_tokens)
        self._lengths[req_id] = max(self._lengths[req_id], n_tokens)

    def growth_deficit(self, req_id: int, n_tokens: int) -> int:
        """Pages that must be newly allocated for the block table to cover
        ``n_tokens`` (0 when the reservation already covers it)."""
        return max(0, self.pages_for(n_tokens) - len(self._tables[req_id]))

    def grow_to(self, req_id: int, n_tokens: int) -> None:
        """Page-granular grow-on-write: extend the block table to cover
        ``n_tokens``.  Raises PagedPoolExhausted when the pool is dry — the
        scheduler's pressure pass preempts before letting that happen."""
        deficit = self.growth_deficit(req_id, n_tokens)
        if deficit > self.n_free_pages:
            raise PagedPoolExhausted(
                f"grow_to({req_id}, {n_tokens}): need {deficit} pages, "
                f"{self.n_free_pages} free of {self.n_pages}")
        for _ in range(deficit):
            self._tables[req_id].append(self._take_page())
            self.n_grow_allocs += 1
        self._lengths[req_id] = max(self._lengths[req_id], n_tokens)
        if deficit:
            self._bump_high_water()

    def release_stash(self, req_id: int) -> None:
        self._release_pages(self._stash.pop(req_id, []))
        self._stash[req_id] = []

    # -- speculative decode reservations --------------------------------------
    #
    # Verify-k decoding may commit anywhere from 1 to 1+k tokens per
    # iteration.  The scheduler pre-charges pages for the FULL window
    # (``reserve_spec``) without recording a filled length — the length is
    # only known post-verification — and the executor's commit trims the
    # table back to the accepted length (``release_spec``), so a rejected
    # draft leaves no page behind.  Speculation is opportunistic: it never
    # evicts anybody, it just shrinks k when the pool is dry.

    def reserve_spec(self, req_id: int, n_tokens: int) -> None:
        """Pre-charge pages so the block table covers ``n_tokens`` WITHOUT
        recording a filled length.  Remembers the pre-speculation table
        size so ``release_spec`` can trim back exactly."""
        assert req_id in self._tables, req_id
        if req_id not in self._spec_base:
            self._spec_base[req_id] = len(self._tables[req_id])
        deficit = self.growth_deficit(req_id, n_tokens)
        if deficit > self.n_free_pages:
            raise PagedPoolExhausted(
                f"reserve_spec({req_id}, {n_tokens}): need {deficit} pages, "
                f"{self.n_free_pages} free of {self.n_pages}")
        for _ in range(deficit):
            self._tables[req_id].append(self._take_page())
        if deficit:
            self._bump_high_water()

    def release_spec(self, req_id: int) -> None:
        """Trim the speculative pre-charge back to what the committed
        length (set via ``grow_to``/``set_length`` since) actually needs —
        never below the pre-speculation table size.  No-op for requests
        without an outstanding ``reserve_spec``.  Trimmed pages are always
        the private tail (the base covers the whole prompt, so shared
        prefix pages sit strictly below it)."""
        base = self._spec_base.pop(req_id, None)
        if base is None or req_id not in self._tables:
            return
        keep = max(base, self.pages_for(self._lengths[req_id]))
        table = self._tables[req_id]
        while len(table) > keep:
            self._release_pages([table.pop()])

    def has_spec_reservation(self, req_id: int) -> bool:
        return req_id in self._spec_base

    def free(self, req_id: int) -> None:
        """Return every page (KV + stash, HBM or host) of ``req_id``.
        Shared prefix pages are decref'd, not freed — at refcount 0 they
        park in the reclaimable LRU with their cached content intact."""
        assert self.owns(req_id), req_id
        self._release_pages(self._tables.pop(req_id, []))
        self._release_pages(self._stash.pop(req_id, []))
        self._release_pages(self._swapped_shared.pop(req_id, []))
        self._host_free.extend(reversed(self._host_tables.pop(req_id, [])))
        self._lengths.pop(req_id, None)
        self._spec_base.pop(req_id, None)
        self._hits.pop(req_id, None)
        self._swap_moved.pop(req_id, None)

    # -- swap-to-host ---------------------------------------------------------

    def _split_shared(self, table: List[int]) -> Tuple[List[int], List[int]]:
        """Partition a block table into (shared, private) pages, order
        preserved.  Shared pages always occupy a leading run (linked at
        reserve or registered over the prompt's leading full pages)."""
        shared = [p for p in table if p in self._page_digests]
        private = [p for p in table if p not in self._page_digests]
        return shared, private

    def can_swap_out(self, req_id: int) -> bool:
        """True iff the host pool can hold ``req_id``'s PRIVATE KV pages
        right now (shared prefix pages stay pinned in HBM — they are
        read-only and other requests may be attached to them).  A
        mid-prefill request (live stash) is never swappable — boundary
        activations are execution state, not KV; such victims fold to
        recompute instead."""
        if not self.is_resident(req_id) or self._stash.get(req_id):
            return False
        _, private = self._split_shared(self._tables[req_id])
        if not private:
            # a fully-shared victim would be a zero-progress swap (nothing
            # leaves HBM); recompute-eviction at least parks its shared
            # pages in the reclaimable LRU
            return False
        return len(private) <= len(self._host_free)

    def swap_out(self, req_id: int) -> int:
        """Move the PRIVATE KV pages of ``req_id`` to the host pool (the
        block table is remembered host-side in logical order); shared
        prefix pages keep their refcount and stay pinned in HBM.  Returns
        the number of KV tokens that actually cross the host link."""
        assert self.can_swap_out(req_id), req_id
        shared, private = self._split_shared(self._tables.pop(req_id))
        self._release_pages(private)
        self._stash.pop(req_id, None)       # empty by the can_swap_out guard
        self._swapped_shared[req_id] = shared
        self._host_tables[req_id] = [self._host_free.pop()
                                     for _ in range(len(private))]
        self.host_pages_high_water = max(self.host_pages_high_water,
                                         self.host_pages_in_use())
        moved = max(0, self._lengths[req_id] - len(shared) * self.page_size)
        self._swap_moved[req_id] = moved
        self.n_swap_outs += 1
        self.swapped_out_tokens += moved
        return moved

    def swapped_pages(self, req_id: int) -> int:
        return len(self._host_tables[req_id])

    def last_swap_tokens(self, req_id: int) -> int:
        """KV tokens moved by ``req_id``'s most recent swap (either
        direction) — the DMA traffic an executor prices.  Shared prefix
        pages never move, so this can be less than ``length``."""
        return self._swap_moved.get(req_id, 0)

    def can_swap_in(self, req_id: int) -> bool:
        return (self.is_swapped(req_id)
                and len(self._host_tables[req_id]) <= self.n_free_pages)

    def swap_in(self, req_id: int) -> int:
        """DMA-back: claim fresh HBM pages for the swapped private KV,
        re-attach the pinned shared prefix, and release the host copy.
        Returns the number of KV tokens moved."""
        assert self.can_swap_in(req_id), req_id
        n_private = len(self._host_tables[req_id])
        self._host_free.extend(reversed(self._host_tables.pop(req_id)))
        shared = self._swapped_shared.pop(req_id, [])
        self._tables[req_id] = shared + [self._take_page()
                                         for _ in range(n_private)]
        self._stash[req_id] = []
        self._bump_high_water()
        moved = max(0, self._lengths[req_id] - len(shared) * self.page_size)
        self._swap_moved[req_id] = moved
        self.n_swap_ins += 1
        self.swapped_in_tokens += moved
        return moved

    # -- inter-pool export / import (disaggregated handoff) -------------------
    #
    # ``export_pages`` serializes a request's residency into a ``KVExport``
    # manifest and releases its pages HERE (move semantics): shared prefix
    # pages decref and park in this pool's LRU — the source stays warm for
    # later prompts — while the manifest carries the chain digests so the
    # importing pool can link pages it already holds instead of receiving
    # their payload.  ``import_pages`` is the mirror: it lands the request
    # as owned (private) + pinned-shared (linked/registered chain) pages,
    # with ``check_invariants`` holding on both allocators at every step.

    def export_pages(self, req_id: int) -> KVExport:
        """Serialize ``req_id``'s KV residency (resident OR swapped) for
        transfer to another allocator, then release every page it holds on
        this side.  Returns the manifest the destination imports from."""
        assert self.owns(req_id), req_id
        length = self._lengths[req_id]
        if self.is_resident(req_id):
            shared, private = self._split_shared(self._tables[req_id])
            host_resident = False
        else:
            shared = list(self._swapped_shared.get(req_id, []))
            private = self._host_tables[req_id]
            host_resident = True
        # the chain only ever covers FULL pages of the filled length
        shared = shared[:length // self.page_size]
        chain = tuple((self._page_digests[p], self._page_tokens[p])
                      for p in shared)
        export = KVExport(
            req_id=req_id, length=length, chain=chain,
            n_private_pages=len(private),
            private_tokens=max(0, length - len(chain) * self.page_size),
            host_resident=host_resident)
        self.free(req_id)
        self.n_exports += 1
        self.exported_tokens += length
        return export

    def _match_chain(self, export: KVExport) -> List[int]:
        """Leading run of ``export.chain`` already served by THIS pool's
        index (content-verified, like ``lookup_prefix``).  Non-mutating."""
        linked: List[int] = []
        for digest, toks in export.chain:
            pid = self._index.get(digest)
            if pid is None or self._page_tokens.get(pid) != toks:
                break
            linked.append(pid)
        return linked

    def can_import(self, export: KVExport, n_tokens: Optional[int] = None,
                   headroom_pages: int = 0) -> bool:
        """True iff ``import_pages`` would succeed right now (prefix-aware:
        chain pages warm on this side are charged zero new pages)."""
        n_tokens = max(n_tokens or 0, export.length)
        linked = self._match_chain(export)
        hit = PrefixHit(cached_tokens=len(linked) * self.page_size,
                        pages=tuple(linked))
        need = max(0, self.pages_for(n_tokens) - len(linked))
        return need + headroom_pages <= self._avail_for(hit)

    def import_pages(self, export: KVExport,
                     n_tokens: Optional[int] = None) -> KVImport:
        """Materialize an exported request on THIS allocator: chain pages
        already warm here are linked refcounted (zero link bytes), the
        rest of the chain allocates fresh pages and registers into the
        index (the transferred payload makes this pool warm too), and the
        private remainder allocates owned pages.  ``n_tokens`` reserves
        decode growth past the filled length (default: exactly the filled
        length).  Raises ``PagedPoolExhausted`` when the pool cannot hold
        the request — probe ``can_import`` first."""
        req_id = export.req_id
        assert req_id not in self._tables, req_id
        n_tokens = max(n_tokens or 0, export.length)
        linked = self._match_chain(export)
        hit = PrefixHit(cached_tokens=len(linked) * self.page_size,
                        pages=tuple(linked))
        need_new = max(0, self.pages_for(n_tokens) - len(linked))
        if need_new > self._avail_for(hit):
            raise PagedPoolExhausted(
                f"import_pages({req_id}): need {need_new} pages, "
                f"{self.n_free_pages} free of {self.n_pages}")
        table: List[int] = []
        for pid in linked:
            self._refs[pid] += 1
            self._lru.pop(pid, None)
            table.append(pid)
        # cold chain pages: allocate + register so the chain is warm here
        # for the NEXT import/admission sharing this prefix
        for digest, toks in export.chain[len(linked):]:
            pid = self._take_page()
            table.append(pid)
            if digest not in self._index and self.prefix_caching:
                self._index[digest] = pid
                self._page_digests[pid] = digest
                self._page_tokens[pid] = toks
                self._refs[pid] = 1
        while len(table) < self.pages_for(n_tokens):
            table.append(self._take_page())
        self._tables[req_id] = table
        self._stash[req_id] = []
        self._lengths[req_id] = export.length
        self._bump_high_water()
        linked_tokens = min(hit.cached_tokens, export.length)
        self.n_imports += 1
        self.import_linked_tokens += linked_tokens
        self.import_moved_tokens += export.length - linked_tokens
        return KVImport(linked_tokens=linked_tokens,
                        moved_tokens=export.length - linked_tokens,
                        n_pages=len(table))

    # -- physical mapping ----------------------------------------------------

    def block_table(self, req_id: int) -> List[int]:
        """Physical page ids backing ``req_id``'s KV, in logical order —
        what the paged decode-attention kernel walks."""
        return list(self._tables[req_id])

    def length(self, req_id: int) -> int:
        return self._lengths[req_id]

    # -- internals -----------------------------------------------------------

    def _take_page(self) -> int:
        """Claim one physical page: the free list first, then reclaim the
        oldest refcount-0 shared page (evicting its index entry)."""
        if self._free:
            return self._free.pop()
        pid, _ = self._lru.popitem(last=False)
        self._unregister(pid)
        return pid

    def _release_pages(self, pages: List[int]) -> None:
        """THE single release choke point for device pages (free / evict /
        swap-out / spec trim / stash all funnel here): shared pages decref
        and park in the reclaimable LRU at refcount 0 with content intact;
        private pages return to the free list."""
        for pid in reversed(pages):
            if pid not in self._page_digests:
                self._free.append(pid)
                continue
            self._refs[pid] -= 1
            assert self._refs[pid] >= 0, pid
            if self._refs[pid] == 0:
                self._lru[pid] = None
                self._enforce_lru_cap()

    def _enforce_lru_cap(self) -> None:
        cap = self.prefix_lru_pages
        while cap is not None and len(self._lru) > cap:
            pid, _ = self._lru.popitem(last=False)
            self._unregister(pid)
            self._free.append(pid)

    def _unregister(self, pid: int) -> None:
        """Drop one page from the shared index (LRU reclaim), notifying
        the engine so its cached KV row snapshots die with the entry."""
        d = self._page_digests.pop(pid)
        self._index.pop(d, None)
        self._page_tokens.pop(pid, None)
        self._refs.pop(pid, None)
        self.n_prefix_evictions += 1
        if self.on_prefix_evict is not None:
            self.on_prefix_evict(d)

    def _bump_high_water(self) -> None:
        self.pages_high_water = max(self.pages_high_water,
                                    self.pages_in_use())

    # -- debug invariant ------------------------------------------------------

    def check_invariants(self) -> None:
        """Assert global page conservation: every device page is in exactly
        one of {free list, LRU, a block table, a stash, pinned-shared},
        shared refcounts equal the number of referencing positions, and
        every host page is in exactly one of {host free list, host table}.
        O(pool) — for tests and debugging, never on the serving path."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate page in free list"
        lru = set(self._lru)
        assert not free & lru, "page both free and LRU-parked"
        refs: Dict[int, int] = {}
        private_placed: List[int] = []
        holders = (list(self._tables.values()) + list(self._stash.values())
                   + list(self._swapped_shared.values()))
        for t in holders:
            for p in t:
                if p in self._page_digests:
                    refs[p] = refs.get(p, 0) + 1
                else:
                    private_placed.append(p)
        assert len(private_placed) == len(set(private_placed)), \
            "private page referenced by two tables"
        assert not set(private_placed) & (free | lru), \
            "placed private page also free/LRU"
        for pid, d in self._page_digests.items():
            assert self._index.get(d) == pid, (pid, "index out of sync")
            assert self._refs[pid] == refs.get(pid, 0), \
                (pid, self._refs[pid], refs.get(pid, 0))
            assert (pid in lru) == (self._refs[pid] == 0), (pid, "LRU sync")
            assert pid not in free, (pid, "shared page on free list")
        for pid in lru:
            assert pid in self._page_digests, (pid, "LRU page unregistered")
        pinned = sum(1 for p in self._page_digests if self._refs[p] > 0)
        assert (len(free) + len(lru) + len(private_placed) + pinned
                == self.n_pages), "device page conservation violated"
        host = list(self._host_free) + [p for t in self._host_tables.values()
                                        for p in t]
        assert sorted(host) == list(range(self.n_host_pages)), \
            "host page conservation violated"
