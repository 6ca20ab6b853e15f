"""Radix prefix cache over the paged KV pool (the SGLang
RadixAttention direction).  The port's own copy of
container_engine_accelerators_tpu/serving/prefix_cache.py (match,
insert, migration adopt and release, LRU eviction, the tier demotion
helpers, release and clear, same behaviour).  Token prefixes map to
refcounted read-only pages, so requests sharing a system prompt — the
dominant pattern at millions-of-users scale — skip prefill for every
matched page instead of recomputing it.

Structure: a trie whose EDGE is one full page of tokens (a
`page_size`-tuple) and whose node holds the physical page id carrying
that page's KV.  An admission walks the trie over its prompt's full
pages; every hit node's page is shared into the row's block table by
REFERENCE (serving/kvpool.py refcounts — no copy), and chunked prefill
resumes at the first miss.  When the walk ends mid-page (the stored
page diverges from the prompt partway, or the prompt itself ends
mid-page), the engine adopts the partial page COPY-ON-WRITE: the
matched tokens' KV is taken from the donor page (gathered into the
admission scratch by the preload seam) into a FRESHLY allocated
private page, so the row's own writes — its remaining prompt and its
generated tokens — never touch the shared donor.

Retention and eviction: when an admission finishes, its prompt's full
pages are INSERTED — missing trie nodes adopt the row's private pages
(one extra pool reference each), so the pages outlive the row.  Under
allocation pressure the engine evicts LEAF nodes in LRU order
(`evict_until`): dropping a leaf releases the trie's reference, and
the page actually frees only when no active row still maps it — the
refcount-aware half of the LRU.  Interior nodes are never evicted
(descendants would become unreachable), which is the standard
radix-cache discipline.

Threading: all structural mutation happens on the engine scheduler
thread (match / insert / evict) with clear() additionally called from
the supervisor during a rebuild, while /metrics readers call
page_count() from scrape threads — every public method takes the
cache's own lock, which never nests around the engine lock.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple


class _Node:
    __slots__ = ("key", "page", "children", "parent", "last_use")

    def __init__(self, key, page, parent):
        self.key = key          # page_size-tuple of tokens (edge label)
        self.page = page        # physical page id holding the KV
        self.children: Dict[tuple, "_Node"] = {}
        self.parent = parent
        self.last_use = 0


class RadixPrefixCache:
    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page = int(page_size)
        self._lock = threading.Lock()
        self._root = _Node(None, 0, None)  # guarded-by: _lock
        self._n_pages = 0  # guarded-by: _lock
        self._tick = 0  # guarded-by: _lock

    # -- lookup ----------------------------------------------------------
    def match(self, tokens) -> Tuple[List[int], Optional[Tuple[int, int]]]:
        """Walk the trie over `tokens` (1-D int sequence).  Returns
        (full_page_ids, partial): full pages matched in order, plus an
        optional (donor page id, n tokens matched into it) when the
        walk ended inside a stored page — the copy-on-write case.
        Touches last_use along the path (the LRU signal)."""
        toks = [int(t) for t in tokens]
        with self._lock:
            self._tick += 1
            node = self._root
            pages: List[int] = []
            off = 0
            while off + self.page <= len(toks):
                key = tuple(toks[off:off + self.page])
                child = node.children.get(key)
                if child is None:
                    break
                child.last_use = self._tick
                pages.append(child.page)
                node = child
                off += self.page
            partial = None
            rest = toks[off:]
            if rest:
                best = 0
                donor = None
                for key, child in node.children.items():
                    n = 0
                    for a, b in zip(rest, key):
                        if a != b:
                            break
                        n += 1
                    if n > best:
                        best, donor = n, child
                if donor is not None:
                    donor.last_use = self._tick
                    partial = (donor.page, best)
            return pages, partial

    # -- insertion -------------------------------------------------------
    # owns-pages
    def insert(self, tokens, page_ids, pool) -> int:
        """Retain `tokens`' full pages: walk the trie, and for every
        missing node adopt the corresponding entry of `page_ids` (the
        admitting row's pages, prefix order) with one extra pool
        reference — the trie's own hold, released at eviction.  Pages
        whose node already exists are left alone (the row keeps its
        copy; dedup happens at the NEXT admission, which will match
        the existing node).  Returns the number of pages adopted."""
        toks = [int(t) for t in tokens]
        adopted = 0
        with self._lock:
            self._tick += 1
            node = self._root
            for i in range(len(toks) // self.page):
                key = tuple(toks[i * self.page:(i + 1) * self.page])
                child = node.children.get(key)
                if child is None:
                    if i >= len(page_ids):
                        break
                    child = _Node(key, int(page_ids[i]), node)
                    pool.ref(child.page)
                    node.children[key] = child
                    self._n_pages += 1
                    adopted += 1
                child.last_use = self._tick
                node = child
        return adopted

    # -- cross-replica page migration ------------------------------------
    # owns-pages
    def adopt(self, tokens, page_ids, pool) -> Tuple[int, List[int]]:
        """insert() with OWNERSHIP TRANSFER — the adoption half of the
        page-migration seam: the caller holds one pool reference per
        entry of `page_ids` (freshly pool.alloc()-ed pages
        whose KV was just scattered from a migration blob), and every
        page whose trie node is MISSING is adopted as-is — the trie
        keeps the caller's reference instead of taking a new one.
        Pages whose node already exists (a racing admission or an
        earlier migration landed the same prefix first) are returned
        as `unused`: the caller unrefs them, and since nothing else
        references a just-allocated page, they free immediately — a
        duplicate migration costs pool churn, never a leak.  Returns
        (adopted count, unused page ids).

        STAGE-AND-COMMIT: a missing node means the whole remaining
        chain is missing (a fresh node has no children), so at most
        ONE link into the live trie exists — the first new node.  The
        chain is built detached and published by that single dict
        store at the end, after every raise-prone conversion and
        allocation: any exception out of this method means the trie
        took NOTHING, so the caller's unref-every-page unwind can
        never double-release a reference the trie already owns."""
        toks = [int(t) for t in tokens]
        adopted = 0
        unused: List[int] = []
        with self._lock:
            self._tick += 1
            node = self._root
            graft = None  # (live parent, key, detached chain head)
            for i in range(len(toks) // self.page):
                key = tuple(toks[i * self.page:(i + 1) * self.page])
                child = node.children.get(key)
                if child is None:
                    if i >= len(page_ids):
                        break
                    child = _Node(key, int(page_ids[i]), node)
                    if graft is None:
                        graft = (node, key, child)  # publish last
                    else:
                        node.children[key] = child  # still detached
                    adopted += 1
                elif i < len(page_ids):
                    unused.append(int(page_ids[i]))
                child.last_use = self._tick
                node = child
            if graft is not None:
                # Stats first: a MemoryError on the commit store's
                # dict resize leaves the trie untouched (unwind
                # correct) at worst inflating _n_pages until the next
                # clear/reset — drifted stats over a double release.
                self._n_pages += adopted
                parent, key, head = graft
                parent.children[key] = head  # the commit point
        del pool  # references transfer as-is; nothing to re-count
        return adopted, unused

    # owns-pages
    def release_exported(self, tokens, pool) -> int:
        """MOVE semantics for an export: drop the trie's hold on the
        exported chain — the nodes along `tokens`' full pages — plus
        the chain's entire subtree (descendants recorded under this
        prefix would be unreachable to the router once the affinity
        index re-points at the adopter, and keeping them would be
        exactly the N-1 duplicate-copy problem migration exists to
        fix).  Pages still mapped by active rows stay resident on
        their own references and free at retire — the refcount-aware
        rule eviction already follows.  Returns trie pages released."""
        toks = [int(t) for t in tokens]
        batch: List[int] = []
        with self._lock:
            self._tick += 1
            node = self._root
            chain: List[_Node] = []
            for i in range(len(toks) // self.page):
                key = tuple(toks[i * self.page:(i + 1) * self.page])
                child = node.children.get(key)
                if child is None:
                    break
                chain.append(child)
                node = child
            if not chain:
                return 0
            # Subtree below the deepest exported node first ...
            stack = list(chain[-1].children.values())
            chain[-1].children = {}
            while stack:
                n = stack.pop()
                batch.append(n.page)
                self._n_pages -= 1
                stack.extend(n.children.values())
            # ... then the chain itself, bottom-up, stopping at the
            # first node some OTHER prefix still needs (it has
            # children outside the exported path).
            for n in reversed(chain):
                if n.children:
                    break
                del n.parent.children[n.key]
                self._n_pages -= 1
                batch.append(n.page)
        for page in batch:
            pool.unref(page)
        return len(batch)

    # -- eviction --------------------------------------------------------
    # owns-pages
    def evict_until(self, pool, n_free_needed: int) -> int:
        """Drop LRU leaves until the pool has `n_free_needed` free
        pages or no leaf remains.  Returns the number of trie pages
        RELEASED (each may or may not free immediately — a page still
        mapped by an active row frees when that row retires; the
        refcount-aware half of the LRU).  Leaves are collected in ONE
        traversal per round and evicted as an LRU-ordered batch
        bounded by the current deficit — not one full-trie walk per
        page, which would stall the scheduler thread against a large
        retained set.  (A later round picks up parents the batch
        turned into leaves, in the rare case the deficit outlives the
        first leaf generation.)"""
        released = 0
        while pool.free_count < n_free_needed:
            deficit = n_free_needed - pool.free_count
            batch = []
            with self._lock:
                leaves = []
                stack = list(self._root.children.values())
                while stack:
                    node = stack.pop()
                    if node.children:
                        stack.extend(node.children.values())
                    else:
                        leaves.append(node)
                if not leaves:
                    break
                leaves.sort(key=lambda n: n.last_use)
                for leaf in leaves[:deficit]:
                    del leaf.parent.children[leaf.key]
                    self._n_pages -= 1
                    batch.append(leaf.page)
            for page in batch:
                pool.unref(page)
            released += len(batch)
        return released

    def lru_leaves(self, limit: int) -> List[Tuple[List[int], int]]:
        """The `limit` least-recently-used leaves as
        (root-to-leaf token path, page id), oldest first, WITHOUT
        removing anything — the tiered store's demotion candidates
        (serving/kvtier.py): the demoter serializes each victim's
        page first and only then calls drop_leaf, so an exception
        between the two leaves the trie intact.  Read-only: no
        last_use touch (a demotion scan must not rejuvenate its own
        victims)."""
        out: List[Tuple[List[int], int]] = []
        with self._lock:
            leaves = []
            stack = list(self._root.children.values())
            while stack:
                node = stack.pop()
                if node.children:
                    stack.extend(node.children.values())
                else:
                    leaves.append(node)
            leaves.sort(key=lambda n: n.last_use)
            for leaf in leaves[: max(0, int(limit))]:
                path = []
                node = leaf
                while node.parent is not None:
                    path.append(node.key)
                    node = node.parent
                out.append((
                    [t for key in reversed(path) for t in key],
                    leaf.page,
                ))
        return out

    # owns-pages
    def drop_leaf(self, tokens, pool) -> int:
        """Release ONE exact leaf — the demotion counterpart of
        evict_until's batch drop: walk `tokens`' full pages and, if
        the path ends at a node that is (still) a leaf, remove it and
        drop the trie's reference.  Returns pages released (0 when
        the path vanished or grew children since lru_leaves — both
        mean some other mutation got there first, and dropping a
        now-interior node would orphan its subtree)."""
        toks = [int(t) for t in tokens]
        page_id = None
        with self._lock:
            node = self._root
            for i in range(len(toks) // self.page):
                key = tuple(toks[i * self.page:(i + 1) * self.page])
                node = node.children.get(key)
                if node is None:
                    return 0
            if node is self._root or node.children:
                return 0
            del node.parent.children[node.key]
            self._n_pages -= 1
            page_id = node.page
        pool.unref(page_id)
        return 1

    # owns-pages
    def release_all(self, pool) -> int:
        """Give every retained reference back to the pool and empty
        the trie — the CLOSE-path counterpart of clear(): clear()
        forgets because the pool is resetting with the device cache,
        release_all releases because the pool lives on and the
        accounting must balance (engine close; the ANALYZE_LEAKS
        harness asserts pool references are exactly active-rows +
        trie, so a closed engine must leave both at zero).  Pages
        still mapped by active rows free when those rows release
        their own references.  Returns trie pages released."""
        batch: List[int] = []
        with self._lock:
            stack = list(self._root.children.values())
            self._root = _Node(None, 0, None)
            self._n_pages = 0
            while stack:
                node = stack.pop()
                batch.append(node.page)
                stack.extend(node.children.values())
        for page in batch:
            pool.unref(page)
        return len(batch)

    def clear(self) -> None:
        """Forget every retained prefix WITHOUT touching the pool —
        used when the device cache is rebuilt (the pool resets with
        it, so per-page unrefs would double-free)."""
        with self._lock:
            self._root = _Node(None, 0, None)
            self._n_pages = 0

    # -- introspection ---------------------------------------------------
    def page_count(self) -> int:
        with self._lock:
            return self._n_pages
