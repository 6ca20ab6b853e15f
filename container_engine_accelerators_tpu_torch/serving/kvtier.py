"""Hierarchical KV page store: host-RAM and disk tiers UNDER the
paged HBM pool (the Mooncake KVCache-centric direction).  The port's own
copy of container_engine_accelerators_tpu/serving/kvtier.py: the same
store, handles, KVT1 disk framing and index rebuild.

The radix prefix cache (serving/prefix_cache.py) dies at the HBM pool
boundary: `evict_until` FREES LRU leaf pages, so a returning session
past pool pressure pays full quadratic recompute.  This module is
where those pages go instead: eviction DEMOTES a leaf's serialized
bytes (the `export_pages` gather + layout `sig`, exactly the
migration wire format) into a bounded host-RAM tier, cold host entries
demote further onto disk spill files, and an admission prefix-miss
consults the tiers before recomputing — promotion is the adopt
machinery verbatim (evict-aware alloc -> scatter -> trie `adopt`).

Granularity: ONE PAGE per entry, keyed by the raw int32 bytes of the
FULL token path root -> that page (so an entry is exactly a trie node
the HBM trie no longer holds).  Eviction demotes leaves one
generation at a time — a parent becomes demotable only after its
children left — so the store naturally accumulates the per-depth
chain the promoter walks: probe page base+1, base+2, ... until the
first miss, then adopt the consecutive run in one bucketed scatter.
Storage stays linear in chain depth (a whole-chain-per-entry design
would duplicate every shared ancestor per leaf).

Disk format (`<sha1(key)>.kvt`, written tmp+rename so a crashed
demotion never leaves a half-entry):

    b"KVT1" | u32 key_len | key | u32 meta_len | meta json
           | u32 crc32(blob) | u64 blob_len | blob

Loads go through `_tier_load` (mmap + CRC verify) — a method of its
own, so a fault injector (or a test) can make exactly that load fail,
and ANY
load failure is the clean-failure path by construction: the entry is
counted `corrupt`, deleted, and the caller falls back to recompute
without failing the ticket.  `_scan_disk` at construction rebuilds
the index from surviving spill files, which is what lets a prefix
outlive an engine kill + supervisor rebuild.

Thread-safety: all MUTATION (put/delete/eviction) happens on the
engine scheduler thread, like the pool and the trie; /metrics scrape
threads call stats()/collect(), and fleet probe threads call
contains()/longest_run() — every public method takes the store's own
lock, which never nests around the engine lock.  Disk IO runs OUTSIDE
the lock (a slow disk must not stall a scrape).
"""

from __future__ import annotations

import hashlib
import json
import mmap
import os
import struct
import threading
import zlib
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from . import observe as observe_mod

HOST = "host"
DISK = "disk"
TIERS = (HOST, DISK)

_MAGIC = b"KVT1"
_HDR = struct.Struct(">I")      # key_len / meta_len / crc
_LEN = struct.Struct(">Q")      # blob_len

# Promotion wall-time buckets: host loads are ~memcpy, disk loads ride
# the page cache or spin, and the +Inf tail is the probe that found a
# cold NFS mount.
TIER_FETCH_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0,
)


class TierCorrupt(RuntimeError):
    """A tier entry failed its CRC, framing, or layout check on load.
    The store has already counted it `corrupt` and deleted the entry
    by the time this propagates — the caller's only job is to fall
    back to recompute (never fail the ticket)."""


class TierHandle:
    """A checked-out tier entry: (tier, meta, blob) plus close().

    Handles are the tier analogue of a pool reference: the promotion
    path holds one per entry between get() and the trie commit, and
    `check_leaks` counts open handles as outstanding — a promotion that
    drops its handle on an exception path shows there, exactly like a
    leaked page reference."""

    __slots__ = ("key", "tier", "meta", "blob", "_store")

    def __init__(self, store, key, tier, meta, blob):
        self._store = store
        self.key = key
        self.tier = tier
        self.meta = meta
        self.blob = blob

    @property
    def n_pages(self) -> int:
        return int(self.meta.get("n_pages", 0))

    def close(self) -> None:
        """Idempotent release — success and unwind paths alike."""
        store, self._store = self._store, None
        if store is not None:
            store._handle_closed(self)


class TieredPageStore:
    """Bounded host-RAM LRU over serialized pages, spilling to a
    bounded disk LRU (both byte-capped).  `page_size` is recorded for
    key arithmetic only — entry layout rides each entry's own meta
    (`sig` — the adopter must match, exactly the migration rule)."""

    def __init__(self, page_size: int, host_bytes: int,
                 disk_dir: Optional[str] = None, disk_bytes: int = 0):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page = int(page_size)
        self.host_cap = max(0, int(host_bytes))
        self.disk_dir = disk_dir or None
        # disk_bytes <= 0 with a disk_dir means UNBOUNDED (the cap is
        # the operator's choice; the directory is the opt-in).
        self.disk_cap = (
            (float(disk_bytes) if int(disk_bytes) > 0 else float("inf"))
            if self.disk_dir else 0.0
        )
        if self.host_cap <= 0 and not self.disk_dir:
            raise ValueError(
                "a tiered store needs host_bytes > 0 and/or a disk_dir"
            )
        self._lock = threading.Lock()
        # key -> (meta, blob), LRU order (oldest first).
        self._host: "OrderedDict[bytes, tuple]" = OrderedDict()  # guarded-by: _lock
        self._host_bytes = 0  # guarded-by: _lock
        self._host_pages = 0  # guarded-by: _lock
        # key -> (path, n_pages, nbytes), LRU order (oldest first).
        self._disk: "OrderedDict[bytes, tuple]" = OrderedDict()  # guarded-by: _lock
        self._disk_bytes = 0  # guarded-by: _lock
        self._disk_pages = 0  # guarded-by: _lock
        self._open_handles = 0  # guarded-by: _lock
        self._c: Dict[str, int] = {  # guarded-by: _lock
            "demotions": 0,    # entries demoted INTO a tier (hbm->host,
                               # host->disk both count — downward moves)
            "promotions": 0,   # entries promoted back into HBM
            "evictions": 0,    # entries dropped off the cold end
            "hits": 0,         # get() found the entry
            "misses": 0,       # a promotion probe found nothing
            "corrupt": 0,      # CRC/framing/sig failures (entry deleted)
        }
        if self.disk_dir:
            os.makedirs(self.disk_dir, exist_ok=True)
            self._scan_disk()

    # -- keys ------------------------------------------------------------
    def key_of(self, tokens) -> bytes:
        """Raw int32 bytes of the token path — exact-match keys, no
        hashing (hash collisions would scatter the WRONG KV)."""
        return np.asarray(tokens, np.int32).reshape(-1).tobytes()

    # -- writes (scheduler thread) ---------------------------------------
    # owns-pages
    def put(self, key: bytes, meta: dict, blob: bytes) -> None:
        """Insert (or refresh) an entry in the host tier, demoting the
        cold end to disk (or evicting, diskless) while over the byte
        cap.  An entry larger than the host cap goes straight to
        disk.  Serialized bytes only — the caller's page references
        are NOT transferred (the demoting evictor still unrefs its
        trie hold; the store owns bytes, never pages)."""
        n_pages = int(meta.get("n_pages", 0))
        spill = []
        with self._lock:
            self._drop_locked(key)
            if self.host_cap >= len(blob):
                self._host[key] = (meta, blob)
                self._host_bytes += len(blob)
                self._host_pages += n_pages
                self._c["demotions"] += 1
                while self._host_bytes > self.host_cap and self._host:
                    k, (m, b) = self._host.popitem(last=False)
                    self._host_bytes -= len(b)
                    self._host_pages -= int(m.get("n_pages", 0))
                    spill.append((k, m, b))
            else:
                spill.append((key, meta, blob))
                self._c["demotions"] += 1
        for k, m, b in spill:
            self._spill_to_disk(k, m, b)

    def delete(self, key: bytes) -> None:
        with self._lock:
            path = self._drop_locked(key)
        if path:
            self._unlink(path)

    def mark_corrupt(self, key: bytes) -> None:
        """A consumer-side integrity failure (layout `sig` mismatch —
        the CRC passed but the bytes belong to a different pool
        layout): count and delete, same clean-failure bar as a CRC
        miss."""
        with self._lock:
            self._c["corrupt"] += 1
            path = self._drop_locked(key)
        if path:
            self._unlink(path)

    def note_miss(self) -> None:
        """A promotion probe that found no usable entry — counted by
        the prober (contains() itself stays count-free so scoring
        probes do not skew the hit rate)."""
        with self._lock:
            self._c["misses"] += 1

    def note_promoted(self, n_entries: int = 1) -> None:
        with self._lock:
            self._c["promotions"] += int(n_entries)

    # -- reads -----------------------------------------------------------
    def contains(self, key: bytes) -> Optional[str]:
        """Which tier holds `key` ("host"/"disk"), or None.  Count-free
        and LRU-neutral: placement probes must not rejuvenate entries
        they never load."""
        with self._lock:
            if key in self._host:
                return HOST
            if key in self._disk:
                return DISK
            return None

    def get(self, key: bytes) -> Optional[TierHandle]:
        """Check the entry out as a TierHandle (close() when the bytes
        are consumed or abandoned).  A disk entry that fails its load
        in ANY way — torn frame, CRC miss, an injected `tier_load`
        fault — is counted `corrupt`, deleted, and raised as
        TierCorrupt: the caller recomputes, the ticket never fails."""
        with self._lock:
            ent = self._host.get(key)
            if ent is not None:
                self._host.move_to_end(key)
                meta, blob = ent
                self._c["hits"] += 1
                self._open_handles += 1
                return self._make_handle(key, HOST, meta, blob)
            dent = self._disk.get(key)
            if dent is None:
                return None
            path = dent[0]
            self._disk.move_to_end(key)
        try:
            meta, blob = self._tier_load(path)
        except Exception as e:  # noqa: BLE001 — clean-failure by construction
            with self._lock:
                self._c["corrupt"] += 1
                path = self._drop_locked(key)
            if path:
                self._unlink(path)
            raise TierCorrupt(
                f"disk tier entry failed to load ({e!r}); entry "
                f"deleted, caller recomputes"
            ) from e
        with self._lock:
            self._c["hits"] += 1
            self._open_handles += 1
        return self._make_handle(key, DISK, meta, blob)

    def _make_handle(self, key, tier, meta, blob) -> TierHandle:
        """Handle construction seam — a leak-hunting subclass overrides
        this to stamp acquisition sites."""
        return TierHandle(self, key, tier, meta, blob)

    def _handle_closed(self, handle) -> None:
        with self._lock:
            self._open_handles -= 1

    def longest_run(self, tokens, start_page: int) -> List[str]:
        """Tiers of the consecutive tier-resident continuation of
        `tokens` from page `start_page` (0-based): element j is the
        tier holding page start_page + j; stops at the first page no
        tier holds.  Pure index walk — nothing loads, nothing
        rejuvenates."""
        toks = np.asarray(tokens, np.int32).reshape(-1)
        out: List[str] = []
        k = int(start_page) + 1
        while k * self.page <= toks.size:
            tier = self.contains(toks[: k * self.page].tobytes())
            if tier is None:
                break
            out.append(tier)
            k += 1
        return out

    # -- introspection ---------------------------------------------------
    def check_leaks(self) -> int:
        """Open handles — the tier half of the `kv_pages_in_use == 0`
        drain pin (open handles are outstanding references)."""
        with self._lock:
            return self._open_handles

    def stats(self) -> Dict[str, int]:
        with self._lock:
            s = {
                "kv_tier_host_entries": len(self._host),
                "kv_tier_host_pages": self._host_pages,
                "kv_tier_host_bytes": self._host_bytes,
                "kv_tier_disk_entries": len(self._disk),
                "kv_tier_disk_pages": self._disk_pages,
                "kv_tier_disk_bytes": self._disk_bytes,
                "kv_tier_open_handles": self._open_handles,
            }
            for k, v in self._c.items():
                s[f"kv_tier_{k}"] = v
        return s

    def collect(self) -> Iterable[observe_mod.MetricSnapshot]:
        """MetricSnapshot families for a Registry collector: labelled
        occupancy gauges plus the flow counters — rides the engine
        registry, so fleet relabelling stamps engine="i" on every
        sample for free."""
        s = self.stats()
        yield observe_mod.MetricSnapshot(
            "kv_tier_pages", "gauge",
            "Serialized KV pages resident per storage tier",
            [({"tier": t}, float(s[f"kv_tier_{t}_pages"]))
             for t in TIERS],
        )
        yield observe_mod.MetricSnapshot(
            "kv_tier_bytes", "gauge",
            "Serialized KV bytes resident per storage tier",
            [({"tier": t}, float(s[f"kv_tier_{t}_bytes"]))
             for t in TIERS],
        )
        for name in ("demotions", "promotions", "evictions",
                     "hits", "misses", "corrupt"):
            yield observe_mod.MetricSnapshot(
                f"kv_tier_{name}_total", "counter",
                f"Tiered KV store {name} (serving/kvtier.py)",
                [({}, float(s[f"kv_tier_{name}"]))],
            )

    # -- internals -------------------------------------------------------
    def _drop_locked(self, key: bytes) -> Optional[str]:  # holds-lock: _lock
        """Remove `key` from whichever index holds it; returns the
        spill path to unlink (outside the lock), if any."""
        ent = self._host.pop(key, None)
        if ent is not None:
            meta, blob = ent
            self._host_bytes -= len(blob)
            self._host_pages -= int(meta.get("n_pages", 0))
            return None
        dent = self._disk.pop(key, None)
        if dent is not None:
            path, n_pages, nbytes = dent
            self._disk_bytes -= nbytes
            self._disk_pages -= n_pages
            return path
        return None

    def _path_of(self, key: bytes) -> str:
        return os.path.join(
            self.disk_dir, hashlib.sha1(key).hexdigest() + ".kvt"
        )

    @staticmethod
    def _unlink(path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass  # already gone (a re-scan raced a delete) — harmless

    def _spill_to_disk(self, key: bytes, meta: dict,
                       blob: bytes) -> None:
        """host -> disk demotion (or eviction, when there is no disk
        tier or the entry exceeds its cap)."""
        if not self.disk_dir:
            with self._lock:
                self._c["evictions"] += 1
            return
        frame = self._frame(key, meta, blob)
        if len(frame) > self.disk_cap:
            with self._lock:
                self._c["evictions"] += 1
            return
        path = self._path_of(key)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(frame)
        os.replace(tmp, path)  # atomic: no reader ever sees a torn file
        n_pages = int(meta.get("n_pages", 0))
        drop: List[str] = []
        with self._lock:
            old = self._disk.pop(key, None)
            if old is not None:
                self._disk_bytes -= old[2]
                self._disk_pages -= old[1]
            self._disk[key] = (path, n_pages, len(frame))
            self._disk_bytes += len(frame)
            self._disk_pages += n_pages
            self._c["demotions"] += 1
            while self._disk_bytes > self.disk_cap and len(self._disk) > 1:
                _, (p, pages, nb) = self._disk.popitem(last=False)
                self._disk_bytes -= nb
                self._disk_pages -= pages
                self._c["evictions"] += 1
                drop.append(p)
        for p in drop:
            self._unlink(p)

    @staticmethod
    def _frame(key: bytes, meta: dict, blob: bytes) -> bytes:
        mj = json.dumps(meta, sort_keys=True).encode()
        return b"".join([
            _MAGIC,
            _HDR.pack(len(key)), key,
            _HDR.pack(len(mj)), mj,
            _HDR.pack(zlib.crc32(blob) & 0xFFFFFFFF),
            _LEN.pack(len(blob)), blob,
        ])

    @staticmethod
    def _parse_header(mm) -> Tuple[bytes, dict, int, int, int]:
        """(key, meta, crc, blob_off, blob_len) or ValueError on any
        framing violation."""
        if len(mm) < len(_MAGIC) + _HDR.size:
            raise ValueError("spill file truncated before header")
        if mm[: len(_MAGIC)] != _MAGIC:
            raise ValueError("bad spill magic")
        off = len(_MAGIC)
        (key_len,) = _HDR.unpack_from(mm, off)
        off += _HDR.size
        key = bytes(mm[off: off + key_len])
        off += key_len
        (meta_len,) = _HDR.unpack_from(mm, off)
        off += _HDR.size
        meta = json.loads(bytes(mm[off: off + meta_len]))
        off += meta_len
        (crc,) = _HDR.unpack_from(mm, off)
        off += _HDR.size
        (blob_len,) = _LEN.unpack_from(mm, off)
        off += _LEN.size
        if off + blob_len != len(mm):
            raise ValueError(
                f"spill blob length mismatch ({len(mm) - off} bytes, "
                f"header says {blob_len})"
            )
        return key, meta, crc, off, blob_len

    def _tier_load(self, path: str) -> Tuple[dict, bytes]:
        """mmap a spill file, verify framing + CRC, return (meta,
        blob).  THE fault seam: an injector wraps exactly this method
        as "tier_load", so an injected fault exercises the
        same corrupt-count/delete/recompute path a real torn file
        does."""
        with open(path, "rb") as f:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            try:
                _, meta, crc, off, blob_len = self._parse_header(mm)
                blob = bytes(mm[off: off + blob_len])
            finally:
                mm.close()
        if zlib.crc32(blob) & 0xFFFFFFFF != crc:
            raise ValueError(f"spill CRC mismatch for {path}")
        return meta, blob

    def _scan_disk(self) -> None:
        """Rebuild the disk index from surviving spill files — the
        engine-kill + supervisor-rebuild path: serialized prefixes
        outlive the process that demoted them.  Unreadable files are
        counted corrupt and deleted (a crashed writer's .tmp is simply
        removed — the rename never happened, so the entry never
        existed)."""
        for name in sorted(os.listdir(self.disk_dir)):
            path = os.path.join(self.disk_dir, name)
            if name.endswith(".tmp"):
                self._unlink(path)
                continue
            if not name.endswith(".kvt"):
                continue
            try:
                size = os.path.getsize(path)
                with open(path, "rb") as f:
                    mm = mmap.mmap(
                        f.fileno(), 0, access=mmap.ACCESS_READ
                    )
                    try:
                        key, meta, _, _, _ = self._parse_header(mm)
                    finally:
                        mm.close()
            except Exception:  # noqa: BLE001 — scan must not raise
                with self._lock:
                    self._c["corrupt"] += 1
                self._unlink(path)
                continue
            with self._lock:
                self._disk[key] = (
                    path, int(meta.get("n_pages", 0)), size
                )
                self._disk_bytes += size
                self._disk_pages += int(meta.get("n_pages", 0))
