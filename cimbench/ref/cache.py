"""Multi-level set-associative cache simulator (the trace VM's memory system).

Mirrors the slice of GEM5 the paper's Request/Access probes observe: every
load/store walks L1 -> L2 -> MEM with LRU replacement, write-back +
write-allocate, per-level banking, and a small MSHR file whose state is
recorded on each access (Table I "response from slave").

The simulator answers the question Eva-CiM's analysis stage needs per access:
*which level currently holds the line* (data locality for offload selection),
plus hit/miss statistics for the profiler.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

LINE = 64                                # bytes per cache line


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    name: str                            # "L1" | "L2"
    size: int                            # bytes
    assoc: int
    banks: int = 4
    mshrs: int = 8

    @property
    def n_sets(self) -> int:
        return max(1, self.size // (LINE * self.assoc))


# Paper §VI setup: 32KB/4-way L1 + 256KB/8-way L2 (validation), with
# 64KB/4-way and 2MB/8-way variants for the Fig. 14 DSE.
L1_32K = CacheConfig("L1", 32 * 1024, 4)
L1_64K = CacheConfig("L1", 64 * 1024, 4)
L2_256K = CacheConfig("L2", 256 * 1024, 8)
L2_2M = CacheConfig("L2", 2 * 1024 * 1024, 8)
SPM_1M = CacheConfig("L1", 1024 * 1024, 8)    # [23]-style single-level SPM


class _Level:
    __slots__ = ("cfg", "sets", "hits", "misses", "writebacks", "mshr")

    def __init__(self, cfg: CacheConfig):
        self.cfg = cfg
        # set index -> OrderedDict(tag -> dirty); LRU order = insertion order
        self.sets: List[OrderedDict] = [OrderedDict() for _ in range(cfg.n_sets)]
        self.hits = 0
        self.misses = 0
        self.writebacks = 0
        self.mshr: OrderedDict = OrderedDict()   # line -> outstanding count

    def lookup(self, line: int) -> bool:
        s = self.sets[line % self.cfg.n_sets]
        if line in s:
            s.move_to_end(line)
            self.hits += 1
            return True
        self.misses += 1
        return False

    def fill(self, line: int, dirty: bool = False) -> Optional[int]:
        """Insert line; returns evicted dirty line (writeback victim) or None."""
        s = self.sets[line % self.cfg.n_sets]
        victim = None
        if line in s:
            s[line] = s[line] or dirty
            s.move_to_end(line)
            return None
        if len(s) >= self.cfg.assoc:
            v_line, v_dirty = s.popitem(last=False)
            if v_dirty:
                self.writebacks += 1
                victim = v_line
        s[line] = dirty
        return victim

    def mark_dirty(self, line: int) -> None:
        s = self.sets[line % self.cfg.n_sets]
        if line in s:
            s[line] = True

    def mshr_probe(self, line: int) -> bool:
        """True if this miss merges into an in-flight MSHR entry."""
        if line in self.mshr:
            self.mshr[line] += 1
            return True
        if len(self.mshr) >= self.cfg.mshrs:
            self.mshr.popitem(last=False)            # oldest entry retires
        self.mshr[line] = 1
        return False

    def bank_of(self, addr: int) -> int:
        return (addr // LINE) % self.cfg.banks


@dataclasses.dataclass
class AccessResult:
    level: str                            # "L1" | "L2" | "MEM" (service level)
    hit: bool                             # hit at the *first* level probed
    bank: int                             # bank id at the service level
    mshr: bool                            # merged into an outstanding miss
    line: int


class CacheHierarchy:
    """L1 + optional L2 in front of main memory (inclusive, write-allocate).

    Two recording APIs drive the same simulator state:

      * :meth:`access` — one :class:`AccessResult` per call (the original
        probe-style interface, kept for tests and interactive use);
      * :meth:`replay` — batched access recording: an entire address
        stream in one call, returning the four memory-response *columns*
        (level/hit/bank/mshr codes) the columnar trace stores.  The trace
        VM emits the structural instruction stream once per workload and
        replays it here once per cache geometry.
    """

    def __init__(self, levels: Tuple[CacheConfig, ...] = (L1_32K, L2_256K)):
        self.levels = [_Level(c) for c in levels]
        self.mem_reads = 0
        self.mem_writes = 0

    # -- probes ----------------------------------------------------------
    def _access(self, addr: int, is_write: bool) -> Tuple[int, bool, int, bool]:
        """One access; returns (service-level index+1 [len+1 => MEM],
        first-level hit, bank, mshr-merged).  Lean core shared by
        :meth:`access` and :meth:`replay`."""
        line = addr // LINE
        levels = self.levels
        mshr_merged = False
        service = len(levels) + 1                     # sentinel: DRAM
        for i, lv in enumerate(levels):
            if lv.lookup(line):
                service = i + 1
                break
            mshr_merged = lv.mshr_probe(line) or mshr_merged
        else:
            self.mem_reads += 1                       # line fill from DRAM

        # allocate the line in every level above the service point
        for i in range(min(service - 1, len(levels))):
            lv = levels[i]
            victim = lv.fill(line)
            if victim is not None:
                self._writeback(victim, below=lv.cfg.name)
        if is_write:
            levels[0].mark_dirty(line)

        bank_level = levels[service - 1] if service <= len(levels) \
            else levels[-1]
        return service, service == 1, bank_level.bank_of(addr), mshr_merged

    def access(self, addr: int, is_write: bool) -> AccessResult:
        service, first_hit, bank, mshr = self._access(addr, is_write)
        name = (self.levels[service - 1].cfg.name
                if service <= len(self.levels) else "MEM")
        return AccessResult(name, first_hit, bank, mshr, addr // LINE)

    def replay(self, addrs, is_writes):
        """Batched access recording over a whole trace's memory stream.

        ``addrs`` / ``is_writes`` are parallel arrays (one entry per
        load/store in commit order).  Returns ``(level, hit, bank, mshr)``
        int8/int8/int16/bool numpy columns using the
        :data:`cimbench.ref.isa.LEVELS` level codes.  State evolution is
        identical to calling :meth:`access` element-by-element — the
        batched form only removes per-access Python/object overhead.
        """
        import numpy as np
        from cimbench.ref.isa import LEVEL_CODE, LEVEL_MEM

        n = len(addrs)
        level = np.empty(n, np.int8)
        hit = np.empty(n, np.int8)
        bank = np.empty(n, np.int16)
        mshr = np.empty(n, bool)
        addr_l = addrs.tolist() if hasattr(addrs, "tolist") else list(addrs)
        wr_l = (is_writes.tolist() if hasattr(is_writes, "tolist")
                else list(is_writes))
        access = self._access
        codes = [LEVEL_CODE[lv.cfg.name] for lv in self.levels] + [LEVEL_MEM]
        # L1-hit fast path (the overwhelmingly common case), inlined with
        # the level's internals bound to locals; every miss falls back to
        # the shared `_access` core, so state evolution stays identical.
        l1 = self.levels[0]
        l1_sets = l1.sets
        l1_nsets = l1.cfg.n_sets
        l1_banks = l1.cfg.banks
        l1_code = codes[0]
        l1_hits = 0
        for i in range(n):
            addr = addr_l[i]
            line = addr // LINE
            s = l1_sets[line % l1_nsets]
            if line in s:
                s.move_to_end(line)
                l1_hits += 1
                if wr_l[i]:
                    s[line] = True               # mark_dirty (line present)
                level[i] = l1_code
                hit[i] = True
                bank[i] = line % l1_banks
                mshr[i] = False
                continue
            l1.hits += l1_hits                   # flush before shared core
            l1_hits = 0
            service, first_hit, b, m = access(addr, wr_l[i])
            level[i] = codes[service - 1] if service - 1 < len(codes) \
                else LEVEL_MEM
            hit[i] = first_hit
            bank[i] = b
            mshr[i] = m
        l1.hits += l1_hits
        return level, hit, bank, mshr

    # -- counter snapshot (store rehydration) -----------------------------
    def counters(self) -> Dict[str, int]:
        out = {"mem_reads": self.mem_reads, "mem_writes": self.mem_writes}
        for lv in self.levels:
            out[f"{lv.cfg.name}_hits"] = lv.hits
            out[f"{lv.cfg.name}_misses"] = lv.misses
            out[f"{lv.cfg.name}_writebacks"] = lv.writebacks
        return out

    def restore_counters(self, counters: Dict[str, int]) -> None:
        """Restore hit/miss statistics (the persisted layer-1 .npz keeps
        counters, not the full LRU set state — nothing downstream of a
        finished trace reads the sets)."""
        self.mem_reads = int(counters.get("mem_reads", 0))
        self.mem_writes = int(counters.get("mem_writes", 0))
        for lv in self.levels:
            lv.hits = int(counters.get(f"{lv.cfg.name}_hits", 0))
            lv.misses = int(counters.get(f"{lv.cfg.name}_misses", 0))
            lv.writebacks = int(counters.get(f"{lv.cfg.name}_writebacks", 0))

    def _writeback(self, line: int, below: str) -> None:
        """Victim from `below` written into the next level (or DRAM)."""
        seen = False
        for lv in self.levels:
            if seen:
                victim = lv.fill(line, dirty=True)
                if victim is not None:
                    self._writeback(victim, below=lv.cfg.name)
                return
            seen = lv.cfg.name == below
        self.mem_writes += 1

    # -- residency query used by offload selection ------------------------
    def residency(self, addr: int) -> str:
        line = addr // LINE
        for lv in self.levels:
            if line in lv.sets[line % lv.cfg.n_sets]:
                return lv.cfg.name
        return "MEM"

    def bank_of(self, addr: int, level: str) -> int:
        for lv in self.levels:
            if lv.cfg.name == level:
                return lv.bank_of(addr)
        return 0

    # -- stats -------------------------------------------------------------
    def stats(self) -> Dict[str, Dict[str, int]]:
        out = {}
        for lv in self.levels:
            out[lv.cfg.name] = {"hits": lv.hits, "misses": lv.misses,
                                "writebacks": lv.writebacks,
                                "size": lv.cfg.size, "assoc": lv.cfg.assoc}
        out["MEM"] = {"reads": self.mem_reads, "writes": self.mem_writes}
        return out
