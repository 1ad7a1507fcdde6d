"""The port's kernel modules against the reference's, on the CPU.

On the CPU each kernel wrapper of ``repro_torch.core.accel`` takes its
plain version, so these tests hold those plain versions -- the arithmetic
the CUDA kernels must reproduce -- to the reference's kernels:

  * ``segment_sum`` / ``segment_max`` against the reference's Pallas
    kernels run in interpret mode (as ``tests/test_accel.py`` runs them),
    with empty segments, out-of-range ids and ``n = 0``;
  * placement (``place_candidates``, the placement kernel's plain version,
    as ``offload._place`` calls it) against ``place_candidates_jax`` with
    the Pallas segment kernels forced on, and against the numpy ``_place``
    (more cases in ``tests/test_torch_place.py``);
  * the replay (``CacheHierarchy.replay`` + ``counters``, through
    ``replay_columns_batch``) against the reference's batched jax replay
    and its OrderedDict machine, on fuzzed streams;
  * pricing's counts (``price_counts``, through the profiler's
    ``count_trace``) against the op chain of bincounts, gathers and
    readbacks the profiler ran before the count kernel, on the 17 traces
    and on edge cases.

All comparisons are exact: the pipeline is integer.  The CUDA kernels are
held to these plain versions by ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` on the card.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")  # CI images without torch skip the port

from repro.core import accel as ref_accel
from repro.core.accel import pallas_ops as ref_pallas
from repro.core.accel.place import place_candidates_jax
from repro.core.accel.replay import replay_columns_batch as ref_replay_batch
from repro.core.cache import CacheConfig as RefCacheConfig
from repro.core.cache import CacheHierarchy as RefHierarchy
from repro.core.idg import IDGBuilder as RefIDGBuilder
from repro.core.idg import build_flow_index as ref_flow
from repro.core.offload import OffloadConfig as RefOffloadConfig
from repro.core.offload import _partition as ref_partition
from repro.core.offload import _place as ref_place
from repro.core.trace import attach_cache_results, trace_structural

from repro_torch.core.accel import price_counts as pc_mod
from repro_torch.core.accel.pallas_ops import (INT32_MIN, segment_max,
                                               segment_sum)
from repro_torch.core.accel.place import place_candidates
from repro_torch.core.accel.price_counts import price_counts
from repro_torch.core.accel.replay import replay_columns_batch
from repro_torch.core.cache import CacheConfig, L1_32K, L1_64K, L2_256K, \
    L2_2M, SPM_1M
from repro_torch.core.columnar import ColumnarTrace
from repro_torch.core.idg import IDGBuilder, build_flow_index
from repro_torch.core.isa import LEVEL_L1, OP_STORE, UNITS
from repro_torch.core.offload import (OffloadConfig, _partition, _place,
                                      analyze_trace)
from repro_torch.core.profiler import count_trace
from repro_torch.core.reshape import reshape
from repro_torch.core.trace import attach_cache_results as port_attach
from repro_torch.dse.space import CIM_SETS
from repro_torch.workloads import fixtures


def _g(sets, assoc, banks, mshrs, name="L1"):
    return CacheConfig(name, sets * 64 * assoc, assoc, banks=banks,
                       mshrs=mshrs)


# the reference's differential geometries (tests/test_accel.py), plus one
# with sets, banks and MSHR files that are not powers of two
GEOMETRIES = (
    (_g(1, 1, 1, 1),),
    (_g(4, 4, 4, 2),),
    (_g(1, 4, 2, 1),),
    (_g(4, 1, 1, 2), _g(4, 4, 4, 2, "L2")),
    (_g(1, 1, 1, 1), _g(4, 1, 2, 1, "L2")),
    (_g(4, 4, 4, 2), _g(4, 4, 1, 2, "L2")),
    (_g(1, 2, 2, 2), _g(1, 4, 4, 1, "L2")),
    (_g(3, 2, 3, 3), _g(5, 3, 3, 5, "L2")),
)
PRESETS = ((L1_32K, L2_256K), (L1_64K, L2_256K), (L1_64K, L2_2M), (SPM_1M,))
_OPS = ("add", "xor", "and", "or", "sub", "max")
_JNP_OP = {"add": "add", "xor": "bitwise_xor", "and": "bitwise_and",
           "or": "bitwise_or", "sub": "subtract", "max": "maximum"}
LEVEL_SETS = (("L1", "L2"), ("L1",), ("L2",))


def ref_geometry(levels):
    return tuple(RefCacheConfig(**dataclasses.asdict(c)) for c in levels)


def cand_tuple(c):
    return (c.root_seq, tuple(c.op_seqs), tuple(c.op_classes),
            tuple(c.load_seqs), tuple(c.store_seqs), c.level, c.bank,
            c.moves, c.internal_edges, c.added_loads, c.memval_leaves,
            c.dram_fills)


# ======================================================================
# segment reductions: plain versions vs the Pallas kernels
# ======================================================================
SEGMENT_CASES = [(0, 5), (1, 1), (7, 40), (130, 3), (300, 17), (1100, 33),
                 (2049, 129), (513, 1)]


@pytest.mark.parametrize("n,n_seg", SEGMENT_CASES)
def test_plain_segment_ops_match_pallas(n, n_seg):
    rng = np.random.default_rng(n * 131 + n_seg)
    # ids beyond n_segments (and negative ones) must be dropped; with few
    # elements per segment some segments stay empty
    ids = rng.integers(-2, n_seg + 3, n).astype(np.int32)
    vals = rng.integers(-1000, 1000, n).astype(np.int32)
    got_sum = segment_sum(torch.from_numpy(vals), torch.from_numpy(ids),
                          n_seg)
    got_max = segment_max(torch.from_numpy(vals), torch.from_numpy(ids),
                          n_seg)
    want_sum = np.asarray(ref_pallas.segment_sum(jnp.asarray(vals),
                                                 jnp.asarray(ids), n_seg))
    want_max = np.asarray(ref_pallas.segment_max(jnp.asarray(vals),
                                                 jnp.asarray(ids), n_seg))
    assert got_sum.dtype == got_max.dtype == torch.int32
    assert np.array_equal(got_sum.numpy(), want_sum)
    assert np.array_equal(got_max.numpy(), want_max)
    # and the XLA ops both stand in for
    assert np.array_equal(got_sum.numpy(), np.asarray(jax.ops.segment_sum(
        jnp.asarray(vals), jnp.asarray(ids), num_segments=n_seg)))
    empty = np.setdiff1d(np.arange(n_seg), ids)
    assert (got_max.numpy()[empty] == INT32_MIN).all()


def test_segment_ops_reject_what_the_kernel_does_not_take():
    v = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        segment_sum(v.to(torch.int64), v, 2)
    with pytest.raises(ValueError):
        segment_max(v, v[:3], 2)


# ======================================================================
# placement vs place_candidates_jax (Pallas forced on) and numpy _place
# ======================================================================
PLACE_CASES = [(n, seed, op, gi, li)
               for n, seed, op, gi, li in ((6, 0, "add", 3, 0),
                                           (12, 1, "xor", 5, 0),
                                           (20, 2, "max", 4, 2),
                                           (9, 3, "sub", 1, 1),
                                           (16, 4, "and", 6, 0),
                                           (24, 5, "or", 7, 2))]


@pytest.mark.parametrize("n,seed,op,gi,li", PLACE_CASES)
def test_placement_matches_place_candidates_jax(n, seed, op, gi, li,
                                                monkeypatch):
    monkeypatch.setenv("EVA_CIM_PALLAS", "1")   # interpret-mode Pallas ops
    geo = GEOMETRIES[gi]
    levels = LEVEL_SETS[li] if len(geo) > 1 else ("L1",)
    r = np.random.default_rng(seed + 13)
    a = jnp.asarray(r.integers(0, 100, (n,)), jnp.int32)
    b = jnp.asarray(r.integers(1, 100, (n,)), jnp.int32)
    f1 = getattr(jnp, _JNP_OP[op])

    def prog(a, b):
        c = f1(a, b)
        return jnp.sum(c ^ a) + jnp.max(c)

    with ref_accel.use_backend("numpy"):
        ref_ct = attach_cache_results(trace_structural(prog, a, b),
                                      ref_geometry(geo)).trace
    ref_cfg = RefOffloadConfig(cim_levels=levels)
    ref_part = ref_partition(ref_ct, RefIDGBuilder(ref_ct), ref_flow(ref_ct),
                             ref_cfg)
    want = [cand_tuple(c) for c in place_candidates_jax(ref_part, ref_ct,
                                                        ref_cfg)]
    with ref_accel.use_backend("numpy"):
        assert [cand_tuple(c) for c in ref_place(ref_part, ref_ct,
                                                 ref_cfg)] == want
    assert want, "the program must yield candidates"

    ct = ColumnarTrace.from_arrays(ref_ct.to_arrays(), device="cpu")
    cfg = OffloadConfig(cim_levels=levels)
    part = _partition(ct, IDGBuilder(ct), build_flow_index(ct), cfg)
    assert part.claimed == ref_part.claimed
    assert [cand_tuple(c) for c in place_candidates(part, ct, cfg)] == want
    assert [cand_tuple(c) for c in _place(part, ct, cfg)] == want


# ======================================================================
# replay: the plain version vs the reference's jax replay and oracle
# ======================================================================
def _check_replay(addrs, wr, geos):
    want = ref_replay_batch(addrs, wr, [ref_geometry(g) for g in geos])
    got = replay_columns_batch(torch.from_numpy(addrs),
                               torch.from_numpy(wr), geos)
    assert len(got) == len(geos)
    for levels, w, g in zip(geos, want, got):
        oracle = RefHierarchy(ref_geometry(levels))
        cols = oracle.replay(addrs, wr)
        for name, ref_col, jax_col, col in zip(("level", "hit", "bank",
                                                "mshr"), cols, w[:4], g[:4]):
            assert col.numpy().dtype == ref_col.dtype, name
            assert np.array_equal(col.numpy(), ref_col), name
            assert np.array_equal(col.numpy(), jax_col), name
        assert g[4] == w[4] == oracle.counters()


@pytest.mark.parametrize("seed", range(12))
def test_plain_replay_matches_reference_fuzzed(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 90))
    enc = rng.integers(0, 2 * 26 * 64, n)       # bit 0: the store flag
    addrs = (enc >> 1).astype(np.int64)
    wr = (enc & 1).astype(bool)
    picks = rng.choice(len(GEOMETRIES), size=int(rng.integers(1, 4)))
    _check_replay(addrs, wr, [GEOMETRIES[i] for i in picks])


def test_plain_replay_matches_reference_on_presets():
    """A real workload's stream under the fig14 presets and SPM_1M."""
    from repro_torch.core.isa import OP_STORE
    from repro_torch.workloads import fixtures
    ct = fixtures.load_structural("KM", device="cpu").columns
    mem = ct.mem_mask
    _check_replay(ct.addr[mem].numpy(), (ct.op[mem] == OP_STORE).numpy(),
                  list(PRESETS))


# ======================================================================
# replay: the CUDA kernel's order of work, emulated
# ======================================================================
def _emulate_replay_kernel(addrs, wr, levels, word=None, stop_at_miss=True,
                           reprobe=True, last_writer=True):
    """The order of work of ``csrc/replay.cu`` for one geometry, in Python:
    set-local tags and LRU stamps in ``word``-byte words that wrap as the
    kernel's do (default: what ``word_bytes`` picks for the stream); a
    step of ``STEP`` accesses probed at once against the first level's
    tags, every hit before the first miss resolved together (stamps touch
    + 1, touch + 2, ... in stream order, the largest kept: the last access
    to each way; dirty bits for the writes), then that miss on its own,
    then the rest of the step probed again; the level, hit and bank
    columns computed per access after the step.  ``stop_at_miss=False``
    resolves every hit of a probe, also those after a miss,
    ``reprobe=False`` keeps every probe after a miss, and
    ``last_writer=False`` lets the first access to a way write its stamp:
    all wrong, to show the rules matter.  Returns what
    ``replay_columns_batch`` returns for it."""
    from repro_torch.core.accel.replay import STEP, word_bytes
    from repro_torch.core.isa import LEVEL_CODE, LEVEL_MEM

    lines = [int(a) >> 6 for a in addrs]
    wr = [bool(w) for w in wr]
    n, L = len(lines), len(levels)
    if word is None:
        word = word_bytes(n, max(lines, default=0), [levels])
    mask = (1 << (8 * word)) - 1              # also the empty-way mark
    sets = [c.n_sets for c in levels]
    assoc = [c.assoc for c in levels]
    tags = [[mask] * (s * a) for s, a in zip(sets, assoc)]
    stamp = [[0] * (s * a) for s, a in zip(sets, assoc)]
    dirty = [[0] * (s * a) for s, a in zip(sets, assoc)]
    mline = [[-1] * c.mshrs for c in levels]
    mstamp = [[0] * c.mshrs for c in levels]
    hits, misses, wbs = [0] * L, [0] * L, [0] * L
    mem = {"reads": 0, "writes": 0}
    touch = [0]

    def split(l, line):
        return line % sets[l], (line // sets[l]) & mask

    def bump():
        touch[0] = (touch[0] + 1) & mask
        return touch[0]

    def lookup(l, line):
        s, tag = split(l, line)
        for w in range(assoc[l]):
            if tags[l][s * assoc[l] + w] == tag:
                stamp[l][s * assoc[l] + w] = bump()
                return True
        return False

    def mshr_probe(l, line, t):
        slots = mline[l]
        if line in slots:
            return True
        occ = [w for w, x in enumerate(slots) if x >= 0]
        w = (min(occ, key=lambda w: (mstamp[l][w], w))
             if len(occ) >= len(slots) else slots.index(-1))
        slots[w], mstamp[l][w] = line, t & mask
        return False

    def fill(l, line, dirty_in):
        """(dirty victim line or None, index of the way now holding it)."""
        s, tag = split(l, line)
        base, ways = s * assoc[l], range(assoc[l])
        t = bump()
        for w in ways:
            if tags[l][base + w] == tag:
                dirty[l][base + w] |= dirty_in
                stamp[l][base + w] = t
                return None, base + w
        victim = None
        if all(tags[l][base + w] != mask for w in ways):
            w = min(ways, key=lambda w: (stamp[l][base + w], w))
            if dirty[l][base + w]:
                victim = tags[l][base + w] * sets[l] + s
                wbs[l] += 1
        else:
            w = next(w for w in ways if tags[l][base + w] == mask)
        tags[l][base + w], dirty[l][base + w] = tag, int(dirty_in)
        stamp[l][base + w] = t
        return victim, base + w

    def probe(t):                             # one lane: its way's index
        s, tag = split(0, lines[t])
        row = tags[0][s * assoc[0]:(s + 1) * assoc[0]]
        return s * assoc[0] + row.index(tag) if tag in row else None

    def miss(t):                              # the whole warp, one access
        line = lines[t]
        misses[0] += 1
        merged = mshr_probe(0, line, t)
        service = L + 1
        for l in range(1, L):
            if lookup(l, line):
                service = l + 1
                hits[l] += 1
                break
            misses[l] += 1
            merged = mshr_probe(l, line, t) or merged
        if service == L + 1:
            mem["reads"] += 1
        for i in range(service - 1):
            victim, idx = fill(i, line, False)
            if i == 0:
                idx0 = idx
            for m in range(i + 1, L):
                if victim is not None:
                    victim, _ = fill(m, victim, True)
            if victim is not None:
                mem["writes"] += 1
        if wr[t]:
            dirty[0][idx0] = 1
        return service, merged

    service_col, merged_col = [1] * n, [False] * n
    for t0 in range(0, n, STEP):
        todo = list(range(t0, min(n, t0 + STEP)))
        way = {t: probe(t) for t in todo}
        while todo:
            first = next((t for t in todo if way[t] is None), None)
            pre = [t for t in todo if way[t] is not None
                   and (first is None or t < first or not stop_at_miss)]
            writer = {}
            for r, t in enumerate(pre):       # stamps in access order
                if last_writer or way[t] not in writer:
                    writer[way[t]] = (touch[0] + 1 + r) & mask
                if wr[t]:
                    dirty[0][way[t]] = 1
            for idx, st in writer.items():
                stamp[0][idx] = st
            touch[0] = (touch[0] + len(pre)) & mask
            hits[0] += len(pre)
            todo = [t for t in todo if t not in pre]
            if first is None:
                break
            service_col[first], merged_col[first] = miss(first)
            todo.remove(first)
            if reprobe:
                way = {t: probe(t) for t in todo}

    codes = [LEVEL_CODE[c.name] for c in levels] + [LEVEL_MEM]
    level = [codes[s - 1] for s in service_col]
    hit = [int(s == 1) for s in service_col]
    bank = [x % levels[min(s, L) - 1].banks
            for x, s in zip(lines, service_col)]
    counters = {"mem_reads": mem["reads"], "mem_writes": mem["writes"]}
    for l, c in enumerate(levels):
        counters[f"{c.name}_hits"] = hits[l]
        counters[f"{c.name}_misses"] = misses[l]
        counters[f"{c.name}_writebacks"] = wbs[l]
    return (torch.tensor(level, dtype=torch.int8),
            torch.tensor(hit, dtype=torch.int8),
            torch.tensor(bank, dtype=torch.int16),
            torch.tensor(merged_col, dtype=torch.bool), counters)


def _emulation_equals_plain(addrs, wr, geos, **kw):
    """True when the emulation gives the OrderedDict machine's columns and
    counters under every geometry of ``geos``."""
    want = replay_columns_batch(torch.as_tensor(addrs, dtype=torch.int64),
                                torch.as_tensor(wr, dtype=torch.bool), geos)
    for levels, w in zip(geos, want):
        got = _emulate_replay_kernel(addrs, wr, levels, **kw)
        if got[4] != w[4]:
            return False
        for a, b in zip(got[:4], w[:4]):
            if a.dtype != b.dtype or not torch.equal(a, b):
                return False
    return True


def _stream_with_runs(seed, n_lines=24, length=300):
    """(addrs, writes): a random walk over ``n_lines`` lines in which each
    access repeats the last line for a random run (1 to 40 accesses, so
    some runs cross a lane group of 32 and a step of 64), stores spread
    over the runs."""
    rng = np.random.default_rng(seed)
    addrs = []
    while len(addrs) < length:
        line = int(rng.integers(0, n_lines))
        addrs += [line * 64 + int(o) for o in
                  rng.integers(0, 64, int(rng.integers(1, 41)))]
    addrs = np.array(addrs[:length], dtype=np.int64)
    return addrs, rng.random(length) < 0.3


@pytest.mark.parametrize("seed", range(12))
def test_replay_kernel_emulation_matches_plain_fuzzed(seed):
    """The kernel's order of work equals the OrderedDict machine on fuzzed
    streams with runs of repeats, under geometries small enough to miss,
    evict and write back often."""
    addrs, wr = _stream_with_runs(seed)
    assert _emulation_equals_plain(addrs, wr, list(GEOMETRIES))


def test_replay_kernel_emulation_matches_plain_on_presets():
    from repro_torch.core.isa import OP_STORE
    from repro_torch.workloads import fixtures
    ct = fixtures.load_structural("KM", device="cpu").columns
    mem = ct.mem_mask
    assert _emulation_equals_plain(ct.addr[mem].numpy(),
                                   (ct.op[mem] == OP_STORE).numpy(),
                                   list(PRESETS))


def _edge_stream(name):
    one_way = [(_g(1, 1, 1, 1), _g(2, 1, 1, 1, "L2"))]
    if name.startswith("length "):            # around a group and a step
        n = int(name.split()[1])
        return [64 * (i % 5) for i in range(n)], [i % 3 == 0
                                                  for i in range(n)], None
    if name == "run across a group":          # accesses 20..49 repeat
        addrs = [64 * (i % 7) for i in range(20)] + [64 * 3] * 30 \
            + [64 * (i % 4) for i in range(15)]
        return addrs, [False] * len(addrs), None
    if name == "run across a step":           # accesses 50..109 repeat
        addrs = [64 * (i % 11) for i in range(50)] + [64 * 6] * 60 \
            + [64 * (i % 13) for i in range(30)]
        return addrs, [i in (60, 70) for i in range(len(addrs))], None
    if name == "write inside a run":
        addrs = [64, 128] + [192] * 40 + [64, 128, 192, 256]
        return addrs, [i == 20 for i in range(len(addrs))], None
    if name == "dirty eviction after a run":  # the run's line leaves dirty
        addrs = [0] * 10 + [64, 128, 192] + [0] * 35 + [64]
        return addrs, [i in (3, 40) for i in range(len(addrs))], one_way
    if name == "one repeated line":
        return [320] * 70, [i % 2 == 0 for i in range(70)], None
    if name == "one set":                     # every line in set 0
        addrs = [64 * 4 * (i % 9) for i in range(90)]
        return addrs, [i % 4 == 0 for i in range(90)], None
    raise KeyError(name)


EDGE_STREAMS = ("length 0", "length 1", "length 31", "length 32",
                "length 33", "length 63", "length 64", "length 65",
                "run across a group", "run across a step",
                "write inside a run", "dirty eviction after a run",
                "one repeated line", "one set")


@pytest.mark.parametrize("name", EDGE_STREAMS)
def test_replay_kernel_emulation_on_edge_streams(name):
    addrs, wr, geos = _edge_stream(name)
    assert _emulation_equals_plain(np.array(addrs, dtype=np.int64),
                                   np.array(wr, dtype=bool),
                                   geos or list(GEOMETRIES))


def test_replay_hits_after_a_miss_are_probed_again():
    """A, B, A with A cached: the probe finds both A's, but B evicts A
    from the one-way first level, so the second A must miss."""
    addrs = np.array([0] * 32 + [0, 64, 0], dtype=np.int64)
    wr = np.zeros(len(addrs), bool)
    geos = [(_g(1, 1, 1, 1), _g(2, 1, 1, 1, "L2"))]
    assert _emulation_equals_plain(addrs, wr, geos)
    assert not _emulation_equals_plain(addrs, wr, geos, stop_at_miss=False)
    assert not _emulation_equals_plain(addrs, wr, geos, reprobe=False)


def test_replay_last_access_to_a_way_writes_its_stamp():
    """X, Y, X then Z in a two-way set: X was touched last, so Z evicts
    Y (a dirty Y: the writeback tells which way went)."""
    addrs = np.array([0, 64, 0, 64, 0, 128, 64], dtype=np.int64)
    wr = np.array([False, True, False, False, False, False, False])
    geos = [(_g(1, 2, 1, 1), _g(1, 8, 1, 1, "L2"))]
    assert _emulation_equals_plain(addrs, wr, geos)
    assert not _emulation_equals_plain(addrs, wr, geos, last_writer=False)


def test_replay_word_choice_and_its_guard():
    """32-bit words where the stream fits them; beyond, 32-bit set-local
    tags would alias, and the guard picks 64 bits."""
    from repro_torch.core.accel.replay import first_level_shared, word_bytes
    geos = list(PRESETS)
    # SPM_1M's 16,384 ways fit in shared memory in 32-bit words only
    assert first_level_shared([(SPM_1M,)], 4)
    assert not first_level_shared([(SPM_1M,)], 8)
    assert word_bytes(30_438, 527, geos) == 4
    assert word_bytes(2 ** 31, 527, geos) == 8            # stamps
    sets = min(c.n_sets for g in geos for c in g)
    assert word_bytes(10, sets * (2 ** 32 - 2), geos) == 4
    assert word_bytes(10, sets * (2 ** 32 - 1), geos) == 8  # tags
    # one set: lines 0 and 2**32 share a 32-bit tag
    geo = [(_g(1, 2, 1, 1), _g(1, 4, 1, 1, "L2"))]
    addrs = np.array([0, 64 << 32, 0, 64, 64 << 32], dtype=np.int64)
    wr = np.zeros(len(addrs), bool)
    assert word_bytes(len(addrs), int(addrs.max()) >> 6, geo) == 8
    assert _emulation_equals_plain(addrs, wr, geo)
    assert not _emulation_equals_plain(addrs, wr, geo, word=4)


# ======================================================================
# pricing's counts: the plain version against the op chain it replaced
# ======================================================================
PRICE_CIM_SETS = ("logic", "full")
_priced_traces = {}


def _priced_trace(name):
    """Workload ``name`` at 32K+256K on the CPU and its IDG artifacts."""
    got = _priced_traces.get(name)
    if got is None:
        tr = port_attach(fixtures.load_structural(name, device="cpu"),
                         (L1_32K, L2_256K), device="cpu")
        got = _priced_traces[name] = (tr.trace, analyze_trace(tr))
    return got


def _converted_seqs(result):
    return [s for c in result.candidates for s in c.load_seqs + c.store_seqs]


def _present_chain(trace, host_seqs, seqs):
    """The counts as pricing made them before the count kernel: two
    bincounts and their readbacks per histogram pair, the gathers at
    ``host_seqs``, the memory mask's sum and the converted accesses' level
    gather (``Profiler._unit_counts`` / ``_mem_counts``,
    ``OffloadResult.macr_breakdown``)."""
    def unit_counts(unit_col):
        return torch.bincount(unit_col.to(torch.int64),
                              minlength=len(UNITS)).tolist()

    def mem_counts(level_col, is_store_col):
        mem = level_col > 0
        combo = level_col[mem].to(torch.int64) * 2 \
            + is_store_col[mem].to(torch.int64)
        counts = torch.bincount(combo).tolist()
        return {(c // 2, c % 2): n for c, n in enumerate(counts) if n}

    hs = host_seqs
    l1 = 0
    if seqs:
        lv = trace.level[torch.tensor(seqs, dtype=torch.int64)]
        l1 = int((lv == LEVEL_L1).sum())
    return dict(units=unit_counts(trace.unit),
                mem=mem_counts(trace.level, trace.op == OP_STORE),
                host_units=unit_counts(trace.unit[hs]),
                host_mem=mem_counts(trace.level[hs],
                                    trace.op[hs] == OP_STORE),
                mem_accesses=trace.mem_accesses(), converted=len(seqs),
                converted_l1=l1)


@pytest.mark.parametrize("cim_set", PRICE_CIM_SETS)
@pytest.mark.parametrize("levels", LEVEL_SETS)
@pytest.mark.parametrize("name", fixtures.WORKLOADS)
def test_price_counts_plain_matches_present_chain(name, levels, cim_set):
    """Every count of the 17 Table-IV traces at 32K+256K, under each CiM
    level set and the logic and full op sets, ``==`` the op chain."""
    trace, analysis = _priced_trace(name)
    result = analysis.select(OffloadConfig(cim_levels=levels,
                                           cim_set=CIM_SETS[cim_set]))
    hs = reshape(trace, result).host_seqs
    seqs = _converted_seqs(result)
    conv = torch.tensor(seqs, dtype=torch.int64)
    got = count_trace(trace, hs, conv)
    assert dataclasses.asdict(got) == _present_chain(trace, hs, seqs)
    # the dict order the profiler's float sums follow: ascending codes
    assert list(got.mem) == sorted(got.mem)
    assert list(got.host_mem) == sorted(got.host_mem)
    raw = price_counts(trace.unit, trace.level, trace.op, hs, conv)
    assert len(raw) == pc_mod.N_OUT and raw[pc_mod.BAD] == 0
    assert raw[pc_mod.MEM_ROWS] == trace.mem_accesses()


def _tiny_trace(unit, level, op):
    """A trace of the given columns alone (what the counts read)."""
    return types.SimpleNamespace(unit=torch.tensor(unit, dtype=torch.int8),
                                 level=torch.tensor(level, dtype=torch.int8),
                                 op=torch.tensor(op, dtype=torch.int16))


def _rows_of(trace, keep):
    """The rows ``keep`` of ``trace`` as a trace of their own (operands
    dropped: the counts read none)."""
    return ColumnarTrace(
        keep.numel(), *(getattr(trace, c)[keep] for c in (
            "op", "unit", "dtype", "dst", "addr", "size", "level", "hit",
            "bank", "mshr")),
        torch.zeros(keep.numel() + 1, dtype=torch.int64),
        trace.src_tag[:0], trace.src_val[:0], trace.src_kind[:0],
        n_regs=trace.n_regs)


PRICE_EDGES = ("empty host_seqs", "no candidates", "no memory row",
               "empty trace", "host_seqs on the CPU")


@pytest.mark.parametrize("case", PRICE_EDGES)
def test_price_counts_edge_cases_match_present_chain(case):
    if case in ("empty trace", "no memory row"):
        trace, _ = _priced_trace("NB")
        keep = torch.nonzero(trace.level == 0).flatten()
        if case == "empty trace":
            keep = keep[:0]
        trace = _rows_of(trace, keep)
        assert int((trace.level > 0).sum()) == 0
        hs, seqs = torch.arange(0, keep.numel(), 3), []
    else:
        trace, analysis = _priced_trace("KM")
        result = analysis.select(OffloadConfig())
        hs = reshape(trace, result).host_seqs
        seqs = _converted_seqs(result)
        if case == "empty host_seqs":
            hs = torch.zeros(0, dtype=torch.int64)
        elif case == "no candidates":
            result = analysis.select(OffloadConfig(cim_set=frozenset()))
            assert not result.candidates
            hs, seqs = reshape(trace, result).host_seqs, []
        else:
            assert hs.device.type == "cpu" and seqs
    conv = torch.tensor(seqs, dtype=torch.int64)
    got = dataclasses.asdict(count_trace(trace, hs, conv))
    assert got == _present_chain(trace, hs, seqs)
    if case == "empty host_seqs":
        assert got["host_units"] == [0] * len(UNITS) and not got["host_mem"]
    if case == "no memory row":
        assert not got["mem"] and not got["host_mem"]


@pytest.mark.parametrize("bad", ("unit 16", "unit -1", "level 4",
                                 "host_seqs past the end", "conv below 0"))
def test_price_counts_refuses_what_the_trace_does_not_hold(bad):
    unit, level, op = [0, 3, 7, 10], [0, 1, 2, 3], [2, 0, 1, 0]
    hs = torch.tensor([0, 2], dtype=torch.int64)
    conv = torch.tensor([1, 3], dtype=torch.int64)
    if bad.startswith("unit"):
        unit[1] = int(bad.split()[1])
    elif bad == "level 4":
        level[2] = 4
    elif bad == "host_seqs past the end":
        hs = torch.tensor([0, 4], dtype=torch.int64)
    else:
        conv = torch.tensor([-1], dtype=torch.int64)
    t = _tiny_trace(unit, level, op)
    with pytest.raises(ValueError, match="price_counts"):
        price_counts(t.unit, t.level, t.op, hs, conv)


def test_price_counts_layout_of_a_hand_counted_trace():
    """Each slot of the buffer on four rows counted by hand."""
    t = _tiny_trace([0, 3, 7, 10], [0, 1, 2, 3], [2, 0, 1, 0])
    got = price_counts(t.unit, t.level, t.op,
                       torch.tensor([1, 3, 3], dtype=torch.int64),
                       torch.tensor([0, 1, 1, 2], dtype=torch.int64))
    want = [0] * pc_mod.N_OUT
    for u in (0, 3, 7, 10):
        want[pc_mod.UNITS_ALL + u] += 1
    for u in (3, 10, 10):
        want[pc_mod.UNITS_HOST + u] += 1
    for lv, st in ((1, 0), (2, 1), (3, 0)):
        want[pc_mod.MEM_ALL + 2 * lv + st] += 1
    for lv, st in ((1, 0), (3, 0), (3, 0)):
        want[pc_mod.MEM_HOST + 2 * lv + st] += 1
    want[pc_mod.MEM_ROWS] = 3
    want[pc_mod.CONV_L1] = 2
    assert got == want
