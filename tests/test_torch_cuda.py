"""The CUDA kernels against their plain versions, on the card.

Every test here carries the ``cuda`` marker and skips where no GPU is
present (the CPU suite); the file imports neither JAX nor ``repro``, so it
runs on a machine that has only the port.  On a GPU machine::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The analysis kernels (replay, segment reductions, placement) and the bulk
CiM ops are integer, and compared exactly; attention and mLSTM are held to their
plain versions (``repro_torch.kernels.ref``) within the reference's own f32
bounds (2e-5 for attention, 2e-3 for mLSTM).  A bf16 result is held to
atol 2e-3 and rtol 1e-2: both sides compute in f32 from the same bf16
inputs and round once, so they differ by at most about one bf16 ulp
(2**-7 of the value) plus the f32 gap.  The model zoo's serving path,
which has no kernel of its own, is held to the reference's committed
``reference_serve.json`` (tokens ==, f32 logits within 1e-4).
"""
import types

import numpy as np
import pytest
torch = pytest.importorskip("torch")  # CI images without torch skip the port

from repro_torch.core import accel, profiler
from repro_torch.core.accel import place
from repro_torch.core.accel import price_counts as pc
from repro_torch.core.accel.pallas_ops import segment_max, segment_sum
from repro_torch.core.accel.replay import replay_columns_batch
from repro_torch.core.cache import CacheConfig, SPM_1M
from repro_torch.core.isa import OP_STORE
from repro_torch.core.offload import OffloadConfig, select_candidates
from repro_torch.core.reshape import reshape
from repro_torch.core.trace import attach_cache_results_batch
from repro_torch.dse.space import CIM_SETS
from repro_torch import kernels
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.workloads import fixtures

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _g(sets, assoc, banks, mshrs, name="L1"):
    return CacheConfig(name, sets * 64 * assoc, assoc, banks=banks,
                       mshrs=mshrs)


GEOMETRIES = (
    (_g(1, 1, 1, 1),),
    (_g(4, 4, 4, 2),),
    (_g(4, 1, 1, 2), _g(4, 4, 4, 2, "L2")),
    (_g(1, 1, 1, 1), _g(4, 1, 2, 1, "L2")),
    (_g(1, 2, 2, 2), _g(1, 4, 4, 1, "L2")),
    (_g(3, 2, 3, 3), _g(5, 3, 3, 5, "L2")),
    (_g(2, 32, 3, 32), _g(8, 16, 4, 32, "L2")),
)


def _assert_replay_equal(addrs, wr, geos, dev):
    before = accel.launch_counts()["replay"]
    got = replay_columns_batch(addrs.to(dev), wr.to(dev), geos)
    depths = len({len(g) for g in geos})
    assert accel.launch_counts()["replay"] == before + depths
    want = replay_columns_batch(addrs, wr, geos)
    for g, w in zip(got, want):
        for a, b in zip(g[:4], w[:4]):
            assert a.device.type == "cuda" and a.dtype == b.dtype
            assert torch.equal(a.cpu(), b)
        assert g[4] == w[4]


@pytest.mark.parametrize("seed", range(8))
def test_replay_kernel_matches_plain_fuzzed(cuda, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 400))
    enc = rng.integers(0, 2 * 40 * 64, n)
    addrs = torch.from_numpy((enc >> 1).astype(np.int64))
    wr = torch.from_numpy((enc & 1).astype(bool))
    _assert_replay_equal(addrs, wr, list(GEOMETRIES), cuda)


@pytest.mark.parametrize("name", ("NB", "astar"))
def test_replay_kernel_matches_plain_on_presets(cuda, name):
    ct = fixtures.load_structural(name, device="cpu").columns
    mem = ct.mem_mask
    _assert_replay_equal(ct.addr[mem], ct.op[mem] == OP_STORE,
                         list(fixtures.CACHES.values()) + [(SPM_1M,)], cuda)


def test_replay_kernel_takes_the_64_bit_path(cuda):
    """Lines beyond 32-bit set-local tags take the int64 instantiation."""
    from repro_torch.core.accel.replay import word_bytes
    rng = np.random.default_rng(3)
    pool = np.array([0, 1, 2, 2 ** 44, 2 ** 44 + 1, 2 ** 50 // 64],
                    dtype=np.int64)
    lines = pool[rng.integers(0, len(pool), 500)]
    addrs = torch.from_numpy(lines * 64 + rng.integers(0, 64, 500))
    wr = torch.from_numpy(rng.random(500) < 0.4)
    geos = list(GEOMETRIES) + list(fixtures.CACHES.values())
    assert word_bytes(500, int(lines.max()), geos) == 8
    _assert_replay_equal(addrs, wr, geos, cuda)


@pytest.mark.parametrize("wide", [False, True])
def test_replay_kernel_with_the_first_level_in_global_memory(cuda, wide):
    """A first level too large for shared memory (4 MB, and SPM_1M in
    64-bit words) lives in the global scratch, in 32- and 64-bit words."""
    from repro_torch.core.accel.replay import first_level_shared, word_bytes
    big = CacheConfig("L1", 4 * 1024 * 1024, 8, banks=4, mshrs=8)
    geos = [(big,), (big, _g(64, 8, 4, 8, "L2")), (SPM_1M,)]
    ct = fixtures.load_structural("KM", device="cpu").columns
    mem = ct.mem_mask
    addrs = ct.addr[mem] + (2 ** 52 if wide else 0)
    word = word_bytes(addrs.numel(), int(addrs.max()) // 64, geos)
    assert word == (8 if wide else 4)
    assert not first_level_shared(geos, word)
    _assert_replay_equal(addrs, ct.op[mem] == OP_STORE, geos, cuda)


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 63, 64, 65, 513])
def test_replay_kernel_at_chunk_edges(cuda, n):
    rng = np.random.default_rng(n)
    addrs = torch.from_numpy(rng.integers(0, 12 * 64, n).astype(np.int64))
    wr = torch.from_numpy(rng.random(n) < 0.5)
    _assert_replay_equal(addrs, wr, list(GEOMETRIES), cuda)


@pytest.mark.parametrize("kind", ["one repeated line", "one set"])
def test_replay_kernel_on_degenerate_streams(cuda, kind):
    n = 1000
    rng = np.random.default_rng(7)
    if kind == "one repeated line":
        addrs = np.full(n, 5 * 64 + 8, dtype=np.int64)
    else:                 # every line in set 0 of each power-of-two level
        addrs = (rng.integers(0, 40, n) * 64 * 4096).astype(np.int64)
    wr = torch.from_numpy(rng.random(n) < 0.3)
    _assert_replay_equal(torch.from_numpy(addrs), wr,
                         list(GEOMETRIES) + list(fixtures.CACHES.values()),
                         cuda)


@pytest.mark.parametrize("name", fixtures.WORKLOADS)
def test_replay_kernel_matches_plain_on_every_fixture(cuda, name):
    """Depth 2 (the Fig. 14 geometries) and depth 1 (SPM_1M, and a 32 KB
    first level alone) in one call: one launch per depth."""
    ct = fixtures.load_structural(name, device="cpu").columns
    mem = ct.mem_mask
    _assert_replay_equal(ct.addr[mem], ct.op[mem] == OP_STORE,
                         list(fixtures.CACHES.values())
                         + [(SPM_1M,), (fixtures.CACHES["32K+256K"][0],)],
                         cuda)


# the shared-memory path (one cluster of 8 blocks) takes n_seg <= 57,344
# and n <= 65,536 (csrc/segment_reduce.cu); the cases sit on both sides of
# each limit
@pytest.mark.parametrize("n,n_seg", [(0, 4), (1, 1), (1000, 37),
                                     (100_000, 5000),
                                     (4_000_000, 70_000),   # grid-strides
                                     (20_000, 57_344), (20_000, 57_345),
                                     (65_536, 7535), (65_537, 7535),
                                     (0, 57_345)])
def test_segment_kernels_match_plain(cuda, n, n_seg):
    gen = torch.Generator().manual_seed(n + n_seg)
    ids = torch.randint(-2, n_seg + 3, (n,), generator=gen,
                        dtype=torch.int32)
    vals = torch.randint(-2 ** 20, 2 ** 20, (n,), generator=gen,
                         dtype=torch.int32)
    for op in (segment_sum, segment_max):
        got = op(vals.to(cuda), ids.to(cuda), n_seg)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), op(vals, ids, n_seg))


@pytest.mark.parametrize("n,n_seg", [(1000, 64), (100_000, 64),
                                     (1000, 60_000)])
def test_segment_kernels_drop_all_out_of_range_ids(cuda, n, n_seg):
    gen = torch.Generator().manual_seed(n)
    ids = torch.cat([torch.randint(-2 ** 31, 0, (n // 2,), generator=gen,
                                   dtype=torch.int32),
                     torch.randint(n_seg, 2 ** 31 - 1, (n - n // 2,),
                                   generator=gen, dtype=torch.int32)])
    vals = torch.randint(-2 ** 20, 2 ** 20, (n,), generator=gen,
                         dtype=torch.int32)
    for op, ident in ((segment_sum, 0), (segment_max, -2 ** 31)):
        got = op(vals.to(cuda), ids.to(cuda), n_seg)
        assert torch.equal(got.cpu(), op(vals, ids, n_seg))
        assert torch.equal(got.cpu(), torch.full((n_seg,), ident,
                                                 dtype=torch.int32))


def test_segment_kernels_with_no_segments_launch_nothing(cuda):
    vals = torch.arange(10, dtype=torch.int32, device=cuda)
    before = accel.launch_counts()
    for op in (segment_sum, segment_max):
        got = op(vals, vals, 0)
        assert got.shape == (0,) and got.dtype == torch.int32
        assert got.device.type == "cuda"
    assert accel.launch_counts() == before


@pytest.mark.parametrize("name", ("NB", "KM", "LCS"))
def test_design_points_on_the_card_equal_reference_reports(cuda, name):
    from repro_torch.dse import DSEEngine

    golden = fixtures.reference_reports()["workloads"][name]
    accel.reset_launch_counts()
    engine = DSEEngine(device=cuda)
    results = engine.run(fixtures.design_point_space([name]))
    records, counters = fixtures.engine_design_points(engine, results)[name]
    assert records == fixtures.golden_by_key(golden["records"])
    assert counters == golden["counters"]
    launches = accel.launch_counts()
    assert launches["replay"] > 0 and launches["place"] > 0
    # placement is one kernel: the segment kernels are off the main path
    assert launches["segment_sum"] == launches["segment_max"] == 0
    # one count launch a point priced
    assert launches["price_counts"] == len(results)


# ------------------------------------------------- DSE engine on the card
def _fig14_space():
    from repro_torch.bench import fig14_cache_cfg
    return fig14_cache_cfg.space()


@pytest.mark.parametrize("executor", ["thread", "serial"])
def test_engine_sweep_on_the_card_equals_reference_records(cuda, executor):
    from repro_torch.dse import DSEEngine

    accel.reset_launch_counts()
    eng = DSEEngine(executor=executor, device=cuda)
    res = eng.run(_fig14_space())
    launches = accel.launch_counts()
    assert [r.to_dict() for r in res] == fixtures.reference_records()["fig14"]
    cache = eng.analysis
    # thread: one batched replay per workload; serial: one per geometry
    assert cache.replay_batches == (9 if executor == "thread" else 0)
    assert launches["replay"] == cache.replay_batches \
        + cache.single_replays > 0
    assert launches["place"] == cache.offload_builds == 27
    for tr in cache._traces.values():
        assert tr.trace.device.type == "cuda"


def test_warm_store_on_the_card_launches_nothing(cuda, tmp_path):
    from repro_torch.dse import DSEEngine

    space = _fig14_space()
    cold = DSEEngine(store=tmp_path, device=cuda).run(space)
    accel.reset_launch_counts()
    warm = DSEEngine(store=tmp_path, device=cuda).run(space)
    assert warm.stats["trace_builds"] == warm.stats["offload_builds"] == 0
    assert accel.launch_counts()["replay"] == 0
    assert accel.launch_counts()["place"] == 0
    assert [r.to_dict() for r in warm] == [r.to_dict() for r in cold] == \
        fixtures.reference_records()["fig14"]


def test_process_workers_on_the_card_launch_the_kernels(cuda, tmp_path):
    from repro_torch.dse import DSEEngine, SweepSpace

    space = SweepSpace(workloads=("NB", "DT"),
                       caches=("32K+256K", "64K+256K", "64K+2M"))
    eng = DSEEngine(executor="process", max_workers=2, store=tmp_path,
                    device=cuda)
    res = eng.run(space)
    assert [r.to_dict() for r in res] == \
        fixtures.reference_records()["fig14"][:6]
    assert eng.worker_launches["replay"] == res.stats["trace_builds"] == 6
    assert eng.worker_launches["place"] == res.stats["offload_builds"] == 6
    assert eng.worker_launches["price_counts"] == len(res) == 6


# ------------------------------------------------------------ placement
LEVEL_SETS = (("L1", "L2"), ("L1",), ("L2",))


def _synthetic_placement(seed, n_inst=4096, n_random=300):
    """(partition, CPU trace columns): protos with no leaves, no loads, no
    accesses, runs of 1, 33, 1,100 and 5,000 accesses and random ones;
    lines repeat, levels mix none/L1/L2/MEM, addresses reach 2**50."""
    rng = np.random.default_rng(seed)
    lines = rng.integers(0, 2 ** 44, 64)
    cols = types.SimpleNamespace(
        level=torch.from_numpy(rng.integers(0, 4, n_inst).astype(np.int8)),
        addr=torch.from_numpy(lines[rng.integers(0, 64, n_inst)] * 64
                              + rng.integers(0, 64, n_inst)),
        bank=torch.from_numpy(rng.integers(0, 16, n_inst).astype(np.int16)),
        device=torch.device("cpu"), _struct={})

    def proto(n_leaf, n_load, n_store):
        return types.SimpleNamespace(
            leaf_src=rng.integers(0, n_inst, n_leaf).tolist(),
            load_seqs=rng.integers(0, n_inst, n_load).tolist(),
            store_seqs=rng.integers(0, n_inst, n_store).tolist())

    protos = [proto(0, 3, 1), proto(5, 0, 4), proto(2, 0, 0)]
    protos += [proto(int(rng.integers(1, 70)), n - n // 3, n // 3)
               for n in (1, 33, 1100, 5000)]
    protos += [proto(int(rng.integers(0, 9)), int(rng.integers(0, 40)),
                     int(rng.integers(0, 3))) for _ in range(n_random)]
    return types.SimpleNamespace(protos=protos), cols


def _on(cols, dev):
    return types.SimpleNamespace(
        **{c: getattr(cols, c).to(dev) for c in ("level", "addr", "bank")},
        device=dev, _struct={})


@pytest.mark.parametrize("levels", LEVEL_SETS)
@pytest.mark.parametrize("seed", range(3))
def test_place_kernel_matches_plain_on_synthetic_partitions(cuda, seed,
                                                            levels):
    part, cols = _synthetic_placement(seed)
    cfg = OffloadConfig(cim_levels=levels)
    before = accel.launch_counts()["place"]
    got = place.place_arrays(part, _on(cols, cuda), cfg)
    assert accel.launch_counts()["place"] == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.int32
    want = place.place_arrays(part, cols, cfg)
    assert torch.equal(got.cpu(), want)
    assert place.placement_lists(part, _on(cols, cuda), cfg) == \
        want.tolist()


@pytest.mark.parametrize("name", fixtures.WORKLOADS)
def test_place_kernel_matches_plain_on_fixtures(cuda, name):
    geos = list(fixtures.CACHES.values())
    for tr, tr_dev in zip(*(attach_cache_results_batch(
            fixtures.load_structural(name, device=d), geos, device=d)
            for d in ("cpu", cuda))):
        for levels in LEVEL_SETS:
            cfg = OffloadConfig(cim_levels=levels)
            select_candidates(tr.trace, cfg=cfg, device="cpu")
            select_candidates(tr_dev.trace, cfg=cfg, device=cuda)
            part = tr.trace._struct["partitions"][cfg.partition_key()]
            part_dev = tr_dev.trace._struct["partitions"][cfg.partition_key()]
            if not part.protos:
                continue
            want = place.place_arrays(part, tr.trace, cfg)
            got = place.place_arrays(part_dev, tr_dev.trace, cfg)
            assert torch.equal(got.cpu(), want), (name, levels)
            assert place.place_candidates(part_dev, tr_dev.trace, cfg) == \
                place.place_candidates(part, tr.trace, cfg)


def test_one_placement_is_one_kernel_launch(cuda):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    part, cols = _synthetic_placement(0)
    ct, cfg = _on(cols, cuda), OffloadConfig()
    place.place_arrays(part, ct, cfg)                  # builds, memoizes
    torch.cuda.synchronize()
    calls = 20
    before = accel.launch_counts()["place"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            place.place_arrays(part, ct, cfg)
        torch.cuda.synchronize()
    assert accel.launch_counts()["place"] == before + calls
    events = {e.key: e.count for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA}
    # the place kernel and nothing else; the trace may miss an event
    assert len(events) == 1 and "place_kernel" in next(iter(events)), events
    assert calls - 2 <= sum(events.values()) <= calls


# ----------------------------------------------------- pricing's counts
def _count_pair(tr, res):
    """``profiler.count_trace`` of one selection, as ``profile_system``
    calls it, with the launches it took."""
    rs = reshape(tr.trace, res)
    before = accel.launch_counts()["price_counts"]
    got = profiler.count_trace(tr.trace, *profiler._selection_index(
        res, rs, tr.trace.device))
    return got, accel.launch_counts()["price_counts"] - before


@pytest.mark.parametrize("name", fixtures.WORKLOADS)
def test_price_counts_kernel_matches_plain_on_fixtures(cuda, name):
    geo = fixtures.CACHES["32K+256K"]
    tr, tr_dev = (attach_cache_results_batch(
        fixtures.load_structural(name, device=d), [geo], device=d)[0]
        for d in ("cpu", cuda))
    for levels in LEVEL_SETS:
        for cim_set in ("logic", "full"):
            cfg = OffloadConfig(cim_levels=levels, cim_set=CIM_SETS[cim_set])
            want, n_cpu = _count_pair(
                tr, select_candidates(tr.trace, cfg=cfg, device="cpu"))
            got, n_dev = _count_pair(
                tr_dev, select_candidates(tr_dev.trace, cfg=cfg,
                                          device=cuda))
            assert (n_cpu, n_dev) == (0, 1)
            assert got == want, (name, levels, cim_set)


def _synthetic_columns(n, seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randint(0, 11, (n,), generator=gen).to(torch.int8),
            torch.randint(0, 4, (n,), generator=gen).to(torch.int8),
            torch.randint(0, 20, (n,), generator=gen).to(torch.int16),
            torch.randint(0, max(n, 1), (n // 2,), generator=gen),
            torch.randint(0, max(n, 1), (n // 3,), generator=gen))


@pytest.mark.parametrize("n", [0, 1, 31, 33, 2048, 2049, 3_000_001])
def test_price_counts_kernel_matches_plain_on_synthetic_columns(cuda, n):
    """Lengths around a warp and a block's share, and one that makes the
    capped grid stride; units 0-10, levels none to MEM, loads, stores and
    other ops."""
    cols = _synthetic_columns(n, n)
    want = pc.price_counts(*cols)
    before = accel.launch_counts()["price_counts"]
    got = pc.price_counts(*(c.to(cuda) for c in cols))
    assert accel.launch_counts()["price_counts"] == before + 1
    assert got == want == pc._plain(*cols).tolist()
    # the launch alone leaves the same counts on the device
    out = pc._launch(*(c.to(cuda) for c in cols))
    assert out.device.type == "cuda" and out.cpu().tolist() == want


@pytest.mark.parametrize("bad", ("unit 16", "level 5", "host_seqs past the "
                                 "end", "conv below 0"))
def test_price_counts_kernel_refuses_what_the_trace_does_not_hold(cuda,
                                                                    bad):
    unit, level, op, hs, conv = (c.to(cuda) for c in
                                 _synthetic_columns(100, 7))
    if bad == "unit 16":
        unit[40] = 16
    elif bad == "level 5":
        level[3] = 5
    elif bad == "host_seqs past the end":
        hs[0] = 100
    else:
        conv[-1] = -1
    with pytest.raises(ValueError, match="price_counts"):
        pc.price_counts(unit, level, op, hs, conv)
    with pytest.raises(TypeError, match="price_counts"):
        pc.price_counts(unit, level, op.to(torch.int32), hs, conv)


def test_price_counts_takes_host_seqs_from_the_cpu(cuda):
    """A selection loaded from a store keeps ``host_seqs`` on the CPU: the
    profiler moves it to the trace's device once per selection."""
    geo = fixtures.CACHES["32K+256K"]
    tr = attach_cache_results_batch(fixtures.load_structural(
        "KM", device=cuda), [geo], device=cuda)[0]
    res = select_candidates(tr.trace, cfg=OffloadConfig(), device=cuda)
    rs = reshape(tr.trace, res)
    want = profiler.profile_system(tr, offload=res, reshaped=rs)
    rs.host_seqs = rs.host_seqs.cpu()
    hs, conv = profiler._selection_index(res, rs, tr.trace.device)
    assert hs.device == tr.trace.device == conv.device
    assert profiler._selection_index(res, rs, tr.trace.device)[0] is hs
    before = accel.launch_counts()["price_counts"]
    got = profiler.profile_system(tr, offload=res, reshaped=rs)
    assert accel.launch_counts()["price_counts"] == before + 1
    assert got == want


def test_profile_system_on_the_card_is_one_count_launch(cuda):
    """One ``profile_system`` call: exactly one count launch, and the
    report ``==`` the CPU's."""
    geo = fixtures.CACHES["32K+256K"]
    reports = []
    for dev in ("cpu", cuda):
        tr = attach_cache_results_batch(fixtures.load_structural(
            "astar", device=dev), [geo], device=dev)[0]
        res = select_candidates(tr.trace, cfg=OffloadConfig(), device=dev)
        rs = reshape(tr.trace, res)
        before = accel.launch_counts()["price_counts"]
        reports.append(profiler.profile_system(
            tr, tech="fefet", offload=res, reshaped=rs, device=dev))
        assert accel.launch_counts()["price_counts"] - before == \
            (dev != "cpu")
    assert reports[0] == reports[1]


# ------------------------------------------------- repro_torch.kernels
def _ints(shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                      dtype=torch.int32)
    return x.view(dtype)


def _launched(name, fn):
    before = kernels.launch_counts()[name]
    out = fn()
    assert kernels.launch_counts()[name] == before + 1
    return out


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint32])
@pytest.mark.parametrize("shape", [(8, 128), (17, 1000), (1, 64),
                                   (4096, 1031)])
@pytest.mark.parametrize("op", ["and", "or", "xor", "add", "sub"])
def test_cim_bulk_kernel_matches_plain(cuda, op, shape, dtype):
    x, y = _ints(shape, dtype, 1), _ints(shape, dtype, 2)
    got = _launched("cim_bitwise",
                    lambda: ops.cim_bulk(x.to(cuda), y.to(cuda), op=op))
    assert got.device.type == "cuda" and got.dtype == dtype
    want = ops.cim_bulk(x, y, op=op)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("op1,op2", [("add", "xor"), ("sub", "and"),
                                     ("or", "add")])
def test_cim_fused_kernel_matches_plain_unaligned(cuda, op1, op2):
    # offset views: the kernel's scalar path (no 16-byte alignment)
    x, y, z = (_ints((3, 1001), torch.int32, s) for s in (3, 4, 5))
    xs, ys, zs = (a.to(cuda).flatten()[1:] for a in (x, y, z))
    got = _launched("cim_bitwise_fused",
                    lambda: ops.cim_fused(xs, ys, zs, op1=op1, op2=op2))
    want = ops.cim_fused(*(a.flatten()[1:] for a in (x, y, z)), op1=op1,
                         op2=op2)
    assert torch.equal(got.cpu(), want)


# cim_bitwise.cu: a block of THREADS threads takes THREADS uint4 vectors
# (or single elements on unaligned views); the card holds two an SM
THREADS = 1024
TILE = THREADS * 4               # elements


def _wave_sizes(waves):
    """Element counts around ``waves`` full waves of the bulk kernel's
    grid (two blocks an SM), and around one block: -1, +1 and one vector
    short."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sorted({n for edge in (waves * sms * 2 * TILE, TILE)
                   for n in (edge - 4, edge - 1, edge, edge + 1)})


@pytest.mark.parametrize("waves", range(1, 5))
def test_cim_kernels_match_plain_at_wave_edges(cuda, waves):
    for n in _wave_sizes(waves):
        x, y, z = (_ints((n,), torch.int32, s) for s in (20, 21, 22))
        for op in ("and", "sub"):
            got = ops.cim_bulk(x.to(cuda), y.to(cuda), op=op)
            assert torch.equal(got.cpu(), ops.cim_bulk(x, y, op=op)), (n, op)
        got = ops.cim_fused(x.to(cuda), y.to(cuda), z.to(cuda))
        assert torch.equal(got.cpu(), ops.cim_fused(x, y, z)), n


# 1 to 5: the last elements alone; TILE - 4 and +- 1: one vector or one
# element short of a block, and one element past it
@pytest.mark.parametrize("n", [1, 3, 4, 5, TILE - 4, TILE - 1, TILE + 1,
                               100_003])
@pytest.mark.parametrize("dtype", [torch.int32, torch.uint32])
def test_cim_kernels_match_plain_at_small_and_unaligned_sizes(cuda, n,
                                                              dtype):
    x, y, z = (_ints((n + 1,), dtype, s) for s in (23, 24, 25))
    xd, yd, zd = (a.to(cuda) for a in (x, y, z))
    for lo in (0, 1):            # 1: views off a 16-byte boundary
        got = _launched("cim_bitwise", lambda: ops.cim_bulk(
            xd[lo:lo + n], yd[lo:lo + n], op="add"))
        want = ops.cim_bulk(x[lo:lo + n], y[lo:lo + n], op="add")
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))
        got = _launched("cim_bitwise_fused", lambda: ops.cim_fused(
            xd[lo:lo + n], yd[lo:lo + n], zd[lo:lo + n], op1="xor",
            op2="sub"))
        want = ops.cim_fused(x[lo:lo + n], y[lo:lo + n], z[lo:lo + n],
                             op1="xor", op2="sub")
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))


def test_cim_kernels_with_no_elements_launch_nothing(cuda):
    x = torch.zeros((0, 5), dtype=torch.int32, device=cuda)
    before = kernels.launch_counts()
    assert ops.cim_bulk(x, x).shape == (0, 5)
    assert ops.cim_fused(x, x, x).shape == (0, 5)
    assert kernels.launch_counts() == before


def _normal(shape, seed, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(dtype)


F32_FLASH = (2e-5, 2e-5)          # (atol, rtol)
BF16 = (2e-3, 1e-2)


@pytest.mark.parametrize("shape,window,dtype,tol", [
    # (B, H, Hkv, Sq, Skv, d)
    ((1, 2, 2, 128, 128, 32), 0, torch.float32, F32_FLASH),
    ((2, 4, 2, 256, 256, 64), 32, torch.float32, F32_FLASH),
    ((1, 8, 1, 128, 128, 64), 0, torch.float32, F32_FLASH),
    ((1, 4, 1, 1024, 1024, 256), 512, torch.float32, F32_FLASH),  # gemma3-1b
    ((1, 4, 1, 1024, 1024, 256), 0, torch.bfloat16, BF16),
    ((1, 2, 2, 100, 70, 32), 16, torch.float32, F32_FLASH),  # ragged quirk
    ((2, 4, 1, 40, 40, 96), 0, torch.float32, F32_FLASH),   # Sq < the q tile
    # GQA (H / Hkv = 4) at gemma3-1b's width over 24 q tiles, B = 2
    ((2, 4, 1, 1536, 1536, 256), 512, torch.float32, F32_FLASH),
    # rows 79 on have no real key (q >= Skv + window - 1): uniform average
    ((1, 2, 1, 256, 64, 32), 16, torch.float32, F32_FLASH),
    # bf16 on the tensor cores
    ((1, 4, 1, 1024, 1024, 256), 512, torch.bfloat16, BF16),  # gemma3-1b
    ((2, 4, 2, 256, 256, 64), 32, torch.bfloat16, BF16),      # GQA, d=64
    ((1, 8, 2, 256, 256, 128), 0, torch.bfloat16, BF16),      # GQA, d=128
    ((2, 4, 1, 40, 40, 96), 0, torch.bfloat16, BF16),   # Sq < the q tile
    ((1, 2, 2, 100, 70, 32), 16, torch.bfloat16, BF16),  # ragged quirk
])
def test_flash_attention_kernel_matches_plain(cuda, shape, window, dtype,
                                              tol):
    B, H, Hkv, Sq, Skv, d = shape
    q = _normal((B, H, Sq, d), 6, dtype)
    k, v = _normal((B, Hkv, Skv, d), 7, dtype), _normal((B, Hkv, Skv, d), 8,
                                                        dtype)
    got = _launched("flash_attention", lambda: ops.flash_attention(
        q.to(cuda), k.to(cuda), v.to(cuda), causal=True, window=window,
        block_q=64, block_k=64))
    want = ops.flash_attention(q, k, v, causal=True, window=window,
                               block_q=64, block_k=64)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=tol[0],
                               rtol=tol[1])


@pytest.mark.parametrize("d", [16, 64, 192, 256])
@pytest.mark.parametrize("window", [0, 48])
def test_flash_attention_bf16_kernel_ragged_tiles(cuda, d, window):
    """Sq = Skv = 136 with 8-row blocks: the kernel gets lengths that are no
    multiple of its 64-row tiles, so its last q tile is partial and the
    keys past Skv of its last KV tile are zero rows scored -inf."""
    q = _normal((1, 4, 136, d), 14, torch.bfloat16)
    k, v = (_normal((1, 2, 136, d), s, torch.bfloat16) for s in (15, 16))
    got = _launched("flash_attention", lambda: ops.flash_attention(
        q.to(cuda), k.to(cuda), v.to(cuda), window=window, block_q=8,
        block_k=8))
    want = ops.flash_attention(q, k, v, window=window, block_q=8, block_k=8)
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=BF16[0],
                               rtol=BF16[1])


@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_flash_attention_f32_kernel_at_every_head_dim(cuda, d, window):
    """Every head dim the kernel is built for, in f32 on the tensor cores:
    GQA (H / Hkv = 2), three q tiles, a window shorter than a tile."""
    q = _normal((1, 4, 192, d), 20, torch.float32)
    k, v = (_normal((1, 2, 192, d), s, torch.float32) for s in (21, 22))
    got = _launched("flash_attention", lambda: ops.flash_attention(
        q.to(cuda), k.to(cuda), v.to(cuda), window=window, block_q=64,
        block_k=64))
    want = ops.flash_attention(q, k, v, window=window, block_q=64,
                               block_k=64)
    torch.testing.assert_close(got.cpu(), want, atol=F32_FLASH[0],
                               rtol=F32_FLASH[1])


@pytest.mark.parametrize("d", [16, 64, 192, 256])
@pytest.mark.parametrize("window", [0, 48])
def test_flash_attention_f32_kernel_ragged_tiles(cuda, d, window):
    """Sq = Skv = 136 with 8-row blocks, in f32: the last q tile is
    partial and the keys past Skv of the last KV tile are zero rows scored
    -inf (as test_flash_attention_bf16_kernel_ragged_tiles)."""
    q = _normal((1, 4, 136, d), 14, torch.float32)
    k, v = (_normal((1, 2, 136, d), s, torch.float32) for s in (15, 16))
    got = _launched("flash_attention", lambda: ops.flash_attention(
        q.to(cuda), k.to(cuda), v.to(cuda), window=window, block_q=8,
        block_k=8))
    want = ops.flash_attention(q, k, v, window=window, block_q=8, block_k=8)
    torch.testing.assert_close(got.cpu(), want, atol=F32_FLASH[0],
                               rtol=F32_FLASH[1])


def test_flash_attention_kernel_takes_unaligned_views(cuda):
    """A view that starts off a 16-byte boundary is copied, not refused."""
    q, k, v = (_normal((1, 2, 64, 32), s, torch.bfloat16) for s in (17, 18,
                                                                    19))
    qs, ks, vs = (torch.cat([t.flatten(), t.flatten()[:1]]).to(cuda)[1:]
                  .view(t.shape) for t in (q, k, v))
    assert qs.data_ptr() % 16
    got = ops.flash_attention(qs, ks, vs, block_q=64, block_k=64)
    want = ops.flash_attention(*(t.cpu() for t in (qs, ks, vs)), block_q=64,
                               block_k=64)
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=BF16[0],
                               rtol=BF16[1])


F32_MLSTM = (2e-3, 2e-3)


def _mlstm_args(B, H, S, dh, dtype=torch.float32):
    q, k, v = (_normal((B, H, S, dh), s, dtype) for s in (9, 10, 11))
    return q, k, v, _normal((B, H, S), 12), _normal((B, H, S), 13) + 3.0


@pytest.mark.parametrize("shape,dtype,tol", [
    # (B, H, S, dh, chunk)
    ((1, 1, 64, 16, 16), torch.float32, F32_MLSTM),
    ((2, 2, 128, 32, 32), torch.float32, F32_MLSTM),
    ((1, 2, 128, 64, 64), torch.float32, F32_MLSTM),
    ((1, 2, 48, 16, 32), torch.float32, F32_MLSTM),      # chunk halves to 16
    ((2, 4, 256, 192, 128), torch.float32, F32_MLSTM),   # xlstm-125m
    ((2, 4, 256, 192, 128), torch.bfloat16, BF16),
])
def test_mlstm_kernel_matches_plain(cuda, shape, dtype, tol):
    B, H, S, dh, chunk = shape
    args = _mlstm_args(B, H, S, dh, dtype)
    got = _launched("mlstm_chunkwise", lambda: ops.mlstm_chunkwise(
        *(a.to(cuda) for a in args), chunk=chunk))
    want = ops.mlstm_chunkwise(*args, chunk=chunk)
    assert got.dtype == dtype
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=tol[0],
                               rtol=tol[1])


@pytest.mark.parametrize("shape,dtype,tol", [
    # (B, H, S, dh, chunk)
    ((1, 1, 256, 64, 64), torch.float32, F32_MLSTM),      # B*H = 1
    ((3, 48, 64, 16, 32), torch.float32, F32_MLSTM),      # B*H = 144 > 132
    ((2, 4, 128, 192, 128), torch.float32, F32_MLSTM),    # one chunk
    ((1, 2, 100, 96, 128), torch.float32, F32_MLSTM),     # one chunk of 100
    ((1, 2, 200, 32, 128), torch.float32, F32_MLSTM),     # ragged: 128 -> 8
    ((2, 2, 256, 128, 64), torch.bfloat16, BF16),
    ((1, 4, 192, 192, 64), torch.bfloat16, BF16),
])
def test_mlstm_split_kernel_matches_plain(cuda, shape, dtype, tol):
    """The kernel split across chunks at chain counts and chunk shapes on
    both sides of the card's 132 SMs."""
    B, H, S, dh, chunk = shape
    args = _mlstm_args(B, H, S, dh, dtype)
    got = _launched("mlstm_chunkwise", lambda: ops.mlstm_chunkwise(
        *(a.to(cuda) for a in args), chunk=chunk))
    want = ops.mlstm_chunkwise(*args, chunk=chunk)
    assert got.dtype == dtype
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=tol[0],
                               rtol=tol[1])


def test_mlstm_kernel_chunk_invariance_at_xlstm_width(cuda):
    args = [a.to(cuda) for a in _mlstm_args(1, 4, 256, 192)]
    o32 = ops.mlstm_chunkwise(*args, chunk=32)
    o128 = ops.mlstm_chunkwise(*args, chunk=128)
    torch.testing.assert_close(o32, o128, atol=F32_MLSTM[0],
                               rtol=F32_MLSTM[1])


def test_mlstm_kernel_chunk_invariance(cuda):
    args = [a.to(cuda) for a in _mlstm_args(1, 2, 256, 64)]
    o32 = ops.mlstm_chunkwise(*args, chunk=32)
    o128 = ops.mlstm_chunkwise(*args, chunk=128)
    torch.testing.assert_close(o32, o128, atol=F32_MLSTM[0],
                               rtol=F32_MLSTM[1])


def test_service_sweep_launches_replay_and_placement(cuda):
    """One sweep through the port's daemon on the card: its warm pass
    launches the replay kernel once (one batch of two geometries), its
    two selections the placement kernel once each, the records equal the
    same sweep on the CPU, and a warm repeat launches nothing."""
    from repro_torch.dse.service import ServiceClient, running_server

    req = dict(caches=["32K+256K", "64K+2M"], techs=["sram", "fefet"])
    with running_server(device="cpu") as (url, _service):
        want = ServiceClient(url).sweep(["NB"], **req).records
    with running_server(device="cuda") as (url, service):
        client = ServiceClient(url)
        accel.reset_launch_counts()
        got = client.sweep(["NB"], **req)
        launches = client.metrics()["accel"]["launches"]
        cache = service.analysis_cache("cim")
        assert launches["replay"] == 1 == (cache.replay_batches
                                           + cache.single_replays)
        assert launches["place"] == 2 == cache.offload_builds
        assert launches["price_counts"] == 4 == len(got.records)
        assert got.records == want
        client.sweep(["NB"], **req)
        assert client.metrics()["accel"]["launches"] == launches


def _serve_case_names():
    from repro_torch.models import fixtures as serve_fixtures
    return [c.name for c in serve_fixtures.serve_cases()]


@pytest.mark.parametrize("name", _serve_case_names())
def test_serve_path_on_card_matches_reference_fixture(cuda, name):
    """The model zoo's serving path on the card (no kernel of its own):
    prefill and 4 greedy decode steps in f32 from the numpy-drawn
    weights, tokens == and logits within ``LOGITS_TOL`` of the
    reference's ``reference_serve.json`` (as ``chip_smoke.py`` phase 11)."""
    from repro_torch.models import convert
    from repro_torch.models import fixtures as serve_fixtures

    case = next(c for c in serve_fixtures.serve_cases() if c.name == name)
    params = convert.from_reference(
        case.cfg, convert.numpy_params(case.cfg, serve_fixtures.SEED_PARAMS),
        device=cuda)
    tokens, logits = serve_fixtures.greedy_run(params, case, device=cuda)
    res = serve_fixtures.compare(serve_fixtures.load()["cases"][name],
                                 tokens, logits)
    assert res["ok"], res


def _train_case_names():
    from repro_torch.train import fixtures as train_fixtures
    return [c.name for c in train_fixtures.train_cases()]


@pytest.mark.parametrize("name", _train_case_names())
def test_train_path_on_card_matches_reference_fixture(cuda, name):
    """The model zoo's training path on the card (no kernel of its own):
    the case's train steps in f32 from the numpy-drawn weights, each
    step's metrics and the strided final parameters held to the
    reference's ``reference_train.json`` (as ``chip_smoke.py`` phase 12)."""
    from repro_torch.models import convert
    from repro_torch.train import fixtures as train_fixtures

    case = next(c for c in train_fixtures.train_cases() if c.name == name)
    params = convert.from_reference(
        case.cfg, convert.numpy_params(case.cfg, train_fixtures.SEED_PARAMS),
        device=cuda)
    res = train_fixtures.compare(train_fixtures.load()["cases"][name],
                                 *train_fixtures.train_run(params, case,
                                                           device=cuda))
    assert res["ok"], res


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_on_card_matches_cpu(cuda, dtype):
    """The flash Function's gradients on the card against the same
    Function on CPU copies: windowed banded path (overlapping bands) and
    the masked path with GQA, within 1e-5 (f32) or two bf16 ulps of each
    gradient's scale."""
    from repro_torch.models import attention as P_attn

    g = torch.Generator().manual_seed(0)
    for fn, shapes in (
            (lambda q, k, v: P_attn.flash_attention_banded(
                q, k, v, window=20, block=16),
             ((1, 96, 4, 16), (1, 96, 1, 16), (1, 96, 1, 16))),
            (lambda q, k, v: P_attn.flash_attention_jnp(
                q, k, v, causal=True, window=9, block=8),
             ((2, 33, 8, 16), (2, 33, 2, 16), (2, 33, 2, 16)))):
        xs = [torch.randn(s, generator=g).to(dtype) for s in shapes]
        w = torch.randn(shapes[0], generator=g).to(dtype)
        grads = {}
        for dev in ("cpu", cuda):
            ins = [x.detach().to(dev).requires_grad_(True) for x in xs]
            (fn(*ins) * w.to(dev)).float().sum().backward()
            grads[str(dev)] = [x.grad.float().cpu() for x in ins]
        for a, b in zip(grads["cpu"], grads[str(cuda)]):
            scale = float(a.abs().max())
            tol = 1e-5 if dtype == torch.float32 else 2 * 2.0 ** -7
            assert float((a - b).abs().max()) <= tol * scale
