"""repro_torch.core.cache's per-access half against repro.core.cache (twin
of ``tests/test_cache.py``).

Each case feeds both packages' ``CacheHierarchy`` the same access stream and
compares every :class:`AccessResult`, the residency and bank queries and
``stats()`` with ``==``; the replay-group cases compare the engines'
counters and the replayed columns.
"""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")  # CI images without torch skip the port
from hypothesis import given, settings, strategies as st

from repro.core import cache as ref
from repro_torch.core import cache as port

from test_torch_dse import reference_on_fixtures


def _pair(*levels):
    """The same hierarchy in both packages, from ``CacheConfig`` kwargs."""
    return (ref.CacheHierarchy(tuple(ref.CacheConfig(**c) for c in levels)),
            port.CacheHierarchy(tuple(port.CacheConfig(**c) for c in levels)))


def _tiny():
    return _pair(dict(name="L1", size=4 * ref.LINE, assoc=2, banks=2),
                 dict(name="L2", size=16 * ref.LINE, assoc=4))


def _drive(pair, stream):
    """Run ``stream`` of (addr, is_write) through both; results must be ==."""
    r, p = pair
    out = []
    for addr, wr in stream:
        a, b = r.access(addr, wr), p.access(addr, wr)
        assert dataclasses.asdict(a) == dataclasses.asdict(b), (addr, wr)
        out.append(b)
    assert r.stats() == p.stats()
    return out


def test_cold_miss_then_hit():
    r1, r2 = _drive(_tiny(), [(0x1000, False), (0x1008, False)])
    assert r1.level == "MEM" and not r1.hit
    assert r2.level == "L1" and r2.hit


def test_lru_eviction_to_l2():
    res = _drive(_tiny(), [(ln * port.LINE, False) for ln in (0, 2, 4)]
                 + [(0, False)])
    assert res[-1].level == "L2"


def test_writeback_dirty_victim():
    pair = _tiny()
    _drive(pair, [(0, True), (2 * port.LINE, False), (4 * port.LINE, False)])
    assert [lv.writebacks for lv in pair[0].levels] == \
        [lv.writebacks for lv in pair[1].levels] == [1, 0]


def test_residency_and_banks():
    pair = _tiny()
    _drive(pair, [(0x40, False)])
    r, p = pair
    for addr in (0x40, 0x9999999, 0, 3 * port.LINE):
        assert p.residency(addr) == r.residency(addr)
        for level in ("L1", "L2", "MEM"):
            assert p.bank_of(addr, level) == r.bank_of(addr, level)
    assert p.residency(0x40) == "L1" and p.residency(0x9999999) == "MEM"
    assert p.bank_of(0, "L1") != p.bank_of(port.LINE, "L1")


def test_mshr_merge():
    res = _drive(_pair(dict(name="L1", size=2 * ref.LINE, assoc=1, mshrs=4)),
                 [(0, False), (2 * port.LINE, False), (0, False)])
    assert res[-1].level == "MEM" and res[-1].mshr


@settings(max_examples=30, deadline=None)
@given(st.lists(st.integers(0, 31), min_size=1, max_size=200),
       st.sampled_from([(2, 2), (4, 2), (2, 4)]),
       st.lists(st.integers(0, 1), min_size=1, max_size=200))
def test_property_access_matches_reference_and_replay(lines, shape, writes):
    """Random streams through an L1+L2 pair: ``access`` == the reference's
    element by element, and a fresh port hierarchy's ``replay`` of the same
    stream gives the same columns and ``stats()``."""
    n_sets, assoc = shape
    levels = (dict(name="L1", size=n_sets * assoc * ref.LINE, assoc=assoc),
              dict(name="L2", size=4 * n_sets * assoc * ref.LINE, assoc=assoc))
    stream = [(ln * ref.LINE, bool(writes[i % len(writes)]))
              for i, ln in enumerate(lines)]
    pair = _pair(*levels)
    res = _drive(pair, stream)
    st_ = pair[1].stats()["L1"]
    assert st_["hits"] + st_["misses"] == len(lines)

    replayed = port.CacheHierarchy(tuple(port.CacheConfig(**c)
                                         for c in levels))
    level, hit, bank, mshr = replayed.replay([a for a, _ in stream],
                                             [w for _, w in stream])
    from repro_torch.core.isa import LEVEL_CODE, LEVEL_MEM
    code = {**LEVEL_CODE, "MEM": LEVEL_MEM}
    assert level.tolist() == [code[r.level] for r in res]
    assert hit.tolist() == [int(r.hit) for r in res]
    assert bank.tolist() == [r.bank for r in res]
    assert mshr.tolist() == [r.mshr for r in res]
    assert replayed.stats() == pair[0].stats()


def _engines(names):
    from repro.dse.engine import AnalysisCache as RefCache
    from repro.dse.space import CacheOption as RefOption
    from repro_torch.dse.engine import AnalysisCache
    from repro_torch.dse.space import CacheOption
    return ((RefCache(), [RefOption.of(n) for n in names]),
            (AnalysisCache(device="cpu"), [CacheOption.of(n) for n in names]))


def _same_columns(ref_tr, port_tr):
    a, b = ref_tr.trace, port_tr.trace
    for col in ("level", "hit", "bank", "mshr"):
        assert np.array_equal(np.asarray(getattr(a, col)),
                              getattr(b, col).cpu().numpy()), col
    assert ref_tr.cache.stats() == port_tr.cache.stats()


def test_replay_group_batches_once():
    from repro.core import accel as ref_accel
    names = ("32K+256K", "64K+256K", "64K+2M")
    (rc, rcaches), (pc, pcaches) = _engines(names)
    with reference_on_fixtures(), ref_accel.use_backend("jax"):
        rc.replay_group("NB", rcaches)
        pc.replay_group("NB", pcaches)
        assert rc.stats() == pc.stats()
        assert (pc.trace_builds, pc.trace_hits, pc.replay_batches) == (3, 0, 1)
        for r_opt, p_opt in zip(rcaches, pcaches):
            _same_columns(rc.trace("NB", r_opt), pc.trace("NB", p_opt))
        assert rc.stats() == pc.stats()
        assert (pc.trace_builds, pc.trace_hits) == (3, 3)
        rc.replay_group("NB", rcaches)
        pc.replay_group("NB", pcaches)
        assert rc.stats() == pc.stats()
        assert (pc.trace_builds, pc.replay_batches) == (3, 1)


def test_replay_group_numpy_backend_degrades_to_trace():
    """The reference's numpy backend replays each geometry on its own
    (``replay_batches`` 0); the port always batches (ROADMAP, reference
    behaviours: the engines' ``stats()`` match under ``EVA_CIM_ACCEL=jax``),
    so the port is held to the numpy backend's builds and columns, and its
    batch count to the jax backend's."""
    from repro.core import accel as ref_accel
    names = ("32K+256K", "64K+256K")
    (rc, rcaches), (pc, pcaches) = _engines(names)
    with reference_on_fixtures():
        with ref_accel.use_backend("numpy"):
            rc.replay_group("NB", rcaches)
        pc.replay_group("NB", pcaches)
        assert rc.trace_builds == pc.trace_builds == 2
        assert rc.replay_batches == 0 and pc.replay_batches == 1
        for r_opt, p_opt in zip(rcaches, pcaches):
            _same_columns(rc.trace("NB", r_opt), pc.trace("NB", p_opt))
