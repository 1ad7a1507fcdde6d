"""The port's kernel modules against the reference's, on the CPU.

On the CPU each kernel wrapper of ``repro_torch.core.accel`` takes its
plain version, so these tests hold those plain versions -- the arithmetic
the CUDA kernels must reproduce -- to the reference's kernels:

  * ``segment_sum`` / ``segment_max`` against the reference's Pallas
    kernels run in interpret mode (as ``tests/test_accel.py`` runs them),
    with empty segments, out-of-range ids and ``n = 0``;
  * placement (``place_candidates``, composed from the segment ops, as
    ``offload._place`` calls it) against ``place_candidates_jax`` with the
    Pallas segment kernels forced on, and against the numpy ``_place``;
  * the replay (``CacheHierarchy.replay`` + ``counters``, through
    ``replay_columns_batch``) against the reference's batched jax replay
    and its OrderedDict machine, on fuzzed streams.

All comparisons are exact: the pipeline is integer.  The CUDA kernels are
held to these plain versions by ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` on the card.
"""
import dataclasses

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

from repro_torch.core.accel.pallas_ops import (INT32_MIN, segment_max,
                                               segment_sum)
from repro_torch.core.accel.place import place_candidates
from repro_torch.core.accel.replay import replay_columns_batch
from repro_torch.core.cache import CacheConfig, L1_32K, L1_64K, L2_256K, \
    L2_2M, SPM_1M
from repro_torch.core.columnar import ColumnarTrace
from repro_torch.core.idg import IDGBuilder, build_flow_index
from repro_torch.core.offload import OffloadConfig, _partition, _place


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
