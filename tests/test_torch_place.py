"""Placement (``repro_torch.core.accel.place``) against the reference, on
the CPU.

On a CPU trace ``place_candidates`` takes the plain version of the
placement kernel (``csrc/place.cu``): per proto a scatter max and sum over
its leaves and a unique of (proto, line) rows over its accesses.  These
tests hold that plain version, exactly, to

  * the reference's numpy ``_place`` and ``place_candidates_jax`` (with
    the Pallas segment kernels forced on, in interpret mode) on synthetic
    partitions: protos with no leaves, with no loads (bank ``None``), with
    no accesses, runs of 1, 33 and 1,100 accesses with repeated lines, MEM
    and non-MEM accesses mixed in one run, under the three level sets;
  * the port's second formulation, ``place_sorted`` (segment ops and a
    sort of packed keys), on the astar, LCS and h264ref fixtures under
    the three Fig. 14 geometries;
  * the numpy ``_place`` with access addresses of 2**46 and more, where
    the packed (proto, line) key of ``place_sorted`` does not fit, and a
    direct per-proto count of distinct lines where the numpy key itself
    (``proto * 2**40 + line``) no longer separates the protos.

The kernel is held to the same plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro.core import accel as ref_accel
from repro.core.accel.place import place_candidates_jax
from repro.core.offload import OffloadConfig as RefOffloadConfig
from repro.core.offload import _place as ref_place

from repro_torch.core.accel import place
from repro_torch.core.isa import LEVEL_MEM
from repro_torch.core.offload import OffloadConfig, select_candidates
from repro_torch.core.trace import attach_cache_results_batch
from repro_torch.workloads import fixtures

LEVEL_SETS = (("L1", "L2"), ("L1",), ("L2",))


def cand_tuple(c):
    return (c.root_seq, tuple(c.op_seqs), tuple(c.op_classes),
            tuple(c.load_seqs), tuple(c.store_seqs), c.level, c.bank,
            c.moves, c.internal_edges, c.added_loads, c.memval_leaves,
            c.dram_fills)


@dataclasses.dataclass
class Proto:
    """The structural fields of a proto-candidate that placement and the
    join read (both packages' ``_ProtoCandidate``)."""
    root_seq: int
    op_seqs: list
    op_classes: list
    load_seqs: list
    store_seqs: list
    internal_edges: int
    added_loads: int
    memval_leaves: int
    leaf_src: list


def synthetic(seed, n_inst=2048, addr_hi=2 ** 30, runs=(1, 33, 1100),
              n_random=40):
    """(protos, numpy level/addr/bank columns).  Lines repeat (64 distinct
    lines below ``addr_hi``) and levels are drawn from none/L1/L2/MEM, so
    each run mixes MEM and non-MEM accesses."""
    rng = np.random.default_rng(seed)
    lines = rng.integers(0, addr_hi // 64, 64)
    cols = dict(level=rng.integers(0, 4, n_inst).astype(np.int8),
                addr=(lines[rng.integers(0, 64, n_inst)] * 64
                      + rng.integers(0, 64, n_inst)).astype(np.int64),
                bank=rng.integers(0, 16, n_inst).astype(np.int16))

    def proto(n_leaf, n_load, n_store):
        i = len(protos)
        protos.append(Proto(
            root_seq=i, op_seqs=[i], op_classes=["add"],
            load_seqs=rng.integers(0, n_inst, n_load).tolist(),
            store_seqs=rng.integers(0, n_inst, n_store).tolist(),
            internal_edges=i % 3, added_loads=i % 2, memval_leaves=i % 5,
            leaf_src=rng.integers(0, n_inst, n_leaf).tolist()))

    protos = []
    proto(0, 3, 1)                   # no leaves
    proto(5, 0, 4)                   # no loads: bank None
    proto(2, 0, 0)                   # no accesses
    for n in runs:                   # runs of n accesses, loads and stores
        proto(int(rng.integers(1, 70)), n - n // 3, n // 3)
    for _ in range(n_random):
        proto(int(rng.integers(0, 9)), int(rng.integers(0, 40)),
              int(rng.integers(0, 3)))
    return protos, cols


def ref_trace(cols):
    return types.SimpleNamespace(**cols, _struct={})


def port_trace(cols):
    return types.SimpleNamespace(
        **{k: torch.from_numpy(v) for k, v in cols.items()},
        device=torch.device("cpu"), _struct={})


def part_of(protos):
    return types.SimpleNamespace(protos=protos)


@pytest.mark.parametrize("levels", LEVEL_SETS)
@pytest.mark.parametrize("seed", (0, 1))
def test_plain_placement_matches_reference_on_synthetic_partitions(
        seed, levels, monkeypatch):
    monkeypatch.setenv("EVA_CIM_PALLAS", "1")   # interpret-mode Pallas ops
    protos, cols = synthetic(seed)
    ref_cfg = RefOffloadConfig(cim_levels=levels)
    with ref_accel.use_backend("numpy"):
        want = [cand_tuple(c) for c in ref_place(part_of(protos),
                                                 ref_trace(cols), ref_cfg)]
    assert [cand_tuple(c) for c in place_candidates_jax(
        part_of(protos), ref_trace(cols), ref_cfg)] == want
    got = place.place_candidates(part_of(protos), port_trace(cols),
                                 OffloadConfig(cim_levels=levels))
    assert [cand_tuple(c) for c in got] == want
    assert want[1][6] is None and want[2][11] == 0   # no loads, no fills
    assert any(c[11] for c in want)                  # some fills


@pytest.mark.parametrize("levels", LEVEL_SETS)
def test_plain_placement_matches_place_sorted_on_synthetic(levels):
    protos, cols = synthetic(7, n_random=300)
    cfg = OffloadConfig(cim_levels=levels)
    ct = port_trace(cols)
    got = place.place_arrays(part_of(protos), ct, cfg)
    assert got.dtype == torch.int32 and got.shape == (4, len(protos))
    assert torch.equal(got, place.place_sorted(part_of(protos), ct, cfg))
    assert place.placement_lists(part_of(protos), ct, cfg) == got.tolist()


@pytest.fixture(scope="module")
def fixture_traces():
    """Per workload, its trace under each Fig. 14 geometry (CPU)."""
    out = {}
    for name in ("astar", "LCS", "h264ref"):
        st = fixtures.load_structural(name, device="cpu")
        out[name] = attach_cache_results_batch(
            st, list(fixtures.CACHES.values()), device="cpu")
    return out


@pytest.mark.parametrize("geometry", range(len(fixtures.CACHES)))
@pytest.mark.parametrize("name", ("astar", "LCS", "h264ref"))
def test_plain_placement_matches_place_sorted_on_fixtures(
        fixture_traces, name, geometry):
    ct = fixture_traces[name][geometry].trace
    for levels in LEVEL_SETS:
        cfg = OffloadConfig(cim_levels=levels)
        select_candidates(ct, cfg, device="cpu")      # memoizes the partition
        part = ct._struct["partitions"][cfg.partition_key()]
        got = place.place_arrays(part, ct, cfg)
        assert torch.equal(got, place.place_sorted(part, ct, cfg)), levels
        assert int(got[2].sum()) > 0 or levels == ("L1",)


@pytest.mark.parametrize("levels", LEVEL_SETS)
def test_placement_with_addresses_beyond_2_46_matches_reference(levels):
    """Accesses at 2**46 and above that L1 or L2 served, beside MEM-served
    ones below: the numpy ``_place`` answers, the packed key of
    ``place_sorted`` does not fit, the plain placement equals numpy."""
    protos, cols = synthetic(3)
    high = cols["level"] != LEVEL_MEM
    cols["addr"][high] += 2 ** 46 + 2 ** 50 * (np.arange(high.sum()) % 7)
    assert cols["addr"].max() >= 2 ** 46
    ref_cfg = RefOffloadConfig(cim_levels=levels)
    with ref_accel.use_backend("numpy"):
        want = [cand_tuple(c) for c in ref_place(part_of(protos),
                                                 ref_trace(cols), ref_cfg)]
    cfg = OffloadConfig(cim_levels=levels)
    got = place.place_candidates(part_of(protos), port_trace(cols), cfg)
    assert [cand_tuple(c) for c in got] == want
    with pytest.raises(ValueError, match="exceeds int64"):
        place.place_sorted(part_of(protos), port_trace(cols), cfg)


def test_placement_counts_distinct_lines_beyond_the_packed_key():
    """MEM-served lines of 2**40 and more: each proto's fills are its
    distinct lines, counted directly."""
    protos, cols = synthetic(4, addr_hi=2 ** 60)
    assert (cols["addr"][cols["level"] == LEVEL_MEM] >> 6).max() >= 2 ** 40
    got = place.place_arrays(part_of(protos), port_trace(cols),
                             OffloadConfig())
    want = [len({int(cols["addr"][s]) >> 6
                 for s in p.load_seqs + p.store_seqs
                 if cols["level"][s] == LEVEL_MEM}) for p in protos]
    assert got[2].tolist() == want


def test_plain_placement_takes_more_than_2_22_protos():
    """Past 2**22 protos (where ``place_sorted``'s key runs out): all but
    the last few protos are empty and place at the shallowest enabled
    depth; the last few equal the numpy ``_place`` of themselves."""
    protos, cols = synthetic(5, runs=(1, 33), n_random=3)
    n = 2 ** 22 + 1
    tail = len(protos)
    flat = place._flat_arrays(part_of(protos), port_trace(cols),
                              OffloadConfig())
    pad = n - tail

    def shifted(off):
        return torch.cat([torch.zeros(pad, dtype=torch.int64), off])

    leaf_seq, leaf_off, acc_seq, acc_off, first_load = flat
    big = (leaf_seq, shifted(leaf_off), acc_seq, shifted(acc_off),
           torch.cat([torch.zeros(pad, dtype=torch.int64), first_load]))
    got = place._plain(port_trace(cols), big, (0, 1), 1)
    assert got.shape == (4, n)
    head = got[:, :pad]
    assert (head[:3] == 0).all()
    assert (head[3] == int(cols["bank"][0])).all()
    with ref_accel.use_backend("numpy"):
        want = ref_place(part_of(protos), ref_trace(cols),
                         RefOffloadConfig(cim_levels=("L1", "L2")))
    level_depth = {"L1": 0, "L2": 1, "MEM": 2}
    assert got[:, pad:].tolist() == [
        [level_depth[c.level] for c in want], [c.moves for c in want],
        [c.dram_fills for c in want],
        [int(cols["bank"][p.load_seqs[0]]) if p.load_seqs else
         int(cols["bank"][0]) for p in protos]]
