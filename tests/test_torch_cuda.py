"""The CUDA kernels against their plain versions, on the card.

Every test here carries the ``cuda`` marker and skips where no GPU is
present (the CPU suite); the file imports neither JAX nor ``repro``, so it
runs on a machine that has only the port.  On a GPU machine::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Comparisons are exact: the kernels are integer.
"""
import numpy as np
import pytest
torch = pytest.importorskip("torch")  # CI images without torch skip the port

from repro_torch.core import accel
from repro_torch.core.accel.pallas_ops import segment_max, segment_sum
from repro_torch.core.accel.replay import replay_columns_batch
from repro_torch.core.cache import CacheConfig, SPM_1M
from repro_torch.core.isa import OP_STORE
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


@pytest.mark.parametrize("n,n_seg", [(0, 4), (1, 1), (1000, 37),
                                     (100_000, 5000),
                                     (4_000_000, 70_000)])  # grid-strides
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


@pytest.mark.parametrize("name", ("NB", "KM", "LCS"))
def test_design_points_on_the_card_equal_reference_reports(cuda, name):
    golden = fixtures.reference_reports()["workloads"][name]
    accel.reset_launch_counts()
    records, counters = fixtures.price_design_points(
        fixtures.load_structural(name, device=cuda), device=cuda)
    assert records == golden["records"]
    assert counters == golden["counters"]
    assert all(v > 0 for v in accel.launch_counts().values())
