"""repro_torch.dse.adaptive against repro.dse.adaptive (twin of
``tests/test_adaptive.py``): the same neighborhoods and seeds, and on the
same space the same frontier, the same records and the same points priced
in every round."""
import pytest
torch = pytest.importorskip("torch")  # CI images without torch skip the port

from repro import dse as ref

from repro_torch import dse as port
from test_torch_dse import both, norm, ref_key, reference_on_fixtures

SPACE = dict(workloads=("NB", "KM"),
             caches=("32K+256K", "64K+256K", "64K+2M"),
             cim_levels=("L1_only", "L2_only", "both"),
             techs=("sram", "fefet"),
             hosts=("inorder-1GHz", "A9-1GHz", "big-OoO-2GHz"))


def summary(result):
    """Everything an adaptive run decides, as plain values."""
    return {"rounds": [(r.round, r.n_candidates, r.n_priced,
                        r.frontier_size, r.stable) for r in result.rounds],
            "frontier": [r.to_dict() for r in result.frontier],
            "records": [r.to_dict() for r in result.results],
            "n_priced": result.n_priced, "space_size": result.space_size,
            "savings": result.savings}


def test_neighborhoods_equal_reference():
    rs, ps = both(**SPACE, cim_sets=("logic", "stt"))
    for rp, pp in zip(rs.points(), ps.points()):
        assert [m.label for m in port.neighborhood(pp, ps)] == \
            [m.label for m in ref.neighborhood(rp, rs)]
        assert [norm(m.key) for m in port.neighborhood(pp, ps)] == \
            [norm(ref_key(m)) for m in ref.neighborhood(rp, rs)]


def test_coarse_seed_equals_reference():
    rs, ps = both(**SPACE)
    assert [p.label for p in port.coarse_seed(ps)] == \
        [p.label for p in ref.coarse_seed(rs)]
    assert len(port.coarse_seed(ps)) == 4


@pytest.mark.parametrize("objectives,max_rounds", [
    (("energy_improvement", "speedup"), 8),
    (("energy_improvement", ("cim_energy_pj", "min")), 8),
    (("energy_improvement", "speedup"), 1),
])
def test_adaptive_run_equals_reference(objectives, max_rounds):
    rs, ps = both(**SPACE)
    with reference_on_fixtures():
        want = ref.AdaptiveDSE(rs, engine=ref.DSEEngine(),
                               objectives=objectives,
                               max_rounds=max_rounds).run()
    got = port.AdaptiveDSE(ps, engine=port.DSEEngine(device="cpu"),
                           objectives=objectives,
                           max_rounds=max_rounds).run()
    assert summary(got) == summary(want)
    got.results.elapsed_s = want.results.elapsed_s
    assert got.to_markdown() == want.to_markdown()


def test_run_iter_and_explicit_seed_equal_reference():
    rs, ps = both(**SPACE)
    seed_r, seed_p = both(workloads=("KM",), caches=("64K+2M",),
                          cim_levels=("both",), hosts=("A9-1GHz",))
    with reference_on_fixtures():
        want = ref.AdaptiveDSE(rs, engine=ref.DSEEngine()).run(seed_r)
    events = list(port.AdaptiveDSE(
        ps, engine=port.DSEEngine(device="cpu")).run_iter(seed_p))
    assert [(e.info.round, e.info.n_candidates, e.info.n_priced,
             e.info.frontier_size, e.info.stable) for e in events] == \
        [(r.round, r.n_candidates, r.n_priced, r.frontier_size, r.stable)
         for r in want.rounds]
    assert [r.to_dict() for r in events[-1].frontier] == \
        [r.to_dict() for r in want.frontier]
    assert [r.to_dict() for r in events[-1].results] == \
        [r.to_dict() for r in want.results]
    outside = port.SweepSpace(workloads=("LCS",))
    with pytest.raises(ValueError, match="outside the design space"):
        port.AdaptiveDSE(ps, engine=port.DSEEngine(device="cpu")).run(outside)


def test_adaptive_rounds_are_free_on_warm_store(tmp_path):
    _, ps = both(**SPACE)
    port.DSEEngine(store=tmp_path, device="cpu").run(ps)
    result = port.AdaptiveDSE(
        ps, engine=port.DSEEngine(store=tmp_path, device="cpu")).run()
    for info in result.rounds:
        assert info.stats["trace_builds"] == 0
        assert info.stats["offload_builds"] == 0
    assert result.rounds[0].stats["store_l1_hits"] >= 1
