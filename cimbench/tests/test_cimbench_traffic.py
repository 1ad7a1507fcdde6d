"""The CiM kind's traffic generator: a seed gives one sequence of units,
other seeds others, the same as before configurations had kinds, and each
mix keeps its promises (no geometry twice in a pass run, no (program,
geometry) pair twice in a request run, clocks re-scaled as the presets
are)."""
import hashlib
import itertools
import json
import pathlib

import pytest

from cimbench import generator, kinds
from cimbench.manifest import union
from cimbench.ref.host_model import HOST_PRESETS
from cimbench.yardstick import scale_host_clock

ROOT = pathlib.Path(__file__).resolve().parents[2]
#: the benchmark's cells and those not admitted yet
DOC = union(ROOT)
CONFIGS = {c["name"]: json.loads((ROOT / c["file"]).read_text())
           for c in DOC["configs"]}
#: the cells of the CiM kind, whose mixes this generator reads
CIM = [c for c in DOC["workloads"]
       if CONFIGS[c["config"]].get("kind", kinds.DEFAULT) == "cim"]
#: sha256 of the JSON (sorted keys) of the first 20 units each mix drew
#: at seeds 1, 2 and 3 before the harness asked configurations for
#: their kind
UNITS_AT = {
    "exact-geometry": (
        "98af237e903bc939f79a6ee03f6c998c1ea7f52358886f27ae805c175f205235",
        "8b6c782af5583902f25dfb1c9a49b0ef9483bb8fc2e36367304261c2f11da711",
        "bafef99446d64a8df8b2029164f0d7011e11adf715efd8f1b673032040e491b9"),
    "sampled-km256": (
        "7f39bfbebc9410986310d793c1822552746d471a47c76cb236a182fe242e8dcb",
        "59bc0a326dd1f00836165869790fe64065cdb1eff871ba2bb54e665677d42fc5",
        "542bb8815bb65cd122e0e95f056b936fb15d9360db53dc597bbc4d4bec8d0eaa"),
    "exact-points": (
        "b5c38787a844c9553fb6577cc9f7e3aa83f8e88c4f047aecfb93ec8ea789e200",
        "16b32f90feb48158a89a576a49a1f30e338287ebbed4b91251ee5c35a64a03ec",
        "5474f730927d77aeaaa3a9f581c6f913b733a3e36d391245e1d2bd106d6a4829"),
    "exact-pricing": (
        "e590106eccab60adb1ae80c22bb342c12f22f3052144690b524dfb2bd4acc028",
        "728b2b7da1e11938db05279fab309e2ea4abb1a0e027daebd8796fe8e0810833",
        "82d67641f847479e12236d1e512df4db34d285598fcdef72b639e07e3fb8317d"),
}


def traffic(cell, seed):
    config = CONFIGS[cell["config"]]
    return kinds.of(config).traffic(
        ROOT / "cimbench" / "traffic" / f"{cell['traffic']}.json", config,
        seed)


def first(cell, seed, n=4):
    return list(itertools.islice(traffic(cell, seed).units(), n))


@pytest.mark.parametrize("cell", CIM, ids=lambda c: c["name"])
def test_a_seed_repeats_and_other_seeds_differ(cell):
    big = 2 ** 31 + 12345
    assert first(cell, big) == first(cell, big)
    assert first(cell, big) != first(cell, big + 1)
    assert traffic(cell, 7).warm_points() == traffic(cell, 8).warm_points()


@pytest.mark.parametrize("mix,seed", [
    pytest.param(m, s, id=f"{m}-{s}") for m in UNITS_AT for s in (1, 2, 3)])
def test_a_mix_draws_the_units_it_drew_before_kinds(mix, seed):
    cell = next(c for c in CIM if c["traffic"] == mix)
    got = json.dumps(first(cell, seed, n=20), sort_keys=True).encode()
    assert hashlib.sha256(got).hexdigest() == UNITS_AT[mix][seed - 1]


def test_pass_geometries_never_repeat_in_a_run():
    cell = next(c for c in DOC["workloads"] if c["name"] == "exact-geometry")
    seen = []
    for u in first(cell, 99, n=30):
        geos = {json.dumps(p["geometry"]) for p in u["points"]}
        assert len(geos) == 3 and len(u["points"]) == 17 * 3 * 3 * 2
        seen += sorted(geos)
    assert len(seen) == len(set(seen))


def test_requests_never_repeat_a_program_and_geometry():
    cell = next(c for c in DOC["workloads"] if c["name"] == "exact-points")
    pairs = [(u["points"][0]["workload"], json.dumps(u["points"][0]
                                                     ["geometry"]))
             for u in first(cell, 5, n=600)]
    assert len(pairs) == len(set(pairs))
    assert {w for w, _ in pairs} == set(CONFIGS["table4-exact"]["workloads"])
    # a 51 s window at up to ~80 requests a second never runs out
    assert len(traffic(cell, 5).geometries()) * 17 >= 4800


def test_pricing_passes_reclock_every_host():
    cell = next(c for c in DOC["workloads"] if c["name"] == "exact-pricing")
    clocks = set()
    for u in first(cell, 3, n=5):
        hosts = {p["host"]["name"]: p["host"] for p in u["points"]}
        assert len(hosts) == 4 and len(u["points"]) == 1224
        for h in hosts.values():
            assert 0.5 <= h["freq_ghz"] <= 3.0
            clocks.add(h["freq_ghz"])
    assert len(clocks) == 20


def test_clock_scaling_turns_a9_1ghz_into_a9_2ghz():
    fields = generator.host_fields("A9-1GHz")
    got = scale_host_clock(fields, 2.0)
    want = generator.host_fields("A9-2GHz")
    for k in ("l2_stall", "mem_stall", "static_pj_per_cycle", "freq_ghz",
              "pipeline_pj", "base_cpi", "overlap", "unit_pj"):
        assert got[k] == want[k], k
    assert HOST_PRESETS["A9-2GHz"].freq_ghz == 2.0


def test_every_sampled_unit_analyses_the_same_seeds_in_its_own_order():
    cell = next(c for c in DOC["workloads"] if c["name"] == "sampled-km256")
    mix = json.loads((ROOT / "cimbench" / "traffic"
                      / "sampled-km256.json").read_text())
    cycle = mix["sampling"]["seed"]["cycle"]
    orders = [[p["sampling"]["seed"] for p in u["points"]]
              for u in first(cell, 11, n=6)]
    assert all(sorted(o) == sorted(cycle) for o in orders)
    assert len({tuple(o) for o in orders}) > 1
    doc = json.loads((ROOT / "cimbench" / "ref"
                      / "sampled_windows.json").read_text())
    assert set(map(int, doc["KM@256"]["seeds"])) == set(cycle)


def test_a_mix_sets_the_pass_engines_pool():
    from cimbench.port import Port
    cell = next(c for c in DOC["workloads"] if c["name"] == "exact-geometry")
    assert Port(traffic(cell, 1), CONFIGS["table4-exact"], "cpu"
                )._new_engine().max_workers == 1
    cell = next(c for c in DOC["workloads"] if c["name"] == "exact-pricing")
    assert "workers" not in traffic(cell, 1).params
