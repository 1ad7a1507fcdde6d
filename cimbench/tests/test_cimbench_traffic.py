"""The one traffic generator: a seed gives one sequence of units, other
seeds others, and each mix keeps its promises (no geometry twice in a
pass run, no (program, geometry) pair twice in a request run, clocks
re-scaled as the presets are)."""
import itertools
import json
import pathlib

import pytest

from cimbench import generator
from cimbench.ref.host_model import HOST_PRESETS
from cimbench.yardstick import scale_host_clock

ROOT = pathlib.Path(__file__).resolve().parents[2]
#: the benchmark's cells and those not admitted yet
DOC = json.loads((ROOT / "cimbench" / "pending.json").read_text())
CONFIGS = {c["name"]: json.loads((ROOT / c["file"]).read_text())
           for c in DOC["configs"]}


def traffic(cell, seed):
    params = generator.load(ROOT / "cimbench" / "traffic"
                            / f"{cell['traffic']}.json")
    return generator.Traffic(params, CONFIGS[cell["config"]], seed)


def first(cell, seed, n=4):
    return list(itertools.islice(traffic(cell, seed).units(), n))


@pytest.mark.parametrize("cell", DOC["workloads"], ids=lambda c: c["name"])
def test_a_seed_repeats_and_other_seeds_differ(cell):
    big = 2 ** 31 + 12345
    assert first(cell, big) == first(cell, big)
    assert first(cell, big) != first(cell, big + 1)
    assert traffic(cell, 7).warm_points() == traffic(cell, 8).warm_points()


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
