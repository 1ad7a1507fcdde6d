"""All 17 workloads priced by the port's DSE engine on the CPU against the
reference's golden reports: the 306 design points of fig14 geometries x
fig15 CiM level sets x fig16 technologies, compared with == (the floats
included) by (cache, level set, tech), and the replay counters of every
geometry.  The engine traces each program on the port's VM, as a user's
sweep does.

``chip_smoke.py`` runs the same comparison on the card."""
import pytest

pytest.importorskip("torch")  # CI images without torch skip the port

from repro_torch.dse import DSEEngine
from repro_torch.workloads import fixtures


@pytest.mark.parametrize("name", fixtures.WORKLOADS)
def test_fixture_design_points_equal_reference_reports(name):
    golden = fixtures.reference_reports()["workloads"][name]
    engine = DSEEngine(device="cpu")
    results = engine.run(fixtures.design_point_space([name]))
    records, counters = fixtures.engine_design_points(engine, results)[name]
    assert len(records) == len(fixtures.CACHES) * len(fixtures.LEVEL_SETS) \
        * len(fixtures.TECHS) == len(golden["records"])
    assert records == fixtures.golden_by_key(golden["records"])
    # the engine's enumeration is the golden file's record order
    assert list(records) == list(fixtures.golden_by_key(golden["records"]))
    assert counters == golden["counters"]
