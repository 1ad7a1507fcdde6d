"""All 17 trace fixtures priced by the port on the CPU against the
reference's golden reports: the 306 design points of fig14 geometries x
fig15 CiM level sets x fig16 technologies, compared with == (the floats
included), and the replay counters of every geometry.

``chip_smoke.py`` runs the same comparison on the card."""
import pytest

pytest.importorskip("torch")  # CI images without torch skip the port

from repro_torch.workloads import fixtures


@pytest.mark.parametrize("name", fixtures.WORKLOADS)
def test_fixture_design_points_equal_reference_reports(name):
    golden = fixtures.reference_reports()["workloads"][name]
    st = fixtures.load_structural(name, device="cpu")
    records, counters = fixtures.price_design_points(st, device="cpu")
    assert len(records) == len(fixtures.CACHES) * len(fixtures.LEVEL_SETS) \
        * len(fixtures.TECHS) == len(golden["records"])
    for got, want in zip(records, golden["records"]):
        assert got == want
    assert counters == golden["counters"]
