"""The serving steps of ``repro.train`` (training follows in a later slice)."""
