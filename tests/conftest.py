import sys
import types

import numpy as np
import pytest

# ----------------------------------------------------------------------
# hypothesis compatibility shim: the CI/container image may not ship
# hypothesis.  Property tests then run against a deterministic seeded
# sampler with the same strategy surface (integers / sampled_from / lists),
# so `from hypothesis import given, settings, strategies` keeps working.
# ----------------------------------------------------------------------
try:
    import hypothesis  # noqa: F401
except ImportError:
    class _Strategy:
        def __init__(self, sample):
            self.sample = sample

    def _integers(lo, hi):
        return _Strategy(lambda rng: int(rng.integers(lo, hi + 1)))

    def _sampled_from(seq):
        items = list(seq)
        return _Strategy(lambda rng: items[int(rng.integers(len(items)))])

    def _lists(elem, min_size=0, max_size=10):
        return _Strategy(lambda rng: [
            elem.sample(rng)
            for _ in range(int(rng.integers(min_size, max_size + 1)))])

    def _given(*strats):
        def deco(fn):
            def wrapper():
                n = getattr(wrapper, "_max_examples", 20)
                rng = np.random.default_rng(0)
                for _ in range(n):
                    fn(*[s.sample(rng) for s in strats])
            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            return wrapper
        return deco

    def _settings(max_examples=20, **_ignored):
        def deco(fn):
            fn._max_examples = max_examples
            return fn
        return deco

    _st = types.ModuleType("hypothesis.strategies")
    _st.integers, _st.sampled_from, _st.lists = _integers, _sampled_from, _lists
    _hyp = types.ModuleType("hypothesis")
    _hyp.given, _hyp.settings, _hyp.strategies = _given, _settings, _st
    _hyp.__stub__ = True
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where none is present")
