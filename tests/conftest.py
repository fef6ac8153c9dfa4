import sys
import types

import pytest


# ---------------------------------------------------------------------------
# Optional-dependency guard: the suite must collect and run everywhere.
#
# Property tests use hypothesis; when it is absent we install a minimal
# stub so `from hypothesis import given, settings, strategies as st` still
# imports, and every @given-decorated test is collected as *skipped*
# (plain tests in the same modules run normally).
# ---------------------------------------------------------------------------

HYPOTHESIS_SKIP_REASON = ("hypothesis not installed; property test "
                          "skipped — install the [dev] extra "
                          "(pip install -e '.[dev]') to run it")

try:
    import hypothesis  # noqa: F401
except ImportError:
    def _given_stub(*_args, **_kwargs):
        def deco(fn):
            return pytest.mark.skip(reason=HYPOTHESIS_SKIP_REASON)(fn)
        return deco

    def _settings_stub(*_args, **_kwargs):
        if _args and callable(_args[0]) and len(_args) == 1 and not _kwargs:
            return _args[0]              # bare @settings usage
        return lambda fn: fn

    class _StubStrategy:
        # real strategies support chained combinators (.map/.filter/...)
        # called at module scope while building @given arguments — the
        # stub must absorb any such chain, or every property module
        # using them would crash at collection and its plain tests
        # would silently vanish with it
        def map(self, *_args, **_kwargs):
            return self

        filter = flatmap = map

        def example(self, *_args, **_kwargs):
            return None

    def _strategy_stub(*_args, **_kwargs):
        return _StubStrategy()

    def _composite_stub(fn):
        # real @st.composite wraps a function that is then *called* at
        # module scope to build strategies — same survival requirement
        return lambda *_args, **_kwargs: _StubStrategy()

    def _decorator_stub(*_args, **_kwargs):
        return lambda fn: fn             # @example(...) / @seed(...)

    def _noop(*_args, **_kwargs):
        return None                      # assume(...) / note(...)

    _st = types.ModuleType("hypothesis.strategies")
    for _name in ("integers", "floats", "booleans", "lists", "tuples",
                  "sampled_from", "text", "just", "one_of", "none",
                  "builds", "dictionaries", "sets", "permutations",
                  "data"):
        setattr(_st, _name, _strategy_stub)
    _st.composite = _composite_stub

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given_stub
    _hyp.settings = _settings_stub
    _hyp.strategies = _st
    _hyp.assume = _noop
    _hyp.note = _noop
    _hyp.example = _decorator_stub
    _hyp.seed = _decorator_stub
    _hyp.HealthCheck = types.SimpleNamespace(too_slow=None,
                                             data_too_large=None,
                                             function_scoped_fixture=None)
    _hyp.__stub__ = True
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


def pytest_report_header(config):
    if getattr(sys.modules.get("hypothesis"), "__stub__", False):
        return ("hypothesis: NOT INSTALLED — @given property tests (e.g. "
                "tests/test_algebra_props.py) are collected as skipped; "
                "their fixed-example twins still run")
    return None


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="run slow (subprocess / multi-device) tests")


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: subprocess / multi-device")
    config.addinivalue_line(
        "markers",
        "faults: fault-injection robustness suite (tests/test_faults.py)")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the port's CUDA kernels); "
        "skips where torch.cuda.is_available() is False")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="needs --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
