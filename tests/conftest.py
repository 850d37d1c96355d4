"""Shared test config.

hypothesis is a dev-extra (requirements-dev.txt); a fresh checkout without
it must not fail collection (the seed repo died with ModuleNotFoundError
before running a single test).  Modules that use hypothesis fall back to
these stubs, which skip ONLY the property tests — every example-based test
in the same module still runs.  CI installs hypothesis, so nothing is
skipped there.
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skips in its fixture "
        "where none is present)")


try:
    import hypothesis  # noqa: F401
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False


def given(*_a, **_k):
    """Stand-in for hypothesis.given: replaces the test with a skip."""
    def deco(_f):
        def _skipper():
            pytest.skip("hypothesis not installed (see requirements-dev.txt)")
        _skipper.__name__ = _f.__name__
        _skipper.__doc__ = _f.__doc__
        return _skipper
    return deco


def settings(*_a, **_k):
    """Stand-in for hypothesis.settings: identity decorator."""
    return lambda f: f


class _Strategies:
    """Stand-in for hypothesis.strategies: any strategy constructor resolves
    to an inert placeholder (never drawn from — the test is skipped)."""

    def __getattr__(self, name):
        return lambda *a, **k: None


st = _Strategies()
