"""Test-suite bootstrap.

* Puts ``src/`` on ``sys.path`` so ``pytest`` works without exporting
  ``PYTHONPATH`` (the documented tier-1 command still works unchanged).
* If ``hypothesis`` is not installed (the offline container cannot pip
  install), registers the deterministic fallback from
  ``_hypothesis_fallback.py`` so all test modules collect and the property
  tests still run.  CI installs the real hypothesis via
  ``requirements-dev.txt``.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

try:
    import hypothesis  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(__file__))
    from _hypothesis_fallback import install

    install()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped on hosts without one")
