"""The port's deterministic studies (``experiments/*_study_torch.py``)
against the JAX package's, line for line.

Each study's ``run()`` prices, simulates or designs on analytic models the
port carries unchanged, at the published settings, so the torch twin must
print the JAX study's lines exactly (both modules loaded from their files,
each putting ``src`` on the path as it does when run as a script).
"""
import importlib.util
import os

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

STUDIES = ["padded_policy_study", "sim_slo_study", "drift_study",
           "design_space_study", "robust_autoconf_study",
           "precision_tradeoff_study"]


def load(name, suffix=""):
    spec = importlib.util.spec_from_file_location(
        f"{name}{suffix}_under_test",
        os.path.join(ROOT, "experiments", f"{name}{suffix}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", STUDIES)
def test_the_study_prints_the_jax_studys_lines(name):
    want = load(name).run()
    got = load(name, "_torch").run()
    assert len(want) > 5
    assert got == want
