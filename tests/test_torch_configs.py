"""The port's architecture registry against the JAX package's.

Every config is copied field for field (full and smoke), the registry's
ids, the sub-quadratic rule and the shape cells are the same, and
``input_specs`` gives ``meta`` tensors with the shapes and dtypes of the
JAX package's ``ShapeDtypeStruct`` stand-ins, for every arch x shape cell.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro_torch import configs
from repro_torch.configs.base import SHAPES

_DTYPES = {torch.int32: jnp.int32, torch.bfloat16: jnp.bfloat16,
           torch.float32: jnp.float32}


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_match_the_jax_package_field_by_field(arch, smoke):
    got = configs.get_config(arch, smoke=smoke)
    want = jconfigs.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # and the derived widths every model and footprint reads
    for prop in ("padded_vocab", "d_inner", "ssm_heads", "mlstm_inner"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.block_counts() == want.block_counts()
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()


def test_registry_matches_the_jax_package():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert len(configs.ARCH_IDS) == 10
    assert configs.SUBQUADRATIC == jconfigs.SUBQUADRATIC
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for arch in configs.ARCH_IDS:
        assert [dataclasses.asdict(c) for c in configs.shape_cells(arch)] \
            == [dataclasses.asdict(c) for c in jconfigs.shape_cells(arch)]
        assert configs.skipped_cells(arch) == jconfigs.skipped_cells(arch)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_input_specs_match_the_jax_stand_ins(arch, smoke):
    cfg = configs.get_config(arch, smoke=smoke)
    jcfg = jconfigs.get_config(arch, smoke=smoke)
    for cell in configs.shape_cells(arch):
        got = configs.input_specs(cfg, cell)
        want = jconfigs.input_specs(jcfg, jconfigs.SHAPES[cell.name])
        assert set(got) == set(want), cell.name
        for key, spec in want.items():
            t = got[key]
            assert t.device.type == "meta", (cell.name, key)
            assert tuple(t.shape) == tuple(spec.shape), (cell.name, key)
            assert np.dtype(_DTYPES[t.dtype]) == np.dtype(spec.dtype), \
                (cell.name, key)
