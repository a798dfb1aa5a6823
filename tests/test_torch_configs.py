"""The port's copy of the configs (repro_torch.configs) equals the JAX
package's: every field of every CONFIG / REDUCED pair, the derived
properties, and the shape table. Exact equality; no tolerance."""
import dataclasses
import importlib

import pytest

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models.config import ArchConfig as JArchConfig
from repro_torch.models.config import ArchConfig as TArchConfig

DERIVED = ("hd", "padded_vocab", "d_inner", "ssm_nheads", "lru_dim")


def test_arch_config_fields_equal():
    assert [(f.name, f.type, f.default) for f in dataclasses.fields(TArchConfig)] == \
        [(f.name, f.type, f.default) for f in dataclasses.fields(JArchConfig)]


@pytest.mark.parametrize("which", ["CONFIG", "REDUCED"])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_equal(arch, which):
    j = getattr(importlib.import_module(f"repro.configs.{arch}"), which)
    t = getattr(importlib.import_module(f"repro_torch.configs.{arch}"), which)
    assert isinstance(t, TArchConfig)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in DERIVED:
        assert getattr(t, prop) == getattr(j, prop), prop
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()


def test_shapes_and_lookups_equal():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.SUBQUADRATIC == jconfigs.SUBQUADRATIC
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert [(a, s.name) for a, s in tconfigs.all_cells()] == \
        [(a, s.name) for a, s in jconfigs.all_cells()]
    for arch in jconfigs.ARCH_IDS:
        alias = arch.replace("_", "-")
        assert dataclasses.asdict(tconfigs.get_config(alias)) == \
            dataclasses.asdict(jconfigs.get_config(arch))
        assert dataclasses.asdict(tconfigs.reduced_config(alias)) == \
            dataclasses.asdict(jconfigs.reduced_config(arch))
