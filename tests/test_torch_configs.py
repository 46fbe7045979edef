"""The port's configs are the JAX package's, field for field and arch for
arch (the port copies them because ``repro/configs/base.py`` imports JAX)."""
import dataclasses

import pytest
import torch

from repro.configs import base as jax_base
from repro.configs.archs import ARCHS as JAX_ARCHS
from repro.models import transformer as jax_tfm
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as torch_tfm

torch.set_num_threads(1)


def test_arch_config_fields_match():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(ArchConfig) == fields(jax_base.ArchConfig)


def test_archs_registry_matches():
    assert list(ARCHS) == list(JAX_ARCHS)
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_arch_and_smoke_match(name):
    ours, theirs = get_arch(name), JAX_ARCHS[name]
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(ours.smoke()) \
        == dataclasses.asdict(theirs.smoke())
    assert ours.layer_kinds() == theirs.layer_kinds()
    assert ours.kind_counts() == theirs.kind_counts()
    assert ours.distinct_kinds() == theirs.distinct_kinds()
    for cfg, jcfg in ((ours, theirs), (ours.smoke(), theirs.smoke())):
        assert dataclasses.asdict(torch_tfm.make_layout(cfg)) \
            == dataclasses.asdict(jax_tfm.make_layout(jcfg))
        assert torch_tfm.paged_supported(cfg) \
            == jax_tfm.paged_supported(jcfg)


def test_gemma_2b_full_width_is_one_scanned_stack():
    """At full width gemma-2b's 18 layers are one period stack (what the
    card runs); smoke() goes through with_layers and has no stack."""
    lay = torch_tfm.make_layout(get_arch("gemma-2b"))
    assert (lay.prefix, lay.period, lay.n_periods, lay.tail) \
        == ((), (("attn", "mlp"),), 18, ())
    smoke = torch_tfm.make_layout(get_arch("gemma-2b").smoke())
    assert smoke.n_periods == 0 and len(smoke.prefix) == 2
