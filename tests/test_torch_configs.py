"""The port's configs agree with the JAX package's, field for field.

Every architecture of ``repro.configs.list_archs()`` is compared through
``get_config`` and ``smoke_config``; the dtype fields map jnp dtypes to
the torch dtypes of the same name.
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

import repro.configs as jcfg
import repro_torch.configs as tcfg

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32}


def _same(jc, tc):
    jf = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    tf = {f.name: getattr(tc, f.name) for f in dataclasses.fields(tc)}
    assert jf.keys() == tf.keys()
    for name, jv in jf.items():
        if name in ("param_dtype", "activation_dtype"):
            assert DTYPES[jnp.dtype(jv)] == tf[name], name
        else:
            assert jv == tf[name], name
    for prop in ("resolved_head_dim", "attention_type",
                 "supports_long_context_decode"):
        assert getattr(jc, prop) == getattr(tc, prop), prop


def test_same_registry():
    assert tcfg.list_archs() == jcfg.list_archs()
    assert tcfg.SHAPES.keys() == jcfg.SHAPES.keys()
    for name, shape in jcfg.SHAPES.items():
        assert dataclasses.asdict(tcfg.SHAPES[name]) == \
            dataclasses.asdict(shape)


@pytest.mark.parametrize("arch", jcfg.list_archs())
def test_full_config_matches(arch):
    _same(jcfg.get_config(arch), tcfg.get_config(arch))


@pytest.mark.parametrize("arch", jcfg.list_archs())
def test_smoke_config_matches(arch):
    jc, tc = jcfg.smoke_config(arch), tcfg.smoke_config(arch)
    _same(jc, tc)
    for layer in range(tc.num_layers):
        assert jc.layer_kind(layer) == tc.layer_kind(layer)


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        tcfg.get_config("no-such-arch")
