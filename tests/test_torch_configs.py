"""The port's ``repro_torch.configs`` against the JAX package's
``repro.configs``, exactly: the same ten archs, the same fields in every
full and smoke config, the same analytic parameter counts, the same shape
grid and runnable cells, and ``input_specs`` of the same shapes and dtypes
(tensors on the "meta" device where the reference has ShapeDtypeStructs).
"""
import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro import configs as jc
from repro_torch import configs as tc

DTYPES = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16}


def test_arch_names_and_grid():
    assert tc.ARCH_NAMES == jc.ARCH_NAMES
    assert tc.SHAPES == jc.SHAPES


@pytest.mark.parametrize("arch", jc.ARCH_NAMES)
@pytest.mark.parametrize("which", ["get", "get_smoke"])
def test_config_fields(arch, which):
    want = dataclasses.asdict(getattr(jc, which)(arch))
    got = dataclasses.asdict(getattr(tc, which)(arch))
    assert got == want


@pytest.mark.parametrize("arch", jc.ARCH_NAMES)
def test_param_counts(arch):
    want, got = jc.get(arch), tc.get(arch)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert (got.hd, got.n_groups, got.n_tail, got.vocab_padded) == \
        (want.hd, want.n_groups, want.n_tail, want.vocab_padded)


@pytest.mark.parametrize("arch", jc.ARCH_NAMES)
@pytest.mark.parametrize("shape", list(jc.SHAPES))
def test_input_specs_and_cells(arch, shape):
    want = jc.input_specs(jc.get(arch), shape)
    got = tc.input_specs(tc.get(arch), shape)
    assert list(got) == list(want)
    for k, spec in want.items():
        assert tuple(got[k].shape) == tuple(spec.shape), k
        assert got[k].dtype == DTYPES[jnp.dtype(spec.dtype)], k
        assert got[k].device.type == "meta", k
    assert tc.cell_runnable(tc.get(arch), shape) == \
        jc.cell_runnable(jc.get(arch), shape)
