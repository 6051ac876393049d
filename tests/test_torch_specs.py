"""The port's input specs (``launch.steps.token_specs`` / ``cache_specs`` /
``input_specs``: meta-device tensors) against the reference's
``ShapeDtypeStruct`` ones (``jax.eval_shape``), leaf for leaf by key
path: every family of the reference at its published config, in every
shape cell, the same shapes and dtypes, and no storage on the port's
side."""
import jax
import numpy as np
import pytest
import torch

from _torch_port import jax_flat
from repro.configs.base import SHAPE_CELLS as JAX_CELLS
from repro.configs.base import get_config as jax_config
from repro.launch import steps as jsteps
from repro_torch import tree
from repro_torch.configs.base import SHAPE_CELLS, get_config
from repro_torch.launch import steps as tsteps

FAMILIES = ["llama3.2-1b", "mixtral-8x22b", "yi-6b", "gemma2-2b",
            "gemma3-1b", "deepseek-v2-lite-16b", "zamba2-7b", "xlstm-125m",
            "whisper-small", "pixtral-12b"]


@pytest.mark.parametrize("cell", list(SHAPE_CELLS))
@pytest.mark.parametrize("arch", FAMILIES)
def test_input_specs_match_reference(arch, cell):
    want = jax_flat(jsteps.input_specs(jax_config(arch), JAX_CELLS[cell]))
    got = dict(tree.flatten_with_path(
        tsteps.input_specs(get_config(arch), SHAPE_CELLS[cell])))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert g.device.type == "meta", path
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).removeprefix("torch.") == np.dtype(w.dtype).name, \
            path
    if SHAPE_CELLS[cell].kind == "decode":
        caches = tsteps.cache_specs(get_config(arch), SHAPE_CELLS[cell])
        ref = jax.tree.leaves(jsteps.cache_specs(jax_config(arch),
                                                 JAX_CELLS[cell]))
        assert len(tree.leaves(caches)) == len(ref) > 0
    else:
        assert set(got) == {f"['batch']['{k}']" for k in
                            tsteps.token_specs(get_config(arch),
                                               SHAPE_CELLS[cell])}
    assert all(isinstance(t, torch.Tensor) for t in got.values())
