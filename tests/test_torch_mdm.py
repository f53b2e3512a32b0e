"""Port parity of the gesture MDM V2: the forward against MDM.apply
(train=False), the fast CFG function against models/mdm_fastpath.py:
make_fast_cfg_fn, and the weight carriers against
utils/convert_torch.py (export_mdm_state_dict, save_torch_checkpoint),
also at the model widths whose head widths the card path pads (80, 96).
Weights cross with gesturediffusion_tpu_torch/utils/convert.py.
Tolerance rtol 2e-4, atol 2e-5 (float32 reassociation, as
tests/test_fastpath.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.models.mdm_fastpath import make_fast_cfg_fn as jax_fast_cfg
from gesturediffusion_tpu.utils.convert_torch import (
    export_mdm_state_dict,
    save_torch_checkpoint,
)
from gesturediffusion_tpu_torch.models.mdm import MDM
from gesturediffusion_tpu_torch.models.mdm_fastpath import (
    make_fast_cfg_fn,
    make_fast_model_fn,
    select_sampling_model_fn,
)
from gesturediffusion_tpu_torch.utils.convert import load_checkpoint, state_dict_from_params
from tests.torch_port_common import (
    SMALL,
    build_pair,
    make_inputs,
    threefry_prng,  # noqa: F401 (autouse fixture)
    to_jax,
    to_torch,
)

RTOL, ATOL = 2e-4, 2e-5


@pytest.mark.parametrize("use_text", [False, True])
def test_forward_matches_jax(use_text):
    jax_model, params, port = build_pair(use_text=use_text)
    x, t, cond = make_inputs(3, 16, seed=1, use_text=use_text)
    cond["uncond"] = np.array([0.0, 1.0, 0.0], np.float32)
    want = np.asarray(jax_model.apply(params, jnp.asarray(x), jnp.asarray(t), to_jax(cond)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t), to_torch(cond)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("use_fused_encoder", [False, True])
def test_fast_cfg_matches_jax(use_fused_encoder):
    """JAX side with use_fused_encoder runs both Pallas kernels in
    interpret mode (T=16 takes the fused local block)."""
    jax_model, params, port = build_pair(use_fused_encoder=use_fused_encoder)
    x, t, cond = make_inputs(3, 16, seed=2)
    cond["scale"] = np.array([2.5, 1.0, 0.0], np.float32)
    pre_j, fn_j = jax_fast_cfg(jax_model, params, 0.1)
    want = np.asarray(fn_j(jnp.asarray(x), jnp.asarray(t), pre_j(to_jax(cond))))
    pre, fn = make_fast_cfg_fn(port, 0.1)
    with torch.no_grad():
        got = fn(torch.from_numpy(x), torch.from_numpy(t), pre(to_torch(cond))).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_fast_paths_match_the_module():
    _, _, port = build_pair(use_text=True)
    x, t, cond = make_inputs(3, 16, seed=3, use_text=True)
    x, t, cond = torch.from_numpy(x), torch.from_numpy(t), to_torch(cond)
    cond["scale"] = torch.tensor([2.5, 1.0, 0.5])
    with torch.no_grad():
        pre, fast_fn = make_fast_model_fn(port)
        torch.testing.assert_close(fast_fn(x, t, pre(cond)), port(x, t, cond),
                                   rtol=RTOL, atol=ATOL)
        pre, guided = select_sampling_model_fn(port, 2.5, 0.1)
        _, wrapped = select_sampling_model_fn(port, 2.5, 0.1, no_fast=True)
        torch.testing.assert_close(guided(x, t, pre(cond)), wrapped(x, t, cond),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("use_text", [False, True])
def test_convert_matches_export(use_text):
    """Key for key and array for array the reference torch layout that
    export_mdm_state_dict writes; the port's own state dict has the same
    keys and shapes."""
    jax_model, params, port = build_pair(use_text=use_text)
    want = export_mdm_state_dict(params, jax_model)
    got = state_dict_from_params(params, cl_head=jax_model.cl_head)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == {
        k: tuple(np.shape(v)) for k, v in want.items()
    }


def test_jax_written_pt_loads_into_port(tmp_path):
    jax_model, params, _ = build_pair()
    path = save_torch_checkpoint(str(tmp_path / "model000000100.pt"), params, jax_model)
    port = MDM(**SMALL)
    port.load_state_dict(load_checkpoint(path))
    port.eval()
    x, t, cond = make_inputs(2, 16, seed=4)
    want = np.asarray(jax_model.apply(params, jnp.asarray(x), jnp.asarray(t), to_jax(cond)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t), to_torch(cond)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("latent_dim,t", [(320, 1200), (384, 300), (544, 300), (1056, 120)])
def test_forward_matches_jax_at_the_c1_widths(latent_dim, t):
    """Widths whose heads the card path pads (4 heads of 80 and 96, local
    heads of 40 and 48) or runs in 128-column slices (4 heads of 136 and
    264, local heads of 68 and 132), at lengths past and within the local
    block's dense form:
    the port's forward (its CPU path, the kernels' plain versions) against
    the JAX MDM, 1 layer, batch 1, the same weights."""
    jax_model, params, port = build_pair(latent_dim=latent_dim, num_layers=1)
    x, ts, cond = make_inputs(1, t, seed=6)
    want = np.asarray(jax_model.apply(params, jnp.asarray(x), jnp.asarray(ts), to_jax(cond)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(ts), to_torch(cond)).numpy()
    assert got.shape == (1, SMALL["njoints"], 1, t)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_cfg_needs_conditioning_dropout():
    _, _, port = build_pair()
    with pytest.raises(ValueError, match="conditioning dropout"):
        make_fast_cfg_fn(port, 0.0)
