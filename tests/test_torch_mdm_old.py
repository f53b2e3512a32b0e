"""Port parity of the MDM V1 gesture denoiser (models/mdm_old.py:MDMOld)
against the JAX package's MDMOld on the CPU: the forward (the CFG mask
included), the reference V1 state dict (utils/convert.py:
mdm_old_state_dict_from_params is the inverse of
convert_torch.py:convert_mdm_old_state_dict, and a V1 ``.pt`` loads onto
both packages' MDMOld), the V2 loaders' and the generate CLIs' refusal of
a V1 file, the sampling selector, and a 2-chunk chunked-AR CFG take under
the JAX chain's noise.  Tolerances: forward rtol 2e-4, atol 2e-5; the take
rtol 1e-4, atol 2e-5 (as tests/test_torch_sampling.py)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.diffusion import gaussian as jg
from gesturediffusion_tpu.diffusion.sampling import autoregressive_sample_loop as jax_ar_loop
from gesturediffusion_tpu.models.mdm import MDM as JaxMDM
from gesturediffusion_tpu.models.mdm_fastpath import (
    select_sampling_model_fn as jax_select_sampling_model_fn,
)
from gesturediffusion_tpu.models.mdm_old import MDMOld as JaxMDMOld
from gesturediffusion_tpu.sample import generate as jax_generate
from gesturediffusion_tpu.utils.convert_torch import (
    convert_mdm_old_state_dict,
    load_torch_checkpoint,
)
from gesturediffusion_tpu_torch.diffusion import gaussian as pg
from gesturediffusion_tpu_torch.diffusion.sampling import autoregressive_sample_loop
from gesturediffusion_tpu_torch.models.mdm import MDM
from gesturediffusion_tpu_torch.models.mdm_fastpath import select_sampling_model_fn
from gesturediffusion_tpu_torch.models.mdm_old import MDMOld
from gesturediffusion_tpu_torch.sample import generate
from gesturediffusion_tpu_torch.utils.convert import load_weights, mdm_old_state_dict_from_params
from tests.torch_port_common import threefry, to_jax, to_torch, torch_threads
from tests.torch_port_common import threefry_prng  # noqa: F401 (autouse fixture)

RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread_for_the_module():
    """torch on one CPU thread for the module's fixtures and tests
    (torch_port_common.one_torch_thread: the suite's workers share the
    cores)."""
    with torch_threads(1):
        yield


# J 12, MFCC 8, D 32, 2 layers of 4 heads, 4 seed poses
OLD = dict(njoints=12, latent_dim=32, ff_size=64, num_layers=2, num_heads=4,
           cond_mask_prob=0.1, seed_poses=4, mfcc_dim=8)


def _inputs(b, t, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, 12, 1, t).astype(np.float32)
    cond = {"mfcc": rs.randn(b, 8, 1, t).astype(np.float32),
            "seed": rs.randn(b, 12, 1, 4).astype(np.float32)}
    return x, rs.randint(0, 1000, size=(b,)).astype(np.int32), cond


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX MDMOld, its params, the port MDMOld with the same weights in
    evaluation mode, a reference-layout V1 ``.pt`` of them)."""
    jax_model = JaxMDMOld(**OLD)
    x, t, cond = _inputs(2, 16)
    with threefry():
        params = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                                to_jax(cond))
    params = jax.tree_util.tree_map(np.asarray, params)
    sd = mdm_old_state_dict_from_params(params)
    port = MDMOld(**OLD)
    port.load_state_dict(sd)
    path = str(tmp_path_factory.mktemp("v1") / "model000000001.pt")
    torch.save(sd, path)
    return jax_model, params, port.eval(), path


def test_forward_matches_jax(pair):
    jax_model, params, port, _ = pair
    x, t, cond = _inputs(3, 20, seed=1)
    cond["uncond"] = np.array([0.0, 1.0, 0.0], np.float32)
    want = np.asarray(jax_model.apply(params, jnp.asarray(x), jnp.asarray(t), to_jax(cond)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t), to_torch(cond)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_v1_state_dict_is_the_layout_jax_reads(pair):
    """JAX's converter takes every key of the port's V1 state dict (it
    raises on one it does not consume) back to the same params."""
    jax_model, params, _, _ = pair
    back = convert_mdm_old_state_dict(mdm_old_state_dict_from_params(params), jax_model)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_v1_checkpoint_loads_onto_both_packages_mdm_old(pair):
    jax_model, _, _, path = pair
    variables = load_torch_checkpoint(path, jax_model)
    port = load_weights(MDMOld(**OLD), path).eval()
    x, t, cond = _inputs(2, 16, seed=2)
    want = np.asarray(jax_model.apply(variables, jnp.asarray(x), jnp.asarray(t), to_jax(cond)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t), to_torch(cond)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_v2_loaders_refuse_a_v1_checkpoint_as_jax_does(pair):
    _, _, _, path = pair
    v2 = dict(njoints=12, latent_dim=32, ff_size=64, num_layers=2, seed_poses=4, mfcc_dim=8)
    with pytest.raises(ValueError, match="MDM V1") as want:
        load_torch_checkpoint(path, JaxMDM(**v2))
    with pytest.raises(ValueError, match="MDM V1") as got:
        load_weights(MDM(**v2), path)
    assert "the CLIs build the V2 model only" in str(want.value) and \
        "the CLIs build the V2 model only" in str(got.value)


def test_generate_clis_refuse_a_v1_checkpoint(pair, tmp_path):
    """Both generate CLIs build the V2 model from args.json and refuse the
    V1 file at the load, before sampling."""
    _, _, _, path = pair
    run = tmp_path / "run"
    run.mkdir()
    ckpt = run / "model000000001.pt"
    ckpt.write_bytes(open(path, "rb").read())
    with open(run / "args.json", "w") as f:
        json.dump({"dataset": "synthetic", "layers": 2, "latent_dim": 32, "seed_poses": 4,
                   "num_frames": 16}, f)
    argv = ["--model_path", str(ckpt), "--num_samples", "2", "--output_dir",
            str(tmp_path / "out")]
    with pytest.raises(ValueError, match="MDM V1"):
        jax_generate.main(argv)
    with pytest.raises(ValueError, match="MDM V1"):
        generate.main(argv + ["--device", "cpu"])


def test_ar_take_through_the_selector_matches_jax(pair):
    """Both selectors take MDMOld's own forward, CFG-wrapped; two chunks
    of a 4-step respaced DDPM under the JAX chain's noise."""
    jax_model, params, port, _ = pair
    b, t, c = 2, 16, 2
    rs = np.random.RandomState(6)
    mfcc = rs.randn(c, b, 8, 1, t).astype(np.float32)
    scale = np.full((c, b), 2.5, np.float32)
    seed0 = rs.randn(b, 12, 1, 4).astype(np.float32)
    shape = (b, 12, 1, t)
    pre_j, fn_j = jax_select_sampling_model_fn(jax_model, params, 2.5, 0.1)
    pre, fn = select_sampling_model_fn(port, 2.5, 0.1)
    assert pre_j is None and pre is None
    jd = jg.create_diffusion(steps=20, timestep_respacing="4")
    rng = jax.random.PRNGKey(7)
    want = np.asarray(jax.jit(lambda r, cc, s0: jax_ar_loop(jd, fn_j, shape, r, cc, s0, 4))(
        rng, {"mfcc": jnp.asarray(mfcc), "scale": jnp.asarray(scale)}, jnp.asarray(seed0)))

    def noise_fn(chunk, step, shp):
        key = jax.random.fold_in(jax.random.fold_in(rng, chunk), step)
        return torch.from_numpy(np.array(jax.random.normal(key, shp)))

    with torch.no_grad():
        got = autoregressive_sample_loop(
            pg.create_diffusion(steps=20, timestep_respacing="4", device="cpu"), fn, shape,
            {"mfcc": torch.from_numpy(mfcc), "scale": torch.from_numpy(scale)},
            torch.from_numpy(seed0), 4, generator=torch.Generator(), noise_fn=noise_fn)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-5)
