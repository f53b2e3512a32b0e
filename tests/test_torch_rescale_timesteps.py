"""``rescale_timesteps`` of the port's diffusion (diffusion/gaussian.py)
against the JAX package on the CPU: ``model_t`` at every internal step of
a 100-step schedule respaced to ddim10, with and without the rescale
(float32 ``timestep_map[t] * 1000 / 100`` with it, the integer map without
it), and a whole DDIM chain respaced to 10 steps, the same x_T injected,
through a model stub that reads t, so a wrong map or scale moves the take.
Tolerances: model_t exact; the chain rtol 1e-5 / atol 1e-6 (float32 sampler
math in another library).  The model factory leaves the rescale off in
both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.diffusion.gaussian import create_diffusion as jax_create_diffusion
from gesturediffusion_tpu.diffusion.sampling import ddim_sample_loop as jax_ddim
from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
from gesturediffusion_tpu_torch.diffusion.sampling import ddim_sample_loop

KW = dict(steps=100, timestep_respacing="ddim10", noise_schedule="cosine")


@pytest.mark.parametrize("rescale", [False, True], ids=["ids", "rescaled"])
def test_model_t_equals_jax(rescale):
    jd = jax_create_diffusion(rescale_timesteps=rescale, **KW)
    pd = create_diffusion(rescale_timesteps=rescale, device="cpu", **KW)
    assert pd.rescale_timesteps == rescale and pd.num_timesteps == jd.num_timesteps == 10
    t = np.arange(10)
    want, got = np.asarray(jd.model_t(jnp.asarray(t))), pd.model_t(torch.from_numpy(t)).numpy()
    assert got.dtype == (np.float32 if rescale else np.int64)
    np.testing.assert_array_equal(got, want.astype(got.dtype))
    if rescale:
        np.testing.assert_array_equal(got, pd.timestep_map.numpy().astype(np.float32) * 10.0)


@pytest.mark.parametrize("rescale", [False, True], ids=["ids", "rescaled"])
def test_respaced_ddim_chain_equals_jax(rescale):
    rs = np.random.RandomState(0)
    x_t = rs.randn(2, 3, 1, 8).astype(np.float32)

    def stub(np_like):
        def model_fn(x, t, cond):
            scale = np_like.cos(t.reshape(-1, 1, 1, 1) / 40.0) * 0.9
            return x * scale + 0.01 * t.reshape(-1, 1, 1, 1) / 100.0
        return model_fn

    jd = jax_create_diffusion(rescale_timesteps=rescale, **KW)
    pd = create_diffusion(rescale_timesteps=rescale, device="cpu", **KW)
    want = jax_ddim(jd, stub(jnp), x_t.shape, jax.random.PRNGKey(0), {},
                    noise=jnp.asarray(x_t))
    got = ddim_sample_loop(pd, stub(torch), x_t.shape, {}, generator=torch.Generator(),
                           noise=torch.from_numpy(x_t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_the_factory_leaves_it_off():
    from gesturediffusion_tpu.utils import model_factory as jax_factory
    from gesturediffusion_tpu_torch.utils import model_factory
    from gesturediffusion_tpu_torch.utils.parser import train_args

    args = train_args(["--save_dir", "unused", "--diffusion_steps", "10"])
    assert model_factory.create_gaussian_diffusion(args, torch.device("cpu")).rescale_timesteps \
        is jax_factory.create_gaussian_diffusion(args).rescale_timesteps is False
