"""Port parity of GaussianDiffusion.q_mean_variance and its table
``log_one_minus_alphas_cumprod`` against the JAX package on the CPU
(gesturediffusion_tpu/diffusion/gaussian.py:135-140, :500).

Tolerances: the table, the variance and the log variance exactly (lookups
of float32 tables that both packages build in float64 numpy and cast);
the mean rtol 1e-6 (one float32 product each).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.diffusion.gaussian import create_diffusion as jax_create_diffusion
from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion

# the shapes and timesteps of the JAX package's own q_mean_variance tests:
# tests/test_diffusion.py:78 ([4, 6, 1, 8] at t 25 of 50 steps) and
# tests/test_diffusion_golden.py:338 ([2, 25, 3, 8] at t 1 and the last)
CASES = [((4, 6, 1, 8), lambda n: [25] * 4), ((2, 25, 3, 8), lambda n: [1, n - 1])]


@pytest.mark.parametrize("schedule,steps,respacing", [
    ("cosine", 1000, None),
    ("linear", 1000, None),
    ("cosine", 1000, "ddim50"),
    ("linear", 1000, "ddim50"),
    ("cosine", 50, None),
])
def test_q_mean_variance_matches_jax(schedule, steps, respacing):
    want_d = jax_create_diffusion(noise_schedule=schedule, steps=steps,
                                  timestep_respacing=respacing)
    got_d = create_diffusion(noise_schedule=schedule, steps=steps,
                             timestep_respacing=respacing, device="cpu")
    np.testing.assert_array_equal(got_d.log_one_minus_alphas_cumprod.numpy(),
                                  np.asarray(want_d.log_one_minus_alphas_cumprod))
    assert got_d.log_one_minus_alphas_cumprod.dtype == torch.float32
    rs = np.random.RandomState(0)
    for shape, times in CASES:
        x0 = rs.randn(*shape).astype(np.float32)
        t = np.asarray(times(got_d.num_timesteps), np.int64)
        want = want_d.q_mean_variance(jnp.asarray(x0), jnp.asarray(t, jnp.int32))
        got = got_d.q_mean_variance(torch.from_numpy(x0), torch.from_numpy(t))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=0)
        for g, w in zip(got[1:], want[1:]):
            assert g.shape == w.shape == (shape[0],) + (1,) * (len(shape) - 1)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
