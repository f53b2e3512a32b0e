#!/usr/bin/env python3
"""How far the port's long-chunk take lies from the JAX take, by PRNG key.

    JAX_PLATFORMS=cpu python3 tools/take_prng_spread.py

tests/test_torch_long_chunk.py:test_ar_take_matches_jax runs a 2-chunk,
4-step respaced cosine DDPM take at T = 320 through the fast CFG path of
the small gesture MDM (tests/torch_port_common.py), in the JAX package and
in the port under the JAX chain's own noise, with PRNGKey(7).  This script
repeats that take for keys 0-7 under each of JAX's PRNG implementations
(threefry2x32, the default, and rbg, which the JAX train CLI switches a
process to), and runs the port twice, both in float32: through the fast
CFG path (composed weights, one stacked forward), as the test does, and
through the model's own forward under the generic CFG wrapper
(models/cfg.py), the same function up to float32 reassociation.  (A
float64 run is not open to the port as it stands: the model casts its
output to float32.)  For each key it prints the largest |fast - JAX|,
|generic - JAX| and |fast - generic|, and how many elements of the fast
take break the test's tolerance (rtol 1e-4, atol 2e-5).  Where |fast -
generic|, two float32 evaluations of one port function, is as large as
|fast - JAX|, what separates the port from JAX is float32 rounding of the
chain.  On the CPU; no card needed.
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    import jax
    import numpy as np
    import torch

    from gesturediffusion_tpu.diffusion.gaussian import create_diffusion as jax_create_diffusion
    from gesturediffusion_tpu.diffusion.sampling import autoregressive_sample_loop as jax_ar_loop
    from gesturediffusion_tpu.models.mdm_fastpath import make_fast_cfg_fn as jax_fast_cfg
    from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
    from gesturediffusion_tpu_torch.diffusion.sampling import autoregressive_sample_loop
    from gesturediffusion_tpu_torch.models.mdm_fastpath import select_sampling_model_fn
    from tests.torch_port_common import SMALL, build_pair

    t, b, c = 320, 2, 2
    j, s, a = SMALL["njoints"], SMALL["seed_poses"], SMALL["mfcc_dim"]
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    jax_model, params, port = build_pair(t=t)  # the weights drawn under threefry
    rs = np.random.RandomState(5)
    mfcc = rs.randn(c, b, a, 1, t).astype(np.float32)
    scale = np.full((c, b), 2.5, np.float32)
    seed0 = rs.randn(b, j, 1, s).astype(np.float32)
    shape = (b, j, 1, t)
    jd = jax_create_diffusion(steps=20, timestep_respacing="4")
    pre_j, fn_j = jax_fast_cfg(jax_model, params, 0.1)
    cond_j = {"mfcc": jax.numpy.asarray(mfcc), "scale": jax.numpy.asarray(scale)}
    take_j = jax.jit(lambda r, cc, s0: jax_ar_loop(jd, fn_j, shape, r, cc, s0, s,
                                                  cond_precompute=pre_j))
    pd = create_diffusion(steps=20, timestep_respacing="4", device="cpu")
    model_fns = {"fast": select_sampling_model_fn(port, 2.5, 0.1),
                 "generic": select_sampling_model_fn(port, 2.5, 0.1, no_fast=True)}

    def port_take(rng, path):
        def noise_fn(chunk, step, shp):
            key = jax.random.fold_in(jax.random.fold_in(rng, chunk), step)
            return torch.from_numpy(np.array(jax.random.normal(key, shp)))

        pre, fn = model_fns[path]
        with torch.no_grad():
            return autoregressive_sample_loop(
                pd, fn, shape, {"mfcc": torch.from_numpy(mfcc), "scale": torch.from_numpy(scale)},
                torch.from_numpy(seed0), s, generator=torch.Generator(), noise_fn=noise_fn,
                cond_precompute=pre).double().numpy()

    for impl in ("threefry2x32", "rbg"):
        jax.config.update("jax_default_prng_impl", impl)
        for key in range(8):
            rng = jax.random.PRNGKey(key)
            want = np.asarray(take_j(rng, cond_j, jax.numpy.asarray(seed0)), np.float64)
            fast, generic = port_take(rng, "fast"), port_take(rng, "generic")
            over = np.abs(fast - want) > 2e-5 + 1e-4 * np.abs(want)
            print(f"{impl} key {key}: |fast - JAX| {np.abs(fast - want).max():.3e}, "
                  f"|generic - JAX| {np.abs(generic - want).max():.3e}, "
                  f"|fast - generic| {np.abs(fast - generic).max():.3e}; "
                  f"{int(over.sum())} of {over.size} past rtol 1e-4 / atol 2e-5", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
