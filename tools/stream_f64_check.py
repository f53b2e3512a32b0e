#!/usr/bin/env python3
"""Is the port's streamed take apart from JAX's by float32 rounding only?

    JAX_PLATFORMS=cpu python3 tools/stream_f64_check.py

tests/test_torch_streaming.py:test_session_matches_jax_under_its_noise
streams a 3-chunk, 4-step respaced cosine DDPM take through the port's
session (the fast CFG path of the small gesture MDM of
tests/torch_port_common.py) under the JAX chain's own noise and holds it
against the JAX package's batch take (rtol 1e-4, atol 2e-5).  With the
weights drawn under JAX's rbg PRNG instead of threefry2x32 one element of
1152 missed that tolerance.  This script draws the weights both ways and
runs the comparison twice for each: in float32, as the test does, and in
float64 in both packages (JAX with ``jax_enable_x64`` on, the
port's model in ``.double()``; the port replays the JAX chain's normals,
which JAX draws in float64 there).  Both packages cast to float32 along the way (the diffusion
tables, the model output, the noise, the carried seed), so the float64 run
widens those casts for its duration: every ``float32`` the two packages
name reads as ``float64`` and ``Tensor.float()`` as ``.double()``.  For
each run it prints the largest |port - JAX|, the largest relative
difference, and how many elements break the test's tolerance.  A float64
difference near 1e-12 relative means the two packages compute one function
and the float32 miss is rounding; a float64 difference near the float32 one
would name a port fault.  On the CPU; no card needed.
"""

from __future__ import annotations

import contextlib
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


@contextlib.contextmanager
def widened():
    """float32 reads as float64 in both packages for the duration."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from gesturediffusion_tpu_torch.diffusion import gaussian as pg
    from gesturediffusion_tpu_torch.models import embeddings as pe

    saved = (jnp.float32, torch.float32, torch.Tensor.float, torch.get_default_dtype(),
             pg.np, pe.np, jax.config.jax_enable_x64)

    class WideNumpy:  # the port's tables (diffusion, rotary), computed in float64, stay so
        float32 = np.float64

        def __getattr__(self, name):
            return getattr(np, name)

    jax.config.update("jax_enable_x64", True)
    jnp.float32 = jnp.float64
    torch.float32 = torch.float64
    torch.Tensor.float = lambda self, *a, **k: self.double()
    torch.set_default_dtype(torch.float64)
    pg.np = pe.np = WideNumpy()
    try:
        yield
    finally:
        jnp.float32, torch.float32, torch.Tensor.float = saved[:3]
        torch.set_default_dtype(saved[3])
        pg.np, pe.np = saved[4:6]
        jax.config.update("jax_enable_x64", saved[6])


def weights(prng: str):
    """(JAX MDM, params as numpy, port MDM) with the weights that
    tests/torch_port_common.py:build_pair draws, under ``prng``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gesturediffusion_tpu.models.mdm import MDM as JaxMDM
    from gesturediffusion_tpu_torch.models.mdm import MDM
    from gesturediffusion_tpu_torch.utils.convert import state_dict_from_params
    from tests.torch_port_common import SMALL, make_inputs, to_jax

    kw = dict(SMALL, use_text=False, text_dim=64)
    before = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", prng)
    try:
        jax_model = JaxMDM(**kw, use_fused_encoder=False)
        x, t, cond = make_inputs(2, 16)
        params = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                                to_jax(cond))
    finally:
        jax.config.update("jax_default_prng_impl", before)
    params = jax.tree_util.tree_map(np.asarray, params)
    port = MDM(**kw)
    port.load_state_dict(state_dict_from_params(params, cl_head=kw["cl_head"]))
    return kw, params, port.eval()


def takes(kw, params, port, wide: bool):
    """(port streamed take, JAX batch take) of the test, as float64 numpy."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from gesturediffusion_tpu.diffusion.gaussian import create_diffusion as jax_create_diffusion
    from gesturediffusion_tpu.diffusion.sampling import autoregressive_sample_loop as jax_ar
    from gesturediffusion_tpu.models.mdm import MDM as JaxMDM
    from gesturediffusion_tpu.models.mdm_fastpath import make_fast_cfg_fn as jax_fast_cfg
    from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
    from gesturediffusion_tpu_torch.serve.streaming import StreamingGestureSession

    b, t, c, steps, sample_steps, guidance = 2, 16, 3, 20, 4, 2.5
    j, s, a = kw["njoints"], kw["seed_poses"], kw["mfcc_dim"]
    rs = np.random.RandomState(2)
    seed0 = rs.randn(b, j, 1, s).astype(np.float32)
    mfcc = rs.randn(c, b, a, 1, t).astype(np.float32)
    dt = np.float64 if wide else np.float32
    rng = jax.random.PRNGKey(7)

    def run():
        # JAX's chain draws its normals in its float dtype (float64 when
        # widened); the port replays the same draws
        draws = {}
        for k in range(c):
            for step in range(sample_steps + 1):
                key = jax.random.fold_in(jax.random.fold_in(rng, k), step)
                draws[k, step] = np.array(jax.random.normal(key, (b, j, 1, t), jnp.float32))
        jmodel = JaxMDM(**kw, use_fused_encoder=False, dtype=jnp.float64 if wide else jnp.float32)
        jp = jax.tree_util.tree_map(lambda v: jnp.asarray(v, dt), params)
        jd = jax_create_diffusion(steps=steps, timestep_respacing=str(sample_steps),
                                  dtype=jnp.float64 if wide else jnp.float32)
        pre_j, fn_j = jax_fast_cfg(jmodel, jp, 0.1)
        want = np.asarray(jax.jit(lambda r, cc, s0: jax_ar(
            jd, fn_j, (b, j, 1, t), r, cc, s0, s, cond_precompute=pre_j,
        ))(rng, {"mfcc": jnp.asarray(mfcc, dt), "scale": jnp.full((c, b), guidance, dt)},
           jnp.asarray(seed0, dt)), np.float64)

        model = port.double() if wide else port.float()
        pd = create_diffusion(steps=steps, timestep_respacing=str(sample_steps), device="cpu")
        session = StreamingGestureSession(
            model, guidance_param=guidance, streams=b, chunk_frames=t, seed_poses=s,
            diffusion=pd, device="cpu",
            noise_fn=lambda k, step, shape: torch.from_numpy(draws[k, step]))
        session.start(seed0.astype(dt))
        got = np.stack([session.feed({"mfcc": mfcc[k].astype(dt)}) for k in range(c)])
        return got.astype(np.float64), want, pd.betas.dtype

    if wide:
        with widened():
            got, want, table_dtype = run()
        port.float()
    else:
        got, want, table_dtype = run()
    assert table_dtype == (torch.float64 if wide else torch.float32), table_dtype
    return got, want


def main() -> int:
    import numpy as np

    print("prng     dtype    max|port-JAX|   max relative   over the test's tolerance")
    for prng in ("threefry2x32", "rbg"):
        kw, params, port = weights(prng)
        for wide in (False, True):
            got, want = takes(kw, params, port, wide)
            diff = np.abs(got - want)
            rel = diff / np.maximum(np.abs(want), 1e-300)
            over = int((diff > 2e-5 + 1e-4 * np.abs(want)).sum())
            print(f"{prng:<8} {'float64' if wide else 'float32'}  {diff.max():.3e}      "
                  f"{rel.max():.3e}      {over} of {diff.size}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
