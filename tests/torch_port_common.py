"""Shared builders for the PyTorch-port parity tests (tests/test_torch_*.py).

A small gesture MDM is built and initialised in the JAX package; its
weights are carried into the port with utils/convert.py, and inputs are
made with numpy from a seed so both packages see the same numbers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gesturediffusion_tpu.models.mdm import MDM as JaxMDM
from gesturediffusion_tpu_torch.models.mdm import MDM
from gesturediffusion_tpu_torch.utils.convert import state_dict_from_params

# J=12, D=64, 2 encoder layers of 4 heads, 8 local heads, window 5
SMALL = dict(njoints=12, latent_dim=64, num_layers=2, ff_size=128, num_heads=4,
             seed_poses=4, cond_mask_prob=0.1, mfcc_dim=8, window_size=5, cl_head=8)


def make_inputs(b: int, t: int, seed: int = 0, use_text: bool = False):
    """Numpy x [B, J, 1, T], timesteps [B] and cond (mfcc, seed[, text_emb])."""
    rs = np.random.RandomState(seed)
    j, s, a = SMALL["njoints"], SMALL["seed_poses"], SMALL["mfcc_dim"]
    x = rs.randn(b, j, 1, t).astype(np.float32)
    cond = {
        "mfcc": rs.randn(b, a, 1, t).astype(np.float32),
        "seed": rs.randn(b, j, 1, s).astype(np.float32),
    }
    if use_text:
        cond["text_emb"] = rs.randn(b, 512).astype(np.float32)
    t_ids = rs.randint(0, 1000, size=(b,)).astype(np.int32)
    return x, t_ids, cond


def build_pair(use_text: bool = False, use_fused_encoder: bool = False, t: int = 16):
    """(JAX model, its params, the port model with the same weights)."""
    kw = dict(SMALL, use_text=use_text, text_dim=16 if use_text else 64)
    jax_model = JaxMDM(**kw, use_fused_encoder=use_fused_encoder)
    x, t_ids, cond = make_inputs(2, t, use_text=use_text)
    params = jax_model.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t_ids), to_jax(cond)
    )
    params = jax.tree_util.tree_map(np.asarray, params)
    port = MDM(**kw)
    port.load_state_dict(state_dict_from_params(params, cl_head=kw["cl_head"]))
    return jax_model, params, port.eval()


def to_jax(tree: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in tree.items()}


def to_torch(tree: dict, device="cpu") -> dict:
    return {k: torch.as_tensor(np.asarray(v), device=device) for k, v in tree.items()}
