"""Shared builders for the PyTorch-port parity tests (tests/test_torch_*.py).

A small gesture MDM is built and initialised in the JAX package; its
weights are carried into the port with utils/convert.py, and inputs are
made with numpy from a seed so both packages see the same numbers.

``threefry()`` pins JAX's default PRNG implementation to threefry2x32 and
restores the setting it found: every JAX CLI switches the whole process to
``rbg`` (gesturediffusion_tpu/utils/fixseed.py:set_prng_impl), and a test
that runs one in-process leaves that on its pytest worker, where every
later key (the init keys of the models whose weights are carried across,
the noise keys of the sampling chains) would draw other numbers.  The
pair-building functions below draw their weights under it, so a
module-scoped fixture that builds a pair gets the same weights whatever
ran before it on the worker; the autouse fixture ``threefry_prng``, which a port module that
draws JAX keys imports, runs each test under it.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.models.mdm import MDM as JaxMDM
from gesturediffusion_tpu.models.mdm_t2m import MotionMDM as JaxMotionMDM
from gesturediffusion_tpu.models.transformer import TransformerEncoderLayer as JaxLayer
from gesturediffusion_tpu_torch.models.mdm import MDM
from gesturediffusion_tpu_torch.models.mdm_t2m import MotionMDM
from gesturediffusion_tpu_torch.utils.convert import (
    motion_mdm_state_dict_from_params,
    state_dict_from_params,
)

@contextlib.contextmanager
def threefry():
    """JAX's default PRNG is threefry2x32 inside, whatever an earlier test
    set; the setting found is restored on the way out."""
    before = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    try:
        yield
    finally:
        jax.config.update("jax_default_prng_impl", before)


@pytest.fixture(autouse=True)
def threefry_prng():
    """Run the test under threefry2x32 (``threefry()``)."""
    with threefry():
        yield


@contextlib.contextmanager
def torch_threads(n: int):
    """torch on ``n`` CPU threads inside, the setting found restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture
def one_torch_thread():
    """Run the test with torch on one CPU thread: the suite's workers share
    the cores, and a pool of every core's threads in each of them slows the
    evaluators' CPU GRUs (widths 512 and 1024) ~20x, and the wav encoder's
    convolutions as much."""
    with torch_threads(1):
        yield


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


def build_pair(use_text: bool = False, use_fused_encoder: bool = False, t: int = 16,
               **overrides):
    """(JAX model, its params, the port model with the same weights).
    ``overrides`` (e.g. dropout, cond_mask_prob, use_fused_train_encoder)
    go to both models."""
    kw = dict(SMALL, use_text=use_text, text_dim=16 if use_text else 64, **overrides)
    jax_model = JaxMDM(**kw, use_fused_encoder=use_fused_encoder)
    x, t_ids, cond = make_inputs(2, t, use_text=use_text)
    with threefry():
        params = jax_model.init(
            jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t_ids), to_jax(cond)
        )
    params = jax.tree_util.tree_map(np.asarray, params)
    port = MDM(**kw)
    port.load_state_dict(state_dict_from_params(params, cl_head=kw["cl_head"]))
    return jax_model, params, port.eval()


# the text-to-motion denoiser at small widths (the feature width is the
# codec's: 263 or 251)
SMALL_T2M = dict(latent_dim=64, num_layers=2, num_heads=4, ff_size=128, cond_mask_prob=0.1)


def make_t2m_inputs(b: int, njoints: int, cond_mode: str, t: int = 20, seed: int = 0):
    """Numpy x [B, J, 1, T], timesteps [B] and cond (text_emb or action)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(b, njoints, 1, t).astype(np.float32)
    t_ids = rs.randint(0, 1000, size=(b,)).astype(np.int32)
    cond = {}
    if cond_mode == "text":
        cond["text_emb"] = rs.randn(b, 512).astype(np.float32)
    elif cond_mode == "action":
        cond["action"] = rs.randint(0, 12, size=(b,)).astype(np.int32)
    return x, t_ids, cond


def build_t2m_pair(cond_mode: str = "text", njoints: int = 263,
                   use_fused_encoder: bool = False, **overrides):
    """(JAX MotionMDM, its params as numpy, the port model with the same
    weights).  The JAX action Dense gets a non-zero bias, which the
    converter folds into the embedding rows."""
    kw = dict(SMALL_T2M, njoints=njoints, cond_mode=cond_mode, **overrides)
    jax_model = JaxMotionMDM(**kw, use_fused_encoder=use_fused_encoder)
    x, t, cond = make_t2m_inputs(2, njoints, cond_mode)
    with threefry():
        params = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                                to_jax(cond))
    params = jax.tree_util.tree_map(np.array, params)
    if cond_mode == "action":
        bias = params["params"]["embed_action"]["bias"]
        bias[:] = np.random.RandomState(9).randn(*bias.shape) * 0.5
    port = MotionMDM(**kw)
    port.load_state_dict(motion_mdm_state_dict_from_params(params))
    return jax_model, params, port.eval()


def load_motion_mdm_params(model: MotionMDM, params: dict) -> MotionMDM:
    """Load JAX MotionMDM params into ``model`` (a port MotionMDM of the
    same configuration) with the action Dense's kernel and bias kept apart,
    as both packages train them, not folded.  Returns the model."""
    model.load_state_dict(motion_mdm_state_dict_from_params(params))
    P = params.get("params", params)
    if "embed_action" in P:
        model.embed_action.load_unfolded_state(
            {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in P["embed_action"].items()})
    return model


def to_jax(tree: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in tree.items()}


def to_torch(tree: dict, device="cpu") -> dict:
    return {k: torch.as_tensor(np.asarray(v), device=device) for k, v in tree.items()}


def jax_layer_params(d: int, h: int, f: int, seed: int = 0):
    """(flax TransformerEncoderLayer, its params as numpy)."""
    layer = JaxLayer(d_model=d, num_heads=h, dim_feedforward=f, dropout=0.0)
    with threefry():
        params = layer.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, d)))["params"]
    return layer, jax.tree_util.tree_map(np.asarray, params)


def torch_layer_weights(p: dict, device="cpu") -> tuple:
    """JAX layer params -> the port's 12 encoder-layer tensors ([out, in])."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    return (
        t(p["self_attn"]["in_proj"]["kernel"].T), t(p["self_attn"]["in_proj"]["bias"]),
        t(p["self_attn"]["out_proj"]["kernel"].T), t(p["self_attn"]["out_proj"]["bias"]),
        t(p["norm1"]["scale"]), t(p["norm1"]["bias"]),
        t(p["linear1"]["kernel"].T), t(p["linear1"]["bias"]),
        t(p["linear2"]["kernel"].T), t(p["linear2"]["bias"]),
        t(p["norm2"]["scale"]), t(p["norm2"]["bias"]),
    )


def jax_layer_args(p: dict) -> tuple:
    """JAX layer params -> ops/pallas_encoder.py:fused_encoder_layer's 12
    weight arguments ([in, out])."""
    s, n1, l1, l2, n2 = (p[k] for k in ("self_attn", "norm1", "linear1", "linear2", "norm2"))
    return (s["in_proj"]["kernel"], s["in_proj"]["bias"], s["out_proj"]["kernel"],
            s["out_proj"]["bias"], n1["scale"], n1["bias"], l1["kernel"], l1["bias"],
            l2["kernel"], l2["bias"], n2["scale"], n2["bias"])


def narrow_block_shape(dh: int, t: int) -> dict | None:
    """The blocks of csrc/flash_attention.cuh's inference flash forward
    (flash_fwd_narrow_kernel) at head width dh and length t, as NarrowTile
    and flash_narrow_launch choose them (dh 1 .. 128; None past it): the
    padded width ``dhp`` (the next multiple of 16), ``nc`` consumer
    warpgroups of 64 query rows each beside one producer warpgroup
    (``threads``), key tiles of ``bk`` keys (64 up to DHP 64 where t > 128,
    else 32), raw rows in
    ``nb`` tensor-copy boxes of 32 columns, and ``smem`` bytes of shared
    memory a block (NarrowTile::smem: the raw ring of two stages, the split
    ring of two, q's small part for each consumer, 64 bytes of mbarriers
    and 1024 of alignment slack).  ``blocks(B, H, T)`` is the grid.  The
    tests emulate the kernel's schedule from it."""
    if not 0 < dh <= 128:
        return None
    dhp = -(-dh // 16) * 16
    nc, bk = (2 if dhp <= 96 else 1), (64 if dhp <= 64 and t > 128 else 32)
    nb = -(-dhp // 32)
    floats = 2 * (2 * nb * bk * 32) + 2 * (4 * bk * dhp) + nc * 64 * dhp
    rows = 64 * nc
    return dict(dhp=dhp, nc=nc, bk=bk, nb=nb, threads=128 * (nc + 1),
                smem=4 * floats + 64 + 1024,
                blocks=lambda b, h, t: b * h * -(-t // rows))


# csrc/wide_attention.cuh's wide forward past a head width of 128: the
# widest head flash_fwd_wide_kernel and band_wide_kernel take (wider ones
# run in 128-column slices, flash_sliced_kernel and band_sliced_kernel)
WIDE_MAX_WIDTH = 544


def wide_block_shape(dh: int, raws: int = 2) -> dict | None:
    """The blocks of csrc/wide_attention.cuh's wide forward
    (flash_fwd_wide_kernel, band_wide_kernel, local_block_wide_kernel) at
    head width dh, as flash_wide_launch and band_wide_launch choose them
    (129 .. WIDE_MAX_WIDTH; None outside): a cluster of ``cl`` blocks of 64
    query rows and two warpgroups; block r takes the scores and the output
    over its share [r w, (r + 1) w) of the width, each warpgroup half of it
    (``wo`` accumulator columns: 8 KS); key tiles of ``bk`` keys (kWgKeys);
    ``smem`` bytes of shared memory a block (wide_fwd_floats) with ``raws``
    raw tiles (1 where k and v are one operand).  The tests emulate the
    kernel's schedule from it.  The band and the local block take the same
    blocks with key tiles of ``band_bk`` keys (kBandKeys), q's rows (or
    the band's, where q = k = v) in an area of kResRows = 96 rows beside
    them, ``band_smem`` bytes a block (two blocks an SM to 144 columns)."""
    if not 128 < dh <= WIDE_MAX_WIDTH:
        return None
    ks, cl = (9, 1) if dh <= 144 else (16, 1) if dh <= 256 else (17, 1) if dh <= 272 else (17, 2)
    bk, w = 32, -(-dh // (16 * cl)) * 16

    def floats(keys, rows):
        return rows * (w + 4) + 2 * w * keys + 32 * ks * keys + 128 * keys

    return dict(cl=cl, w=w, bk=bk, wo=8 * ks, smem=4 * floats(bk, raws * bk), band_bk=16,
                band_smem=4 * floats(16, 96))


def wide_bwd_block_shape(dh: int) -> dict | None:
    """The blocks of csrc/encoder_layer_train.cu's wide attention backward
    (attn_bwd_dq_wide_kernel, attn_bwd_dkdv_wide_kernel) at head width dh,
    as attention_backward_wide chooses them (129 .. WIDE_MAX_WIDTH; None
    outside: the narrow passes to 128, the sliced ones past): a cluster of
    ``cl`` blocks of 64 resident rows and two warpgroups; block r takes the
    scores and the outputs over its share [r w, (r + 1) w) of the width,
    each warpgroup half of it (``wo`` accumulator columns: 8 KS); tiles of
    ``bk`` streamed rows (kWbKeys); ``smem`` bytes of shared memory a block
    (wide_bwd_floats).  The tests emulate the passes' schedule from it."""
    if not 128 < dh <= WIDE_MAX_WIDTH:
        return None
    ks, cl = (9, 1) if dh <= 144 else (16, 1) if dh <= 256 else (17, 1) if dh <= 272 else (17, 2)
    bk, w = 8, -(-dh // (16 * cl)) * 16
    floats = 2 * (64 + bk) * (w + 8) + 4 * 16 * ks * bk + 2 * 8 * 32 * 4
    return dict(cl=cl, w=w, bk=bk, wo=8 * ks, smem=4 * floats)
