"""Port parity of the encoder layer (the CPU path of kernel 2's wrapper; the
CUDA kernel is held against it in test_torch_cuda.py and chip_smoke.py)
and the encoder stack against the JAX package:
models/transformer.py:TransformerEncoderLayer / TransformerEncoder
(deterministic) and ops/pallas_encoder.py:fused_encoder_layer in
interpret mode.  Tolerance atol 1e-4 (float32 over K <= 1024 sums and two
LayerNorms, as the JAX package's own kernel test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gesturediffusion_tpu.models.transformer import TransformerEncoder as JaxEncoder
from gesturediffusion_tpu.ops.pallas_encoder import fused_encoder_layer as jax_fused_layer
from gesturediffusion_tpu_torch.models.transformer import TransformerEncoder
from gesturediffusion_tpu_torch.ops.fused_encoder import (
    encoder_layer_plain,
    fused_encoder_layer,
    gelu_tanh,
)
from tests.torch_port_common import (
    jax_layer_args,
    jax_layer_params as _jax_layer_params,
    threefry_prng,  # noqa: F401 (autouse fixture)
    torch_layer_weights as _torch_weights,
)

ATOL = 1e-4


@pytest.mark.parametrize("b,t,d,h,f", [
    (5, 81, 256, 4, 1024),   # the gesture layer (odd T) at a small batch
    (3, 24, 128, 4, 256),
])
def test_cpu_path_matches_jax_layer(b, t, d, h, f):
    x = (np.random.RandomState(0).randn(b, t, d) * 0.5).astype(np.float32)
    layer, p = _jax_layer_params(d, h, f)
    want = np.asarray(layer.apply({"params": p}, jnp.asarray(x), deterministic=True))
    got = fused_encoder_layer(torch.from_numpy(x), *_torch_weights(p), num_heads=h)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_cpu_path_matches_pallas_interpret():
    b, t, d, h, f = 3, 20, 64, 4, 128
    x = np.random.RandomState(1).randn(b, t, d).astype(np.float32)
    _, p = _jax_layer_params(d, h, f, seed=1)
    want = np.asarray(jax_fused_layer(
        jnp.asarray(x), *jax_layer_args(p), num_heads=h, block_b=2, interpret=True,
    ))
    got = encoder_layer_plain(torch.from_numpy(x), *_torch_weights(p), num_heads=h)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_stack_matches_jax_encoder():
    b, t, d, h, f, n = 2, 17, 64, 4, 128, 2
    x = np.random.RandomState(2).randn(b, t, d).astype(np.float32)
    enc = JaxEncoder(num_layers=n, d_model=d, num_heads=h, dim_feedforward=f, dropout=0.0)
    params = enc.init(jax.random.PRNGKey(2), jnp.asarray(x))
    want = np.asarray(enc.apply(params, jnp.asarray(x), deterministic=True))
    port = TransformerEncoder(n, d, h, f)
    for i, layer in enumerate(port.layers):
        with torch.no_grad():
            for dst, src in zip(layer.weights(), _torch_weights(
                jax.tree_util.tree_map(np.asarray, params["params"][f"layer_{i}"])
            )):
                dst.copy_(src)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        plain = port(torch.from_numpy(x), use_kernels=False)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)


def test_gelu_is_the_tanh_form():
    """The JAX layers use the tanh GELU (transformer.py:106,
    pallas_encoder.py:156); torch's default F.gelu is the erf form."""
    x = np.linspace(-6, 6, 1201).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True))
    got = gelu_tanh(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    erf = F.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4


def test_unsupported_device_raises():
    x = torch.empty(2, 4, 8, device="meta")
    w = [torch.empty(s, device="meta") for s in
         [(24, 8), (24,), (8, 8), (8,), (8,), (8,), (16, 8), (16,), (8, 16), (8,), (8,), (8,)]]
    with pytest.raises(ValueError, match="unsupported device"):
        fused_encoder_layer(x, *w, num_heads=2)
