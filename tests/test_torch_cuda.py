"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here carries the ``cuda`` marker and skips without a card (the
decision is made in a fixture, so every pytest worker collects the same
tests).  The file imports no JAX, so on a machine with a card and no JAX
it runs on its own, without tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances (float32, TF32 off): local block rtol 2e-4 / atol 2e-5 (sums of
at most 2w terms); encoder layer atol 1e-4 (sums over K <= 1024 in another
order, two LayerNorms); MDM fast CFG step atol 1e-4.
"""

import numpy as np
import pytest
import torch

from gesturediffusion_tpu_torch.models.mdm import MDM
from gesturediffusion_tpu_torch.models.mdm_fastpath import make_fast_cfg_fn
from gesturediffusion_tpu_torch.ops.fused_encoder import (
    encoder_layer_plain,
    fused_encoder_layer,
)
from gesturediffusion_tpu_torch.ops.fused_local_block import (
    fused_local_block,
    pre_encoder_local_block,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rs, *shape, scale=1.0, device="cpu"):
    return torch.from_numpy(rs.randn(*shape).astype(np.float32) * scale).to(device)


def _encoder_weights(d, f, device, seed=0):
    rs = np.random.RandomState(seed)
    return (
        _randn(rs, 3 * d, d, scale=d**-0.5, device=device), _randn(rs, 3 * d, scale=0.02, device=device),
        _randn(rs, d, d, scale=d**-0.5, device=device), _randn(rs, d, scale=0.02, device=device),
        1.0 + _randn(rs, d, scale=0.1, device=device), _randn(rs, d, scale=0.1, device=device),
        _randn(rs, f, d, scale=d**-0.5, device=device), _randn(rs, f, scale=0.02, device=device),
        _randn(rs, d, f, scale=f**-0.5, device=device), _randn(rs, d, scale=0.02, device=device),
        1.0 + _randn(rs, d, scale=0.1, device=device), _randn(rs, d, scale=0.1, device=device),
    )


@pytest.mark.parametrize("b,t,d,h,w", [(82, 80, 256, 8, 10), (3, 16, 64, 8, 5), (5, 24, 32, 4, 10)])
def test_local_block_kernel_matches_plain(dev, b, t, d, h, w):
    rs = np.random.RandomState(3)
    x, coa = _randn(rs, b, t, d, device=dev), _randn(rs, b, d, device=dev)
    want = pre_encoder_local_block(x, coa, num_heads=h, window_size=w)
    before = fused_local_block.launches
    got = fused_local_block(x, coa, num_heads=h, window=w)
    torch.cuda.synchronize()
    assert fused_local_block.launches == before + 1
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


def test_local_block_kernel_rejects_float64(dev):
    x = torch.zeros(2, 16, 64, dtype=torch.float64, device=dev)
    with pytest.raises(TypeError, match="float32"):
        fused_local_block(x, x[:, 0], num_heads=8, window=5)


@pytest.mark.parametrize("b,t,d,h,f", [(82, 81, 256, 4, 1024), (3, 24, 128, 4, 256), (2, 7, 64, 2, 96)])
def test_encoder_kernel_matches_plain(dev, b, t, d, h, f):
    w = _encoder_weights(d, f, dev)
    x = _randn(np.random.RandomState(4), b, t, d, device=dev)
    want = encoder_layer_plain(x, *w, num_heads=h)
    before = fused_encoder_layer.launches
    got = fused_encoder_layer(x, *w, num_heads=h)
    torch.cuda.synchronize()
    assert fused_encoder_layer.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_encoder_kernel_rejects_wrong_shapes(dev):
    w = list(_encoder_weights(64, 128, dev))
    w[2] = w[2][:, :32]
    with pytest.raises(ValueError, match="wo"):
        fused_encoder_layer(torch.zeros(2, 8, 64, device=dev), *w, num_heads=4)


def test_fast_cfg_step_kernels_match_plain(dev):
    """One guided denoise step of a small MDM through both kernels, against
    the same step with use_kernels=False, and the launch counts."""
    torch.manual_seed(0)
    model = MDM(njoints=12, latent_dim=64, num_layers=2, ff_size=128, seed_poses=4,
                cond_mask_prob=0.1, mfcc_dim=8, window_size=5).to(dev).eval()
    rs = np.random.RandomState(5)
    x = _randn(rs, 3, 12, 1, 20, device=dev)
    cond = {"mfcc": _randn(rs, 3, 8, 1, 20, device=dev),
            "seed": _randn(rs, 3, 12, 1, 4, device=dev),
            "scale": torch.full((3,), 2.5, device=dev)}
    t = torch.tensor([0, 5, 9], device=dev)
    with torch.no_grad():
        pre, guided = make_fast_cfg_fn(model, 0.1)
        lb, enc = fused_local_block.launches, fused_encoder_layer.launches
        got = guided(x, t, pre(cond))
        assert (fused_local_block.launches - lb, fused_encoder_layer.launches - enc) == (1, 2)
        model.use_kernels = False
        want = guided(x, t, pre(cond))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
