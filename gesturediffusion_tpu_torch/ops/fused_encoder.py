"""One post-LN transformer encoder layer: CUDA kernel and plain version.

``fused_encoder_layer`` is the counterpart of
gesturediffusion_tpu/ops/pallas_encoder.py:fused_encoder_layer, and
``encoder_layer_plain`` of the deterministic
gesturediffusion_tpu/models/transformer.py:TransformerEncoderLayer (the
kernel's specification; torch ``nn.TransformerEncoderLayer`` post-LN
order with GELU in its tanh form):

    a = selfattn(x); x = LN1(x + a); x = LN2(x + linear2(gelu(linear1(x))))

Weights use PyTorch's [out, in] layout: wqkv [3D, D] (the packed
``in_proj_weight``), wo [D, D], w1 [F, D], w2 [D, F]; LayerNorm weight
and bias [D].  On a CUDA tensor the wrapper launches
csrc/encoder_layer.cu; on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from gesturediffusion_tpu_torch.ops import _build

LN_EPS = 1e-5


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU in the tanh form, as jax.nn.gelu and flax nn.gelu compute it
    (torch's default F.gelu is the erf form)."""
    return F.gelu(x, approximate="tanh")


def self_attention_plain(
    x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor,
    wo: torch.Tensor, bo: torch.Tensor, num_heads: int,
) -> torch.Tensor:
    """Packed-QKV multi-head self-attention, f32 scores and softmax."""
    b, t, d = x.shape
    dh = d // num_heads
    q, k, v = F.linear(x, wqkv, bqkv).chunk(3, dim=-1)
    q, k, v = (y.reshape(b, t, num_heads, dh).transpose(1, 2) for y in (q, k, v))
    sim = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * (dh**-0.5)
    attn = sim.softmax(dim=-1).to(x.dtype)
    out = torch.einsum("bhij,bhjd->bhid", attn, v)
    return F.linear(out.transpose(1, 2).reshape(b, t, d), wo, bo)


def encoder_layer_plain(
    x, wqkv, bqkv, wo, bo, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b,
    *, num_heads: int,
) -> torch.Tensor:
    """Plain PyTorch version of the layer (inference: no dropout)."""
    d = x.shape[-1]
    x = F.layer_norm(
        x + self_attention_plain(x, wqkv, bqkv, wo, bo, num_heads),
        (d,), ln1_w, ln1_b, LN_EPS,
    )
    h = F.linear(gelu_tanh(F.linear(x, w1, b1)), w2, b2)
    return F.layer_norm(x + h, (d,), ln2_w, ln2_b, LN_EPS)


@functools.cache
def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.load_function(
        "encoder_layer", "gdt_encoder_layer_f32",
        [p] * 19 + [i] * 5 + [ctypes.c_float, p],
    )


def _check_cuda_args(x, weights, num_heads):
    if x.dim() != 3:
        raise ValueError(f"expected x [B, T, D], got {tuple(x.shape)}")
    d, f = x.shape[2], weights[6].shape[0]
    shapes = [(3 * d, d), (3 * d,), (d, d), (d,), (d,), (d,),
              (f, d), (f,), (d, f), (d,), (d,), (d,)]
    for name, w, shape in zip(
        ("wqkv", "bqkv", "wo", "bo", "ln1_w", "ln1_b",
         "w1", "b1", "w2", "b2", "ln2_w", "ln2_b"), weights, shapes,
    ):
        if tuple(w.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(w.shape)}")
    if d % num_heads or (d // num_heads) % 4 or f % 4:
        raise ValueError(
            f"D={d} must split into {num_heads} heads of a width divisible by 4; "
            f"F={f} must be divisible by 4"
        )
    for w in (x, *weights):
        if w.dtype != torch.float32:
            raise TypeError("the encoder-layer kernel takes float32 tensors")
        if w.device != x.device:
            raise ValueError("all tensors must be on the same device")
        if not w.is_contiguous() or w.data_ptr() % 16:
            raise ValueError(
                "the encoder-layer kernel takes contiguous, 16-byte aligned tensors"
            )


def fused_encoder_layer(
    x, wqkv, bqkv, wo, bo, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b,
    *, num_heads: int,
) -> torch.Tensor:
    """One post-LN encoder layer.  x [B, T, D] -> [B, T, D].

    CPU tensors run ``encoder_layer_plain``; CUDA tensors launch the
    kernel chain of csrc/encoder_layer.cu (counted once per call in
    ``fused_encoder_layer.launches``)."""
    weights = (wqkv, bqkv, wo, bo, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b)
    if x.device.type == "cpu":
        return encoder_layer_plain(x, *weights, num_heads=num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_cuda_args(x, weights, num_heads)
    b, t, d = x.shape
    f = w1.shape[0]
    m = b * t
    new = functools.partial(torch.empty, dtype=x.dtype, device=x.device)
    qkv, attn, tmp, h1, ff = new((m, 3 * d)), new((m, d)), new((m, d)), new((m, d)), new((m, f))
    out = new((b, t, d))
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(
            x.data_ptr(), *(w.data_ptr() for w in weights),
            qkv.data_ptr(), attn.data_ptr(), tmp.data_ptr(), h1.data_ptr(),
            ff.data_ptr(), out.data_ptr(), b, t, d, f, num_heads,
            (d // num_heads) ** -0.5, stream,
        )
    _build.check("encoder_layer", code)
    fused_encoder_layer.launches += 1
    return out


fused_encoder_layer.launches = 0
