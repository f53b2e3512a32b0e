"""``GDT_SEED_DROPOUT=1`` in the port (ops/dropout.py:SeedDropout, JAX
ops/seed_dropout.py:44-124): the forward draws the default path's mask from
the same generator, autograd keeps the generator's state in place of the
mask, and backward draws the mask again.  Held bit for bit against the
default path on the CPU (losses, outputs, every gradient, the generator's
state after the draws, the weights after two AdamW steps): the mask alone;
the gesture MDM's training forward through the plain encoder layers (the
transformer's four sites and the local block's attention probabilities)
and through the fused training layer's plain twin (the local block only);
the text MotionMDM's (the positional encoding's site and the transformer's);
and under ``global_rows`` at two ranks' slices of a global batch, backward
run outside the block, each rank's output and gradient the single
process's rows.  The bytes autograd saves (``saved_tensors_hooks``) drop.
No tolerance: everything is compared for equality."""

import copy

import numpy as np
import pytest
import torch

from gesturediffusion_tpu_torch.diffusion import gaussian as pg
from gesturediffusion_tpu_torch.diffusion.resample import UniformSampler
from gesturediffusion_tpu_torch.models.mdm import MDM
from gesturediffusion_tpu_torch.models.mdm_t2m import MotionMDM
from gesturediffusion_tpu_torch.ops import dropout as pd
from gesturediffusion_tpu_torch.parallel.distributed import global_rows
from gesturediffusion_tpu_torch.train import loop as ploop
from tests.torch_port_common import SMALL, SMALL_T2M, to_torch


def _saved_bytes():
    sizes = []

    def pack(t):
        sizes.append(t.numel() * t.element_size())
        return t

    return sizes, torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t)


def test_the_mask_and_the_generator_advance_equal_the_default(monkeypatch):
    x = torch.randn(6, 5, 7, requires_grad=True)
    outs = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("GDT_SEED_DROPOUT", flag)
        g = torch.Generator().manual_seed(3)
        y = pd.dropout(x, 0.3, g)
        assert (type(y.grad_fn).__name__ == "SeedDropoutBackward") == (flag == "1")
        (grad,) = torch.autograd.grad((y * torch.arange(y.numel()).reshape(y.shape)).sum(), x)
        outs[flag] = (y.detach(), grad, g.get_state(), torch.rand(3, generator=g))
    for a, b in zip(outs["0"], outs["1"]):
        assert torch.equal(a, b)
    with torch.no_grad():  # no graph: the default draw, nothing saved
        monkeypatch.setenv("GDT_SEED_DROPOUT", "1")
        y = pd.dropout(x, 0.3, torch.Generator().manual_seed(3))
    assert y.grad_fn is None and torch.equal(y, outs["0"][0])


def _gesture(fused):
    torch.manual_seed(0)
    return MDM(**SMALL, dropout=0.2, use_fused_train_encoder=fused)


def _t2m():
    torch.manual_seed(0)
    return MotionMDM(njoints=10, cond_mode="text", **{**SMALL_T2M, "cond_mask_prob": 0.2},
                     dropout=0.2)


def _batches(model, n=2, b=4, t=16):
    rs = np.random.RandomState(5)
    out = []
    for _ in range(n):
        j = model.njoints
        cond = {"mask": np.ones((b, 1, 1, t), bool)}
        if isinstance(model, MDM):
            cond.update(mfcc=rs.randn(b, SMALL["mfcc_dim"], 1, t).astype(np.float32),
                        seed=rs.randn(b, j, 1, SMALL["seed_poses"]).astype(np.float32))
        else:
            cond["text_emb"] = rs.randn(b, 512).astype(np.float32)
        out.append((rs.randn(b, j, 1, t).astype(np.float32), cond,
                    rs.randint(0, 8, b).astype(np.int64), rs.randn(b, j, 1, t).astype(np.float32)))
    return out


@pytest.mark.parametrize("build", ["gesture-plain-layers", "gesture-fused-layer", "t2m"])
def test_train_steps_equal_the_default_bit_for_bit(monkeypatch, build):
    make = {"gesture-plain-layers": lambda: _gesture(False),
            "gesture-fused-layer": lambda: _gesture(True), "t2m": _t2m}[build]
    base = make()
    diffusion = pg.create_diffusion(steps=8, device="cpu")
    cfg = ploop.TrainConfig(lr=1e-3, weight_decay=0.01)
    runs = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("GDT_SEED_DROPOUT", flag)
        model = copy.deepcopy(base)
        state = ploop.TrainState(model, *ploop.make_optimizer(model.parameters(), cfg),
                                 UniformSampler(8), {})
        gen = torch.Generator().manual_seed(7)
        x, cond, t, _ = _batches(model, 1)[0]
        sizes, hooks = _saved_bytes()
        with hooks:
            out = model(torch.from_numpy(x), torch.from_numpy(t), to_torch(cond), train=True,
                        generator=gen)
        (out ** 2).mean().backward()
        first = {"out": out.detach(), **{n: p.grad.clone() for n, p in model.named_parameters()
                                          if p.grad is not None}}
        model.zero_grad(set_to_none=True)
        losses = [ploop.train_step(state, diffusion, cfg, torch.from_numpy(m), to_torch(c), gen,
                                   torch.from_numpy(tt), torch.from_numpy(nz))["loss"]
                  for m, c, tt, nz in _batches(model)]
        runs[flag] = (first, losses, model.state_dict(), gen.get_state(), sum(sizes))
    (f0, l0, w0, g0, s0), (f1, l1, w1, g1, s1) = runs["0"], runs["1"]
    assert sorted(f0) == sorted(f1) and len(f0) > 1
    for k in f0:
        assert torch.equal(f0[k], f1[k]), k
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    for k in w0:
        assert torch.equal(w0[k], w1[k]), k
    assert torch.equal(g0, g1)
    assert s1 < s0, (s1, s0)


def test_two_ranks_rows_equal_the_single_process(monkeypatch):
    """Each rank of a global batch of 4 holds 2 rows under global_rows: its
    seed-path output and gradient are the single process's default rows,
    backward run after the block has closed."""
    monkeypatch.setenv("GDT_SEED_DROPOUT", "0")
    rs = np.random.RandomState(2)
    x_all = torch.from_numpy(rs.randn(4, 3, 5).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rs.randn(4, 3, 5).astype(np.float32))
    gen = torch.Generator().manual_seed(11)
    y_all = pd.dropout(x_all, 0.4, gen)
    (y_all * w).sum().backward()
    state_all = gen.get_state()
    monkeypatch.setenv("GDT_SEED_DROPOUT", "1")
    for rank in (0, 1):
        rows = slice(2 * rank, 2 * rank + 2)
        x = x_all.detach()[rows].clone().requires_grad_()
        g = torch.Generator().manual_seed(11)
        with global_rows(2 * rank, 2, 4):
            y = pd.dropout(x, 0.4, g)
        assert type(y.grad_fn).__name__ == "SeedDropoutBackward"
        (y * w[rows]).sum().backward()
        assert torch.equal(y.detach(), y_all.detach()[rows])
        assert torch.equal(x.grad, x_all.grad[rows])
        assert torch.equal(g.get_state(), state_all)
