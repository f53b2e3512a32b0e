"""Training of the evaluator networks: regenerate the T2M evaluators
(``finest.tar``) and the a2m action classifier from scratch.

PyTorch counterpart of gesturediffusion_tpu/eval/trainers.py (the
reference's trainers.py DecompTrainerV3:25-108, LengthEstTrainer:748-877,
TextMotionMatchTrainer:879-1080, modules.py:11-24 ContrastiveLoss):
- ``contrastive_loss`` (:32): label 0 pulls a pair together (squared
  distance), label 1 pushes it past the margin.
- ``DecompTrainer`` (:65): the movement autoencoder, MovementConvEncoder of
  eval/networks.py on ``motions[..., :-4]`` and MovementConvDecoder of
  eval/comp_v6.py back to the whole pose: L1 reconstruction + 0.001 x the
  latents' mean |.| + 0.001 x their temporal L1.  No clip.
- ``LengthEstTrainer`` (:121): cross-entropy of MotionLenEstimatorBiGRU's
  logits against ``m_lens // 4``, clip 0.5.
- ``TextMotionMatchTrainer`` (:161): the caption and motion co-embedding
  encoders against a FROZEN movement encoder: the positive pairs and the
  pairs shifted by a draw from 1..B-1 (from the trainer's generator, or
  given) in the contrastive loss at margin 10, clip 0.5; ``val_loss`` with
  shift 1.
- ``ActionClassifierTrainer`` (:260): cross-entropy of the a2m GRU
  classifier (eval/networks.py:MotionDiscriminator) on [B, J, 3, T] xyz.
- ``fit`` (:301, the epoch loop's mean metrics) and ``save_finest``
  (:318), which writes what the port loads: ``{"text_encoder",
  "motion_encoder", "movement_encoder"}`` state dicts, the released
  ``finest.tar`` layout that eval/evaluator_wrapper.py reads through
  ``T2M_EVALUATOR_PATH``, or ``{"model": classifier}``, the
  ``humanact12_gru.tar`` layout that eval/eval_a2m.py reads through
  ``A2M_CLASSIFIER_PATH``.
Every trainer runs ``torch.optim.Adam`` (optax.adam's defaults) after the
clip where there is one, and the clip is optax's ``clip_by_global_norm``
rule: ``g / norm * clip`` where the global norm reaches ``clip``, else ``g``
(torch's ``clip_grad_norm_`` scales by ``clip / (norm + 1e-6)`` instead).
The movement encoder's dropouts stay idle, as JAX's encoder has none.  The
trainers put their modules on ``device`` (the card unless ``"cpu"``) and
run them in float32 with TF32 off (utils/device.py:full_f32).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gesturediffusion_tpu_torch.utils.device import full_f32, resolve_device


def _host(a) -> np.ndarray:
    """Lengths as host numpy (the GRUs pack on the host)."""
    return np.asarray(a.cpu() if torch.is_tensor(a) else a)


def contrastive_loss(emb1: torch.Tensor, emb2: torch.Tensor, label: torch.Tensor,
                     margin: float = 10.0) -> torch.Tensor:
    """mean((1 - label) d^2 + label max(margin - d, 0)^2), d the pairs'
    Euclidean distance."""
    dist = torch.sqrt(((emb1 - emb2) ** 2).sum(dim=-1) + 1e-12)
    return ((1.0 - label) * dist**2 + label * torch.clamp(margin - dist, min=0.0) ** 2).mean()


@torch.no_grad()
def clip_by_global_norm_(params, clip: float) -> torch.Tensor:
    """optax.clip_by_global_norm on the gradients of ``params``, in place;
    returns the global norm before the clip."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    for g in grads:
        # optax's select: g where the norm is below the clip, else (g / norm) * clip
        g.copy_(torch.where(norm < clip, g, (g / norm) * clip))
    return norm


class _Trainer:
    """Adam over the modules' parameters (``modules``: {name: module}),
    with the optional clip; ``backward`` leaves a batch's gradients in
    ``.grad``, ``update`` clips and steps, ``step`` does both."""

    def __init__(self, modules: dict, lr: float, clip: Optional[float], device=None):
        self.device = resolve_device(device)
        self.modules = {k: m.to(self.device) for k, m in modules.items()}
        self.params = [p for m in self.modules.values() for p in m.parameters()]
        self.optimizer = torch.optim.Adam(self.params, lr=lr)
        self.clip = clip

    def named_parameters(self):
        for key, module in self.modules.items():
            for name, p in module.named_parameters():
                yield f"{key}.{name}", p

    def loss(self, *batch) -> tuple[torch.Tensor, dict]:
        raise NotImplementedError

    def _tensor(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a, dtype=dtype,
                               device=self.device)

    def backward(self, *batch) -> dict:
        """The batch's loss and metrics (detached); its gradients in ``.grad``."""
        self.optimizer.zero_grad(set_to_none=True)
        for m in self.modules.values():
            m.train()
        with torch.enable_grad(), full_f32():  # whatever the caller's grad mode
            loss, metrics = self.loss(*batch)
            loss.backward()
        return {k: v.detach() for k, v in metrics.items()}

    def update(self) -> None:
        if self.clip is not None:
            clip_by_global_norm_(self.params, self.clip)
        self.optimizer.step()

    def step(self, *batch) -> dict:
        metrics = self.backward(*batch)
        self.update()
        return metrics


class DecompTrainer(_Trainer):
    """The movement autoencoder: ``step(motions [B, T, dim_pose])``."""

    def __init__(self, movement_enc: nn.Module, movement_dec: nn.Module, lr: float = 1e-4,
                 lambda_sparsity: float = 0.001, lambda_smooth: float = 0.001, device=None):
        super().__init__({"enc": movement_enc, "dec": movement_dec}, lr, None, device)
        self.lambda_sparsity, self.lambda_smooth = lambda_sparsity, lambda_smooth

    def loss(self, motions):
        motions = self._tensor(motions)
        enc = self.modules["enc"].eval()  # its dropouts idle, as JAX's encoder has none
        latents = enc(motions[..., :-4])
        recon = self.modules["dec"](latents)
        loss_rec = (recon - motions).abs().mean()
        loss_sparsity = latents.abs().mean()
        loss_smooth = (latents[:, 1:] - latents[:, :-1]).abs().mean()
        loss = loss_rec + self.lambda_sparsity * loss_sparsity + self.lambda_smooth * loss_smooth
        return loss, {"loss": loss, "loss_rec": loss_rec, "loss_sparsity": loss_sparsity,
                      "loss_smooth": loss_smooth}


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, dict]:
    loss = F.cross_entropy(logits, labels)
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss, "acc": acc}


class LengthEstTrainer(_Trainer):
    """The length estimator: ``step(word_embs, pos_ohot, cap_lens, m_lens)``."""

    def __init__(self, estimator: nn.Module, lr: float = 1e-4, unit_length: int = 4,
                 clip: float = 0.5, device=None):
        super().__init__({"estimator": estimator}, lr, clip, device)
        self.unit_length = unit_length

    def loss(self, word_embs, pos_ohot, cap_lens, m_lens):
        logits = self.modules["estimator"](self._tensor(word_embs), self._tensor(pos_ohot),
                                           _host(cap_lens))
        return _cross_entropy(logits, self._tensor(m_lens, torch.int64) // self.unit_length)


class TextMotionMatchTrainer(_Trainer):
    """The co-embedding evaluators against the frozen ``movement_encoder``:
    ``step(word_embs, pos_ohot, cap_lens, motions, m_lens[, shift])``; the
    negative pairs' shift is drawn from ``generator`` unless given."""

    def __init__(self, text_encoder: nn.Module, motion_encoder: nn.Module,
                 movement_encoder: nn.Module, lr: float = 1e-4, negative_margin: float = 10.0,
                 unit_length: int = 4, clip: float = 0.5,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__({"text": text_encoder, "motion": motion_encoder}, lr, clip, device)
        self.movement_encoder = movement_encoder.to(self.device).eval().requires_grad_(False)
        self.negative_margin, self.unit_length = negative_margin, unit_length
        self.generator = generator

    def embed(self, word_embs, pos_ohot, cap_lens, motions, m_lens):
        """(text embeddings, motion embeddings), in the input order."""
        with torch.no_grad():
            movements = self.movement_encoder(self._tensor(motions)[..., :-4])
        motion_emb = self.modules["motion"](movements, _host(m_lens) // self.unit_length)
        text_emb = self.modules["text"](self._tensor(word_embs), self._tensor(pos_ohot),
                                        _host(cap_lens))
        return text_emb, motion_emb

    def loss(self, word_embs, pos_ohot, cap_lens, motions, m_lens, shift=None):
        text_emb, motion_emb = self.embed(word_embs, pos_ohot, cap_lens, motions, m_lens)
        b = text_emb.shape[0]
        if shift is None:
            shift = torch.randint(1, b, (), generator=self.generator,
                                  device=self.device if self.generator is None
                                  else self.generator.device)
        mis_idx = (torch.arange(b, device=self.device) + torch.as_tensor(shift, device=self.device)) % b
        zeros = torch.zeros((b,), device=self.device)
        loss_pos = contrastive_loss(text_emb, motion_emb, zeros, self.negative_margin)
        loss_neg = contrastive_loss(text_emb, motion_emb[mis_idx], zeros + 1.0,
                                    self.negative_margin)
        loss = loss_pos + loss_neg
        return loss, {"loss": loss, "loss_pos": loss_pos, "loss_neg": loss_neg}

    @torch.no_grad()
    def val_loss(self, word_embs, pos_ohot, cap_lens, motions, m_lens) -> dict:
        """The loss at shift 1, without gradients (JAX :240-252)."""
        for m in self.modules.values():
            m.eval()
        with full_f32():
            return {k: v.detach() for k, v in self.loss(
                word_embs, pos_ohot, cap_lens, motions, m_lens, shift=1)[1].items()}


class ActionClassifierTrainer(_Trainer):
    """The a2m GRU classifier: ``step(motions [B, J, 3, T], lengths, labels)``."""

    def __init__(self, classifier: nn.Module, lr: float = 1e-4, clip: Optional[float] = None,
                 device=None):
        super().__init__({"classifier": classifier}, lr, clip, device)

    def loss(self, motions, lengths, labels):
        logits, _ = self.modules["classifier"](self._tensor(motions),
                                               self._tensor(lengths, torch.int64))
        return _cross_entropy(logits, self._tensor(labels, torch.int64))


def fit(step_fn: Callable, batches, log_every: int = 0, log: Callable = print) -> dict:
    """``step_fn(*batch)`` over an iterable of argument tuples -> the mean
    of each metric."""
    sums: dict = {}
    n = 0
    for batch in batches:
        metrics = step_fn(*batch)
        n += 1
        for k, v in metrics.items():
            sums[k] = sums.get(k, 0.0) + float(v)
        if log_every and n % log_every == 0:
            log(f"step {n}: " + ", ".join(f"{k}={sums[k] / n:.4f}" for k in sorted(sums)))
    return {k: v / max(n, 1) for k, v in sums.items()}


def save_finest(path: str, modules: dict) -> None:
    """Write {tar key: module's state dict (on the CPU)} with torch.save:
    ``{"text_encoder": ..., "motion_encoder": ..., "movement_encoder": ...}``
    gives a finest.tar, ``{"model": classifier}`` an a2m classifier tar."""
    torch.save({key: {k: v.detach().cpu() for k, v in m.state_dict().items()}
                for key, m in modules.items()}, path)
