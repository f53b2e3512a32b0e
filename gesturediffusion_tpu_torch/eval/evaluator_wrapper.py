"""The frozen T2M evaluators of the text-to-motion benchmark.

PyTorch counterpart of gesturediffusion_tpu/eval/evaluator_wrapper.py
(``EvaluatorWrapper``, :34): the caption encoder, the motion encoder and
the movement encoder of eval/networks.py at their released widths (text
BiGRU 300 -> 512, motion BiGRU 512 -> 1024 -> 512, movement convolutions
512), with the given state dicts, else the weights of the released
``finest.tar`` where ``T2M_EVALUATOR_PATH`` (default
``{t2m|kit}/text_mot_match/model/finest.tar``) names one, else random
frozen weights of seed 0 with a loud warning.
``get_co_embeddings`` and ``get_motion_embeddings`` keep the reference's
order: the motions sorted by length, longest first (``np.argsort`` as in
JAX, so ties fall alike), the movement encoder on ``motions[..., :-4]``,
the motion encoder over ``m_lens // 4`` units, the captions' embeddings
put in the motions' order; ``keep_order`` gives the input order back.
Every device call runs in float32 with TF32 off (utils/device.py:full_f32):
cuDNN's GRU and convolutions would otherwise take one TF32 pass, PyTorch's
default.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from gesturediffusion_tpu_torch.eval.eval_a2m import seeded
from gesturediffusion_tpu_torch.eval.networks import (
    MotionEncoderBiGRUCo,
    MovementConvEncoder,
    TextEncoderBiGRUCo,
)
from gesturediffusion_tpu_torch.utils import logger as log_lib
from gesturediffusion_tpu_torch.utils.device import full_f32, resolve_device

STATE_DICT_KEYS = ("text_encoder", "motion_encoder", "movement_encoder")


class EvaluatorWrapper:
    """Text and motion co-embeddings of the frozen evaluators, as numpy."""

    UNIT_LENGTH = 4

    def __init__(
        self,
        dataset_name: str = "humanml",
        state_dicts: Optional[dict] = None,
        dim_pose: Optional[int] = None,
        device=None,
    ):
        self.dataset_name = dataset_name
        self.dim_pose = dim_pose or (263 if dataset_name == "humanml" else 251)
        self.device = resolve_device(device)

        def build():
            return (TextEncoderBiGRUCo(word_size=300, pos_size=15, hidden_size=512,
                                       output_size=512),
                    MotionEncoderBiGRUCo(input_size=512, hidden_size=1024, output_size=512),
                    MovementConvEncoder(self.dim_pose - 4, hidden_size=512, output_size=512))

        self.text_encoder, self.motion_encoder, self.movement_encoder = seeded(0, build)
        if state_dicts is None:
            path = os.environ.get("T2M_EVALUATOR_PATH", os.path.join(
                "t2m" if dataset_name == "humanml" else "kit", "text_mot_match", "model",
                "finest.tar"))
            if os.path.isfile(path):
                state_dicts = self.load_torch_checkpoint(path)
        if state_dicts is not None:
            for key, module in zip(STATE_DICT_KEYS, self.modules()):
                module.load_state_dict(state_dicts[key])
        else:
            log_lib.log(
                "WARNING: T2M evaluator checkpoint (finest.tar) not found — using RANDOM "
                "frozen evaluator weights; metrics are NOT comparable to the reference "
                "protocol.")
        for module in self.modules():
            module.to(self.device).eval()

    def modules(self):
        return self.text_encoder, self.motion_encoder, self.movement_encoder

    @staticmethod
    def load_torch_checkpoint(path: str) -> dict:
        """The released finest.tar -> its three state dicts, in this
        wrapper's modules' layout."""
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        return {key: dict(ckpt[key]) for key in STATE_DICT_KEYS}

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    @torch.no_grad()
    def _motion_embed(self, motions, m_lens) -> np.ndarray:
        with full_f32():
            movements = self.movement_encoder(self._tensor(motions)[..., :-4])
            emb = self.motion_encoder(movements, np.asarray(m_lens) // self.UNIT_LENGTH)
        return emb.cpu().numpy()

    def get_co_embeddings(self, word_embs, pos_ohot, cap_lens, motions, m_lens):
        """(text, motion) embeddings, both in the motions' length-sorted
        order, longest first (not the input order)."""
        align_idx = np.argsort(np.asarray(m_lens))[::-1].copy()
        motion_embedding = self._motion_embed(np.asarray(motions)[align_idx],
                                              np.asarray(m_lens)[align_idx])
        with torch.no_grad(), full_f32():
            text_embedding = self.text_encoder(self._tensor(word_embs), self._tensor(pos_ohot),
                                               np.asarray(cap_lens)).cpu().numpy()
        return text_embedding[align_idx], motion_embedding

    def get_motion_embeddings(self, motions, m_lens, keep_order: bool = False) -> np.ndarray:
        """Motion embeddings in the length-sorted order, or with
        ``keep_order`` in the input order (multimodality regroups by it)."""
        align_idx = np.argsort(np.asarray(m_lens))[::-1].copy()
        emb = self._motion_embed(np.asarray(motions)[align_idx], np.asarray(m_lens)[align_idx])
        if keep_order:
            inverse = np.empty_like(align_idx)
            inverse[align_idx] = np.arange(len(align_idx))
            return emb[inverse]
        return emb
