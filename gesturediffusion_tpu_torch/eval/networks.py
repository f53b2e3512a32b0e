"""The frozen evaluator networks.

PyTorch counterpart of gesturediffusion_tpu/eval/networks.py:
- ``gru_cell`` and ``masked_gru`` (:52-95): one torch-semantics GRU step
  (gate order r, z, n, with ``r * (W_hn h + b_hn)``) and a GRU over the
  valid frames only, as pack_padded_sequence runs it: forward, the state
  stops at each sample's last valid frame; reverse, it starts there.
  Plain functions of explicit weights: the reference semantics that the
  BiGRUs below are held to.
- ``TextEncoderBiGRUCo``, ``MotionEncoderBiGRUCo`` (:98-170, the
  reference's modules.py:311,353) and ``MovementConvEncoder`` (:173,
  modules.py:79): the T2M text and motion co-embedding evaluators at their
  released widths.  The BiGRUs run ``nn.GRU`` (bidirectional) over
  ``pack_padded_sequence``, so the reverse half starts at each sample's
  last valid frame, as JAX's masked scan and the reference run it; over the
  padded batch it would read the padding.  The movement encoder is two
  stride-2 ``Conv1d`` over [B, C, T] (JAX's channel-last ``nn.Conv``), its
  dropouts idle at eval.  The parameter names are the reference's, so the
  ``text_encoder``, ``motion_encoder`` and ``movement_encoder`` dicts of
  the released ``finest.tar`` load as they are: the layout that JAX's
  ``convert_text_encoder``, ``convert_motion_encoder`` and
  ``convert_movement_encoder`` (:256-330, through ``convert_torch_gru``)
  read.
- ``MotionDiscriminator`` (:191-241), the HumanAct12 GRU action
  classifier of the reference (action2motion/models.py): a two-layer
  unidirectional ``nn.GRU`` of width 128 over the frames of [B, J, F, T],
  read at row ``lengths - 1``, ``tanh(linear1)`` of width 30 (the FID
  features), then ``linear2`` (the logits).  A unidirectional GRU's output
  at a valid frame depends on the frames before it only, so running it over
  the padded sequence gives JAX's masked scan there.  The parameter names
  are the reference's (``recurrent.*_l{0,1}``, ``linear1``, ``linear2``),
  so the ``model`` dict of ``humanact12_gru.tar`` loads as it is.  The
  hidden state starts at zeros, as in JAX (:18-21); the reference draws it
  with an unseeded ``torch.randn`` at every call.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence


def gru_cell(h, x, w_ih, w_hh, b_ih, b_hh):
    """One GRU step: h [B, H], x [B, D], w_ih [3H, D], w_hh [3H, H]."""
    i_r, i_z, i_n = (x @ w_ih.T + b_ih).chunk(3, dim=-1)
    h_r, h_z, h_n = (h @ w_hh.T + b_hh).chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1 - z) * n + z * h


def masked_gru(inputs: torch.Tensor, lengths: torch.Tensor, h0: torch.Tensor, params: dict,
               reverse: bool = False):
    """A GRU over the valid frames of inputs [B, T, D] (``params``: w_ih,
    w_hh, b_ih, b_hh); returns (outputs [B, T, H], the last state [B, H]).
    Forward, the state stops changing at t >= length; reverse, the steps
    run T-1..0 and skip t >= length, so the state starts at the last valid
    frame.  Past a sample's length its output holds the frozen state."""
    t = inputs.shape[1]
    h, outs = h0, [None] * t
    lengths = lengths.to(inputs.device)
    for i in (range(t - 1, -1, -1) if reverse else range(t)):
        h_new = gru_cell(h, inputs[:, i], params["w_ih"], params["w_hh"], params["b_ih"],
                         params["b_hh"])
        h = torch.where((i < lengths)[:, None], h_new, h)
        outs[i] = h
    return torch.stack(outs, dim=1), h


class MotionDiscriminator(nn.Module):
    """The a2m GRU action classifier: (motion [B, J, F, T], lengths [B])
    -> (logits [B, output_size], FID features [B, 30])."""

    def __init__(self, input_size: int, hidden_size: int = 128, hidden_layer: int = 2,
                 output_size: int = 12):
        super().__init__()
        self.hidden_size, self.hidden_layer = hidden_size, hidden_layer
        self.recurrent = nn.GRU(input_size, hidden_size, hidden_layer, batch_first=True)
        self.linear1 = nn.Linear(hidden_size, 30)
        self.linear2 = nn.Linear(30, output_size)

    def forward(self, motion: torch.Tensor, lengths: torch.Tensor,
                hidden: Optional[torch.Tensor] = None):
        b, j, f, t = motion.shape
        x = motion.reshape(b, j * f, t).transpose(1, 2).contiguous().float()
        if hidden is None:
            hidden = x.new_zeros((self.hidden_layer, b, self.hidden_size))
        out, _ = self.recurrent(x, hidden)
        idx = (lengths.to(x.device).long() - 1).clamp(0, t - 1)
        feats = torch.tanh(self.linear1(out[torch.arange(b, device=x.device), idx]))
        return self.linear2(feats), feats


class _BiGRUCo(nn.Module):
    """input_emb -> BiGRU from the learned initial state ``hidden`` -> the
    two directions' last states -> Linear, LayerNorm, LeakyReLU(0.2),
    Linear (the reference's co-embedding trunk)."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int):
        super().__init__()
        self.input_emb = nn.Linear(input_size, hidden_size)
        self.gru = nn.GRU(hidden_size, hidden_size, batch_first=True, bidirectional=True)
        self.output_net = nn.Sequential(
            nn.Linear(hidden_size * 2, hidden_size), nn.LayerNorm(hidden_size),
            nn.LeakyReLU(0.2, inplace=True), nn.Linear(hidden_size, output_size))
        self.hidden = nn.Parameter(torch.randn((2, 1, hidden_size)))

    def encode(self, inputs: torch.Tensor, lengths) -> torch.Tensor:
        """inputs [B, T, input_size], lengths [B] (1..T) -> [B, output_size]."""
        lengths = torch.as_tensor(lengths).to("cpu", torch.int64)
        packed = pack_padded_sequence(self.input_emb(inputs), lengths, batch_first=True,
                                      enforce_sorted=False)
        hidden = self.hidden.repeat(1, inputs.shape[0], 1)
        _, last = self.gru(packed, hidden)
        return self.output_net(torch.cat([last[0], last[1]], dim=-1))


class TextEncoderBiGRUCo(_BiGRUCo):
    """Caption encoder: (GloVe vectors [B, L, 300], part-of-speech one-hots
    [B, L, 15], caption lengths [B]) -> co-embedding [B, output_size]."""

    def __init__(self, word_size: int = 300, pos_size: int = 15, hidden_size: int = 512,
                 output_size: int = 512):
        super().__init__(word_size, hidden_size, output_size)
        self.pos_emb = nn.Linear(pos_size, word_size)

    def forward(self, word_embs, pos_onehot, cap_lens) -> torch.Tensor:
        return self.encode(word_embs + self.pos_emb(pos_onehot), cap_lens)


class MotionEncoderBiGRUCo(_BiGRUCo):
    """Movement features [B, T', 512], lengths [B] in units -> co-embedding."""

    def __init__(self, input_size: int = 512, hidden_size: int = 1024, output_size: int = 512):
        super().__init__(input_size, hidden_size, output_size)

    def forward(self, inputs, m_lens) -> torch.Tensor:
        return self.encode(inputs, m_lens)


class MovementConvEncoder(nn.Module):
    """Motion features [B, T, input_size] -> movement features
    [B, T / 4, output_size]: two Conv1d of kernel 4, stride 2, padding 1,
    each with LeakyReLU(0.2), then a Linear."""

    def __init__(self, input_size: int, hidden_size: int = 512, output_size: int = 512):
        super().__init__()
        self.main = nn.Sequential(
            nn.Conv1d(input_size, hidden_size, 4, 2, 1), nn.Dropout(0.2, inplace=True),
            nn.LeakyReLU(0.2, inplace=True),
            nn.Conv1d(hidden_size, output_size, 4, 2, 1), nn.Dropout(0.2, inplace=True),
            nn.LeakyReLU(0.2, inplace=True))
        self.out_net = nn.Linear(output_size, output_size)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        return self.out_net(self.main(inputs.permute(0, 2, 1)).permute(0, 2, 1))
