"""Guo et al.'s text-to-motion baseline generator (CompV6), inference.

PyTorch counterpart of gesturediffusion_tpu/eval/comp_v6.py: the text
benchmark's comparison row (the reference's trainers.py CompTrainerV6
generate:382-446, modules.py, comp_v6_model_dataset.py:77-94).
- ``TextEncoderBiGRU`` (:28): word vectors + a Linear of the
  part-of-speech one-hots -> Linear -> a BiGRU from the learned state
  ``hidden`` over each caption's words (``pack_padded_sequence``), its
  outputs [B, T, 2H] and last states [B, 2H].  Past each caption's length
  the outputs are zeros and the backward half is flipped within the length
  (JAX :64-73), because ``AttLayer`` attends over all T positions.
- ``AttLayer`` (:79): one query against the word outputs, a softmax over T.
- ``TextDecoder`` (:126, the prior) and ``TextVAEDecoder`` (:150, the
  snippet decoder): Linear, LayerNorm, LeakyReLU(0.2), the sinusoidal table
  of 300 rows at the snippets still to go (``positional_encoder.pe``,
  clamped to 0..299), a stack of ``nn.GRUCell`` (``_GRUCellStack``, :92,
  each layer's state feeding the next), then the prior's mu / logvar heads
  and ``z = mu + exp(logvar / 2) * noise`` (the noise from an explicit
  generator, or injected) or the decoder's Linear, LayerNorm, LeakyReLU,
  Linear.  ``z2init`` maps the text's last state to the initial states.
- ``MovementConvDecoder`` (:175): movement latents [B, T', 512] -> poses
  [B, 4 T', dim_pose] through two ``ConvTranspose1d(k=4, s=2, p=1)``, the
  reference's layer (JAX runs a VALID transposed conv cropped by one on
  each side with the kernel flipped, :184-194, :326-338).
- ``MotionLenEstimatorBiGRU`` (:197): the caption's BiGRU last states ->
  three Linear, LayerNorm, LeakyReLU blocks (512, 256, 128) -> 50 logits.
- ``CompV6Generator`` (:379-532): the seven networks at the released
  widths, ``estimate_length_logits`` and ``generate`` (the autoregressive
  snippet loop: the movement encoder of eval/networks.py on a zero snippet,
  then per snippet the attention vector, the prior's z and the decoder's
  movement, then the movement decoder over all of them).
The modules are named as the reference's modules.py names them, so the
released ``CompV6`` tar's ``text_enc``, ``seq_pri``, ``seq_dec``,
``att_layer``, ``mov_enc`` and ``mov_dec`` and the length estimator tar's
``estimator`` load with ``load_state_dict`` (``load_torch_checkpoints``);
utils/convert.py:comp_v6_state_dicts_from_params carries JAX parameters
across in the same layout.  On the card every GRU, convolution and product
runs in float32 with TF32 off (utils/device.py:full_f32).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from gesturediffusion_tpu_torch.eval.networks import MovementConvEncoder
from gesturediffusion_tpu_torch.models.embeddings import sinusoidal_table
from gesturediffusion_tpu_torch.utils.device import full_f32, resolve_device

# the released tars' keys -> the generator's module names
STATE_DICT_KEYS = {"text_enc": "text_enc", "seq_pri": "seq_pri", "seq_dec": "seq_dec",
                   "att_layer": "att_layer", "mov_enc": "mov_enc", "mov_dec": "mov_dec",
                   "estimator": "len_estimator"}


def _lengths_cpu(lengths) -> torch.Tensor:
    return torch.as_tensor(lengths).to("cpu", torch.int64)


class _CaptionBiGRU(nn.Module):
    """pos_emb, input_emb and the BiGRU from ``hidden`` that the text
    encoder and the length estimator share (the reference's layout)."""

    def __init__(self, word_size: int, pos_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.pos_emb = nn.Linear(pos_size, word_size)
        self.input_emb = nn.Linear(word_size, hidden_size)
        self.gru = nn.GRU(hidden_size, hidden_size, batch_first=True, bidirectional=True)
        self.hidden = nn.Parameter(torch.randn((2, 1, hidden_size)))

    def run_gru(self, word_embs, pos_onehot, cap_lens):
        """(the packed outputs, the last states [2, B, H])."""
        x = self.input_emb(word_embs + self.pos_emb(pos_onehot))
        packed = pack_padded_sequence(x, _lengths_cpu(cap_lens), batch_first=True,
                                      enforce_sorted=False)
        return self.gru(packed, self.hidden.repeat(1, x.shape[0], 1))


class TextEncoderBiGRU(_CaptionBiGRU):
    """(word vectors [B, T, 300], part-of-speech one-hots [B, T, 15],
    caption lengths [B]) -> (word outputs [B, T, 2H], last states [B, 2H])."""

    def __init__(self, word_size: int = 300, pos_size: int = 15, hidden_size: int = 512):
        super().__init__(word_size, pos_size, hidden_size)

    def forward(self, word_embs, pos_onehot, cap_lens):
        b, t = word_embs.shape[:2]
        seq, last = self.run_gru(word_embs, pos_onehot, cap_lens)
        seq = pad_packed_sequence(seq, batch_first=True, total_length=t)[0]  # zeros past a length
        fwd, bwd = seq[..., :self.hidden_size], seq[..., self.hidden_size:]
        lengths = torch.as_tensor(cap_lens).to(seq.device, torch.int64)
        idx = torch.arange(t, device=seq.device)[None, :]
        flip = (lengths[:, None] - 1 - idx).clamp(0, t - 1)
        bwd = torch.gather(bwd, 1, flip[..., None].expand(b, t, self.hidden_size))
        bwd = torch.where((idx < lengths[:, None])[..., None], bwd, torch.zeros((), device=seq.device))
        return torch.cat([fwd, bwd], dim=-1), torch.cat([last[0], last[1]], dim=-1)


class AttLayer(nn.Module):
    """(query [B, Q], keys [B, T, K]) -> (the attended value [B, V], the
    weights [B, T, 1])."""

    def __init__(self, query_dim: int, key_dim: int, value_dim: int):
        super().__init__()
        self.W_q = nn.Linear(query_dim, value_dim)
        self.W_k = nn.Linear(key_dim, value_dim, bias=False)
        self.W_v = nn.Linear(key_dim, value_dim)
        self.dim = value_dim

    def forward(self, query, key_mat):
        q = self.W_q(query)[..., None]
        weights = torch.matmul(self.W_k(key_mat), q) / np.sqrt(self.dim)
        co_weights = torch.softmax(weights, dim=1)
        return (self.W_v(key_mat) * co_weights).sum(dim=1), co_weights


class PositionalEncoding(nn.Module):
    """The sinusoidal table [max_len, d] as the buffer ``pe``, read at
    positions clamped to its rows."""

    def __init__(self, d_model: int, max_len: int = 300):
        super().__init__()
        self.register_buffer("pe", torch.from_numpy(
            sinusoidal_table(max_len, d_model).astype(np.float32)))

    def forward(self, pos: torch.Tensor) -> torch.Tensor:
        return self.pe[pos.long().clamp(0, self.pe.shape[0] - 1)]


class _GRUCellStack(nn.Module):
    """``n_layers`` GRU cells, each layer's new state the next one's input."""

    def __init__(self, hidden_size: int, n_layers: int):
        super().__init__()
        self.gru = nn.ModuleList(nn.GRUCell(hidden_size, hidden_size) for _ in range(n_layers))

    def run_cells(self, h_in, hidden: list):
        new_hidden = []
        for cell, h in zip(self.gru, hidden):
            h_in = cell(h_in, h)
            new_hidden.append(h_in)
        return h_in, new_hidden


def _emb(input_size: int, hidden_size: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(input_size, hidden_size), nn.LayerNorm(hidden_size),
                         nn.LeakyReLU(0.2, inplace=True))


class _SnippetRNN(_GRUCellStack):
    """emb -> + positional table -> GRU cells, with ``z2init`` (the text's
    last states -> the initial states)."""

    def __init__(self, text_size: int, input_size: int, hidden_size: int, n_layers: int):
        super().__init__(hidden_size, n_layers)
        self.hidden_size = hidden_size
        self.emb = _emb(input_size, hidden_size)
        self.z2init = nn.Linear(text_size, hidden_size * n_layers)
        self.positional_encoder = PositionalEncoding(hidden_size)

    def get_init_hidden(self, latent) -> list:
        return list(torch.split(self.z2init(latent), self.hidden_size, dim=-1))

    def recur(self, inputs, hidden, p):
        return self.run_cells(self.emb(inputs) + self.positional_encoder(p), hidden)


class TextDecoder(_SnippetRNN):
    """The prior: (inputs, states, snippets to go, noise) -> (z, mu,
    logvar, states)."""

    def __init__(self, text_size: int, input_size: int, output_size: int, hidden_size: int,
                 n_layers: int = 1):
        super().__init__(text_size, input_size, hidden_size, n_layers)
        self.mu_net = nn.Linear(hidden_size, output_size)
        self.logvar_net = nn.Linear(hidden_size, output_size)

    def forward(self, inputs, hidden: list, p, generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
        h, hidden = self.recur(inputs, hidden, p)
        mu, logvar = self.mu_net(h), self.logvar_net(h)
        if noise is None:
            noise = torch.randn(mu.shape, generator=generator, device=mu.device)
        return mu + torch.exp(0.5 * logvar) * noise, mu, logvar, hidden


class TextVAEDecoder(_SnippetRNN):
    """The snippet decoder: (inputs, states, snippets to go) -> (movement,
    states)."""

    def __init__(self, text_size: int, input_size: int, output_size: int, hidden_size: int,
                 n_layers: int = 1):
        super().__init__(text_size, input_size, hidden_size, n_layers)
        self.output = nn.Sequential(
            nn.Linear(hidden_size, hidden_size), nn.LayerNorm(hidden_size),
            nn.LeakyReLU(0.2, inplace=True), nn.Linear(hidden_size, output_size))

    def forward(self, inputs, hidden: list, p):
        h, hidden = self.recur(inputs, hidden, p)
        return self.output(h), hidden


class MovementConvDecoder(nn.Module):
    """Movement latents [B, T', input_size] -> poses [B, 4 T', output_size]."""

    def __init__(self, input_size: int = 512, hidden_size: int = 512, output_size: int = 263):
        super().__init__()
        self.main = nn.Sequential(
            nn.ConvTranspose1d(input_size, hidden_size, 4, 2, 1), nn.LeakyReLU(0.2, inplace=True),
            nn.ConvTranspose1d(hidden_size, output_size, 4, 2, 1), nn.LeakyReLU(0.2, inplace=True))
        self.out_net = nn.Linear(output_size, output_size)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        return self.out_net(self.main(inputs.permute(0, 2, 1)).permute(0, 2, 1))


class MotionLenEstimatorBiGRU(_CaptionBiGRU):
    """(word vectors, part-of-speech one-hots, caption lengths) -> the
    motion length's logits [B, output_size] over units of 4 frames."""

    def __init__(self, word_size: int = 300, pos_size: int = 15, hidden_size: int = 512,
                 output_size: int = 50):
        super().__init__(word_size, pos_size, hidden_size)
        nd = 512
        self.output = nn.Sequential(
            nn.Linear(hidden_size * 2, nd), nn.LayerNorm(nd), nn.LeakyReLU(0.2, inplace=True),
            nn.Linear(nd, nd // 2), nn.LayerNorm(nd // 2), nn.LeakyReLU(0.2, inplace=True),
            nn.Linear(nd // 2, nd // 4), nn.LayerNorm(nd // 4), nn.LeakyReLU(0.2, inplace=True),
            nn.Linear(nd // 4, output_size))

    def forward(self, word_embs, pos_onehot, cap_lens):
        _, last = self.run_gru(word_embs, pos_onehot, cap_lens)
        return self.output(torch.cat([last[0], last[1]], dim=-1))


class CompV6Generator(nn.Module):
    """The CompV6 networks at the released widths (or the given ones), with
    ``state_dicts`` ({tar key: state dict}, the released tars' layout) or
    random weights, on ``device`` (the card unless ``"cpu"``)."""

    def __init__(self, dim_pose: int = 263, unit_length: int = 4, text_hidden: int = 512,
                 movement_latent: int = 512, z_dim: int = 128, hidden_size: int = 1024,
                 n_layers: int = 1, word_size: int = 300, pos_size: int = 15,
                 state_dicts: Optional[dict] = None, device=None):
        super().__init__()
        self.dim_pose, self.unit_length, self.z_dim = dim_pose, unit_length, z_dim
        text_size = 2 * text_hidden
        self.text_enc = TextEncoderBiGRU(word_size, pos_size, text_hidden)
        self.seq_pri = TextDecoder(text_size, movement_latent + text_size, z_dim, hidden_size,
                                   n_layers)
        self.seq_dec = TextVAEDecoder(text_size, movement_latent + text_size + z_dim,
                                      movement_latent, hidden_size, n_layers)
        self.att_layer = AttLayer(hidden_size, text_size, text_size)
        self.mov_enc = MovementConvEncoder(dim_pose - 4, movement_latent, movement_latent)
        # the decoder gives the whole pose, foot contacts included (JAX :417-419)
        self.mov_dec = MovementConvDecoder(movement_latent, movement_latent, dim_pose)
        self.len_estimator = MotionLenEstimatorBiGRU(word_size, pos_size)
        if state_dicts is not None:
            self.load_state_dicts(state_dicts)
        self.device = resolve_device(device)
        self.to(self.device).eval()

    def load_state_dicts(self, state_dicts: dict) -> None:
        """{tar key: state dict} (``text_enc`` ... ``mov_dec``, ``estimator``)."""
        for key, name in STATE_DICT_KEYS.items():
            getattr(self, name).load_state_dict(state_dicts[key])

    @staticmethod
    def load_torch_checkpoints(path: str, len_est_path: str) -> dict:
        """The released CompV6 tar and length estimator tar -> their state
        dicts in this generator's layout."""
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        est = torch.load(len_est_path, map_location="cpu", weights_only=False)
        out = {key: dict(ckpt[key]) for key in STATE_DICT_KEYS if key != "estimator"}
        out["estimator"] = dict(est["estimator"])
        return out

    def _tensor(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    @torch.no_grad()
    def estimate_length_logits(self, word_embs, pos_ohot, cap_lens) -> torch.Tensor:
        with full_f32():
            return self.len_estimator(self._tensor(word_embs), self._tensor(pos_ohot),
                                      np.asarray(cap_lens))

    @torch.no_grad()
    def begin(self, word_embs, pos_ohot, cap_lens):
        """The loop's state before the first snippet: (the zero snippet's
        movement, the word outputs, the prior's and the decoder's states)."""
        b = len(cap_lens)
        with full_f32():
            mov_in = self.mov_enc(torch.zeros(
                (b, self.unit_length, self.dim_pose - 4), device=self.device))[:, 0]
            word_hids, hidden = self.text_enc(self._tensor(word_embs), self._tensor(pos_ohot),
                                              np.asarray(cap_lens))
            return (mov_in, word_hids, self.seq_pri.get_init_hidden(hidden),
                    self.seq_dec.get_init_hidden(hidden))

    @torch.no_grad()
    def snippet(self, i: int, state, m_lens: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
        """Snippet ``i`` of the loop: (movement [B, latent], the new state)."""
        mov_in, word_hids, hidden_pri, hidden_dec = state
        with full_f32():
            att_vec, _ = self.att_layer(hidden_dec[-1], word_hids)
            tta = m_lens // self.unit_length - i
            z_pri, _, _, hidden_pri = self.seq_pri(torch.cat([mov_in, att_vec], dim=-1),
                                                   hidden_pri, tta, generator, noise)
            fake_mov, hidden_dec = self.seq_dec(torch.cat([mov_in, att_vec, z_pri], dim=-1),
                                                hidden_dec, tta)
        return fake_mov, (fake_mov, word_hids, hidden_pri, hidden_dec)

    @torch.no_grad()
    def generate(self, word_embs, pos_ohot, cap_lens, m_lens, mov_len: int,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mov_len`` snippets -> motions [B, mov_len * unit_length,
        dim_pose].  The prior's noise is drawn from ``generator`` (on the
        generator's device) or read from ``noise`` [mov_len, B, z_dim]."""
        state = self.begin(word_embs, pos_ohot, cap_lens)
        m_lens = self._tensor(m_lens, torch.int64)
        if noise is not None:
            noise = self._tensor(noise)
        movements = []
        for i in range(mov_len):
            fake_mov, state = self.snippet(i, state, m_lens, generator,
                                           None if noise is None else noise[i])
            movements.append(fake_mov[:, None])
        with full_f32():
            return self.mov_dec(torch.cat(movements, dim=1))
