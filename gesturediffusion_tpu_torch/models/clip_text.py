"""CLIP text encoder (the ViT-B/32 text tower) and its BPE tokenizer.

PyTorch counterpart of gesturediffusion_tpu/models/clip_text.py:
``SimpleTokenizer`` (:73), ``tokenize`` (:168), the tower
``CLIPTextEncoder`` (:231), ``CLIPTextEmbedder`` (:323; MDM's 20-token
context + 2, zero-padded to 77) and ``default_bpe_path`` (:367).  The tower
keeps OpenAI CLIP's own parameter names (``token_embedding``,
``positional_embedding``, ``transformer.resblocks.{i}.{ln_1, attn, ln_2,
mlp.c_fc, mlp.c_proj}``, ``ln_final``, ``text_projection``), so it loads a
CLIP state dict directly (the JAX package converts it,
``convert_clip_text_weights`` :278).

The tower: token embedding + positional embedding -> pre-LN residual
blocks (causal mask of the finite -finfo(float32).max, QuickGELU
x * sigmoid(1.702 x), not torch's erf GELU) -> final LayerNorm -> the
activation at the EOT token (the highest id) -> text projection.  CLIP is
no TPU kernel: plain PyTorch products (TF32 off, PyTorch's default).
The tokenizer needs the ``regex`` module for CLIP's unicode classes and
falls back to an ASCII pattern with ``re`` where it is missing, as the
JAX package does (only non-ASCII prompts tokenize differently).
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
from typing import Optional

import numpy as np
import torch
from torch import nn


# ---------------------------------------------------------------------- #
# byte-level BPE tokenizer
# ---------------------------------------------------------------------- #
@functools.lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word) -> set:
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    """CLIP's byte-level BPE tokenizer over a merges file
    (``bpe_simple_vocab_16e6.txt.gz`` or one of its layout)."""

    def __init__(self, bpe_path: str):
        try:
            import regex

            pattern = (r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
                       r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+")
            self.pat = regex.compile(pattern, regex.IGNORECASE)
        except ImportError:
            pattern = (r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
                       r"[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+")
            self.pat = re.compile(pattern, re.IGNORECASE)
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1:49152 - 256 - 2 + 1]]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(merge) for merge in merges]
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        word = " ".join(word)
        self.cache[token] = word
        return word

    def encode(self, text: str) -> list[int]:
        bpe_tokens: list[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in self.pat.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens


def tokenize(tokenizer: SimpleTokenizer, texts: list[str], context_length: int = 77,
             truncate: bool = True) -> np.ndarray:
    """texts -> [B, context_length] int32 ids (sot ... eot, zero-padded)."""
    sot = tokenizer.encoder["<|startoftext|>"]
    eot = tokenizer.encoder["<|endoftext|>"]
    result = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        tokens = [sot] + tokenizer.encode(text) + [eot]
        if len(tokens) > context_length:
            if not truncate:
                raise RuntimeError(f"input too long: {text}")
            tokens = tokens[:context_length]
            tokens[-1] = eot
        result[i, :len(tokens)] = tokens
    return result


# ---------------------------------------------------------------------- #
# text transformer
# ---------------------------------------------------------------------- #
def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class _Attention(nn.Module):
    """nn.MultiheadAttention's packed parameter names."""

    def __init__(self, width: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)
        nn.init.normal_(self.in_proj_weight, std=width**-0.5)


class _MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = _Attention(width)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = _MLP(width)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        dh = d // self.heads
        qkv = nn.functional.linear(self.ln_1(x), self.attn.in_proj_weight, self.attn.in_proj_bias)
        q, k, v = (y.reshape(b, t, self.heads, dh).transpose(1, 2) for y in qkv.chunk(3, dim=-1))
        sim = (q @ k.transpose(-1, -2)) * dh**-0.5 + attn_mask
        out = (torch.softmax(sim, dim=-1) @ v).transpose(1, 2).reshape(b, t, d)
        x = x + self.attn.out_proj(out)
        return x + self.mlp.c_proj(quick_gelu(self.mlp.c_fc(self.ln_2(x))))


class _Transformer(nn.Module):
    def __init__(self, width: int, heads: int, layers: int):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, heads)
                                       for _ in range(layers))


class CLIPTextEncoder(nn.Module):
    """OpenAI CLIP text tower: tokens [B, T] -> pooled embedding [B, embed_dim]."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77, width: int = 512,
                 heads: int = 8, layers: int = 12, embed_dim: int = 512):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.randn(context_length, width) * 0.01)
        self.transformer = _Transformer(width, heads, layers)
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.randn(width, embed_dim) * width**-0.5)
        nn.init.normal_(self.token_embedding.weight, std=0.02)

    @classmethod
    def from_state_dict(cls, state_dict: dict, heads: int = 8) -> "CLIPTextEncoder":
        """The tower of a CLIP state dict (a whole CLIP model's included:
        its image tower and logit scale are left out), its widths read off
        the tensors; the head count is not in them."""
        layers = 0
        while f"transformer.resblocks.{layers}.attn.in_proj_weight" in state_dict:
            layers += 1
        vocab_size, width = state_dict["token_embedding.weight"].shape
        model = cls(vocab_size=vocab_size, width=width, layers=layers, heads=heads,
                    context_length=state_dict["positional_embedding"].shape[0],
                    embed_dim=state_dict["text_projection"].shape[1])
        own = model.state_dict()
        model.load_state_dict({k: v.float() for k, v in state_dict.items() if k in own})
        return model

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        b, t = tokens.shape
        x = self.token_embedding(tokens.long()) + self.positional_embedding[:t]
        causal = torch.triu(torch.full((t, t), -torch.finfo(torch.float32).max,
                                       device=x.device), diagonal=1)
        for block in self.transformer.resblocks:
            x = block(x, causal)
        x = self.ln_final(x)
        pooled = x[torch.arange(b, device=x.device), tokens.argmax(dim=-1)]
        return pooled @ self.text_projection


class CLIPTextEmbedder:
    """Texts -> CLIP sentence embeddings, tokenized as MDM.encode_text does
    (the reference's model/mdm.py:252-267): a context of 20 + 2 tokens,
    zero-padded to 77, through the frozen tower on ``device``."""

    def __init__(self, model: CLIPTextEncoder, bpe_path: str,
                 max_text_len: Optional[int] = 20, device=None):
        self.model = model.to(device).eval()
        self.device = self.model.positional_embedding.device
        self.tokenizer = SimpleTokenizer(bpe_path)
        self.max_text_len = max_text_len

    @classmethod
    def from_torch_checkpoint(cls, ckpt_path: str, bpe_path: str, heads: int = 8, **kw):
        """A CLIP checkpoint: a state dict, or a TorchScript archive (as
        OpenAI's ``ViT-B-32.pt`` is) whose ``state_dict()`` gives one.
        Neither is unpickled as arbitrary objects."""
        try:
            sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        except RuntimeError:  # weights_only refuses a TorchScript archive
            sd = torch.jit.load(ckpt_path, map_location="cpu")
        if isinstance(sd, torch.jit.ScriptModule):
            sd = sd.state_dict()
        return cls(CLIPTextEncoder.from_state_dict(sd, heads=heads), bpe_path, **kw)

    def tokens(self, texts: list[str]) -> np.ndarray:
        if self.max_text_len is None:
            return tokenize(self.tokenizer, texts, 77, truncate=True)
        context_length = self.max_text_len + 2
        tokens = tokenize(self.tokenizer, texts, context_length, truncate=True)
        pad = np.zeros((tokens.shape[0], 77 - context_length), np.int32)
        return np.concatenate([tokens, pad], axis=1)

    @torch.no_grad()
    def __call__(self, texts: list[str]) -> torch.Tensor:
        return self.model(torch.from_numpy(self.tokens(texts)).to(self.device))


def default_bpe_path() -> Optional[str]:
    """``$CLIP_BPE_PATH``, else ``assets/clip/bpe_simple_vocab_16e6.txt.gz``
    under the working directory, where the file exists."""
    for cand in (os.environ.get("CLIP_BPE_PATH", ""),
                 "assets/clip/bpe_simple_vocab_16e6.txt.gz"):
        if cand and os.path.isfile(cand):
            return cand
    return None
