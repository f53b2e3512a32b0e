"""Port parity of the text embedders (models/clip_text.py,
utils/text_embedder.py) against the JAX package: the BPE tokenizer's ids
on a synthetic merges file (with ``regex`` and with the ``re`` fallback),
the CLIP text tower and MDM's 22-token embedder from one reference-layout
state dict (rtol 1e-5 / atol 1e-5: float32 products in another order
through 2 blocks), the hash embedder (byte-equal) and ``get_text_encoder``'s
branch under the same environment."""

import builtins
import gzip

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.models import clip_text as jax_clip
from gesturediffusion_tpu.utils import text_embedder as jax_embedder
from gesturediffusion_tpu_torch.models import clip_text
from gesturediffusion_tpu_torch.utils import text_embedder

TINY = dict(vocab_size=49408, context_length=77, width=64, heads=4, layers=2, embed_dim=32)
TEXTS = ["a person walks forward and waves", "Jump! then 3 spins...", "",
         "the quick brown fox jumps over the lazy dog " * 4]


@pytest.fixture(scope="module")
def bpe_file(tmp_path_factory):
    """A merges file in CLIP's layout: a header line and merges over the
    byte alphabet, so that the merged tokens of TEXTS exist."""
    path = tmp_path_factory.mktemp("bpe") / "bpe.txt.gz"
    merges = ["t h", "th e</w>", "a </w>", "p e", "pe r", "per s", "o n</w>", "w a", "wa l",
              "wal k", "walk s</w>", "f o", "fo r", "for w", "forw a", "forwa r", "forwar d</w>",
              "j u", "ju m", "jum p", "s p", "i n", "in s</w>", "o v", "ov e", "ove r</w>"]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def state_dict():
    """A reference-layout (OpenAI CLIP) text-tower state dict, seeded."""
    torch.manual_seed(0)
    model = clip_text.CLIPTextEncoder(**TINY)
    # LayerNorm and bias parameters off their initial values, so a wrong
    # mapping shows
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or ".ln_" in name or "ln_final" in name:
                p.add_(torch.randn_like(p) * 0.1)
    sd = model.state_dict()
    sd["logit_scale"] = torch.tensor(4.6)  # a whole CLIP's extra keys are left out
    sd["visual.proj"] = torch.zeros(8, 8)
    return sd


@pytest.mark.parametrize("fallback", [False, True])
def test_tokenizer_ids_equal_jax(bpe_file, fallback, monkeypatch):
    if fallback:  # the machine may lack the regex module: both take re
        real_import = builtins.__import__

        def no_regex(name, *args, **kwargs):
            if name == "regex":
                raise ImportError("no regex")
            return real_import(name, *args, **kwargs)

        monkeypatch.setattr(builtins, "__import__", no_regex)
    got_tok, want_tok = clip_text.SimpleTokenizer(bpe_file), jax_clip.SimpleTokenizer(bpe_file)
    assert got_tok.encoder == want_tok.encoder
    for text in TEXTS:
        assert got_tok.encode(text) == want_tok.encode(text), text
    for ctx in (22, 77):
        np.testing.assert_array_equal(clip_text.tokenize(got_tok, TEXTS, ctx),
                                      jax_clip.tokenize(want_tok, TEXTS, ctx))
    with pytest.raises(RuntimeError, match="too long"):
        clip_text.tokenize(got_tok, TEXTS[-1:], 8, truncate=False)


def test_tower_matches_jax(state_dict):
    tower = clip_text.CLIPTextEncoder.from_state_dict(state_dict, heads=TINY["heads"]).eval()
    rs = np.random.RandomState(1)
    tokens = rs.randint(1, 49406, size=(3, 77)).astype(np.int32)
    for i, eot in enumerate((21, 5, 76)):
        tokens[i, eot] = 49407  # EOT, the highest id
        tokens[i, eot + 1:] = 0
    want = jax_clip.CLIPTextEncoder(**TINY).apply(
        {"params": jax_clip.convert_clip_text_weights(state_dict)}, jnp.asarray(tokens))
    with torch.no_grad():
        got = tower(torch.from_numpy(tokens))
    assert got.shape == (3, TINY["embed_dim"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", ["state_dict", "torchscript"])
def test_embedder_matches_jax(state_dict, bpe_file, tmp_path, layout):
    """MDM's tokenization (20 + 2, zero-padded to 77) and the tower, from a
    checkpoint file (a state dict, or a TorchScript archive as OpenAI's
    ViT-B-32.pt is), as JAX's CLIPTextEmbedder runs them."""
    if layout == "state_dict":
        torch.save(state_dict, tmp_path / "clip.pt")
    else:
        tower = clip_text.CLIPTextEncoder.from_state_dict(state_dict, heads=TINY["heads"])
        tokens = torch.ones((1, 77), dtype=torch.long)
        torch.jit.save(torch.jit.trace(tower.eval(), tokens), str(tmp_path / "clip.pt"))
    got = clip_text.CLIPTextEmbedder.from_torch_checkpoint(
        str(tmp_path / "clip.pt"), bpe_file, heads=TINY["heads"], device="cpu")
    want = jax_clip.CLIPTextEmbedder(jax_clip.convert_clip_text_weights(state_dict), bpe_file,
                                     **TINY)
    toks = got.tokens(TEXTS)
    assert toks.shape == (len(TEXTS), 77) and not toks[:, 22:].any()
    np.testing.assert_allclose(got(TEXTS).numpy(), np.asarray(want(TEXTS)),
                               rtol=1e-5, atol=1e-5)


def test_hash_embedder_is_byte_equal():
    got = text_embedder.HashTextEmbedder(512)(TEXTS)
    want = jax_embedder.HashTextEmbedder(512)(TEXTS)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("assets", ["none", "bpe_only", "both"])
def test_get_text_encoder_takes_jax_branch(assets, state_dict, bpe_file, tmp_path, monkeypatch,
                                           capsys):
    """CLIP_CHECKPOINT and CLIP_BPE_PATH pick the same branch in both
    packages (JAX's tower is loaded at ViT-B/32 widths only, so its loader
    is stood in for and only its choice is compared); the port logs it."""
    monkeypatch.chdir(tmp_path)  # no assets/clip/ here
    monkeypatch.setenv("CLIP_CHECKPOINT", str(tmp_path / "clip.pt"))
    if assets == "both":
        torch.save(state_dict, tmp_path / "clip.pt")
    if assets != "none":
        monkeypatch.setenv("CLIP_BPE_PATH", bpe_file)
    else:
        monkeypatch.delenv("CLIP_BPE_PATH", raising=False)
    monkeypatch.setattr(jax_clip.CLIPTextEmbedder, "from_torch_checkpoint",
                        classmethod(lambda cls, ckpt, bpe, **kw: ("clip", ckpt, bpe)))
    want = jax_embedder.get_text_encoder()
    got = text_embedder.get_text_encoder(device="cpu")
    log = capsys.readouterr().out
    if assets == "both":
        assert want == ("clip", str(tmp_path / "clip.pt"), bpe_file)
        assert isinstance(got, clip_text.CLIPTextEmbedder)
        assert "loading CLIP text tower" in log
        assert got(TEXTS[:2]).shape == (2, 32)  # the tower's widths read off the file
    else:
        assert isinstance(want, jax_embedder.HashTextEmbedder)
        assert isinstance(got, text_embedder.HashTextEmbedder)
        assert "hash text embedder" in log
