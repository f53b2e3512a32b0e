"""Port parity of the text benchmark's inputs and evaluators against the JAX
package on the CPU: ``WordVectorizer`` on a tiny GloVe-layout tree and
``HashVectorizer`` (item for item, exactly equal), the word fields of
``Text2MotionDatasetV2`` items (word vectors, part-of-speech one-hots,
sentence length, tokens; exactly equal, crops and captions too) on
``make_synthetic_humanml`` trees with one caption and with varied captions
of up to 26 words, the T2M evaluators through the converters from JAX
params drawn under threefry2x32 (``TextEncoderBiGRUCo``,
``MotionEncoderBiGRUCo``, ``MovementConvEncoder``, each BiGRU direction's
last state against JAX's masked scan at ragged lengths), the released
finest.tar layout, and ``EvaluatorWrapper.get_co_embeddings`` /
``get_motion_embeddings`` (the length-sorted order with ties, and
``keep_order``).

Tolerances: the evaluators' outputs rtol 1e-5 / atol 1e-5 (float32 GRUs of
up to 49 steps at widths 512 and 1024, cuDNN's and JAX's products in
another order; outputs of order 1 after a LayerNorm); the wrapper's
embeddings the same; everything else exact.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.data import humanml as jh
from gesturediffusion_tpu.eval import evaluator_wrapper as jew
from gesturediffusion_tpu.eval import networks as jn
from gesturediffusion_tpu_torch.data import humanml as ph
from gesturediffusion_tpu_torch.eval import evaluator_wrapper as pew
from gesturediffusion_tpu_torch.eval import networks as pn
from gesturediffusion_tpu_torch.utils.convert import t2m_evaluator_state_dicts_from_params
from tests.torch_port_common import (  # noqa: F401 (fixtures)
    one_torch_thread,
    threefry,
    threefry_prng,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL = ATOL = 1e-5

# (word, tag) pairs the varied captions draw from; VIP words, unknown words
# (not in the GloVe tree) and every tag class among them
WORDS = [("a", "DET"), ("the", "DET"), ("person", "NOUN"), ("man", "NOUN"),
         ("walk", "VERB"), ("run", "VERB"), ("jump", "VERB"), ("wave", "VERB"),
         ("left", "ADV"), ("forward", "ADV"), ("slowly", "ADV"), ("arm", "NOUN"),
         ("chair", "NOUN"), ("circle", "NOUN"), ("in", "ADP"), ("quick", "ADJ"),
         ("three", "NUM"), ("he", "PRON"), ("is", "AUX"), ("zigzag", "X")]
UNKNOWN = {"zigzag", "three", "sos"}  # words left out of the GloVe tree


def vary_captions(root: str, seed: int = 0) -> str:
    """Give every clip of a synthetic tree 1-3 captions of 2-26 random words
    (the tree's maker writes one sentence for all), one of them over the
    clip's middle third where the clip is long enough."""
    rs = np.random.RandomState(seed)
    for name in sorted(os.listdir(os.path.join(root, "texts"))):
        frames = len(np.load(os.path.join(root, "new_joint_vecs", name[:-4] + ".npy")))
        lines = []
        for c in range(rs.randint(1, 4)):
            picks = [WORDS[i] for i in rs.randint(0, len(WORDS), rs.randint(2, 27))]
            caption = " ".join(w for w, _ in picks)
            tokens = " ".join(f"{w}/{t}" for w, t in picks)
            span = (f"{frames / 60:.2f}#{2 * frames / 60:.2f}"
                    if c == 1 and frames >= 150 else "0.0#0.0")
            lines.append(f"{caption}#{tokens}#{span}\n")
        with open(os.path.join(root, "texts", name), "w") as f:
            f.writelines(lines)
    return root


def make_glove(root: str, seed: int = 0) -> str:
    """A GloVe-layout tree (``our_vab_words.pkl``, ``_idx.pkl``,
    ``_data.npy``) of the caption words but UNKNOWN, plus eos and unk."""
    os.makedirs(root, exist_ok=True)
    words = sorted({w for w, _ in WORDS} - UNKNOWN) + ["eos", "unk"]
    order = np.random.RandomState(seed).permutation(len(words))
    vectors = np.random.RandomState(seed + 1).randn(len(words), 300).astype(np.float32)
    with open(os.path.join(root, "our_vab_words.pkl"), "wb") as f:
        pickle.dump(words, f)
    with open(os.path.join(root, "our_vab_idx.pkl"), "wb") as f:
        pickle.dump({w: int(i) for w, i in zip(words, order)}, f)
    np.save(os.path.join(root, "our_vab_data.npy"), vectors)
    return root


TOKENS = ([f"{w}/{t}" for w, t in WORDS] + ["sos/OTHER", "eos/OTHER", "unk/OTHER", "left/VERB",
                                             "arm/ADJ", "walk/NOUN", "x/UNKNOWNTAG"])


def _assert_items_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
            assert got[k].dtype == v.dtype, k
        else:
            assert got[k] == v, k


def test_word_vectorizer_matches_jax(tmp_path):
    glove = make_glove(str(tmp_path / "glove"))
    jv, pv = jh.WordVectorizer(glove, "our_vab"), ph.WordVectorizer(glove, "our_vab")
    assert len(pv) == len(jv)
    for token in TOKENS:
        (jw, jp), (pw, pp) = jv[token], pv[token]
        np.testing.assert_array_equal(pw, jw, err_msg=token)
        np.testing.assert_array_equal(pp, jp, err_msg=token)
    assert ph.POS_ENUMERATOR == jh.POS_ENUMERATOR and ph.VIP_DICT == jh.VIP_DICT
    with pytest.raises(FileNotFoundError):
        ph.WordVectorizer(str(tmp_path / "absent"), "our_vab")


def test_hash_vectorizer_matches_jax():
    jv, pv = jh.HashVectorizer(), ph.HashVectorizer()
    for token in TOKENS:
        (jw, jp), (pw, pp) = jv[token], pv[token]
        np.testing.assert_array_equal(pw, jw, err_msg=token)
        np.testing.assert_array_equal(pp, jp, err_msg=token)
        assert pw.dtype == jw.dtype and pp.dtype == jp.dtype


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("t2m_words")
    return {
        "one caption": ph.make_synthetic_humanml(str(root / "one"), n_clips=18, seed=2),
        "varied": vary_captions(ph.make_synthetic_humanml(str(root / "varied"), n_clips=18,
                                                          seed=4), seed=4),
        "glove": make_glove(str(root / "glove")),
    }


@pytest.mark.parametrize("vectorizer", ["hash", "glove"])
@pytest.mark.parametrize("tree", ["one caption", "varied"])
@pytest.mark.parametrize("max_text_len", [20, 6])
def test_dataset_word_fields_match_jax(trees, tree, vectorizer, max_text_len):
    """Every item of the train split twice over (the crops and caption
    choices drawing on), JAX's and the port's, with the evaluators' fields."""
    def vec(pkg):
        return pkg.HashVectorizer() if vectorizer == "hash" else pkg.WordVectorizer(
            trees["glove"], "our_vab")

    jds = jh.Text2MotionDatasetV2(trees[tree], "train", w_vectorizer=vec(jh),
                                  max_text_len=max_text_len)
    pds = ph.Text2MotionDatasetV2(trees[tree], "train", w_vectorizer=vec(ph),
                                  max_text_len=max_text_len)
    assert len(pds) == len(jds) > 0
    lens = set()
    for _ in range(2):
        for i in range(len(jds)):
            want, got = jds[i], pds[i]
            _assert_items_equal(got, want)
            assert got["word_embeddings"].shape == (max_text_len + 2, 300)
            lens.add(got["sent_len"])
    if tree == "varied":  # short captions padded with unk, long ones cut
        assert min(lens) < max_text_len + 2 == max(lens)


# ---- the evaluators ------------------------------------------------------ #
@pytest.fixture(scope="module")
def evaluators():
    """(JAX EvaluatorWrapper with threefry-drawn random weights, its params
    carried into the released finest.tar layout)."""
    with threefry():
        jw = jew.EvaluatorWrapper("humanml", dim_pose=263, seed=3)
    params = jax.tree_util.tree_map(np.asarray, jw.params)
    return jw, params, t2m_evaluator_state_dicts_from_params(params)


def _lengths(rs, b, t):
    """Ragged lengths in 1..t, the longest and the shortest among them."""
    lens = rs.randint(1, t + 1, size=b)
    lens[0], lens[-1] = t, 1
    return lens


def test_text_encoder_matches_jax(evaluators):
    jw, params, sds = evaluators
    port = pn.TextEncoderBiGRUCo().eval()
    port.load_state_dict(sds["text_encoder"])
    rs = np.random.RandomState(0)
    we = rs.randn(9, 22, 300).astype(np.float32)
    po = np.eye(15, dtype=np.float32)[rs.randint(0, 15, (9, 22))]
    lens = _lengths(rs, 9, 22)
    want = np.asarray(jn.TextEncoderBiGRUCo().apply(
        {"params": params["text"]}, jnp.asarray(we), jnp.asarray(po), jnp.asarray(lens)))
    with torch.no_grad():
        got = port(torch.from_numpy(we), torch.from_numpy(po), lens).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_motion_and_movement_encoders_match_jax(evaluators):
    jw, params, sds = evaluators
    motion, movement = pn.MotionEncoderBiGRUCo().eval(), pn.MovementConvEncoder(259).eval()
    motion.load_state_dict(sds["motion_encoder"])
    movement.load_state_dict(sds["movement_encoder"])
    rs = np.random.RandomState(1)
    x = rs.randn(7, 196, 259).astype(np.float32)
    want_mv = np.asarray(jn.MovementConvEncoder().apply({"params": params["movement"]},
                                                        jnp.asarray(x)))
    with torch.no_grad():
        got_mv = movement(torch.from_numpy(x))
    assert got_mv.shape == (7, 49, 512)
    np.testing.assert_allclose(got_mv.numpy(), want_mv, rtol=RTOL, atol=ATOL)
    lens = _lengths(rs, 7, 49)
    want = np.asarray(jn.MotionEncoderBiGRUCo().apply(
        {"params": params["motion"]}, jnp.asarray(want_mv), jnp.asarray(lens)))
    with torch.no_grad():
        got = motion(torch.from_numpy(want_mv.copy()), lens).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_bigru_directions_start_and_stop_at_the_valid_frames(evaluators, reverse):
    """Each direction's last state of the port's packed nn.GRU against JAX's
    masked_gru at ragged lengths: forward, the state at the last valid
    frame; reverse, run from the last valid frame back to the first.  The
    padding past a sample's length is noise, which a GRU over the padded
    batch would read."""
    _, params, sds = evaluators
    port = pn.MotionEncoderBiGRUCo().eval()
    port.load_state_dict(sds["motion_encoder"])
    trunk = params["motion"]["trunk"]
    rs = np.random.RandomState(2)
    x = rs.randn(6, 30, 1024).astype(np.float32)
    lens = _lengths(rs, 6, 30)
    d = "bwd" if reverse else "fwd"
    gru = {k: jnp.asarray(trunk[f"gru_{d}_{k}"]) for k in ("w_ih", "w_hh", "b_ih", "b_hh")}
    h0 = jnp.broadcast_to(jnp.asarray(trunk["hidden"][int(reverse)]), (6, 1024))
    _, want = jn.masked_gru(jnp.asarray(x), jnp.asarray(lens), h0, gru, reverse=reverse)
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        torch.from_numpy(x), torch.as_tensor(lens), batch_first=True, enforce_sorted=False)
    with torch.no_grad():
        _, last = port.gru(packed, port.hidden.repeat(1, 6, 1))
        _, padded = port.gru(torch.from_numpy(x), port.hidden.repeat(1, 6, 1))
    np.testing.assert_allclose(last[int(reverse)].numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # a GRU over the padded batch reads the padding: the short samples' states move
    short = lens < 30
    assert np.abs(padded[int(reverse)].numpy() - np.asarray(want))[short].max() > 1e-2


def test_the_released_finest_tar_layout_loads_as_it_is(evaluators, tmp_path):
    """A finest.tar of the reference's layout: the port's wrapper loads it by
    T2M_EVALUATOR_PATH and JAX's converters read the same dicts back to its
    params."""
    jw, params, sds = evaluators
    tar = str(tmp_path / "finest.tar")
    torch.save({**sds, "opt": {}, "epoch": 3}, tar)
    back = jew.EvaluatorWrapper.load_torch_checkpoint(tar)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("T2M_EVALUATOR_PATH", tar)
        wrapper = pew.EvaluatorWrapper("humanml", device="cpu")
    for key, module in zip(pew.STATE_DICT_KEYS, wrapper.modules()):
        for name, t in module.state_dict().items():
            torch.testing.assert_close(t, sds[key][name], rtol=0, atol=0, msg=name)


@pytest.fixture(scope="module")
def wrappers(evaluators):
    jw, _, sds = evaluators
    return jw, pew.EvaluatorWrapper("humanml", state_dicts=sds, device="cpu")


def _eval_batch(seed, b=12):
    """A batch with ties among the motion lengths (multiples of 4, 40..196)."""
    rs = np.random.RandomState(seed)
    m_lens = rs.choice([40, 96, 96, 148, 196, 196], size=b)
    return dict(motions=rs.randn(b, 196, 263).astype(np.float32), m_lens=m_lens,
                word_embs=rs.randn(b, 22, 300).astype(np.float32),
                pos_ohot=np.eye(15, dtype=np.float32)[rs.randint(0, 15, (b, 22))],
                cap_lens=rs.randint(3, 23, size=b))


def test_co_embeddings_match_jax_in_the_sorted_order(wrappers):
    jw, pw = wrappers
    batch = _eval_batch(5)
    want = jw.get_co_embeddings(**batch)
    got = pw.get_co_embeddings(**batch)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    # the rows follow the motions sorted by length, longest first
    order = np.argsort(batch["m_lens"])[::-1]
    alone = pw.get_motion_embeddings(batch["motions"][order[:1]], batch["m_lens"][order[:1]])
    np.testing.assert_allclose(got[1][:1], alone, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("keep_order", [False, True])
def test_motion_embeddings_match_jax(wrappers, keep_order):
    jw, pw = wrappers
    batch = _eval_batch(6)
    want = jw.get_motion_embeddings(batch["motions"], batch["m_lens"], keep_order=keep_order)
    got = pw.get_motion_embeddings(batch["motions"], batch["m_lens"], keep_order=keep_order)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if keep_order:  # row i is sample i's
        i = int(np.argmin(batch["m_lens"]))
        alone = pw.get_motion_embeddings(batch["motions"][i:i + 1], batch["m_lens"][i:i + 1])
        np.testing.assert_allclose(got[i:i + 1], alone, rtol=RTOL, atol=ATOL)
