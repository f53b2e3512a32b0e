"""Port parity of the three HumanML3D datasets the evaluator retraining and
the CompV6 baseline read, against the JAX package on the CPU:
``MotionDatasetV2`` (every window of a split), ``Text2MotionDatasetBaseline``
(the text item with ``src_motion`` at ``max_length``, crops drawn from the
same ``random.Random(0)`` in the same order, with and without word
vectors, at max_length 20 and 96) and ``RawTextDataset`` (the OTHER tags
without spacy, with and without word vectors).  Every field exactly equal,
dtypes included."""

import sys

import numpy as np
import pytest

from gesturediffusion_tpu.data import humanml as jh
from gesturediffusion_tpu_torch.data import humanml as ph


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return ph.make_synthetic_humanml(str(tmp_path_factory.mktemp("hml_ds")), n_clips=15, seed=5)


def _assert_items_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
            assert got[k].dtype == v.dtype, k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("window", [40, 64])
def test_motion_dataset_v2_equals_jax(tree, window):
    want = jh.MotionDatasetV2(tree, split="train", window_size=window)
    got = ph.MotionDatasetV2(tree, split="train", window_size=window)
    assert len(got) == len(want) > 0
    for i in sorted({0, 1, len(want) // 2, len(want) - 1}):
        _assert_items_equal(got[i], want[i])
    np.testing.assert_array_equal(got.inv_transform(got[3]["motion"]),
                                  want.inv_transform(want[3]["motion"]))


@pytest.mark.parametrize("words", [False, True], ids=["no-vectors", "hash-vectors"])
@pytest.mark.parametrize("max_length", [20, 96])
def test_text2motion_baseline_items_equal_jax(tree, words, max_length):
    kw = {"w_vectorizer": ph.HashVectorizer()} if words else {}
    jkw = {"w_vectorizer": jh.HashVectorizer()} if words else {}
    want = jh.Text2MotionDatasetBaseline(tree, split="train", **jkw)
    got = ph.Text2MotionDatasetBaseline(tree, split="train", **kw)
    want.reset_max_len(max_length)
    got.reset_max_len(max_length)
    assert len(got) == len(want) > 0
    for i in list(range(len(want))) * 2:  # twice: the crops keep drawing alike
        g, w = got[i], want[i]
        _assert_items_equal(g, w)
        assert g["src_motion"].shape == (max_length, 263)


@pytest.mark.parametrize("words", [False, True], ids=["no-vectors", "hash-vectors"])
def test_raw_text_dataset_equals_jax(tmp_path, monkeypatch, words):
    monkeypatch.setitem(sys.modules, "spacy", None)  # the OTHER tags, as on the card's machine
    path = tmp_path / "prompts.txt"
    path.write_text("A person walks forward.\n\n  the man jumps up-and-down twice\n"
                    + " ".join(["wave"] * 25) + "\n")
    with pytest.warns(UserWarning, match="spacy"):
        want = jh.RawTextDataset(str(path), w_vectorizer=jh.HashVectorizer() if words else None)
    with pytest.warns(UserWarning, match="spacy"):
        got = ph.RawTextDataset(str(path), w_vectorizer=ph.HashVectorizer() if words else None)
    assert len(got) == len(want) == 3
    for i in range(3):
        _assert_items_equal(got[i], want[i])
    assert got[0]["tokens"] == "a/OTHER_person/OTHER_walks/OTHER_forward./OTHER"
