"""Port parity of the action-to-motion data path against the JAX package
on the CPU: make_synthetic_humanact12 / make_synthetic_uestc trees,
HumanAct12Poses and UESTC items (every pose representation and frame
sampling mode, the same random.Random draws), the splits and the side-2
view correction, A2MSplitView, collate_a2m, and the registry's loaders.
Host-side numpy in both packages, so everything is held exactly.
"""

import os
import pickle

import numpy as np
import pytest

from gesturediffusion_tpu.data import a2m as ja2m
from gesturediffusion_tpu.data import uestc as juestc
from gesturediffusion_tpu.data.registry import get_dataset_loader as jax_loader
from gesturediffusion_tpu_torch.data import a2m as pa2m
from gesturediffusion_tpu_torch.data import uestc as puestc
from gesturediffusion_tpu_torch.data.registry import (
    get_dataset,
    get_dataset_class,
    get_dataset_loader,
)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("a2m")
    return {
        "ha12": pa2m.make_synthetic_humanact12(str(root / "ha12"), n_clips=24, seed=1),
        "ha12_jax": ja2m.make_synthetic_humanact12(str(root / "ha12_jax"), n_clips=24, seed=1),
        "uestc": puestc.make_synthetic_uestc(str(root / "uestc"), n_videos=24, n_actions=6,
                                             seed=2, min_frames=50, max_frames=90),
        "uestc_jax": juestc.make_synthetic_uestc(str(root / "uestc_jax"), n_videos=24,
                                                 n_actions=6, seed=2, min_frames=50,
                                                 max_frames=90),
    }


def _same_tree(a, b):
    for dirpath, _, files in os.walk(a):
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name), a)
            with open(os.path.join(a, rel), "rb") as fa, open(os.path.join(b, rel), "rb") as fb:
                assert fa.read() == fb.read(), rel


def test_makers_write_the_jax_trees(trees):
    _same_tree(trees["ha12"], trees["ha12_jax"])
    _same_tree(trees["uestc_jax"], trees["uestc"])


def _assert_items_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("pose_rep", ["rot6d", "rotvec", "rotmat", "rotquat", "xyz"])
@pytest.mark.parametrize("sampling,num_frames", [("conseq", 60), ("random_conseq", 30),
                                                 ("random", 20), ("conseq", 120),
                                                 ("conseq", -1)])
def test_humanact12_items_equal_jax(trees, pose_rep, sampling, num_frames):
    kw = dict(datapath=trees["ha12"], num_frames=num_frames, sampling=sampling,
              pose_rep=pose_rep, translation=pose_rep != "rotquat", glob=pose_rep != "rotvec")
    got, want = pa2m.HumanAct12Poses(**kw), ja2m.HumanAct12Poses(**kw)
    assert len(got) == len(want) == 24
    for i in range(len(want)):
        _assert_items_equal(got[i], want[i])


def test_frame_sampling_draws_as_jax(trees):
    """num_frames -2 (a random length between min_len and max_len) draws
    the length, the step and the shift from the dataset's random.Random in
    JAX's order; shuffle and reset_shuffle follow it too."""
    kw = dict(datapath=trees["ha12"], num_frames=-2, min_len=20, max_len=70,
              sampling="random_conseq")
    got, want = pa2m.HumanAct12Poses(**kw), ja2m.HumanAct12Poses(**kw)
    for ds in (got, want):
        ds.reset_shuffle()
        ds.shuffle()
    assert got._train == want._train
    for _ in range(2):
        for i in range(len(want)):
            _assert_items_equal(got[i], want[i])
    for ds in (got, want):
        ds.reset_shuffle()
    assert got._train == want._train == list(range(24))
    with pytest.raises(ValueError):
        pa2m.HumanAct12Poses(datapath=trees["ha12"], sampling="bogus", num_frames=20)[0]


def test_split_views_and_labels_equal_jax(trees):
    base_p = pa2m.HumanAct12Poses(datapath=trees["ha12"], num_frames=40)
    base_j = ja2m.HumanAct12Poses(datapath=trees["ha12"], num_frames=40)
    for split in ("train", "test"):
        vp, vj = pa2m.A2MSplitView(base_p, split, seed=3), ja2m.A2MSplitView(base_j, split, seed=3)
        vp.shuffle()
        vj.shuffle()
        assert vp._indices == vj._indices and len(vp) == len(vj)
        _assert_items_equal(vp[0], vj[0])
        vp.reset_shuffle()
        assert vp._indices == vp._original
    assert base_p.action_to_action_name(3) == base_j.action_to_action_name(3) == "jump"
    assert base_p.label_to_action(np.eye(12)[5]) == base_j.label_to_action(np.eye(12)[5]) == 5
    names = ["run", "throw", "walk"]
    np.testing.assert_array_equal(base_p.action_name_to_action(names),
                                  base_j.action_name_to_action(names))
    with pytest.raises(ValueError):
        pa2m.A2MSplitView(base_p, "val")


@pytest.mark.parametrize("num_frames,view", [(60, "all"), (40, "frontview"), (-1, "all")])
def test_uestc_items_and_splits_equal_jax(trees, num_frames, view):
    got = puestc.UESTC(datapath=trees["uestc"], num_frames=num_frames, view=view)
    want = juestc.UESTC(datapath=trees["uestc_jax"], num_frames=num_frames, view=view)
    assert got._train == want._train and got._test == want._test
    assert got.video_info == want.video_info and got.num_actions == want.num_actions == 40
    assert got._train and got._test
    for split in ("train", "test"):
        got.split = want.split = split
        assert len(got) == len(want)
        for i in range(len(want)):
            _assert_items_equal(got[i], want[i])
    # the global-translation cache each package wrote
    with open(os.path.join(trees["uestc"], "globtrans_usez.pkl"), "rb") as f:
        gp = pickle.load(f)
    with open(os.path.join(trees["uestc_jax"], "globtrans_usez.pkl"), "rb") as f:
        gj = pickle.load(f)
    for a, b in zip(gp, gj):
        np.testing.assert_array_equal(a, b)


def test_uestc_geometry_helpers_equal_jax():
    cam = np.random.RandomState(4).uniform(0.5, 1.5, (9, 4))
    for use_depth in (True, False):
        np.testing.assert_array_equal(puestc.vibe_global_translation(cam, use_depth),
                                      juestc.vibe_global_translation(cam, use_depth))
    for view in range(8):
        np.testing.assert_array_equal(puestc.yaw_matrix(view), juestc.yaw_matrix(view))
    rec = "a12_d3_p045_c2_color.avi"
    assert puestc.VideoRecord.from_name(rec) == juestc.VideoRecord.from_name(rec) == (12, 3, 45, 2)


def test_collate_a2m_equals_jax(trees):
    ds = pa2m.HumanAct12Poses(datapath=trees["ha12"], num_frames=-1)
    items = [ds[i] for i in range(5)]
    for max_frames in (None, 60):
        gm, gc = pa2m.collate_a2m(items, max_frames)
        wm, wc = ja2m.collate_a2m(items, max_frames)
        np.testing.assert_array_equal(gm, wm)
        assert set(gc) == set(wc) == {"mask", "lengths", "action", "action_text"}
        for k in ("mask", "lengths", "action"):
            assert gc[k].dtype == wc[k].dtype
            np.testing.assert_array_equal(gc[k], wc[k], err_msg=k)
        assert gc["action_text"] == wc["action_text"]
        assert gm.shape[:3] == (5, 25, 6) and gc["mask"].shape == (5, 1, 1, gm.shape[-1])


@pytest.mark.parametrize("name", ["humanact12", "uestc"])
def test_registry_loads_the_action_datasets_as_jax(trees, name):
    assert get_dataset_class(name).__name__ == {"humanact12": "HumanAct12Poses",
                                                "uestc": "UESTC"}[name]
    root = trees["ha12" if name == "humanact12" else "uestc"]
    assert get_dataset(name, 60, datapath=root).num_frames == 60
    kw = dict(batch_size=4, num_frames=60, split="train", datapath=root, num_workers=1, seed=5)
    got_it, want_it = iter(get_dataset_loader(name, **kw)), iter(jax_loader(name, **kw))
    for _ in range(2):
        (gm, gc), (wm, wc) = next(got_it), next(want_it)
        assert gm.shape == (4, 25, 6, 60)
        np.testing.assert_array_equal(gm, wm)
        for k in ("mask", "lengths", "action"):
            np.testing.assert_array_equal(gc[k], wc[k], err_msg=k)
        assert gc["action_text"] == wc["action_text"]
