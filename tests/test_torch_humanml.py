"""Port parity of the HumanML3D / KIT data path against the JAX package:
the synthetic tree maker (the same bytes), ``Text2MotionDatasetV2`` items
and ``TextOnlyDataset`` (equal arrays, captions and lengths, t2m and kit),
the registry and the collation of text items, ``recover_from_ric`` at 22
and 21 joints (rtol 1e-5 / atol 1e-5: float32 cumulative sums over 196
frames and sin / cos of the integrated yaw in another library), the
quaternion helpers (rtol 1e-6 / atol 1e-6), the HumanML3D masks and the
edit masks (exactly equal)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.data import humanml_utils as jax_hml_utils
from gesturediffusion_tpu.data.collate import collate_gesture as jax_collate
from gesturediffusion_tpu.data.humanml import (
    Text2MotionDatasetV2 as JaxT2M,
    TextOnlyDataset as JaxTextOnly,
    make_synthetic_humanml as jax_make,
)
from gesturediffusion_tpu.ops import motion_process as jax_mp
from gesturediffusion_tpu.ops import quaternion as jax_quat
from gesturediffusion_tpu.sample.edit import build_edit_masks as jax_masks
from gesturediffusion_tpu_torch.data import humanml_utils
from gesturediffusion_tpu_torch.data.collate import collate_gesture, device_cond
from gesturediffusion_tpu_torch.data.humanml import (
    Text2MotionDatasetV2,
    TextOnlyDataset,
    make_synthetic_humanml,
)
from gesturediffusion_tpu_torch.data.registry import get_dataset
from gesturediffusion_tpu_torch.ops import motion_process, quaternion
from gesturediffusion_tpu_torch.sample.edit import build_edit_masks

DIMS = {"t2m": 263, "kit": 251}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{name: (port tree, JAX tree)} written by both makers, 12 clips."""
    root = tmp_path_factory.mktemp("hml")
    return {name: (make_synthetic_humanml(str(root / f"port_{name}"), n_clips=12, dim=dim,
                                          seed=3),
                   jax_make(str(root / f"jax_{name}"), n_clips=12, dim=dim, seed=3))
            for name, dim in DIMS.items()}


def _tree_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("name", list(DIMS))
def test_maker_writes_the_same_bytes(trees, name):
    port, jax = trees[name]
    got, want = _tree_bytes(port), _tree_bytes(jax)
    assert sorted(got) == sorted(want)
    assert len(got) == 2 * 12 + 2 + 3
    for rel in want:
        assert got[rel] == want[rel], rel


@pytest.mark.parametrize("name,split", [("t2m", "test"), ("t2m", "train"), ("kit", "test")])
def test_text2motion_items_equal_jax(trees, name, split):
    """The same crops from the same random.Random(0) sequence, item by item
    (read twice, so the draws run on)."""
    root = trees[name][0]
    got = Text2MotionDatasetV2(root, split=split, dataset_name=name)
    want = JaxT2M(root, split=split, dataset_name=name)
    assert len(got) == len(want) > 0
    assert got.name_list == want.name_list
    np.testing.assert_array_equal(got.length_arr, want.length_arr)
    assert got.pose_dim == DIMS[name]
    for i in list(range(len(want))) * 2:
        a, b = got[i], want[i]
        assert sorted(a) == sorted(b) == ["length", "motion", "text"]
        assert a["text"] == b["text"] and a["length"] == b["length"]
        np.testing.assert_array_equal(a["motion"], b["motion"])
    x = np.random.RandomState(0).randn(2, 196, DIMS[name]).astype(np.float32)
    np.testing.assert_array_equal(got.inv_transform(x), want.inv_transform(x))


def test_text_only_dataset_equals_jax(trees):
    root = trees["t2m"][0]
    got, want = TextOnlyDataset(root, split="test"), JaxTextOnly(root, split="test")
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        a, b = got[i], want[i]
        assert (a["text"], a["length"]) == (b["text"], b["length"])
        np.testing.assert_array_equal(a["motion"], b["motion"])


@pytest.mark.parametrize("name", ["humanml", "kit"])
def test_registry_and_collate_take_the_text_datasets(trees, name):
    """The registry builds the text dataset; a batch of its items collates
    as JAX's collate does, captions staying on the host."""
    root = trees["t2m" if name == "humanml" else "kit"][0]
    ds = get_dataset(name, 120, split="test", datapath=root)
    assert isinstance(ds, Text2MotionDatasetV2)
    assert ds.dataset_name == ("t2m" if name == "humanml" else "kit")
    items = [ds[i] for i in range(len(ds))]
    motion, cond = collate_gesture(items, max_frames=196)
    want_motion, want = jax_collate(items, max_frames=196)
    np.testing.assert_array_equal(motion, want_motion)
    assert sorted(cond) == sorted(want) == ["lengths", "mask", "text"]
    assert cond["text"] == want["text"] == [it["text"] for it in items]
    for k in ("lengths", "mask"):
        np.testing.assert_array_equal(cond[k], want[k])
    assert sorted(device_cond(cond)) == ["lengths", "mask"]


@pytest.mark.parametrize("joints", [22, 21])
def test_recover_from_ric_matches_jax(joints):
    rs = np.random.RandomState(joints)
    dim = 12 * joints - 1
    data = (np.cumsum(rs.randn(2, 196, dim) * 0.05, axis=1)).astype(np.float32)
    data[..., 0] = rs.randn(2, 196) * 0.1  # yaw velocity of a few degrees a frame
    want = np.asarray(jax_mp.recover_from_ric(jnp.asarray(data), joints))
    got = motion_process.recover_from_ric(torch.from_numpy(data), joints).numpy()
    assert got.shape == want.shape == (2, 196, joints, 3)
    assert motion_process.joints_of_features(dim) == joints
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    want_q, want_p = jax_mp.recover_root_rot_pos(jnp.asarray(data))
    got_q, got_p = motion_process.recover_root_rot_pos(torch.from_numpy(data))
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-5, atol=1e-5)


def test_quaternion_helpers_match_jax():
    rs = np.random.RandomState(0)
    q = rs.randn(5, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    r = rs.randn(5, 4).astype(np.float32)
    v = rs.randn(3, 5, 3).astype(np.float32)  # broadcast over a leading axis
    tq, tr, tv = map(torch.from_numpy, (q, r, v))
    for got, want in ((quaternion.qinv(tq), jax_quat.qinv(jnp.asarray(q))),
                      (quaternion.qmul(tq, tr), jax_quat.qmul(jnp.asarray(q), jnp.asarray(r))),
                      (quaternion.qrot(tq, tv), jax_quat.qrot(jnp.asarray(q), jnp.asarray(v)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["HML_ROOT_MASK", "HML_LOWER_BODY_MASK", "HML_UPPER_BODY_MASK",
                                  "HML_LOWER_BODY_JOINTS", "SMPL_UPPER_BODY_JOINTS",
                                  "HML_JOINT_NAMES"])
def test_humanml_masks_equal_jax(name):
    got, want = getattr(humanml_utils, name), getattr(jax_hml_utils, name)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    if name.endswith("MASK"):
        assert np.asarray(got).shape == (263,)


@pytest.mark.parametrize("mode,dim,kw", [
    ("in_between", 263, {}),
    ("in_between", 24, {"prefix_end": 0.1, "suffix_start": 0.5}),
    ("upper_body", 263, {}),
    ("upper_body", 24, {"feature_mask": np.arange(24) % 3 == 0}),
])
def test_build_edit_masks_equal_jax(mode, dim, kw):
    motion = np.zeros((3, dim, 1, 196), np.float32)
    lengths = np.array([196, 120, 61])
    got = build_edit_masks(mode, motion, lengths, **kw)
    np.testing.assert_array_equal(got, jax_masks(mode, motion, lengths, **kw))
    assert got.dtype == bool and got.shape == motion.shape


def test_upper_body_refuses_a_non_humanml_width():
    with pytest.raises(ValueError, match="263-dim codec"):
        build_edit_masks("upper_body", np.zeros((1, 251, 1, 8)), np.array([8]))
