"""Port parity of the BVH reader and writer (gesturediffusion_tpu_torch/viz/bvh.py)
against the JAX package's viz/bvh.py: the files written for the same arrays
are the same bytes, and a JAX-written file reads back to the arrays it was
written from (to the 6 decimals the format stores: atol 5e-7)."""

import numpy as np
import pytest

from gesturediffusion_tpu.viz import bvh as jax_bvh
from gesturediffusion_tpu_torch.viz import bvh

T, J = 12, 5


def _motion(seed):
    rs = np.random.RandomState(seed)
    return rs.uniform(-180, 180, (T, J, 3)), rs.randn(T, 3) * 10


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_default_skeleton_export_is_byte_identical(tmp_path):
    rot, root = _motion(0)
    bvh.export_gesture_bvh(str(tmp_path / "port.bvh"), rot, root, fps=30)
    jax_bvh.export_gesture_bvh(str(tmp_path / "jax.bvh"), rot, root, fps=30)
    assert _bytes(tmp_path / "port.bvh") == _bytes(tmp_path / "jax.bvh")


def test_reference_skeleton_export_is_byte_identical(tmp_path):
    """A JAX-written file as the reference skeleton (read back by each
    package, motion skipped), then a new take written onto it."""
    rot, root = _motion(1)
    ref_path = str(tmp_path / "reference.bvh")
    sk = jax_bvh.make_default_skeleton(J + 1)
    for k, joint in enumerate(sk.joints):
        joint.offset = np.array([k, 0.5 * k, -k], np.float64)
    sk.joints[-1].is_end_site = True
    sk.joints[-1].channels = []
    sk.frames = T
    jax_bvh.export_gesture_bvh(ref_path, rot, root, reference=sk, fps=30)
    rot2, root2 = _motion(2)
    bvh.export_gesture_bvh(str(tmp_path / "port.bvh"), rot2, root2,
                           reference=bvh.read_bvh(ref_path, skip_motion=True), fps=20)
    jax_bvh.export_gesture_bvh(str(tmp_path / "jax.bvh"), rot2, root2,
                               reference=jax_bvh.read_bvh(ref_path, skip_motion=True), fps=20)
    assert _bytes(tmp_path / "port.bvh") == _bytes(tmp_path / "jax.bvh")


def test_write_bvh_is_byte_identical(tmp_path):
    rot, root = _motion(3)
    paths = {}
    for name, mod in (("port", bvh), ("jax", jax_bvh)):
        sk = mod.make_default_skeleton(J)
        sk.frames = T
        for k, joint in enumerate(sk.joints):
            joint.rotation = rot[:, k]
        sk.root.translation = root
        paths[name] = str(tmp_path / f"{name}.bvh")
        mod.write_bvh(sk, paths[name], frame_time=0.04)
    assert _bytes(paths["port"]) == _bytes(paths["jax"])


def test_read_bvh_round_trips_a_jax_file(tmp_path):
    rot, root = _motion(4)
    path = str(tmp_path / "jax.bvh")
    jax_bvh.export_gesture_bvh(path, rot, root, fps=30)
    sk = bvh.read_bvh(path)
    assert sk.frames == T and sk.frame_time == pytest.approx(1 / 30)
    assert [j.name for j in sk.list_of_joints()] == [f"joint_{k}" for k in range(J)]
    for k, joint in enumerate(sk.list_of_joints()):
        np.testing.assert_allclose(joint.rotation, rot[:, k], rtol=0, atol=5e-7)
    np.testing.assert_allclose(sk.root.translation, root, rtol=0, atol=5e-7)


def test_read_bvh_refuses_a_malformed_file(tmp_path):
    path = tmp_path / "bad.bvh"
    path.write_text("MOTION\nFrames: 1\n")
    with pytest.raises(ValueError, match="HIERARCHY"):
        bvh.read_bvh(str(path))
