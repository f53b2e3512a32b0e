"""Port parity of the skeleton codec against the JAX package on the CPU:
the quaternion toolbox (ops/quaternion.py), the kinematic-chain skeleton's
FK and IK (ops/skeleton.py), ``recover_from_rot`` / ``recover_rot``
(ops/motion_process.py) and HumanML3D's forward codec ``process_file``
(ops/motion_features.py) on a synthetic 22-joint sequence, with its round
trip through ``recover_from_ric``.  Inputs are numpy draws from a seed.
Tolerances: float32 closed forms and chains atol 1e-5 (ATOL); the Euler
angles in degrees 1e-3 (ATOL_DEG, 1e-5 rad); the host-numpy codec in
float64 is the same code, 1e-10 (ATOL_F64); the round trip 1e-4, as the
JAX package's own test holds it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.ops import motion_features as jmf
from gesturediffusion_tpu.ops import motion_process as jmp
from gesturediffusion_tpu.ops import quaternion as jq
from gesturediffusion_tpu.ops import skeleton as jsk
from gesturediffusion_tpu.utils import paramutil as jpu
from gesturediffusion_tpu_torch.ops import motion_features as pmf
from gesturediffusion_tpu_torch.ops import motion_process as pmp
from gesturediffusion_tpu_torch.ops import quaternion as pq
from gesturediffusion_tpu_torch.ops import skeleton as psk
from gesturediffusion_tpu_torch.ops.quaternion_np import qmul_np, qrot_np
from gesturediffusion_tpu_torch.ops.rotations_np import axis_angle_to_quaternion_np
from gesturediffusion_tpu_torch.utils import paramutil as ppu

ATOL = 1e-5
ATOL_DEG = 1e-3
ATOL_F64 = 1e-10


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=0, atol=atol)


def _unit_quats(shape, seed):
    q = np.random.RandomState(seed).randn(*shape, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_paramutil_is_the_jax_tables():
    for name in ("kit_kinematic_chain", "t2m_kinematic_chain", "t2m_left_hand_chain",
                 "t2m_right_hand_chain", "genea2022_kinematic_chain", "kit_tgt_skel_id",
                 "t2m_tgt_skel_id"):
        assert getattr(ppu, name) == getattr(jpu, name), name
    for name in ("kit_raw_offsets", "t2m_raw_offsets"):
        np.testing.assert_array_equal(getattr(ppu, name), getattr(jpu, name))


@pytest.mark.parametrize("order", ["xyz", "yzx", "zxy", "xzy", "yxz", "zyx"])
def test_euler_round_trips_match_jax(order):
    """qeuler and euler_to_quaternion (radians and degrees) in each order."""
    q = _unit_quats((5, 3), 0)
    _close(pq.qeuler(torch.from_numpy(q), order), jq.qeuler(jnp.asarray(q), order), ATOL_DEG)
    _close(pq.qeuler(torch.from_numpy(q), order, epsilon=1e-6, deg=False),
           jq.qeuler(jnp.asarray(q), order, epsilon=1e-6, deg=False))
    e = np.random.RandomState(1).uniform(-2, 2, (5, 3)).astype(np.float32)
    _close(pq.euler_to_quaternion(torch.from_numpy(e), order),
           jq.euler_to_quaternion(jnp.asarray(e), order))
    _close(pq.euler_to_quaternion(torch.from_numpy(e * 50), order, deg=True),
           jq.euler_to_quaternion(jnp.asarray(e * 50), order, deg=True))
    with pytest.raises(ValueError):
        pq.qeuler(torch.from_numpy(q), "xxy")


def test_quaternion_toolbox_matches_jax():
    """qnormalize, qfix, expmap, the matrix and cont6d forms, qpow, qslerp,
    qbetween and lerp on the same draws."""
    rs = np.random.RandomState(2)
    q = _unit_quats((6, 4), 3)
    q_raw = rs.randn(6, 4, 4).astype(np.float32)
    _close(pq.qnormalize(torch.from_numpy(q_raw)), jq.qnormalize(jnp.asarray(q_raw)))
    # sign flips along time, so that qfix has work to do
    flips = np.where(rs.rand(6, 4, 1) < 0.5, -1.0, 1.0).astype(np.float32)
    _close(pq.qfix(torch.from_numpy(q * flips)), jq.qfix(jnp.asarray(q * flips)))
    e = rs.randn(7, 3).astype(np.float32)
    e[0] = 0.0  # the zero rotation through sinc
    _close(pq.expmap_to_quaternion(torch.from_numpy(e)), jq.expmap_to_quaternion(jnp.asarray(e)))
    _close(pq.quaternion_to_matrix(torch.from_numpy(q)), jq.quaternion_to_matrix(jnp.asarray(q)))
    c6 = pq.quaternion_to_cont6d(torch.from_numpy(q))
    _close(c6, jq.quaternion_to_cont6d(jnp.asarray(q)))
    raw6 = rs.randn(6, 4, 6).astype(np.float32)
    _close(pq.cont6d_to_matrix(torch.from_numpy(raw6)), jq.cont6d_to_matrix(jnp.asarray(raw6)))
    _close(pq.cont6d_to_matrix(c6), pq.quaternion_to_matrix(torch.from_numpy(q)))
    t = np.linspace(0, 1, 5).astype(np.float32)
    _close(pq.qpow(torch.from_numpy(q[0]), torch.from_numpy(t)),
           jq.qpow(jnp.asarray(q[0]), jnp.asarray(t)))
    q1 = _unit_quats((4,), 4)
    _close(pq.qslerp(torch.from_numpy(q[0]), torch.from_numpy(q1), torch.from_numpy(t)),
           jq.qslerp(jnp.asarray(q[0]), jnp.asarray(q1), jnp.asarray(t)))
    v0, v1 = rs.randn(2, 8, 3).astype(np.float32)
    _close(pq.qbetween(torch.from_numpy(v0), torch.from_numpy(v1)),
           jq.qbetween(jnp.asarray(v0), jnp.asarray(v1)))
    _close(pq.lerp(torch.from_numpy(v0), torch.from_numpy(v1), torch.from_numpy(t)),
           jq.lerp(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(t)))


def _skeletons():
    chains = tuple(tuple(c) for c in jpu.t2m_kinematic_chain)
    return (jsk.Skeleton(jpu.t2m_raw_offsets, chains),
            psk.Skeleton(ppu.t2m_raw_offsets, chains))


@pytest.mark.parametrize("do_root_R", [True, False])
def test_forward_kinematics_match_jax(do_root_R):
    """Both FK forms from quaternions and from cont6d, with shared and with
    per-sample offsets, and the bone-length offsets of one pose."""
    jskel, pskel = _skeletons()
    assert pskel.parents == jskel.parents == jsk.parents_from_chains(22, jskel.kinematic_tree)
    rs = np.random.RandomState(5)
    q = _unit_quats((4, 22), 6)
    root = rs.randn(4, 3).astype(np.float32)
    offsets = (ppu.t2m_raw_offsets * 0.3).astype(np.float32)
    per_sample = (offsets[None] * rs.uniform(0.8, 1.2, (4, 22, 1))).astype(np.float32)
    for off in (offsets, per_sample):
        _close(pskel.forward_kinematics(torch.from_numpy(q), torch.from_numpy(root),
                                        torch.from_numpy(off), do_root_R=do_root_R),
               jskel.forward_kinematics(jnp.asarray(q), jnp.asarray(root), jnp.asarray(off),
                                        do_root_R=do_root_R))
    c6 = rs.randn(4, 22, 6).astype(np.float32)
    _close(pskel.forward_kinematics_cont6d(torch.from_numpy(c6), torch.from_numpy(root),
                                           torch.from_numpy(offsets), do_root_R=do_root_R),
           jskel.forward_kinematics_cont6d(jnp.asarray(c6), jnp.asarray(root),
                                           jnp.asarray(offsets), do_root_R=do_root_R))
    joints = rs.randn(22, 3).astype(np.float32)
    _close(pskel.get_offsets_joints(joints), jskel.get_offsets_joints(joints))


def synthetic_t2m_joints(t=24, seed=0):
    """A plausible 22-joint motion [T, 22, 3] by FK of the t2m skeleton:
    bones of ~0.3, small per-frame rotations, the hips at 0.9."""
    rs = np.random.RandomState(seed)
    offsets = ppu.t2m_raw_offsets.astype(np.float64) * 0.3
    aa = rs.randn(t, 22, 3) * 0.08
    aa[:, 0] = 0
    quats = axis_angle_to_quaternion_np(aa)
    root_pos = np.cumsum(rs.randn(t, 3) * 0.01, axis=0)
    root_pos[:, 1] += 0.9
    joints = np.zeros((t, 22, 3))
    joints[:, 0] = root_pos
    for chain in ppu.t2m_kinematic_chain:
        R = quats[:, 0]
        for i in range(1, len(chain)):
            R = qmul_np(R, quats[:, chain[i]])
            joints[:, chain[i]] = qrot_np(R, np.tile(offsets[chain[i]], (t, 1))) \
                + joints[:, chain[i - 1]]
    return joints, offsets


@pytest.mark.parametrize("smooth_forward", [False, True])
def test_inverse_kinematics_match_jax(smooth_forward):
    jskel, pskel = _skeletons()
    joints, _ = synthetic_t2m_joints(t=12, seed=1)
    _close(pskel.inverse_kinematics_np(joints, pmf.T2M_FACE_JOINTS, smooth_forward),
           jskel.inverse_kinematics_np(joints, jmf.T2M_FACE_JOINTS, smooth_forward), ATOL_F64)
    with pytest.raises(ValueError):
        pskel.inverse_kinematics_np(joints, (2, 1, 17))


def test_process_file_matches_jax_and_round_trips():
    """The 263 features, global and rifke positions and the root velocity
    of both packages' codecs; the port's features decode back to the
    aligned global positions through its recover_from_ric."""
    joints, offsets = synthetic_t2m_joints(t=24, seed=3)
    want = jmf.process_file(joints.copy(), 0.002, offsets)
    got = pmf.process_file(joints.copy(), 0.002, offsets)
    assert got[0].shape == (23, 263)
    for g, w in zip(got, want):
        _close(g, w, ATOL_F64)
    assert set(np.unique(got[0][:, -4:])) <= {0.0, 1.0}
    _close(pmf.uniform_skeleton(joints.copy(), offsets, psk.Skeleton(
               ppu.t2m_raw_offsets, ppu.t2m_kinematic_chain)),
           jmf.uniform_skeleton(joints.copy(), offsets, jsk.Skeleton(
               jpu.t2m_raw_offsets, tuple(tuple(c) for c in jpu.t2m_kinematic_chain))),
           ATOL_F64)
    recovered = pmp.recover_from_ric(torch.as_tensor(got[0], dtype=torch.float32), 22).numpy()
    np.testing.assert_allclose(recovered, got[1][:-1], atol=1e-4)


def test_recover_from_rot_and_recover_rot_match_jax():
    """Rotation features -> joints through cont6d FK, and -> the per-joint
    cont6d rows with the padded translation row, at HumanML3D's 263 and
    KIT's 251 features."""
    joints, offsets = synthetic_t2m_joints(t=16, seed=4)
    feats = pmf.process_file(joints, 0.002, offsets)[0].astype(np.float32)  # [15, 263]
    batch = np.stack([feats, feats[::-1].copy()])  # [2, 15, 263]
    jskel, pskel = _skeletons()
    off = offsets.astype(np.float32)
    _close(pmp.recover_from_rot(torch.from_numpy(batch), 22, pskel, torch.from_numpy(off)),
           jmp.recover_from_rot(jnp.asarray(batch), 22, jskel, jnp.asarray(off)))
    kit = np.random.RandomState(5).randn(2, 15, 251).astype(np.float32) * 0.3
    for data in (batch, kit):
        got = pmp.recover_rot(torch.from_numpy(data))
        assert got.shape == data.shape[:-1] + ((22 if data.shape[-1] == 263 else 21) + 1, 6)
        _close(got, jmp.recover_rot(jnp.asarray(data)))
