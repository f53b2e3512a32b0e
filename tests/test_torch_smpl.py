"""Port parity of the SMPL body model and rotation2xyz against the JAX
package on the CPU, on a synthetic model of 128 vertices with the extra
regressor (so that every joint set exists): lbs and each joint set at atol
1e-5 (float32; the rest joints regressed in another order), the pickles
(the official layout, chumpy arrays, the synthetic extras) read alike by
both packages, the joints-only path equal to the full path bit for bit,
and rotation2xyz for every pose representation and joint set.
"""

import pickle
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.models import rotation2xyz as jr2x
from gesturediffusion_tpu.models import smpl as js
from gesturediffusion_tpu.ops import rotations as jrot
from gesturediffusion_tpu_torch.models import rotation2xyz as pr2x
from gesturediffusion_tpu_torch.models import smpl as ps

ATOL = 1e-5
NV = 128


@pytest.fixture(scope="module")
def models():
    return js.make_synthetic_smpl(NV), ps.make_synthetic_smpl(NV)


def _pose(b=6, seed=0):
    """Rotation matrices [B, 24, 3, 3] from random 6D rows, betas, transl."""
    rs = np.random.RandomState(seed)
    d6 = rs.randn(b, 24, 6).astype(np.float32)
    mats = np.array(jrot.rotation_6d_to_matrix(jnp.asarray(d6)))
    return mats, rs.randn(b, 10).astype(np.float32) * 0.5, rs.randn(b, 3).astype(np.float32)


def test_synthetic_tables_equal_jax(models):
    jm, pm = models
    for name in ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights",
                 "j_regressor_extra"):
        np.testing.assert_array_equal(getattr(pm, name).numpy(), np.asarray(getattr(jm, name)),
                                      err_msg=name)
    assert pm.parents == jm.parents and pm.vertex_joint_ids == jm.vertex_joint_ids


def test_lbs_matches_jax(models):
    jm, pm = models
    mats, betas, transl = _pose()
    for tr in (None, transl):
        jv, jj = jm.lbs(jnp.asarray(betas), jnp.asarray(mats),
                        None if tr is None else jnp.asarray(tr))
        pv, pj = pm.lbs(torch.from_numpy(betas), torch.from_numpy(mats),
                        None if tr is None else torch.from_numpy(tr))
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=0, atol=ATOL)
        np.testing.assert_allclose(pj.numpy(), np.asarray(jj), rtol=0, atol=ATOL)


def test_every_joint_set_matches_jax(models):
    jm, pm = models
    mats, betas, transl = _pose(seed=1)
    want = jm(jnp.asarray(mats[:, 1:]), jnp.asarray(mats[:, 0]), jnp.asarray(betas),
              jnp.asarray(transl))
    got = pm(torch.from_numpy(mats[:, 1:]), torch.from_numpy(mats[:, 0]),
             torch.from_numpy(betas), torch.from_numpy(transl))
    assert set(got) == set(want) == {"vertices", "smpl", "vibe", "a2m", "a2mpl"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=ATOL,
                                   err_msg=k)


def test_joints_only_path_equals_the_full_path_exactly(models):
    _, pm = models
    mats, betas, transl = _pose(seed=2)
    args = (torch.from_numpy(mats[:, 1:]), torch.from_numpy(mats[:, 0]),
            torch.from_numpy(betas), torch.from_numpy(transl))
    full = pm(*args)
    only = pm(*args, sets=("smpl",))
    assert set(only) == {"smpl"}
    assert torch.equal(only["smpl"], full["smpl"])
    assert set(pm(*args, sets=("a2m",))) == set(full)  # a vertex set computes them all


def _official_pickle(path, extras: bool, chumpy: bool):
    """A JAX-written synthetic pickle, optionally without the synthetic
    extras and with its arrays wrapped as chumpy objects."""
    js.save_synthetic_smpl_pickle(str(path), n_vertices=NV, seed=3)
    if not extras or chumpy:
        with open(path, "rb") as f:
            data = pickle.load(f)
        if not extras:
            data.pop("vertex_joint_ids")
            data.pop("J_regressor_extra")
        if chumpy:
            mod = types.ModuleType("chumpy.ch")

            class Ch:
                pass

            Ch.__module__, Ch.__qualname__ = "chumpy.ch", "Ch"
            mod.Ch = Ch
            saved = {k: sys.modules.get(k) for k in ("chumpy", "chumpy.ch")}
            sys.modules["chumpy"] = types.ModuleType("chumpy")
            sys.modules["chumpy.ch"] = mod
            try:
                for k in ("shapedirs", "posedirs", "v_template"):
                    c = Ch()
                    c.x = data[k]
                    data[k] = c
                with open(path, "wb") as f:
                    pickle.dump(data, f)
            finally:
                for k, v in saved.items():
                    if v is None:
                        sys.modules.pop(k, None)
                    else:
                        sys.modules[k] = v
        else:
            with open(path, "wb") as f:
                pickle.dump(data, f)
    return str(path)


@pytest.mark.parametrize("extras,chumpy", [(True, False), (False, False), (False, True)],
                         ids=["synthetic", "official-layout", "chumpy"])
def test_pickles_load_alike(tmp_path, extras, chumpy):
    path = _official_pickle(tmp_path / "smpl.pkl", extras, chumpy)
    jm, pm = js.load_smpl_pickle(path), ps.load_smpl_pickle(path)
    for name in ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights"):
        np.testing.assert_array_equal(getattr(pm, name).numpy(), np.asarray(getattr(jm, name)),
                                      err_msg=name)
    assert (pm.j_regressor_extra is None) == (jm.j_regressor_extra is None) == (not extras)
    assert pm.parents == jm.parents == ps.SMPL_PARENTS
    assert pm.vertex_joint_ids == jm.vertex_joint_ids
    assert max(pm.vertex_joint_ids) < NV  # the constant ids taken modulo the mesh


def test_port_pickle_equals_jax_pickle(tmp_path):
    a = js.save_synthetic_smpl_pickle(str(tmp_path / "j.pkl"), n_vertices=NV, seed=4)
    b = ps.save_synthetic_smpl_pickle(str(tmp_path / "p.pkl"), n_vertices=NV, seed=4)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        da, db = pickle.load(fa), pickle.load(fb)
    assert set(da) == set(db)
    for k in da:
        np.testing.assert_array_equal(np.asarray(db[k]), np.asarray(da[k]), err_msg=k)


FEATS = {"rot6d": 6, "rotvec": 3, "rotquat": 4, "rotmat": 9}


def _rotations(rep, b, j, t, seed):
    """Valid rotations in representation ``rep`` [B, J, F, T]."""
    rs = np.random.RandomState(seed)
    d6 = rs.randn(b, j, t, 6).astype(np.float32)
    m = jrot.rotation_6d_to_matrix(jnp.asarray(d6))
    x = {"rot6d": d6, "rotmat": np.asarray(m).reshape(b, j, t, 9),
         "rotquat": np.asarray(jrot.matrix_to_quaternion(m)),
         "rotvec": np.asarray(jrot.matrix_to_axis_angle(m))}[rep]
    return np.ascontiguousarray(x.transpose(0, 1, 3, 2))


@pytest.mark.parametrize("jointstype", ["smpl", "vibe", "a2m", "a2mpl", "vertices"])
@pytest.mark.parametrize("pose_rep", list(FEATS))
def test_rotation2xyz_matches_jax(models, pose_rep, jointstype):
    jm, pm = models
    b, t = 2, 7
    rot = _rotations(pose_rep, b, 24, t, seed=5)
    trans = np.zeros((b, 1, FEATS[pose_rep], t), np.float32)
    trans[:, 0, :3] = np.random.RandomState(6).randn(b, 3, t)
    x = np.concatenate([rot, trans], axis=1)
    mask = np.ones((b, t), bool)
    mask[1, 5:] = False
    cases = [dict(), dict(vertstrans=True), dict(mask=mask), dict(beta=0.7),
             dict(translation=False, x=rot),
             dict(glob=False, glob_rot=(np.pi, 0.0, 0.0), x=x[:, 1:])]
    for kw in cases:
        xx = kw.pop("x", x)
        m = kw.pop("mask", None)
        want = np.asarray(jr2x.rotation2xyz(
            jm, jnp.asarray(xx), None if m is None else jnp.asarray(m), pose_rep=pose_rep,
            jointstype=jointstype, **kw))
        got = pr2x.Rotation2xyz(pm)(torch.from_numpy(xx),
                                    None if m is None else torch.from_numpy(m),
                                    pose_rep=pose_rep, jointstype=jointstype, **kw)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL, err_msg=str(kw))


def test_rotation2xyz_contract(models):
    _, pm = models
    x = torch.zeros(1, 25, 6, 3)
    assert pr2x.rotation2xyz(pm, x, pose_rep="xyz") is x
    with pytest.raises(NotImplementedError):
        pr2x.rotation2xyz(pm, x, jointstype="h36m")
    with pytest.raises(TypeError):
        pr2x.rotation2xyz(pm, x, glob=False)
    xyz, rots, glob = pr2x.rotation2xyz(pm, _t(_rotations("rot6d", 1, 25, 3, 7)),
                                        get_rotations_back=True)
    assert xyz.shape == (1, 24, 3, 3) and rots.shape == (3, 23, 3, 3) and glob.shape == (3, 3, 3)


def _t(a):
    return torch.from_numpy(a)


def test_fk_gradients_match_jax(models):
    """The training losses' fk_fn (rot6d, translation, glob, smpl joints)
    differentiated with respect to the sample."""
    import jax

    jm, pm = models
    x = _rotations("rot6d", 2, 25, 5, seed=8)
    w = np.random.RandomState(9).randn(2, 24, 3, 5).astype(np.float32)

    def jfk(s):
        return jnp.sum(jr2x.rotation2xyz(jm, s, pose_rep="rot6d", translation=True, glob=True,
                                         jointstype="smpl", vertstrans=False) * w)

    want = np.asarray(jax.jit(jax.grad(jfk))(jnp.asarray(x)))
    s = torch.from_numpy(x).requires_grad_()
    (pr2x.rotation2xyz(pm, s, pose_rep="rot6d", translation=True, glob=True,
                       jointstype="smpl", vertstrans=False) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(s.grad.numpy(), want, rtol=1e-4, atol=ATOL)
