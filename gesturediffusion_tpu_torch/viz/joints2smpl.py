"""SMPLify: fit SMPL pose parameters to 3D joint positions.

PyTorch counterpart of gesturediffusion_tpu/viz/joints2smpl.py (:48-360):
a two-stage Adam fit (lr 0.02, 150 iterations a stage by default) of a
per-frame axis-angle pose [T, 24, 3] and root translation [T, 3] through
SMPL's kinematic chain (models/smpl.py ``lbs(..., vertices=False)``), all
frames of a motion as one batch on the device.

- Stage 1 (the camera / global stage) fits the global orientation and the
  translation on the plain squared keypoint error; the body rows of the
  pose gradient are zeroed before each step, and with zero optimizer state
  Adam leaves them where they are.
- Stage 2 (the body stage) fits everything on the reference's body-fitting
  objective: the Geman-McClure joint loss with the confidences squared,
  the knee / elbow angle prior, and the GMM pose prior over gmm_08.pkl
  ($GMM_PRIOR_PATH), or an L2 body-pose prior where that file is absent
  (logged).

Each stage has an optimizer of its own (JAX initialises optax's state a
stage); torch's and optax's Adam share the update rule, eps outside the
square root.  The products run in float32 with TF32 off.  ``npy2smpl`` and
the CLI (``python -m gesturediffusion_tpu_torch.viz.joints2smpl
--input_path results.npy [--device cpu]``) turn a results.npy of xyz
joints into ``<name>_rot.npy``, the [25, 6, T] rot6d layout that Blender
imports.  Everything runs on the CUDA card unless the CPU is asked for.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from gesturediffusion_tpu_torch.models.smpl import SMPLModel
from gesturediffusion_tpu_torch.ops import rotations as R
from gesturediffusion_tpu_torch.utils import logger as log_lib
from gesturediffusion_tpu_torch.utils.device import full_f32, resolve_device
from gesturediffusion_tpu_torch.viz.prior import MaxMixturePrior, angle_prior, load_gmm_prior

# gmm_08.pkl's default location; GMM_PRIOR_PATH overrides it
DEFAULT_GMM_PRIOR_PATH = "body_models/joints2smpl/gmm_08.pkl"
# the neutral mean pose the reference starts its fits from; SMPL_MEAN_PATH
# overrides it
DEFAULT_SMPL_MEAN_PATH = "body_models/joints2smpl/neutral_smpl_mean_params.h5"
DEFAULT_SMPL_MODEL_PATH = "body_models/smpl/SMPL_NEUTRAL.pkl"


def load_smpl_mean_pose(path: Optional[str] = None) -> Optional[np.ndarray]:
    """SMPL's mean pose from neutral_smpl_mean_params.h5 as [24, 3]
    axis-angle, or None where the file is absent or h5py is not installed
    (logged): the fit then starts from the zero pose."""
    path = path or os.environ.get("SMPL_MEAN_PATH", DEFAULT_SMPL_MEAN_PATH)
    if not os.path.isfile(path):
        return None
    try:
        import h5py
    except ImportError:
        log_lib.log(
            f"WARNING: {path} exists but h5py is not installed — falling back to the "
            "zero-pose init (install h5py to use the reference mean-pose init).")
        return None
    with h5py.File(path, "r") as f:
        pose = np.asarray(f["pose"][:], np.float32).reshape(-1)
    if pose.shape != (72,):
        raise ValueError(f"mean-params 'pose' has {pose.shape[0]} values, expected 72")
    return pose.reshape(24, 3)


# the body stage's weights (the reference's customloss defaults, the joint
# weight as its body-stage calls pass it)
POSE_PRIOR_WEIGHT = 4.78 * 1.5
ANGLE_PRIOR_WEIGHT = 15.2
JOINT_LOSS_WEIGHT = 600.0
GMOF_SIGMA = 100.0

# ankles (7, 8) and feet (10, 11) in SMPL's joint order, weighted 1.5 by
# the reference's fix_foot option
FIX_FOOT_JOINTS = (7, 8, 10, 11)
FIX_FOOT_CONFIDENCE = 1.5


def gmof(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Geman-McClure robust error."""
    x2 = x ** 2
    s2 = sigma ** 2
    return (s2 * x2) / (s2 + x2)


def fk_joints(smpl: SMPLModel, pose_aa: torch.Tensor, transl: torch.Tensor) -> torch.Tensor:
    """Axis-angle pose [B, 24, 3] and translation [B, 3] -> SMPL's 24 joints
    [B, 24, 3] (the chain only: no vertices)."""
    mats = R.axis_angle_to_matrix(pose_aa)
    _, joints = smpl.lbs(pose_aa.new_zeros((pose_aa.shape[0], smpl.num_betas)), mats, transl,
                         vertices=False)
    return joints


def keypoint_error(smpl, pose, transl, target, subset) -> torch.Tensor:
    """Mean squared distance of the fitted joints from the target."""
    err = fk_joints(smpl, pose, transl)[:, subset] - target[:, subset]
    return torch.mean(torch.sum(err ** 2, -1))


def stage_objective(smpl, pose, transl, target, subset, conf, pose_prior, fit_pose: bool
                    ) -> torch.Tensor:
    """A stage's scalar objective: the plain keypoint error in stage 1
    (``fit_pose`` False), the body-fitting objective in stage 2."""
    err = fk_joints(smpl, pose, transl)[:, subset] - target[:, subset]
    if not fit_pose:
        return torch.mean(torch.sum(err ** 2, -1))
    joint_loss = (JOINT_LOSS_WEIGHT ** 2) * torch.sum(
        (conf ** 2)[None, :] * torch.sum(gmof(err, GMOF_SIGMA), -1), -1)
    body = pose[:, 1:].reshape(pose.shape[0], -1)
    ang = (ANGLE_PRIOR_WEIGHT ** 2) * torch.sum(angle_prior(body), -1)
    if pose_prior is not None:
        pp = (POSE_PRIOR_WEIGHT ** 2) * pose_prior(body)
    else:
        pp = (POSE_PRIOR_WEIGHT ** 2) * torch.sum(body ** 2, -1)
    return torch.sum(joint_loss + ang + pp)


def fit_stage(smpl, target, subset, conf, pose, transl, *, fit_pose: bool, num_iters: int,
              lr: float = 0.02, pose_prior: Optional[MaxMixturePrior] = None):
    """``num_iters`` Adam steps of one stage from (pose, transl), on a fresh
    optimizer (with gradients on, whatever the caller's mode) -> (pose,
    transl, keypoint error after the stage)."""
    pose = pose.detach().clone().requires_grad_(True)
    transl = transl.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([pose, transl], lr=lr)
    with torch.enable_grad(), full_f32():
        for _ in range(num_iters):
            opt.zero_grad(set_to_none=False)
            stage_objective(smpl, pose, transl, target, subset, conf, pose_prior,
                            fit_pose).backward()
            if not fit_pose:
                pose.grad[:, 1:] = 0.0  # stage 1 moves the global orientation only
            opt.step()
        with torch.no_grad():
            err = keypoint_error(smpl, pose, transl, target, subset)
    return pose.detach(), transl.detach(), err


def fit_inputs(joints: np.ndarray, device, joint_subset=None, joint_confidence=None,
               fix_foot: bool = False):
    """The fit's target [T, J<=24, 3], fitted joint indices and their
    confidences as tensors on ``device``, validated as JAX does."""
    target = torch.as_tensor(np.asarray(joints[:, :24] if joints.shape[1] >= 24 else joints,
                                        np.float32), device=device)
    subset = (np.asarray(joint_subset) if joint_subset is not None
              else np.arange(min(target.shape[1], 22)))
    if joint_confidence is not None:
        if fix_foot:
            raise ValueError(
                "joint_confidence and fix_foot are mutually exclusive — fix_foot is shorthand "
                "for a confidence vector with ankles/feet at 1.5; fold the upweight into "
                "joint_confidence instead")
        conf = np.asarray(joint_confidence, np.float32)
        if conf.shape != subset.shape:
            raise ValueError(f"joint_confidence has shape {conf.shape}, expected "
                             f"{subset.shape} (one weight per fitted joint)")
    else:
        conf = np.ones(subset.shape, np.float32)
        if fix_foot:
            for j in FIX_FOOT_JOINTS:
                conf[subset == j] = FIX_FOOT_CONFIDENCE
    return (target, torch.as_tensor(subset, dtype=torch.int64, device=device),
            torch.as_tensor(conf, device=device))


def default_pose_prior() -> Optional[MaxMixturePrior]:
    """gmm_08.pkl from $GMM_PRIOR_PATH (or its default location), or None
    with the warning that the L2 prior stands in."""
    prior = load_gmm_prior(os.environ.get("GMM_PRIOR_PATH", DEFAULT_GMM_PRIOR_PATH))
    if prior is None:
        log_lib.log(
            "WARNING: joints2smpl running WITHOUT the GMM pose prior (gmm_08.pkl not found at "
            f"$GMM_PRIOR_PATH or {DEFAULT_GMM_PRIOR_PATH}) — using an L2 body-pose prior; "
            "fits will differ from the reference objective.")
    return prior


def initial_params(smpl, target, init_pose=None):
    """The fit's starting pose (``init_pose``, else SMPL's mean pose where
    its file is present, else zero) and the translation that puts the root
    on the target's."""
    t = target.shape[0]
    if init_pose is not None:
        pose0 = torch.as_tensor(np.asarray(init_pose, np.float32), device=target.device)
    else:
        mean = load_smpl_mean_pose()
        pose0 = (torch.as_tensor(mean, device=target.device).expand(t, 24, 3).clone()
                 if mean is not None else target.new_zeros((t, 24, 3)))
    with torch.no_grad(), full_f32():
        transl0 = target[:, 0] - fk_joints(smpl, pose0, target.new_zeros((t, 3)))[:, 0]
    return pose0, transl0


def joints2smpl(
    smpl: SMPLModel,
    joints: np.ndarray,  # [T, J>=22, 3] target joint positions
    num_smplify_iters: int = 150,
    lr: float = 0.02,
    init_pose: Optional[np.ndarray] = None,
    joint_subset: Optional[np.ndarray] = None,
    pose_prior: Optional[MaxMixturePrior] = None,
    joint_confidence: Optional[np.ndarray] = None,
    fix_foot: bool = False,
    device=None,
) -> dict:
    """Fit per-frame SMPL axis-angle poses and the root translation to
    joints, every frame in one batch on ``device`` (the card unless
    ``"cpu"``); ``smpl`` is moved there.  ``joint_confidence`` weights
    each fitted joint's stage-2 error, indexed like ``joint_subset``;
    ``fix_foot`` weights the ankles and feet 1.5.  Returns {'thetas':
    [T, 24, 3], 'root_translation': [T, 3], 'loss': the keypoint mean
    squared error after each stage}, on the host."""
    device = resolve_device(device)
    smpl = smpl.to(device)
    if pose_prior is None:
        pose_prior = default_pose_prior()
    prior = pose_prior.to(device) if pose_prior is not None else None
    target, subset, conf = fit_inputs(joints, device, joint_subset, joint_confidence, fix_foot)
    pose, transl = initial_params(smpl, target, init_pose)
    pose, transl, loss1 = fit_stage(smpl, target, subset, conf, pose, transl, fit_pose=False,
                                    num_iters=num_smplify_iters, lr=lr, pose_prior=prior)
    pose, transl, loss2 = fit_stage(smpl, target, subset, conf, pose, transl, fit_pose=True,
                                    num_iters=num_smplify_iters, lr=lr, pose_prior=prior)
    return {
        "thetas": pose.cpu().numpy(),
        "root_translation": transl.cpu().numpy(),
        "loss": (float(loss1), float(loss2)),
    }


def motion_to_rot(smpl: SMPLModel, motion: np.ndarray, **fit_kw) -> np.ndarray:
    """One xyz sample [J>=22, 3, T] -> [25, 6, T] SMPL rot6d: rows 0-23 each
    joint's rotation-6d, row 24 the root's xyz in its first three channels
    (the reference's Blender-import layout)."""
    fit = joints2smpl(smpl, motion.transpose(2, 0, 1), **fit_kw)
    rot6d = R.matrix_to_rotation_6d(R.axis_angle_to_matrix(
        torch.from_numpy(fit["thetas"]))).numpy()  # [T, 24, 6]
    root = motion.transpose(2, 0, 1)[:, 0]  # [T, 3]
    root_row = np.concatenate([root, np.zeros_like(root)], -1)[:, None]
    return np.concatenate([rot6d, root_row], 1).transpose(1, 2, 0)


def npy2smpl(npy_path: str, smpl: SMPLModel, num_smplify_iters: int = 150,
             fix_foot: bool = False, out_path: Optional[str] = None, device=None) -> str:
    """A results.npy of xyz joints -> ``<name>_rot.npy``: every sample's
    [J, 3, T] motion fitted and replaced by the [25, 6, T] rot6d layout,
    every other key passed through.  Returns the path written."""
    if not npy_path.endswith(".npy"):
        raise ValueError(f"npy2smpl expects a .npy results file, got {npy_path!r}")
    data = np.load(npy_path, allow_pickle=True).item()
    motions = data["motion"]
    if motions.ndim != 4 or motions.shape[2] != 3:
        raise ValueError(f"expected xyz motions [N, J, 3, T], got {motions.shape} — "
                         "npy2smpl consumes stick-figure results.npy files")
    data["motion"] = np.stack([
        motion_to_rot(smpl, m, num_smplify_iters=num_smplify_iters, fix_foot=fix_foot,
                      device=device)
        for m in motions])
    if out_path is None:
        out_path = npy_path[: -len(".npy")] + "_rot.npy"
    np.save(out_path, data)
    return out_path


def load_smpl_or_synthetic(path: str) -> SMPLModel:
    """The SMPL pickle at ``path``, or the synthetic stand-in where it is
    absent (as the JAX CLIs do)."""
    from gesturediffusion_tpu_torch.models.smpl import load_smpl_pickle, make_synthetic_smpl

    return load_smpl_pickle(path) if os.path.isfile(path) else make_synthetic_smpl()


def main(argv=None):
    """``python -m gesturediffusion_tpu_torch.viz.joints2smpl --input_path
    <results.npy | directory> [--num_smplify_iters N] [--fix_foot]
    [--smpl_model PATH] [--device cpu]``."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--input_path", required=True,
                        help="results.npy file, or a directory of them")
    parser.add_argument("--num_smplify_iters", type=int, default=150)
    parser.add_argument("--fix_foot", action="store_true",
                        help="upweight ankle/foot joints to 1.5 in the fit")
    parser.add_argument("--smpl_model", default=os.environ.get(
        "SMPL_MODEL_PATH", DEFAULT_SMPL_MODEL_PATH))
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    smpl = load_smpl_or_synthetic(args.smpl_model)
    if os.path.isfile(args.input_path):
        paths = [args.input_path]
    else:
        paths = sorted(os.path.join(args.input_path, f) for f in os.listdir(args.input_path)
                       if f.endswith(".npy") and not f.endswith("_rot.npy"))
    outs = []
    for path in paths:
        outs.append(npy2smpl(path, smpl, num_smplify_iters=args.num_smplify_iters,
                             fix_foot=args.fix_foot, device=device))
        print(f"saved [{outs[-1]}]")
    return outs


if __name__ == "__main__":
    main()
