"""Model and diffusion from the command-line flags, shared by the train,
generate, edit and export CLIs.

Counterpart of gesturediffusion_tpu/utils/model_factory.py
(``get_model_args``, ``create_model``, :23-111): the
gesture datasets get MDM V2 with MFCC input, or with the wav encoder under
``--use_wav_enc`` (``--mfcc_input`` with it is refused as JAX refuses it,
:68-90), ``humanml`` and ``kit`` the
MotionMDM of models/mdm_t2m.py (cond_mode ``text``, or ``no_cond`` under
``--unconstrained``; 263 and 251 features), ``humanact12`` and ``uestc``
the action-mode MotionMDM (12 and 40 actions, ``no_cond`` under
``--unconstrained``) on 25 rows of 6 (24 SMPL joints in rot6d and the
translation row; model_factory.py:101-109,128-137), each with ff 1024, 4
heads and dropout 0.1 as the reference's get_model_args, the fused
training layer under ``--use_fused_train_encoder`` (model_factory.py:90-99)
and ``--remat``; the diffusion is START_X with MSE loss.
"""

from __future__ import annotations

import torch

from gesturediffusion_tpu_torch.diffusion.gaussian import (
    LossType,
    ModelMeanType,
    ModelVarType,
    create_diffusion,
)
from gesturediffusion_tpu_torch.models.mdm import MDM
from gesturediffusion_tpu_torch.models.mdm_t2m import MotionMDM

GESTURE_DATASETS = ("genea2022", "genea2023", "synthetic")
# features a frame of the text-to-motion codecs (12 J - 1)
TEXT_NJOINTS = {"humanml": 263, "kit": 251}
# the action datasets' label counts
NUM_ACTIONS = {"humanact12": 12, "uestc": 40}


def gesture_audio_input(args) -> tuple[bool, bool]:
    """(mfcc_input, use_wav_enc) of a gesture model from the flags: MFCCs
    unless the wav encoder is asked for; both asked for is refused
    (model_factory.py:70-80)."""
    use_wav_enc = getattr(args, "use_wav_enc", False)
    if getattr(args, "mfcc_input", False) and use_wav_enc:
        # the model would run the MFCC branch and leave the wav encoder inert
        raise ValueError("--mfcc_input and --use_wav_enc are mutually exclusive "
                         "(the model consumes ONE audio representation)")
    return getattr(args, "mfcc_input", False) or not use_wav_enc, use_wav_enc


def create_gaussian_diffusion(args, device: torch.device,
                              timestep_respacing: str | None = None):
    """The START_X diffusion of the flags on ``device``, respaced by
    ``timestep_respacing`` or else ``--timestep_respacing``
    (model_factory.py:114)."""
    return create_diffusion(
        noise_schedule=args.noise_schedule,
        steps=args.diffusion_steps,
        timestep_respacing=(timestep_respacing
                            or getattr(args, "timestep_respacing", "") or None),
        model_mean_type=ModelMeanType.START_X,
        model_var_type=(
            ModelVarType.FIXED_SMALL if args.sigma_small else ModelVarType.FIXED_LARGE
        ),
        loss_type=LossType.MSE,
        lambda_vel=getattr(args, "lambda_vel", 0.0),
        lambda_rcxyz=getattr(args, "lambda_rcxyz", 0.0),
        lambda_fc=getattr(args, "lambda_fc", 0.0),
        device=device,
    )


def get_model_args(args, data=None) -> dict:
    """The denoiser's constructor arguments from the flags
    (model_factory.py:23-50): a gesture model takes ``data``'s
    ``pose_dim`` features, 498 without it (as JAX, for ``genea2022`` too);
    ff 1024, 4 heads and dropout 0.1 as the reference's get_model_args."""
    if args.dataset in GESTURE_DATASETS:
        njoints, nfeats = getattr(data, "pose_dim", None) or 498, 1
    elif args.dataset in TEXT_NJOINTS:
        njoints, nfeats = TEXT_NJOINTS[args.dataset], 1
    elif args.dataset in NUM_ACTIONS:
        njoints, nfeats = 25, 6  # rot6d + the translation row
    else:
        raise ValueError(f"Unsupported dataset name [{args.dataset}]")
    return dict(njoints=njoints, nfeats=nfeats, latent_dim=args.latent_dim, ff_size=1024,
                num_layers=args.layers, num_heads=4, dropout=0.1,
                cond_mask_prob=args.cond_mask_prob, clip_dim=512)


def create_model(args, data=None):
    """The denoiser of the flags, on the CPU (model_factory.py:53-111);
    ``data`` gives a gesture model its feature count."""
    if getattr(args, "arch", "trans_enc") != "trans_enc":
        raise NotImplementedError(f"--arch {args.arch!r}: only 'trans_enc' can be built")
    kw = get_model_args(args, data)
    kw.update(use_fused_train_encoder=getattr(args, "use_fused_train_encoder", False),
              remat=getattr(args, "remat", False))
    unconstrained = getattr(args, "unconstrained", False)
    if args.dataset in GESTURE_DATASETS:
        mfcc_input, use_wav_enc = gesture_audio_input(args)
        return MDM(use_text=args.use_text, seed_poses=args.seed_poses, mfcc_input=mfcc_input,
                   use_wav_enc=use_wav_enc, **kw)
    if args.dataset in TEXT_NJOINTS:
        return MotionMDM(cond_mode="no_cond" if unconstrained else "text", **kw)
    return MotionMDM(cond_mode="no_cond" if unconstrained else "action",
                     num_actions=NUM_ACTIONS[args.dataset], **kw)


def create_model_and_diffusion(args, dataset, device: torch.device):
    """The denoiser of the flags (on the CPU; the caller moves it) and its
    diffusion (on ``device``)."""
    return create_model(args, dataset), create_gaussian_diffusion(args, device)
