"""Training CLI: ``python -m gesturediffusion_tpu_torch.train.train_mdm``.

PyTorch counterpart of gesturediffusion_tpu/train/train_mdm.py:main
(:30-273): flags -> seed -> save-dir guard -> platform -> args.json ->
data -> model and diffusion -> TrainLoop, with ``--resume_checkpoint
latest|<model*.pt>``.  It runs on the CUDA card unless ``--device cpu`` is
given.  ``--dataset genea2023`` reads the train split of ``--data_dir``
through the registry, ``synthetic`` is the in-memory set; ``genea2022``
loads too, but has no seed poses for the model to condition on, and is
refused before training (the JAX CLI fails on it inside the model).
``--dataset humanml|kit`` trains the text-to-motion MotionMDM (``no_cond``
under ``--unconstrained``) on HumanML3D / KIT clips, the captions embedded
by utils/text_embedder.py:get_text_encoder (train_mdm.py:73-82); under
``--use_fused_train_encoder`` its encoder trains through the training-
layer kernels.  ``--dataset humanact12|uestc`` trains the action-mode
MotionMDM (``no_cond`` under ``--unconstrained``) on rot6d poses; with
``--lambda_rcxyz`` or ``--lambda_fc`` above 0 the geometric losses read
xyz joints through SMPL (the pickle named by ``SMPL_MODEL_PATH``, else
body_models/smpl/SMPL_NEUTRAL.pkl) and models/rotation2xyz.py
(train_mdm.py:104-116).  ``--device_batch_pool N`` stages N batches on the
device and cycles them (train_mdm.py:276-301).  ``--eval_during_training``
evaluates after every in-loop save (train_mdm.py:134-229): the text
benchmark on humanml / kit over ``--eval_split`` (eval/eval_humanml.py),
the a2m benchmark on humanact12 / uestc (eval/eval_a2m.py), else, or where
a benchmark cannot run (SMPL missing, a split under 32 clips), the
validation loss over a fixed set of batches.

Several ranks (train_mdm.py:41-43, 66-67, 231-240): with GDT_COORDINATOR_ADDRESS
set and the world named by GDT_NUM_PROCESSES and GDT_PROCESS_ID, or under
``torchrun --nproc_per_node N`` by its WORLD_SIZE and RANK, each process
joins the group before it touches the card
(parallel/distributed.py:maybe_initialize; a rank on card LOCAL_RANK where
torchrun sets it, else rank % device_count, unless ``--device`` names
one), the ranks form a (data, model) grid with ``--mesh_model_axis`` on
the model axis, each data rank loads its slice of every global
``--batch_size`` batch, and rank 0 alone writes the files, reports to the
platform and evaluates.  ``--mesh_model_axis N`` divides each weight of
JAX's shape rule over the model axis: a rank holds its 1/N block of the
weight, its gradient, its AdamW moments and its EMA, and runs the
products on the block (parallel/tensor.py); the checkpoints keep the
single-process layout.
"""

from __future__ import annotations

import itertools
import os
import sys
from typing import Callable, Optional

import numpy as np
import torch

from gesturediffusion_tpu_torch.data.registry import (
    ACTION_DATASETS,
    TEXT_DATASETS,
    get_dataset_class,
    get_dataset_loader,
)
from gesturediffusion_tpu_torch.eval.eval_a2m import make_a2m_training_eval_fn
from gesturediffusion_tpu_torch.eval.eval_humanml import make_training_eval_fn
from gesturediffusion_tpu_torch.models.rotation2xyz import rotation2xyz
from gesturediffusion_tpu_torch.models.smpl import load_smpl_pickle
from gesturediffusion_tpu_torch.parallel.distributed import (
    barrier,
    maybe_initialize,
    process_index,
    rank_device,
)
from gesturediffusion_tpu_torch.parallel.mesh import make_data_mesh_for_batch
from gesturediffusion_tpu_torch.train.loop import (
    TrainConfig,
    TrainLoop,
    batch_to_device,
    find_latest_checkpoint,
)
from gesturediffusion_tpu_torch.train.platforms import TrainPlatform, create_platform
from gesturediffusion_tpu_torch.utils import logger as log_lib
from gesturediffusion_tpu_torch.utils.model_factory import create_model_and_diffusion
from gesturediffusion_tpu_torch.utils.parser import train_args
from gesturediffusion_tpu_torch.utils.text_embedder import get_text_encoder


def main(argv=None) -> TrainLoop:
    args = train_args(argv)
    get_dataset_class(args.dataset)  # an unknown dataset raises here
    text_data = args.dataset in TEXT_DATASETS
    motion_data = text_data or args.dataset in ACTION_DATASETS
    maybe_initialize(args.device)  # before anything touches the card
    device = rank_device(args.device)
    mesh = make_data_mesh_for_batch(args.batch_size, model=args.mesh_model_axis)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)  # the model's initial weights, alike on every rank

    if os.path.exists(args.save_dir) and not args.overwrite:
        raise FileExistsError(f"save_dir [{args.save_dir}] already exists.")
    barrier()  # every rank has looked before rank 0 creates it
    writes = process_index() == 0
    if writes:
        os.makedirs(args.save_dir, exist_ok=True)
        platform = create_platform(args.train_platform_type, args.save_dir)
        platform.report_args(vars(args), name="Args")
    else:
        platform = TrainPlatform(args.save_dir)

    log_lib.log("creating data loader...")
    data = get_dataset_loader(args.dataset, batch_size=args.batch_size,
                              num_frames=args.num_frames, split="train",
                              datapath=args.data_dir or None, n_seed_poses=args.seed_poses,
                              seed=args.seed, process_count=mesh.data,
                              process_index=mesh.data_index)
    if not motion_data and args.seed_poses and "seed" not in data.dataset[0]:
        # the MDM V2 conditions every step on seed poses; the JAX train CLI
        # fails on such a dataset at the model's cond["seed"] (mdm.py:228)
        raise ValueError(f"--dataset {args.dataset} has no seed poses, which the model "
                         f"conditions on (--seed_poses {args.seed_poses})")
    log_lib.log("creating model and diffusion...")
    model, diffusion = create_model_and_diffusion(args, data.dataset, device)
    n_params = sum(p.numel() for p in model.parameters())
    log_lib.log(f"model initialized: {n_params / 1e6:.2f}M params on {device}")

    config = TrainConfig(
        save_dir=args.save_dir, lr=args.lr, weight_decay=args.weight_decay,
        lr_anneal_steps=args.lr_anneal_steps, num_steps=args.num_steps,
        batch_size=args.batch_size, log_interval=args.log_interval,
        save_interval=args.save_interval, schedule_sampler=args.schedule_sampler,
        ema_rate=args.ema_rate, use_bf16=args.use_bf16,
        microbatch_size=args.microbatch_size, seed=args.seed,
    )
    text_encoder = (get_text_encoder(device=device)
                    if text_data and not args.unconstrained else None)
    fk_fn = None
    if args.lambda_rcxyz > 0 or args.lambda_fc > 0:
        smpl = load_smpl_pickle(os.environ.get(
            "SMPL_MODEL_PATH", "body_models/smpl/SMPL_NEUTRAL.pkl")).to(device)

        def fk_fn(sample):
            return rotation2xyz(smpl, sample, pose_rep="rot6d", translation=True, glob=True,
                                jointstype="smpl", vertstrans=False)

    eval_fn = (make_eval_fn(args, diffusion, data.dataset, device, text_encoder)
               if args.eval_during_training and writes else None)
    loop = TrainLoop(config, diffusion, model, data, device, platform=platform,
                     args_to_save=vars(args), text_encoder=text_encoder, fk_fn=fk_fn,
                     eval_fn=eval_fn, mesh=mesh)
    if args.resume_checkpoint:
        resume = args.resume_checkpoint
        if resume == "latest":
            resume = find_latest_checkpoint(args.save_dir)
            if resume is None:
                raise FileNotFoundError(
                    f"--resume_checkpoint latest: no model*.pt under {args.save_dir}")
        loop.load(resume)
    batch_source = None
    if args.device_batch_pool > 0:
        batch_source = build_device_batch_pool(loop, args.device_batch_pool)
    log_lib.log("training...")
    loop.run_loop(batch_source=batch_source)
    platform.close()
    return loop


def make_eval_fn(args, diffusion, dataset, device, text_encoder=None) -> Optional[Callable]:
    """The ``--eval_during_training`` hook (train_mdm.py:134-229): the text
    benchmark on humanml / kit (its captions through ``text_encoder``), the
    a2m benchmark on the action datasets, else (or where the benchmark
    cannot run) the validation loss; None, logged, when the eval split
    cannot be read."""
    if args.dataset in TEXT_DATASETS:
        try:
            return make_training_eval_fn(args, diffusion, device, text_encoder=text_encoder)
        except (OSError, ValueError) as e:  # no such split, or under 32 clips
            log_lib.log(f"benchmark eval_during_training unavailable ({e}); "
                        "falling back to val-loss eval")
    if args.dataset in ACTION_DATASETS:
        try:
            return make_a2m_training_eval_fn(args, diffusion, dataset, device)
        except FileNotFoundError as e:
            log_lib.log(f"a2m eval_during_training unavailable ({e}); "
                        "falling back to val-loss eval")
    try:
        return make_val_loss_eval_fn(args, diffusion, device, text_encoder)
    except (OSError, ValueError) as e:  # no such split, or too few items
        log_lib.log(f"eval_during_training disabled: {e}")
        return None


def make_val_loss_eval_fn(args, diffusion, device, text_encoder=None) -> Callable:
    """The mean diffusion loss of the model (no dropout) over the first
    ceil(eval_num_samples / eval_batch_size) batches of the val split (the
    train split of ``synthetic``, ``--eval_split`` of humanml / kit, whose
    captions ``text_encoder`` embeds), the timesteps and noise drawn from a
    generator seeded alike at every eval: eval_fn(state, step) ->
    {"val_loss": float}."""
    split = {"synthetic": "train", "humanml": args.eval_split, "kit": args.eval_split}.get(
        args.dataset, "val")
    val_data = get_dataset_loader(args.dataset, batch_size=args.eval_batch_size,
                                  num_frames=args.num_frames, split=split,
                                  datapath=args.data_dir or None, n_seed_poses=args.seed_poses,
                                  seed=args.seed + 1)
    batches = iter(val_data)
    try:
        n = -(-args.eval_num_samples // args.eval_batch_size)
        audio = args.use_wav_enc and not args.mfcc_input  # the wav encoder reads it
        val_batches = [batch_to_device(m, c, device, text_encoder, audio)
                       for m, c in itertools.islice(batches, n)]
    finally:
        batches.close()  # stops the loader's producer thread
    if not val_batches:
        raise ValueError(f"{split} split smaller than eval_batch_size")

    def eval_fn(state, step):
        model = state.model
        was_training = model.training
        model.eval()
        generator = torch.Generator(device=device).manual_seed(args.seed + 12345)
        losses = []
        try:
            with torch.no_grad():
                for motion, cond in val_batches:
                    t = torch.randint(0, diffusion.num_timesteps, (motion.shape[0],),
                                      generator=generator, device=device)
                    noise = torch.randn(motion.shape, generator=generator, device=device)
                    terms = diffusion.training_losses(model, motion, t, cond, mask=cond["mask"],
                                                      noise=noise)
                    losses.append(terms["loss"].mean().item())
        finally:
            model.train(was_training)
        return {"val_loss": float(np.mean(losses))}

    return eval_fn


def build_device_batch_pool(loop: TrainLoop, n_batches: int):
    """Stage ``n_batches`` collated batches on the loop's device once and
    cycle them for the whole run (train_mdm.py:276-301)."""
    log_lib.log(f"staging {n_batches}-batch device pool...")
    src = loop._host_batches()
    try:
        pool = [next(src) for _ in range(n_batches)]
    finally:
        src.close()  # stops the loader's producer thread
    nbytes = sum(t.numel() * t.element_size()
                 for motion, cond in pool for t in (motion, *cond.values()))
    log_lib.log(f"device pool staged: {n_batches} batches, {nbytes / 1e6:.1f} MB")
    return itertools.cycle(pool)


if __name__ == "__main__":
    main(sys.argv[1:])
