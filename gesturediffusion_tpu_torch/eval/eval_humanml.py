"""Text-to-motion benchmark (HumanML3D / KIT):
``python -m gesturediffusion_tpu_torch.eval.eval_humanml --model_path
<run>/model*.pt --eval_mode debug|wo_mm|mm_short [--device cpu]``.

PyTorch counterpart of gesturediffusion_tpu/eval/eval_humanml.py:
- ``collate_humanml_eval`` (:32), ``GroundTruthMotionSet`` (:54; every pass
  over it draws the dataset's crops anew, as the reference's DataLoader)
  and ``GeneratedMotionSet`` (:95): one ancestral chain a batch of 32
  (``sample_fn(generator, cond)``, all of a replication's chains from one
  ``torch.Generator`` seeded with the replication), multimodality's
  repeated batches picked by ``np.random.RandomState(seed)``, the samples
  renormalised to the evaluators' statistics;
- the metric passes (:186-280): matching score and R-precision on the
  co-embeddings, FID against the ground truth's motion embeddings,
  diversity and multimodality drawing from the global ``np.random`` in
  JAX's order; ``evaluation`` (:282: N replications, each metric's mean
  and 95% interval logged, the means returned); ``EVAL_MODES`` (:352;
  ``full`` is the action benchmark's and raises here, as in JAX);
  ``load_eval_renorm`` (:366: ``dataset/{t2m|kit}_{mean,std}.npy`` under
  the working directory, then beside the package, skipping stats of
  another width); ``make_training_eval_fn`` (:402, the train CLI's
  ``--eval_during_training`` hook on humanml / kit: no guidance, the EMA
  weights where there are some) and ``main`` (:507), which logs to
  ``eval_humanml_<run>_<iter>_<mode>.log`` beside the checkpoint.
The chains run the model (through kernel 1 on the card) and, at a
guidance other than 1, ``models/cfg.py:classifier_free_guidance``; the
captions go through utils/text_embedder.py (the CLIP tower where its files
are), the evaluators' word vectors through GloVe where ``./glove`` holds
them, else the hash stand-in.  Everything on the device runs in float32
with TF32 off (utils/device.py:full_f32); the metric math is host numpy.
"""

from __future__ import annotations

import os
import random
import sys
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch

from gesturediffusion_tpu_torch.eval import metrics as M
from gesturediffusion_tpu_torch.eval.eval_a2m import ema_model
from gesturediffusion_tpu_torch.eval.evaluator_wrapper import EvaluatorWrapper
from gesturediffusion_tpu_torch.utils import logger as log_lib
from gesturediffusion_tpu_torch.utils.device import full_f32, resolve_device

# R-precision is defined over batches of 32 (the reference's eval_humanml.py:232)
BATCH_SIZE = 32
MAX_FRAMES = 196


def collate_humanml_eval(items) -> dict:
    """Eval items -> {motions [B, 196, D], m_lens, captions[, word_embs,
    pos_ohot, cap_lens]}."""
    b, d = len(items), items[0]["motion"].shape[-1]
    motions = np.zeros((b, MAX_FRAMES, d), np.float32)
    lengths = np.zeros((b,), np.int32)
    for i, it in enumerate(items):
        t = min(it["motion"].shape[0], MAX_FRAMES)
        motions[i, :t] = it["motion"][:t]
        lengths[i] = it["length"]
    out = {"motions": motions, "m_lens": lengths, "captions": [it["text"] for it in items]}
    if "word_embeddings" in items[0]:
        out["word_embs"] = np.stack([it["word_embeddings"] for it in items])
        out["pos_ohot"] = np.stack([it["pos_one_hots"] for it in items])
        out["cap_lens"] = np.asarray([it["sent_len"] for it in items])
    return out


def _renormed(motions: np.ndarray, renorm: Optional[tuple]) -> np.ndarray:
    """From the training normalisation to the evaluators' (the reference's
    comp_v6_model_dataset.py:246-250)."""
    if renorm is None:
        return motions
    our_mean, our_std, ev_mean, ev_std = renorm
    return (motions * our_std + our_mean - ev_mean) / ev_std


class GroundTruthMotionSet:
    """The dataset's whole batches of 32, renormalised like the generated
    ones; each pass draws the crops anew."""

    def __init__(self, dataset, renorm: Optional[tuple] = None):
        self.dataset = dataset
        self.renorm = renorm

    def __iter__(self):
        for lo in range(0, len(self.dataset) - BATCH_SIZE + 1, BATCH_SIZE):
            batch = collate_humanml_eval([self.dataset[i] for i in range(lo, lo + BATCH_SIZE)])
            batch["motions"] = _renormed(batch["motions"], self.renorm)
            yield batch


class GeneratedMotionSet:
    """The model sampled over the eval split in whole batches of 32:
    ``sample_fn(generator, cond)`` -> [B, D, 1, T] on ``device``, cond
    holding the batch's mask, lengths, caption embeddings and (guided)
    scale.  ``mm_num_samples`` samples' worth of batches, picked by
    ``np.random.RandomState(seed)``, are sampled ``mm_num_repeats`` times
    for multimodality."""

    def __init__(
        self,
        sample_fn: Callable,
        dataset,
        text_encoder=None,
        mm_num_samples: int = 0,
        mm_num_repeats: int = 0,
        scale: float = 1.0,
        renorm: Optional[tuple] = None,
        seed: int = 0,
        num_samples_limit: Optional[int] = None,
        device=None,
    ):
        self.batches, self.mm_batches = [], []
        device = resolve_device(device)
        generator = torch.Generator(device=device).manual_seed(seed)
        n = len(dataset)
        if num_samples_limit:
            n = min(n, num_samples_limit)
        n_batches = n // BATCH_SIZE
        # mm_num_samples counts samples: mm_num_samples // 32 + 1 batches
        n_mm = min(mm_num_samples // BATCH_SIZE + 1, n_batches) if mm_num_samples > 0 else 0
        mm_idxs = (np.random.RandomState(seed).choice(n_batches, n_mm, replace=False)
                   if n_mm else [])
        for bi in range(n_batches):
            batch = collate_humanml_eval(
                [dataset[i] for i in range(bi * BATCH_SIZE, (bi + 1) * BATCH_SIZE)])
            lengths = torch.as_tensor(batch["m_lens"], device=device)
            cond = {"mask": (torch.arange(MAX_FRAMES, device=device)[None] < lengths[:, None])
                    [:, None, None, :], "lengths": lengths}
            if text_encoder is not None:
                cond["text_emb"] = torch.as_tensor(text_encoder(batch["captions"]),
                                                   dtype=torch.float32, device=device)
            if scale != 1.0:
                cond["scale"] = torch.full((BATCH_SIZE,), scale, device=device)
            repeats = mm_num_repeats if bi in mm_idxs else 1
            reps = [_renormed(sample_fn(generator, cond).cpu().numpy()[:, :, 0, :]
                              .transpose(0, 2, 1), renorm) for _ in range(repeats)]
            self.batches.append({**batch, "motions": reps[0]})
            if repeats > 1:
                self.mm_batches.append({"motions": np.stack(reps, 1), "m_lens": batch["m_lens"]})

    def __iter__(self):
        return iter(self.batches)


# ---- the metric passes (the reference's eval_humanml.py:19-135) ---------- #
def evaluate_matching_score(eval_wrapper, motion_loaders, log=print):
    match_score_dict, r_precision_dict, activation_dict = (OrderedDict() for _ in range(3))
    for name, loader in motion_loaders.items():
        all_motion_embeddings = []
        all_size, matching_score_sum, top_k_count = 0, 0, 0
        for batch in loader:
            text_emb, motion_emb = eval_wrapper.get_co_embeddings(
                batch["word_embs"], batch["pos_ohot"], batch["cap_lens"], batch["motions"],
                batch["m_lens"])
            dist_mat = M.euclidean_distance_matrix(text_emb, motion_emb)
            matching_score_sum += dist_mat.trace()
            top_k_count += M.calculate_top_k(np.argsort(dist_mat, axis=1), top_k=3).sum(axis=0)
            all_size += text_emb.shape[0]
            all_motion_embeddings.append(motion_emb)
        if all_size == 0:
            raise ValueError(
                f"motion loader {name!r} yielded no batches — the split is smaller than the "
                f"fixed R-precision batch size ({BATCH_SIZE}); use a larger dataset")
        match_score_dict[name] = matching_score_sum / all_size
        r_precision_dict[name] = top_k_count / all_size
        activation_dict[name] = np.concatenate(all_motion_embeddings, axis=0)
        log(f"---> [{name}] Matching Score: {match_score_dict[name]:.4f}")
        for i, v in enumerate(r_precision_dict[name]):
            log(f"---> [{name}] R_precision: (top {i + 1}): {v:.4f}")
    return match_score_dict, r_precision_dict, activation_dict


def evaluate_fid(eval_wrapper, groundtruth_loader, activation_dict, log=print):
    gt = np.concatenate([eval_wrapper.get_motion_embeddings(b["motions"], b["m_lens"])
                         for b in groundtruth_loader], axis=0)
    gt_mu, gt_cov = M.calculate_activation_statistics(gt)
    eval_dict = OrderedDict()
    for name, activations in activation_dict.items():
        mu, cov = M.calculate_activation_statistics(activations)
        eval_dict[name] = M.calculate_frechet_distance(gt_mu, gt_cov, mu, cov)
        log(f"---> [{name}] FID: {eval_dict[name]:.4f}")
    return eval_dict


def evaluate_diversity(activation_dict, diversity_times=300, log=print):
    eval_dict = OrderedDict()
    for name, activations in activation_dict.items():
        eval_dict[name] = M.calculate_diversity(
            activations, min(diversity_times, activations.shape[0] - 1))
        log(f"---> [{name}] Diversity: {eval_dict[name]:.4f}")
    return eval_dict


def evaluate_multimodality(eval_wrapper, mm_motion_loaders, mm_num_times=10, log=print):
    eval_dict = OrderedDict()
    for name, loader in mm_motion_loaders.items():
        embs = []
        for batch in loader:
            reps = batch["motions"]  # [B, R, T, D]
            b, r = reps.shape[:2]
            # keep_order: the [b, r] regrouping reads the input order
            emb = eval_wrapper.get_motion_embeddings(
                reps.reshape(b * r, *reps.shape[2:]), np.repeat(batch["m_lens"], r),
                keep_order=True)
            embs.append(emb.reshape(b, r, -1))
        if not embs:
            eval_dict[name] = 0.0
            continue
        embs = np.concatenate(embs, axis=0)
        eval_dict[name] = M.calculate_multimodality(embs, min(mm_num_times, embs.shape[1] - 1))
        log(f"---> [{name}] Multimodality: {eval_dict[name]:.4f}")
    return eval_dict


def evaluation(
    eval_wrapper: EvaluatorWrapper,
    gt_loader,
    eval_motion_loaders: dict,
    log_file: str,
    replication_times: int,
    diversity_times: int = 300,
    mm_num_times: int = 10,
    run_mm: bool = False,
) -> dict:
    """``replication_times`` replications -> each metric's mean over them
    ({"<metric>_<loader>": mean}), each logged with its 95% interval
    (the reference's eval_humanml.py:138-226).  ``eval_motion_loaders``
    maps a name to make_loader(replication) -> (loader, mm_loader)."""
    with open(log_file, "w") as f:

        def log(msg):
            print(msg)
            print(msg, file=f, flush=True)

        all_metrics = OrderedDict((k, OrderedDict()) for k in (
            "Matching Score", "R_precision", "FID", "Diversity", "MultiModality"))
        for replication in range(replication_times):
            motion_loaders, mm_motion_loaders = {"ground truth": gt_loader}, {}
            for name, make_loader in eval_motion_loaders.items():
                motion_loaders[name], mm_motion_loaders[name] = make_loader(replication)
            log(f"==================== Replication {replication} ====================")
            match, rprec, acti = evaluate_matching_score(eval_wrapper, motion_loaders, log)
            fid = evaluate_fid(eval_wrapper, gt_loader, acti, log)
            div = evaluate_diversity(acti, diversity_times, log)
            mm = (evaluate_multimodality(eval_wrapper, mm_motion_loaders, mm_num_times, log)
                  if run_mm else {})
            for key, d in (("Matching Score", match), ("R_precision", rprec), ("FID", fid),
                           ("Diversity", div), ("MultiModality", mm)):
                for name, value in d.items():
                    all_metrics[key].setdefault(name, []).append(value)

        mean_dict = {}
        for metric_name, metric_dict in all_metrics.items():
            log(f"========== {metric_name} Summary ==========")
            for model_name, values in metric_dict.items():
                mean, conf = M.get_metric_statistics(np.asarray(values), replication_times)
                mean_dict[f"{metric_name}_{model_name}"] = mean
                log(f"---> [{model_name}] Mean: {mean} CInterval: {conf}")
        return mean_dict


EVAL_MODES = {
    # the reference's eval_humanml.py:244-267
    "debug": dict(num_samples_limit=1000, run_mm=False, mm_num_samples=0, mm_num_repeats=0,
                  mm_num_times=0, diversity_times=300, replication_times=5),
    "wo_mm": dict(num_samples_limit=1000, run_mm=False, mm_num_samples=0, mm_num_repeats=0,
                  mm_num_times=0, diversity_times=300, replication_times=20),
    "mm_short": dict(num_samples_limit=1000, run_mm=True, mm_num_samples=100,
                     mm_num_repeats=30, mm_num_times=10, diversity_times=300,
                     replication_times=5),
}


def load_eval_renorm(dataset, log=None, dataset_name="humanml"):
    """(our_mean, our_std, eval_mean, eval_std) when the evaluators'
    statistics ``{t2m|kit}_{mean,std}.npy`` are found in ``dataset/`` under
    the working directory, else in the repository's ``dataset/`` beside the
    package; stats of another width than the dataset's are skipped.  None,
    logged, when none match: the samples are then scored in the training
    normalisation."""
    log = log or log_lib.log
    prefix = "kit" if dataset_name == "kit" else "t2m"
    repo_dataset = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "dataset")
    for d in ("dataset", repo_dataset):
        mean_p, std_p = (os.path.join(d, f"{prefix}_{s}.npy") for s in ("mean", "std"))
        if os.path.isfile(mean_p) and os.path.isfile(std_p):
            ev_mean, ev_std = np.load(mean_p), np.load(std_p)
            if ev_mean.shape != np.shape(dataset.mean):
                log(f"{prefix} evaluator stats at {mean_p} are {ev_mean.shape[0]}-dim but the "
                    f"dataset is {np.shape(dataset.mean)[0]}-dim — ignoring them")
                continue
            return dataset.mean, dataset.std, ev_mean, ev_std
    log(f"{prefix} evaluator norm stats not found (or none match the dataset dim) — generated "
        "motions evaluated in training normalization (NOT metric-parity)")
    return None


def _eval_dataset(args, split: str, log=None):
    from gesturediffusion_tpu_torch.data.humanml import (
        Text2MotionDatasetV2,
        load_word_vectorizer,
    )

    root = args.data_dir or (
        "./dataset/HumanML3D" if args.dataset == "humanml" else "./dataset/KIT-ML")
    return Text2MotionDatasetV2(root, split=split,
                                dataset_name="t2m" if args.dataset == "humanml" else "kit",
                                w_vectorizer=load_word_vectorizer(log or log_lib.log))


def make_training_eval_fn(args, diffusion, device, text_encoder=None, log=None) -> Callable:
    """The text benchmark as the train CLI's ``--eval_during_training``
    hook (the reference's training_loop.py:165-202): ``eval_rep_times``
    replications over ``eval_num_samples`` samples of ``--eval_split`` in
    batches of 32, without guidance, mm off, diversity over at most 300
    pairs; logs to ``<save_dir>/eval_humanml_<step>.log``.  Returns
    eval_fn(state, step) -> {metric: float}, R-precision as ``_top1..3``.
    Raises ValueError when the split holds fewer than 32 clips."""
    from gesturediffusion_tpu_torch.diffusion.sampling import p_sample_loop

    log = log or log_lib.log
    dataset = _eval_dataset(args, args.eval_split, log)
    if len(dataset) < BATCH_SIZE:
        raise ValueError(f"eval split has {len(dataset)} samples < protocol batch {BATCH_SIZE} "
                         "— benchmark eval impossible")
    renorm = load_eval_renorm(dataset, log, dataset_name=args.dataset)
    gt_loader = GroundTruthMotionSet(dataset, renorm=renorm)
    eval_wrapper = EvaluatorWrapper(args.dataset, dim_pose=dataset.pose_dim, device=device)
    shape = (BATCH_SIZE, dataset.pose_dim, 1, MAX_FRAMES)
    num_samples, rep_times = args.eval_num_samples, args.eval_rep_times
    diversity_times = min(300, max(2, (num_samples // BATCH_SIZE) * BATCH_SIZE - 1))

    def eval_fn(state, step):
        net = ema_model(state)
        was_training = net.training
        net.eval()

        def sample_fn(generator, cond):
            return p_sample_loop(diffusion, net, shape, cond, generator=generator,
                                 clip_denoised=False)

        def make_gen_loader(replication):
            gen = GeneratedMotionSet(sample_fn, dataset, text_encoder=text_encoder,
                                     renorm=renorm, seed=replication,
                                     num_samples_limit=num_samples, device=device)
            return gen, gen.mm_batches

        try:
            with torch.no_grad(), full_f32():
                mean_dict = evaluation(
                    eval_wrapper, gt_loader, {"vald": make_gen_loader},
                    os.path.join(args.save_dir, f"eval_humanml_{step:09d}.log"),
                    replication_times=rep_times, diversity_times=diversity_times)
        finally:
            net.train(was_training)
        out = {}
        for k, v in mean_dict.items():
            arr = np.asarray(v)
            if arr.ndim == 0:
                out[k] = float(arr)
            else:  # R-precision: top 1, 2, 3
                out.update({f"{k}_top{i + 1}": float(vi) for i, vi in enumerate(arr)})
        return out

    return eval_fn


def main(argv=None) -> dict:
    """python -m gesturediffusion_tpu_torch.eval.eval_humanml --model_path
    <run>/model*.pt --eval_mode debug|wo_mm|mm_short [--guidance_param S]
    [--device cpu]"""
    from gesturediffusion_tpu_torch.diffusion.sampling import p_sample_loop
    from gesturediffusion_tpu_torch.models.cfg import classifier_free_guidance
    from gesturediffusion_tpu_torch.utils.convert import load_checkpoint
    from gesturediffusion_tpu_torch.utils.device import resolve_device
    from gesturediffusion_tpu_torch.utils.model_factory import create_model_and_diffusion
    from gesturediffusion_tpu_torch.utils.parser import evaluation_args
    from gesturediffusion_tpu_torch.utils.text_embedder import get_text_encoder

    args = evaluation_args(argv, prog="python -m gesturediffusion_tpu_torch.eval.eval_humanml")
    random.seed(args.seed)
    np.random.seed(args.seed)
    if args.eval_mode not in EVAL_MODES:
        # 'full' is the action benchmark's protocol (JAX raises here too)
        raise ValueError(f"eval_mode {args.eval_mode} unsupported for t2m; "
                         f"choose from {sorted(EVAL_MODES)}")
    mode = EVAL_MODES[args.eval_mode]
    device = resolve_device(args.device)

    name = os.path.basename(os.path.dirname(args.model_path))
    niter = os.path.basename(args.model_path).replace("model", "").replace(".pt", "")
    log_file = os.path.join(os.path.dirname(args.model_path),
                            f"eval_humanml_{name}_{niter}_{args.eval_mode}.log")
    dataset = _eval_dataset(args, "test")
    renorm = load_eval_renorm(dataset, dataset_name=args.dataset)
    gt_loader = GroundTruthMotionSet(dataset, renorm=renorm)
    text_encoder = get_text_encoder(device=device)

    model, diffusion = create_model_and_diffusion(args, dataset, device)
    model.load_state_dict(load_checkpoint(args.model_path))
    model.to(device).eval()
    model_fn = (classifier_free_guidance(model, args.cond_mask_prob)
                if args.guidance_param != 1 else model)
    shape = (BATCH_SIZE, dataset.pose_dim, 1, MAX_FRAMES)

    def sample_fn(generator, cond):
        return p_sample_loop(diffusion, model_fn, shape, cond, generator=generator,
                             clip_denoised=False)

    eval_wrapper = EvaluatorWrapper(args.dataset, device=device)

    def make_gen_loader(replication):
        gen = GeneratedMotionSet(
            sample_fn, dataset, text_encoder=text_encoder,
            mm_num_samples=mode["mm_num_samples"], mm_num_repeats=mode["mm_num_repeats"],
            scale=args.guidance_param, renorm=renorm, seed=replication,
            num_samples_limit=mode["num_samples_limit"], device=device)
        return gen, gen.mm_batches

    with torch.no_grad(), full_f32():
        return evaluation(eval_wrapper, gt_loader, {"vald": make_gen_loader}, log_file,
                          replication_times=mode["replication_times"],
                          diversity_times=mode["diversity_times"],
                          mm_num_times=mode["mm_num_times"], run_mm=mode["run_mm"])


if __name__ == "__main__":
    main(sys.argv[1:])
