"""Action-to-motion benchmark (HumanAct12 / UESTC):
``python -m gesturediffusion_tpu_torch.eval.eval_a2m --model_path
<run>/model*.pt --eval_mode debug|full``.

PyTorch counterpart of gesturediffusion_tpu/eval/eval_a2m.py:
- ``A2MEvaluation`` (:50-208): the GRU classifier's accuracy, FID,
  diversity and the quota-based multimodality (:138-179), which draws from
  the global ``np.random`` in JAX's order; ``STGCNA2MEvaluation``
  (:211-273): the same on the UESTC ST-GCN, which reads the rotations
  without the translation row, [B, 24, 6, T] as [B, 6, T, 24].
- ``make_generated_batches`` / ``make_gt_batches`` (:288-346): dataset
  items -> (sample ->) xyz joints through SMPL -> classifier batches.
  Every block of indices is padded to ``batch_size`` (``_batch_indices``),
  so the denoiser always runs at the full batch, each encoder layer one
  launch of the encoder-layer kernel on the card; the padding is cut off
  on the host.  The chain's noise comes from a ``torch.Generator`` on the
  device, seeded with the eval seed.
- ``evaluate_humanact12`` and ``evaluate_uestc`` (:349-435; UESTC scores
  both splits through ``A2MSplitView``, keys suffixed ``_train`` /
  ``_test``), the unconstrained branch (:437-490; FK-derived 15-joint GT
  when MoDi's npy is absent), ``save_metrics`` (YAML),
  ``make_a2m_evaluation`` (the classifiers from ``A2M_CLASSIFIER_PATH``,
  ``UESTC_STGCN_PATH`` and ``MODI_STGCN_PATH``; ``--eval_mode full``
  refuses random weights), ``make_a2m_training_eval_fn`` (:567-630, the
  train CLI's ``--eval_during_training`` hook) and ``main`` (:633-778),
  which writes ``eval_<dataset>_<mode>.yaml`` beside the checkpoint.
The classifiers' weights are seeded random ones, with a loud warning,
where no checkpoint is found.  Everything the protocol computes on the
device (the chains, SMPL, the classifiers) runs in float32 with TF32 off
(utils/device.py:full_f32); cuDNN's GRU and convolutions would otherwise
take TF32, PyTorch's default.  The metric math is host numpy.
"""

from __future__ import annotations

import copy
import math
import os
import random
import sys
from typing import Callable, Optional

import numpy as np
import torch

from gesturediffusion_tpu_torch.data.a2m import A2MSplitView, HumanAct12Poses, collate_a2m
from gesturediffusion_tpu_torch.eval import metrics as M
from gesturediffusion_tpu_torch.eval.networks import MotionDiscriminator
from gesturediffusion_tpu_torch.eval.stgcn import STGCN, load_stgcn_checkpoint
from gesturediffusion_tpu_torch.utils import logger as log_lib
from gesturediffusion_tpu_torch.utils.device import full_f32, resolve_device

SMPL_DEFAULT = "body_models/smpl/SMPL_NEUTRAL.pkl"
# the a2m benchmark's clip length (eval_a2m.py:586, the reference's 60 frames)
NUM_FRAMES = 60


def _warn_random_classifier(
    name: str, script: str = "prepare/download_recognition_models.sh"
) -> None:
    """The banner when an eval classifier falls back to random frozen
    weights (eval_a2m.py:34): every FID and accuracy is then meaningless."""
    log_lib.log(
        f"WARNING: {name} checkpoint not found — using RANDOM frozen "
        "classifier weights; FID/accuracy/diversity are NOT comparable "
        f"to the reference protocol. Fetch the asset with {script} or "
        "point the env var at an existing tar."
    )


def seeded(seed: int, build: Callable):
    """``build()`` with the global torch RNG seeded, restored after: the
    random classifier weights of one seed, whatever ran before."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


class A2MEvaluation:
    """GRU-classifier based accuracy / FID / diversity / multimodality."""

    def __init__(
        self,
        input_size_raw: int = 72,
        num_classes: int = 12,
        state_dict: Optional[dict] = None,
        checkpoint_path: Optional[str] = None,
        seed: int = 0,
        device=None,
    ):
        self.input_size_raw = input_size_raw
        self.num_classes = num_classes
        self.device = resolve_device(device)
        self.classifier = seeded(seed, lambda: MotionDiscriminator(
            input_size_raw, hidden_size=128, hidden_layer=2, output_size=num_classes))
        if state_dict is None and checkpoint_path is not None:
            state_dict = self.load_torch_checkpoint(checkpoint_path)
        if state_dict is not None:
            self.classifier.load_state_dict(state_dict)
        else:
            _warn_random_classifier("a2m GRU classifier (humanact12_gru.tar)")
        self.classifier.to(self.device).eval()

    @staticmethod
    def load_torch_checkpoint(path_or_ckpt) -> dict:
        """The released humanact12_gru.tar (a path, or what ``torch.load``
        returned) -> its ``model`` state dict, in this classifier's layout."""
        if isinstance(path_or_ckpt, (str, bytes, os.PathLike)):
            path_or_ckpt = torch.load(path_or_ckpt, map_location="cpu", weights_only=False)
        return dict(path_or_ckpt["model"])

    @torch.no_grad()
    def forward(self, batch: dict):
        """One classifier batch -> (logits, features) as numpy."""
        with full_f32():
            logits, feats = self.classifier(
                torch.as_tensor(batch["output_xyz"], dtype=torch.float32, device=self.device),
                torch.as_tensor(batch["lengths"], device=self.device))
        return logits.cpu().numpy(), feats.cpu().numpy()

    # ---------------------------------------------------------------- #
    def calculate_accuracy(self, batches) -> float:
        confusion = np.zeros((self.num_classes, self.num_classes), np.int64)
        for batch in batches:
            pred = self.forward(batch)[0].argmax(-1)
            for label, p in zip(np.asarray(batch["y"]), pred):
                confusion[label, p] += 1
        return float(np.trace(confusion) / max(np.sum(confusion), 1))

    def compute_features(self, batches, with_labels=True):
        feats = np.concatenate([self.forward(batch)[1] for batch in batches], 0)
        labels = (np.concatenate([np.asarray(b["y"]) for b in batches], 0)
                  if with_labels else None)
        return feats, labels

    @staticmethod
    def diversity_multimodality(
        activations, labels, num_labels, unconstrained=False, rng=None,
        diversity_times=200, multimodality_times=20,
    ):
        """action2motion diversity + quota-based per-class multimodality."""
        rng = rng or np.random
        num_motions = activations.shape[0]
        first = rng.randint(0, num_motions, diversity_times)
        second = rng.randint(0, num_motions, diversity_times)
        diversity = float(
            np.linalg.norm(activations[first] - activations[second], axis=1).mean()
        )

        if unconstrained or labels is None:
            return diversity, float("nan")

        multimodality = 0.0
        label_quotas = np.zeros(num_labels)
        label_quotas[np.unique(labels)] = multimodality_times
        guard = 0
        while np.any(label_quotas > 0) and guard < 10_000_000:
            guard += 1
            first_idx = rng.randint(0, num_motions)
            first_label = labels[first_idx]
            if not label_quotas[first_label]:
                continue
            second_idx = rng.randint(0, num_motions)
            while labels[second_idx] != first_label:
                second_idx = rng.randint(0, num_motions)
            label_quotas[first_label] -= 1
            multimodality += np.linalg.norm(
                activations[first_idx] - activations[second_idx]
            )
        # the denominator counts every label, also those absent from the
        # samples (the reference's eval/a2m/stgcn/diversity.py:28,49)
        multimodality /= multimodality_times * num_labels
        return diversity, float(multimodality)

    def evaluate(self, loaders: dict, cond_mode: str = "action") -> dict:
        metrics: dict = {}
        computed = {}
        for key, batches in loaders.items():
            batches = list(batches)
            if cond_mode != "no_cond":
                metrics[f"accuracy_{key}"] = self.calculate_accuracy(batches)
            else:
                metrics[f"accuracy_{key}"] = float("nan")
            feats, labels = self.compute_features(
                batches, with_labels=cond_mode != "no_cond"
            )
            stats = M.calculate_activation_statistics(feats)
            computed[key] = {"feats": feats, "labels": labels, "stats": stats}
            div, mm = self.diversity_multimodality(
                feats, labels, self.num_classes,
                unconstrained=cond_mode == "no_cond",
            )
            metrics[f"diversity_{key}"] = div
            metrics[f"multimodality_{key}"] = mm

        gt_mu, gt_cov = computed["gt"]["stats"]
        for key in computed:
            mu, cov = computed[key]["stats"]
            metrics[f"fid_{key}"] = M.calculate_frechet_distance(gt_mu, gt_cov, mu, cov)
        return metrics


class STGCNA2MEvaluation(A2MEvaluation):
    """UESTC evaluation: the 10-block recognition ST-GCN (smpl layout, 6
    channels) on the rotations without the translation row."""

    def __init__(
        self,
        num_classes: int = 40,
        in_channels: int = 6,
        state_dict: Optional[dict] = None,
        checkpoint_path: Optional[str] = None,
        seed: int = 0,
        device=None,
    ):
        self.num_classes = num_classes
        self.device = resolve_device(device)
        self.model = seeded(seed, lambda: STGCN(
            in_channels=in_channels, num_class=num_classes, layout="smpl", strategy="spatial",
            edge_importance_weighting=True, variant="recognition"))
        if state_dict is None and checkpoint_path is not None:
            state_dict = load_stgcn_checkpoint(checkpoint_path, self.model)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        else:
            _warn_random_classifier("UESTC STGCN classifier (uestc_rot6d_stgcn.tar)")
        self.model.to(self.device).eval()

    @torch.no_grad()
    def forward(self, batch: dict):
        rot = torch.as_tensor(batch["output_rot"], dtype=torch.float32, device=self.device)
        with full_f32():
            logits, feats = self.model(rot.permute(0, 2, 3, 1), return_features=True)
        return logits.cpu().numpy(), feats.cpu().numpy()


def _batch_indices(n: int, batch_size: int):
    """Full-size index blocks covering n samples; the last block is padded
    to batch_size with its last index, and ``keep`` says how many rows the
    caller keeps (the reference truncates the last batch)."""
    for lo in range(0, n, batch_size):
        keep = min(batch_size, n - lo)
        idxs = list(range(lo, lo + keep))
        idxs += [idxs[-1]] * (batch_size - keep)
        yield idxs, keep


def _collated(dataset, idxs, num_frames):
    return collate_a2m([dataset[i] for i in idxs], max_frames=num_frames)


@torch.no_grad()
def make_generated_batches(
    sample_fn: Callable,
    fk_fn: Callable,
    dataset,
    num_samples: int,
    batch_size: int,
    num_frames: int,
    seed: int = 0,
    device=None,
) -> list[dict]:
    """Sample -> FK -> classifier batches.  ``sample_fn(generator, shape,
    cond)`` draws from one ``torch.Generator`` on ``device`` seeded with
    ``seed``; cond holds the items' mask, lengths and action on ``device``."""
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    batches = []
    for idxs, keep in _batch_indices(min(num_samples, len(dataset)), batch_size):
        motion, cond = _collated(dataset, idxs, num_frames)
        dcond = {k: torch.as_tensor(cond[k], device=device) for k in ("mask", "lengths", "action")}
        sample = sample_fn(generator, tuple(motion.shape), dcond)
        xyz = fk_fn(sample)
        batches.append({
            "output_xyz": xyz.cpu().numpy()[:keep],
            # rotations minus the translation row (the ST-GCN's input)
            "output_rot": sample.cpu().numpy()[:keep, :-1],
            "lengths": cond["lengths"][:keep],
            "y": cond["action"][:keep],
        })
    return batches


@torch.no_grad()
def make_gt_batches(
    fk_fn: Callable, dataset, num_samples: int, batch_size: int, num_frames: int,
    device=None,
) -> list[dict]:
    device = resolve_device(device)
    batches = []
    for idxs, keep in _batch_indices(min(num_samples, len(dataset)), batch_size):
        motion, cond = _collated(dataset, idxs, num_frames)
        xyz = fk_fn(torch.as_tensor(motion, device=device))
        batches.append({
            "output_xyz": xyz.cpu().numpy()[:keep],
            "output_rot": motion[:keep, :-1],
            "lengths": cond["lengths"][:keep],
            "y": cond["action"][:keep],
        })
    return batches


def _summary(all_metrics: dict, num_seeds: int) -> dict:
    """Mean and 95% interval of every metric over the seeds."""
    summary = {}
    for k, values in all_metrics.items():
        mean, conf = M.get_metric_statistics(np.asarray(values), num_seeds)
        summary[k] = float(mean)
        summary[f"{k}_conf"] = float(conf)
    return summary


def evaluate_humanact12(
    sample_fn,
    fk_fn,
    dataset,
    evaluation: A2MEvaluation,
    num_seeds: int = 20,
    num_samples: int = 1000,
    batch_size: int = 64,
    num_frames: int = NUM_FRAMES,
    cond_mode: str = "action",
    log=print,
    device=None,
) -> dict:
    """Multi-seed evaluation loop (the reference's gru_eval.py:76-102)."""
    device = resolve_device(device)
    all_metrics: dict = {}
    for seed in range(num_seeds):
        dataset.reset_shuffle()
        dataset.shuffle()
        gt_batches = make_gt_batches(fk_fn, dataset, num_samples, batch_size, num_frames,
                                     device=device)
        gen_batches = make_generated_batches(sample_fn, fk_fn, dataset, num_samples, batch_size,
                                             num_frames, seed=seed, device=device)
        metrics = evaluation.evaluate({"gt": gt_batches, "gen": gen_batches},
                                      cond_mode=cond_mode)
        log(f"[seed {seed}] {metrics}")
        for k, v in metrics.items():
            all_metrics.setdefault(k, []).append(v)
    return _summary(all_metrics, num_seeds)


def evaluate_uestc(
    sample_fn,
    fk_fn,
    dataset,
    evaluation: STGCNA2MEvaluation,
    num_seeds: int = 20,
    num_samples: int = 1000,
    batch_size: int = 64,
    num_frames: int = NUM_FRAMES,
    cond_mode: str = "action",
    log=print,
    device=None,
) -> dict:
    """UESTC multi-seed evaluation over both the train and the test split
    (the reference's stgcn_eval.py:78-147), keys suffixed ``_train`` /
    ``_test``."""
    device = resolve_device(device)
    splits = {key: A2MSplitView(dataset, key) for key in ("train", "test")}
    all_metrics: dict = {}
    for seed in range(num_seeds):
        per_seed = {}
        for key, ds in splits.items():
            ds.reset_shuffle()
            ds.shuffle()
            gt_batches = make_gt_batches(fk_fn, ds, num_samples, batch_size, num_frames,
                                         device=device)
            gen_batches = make_generated_batches(sample_fn, fk_fn, ds, num_samples, batch_size,
                                                 num_frames, seed=seed, device=device)
            metrics = evaluation.evaluate({"gt": gt_batches, "gen": gen_batches},
                                          cond_mode=cond_mode)
            per_seed.update({f"{k}_{key}": v for k, v in metrics.items()})
        log(f"[seed {seed}] {per_seed}")
        for k, v in per_seed.items():
            all_metrics.setdefault(k, []).append(v)
    return _summary(all_metrics, num_seeds)


# SMPL-joint indices of the 15-joint openpose-like subset of the
# unconstrained (MoDi) metrics (the reference's gru_eval.py:115)
UNCONSTRAINED_15_JOINTS = [15, 12, 16, 18, 20, 17, 19, 21, 0, 1, 4, 7, 2, 5, 8]


def evaluate_unconstrained_branch(
    sample_fn,
    fk_fn,
    dataset,
    num_samples: int = 1000,
    batch_size: int = 64,
    num_frames: int = NUM_FRAMES,
    dataset_npy_path: Optional[str] = None,
    evaluator=None,
    seed: int = 12345,
    log=print,
    device=None,
) -> dict:
    """MoDi ST-GCN FID / KID / diversity of unconstrained samples (the
    reference's gru_eval.py:106-121): the 15-joint subset of the generated
    xyz against the MoDi-struct npy where it exists, else against the
    dataset's own joints through the same FK and subset (logged)."""
    from gesturediffusion_tpu_torch.eval.eval_unconstrained import (
        evaluate_unconstrained_metrics,
    )

    device = resolve_device(device)
    dataset.reset_shuffle()
    dataset.shuffle()
    gen_batches = make_generated_batches(sample_fn, fk_fn, dataset, num_samples, batch_size,
                                         num_frames, seed=seed, device=device)
    generated = np.concatenate([b["output_xyz"][:, UNCONSTRAINED_15_JOINTS] for b in gen_batches])

    if dataset_npy_path and os.path.exists(dataset_npy_path):
        motion_data = np.load(dataset_npy_path, allow_pickle=True)
    else:
        log(
            "WARNING: unconstrained GT npy not found at "
            f"[{dataset_npy_path}]; deriving 15-joint GT motions from the "
            "dataset via FK (metric values will differ from the reference "
            "protocol until the asset is provided)."
        )
        gt_batches = make_gt_batches(fk_fn, dataset, num_samples, batch_size, num_frames,
                                     device=device)
        motion_data = np.concatenate(
            [b["output_xyz"][:, UNCONSTRAINED_15_JOINTS] for b in gt_batches])
    metrics = evaluate_unconstrained_metrics(generated, motion_data, evaluator=evaluator,
                                             fast=True, log=log, device=device)
    return {f"{k}_unconstrained": v for k, v in metrics.items()}


def _yaml_float(v) -> str:
    """A float as PyYAML's safe_dump writes it (.nan, .inf, 1.0e-05)."""
    v = float(v)
    if math.isnan(v):
        return ".nan"
    if math.isinf(v):
        return ".inf" if v > 0 else "-.inf"
    text = repr(v).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def save_metrics(path: str, metrics: dict) -> None:
    """The metrics as a flat YAML mapping, keys sorted (the reference's
    eval/a2m/tools.py:11), written without PyYAML."""
    with open(path, "w") as f:
        for k in sorted(metrics):
            f.write(f"{k}: {_yaml_float(metrics[k])}\n")


EVAL_MODES_A2M = {
    # the reference's eval_humanact12_uestc.py:58-63
    "debug": dict(num_seeds=2, num_samples=64),
    "full": dict(num_seeds=20, num_samples=1000),
}


def _existing(path: Optional[str]) -> Optional[str]:
    return path if path and os.path.exists(path) else None


def _require_classifier(
    path: Optional[str], env_var: str, default: str, eval_mode: Optional[str],
    script: str = "prepare/download_recognition_models.sh",
) -> Optional[str]:
    """A full-protocol run refuses random classifier weights; debug and
    in-training runs go on with the constructors' warning."""
    if path is None and eval_mode == "full":
        raise FileNotFoundError(
            f"a2m full-protocol evaluation requires the classifier "
            f"checkpoint; nothing found at ${env_var} "
            f"(default: {default}). Fetch it with {script}, or use "
            "--eval_mode debug for a smoke run with random-init weights."
        )
    return path


def make_a2m_evaluation(dataset_name: str, eval_mode: Optional[str] = None, device=None):
    """The benchmark's evaluation object for an a2m dataset on ``device``:
    uestc -> STGCNA2MEvaluation over $UESTC_STGCN_PATH, anything else ->
    A2MEvaluation over $A2M_CLASSIFIER_PATH (each with its default asset
    path).  ``eval_mode='full'`` refuses to run without the checkpoint."""
    if dataset_name == "uestc":
        env_var, default = "UESTC_STGCN_PATH", "assets/actionrecognition/uestc_rot6d_stgcn.tar"
        return STGCNA2MEvaluation(device=device, checkpoint_path=_require_classifier(
            _existing(os.environ.get(env_var, default)), env_var, default, eval_mode))
    env_var, default = "A2M_CLASSIFIER_PATH", "assets/actionrecognition/humanact12_gru.tar"
    return A2MEvaluation(device=device, checkpoint_path=_require_classifier(
        _existing(os.environ.get(env_var, default)), env_var, default, eval_mode))


def make_fk_fn(smpl) -> Callable:
    """rot6d samples [B, 25, 6, T] -> SMPL's 24 xyz joints [B, 24, 3, T],
    translated (the reference's rot2xyz of the a2m evaluation)."""
    from gesturediffusion_tpu_torch.models.rotation2xyz import rotation2xyz

    def fk_fn(sample):
        return rotation2xyz(smpl, sample, pose_rep="rot6d", translation=True, glob=True,
                            jointstype="smpl", vertstrans=True)

    return fk_fn


def ema_model(state):
    """The train state's model, or a copy of it holding the EMA weights
    where the state keeps them: what an in-training evaluation samples."""
    if not state.ema:
        return state.model
    net = copy.deepcopy(state.model)
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(state.ema[name])
    return net


def make_a2m_training_eval_fn(args, diffusion, dataset, device, log=None):
    """The a2m benchmark as the train CLI's ``--eval_during_training``
    hook (the reference's training_loop.py:188-199): ``eval_rep_times``
    seeds of ``eval_num_samples`` samples in batches of
    ``eval_batch_size``, no guidance, the EMA weights where there are some.
    Returns eval_fn(state, step) -> {metric: float} (the finite ones).
    Raises FileNotFoundError here when SMPL, which FK needs, is missing."""
    from gesturediffusion_tpu_torch.diffusion.sampling import p_sample_loop
    from gesturediffusion_tpu_torch.models.smpl import load_smpl_pickle

    log = log or log_lib.log
    smpl = load_smpl_pickle(os.environ.get("SMPL_MODEL_PATH", SMPL_DEFAULT)).to(device)
    fk_fn = make_fk_fn(smpl)
    evaluation = make_a2m_evaluation(args.dataset, device=device)
    evaluate = evaluate_uestc if args.dataset == "uestc" else evaluate_humanact12
    cond_mode = "no_cond" if args.unconstrained else "action"

    def eval_fn(state, step):
        net = ema_model(state)
        was_training = net.training
        net.eval()

        def sample_fn(generator, shape, cond):
            return p_sample_loop(diffusion, net, shape, cond, generator=generator,
                                 clip_denoised=False)

        try:
            with full_f32():
                summary = evaluate(
                    sample_fn, fk_fn, dataset, evaluation, num_seeds=args.eval_rep_times,
                    num_samples=args.eval_num_samples, batch_size=args.eval_batch_size,
                    num_frames=NUM_FRAMES, cond_mode=cond_mode, log=log, device=device)
        finally:
            net.train(was_training)
        return {k: float(v) for k, v in summary.items() if np.isfinite(v)}

    return eval_fn


def _load_dataset(args):
    """The benchmark's test data (the reference's eval_humanact12_uestc.py:30-35)."""
    if args.dataset == "uestc":
        from gesturediffusion_tpu_torch.data.uestc import UESTC

        return UESTC(args.data_dir or "dataset/uestc", num_frames=NUM_FRAMES,
                     pose_rep="rot6d", split="test")
    if args.dataset == "humanact12":
        return HumanAct12Poses(args.data_dir or "dataset/HumanAct12Poses",
                               num_frames=NUM_FRAMES, pose_rep="rot6d", split="test")
    raise NotImplementedError(
        f"dataset [{args.dataset}] is not supported by the a2m "
        "benchmark (expected humanact12 or uestc).")


def main(argv=None) -> dict:
    """python -m gesturediffusion_tpu_torch.eval.eval_a2m --model_path
    <run>/model*.pt --eval_mode debug|full [--batch_size N] [--device cpu]"""
    from gesturediffusion_tpu_torch.diffusion.sampling import p_sample_loop
    from gesturediffusion_tpu_torch.models.cfg import classifier_free_guidance
    from gesturediffusion_tpu_torch.models.smpl import load_smpl_pickle
    from gesturediffusion_tpu_torch.utils.convert import load_checkpoint
    from gesturediffusion_tpu_torch.utils.device import resolve_device
    from gesturediffusion_tpu_torch.utils.model_factory import create_model_and_diffusion
    from gesturediffusion_tpu_torch.utils.parser import evaluation_args

    args = evaluation_args(argv)
    random.seed(args.seed)
    np.random.seed(args.seed)
    if args.eval_mode not in EVAL_MODES_A2M:
        raise ValueError(f"eval_mode {args.eval_mode!r} unsupported for a2m; "
                         f"choose from {sorted(EVAL_MODES_A2M)}")
    mode = EVAL_MODES_A2M[args.eval_mode]
    device = resolve_device(args.device)
    dataset = _load_dataset(args)

    model, diffusion = create_model_and_diffusion(args, dataset, device)
    model.load_state_dict(load_checkpoint(args.model_path))
    model.to(device).eval()
    fk_fn = make_fk_fn(load_smpl_pickle(
        os.environ.get("SMPL_MODEL_PATH", SMPL_DEFAULT)).to(device))
    guided = args.guidance_param != 1
    model_fn = classifier_free_guidance(model, args.cond_mask_prob) if guided else model

    def sample_fn(generator, shape, cond):
        if guided:
            cond = {**cond, "scale": torch.full((shape[0],), args.guidance_param, device=device)}
        return p_sample_loop(diffusion, model_fn, shape, cond, generator=generator,
                             clip_denoised=False)

    cond_mode = "no_cond" if args.unconstrained else "action"
    common = dict(batch_size=args.batch_size, log=log_lib.log, device=device)
    with torch.no_grad(), full_f32():
        evaluation = make_a2m_evaluation(args.dataset, eval_mode=args.eval_mode, device=device)
        evaluate = evaluate_uestc if args.dataset == "uestc" else evaluate_humanact12
        summary = evaluate(sample_fn, fk_fn, dataset, evaluation, num_seeds=mode["num_seeds"],
                           num_samples=mode["num_samples"], cond_mode=cond_mode, **common)
        if args.dataset == "humanact12" and args.unconstrained:
            from gesturediffusion_tpu_torch.eval.eval_unconstrained import UnconstrainedEvaluator

            modi_env = "MODI_STGCN_PATH"
            modi_default = "assets/actionrecognition/humanact12_gru_modi_struct.pth.tar"
            evaluator = UnconstrainedEvaluator(device=device, checkpoint_path=_require_classifier(
                _existing(os.environ.get(modi_env, modi_default)), modi_env, modi_default,
                args.eval_mode, script="prepare/download_recognition_unconstrained_models.sh"))
            # the full protocol's 1000 unconstrained samples, as the mode table
            summary.update(evaluate_unconstrained_branch(
                sample_fn, fk_fn, dataset, num_samples=mode["num_samples"],
                dataset_npy_path=os.environ.get("UNCONSTRAINED_DATASET_PATH", os.path.join(
                    args.data_dir or "dataset/HumanAct12Poses",
                    "humanact12_unconstrained_modi_struct.npy")),
                evaluator=evaluator, **common))
    out = os.path.join(os.path.dirname(args.model_path),
                       f"eval_{args.dataset}_{args.eval_mode}.yaml")
    save_metrics(out, summary)
    log_lib.log(f"saved metrics to {out}")
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
