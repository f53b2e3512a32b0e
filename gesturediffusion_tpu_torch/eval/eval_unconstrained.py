"""Unconstrained-generation metrics on MoDi-style ST-GCN features.

PyTorch counterpart of gesturediffusion_tpu/eval/eval_unconstrained.py
(:21-122): the 15-joint openpose ST-GCN feature extractor
(``UnconstrainedEvaluator``) and ``evaluate_unconstrained_metrics``, which
centres every motion on joint 8 (the pelvis in MoDi's joint order) and
reports FID, KID, diversity and, unless ``fast``, precision and recall.
The features run on the evaluator's device in float32 (TF32 off); the
metric math is host numpy (eval/metrics.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gesturediffusion_tpu_torch.eval import metrics as M
from gesturediffusion_tpu_torch.eval.eval_a2m import _warn_random_classifier, seeded
from gesturediffusion_tpu_torch.eval.stgcn import STGCN, load_stgcn_checkpoint
from gesturediffusion_tpu_torch.utils.device import full_f32, resolve_device


class UnconstrainedEvaluator:
    """The MoDi ST-GCN (``modi`` variant, openpose15, 3 channels) from a
    state dict, a checkpoint, or seeded random weights (with the warning)."""

    def __init__(
        self,
        num_classes: int = 12,
        state_dict: Optional[dict] = None,
        checkpoint_path: Optional[str] = None,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = seeded(seed, lambda: STGCN(
            in_channels=3, num_class=num_classes, layout="openpose15", strategy="spatial",
            edge_importance_weighting=True, variant="modi"))
        if state_dict is None and checkpoint_path is not None:
            state_dict = load_stgcn_checkpoint(checkpoint_path, self.model)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        else:
            _warn_random_classifier(
                "MoDi unconstrained STGCN evaluator (humanact12_gru_modi_struct.pth.tar)",
                script="prepare/download_recognition_unconstrained_models.sh")
        self.model.to(self.device).eval()

    @torch.no_grad()
    def compute_features(self, motions: np.ndarray, batch_size: int = 64):
        """motions [N, 15, 3, T] -> (features [N, 256], logits [N, classes])."""
        feats, preds = [], []
        with full_f32():
            for lo in range(0, len(motions), batch_size):
                x = torch.as_tensor(np.ascontiguousarray(
                    motions[lo:lo + batch_size].transpose(0, 2, 3, 1)),  # [B, 3, T, V]
                    dtype=torch.float32, device=self.device)
                logits, f = self.model(x, return_features=True)
                feats.append(f.cpu().numpy())
                preds.append(logits.cpu().numpy())
        return np.concatenate(feats), np.concatenate(preds)


def evaluate_unconstrained_metrics(
    generated_motions: np.ndarray,  # [N, 15, 3, T]
    dataset_motions: np.ndarray,  # [M, >=15, 3, T]
    evaluator: Optional[UnconstrainedEvaluator] = None,
    fast: bool = True,
    log=print,
    device=None,
) -> dict:
    """FID, KID and diversity (and precision / recall unless ``fast``) of
    the generated motions against the dataset's.  Both are in MoDi's joint
    order (eval_a2m.UNCONSTRAINED_15_JOINTS maps SMPL's); the dataset's
    first 15 joints are taken, as the reference's 16-joint npy needs."""
    evaluator = evaluator or UnconstrainedEvaluator(device=device)
    generated = generated_motions - generated_motions[:, 8:9]
    dataset = dataset_motions[:, :15] - dataset_motions[:, 8:9]

    gen_feats, _ = evaluator.compute_features(generated)
    ds_feats, _ = evaluator.compute_features(dataset)

    gen_stats = M.calculate_activation_statistics(gen_feats)
    ds_stats = M.calculate_activation_statistics(ds_feats)

    fid = M.calculate_frechet_distance(*gen_stats, *ds_stats)
    log(f"FID score: {fid}")

    kid_mean, kid_std = M.calculate_kid(ds_feats, gen_feats, subset_size=min(1000, len(gen_feats)))
    log(f"KID: {kid_mean:.3f} ({kid_std:.3f})")

    dt = min(200, len(gen_feats) - 1, len(ds_feats) - 1)
    gen_div = M.calculate_diversity(gen_feats, dt)
    ds_div = M.calculate_diversity(ds_feats, dt)
    log(f"Diversity generated: {gen_div}  dataset: {ds_div}")

    out = {
        "fid": fid,
        "kid_mean": kid_mean,
        "kid_std": kid_std,
        "diversity_gen": gen_div,
        "diversity_gt": ds_div,
    }
    if not fast:
        precision, recall = M.precision_and_recall(gen_feats, ds_feats)
        log(f"precision: {precision}  recall: {recall}")
        out["precision"] = precision
        out["recall"] = recall
    return out
