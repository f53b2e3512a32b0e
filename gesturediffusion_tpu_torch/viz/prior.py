"""Pose priors of the SMPLify fit.

PyTorch counterpart of gesturediffusion_tpu/viz/prior.py (:24-130):
``MaxMixturePrior``, the min-over-components GMM negative log-likelihood
of the 69-dim body pose over gmm_08.pkl; ``load_gmm_prior`` with its cache;
``make_synthetic_gmm``, a random GMM in gmm_08.pkl's layout; and
``angle_prior``, the knee and elbow bend prior.  The precisions and
weights are built in float64 on the host, as in JAX, and held as float32
tensors, on the CPU as loaded and on the fit's device through
``MaxMixturePrior.to``.  The constant term
keeps the reference's hard-coded 69-dim pose space (``const_dim``), so a
converted gmm_08.pkl gives the reference's numbers.
"""

from __future__ import annotations

import functools
import os
import pickle
from typing import Optional

import numpy as np
import torch


class MaxMixturePrior:
    """Min-over-components GMM negative log-likelihood of the flat body pose:

        nll(pose) = min_m [ 0.5 * (pose-mu_m)^T P_m (pose-mu_m)
                            - log(w_m / (const * sqrtdet_m/min sqrtdet)) ]
    """

    def __init__(
        self,
        means: np.ndarray,    # [M, D]
        covs: np.ndarray,     # [M, D, D]
        weights: np.ndarray,  # [M]
        epsilon: float = 1e-16,
        const_dim: int = 69,
    ):
        means = np.asarray(means, np.float64)
        covs = np.asarray(covs, np.float64)
        weights = np.asarray(weights, np.float64)
        precisions = np.stack([np.linalg.inv(c) for c in covs])
        sqrdets = np.array([np.sqrt(np.linalg.det(c)) for c in covs])
        const = (2 * np.pi) ** (const_dim / 2.0)
        nll_weights = weights / (const * (sqrdets / sqrdets.min()))

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32))

        self.means = f32(means)
        self.precisions = f32(precisions)
        self.nll_weights = f32(nll_weights)
        self.epsilon = epsilon
        self.random_var_dim = means.shape[1]

    def to(self, device) -> "MaxMixturePrior":
        """A copy whose tables live on ``device`` (self where they do)."""
        device = torch.device(device)
        if self.means.device == device:
            return self
        out = object.__new__(MaxMixturePrior)
        out.__dict__.update(self.__dict__)
        out.means, out.precisions, out.nll_weights = (
            t.to(device) for t in (self.means, self.precisions, self.nll_weights))
        return out

    def __call__(self, pose: torch.Tensor) -> torch.Tensor:
        """pose [B, D] flat body pose -> [B] the least component's NLL."""
        diff = pose[:, None, :] - self.means[None]                    # [B, M, D]
        prec_diff = torch.einsum("mij,bmj->bmi", self.precisions, diff)
        quad = torch.sum(prec_diff * diff, -1)                         # [B, M]
        ll = 0.5 * quad - torch.log(self.nll_weights)[None]
        return torch.min(ll, dim=1).values


def load_gmm_prior(path: str, epsilon: float = 1e-16) -> Optional[MaxMixturePrior]:
    """gmm_08.pkl (a dict or an sklearn GMM pickle) as a MaxMixturePrior on
    the CPU, or None where the file is absent.  Loads are cached per
    (path, epsilon): a rendering loop fits once a clip."""
    if not path or not os.path.exists(path):
        return None
    return _load_gmm_prior_cached(path, epsilon)


@functools.lru_cache(maxsize=8)
def _load_gmm_prior_cached(path: str, epsilon: float) -> MaxMixturePrior:
    with open(path, "rb") as f:
        gmm = pickle.load(f, encoding="latin1")
    if isinstance(gmm, dict):
        means, covs, weights = gmm["means"], gmm["covars"], gmm["weights"]
    elif hasattr(gmm, "means_"):
        means, covs, weights = gmm.means_, gmm.covars_, gmm.weights_
    else:
        raise ValueError(f"Unknown GMM pickle type: {type(gmm)}")
    return MaxMixturePrior(means, covs, weights, epsilon=epsilon)


def make_synthetic_gmm(n_gaussians: int = 8, dim: int = 69, seed: int = 0) -> dict:
    """A random well-conditioned GMM in the gmm_08.pkl dict layout, from the
    JAX package's numpy draws."""
    rs = np.random.RandomState(seed)
    means = rs.randn(n_gaussians, dim) * 0.3
    covs = []
    for _ in range(n_gaussians):
        a = rs.randn(dim, dim) * 0.05
        covs.append(a @ a.T + np.eye(dim) * 0.5)
    weights = rs.rand(n_gaussians)
    weights = weights / weights.sum()
    return {
        "means": means.astype(np.float64),
        "covars": np.stack(covs).astype(np.float64),
        "weights": weights.astype(np.float64),
    }


# the knees and elbows in the flat 69-dim body pose (no global orientation)
ANGLE_PRIOR_IDX = (55 - 3, 58 - 3, 12 - 3, 15 - 3)
ANGLE_PRIOR_SIGNS = (1.0, -1.0, -1.0, -1.0)


def angle_prior(body_pose: torch.Tensor) -> torch.Tensor:
    """Knee and elbow bend prior of the flat 69-dim body pose, [B, 4]."""
    signs = body_pose.new_tensor(ANGLE_PRIOR_SIGNS)
    return torch.exp(body_pose[:, list(ANGLE_PRIOR_IDX)] * signs) ** 2
