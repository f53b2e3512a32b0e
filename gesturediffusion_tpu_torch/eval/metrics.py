"""Evaluation metric math.

Copy of gesturediffusion_tpu/eval/metrics.py for the port (numpy and
scipy, host side): the distance matrix, R-precision and matching score
(:22-60), activation statistics, diversity and multimodality, the
Frechet distance with scipy's ``sqrtm`` and, for a rank-deficient product,
the PSD square root (:94-135), KID as the unbiased polynomial-kernel MMD
over random subsets (:146-196), the manifold estimate behind precision and
recall (:199-219) and the mean with its 95% interval over replications
(:222).  Random draws come from ``rng`` or the global ``np.random``, in
the JAX package's order.
"""

from __future__ import annotations

import numpy as np
from scipy import linalg


def euclidean_distance_matrix(matrix1: np.ndarray, matrix2: np.ndarray):
    """dist[i, j] = ||matrix1[i] - matrix2[j]||."""
    assert matrix1.shape[1] == matrix2.shape[1]
    d1 = -2 * np.dot(matrix1, matrix2.T)
    d2 = np.sum(np.square(matrix1), axis=1, keepdims=True)
    d3 = np.sum(np.square(matrix2), axis=1)
    return np.sqrt(np.maximum(d1 + d2 + d3, 0.0))


def calculate_top_k(mat: np.ndarray, top_k: int) -> np.ndarray:
    """Cumulative top-k hit matrix given argsorted index matrix."""
    size = mat.shape[0]
    gt_mat = np.expand_dims(np.arange(size), 1).repeat(size, 1)
    bool_mat = mat == gt_mat
    correct_vec = False
    top_k_list = []
    for i in range(top_k):
        correct_vec = correct_vec | bool_mat[:, i]
        top_k_list.append(correct_vec[:, None])
    return np.concatenate(top_k_list, axis=1)


def calculate_R_precision(
    embedding1: np.ndarray, embedding2: np.ndarray, top_k: int,
    sum_all: bool = False,
):
    dist_mat = euclidean_distance_matrix(embedding1, embedding2)
    argmax = np.argsort(dist_mat, axis=1)
    top_k_mat = calculate_top_k(argmax, top_k)
    return top_k_mat.sum(axis=0) if sum_all else top_k_mat


def calculate_matching_score(
    embedding1: np.ndarray, embedding2: np.ndarray, sum_all: bool = False
):
    assert embedding1.shape == embedding2.shape and embedding1.ndim == 2
    dist = linalg.norm(embedding1 - embedding2, axis=1)
    return dist.sum(axis=0) if sum_all else dist


def calculate_activation_statistics(activations: np.ndarray):
    mu = np.mean(activations, axis=0)
    cov = np.cov(activations, rowvar=False)
    return mu, cov


def calculate_diversity(
    activation: np.ndarray, diversity_times: int, rng=None
) -> float:
    assert activation.ndim == 2 and activation.shape[0] > diversity_times
    rng = rng or np.random
    num_samples = activation.shape[0]
    first = rng.choice(num_samples, diversity_times, replace=False)
    second = rng.choice(num_samples, diversity_times, replace=False)
    return float(
        linalg.norm(activation[first] - activation[second], axis=1).mean()
    )


def calculate_multimodality(
    activation: np.ndarray, multimodality_times: int, rng=None
) -> float:
    assert activation.ndim == 3 and activation.shape[1] > multimodality_times
    rng = rng or np.random
    num_per_sent = activation.shape[1]
    first = rng.choice(num_per_sent, multimodality_times, replace=False)
    second = rng.choice(num_per_sent, multimodality_times, replace=False)
    return float(
        linalg.norm(activation[:, first] - activation[:, second], axis=2).mean()
    )


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6) -> float:
    """FID between two Gaussians (Dougal Sutherland's stable form)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    assert mu1.shape == mu2.shape and sigma1.shape == sigma2.shape

    diff = mu1 - mu2
    tr_covmean = None
    try:
        # scipy signals a singular/defective product with a LinAlgWarning
        # (while still returning a possibly-inaccurate result) — promote
        # it to an error so the singular path routes to the PSD
        # eigendecomposition fallback below instead of warning through
        # (tests/test_eval.py::test_frechet_singular_uses_psd_fallback)
        import warnings

        from scipy.linalg import LinAlgWarning

        with warnings.catch_warnings():
            warnings.simplefilter("error", LinAlgWarning)
            covmean = linalg.sqrtm(sigma1.dot(sigma2))
        if np.iscomplexobj(covmean):
            if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
                raise np.linalg.LinAlgError("large imaginary component")
            covmean = covmean.real
        if np.isfinite(covmean).all():
            tr_covmean = np.trace(covmean)
    except (np.linalg.LinAlgError, ValueError, LinAlgWarning):
        pass
    if tr_covmean is None:
        # rank-deficient product (scipy sqrtm fails): use the PSD
        # formulation tr sqrt(s1·s2) = tr sqrt(sqrt(s1)·s2·sqrt(s1)),
        # computed by eigendecomposition with clipped spectra
        def sqrtm_psd(mat):
            vals, vecs = np.linalg.eigh((mat + mat.T) / 2)
            vals = np.clip(vals, 0, None)
            return (vecs * np.sqrt(vals)) @ vecs.T

        s1h = sqrtm_psd(sigma1 + np.eye(sigma1.shape[0]) * eps)
        inner = sqrtm_psd(s1h @ (sigma2 + np.eye(sigma2.shape[0]) * eps) @ s1h)
        tr_covmean = np.trace(inner)
    return float(
        diff.dot(diff)
        + np.trace(sigma1)
        + np.trace(sigma2)
        - 2 * tr_covmean
    )


# ---------------------------------------------------------------------- #
# KID (polynomial-kernel MMD)
# ---------------------------------------------------------------------- #
def _polynomial_kernel(x, y=None, degree=3, gamma=None, coef0=1.0):
    y = x if y is None else y
    gamma = gamma if gamma is not None else 1.0 / x.shape[1]
    return (gamma * (x @ y.T) + coef0) ** degree


def _mmd2_unbiased(k_xx, k_xy, k_yy) -> float:
    m = k_xx.shape[0]
    diag_x = np.diagonal(k_xx)
    diag_y = np.diagonal(k_yy)
    kt_xx_sum = k_xx.sum() - diag_x.sum()
    kt_yy_sum = k_yy.sum() - diag_y.sum()
    k_xy_sum = k_xy.sum()
    return float(
        (kt_xx_sum + kt_yy_sum) / (m * (m - 1)) - 2 * k_xy_sum / (m * m)
    )


def calculate_kid(
    real_features: np.ndarray,
    gen_features: np.ndarray,
    n_subsets: int = 50,
    subset_size: int = 1000,
    rng=None,
) -> tuple[float, float]:
    """Kernel Inception Distance: mean/std of unbiased polynomial MMD over
    random subsets (reference: kid.py:8-45)."""
    rng = rng or np.random
    m = min(len(real_features), len(gen_features))
    subset_size = min(subset_size, m)
    # reference parity (kid.py:16 `replace = subset_size < len(codes_g)`):
    # subsets are drawn WITH replacement whenever the subset is smaller
    # than the feature set — byte-identical draw sequence under a shared
    # np.random seed (tests/test_eval_golden.py)
    replace = subset_size < len(gen_features)
    mmds = np.zeros(n_subsets)
    for i in range(n_subsets):
        g = gen_features[
            rng.choice(len(gen_features), subset_size, replace=replace)
        ]
        r = real_features[
            rng.choice(len(real_features), subset_size, replace=replace)
        ]
        k_xx = _polynomial_kernel(g)
        k_yy = _polynomial_kernel(r)
        k_xy = _polynomial_kernel(g, r)
        mmds[i] = _mmd2_unbiased(k_xx, k_xy, k_yy)
    return float(mmds.mean()), float(mmds.std())


# ---------------------------------------------------------------------- #
# Improved precision / recall (manifold estimate)
# ---------------------------------------------------------------------- #
def manifold_estimate(
    a_features: np.ndarray, b_features: np.ndarray, k: int = 3
) -> float:
    """Fraction of B inside the k-NN radius manifold of A (vectorized)."""
    d_aa = euclidean_distance_matrix(a_features, a_features)
    # k-th smallest nonzero distance per row (row itself has distance 0)
    radii = np.sort(d_aa, axis=1)[:, k]
    d_ba = euclidean_distance_matrix(b_features, a_features)
    inside = (d_ba <= radii[None, :]).any(axis=1)
    return float(inside.mean())


def precision_and_recall(
    generated_features: np.ndarray, real_features: np.ndarray, k: int = 3
) -> tuple[float, float]:
    n = min(len(generated_features), len(real_features))
    generated_features = generated_features[:n]
    real_features = real_features[:n]
    precision = manifold_estimate(real_features, generated_features, k)
    recall = manifold_estimate(generated_features, real_features, k)
    return precision, recall


def get_metric_statistics(values, replication_times: int):
    """mean ± 95% CI over replications (reference: eval_humanml.py:131)."""
    mean = np.mean(values, axis=0)
    std = np.std(values, axis=0)
    conf_interval = 1.96 * std / np.sqrt(replication_times)
    return mean, conf_interval
