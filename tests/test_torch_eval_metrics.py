"""Port parity of the evaluation metrics (eval/metrics.py) against the JAX
package's on the same float64 features: the distance matrix, top-k,
R-precision, matching score, activation statistics, diversity and
multimodality (the global ``np.random`` seeded alike before each), the
Frechet distance on both branches (scipy's ``sqrtm`` on full-rank
covariances, the PSD square root on a rank-deficient product), KID,
precision / recall and the replication statistics; and the a2m
evaluation's quota-based diversity / multimodality.

Tolerance: relative 1e-10 (float64, the same numpy and scipy calls).
"""

import numpy as np
import pytest

from gesturediffusion_tpu.eval import metrics as jm
from gesturediffusion_tpu.eval.eval_a2m import A2MEvaluation as JaxA2MEvaluation
from gesturediffusion_tpu_torch.eval import metrics as pm
from gesturediffusion_tpu_torch.eval.eval_a2m import A2MEvaluation

RTOL = 1e-10


def _feats(n, d, seed):
    return np.random.RandomState(seed).randn(n, d)


def _rank_deficient_pair():
    """3 samples of 30 features each: a covariance product on which scipy's
    sqrtm gives up (it succeeds on most singular products)."""
    rs = np.random.RandomState(3)
    return rs.randn(3, 30), rs.randn(3, 30) * 1.5


CASES = {
    "euclidean_distance_matrix": lambda M: M.euclidean_distance_matrix(_feats(9, 5, 0),
                                                                       _feats(7, 5, 1)),
    "calculate_top_k": lambda M: M.calculate_top_k(
        np.argsort(_feats(8, 8, 2), axis=1), 3).astype(np.float64),
    "calculate_R_precision": lambda M: M.calculate_R_precision(
        _feats(16, 6, 3), _feats(16, 6, 4) * 0.1 + _feats(16, 6, 3), 3,
        sum_all=True).astype(np.float64),
    "calculate_matching_score": lambda M: M.calculate_matching_score(
        _feats(10, 4, 5), _feats(10, 4, 6), sum_all=True),
    "calculate_activation_statistics": lambda M: np.concatenate(
        [a.ravel() for a in M.calculate_activation_statistics(_feats(40, 6, 7))]),
    "calculate_diversity": lambda M: M.calculate_diversity(_feats(50, 8, 8), 20),
    "calculate_multimodality": lambda M: M.calculate_multimodality(
        np.random.RandomState(9).randn(6, 12, 4), 5),
    "frechet_sqrtm": lambda M: M.calculate_frechet_distance(
        *M.calculate_activation_statistics(_feats(200, 8, 10)),
        *M.calculate_activation_statistics(_feats(150, 8, 11) + 0.5)),
    "frechet_psd_rank_deficient": lambda M: M.calculate_frechet_distance(
        *(v for x in _rank_deficient_pair() for v in M.calculate_activation_statistics(x))),
    "calculate_kid": lambda M: np.asarray(M.calculate_kid(
        _feats(60, 16, 14), _feats(50, 16, 15) + 0.2, n_subsets=7, subset_size=20)),
    "calculate_kid_whole_set": lambda M: np.asarray(M.calculate_kid(
        _feats(30, 16, 16), _feats(30, 16, 17), n_subsets=3, subset_size=1000)),
    "precision_and_recall": lambda M: np.asarray(M.precision_and_recall(
        _feats(40, 6, 18), _feats(45, 6, 19) + 0.3, k=3)),
    "get_metric_statistics": lambda M: np.concatenate(
        [np.ravel(a) for a in M.get_metric_statistics(_feats(20, 3, 20), 20)]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_metric_matches_jax(name):
    results = []
    for M in (jm, pm):
        np.random.seed(123)
        results.append(np.asarray(CASES[name](M), np.float64))
    np.testing.assert_allclose(results[1], results[0], rtol=RTOL, atol=0)


def test_rank_deficient_frechet_takes_the_psd_branch(monkeypatch):
    """On the rank-deficient pair scipy's sqrtm gives up and the port falls
    back to the PSD square root (two eigendecompositions); on full-rank
    covariances it takes scipy's branch."""
    calls = []
    real = pm.np.linalg.eigh

    def eigh(a):
        calls.append(a.shape)
        return real(a)

    monkeypatch.setattr(pm.np.linalg, "eigh", eigh)
    CASES["frechet_psd_rank_deficient"](pm)
    assert calls == [(30, 30), (30, 30)]
    calls.clear()
    CASES["frechet_sqrtm"](pm)
    assert calls == []


@pytest.mark.parametrize("unconstrained", [False, True])
def test_a2m_diversity_multimodality_matches_jax(unconstrained):
    """The quota-based multimodality draws from np.random in JAX's order;
    not every label is present (the denominator counts them all)."""
    rs = np.random.RandomState(21)
    acts = rs.randn(80, 30)
    labels = rs.choice([0, 2, 3, 7, 11], size=80)
    out = []
    for cls in (JaxA2MEvaluation, A2MEvaluation):
        np.random.seed(5)
        out.append(cls.diversity_multimodality(acts, labels, 12, unconstrained=unconstrained))
    np.testing.assert_allclose(out[1], out[0], rtol=RTOL, atol=0)
    assert np.isnan(out[1][1]) == unconstrained
