"""Port parity of the evaluator classifiers against the JAX package on the
CPU: ``gru_cell`` and ``masked_gru`` in both directions at ragged lengths,
the HumanAct12 GRU classifier (``MotionDiscriminator``: logits and FID
features), ``build_graph`` for every layout and partition, and both ST-GCN
variants (``recognition`` on smpl, ``modi`` on openpose15) with non-zero
running statistics, the JAX weights drawn under threefry2x32 and carried
across with utils/convert.py; and the released tars' layouts loading as
they are.

Tolerances: float32 atol 1e-5 (the same products in another order: GRU
gates over 20 frames, ten blocks of convolutions and BatchNorms); the
graph exactly (the same numpy code).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.eval import networks as jn
from gesturediffusion_tpu.eval import stgcn as jst
from gesturediffusion_tpu_torch.eval import networks as pn
from gesturediffusion_tpu_torch.eval import stgcn as pst
from gesturediffusion_tpu_torch.eval.eval_a2m import A2MEvaluation, STGCNA2MEvaluation
from gesturediffusion_tpu_torch.utils.convert import (
    motion_discriminator_state_dict_from_params,
    stgcn_state_dict_from_variables,
)
from tests.torch_port_common import threefry, threefry_prng  # noqa: F401 (autouse fixture)

ATOL = 1e-5
LENGTHS = np.array([20, 7, 1, 13, 20, 4], np.int32)


def _gru_params(rs, d, h):
    return {k: (rs.randn(*shape) * 0.3).astype(np.float32) for k, shape in (
        ("w_ih", (3 * h, d)), ("w_hh", (3 * h, h)), ("b_ih", (3 * h,)), ("b_hh", (3 * h,)))}


def test_gru_cell_matches_jax():
    rs = np.random.RandomState(0)
    p = _gru_params(rs, 5, 8)
    h, x = rs.randn(4, 8).astype(np.float32), rs.randn(4, 5).astype(np.float32)
    want = np.asarray(jn.gru_cell(jnp.asarray(h), jnp.asarray(x), *map(jnp.asarray, p.values())))
    got = pn.gru_cell(torch.from_numpy(h), torch.from_numpy(x),
                      *map(torch.from_numpy, p.values())).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_masked_gru_matches_jax_at_ragged_lengths(reverse):
    """Outputs and the last state, frozen past each sample's length
    forward and starting at its last valid frame in reverse (the
    bidirectional text evaluators' backward direction)."""
    rs = np.random.RandomState(1)
    p = _gru_params(rs, 6, 16)
    x = rs.randn(len(LENGTHS), 20, 6).astype(np.float32)
    h0 = rs.randn(len(LENGTHS), 16).astype(np.float32)
    want_out, want_h = jn.masked_gru(jnp.asarray(x), jnp.asarray(LENGTHS), jnp.asarray(h0),
                                     {k: jnp.asarray(v) for k, v in p.items()}, reverse=reverse)
    got_out, got_h = pn.masked_gru(torch.from_numpy(x), torch.from_numpy(LENGTHS),
                                   torch.from_numpy(h0),
                                   {k: torch.from_numpy(v) for k, v in p.items()},
                                   reverse=reverse)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def discriminator():
    jm = jn.MotionDiscriminator(input_size=72, output_size=12)
    jf = jn.MotionDiscriminator(input_size=72, output_size=12, return_fid_features=True)
    with threefry():
        params = jm.init(jax.random.PRNGKey(3), jnp.zeros((2, 24, 3, 8)),
                         jnp.asarray([8, 8]))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    port = pn.MotionDiscriminator(72, output_size=12)
    port.load_state_dict(motion_discriminator_state_dict_from_params(params))
    return jm, jf, params, port.eval()


@pytest.mark.parametrize("hidden", [False, True])
def test_motion_discriminator_matches_jax(discriminator, hidden):
    """Logits and the tanh(linear1) features at ragged lengths, from zeros
    (JAX's default) and from an explicit hidden state."""
    jm, jf, params, port = discriminator
    rs = np.random.RandomState(2)
    motion = rs.randn(len(LENGTHS), 24, 3, 20).astype(np.float32)
    h = rs.randn(2, len(LENGTHS), 128).astype(np.float32) if hidden else None
    args = (jnp.asarray(motion), jnp.asarray(LENGTHS), None if h is None else jnp.asarray(h))
    want_logits = np.asarray(jm.apply({"params": params}, *args))
    want_feats = np.asarray(jf.apply({"params": params}, *args))
    with torch.no_grad():
        logits, feats = port(torch.from_numpy(motion), torch.from_numpy(LENGTHS),
                             None if h is None else torch.from_numpy(h))
    np.testing.assert_allclose(feats.numpy(), want_feats, rtol=0, atol=ATOL)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0, atol=ATOL)


def test_the_released_gru_tar_layout_loads_as_it_is(discriminator, tmp_path):
    """A humanact12_gru.tar-layout file ({"model": state dict}) loads into
    A2MEvaluation unconverted, and JAX's converter reads the same file."""
    jm, _, params, port = discriminator
    path = str(tmp_path / "humanact12_gru.tar")
    torch.save({"model": port.state_dict()}, path)
    ev = A2MEvaluation(checkpoint_path=path, device="cpu")
    for k, v in port.state_dict().items():
        assert torch.equal(ev.classifier.state_dict()[k], v), k
    from gesturediffusion_tpu.eval.eval_a2m import A2MEvaluation as JaxA2MEvaluation

    back = JaxA2MEvaluation.load_torch_checkpoint(path)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, back, params))


LAYOUTS = ["openpose", "openpose15", "smpl", "smpl_noglobal", "ntu-rgb+d"]


@pytest.mark.parametrize("strategy", ["uniform", "distance", "spatial"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_build_graph_equals_jax(layout, strategy):
    np.testing.assert_array_equal(pst.build_graph(layout, strategy),
                                  jst.build_graph(layout, strategy))


def _perturbed(variables, seed):
    """The JAX variables with running statistics, BatchNorm affines and
    edge importances moved off their initial values."""
    rs = np.random.RandomState(seed)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        a = np.array(tree, np.float32)
        if name == "var":
            return rs.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("mean", "scale", "bias") or name.startswith("edge_importance"):
            return (a + rs.randn(*a.shape) * 0.1).astype(np.float32)
        return a

    return walk(jax.tree_util.tree_map(np.asarray, variables))


VARIANTS = {
    "recognition": dict(in_channels=6, num_class=40, layout="smpl", variant="recognition"),
    "modi": dict(in_channels=3, num_class=12, layout="openpose15", variant="modi"),
}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def stgcn_pair(request):
    kw = VARIANTS[request.param]
    jm = jst.STGCN(strategy="spatial", edge_importance_weighting=True, **kw)
    v = jst.build_graph(kw["layout"]).shape[1]
    with threefry():
        variables = jm.init(jax.random.PRNGKey(4), jnp.zeros((2, kw["in_channels"], 16, v)))
    variables = _perturbed(variables, 5)
    port = pst.STGCN(strategy="spatial", edge_importance_weighting=True, **kw)
    port.load_state_dict(stgcn_state_dict_from_variables(variables))
    return request.param, jm, variables, port.eval()


@pytest.mark.parametrize("t", [16, 21])
def test_stgcn_matches_jax(stgcn_pair, t):
    """Logits and the pooled 256 features of both variants, at a length
    each stride divides and at one it does not."""
    name, jm, variables, port = stgcn_pair
    rs = np.random.RandomState(6)
    x = rs.randn(3, port.data_bn.num_features // port.A.shape[1], t,
                 port.A.shape[1]).astype(np.float32)
    want_logits, want_feats = jm.apply(variables, jnp.asarray(x), return_features=True)
    port.train()  # frozen evaluation: the running statistics whatever the mode
    with torch.no_grad():
        logits, feats = port(torch.from_numpy(x), return_features=True)
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_feats), rtol=0, atol=ATOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=0, atol=ATOL)
    assert feats.shape == (3, 256)
    port.eval()


def test_the_released_stgcn_tar_layout_loads_as_it_is(stgcn_pair, tmp_path):
    """A reference-layout tar ({"model": state dict} with the graph buffer
    ``A``) loads into the evaluation objects unconverted, JAX's
    load_stgcn_checkpoint reads the same file, and a tar of another layout
    is refused."""
    name, jm, variables, port = stgcn_pair
    path = str(tmp_path / "stgcn.tar")
    torch.save({"model": {**port.state_dict(), "A": port.A.clone()}}, path)
    if name == "recognition":
        ev = STGCNA2MEvaluation(checkpoint_path=path, device="cpu")
        model = ev.model
    else:
        from gesturediffusion_tpu_torch.eval.eval_unconstrained import UnconstrainedEvaluator

        model = UnconstrainedEvaluator(checkpoint_path=path, device="cpu").model
    for k, v in port.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    back = jst.load_stgcn_checkpoint(path)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: np.array_equal(np.asarray(a), np.asarray(b)), back, variables))
    other = pst.STGCN(in_channels=3, layout="openpose15" if name == "recognition" else "smpl",
                      variant="modi")
    with pytest.raises(ValueError, match="graph"):
        pst.load_stgcn_checkpoint(path, other)
