"""Port parity of text-to-motion training against the JAX package on the
CPU: MotionMDM's train-mode forward (models/mdm_t2m.py) against JAX's
``model.apply(..., train=True)``, three training steps of a small
MotionMDM (latent 64, 2 layers of heads of 16, ff 128) against
train/loop.py:make_train_step under injected timesteps and noise, the
generator as the one source of every training mask, the train split's
batches against the JAX loader, and the train CLI on a
``make_synthetic_humanml`` tree: checkpoint, resume, the port's predict CLI
and JAX's load_torch_checkpoint on the file it writes.

Tolerances: the forward rtol 2e-4 / atol 2e-5 (test_torch_t2m.py's:
float32 reassociation); the steps those of
test_torch_train.py::test_three_steps_match_jax_make_train_step (loss rtol
1e-4, gradient norm rtol 1e-3, parameters atol 1e-4 with a mean deviation
below 1e-7); the JAX forward of the port's checkpoint atol 1e-5.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gesturediffusion_tpu.models.mdm_t2m as jax_mdm_t2m
import gesturediffusion_tpu.ops.pallas_encoder_train as jax_encoder_train
from gesturediffusion_tpu.data.registry import get_dataset_loader as jax_loader
from gesturediffusion_tpu.diffusion import gaussian as jg
from gesturediffusion_tpu.models.embeddings import PositionalEncoding as JaxPE
from gesturediffusion_tpu.models.mdm_t2m import MotionMDM as JaxMotionMDM
from gesturediffusion_tpu.train import loop as jloop
from gesturediffusion_tpu.utils.convert_torch import load_torch_checkpoint
from gesturediffusion_tpu_torch.data.humanml import make_synthetic_humanml
from gesturediffusion_tpu_torch.data.registry import get_dataset_loader
from gesturediffusion_tpu_torch.diffusion import gaussian as pg
from gesturediffusion_tpu_torch.diffusion.resample import UniformSampler
from gesturediffusion_tpu_torch.models import transformer as port_transformer
from gesturediffusion_tpu_torch.models.mdm_t2m import MotionMDM
from gesturediffusion_tpu_torch.sample import predict
from gesturediffusion_tpu_torch.train import loop as ploop
from gesturediffusion_tpu_torch.train import train_mdm
from gesturediffusion_tpu_torch.utils.convert import (
    load_checkpoint,
    motion_mdm_state_dict_from_params,
)
from tests.torch_port_common import (
    SMALL_T2M,
    build_t2m_pair,
    make_t2m_inputs,
    threefry_prng,  # noqa: F401 (autouse fixture)
    to_jax,
    to_torch,
)

RTOL, ATOL = 2e-4, 2e-5
NJ = 263


def _train_forward(jax_model, params, port, cond_mode, rngs):
    x, t, cond = make_t2m_inputs(3, NJ, cond_mode, seed=1)
    want = np.asarray(jax_model.apply(params, jnp.asarray(x), jnp.asarray(t), to_jax(cond),
                                      train=True, rngs=rngs))
    got = port(torch.from_numpy(x), torch.from_numpy(t), to_torch(cond), train=True,
               generator=torch.Generator().manual_seed(0))
    return got.detach().numpy(), want


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused-train-layer"])
@pytest.mark.parametrize("cond_mode", ["text", "action", "no_cond"])
def test_train_forward_matches_jax_without_dropout(cond_mode, fused):
    jax_model, params, port = build_t2m_pair(cond_mode, NJ, dropout=0.0, cond_mask_prob=0.0,
                                             use_fused_train_encoder=fused)
    got, want = _train_forward(jax_model, params, port, cond_mode,
                               {"dropout": jax.random.PRNGKey(1)})
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_fused_train_layers_match_jax_at_dropout(monkeypatch):
    """Layer dropout 0.1 through the hash-dropout layer (JAX: the Pallas
    training kernels in interpret mode; the port: its plain twin on the
    CPU), each layer on the int32 seed JAX drew for it.  The positional
    encoding's Bernoulli dropout, drawn from another generator in each
    package, is 0 on both sides."""
    seeds = []
    make = jax_encoder_train.make_fused_train_layer

    def recording(*args, **kwargs):
        layer = make(*args, **kwargs)

        def run(*xs):
            seeds.append(int(xs[-1]))
            return layer(*xs)

        return run

    monkeypatch.setattr(jax_encoder_train, "make_fused_train_layer", recording)
    monkeypatch.setattr(jax_mdm_t2m, "PositionalEncoding",
                        lambda d, rate, name: JaxPE(d, 0.0, name=name))
    jax_model, params, port = build_t2m_pair("text", NJ, cond_mask_prob=0.0,
                                             use_fused_train_encoder=True)
    port.sequence_pos_encoder.dropout = 0.0
    replay = []
    layer = port_transformer.fused_encoder_layer_train

    def replaying(*args, seed, **kwargs):
        return layer(*args, seed=torch.tensor([replay.pop(0)], dtype=torch.int32), **kwargs)

    monkeypatch.setattr(port_transformer, "fused_encoder_layer_train", replaying)
    x, t, cond = make_t2m_inputs(3, NJ, "text", seed=1)
    want = np.asarray(jax_model.apply(params, jnp.asarray(x), jnp.asarray(t), to_jax(cond),
                                      train=True, rngs={"dropout": jax.random.PRNGKey(1)}))
    assert len(seeds) == SMALL_T2M["num_layers"] and len(set(seeds)) == len(seeds)
    replay[:] = seeds
    got = port(torch.from_numpy(x), torch.from_numpy(t), to_torch(cond), train=True,
               generator=torch.Generator().manual_seed(0)).detach().numpy()
    assert not replay
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with torch.no_grad():
        assert np.abs(got - port(torch.from_numpy(x), torch.from_numpy(t),
                                 to_torch(cond)).numpy()).max() > 1e-3  # dropout acted


@pytest.mark.parametrize("source", ["cond_mask", "positional", "plain_layers",
                                    "fused_layers"])
def test_train_mode_draws_each_mask_from_the_generator(source):
    """Each of the conditioning mask, the positional encoding's dropout and
    the encoder's dropout alone: the same generator seed gives the same
    output, another seed another, and eval mode neither."""
    kw = dict(SMALL_T2M, njoints=NJ, cond_mode="text", dropout=0.0, cond_mask_prob=0.0)
    if source == "cond_mask":
        kw["cond_mask_prob"] = 0.5
    elif source in ("plain_layers", "fused_layers"):
        kw.update(dropout=0.3, use_fused_train_encoder=source == "fused_layers")
    torch.manual_seed(0)
    port = MotionMDM(**kw)
    if source == "positional":
        port.sequence_pos_encoder.dropout = 0.3
    else:
        port.sequence_pos_encoder.dropout = 0.0
    x, t, cond = make_t2m_inputs(4, NJ, "text", seed=2)
    args = (torch.from_numpy(x), torch.from_numpy(t), to_torch(cond))

    def run(seed):
        return port(*args, train=True, generator=torch.Generator().manual_seed(seed)).detach()

    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    assert (run(1) - run(2)).abs().max() > 1e-3
    with torch.no_grad():
        assert (run(1) - port(*args)).abs().max() > 1e-3


def _t2m_batches(n, b, t, seed=3):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        mask = np.ones((b, 1, 1, t), bool)
        mask[-1, ..., t // 2:] = False  # a shorter clip
        out.append(dict(
            motion=rs.randn(b, NJ, 1, t).astype(np.float32) * 0.5,
            cond=dict(text_emb=rs.randn(b, 512).astype(np.float32), mask=mask),
            t=rs.randint(0, 8, size=b).astype(np.int32),
            noise=rs.randn(b, NJ, 1, t).astype(np.float32),
        ))
    return out


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused-train-layer"])
def test_three_steps_match_jax_make_train_step(fused):
    """Dropout 0 and cond_mask_prob 0 make the step deterministic; with
    use_fused_train_encoder the JAX side runs the Pallas training kernels
    in interpret mode and the port its plain hash-dropout layer."""
    jax_model, params, port = build_t2m_pair("text", NJ, dropout=0.0, cond_mask_prob=0.0,
                                             use_fused_train_encoder=fused)
    lr, wd = 1e-3, 0.1
    dj = jg.create_diffusion(steps=8, noise_schedule="cosine")
    dp = pg.create_diffusion(steps=8, noise_schedule="cosine")
    jcfg = jloop.TrainConfig(lr=lr, weight_decay=wd)
    tx = jloop.make_optimizer(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jloop.TrainState(step=jnp.asarray(0, jnp.int32), params=jparams,
                              opt_state=tx.init(jparams), ema_params={},
                              sampler=jloop.create_named_schedule_sampler("uniform", 8))

    def apply_fn(p, x, t, c, rngs=None):
        return jax_model.apply(p, x, t, c, train=True, rngs=rngs)

    jstep = jloop.make_train_step(dj, apply_fn, tx, jcfg)
    pcfg = ploop.TrainConfig(lr=lr, weight_decay=wd)
    opt, sched = ploop.make_optimizer(port.parameters(), pcfg)
    pstate = ploop.TrainState(port, opt, sched, UniformSampler(8), {})
    gen = torch.Generator().manual_seed(0)
    for batch in _t2m_batches(3, 4, 20):
        jstate, jm = jstep(jstate, jnp.asarray(batch["motion"]), to_jax(batch["cond"]),
                           jax.random.PRNGKey(0), jnp.asarray(batch["t"]),
                           jnp.asarray(batch["noise"]))
        pm = ploop.train_step(pstate, dp, pcfg, torch.from_numpy(batch["motion"]),
                              to_torch(batch["cond"]), gen, torch.from_numpy(batch["t"]).long(),
                              torch.from_numpy(batch["noise"]))
        np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(pm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-3)
    assert pstate.step == 3 and pstate.nonfinite_skips == 0
    want = motion_mdm_state_dict_from_params(jax.tree_util.tree_map(np.asarray, jstate.params))
    got = port.state_dict()
    d = SMALL_T2M["latent_dim"]
    diffs = []
    for k, v in want.items():
        a, b = got[k].numpy(), v.numpy()
        if k.endswith("in_proj_bias"):
            # the key bias gets an exactly zero gradient (softmax is
            # shift-invariant); Adam turns its rounding noise into +-lr
            # steps that differ between frameworks
            a, b = np.delete(a, np.s_[d:2 * d]), np.delete(b, np.s_[d:2 * d])
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=k)
        diffs.append(np.abs(a - b).ravel())
    assert np.concatenate(diffs).mean() < 1e-7


# ---- the train split and the train CLI ---------------------------------- #
@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_synthetic_humanml(str(tmp_path_factory.mktemp("hml") / "tree"), n_clips=30,
                                  seed=4)


def test_train_batches_equal_the_jax_loader(tree):
    """Two shuffled batches of the train split: motion padded to 196
    frames, captions, lengths and the length mask."""
    kw = dict(batch_size=4, num_frames=120, split="train", datapath=tree, num_workers=1,
              seed=3)
    got_it, want_it = iter(get_dataset_loader("humanml", **kw)), iter(jax_loader("humanml", **kw))
    for _ in range(2):
        (got, gc), (want, wc) = next(got_it), next(want_it)
        assert got.shape == (4, NJ, 1, 196)
        np.testing.assert_array_equal(got, want)
        assert gc["text"] == wc["text"]
        np.testing.assert_array_equal(gc["lengths"], wc["lengths"])
        np.testing.assert_array_equal(gc["mask"], wc["mask"])
        assert gc["mask"].sum(-1).ravel().tolist() == gc["lengths"].tolist()


CLI = ["--device", "cpu", "--dataset", "humanml", "--layers", "2", "--latent_dim", "64",
       "--batch_size", "4", "--diffusion_steps", "8", "--log_interval", "1"]


@pytest.fixture(scope="module")
def trained(tree, tmp_path_factory):
    save = tmp_path_factory.mktemp("t2m_train") / "run"
    loop = train_mdm.main(CLI + ["--data_dir", tree, "--save_dir", str(save), "--num_steps", "2",
                                 "--use_fused_train_encoder"])
    return save, loop


def test_train_cli_writes_resumes_and_embeds_the_captions(trained, tree):
    save, loop = trained
    assert {"model000000002.pt", "opt000000002.pt", "args.json"} <= set(os.listdir(save))
    with open(save / "args.json") as f:
        args = json.load(f)
    assert args["dataset"] == "humanml" and args["use_fused_train_encoder"]
    assert loop.text_encoder is not None and loop.state.step == 2
    assert loop.state.model.cond_mode == "text"
    assert isinstance(loop.state.model.seqTransEncoder.layers[0],
                      port_transformer.FusedTrainEncoderLayer)
    resumed = train_mdm.main(CLI + ["--data_dir", tree, "--save_dir", str(save), "--num_steps",
                                    "3", "--use_fused_train_encoder", "--resume_checkpoint",
                                    "latest", "--overwrite"])
    assert resumed.resume_step == 2 and resumed.state.step == 3
    assert "model000000003.pt" in os.listdir(save)


def test_train_cli_unconstrained_trains_no_cond(tree, tmp_path):
    loop = train_mdm.main(CLI + ["--data_dir", tree, "--save_dir", str(tmp_path / "run"),
                                 "--num_steps", "1", "--unconstrained"])
    assert loop.state.model.cond_mode == "no_cond" and loop.text_encoder is None
    assert not hasattr(loop.state.model, "embed_text")


def test_checkpoint_is_read_by_predict_and_jax(trained, tmp_path, capsys):
    save, _ = trained
    path = str(save / "model000000002.pt")
    out = predict.main(["--model_path", path, "--text", "a person walks", "--num_repetitions",
                        "1", "--motion_length", "2", "--latent_dim", "64", "--layers", "2",
                        "--diffusion_steps", "8", "--device", "cpu",
                        "--output_dir", str(tmp_path / "pred")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["frames"] == 40 and os.path.exists(os.path.join(out, "results.npy"))

    jm = JaxMotionMDM(njoints=NJ, latent_dim=64, num_layers=2, ff_size=1024, num_heads=4,
                      cond_mode="text", cond_mask_prob=0.1)
    variables = load_torch_checkpoint(path, jm)
    port = MotionMDM(njoints=NJ, latent_dim=64, num_layers=2, ff_size=1024, num_heads=4,
                     cond_mode="text", cond_mask_prob=0.1)
    port.load_state_dict(load_checkpoint(path))
    x, t, cond = make_t2m_inputs(2, NJ, "text", seed=5)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), jnp.asarray(t), to_jax(cond)))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x), torch.from_numpy(t), to_torch(cond)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dataset", ["humanact12", "uestc"])
def test_action_datasets_still_raise_naming_a12(dataset, tmp_path, monkeypatch):
    """The A12 refusal is lifted: the train CLI trains the action datasets
    (tests/test_torch_a2m_train.py holds them against JAX) as action-mode
    MotionMDMs with no text encoder.  Since A8a their in-training
    evaluation runs too: the a2m benchmark (the GRU classifier on
    humanact12, the ST-GCN on both UESTC splits) after the in-loop save."""
    from gesturediffusion_tpu_torch.data.a2m import make_synthetic_humanact12
    from gesturediffusion_tpu_torch.data.uestc import make_synthetic_uestc
    from gesturediffusion_tpu_torch.models.smpl import save_synthetic_smpl_pickle

    monkeypatch.setenv("SMPL_MODEL_PATH",
                       save_synthetic_smpl_pickle(str(tmp_path / "smpl.pkl"), 128))
    root = str(tmp_path / dataset)
    (make_synthetic_humanact12 if dataset == "humanact12" else make_synthetic_uestc)(root)
    loop = train_mdm.main(["--device", "cpu", "--dataset", dataset, "--data_dir", root,
                           "--layers", "1", "--latent_dim", "32", "--batch_size", "4",
                           "--num_frames", "40", "--num_steps", "2", "--save_interval", "1",
                           "--diffusion_steps", "4", "--eval_during_training",
                           "--eval_num_samples", "4", "--eval_batch_size", "4",
                           "--eval_rep_times", "1", "--save_dir", str(tmp_path / "run")])
    assert loop.state.model.cond_mode == "action" and loop.text_encoder is None
    assert loop.state.step == 2
    seen = loop.eval_fn(loop.state, 2)
    suffix = "_test" if dataset == "uestc" else ""
    assert {f"accuracy_gen{suffix}", f"fid_gen{suffix}"} <= set(seen)
