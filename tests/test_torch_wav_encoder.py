"""Port parity of the wav-encoder MDM (models/mdm.py:WavEncoder and MDM's
raw-audio input) against the JAX package on the CPU: the encoder in
evaluation and training mode, its BatchNorm running statistics after 1-3
training calls against flax's mutated ``batch_stats`` (and a control:
torch's stock BatchNorm1d fails that check where n / (n - 1) shows), the
model's forward with the audio features padded and cropped to the motion's
frames, the weights from JAX variables and from a JAX-exported ``.pt``,
the sampling selector, a 2-chunk chunked-AR take under the JAX chain's
noise, three train steps with microbatches against
train/loop.py:make_train_step (the running statistics included), a
non-finite step, and the train, generate and demo CLIs on a synthetic
GENEA tree against the JAX CLIs.

Tolerances: forward rtol 2e-4, atol 2e-5 (float32 reassociation, as
tests/test_torch_mdm.py); the running statistics the same; the train
steps as tests/test_torch_train.py (loss rtol 1e-4, gradient norm 1e-3,
parameters atol 1e-4 after three Adam steps with a mean deviation below
1e-7)."""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gesturediffusion_tpu.diffusion import gaussian as jg
from gesturediffusion_tpu.diffusion.sampling import autoregressive_sample_loop as jax_ar_loop
from gesturediffusion_tpu.models.mdm import MDM as JaxMDM
from gesturediffusion_tpu.models.mdm import WavEncoder as JaxWavEncoder
from gesturediffusion_tpu.models.mdm_fastpath import (
    select_sampling_model_fn as jax_select_sampling_model_fn,
)
from gesturediffusion_tpu.sample import generate as jax_generate
from gesturediffusion_tpu.serve import demo as jax_demo
from gesturediffusion_tpu.train import loop as jloop
from gesturediffusion_tpu.train import train_mdm as jax_train_mdm
from gesturediffusion_tpu.utils.convert_torch import load_torch_checkpoint, save_torch_checkpoint
from gesturediffusion_tpu_torch.data.synthetic import make_synthetic_genea2023
from gesturediffusion_tpu_torch.diffusion import gaussian as pg
from gesturediffusion_tpu_torch.diffusion.resample import UniformSampler
from gesturediffusion_tpu_torch.diffusion.sampling import autoregressive_sample_loop
from gesturediffusion_tpu_torch.models.mdm import MDM
from gesturediffusion_tpu_torch.models.mdm_fastpath import select_sampling_model_fn
from gesturediffusion_tpu_torch.sample import generate
from gesturediffusion_tpu_torch.serve import demo
from gesturediffusion_tpu_torch.train import loop as ploop
from gesturediffusion_tpu_torch.train import train_mdm
from gesturediffusion_tpu_torch.utils.convert import load_weights, state_dict_from_params
from tests.torch_port_common import threefry, to_jax, to_torch, torch_threads
from tests.torch_port_common import threefry_prng  # noqa: F401 (autouse fixture)
from tests.test_torch_genea_cli import _bytes, _files, _results, _val_wav, no_video  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread_for_the_module():
    """torch on one CPU thread for the module's fixtures and tests
    (torch_port_common.one_torch_thread: the suite's workers share the
    cores)."""
    with torch_threads(1):
        yield


# J 12, D 32, 2 layers of 4 heads, 4 local heads, window 5
WAV = dict(njoints=12, latent_dim=32, num_layers=2, ff_size=64, num_heads=4, seed_poses=4,
           cond_mask_prob=0.1, window_size=5, cl_head=4, mfcc_input=False, use_wav_enc=True)
# 24000 samples: the convolutions give 5438, 1077, 196 and 3 frames; the
# last BatchNorm normalises n = 2 x 196 values, where n / (n - 1) shows
L_SHORT = 24000
NORMS = (1, 4, 7)
CONV_BIASES_BEFORE_NORMS = tuple(f"wav_encoder.feat_extractor.{i}.bias" for i in (0, 3, 6))


def _audio(b, n, seed):
    return (np.random.RandomState(seed).randn(b, n) * 0.3).astype(np.float32)


def _inputs(b, t, spf, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, 12, 1, t).astype(np.float32)
    cond = {"audio": _audio(b, t * spf, seed + 100),
            "seed": rs.randn(b, 12, 1, 4).astype(np.float32)}
    return x, rs.randint(0, 1000, size=(b,)).astype(np.int32), cond


def _perturbed(variables, seed=1):
    """The variables as numpy, the BatchNorm scales, biases and running
    statistics moved off their initial values so that each is read."""
    v = jax.tree_util.tree_map(np.array, variables)
    rs = np.random.RandomState(seed)
    for i in range(3):
        bn, st = v["params"]["wav_encoder"][f"bn_{i}"], v["batch_stats"]["wav_encoder"][f"bn_{i}"]
        bn["scale"] += rs.randn(*bn["scale"].shape).astype(np.float32) * 0.2
        bn["bias"] += rs.randn(*bn["bias"].shape).astype(np.float32) * 0.2
        st["mean"] += rs.randn(*st["mean"].shape).astype(np.float32) * 0.1
        st["var"] = (0.5 + rs.rand(*st["var"].shape)).astype(np.float32)
    return v


@pytest.fixture(scope="module")
def pair():
    """(JAX wav-encoder MDM, its variables with moved BatchNorm values, the
    port model with the same weights, in evaluation mode)."""
    jax_model = JaxMDM(**WAV)
    x, t, cond = _inputs(2, 16, 1500)
    with threefry():
        variables = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                                   to_jax(cond))
    variables = _perturbed(variables)
    port = MDM(**WAV)
    port.load_state_dict(state_dict_from_params(variables, cl_head=WAV["cl_head"]))
    return jax_model, variables, port.eval()


def _encoder_vars(variables):
    return {"params": variables["params"]["wav_encoder"],
            "batch_stats": variables["batch_stats"]["wav_encoder"]}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_wav_encoder_matches_jax(pair, train):
    _, variables, port = pair
    wav = _audio(3, L_SHORT + 5000, 2)
    out = JaxWavEncoder().apply(_encoder_vars(variables), jnp.asarray(wav), train=train,
                                mutable=["batch_stats"] if train else False)
    want = np.asarray(out[0] if train else out)
    enc = copy.deepcopy(port.wav_encoder).train(train)  # training moves its statistics
    with torch.no_grad():
        got = enc(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (3, 32, 11)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _train_calls(encoder_vars, enc, calls, b=2):
    """``calls`` training-mode calls of the JAX encoder (threading its
    mutated batch_stats) and of the port's ``enc``, on the same audio;
    returns JAX's final batch_stats."""
    stats = encoder_vars["batch_stats"]
    enc.train()
    for k in range(calls):
        wav = _audio(b, L_SHORT, 10 + k)
        _, new = JaxWavEncoder().apply({"params": encoder_vars["params"], "batch_stats": stats},
                                       jnp.asarray(wav), train=True, mutable=["batch_stats"])
        stats = new["batch_stats"]
        with torch.no_grad():
            enc(torch.from_numpy(wav))
    enc.eval()
    return jax.tree_util.tree_map(np.asarray, stats)


@pytest.mark.parametrize("calls", [1, 2, 3])
def test_running_stats_follow_jax(pair, calls):
    """Flax moves them 1 % a call with the biased variance E[x^2] - E[x]^2."""
    _, variables, port = pair
    enc = MDM(**WAV).wav_encoder
    enc.load_state_dict(port.wav_encoder.state_dict())
    want = _train_calls(_encoder_vars(variables), enc, calls)
    for i, bi in enumerate(NORMS):
        bn = enc.feat_extractor[bi]
        np.testing.assert_allclose(bn.running_mean.numpy(), want[f"bn_{i}"]["mean"],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(bn.running_var.numpy(), want[f"bn_{i}"]["var"],
                                   rtol=RTOL, atol=ATOL)
        assert int(bn.num_batches_tracked) == calls


def _variance_intake(variables, stock: bool):
    """The running variances after one training call from zero running
    variances, where the port's BatchNorm (or, with ``stock``, torch's
    BatchNorm1d at flax's 1 % rate) stands against JAX's: the batch
    variance that went in, relative (atol 0)."""
    ev = _encoder_vars(variables)
    ev = {"params": ev["params"], "batch_stats": jax.tree_util.tree_map(
        lambda a: np.zeros_like(a), ev["batch_stats"])}
    enc = MDM(**WAV).wav_encoder
    sd = state_dict_from_params({"params": {**variables["params"]},
                                 "batch_stats": {"wav_encoder": ev["batch_stats"]}},
                                cl_head=WAV["cl_head"])
    enc.load_state_dict({k[len("wav_encoder."):]: v for k, v in sd.items()
                         if k.startswith("wav_encoder.")})
    if stock:
        for bi in NORMS:
            mine = enc.feat_extractor[bi]
            bn = torch.nn.BatchNorm1d(mine.weight.shape[0], eps=1e-5, momentum=0.01)
            bn.load_state_dict(mine.state_dict())
            enc.feat_extractor[bi] = bn
    want = _train_calls(ev, enc, 1)
    for i, bi in enumerate(NORMS):
        np.testing.assert_allclose(enc.feat_extractor[bi].running_var.numpy(),
                                   want[f"bn_{i}"]["var"], rtol=RTOL, atol=0)


def test_running_variance_is_the_biased_one(pair):
    _variance_intake(pair[1], stock=False)


def test_stock_batchnorm1d_fails_the_running_stats_check(pair):
    """torch's BatchNorm1d stores the unbiased variance: 1 / (n - 1) apart,
    2.7e-3 at the last BatchNorm's n = 392."""
    with pytest.raises(AssertionError, match="Not equal to tolerance"):
        _variance_intake(pair[1], stock=True)


@pytest.mark.parametrize("t,spf", [(40, 600), (16, 3000)], ids=["padded", "cropped"])
def test_forward_matches_jax(pair, t, spf):
    """40 frames of 600 samples give the model 3 frames of features (the
    rest zeros); 16 frames of 3000 give 42, cropped to 16."""
    jax_model, variables, port = pair
    x, tt, cond = _inputs(3, t, spf, seed=3)
    cond["uncond"] = np.array([0.0, 1.0, 0.0], np.float32)
    want = np.asarray(jax_model.apply(variables, jnp.asarray(x), jnp.asarray(tt), to_jax(cond)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(tt), to_torch(cond)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_short_audio_gives_no_features_as_xla(pair):
    """Under ~1 s of audio the last convolution has no whole window: XLA
    gives 0 frames, which the model pads with zeros."""
    jax_model, variables, port = pair
    x, tt, cond = _inputs(2, 16, 700, seed=4)
    with torch.no_grad():
        assert port.wav_encoder(torch.from_numpy(cond["audio"])).shape == (2, 32, 0)
        got = port(torch.from_numpy(x), torch.from_numpy(tt), to_torch(cond)).numpy()
    want = np.asarray(jax_model.apply(variables, jnp.asarray(x), jnp.asarray(tt), to_jax(cond)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_jax_exported_checkpoint_loads_and_round_trips(pair, tmp_path):
    """The JAX exporter's ``.pt`` (num_batches_tracked included) loads onto
    the port model; the port's state dict converts back to the same JAX
    variables."""
    jax_model, variables, _ = pair
    path = save_torch_checkpoint(str(tmp_path / "model000000001.pt"), variables, jax_model)
    port = load_weights(MDM(**WAV), path).eval()
    x, tt, cond = _inputs(2, 40, 600, seed=5)
    want = np.asarray(jax_model.apply(variables, jnp.asarray(x), jnp.asarray(tt), to_jax(cond)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(tt), to_torch(cond)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    torch.save(port.state_dict(), tmp_path / "port.pt")
    back = load_torch_checkpoint(str(tmp_path / "port.pt"), jax_model)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_ar_take_through_the_selector_matches_jax(pair):
    """Both selectors take the module's own forward for a wav-encoder MDM,
    CFG-wrapped (mdm_fastpath.py:251); two chunks of a 4-step respaced
    DDPM under the JAX chain's noise, the raw audio a chunk."""
    jax_model, variables, port = pair
    b, t, c = 2, 16, 2
    rs = np.random.RandomState(6)
    audio = (rs.randn(c, b, t * 1500) * 0.3).astype(np.float32)
    scale = np.full((c, b), 2.5, np.float32)
    seed0 = rs.randn(b, 12, 1, 4).astype(np.float32)
    shape = (b, 12, 1, t)
    pre_j, fn_j = jax_select_sampling_model_fn(jax_model, variables, 2.5, 0.1)
    pre, fn = select_sampling_model_fn(port, 2.5, 0.1)
    assert pre_j is None and pre is None
    jd = jg.create_diffusion(steps=20, timestep_respacing="4")
    rng = jax.random.PRNGKey(7)
    want = np.asarray(jax.jit(lambda r, cc, s0: jax_ar_loop(jd, fn_j, shape, r, cc, s0, 4))(
        rng, {"audio": jnp.asarray(audio), "scale": jnp.asarray(scale)}, jnp.asarray(seed0)))

    def noise_fn(chunk, step, shp):
        key = jax.random.fold_in(jax.random.fold_in(rng, chunk), step)
        return torch.from_numpy(np.array(jax.random.normal(key, shp)))

    with torch.no_grad():
        got = autoregressive_sample_loop(
            pg.create_diffusion(steps=20, timestep_respacing="4", device="cpu"), fn, shape,
            {"audio": torch.from_numpy(audio), "scale": torch.from_numpy(scale)},
            torch.from_numpy(seed0), 4, generator=torch.Generator(), noise_fn=noise_fn)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-5)


def _batches(n, b, t, spf, seed=3):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        mask = np.ones((b, 1, 1, t), bool)
        mask[-1, ..., t // 2:] = False
        out.append(dict(
            motion=rs.randn(b, 12, 1, t).astype(np.float32) * 0.5,
            cond=dict(audio=(rs.randn(b, t * spf) * 0.3).astype(np.float32),
                      seed=rs.randn(b, 12, 1, 4).astype(np.float32) * 0.5, mask=mask),
            t=rs.randint(0, 8, size=b).astype(np.int32),
            noise=rs.randn(b, 12, 1, t).astype(np.float32)))
    return out


def _fresh_pair(variables):
    port = MDM(**{**WAV, "dropout": 0.0, "cond_mask_prob": 0.0})
    port.load_state_dict(state_dict_from_params(variables, cl_head=WAV["cl_head"]))
    return JaxMDM(**{**WAV, "dropout": 0.0, "cond_mask_prob": 0.0}), port


def test_three_steps_with_microbatches_match_jax_make_train_step(pair):
    """Batch 4 as 2 microbatches of 2: the running statistics move once a
    microbatch, in order, through JAX's model_state (loop.py:119-160,
    218-230, 262)."""
    variables = pair[1]
    jax_model, port = _fresh_pair(variables)
    lr, wd = 1e-3, 0.1
    dj = jg.create_diffusion(steps=8, noise_schedule="cosine")
    dp = pg.create_diffusion(steps=8, noise_schedule="cosine")
    jcfg = jloop.TrainConfig(lr=lr, weight_decay=wd, microbatch_size=2)
    jparams = {"params": jax.tree_util.tree_map(jnp.asarray, variables["params"])}
    # the convolution biases before the BatchNorms have an exactly zero
    # gradient (a training BatchNorm takes the mean off), and Adam turns its
    # rounding noise into +-lr steps that differ between frameworks and
    # reach the running means: both steps leave those three where they are
    biases = {("wav_encoder", f"conv_{i}", "bias") for i in range(3)}
    frozen = jax.tree_util.tree_map_with_path(
        lambda path, _: tuple(k.key for k in path[-3:]) in biases, jparams)
    tx = optax.chain(jloop.make_optimizer(jcfg), optax.masked(optax.set_to_zero(), frozen))
    for k in CONV_BIASES_BEFORE_NORMS:
        port.get_parameter(k).requires_grad_(False)
    jstate = jloop.TrainState(
        step=jnp.asarray(0, jnp.int32), params=jparams, opt_state=tx.init(jparams),
        ema_params={}, sampler=jloop.create_named_schedule_sampler("uniform", 8),
        model_state={"batch_stats": jax.tree_util.tree_map(jnp.asarray,
                                                           variables["batch_stats"])})

    def apply_fn(p, x, t, c, rngs=None, model_state=None):
        return jax_model.apply({**p, **model_state}, x, t, c, train=True, rngs=rngs,
                               mutable=["batch_stats"])

    jstep = jloop.make_train_step(dj, apply_fn, tx, jcfg)
    pcfg = ploop.TrainConfig(lr=lr, weight_decay=wd, microbatch_size=2)
    pstate = ploop.TrainState(port, *ploop.make_optimizer(port.parameters(), pcfg),
                              UniformSampler(8), {})
    gen = torch.Generator().manual_seed(0)
    for batch in _batches(3, 4, 16, 1500):
        jstate, jm = jstep(jstate, jnp.asarray(batch["motion"]), to_jax(batch["cond"]),
                           jax.random.PRNGKey(0), jnp.asarray(batch["t"]),
                           jnp.asarray(batch["noise"]))
        pm = ploop.train_step(pstate, dp, pcfg, torch.from_numpy(batch["motion"]),
                              to_torch(batch["cond"]), gen, torch.from_numpy(batch["t"]).long(),
                              torch.from_numpy(batch["noise"]))
        np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(pm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-3)
    want = state_dict_from_params(
        jax.tree_util.tree_map(np.asarray, {**jstate.params, **jstate.model_state}),
        cl_head=WAV["cl_head"])
    got, d, diffs = port.state_dict(), WAV["latent_dim"], []
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 6, k  # 3 steps x 2 microbatches (JAX exports 0)
            continue
        a, b = got[k].numpy(), v.numpy()
        if k.endswith("in_proj_bias"):  # the key bias: an exactly zero gradient
            a, b = np.delete(a, np.s_[d:2 * d]), np.delete(b, np.s_[d:2 * d])
        tol = (dict(rtol=RTOL, atol=ATOL) if "running" in k else dict(rtol=0, atol=1e-4))
        np.testing.assert_allclose(a, b, err_msg=k, **tol)
        diffs.append(np.abs(a - b).ravel())
    assert np.concatenate(diffs).mean() < 1e-7


def test_non_finite_step_keeps_the_running_stats(pair):
    """JAX keeps the old model_state on a skipped step (loop.py:262): the
    statistics its forward moved go back."""
    _, port = _fresh_pair(pair[1])
    cfg = ploop.TrainConfig(lr=1e-3)
    state = ploop.TrainState(port, *ploop.make_optimizer(port.parameters(), cfg),
                             UniformSampler(8), {})
    before = {k: v.clone() for k, v in port.state_dict().items()}
    batch = _batches(1, 2, 16, 1500)[0]
    motion = torch.from_numpy(batch["motion"].copy())
    motion[0, 0, 0, 0] = float("nan")
    m = ploop.train_step(state, pg.create_diffusion(steps=8), cfg, motion,
                         to_torch(batch["cond"]), torch.Generator().manual_seed(0))
    assert (state.nonfinite_skips, m["nonfinite_skips"]) == (1, 1)
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k
    ploop.train_step(state, pg.create_diffusion(steps=8), cfg, torch.from_numpy(batch["motion"]),
                     to_torch(batch["cond"]), torch.Generator().manual_seed(0))
    assert not torch.equal(port.wav_encoder.feat_extractor[1].running_mean,
                           before["wav_encoder.feat_extractor.1.running_mean"])


POSE, FRAMES = 24, 40
TINY = ["--layers", "1", "--latent_dim", "32", "--num_frames", str(FRAMES), "--use_wav_enc"]


@pytest.fixture(scope="module")
def wav_run(tmp_path_factory):
    """A wav-encoder checkpoint trained by the port's train CLI on a
    genea2023 tree's train split, and the tree."""
    root = tmp_path_factory.mktemp("wavcli")
    tree = make_synthetic_genea2023(str(root / "g2023"), n_takes=3, frames_per_take=240,
                                    pose_dim=POSE, seed=1)
    save = str(root / "run")
    train_mdm.main(["--device", "cpu", "--dataset", "genea2023", "--data_dir", tree,
                    "--save_dir", save, "--batch_size", "4", "--num_steps", "2",
                    "--use_fused_train_encoder", *TINY])
    return tree, os.path.join(save, "model000000002.pt")


def test_train_cli_trains_the_wav_encoder_as_jax_does(wav_run, tmp_path):
    """Both train CLIs take the same command line on the tree; each moves
    the running statistics and writes --use_wav_enc into its args.json.
    The port's file carries the statistics in the reference layout."""
    tree, ckpt = wav_run
    sd = torch.load(ckpt, weights_only=True)
    assert int(sd["wav_encoder.feat_extractor.1.num_batches_tracked"]) == 2
    assert sd["wav_encoder.feat_extractor.7.running_var"].ne(1).all()
    with open(os.path.join(os.path.dirname(ckpt), "args.json")) as f:
        assert json.load(f)["use_wav_enc"] is True
    jax_train_mdm.main(["--dataset", "genea2023", "--data_dir", tree, "--save_dir",
                        str(tmp_path / "jax"), "--batch_size", "4", "--num_steps", "1",
                        "--log_interval", "1", *TINY])
    with open(tmp_path / "jax" / "args.json") as f:
        assert json.load(f)["use_wav_enc"] is True
    loop = train_mdm.main(["--device", "cpu", "--dataset", "synthetic", "--save_dir",
                           str(tmp_path / "syn"), "--batch_size", "4", "--num_steps", "1",
                           *TINY])
    assert loop.state.model.reads_audio and loop.state.step == 1
    stats = loop.state.model.wav_encoder.feat_extractor[1].running_mean
    assert stats.ne(0).all()


def test_generate_cli_writes_what_jax_writes(wav_run, tmp_path, no_video):  # noqa: F811
    """A wav-encoder checkpoint samples GENEA takes from the batches' raw
    audio in both CLIs: the same files, the same ground truth and audio
    bytes."""
    _, ckpt = wav_run
    argv = ["--model_path", ckpt, "--num_samples", "2", "--timestep_respacing", "2"]
    port = generate.main(argv + ["--device", "cpu", "--output_dir", str(tmp_path / "port")])
    jax = jax_generate.main(argv + ["--output_dir", str(tmp_path / "jax")])
    assert _files(port) == _files(jax)
    for take in (f[: -len("_gt.bvh")] for f in _files(jax) if f.endswith("_gt.bvh")):
        for suffix in ("_gt.bvh", ".wav"):
            assert _bytes(os.path.join(port, take + suffix)) == \
                _bytes(os.path.join(jax, take + suffix)), take + suffix
    got, want = _results(port), _results(jax)
    assert sorted(got) == sorted(want) and got["text"] == want["text"]
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    assert got["motion"].shape == want["motion"].shape
    assert np.isfinite(got["motion"]).all()


def test_demo_streams_the_val_split_and_refuses_a_wav_as_jax_fails(wav_run, tmp_path):
    """From the val split's windows (raw audio kept) both demos stream; the
    --wav front end makes MFCCs, on which JAX's wav-encoder model fails with
    a KeyError at cond['audio'] and the port's demo refuses up front."""
    tree, ckpt = wav_run
    argv = ["--model_path", ckpt, "--streams", "2", "--num_chunks", "2", "--sampler", "ddim",
            "--sample_steps", "2"]
    port = demo.main(argv + ["--device", "cpu", "--output_dir", str(tmp_path / "port")])
    jax = jax_demo.main(argv + ["--output_dir", str(tmp_path / "jax")])
    assert _files(port) == _files(jax)
    assert _results(port)["motion"].shape == _results(jax)["motion"].shape
    wav = ["--wav", _val_wav({"genea2023": tree}, str(tmp_path / "take.wav"))]
    with pytest.raises(KeyError, match="audio"):
        jax_demo.main(argv + wav + ["--output_dir", str(tmp_path / "jax_wav")])
    with pytest.raises(KeyError, match="--use_wav_enc"):
        demo.main(argv + wav + ["--device", "cpu", "--output_dir", str(tmp_path / "port_wav")])
    assert not os.path.exists(tmp_path / "port_wav")
