"""The port's counterpart of tests/test_eval_closed_loop.py: the metric
stack must rank models, not only run.  Hermetic, through the code paths
the benchmarks use, on the CPU, all in the port:

  t2m: a synthetic paired text <-> motion world of K classes; the T2M
  evaluators retrained from scratch by eval/trainers.py (the movement
  autoencoder, then the contrastive text-motion match) and written as a
  finest.tar that EvaluatorWrapper reads through T2M_EVALUATOR_PATH; a
  tiny MotionMDM trained by train/loop.py on the same world and an
  untrained twin, both sampled by diffusion/sampling.py; then
  eval/eval_humanml.py:evaluation: FID(ground truth) ~ 0, FID(trained) <
  FID(untrained), R-precision(trained) > R-precision(untrained), matching
  score(trained) < (untrained).

  a2m: the GRU action classifier trained by eval/trainers.py on labelled
  xyz motions and written as the a2m tar, which A2MEvaluation reads back;
  eval/eval_a2m.py:A2MEvaluation.evaluate
  ranks a faithful generator above a noise generator by accuracy and FID.

Marked slow, as the JAX one is (minutes on the CPU).  The thresholds are
the JAX test's.
"""

import numpy as np
import pytest
import torch

from gesturediffusion_tpu_torch.diffusion.gaussian import ModelMeanType, create_diffusion
from gesturediffusion_tpu_torch.diffusion.resample import UniformSampler
from gesturediffusion_tpu_torch.diffusion.sampling import p_sample_loop
from gesturediffusion_tpu_torch.eval import eval_a2m as pa
from gesturediffusion_tpu_torch.eval.comp_v6 import MovementConvDecoder
from gesturediffusion_tpu_torch.eval.eval_humanml import (
    MAX_FRAMES,
    GeneratedMotionSet,
    GroundTruthMotionSet,
    evaluation,
)
from gesturediffusion_tpu_torch.eval.evaluator_wrapper import EvaluatorWrapper
from gesturediffusion_tpu_torch.eval.networks import (
    MotionDiscriminator,
    MotionEncoderBiGRUCo,
    MovementConvEncoder,
    TextEncoderBiGRUCo,
)
from gesturediffusion_tpu_torch.eval.trainers import (
    ActionClassifierTrainer,
    DecompTrainer,
    TextMotionMatchTrainer,
    save_finest,
)
from gesturediffusion_tpu_torch.models.mdm_t2m import MotionMDM
from gesturediffusion_tpu_torch.train import loop as ploop

pytestmark = pytest.mark.slow

K, DP, TW, TM, CLIP_DIM = 32, 23, 6, 32, 16
_WORLD = np.random.RandomState(99)
CLASS_WORDS = _WORLD.randn(K, TW, 300).astype(np.float32)
CLASS_POS = np.eye(15, dtype=np.float32)[_WORLD.randint(0, 15, (K, TW))]
_t = np.linspace(0, 2 * np.pi, TM)[:, None]
CLASS_MOTION = np.stack([
    np.sin(_t * _WORLD.uniform(0.5, 3.0, DP) + _WORLD.uniform(0, 6, DP))
    * _WORLD.uniform(0.5, 1.5, DP) for _ in range(K)]).astype(np.float32)
CLASS_TEXT_EMB = _WORLD.randn(K, CLIP_DIM).astype(np.float32)


class SyntheticPairedT2M:
    """Text2MotionDatasetV2's eval items over the world, item i of class i % K."""

    def __init__(self, n, seed, noise=0.08):
        rs = np.random.RandomState(seed)
        self.items = [{
            "motion": CLASS_MOTION[i % K] + rs.randn(TM, DP).astype(np.float32) * noise,
            "length": TM, "text": f"class {i % K}",
            "word_embeddings": CLASS_WORDS[i % K] + rs.randn(TW, 300).astype(np.float32) * 0.01,
            "pos_one_hots": CLASS_POS[i % K], "sent_len": TW} for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _text_encoder(captions):
    return np.stack([CLASS_TEXT_EMB[int(c.split()[-1])] for c in captions])


def _train_evaluator(path, seed=0):
    rs = np.random.RandomState(seed)
    torch.manual_seed(seed)

    def batch(bs=32):
        idx = rs.randint(0, K, bs)
        return idx, CLASS_MOTION[idx] + rs.randn(bs, TM, DP).astype(np.float32) * 0.08

    movement = MovementConvEncoder(DP - 4, 512, 512)
    decomp = DecompTrainer(movement, MovementConvDecoder(512, 512, DP), lr=1e-3, device="cpu")
    for _ in range(30):
        decomp.step(batch()[1])
    text = TextEncoderBiGRUCo(300, 15, 512, 512)
    motion = MotionEncoderBiGRUCo(512, 1024, 512)
    match = TextMotionMatchTrainer(text, motion, movement, lr=1e-3, device="cpu",
                                   generator=torch.Generator().manual_seed(seed + 2))
    losses = []
    for _ in range(150):
        idx, motions = batch()
        words = CLASS_WORDS[idx] + rs.randn(32, TW, 300).astype(np.float32) * 0.01
        losses.append(match.step(words, CLASS_POS[idx], np.full(32, TW), motions,
                                 np.full(32, TM))["loss"].item())
    assert losses[-1] < losses[0], "contrastive evaluator training did not learn"
    save_finest(path, {"text_encoder": text, "motion_encoder": motion,
                       "movement_encoder": movement})


def _train_generator(n_steps, seed=3):
    torch.manual_seed(seed)
    model = MotionMDM(njoints=DP, nfeats=1, latent_dim=32, ff_size=64, num_layers=1,
                      num_heads=2, dropout=0.0, clip_dim=CLIP_DIM, cond_mode="text",
                      cond_mask_prob=0.0)
    diffusion = create_diffusion(steps=8, noise_schedule="cosine",
                                 model_mean_type=ModelMeanType.START_X, device="cpu")
    cfg = ploop.TrainConfig(lr=3e-3)
    state = ploop.TrainState(model, *ploop.make_optimizer(model.parameters(), cfg),
                             UniformSampler(8), {})
    rs, gen = np.random.RandomState(seed), torch.Generator().manual_seed(seed + 1)
    for _ in range(n_steps):
        idx = rs.randint(0, K, 32)
        motions = (CLASS_MOTION[idx] + rs.randn(32, TM, DP).astype(np.float32) * 0.08)
        cond = {"text_emb": torch.from_numpy(CLASS_TEXT_EMB[idx]),
                "mask": torch.ones((32, 1, 1, TM), dtype=torch.bool)}
        ploop.train_step(state, diffusion, cfg,
                         torch.from_numpy(motions.transpose(0, 2, 1)[:, :, None]), cond, gen)
    model.eval()

    def sample_fn(generator, cond):
        """TM frames sampled, zero-padded to the eval batch's MAX_FRAMES."""
        c = {"text_emb": cond["text_emb"], "mask": cond["mask"][..., :TM]}
        with torch.no_grad():
            out = p_sample_loop(diffusion, lambda x, t, cc: model(x, t, cc),
                                (c["text_emb"].shape[0], DP, 1, TM), c, generator=generator)
        return torch.nn.functional.pad(out, (0, MAX_FRAMES - TM))

    return sample_fn


def test_t2m_eval_stack_discriminates(tmp_path, monkeypatch):
    path = str(tmp_path / "finest.tar")
    _train_evaluator(path)
    monkeypatch.setenv("T2M_EVALUATOR_PATH", path)
    wrapper = EvaluatorWrapper("humanml", dim_pose=DP, device="cpu")
    gt_loader = list(GroundTruthMotionSet(SyntheticPairedT2M(64, seed=21)))
    trained, untrained = _train_generator(400), _train_generator(0)

    def make_loader(fn, seed):
        def make(replication):
            return GeneratedMotionSet(fn, SyntheticPairedT2M(64, seed=seed + replication),
                                      text_encoder=_text_encoder, seed=seed + replication,
                                      device="cpu"), {}
        return make

    means = evaluation(wrapper, gt_loader, {"trained": make_loader(trained, 100),
                                            "untrained": make_loader(untrained, 200)},
                       log_file=str(tmp_path / "closed_loop.log"), replication_times=1,
                       diversity_times=30)
    fid_gt, fid_tr, fid_un = (means[f"FID_{k}"] for k in ("ground truth", "trained", "untrained"))
    assert fid_gt < 0.1 * fid_tr, (fid_gt, fid_tr)
    assert fid_tr < 0.6 * fid_un, f"FID does not rank models: {fid_tr} vs {fid_un}"
    r_gt, r_tr, r_un = (means[f"R_precision_{k}"] for k in ("ground truth", "trained",
                                                             "untrained"))
    assert r_gt[2] > 0.9, f"the evaluator did not learn the world: {r_gt}"
    assert r_tr[2] > r_un[2] + 0.1, f"R-precision does not rank models: {r_tr} vs {r_un}"
    assert means["Matching Score_trained"] < means["Matching Score_untrained"]


def test_a2m_eval_stack_discriminates(tmp_path):
    ka, ja, ta, ba = 6, 24, 16, 48
    rs = np.random.RandomState(7)
    templates = rs.randn(ka, ja, 3, ta).astype(np.float32)

    def draw(labels, r=rs, noise=0.1):
        return templates[labels] + r.randn(len(labels), ja, 3, ta).astype(np.float32) * noise

    torch.manual_seed(0)
    clf = MotionDiscriminator(ja * 3, 128, 2, ka)
    trainer = ActionClassifierTrainer(clf, lr=2e-3, device="cpu")
    lengths = np.full(ba, ta)
    acc = 0.0
    for i in range(150):
        labels = rs.randint(0, ka, ba)
        acc = trainer.step(draw(labels), lengths, labels)["acc"].item()
        if acc == 1.0 and i > 20:
            break
    assert acc > 0.9, f"the classifier did not train (acc {acc})"
    path = str(tmp_path / "gru.tar")
    save_finest(path, {"model": clf})
    evaluator = pa.A2MEvaluation(input_size_raw=ja * 3, num_classes=ka, device="cpu",
                                 checkpoint_path=path)

    def batches(kind, seed):
        r = np.random.RandomState(seed)
        out = []
        for _ in range(3):
            labels = r.randint(0, ka, ba)
            xyz = draw(labels, r) if kind == "faithful" else r.randn(ba, ja, 3, ta).astype(
                np.float32)
            out.append({"output_xyz": xyz, "lengths": np.full((ba,), ta, np.int64), "y": labels})
        return out

    m = evaluator.evaluate({"gt": batches("faithful", 11), "good": batches("faithful", 22),
                            "bad": batches("noise", 33)})
    assert m["accuracy_good"] > 0.9
    assert m["accuracy_good"] > m["accuracy_bad"] + 0.3
    assert m["fid_gt"] < 0.1 * max(m["fid_good"], 1e-6) or m["fid_gt"] < m["fid_good"]
    assert m["fid_good"] < 0.2 * m["fid_bad"], (m["fid_good"], m["fid_bad"])
