"""Port parity of the evaluator trainers (eval/trainers.py) against the JAX
package on the CPU.  JAX parameters (drawn under threefry2x32) go into the
port's modules through utils/convert.py; the same numpy-seeded batches go
to both.  The JAX side's first-step gradients are read out of its own
jitted step by putting a transformation that keeps the gradients (and
applies no update) in the place of its Adam (``_adam_with_clip``,
monkeypatched for the test; with the trainer's clip in front of it, the
clipped gradients).  Held:
- ``contrastive_loss`` on pulled, pushed and mixed pairs;
- each trainer's first-step loss and every gradient, and the clipped
  gradients where it clips; then three Adam steps' losses of the real
  trainers (the text-motion trainer's negative shift drawn from JAX's key
  and passed to the port);
- the clip rule against optax's ``clip_by_global_norm`` with the global
  norm below, at and above the clip (torch's ``clip_grad_norm_`` differs);
- the frozen movement encoder (unchanged, no gradient, not in the
  optimizer) and the text-motion trainer's ``val_loss`` against JAX's;
- ``save_finest``: the T2M trio at the released widths, one step trained,
  written as a finest.tar and read by ``EvaluatorWrapper`` through
  ``T2M_EVALUATOR_PATH`` (embeddings equal to the in-memory modules'), and
  the a2m classifier through ``A2M_CLASSIFIER_PATH``;
- ``fit``'s mean metrics.
Tolerances: the loss rel 1e-5 and each gradient within 1e-5 of its largest
magnitude (float32, products and GRU steps summed in another order); the
three Adam steps' losses rel 1e-4 (each step rounds the update in another
order); the clip rule rtol 1e-6; the round trips exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gesturediffusion_tpu.eval import comp_v6 as jc
from gesturediffusion_tpu.eval import networks as jn
from gesturediffusion_tpu.eval import trainers as jt
from gesturediffusion_tpu_torch.eval import comp_v6 as pc
from gesturediffusion_tpu_torch.eval import eval_a2m as pa
from gesturediffusion_tpu_torch.eval import networks as pn
from gesturediffusion_tpu_torch.eval import trainers as pt
from gesturediffusion_tpu_torch.eval.evaluator_wrapper import EvaluatorWrapper
from gesturediffusion_tpu_torch.utils import convert as cv
from tests.torch_port_common import (  # noqa: F401 (fixtures)
    one_torch_thread,
    threefry_prng,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, T, DP = 4, 16, 23
TOL_LOSS, TOL_GRAD, TOL_STEPS = 1e-5, 1e-5, 1e-4
RS = np.random.RandomState(0)
MOTIONS = RS.randn(B, T, DP).astype(np.float32)
WORDS = RS.randn(B, 6, 12).astype(np.float32)
POS = RS.randn(B, 6, 5).astype(np.float32)
CAP_LENS = np.asarray([6, 4, 5, 2], np.int32)
M_LENS = np.asarray([16, 12, 16, 8], np.int32)


def _keep_grads(lr, clip):
    """In place of the JAX trainer's Adam: the (clipped) gradients kept in
    the optimizer state, the parameters left as they are."""
    def init(params):
        return {"g": jax.tree_util.tree_map(jnp.zeros_like, params)}

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), {"g": grads}

    keep = optax.GradientTransformation(init, update)
    return keep if clip is None else optax.chain(optax.clip_by_global_norm(clip), keep)


def _jax_grads(monkeypatch, make, *args, **kw):
    """(the trainer's init, its step) with the gradient-keeping optimizer."""
    with monkeypatch.context() as m:
        m.setattr(jt, "_adam_with_clip", _keep_grads)
        return make(*args, **kw)


def _kept(opt_state):
    return opt_state["g"] if isinstance(opt_state, dict) else opt_state[1]["g"]


def _assert_grads(trainer, want: dict):
    """Every port gradient against the JAX one (``want``: name -> array in
    the port's layout), within TOL_GRAD of its largest magnitude."""
    got = dict(trainer.named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        w = np.asarray(want[name])
        err = np.abs(p.grad.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= TOL_GRAD, f"{name}: {err:.3e} of the max"


def _prefixed(prefix: str, sd: dict) -> dict:
    return {f"{prefix}.{k}": v.numpy() for k, v in sd.items()}


@pytest.mark.parametrize("labels", [[0] * 6, [1] * 6, [0, 1, 0, 1, 1, 0]],
                         ids=["pull", "push", "mixed"])
def test_contrastive_loss_matches_jax(labels):
    rs = np.random.RandomState(1)
    e1, e2 = rs.randn(6, 8).astype(np.float32), rs.randn(6, 8).astype(np.float32) * 0.3
    label = np.asarray(labels, np.float32)
    for margin in (3.0, 10.0):
        want = float(jt.contrastive_loss(jnp.asarray(e1), jnp.asarray(e2), jnp.asarray(label),
                                         margin))
        got = pt.contrastive_loss(torch.from_numpy(e1), torch.from_numpy(e2),
                                  torch.from_numpy(label), margin).item()
        assert got == pytest.approx(want, rel=TOL_LOSS)


def _decomp_pair(monkeypatch):
    enc = jn.MovementConvEncoder(hidden_size=32, output_size=16)
    dec = jc.MovementConvDecoder(hidden_size=32, output_size=DP)
    init, step = _jax_grads(monkeypatch, jt.make_decomp_trainer, enc, dec)
    state = init(jax.random.PRNGKey(0), jnp.asarray(MOTIONS))
    params = jax.tree_util.tree_map(np.asarray, state.params)

    def port():
        penc = pn.MovementConvEncoder(DP - 4, 32, 16)
        penc.load_state_dict(cv.movement_encoder_state_dict_from_params(params["enc"]))
        pdec = pc.MovementConvDecoder(16, 32, DP)
        pdec.load_state_dict(cv.movement_decoder_state_dict_from_params(params["dec"]))
        return penc, pdec

    return (enc, dec), state, step, port


def test_decomp_trainer_matches_jax(monkeypatch):
    (enc, dec), state, step, port = _decomp_pair(monkeypatch)
    kept, metrics = step(state, jnp.asarray(MOTIONS))
    g = _kept(kept.opt_state)
    trainer = pt.DecompTrainer(*port(), device="cpu")
    got = trainer.backward(MOTIONS)
    for k in ("loss", "loss_rec", "loss_sparsity", "loss_smooth"):
        assert got[k].item() == pytest.approx(float(metrics[k]), rel=TOL_LOSS), k
    _assert_grads(trainer, {
        **_prefixed("enc", cv.movement_encoder_state_dict_from_params(g["enc"])),
        **_prefixed("dec", cv.movement_decoder_state_dict_from_params(g["dec"]))})

    init, jstep = jt.make_decomp_trainer(enc, dec, lr=1e-3)
    jstate = init(jax.random.PRNGKey(0), jnp.asarray(MOTIONS))
    trainer = pt.DecompTrainer(*port(), lr=1e-3, device="cpu")
    for i in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(MOTIONS + i))
        assert trainer.step(MOTIONS + i)["loss"].item() == pytest.approx(
            float(jm["loss"]), rel=TOL_STEPS)


def _estimator_pair(monkeypatch, clip):
    est = jc.MotionLenEstimatorBiGRU(word_size=12, pos_size=5, hidden_size=16, output_size=8)
    init, step = _jax_grads(monkeypatch, jt.make_length_est_trainer, est, clip=clip)
    state = init(jax.random.PRNGKey(1), jnp.asarray(WORDS), jnp.asarray(POS),
                 jnp.asarray(CAP_LENS))
    params = jax.tree_util.tree_map(np.asarray, state.params)

    def port():
        m = pc.MotionLenEstimatorBiGRU(12, 5, 16, 8)
        m.load_state_dict(cv.len_estimator_state_dict_from_params(params))
        return m

    return est, state, step, port


@pytest.mark.parametrize("clip", [0.5, 100.0], ids=["released-clip-bites", "clip-idle"])
def test_length_estimator_trainer_matches_jax(monkeypatch, clip):
    """The released clip 0.5, which these gradients pass, and one they stay
    under: JAX's gradients after its clip against the port's after the
    trainer's clip."""
    est, state, step, port = _estimator_pair(monkeypatch, clip)
    args = [jnp.asarray(a) for a in (WORDS, POS, CAP_LENS, M_LENS)]
    kept, metrics = step(state, *args)
    trainer = pt.LengthEstTrainer(port(), clip=clip, device="cpu")
    got = trainer.backward(WORDS, POS, CAP_LENS, M_LENS)
    assert got["loss"].item() == pytest.approx(float(metrics["loss"]), rel=TOL_LOSS)
    assert got["acc"].item() == float(metrics["acc"])
    norm = pt.clip_by_global_norm_(trainer.params, clip)
    assert (norm.item() > clip) == (clip == 0.5)
    _assert_grads(trainer, _prefixed("estimator", cv.len_estimator_state_dict_from_params(
        _kept(kept.opt_state))))

    init, jstep = jt.make_length_est_trainer(est, lr=1e-3, clip=clip)
    jstate = init(jax.random.PRNGKey(1), *args[:3])
    trainer = pt.LengthEstTrainer(port(), lr=1e-3, clip=clip, device="cpu")
    for _ in range(3):
        jstate, jm = jstep(jstate, *args)
        got = trainer.step(WORDS, POS, CAP_LENS, M_LENS)
        assert got["loss"].item() == pytest.approx(float(jm["loss"]), rel=TOL_STEPS)


def _match_setup(monkeypatch):
    mov_enc = jn.MovementConvEncoder(hidden_size=16, output_size=12)
    text_enc = jn.TextEncoderBiGRUCo(word_size=12, pos_size=5, hidden_size=16, output_size=16)
    mot_enc = jn.MotionEncoderBiGRUCo(input_size=12, hidden_size=16, output_size=16)
    mov_params = mov_enc.init(jax.random.PRNGKey(9), jnp.asarray(MOTIONS)[..., :-4])["params"]
    args = [jnp.asarray(a) for a in (WORDS, POS, CAP_LENS, MOTIONS, M_LENS)]
    init, step, val = _jax_grads(monkeypatch, jt.make_text_motion_match_trainer, text_enc,
                                 mot_enc, mov_enc, mov_params)
    state = init(jax.random.PRNGKey(0), *args)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    mov_np = jax.tree_util.tree_map(np.asarray, mov_params)

    def port():
        sds = cv.t2m_evaluator_state_dicts_from_params(
            {"text": params["text"], "motion": params["motion"], "movement": mov_np})
        text = pn.TextEncoderBiGRUCo(12, 5, 16, 16)
        motion = pn.MotionEncoderBiGRUCo(12, 16, 16)
        movement = pn.MovementConvEncoder(DP - 4, 16, 12)
        for m, k in ((text, "text_encoder"), (motion, "motion_encoder"),
                     (movement, "movement_encoder")):
            m.load_state_dict(sds[k])
        return text, motion, movement

    return (text_enc, mot_enc, mov_enc, mov_params), args, state, step, port


def test_text_motion_match_trainer_matches_jax(monkeypatch):
    jmods, args, state, step, port = _match_setup(monkeypatch)
    key = jax.random.PRNGKey(1)
    kept, metrics = step(state, key, *args)
    shift = int(jax.random.randint(key, (), 1, B))  # the shift JAX's step drew
    trainer = pt.TextMotionMatchTrainer(*port(), device="cpu")
    got = trainer.backward(WORDS, POS, CAP_LENS, MOTIONS, M_LENS, shift)
    for k in ("loss", "loss_pos", "loss_neg"):
        assert got[k].item() == pytest.approx(float(metrics[k]), rel=TOL_LOSS), k
    pt.clip_by_global_norm_(trainer.params, trainer.clip)
    g = _kept(kept.opt_state)
    sds = cv.t2m_evaluator_state_dicts_from_params(
        {"text": g["text"], "motion": g["motion"], "movement": jmods[3]})
    _assert_grads(trainer, {**_prefixed("text", sds["text_encoder"]),
                            **_prefixed("motion", sds["motion_encoder"])})

    init, jstep, jval = jt.make_text_motion_match_trainer(*jmods, lr=1e-3)
    jstate = init(jax.random.PRNGKey(0), *args)
    text, motion, movement = port()
    frozen = {k: v.clone() for k, v in movement.state_dict().items()}
    trainer = pt.TextMotionMatchTrainer(text, motion, movement, lr=1e-3, device="cpu")
    for i in range(3):
        key, skey = jax.random.split(key)
        jstate, jm = jstep(jstate, skey, *args)
        got = trainer.step(WORDS, POS, CAP_LENS, MOTIONS, M_LENS,
                           int(jax.random.randint(skey, (), 1, B)))
        assert got["loss"].item() == pytest.approx(float(jm["loss"]), rel=TOL_STEPS)
    want_val = jval(jstate, *args)
    got_val = trainer.val_loss(WORDS, POS, CAP_LENS, MOTIONS, M_LENS)
    assert got_val["loss"].item() == pytest.approx(float(want_val["loss"]), rel=TOL_STEPS)
    # the movement encoder is frozen: unchanged, no gradient, not optimised
    for k, v in movement.state_dict().items():
        assert torch.equal(v, frozen[k]), k
    assert all(p.grad is None and not p.requires_grad for p in movement.parameters())
    assert not {id(p) for p in movement.parameters()} & {id(p) for p in trainer.params}
    # the shift's own draw: from the trainer's generator, 1..B-1
    drawn = pt.TextMotionMatchTrainer(*port(), device="cpu",
                                      generator=torch.Generator().manual_seed(0))
    assert np.isfinite(drawn.step(WORDS, POS, CAP_LENS, MOTIONS, M_LENS)["loss"].item())


def test_action_classifier_trainer_matches_jax(monkeypatch):
    rs = np.random.RandomState(7)
    motions = rs.randn(6, 4, 3, 10).astype(np.float32)
    lengths = np.asarray([10, 7, 10, 3, 9, 10], np.int32)
    labels = rs.randint(0, 5, 6).astype(np.int32)
    clf = jn.MotionDiscriminator(input_size=12, hidden_size=16, hidden_layer=2, output_size=5)
    init, step = _jax_grads(monkeypatch, jt.make_action_classifier_trainer, clf)
    state = init(jax.random.PRNGKey(2), jnp.asarray(motions), jnp.asarray(lengths))
    params = jax.tree_util.tree_map(np.asarray, state.params)

    def port():
        m = pn.MotionDiscriminator(12, 16, 2, 5)
        m.load_state_dict(cv.motion_discriminator_state_dict_from_params(params))
        return m

    args = [jnp.asarray(a) for a in (motions, lengths, labels)]
    kept, metrics = step(state, *args)
    trainer = pt.ActionClassifierTrainer(port(), device="cpu")
    got = trainer.backward(motions, lengths, labels)
    assert got["loss"].item() == pytest.approx(float(metrics["loss"]), rel=TOL_LOSS)
    assert got["acc"].item() == float(metrics["acc"])
    _assert_grads(trainer, _prefixed("classifier", cv.motion_discriminator_state_dict_from_params(
        _kept(kept.opt_state))))

    init, jstep = jt.make_action_classifier_trainer(clf, lr=1e-3)
    jstate = init(jax.random.PRNGKey(2), *args[:2])
    trainer = pt.ActionClassifierTrainer(port(), lr=1e-3, device="cpu")
    for _ in range(3):
        jstate, jm = jstep(jstate, *args)
        got = trainer.step(motions, lengths, labels)
        assert got["loss"].item() == pytest.approx(float(jm["loss"]), rel=TOL_STEPS)


@pytest.mark.parametrize("clip", [100.0, 5.0, 0.5], ids=["below", "near", "above"])
def test_clip_rule_is_optax_not_clip_grad_norm(clip):
    rs = np.random.RandomState(3)
    grads = [rs.randn(5, 3).astype(np.float32), rs.randn(7).astype(np.float32)]
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads)))
    want, _ = optax.clip_by_global_norm(clip).update([jnp.asarray(g) for g in grads], None)
    params = [torch.zeros(g.shape, requires_grad=True) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    got_norm = pt.clip_by_global_norm_(params, clip).item()
    assert got_norm == pytest.approx(norm, rel=1e-6)
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6, atol=0)
    if norm > clip:  # torch's rule scales by clip / (norm + 1e-6): another gradient
        theirs = [torch.from_numpy(g.copy()).requires_grad_() for g in grads]
        for t, g in zip(theirs, grads):
            t.grad = torch.from_numpy(g.copy())
        torch.nn.utils.clip_grad_norm_(theirs, clip)
        assert any(not torch.equal(t.grad, p.grad) for t, p in zip(theirs, params))


def test_fit_returns_the_mean_metrics():
    seen = []

    def step(x):
        seen.append(x)
        return {"loss": torch.tensor(float(x)), "acc": x / 10}

    assert pt.fit(step, [(1,), (2,), (6,)]) == {"loss": 3.0, "acc": 0.3}
    assert seen == [1, 2, 6] and pt.fit(step, []) == {}


def test_save_finest_round_trips_through_the_evaluators(tmp_path, monkeypatch):
    """One text-motion step at the released widths, the trio written as a
    finest.tar: EvaluatorWrapper reads it through T2M_EVALUATOR_PATH and
    embeds like the in-memory modules; one classifier step, written as the
    a2m tar, reads back through A2M_CLASSIFIER_PATH."""
    torch.manual_seed(0)
    text = pn.TextEncoderBiGRUCo(300, 15, 512, 512)
    motion = pn.MotionEncoderBiGRUCo(512, 1024, 512)
    movement = pn.MovementConvEncoder(DP - 4, 512, 512)
    rs = np.random.RandomState(4)
    words = rs.randn(B, 5, 300).astype(np.float32)
    pos = np.eye(15, dtype=np.float32)[rs.randint(0, 15, (B, 5))]
    cap_lens, m_lens = np.asarray([5, 3, 4, 5]), np.asarray([8, 8, 4, 8])
    motions = rs.randn(B, 8, DP).astype(np.float32)
    trainer = pt.TextMotionMatchTrainer(text, motion, movement, device="cpu")
    trainer.step(words, pos, cap_lens, motions, m_lens, 1)
    path = str(tmp_path / "finest.tar")
    pt.save_finest(path, {"text_encoder": text, "motion_encoder": motion,
                          "movement_encoder": movement})
    monkeypatch.setenv("T2M_EVALUATOR_PATH", path)
    loaded = EvaluatorWrapper("humanml", dim_pose=DP, device="cpu")
    memory = EvaluatorWrapper("humanml", dim_pose=DP, device="cpu", state_dicts={
        "text_encoder": text.state_dict(), "motion_encoder": motion.state_dict(),
        "movement_encoder": movement.state_dict()})
    for a, b in zip(loaded.get_co_embeddings(words, pos, cap_lens, motions, m_lens),
                    memory.get_co_embeddings(words, pos, cap_lens, motions, m_lens)):
        np.testing.assert_array_equal(a, b)
    t_emb, m_emb = trainer.embed(words, pos, cap_lens, motions, m_lens)
    order = np.argsort(m_lens)[::-1]
    np.testing.assert_allclose(loaded.get_co_embeddings(words, pos, cap_lens, motions, m_lens)[0],
                               t_emb.detach().numpy()[order], rtol=1e-5, atol=1e-5)

    clf = pn.MotionDiscriminator(72, 128, 2, 12)
    ActionTrainer = pt.ActionClassifierTrainer(clf, device="cpu")
    ActionTrainer.step(rs.randn(4, 24, 3, 6).astype(np.float32), np.asarray([6, 5, 6, 2]),
                       np.asarray([0, 3, 11, 5]))
    a2m_path = str(tmp_path / "humanact12_gru.tar")
    pt.save_finest(a2m_path, {"model": clf})
    monkeypatch.setenv("A2M_CLASSIFIER_PATH", a2m_path)
    ev = pa.make_a2m_evaluation("humanact12", device="cpu")
    for k, v in clf.state_dict().items():
        assert torch.equal(ev.classifier.state_dict()[k], v), k
    assert os.path.getsize(a2m_path) > 0
