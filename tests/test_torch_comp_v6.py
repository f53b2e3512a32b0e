"""Port parity of the CompV6 baseline (eval/comp_v6.py) against the JAX
package on the CPU: JAX ``CompV6Generator`` parameters (drawn under
threefry2x32, each network's init jitted) carried into the port with
utils/convert.py:comp_v6_state_dicts_from_params, then each sub-network on
the same numpy-seeded inputs (the caption BiGRU at ragged lengths shorter
than T, its padded outputs zero and its backward half flipped; the
attention layer; the prior with its noise injected; the snippet decoder;
the movement decoder's transposed convolutions; the length estimator), the
whole autoregressive ``generate`` over 6 snippets with JAX's noise
injected, the port's state dicts through JAX's ``convert_comp_v6_checkpoint``
back to the JAX parameters (the released tars' layout), and the tars
written and read back through ``load_torch_checkpoints``.

Widths: text BiGRU 16, snippet GRUs 32, pose 23; the movement latent (512),
z (128) and the length estimator (BiGRU 512, 50 buckets) stay at the
released widths, which JAX's generator fixes.

Tolerances: each sub-network within 1e-5 of its output's largest magnitude
(float32 GRUs and products summed in another order); the whole take within
1e-4 of its largest magnitude (6 chained snippets of GRU cells, then two
transposed convolutions); the converter round trip and the tars exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.eval import comp_v6 as jc
from gesturediffusion_tpu_torch.eval import comp_v6 as pc
from gesturediffusion_tpu_torch.utils.convert import comp_v6_state_dicts_from_params
from tests.torch_port_common import (  # noqa: F401 (fixtures)
    one_torch_thread,
    threefry,
    threefry_prng,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL_NET = 1e-5
TOL_TAKE = 1e-4
WIDTHS = dict(dim_pose=23, text_hidden=16, hidden_size=32)
B, T = 3, 9


def _init_params(gen: jc.CompV6Generator, seed: int = 0) -> dict:
    """CompV6Generator._init_random's tree, each network's init jitted; the
    keys drawn under threefry2x32 (a module-scoped fixture runs outside the
    autouse ``threefry_prng``, and an earlier JAX CLI on the worker leaves
    rbg on)."""
    with threefry():
        k = jax.random.split(jax.random.PRNGKey(seed), 8)
    word, pos, lens = jnp.zeros((1, 8, 300)), jnp.zeros((1, 8, 15)), jnp.asarray([8])
    ts, hs = 2 * gen.text_enc.hidden_size, gen.seq_pri.hidden_size
    hidden1, p0 = [jnp.zeros((1, hs))], jnp.zeros((1,), jnp.int32)

    def init(module, key, *args):
        return jax.jit(module.init)(key, *args)["params"]

    with threefry():
        params = {
            "text_enc": init(gen.text_enc, k[0], word, pos, lens),
            "seq_pri": init(gen.seq_pri, k[1], jnp.zeros((1, 512 + ts)), hidden1, p0, k[6]),
            "seq_dec": init(gen.seq_dec, k[2], jnp.zeros((1, 512 + ts + 128)), hidden1, p0),
            "att_layer": init(gen.att_layer, k[3], jnp.zeros((1, hs)), jnp.zeros((1, 8, ts))),
            "mov_enc": init(gen.mov_enc, k[4], jnp.zeros((1, 4, gen.dim_pose - 4))),
            "mov_dec": init(gen.mov_dec, k[5], jnp.zeros((1, 2, 512))),
            "len_estimator": init(gen.len_estimator, k[7], word, pos, lens),
            "z2init_pri": init(gen._z2init_pri, k[6], jnp.zeros((1, ts))),
            "z2init_dec": init(gen._z2init_dec, k[5], jnp.zeros((1, ts))),
        }
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def pair():
    jgen = jc.CompV6Generator(**WIDTHS, params={})
    jgen.params = _init_params(jgen)
    port = pc.CompV6Generator(**WIDTHS, state_dicts=comp_v6_state_dicts_from_params(jgen.params),
                              device="cpu")
    return jgen, port


def _caption(lens, t=T, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(len(lens), t, 300).astype(np.float32),
            rs.randn(len(lens), t, 15).astype(np.float32), np.asarray(lens))


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"{what}: {err:.3e} of the max (tol {tol:g})"


def _apply(jgen, name, *args):
    module = {"z2init_pri": jgen._z2init_pri, "z2init_dec": jgen._z2init_dec}.get(
        name) or getattr(jgen, name)
    return module.apply({"params": jgen.params[name]}, *args)


@pytest.mark.parametrize("lens,t", [([9, 6, 4], 9), ([7, 5, 3], 10), ([1, 8, 2], 8)],
                         ids=["one-full-length", "all-shorter-than-T", "length-1"])
def test_text_encoder_matches_jax_with_zero_padding(pair, lens, t):
    jgen, port = pair
    word, pos, lens = _caption(lens, t)
    seq_j, last_j = _apply(jgen, "text_enc", word, pos, lens)
    with torch.no_grad():
        seq_p, last_p = port.text_enc(torch.from_numpy(word), torch.from_numpy(pos), lens)
    _close(seq_p.numpy(), seq_j, TOL_NET, "word outputs")
    _close(last_p.numpy(), last_j, TOL_NET, "last states")
    for i, n in enumerate(lens):  # AttLayer attends over every position: zeros past n
        assert not seq_p[i, n:].any()


def test_att_layer_matches_jax(pair):
    jgen, port = pair
    rs = np.random.RandomState(1)
    q = rs.randn(B, 32).astype(np.float32)
    keys = rs.randn(B, T, 32).astype(np.float32)
    keys[0, 5:] = 0.0  # a padded caption's keys
    pred_j, w_j = _apply(jgen, "att_layer", q, keys)
    with torch.no_grad():
        pred_p, w_p = port.att_layer(torch.from_numpy(q), torch.from_numpy(keys))
    _close(pred_p.numpy(), pred_j, TOL_NET, "attended value")
    _close(w_p.numpy(), w_j, TOL_NET, "weights")


@pytest.mark.parametrize("p", [[0, 3, 7], [-2, 120, 400]], ids=["in-range", "clamped"])
def test_prior_and_snippet_decoder_match_jax(pair, p):
    """The prior with JAX's noise injected and the snippet decoder, at
    snippets-to-go inside and past the table's 0..299."""
    jgen, port = pair
    rs = np.random.RandomState(2)
    text = rs.randn(B, 32).astype(np.float32)
    pri_in = rs.randn(B, 512 + 32).astype(np.float32)
    dec_in = rs.randn(B, 512 + 32 + 128).astype(np.float32)
    p = np.asarray(p, np.int32)
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.normal(key, (B, 128)))
    h_pri = list(jnp.split(_apply(jgen, "z2init_pri", text), 1, axis=-1))
    h_dec = list(jnp.split(_apply(jgen, "z2init_dec", text), 1, axis=-1))
    z_j, mu_j, lv_j, hp_j = _apply(jgen, "seq_pri", pri_in, h_pri, p, key)
    mov_j, hd_j = _apply(jgen, "seq_dec", dec_in, h_dec, p)
    with torch.no_grad():
        t = torch.from_numpy(text)
        hp = port.seq_pri.get_init_hidden(t)
        hd = port.seq_dec.get_init_hidden(t)
        _close(hp[0].numpy(), h_pri[0], TOL_NET, "prior's initial state")
        z_p, mu_p, lv_p, hp_p = port.seq_pri(torch.from_numpy(pri_in), hp,
                                             torch.from_numpy(p), noise=torch.tensor(noise))
        mov_p, hd_p = port.seq_dec(torch.from_numpy(dec_in), hd, torch.from_numpy(p))
    for got, want, what in ((z_p, z_j, "z"), (mu_p, mu_j, "mu"), (lv_p, lv_j, "logvar"),
                            (hp_p[0], hp_j[0], "prior state"), (mov_p, mov_j, "movement"),
                            (hd_p[0], hd_j[0], "decoder state")):
        _close(got.numpy(), want, TOL_NET, what)


def test_movement_decoder_matches_jax(pair):
    """torch's ConvTranspose1d(k=4, s=2, p=1) against JAX's VALID transposed
    convolution cropped by one a side with the kernel flipped."""
    jgen, port = pair
    x = np.random.RandomState(3).randn(B, 5, 512).astype(np.float32)
    want = _apply(jgen, "mov_dec", x)
    with torch.no_grad():
        got = port.mov_dec(torch.from_numpy(x))
    assert got.shape == (B, 20, WIDTHS["dim_pose"])
    _close(got.numpy(), want, TOL_NET, "poses")


def test_length_estimator_matches_jax(pair):
    jgen, port = pair
    word, pos, lens = _caption([9, 4, 6], seed=4)
    want = jgen.estimate_length_logits(word, pos, lens)
    got = port.estimate_length_logits(word, pos, lens)
    assert got.shape == (B, 50)
    _close(got.numpy(), want, TOL_NET, "length logits")


def test_generate_matches_jax_with_its_noise(pair):
    """Six snippets, m_lens that run out before the last (negative
    snippets-to-go), JAX's per-snippet noise injected."""
    jgen, port = pair
    word, pos, lens = _caption([7, 5, 3], seed=5)
    m_lens, mov_len = np.asarray([24, 16, 20]), 6
    rng = jax.random.PRNGKey(3)
    key, noise = rng, []
    for _ in range(mov_len):  # the splits JAX's loop makes
        key, zkey = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(zkey, (B, 128))))
    want = np.asarray(jgen.generate(word, pos, lens, m_lens, mov_len, rng))
    got = port.generate(word, pos, lens, m_lens, mov_len, noise=np.stack(noise))
    assert got.shape == (B, mov_len * 4, WIDTHS["dim_pose"]) and torch.isfinite(got).all()
    _close(got.numpy(), want, TOL_TAKE, "take")
    # the generator's own draws: a seeded take repeats, another seed differs
    a, b, c = (port.generate(word, pos, lens, m_lens, mov_len,
                             generator=torch.Generator().manual_seed(s)) for s in (0, 0, 1))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_state_dicts_round_trip_through_the_jax_converter(pair):
    """The port's state dicts are the released tars' layout: JAX's
    convert_comp_v6_checkpoint reads them back to the JAX parameters."""
    jgen, port = pair
    sds = {k: {n: v.numpy() for n, v in sd.items()}
           for k, sd in comp_v6_state_dicts_from_params(jgen.params).items()}
    assert {k: sorted(v) for k, v in sds.items()} == {
        key: sorted(getattr(port, name).state_dict()) for key, name in pc.STATE_DICT_KEYS.items()}
    back = jc.convert_comp_v6_checkpoint({k: v for k, v in sds.items() if k != "estimator"},
                                         {"estimator": sds["estimator"]})
    flat_w = jax.tree_util.tree_flatten_with_path(jgen.params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_w) == len(flat_b)
    for path, want in flat_w:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), want, err_msg=str(path))


def test_released_tars_load(pair, tmp_path):
    jgen, port = pair
    sds = comp_v6_state_dicts_from_params(jgen.params)
    torch.save({k: v for k, v in sds.items() if k != "estimator"}, tmp_path / "latest.tar")
    torch.save({"estimator": sds["estimator"]}, tmp_path / "len_est.tar")
    loaded = pc.CompV6Generator.load_torch_checkpoints(str(tmp_path / "latest.tar"),
                                                       str(tmp_path / "len_est.tar"))
    again = pc.CompV6Generator(**WIDTHS, state_dicts=loaded, device="cpu")
    for key, name in pc.STATE_DICT_KEYS.items():
        for n, v in getattr(port, name).state_dict().items():
            assert torch.equal(getattr(again, name).state_dict()[n], v), (key, n)
