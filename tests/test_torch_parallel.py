"""The port's parallel/ modules in one process, against the JAX package:
the per-process batch slice, the mesh's divisibility errors, the loader's
per-rank items at 2 and 4 processes, the tensor-parallel shape rule; and
the draws a rank makes for the global batch (dropout, conditioning masks,
the samplers' noise, the training layer's hash dropout from its row
offset), each equal to its rows of the whole-batch draw, exactly.  The
multi-rank runs themselves are tests/test_torch_multiprocess.py."""

import jax
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.data.loader import DataLoader as JaxDataLoader
from gesturediffusion_tpu.ops import pallas_encoder_train as jet
from gesturediffusion_tpu.parallel import distributed as jdist
from gesturediffusion_tpu.parallel import mesh as jmesh
from gesturediffusion_tpu_torch.data.loader import DataLoader
from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
from gesturediffusion_tpu_torch.diffusion.sampling import p_sample_loop
from gesturediffusion_tpu_torch.models.embeddings import mask_cond
from gesturediffusion_tpu_torch.models.mdm import MDM
from gesturediffusion_tpu_torch.models.mdm_t2m import MotionMDM
from gesturediffusion_tpu_torch.ops.dropout import dropout
from gesturediffusion_tpu_torch.ops.fused_encoder import SITE_ATTN
from gesturediffusion_tpu_torch.ops.fused_encoder_train import (
    encoder_layer_train_plain,
    hash_dropout_mask,
)
from gesturediffusion_tpu_torch.parallel import distributed as pdist
from gesturediffusion_tpu_torch.parallel import mesh as pmesh
from gesturediffusion_tpu_torch.serve.streaming import StreamingGestureSession
from gesturediffusion_tpu_torch.utils.parser import train_args
from tests.torch_port_common import SMALL


@pytest.mark.parametrize("batch,n,pid", [(8, 2, 0), (8, 2, 1), (12, 4, 3), (6, 1, 0),
                                         (7, 2, 0), (8, 2, 2), (8, 2, -1)])
def test_local_batch_slice_matches_jax(batch, n, pid):
    try:
        want = jdist.local_batch_slice(batch, n, pid)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pdist.local_batch_slice(batch, n, pid)
        assert str(got.value) == str(e)
        return
    assert pdist.local_batch_slice(batch, n, pid) == want


def test_mesh_divisibility_errors_match_jax(monkeypatch):
    """Several processes never clamp: a batch the data width does not
    divide raises JAX's ValueError, word for word (JAX at 8 devices over 2
    processes, the port at 8 ranks); one process is a 1 x 1 grid."""
    n = jax.device_count()
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(pdist, "process_count", lambda: n)
    monkeypatch.setattr(pmesh, "process_count", lambda: n)
    for batch, model in ((12, 1), (6, 2)):
        with pytest.raises(ValueError) as want:
            jmesh.make_data_mesh_for_batch(batch, model=model)
        with pytest.raises(ValueError) as got:
            pmesh.make_data_mesh_for_batch(batch, model=model)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="model axis 3 does not divide 8 devices"):
        pmesh.make_data_mesh_for_batch(12, model=3)
    monkeypatch.undo()
    mesh = pmesh.make_data_mesh_for_batch(7)
    assert (mesh.shape, mesh.data_index, mesh.model_index) == ({"data": 1, "model": 1}, 0, 0)
    assert mesh.data_group is None and mesh.model_group is None
    with pytest.raises(ValueError, match="model axis 2 does not divide 1 devices"):
        pmesh.make_data_mesh_for_batch(8, model=2)


class _Items:
    """A dataset whose items are their indices."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": i}


def _collate(items):
    return np.asarray([it["i"] for it in items])


@pytest.mark.parametrize("processes", [2, 4])
def test_loader_items_per_rank_match_jax(processes):
    """Every rank builds the same shuffled order and takes its contiguous
    slice of each global batch, epoch after epoch, as JAX's loader does;
    the slices of the ranks make up the global batch."""
    ds = _Items(50)
    single = DataLoader(ds, 8, _collate, seed=3, num_workers=2)
    whole = [b for _ in range(2) for b in single]
    for pid in range(processes):
        kw = dict(seed=3, num_workers=2, process_count=processes, process_index=pid)
        port, jax_loader = DataLoader(ds, 8, _collate, **kw), JaxDataLoader(ds, 8, _collate, **kw)
        got = [b for _ in range(2) for b in port]
        want = [b for _ in range(2) for b in jax_loader]
        assert len(got) == len(want) == 2 * 6
        for g, w, full in zip(got, want, whole):
            np.testing.assert_array_equal(g, w)
            per = 8 // processes
            np.testing.assert_array_equal(g, full[pid * per:(pid + 1) * per])


def test_loader_refuses_what_jax_refuses():
    ds = _Items(16)
    for kw in (dict(drop_last=False, process_count=2), dict(process_count=3),
               dict(process_count=2, process_index=2)):
        with pytest.raises(ValueError) as want:
            JaxDataLoader(ds, 8, _collate, **kw)
        with pytest.raises(ValueError) as got:
            DataLoader(ds, 8, _collate, **kw)
        assert str(got.value) == str(want.value)


def test_tensor_parallel_shape_rule_follows_jax():
    """A weight is sharded where JAX's rule shards its [in, out] kernel:
    2-D, at least 1 << 16 elements, the output width divisible by tp."""
    model = MDM(**dict(SMALL, latent_dim=256, num_layers=1, ff_size=256))
    for tp in (2, 3, 4):
        mesh = pmesh.Mesh(data=1, model=tp, model_index=tp - 1)
        blocks = pmesh.shard_params_tp(model.named_parameters(), mesh)
        for name, p in model.named_parameters():
            jax_rule = (p.ndim == 2 and p.numel() >= 1 << 16 and p.T.shape[1] % tp == 0)
            assert (name in blocks) == jax_rule, (tp, name)
            if name in blocks:
                rows = p.shape[0] // tp
                assert blocks[name] == slice((tp - 1) * rows, tp * rows)
        assert len(blocks) >= (5 if tp != 3 else 1)
    assert pmesh.shard_params_tp(model.named_parameters(), pmesh.Mesh(1, 1)) == {}


@pytest.mark.parametrize("num_actions", [12, 40, 256])
def test_tensor_parallelism_keeps_the_action_table_whole(num_actions):
    """The action table stays whole under tensor parallelism: HumanAct12's
    and UESTC's (12 and 40 actions at D 512) are under the shape rule's
    size, and a table the rule would reach is refused before any block is
    cut."""
    model = MotionMDM(njoints=25, nfeats=6, latent_dim=512, num_layers=1, ff_size=64,
                      num_heads=4, cond_mode="action", num_actions=num_actions)
    mesh = pmesh.Mesh(data=1, model=2)
    names = pmesh.shard_params_tp(model.named_parameters(), mesh)
    if num_actions * 512 < 1 << 16:
        assert "embed_action.action_embedding" not in names
        return
    before = {n: p.shape for n, p in model.named_parameters()}
    with pytest.raises(ValueError, match="action table"):
        pmesh.ShardedParams(model, mesh)
    assert {n: p.shape for n, p in model.named_parameters()} == before


def test_draws_under_global_rows_are_the_rows_of_the_whole_batch_draw():
    """dropout (batch-major and [B * H, ...] axes), the conditioning mask
    and a sampling loop's noise, drawn by rank r of 3 over a batch of 6,
    equal rows [2r, 2r + 2) of the single-process draw, bit for bit."""
    x = torch.randn(6, 4, 5) + 2.0
    c = torch.randn(6, 3) + 2.0
    diffusion = create_diffusion(steps=4)

    def model(xt, t, cond):
        return xt * 0.5

    def draws(rows):
        g = torch.Generator().manual_seed(11)
        n = rows.count if rows else 6
        sl = slice(rows.start, rows.start + n) if rows else slice(None)
        with pdist.using_rows(rows):
            return (dropout(x[sl], 0.3, g), dropout(x[sl].reshape(-1, 5), 0.5, g),
                    mask_cond(c[sl], torch.zeros(n), 0.4, True, g),
                    p_sample_loop(diffusion, model, (n, 4, 1, 5), {}, generator=g))

    whole = draws(None)
    for r in range(3):
        for got, want in zip(draws(pdist.GlobalRows(2 * r, 2, 6)), whole):
            per = want.shape[0] // 6
            assert torch.equal(got, want[2 * r * per:(2 * r + 2) * per])
    with pytest.raises(ValueError, match="local rows"):
        with pdist.global_rows(0, 4, 8):
            dropout(torch.ones(6, 2), 0.5, torch.Generator())


@pytest.mark.parametrize("row0", [0, 3])
def test_hash_dropout_counts_from_the_row_offset(row0):
    """The training layer's plain twin at row offset r0 on rows
    [r0, r0 + b) equals those rows of the whole batch's layer, exactly; the
    mask at a base is JAX's hash_dropout_mask at that base."""
    rs = np.random.RandomState(row0)
    d, h, f, b = 16, 2, 32, 2
    x = torch.from_numpy(rs.randn(6, 5, d).astype(np.float32))
    w = [torch.from_numpy(rs.randn(*s).astype(np.float32) * 0.3)
         for s in ((3 * d, d), (3 * d,), (d, d), (d,), (d,), (d,), (f, d), (f,), (d, f), (d,),
                   (d,), (d,))]
    whole = encoder_layer_train_plain(x, *w, seed=9, num_heads=h, rate=0.3)
    part = encoder_layer_train_plain(x[row0:row0 + b], *w, seed=9, num_heads=h, rate=0.3,
                                     row0=row0)
    assert torch.equal(part, whole[row0:row0 + b])
    if row0:
        assert not torch.equal(part, encoder_layer_train_plain(x[row0:row0 + b], *w, seed=9,
                                                               num_heads=h, rate=0.3))
    base = row0 * h * 5 * 5
    want = np.asarray(jet.hash_dropout_mask((b, h, 5, 5), base, jax.numpy.int32(9),
                                            SITE_ATTN, 0.7))
    got = hash_dropout_mask((b, h, 5, 5), base, 9, SITE_ATTN, 0.7).numpy()
    np.testing.assert_array_equal(got, want)


def test_parser_takes_a_model_axis_and_the_session_takes_a_mesh(tmp_path):
    args = train_args(["--save_dir", str(tmp_path / "x"), "--mesh_model_axis", "2"])
    assert args.mesh_model_axis == 2
    model = MDM(**SMALL)
    session = StreamingGestureSession(model, streams=4, chunk_frames=16,
                                      seed_poses=SMALL["seed_poses"], diffusion_steps=4,
                                      mesh=pmesh.Mesh(data=2, model=1, data_index=1),
                                      device="cpu")
    assert session._shape[0] == 2  # this rank's streams
    with pytest.raises(ValueError, match="streams=3 is not divisible"):
        StreamingGestureSession(model, streams=3, mesh=pmesh.Mesh(data=2, model=1),
                                device="cpu")


WORLD_VARS = ("GDT_COORDINATOR_ADDRESS", "GDT_NUM_PROCESSES", "GDT_PROCESS_ID",
              "GDT_DIST_BACKEND", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def test_initialize_reads_the_environment(monkeypatch):
    """No coordinator address: nothing to join.  An address without the
    world size or the rank, or an unknown backend, is refused before any
    connection is tried."""
    for var in WORLD_VARS:
        monkeypatch.delenv(var, raising=False)
    assert pdist.maybe_initialize("cpu") is False
    assert (pdist.process_count(), pdist.process_index()) == (1, 0)
    monkeypatch.setenv("GDT_COORDINATOR_ADDRESS", "127.0.0.1:1")
    with pytest.raises(ValueError, match="GDT_NUM_PROCESSES"):
        pdist.maybe_initialize("cpu")
    monkeypatch.setenv("GDT_NUM_PROCESSES", "2")
    monkeypatch.setenv("GDT_PROCESS_ID", "2")
    with pytest.raises(ValueError, match="out of range"):
        pdist.maybe_initialize("cpu")
    monkeypatch.setenv("GDT_PROCESS_ID", "1")
    monkeypatch.setenv("GDT_DIST_BACKEND", "mpi")
    with pytest.raises(ValueError, match="GDT_DIST_BACKEND"):
        pdist.maybe_initialize("cpu")


@pytest.mark.parametrize("env,want", [
    ({"GDT_NUM_PROCESSES": "4", "GDT_PROCESS_ID": "3"}, (4, 3)),
    ({"WORLD_SIZE": "4", "RANK": "2", "LOCAL_RANK": "0"}, (4, 2)),
    ({"GDT_NUM_PROCESSES": "2", "GDT_PROCESS_ID": "1", "WORLD_SIZE": "2", "RANK": "1"}, (2, 1)),
], ids=["gdt", "torchrun", "both-agree"])
def test_world_comes_from_the_gdt_pair_or_torchrun(monkeypatch, env, want):
    """The world size and the rank from GDT_NUM_PROCESSES / GDT_PROCESS_ID,
    or where they are unset from torchrun's WORLD_SIZE / RANK (JAX lets
    the pair be left out where the runtime knows the topology,
    distributed.py:36-53); two pairs that agree are one world."""
    for var in WORLD_VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("GDT_COORDINATOR_ADDRESS", "127.0.0.1:1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert pdist.world_from_env() == want


@pytest.mark.parametrize("env,match", [
    ({}, "neither GDT_NUM_PROCESSES nor WORLD_SIZE"),
    ({"GDT_NUM_PROCESSES": "2"}, "GDT_PROCESS_ID is not"),
    ({"GDT_PROCESS_ID": "0"}, "GDT_NUM_PROCESSES is not"),
    ({"WORLD_SIZE": "2"}, "RANK is not"),
    ({"RANK": "1", "LOCAL_RANK": "1"}, "WORLD_SIZE is not"),
    ({"GDT_NUM_PROCESSES": "2", "GDT_PROCESS_ID": "0", "WORLD_SIZE": "2", "RANK": "1"},
     "disagree"),
    ({"GDT_NUM_PROCESSES": "2", "GDT_PROCESS_ID": "1", "WORLD_SIZE": "4", "RANK": "1"},
     "disagree"),
    ({"GDT_NUM_PROCESSES": "2", "WORLD_SIZE": "2", "RANK": "0"}, "GDT_PROCESS_ID is not"),
], ids=["neither", "gdt-size-only", "gdt-rank-only", "torchrun-size-only",
        "torchrun-rank-only", "ranks-disagree", "sizes-disagree", "half-gdt-with-torchrun"])
def test_initialize_refuses_half_a_world_or_two_worlds(monkeypatch, env, match):
    """Half a pair, neither pair, or two pairs that disagree: a ValueError
    naming both sources, before any connection is tried."""
    for var in WORLD_VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("GDT_COORDINATOR_ADDRESS", "127.0.0.1:1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=match) as err:
        pdist.maybe_initialize("cpu")
    assert "GDT_NUM_PROCESSES" in str(err.value) and "WORLD_SIZE" in str(err.value)


def test_rank_device_takes_the_card_from_local_rank(monkeypatch):
    """Under torchrun LOCAL_RANK names the card (modulo the cards, as ranks
    sharing one card over gloo need), before rank % device_count; a device
    with an index keeps it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert pdist.rank_device(None, rank=2, world=4) == torch.device("cuda", 1)
    assert pdist.rank_device("cuda", rank=0, world=4) == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert pdist.rank_device("cuda", rank=0, world=4) == torch.device("cuda", 0)
    assert pdist.rank_device("cuda:1", rank=0, world=4) == torch.device("cuda", 1)
    assert pdist.rank_device("cpu", rank=0, world=4) == torch.device("cpu")
    monkeypatch.delenv("LOCAL_RANK")
    assert pdist.rank_device(None, rank=2, world=4) == torch.device("cuda", 0)


def test_rank_device_maps_ranks_onto_the_cards(monkeypatch):
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert pdist.rank_device("cpu", rank=3, world=4) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pdist.rank_device(None, rank=3, world=4) == torch.device("cuda", 1)
    assert pdist.rank_device("cuda", rank=2, world=4) == torch.device("cuda", 0)
    assert pdist.rank_device("cuda:1", rank=0, world=4) == torch.device("cuda", 1)
    assert pdist.rank_device("cuda", rank=0, world=1) == torch.device("cuda")
