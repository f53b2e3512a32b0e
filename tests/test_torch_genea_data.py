"""Port parity of the GENEA data path (gesturediffusion_tpu_torch/ops/mfcc.py,
data/synthetic.py, data/genea.py, data/registry.py and
sample/generate.py:take_layout) against the JAX package's modules, on trees
written by the synthetic makers from a seed.  The two packages run the same
numpy code, so every comparison is exact (``array_equal``, byte for byte)
but the MFCCs' own check, which allows atol 1e-6 (rtol 0) for a BLAS that
orders the filterbank sums differently."""

import os

import numpy as np
import pytest

from gesturediffusion_tpu.data import genea as jax_genea
from gesturediffusion_tpu.data.registry import get_dataset_loader as jax_loader
from gesturediffusion_tpu.data.synthetic import (
    make_synthetic_genea2022 as jax_make_2022,
    make_synthetic_genea2023 as jax_make_2023,
)
from gesturediffusion_tpu.ops import mfcc as jax_mfcc
from gesturediffusion_tpu.sample.generate import take_layout as jax_take_layout
from gesturediffusion_tpu_torch.data import genea
from gesturediffusion_tpu_torch.data.registry import get_dataset, get_dataset_loader
from gesturediffusion_tpu_torch.data.synthetic import (
    make_synthetic_genea2022,
    make_synthetic_genea2023,
)
from gesturediffusion_tpu_torch.ops import mfcc
from gesturediffusion_tpu_torch.sample.generate import take_layout

POSE = 24
MAKE = dict(n_takes=3, frames_per_take=240, pose_dim=POSE, seed=3)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("genea")
    paths = {}
    for name, make in (("port2023", make_synthetic_genea2023), ("jax2023", jax_make_2023),
                       ("port2022", make_synthetic_genea2022), ("jax2022", jax_make_2022)):
        paths[name] = make(str(root / name), **MAKE)
    return paths


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.mark.parametrize("year", ["2023", "2022"])
def test_makers_write_the_same_bytes(trees, year):
    port, jax = _files(trees["port" + year]), _files(trees["jax" + year])
    assert sorted(port) == sorted(jax)
    assert all(port[k] == jax[k] for k in port)


def _assert_items_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("split,cache", [("train", True), ("train", False), ("val", True),
                                         ("val", False)])
def test_genea2023_items_equal_jax(trees, tmp_path, monkeypatch, split, cache):
    monkeypatch.setenv("GDT_MFCC_CACHE", str(tmp_path / "cache"))
    port = genea.Genea2023(trees["port2023"], split=split, use_mfcc_cache=cache)
    jax = jax_genea.Genea2023(trees["port2023"], split=split, use_mfcc_cache=cache)
    assert len(port) == len(jax) > 0
    for i in range(len(jax)):
        _assert_items_equal(port[i], jax[i])


@pytest.mark.parametrize("split", ["train", "val"])
def test_genea2022_items_equal_jax(trees, split):
    port = genea.Genea2022(trees["port2022"], split=split, window=80)
    jax = jax_genea.Genea2022(trees["port2022"], split=split, window=80)
    assert (len(port), port.begin, port.end) == (len(jax), jax.begin, jax.end)
    for i in range(len(jax)):
        _assert_items_equal(port[i], jax[i])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mfcc_cache_serves_both_packages(trees, tmp_path, monkeypatch, writer):
    """A take's cache written by one package is read, not recomputed, by the
    other: the reader's MFCC function is made to fail."""
    monkeypatch.setenv("GDT_MFCC_CACHE", str(tmp_path))
    mods = {"port": genea, "jax": jax_genea}
    first = mods[writer].Genea2023(trees["port2023"], split="val")[0]
    assert sorted(os.listdir(tmp_path)) == ["val_take_000_main-agent.npy"]
    reader = mods["jax" if writer == "port" else "port"]

    def fail(*args, **kwargs):
        raise AssertionError("the cache was not read")

    monkeypatch.setattr(reader, "mfcc_fn", fail)
    _assert_items_equal(reader.Genea2023(trees["port2023"], split="val")[0], first)


def test_mfcc_equals_jax():
    rs = np.random.RandomState(5)
    audio = (rs.randn(22050 * 3) * 0.1).astype(np.float32)
    np.testing.assert_allclose(mfcc.mfcc(audio), jax_mfcc.mfcc(audio), rtol=0, atol=1e-6)
    for kw in ({}, {"fps": 20, "samplerate": 8000}):
        got = mfcc.mfcc_for_window(audio, **kw)
        assert got.dtype == np.float32 and got.shape[1] == 26
        np.testing.assert_allclose(got, jax_mfcc.mfcc_for_window(audio, **kw), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name,split", [("genea2023", "train"), ("genea2023", "val"),
                                        ("genea2022", "train"), ("genea2022", "val")])
def test_take_layout_equals_jax(trees, name, split):
    from gesturediffusion_tpu.data.registry import get_dataset as jax_get_dataset

    root = trees["port" + name[-4:]]
    port = get_dataset(name, 80, split=split, datapath=root)
    jax = jax_get_dataset(name, 80, split=split, datapath=root)
    got, want = take_layout(port), jax_take_layout(jax)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    counts, starts, _ = got
    assert int(starts[-1] + counts[-1]) <= len(port)  # inside the split


@pytest.mark.parametrize("name,frames", [("genea2023", 80), ("genea2022", 80),
                                         ("synthetic", 40)])
def test_loader_batches_equal_jax(trees, name, frames):
    root = trees["port" + name[-4:]] if name != "synthetic" else None
    kw = dict(batch_size=4, num_frames=frames, split="train", datapath=root, num_workers=0,
              seed=7)
    port, jax = get_dataset_loader(name, **kw), jax_loader(name, **kw)
    assert len(port) == len(jax) > 0
    for (pm, pc), (jm, jc) in zip(port, jax):
        np.testing.assert_array_equal(pm, jm)
        assert sorted(pc) == sorted(jc)
        for k in jc:
            if k == "text":
                assert pc[k] == jc[k]
            else:
                np.testing.assert_array_equal(pc[k], jc[k], err_msg=k)


def test_loader_refuses_a_split_smaller_than_the_batch(trees):
    kw = dict(batch_size=64, num_frames=80, split="val", datapath=trees["port2023"])
    with pytest.raises(ValueError) as want:
        jax_loader("genea2023", **kw)
    with pytest.raises(ValueError) as got:
        get_dataset_loader("genea2023", **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["humanact12", "uestc"])
def test_registry_names_the_datasets_still_to_port(name, tmp_path):
    """The action datasets, which waited for A12, are ported: the registry
    names the JAX package's classes and loads a synthetic tree as JAX does
    (tests/test_torch_a2m.py holds their items); an unknown name is refused
    with JAX's message."""
    from gesturediffusion_tpu.data.registry import get_dataset as jax_get_dataset
    from gesturediffusion_tpu.data.registry import get_dataset_class as jax_class
    from gesturediffusion_tpu_torch.data.a2m import make_synthetic_humanact12
    from gesturediffusion_tpu_torch.data.registry import get_dataset_class
    from gesturediffusion_tpu_torch.data.uestc import make_synthetic_uestc

    assert get_dataset_class(name).__name__ == jax_class(name).__name__
    root = str(tmp_path / name)
    (make_synthetic_humanact12 if name == "humanact12" else make_synthetic_uestc)(root)
    got, want = get_dataset(name, 40, datapath=root), jax_get_dataset(name, 40, datapath=root)
    assert len(got) == len(want) > 0 and got.num_frames == want.num_frames == 40
    np.testing.assert_array_equal(got[0]["pose"], want[0]["pose"])
    with pytest.raises(ValueError, match="Unsupported dataset name"):
        get_dataset("h36m", 80)
