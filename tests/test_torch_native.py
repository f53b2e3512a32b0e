"""The host C data-path library (data/native.py, ``native/gdt_native.c``
built with the system compiler into ``build/native/``) against numpy and
the JAX package's binding on the CPU, byte for byte: each function with the
library against its numpy path (``native.disabled()``); the z-norm
transposes and the length mask against JAX's library (the same C, the
same float32 operations); the pre-emphasis against JAX's numpy path (the
port builds without floating-point contraction, so it never fuses
``x[i] - coef * x[i - 1]`` into one rounding; JAX's Makefile builds with
``-march=native``, where the compiler may, and then JAX's library is within
the port's by the two roundings it skips, half an ulp of the product
``coef * x[i - 1]`` and half an ulp of the result, held too); the port's
numpy ``collate_gesture`` batches against the library's fills and JAX's
collate; a compiler that fails leaves the numpy path, logged."""

import numpy as np
import pytest

from gesturediffusion_tpu.data import collate as jcollate
from gesturediffusion_tpu.data import native as jnative
from gesturediffusion_tpu_torch.data import collate as pcollate
from gesturediffusion_tpu_torch.data import native

RS = np.random.RandomState(0)
SRC = RS.randn(100, 24).astype(np.float32)
MEAN = RS.randn(24).astype(np.float32)
STD = (RS.rand(24) + 0.5).astype(np.float32)
STACK = RS.randn(4, 16, 24).astype(np.float32)
AUDIO = RS.randn(10000).astype(np.float32)
LENGTHS = np.asarray([3, 5, 0, 9], np.int64)


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    assert lib is not None, "the C library did not build (is there a C compiler?)"
    return lib


CALLS = {
    "window": lambda m: m.window_znorm_transpose(SRC, 30, 40, MEAN, STD),
    "window-past-the-end": lambda m: m.window_znorm_transpose(SRC, 80, 40, MEAN, STD),
    "batch": lambda m: m.batch_znorm_transpose(STACK, MEAN, STD),
    "mask": lambda m: m.lengths_to_mask_native(LENGTHS, 7),
    "preemphasis": lambda m: m.preemphasis(AUDIO, 0.97),
}


def _same_bytes(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("call", sorted(CALLS))
def test_library_equals_its_numpy_path(lib, call):
    with_lib = CALLS[call](native)
    with native.disabled():
        assert native.get_lib() is None
        numpy_path = CALLS[call](native)
    _same_bytes(with_lib, numpy_path)


@pytest.mark.parametrize("call", ["window", "window-past-the-end", "batch", "mask"])
def test_equals_the_jax_library(lib, call):
    if jnative.get_lib() is None:
        pytest.fail("the JAX package's native library did not build")
    _same_bytes(CALLS[call](native), CALLS[call](jnative))


def test_preemphasis_equals_jax_numpy_and_its_library_within_a_rounding(lib, monkeypatch):
    got = CALLS["preemphasis"](native)
    lib_j = CALLS["preemphasis"](jnative)
    product = np.abs(np.float32(0.97) * AUDIO[:-1])  # a fused multiply-add skips its rounding
    bound = np.spacing(product) + np.spacing(np.abs(got[1:]))
    assert got[0] == lib_j[0] and (np.abs(got[1:] - lib_j[1:]) <= bound).all()
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)
    _same_bytes(got, CALLS["preemphasis"](jnative))


def _items(n=5, seed=1):
    rs = np.random.RandomState(seed)
    return [{"motion": rs.randn(rs.randint(6, 30), 12).astype(np.float32),
             "length": int(rs.randint(4, 30)), "mfcc": rs.randn(30, 5).astype(np.float32),
             "seed": rs.randn(4, 12).astype(np.float32),
             "audio": rs.randn(rs.randint(100, 20000)).astype(np.float32), "text": f"take {i}"}
            for i in range(n)]


def _library_fill(items, key, t):
    """[B, C, 1, t] as JAX's collate fills it through the library
    (JAX data/collate.py:47-57): a window z-normalised by mean 0, std 1."""
    c = items[0][key].shape[1]
    dst = np.zeros((len(items), c, 1, t), np.float32)
    for i, it in enumerate(items):
        dst[i, :, 0, :] = native.window_znorm_transpose(
            it[key][:t], 0, t, np.zeros(c, np.float32), np.ones(c, np.float32))
    return dst


@pytest.mark.parametrize("max_frames", [None, 20])
def test_collate_batches_are_byte_equal_with_and_without_the_library(lib, max_frames):
    """The port's collate fills by numpy; the library's fills, and JAX's
    collate (which goes through its library), give the same bytes."""
    items = _items()
    motion, cond = pcollate.collate_gesture(items, max_frames)
    t = motion.shape[-1]
    _same_bytes(motion, _library_fill(items, "motion", t))
    _same_bytes(cond["mfcc"], _library_fill(items, "mfcc", t))
    _same_bytes(cond["mask"][:, 0, 0], native.lengths_to_mask_native(cond["lengths"], t))
    jmotion, jcond = jcollate.collate_gesture(items, max_frames)
    _same_bytes(motion, jmotion)
    assert sorted(jcond) == sorted(cond)
    for k, v in cond.items():
        if k == "text":
            assert jcond[k] == v
        else:
            _same_bytes(v, jcond[k])
    np.testing.assert_array_equal(pcollate.lengths_to_mask(LENGTHS, 7),
                                  jcollate.lengths_to_mask(LENGTHS, 7))


def test_a_failed_build_leaves_the_numpy_path(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CC", str(tmp_path / "no-such-compiler"))
    assert native.get_lib() is None
    assert "native data path unavailable" in capsys.readouterr().out
    with native.disabled():
        want = CALLS["batch"](native)
    _same_bytes(CALLS["batch"](native), want)
