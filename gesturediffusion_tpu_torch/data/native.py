"""ctypes binding of the host C data-path library (``native/gdt_native.c``).

PyTorch-port counterpart of gesturediffusion_tpu/data/native.py (:72-128):
``window_znorm_transpose`` (a take's window gathered, z-normalised and
transposed to [D, T] in one pass, zero past the take's end),
``batch_znorm_transpose`` ([B, T, D] -> [B, D, T]), ``lengths_to_mask_native``
and ``preemphasis``.  JAX's collate fills its batches through them
(JAX data/collate.py:28-31,47-57); the port's data/collate.py keeps its
one-pass numpy fill, which gives the same bytes and was the faster of the
two on an H100 machine's host (``chip_smoke.py`` phase 19 (e) times both).

The library is built at first use with the system C compiler (``$CC``,
else ``cc``) into ``build/native/`` beside the package, a directory git
ignores, under a name that carries a hash of the source and the flags; the
repository's ``native/`` directory is only read.  The flags leave out
``-march=native`` and turn off floating-point contraction, so every
function computes exactly what its numpy path below computes: the z-norm
as ``(x - mean) * (1 / std)`` in float32, the pre-emphasis as
``x[i] - coef * x[i - 1]`` without a fused multiply-add.  Where no
compiler or library is found, the failure is logged once and every
function takes its numpy path, whose results are the same bytes, as JAX
falls back to numpy.  ``disabled()`` takes the numpy path inside a block.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from gesturediffusion_tpu_torch.utils import logger as log_lib

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(REPO_DIR, "native", "gdt_native.c")
BUILD_DIR = os.path.join(REPO_DIR, "build", "native")
CFLAGS = ("-O3", "-fPIC", "-shared", "-ffp-contract=off", "-Wall")

_f32p = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "gdt_window_znorm_transpose": [_f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int64, _f32p, _f32p, _f32p],
    "gdt_batch_znorm_transpose": [_f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                  _f32p, _f32p, _f32p],
    "gdt_lengths_to_mask": [ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
                            ctypes.POINTER(ctypes.c_uint8)],
    "gdt_preemphasis": [_f32p, ctypes.c_int64, ctypes.c_float, _f32p],
}

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()
_disabled = contextvars.ContextVar("gdt_native_disabled", default=False)


def library_path() -> str:
    """Where the library lives: the hash covers the source and the flags."""
    digest = hashlib.sha1(" ".join(CFLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libgdt_native-{digest.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the library unless it is built; returns its path.  Raises
    with the compiler's output when the compiler fails or is missing."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cc = os.environ.get("CC", "cc")
    r = subprocess.run([cc, *CFLAGS, "-o", tmp, SOURCE], capture_output=True, text=True,
                       timeout=120)
    if r.returncode != 0:
        raise RuntimeError(f"{cc} failed on native/gdt_native.c:\n{r.stdout}{r.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or none
    return path


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library (built at first use), or None where it cannot
    be built or loaded (logged once) or inside ``disabled()``."""
    global _lib, _tried
    if _disabled.get():
        return None
    with _lock:
        if not _tried:
            _tried = True
            try:
                lib = ctypes.CDLL(build())
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                log_lib.log(f"native data path unavailable, numpy fills the batches: {e}")
            else:
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes, fn.restype = argtypes, None
                _lib = lib
    return _lib


@contextlib.contextmanager
def disabled():
    """Every function takes its numpy path inside the block."""
    token = _disabled.set(True)
    try:
        yield
    finally:
        _disabled.reset(token)


def _ptr(a: np.ndarray, ctype=ctypes.c_float):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _znorm_operands(mean, std) -> tuple[np.ndarray, np.ndarray]:
    return (np.ascontiguousarray(mean, np.float32),
            np.ascontiguousarray(np.float32(1.0) / np.asarray(std, np.float32), np.float32))


def window_znorm_transpose(src: np.ndarray, lo: int, t: int, mean: np.ndarray,
                           std: np.ndarray) -> np.ndarray:
    """Rows [lo, lo + t) of a take [T_take, D], z-normalised, as [D, t];
    zeros past the take's end."""
    src = np.ascontiguousarray(src, np.float32)
    d = src.shape[1]
    mean, inv_std = _znorm_operands(mean, std)
    if mean.shape != (d,) or inv_std.shape != (d,):
        raise ValueError(f"mean and std must have shape ({d},)")
    lib = get_lib()
    if lib is None:
        window = src[lo:lo + t]
        out = np.zeros((d, t), np.float32)
        out[:, :window.shape[0]] = ((window - mean) * inv_std).T
        return out
    out = np.empty((d, t), np.float32)
    lib.gdt_window_znorm_transpose(_ptr(src), src.shape[0], d, lo, t, _ptr(mean),
                                   _ptr(inv_std), _ptr(out))
    return out


def batch_znorm_transpose(src: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """[B, T, D] -> z-normalised [B, D, T]."""
    src = np.ascontiguousarray(src, np.float32)
    b, t, d = src.shape
    mean, inv_std = _znorm_operands(mean, std)
    if mean.shape != (d,) or inv_std.shape != (d,):
        raise ValueError(f"mean and std must have shape ({d},)")
    lib = get_lib()
    if lib is None:
        return np.ascontiguousarray(((src - mean) * inv_std).transpose(0, 2, 1))
    out = np.empty((b, d, t), np.float32)
    lib.gdt_batch_znorm_transpose(_ptr(src), b, t, d, _ptr(mean), _ptr(inv_std), _ptr(out))
    return out


def lengths_to_mask_native(lengths: np.ndarray, max_len: int) -> np.ndarray:
    """[B] lengths -> bool [B, max_len], True below each length."""
    lengths = np.ascontiguousarray(lengths, np.int32)
    lib = get_lib()
    if lib is None:
        return np.arange(max_len)[None, :] < lengths[:, None]
    out = np.empty((len(lengths), max_len), np.uint8)
    lib.gdt_lengths_to_mask(_ptr(lengths, ctypes.c_int32), len(lengths), max_len,
                            _ptr(out, ctypes.c_uint8))
    return out.astype(bool)


def preemphasis(x: np.ndarray, coef: float = 0.97) -> np.ndarray:
    """out[0] = x[0]; out[i] = x[i] - coef * x[i - 1], in float32."""
    x = np.ascontiguousarray(x, np.float32)
    lib = get_lib()
    if lib is None:
        return np.append(x[0], x[1:] - np.float32(coef) * x[:-1]).astype(np.float32)
    out = np.empty_like(x)
    lib.gdt_preemphasis(_ptr(x), len(x), coef, _ptr(out))
    return out
