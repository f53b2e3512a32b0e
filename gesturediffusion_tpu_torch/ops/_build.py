"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` is compiled on first use into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so

The library lands in ``build/kernels/`` beside the package (a directory
git ignores); its file name carries a hash of the source and the flags,
so an edited source is rebuilt and an unchanged one is reused.  nvcc's
``-Xptxas -v`` report (registers, shared memory, spills) is kept next to
the library as ``.log``.  Nothing here runs at import time: the CPU tests
import every module on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNELS = ("local_block", "encoder_layer", "encoder_layer_train", "band_attention",
           "flash_attention")

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels are built from csrc/ at first use"
        )
    return path


def library_path(name: str) -> str:
    """Where the library built from ``csrc/<name>.cu`` lives.  The hash
    covers the source, every shared ``csrc/*.cuh`` header and the flags."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names=KERNELS) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet, all nvcc
    processes at once.  Returns {name: nvcc's -Xptxas -v report}."""
    nvcc = None
    running = {}
    for name in names:
        path = library_path(name)
        if os.path.exists(path):
            continue
        nvcc = nvcc or _nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        running[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            tmp, path,
        )
    failed = []
    for name, (proc, tmp, path) in running.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu:\n{report}")
            continue
        with open(path + ".log", "w") as f:
            f.write(report)
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("\n".join(failed))
    reports = {}
    for name in names:
        log = library_path(name) + ".log"
        reports[name] = open(log).read() if os.path.exists(log) else ""
    return reports


def load_function(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of library ``name`` (built if needed),
    with its argument types declared; every entry returns a CUDA error
    code."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            lib.gdt_error_string.argtypes = [ctypes.c_int]
            lib.gdt_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = _loaded[name].gdt_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: error {code} ({msg})")
