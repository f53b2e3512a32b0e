"""The PyTorch port imports no JAX and nothing of gesturediffusion_tpu (nor
``regex``, which the machine with the card may lack: the CLIP tokenizer
falls back to ``re``), and chip_smoke.py refuses to run without a CUDA
card."""

import os
import shutil
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKED_IMPORT = r"""
import pkgutil, sys
for name in ("jax", "jaxlib", "flax", "gesturediffusion_tpu", "regex"):
    sys.modules[name] = None  # any import of these now raises ImportError
import gesturediffusion_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    __import__(name)
leaked = [m for m, mod in sys.modules.items() if mod is not None and (
    m.split(".")[0] in ("jax", "jaxlib", "flax", "gesturediffusion_tpu"))]
assert not leaked, leaked
assert {"gesturediffusion_tpu_torch." + m for m in (
    "ops.band_attention", "ops.flash_attention", "ops.quaternion", "ops.motion_process",
    "data.humanml", "data.humanml_utils", "models.mdm_t2m", "models.clip_text",
    "utils.text_embedder", "sample.predict", "sample.edit", "ops.rotations",
    "ops.rotations_np", "ops.quaternion_np", "models.smpl", "models.rotation2xyz",
    "data.a2m", "data.uestc", "eval", "eval.metrics", "eval.networks", "eval.stgcn",
    "eval.eval_unconstrained", "eval.eval_a2m", "eval.evaluator_wrapper",
    "eval.eval_humanml", "utils.get_opt", "utils.paramutil", "ops.skeleton",
    "ops.motion_features", "viz.plot", "viz.prior", "viz.joints2smpl", "viz.vis_utils",
    "viz.motions2hik", "models.mdm_old", "parallel", "parallel.distributed",
    "parallel.mesh")} <= set(names), names
# the tokenizer takes re where regex is missing
import gzip, os, tempfile
from gesturediffusion_tpu_torch.models.clip_text import SimpleTokenizer
path = os.path.join(tempfile.mkdtemp(), "bpe.txt.gz")
with gzip.open(path, "wt") as f:
    f.write("#version: 0.2\nh e\n")
assert SimpleTokenizer(path).pat.__class__.__module__ == "re"
print(len(names))
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    r = subprocess.run([sys.executable, "-c", BLOCKED_IMPORT], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 82  # every module of the port was imported


def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path):
    """Alone in a directory (no package) and, here, without a card:
    non-zero exit and no result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    runs = [subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           capture_output=True, text=True, timeout=300)]
    if not torch.cuda.is_available():
        runs.append(subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                                   capture_output=True, text=True, timeout=300))
    for r in runs:
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
