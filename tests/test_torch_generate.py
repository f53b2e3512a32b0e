"""The port's generation CLI (gesturediffusion_tpu_torch/sample/generate.py)
on the CPU: it reads the checkpoint's args.json like the JAX CLI, writes
results.npy in the JAX CLI's layout, and refuses to run without a card
unless --device cpu is given."""

import json
import os

import numpy as np
import pytest
import torch

from gesturediffusion_tpu_torch.models.mdm import MDM
from gesturediffusion_tpu_torch.sample import generate
from gesturediffusion_tpu_torch.utils.parser import generate_args

ARGS = {  # as a JAX training run writes them, extra keys included
    "dataset": "synthetic", "num_frames": 20, "layers": 1, "latent_dim": 64,
    "cond_mask_prob": 0.1, "seed_poses": 10, "noise_schedule": "cosine",
    "diffusion_steps": 6, "sigma_small": True, "arch": "trans_enc",
    "lambda_vel": 0.0, "use_fused_encoder": False,
}


@pytest.fixture
def checkpoint(tmp_path):
    torch.manual_seed(0)
    model = MDM(njoints=498, latent_dim=64, num_layers=1, cond_mask_prob=0.1)
    path = tmp_path / "run" / "model000000000.pt"
    path.parent.mkdir()
    torch.save(model.state_dict(), path)
    with open(path.parent / "args.json", "w") as f:
        json.dump(ARGS, f)
    return str(path)


def test_cli_writes_results_on_cpu(checkpoint, tmp_path):
    out = generate.main([
        "--model_path", checkpoint, "--dataset", "synthetic", "--num_samples", "3",
        "--device", "cpu", "--use_fused_encoder", "--output_dir", str(tmp_path / "out"),
    ])
    res = np.load(os.path.join(out, "results.npy"), allow_pickle=True).item()
    assert res["motion"].shape == (3, 83, 3, 20)
    assert np.isfinite(res["motion"]).all()
    assert res["num_samples"] == 3 and res["num_chunks"] == 1
    assert list(res["lengths"]) == [20, 20, 20]
    with open(os.path.join(out, "results_len.txt")) as f:
        assert f.read().split() == ["20", "20", "20"]


def test_args_json_overrides_checkpoint_groups(checkpoint):
    args = generate_args(["--model_path", checkpoint, "--num_frames", "80",
                          "--diffusion_steps", "1000", "--seed", "3"])
    assert (args.num_frames, args.diffusion_steps, args.layers) == (20, 6, 1)
    assert args.seed == 3 and args.device == "cuda"


def test_cli_needs_a_card_unless_cpu_is_asked(checkpoint):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.main(["--model_path", checkpoint])
