#!/usr/bin/env python3
"""Kernels 5 and 6 (the training layer's forward and backward) of two trees,
bit for bit, at the whole-batch row offset 0.

    python3 tools/row_offset_ab.py OTHER_TREE      # on the card

Each tree's package builds its own csrc/encoder_layer_train.cu (into its
own build/kernels) and runs, in a process of its own, the forward and the
backward at [64, 81, 256] and [64, 121, 256], 4 heads, ff 1024, dropout
0.1, from the same seeded inputs, without a row offset argument.  The
script prints each output's largest absolute difference between the trees
and the card's name and power limit, and exits 1 if any differs: a change
that gives the kernels a batch-row offset must leave them as they were at
offset 0.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((64, 81), (64, 121))
D, FF, HEADS, RATE = 256, 1024, 4, 0.1


def run(tree: str, out: str) -> None:
    """The outputs of ``tree``'s kernels, saved to ``out``."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from gesturediffusion_tpu_torch.ops import _build
    from gesturediffusion_tpu_torch.ops.fused_encoder_train import (
        encoder_layer_train_bwd,
        encoder_layer_train_fwd,
    )

    _build.build(["encoder_layer_train"])
    rs = np.random.RandomState(0)

    def randn(*shape, scale=1.0):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32) * scale).cuda()

    w = (randn(3 * D, D, scale=D**-0.5), randn(3 * D, scale=0.02), randn(D, D, scale=D**-0.5),
         randn(D, scale=0.02), 1.0 + randn(D, scale=0.1), randn(D, scale=0.1),
         randn(FF, D, scale=D**-0.5), randn(FF, scale=0.02), randn(D, FF, scale=FF**-0.5),
         randn(D, scale=0.02), 1.0 + randn(D, scale=0.1), randn(D, scale=0.1))
    seed = torch.tensor([20240], dtype=torch.int32, device="cuda")
    outs = {}
    for b, t in SHAPES:
        x, g = randn(b, t, D), randn(b, t, D)
        outs[f"fwd [{b},{t},{D}]"] = encoder_layer_train_fwd(x, *w, seed=seed, num_heads=HEADS,
                                                             rate=RATE).cpu()
        for i, o in enumerate(encoder_layer_train_bwd(x, *w, seed=seed, g=g, num_heads=HEADS,
                                                      rate=RATE)):
            outs[f"bwd [{b},{t},{D}] output {i}"] = o.cpu()
    torch.save(outs, out)


def main(other: str) -> int:
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        paths = []
        for i, tree in enumerate((os.path.abspath(other), HERE)):
            paths.append(os.path.join(tmp, f"{i}.pt"))
            subprocess.run([sys.executable, os.path.abspath(__file__), "--run", tree, paths[-1]],
                           check=True, cwd=tree)
        a, b = (torch.load(p) for p in paths)
    worst = 0.0
    for k in b:
        diff = (a[k] - b[k]).abs().max().item()
        worst = max(worst, diff)
        print(f"{k}: max|diff| {diff:.3e} ({other} vs {HERE})")
    print(f"row offset 0: {'identical' if worst == 0 else 'DIFFERENT'} over {len(b)} outputs "
          f"[{smi}]")
    return int(worst != 0)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--run"]:
        run(sys.argv[2], sys.argv[3])
    else:
        os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
        sys.exit(main(sys.argv[1]))
