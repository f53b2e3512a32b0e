#!/usr/bin/env python3
"""Where kernel 6's time goes past a head width of 128, on one card.

    python3 tools/wide_bwd_profile.py [D ...]

For each layer width D (default 1024 and 2080: 4 heads of 256 and 520),
the training layer's backward (kernel 6: the forward recomputed, then the
backward) at [64, 81, D], ff 1024, rate 0.1, is timed by CUDA events, and
one call is profiled: its device time in all, and that of its attention
backward by pass (D's row dot products, the dQ pass, the dK/dV pass), with
the passes' kernel names.  Beside them: the attention backward's bound (its
five products once in three TF32 passes against q, k, v, o, dO and the LSE
read once and dq, dk, dv written once), the library's attention backward
alone (the autograd backward of a retained F.scaled_dot_product_attention
forward at the same rate) and the SDPA layer's forward + backward
(chip_smoke.py's encoder_layer_sdpa), with the card's name and power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main(widths: list[int]) -> int:
    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("wide_bwd_profile: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    own = np.random.RandomState(18)

    def randn(*shape, scale=1.0):
        return torch.from_numpy(own.randn(*shape).astype(np.float32) * scale).to("cuda")

    seed = torch.tensor([20240], dtype=torch.int32, device="cuda")
    b, t = cs.MB, cs.T + 1
    for d in widths:
        w = cs.layer_weights(randn, d, cs.FF)
        x, g = randn(b, t, d), randn(b, t, d)
        with torch.random.fork_rng(devices=[torch.cuda.current_device()]):
            split = cs.attention_backward_split(x, g, w, seed)
            sdpa_bwd = cs.sdpa_backward_ms(b, t, d // cs.HEADS)
            tw = [y.clone().requires_grad_() for y in w]
            tx = x.clone().requires_grad_()

            def sdpa_layer():
                with torch.enable_grad():
                    cs.encoder_layer_sdpa(tx, *tw, cs.HEADS, rate=cs.RATE).backward(g)

            sdpa_layer_ms = cs.cuda_time_ms(sdpa_layer, iters=10, warmup=2)
        flops, nbytes, bound, by = cs.attention_backward_bound(b, t, d)
        t_bytes, t_ops = nbytes / cs.PEAK_BYTES_PER_S * 1e3, 3 * flops / cs.PEAK_TF32_FLOPS * 1e3
        parts = ", ".join(f"{k} {split[k]:.4f} ms x{split[k + ' launches']}"
                          for k, _ in cs.ATTN_BWD_KERNELS)
        print(f"kernel 6 [{b},{t},{d}] heads {cs.HEADS} of {d // cs.HEADS} ff {cs.FF} rate "
              f"{cs.RATE}: call {split['call']:.4f} ms (CUDA events), device {split['device']:.4f} "
              f"ms; attention backward {split['passes']:.4f} ms ({parts}), "
              f"{split['passes'] / split['device']:.3f} of the device time; its bound "
              f"{bound:.4f} ms ({by}; bytes {t_bytes:.4f}, operations {t_ops:.4f}), "
              f"{bound / split['passes']:.3f} of it; SDPA's backward alone {sdpa_bwd:.4f} ms; "
              f"the SDPA layer forward + backward {sdpa_layer_ms:.4f} ms [{smi}]", flush=True)
        for name, ms in sorted(split["names"].items(), key=lambda kv: -kv[1]):
            print(f"  {ms:.4f} ms  {name}", flush=True)
        del w, x, g, tw, tx
    return 0


if __name__ == "__main__":
    sys.exit(main([int(a) for a in sys.argv[1:]] or [1024, 2080]))
