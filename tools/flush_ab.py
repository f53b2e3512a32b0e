#!/usr/bin/env python3
"""How often the training layer's GEMM flushes its accumulator, against the
action-to-motion step's accuracy and the training kernels' speed, on one card.

    python3 tools/flush_ab.py [variant ...]

Each variant (all of VARIANTS by default) is a copy of this tree (the
package, tools/ and chip_smoke.py) under build/flush_ab/<name>/ with the
flush constants of csrc/encoder_layer_train.cu (kFwdFlush, kDataGradFlush,
kWeightGradFlush: K slices of 32 between the accumulator's flushes into its
f32 sum, for the forward products, the data gradients and the weight
gradients; 0 = never) set as VARIANTS says, and where VARIANTS asks for it
csrc/gemm_tf32x3.cuh patched by CORR_PATCHES: the two correction products
of each k8 step of a flushed GEMM (big . small, small . big) in an
accumulator of their own, the big . big product alone in ``acc``, both
added into the f32 sum at each flush (tried for ROADMAP C6; 142-154
registers a thread against 128 for two blocks an SM).  The GEMM's GENERAL
instantiation (a reduction past K 1024, unaligned operands) flushes every
128 of K in every variant.  Every variant runs its products on
csrc/gemm_tf32x3.cuh (csrc/encoder_layer_train.cu:train_routes patched to
send them all there, as tools/kernel_variants.py train_parent does): the
shipped products on csrc/gemm_ws.cuh are k128's bit for bit.  All variants are built at once; then each runs
in a process of its own, in the order given and again in reverse:

  - first pass only: tools/a2m_f64_check.py at full size (batch 64, 8
    layers, D 512, 60 frames, 6890 vertices, the recipe's lambdas) for each
    of F64_SEEDS (or those of ``--f64-seeds=6,0,1,2``): one step's worst
    gradient and model output against float64, the kernels' beside plain
    f32's, A2M_STEPS train steps'
    losses against float64's (the largest relative gap of any step), the
    kernels' beside plain f32's, and each teacher-forced step's worst
    gradient against float64's, the kernels' beside plain f32's;
  - first pass only: A2M_STEPS train steps at chip_smoke.py phase 13's
    configuration (the action-mode MotionMDM at batch 64, the recipe's
    lambdas through SMPL's chain) through the kernels against the plain
    steps, for three seeds: the losses' largest relative gap and the first
    step's worst max|diff| / max|grad|, beside TOL_STEP_LOSS and
    TOL_STEP_GRAD, and each step's loss gap; beside them the same gaps
    between the plain steps and plain steps from weights nudged by one ulp
    (every weight times 1 +- 2^-23): how far float32 rounding alone carries
    the 5 steps apart; and teacher-forced (chip_smoke.py's comparison),
    each step's worst gradient gap from the plain run's state before it,
    the kernels' and the plain layer's from those weights nudged by one ulp;
  - both passes: kernels 5 and 6 at [64, 81, 256], [64, 197, 512] and
    [64, 61, 512] (tools/take_ab.py:train_kernel_ms, median of three).

One line a variant and pass, with the card's name and power limit.
``--no-f64`` skips the float64 runs.
Needs a CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = "gesturediffusion_tpu_torch/csrc/encoder_layer_train.cu"
PATTERN = re.compile(r"constexpr int kFwdFlush = \d+, kDataGradFlush = \d+, "
                     r"kWeightGradFlush = \d+;")
GEMM = "gesturediffusion_tpu_torch/csrc/gemm_tf32x3.cuh"
CORR_PATCHES = (
    ("""  float acc[32];
  float sum[FLUSH ? 32 : 1];  // the flushed sum
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
""", """  constexpr bool kCorr = FLUSH > 0;
  float acc[32];
  float corr[kCorr ? 32 : 1];  // the correction products' accumulator
  float sum[FLUSH ? 32 : 1];   // the flushed sum
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (kCorr ? 32 : 1); ++i) corr[i] = 0.0f;
"""),
    ("""    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint64_t step = (uint64_t)(s * kTcSlice * sizeof(float)) >> 4;
      wgmma_m64n64k8_tf32(acc, a_big[s], desc_small + step);
      wgmma_m64n64k8_tf32(acc, a_small[s], desc_big + step);
      wgmma_m64n64k8_tf32(acc, a_big[s], desc_big + step);
    }
    wgmma_commit();
    wgmma_wait_all();  // the B tiles and A fragments are read
    reg_fence(acc);
""", """    reg_fence(acc);
    if constexpr (kCorr) reg_fence(corr);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint64_t step = (uint64_t)(s * kTcSlice * sizeof(float)) >> 4;
      if constexpr (kCorr) {
        wgmma_m64n64k8_tf32(corr, a_big[s], desc_small + step);
        wgmma_m64n64k8_tf32(corr, a_small[s], desc_big + step);
      } else {
        wgmma_m64n64k8_tf32(acc, a_big[s], desc_small + step);
        wgmma_m64n64k8_tf32(acc, a_small[s], desc_big + step);
      }
      wgmma_m64n64k8_tf32(acc, a_big[s], desc_big + step);
    }
    wgmma_commit();
    wgmma_wait_all();  // the B tiles and A fragments are read
    reg_fence(acc);
    if constexpr (kCorr) reg_fence(corr);
"""),
    ("""        for (int i = 0; i < 32; ++i) {
          sum[i] += acc[i];
          acc[i] = 0.0f;
        }
""", """        for (int i = 0; i < 32; ++i) {
          if constexpr (kCorr) {
            sum[i] += corr[i];
            corr[i] = 0.0f;
          }
          sum[i] += acc[i];
          acc[i] = 0.0f;
        }
"""),
)

# (forward products, data gradients, weight gradients): slices between
# flushes; then whether the correction products have their own accumulator
VARIANTS = {
    "none": (0, 0, 0, False),       # the unflushed main path, before the C4 repair
    "k128": (4, 4, 4, False),       # every product every 128 of K, one accumulator
    "k128c": (4, 4, 4, True),       # the same, the corrections apart
    "k256": (8, 8, 8, False),
    "k512": (16, 16, 16, False),
    "bwd128": (0, 4, 4, False),     # the gradients' products only
    "wgrad128": (0, 0, 4, False),   # the weight gradients only
    "k32": (1, 1, 1, False),        # every product every slice
    "k64": (2, 2, 2, False),
    "fwd32": (1, 4, 4, False),      # the forward products every slice
}
F64_SEEDS = (6, 0, 2, 3, 4)  # 6: a2m_f64_check.py's default


def load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_tree(name: str) -> str:
    """A copy of this tree with the variant's flush constants."""
    root = os.path.join(HERE, "build", "flush_ab", name)
    shutil.rmtree(root, ignore_errors=True)
    ignore = shutil.ignore_patterns("__pycache__", "build")
    for sub in ("gesturediffusion_tpu_torch", "tools"):
        shutil.copytree(os.path.join(HERE, sub), os.path.join(root, sub), ignore=ignore)
    shutil.copy(os.path.join(HERE, "chip_smoke.py"), root)
    fwd, dgrad, wgrad, corr = VARIANTS[name]
    path = os.path.join(root, SOURCE)
    new, n = PATTERN.subn(f"constexpr int kFwdFlush = {fwd}, kDataGradFlush = {dgrad}, "
                          f"kWeightGradFlush = {wgrad};", open(path).read())
    if n != 1:
        raise RuntimeError(f"{SOURCE}: the flush constants' line is not there to patch")
    routes = "int train_routes(int D, int F) {\n"
    if new.count(routes) != 1:
        raise RuntimeError(f"{SOURCE}: train_routes is not there to patch")
    with open(path, "w") as f:
        f.write(new.replace(routes, routes + "  if (D > 0) return 0;\n"))
    if corr:
        path = os.path.join(root, GEMM)
        text = open(path).read()
        for old, new in CORR_PATCHES:
            if text.count(old) != 1:
                raise RuntimeError(f"{GEMM}: a correction-accumulator patch does not match")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
    return root


def a2m_steps(cs, seed: int) -> tuple[float, float, list, list]:
    """(losses' largest relative gap, the first step's worst gradient gap,
    each step's loss gap) of A2M_STEPS kernel steps against the plain
    steps, phase 13's configuration, inputs from ``seed``, and each step's
    loss gap between the plain steps and those from nudged weights."""
    import copy

    import numpy as np
    import torch

    from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
    from gesturediffusion_tpu_torch.models.mdm_t2m import MotionMDM
    from gesturediffusion_tpu_torch.models.rotation2xyz import rotation2xyz
    from gesturediffusion_tpu_torch.models.smpl import make_synthetic_smpl
    from gesturediffusion_tpu_torch.ops.rotations import (
        matrix_to_rotation_6d,
        rotation_6d_to_matrix,
    )
    from gesturediffusion_tpu_torch.train.loop import TrainConfig

    dev = torch.device("cuda")
    smpl = make_synthetic_smpl(cs.A2M_VERTS).to(dev)

    def fk_fn(sample):
        return rotation2xyz(smpl, sample, pose_rep="rot6d", translation=True, glob=True,
                            jointstype="smpl", vertstrans=False)

    rs = np.random.RandomState(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def motion(b):
        rot = matrix_to_rotation_6d(rotation_6d_to_matrix(randn(b, 24, cs.A2M_FRAMES, 6,
                                                                scale=0.3)))
        trans = torch.zeros(b, 1, cs.A2M_FRAMES, 6, device=dev)
        trans[..., :3] = torch.cumsum(randn(b, 1, cs.A2M_FRAMES, 3, scale=0.01), dim=2)
        return torch.cat([rot, trans], dim=1).permute(0, 1, 3, 2).contiguous()

    torch.manual_seed(6 + seed)
    model = MotionMDM(njoints=cs.A2M_J, nfeats=cs.A2M_F, latent_dim=cs.T2M_D, ff_size=cs.FF,
                      num_layers=cs.LAYERS, num_heads=cs.HEADS, dropout=cs.RATE,
                      cond_mode="action", num_actions=cs.A2M_ACTIONS, cond_mask_prob=0.0,
                      use_fused_train_encoder=True).to(dev)
    plain = copy.deepcopy(model)
    plain.use_kernels = False
    nudged = copy.deepcopy(plain)
    with torch.no_grad():
        g = torch.Generator(device=dev).manual_seed(99)
        for p in nudged.parameters():
            p.mul_(1 + 2.0**-23 * torch.randn(p.shape, generator=g, device=dev).sign())
    diffusion = create_diffusion(noise_schedule="cosine", steps=1000, lambda_rcxyz=1.0,
                                 lambda_vel=1.0, lambda_fc=1.0, device=dev)
    cfg = TrainConfig(lr=1e-4, batch_size=cs.MB)
    lengths = rs.randint(40, cs.A2M_FRAMES + 1, size=cs.MB)
    mask = torch.from_numpy(np.arange(cs.A2M_FRAMES)[None] < lengths[:, None])[:, None, None]
    batches = [dict(motion=motion(cs.MB),
                    cond={"action": torch.from_numpy(
                        rs.randint(0, cs.A2M_ACTIONS, size=cs.MB)).to(dev), "mask": mask.to(dev)},
                    t=torch.from_numpy(rs.randint(0, 1000, size=cs.MB)).to(dev),
                    noise=randn(cs.MB, cs.A2M_J, cs.A2M_F, cs.A2M_FRAMES))
               for _ in range(cs.A2M_STEPS)]
    losses, grads, _, _ = cs.run_train_steps(model, diffusion, cfg, batches, fk_fn)
    p_losses, p_grads, _, _, records = cs.run_train_steps(plain, diffusion, cfg, batches, fk_fn,
                                                          record=True)
    n_losses = cs.run_train_steps(nudged, diffusion, cfg, batches, fk_fn)[0]
    each = [abs(x - y) / abs(y) for x, y in zip(losses, p_losses)]
    grad_err = max((grads[k] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
                   for k, g in p_grads.items())
    # teacher-forced (chip_smoke.py:teacher_forced_steps): each step's worst
    # gradient gap from the plain run's state before it, the kernels' and
    # that of the plain layer from those weights nudged by one ulp
    nudged_records = [{**r, "params": {n: torch.nextafter(w, torch.full_like(w, float("inf")))
                                       for n, w in r["params"].items()}} for r in records]
    forced = {name: [cs.grad_gap(g, r["grads"])[0] for (_, g), r in zip(
        cs.teacher_forced_steps(m, diffusion, cfg, batches, recs, fk_fn), records)]
        for name, m, recs in (("kernels", model, records), ("nudged", plain, nudged_records))}
    return (max(each), grad_err, each, [abs(x - y) / abs(y) for x, y in zip(n_losses, p_losses)],
            forced["kernels"], forced["nudged"])


def one_tree(root: str, accuracy: bool, flags=()) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs = load(os.path.join(root, "chip_smoke.py"), "chip_smoke")
    take_ab = load(os.path.join(root, "tools", "take_ab.py"), "take_ab")
    out = {}
    if accuracy and "--no-f64" not in flags:
        f64 = load(os.path.join(root, "tools", "a2m_f64_check.py"), "a2m_f64_check")

        def worst(x, y):
            return max(abs(u - v) / abs(v) for u, v in zip(x, y))

        seeds = next((tuple(int(x) for x in f.split("=", 1)[1].split(","))
                      for f in flags if f.startswith("--f64-seeds=")), F64_SEEDS)
        out["f64"] = []
        for seed in seeds:
            gaps = f64.main(["--seed", str(seed), "--steps", str(cs.A2M_STEPS)])
            one = next(v for k, v in gaps.items() if k.startswith("recipe"))
            k, p = one["kernels f32 vs plain f64"], one["plain f32   vs plain f64"]
            losses = gaps["steps"]
            out["f64"].append({
                "seed": seed, "grad": [k[1], p[1]], "output": [k[3], p[3]],
                "steps": [worst(losses["kernels f32"], losses["plain f64"]),
                          worst(losses["plain f32"], losses["plain f64"]),
                          worst(losses["kernels f32"], losses["plain f32"])],
                "forced": [(r["kernels f32 vs plain f64"][1], r["plain f32   vs plain f64"][1])
                           for r in gaps["teacher_forced"]]})
    if accuracy:
        out["steps"] = [a2m_steps(cs, seed) for seed in (0, 1, 2)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        out["kernels"] = take_ab.train_kernel_ms(cs, gen)
    return out


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one_tree(argv[1], "--accuracy" in argv[2:], argv[2:])))
        return 0
    flags = [a for a in argv if a.startswith("--")]
    argv = [a for a in argv if not a.startswith("--")]
    import torch

    if not torch.cuda.is_available():
        print("flush_ab: needs a CUDA card", file=sys.stderr)
        return 1
    names = argv or list(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    trees = {name: make_tree(name) for name in names}
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from gesturediffusion_tpu_torch.ops import _build; _build.build(['encoder_layer_train'])",
         root]) for root in trees.values()]
    if any(p.wait() != 0 for p in builds):
        raise RuntimeError("a variant failed to build")
    cs = load(os.path.join(HERE, "chip_smoke.py"), "chip_smoke")
    print(f"flush A/B: tolerances TOL_STEP_LOSS {cs.TOL_STEP_LOSS:g}, TOL_STEP_GRAD "
          f"{cs.TOL_STEP_GRAD:g} [{smi}]", flush=True)
    for pass_, order in enumerate((names, names[::-1])):
        for name in order:
            cmd = [sys.executable, os.path.abspath(__file__), "--one", trees[name]]
            out = subprocess.run(cmd + (["--accuracy", *flags] if pass_ == 0 else []), check=True,
                                 capture_output=True, text=True, cwd=HERE).stdout
            r = json.loads(out.strip().splitlines()[-1])
            line = f"flush A/B pass {pass_ + 1} {name} {VARIANTS[name]}: kernels " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in r["kernels"].items())
            if "f64" in r:
                line += "; vs float64, kernels / plain f32 (seed: one step's worst grad, " \
                        f"output; {cs.A2M_STEPS} steps' worst loss; kernels vs plain): " + \
                        ", ".join(f"{g['seed']}: {g['grad'][0]:.3e} / {g['grad'][1]:.3e}, "
                                  f"{g['output'][0]:.3e} / {g['output'][1]:.3e}; "
                                  f"{g['steps'][0]:.3e} / {g['steps'][1]:.3e}; "
                                  f"{g['steps'][2]:.3e}; teacher-forced each step's worst "
                                  "grad " + " ".join(f"{k:.3e}/{p:.3e}" for k, p in g["forced"])
                                  for g in r["f64"])
            if "steps" in r:
                line += "; a2m steps vs plain (losses, grads; each step's loss; nudged " \
                        "plain's; teacher-forced each step's worst grad, kernels | nudged " \
                        "plain's) " + ", ".join(
                            f"{lo:.3e} {gr:.3e} ({' '.join(f'{e:.1e}' for e in each)}; "
                            f"{' '.join(f'{e:.1e}' for e in nudge)}; "
                            f"{' '.join(f'{e:.1e}' for e in tf)} | "
                            f"{' '.join(f'{e:.1e}' for e in tf_n)})"
                            for lo, gr, each, nudge, tf, tf_n in r["steps"])
            print(f"{line} [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
