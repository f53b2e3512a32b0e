"""results.npy -> SMPL mesh OBJ export.

PyTorch counterpart of gesturediffusion_tpu/viz/vis_utils.py (:23-130):
``write_obj``, ``Npy2Obj`` and the render-mesh CLI.  A sample of xyz
joints [J, 3, T] is fitted by SMPLify (viz/joints2smpl.py); a rot6d sample
[25, 6, T] (rows 0-23 each joint's rotation-6d, row 24 the root's
translation) is decoded as it is.  The vertices [T, V, 3] come from SMPL's
skinning on the device; the OBJs (1-based faces) and ``smpl_params.npy``
are written on the host.  The CLI writes the SMPL pickle's triangles (its
``f``) into every OBJ, as the reference's mesh export does; the JAX CLI
writes vertices only.  ``python -m gesturediffusion_tpu_torch.viz.vis_utils
--input_path results.npy [--sample_idx I --rep_idx R] [--device cpu]``
writes ``<name>_obj/frame%03d.obj`` and ``smpl_params.npy``; it runs on the
CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from gesturediffusion_tpu_torch.models.smpl import SMPLModel, read_smpl_pickle_dict
from gesturediffusion_tpu_torch.ops import rotations as R
from gesturediffusion_tpu_torch.utils.device import full_f32, resolve_device
from gesturediffusion_tpu_torch.viz.joints2smpl import (
    DEFAULT_SMPL_MODEL_PATH,
    joints2smpl,
    load_smpl_or_synthetic,
)


def write_obj(path: str, vertices: np.ndarray, faces: Optional[np.ndarray]):
    """A minimal OBJ file: one ``v`` line a vertex, 1-based ``f`` lines; the
    JAX package's bytes, formatted from Python numbers in one write."""
    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in np.asarray(vertices).tolist()]
    if faces is not None:
        lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in np.asarray(faces).tolist()]
    with open(path, "w") as f:
        f.write("".join(line + "\n" for line in lines))


def smpl_faces(path: str) -> Optional[np.ndarray]:
    """The triangles [F, 3] of the SMPL pickle at ``path`` (its ``f``), or
    None where the file or the key is absent."""
    if not os.path.isfile(path):
        return None
    faces = read_smpl_pickle_dict(path).get("f")
    return None if faces is None else np.asarray(faces, np.int64)


class Npy2Obj:
    """One sample of a results.npy as SMPL parameters and per-frame meshes."""

    def __init__(
        self,
        npy_path: str,
        sample_idx: int,
        rep_idx: int,
        smpl: SMPLModel,
        faces: Optional[np.ndarray] = None,
        num_smplify_iters: int = 150,
        device=None,
    ):
        device = resolve_device(device)
        self.smpl = smpl.to(device)
        self.faces = faces
        data = np.load(npy_path, allow_pickle=True).item()
        motions = data["motion"]
        num_samples = data.get("num_samples", motions.shape[0])
        self.absl_idx = rep_idx * num_samples + sample_idx
        motion = motions[self.absl_idx]  # [J, 3 or 6, T]
        self.nframes = motion.shape[-1]

        if motion.shape[1] == 3:  # xyz joints: the SMPLify fit
            self.fit = joints2smpl(self.smpl, motion.transpose(2, 0, 1),
                                   num_smplify_iters=num_smplify_iters, device=device)
            self.thetas = self.fit["thetas"]  # [T, 24, 3]
            self.root_translation = self.fit["root_translation"]
            mats = R.axis_angle_to_matrix(torch.as_tensor(self.thetas, device=device))
        else:  # rot6d rows and the translation row
            self.fit = None
            rot6d = torch.as_tensor(np.ascontiguousarray(motion[:24].transpose(2, 0, 1)),
                                    dtype=torch.float32, device=device)
            mats = R.rotation_6d_to_matrix(rot6d)
            self.thetas = R.matrix_to_axis_angle(mats).cpu().numpy()
            self.root_translation = motion[24, :3].T

        with torch.no_grad(), full_f32():
            verts, _ = self.smpl.lbs(
                mats.new_zeros((self.nframes, self.smpl.num_betas)), mats,
                torch.as_tensor(np.asarray(self.root_translation, np.float32), device=device))
        self.vertices = verts.cpu().numpy()  # [T, V, 3]

    def save_obj(self, save_path: str, frame_i: int) -> str:
        write_obj(save_path, self.vertices[frame_i], self.faces)
        return save_path

    def save_npy(self, save_path: str) -> None:
        np.save(save_path, {
            "motion": self.thetas.transpose(1, 2, 0)[None],
            "thetas": self.thetas,
            "root_translation": self.root_translation,
            "faces": self.faces,
            "vertices": self.vertices,
            "num_frames": self.nframes,
        })


def main(argv=None) -> Npy2Obj:
    """The render-mesh CLI; returns the converter it wrote from."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--input_path", required=True, help="stick figure results.npy path")
    parser.add_argument("--sample_idx", type=int, default=0)
    parser.add_argument("--rep_idx", type=int, default=0)
    parser.add_argument("--num_smplify_iters", type=int, default=150)
    parser.add_argument("--smpl_model", default=os.environ.get(
        "SMPL_MODEL_PATH", DEFAULT_SMPL_MODEL_PATH))
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    smpl = load_smpl_or_synthetic(args.smpl_model)
    out_dir = args.input_path.replace(".npy", "_obj")
    os.makedirs(out_dir, exist_ok=True)
    converter = Npy2Obj(args.input_path, args.sample_idx, args.rep_idx, smpl,
                        faces=smpl_faces(args.smpl_model),
                        num_smplify_iters=args.num_smplify_iters, device=device)
    for i in range(converter.nframes):
        converter.save_obj(os.path.join(out_dir, f"frame{i:03d}.obj"), i)
    converter.save_npy(os.path.join(out_dir, "smpl_params.npy"))
    print(f"saved {converter.nframes} OBJs to {out_dir}")
    return converter


if __name__ == "__main__":
    main()
