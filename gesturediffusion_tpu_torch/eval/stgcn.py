"""The ST-GCN skeleton action classifier.

PyTorch counterpart of gesturediffusion_tpu/eval/stgcn.py: the graph of a
skeleton layout (``build_graph`` and its helpers, :31-140, host numpy,
copied: layouts openpose, openpose15, smpl, smpl_noglobal and ntu-rgb+d;
the uniform, distance and spatial partitions) and ``STGCN`` (:143-264) in
PyTorch's NCHW idiom, in both variants: ``recognition`` (10 blocks; the
UESTC classifier, 6 channels on the smpl layout) and ``modi`` (6 blocks;
the unconstrained MoDi features, 3 channels on openpose15).  The parameter
names are the reference's torch layout (``data_bn``,
``st_gcn_networks.{i}.gcn.conv``, ``.tcn.{0,2,3}``, ``.residual.{0,1}``,
``edge_importance.{i}``, ``fcn``), so the released tars load unconverted
(``load_stgcn_checkpoint``, :267): the inverse of JAX ``convert_stgcn``.
Inference only: every BatchNorm reads its running statistics, whatever
the module's mode.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gesturediffusion_tpu_torch.models.smpl import SMPL_PARENTS


# ---------------------------------------------------------------------- #
# graph construction (host-side, static)
# ---------------------------------------------------------------------- #
def _layout_edges(layout: str, parents: Optional[Sequence[int]] = None):
    if layout == "openpose":  # 18-joint original
        num_node = 18
        neighbor = [(4, 3), (3, 2), (7, 6), (6, 5), (13, 12), (12, 11),
                    (10, 9), (9, 8), (11, 5), (8, 2), (5, 1), (2, 1),
                    (0, 1), (15, 0), (14, 0), (17, 15), (16, 14)]
        center = 1
    elif layout == "openpose15":  # MoDi-struct 15-joint variant
        num_node = 15
        neighbor = [(4, 3), (3, 2), (2, 1), (7, 6), (6, 5), (5, 1), (1, 0),
                    (14, 13), (13, 12), (12, 8), (11, 10), (10, 9), (9, 8),
                    (8, 1)]
        center = 1
    elif layout == "smpl":
        num_node = 24
        parents = parents or SMPL_PARENTS
        neighbor = [(j, parents[j]) for j in range(1, num_node)]
        center = 0
    elif layout == "smpl_noglobal":
        parents = parents or SMPL_PARENTS
        neighbor = [
            (j - 1, parents[j] - 1)
            for j in range(1, 24)
            if parents[j] != 0 and j != 0
        ]
        num_node = 23
        center = 0
    elif layout == "ntu-rgb+d":
        num_node = 25
        neighbor_1base = [(1, 2), (2, 21), (3, 21), (4, 3), (5, 21), (6, 5),
                          (7, 6), (8, 7), (9, 21), (10, 9), (11, 10),
                          (12, 11), (13, 1), (14, 13), (15, 14), (16, 15),
                          (17, 1), (18, 17), (19, 18), (20, 19), (22, 23),
                          (23, 8), (24, 25), (25, 12)]
        neighbor = [(i - 1, j - 1) for (i, j) in neighbor_1base]
        center = 20
    else:
        raise NotImplementedError(f"layout {layout}")
    self_link = [(i, i) for i in range(num_node)]
    return num_node, self_link + neighbor, center


def _hop_distance(num_node: int, edges, max_hop: int = 1) -> np.ndarray:
    A = np.zeros((num_node, num_node))
    for i, j in edges:
        A[j, i] = 1
        A[i, j] = 1
    hop_dis = np.full((num_node, num_node), np.inf)
    transfer = [np.linalg.matrix_power(A, d) for d in range(max_hop + 1)]
    arrive = np.stack(transfer) > 0
    for d in range(max_hop, -1, -1):
        hop_dis[arrive[d]] = d
    return hop_dis


def _normalize_digraph(A: np.ndarray) -> np.ndarray:
    Dl = A.sum(0)
    Dn = np.zeros_like(A)
    idx = Dl > 0
    Dn[np.where(idx)[0], np.where(idx)[0]] = Dl[idx] ** -1
    return A @ Dn


def build_graph(
    layout: str = "openpose15",
    strategy: str = "spatial",
    max_hop: int = 1,
    parents: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Adjacency stack [K, V, V] (spatial partitioning per ST-GCN paper)."""
    num_node, edges, center = _layout_edges(layout, parents)
    hop_dis = _hop_distance(num_node, edges, max_hop)
    valid_hop = range(0, max_hop + 1)
    adjacency = np.zeros((num_node, num_node))
    for hop in valid_hop:
        adjacency[hop_dis == hop] = 1
    norm_adj = _normalize_digraph(adjacency)

    if strategy == "uniform":
        return norm_adj[None]
    if strategy == "distance":
        A = np.zeros((len(list(valid_hop)), num_node, num_node))
        for i, hop in enumerate(valid_hop):
            A[i][hop_dis == hop] = norm_adj[hop_dis == hop]
        return A
    if strategy == "spatial":
        A = []
        for hop in valid_hop:
            a_root = np.zeros((num_node, num_node))
            a_close = np.zeros((num_node, num_node))
            a_further = np.zeros((num_node, num_node))
            for i in range(num_node):
                for j in range(num_node):
                    if hop_dis[j, i] == hop:
                        if hop_dis[j, center] == hop_dis[i, center]:
                            a_root[j, i] = norm_adj[j, i]
                        elif hop_dis[j, center] > hop_dis[i, center]:
                            a_close[j, i] = norm_adj[j, i]
                        else:
                            a_further[j, i] = norm_adj[j, i]
            if hop == 0:
                A.append(a_root)
            else:
                A.append(a_root + a_close)
                A.append(a_further)
        return np.stack(A)
    raise NotImplementedError(f"strategy {strategy}")


# ---------------------------------------------------------------------- #
# network
# ---------------------------------------------------------------------- #
# block configurations: (channels, strides)
STGCN_VARIANTS = {
    # 10-block stack (reference: eval/a2m/recognition/models/stgcn.py:50-62)
    "recognition": (
        (64, 64, 64, 64, 128, 128, 128, 256, 256, 256),
        (1, 1, 1, 1, 2, 1, 1, 2, 1, 1),
    ),
    # 6-block MoDi stack (reference: eval/unconstrained/models/stgcn.py:52-61)
    "modi": ((64, 64, 64, 128, 128, 256), (1, 1, 1, 2, 1, 2)),
}
TEMPORAL_KERNEL = 9


def _bn(x: torch.Tensor, bn: nn.BatchNorm1d | nn.BatchNorm2d) -> torch.Tensor:
    """BatchNorm from its running statistics (frozen evaluation)."""
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                        training=False, eps=bn.eps)


class GraphConv(nn.Module):
    """ConvTemporalGraphical: a 1x1 conv to K*C channels, then the
    contraction with the K adjacency matrices."""

    def __init__(self, in_channels: int, out_channels: int, spatial_kernel: int):
        super().__init__()
        self.spatial_kernel = spatial_kernel
        self.conv = nn.Conv2d(in_channels, out_channels * spatial_kernel, kernel_size=1)

    def forward(self, x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
        h = self.conv(x)  # [N, K*C, T, V]
        n, kc, t, v = h.shape
        h = h.view(n, self.spatial_kernel, kc // self.spatial_kernel, t, v)
        return torch.einsum("nkctv,kvw->nctw", h, A).contiguous()


class STGCNBlock(nn.Module):
    """GraphConv -> BN -> ReLU -> temporal conv (9 x 1, stride) -> BN, plus
    the residual (none, identity, or a strided 1x1 conv and BN), -> ReLU."""

    def __init__(self, in_channels: int, out_channels: int, spatial_kernel: int,
                 stride: int = 1, residual: bool = True):
        super().__init__()
        pad = (TEMPORAL_KERNEL - 1) // 2
        self.gcn = GraphConv(in_channels, out_channels, spatial_kernel)
        self.tcn = nn.Sequential(
            nn.BatchNorm2d(out_channels),
            nn.ReLU(),
            nn.Conv2d(out_channels, out_channels, (TEMPORAL_KERNEL, 1), (stride, 1), (pad, 0)),
            nn.BatchNorm2d(out_channels),
        )
        self.res_mode = ("none" if not residual else
                         "identity" if in_channels == out_channels and stride == 1 else "conv")
        if self.res_mode == "conv":
            self.residual = nn.Sequential(
                nn.Conv2d(in_channels, out_channels, kernel_size=1, stride=(stride, 1)),
                nn.BatchNorm2d(out_channels),
            )

    def forward(self, x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
        if self.res_mode == "none":
            res = 0.0
        elif self.res_mode == "identity":
            res = x
        else:
            res = _bn(self.residual[0](x), self.residual[1])
        h = F.relu(_bn(self.gcn(x, A), self.tcn[0]))
        h = _bn(self.tcn[2](h), self.tcn[3])
        return F.relu(h + res)


class STGCN(nn.Module):
    """ST-GCN classifier: x [N, C, T, V] -> logits [N, num_class] (and the
    pooled features [N, 256] with ``return_features``)."""

    def __init__(self, in_channels: int = 3, num_class: int = 12, layout: str = "openpose15",
                 strategy: str = "spatial", edge_importance_weighting: bool = True,
                 variant: str = "modi"):
        super().__init__()
        A = torch.as_tensor(build_graph(layout, strategy), dtype=torch.float32)
        self.register_buffer("A", A, persistent=False)
        channels, strides = STGCN_VARIANTS[variant]
        self.data_bn = nn.BatchNorm1d(in_channels * A.shape[1])
        c_in = [in_channels, *channels[:-1]]
        self.st_gcn_networks = nn.ModuleList(
            STGCNBlock(ci, co, A.shape[0], stride=s, residual=(i != 0))
            for i, (ci, co, s) in enumerate(zip(c_in, channels, strides)))
        self.edge_importance = (
            nn.ParameterList(nn.Parameter(torch.ones_like(A)) for _ in self.st_gcn_networks)
            if edge_importance_weighting else None)
        self.fcn = nn.Conv2d(channels[-1], num_class, kernel_size=1)

    def forward(self, x: torch.Tensor, return_features: bool = False):
        n, c, t, v = x.shape
        # data BN over the V*C channels of each frame, channel v*C + c
        h = _bn(x.permute(0, 3, 1, 2).reshape(n, v * c, t), self.data_bn)
        h = h.reshape(n, v, c, t).permute(0, 2, 3, 1).contiguous()  # [N, C, T, V]
        for i, block in enumerate(self.st_gcn_networks):
            A = self.A if self.edge_importance is None else self.A * self.edge_importance[i]
            h = block(h, A)
        feats = h.mean(dim=(2, 3))  # global average pool over (T, V)
        logits = self.fcn(feats[:, :, None, None])[:, :, 0, 0]
        return (logits, feats) if return_features else logits


def load_stgcn_checkpoint(path_or_ckpt, model: Optional[STGCN] = None) -> dict:
    """A released ST-GCN tar (a path, or what ``torch.load`` returned) ->
    its state dict, the ``{"model": ...}`` wrapper removed and the graph
    buffer ``A`` dropped (the model builds its own).  With ``model`` the
    stored graph is first checked against the model's: a tar of another
    layout raises."""
    if isinstance(path_or_ckpt, (str, bytes, os.PathLike)):
        sd = torch.load(path_or_ckpt, map_location="cpu", weights_only=False)
    else:
        sd = path_or_ckpt
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    sd = dict(sd)
    A = sd.pop("A", None)
    if A is not None and model is not None and (
            tuple(A.shape) != tuple(model.A.shape)
            or not torch.allclose(A.float().cpu(), model.A.cpu(), atol=1e-6)):
        raise ValueError(f"the checkpoint's graph {tuple(A.shape)} is not the model's "
                         f"{tuple(model.A.shape)}")
    return sd
