"""Stick-figure 3D motion animation, host matplotlib.

Copy of gesturediffusion_tpu/viz/plot.py for the port (``plot_3d_motion``
:29-140): per-dataset scaling (GENEA x0.015), chain colours, the ground
truth's frames tinted blue for the edit modes, an animation through
matplotlib's FuncAnimation.  The writer is ffmpeg where the binary is on
the PATH and the file an .mp4, else pillow writing a GIF beside it.
matplotlib is imported when a video is drawn, not with the module: it is
optional (the machine with the card lacks it), and ``render_or_log``, which
the CLIs call, logs a skipped video where it is not installed.
"""

from __future__ import annotations

import shutil
import warnings

import numpy as np


def _writer_for(save_path: str):
    if shutil.which("ffmpeg") and save_path.endswith(".mp4"):
        return save_path, "ffmpeg"
    if save_path.endswith(".mp4"):
        return save_path[:-4] + ".gif", "pillow"
    return save_path, "pillow"


def plot_3d_motion(
    save_path: str,
    kinematic_tree,
    joints: np.ndarray,  # (T, J, 3)
    title: str = "",
    dataset: str | None = None,
    figsize=(3, 3),
    fps: float = 120,
    radius: float = 3,
    vis_mode: str = "default",
    gt_frames: list | tuple = (),
) -> str:
    """Render a joint-position sequence to video; returns the file written."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import MatplotlibDeprecationWarning
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation
    from mpl_toolkits.mplot3d import Axes3D  # noqa: F401

    data = np.asarray(joints, np.float64).copy()

    if dataset in ("kit",):
        data *= 0.003
    elif dataset in ("humanml",):
        data *= 1.3
    elif dataset in ("humanact12", "uestc"):
        data *= -1.5
    elif dataset in ("genea2022", "genea2023", "synthetic"):
        data *= 0.015

    frame_number = data.shape[0]
    MINS, MAXS = data.min(axis=0).min(axis=0), data.max(axis=0).max(axis=0)

    colors_blue = ["#4D84AA", "#5B9965", "#61CEB9", "#34C1E2", "#80B79A"]
    colors_orange = ["#DD5A37", "#D69E00", "#B75A39", "#FF6D00", "#DDB50E"]
    colors = colors_orange
    if vis_mode == "upper_body":
        colors[0] = colors_blue[0]
        colors[1] = colors_blue[1]
    elif vis_mode == "gt":
        colors = colors_blue

    height_offset = MINS[1]
    data[:, :, 1] -= height_offset
    trajec = data[:, 0, [0, 2]].copy()
    data[..., 0] -= data[:, 0:1, 0]
    data[..., 2] -= data[:, 0:1, 2]

    fig = plt.figure(figsize=figsize)
    plt.tight_layout()
    ax = fig.add_subplot(111, projection="3d")

    def init():
        ax.set_xlim3d([-radius / 2, radius / 2])
        ax.set_ylim3d([0, radius])
        ax.set_zlim3d([-radius / 3.0, radius * 2 / 3.0])
        fig.suptitle(title, fontsize=10)
        ax.grid(False)

    def plot_xz_plane(minx, maxx, miny, minz, maxz):
        verts = [
            [minx, miny, minz], [minx, miny, maxz],
            [maxx, miny, maxz], [maxx, miny, minz],
        ]
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection

        xz_plane = Poly3DCollection([verts])
        xz_plane.set_facecolor((0.5, 0.5, 0.5, 0.5))
        ax.add_collection3d(xz_plane)

    def update(index):
        ax.clear()  # resets the grid to default-ON — re-disable below
        ax.grid(False)
        ax.view_init(elev=120, azim=-90)
        # the reference's camera distance; matplotlib 3.6-3.7 honour it
        # with a deprecation warning, 3.8 and later ignore the attribute
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", MatplotlibDeprecationWarning)
            ax.dist = 7.5
        ax.set_xlim3d([-radius / 2, radius / 2])
        ax.set_ylim3d([0, radius])
        ax.set_zlim3d([-radius / 3.0, radius * 2 / 3.0])
        plot_xz_plane(
            MINS[0] - trajec[index, 0],
            MAXS[0] - trajec[index, 0],
            0,
            MINS[2] - trajec[index, 1],
            MAXS[2] - trajec[index, 1],
        )
        used_colors = colors_blue if index in gt_frames else colors
        # cycle colors: skeletons can have more chains than palette entries
        # (zip would silently truncate rendering to the first 5 chains)
        from itertools import cycle

        for i, (chain, color) in enumerate(
            zip(kinematic_tree, cycle(used_colors))
        ):
            linewidth = 4.0 if i < 5 else 2.0
            ax.plot3D(
                data[index, chain, 0],
                data[index, chain, 1],
                data[index, chain, 2],
                linewidth=linewidth,
                color=color,
            )
        ax.set_xticklabels([])
        ax.set_yticklabels([])
        ax.set_zticklabels([])

    out_path, writer = _writer_for(save_path)
    anim = FuncAnimation(
        fig, update, frames=frame_number, interval=1000 / fps, repeat=False,
        init_func=init,
    )
    anim.save(out_path, fps=fps, writer=writer)
    plt.close(fig)
    return out_path


def render_or_log(log, save_path: str, *args, **kwargs):
    """``plot_3d_motion``, or where matplotlib is not installed the JAX CLIs'
    log line for a skipped video (and None).  Any other error propagates."""
    try:
        return plot_3d_motion(save_path, *args, **kwargs)
    except ModuleNotFoundError as e:
        if e.name != "matplotlib":
            raise
        log(f"  (video skipped: {e})")
        return None
