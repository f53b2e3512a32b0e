"""Real-time streaming gesture serving.

PyTorch counterpart of gesturediffusion_tpu/serve/streaming.py
(StreamStats :56, StreamingGestureSession :82).  The batch path
(sample/generate.py) needs every audio chunk up front; a live agent has
audio only up to "now", so a session generates the take chunk by chunk:

  * each ``feed()`` runs one chunk through ``diffusion.sampling.ar_chunk_step``,
    the function the batch loop runs for every chunk, so the two paths
    share their per-chunk math;
  * the seed-pose carry stays on the device between chunks; per chunk the
    host sends the conditioning window and reads back the motion chunk,
    and a chunk's latency is measured up to that readback (``.cpu()``
    waits for the device);
  * ``streams`` concurrent takes run batched as one chunk;
  * ``sample_steps`` respaces the sampler (DDPM, DDIM, PLMS or DPM++) for
    latency;
  * ``mesh=`` (parallel/mesh.py) splits the streams over the data ranks
    (serve/streaming.py:188-201): each rank denoises its rows, draws the
    global noise and keeps its rows (parallel/distributed.py:global_rows),
    and every chunk is gathered so that every rank returns the whole chunk.

The session owns a ``torch.Generator`` seeded in ``start()``.  Fed the
same per-chunk conditioning in order, it draws what
``autoregressive_sample_loop`` draws from a generator of the same seed,
so it reproduces the batch take: the JAX package's streamed-equals-batch
invariant.  Any other draw on the session (a warm-up ``feed`` in the same
take, say) shifts every later chunk; ``reset_stats()`` after the first
chunk keeps its latency out of the steady numbers instead.  ``noise_fn``
replaces the draws, as in the sampling loops.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from gesturediffusion_tpu_torch.diffusion.gaussian import (
    GaussianDiffusion,
    ModelMeanType,
    create_diffusion,
)
from gesturediffusion_tpu_torch.diffusion.sampling import NoiseFn, ar_chunk_step, sample_loop
from gesturediffusion_tpu_torch.diffusion.schedules import respacing_string
from gesturediffusion_tpu_torch.models.mdm_fastpath import select_sampling_model_fn
from gesturediffusion_tpu_torch.ops.mfcc import mfcc_for_window
from gesturediffusion_tpu_torch.parallel.distributed import GlobalRows, all_gather_cat, using_rows
from gesturediffusion_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class StreamStats:
    """Per-session serving latency accounting (wall seconds a chunk)."""

    chunks: int = 0
    total_latency_s: float = 0.0
    last_latency_s: float = 0.0
    worst_latency_s: float = 0.0
    motion_seconds_per_chunk: float = 0.0

    @property
    def mean_latency_s(self) -> float:
        return self.total_latency_s / self.chunks if self.chunks else 0.0

    @property
    def realtime_speedup(self) -> float:
        """Seconds of motion produced a wall second (> 1: faster than real
        time), from the mean chunk latency; the first chunk of a process
        includes the kernels' build and load, so ``reset_stats()`` after it
        for steady numbers."""
        mean = self.mean_latency_s
        return self.motion_seconds_per_chunk / mean if mean > 0 else 0.0


class StreamingGestureSession:
    """Incremental chunked-AR gesture generation for live serving.

    Usage::

        session = StreamingGestureSession(model, streams=1)
        session.start(init_seed, rng=0)        # dataset GT seed poses
        chunk = session.feed({"mfcc": mfcc})   # [B, J, F, T] per window
        ...                                    # repeat per audio window

    ``feed_audio`` takes a raw mono window instead and runs the dataset's
    MFCC and z-normalisation on the host (ops/mfcc.py).  The model is moved
    to ``device`` (the CUDA card unless ``"cpu"`` is asked for) and put in
    eval mode.  With ``mesh=`` every rank of the mesh runs the session with
    the same arguments and the same ``feed`` calls (all the streams each
    time), and each gets the whole chunk back.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        *,
        guidance_param: float = 2.5,
        cond_mask_prob: float = 0.1,
        sampler: str = "ddpm",
        sample_steps: Optional[int] = None,
        step_spacing: str = "uniform",
        diffusion: Optional[GaussianDiffusion] = None,
        diffusion_steps: int = 1000,
        noise_schedule: str = "cosine",
        streams: int = 1,
        chunk_frames: int = 80,
        seed_poses: int = 10,
        fps: float = 30.0,
        mesh=None,
        device=None,
        noise_fn: Optional[NoiseFn] = None,
    ):
        self._rows, self._group = None, None
        if mesh is not None:
            dp = mesh.shape["data"]
            if streams % dp != 0:
                raise ValueError(
                    f"streams={streams} is not divisible by the mesh's "
                    f"data axis ({dp})"
                )
            if dp > 1:
                per = streams // dp
                self._rows = GlobalRows(mesh.data_index * per, per, streams)
                self._group = mesh.data_group
        if diffusion is not None and (sample_steps is not None or step_spacing != "uniform"):
            raise ValueError(
                "pass either a prebuilt `diffusion` or "
                "`sample_steps`/`step_spacing` (respacing is baked into "
                "the diffusion), not both"
            )
        self._device = resolve_device(device)
        self._loop = sample_loop(sampler)
        if diffusion is None:
            diffusion = create_diffusion(
                steps=diffusion_steps, noise_schedule=noise_schedule,
                model_mean_type=ModelMeanType.START_X,
                timestep_respacing=respacing_string(sample_steps, sampler, step_spacing),
                device=self._device,
            )
        self._diffusion = diffusion
        self._model = model.to(self._device).eval()
        self._precompute, self._model_fn = select_sampling_model_fn(
            self._model, guidance_param, cond_mask_prob
        )
        self._streams = streams
        self._chunk_frames = chunk_frames
        self._seed_poses = seed_poses
        self._fps = fps
        self._nfeats = getattr(model, "nfeats", 1)
        local = streams if self._rows is None else self._rows.count
        self._shape = (local, model.njoints, self._nfeats, chunk_frames)
        self._scale = (torch.full((local,), guidance_param, device=self._device)
                       if guidance_param != 1 else None)
        self._noise_fn = noise_fn
        self._generator = torch.Generator(device=self._device)
        self._seed: Optional[torch.Tensor] = None
        self._k = 0
        self._stats = StreamStats(motion_seconds_per_chunk=chunk_frames / fps)

    def start(self, init_seed: np.ndarray, rng: int = 0) -> None:
        """Begin a take: the first chunk's seed poses and the seed of the
        session's generator.  ``init_seed`` is [streams, J, F, seed_poses]
        (the dataset's z-normalised seed poses; the reference seeds chunk 0
        from them)."""
        init_seed = torch.as_tensor(init_seed, dtype=torch.float32)
        want = (self._streams, self._shape[1], self._nfeats, self._seed_poses)
        if tuple(init_seed.shape) != want:
            raise ValueError(
                f"init_seed shape {tuple(init_seed.shape)} != {want} "
                "(streams, njoints, nfeats, seed_poses)"
            )
        self._seed = self._local(init_seed.to(self._device))
        self._generator.manual_seed(rng)
        self._k = 0
        self.reset_stats()

    @torch.no_grad()
    def feed(self, cond: dict) -> np.ndarray:
        """Denoise one chunk from per-window conditioning.

        ``cond`` holds the window's arrays with a leading streams axis
        (``{"mfcc": [B, 26, 1, T]}``); the seed and the guidance scale are
        the session's.  Returns the motion chunk [B, J, F, T] in the
        model's normalised space (``dataset.inv_transform`` gives poses),
        read back to the host, which the chunk's latency includes."""
        if self._seed is None:
            raise RuntimeError("call start() before feed()")
        t0 = time.perf_counter()
        dc = {k: self._local(torch.as_tensor(v, device=self._device)) for k, v in cond.items()}
        if self._scale is not None and "scale" not in dc:
            dc["scale"] = self._scale
        with using_rows(self._rows):
            out, self._seed = ar_chunk_step(
                self._diffusion, self._model_fn, self._shape, self._k, dc, self._seed,
                self._seed_poses, generator=self._generator, noise_fn=self._noise_fn,
                cond_precompute=self._precompute, loop=self._loop,
            )
        out_np = all_gather_cat(out, self._group).cpu().numpy()
        dt = time.perf_counter() - t0
        self._k += 1
        s = self._stats
        s.chunks += 1
        s.total_latency_s += dt
        s.last_latency_s = dt
        s.worst_latency_s = max(s.worst_latency_s, dt)
        return out_np

    def feed_audio(
        self,
        audio: np.ndarray,
        *,
        samplerate: float = 22050,
        mfcc_mean: Optional[np.ndarray] = None,
        mfcc_std: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Denoise one chunk from a raw mono audio window: frame-aligned
        MFCCs (ops/mfcc.py), z-normalised with the training statistics
        (data/genea.py), padded or cut to the chunk length.  ``audio`` is
        [L] (given to every stream) or [streams, L]."""
        if getattr(self._model, "reads_audio", False):
            # JAX's session hands the model MFCCs here, which a wav-encoder
            # model does not read: a KeyError at its cond['audio']
            raise KeyError("audio: feed_audio makes MFCCs, and a wav-encoder model reads raw "
                           "audio; feed({'audio': [streams, L]}) instead")
        if (mfcc_mean is None) != (mfcc_std is None):
            raise ValueError("pass mfcc_mean and mfcc_std together")
        audio = np.asarray(audio, np.float32)
        if audio.ndim == 1:
            audio = np.broadcast_to(audio, (self._streams,) + audio.shape)
        if audio.ndim != 2 or audio.shape[0] != self._streams:
            raise ValueError(f"audio must be [L] or [streams, L]; got {audio.shape}")
        t = self._chunk_frames
        rows = []
        for wav in audio:
            feats = mfcc_for_window(wav, fps=self._fps, samplerate=samplerate).astype(np.float32)
            if mfcc_mean is not None:
                feats = (feats - mfcc_mean) / mfcc_std
            rows.append(feats[:t])
        mf = np.zeros((self._streams, rows[0].shape[1], 1, t), np.float32)
        for i, feats in enumerate(rows):
            mf[i, :, 0, : feats.shape[0]] = feats.T
        return self.feed({"mfcc": mf})

    def _local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's streams of an all-streams tensor."""
        r = self._rows
        return x if r is None else x[r.start:r.start + r.count]

    def reset_stats(self) -> None:
        """Zero the latency accounting; the take (seed carry, generator,
        chunk index) goes on."""
        self._stats = StreamStats(motion_seconds_per_chunk=self._chunk_frames / self._fps)

    def stats(self) -> StreamStats:
        return dataclasses.replace(self._stats)
