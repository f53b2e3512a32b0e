"""Timestep importance samplers.

PyTorch counterpart of gesturediffusion_tpu/diffusion/resample.py: the
uniform sampler and the loss-second-moment sampler, whose state lives in
tensors on the model's device and is updated without a host round trip.
"""

from __future__ import annotations

from typing import Optional

import torch


def create_named_schedule_sampler(name: str, num_timesteps: int, device=None):
    """resample.py:create_named_schedule_sampler."""
    if name == "uniform":
        return UniformSampler(num_timesteps)
    if name == "loss-second-moment":
        return LossSecondMomentState(num_timesteps, device=device)
    raise NotImplementedError(f"unknown schedule sampler: {name}")


class UniformSampler:
    """Uniform timesteps; importance weights are identically 1."""

    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps

    def sample(self, batch_size: int, generator: torch.Generator):
        dev = generator.device
        t = torch.randint(0, self.num_timesteps, (batch_size,), generator=generator, device=dev)
        return t, torch.ones((batch_size,), dtype=torch.float32, device=dev)

    def update_with_losses(self, ts: torch.Tensor, losses: torch.Tensor) -> None:
        pass

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None:
        pass


class LossSecondMomentState:
    """Importance-sample timesteps in proportion to sqrt(E[loss^2]) over a
    ring of the last ``history_per_term`` losses of each timestep; uniform
    until every timestep has a full ring."""

    def __init__(self, num_timesteps: int, history_per_term: int = 10,
                 uniform_prob: float = 0.001, device=None):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self.history = torch.zeros((num_timesteps, history_per_term), device=device)
        self.counts = torch.zeros((num_timesteps,), dtype=torch.int64, device=device)

    def warmed_up(self) -> torch.Tensor:
        return (self.counts == self.history_per_term).all()

    def weights(self) -> torch.Tensor:
        """Per-timestep sampling probabilities (normalised)."""
        raw = (self.history**2).mean(dim=-1).sqrt()
        raw = raw / raw.sum()
        raw = raw * (1 - self.uniform_prob) + self.uniform_prob / self.num_timesteps
        uniform = torch.full_like(raw, 1.0 / self.num_timesteps)
        return torch.where(self.warmed_up(), raw, uniform)

    def sample(self, batch_size: int, generator: Optional[torch.Generator]):
        p = self.weights()
        t = torch.multinomial(p, batch_size, replacement=True, generator=generator)
        return t, 1.0 / (self.num_timesteps * p[t])

    def update_with_losses(self, ts: torch.Tensor, losses: torch.Tensor) -> None:
        """Insert a batch of (t, loss) observations as the reference's
        sequential loop does, duplicates in batch order: each timestep's
        ring becomes the last K of (its valid entries, then its new losses).
        Computed with scatters, without a loop over the batch."""
        k = self.history_per_term
        ts = ts.long()
        n_new = torch.bincount(ts, minlength=self.num_timesteps)
        rank = torch.tril((ts[:, None] == ts[None, :]).long(), diagonal=-1).sum(dim=1)
        total = self.counts + n_new
        shift = (total - k).clamp(min=0)                       # oldest entries dropped
        slot = torch.arange(k, device=ts.device)
        old_pos = slot[None, :] - shift[:, None]
        old_ok = (slot[None, :] < self.counts[:, None]) & (old_pos >= 0)
        history = torch.zeros_like(self.history)
        rows = torch.arange(self.num_timesteps, device=ts.device)[:, None].expand(-1, k)
        history[rows[old_ok], old_pos[old_ok]] = self.history[old_ok]
        new_pos = self.counts[ts] + rank - shift[ts]
        new_ok = new_pos >= 0
        history[ts[new_ok], new_pos[new_ok]] = losses.float()[new_ok]
        self.history = history
        self.counts = total.clamp(max=k)

    def state_dict(self) -> dict:
        return {"history": self.history, "counts": self.counts}

    def load_state_dict(self, state: dict) -> None:
        self.history = state["history"].to(self.history.device)
        self.counts = state["counts"].to(self.counts.device)
