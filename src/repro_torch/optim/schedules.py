"""LR schedules on f32 tensors: cosine (default) and WSD
(warmup-stable-decay, MiniCPM arXiv:2404.06395 §4), the JAX package's
``optim/schedules.py`` op for op."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _cos(x: torch.Tensor) -> torch.Tensor:
    """f32 cosine through f64, rounded once: within an ulp of XLA's."""
    return torch.cos(x.double()).float()


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1) -> torch.Tensor:
    step = _f32(step)
    warm = peak_lr * step / max(warmup, 1)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                     (1 + _cos(math.pi * t)))
    return torch.where(step < warmup, warm, cos)


def wsd_schedule(step, *, peak_lr: float, warmup: int, total: int,
                 decay_frac: float = 0.1, min_ratio: float = 0.01
                 ) -> torch.Tensor:
    """Warmup -> stable at peak -> sharp exponential decay in the last
    ``decay_frac`` of training."""
    step = _f32(step)
    warm = peak_lr * step / max(warmup, 1)
    decay_start = total * (1.0 - decay_frac)
    t = torch.clamp((step - decay_start) / max(total - decay_start, 1),
                    0.0, 1.0)
    decay = peak_lr * torch.exp(torch.log(_f32(min_ratio)) * t)
    stable = torch.full_like(step, peak_lr)
    return torch.where(step < warmup, warm,
                       torch.where(step < decay_start, stable, decay))


def make_schedule(name: str, **kw):
    if name == "wsd":
        return lambda s: wsd_schedule(s, **kw)
    return lambda s: cosine_schedule(s, **kw)
