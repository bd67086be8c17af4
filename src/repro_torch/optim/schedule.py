"""LR schedules: linear warmup + cosine decay (paper setting).

The step index is a host integer, so the schedule is evaluated on the
host, in numpy float32, with the expressions and the operation order of
the JAX ``optim/schedule.py`` (which computes it in float32 on the
device). Every constant is rounded to float32 where JAX's weak typing
rounds it, so the result does not depend on numpy's promotion rules.
"""
from __future__ import annotations

import numpy as np

f32 = np.float32


def warmup_cosine(step, *, peak_lr, warmup_steps, total_steps,
                  min_ratio=0.1) -> np.float32:
    step = f32(step)
    warm = f32(peak_lr) * step / f32(max(warmup_steps, 1))
    progress = (step - f32(warmup_steps)) \
        / f32(max(total_steps - warmup_steps, 1))
    progress = f32(min(max(progress, f32(0.0)), f32(1.0)))
    cos = f32(min_ratio) + f32((1 - min_ratio) * 0.5) * (
        f32(1.0) + np.cos(f32(np.pi) * progress))
    return warm if step < warmup_steps else f32(peak_lr) * cos


def make_warmup_cosine(peak_lr, warmup_steps, total_steps, min_ratio=0.1):
    """Factory form: returns sched(step) -> lr (numpy float32)."""
    return lambda step: warmup_cosine(
        step, peak_lr=peak_lr, warmup_steps=warmup_steps,
        total_steps=total_steps, min_ratio=min_ratio)


def constant(step, *, peak_lr, warmup_steps=0, **_) -> np.float32:
    step = f32(step)
    warm = f32(peak_lr) * step / f32(max(warmup_steps, 1))
    return warm if step < warmup_steps else f32(peak_lr)
