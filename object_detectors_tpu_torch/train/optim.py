"""Optimizers and learning-rate schedules (port of the JAX package's
``train/optim.py``, which builds them with optax).

SGD with momentum and weight decay (the decay added to the gradient before
the momentum, as ``add_decayed_weights`` before ``sgd``), or AdamW, on
``torch.optim``; the learning rate of every step is set from the ported
schedule, evaluated, as optax's ``inject_hyperparams`` does, at the count of
updates made before this one (the first update takes ``schedule(0)``).
Epoch-granular schedules are functions of the step with a known
``steps_per_epoch``. ReduceLROnPlateau is a host-side ``PlateauState``
whose scale multiplies the whole update, weight decay included.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Sequence

import torch


@dataclasses.dataclass
class OptimizerConfig:
    name: str = "sgd"          # sgd | adam (AdamW)
    lr: float = 1e-3
    weight_decay: float = 5e-4
    momentum: float = 0.9


@dataclasses.dataclass
class SchedulerConfig:
    name: str = "step"          # step | multistep | cyclic | reduce_on_plateau
    step_size: int = 100        # step (epochs)
    factor: float = 0.1         # step / multistep / plateau gamma
    milestones: Sequence[int] = (15, 25)   # multistep (epochs)
    base_lr: float = 1e-4       # cyclic
    max_lr: float = 1e-3        # cyclic
    cycle_steps: int = 4000     # cyclic: up and down
    mode: str = "max"           # plateau
    patience: int = 10          # plateau
    warmup_steps: int = 0       # linear warmup
    warmup_factor: float = 1.0 / 1000


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over ``steps``, then end."""
    def sched(step):
        frac = 1.0 - min(max(step, 0), steps) / steps
        return (init - end) * frac + end
    return sched


def make_schedule(opt_cfg: OptimizerConfig, sch_cfg: SchedulerConfig,
                  steps_per_epoch: int) -> Callable[[int], float]:
    """The learning rate as a function of the step (plateau is the constant
    base; its scale lives in ``PlateauState``)."""
    base = opt_cfg.lr
    name = sch_cfg.name
    if name == "multistep":
        boundaries = sorted({int(m) * steps_per_epoch: sch_cfg.factor
                             for m in sch_cfg.milestones}.items())

        def sched(step):
            v = base
            for boundary, scale in boundaries:
                if step >= boundary:
                    v = v * scale
            return v
    elif name == "cyclic":
        # triangular: linear base_lr -> max_lr -> base_lr, repeated
        half = max(sch_cfg.cycle_steps // 2, 1)
        up = _linear(sch_cfg.base_lr, sch_cfg.max_lr, half)
        down = _linear(sch_cfg.max_lr, sch_cfg.base_lr, half)

        def sched(step):
            t = step % (2 * half)
            return up(t) if t < half else down(t - half)
    elif name == "reduce_on_plateau":
        def sched(step):
            return base
    else:  # step
        def sched(step):
            epoch = step // steps_per_epoch
            return base * (sch_cfg.factor ** (epoch // sch_cfg.step_size))

    if sch_cfg.warmup_steps > 0:
        warm = _linear(base * sch_cfg.warmup_factor, base, sch_cfg.warmup_steps)
        inner = sched

        def sched(step):  # noqa: F811
            return warm(step) if step < sch_cfg.warmup_steps else inner(step)
    return sched


class ScheduledOptimizer:
    """A ``torch.optim`` optimizer whose learning rate each ``step()`` takes
    from the schedule at ``count`` (the updates made so far) times
    ``plateau_scale``."""

    def __init__(self, params: Iterable[torch.nn.Parameter], opt_cfg: OptimizerConfig,
                 schedule: Callable[[int], float]):
        params = list(params)
        if opt_cfg.name == "adam":
            self.optimizer = torch.optim.AdamW(params, lr=schedule(0), betas=(0.9, 0.999),
                                               eps=1e-8, weight_decay=opt_cfg.weight_decay)
        else:
            self.optimizer = torch.optim.SGD(params, lr=schedule(0), momentum=opt_cfg.momentum,
                                             weight_decay=opt_cfg.weight_decay)
        self.schedule = schedule
        self.count = 0
        self.plateau_scale = 1.0

    @property
    def lr(self) -> float:
        """The learning rate the next update takes."""
        return self.schedule(self.count) * self.plateau_scale

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        lr = self.lr
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1


def make_optimizer(opt_cfg: OptimizerConfig, sch_cfg: SchedulerConfig,
                   steps_per_epoch: int = 1):
    """SGD (momentum) + weight decay or AdamW with the configured schedule:
    returns ``init(params) -> ScheduledOptimizer``, the counterpart of an
    optax transformation's ``init``."""
    schedule = make_schedule(opt_cfg, sch_cfg, steps_per_epoch)

    def init(params) -> ScheduledOptimizer:
        return ScheduledOptimizer(params, opt_cfg, schedule)
    return init


@dataclasses.dataclass
class PlateauState:
    """Host-side ReduceLROnPlateau: after ``patience`` epochs without
    improvement, multiply the learning rate by ``factor``."""

    factor: float = 0.1
    patience: int = 10
    mode: str = "max"
    best: float | None = None
    bad_epochs: int = 0
    scale: float = 1.0

    def update(self, metric: float) -> float:
        better = (self.best is None
                  or (self.mode == "max" and metric > self.best)
                  or (self.mode == "min" and metric < self.best))
        if better:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale *= self.factor
                self.bad_epochs = 0
        return self.scale
