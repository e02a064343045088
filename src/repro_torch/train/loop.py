"""Training loop, as in `repro.train.loop`: the step (gradient
accumulation over microbatches, a remat policy around the loss), and
`train` with checkpoint/restart and the fault monitor's hooks.

Eager PyTorch has no jit, so the reference's `jit=` switch has no
counterpart: the step runs as written.  The step computes gradients
with `torch.autograd.grad` on detached views of the parameter leaves,
made to require grad, then updates the parameters and moments in place
(`repro_torch.optim.adamw_update`); `train` works on a private clone of
the caller's parameters, as the reference copies them before donating
them to its jitted step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..launch.faults import FaultMonitor
from ..models.model import (_dots_saveable, _leaves, _map_shapes, _set,
                            loss_fn)
from ..optim.adamw import AdamWConfig, adamw_update, init_opt_state

__all__ = ["TrainConfig", "make_train_step", "train"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1            # gradient accumulation
    remat: str = "none"              # none | full | dots_saveable
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    log_every: int = 10


def _remat_loss(name: str) -> Callable:
    """loss_fn under the remat policy `name`: none, full (save nothing,
    recompute all) or dots_saveable (save the matrix products)."""
    if name == "none":
        return loss_fn
    if name == "full":
        return lambda params, batch, cfg: checkpoint(
            loss_fn, params, batch, cfg, use_reentrant=False)
    if name == "dots_saveable":
        return lambda params, batch, cfg: checkpoint(
            loss_fn, params, batch, cfg, use_reentrant=False,
            context_fn=_dots_saveable)
    raise ValueError(name)


def _value_and_grad(loss, params, batch, cfg):
    """(loss, [grad per leaf in `_leaves` order])."""
    tree = _map_shapes(params,
                       lambda leaf: leaf.detach().requires_grad_(True))
    value = loss(tree, batch, cfg)
    grads = torch.autograd.grad(value, [leaf for _, leaf in _leaves(tree)])
    return value.detach(), list(grads)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    tc: TrainConfig) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), the
    parameters and moments updated in place; metrics dict(loss,
    grad_norm, lr) of float32 device scalars."""
    base_loss = _remat_loss(tc.remat)

    def step(params, opt_state, batch):
        if tc.microbatches > 1:
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            grads = [torch.zeros(leaf.shape, dtype=torch.float32,
                                 device=leaf.device)
                     for _, leaf in _leaves(params)]
            for i in range(tc.microbatches):
                mb = {k: v[i * (v.shape[0] // tc.microbatches):
                           (i + 1) * (v.shape[0] // tc.microbatches)]
                      for k, v in batch.items()}
                l, g = _value_and_grad(base_loss, params, mb, cfg)
                loss = loss + l
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                del g
            loss = loss / tc.microbatches
            grads = [g / tc.microbatches for g in grads]
        else:
            loss, grads = _value_and_grad(base_loss, params, batch, cfg)

        grad_tree = _map_shapes(params, lambda leaf: None)
        for (path, _), g in zip(_leaves(params), grads):
            _set(grad_tree, path, g)
        del grads
        params, opt_state, om = adamw_update(params, grad_tree, opt_state,
                                             opt_cfg)
        return params, opt_state, dict(loss=loss, **om)

    return step


def train(cfg: ModelConfig, opt_cfg: AdamWConfig, tc: TrainConfig,
          data_source, params, n_steps: int,
          monitor: Optional[FaultMonitor] = None):
    """Run n_steps; resumes from tc.ckpt_dir if a checkpoint exists.
    Returns (params, opt_state, history); the caller's params are left
    as they were."""
    from ..ckpt.checkpoint import (latest_step, restore_checkpoint,
                                   save_checkpoint)

    params = _map_shapes(params, lambda leaf: leaf.detach().clone())
    opt_state = init_opt_state(params, opt_cfg)
    start = 0
    if tc.ckpt_dir:
        last = latest_step(tc.ckpt_dir)
        if last is not None:
            tree = restore_checkpoint(tc.ckpt_dir, last,
                                      dict(p=params, o=opt_state))
            params, opt_state = tree["p"], tree["o"]
            start = last

    step_fn = make_train_step(cfg, opt_cfg, tc)
    history = []
    pending_save = None
    for step in range(start, n_steps):
        t0 = time.time()
        batch = data_source.batch_at(step)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if monitor is not None:
            monitor.heartbeat(step)
            if monitor.should_checkpoint_and_exit():
                save_checkpoint(tc.ckpt_dir, step + 1,
                                dict(p=params, o=opt_state))
                return params, opt_state, history
        if step % tc.log_every == 0:
            loss = float(metrics["loss"])
            history.append(dict(step=step, loss=loss,
                                dt=time.time() - t0))
        if tc.ckpt_dir and (step + 1) % tc.ckpt_every == 0:
            if pending_save is not None:
                pending_save.join()
            pending_save = save_checkpoint(
                tc.ckpt_dir, step + 1, dict(p=params, o=opt_state),
                async_save=True)
    if pending_save is not None:
        pending_save.join()
    return params, opt_state, history
