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

Parameters may be DTensors (`repro_torch.dist.sharding.shard_params`),
the counterpart of the reference's sharded global arrays under jit.
The step then runs inside `dtensor_scope`, and three sites redistribute
explicitly: `_shard_batch` distributes a plain batch over the data axes
(`batch_spec`), `_microbatch` keeps each slice of it so sharded (a
slice of a dim-0-sharded DTensor would otherwise come back replicated,
every data rank computing the same rows), and `_value_and_grad` brings
each gradient to its parameter's placements (FSDP's reduce-scatter) and
the loss to one replicated value.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..dist.sharding import (batch_spec, distribute_like, dtensor_scope,
                             is_dtensor, to_placements)
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
    """(loss, [grad per leaf in `_leaves` order]); with DTensor
    parameters each gradient is laid out as its parameter and the loss
    is a plain replicated scalar."""
    tree = _map_shapes(params,
                       lambda leaf: leaf.detach().requires_grad_(True))
    value = loss(tree, batch, cfg)
    leaves = [leaf for _, leaf in _leaves(tree)]
    grads = list(torch.autograd.grad(value, leaves))
    if is_dtensor(value):
        grads = [distribute_like(g, p) for g, p in zip(grads, leaves)]
        value = value.full_tensor()
    return value.detach(), grads


def _shard_batch(batch, params):
    """A batch of plain tensors (the same on every rank) distributed over
    the data axes of the DTensor parameters' mesh; as it is otherwise."""
    first = next(leaf for _, leaf in _leaves(params))
    if not is_dtensor(first):
        return batch
    from torch.distributed.tensor import distribute_tensor
    mesh = first.device_mesh
    bsp = batch_spec(mesh)
    return {k: v if is_dtensor(v) else distribute_tensor(
                v, mesh, to_placements(bsp, mesh, v.dim()))
            for k, v in batch.items()}


def _microbatch(v, i: int, n: int):
    """Rows [i B/n, (i+1) B/n) of batch tensor `v`, as the reference's
    dynamic slice; a DTensor slice keeps `v`'s placements."""
    rows = v.shape[0] // n
    mb = v[i * rows:(i + 1) * rows]
    if is_dtensor(v):
        mb = distribute_like(mb, v)
    return mb


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    tc: TrainConfig) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), the
    parameters and moments updated in place; metrics dict(loss,
    grad_norm, lr) of float32 device scalars."""
    base_loss = _remat_loss(tc.remat)

    def step(params, opt_state, batch):
        with dtensor_scope(params):
            return _step(params, opt_state, _shard_batch(batch, params))

    def _step(params, opt_state, batch):
        if tc.microbatches > 1:
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            grads = [torch.zeros_like(leaf, dtype=torch.float32)
                     for _, leaf in _leaves(params)]
            for i in range(tc.microbatches):
                mb = {k: _microbatch(v, i, tc.microbatches)
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
