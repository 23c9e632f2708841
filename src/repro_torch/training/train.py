"""Training loop: the train step, gradient accumulation, metrics.

The port of the JAX package's ``training/train.py``.  The loss and its
gradients come from ``torch.autograd.grad`` over the parameter leaves:
a step differentiates detached views of the caller's leaves, so the
params tree never holds ``requires_grad`` (the serving kernels refuse
tensors that do), and ``AdamW.update`` then writes the new values into
those leaves in place.  ``train`` is the single-process training loop of the
tests and of ``launch/train.py``; its batches are numpy
(``Syntheticcorpus``) and go to the params' device each step.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..models.model import Model
from .data import DataConfig, Syntheticcorpus, extra_inputs
from .optimizer import AdamW, AdamWState, cosine_schedule, global_norm
from .tree import tree_leaves, tree_unflatten


def to_device(batch: Dict[str, Any], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) on ``device``: integer arrays
    (tokens, labels) as int64, the rest as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


def loss_and_grads(model: Model, params: Any,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``model.loss_fn`` at ``params`` and its gradient leaves, in
    :func:`tree_leaves` order."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = model.loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), list(grads)


def make_train_step(model: Model, opt: AdamW) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics); the
    params and moments are updated in place."""

    def train_step(params, opt_state: AdamWState, batch):
        loss, grads = loss_and_grads(model, params, batch)
        gnorm = global_norm(grads)
        params, new_state = opt.update(grads, opt_state, params, gnorm)
        metrics = {
            "loss": loss,
            "grad_norm": gnorm,
            "lr": opt.learning_rate(new_state.step),
        }
        return params, new_state, metrics

    return train_step


def make_grad_accum_step(model: Model, opt: AdamW, n_micro: int) -> Callable:
    """Micro-batched step: batch leading dim = n_micro * micro_batch; the
    gradients are summed in float32 over the micro-batches, then
    averaged."""

    def step(params, opt_state, batch):
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in tree_leaves(params)]
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=acc[0].device)
        for i in range(n_micro):
            micro = {k: v[i * (v.shape[0] // n_micro):
                          (i + 1) * (v.shape[0] // n_micro)]
                     for k, v in batch.items()}
            loss, grads = loss_and_grads(model, params, micro)
            acc = [a + g for a, g in zip(acc, grads)]
            loss_acc = loss_acc + loss
        grads = [g / n_micro for g in acc]
        gnorm = global_norm(grads)
        params, new_state = opt.update(grads, opt_state, params, gnorm)
        return params, new_state, {"loss": loss_acc / n_micro,
                                   "grad_norm": gnorm,
                                   "lr": opt.learning_rate(new_state.step)}

    return step


@dataclass
class TrainResult:
    losses: List[float] = field(default_factory=list)
    steps: int = 0
    wall_seconds: float = 0.0

    @property
    def first_loss(self) -> float:
        return self.losses[0] if self.losses else float("nan")

    @property
    def last_loss(self) -> float:
        return self.losses[-1] if self.losses else float("nan")


def train(model: Model, *, steps: int, batch_size: int, seq_len: int,
          peak_lr: float = 3e-4, warmup: int = 20, seed: int = 0,
          log_every: int = 10,
          log_fn: Optional[Callable[[int, Dict], None]] = None,
          device: DeviceLike = None) -> Tuple[dict, TrainResult]:
    """Single-process training loop.  The weights are drawn from a
    ``torch.Generator`` seeded with ``seed`` (so they differ from the
    reference's ``jax.random`` draw); the data is the reference's."""
    dev = resolve_device(device)
    cfg = model.cfg
    opt = AdamW(learning_rate=cosine_schedule(peak_lr, warmup, steps))
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    opt_state = opt.init(params)
    corpus = Syntheticcorpus(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=batch_size,
        seed=seed))
    step_fn = make_train_step(model, opt)
    extras = extra_inputs(cfg, batch_size, seed)
    result = TrainResult()
    t0 = time.perf_counter()
    for step in range(steps):
        batch = dict(corpus.batch(step))
        batch.update(extras)
        params, opt_state, metrics = step_fn(params, opt_state,
                                             to_device(batch, dev))
        loss = float(metrics["loss"])
        result.losses.append(loss)
        if log_fn is not None and step % log_every == 0:
            log_fn(step, {k: float(v) for k, v in metrics.items()})
    result.steps = steps
    result.wall_seconds = time.perf_counter() - t0
    return params, result
