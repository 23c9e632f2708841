"""AdamW and learning-rate schedules over nested dicts of tensors.

The port of the JAX package's ``training/optimizer.py``, with its
arithmetic: b2 = 0.95, the gradients scaled by ``min(1, clip / (gnorm +
1e-9))``, the moments in float32, the bias corrections from the step as
float32, decay on matrices only (``ndim >= 2``), the update computed in
float32 and cast back to the parameter's type.

``AdamW.update`` works in place, as PyTorch's optimizers do: it writes the
new parameters into the given leaves and the new moments into the state's,
under ``torch.no_grad()``, and returns them, ``(params, state)``, as the
reference returns its new trees.  At full width a functional update would
hold a second copy of the parameters and both moments for the length of
the step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from .tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor        # int32 scalar, the updates made so far
    mu: Any
    nu: Any


@dataclass(frozen=True)
class AdamW:
    learning_rate: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0

    def init(self, params: Any) -> AdamWState:
        """Zero float32 moments beside each leaf, and step 0 on the device
        of the first leaf."""
        zeros = lambda p: tree_map(
            lambda x: torch.zeros_like(x, dtype=torch.float32), p)
        dev = tree_leaves(params)[0].device
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          mu=zeros(params), nu=zeros(params))

    @torch.no_grad()
    def update(self, grads: Any, state: AdamWState, params: Any,
               gnorm: Optional[torch.Tensor] = None
               ) -> Tuple[Any, AdamWState]:
        """One AdamW step, in place (see the module's docstring).
        ``grads`` is a tree like ``params`` or its list of leaves;
        ``gnorm``, their :func:`global_norm` where the caller has it."""
        step = state.step + 1
        g_leaves = grads if isinstance(grads, list) else tree_leaves(grads)
        scale = None
        if self.grad_clip is not None:
            if gnorm is None:
                gnorm = global_norm(g_leaves)
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        b1, b2 = self.b1, self.b2
        lr = self.learning_rate(step)
        c1 = 1 - b1 ** step.float()
        c2 = 1 - b2 ** step.float()
        for p, m, v, g in zip(tree_leaves(params), tree_leaves(state.mu),
                              tree_leaves(state.nu), g_leaves):
            g = g.float()      # JAX promotes a bf16 g * f32 scale to f32
            if scale is not None:
                g = g * scale
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
            delta = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if p.dim() >= 2:   # decay matrices only (norms/biases exempt)
                delta = delta + self.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, the leaves
    summed one after the other in tree order as the reference sums them."""
    leaves = tree if isinstance(tree, list) else tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


def cosine_schedule(peak_lr: float, warmup_steps: int,
                    total_steps: int, min_ratio: float = 0.1):
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = peak_lr * s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup_steps, warm, cos)

    return lr


def constant_schedule(lr_value: float):
    return lambda step: torch.tensor(lr_value, dtype=torch.float32,
                                     device=step.device)
