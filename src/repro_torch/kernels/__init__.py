"""Hand-written Hopper kernels of the port, each beside its plain version.

``<name>/ops.py`` is the wrapper: a CUDA tensor launches the kernel (or the
call raises), a CPU tensor takes the plain PyTorch version in
``<name>/ref.py``.  The CUDA sources live in ``repro_torch/csrc/``.

No kernel has a backward (nor does any Pallas kernel of the JAX package),
and a launch writes into a fresh tensor with no ``grad_fn``: under
autograd it would cut the gradient without a word.  So every wrapper
calls :func:`refuse_autograd` on every device, the CPU's plain versions
included, and training runs the plain PyTorch paths instead.
"""

import torch


def refuse_autograd(name: str, *tensors) -> None:
    """Raise if autograd is on and any of ``tensors`` (None skipped)
    requires grad: the kernel ``name`` has no backward."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is a forward-only kernel: it has no backward, so it "
            f"takes no tensor that requires grad while autograd is on "
            f"(run it under torch.no_grad(), or train through the plain "
            f"PyTorch path)")
