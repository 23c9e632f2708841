"""Parameter interop with the JAX package.

The JAX package's params arrive as a nested dict of numpy arrays (callers
obtain it with ``jax.device_get``); this module never touches JAX itself.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .device import DeviceLike, resolve_device


def params_from_numpy(tree: Any, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dict of numpy arrays -> the same tree of torch tensors.

    bf16 arrays (numpy has no native bf16; JAX hands over ml_dtypes bf16)
    go through float32, which is exact.  ``dtype`` casts every leaf; by
    default a leaf keeps its own type (bf16 stays bf16)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev, dtype) for k, v in tree.items()}
    arr = np.asarray(tree)
    is_bf16 = arr.dtype.name == "bfloat16"
    t = torch.tensor(arr.astype(np.float32) if is_bf16 else arr)
    target = dtype or (torch.bfloat16 if is_bf16 else t.dtype)
    return t.to(device=dev, dtype=target)
