"""Hand-written Hopper kernels of the port, each beside its plain version.

``<name>/ops.py`` is the wrapper: a CUDA tensor launches the kernel (or the
call raises), a CPU tensor takes the plain PyTorch version in
``<name>/ref.py``.  The CUDA sources live in ``repro_torch/csrc/``.
"""
