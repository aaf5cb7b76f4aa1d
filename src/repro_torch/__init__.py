"""pathsig on PyTorch and CUDA: the port of the JAX package ``repro``.

The module tree mirrors ``repro`` so every module names its reference.
Entry points take ``device=None``, which means the CUDA card; the CPU is
used only when the caller passes ``device="cpu"`` (see
:func:`repro_torch.device.resolve_device`).  Hand-written Hopper kernels
live under ``repro_torch/kernels/csrc`` and are built at first use.
"""
