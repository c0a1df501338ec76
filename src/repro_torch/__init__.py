"""PyTorch / CUDA port of the ``repro`` package for NVIDIA Hopper (H100).

Same subpackage names as ``repro``.  The storage stack (``configs``,
``core``, ``cache``, ``runtime``, ``obs``, ``workload``, ``serving.engine``)
is kept as byte-identical copies; the model zoo, the device side of serving
and the attention kernels are ported.  Nothing here imports ``jax`` or
``repro``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
