"""PyTorch/CUDA port of the HDP serving system for NVIDIA Hopper (H100).

The JAX package ``repro`` stays the reference; this package mirrors its
module layout (``core``, ``configs``, ``models``, ``kernels``,
``serving``, ``training``, ``data``) and imports neither ``jax`` nor
anything of ``repro``. Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU, where every hand-written kernel is replaced by its plain
PyTorch version.
"""
