"""PyTorch + CUDA port of ``octfusion_tpu`` (the JAX reference package).

The tree mirrors the JAX package module for module (``octree/``, ``ops/``,
``nn/``, ``diffusion/``, ``models/``, ``utils/``) and keeps its padded
static-capacity layout, so every intermediate array compares element by
element with the reference.  The package imports ``torch`` and never
``jax``; its hand-written kernels (the fused graph convolution's forward
and its two backward kernels, ``csrc/graph_conv.cu``) are built with
``nvcc`` at first use on a GPU.
"""
