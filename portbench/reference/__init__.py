"""The benchmark's plain reference: a frozen copy of the plain paths of
``octfusion_tpu_torch`` (octree and dual-graph building, the split codecs,
the U-Nets, the graph VAE, the samplers, the MPU SDF grid, the solvers'
cascades, losses and train step), kept here so that a later change to the
program cannot change the yardstick.

It imports only ``torch`` and ``numpy`` and nothing of the program.  Its
graph convolution is a gather, an ``index_add`` and a GEMM on every device
(``ops/graph_ops.graph_conv``); there is no hand-written kernel and no
packed path.  ``judge`` holds the comparisons that decide a run's
``correct``.
"""
