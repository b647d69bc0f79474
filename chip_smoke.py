"""Smoke run of the PyTorch port (``octfusion_tpu_torch``) on one NVIDIA GPU.

Drives the port's main paths (sampling and the training of every stage
at the full width of the reference-parity model with seeded random
weights, the evaluation metrics from meshes at the reference's
2048-point protocol, the DPM-Solver++ generation path with its CLI,
the training CLI on a ShapeNet-format set, and the 3-stage model at the
Objaverse widths, decoded to depth 10; data parallelism on the one
card; shading FID with the stand-in features, dataset preparation from
meshes and the depth-9 generation), and checks the hand-written
CUDA kernels they run (the graph conv's K1 forward, K2 column buffer, K3
input gradient and K5 packed forward; the Chamfer kernel K4):

1. device: the card's name and power limit; TF32 off for matmul and cuDNN;
2. build: ``graph_conv.cu`` and ``chamfer.cu`` are compiled from
   ``octfusion_tpu_torch/csrc``, one ``nvcc`` each, both at once;
3. K1 vs plain: on the graph levels 4-8 of a short warm-up cascade, at
   every (C, C') pair the cascade's graph convs use, the kernel against its
   plain PyTorch version on the same tensors (rtol = atol = 1e-4), timed
   with CUDA events beside the GEMM alone on the materialised column
   buffer (``gemm_ms``: ``col @ W``, a yardstick the port never calls) and
   its bound (``ops/roofline.py``: at the TF32 tensor-core rate, and at
   the fp32 rate beside it), then the sums over the shapes;
4. one full-width hr denoise step on the card (kernel) against the CPU
   (plain path), same weights and inputs (rtol = atol = 1e-3);
5. the generation cascade (``UnionSolver.sample``: lr sampling, grow, hr
   sampling, growing VAE decode, 256³ SDF grid; depth 8, caps from
   finest_cap 131072, 200 + 200 ancestral steps, fp32, batch 1), with K1's
   launch count checked against the number of GraphConv calls, stage
   seconds, node counts, overflow flags and peak memory; the decoded SDF
   grid must be finite, and a mesh is extracted from the analytic
   lumpy-sphere planes over the grown octree (random weights decode noise,
   so iso-surfacing the decoded field would measure a pathological
   surface);
6. K1, K2 and K3 vs plain at the training shapes: at every (level, C, C')
   the hr train step's graph convs use on the batch-4 training graph (K1:
   the frozen encoder's levels 6-8 and the hr U-Net's levels 4-6; K2 and
   K3: the differentiable convs of levels 4-6), each kernel against its
   plain version on the same tensors (rtol = atol = 1e-4), timed with CUDA
   events, K1 and K3 beside the GEMM alone (K3: ``dout @ W^T``, as in its
   plain version), then the sums; the training graph's line gives each
   level's largest CSR and transposed-CSR slot;
7. one full-width hr train step (``UnionSolver.loss_fn`` and its backward)
   on the card against the CPU, batch 1, all weights perturbed with seeded
   noise (the zero-initialised convs would otherwise give trivially zero
   gradient blocks), the same injected encoder eps, times and noise: the
   loss and every trainable gradient (rtol = atol = 1e-3, and each leaf's
   largest error within 1e-4 of its own largest |gradient|, which is
   printed), and every hr U-Net parameter must get a gradient that is not
   all zero;
8. training (``UnionSolver.make_train_step``; the hr stage of
   ``configs/octfusion_snet_uncond.yaml``: batch 4, 65536 points per shape
   from seeded lumpy spheres with exact normals): ``TRAIN_STEPS`` (12)
   steps on one fixed batch with fixed times and noise.  The graph must
   not overflow, the loss must be finite and fall, the frozen lr U-Net
   must stay bit for bit, K1 launches must equal the GraphConv forward calls (encoder and
   checkpoint recomputes included) and K2 launches = K3 launches = the
   backward calls of the graph conv; it prints the median ms/step after 2
   warm-up steps, the stage split and the peak memory;
9. K4 vs plain (run first, right after the build: its device times come
   from ``torch.profiler`` traces, which a fresh process takes reliably):
   the 2048-point evaluation protocol at B = 16, 32 (the evaluation's
   launch, phase 10's tiles), 64 and 256 pairs, the ragged B = 2, N = 700,
   M = 1100, near-duplicate clouds (a and a + 1e-3 noise) and a NaN
   coordinate in a[0, 2] and b[1, 5], and infinite and 1e20 coordinates
   in a and b (NaN or +inf by the signs, as the plain version), all in
   the unit cube: the kernel against its plain version (rtol 1e-4, atol
   1e-6, NaN and +inf exactly where the plain version has them, no -0.0
   elsewhere), with kernel ms (CUDA events)
   and device ms (profiler), plain / library (``torch.cdist`` squared and
   both minima, a yardstick the port never calls) ms, the bound
   (``roofline.bound_times``) and its share, and the fp32 bound of
   ``roofline.chamfer_cost`` (the direct form's 8 FLOP per pair) and its
   share; then CD (K4), EMD fp32 and EMD bf16-stored
   pairs/s at the four evaluation B, and bf16 vs fp32 EMD at B = 16 (rtol
   2.5e-3);
10. evaluation (``python -m octfusion_tpu_torch.evaluate``): 32 sample and
   32 reference ``.obj`` meshes, marching tetrahedra over seeded
   lumpy-sphere fields on a 64³ grid from two seeds, to 1-NNA / COV / MMD
   over CD and EMD at 2048 points and batch 8 on the card.  Every metric
   must be finite, COV and 1-NNA in [0, 1], K4 launches = the tiles of the
   three matrices, and the first 8 x 8 block of the CD and EMD matrices
   equal to the CPU plain path's on the same clouds (CD rtol 1e-4, atol
   1e-6; EMD rtol 1e-3).  Prints the metrics, pairs/s and peak memory;
11. K5 vs plain and vs K1 (run right after phase 3, on its warm-up graph):
   at every (level, C, C') of levels 4-6 that phase 3 saw (the hr U-Net's
   convs and the decoder's depth-6 convs, which K5 runs when the sampling
   graph is packed) and the ragged 515 -> 512 and 131 -> 128, K5 (K1's
   template over the flat 7C axis) against its plain version (rtol = atol
   = 1e-4), timed with K1 on the same tensors (CUDA events, median of 20)
   beside its bound at the TF32 tensor-core rate; then K5 under autograd
   must raise, launching nothing;
12. the DPM-Solver++(2M) cascade at full width (``Config()`` with
   ``sampler="dpmpp"``, 25 + 25 steps, batch 1, 256³ SDF grid), seeded
   weights perturbed with seeded noise (the zero-initialised hr output
   conv would otherwise make the hr stage ignore its convs) and the same
   injected initial noise, once with ``kpack=True`` (K5 on the packed
   depth <= 6 graph) and once with ``kpack=False`` (K1): the same octree
   and graph, codes within 1e-3 of their own max |code|, finite codes and
   grid, K5 launches = the GraphConv calls on packed levels and K1
   launches = the rest; prints each run's stage seconds and peak memory;
13. the CLI, ``python -m octfusion_tpu_torch.generate`` as a subprocess
   with ``OCTFUSION_CONV_KPACK=1``: 4 shapes at full width with ``--sampler
   dpmpp --sample_steps 25`` from the phase-12 weights, which the phase
   first writes with ``utils/ckpt.save`` (reference checkpoint layout, and
   the VAE's ``autoencoder`` entry), into a temp dir, with a temp config
   whose one change is ``solver.resolution: 64`` (random weights decode
   noise, whose 256³ mesh is ~10^8 faces of text; the CLI sets fp32 with
   TF32 off itself): 4 non-empty ``.obj``
   files, 4 ``[*] wrote`` lines and K5 launches in its summary line; a
   second run must skip all 4;
14. lr training (the lr stage of ``configs/octfusion_snet_uncond.yaml``:
   lr U-Net 64 ch, mult (1, 2, 4); the split grid built from 65536-point
   lumpy spheres at the caps from finest_cap 131072): one step card vs
   CPU at batch 1 with ``lr_pos_weight`` 1.75, all weights perturbed with
   seeded noise and the same injected times and noise (the loss and every
   gradient at phase 7's tolerances), then ``LR_TRAIN_STEPS`` (12) steps
   at batch 4 on one fixed batch with fixed times and noise: no
   overflow, a finite, falling loss, the median ms/step after 2 warm-up
   steps with its stage split, and the peak memory;
15. K1, K2 and K3 vs plain at the VAE's training shapes: every (level, C,
   C') of the VAE step's graph convs on the batch-2 training graph
   (levels 6-8 of the encoder and the decoder; C = 11, 31, 37, 38 with
   the node-type one-hot, none a multiple of 4), as phase 6 does; the
   graph's line gives each level's largest CSR and transposed-CSR slot;
16. one full-width VAE train step (``VAESolver.loss_fn`` and its
   backward) on the card against the CPU at batch 1, all weights
   perturbed with seeded noise, the same injected eps: the loss, every
   term of the loss dict and every gradient at phase 7's tolerances, and
   every VAE parameter must get a gradient that is not all zero.  Both
   sides run under ``torch.use_deterministic_algorithms``: at the VAE's
   gradients of ~1e3 the atomic and parallel accumulations moved an
   element by about the elementwise atol from run to run;
17. VAE training (``VAESolver.make_train_step`` with the YAML's
   ``model``, ``capacity`` and ``loss``: depth 8, stop 6, out 8,
   checkpointed res blocks, edge_factor 10, ``sdf_reg_loss``, kl 0.1):
   ``VAE_TRAIN_STEPS`` (8) steps at batch 2 (65536 surface points and
   ``data.point_sample_num`` SDF samples per shape) on one fixed batch
   with a fixed eps.  No overflow, a finite, falling loss, K1 launches =
   GraphConv forward calls (checkpoint recomputes included) and K2 = K3
   launches = graph-conv backward calls; prints the median ms/step after
   2 warm-up steps split into graph / forward / backward / optimizer, and
   the peak memory;
18. VAE reconstruction (``VAESolver.reconstruct``) of phase 17's 2 shapes
   from its trained weights: the SDF grid at the YAML's 256³ must be
   finite and K1 launches = GraphConv calls; then meshes at 64³ into a
   temp dir (barely trained weights decode noise, as phase 13 says of
   random ones); prints each stage's seconds;
19. the training CLI, ``python -m octfusion_tpu_torch.train`` as
   subprocesses on a ShapeNet-format set it writes (8 seeded lumpy
   spheres, 100000 surface points with normals and 100000 SDF samples
   with gradients each, points scaled by ``data.point_scale`` as the
   reference's files are) with ``configs/octfusion_snet_uncond.yaml``
   changed only in ``data.location`` / ``data.filelist``,
   ``train.print_freq`` 1, ``save_latest_freq`` 2, ``display_freq`` 3 and
   ``solver.resolution`` 64 (noise meshes, as phase 13): the VAE at batch
   2 for 3 steps, then resumed to 5; lr at batch 4 for 4 steps; hr at
   batch 4 for 3 steps with the VAE run as ``--vq_ckpt`` and the lr run
   as ``--pretrain_ckpt``; generate mode of the hr run (dpmpp-25, one
   shape) and of the VAE (one reconstruction); then
   ``python -m octfusion_tpu_torch.tools.vae_recon_eval`` on the VAE run
   (2 held-out synthetic shapes, their Chamfer distances through K4).
   ``python -m octfusion_tpu_torch.tools.loader_bench`` measures the
   loader's own pace.  Each run must exit 0 with finite losses, K1 launches = GraphConv calls and K2 = K3 launches
   = graph-conv backward calls, no display-eval failure (the display
   meshes and the generated ones must have faces), the resume at step 3,
   the hr run's frozen ``unet_lr`` bit for bit the lr run's and its EMA
   other than its live weights; an overflow stops a run.  Prints each
   run's summary line and wall, ms/step and ``data_s`` per stage, and
   the phase's seconds;
20. the 3-stage solver (``Union3TSolver``) at the obja-3t-d10
   configuration: ``configs/octfusion_obja_uncond.yaml``'s diffusion
   (lr 64 ch, hr 128 ch on split_large, feature 64 ch; input depths 4 / 6
   / 8; x0; batch 2) over ``configs/vae_obja_depth1084.yaml``'s depth-10
   VAE and caps (finest_cap 1048576; ``config_3t``), seeded
   weights perturbed with seeded noise, lumpy spheres at
   ``SHAPE_SCALE_3T`` (0.8) of their size (at full size
   they overflow the depth-6 cap).  (a) K1 vs plain at every
   (level, C, C') of a 2-step warm-up cascade (levels 4-10: the hr and
   feature U-Nets and the decoder to depth 10) and of the batch-2
   training graph (the frozen encoder at levels 8-10, the U-Nets), K5 at
   the sampling shapes of levels 4-8, K2 and K3 at the train steps' (the
   frozen hr U-Net's included), as phases 3, 6 and 11 do; the graphs'
   lines hold each level's CSR to its int32 offsets.  (b) The 3-hop
   cascade at batch 1 from the split grid of a seeded lumpy sphere (random
   lr weights fill half the grid, which overflows the depth-5/6 caps):
   ``--steps`` (200) ancestral steps per stage, decode to depth 10, 256³
   SDF grid; K1 launches = GraphConv calls, stage seconds (lr, grow6, hr,
   grow8, feature, decode, sdf), node counts d4-d10, the overflow flags of
   both grown graphs and the decoded one (an overflow truncates, as in the
   JAX package), peak memory; finite codes and SDF.  Then dpmpp-25 with
   ``kpack``: K5 launches = the GraphConv calls on packed levels (both
   grown graphs), K1 launches = the rest.  (c) One hr (split_large) and
   one feature train step at batch 2, card vs CPU from the same weights
   and draws, both under ``torch.use_deterministic_algorithms``, at phase
   7's tolerances; then ``TRAIN_STEPS_3T`` (4) steps of each on the card
   (as phase 8: finite, falling loss, launches = calls), the frozen
   U-Nets (``unet_lr``; and ``unet_hr`` in the feature stage) bit for
   bit.  (d) ``python -m octfusion_tpu_torch.train --model union_3t`` on a
   ShapeNet-format set: lr, hr grafted from it, feature grafted from the
   hr run with a seeded depth-10 VAE checkpoint as ``--vq_ckpt``, then
   generate (dpmpp-25, one shape at 64³): each exits 0, the feature
   checkpoint holds ``df_unet_feature`` with an EMA other than it and the
   hr run's ``unet_lr`` / ``unet_hr``, the mesh has faces;
21. the colour VAE at full width (``configs/vae_snet_color.yaml``'s
   model, capacity and loss: ``channel_in`` 7, colour heads, 200 x colour
   MSE per depth): batch 2 of seeded lumpy spheres, 65536 points and
   50000 SDF samples each, per-point colours a smooth function of
   position (``utils/shapes.position_colors``).  K1 / K2 / K3 vs plain at
   every (level, C, C') of the step (conv1 reads C = 14: 4 ND + 3 RGB +
   7 node types, not a multiple of 4, K2's ``<false>`` path); one step
   card vs CPU at batch 1 under deterministic algorithms at phase 7's
   tolerances; ``COLOR_TRAIN_STEPS`` (10) steps (finite, falling loss
   and every ``color_loss_{d}``, launches = calls); ``reconstruct`` of
   the 2 shapes (256³, finite colours); the train CLI for 2 steps on a
   ShapeNet-format set with ``color.npz``;
22. data parallelism on the one card: (a) two ranks spawned
   (``parallel/launch.spawn``, gloo, both on cuda:0, under deterministic
   algorithms) run the hr DP step at the snet width (global batch 4, 2
   per rank, perturbed weights, fixed per-rank draws); rank 0 replays it
   in one process (each shard's loss and backward, the gradients
   averaged, one optimizer and EMA step) and holds parameters, EMA and
   loss to phase 7's tolerances; both ranks' parameters and EMA are
   identical (bit digests); (b) the same for the VAE step on the query
   axis (data 1 x model 2); each prints the DP step's ms (both ranks on
   one card) beside one shard's single-process forward + backward, the
   gradient all-reduce's bytes and ms and rank 0's idle share; (c)
   ``torch.distributed.run --nproc_per_node 1 -m
   octfusion_tpu_torch.train`` (NCCL, world 1): 3 hr steps on a
   ShapeNet-format set, the checkpoint restored into a plain run; (d)
   ``--mode generate`` of 4 shapes (dpmpp-25 at 64³, K5) on 2 ranks
   sharing the card (gloo, chosen because the host has fewer cards than
   ranks) against the same CLI in this process: the same files, bit for bit
   (or, if not, the same faces with vertices within K1's atol, said so);
   (e) ``pairwise_cd_emd`` with ``shard_devices=["cuda:0", "cuda:0"]``
   equal to the unsharded matrices bit for bit.  Every spawned process
   has a timeout and a failing rank fails the phase;
23. shading FID: ``python -m octfusion_tpu_torch.evaluate --fid_standin
   --skip_pairwise`` (the triangle rasteriser in float64 and the stand-in
   features on the card) over 16 + 16 meshes made as phase 10 makes its
   32 + 32, at 299², 20 views, twice: a finite, positive
   ``shading_fid_standin``, and the second run, which reads each set's
   ``.fid_cache`` (32 feature files),
   gives the same value.  Then on 2 meshes x 20 views the card's images
   against the port's CPU path (>= 99.9% of the pixels within 1e-6, the
   pixels beyond counted) and the stand-in features of the same images
   (rtol 1e-4, atol 1e-5); prints render and feature s/mesh, the FID
   wall of both runs and the peak memory;
24. dataset preparation: 4 lumpy spheres marched on the card at 128³
   (their face counts printed), then ``python -m
   octfusion_tpu_torch.tools.prepare_dataset`` on the card at its
   defaults (100000 surface samples and 100000 queries a mesh): per mesh
   the seconds of the nearest-sample search, the winding numbers and in
   all, and finite shards of the right shapes.  On the first mesh at 4096
   queries, the card against the CPU: distances within 1e-6, another
   nearest index only at a tie (squared distances within 1e-12), winding
   numbers within 1e-4, the same sign and SDF (1e-6) wherever |w - 1/2|
   > 1e-3.  Then ``PREP_VAE_STEPS`` (3) VAE steps of the train CLI on the
   prepared set, as phase 19 trains (finite losses, launches = calls;
   an overflow stops the run), with ``data.point_scale`` 1.0: the shards
   span [-0.4, 0.4]³ as phase 19's shapes do (read at the reference's
   0.5, a sphere of that size overflows the snet caps at depth 7);
25. depth 9: first a 2-step warm-up of ``configs/synthetic_depth9.yaml``
   in process notes every (level, C, C') it convolves; K1 vs plain on
   the warm-up's decoded graph at each (levels 4-9, the 64-channel hr
   U-Net and the VAE decode up to the 131072 cap) and K5 vs plain on its
   sampling graph at levels 4-6, as phases 3 and 11 check.  Then the
   config through ``python -m octfusion_tpu_torch.generate`` (dpmpp-25, 2 shapes, K5 on the grown
   graph) from seeded perturbed weights saved as phase 13 saves them, at
   ``solver.resolution`` 64 (noise meshes, as phase 13): exit 0, per shape
   the node counts d4-d9, the per-depth and graph overflow flags (random
   weights overflow the grown depths, and a flag must come with the
   CLI's warning: no shape is truncated silently), a finite SDF and a
   mesh with faces; prints s/shape, the faces and the peak memory;
26. the bf16 compute mode (``diffusion.compute_dtype: bfloat16``, the
   JAX package's mixed precision: the hr U-Net's finest encoder levels
   run bf16 graph convs, the rest fp32): the bf16 K1 and K5 against their
   plain versions (the Pallas kernels' bf16 arithmetic; rtol 2^-7, atol
   2^-7 of the reference's largest magnitude, K3's 2^-6) at every bf16
   (level, C, C') of a 2-step warm-up cascade's depth-8 sampling graph,
   timed beside the bf16 GEMM alone (and K5 beside bf16 K1) and the
   bound at the bf16 tensor-core rate and 2-byte operands; one full-width
   bf16 hr denoise step card vs CPU within twice the CPU's own
   bf16-vs-fp32 gap and at least a quarter of it from the CPU's fp32
   result; the 200 + 200 ancestral cascade and dpmpp-25 with
   K5 in bf16 (bf16 K1 + K5 launches = the bf16 GraphConv calls; finite
   codes and SDF, overflow flags, stage seconds, peak memory, beside
   phases 5 and 12); the bf16 K2 and K3 against their plain versions at
   the bf16 shapes of the batch-4 training graph; ``BF16_TRAIN_STEPS``
   (12) hr train steps at batch 4 in bf16 (finite, falling loss; bf16 K1
   launches = the bf16 GraphConv calls, bf16 K2 = K3 = the bf16 backward
   calls).

Prints the kernel summary as a JSON line (each kernel's ``launches`` is
its count over the counted runs of phases 5, 8, 12, 17, 18, 19, 20, 21,
22, 24 and 25, K4's over phases 10, 19 and 22, the four bf16 entry
points' (``*_bf16``) over phase 26's cascades and training run; their
``ms`` and the rest sum phase 26's shapes; ``ms``, ``plain_ms``,
``bound_ms`` and ``library_ms`` sum the shapes of phases 3, 6, 15, 20,
21 and 25 (K1), 6, 15, 20 and 21 (K2, K3), 9 (K4), or 11, 20 and 25
(K5), K1's and K3's ``gemm_ms`` the GEMM-alone yardstick over the same
shapes, and K5's ``k1_ms`` is K1 on phases 11's, 20's and 25's shapes;
``bound_by`` is the larger of the summed operation and byte times; every
bound is ``roofline.bound_times``: the operations at
``roofline.FLOPS_RATE``, the rate of the units the kernel runs on, and
K4's minima at ``roofline.MINIMA_RATE``), then the card's name and power
limit, and last
``{"ok": true, "device": {...}}``.  Any failure raises: there is no CPU fallback.  The
run uses one card, the first visible one.  Usage:
``python3 chip_smoke.py [--steps N] [--seed S]``.
"""

import argparse
import concurrent.futures
import copy
import dataclasses
import glob
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np

# One card: expose only the first visible device, so the device count
# reported on the last line is the number of cards the run used.
_visible = os.environ.get("CUDA_VISIBLE_DEVICES")
os.environ["CUDA_VISIBLE_DEVICES"] = ("0" if _visible is None
                                      else _visible.split(",")[0])

import torch  # noqa: E402  (after the device pinning above)

TOL_KERNEL = dict(rtol=1e-4, atol=1e-4)  # fp32, different summation order
TOL_STEP = dict(rtol=1e-3, atol=1e-3)    # fp32 through ~40 layers
TOL_GRAD_SCALE = 1e-4   # card vs CPU gradient error / the leaf's max |grad|
RESOLUTION = 256        # SDF grid side, as the reference
TRAIN_STEPS = 12        # phase 8; at least 10, the first 2 are warm-up
TRAIN_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "configs", "octfusion_snet_uncond.yaml")
# phase 20: the 3-stage model's diffusion, data, solver, train | its
# depth-10 VAE's model, capacity (config_3t)
CONFIG_3T = tuple(os.path.join(os.path.dirname(TRAIN_CONFIG), name) for name
                  in ("octfusion_obja_uncond.yaml", "vae_obja_depth1084.yaml"))
# the lumpy spheres, sized for the default caps, overflow the Objaverse
# caps at depths 6-8 (4096 / 16384 / 65536 a sample); at 0.8 of their size
# they fit every level
SHAPE_SCALE_3T = 0.8
# phases 9 and 10
EVAL_POINTS = 2048      # points per cloud, the reference's protocol
TOL_CHAMFER = dict(rtol=1e-4, atol=1e-6)   # fp32 clouds in the unit cube
TOL_EMD_CARD = dict(rtol=1e-3, atol=0.0)   # card vs CPU: reduction order
TOL_EMD_BF16 = dict(rtol=2.5e-3, atol=0.0)
# phase 9: (case, B, N, M)
CHAMFER_CASES = [("eval", 16, EVAL_POINTS, EVAL_POINTS),
                 ("eval", 32, EVAL_POINTS, EVAL_POINTS),
                 ("eval", 64, EVAL_POINTS, EVAL_POINTS),
                 ("eval", 256, EVAL_POINTS, EVAL_POINTS),
                 ("ragged", 2, 700, 1100),
                 ("near_duplicate", 16, EVAL_POINTS, EVAL_POINTS),
                 ("nan", 4, EVAL_POINTS, EVAL_POINTS),
                 ("non_finite", 4, EVAL_POINTS, EVAL_POINTS)]
# phase 10
EVAL_SHAPES = 32        # sample meshes, and as many reference meshes
EVAL_GRID = 64
EVAL_BATCH = 8
EVAL_ROW_BLOCK = 4      # pairwise_cd_emd's default
EVAL_BLOCK = 8          # card vs CPU block of the matrices
# phases 11-13
RAGGED_PACKED = {(4, 515, 512), (6, 131, 128)}   # (level, C, C')
DPMPP_STEPS = 25        # per stage, as bench.py's dpmpp_25step_s_per_shape
TOL_KPACK_CODE = 1e-3   # K5 vs K1 codes / max |code|
CLI_SHAPES = 4
CLI_RESOLUTION = 64
# phases 14-18
LR_POS_WEIGHT = 1.75    # phase 14's card-vs-CPU step
LR_TRAIN_STEPS = 12     # at least 10, the first 2 are warm-up
VAE_BATCH = 2
VAE_TRAIN_STEPS = 8     # the first 2 are warm-up
VAE_MESH_RESOLUTION = 64
# phase 19
CLI_DATA_SHAPES = 8
CLI_DATA_POINTS = 100000   # surface points and SDF samples per shape file
CLI_TRAIN_RESOLUTION = 64  # SDF grid of the display evals and generate
CLI_TIMEOUT = 600          # seconds per CLI run
CLI_RECON_SHAPES = 2       # held-out shapes of tools/vae_recon_eval
# phase 21
COLOR_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "configs", "vae_snet_color.yaml")
COLOR_TRAIN_STEPS = 10  # the first 2 are warm-up
COLOR_CLI_SHAPES = 4
COLOR_CLI_STEPS = 2
# phase 22
DP_TIMEOUT = 900        # seconds for the two spawned ranks
DP_TIMED_STEPS = 1      # DP steps timed after the checked one
DP_CLI_STEPS = 3
DP_EVAL_SETS = 12       # clouds per set of the sharded evaluation
# phase 23
FID_SHAPES = 16         # meshes a set (phase 10 makes 32), for the time
FID_VIEWS = 20
FID_IMAGE = 299         # the evaluation's default image side
FID_CHECK_MESHES = 2    # card vs CPU
TOL_IMAGE = 1e-6        # the same float64 operations on both
IMAGE_SHARE = 0.999     # of the pixels within TOL_IMAGE
TOL_FEATURES = dict(rtol=1e-4, atol=1e-5)   # fp32 convs, another order
# phase 24
PREP_MESHES = 4
PREP_GRID = 128
PREP_SURFACE = 100_000  # prepare_dataset's defaults
PREP_QUERIES = 100_000
PREP_CHECK_QUERIES = 4096
TOL_PREP_SDF = 1e-6     # float64 distances (the sign from the winding)
NEAR_TIE = 1e-12        # |d2| gap of two nearest samples held a tie
TOL_WINDING = 1e-4      # float32 solid angles, another summation order
WINDING_TIE = 1e-3      # |w - 1/2| within which the sign may flip
PREP_VAE_STEPS = 3
# the prepared shapes fill [-0.8, 0.8]^3 at the reference's point_scale
# 0.5, and a sphere that size overflows the snet caps at depth 7; read at
# 1.0 they span [-0.4, 0.4]^3, as phase 19's lumpy spheres do
PREP_TRAIN_POINT_SCALE = 1.0
# phase 25
DEPTH9_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "configs", "synthetic_depth9.yaml")
DEPTH9_SHAPES = 2
# phase 26
# a bf16 kernel against its plain version: each rounds its fp32 sums to
# bf16, in another order, so an element may sit a bf16 ulp (2^-8) off on
# either side: rtol two ulps, atol two ulps of the reference's largest
# magnitude.  K3 rounds the gathered dout where its plain version (the
# Pallas order) rounds dout W_d^T, C' products apart: atol four ulps of
# the largest magnitude (measured up to 6.85e-3 of it, PR 13)
TOL_KERNEL_BF16 = 2.0**-7
TOL_K3_BF16 = 2.0**-6
GAP_FACTOR = 2.0        # bf16 card vs CPU: within twice the CPU's own
                        # bf16-vs-fp32 gap
GAP_FLOOR = 0.25        # and the card's bf16 result at least a quarter of
                        # that gap from the CPU's fp32 one: the card
                        # computed in bf16 where the CPU did
BF16_TRAIN_STEPS = 12   # the first 2 are warm-up
# phase 20
TRAIN_STEPS_3T = 4      # per stage; the first 2 are warm-up
CLI_3T_SHAPES = 4
CLI_3T_STEPS = 2        # per training run
INT32_MAX = 2**31 - 1   # the CSR's offsets and edge indices are int32
REPO = os.path.dirname(os.path.abspath(__file__))
_CSRC = "octfusion_tpu_torch/csrc"
SOURCES = {"graph_conv_fwd": f"{_CSRC}/graph_conv.cu",
           "graph_conv_col": f"{_CSRC}/graph_conv.cu",
           "graph_conv_bwd_dx": f"{_CSRC}/graph_conv.cu",
           "chamfer": f"{_CSRC}/chamfer.cu",
           "graph_conv_fwd_packed": f"{_CSRC}/graph_conv.cu"}
_PALLAS = "octfusion_tpu/ops/pallas/graph_conv_kernel.py"
REPLACES = {"graph_conv_fwd": f"{_PALLAS}:41",
            "graph_conv_col": f"{_PALLAS}:80",
            "graph_conv_bwd_dx": f"{_PALLAS}:110",
            "chamfer": "octfusion_tpu/ops/pallas/chamfer_kernel.py:30",
            "graph_conv_fwd_packed": f"{_PALLAS}:297"}
# the bf16 entry points (phase 26): the same sources and Pallas kernels,
# which the JAX package runs on bf16 operands under compute_dtype bfloat16
BF16_KERNELS = ("graph_conv_fwd", "graph_conv_col", "graph_conv_bwd_dx",
                "graph_conv_fwd_packed")
for _name in BF16_KERNELS:
    SOURCES[f"{_name}_bf16"] = SOURCES[_name]
    REPLACES[f"{_name}_bf16"] = REPLACES[_name]


@dataclasses.dataclass
class KernelStats:
    """One kernel over the shapes a phase checks it at: the largest error,
    and the summed median times of the kernel, its plain version, the
    library yardstick and the GEMM-alone yardstick, and of its bound (with
    the operation and byte times behind it) at the rate of the units it
    runs on and, for continuity, at the fp32 rate."""
    max_abs_err: float = 0.0
    ms: float = 0.0
    plain_ms: float = 0.0
    bound_ms: float = 0.0
    ops_ms: float = 0.0
    bytes_ms: float = 0.0
    bound_fp32_ms: float = 0.0
    library_ms: Optional[float] = None
    gemm_ms: Optional[float] = None
    k1_ms: Optional[float] = None

    def add(self, err, ms, plain_ms, name, cost, library_ms=None,
            gemm_ms=None, k1_ms=None) -> float:
        """Adds one shape of the kernel behind entry point ``name``, ``cost``
        = (flops, bytes), bounded by ``roofline.bound_times``; returns its
        bound."""
        from octfusion_tpu_torch.ops import roofline

        ops, nbytes = roofline.bound_times(name, *cost)
        bound = max(ops, nbytes)
        self.max_abs_err = max(self.max_abs_err, err)
        self.ms += ms
        self.plain_ms += plain_ms
        self.bound_ms += bound
        self.ops_ms += ops
        self.bytes_ms += nbytes
        self.bound_fp32_ms += max(roofline.times_ms(*cost))
        for f, v in (("library_ms", library_ms), ("gemm_ms", gemm_ms),
                     ("k1_ms", k1_ms)):
            if v is not None:
                setattr(self, f, (getattr(self, f) or 0.0) + v)
        return bound

    def merge(self, other: "KernelStats") -> None:
        self.max_abs_err = max(self.max_abs_err, other.max_abs_err)
        for f in ("ms", "plain_ms", "bound_ms", "ops_ms", "bytes_ms",
                  "bound_fp32_ms"):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        for f in ("library_ms", "gemm_ms", "k1_ms"):
            if getattr(other, f) is not None:
                setattr(self, f, (getattr(self, f) or 0.0) + getattr(other, f))

    def summary(self, label: str) -> None:
        """Prints the sums over the phase's shapes and the shares of the
        bound at both rates."""
        extra = "".join(f" {f}={getattr(self, f):.4f}"
                        for f in ("gemm_ms", "library_ms", "k1_ms")
                        if getattr(self, f) is not None)
        print(f"{label} sums: ms={self.ms:.4f} plain_ms={self.plain_ms:.4f}"
              f"{extra} bound_ms={self.bound_ms:.4f} (by "
              f"{self.entry()['bound_by']}) share_of_bound="
              f"{self.bound_ms / self.ms:.3f} bound_fp32_ms="
              f"{self.bound_fp32_ms:.4f} share_of_fp32_bound="
              f"{self.bound_fp32_ms / self.ms:.3f} max_abs_err="
              f"{self.max_abs_err:.3e}", flush=True)

    def entry(self) -> dict:
        out = {"max_abs_err": self.max_abs_err, "ms": self.ms,
               "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
               "bound_by": ("operations" if self.ops_ms >= self.bytes_ms
                            else "bytes"),
               "library_ms": self.library_ms}
        for f in ("gemm_ms", "k1_ms"):
            if getattr(self, f) is not None:
                out[f] = getattr(self, f)
        return out


def smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event-timed runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps=20, warmup=3, tries=5):
    """Mean device milliseconds of ``fn`` per call: the summed durations of
    the kernels and copies it ran in ``reps`` calls under
    ``torch.profiler``, so the host's time between launches does not count
    (``cuda_ms`` reads a call shorter than its own launch overhead as that
    overhead).  A trace without device events is taken again, up to
    ``tries`` times, then raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.device_time_total for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / reps
    raise RuntimeError("the profiler's traces hold no device time")


def add_launches(total, got) -> None:
    """Adds ``got``'s launch counts to ``total``'s kernels; a kernel that
    ``total`` does not count (a bf16 entry point, outside phase 26) must
    not have launched."""
    for name, n in got.items():
        if name in total:
            total[name] += n
        elif n:
            raise AssertionError(f"{name} launched {n} times outside the "
                                 "phase that counts it")


def analytic_reg(octree, full_depth, depth_out):
    """Per-node lumpy-sphere planes (n, r - radius) over ``octree``: the same
    shapes as the decoder's planes, a realistic iso-surface."""
    out = {}
    for dd in range(full_depth, depth_out + 1):
        x, y, z, _ = octree.xyzb(dd)
        c = (torch.stack([x, y, z], -1).float() + 0.5) / 2**dd * 2.0 - 1.0
        r = c.norm(dim=-1, keepdim=True)
        n = c / r.clamp(min=1e-9)
        rad = 0.55 + 0.08 * torch.sin(5 * c[:, :1]) * torch.cos(4 * c[:, 1:2])
        reg = torch.cat([n, r - rad], -1)
        out[dd] = torch.where(octree.node_mask(dd)[:, None], reg,
                              torch.zeros_like(reg))
    return out


def perturb_(modules, gen, scale=0.02):
    """Add seeded noise to every parameter, so no layer is zero."""
    with torch.no_grad():
        for mod in modules:
            for p in mod.parameters():
                p.add_(scale * torch.randn(p.shape, generator=gen).to(p))


def conv_shape_hooks(modules, shapes, dtype=None):
    """Forward hooks noting (level, C incl. node types, C') of every
    GraphConv call (with ``dtype``, of every call on an input of that
    dtype); returns the handles."""
    from octfusion_tpu_torch.nn.modules import GraphConv

    def hook(mod, args, out):
        if dtype is None or args[0].dtype == dtype:
            w = mod.weights
            shapes.add((args[1].d, w.shape[0] // 7, w.shape[1]))

    return [m.register_forward_hook(hook) for mod in modules
            for m in mod.modules() if isinstance(m, GraphConv)]


K1, K2K3, K5 = (("graph_conv_fwd",), ("graph_conv_col", "graph_conv_bwd_dx"),
                ("graph_conv_fwd_packed",))
_SHORT = {"graph_conv_fwd": "k1", "graph_conv_col": "k2",
          "graph_conv_bwd_dx": "k3", "graph_conv_fwd_packed": "k5"}


def kernel_tol(name, dtype, scale) -> dict:
    """The tolerance of a kernel against its plain version: fp32
    ``TOL_KERNEL``; bf16 rtol ``TOL_KERNEL_BF16`` and atol that share of
    the reference's largest magnitude ``scale`` (K3's ``TOL_K3_BF16``)."""
    if dtype == torch.float32:
        return TOL_KERNEL
    atol = TOL_K3_BF16 if name == "graph_conv_bwd_dx" else TOL_KERNEL_BF16
    return dict(rtol=TOL_KERNEL_BF16, atol=atol * scale)


def check_kernels(graph, shapes, gen, names, dtype=torch.float32):
    """The graph-conv kernels ``names`` (of K1, K2, K3, K5) against their
    plain versions at each (level, C, C') of ``graph`` on ``dtype``
    operands (``kernel_tol``), timed with CUDA events beside a yardstick
    the port never calls (K1: the GEMM alone on the materialised column
    buffer, ``col @ W``; K3: ``dout @ W^T``; K5: K1) and the bound at the
    rates of ``dtype`` -> {entry point (``*_bf16`` for bf16): KernelStats}."""
    from octfusion_tpu_torch.ops import graph_conv_cuda as k
    from octfusion_tpu_torch.ops import roofline

    dev = torch.device("cuda")
    bf16 = dtype == torch.bfloat16
    suffix, elem = ("_bf16", roofline.BF16) if bf16 else ("", roofline.F32)
    res = {name + suffix: KernelStats() for name in names}
    label = "".join(_SHORT[n] for n in names) + (" bf16" if bf16 else "")
    for d, c, cout in sorted(shapes):
        lvl = graph.level(d)
        csr, csr_t = lvl.csr(), lvl.csr_t()
        edges = (lvl.edge_row, lvl.edge_col, lvl.edge_dir, lvl.edge_scale)
        x = torch.randn(lvl.g_cap, c, device=dev, generator=gen).to(dtype)
        dout = (torch.randn(lvl.g_cap, cout, device=dev,
                            generator=gen).to(dtype)
                if "graph_conv_bwd_dx" in names else None)
        w = (torch.randn(7 * c, cout, device=dev, generator=gen)
             / (7 * c) ** 0.5).to(dtype)
        g, e = lvl.g_cap, int(lvl.n_edges)
        fwd_cost = roofline.graph_conv_fwd_cost(g, c, cout, e, elem)
        runs = {
            "graph_conv_fwd": (
                lambda: k.graph_conv(x, w, *csr),
                lambda: k.graph_conv_plain(x, w, *edges), fwd_cost,
                "gemm_ms", lambda cbuf: torch.matmul(cbuf, w)),
            "graph_conv_fwd_packed": (
                lambda: k.graph_conv_packed(x, w, *csr),
                lambda: k.graph_conv_packed_plain(x, w, *edges), fwd_cost,
                "k1_ms", lambda cbuf: k.graph_conv(x, w, *csr)),
            "graph_conv_col": (
                lambda: k.graph_conv_col(x, *csr),
                lambda: k.graph_conv_col_plain(x, *edges),
                roofline.graph_conv_col_cost(g, c, e, elem), None, None),
            "graph_conv_bwd_dx": (
                lambda: k.graph_conv_bwd_dx(dout, w, *csr_t),
                lambda: k.graph_conv_bwd_dx_plain(dout, w, *edges),
                roofline.graph_conv_bwd_dx_cost(g, c, cout, e, elem),
                "gemm_ms", lambda cbuf: torch.matmul(dout, w.t())),
        }
        line = [f"{label} d={d} G={g} E={e} C={c} C'={cout}"]
        for name in names:
            kern, plain, cost, yard, yard_fn = runs[name]
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            if got.dtype != dtype:
                raise AssertionError(f"{name}{suffix} returned {got.dtype}")
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            if not scale > 0:
                raise AssertionError(f"all-zero {name} reference at {line}")
            tol = kernel_tol(name, dtype, scale)
            torch.testing.assert_close(got.float(), ref.float(), **tol,
                                       msg=f"{name}{suffix} {line}")
            del got, ref
            tk, tp = cuda_ms(kern), cuda_ms(plain)
            extra = {}
            if yard is not None:
                cbuf = (k.graph_conv_col_plain(x, *edges)
                        if name == "graph_conv_fwd" else None)
                extra[yard] = cuda_ms(lambda: yard_fn(cbuf))
                del cbuf
            bound = res[name + suffix].add(err, tk, tp, name + suffix, cost,
                                           **extra)
            line.append(f"{name}{suffix} max_abs_err={err:.3e} max_rel_err="
                        f"{err / scale:.3e} tol=rtol {tol['rtol']:g} atol "
                        f"{tol['atol']:.3g} kernel_ms={tk:.4f} plain_ms="
                        f"{tp:.4f} " + "".join(f"{f}={v:.4f} "
                                               for f, v in extra.items())
                        + f"bound_ms={bound:.4f} share_of_bound="
                        f"{bound / tk:.3f} bound_fp32_ms="
                        f"{max(roofline.times_ms(*cost)):.4f}")
        print(" | ".join(line), flush=True)
    return res


def check_hr_step(solver, g, seed):
    """Phase 4: one full-width hr denoise step, card vs CPU.  Every weight
    gets seeded noise so zero-initialised layers carry signal."""
    df = copy.deepcopy(solver.df).cpu()
    gen = torch.Generator().manual_seed(seed)
    perturb_([df], gen)
    lvl = g.level(solver.small_depth)
    x = torch.randn(lvl.g_cap, solver.cfg.model.embed_dim, generator=gen)
    x = torch.where(lvl.node_mask.cpu()[:, None], x, torch.zeros_like(x))
    t = solver.log_snr(torch.tensor([0.5]))
    with torch.no_grad():
        ref = df("hr", x, t, g=g.to("cpu"))
        dev = torch.device("cuda")
        got = df.to(dev)("hr", x.to(dev), t.to(dev), g=g).cpu()
    err = (got - ref).abs().max().item()
    print(f"hr_step G={lvl.g_cap} max_abs_err={err:.3e} "
          f"max_abs_ref={ref.abs().max().item():.3e} "
          f"tol=rtol {TOL_STEP['rtol']:g} atol {TOL_STEP['atol']:g}",
          flush=True)
    torch.testing.assert_close(got, ref, **TOL_STEP)


def check_train_step(solver, cfg, batch, draws, seed):
    """Phase 7: one full-width hr train step's loss and gradients, card vs
    CPU, from the same perturbed weights and injected draws."""
    from octfusion_tpu_torch.models.union_solver import UnionSolver

    cpu = UnionSolver(cfg, device="cpu")
    cpu.df.load_state_dict(solver.df.state_dict())
    cpu.vae.load_state_dict(solver.vae.state_dict())
    perturb_([cpu.df, cpu.vae], torch.Generator().manual_seed(seed))
    card = UnionSolver(cfg, device="cuda")
    card.df.load_state_dict(cpu.df.state_dict())
    card.vae.load_state_dict(cpu.vae.state_dict())
    runs = {}
    for name, s in (("card", card), ("cpu", cpu)):
        s.df.train()
        s.df.unet_lr.requires_grad_(False)
        runs[name] = timed_step(s.df, lambda: s.loss_fn(
            to_device(batch, s.device), **to_device(draws, s.device)))
    compare_steps("train_step", runs, "unet_hr.")


def to_device(batch, device):
    """A dict of tensors on ``device``."""
    return {k: v.to(device) for k, v in batch.items()}


def timed_step(net, loss_fn):
    """``loss_fn()`` -> (loss, dict) and its backward -> (the dict's
    scalars as floats, the trainable parameters' gradients, seconds)."""
    t0 = time.perf_counter()
    loss, terms = loss_fn()
    loss.backward()
    secs = time.perf_counter() - t0
    scalars = {k: float(v.detach()) for k, v in terms.items()}
    return (scalars, {n: p.grad for n, p in net.named_parameters()
                      if p.requires_grad}, secs)


def compare_steps(label, runs, prefix, batch_size: int = 1):
    """Phases 7, 14 and 16: one train step's loss terms and every gradient,
    card (``runs["card"]``) vs CPU (``runs["cpu"]``), each (terms,
    gradients, seconds) from :func:`timed_step`.  Every parameter whose
    name starts with ``prefix`` must get a gradient that is not all
    zero."""
    (l_card, g_card, t_card), (l_cpu, g_cpu, t_cpu) = runs["card"], runs["cpu"]
    missing = [n for n, g in g_card.items()
               if n.startswith(prefix) and (g is None or not g.abs().max() > 0)]
    if missing or not any(n.startswith(prefix) for n in g_card):
        raise AssertionError(f"{prefix} parameters without gradient: "
                             f"{missing}")
    if sorted(l_card) != sorted(l_cpu):
        raise AssertionError(f"loss terms {sorted(l_card)} vs {sorted(l_cpu)}")
    for k in l_card:
        torch.testing.assert_close(torch.tensor(l_card[k]),
                                   torch.tensor(l_cpu[k]), **TOL_STEP,
                                   msg=k)
    worst, worst_rel, worst_share = 0.0, 0.0, 0.0
    for n, g in g_card.items():
        g = g.cpu()
        torch.testing.assert_close(g, g_cpu[n], **TOL_STEP, msg=n)
        err = (g - g_cpu[n]).abs().max().item()
        scale = g_cpu[n].abs().max().item()
        # the worst element's error over the error assert_close allows it
        share = ((g - g_cpu[n]).abs() / (TOL_STEP["atol"] + TOL_STEP["rtol"]
                                         * g_cpu[n].abs())).max().item()
        worst_share = max(worst_share, share)
        print(f"grad {n} max_abs_cpu={scale:.3e} max_abs_err={err:.3e} "
              f"share_of_tol={share:.3f}", flush=True)
        # relative to the leaf's own scale: the absolute atol above would
        # pass any leaf whose gradients are all below it
        if not err <= TOL_GRAD_SCALE * scale:
            raise AssertionError(f"gradient {n}: max abs err {err:.3e} > "
                                 f"{TOL_GRAD_SCALE:g} * max |grad| "
                                 f"{scale:.3e}")
        worst = max(worst, err)
        worst_rel = max(worst_rel, err / scale if scale else 0.0)
    if len(l_card) > 1:
        print(f"{label} terms card / cpu: " + " ".join(
            f"{k}={l_card[k]:.6f}/{l_cpu[k]:.6f}" for k in sorted(l_card)),
            flush=True)
    print(f"{label} card vs cpu B={batch_size}: loss card="
          f"{l_card['loss']:.6f} "
          f"cpu={l_cpu['loss']:.6f}"
          f" params={len(g_card)} grad max_abs_err={worst:.3e} "
          f"max_err_over_leaf_max={worst_rel:.3e} "
          f"share_of_tol={worst_share:.3f} tol=rtol "
          f"{TOL_STEP['rtol']:g} atol {TOL_STEP['atol']:g} and err <= "
          f"{TOL_GRAD_SCALE:g} * leaf max card_s={t_card:.3f} "
          f"cpu_s={t_cpu:.3f}",
          flush=True)


def run_steps(label, step, batch, n_steps, counted: bool, falling=(),
              **kw):
    """Phases 14, 17 and 21: ``n_steps`` timed steps of ``step`` on one
    fixed batch; prints the losses (and the terms named in ``falling``),
    the median ms/step after 2 warm-up steps with its stage split, and the
    peak memory; raises on overflow or a loss (or ``falling`` term) that
    is not finite or does not fall.  With ``counted`` the graph-conv
    launch counts are set to 0 first and checked after against the
    GraphConv forward and backward calls -> the run's launches."""
    from octfusion_tpu_torch.nn.modules import GraphConv
    from octfusion_tpu_torch.ops import graph_conv_cuda as k

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k.reset_launches()
    GraphConv.calls = 0
    k.GraphConvFunction.backward_calls = 0
    losses, walls, stages = [], [], []
    terms = {name: [] for name in falling}
    for _ in range(n_steps):
        t0 = time.perf_counter()
        out = step(batch, timed=True, **kw)
        walls.append(time.perf_counter() - t0)
        losses.append(out["loss"].item())
        for name in falling:
            terms[name].append(out[name].item())
        stages.append(out["seconds"])
        if "overflow" not in out or out["overflow"].item():
            raise AssertionError(f"{label}: the batch overflows (or no flag)")
    launches = dict(k.launches)
    calls, bwd = GraphConv.calls, k.GraphConvFunction.backward_calls
    peak = torch.cuda.max_memory_allocated()
    print(f"{label} losses " + " ".join(f"{v:.6f}" for v in losses),
          flush=True)
    warm = slice(2, None)
    split = {name: statistics.median(s[name] for s in stages[warm]) * 1e3
             for name in stages[0]}
    print(f"{label}: B={batch['points'].shape[0]} steps={n_steps} "
          f"ms_per_step={statistics.median(walls[warm]) * 1e3:.3f} (median "
          f"after 2 warm-up) first_step_ms={walls[0] * 1e3:.3f} "
          + " ".join(f"{n}_ms={v:.3f}" for n, v in split.items())
          + f" peak_memory_bytes={peak} ({peak / 2**30:.2f} GiB)",
          flush=True)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: the loss did not fall: {losses}")
    for name, vals in terms.items():
        print(f"{label} {name} " + " ".join(f"{v:.6f}" for v in vals),
              flush=True)
        if not (all(math.isfinite(v) for v in vals) and vals[-1] < vals[0]):
            raise AssertionError(f"{label}: {name} is not finite or did not "
                                 f"fall: {vals}")
    if counted:
        print(f"{label} launches fwd={launches['graph_conv_fwd']} "
              f"col={launches['graph_conv_col']} "
              f"bwd_dx={launches['graph_conv_bwd_dx']} graph_conv_calls="
              f"{calls} graph_conv_backward_calls={bwd}", flush=True)
        if launches["graph_conv_fwd"] != calls:
            raise AssertionError(f"K1 launches {launches['graph_conv_fwd']}"
                                 f" != GraphConv calls {calls}")
        if not (launches["graph_conv_col"] == launches["graph_conv_bwd_dx"]
                == bwd > 0):
            raise AssertionError(f"K2 {launches['graph_conv_col']} / K3 "
                                 f"{launches['graph_conv_bwd_dx']} launches "
                                 f"vs {bwd} graph-conv backward calls")
    return launches


def run_training(solver, batch, draws, n_steps):
    """Phase 8: ``n_steps`` train steps on one fixed batch; the frozen lr
    U-Net must stay bit for bit -> the launch counts of the run."""
    lr_before = {n: p.detach().clone()
                 for n, p in solver.df.unet_lr.named_parameters()}
    launches = run_steps("train", solver.make_train_step(), batch, n_steps,
                         True, **draws)
    for n, p in solver.df.unet_lr.named_parameters():
        if not torch.equal(p, lr_before[n]):
            raise AssertionError(f"frozen lr U-Net parameter {n} changed")
    return launches


def print_graph(label, g, allow_overflow: bool = False) -> None:
    """A graph's node counts, vertex and edge counts and each level's
    largest CSR and transposed-CSR slot, held to the CSR's int32 offsets
    (7 G + 1 slot pointers and E edges below 2^31; a slot's edges are
    staged in pieces of at most 1024, so a piece's 16-bit count holds
    whatever the slot's size); raises if the graph overflows unless
    ``allow_overflow``."""
    print(f"{label} graph: nnum " + " ".join(
        f"d{d}={int(n)}" for d, n in enumerate(g.octree.nnum.tolist()))
        + " G " + " ".join(f"d{lvl.d}={lvl.g_cap}" for lvl in g.levels)
        + " E " + " ".join(f"d{lvl.d}={int(lvl.n_edges)}" for lvl in g.levels)
        + " largest slot (csr/csr_t) " + " ".join(
            f"d{lvl.d}={int(lvl.csr()[0].diff().max())}/"
            f"{int(lvl.csr_t()[0].diff().max())}" for lvl in g.levels)
        + f" overflow={bool(g.any_overflow())}", flush=True)
    for lvl in g.levels:
        if 7 * lvl.g_cap + 1 > INT32_MAX or int(lvl.n_edges) > INT32_MAX:
            raise AssertionError(f"{label}: level {lvl.d} exceeds the CSR's "
                                 f"int32 offsets (G={lvl.g_cap}, "
                                 f"E={int(lvl.n_edges)})")
    if g.any_overflow().item() and not allow_overflow:
        raise AssertionError(f"the {label} batch's graph overflows")


def training_setup(seed, edit=None, dtype=None):
    """The hr stage of ``configs/octfusion_snet_uncond.yaml`` on the card
    (changed by ``edit(cfg)`` if given) -> (trainer, config, batch, draws,
    the batch's graph, the (level, C, C') of every conv of a train step's
    forward (K1: the frozen encoder's included), those of the
    differentiable convs (K2, K3); with ``dtype``, only the convs on
    inputs of that dtype).  Prints the graph's sizes; raises
    if it overflows."""
    from octfusion_tpu_torch.config import load_config
    from octfusion_tpu_torch.models.union_solver import UnionSolver
    from octfusion_tpu_torch.utils.shapes import lumpy_spheres

    dev = torch.device("cuda")
    tcfg = load_config(TRAIN_CONFIG)
    if edit is not None:
        tcfg = edit(tcfg)
    torch.manual_seed(seed)
    trainer = UnionSolver(tcfg, device=dev)
    bsz = tcfg.data.batch_size
    pts, nrm = lumpy_spheres(bsz, tcfg.data.points_per_shape, seed,
                             device=dev)
    batch = {"points": pts, "normals": nrm}
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    shape = trainer.code_shape(bsz)
    draws = {"eps": torch.randn(shape, device=dev, generator=gen),
             "times": torch.rand(bsz, device=dev, generator=gen),
             "noise": torch.randn(shape, device=dev, generator=gen)}
    g_train = trainer.batch_graph(batch)
    print_graph("train", g_train)
    # K1 runs at every conv's shape, the frozen encoder's included; K2 and
    # K3 only at the differentiable convs of the hr U-Net
    fwd_shapes, shapes = set(), set()
    hooks = (conv_shape_hooks([trainer.vae], fwd_shapes, dtype)
             + conv_shape_hooks([trainer.df], shapes, dtype))
    with torch.no_grad():
        trainer.hr_loss(g_train,
                        trainer.vae.extract_code(g_train, eps=draws["eps"]),
                        times=draws["times"], noise=draws["noise"])
    for h in hooks:
        h.remove()
    return trainer, tcfg, batch, draws, g_train, fwd_shapes | shapes, shapes


def check_training(seed):
    """Phases 6-8 on the hr stage of ``configs/octfusion_snet_uncond.yaml``
    -> (K1 / K2 / K3 measurements at the training shapes, the training
    run's launch counts)."""
    dev = torch.device("cuda")
    trainer, tcfg, batch, draws, g_train, fwd_shapes, shapes = \
        training_setup(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    measured = {**check_kernels(g_train, fwd_shapes, gen, K1),
                **check_kernels(g_train, shapes, gen, K2K3)}
    for name, label in (("graph_conv_fwd", "k1 phase 6 (training)"),
                        ("graph_conv_col", "k2 phase 6 (training)"),
                        ("graph_conv_bwd_dx", "k3 phase 6 (training)")):
        measured[name].summary(label)
    del g_train

    one = {k: v[:1] for k, v in batch.items()}
    shape1 = trainer.code_shape(1)
    gen1 = torch.Generator().manual_seed(seed + 3)
    check_train_step(trainer, tcfg, one, {
        "eps": torch.randn(shape1, generator=gen1),
        "times": torch.rand(1, generator=gen1),
        "noise": torch.randn(shape1, generator=gen1)}, seed)

    return measured, run_training(trainer, batch, draws, TRAIN_STEPS)


def check_lr_training(seed):
    """Phase 14: the lr stage of ``configs/octfusion_snet_uncond.yaml``,
    one step card vs CPU at batch 1 (``lr_pos_weight`` 1.75), then
    ``LR_TRAIN_STEPS`` steps at batch 4."""
    from octfusion_tpu_torch.config import load_config
    from octfusion_tpu_torch.models.union_solver import UnionSolver
    from octfusion_tpu_torch.utils.shapes import lumpy_spheres

    dev = torch.device("cuda")
    tcfg = load_config(TRAIN_CONFIG)
    s = 2**tcfg.model.full_depth
    wcfg = dataclasses.replace(tcfg, diffusion=dataclasses.replace(
        tcfg.diffusion, lr_pos_weight=LR_POS_WEIGHT))
    torch.manual_seed(seed)
    cpu = UnionSolver(wcfg, stage_flag="lr", device="cpu")
    perturb_([cpu.df], torch.Generator().manual_seed(seed + 8))
    card = UnionSolver(wcfg, stage_flag="lr", device=dev)
    card.df.load_state_dict(cpu.df.state_dict())
    pts, nrm = lumpy_spheres(1, tcfg.data.points_per_shape, seed)
    gen = torch.Generator().manual_seed(seed + 9)
    draws = {"times": torch.rand(1, generator=gen),
             "noise": torch.randn(1, s, s, s, 8, generator=gen)}
    runs = {}
    for name, sol in (("card", card), ("cpu", cpu)):
        sol.df.train()
        runs[name] = timed_step(sol.df, lambda: sol.loss_fn(
            to_device({"points": pts, "normals": nrm}, sol.device),
            **to_device(draws, sol.device)))
    compare_steps(f"lr_step (lr_pos_weight {LR_POS_WEIGHT:g})", runs,
                  "unet_lr.")
    del cpu, card

    torch.manual_seed(seed)
    trainer = UnionSolver(tcfg, stage_flag="lr", device=dev)
    bsz = tcfg.data.batch_size
    pts, nrm = lumpy_spheres(bsz, tcfg.data.points_per_shape, seed,
                             device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 10)
    draws = {"times": torch.rand(bsz, device=dev, generator=gen),
             "noise": torch.randn(bsz, s, s, s, 8, device=dev,
                                  generator=gen)}
    run_steps("lr train", trainer.make_train_step(),
              {"points": pts, "normals": nrm}, LR_TRAIN_STEPS, False,
              **draws)


def vae_setup(seed):
    """The VAE of ``configs/octfusion_snet_uncond.yaml`` on the card ->
    (solver, config, the batch-2 batch, eps, its graph, the (level, C,
    C') of every graph conv of a train step).  Prints the graph's sizes;
    raises if it overflows."""
    from octfusion_tpu_torch.config import load_config
    from octfusion_tpu_torch.models.common import batch_to_graph
    from octfusion_tpu_torch.models.vae_solver import VAESolver
    from octfusion_tpu_torch.utils.shapes import lumpy_sphere_batch

    dev = torch.device("cuda")
    cfg = load_config(TRAIN_CONFIG)
    torch.manual_seed(seed)
    solver = VAESolver(cfg, device=dev)
    batch = lumpy_sphere_batch(VAE_BATCH, cfg.data.points_per_shape,
                               cfg.data.point_sample_num, seed, device=dev)
    eps = torch.randn(solver.code_shape(VAE_BATCH), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(
                          seed + 11))
    g = batch_to_graph(batch["points"], batch["normals"], solver.spec1,
                       solver.edge_factor)[1]
    print_graph("vae", g)
    shapes = set()
    hooks = conv_shape_hooks([solver.vae], shapes)
    with torch.no_grad():
        solver.vae(g, g, eps=eps)
    for h in hooks:
        h.remove()
    return solver, cfg, batch, eps, g, shapes


def check_vae_step(solver, cfg, batch, seed, label="vae_step"):
    """Phases 16 and 21: one full-width VAE train step's loss terms and gradients,
    card vs CPU at batch 1, from the same perturbed weights and eps, both
    under deterministic algorithms.  The VAE's gradients reach ~1e3, where
    the atomic and parallel accumulations (``index_add_``, ``index_put_``
    with ``accumulate``) change an element's fp32 sum from run to run by
    about the elementwise atol itself; deterministically, each side gives
    the same bits on every run, and the kernels are unchanged."""
    from octfusion_tpu_torch.models.vae_solver import VAESolver

    cpu = VAESolver(cfg, device="cpu")
    cpu.vae.load_state_dict(solver.vae.state_dict())
    perturb_([cpu.vae], torch.Generator().manual_seed(seed + 12))
    card = VAESolver(cfg, device="cuda")
    card.vae.load_state_dict(cpu.vae.state_dict())
    one = {k: v[:1].cpu() for k, v in batch.items()}
    eps = torch.randn(cpu.code_shape(1),
                      generator=torch.Generator().manual_seed(seed + 13))
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for name, sol in (("card", card), ("cpu", cpu)):
            sol.vae.train()
            runs[name] = timed_step(sol.vae, lambda: sol.loss_fn(
                to_device(one, sol.device), eps=eps.to(sol.device)))
    finally:
        torch.use_deterministic_algorithms(False)
    compare_steps(label, runs, "")


def check_vae_training(seed):
    """Phases 15-18 on the VAE of ``configs/octfusion_snet_uncond.yaml``
    -> (K1 / K2 / K3 measurements at the VAE's training shapes, the
    launches of the training run (phase 17) and of the reconstruction
    (phase 18))."""
    from octfusion_tpu_torch.nn.modules import GraphConv
    from octfusion_tpu_torch.ops import graph_conv_cuda as k

    dev = torch.device("cuda")
    solver, cfg, batch, eps, g, shapes = vae_setup(seed)
    # ---- 15 -------------------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    measured = {**check_kernels(g, shapes, gen, K1),
                **check_kernels(g, shapes, gen, K2K3)}
    for name, label in (("graph_conv_fwd", "k1 phase 15 (vae training)"),
                        ("graph_conv_col", "k2 phase 15 (vae training)"),
                        ("graph_conv_bwd_dx", "k3 phase 15 (vae training)")):
        measured[name].summary(label)
    del g
    # ---- 16 -------------------------------------------------------------
    check_vae_step(solver, cfg, batch, seed)
    # ---- 17 -------------------------------------------------------------
    train_launches = run_steps("vae train", solver.make_train_step(), batch,
                               VAE_TRAIN_STEPS, True, eps=eps)
    # ---- 18 -------------------------------------------------------------
    m = cfg.model
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k.reset_launches()
    GraphConv.calls = 0
    sdfs, out = solver.reconstruct(batch)
    recon_launches, calls = dict(k.launches), GraphConv.calls
    peak = torch.cuda.max_memory_allocated()
    octree = out["octree_out"]
    print("vae reconstruct: " + " ".join(
        f"{n}_s={v:.3f}" for n, v in out["seconds"].items())
        + f" resolution={sdfs.shape[1]} nnum " + " ".join(
            f"d{d}={int(n)}" for d, n in enumerate(octree.nnum.tolist()))
        + f" overflow={bool(out['graph_out'].any_overflow())} "
        f"k1_launches={recon_launches['graph_conv_fwd']} graph_conv_calls="
        f"{calls} peak_memory_bytes={peak} ({peak / 2**30:.2f} GiB)",
        flush=True)
    want = (VAE_BATCH,) + (cfg.solver.resolution,) * 3
    if tuple(sdfs.shape) != want or not torch.isfinite(sdfs).all():
        raise AssertionError(f"reconstruct: sdf {tuple(sdfs.shape)} (want "
                             f"{want}) or non-finite values")
    if not recon_launches["graph_conv_fwd"] == calls > 0:
        raise AssertionError(f"reconstruct: K1 launches "
                             f"{recon_launches['graph_conv_fwd']} != "
                             f"GraphConv calls {calls}")
    print(f"vae reconstruct sdf: min={sdfs.min().item():.4f} "
          f"max={sdfs.max().item():.4f}", flush=True)
    del sdfs, out, octree
    with tempfile.TemporaryDirectory() as root:
        paths = [os.path.join(root, f"{i}.obj") for i in range(VAE_BATCH)]
        _, out = solver.reconstruct(batch, resolution=VAE_MESH_RESOLUTION,
                                    save_paths=paths)
        sizes = [os.path.getsize(p) if os.path.exists(p) else 0
                 for p in paths]
    print(f"vae reconstruct meshes at {VAE_MESH_RESOLUTION}^3 (barely "
          "trained weights decode noise): " + " ".join(
              f"{n}_s={v:.3f}" for n, v in out["seconds"].items())
          + f" obj_bytes={sizes}", flush=True)
    launches = {name: train_launches[name] for name in measured}
    launches["graph_conv_fwd"] += recon_launches["graph_conv_fwd"]
    return measured, launches


def cdist_minima(a, b):
    """The library yardstick of K4: one ``torch.cdist``, squared, and both
    minima (the port never calls it)."""
    d = torch.cdist(a, b).square()
    return d.amin(2), d.amin(1)


def check_chamfer(seed) -> KernelStats:
    """Phase 9: K4 vs its plain version at the cases of ``CHAMFER_CASES``,
    then CD / EMD pairs/s at the evaluation batches."""
    from octfusion_tpu_torch.metrics import distances
    from octfusion_tpu_torch.ops import chamfer_cuda as k4
    from octfusion_tpu_torch.ops import roofline

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    stats = KernelStats()
    cd_ms = {}
    for case, bsz, n, m in CHAMFER_CASES:
        a = torch.rand(bsz, n, 3, device=dev, generator=gen) - 0.5
        if case == "near_duplicate":
            b = a + 1e-3 * torch.randn(a.shape, device=dev, generator=gen)
        else:
            b = torch.rand(bsz, m, 3, device=dev, generator=gen) - 0.5
        if case == "nan":
            a[0, 2, 1] = float("nan")
            b[1, 5, 0] = float("nan")
        if case == "non_finite":
            a[0, 3, 2] = float("inf")
            a[1, 4, 0] = 1e20
            b[2, 6, 1] = -float("inf")
            b[3, 9, 2] = -1e20
        got, ref = k4.chamfer(a, b), k4.chamfer_plain(a, b)
        torch.cuda.synchronize()
        err = max((g - r).nan_to_num(0.0).abs().max().item()
                  for g, r in zip(got, ref))
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, equal_nan=True, **TOL_CHAMFER)
            if torch.signbit(g[~g.isnan()]).any():
                raise AssertionError(f"-0.0 in K4's output at {case}")
        if case == "nan" and not (got[0][1].isnan().all()
                                  and got[1][0].isnan().all()):
            raise AssertionError("K4 dropped a NaN")
        if case == "non_finite" and not (got[0][0, 3].isnan()
                                         and got[0][1, 4].isinf()):
            raise AssertionError("K4 dropped an infinity")
        del got, ref
        tk = cuda_ms(lambda: k4.chamfer(a, b))
        tkd = device_ms(lambda: k4.chamfer(a, b))
        tp = cuda_ms(lambda: k4.chamfer_plain(a, b))
        tl = cuda_ms(lambda: cdist_minima(a, b))
        cost = roofline.chamfer_cost(bsz, n, m)
        bound = stats.add(err, tk, tp, "chamfer", cost, library_ms=tl)
        bound_fp32 = max(roofline.times_ms(*cost))
        if case == "eval":
            cd_ms[bsz] = tk
        print(f"k4 {case} B={bsz} N={n} M={m} max_abs_err={err:.3e} "
              f"tol=rtol {TOL_CHAMFER['rtol']:g} atol {TOL_CHAMFER['atol']:g}"
              f" kernel_ms={tk:.4f} kernel_dev_ms={tkd:.4f} plain_ms="
              f"{tp:.4f} library_ms={tl:.4f} bound_ms={bound:.4f} "
              f"share_of_bound={bound / tk:.3f} share_of_bound_dev="
              f"{bound / tkd:.3f} bound_fp32_ms={bound_fp32:.4f} "
              f"share_of_fp32_bound_dev={bound_fp32 / tkd:.3f}", flush=True)
    for bsz, tk in cd_ms.items():
        a = torch.rand(bsz, EVAL_POINTS, 3, device=dev, generator=gen) - 0.5
        b = torch.rand(bsz, EVAL_POINTS, 3, device=dev, generator=gen) - 0.5
        emd_ms = {}
        for store in (torch.float32, torch.bfloat16):
            emd_ms[store] = cuda_ms(
                lambda: distances.emd_approx(a, b, store_dtype=store),
                reps=5, warmup=1)
        if bsz == min(cd_ms):
            e32 = distances.emd_approx(a, b)
            e16 = distances.emd_approx(a, b, store_dtype=torch.bfloat16)
            rel = ((e16 - e32).abs() / e32.abs()).max().item()
            print(f"emd bf16 vs fp32 B={bsz} max_rel_diff={rel:.3e} tol=rtol"
                  f" {TOL_EMD_BF16['rtol']:g}", flush=True)
            torch.testing.assert_close(e16, e32, **TOL_EMD_BF16)
        print(f"pairs_per_s B={bsz} P={EVAL_POINTS} cd_k4={bsz / tk * 1e3:.1f} "
              f"emd_fp32={bsz / emd_ms[torch.float32] * 1e3:.1f} "
              f"emd_bf16={bsz / emd_ms[torch.bfloat16] * 1e3:.1f} "
              f"(ms: {tk:.4f} / {emd_ms[torch.float32]:.3f} / "
              f"{emd_ms[torch.bfloat16]:.3f})", flush=True)
    return stats


def write_meshes(root, seed, n=EVAL_SHAPES):
    """Phase 10's meshes (phase 23's with ``n``): ``n`` lumpy spheres per
    set, marching tetrahedra on the card over their fields on a
    ``EVAL_GRID``³ grid, one seed per set -> the two globs."""
    from octfusion_tpu_torch.utils import mesh as mesh_utils
    from octfusion_tpu_torch.utils.shapes import lumpy_sphere_fields

    dev = torch.device("cuda")
    globs, faces_n = [], []
    for kind, s in (("samples", seed + 100), ("reference", seed + 200)):
        os.makedirs(os.path.join(root, kind))
        fields = lumpy_sphere_fields(n, EVAL_GRID, s, device=dev)
        for i, field in enumerate(fields):
            verts, faces = mesh_utils.marching_tetrahedra(field)
            faces_n.append(faces.shape[0])
            mesh_utils.save_obj(os.path.join(root, kind, f"{i:03d}.obj"),
                                verts.cpu().numpy(), faces.cpu().numpy())
        globs.append(os.path.join(root, kind, "*.obj"))
    if min(faces_n) == 0:
        raise AssertionError("an empty evaluation mesh")
    print(f"eval meshes: {n}+{n} lumpy spheres, "
          f"{EVAL_GRID}^3 grid, faces {min(faces_n)}-{max(faces_n)}",
          flush=True)
    return globs


def check_evaluation(seed) -> int:
    """Phase 10: ``python -m octfusion_tpu_torch.evaluate`` from meshes on
    the card -> K4's launches in it."""
    from octfusion_tpu_torch import evaluate
    from octfusion_tpu_torch.metrics import distances
    from octfusion_tpu_torch.ops import chamfer_cuda as k4

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        samples, reference = write_meshes(root, seed)
        t_mesh = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        k4.reset_launches()
        t0 = time.perf_counter()
        res = evaluate.main(["--samples", samples, "--reference", reference,
                             "--points", str(EVAL_POINTS), "--emd",
                             "--batch", str(EVAL_BATCH)])
        wall = time.perf_counter() - t0
        launches = k4.launches["chamfer"]
        peak = torch.cuda.max_memory_allocated()

        s = r = EVAL_SHAPES
        tiles = sum(-(-rows // EVAL_ROW_BLOCK) * -(-cols // EVAL_BATCH)
                    for rows, cols in ((s, r), (s, s), (r, r)))
        pairs = s * r + s * s + r * r
        print(f"eval: S={s} R={r} P={EVAL_POINTS} batch={EVAL_BATCH} "
              f"mesh_s={t_mesh:.3f} wall_s={wall:.3f} sampling_s="
              f"{res['wall_s_pointcloud_sampling']:.3f} pairwise_s="
              f"{res['wall_s_pairwise_metrics']:.3f} pairs={pairs} "
              f"pairs_per_s={pairs / res['wall_s_pairwise_metrics']:.1f} "
              f"k4_launches={launches} tiles={tiles} peak_memory_bytes="
              f"{peak} ({peak / 2**30:.2f} GiB)", flush=True)
        print("eval metrics " + " ".join(f"{k}={v}" for k, v in res.items()),
              flush=True)
        if not all(math.isfinite(v) for v in res.values()):
            raise AssertionError(f"non-finite metric: {res}")
        for k in ("cov_cd", "cov_emd", "1nna_cd", "1nna_emd"):
            if not 0.0 <= res[k] <= 1.0:
                raise AssertionError(f"{k} = {res[k]} outside [0, 1]")
        if launches != tiles:
            raise AssertionError(f"K4 launches {launches} != tiles {tiles}")

        # the first block of the sample x reference matrices, recomputed
        # through the same tiles on the card and on the CPU (plain path)
        k = EVAL_BLOCK
        sp, _ = evaluate.meshes_to_pointclouds(
            sorted(glob.glob(samples))[:k], EVAL_POINTS, seed=0)
        rp, _ = evaluate.meshes_to_pointclouds(
            sorted(glob.glob(reference))[:k], EVAL_POINTS, seed=10_000)
        t0 = time.perf_counter()
        card = distances.pairwise_cd_emd(
            torch.tensor(sp, device=dev), torch.tensor(rp, device=dev),
            EVAL_BATCH)
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = distances.pairwise_cd_emd(torch.tensor(sp), torch.tensor(rp),
                                        EVAL_BATCH)
        t_cpu = time.perf_counter() - t0
    errs = [np.abs(c - p).max() / np.abs(p).max() for c, p in zip(card, cpu)]
    print(f"eval {k}x{k} block card vs cpu: cd max_err/max={errs[0]:.3e} "
          f"emd max_err/max={errs[1]:.3e} tol cd rtol "
          f"{TOL_CHAMFER['rtol']:g} atol {TOL_CHAMFER['atol']:g}, emd rtol "
          f"{TOL_EMD_CARD['rtol']:g} card_s={t_card:.3f} cpu_s={t_cpu:.3f}",
          flush=True)
    np.testing.assert_allclose(card[0], cpu[0], **TOL_CHAMFER)
    np.testing.assert_allclose(card[1], cpu[1], **TOL_EMD_CARD)
    return launches


def check_packed_autograd(graph, gen) -> None:
    """Phase 11: K5 is forward only: a gradient through a packed level
    raises, unlaunched; under no_grad it runs."""
    from octfusion_tpu_torch.octree.dual_graph import with_packed_levels
    from octfusion_tpu_torch.ops import graph_conv_cuda as k
    from octfusion_tpu_torch.ops import graph_ops

    dev = torch.device("cuda")
    packed = with_packed_levels(graph)
    lvl = packed.level(graph.spec.full_depth)
    x = torch.randn(lvl.g_cap, 8, device=dev, generator=gen)
    w = torch.randn(7 * 8, 8, device=dev, generator=gen).requires_grad_()
    n0 = k.launches["graph_conv_fwd_packed"]
    for call in (lambda: graph_ops.graph_conv(x, w, lvl),
                 lambda: k.graph_conv_packed(x, w, *lvl.csr())):
        try:
            call()
        except RuntimeError as exc:
            if "forward-only" not in str(exc):
                raise
        else:
            raise AssertionError("K5 ran under autograd")
    if k.launches["graph_conv_fwd_packed"] != n0:
        raise AssertionError("K5 launched under autograd")
    with torch.no_grad():
        graph_ops.graph_conv(x, w, lvl)
    print("k5 under autograd: raises (graph_ops.graph_conv on a packed "
          "level and the wrapper); under no_grad it runs", flush=True)


def assert_same_tensors(a, b, what: str) -> None:
    """Every tensor of two (nested) dataclasses / sequences is equal."""
    if isinstance(a, torch.Tensor):
        if not torch.equal(a, b):
            raise AssertionError(f"{what} differs")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{what}: {len(a)} vs {len(b)} entries")
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_tensors(x, y, f"{what}[{i}]")
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            if f.init:
                assert_same_tensors(getattr(a, f.name), getattr(b, f.name),
                                    f"{what}.{f.name}")


def dpmpp_solver(cfg, seed):
    """Phases 12-13's model: ``cfg`` with the DPM-Solver++ sampler, seeded
    weights perturbed with seeded noise."""
    from octfusion_tpu_torch.models.union_solver import UnionSolver

    cfg = dataclasses.replace(cfg, diffusion=dataclasses.replace(
        cfg.diffusion, sampler="dpmpp"))
    torch.manual_seed(seed)
    solver = UnionSolver(cfg, device="cuda")
    perturb_([solver.df, solver.vae], torch.Generator().manual_seed(seed + 4))
    return solver


def check_dpmpp(solver, seed):
    """Phase 12: the dpmpp-25 cascade with K5 and with K1 on the same
    weights and injected noise -> (K5 launches, K1 launches) of the two
    counted runs."""
    from octfusion_tpu_torch.nn.modules import GraphConv
    from octfusion_tpu_torch.ops import graph_conv_cuda as k

    dev = solver.device
    m = solver.cfg.model
    s = 2**m.full_depth
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    noise = {"lr_noise": torch.randn(1, 1, 8, s, s, s, device=dev,
                                     generator=gen),
             "hr_noise": torch.randn((1,) + solver.code_shape(1), device=dev,
                                     generator=gen)}
    packed_calls = [0]

    def count_packed(mod, args, out):
        packed_calls[0] += bool(args[1].packed)

    hooks = [mod.register_forward_hook(count_packed)
             for net in (solver.df, solver.vae) for mod in net.modules()
             if isinstance(mod, GraphConv)]
    runs = {}
    for kpack in (True, False):
        solver.sample(steps=2, resolution=RESOLUTION, kpack=kpack, **noise)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k.reset_launches()
        GraphConv.calls = 0
        packed_calls[0] = 0
        t0 = time.perf_counter()
        out = solver.sample(steps=DPMPP_STEPS, resolution=RESOLUTION,
                            kpack=kpack, **noise)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, calls = dict(k.launches), GraphConv.calls
        peak = torch.cuda.max_memory_allocated()
        print(f"dpmpp cascade kpack={kpack}: steps={DPMPP_STEPS}+"
              f"{DPMPP_STEPS} wall_s={wall:.3f} "
              + " ".join(f"{n}_s={v:.3f}" for n, v in out["seconds"].items())
              + f" peak_memory_bytes={peak} ({peak / 2**30:.2f} GiB) "
              f"k1_launches={launches['graph_conv_fwd']} k5_launches="
              f"{launches['graph_conv_fwd_packed']} graph_conv_calls={calls}"
              f" on_packed_levels={packed_calls[0]} overflow="
              f"{bool(out['overflow'])}", flush=True)
        want_k5 = packed_calls[0] if kpack else 0
        if not (launches["graph_conv_fwd_packed"] == want_k5
                and launches["graph_conv_fwd"] == calls - want_k5
                and calls > want_k5 and (want_k5 > 0 or not kpack)):
            raise AssertionError(f"kpack={kpack}: launches {launches} vs "
                                 f"{calls} GraphConv calls, {packed_calls[0]}"
                                 " on packed levels")
        if not (torch.isfinite(out["code"]).all()
                and torch.isfinite(out["sdfs"]).all()):
            raise AssertionError(f"kpack={kpack}: non-finite codes or SDF")
        runs[kpack] = (out, launches)
    for h in hooks:
        h.remove()

    (o5, l5), (o1, l1) = runs[True], runs[False]
    assert_same_tensors(o5["graph"], o1["graph"], "graph")
    err = (o5["code"] - o1["code"]).abs().max().item()
    scale = o1["code"].abs().max().item()
    print(f"dpmpp K5 vs K1: same octree and graph; codes max_abs_err="
          f"{err:.3e} max_abs_code={scale:.3e} ratio={err / scale:.3e} "
          f"tol {TOL_KPACK_CODE:g}", flush=True)
    if not (scale > 0 and err <= TOL_KPACK_CODE * scale):
        raise AssertionError(f"K5 vs K1 codes: {err:.3e} > "
                             f"{TOL_KPACK_CODE:g} * {scale:.3e}")
    return (l5["graph_conv_fwd_packed"],
            l5["graph_conv_fwd"] + l1["graph_conv_fwd"])


def save_for_generate(solver, cfg, root):
    """Phases 13 and 25: ``solver``'s weights as the generate CLI reads
    them (``utils/ckpt.save`` in the reference layout, the VAE under
    ``autoencoder``) and ``cfg`` with ``solver.resolution``
    ``CLI_RESOLUTION``, under ``root`` -> (diffusion checkpoint, VAE
    checkpoint, config path)."""
    from octfusion_tpu_torch.config import dump_config
    from octfusion_tpu_torch.utils import ckpt, params

    # untrained weights: the EMA a trainer would hold is the weights
    ckpt_path = ckpt.save(os.path.join(root, "ckpt"),
                          params.union_checkpoint(solver.df, ema=None),
                          step=0)
    vae_path = ckpt.save(
        os.path.join(root, "vae"),
        {"autoencoder": {n: v.cpu() for n, v in
                         solver.vae.state_dict().items()}}, step=0)
    cfg_path = os.path.join(root, "config.yaml")
    dump_config(dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, resolution=CLI_RESOLUTION)), cfg_path)
    return ckpt_path, vae_path, cfg_path


def check_cli(solver, cfg, seed):
    """Phase 13: ``python -m octfusion_tpu_torch.generate`` from a
    checkpoint of ``solver``'s weights, twice."""
    with tempfile.TemporaryDirectory() as root:
        ckpt_path, vae_path, cfg_path = save_for_generate(solver, cfg, root)
        cmd = [sys.executable, "-m", "octfusion_tpu_torch.generate",
               "--config", cfg_path, "--logs_dir", root, "--name", "gen",
               "--ckpt", ckpt_path, "--vq_ckpt", vae_path,
               "--count", str(CLI_SHAPES), "--sampler", "dpmpp",
               "--sample_steps", str(DPMPP_STEPS), "--seed", str(seed)]
        env = dict(os.environ, OCTFUSION_CONV_KPACK="1")
        rdir = os.path.join(root, "gen", "results_airplane")
        outs = []
        for attempt in (1, 2):
            t0 = time.perf_counter()
            res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                                 text=True, timeout=900)
            wall = time.perf_counter() - t0
            if res.returncode != 0:
                raise AssertionError(f"generate run {attempt} failed "
                                     f"({res.returncode}):\n"
                                     f"{res.stderr[-3000:]}")
            lines = res.stdout.splitlines()
            outs.append(lines)
            print(f"cli run {attempt}: wall_s={wall:.3f} "
                  f"(resolution {CLI_RESOLUTION}, the one cut: random "
                  "weights decode noise)", flush=True)
            for line in lines:
                print(f"  {line}", flush=True)
        wrote = [ln for ln in outs[0] if ln.startswith("[*] wrote ")]
        summary = [ln for ln in outs[0] if ln.startswith("[*] generated")]
        if len(wrote) != CLI_SHAPES or not any(
                ln.startswith("[*] loaded EMA") for ln in outs[0]):
            raise AssertionError(f"generate: {len(wrote)} meshes written of "
                                 f"{CLI_SHAPES}, or no checkpoint loaded")
        if not summary or "graph_conv_fwd_packed_launches=" not in summary[0]:
            raise AssertionError("generate ran no K5 launch")
        sizes = []
        for i in range(CLI_SHAPES):
            with open(os.path.join(rdir, f"{i}.obj"), "rb") as fh:
                data = fh.read()
            if b"\nf " not in data:
                raise AssertionError(f"{i}.obj has no face")
            sizes.append(len(data))
        if any(ln.startswith("[*] wrote ") for ln in outs[1]) or not any(
                f"{CLI_SHAPES}/{CLI_SHAPES} meshes already present" in ln
                for ln in outs[1]):
            raise AssertionError("the second generate run did not skip "
                                 "every mesh")
    print(f"cli: {CLI_SHAPES} non-empty meshes, bytes {sizes}; the rerun "
          "skipped all of them", flush=True)


def cli_config(root, location, filelist, base=None,
               point_scale=None) -> str:
    """Phase 19's YAML (and phase 21's, 22's with ``base``; phase 24's
    with ``point_scale``): ``configs/octfusion_snet_uncond.yaml`` with
    the changes its first lines list."""
    from octfusion_tpu_torch.config import dump_config, load_config

    base = base or TRAIN_CONFIG
    cfg = load_config(base)
    data = dict(location=location, filelist=filelist)
    note = ""
    if point_scale is not None:
        data["point_scale"] = point_scale
        note = f", data.point_scale {point_scale}"
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, **data),
        train=dataclasses.replace(cfg.train, print_freq=1,
                                  save_latest_freq=2, display_freq=3),
        solver=dataclasses.replace(cfg.solver,
                                   resolution=CLI_TRAIN_RESOLUTION))
    path = os.path.join(root, "config.yaml")
    dump_config(cfg, path)
    with open(path) as fh:
        body = fh.read()
    with open(path, "w") as fh:
        fh.write(f"# {os.path.relpath(base, REPO)} with these changes: "
                 "data.location and data.filelist (a seeded lumpy-sphere\n"
                 f"# set){note}, train.print_freq 1, "
                 "train.save_latest_freq 2, "
                 f"train.display_freq 3, solver.resolution "
                 f"{CLI_TRAIN_RESOLUTION}\n# (barely trained weights decode "
                 "noise, whose 256^3 mesh is ~10^8 faces of text)\n" + body)
    return path


def run_cli(label, argv):
    """One ``python -m octfusion_tpu_torch.train`` run -> (its stdout
    lines, the key=value fields of its last ``[*] trained`` or ``[*]
    generated`` line, the wall seconds).  Raises if it fails or a display
    eval failed."""
    cmd = [sys.executable, "-m", "octfusion_tpu_torch.train", *argv]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=CLI_TIMEOUT)
    wall = time.perf_counter() - t0
    lines = res.stdout.splitlines()
    if res.returncode != 0:
        raise AssertionError(f"{label} failed ({res.returncode}):\n"
                             + "\n".join(lines[-20:])
                             + f"\n{res.stderr[-3000:]}")
    if any("display eval failed" in ln for ln in lines):
        raise AssertionError(f"{label}: a display eval failed:\n"
                             f"{res.stdout[-3000:]}")
    summary = [ln for ln in lines if ln.startswith(("[*] trained",
                                                    "[*] generated"))]
    if not summary:
        raise AssertionError(f"{label}: no summary line:\n"
                             + "\n".join(lines[-20:]))
    fields = dict(tok.split("=", 1) for tok in summary[-1].split()
                  if "=" in tok)
    print(f"cli {label}: wall_s={wall:.3f} | {summary[-1]}", flush=True)
    return lines, fields, wall


def run_recon_eval(root, cfg_path) -> dict:
    """``python -m octfusion_tpu_torch.tools.vae_recon_eval`` on phase
    19's VAE run: ``CLI_RECON_SHAPES`` held-out synthetic shapes at
    ``CLI_TRAIN_RESOLUTION``, scored by K4 -> its JSON line.  Raises unless
    it exits 0, keeps every shape and gives each a finite Chamfer
    distance."""
    cmd = [sys.executable, "-m", "octfusion_tpu_torch.tools.vae_recon_eval",
           "--config", cfg_path, "--run", os.path.join(root, "vae"),
           "--out", os.path.join(root, "recon"), "--count",
           str(CLI_RECON_SHAPES), "--resolution", str(CLI_TRAIN_RESOLUTION)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=CLI_TIMEOUT)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"vae_recon_eval failed ({res.returncode}):\n"
                             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    out = json.loads(res.stdout.splitlines()[-1])
    if (len(out["shapes"]) != CLI_RECON_SHAPES
            or not all(math.isfinite(cd) for cd in out["cd"])
            or out["chamfer_launches"] < 1):
        raise AssertionError(f"vae_recon_eval: {out}")
    print(f"cli vae_recon_eval: wall_s={wall:.3f} shapes={out['shapes']} "
          f"cd={out['cd']} chamfer_launches={out['chamfer_launches']}",
          flush=True)
    return out


def check_cli_launches(label, f) -> dict:
    """A training run's losses must be finite, K1 launches = GraphConv
    calls and K2 = K3 launches = graph-conv backward calls -> its K1 / K2
    / K3 launches."""
    for k in ("loss_first", "loss_last"):
        if not math.isfinite(float(f[k])):
            raise AssertionError(f"{label}: {k} = {f[k]}")
    got = {k: int(f[f"{k}_launches"]) for k in
           ("graph_conv_fwd", "graph_conv_col", "graph_conv_bwd_dx")}
    calls, bwd = int(f["graph_conv_calls"]), int(
        f["graph_conv_backward_calls"])
    if got["graph_conv_fwd"] != calls or not (
            got["graph_conv_col"] == got["graph_conv_bwd_dx"] == bwd):
        raise AssertionError(f"{label}: launches {got} vs GraphConv calls "
                             f"{calls} and backward calls {bwd}")
    return got


def nonempty_mesh(path) -> int:
    """-> the faces of the ``.obj`` at ``path``; raises if it has none."""
    with open(path) as fh:
        faces = sum(ln.startswith("f ") for ln in fh)
    if not faces:
        raise AssertionError(f"{path} has no face")
    return faces


def check_train_cli(seed) -> dict:
    """Phase 19: the training CLI at the reference-parity widths on a
    ShapeNet-format set: the VAE (then resumed), lr and hr stages
    (grafted, with the VAE as ``--vq_ckpt``), then generate mode of the
    union model and of the VAE, then the VAE's reconstruction Chamfer ->
    the runs' K1 / K2 / K3 / K4 launches."""
    from octfusion_tpu_torch.config import load_config
    from octfusion_tpu_torch.utils import ckpt
    from octfusion_tpu_torch.utils.shapes import write_shapenet_set

    t_phase = time.perf_counter()
    launches = dict.fromkeys(("graph_conv_fwd", "graph_conv_col",
                              "graph_conv_bwd_dx"), 0)
    with tempfile.TemporaryDirectory() as root:
        location, filelist = write_shapenet_set(
            os.path.join(root, "data"), CLI_DATA_SHAPES, CLI_DATA_POINTS,
            load_config(TRAIN_CONFIG).data.point_scale, seed)
        cfg_path = cli_config(root, location, filelist)
        base = ["--config", cfg_path, "--logs_dir", root, "--seed",
                str(seed)]
        vae_ckpt = os.path.join(root, "vae", "ckpt", "steps-latest")
        lr_ckpt = os.path.join(root, "lr", "ckpt", "steps-latest")
        runs = [
            ("vae train", ["--model", "vae", "--name", "vae",
                           "--batch_size", "2", "--max_steps", "3"]),
            ("vae resume", ["--model", "vae", "--name", "vae",
                            "--batch_size", "2", "--max_steps", "5"]),
            ("lr train", ["--model", "union", "--stage", "lr", "--name",
                          "lr", "--batch_size", "4", "--max_steps", "4"]),
            ("hr train", ["--model", "union", "--stage", "hr", "--name",
                          "hr", "--batch_size", "4", "--max_steps", "3",
                          "--vq_ckpt", vae_ckpt, "--pretrain_ckpt",
                          lr_ckpt]),
            ("hr generate", ["--model", "union", "--stage", "hr", "--name",
                             "hr", "--mode", "generate", "--count", "1",
                             "--sampler", "dpmpp", "--sample_steps",
                             str(DPMPP_STEPS), "--vq_ckpt", vae_ckpt]),
            ("vae generate", ["--model", "vae", "--name", "vae", "--mode",
                              "generate", "--count", "1"]),
        ]
        out = {}
        for label, argv in runs:
            out[label] = run_cli(label, base + argv)
            fields = out[label][1]
            if label.endswith("generate"):
                launches["graph_conv_fwd"] += int(
                    fields.get("graph_conv_fwd_launches", 0))
                continue
            for k, v in check_cli_launches(label, fields).items():
                launches[k] += v
        if not any("at step 3" in ln and ln.startswith("[*] resumed")
                   for ln in out["vae resume"][0]):
            raise AssertionError("the second VAE run did not resume at 3")
        if int(out["vae resume"][1]["steps"]) != 2:
            raise AssertionError("the resumed VAE run did not take 2 steps")
        if not any(ln.startswith("[*] grafted unet_lr")
                   for ln in out["hr train"][0]):
            raise AssertionError("the hr run grafted no unet_lr")
        # the graft (as the JAX package's train.py:219-234): the frozen
        # unet_lr is the lr run's, bit for bit, through hr training
        lr_tree = ckpt.restore(lr_ckpt)
        hr_tree = ckpt.restore(os.path.join(root, "hr", "ckpt",
                                            "steps-latest"))
        for k, v in lr_tree["df_unet_lr"].items():
            if not torch.equal(hr_tree["df_unet_lr"][k], v):
                raise AssertionError(f"hr run's unet_lr.{k} changed")
        if all(torch.equal(v, hr_tree["ema_df_unet_hr"][k])
               for k, v in hr_tree["df_unet_hr"].items()):
            raise AssertionError("the hr checkpoint's EMA is its live "
                                 "weights")
        recon = run_recon_eval(root, cfg_path)
        launches["chamfer"] = recon["chamfer_launches"]
        faces = {
            "vae display": nonempty_mesh(os.path.join(
                root, "vae", "train_temp", "recon_3.obj")),
            "hr display": nonempty_mesh(os.path.join(
                root, "hr", "train_temp", "sample_3.obj")),
            "hr generate": nonempty_mesh(os.path.join(
                root, "hr", "results_airplane", "0.obj")),
            "vae generate": nonempty_mesh(os.path.join(
                root, "vae", "results_airplane", "0.obj")),
        }
    for label in ("vae train", "vae resume", "lr train", "hr train"):
        f = out[label][1]
        print(f"cli {label}: ms_per_step={f['ms_per_step']} "
              f"data_s={f['data_s']} first_data_s={f['first_data_s']} "
              f"loss {f['loss_first']} -> "
              f"{f['loss_last']} wall_s={out[label][2]:.3f}", flush=True)
    print(f"cli meshes (faces): {faces}; phase 19 "
          f"{time.perf_counter() - t_phase:.1f} s; launches {launches}",
          flush=True)
    return launches


def config_3t():
    """The obja-3t-d10 configuration: the 3-stage model over the depth-10
    VAE and caps of ``CONFIG_3T``."""
    from octfusion_tpu_torch.config import load_config, with_vae

    return with_vae(*(load_config(p) for p in CONFIG_3T))


def lumpy_batch_3t(cfg, batch_size, seed):
    """``batch_size`` seeded lumpy spheres of ``data.points_per_shape``
    points on the card, at ``SHAPE_SCALE_3T`` of their size, so that
    they fit the Objaverse caps (at full size they overflow depth 6)."""
    from octfusion_tpu_torch.utils.shapes import lumpy_spheres

    pts, nrm = lumpy_spheres(batch_size, cfg.data.points_per_shape, seed,
                             device=torch.device("cuda"))
    return {"points": pts * SHAPE_SCALE_3T, "normals": nrm}


def split_small_3t(solver, seed):
    """The split grid [1, 16, 16, 16, 8] of a seeded lumpy sphere's octree
    (random lr weights give a grid about half full, which overflows the
    depth-5/6 caps)."""
    from octfusion_tpu_torch.models.common import batch_to_octree
    from octfusion_tpu_torch.octree import split_codec

    b = lumpy_batch_3t(solver.cfg, 1, seed)
    octree = batch_to_octree(b["points"], b["normals"], solver.spec1)
    if octree.overflow.any():
        raise AssertionError("the lumpy sphere overflows the 3-stage caps")
    return split_codec.octree2split_small(octree)


def count_packed_calls(nets):
    """Forward hooks counting the GraphConv calls on packed levels ->
    (the handles, a one-element counter)."""
    from octfusion_tpu_torch.nn.modules import GraphConv

    n = [0]

    def hook(mod, args, out):
        n[0] += bool(args[1].packed)

    return [mod.register_forward_hook(hook) for net in nets
            for mod in net.modules() if isinstance(mod, GraphConv)], n


def print_cascade_3t(label, out, wall, launches, calls) -> None:
    """A 3-stage cascade's stage seconds, launches, node counts per depth,
    overflow flags and peak memory."""
    octree = out["decode_out"]["octree_out"]
    peak = torch.cuda.max_memory_allocated()
    print(f"{label}: wall_s={wall:.3f} "
          + " ".join(f"{n}_s={v:.3f}" for n, v in out["seconds"].items())
          + f" k1_launches={launches['graph_conv_fwd']} k5_launches="
          f"{launches['graph_conv_fwd_packed']} graph_conv_calls={calls} "
          "nnum " + " ".join(f"d{d}={int(n)}" for d, n in
                             enumerate(octree.nnum.tolist()) if d >= 4)
          + f" overflow grow6={bool(out['overflow_small'])} grow8="
          f"{bool(out['overflow_large'])} decoded="
          f"{bool(out['decode_out']['graph_out'].any_overflow())} "
          f"per_depth={octree.overflow.int().tolist()} "
          f"peak_memory_bytes={peak} ({peak / 2**30:.2f} GiB)", flush=True)
    if not (torch.isfinite(out["code"]).all()
            and torch.isfinite(out["sdfs"]).all()):
        raise AssertionError(f"{label}: non-finite codes or SDF")


def train_setup_3t(cfg, solver, seed):
    """Phase 20(c)'s hr and feature trainers with ``solver``'s (perturbed)
    weights, their batch-2 batch, fixed draws, the batch's full-depth graph
    and the (level, C, C') of the convs of each step: the frozen encoder's
    (K1) and the diffusion U-Nets' (K1, K2, K3)."""
    from octfusion_tpu_torch.models.union_3t_solver import Union3TSolver

    dev = torch.device("cuda")
    b = cfg.data.batch_size
    batch = lumpy_batch_3t(cfg, b, seed + 22)
    gen = torch.Generator(device=dev).manual_seed(seed + 23)
    trainers, draws = {}, {}
    for stage in ("hr", "feature"):
        t = Union3TSolver(cfg, stage, device=dev)
        t.df.load_state_dict({k: v for k, v in solver.df.state_dict().items()
                              if getattr(t.df, k.split(".")[0]) is not None})
        t.vae.load_state_dict(solver.vae.state_dict())
        shape = t.train_shape(b)
        draws[stage] = {"times": torch.rand(b, device=dev, generator=gen),
                        "noise": torch.randn(shape, device=dev,
                                             generator=gen)}
        if stage == "feature":
            draws[stage]["eps"] = torch.randn(shape, device=dev,
                                              generator=gen)
        trainers[stage] = t
    g = trainers["feature"].batch_graph(batch)
    print_graph("3t train", g)
    enc, df = set(), set()
    hooks = (conv_shape_hooks([trainers["feature"].vae], enc)
             + conv_shape_hooks([t.df for t in trainers.values()], df))
    with torch.no_grad():
        for stage, t in trainers.items():
            t.loss_fn(batch, **draws[stage])
    for h in hooks:
        h.remove()
    return trainers, batch, draws, g, enc, df


def check_train_3t(cfg, trainers, batch, draws, seed):
    """Phase 20(c): per stage, one step card vs CPU (both deterministic)
    from the same weights and draws, then ``TRAIN_STEPS_3T`` steps on the
    card; the frozen U-Nets stay bit for bit -> the steps' launches."""
    from octfusion_tpu_torch.models.union_3t_solver import Union3TSolver
    from octfusion_tpu_torch.models.union_solver import FROZEN

    launches = {}
    for stage, card in trainers.items():
        cpu = Union3TSolver(cfg, stage, device="cpu")
        cpu.df.load_state_dict(card.df.state_dict())
        cpu.vae.load_state_dict(card.vae.state_dict())
        runs = {}
        torch.use_deterministic_algorithms(True)
        try:
            for name, sol in (("card", card), ("cpu", cpu)):
                sol.df.train()
                for kind in FROZEN[stage]:
                    getattr(sol.df, f"unet_{kind}").requires_grad_(False)
                runs[name] = timed_step(sol.df, lambda: sol.loss_fn(
                    to_device(batch, sol.device),
                    **to_device(draws[stage], sol.device)))
        finally:
            torch.use_deterministic_algorithms(False)
        compare_steps(f"3t {stage}_step", runs, f"unet_{stage}.",
                      batch_size=batch["points"].shape[0])
        del cpu, runs
        frozen = {n: p.detach().clone() for n, p in
                  card.df.named_parameters()
                  if not n.startswith(f"unet_{stage}.")}
        got = run_steps(f"3t {stage} train", card.make_train_step(), batch,
                        TRAIN_STEPS_3T, True, **draws[stage])
        for n, p in card.df.named_parameters():
            if n in frozen and not torch.equal(p, frozen[n]):
                raise AssertionError(f"3t {stage}: frozen {n} changed")
        print(f"3t {stage} train: frozen "
              f"{sorted({n.split('.')[0] for n in frozen})} bit for bit",
              flush=True)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    return launches


def check_cli_3t(cfg, solver, seed) -> dict:
    """Phase 20(d): ``python -m octfusion_tpu_torch.train --model
    union_3t``: lr, hr grafted from it, feature grafted from the hr run
    with a seeded depth-10 VAE as ``--vq_ckpt``, then generate (dpmpp-25)
    -> the runs' K1 / K2 / K3 launches."""
    from octfusion_tpu_torch.config import dump_config
    from octfusion_tpu_torch.utils import ckpt
    from octfusion_tpu_torch.utils.shapes import write_shapenet_set

    t_phase = time.perf_counter()
    launches = dict.fromkeys(("graph_conv_fwd", "graph_conv_col",
                              "graph_conv_bwd_dx"), 0)
    with tempfile.TemporaryDirectory() as root:
        # files hold points times data.point_scale: these read back at
        # SHAPE_SCALE_3T of the spheres' size
        location, filelist = write_shapenet_set(
            os.path.join(root, "data"), CLI_3T_SHAPES, CLI_DATA_POINTS,
            cfg.data.point_scale * SHAPE_SCALE_3T, seed)
        cfg_path = os.path.join(root, "config.yaml")
        dump_config(dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, location=location,
                                          filelist=filelist),
            train=dataclasses.replace(cfg.train, print_freq=1,
                                      save_latest_freq=CLI_3T_STEPS,
                                      display_freq=0),
            solver=dataclasses.replace(cfg.solver,
                                       resolution=CLI_TRAIN_RESOLUTION)),
            cfg_path)
        vae_path = ckpt.save(
            os.path.join(root, "vae10"),
            {"autoencoder": {n: v.cpu() for n, v in
                             solver.vae.state_dict().items()}}, step=0)
        ck = lambda name: os.path.join(root, name, "ckpt", "steps-latest")
        base = ["--config", cfg_path, "--logs_dir", root, "--seed",
                str(seed), "--model", "union_3t"]
        steps = ["--max_steps", str(CLI_3T_STEPS)]
        runs = [
            ("3t lr train", ["--stage", "lr", "--name", "lr", *steps]),
            ("3t hr train", ["--stage", "hr", "--name", "hr", *steps,
                             "--pretrain_ckpt", ck("lr")]),
            ("3t feature train", ["--stage", "feature", "--name", "feat",
                                  *steps, "--vq_ckpt", vae_path,
                                  "--pretrain_ckpt", ck("hr")]),
            ("3t feature generate", ["--stage", "feature", "--name", "feat",
                                     "--mode", "generate", "--count", "1",
                                     "--sampler", "dpmpp", "--sample_steps",
                                     str(DPMPP_STEPS), "--vq_ckpt",
                                     vae_path]),
        ]
        out = {}
        for label, argv in runs:
            out[label] = run_cli(label, base + argv)
            fields = out[label][1]
            if label.endswith("generate"):
                launches["graph_conv_fwd"] += int(
                    fields.get("graph_conv_fwd_launches", 0))
                continue
            for k, v in check_cli_launches(label, fields).items():
                launches[k] += v
        for kind in ("lr", "hr"):
            if not any(ln.startswith(f"[*] grafted unet_{kind}")
                       for ln in out["3t feature train"][0]):
                raise AssertionError(f"the feature run grafted no "
                                     f"unet_{kind}")
        trees = {n: ckpt.restore(ck(n)) for n in ("hr", "feat")}
        feat = trees["feat"]
        if not {"df_unet_feature", "ema_df_unet_feature"} <= set(feat):
            raise AssertionError(f"feature checkpoint keys {sorted(feat)}")
        if all(torch.equal(v, feat["ema_df_unet_feature"][k])
               for k, v in feat["df_unet_feature"].items()):
            raise AssertionError("the feature checkpoint's EMA is its live "
                                 "weights")
        for kind in ("lr", "hr"):
            for k, v in trees["hr"][f"df_unet_{kind}"].items():
                if not torch.equal(feat[f"df_unet_{kind}"][k], v):
                    raise AssertionError(f"the feature run's unet_{kind}.{k}"
                                         " is not the hr run's")
        faces = nonempty_mesh(os.path.join(root, "feat", "results_airplane",
                                           "0.obj"))
    for label in ("3t lr train", "3t hr train", "3t feature train"):
        f = out[label][1]
        print(f"cli {label}: ms_per_step={f['ms_per_step']} "
              f"data_s={f['data_s']} loss {f['loss_first']} -> "
              f"{f['loss_last']} wall_s={out[label][2]:.3f}", flush=True)
    print(f"cli 3t: feature checkpoint holds df_unet_feature and its EMA; "
          f"generated mesh faces={faces}; phase 20(d) "
          f"{time.perf_counter() - t_phase:.1f} s; launches {launches}",
          flush=True)
    return launches


def check_three_stage(seed, steps):
    """Phase 20: the 3-stage solver at the obja-3t-d10 configuration ->
    ({kernel: KernelStats} at its shapes, {kernel: launches} of its
    counted runs)."""
    from octfusion_tpu_torch.models.union_3t_solver import Union3TSolver
    from octfusion_tpu_torch.nn.modules import GraphConv
    from octfusion_tpu_torch.ops import graph_conv_cuda as k

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = config_3t()
    torch.manual_seed(seed)
    solver = Union3TSolver(cfg, device=dev)
    # the zero-initialised output convs would make split_large all zero,
    # which grows nothing below depth 6
    perturb_([solver.df, solver.vae], torch.Generator().manual_seed(seed + 20))
    split = split_small_3t(solver, seed)
    gen = torch.Generator(device=dev)

    # ---- (a) the kernels at the sampling and training shapes -----------
    shapes = set()
    hooks = conv_shape_hooks([solver.df, solver.vae], shapes)
    warm = solver.sample(steps=2, split_small=split, kpack=False,
                         compute_sdf=False,
                         generator=gen.manual_seed(seed + 1))
    for h in hooks:
        h.remove()
    g_dec = warm["decode_out"]["graph_out"]
    print_graph("3t warm-up decode", g_dec, allow_overflow=True)
    kgen = torch.Generator(device=dev).manual_seed(seed + 21)
    measured = check_kernels(g_dec, shapes, kgen, K1)
    measured["graph_conv_fwd"].summary("k1 phase 20 (3-stage sampling)")
    measured.update(check_kernels(
        warm["graph"], {sh for sh in shapes if sh[0] <= solver.code_depth},
        kgen, K5))
    check_packed_autograd(warm["graph"], kgen)
    measured["graph_conv_fwd_packed"].summary("k5 phase 20 (3-stage "
                                              "sampling)")
    del warm, g_dec
    trainers, batch, draws, g_train, enc, df = train_setup_3t(cfg, solver,
                                                              seed)
    k1_train = check_kernels(g_train, enc | df, kgen, K1)["graph_conv_fwd"]
    k1_train.summary("k1 phase 20 (3-stage training)")
    measured["graph_conv_fwd"].merge(k1_train)
    measured.update(check_kernels(g_train, df, kgen, K2K3))
    for name, label in (("graph_conv_col", "k2 phase 20 (3-stage training)"),
                        ("graph_conv_bwd_dx",
                         "k3 phase 20 (3-stage training)")):
        measured[name].summary(label)
    del g_train

    # ---- (b) the 3-hop cascade, then dpmpp-25 with K5 ------------------
    launches = dict.fromkeys(measured, 0)
    for sampler_name, kpack, n in (("ancestral", False, steps),
                                   ("dpmpp", True, DPMPP_STEPS)):
        run = solver
        if sampler_name == "dpmpp":
            run = Union3TSolver(dataclasses.replace(
                cfg, diffusion=dataclasses.replace(cfg.diffusion,
                                                   sampler="dpmpp")),
                device=dev)
            run.df.load_state_dict(solver.df.state_dict())
            run.vae.load_state_dict(solver.vae.state_dict())
        hooks, packed = count_packed_calls([run.df, run.vae])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k.reset_launches()
        GraphConv.calls = 0
        t0 = time.perf_counter()
        out = run.sample(steps=n, split_small=split, resolution=RESOLUTION,
                         kpack=kpack, generator=gen.manual_seed(seed))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got, calls = dict(k.launches), GraphConv.calls
        for h in hooks:
            h.remove()
        label = f"3t cascade {sampler_name} {n}+{n}+{n} kpack={kpack}"
        print_cascade_3t(label, out, wall, got, calls)
        print(f"{label}: graph_conv_calls_on_packed_levels={packed[0]}",
              flush=True)
        if kpack:
            ok = (got["graph_conv_fwd_packed"] == packed[0] > 0
                  and got["graph_conv_fwd"] == calls - packed[0] > 0)
        else:
            ok = got["graph_conv_fwd"] == calls > 0
            print_graph("3t decode", out["decode_out"]["graph_out"],
                        allow_overflow=True)
        if not ok:
            raise AssertionError(f"{label}: launches {got} vs {calls} "
                                 f"GraphConv calls, {packed[0]} packed")
        for name in launches:
            launches[name] += got[name]
        del out, run

    # ---- (c) the train steps -----------------------------------------
    add_launches(launches, check_train_3t(cfg, trainers, batch, draws, seed))
    del trainers

    # ---- (d) the CLI --------------------------------------------------
    add_launches(launches, check_cli_3t(cfg, solver, seed))
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s; launches "
          f"{launches}", flush=True)
    return measured, launches


# ----------------------------------------------------------------------
# phase 21: the colour VAE
# ----------------------------------------------------------------------
def color_setup(seed):
    """The colour VAE of ``configs/vae_snet_color.yaml`` on the card ->
    (solver, config, the batch-2 batch with ``point_colors``, eps, its
    graph, the (level, C, C') of every graph conv of a train step)."""
    from octfusion_tpu_torch.config import load_config
    from octfusion_tpu_torch.models.common import batch_to_graph
    from octfusion_tpu_torch.models.vae_solver import VAESolver
    from octfusion_tpu_torch.utils.shapes import lumpy_sphere_batch

    dev = torch.device("cuda")
    cfg = load_config(COLOR_CONFIG)
    torch.manual_seed(seed)
    solver = VAESolver(cfg, device=dev)
    batch = lumpy_sphere_batch(VAE_BATCH, cfg.data.points_per_shape,
                               cfg.data.point_sample_num, seed + 30,
                               device=dev, colors=True)
    eps = torch.randn(solver.code_shape(VAE_BATCH), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(
                          seed + 31))
    g = batch_to_graph(batch["points"], batch["normals"], solver.spec1,
                       solver.edge_factor,
                       features=batch["point_colors"])[1]
    print_graph("color vae", g)
    shapes = set()
    hooks = conv_shape_hooks([solver.vae], shapes)
    with torch.no_grad():
        solver.vae(g, g, eps=eps)
    for h in hooks:
        h.remove()
    return solver, cfg, batch, eps, g, shapes


def check_color_vae(seed):
    """Phase 21: the colour VAE at full width -> (K1 / K2 / K3
    measurements at its training shapes, the launches of its training
    run, reconstruction and CLI run)."""
    from octfusion_tpu_torch.config import load_config
    from octfusion_tpu_torch.nn.modules import GraphConv
    from octfusion_tpu_torch.ops import graph_conv_cuda as k
    from octfusion_tpu_torch.utils.shapes import write_shapenet_set

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    solver, cfg, batch, eps, g, shapes = color_setup(seed)
    m = cfg.model
    # (a) the kernels at every (level, C, C') of the step; conv1 reads
    # 4 ND + 3 RGB + 7 node-type channels, not a multiple of 4
    conv1 = (m.depth, m.channel_in + m.depth - 1, m.channels[m.depth])
    if conv1 not in shapes or conv1[1] % 4 == 0:
        raise AssertionError(f"colour conv1 shape {conv1} not in {shapes}")
    gen = torch.Generator(device=dev).manual_seed(seed + 32)
    measured = {**check_kernels(g, shapes, gen, K1),
                **check_kernels(g, shapes, gen, K2K3)}
    for name, label in (("graph_conv_fwd", "k1 phase 21 (colour vae)"),
                        ("graph_conv_col", "k2 phase 21 (colour vae)"),
                        ("graph_conv_bwd_dx", "k3 phase 21 (colour vae)")):
        measured[name].summary(label)
    del g
    # (b) one step card vs CPU, then COLOR_TRAIN_STEPS steps
    check_vae_step(solver, cfg, batch, seed + 33, label="color_vae_step")
    colour_terms = tuple(f"color_loss_{d}"
                         for d in range(m.depth_stop, m.depth_out + 1))
    launches = run_steps("color vae train", solver.make_train_step(), batch,
                         COLOR_TRAIN_STEPS, True, falling=colour_terms,
                         eps=eps)
    launches = {name: launches[name] for name in measured}
    # (c) reconstruction of the 2 shapes
    k.reset_launches()
    GraphConv.calls = 0
    sdfs, out = solver.reconstruct(batch)
    rec, calls = k.launches["graph_conv_fwd"], GraphConv.calls
    cols = out["colors"][m.depth_out][m.depth_out]
    print("color vae reconstruct: " + " ".join(
        f"{n}_s={v:.3f}" for n, v in out["seconds"].items())
        + f" resolution={sdfs.shape[1]} k1_launches={rec} graph_conv_calls="
        f"{calls} colors d{m.depth_out} shape={tuple(cols.shape)} "
        f"min={cols.min().item():.4f} max={cols.max().item():.4f}",
        flush=True)
    want = (VAE_BATCH,) + (cfg.solver.resolution,) * 3
    if (tuple(sdfs.shape) != want or not torch.isfinite(sdfs).all()
            or not torch.isfinite(cols).all() or not rec == calls > 0):
        raise AssertionError(f"colour reconstruct: sdf {tuple(sdfs.shape)}"
                             f" (want {want}), launches {rec} vs {calls}")
    launches["graph_conv_fwd"] += rec
    del sdfs, out, solver
    # (d) the train CLI on a ShapeNet-format set with color.npz
    with tempfile.TemporaryDirectory() as root:
        location, filelist = write_shapenet_set(
            os.path.join(root, "data"), COLOR_CLI_SHAPES, CLI_DATA_POINTS,
            load_config(COLOR_CONFIG).data.point_scale, seed, colors=True)
        cfg_path = cli_config(root, location, filelist, base=COLOR_CONFIG)
        lines, f, _ = run_cli("color vae train", [
            "--model", "vae", "--name", "cvae", "--config", cfg_path,
            "--logs_dir", root, "--seed", str(seed), "--batch_size",
            str(VAE_BATCH), "--max_steps", str(COLOR_CLI_STEPS)])
        if not any(f"color_loss_{m.depth_out}" in ln for ln in lines):
            raise AssertionError("the colour CLI printed no colour loss")
        add_launches(launches, check_cli_launches("color vae train", f))
    print(f"phase 21: {time.perf_counter() - t_phase:.1f} s; launches "
          f"{launches}", flush=True)
    return measured, launches


# ----------------------------------------------------------------------
# phase 22: data parallelism on the one card
# ----------------------------------------------------------------------
def _digests(tensors):
    """[n, 2] int64 digests of a list of float32 tensors (the sum of the
    bit patterns, and of the bit patterns weighted by position): equal
    digests on two ranks mean equal bits, but for a collision."""
    out = []
    for t in tensors:
        bits = t.detach().contiguous().view(torch.int32).reshape(-1).long()
        pos = torch.arange(1, bits.numel() + 1, device=bits.device)
        out.append(torch.stack([bits.sum(), (bits * pos).sum()]))
    return torch.stack(out)


def _same_on_every_rank(tensors) -> bool:
    import torch.distributed as tdist

    mine = _digests(tensors).cpu()     # gloo gathers host tensors only
    every = [torch.empty_like(mine) for _ in range(tdist.get_world_size())]
    tdist.all_gather(every, mine)
    return all(torch.equal(every[0], d) for d in every[1:])


def _replay(make_solver, net_of, shards, draws, make_step):
    """The one-process replay of a DP step: each shard's loss and backward
    with its draws, the gradients averaged, one optimizer (and EMA) step
    -> (the step, the mean loss, the per-shard ms)."""
    solver = make_solver()
    step = make_step(solver)
    net = net_of(solver)
    net.train()
    grads, losses, walls = None, [], []
    for shard, kw in zip(shards, draws):
        step.optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = solver.loss_fn(shard, **kw)
        loss.backward()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.detach())
        g = {n: p.grad.clone() for n, p in net.named_parameters()
             if p.grad is not None}
        grads = g if grads is None else {n: grads[n] + v
                                         for n, v in g.items()}
    for n, p in net.named_parameters():
        if n in grads:
            p.grad = grads[n] / len(shards)
    step.apply_gradients()
    return step, torch.stack(losses).mean().item(), walls


def _compare_replay(label, out, net, step, replay, replay_loss):
    """A DP step's loss, parameters (and EMA) against the replay's, at
    phase 7's tolerances -> the worst share of the tolerance."""
    torch.testing.assert_close(torch.tensor(float(out["loss"])),
                               torch.tensor(replay_loss), **TOL_STEP)
    rnet = dict(replay.solver.vae.named_parameters()
                if label.startswith("vae") else
                replay.solver.df.named_parameters())
    share = 0.0
    pairs = [(n, p, rnet[n]) for n, p in net.named_parameters()]
    pairs += [(f"ema {n}", e, replay.ema[n])
              for n, e in getattr(step, "ema", {}).items()]
    for n, a, b in pairs:
        torch.testing.assert_close(a, b, **TOL_STEP, msg=f"{label} {n}")
        share = max(share, ((a - b).abs() / (TOL_STEP["atol"] + TOL_STEP[
            "rtol"] * b.abs())).max().item())
    return share


def _dp_rank(rank, path):
    """One of phase 22(a)/(b)'s two ranks (gloo, both on cuda:0, under
    deterministic algorithms): the hr DP step at global batch 4 and the
    VAE's on the query axis; rank 0 replays each in one process -> this
    rank's report."""
    from octfusion_tpu_torch.config import load_config
    from octfusion_tpu_torch.models.union_solver import UnionSolver
    from octfusion_tpu_torch.models.vae_solver import VAESolver
    from octfusion_tpu_torch.ops import graph_conv_cuda as k
    from octfusion_tpu_torch.parallel import dist as pdist
    from octfusion_tpu_torch.parallel import train_step as pts
    from octfusion_tpu_torch.parallel.mesh import make_mesh
    from octfusion_tpu_torch.utils.device import use_fp32_math

    dev = pdist.local_device("cuda")
    torch.cuda.set_device(dev)
    use_fp32_math()
    torch.use_deterministic_algorithms(True)
    inp = torch.load(path, weights_only=False)
    cfg = load_config(TRAIN_CONFIG)
    res = {"device": str(dev)}
    k.reset_launches()

    def hr_solver():
        s = UnionSolver(cfg, device=dev)
        s.df.load_state_dict(inp["df"])
        s.vae.load_state_dict(inp["vae"])
        return s

    def vae_solver():
        s = VAESolver(cfg, device=dev)
        s.vae.load_state_dict(inp["vae"])
        return s

    for label, mesh, make, net_of, vae in (
            ("hr", make_mesh(2, 1), hr_solver, lambda s: s.df, False),
            ("vae", make_mesh(1, 2), vae_solver, lambda s: s.vae, True)):
        batch = to_device(inp[f"{label}_batch"], dev)
        draws = [to_device(d, dev) for d in inp[f"{label}_draws"]]
        solver = make()
        step = (pts.make_vae_dp_train_step(solver, mesh, 100) if vae
                else pts.make_union_dp_train_step(solver, mesh))
        net = net_of(solver)
        out = step(pts.shard_batch(batch, mesh, vae, rank), **draws[rank])
        torch.cuda.synchronize()
        same = _same_on_every_rank(
            list(net.parameters()) + list(getattr(step, "ema", {}).values()))
        rep = {"loss": float(out["loss"]), "identical": same}
        if rank == 0:
            shards = [pts.shard_batch(batch, mesh, vae, r) for r in range(2)]
            counted = dict(k.launches)     # the replay's do not count
            replay, loss, walls = _replay(
                make, net_of, shards, draws,
                (lambda s: s.make_train_step(100)) if vae
                else (lambda s: s.make_train_step()))
            rep["share_of_tol"] = _compare_replay(label, out, net, step,
                                                  replay, loss)
            rep["replay_loss"] = loss
            rep["single_ms"] = statistics.median(walls)
            k.launches.update(counted)
            del replay
        pdist.barrier()
        # timing: DP_TIMED_STEPS more steps (the ranks share the card), and
        # the profiled one below
        walls = []
        for _ in range(DP_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(pts.shard_batch(batch, mesh, vae, rank), **draws[rank])
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        rep.update(dp_ms=statistics.median(walls),
                   allreduce_bytes=step.sync.bytes,
                   allreduce_ms=statistics.median(step.sync.seconds) * 1e3)
        if rank == 0:
            rep["idle_share"] = _idle_share(lambda: step(
                pts.shard_batch(batch, mesh, vae, rank), **draws[rank]))
        else:
            step(pts.shard_batch(batch, mesh, vae, rank), **draws[rank])
        res[label] = rep
        del solver, step, net
        torch.cuda.empty_cache()
    res["launches"] = dict(k.launches)
    torch.use_deterministic_algorithms(False)
    return res


def _idle_share(fn) -> float:
    """1 - (the device time of this process's kernels and copies in one
    call of ``fn``) / (the call's wall time): the share of the call in
    which this process left the card idle (the other rank's kernels on
    the shared card are not in its trace)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.device_time_total for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e6
    return 1.0 - busy / wall if busy > 0 else float("nan")


def dp_inputs(seed, path):
    """Phase 22(a)/(b)'s weights (the snet config's, perturbed), batches
    and each rank's draws, saved to ``path``."""
    from octfusion_tpu_torch.config import load_config
    from octfusion_tpu_torch.models.union_solver import UnionSolver
    from octfusion_tpu_torch.utils.shapes import (lumpy_sphere_batch,
                                                  lumpy_spheres)

    cfg = load_config(TRAIN_CONFIG)
    torch.manual_seed(seed)
    s = UnionSolver(cfg, device="cpu")
    perturb_([s.df, s.vae], torch.Generator().manual_seed(seed + 40))
    b = cfg.data.batch_size
    pts, nrm = lumpy_spheres(b, cfg.data.points_per_shape, seed + 41)
    gen = torch.Generator().manual_seed(seed + 42)
    shape = s.code_shape(b // 2)
    hr_draws = [{"eps": torch.randn(shape, generator=gen),
                 "times": torch.rand(b // 2, generator=gen),
                 "noise": torch.randn(shape, generator=gen)}
                for _ in range(2)]
    vbatch = lumpy_sphere_batch(VAE_BATCH, cfg.data.points_per_shape,
                                cfg.data.point_sample_num, seed + 43)
    vshape = s.code_shape(VAE_BATCH)
    torch.save({"df": s.df.state_dict(), "vae": s.vae.state_dict(),
                "hr_batch": {"points": pts, "normals": nrm},
                "hr_draws": hr_draws, "vae_batch": vbatch,
                "vae_draws": [{"eps": torch.randn(vshape, generator=gen)}
                              for _ in range(2)]}, path)


def run_torchrun(label, nproc, argv, env=None):
    """``python -m torch.distributed.run --standalone --nproc_per_node
    nproc -m octfusion_tpu_torch.train argv`` -> (its stdout lines, the
    key=value fields of each rank's summary line, wall seconds).  Raises
    if it fails or a rank did not announce its place in the group."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), "-m", "octfusion_tpu_torch.train",
           *argv]
    t0 = time.perf_counter()
    # its own session, so that a timeout kills the ranks with the launcher
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True,
                            env={**os.environ, **(env or {})})
    try:
        stdout, stderr = proc.communicate(timeout=CLI_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        raise
    wall = time.perf_counter() - t0
    lines = stdout.splitlines()
    if proc.returncode != 0:
        raise AssertionError(f"{label} failed ({proc.returncode}):\n"
                             + "\n".join(lines[-20:])
                             + f"\n{stderr[-3000:]}")
    joined = [ln for ln in lines if ln.startswith("[*] rank ")]
    if len(joined) != nproc:
        raise AssertionError(f"{label}: {len(joined)} ranks announced, want "
                             f"{nproc}:\n" + "\n".join(lines[-20:]))
    summary = [ln for ln in lines if ln.startswith(("[*] trained",
                                                    "[*] generated"))]
    fields = [dict(tok.split("=", 1) for tok in ln.split() if "=" in tok)
              for ln in summary]
    print(f"cli {label}: wall_s={wall:.3f} | " + " | ".join(joined)
          + "".join(f" | {ln}" for ln in summary), flush=True)
    return lines, fields, wall


def _same_meshes(dir_a, dir_b, names) -> str:
    """Whether the meshes ``names`` in two directories are the same bytes,
    or else the same faces with vertices within K1's tolerance; raises
    otherwise -> "bit-identical" or the largest vertex difference."""
    from octfusion_tpu_torch.utils import mesh as mesh_utils

    worst = 0.0
    for n in names:
        a, b = os.path.join(dir_a, n), os.path.join(dir_b, n)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            if fa.read() == fb.read():
                continue
        va, fa_ = mesh_utils.load_obj(a)
        vb, fb_ = mesh_utils.load_obj(b)
        if va.shape != vb.shape or not np.array_equal(fa_, fb_):
            raise AssertionError(f"{n}: the striped run's mesh differs in "
                                 "topology from one rank's")
        worst = max(worst, float(np.abs(va - vb).max()))
        if worst > TOL_KERNEL["atol"]:
            raise AssertionError(f"{n}: vertices differ by {worst:.3e}")
    return "bit-identical" if worst == 0 else f"max_vertex_diff={worst:.3e}"


def check_data_parallel(seed):
    """Phase 22: data parallelism on the one card -> the launches of its
    main-path runs (the DP steps, the torchrun CLI runs, striped
    generation, the sharded evaluation)."""
    from octfusion_tpu_torch.config import load_config
    from octfusion_tpu_torch.metrics.distances import pairwise_cd_emd
    from octfusion_tpu_torch.models.union_solver import UnionSolver
    from octfusion_tpu_torch.ops import chamfer_cuda
    from octfusion_tpu_torch.parallel import launch
    from octfusion_tpu_torch.train import main as train_main
    from octfusion_tpu_torch.train import restore_training
    from octfusion_tpu_torch.utils import ckpt
    from octfusion_tpu_torch.utils.shapes import write_shapenet_set

    t_phase = time.perf_counter()
    launches = dict.fromkeys(("graph_conv_fwd", "graph_conv_col",
                              "graph_conv_bwd_dx", "graph_conv_fwd_packed",
                              "chamfer"), 0)
    with tempfile.TemporaryDirectory() as root:
        # (a) + (b): two gloo ranks on cuda:0
        path = os.path.join(root, "dp_inputs.pt")
        dp_inputs(seed, path)
        torch.cuda.empty_cache()   # the ranks share the card with this one
        t0 = time.perf_counter()
        ranks = launch.spawn(_dp_rank, 2, args=(path,), backend="gloo",
                             device="cuda", timeout=DP_TIMEOUT)
        wall = time.perf_counter() - t0
        for label in ("hr", "vae"):
            r0, r1 = ranks[0][label], ranks[1][label]
            if not (r0["identical"] and r1["identical"]):
                raise AssertionError(f"dp {label}: the ranks' parameters "
                                     "differ")
            if r0["loss"] != r1["loss"]:
                raise AssertionError(f"dp {label}: the ranks' averaged "
                                     f"losses differ: {r0['loss']} vs "
                                     f"{r1['loss']}")
            print(f"dp {label} step (2 gloo ranks on {ranks[0]['device']}, "
                  f"{'data 1 x model 2' if label == 'vae' else 'data 2'}):"
                  f" loss={r0['loss']:.6f} replay_loss="
                  f"{r0['replay_loss']:.6f} params_and_ema_vs_replay "
                  f"share_of_tol={r0['share_of_tol']:.3f} tol=rtol "
                  f"{TOL_STEP['rtol']:g} atol {TOL_STEP['atol']:g} "
                  f"ranks_identical=True dp_step_ms={r0['dp_ms']:.3f} "
                  f"(median of {DP_TIMED_STEPS}, both ranks on one card) "
                  f"single_process_shard_ms={r0['single_ms']:.3f} "
                  f"(forward + backward of one rank's shard) allreduce_bytes="
                  f"{r0['allreduce_bytes']} allreduce_ms="
                  f"{r0['allreduce_ms']:.3f} idle_share_rank0="
                  f"{r0['idle_share']:.3f}", flush=True)
        for r in ranks:
            add_launches(launches, r["launches"])
        print(f"phase 22(a,b): {wall:.1f} s; launches "
              f"{[r['launches'] for r in ranks]}", flush=True)
        # (c) the train CLI under torchrun, one rank (NCCL)
        location, filelist = write_shapenet_set(
            os.path.join(root, "data"), CLI_DATA_SHAPES, CLI_DATA_POINTS,
            load_config(TRAIN_CONFIG).data.point_scale, seed)
        cfg_path = cli_config(root, location, filelist)
        base = ["--config", cfg_path, "--logs_dir", root, "--seed",
                str(seed)]
        lines, fields, _ = run_torchrun("torchrun hr train", 1, base + [
            "--model", "union", "--stage", "hr", "--name", "hr",
            "--batch_size", "4", "--max_steps", str(DP_CLI_STEPS)])
        if "(nccl)" not in " ".join(lines):
            raise AssertionError("the torchrun CLI did not join over NCCL")
        add_launches(launches, check_cli_launches("torchrun hr train",
                                                  fields[-1]))
        hr_ckpt = os.path.join(root, "hr", "ckpt", "steps-latest")
        plain = UnionSolver(load_config(cfg_path), device="cuda")
        step = plain.make_train_step()
        restore_training(step, ckpt.restore(hr_ckpt))
        if step.step != DP_CLI_STEPS:
            raise AssertionError(f"the torchrun checkpoint is at step "
                                 f"{step.step}")
        del plain, step
        # (d) striped generation: 2 gloo ranks on the card vs one process
        gen = ["--model", "union", "--stage", "hr", "--mode", "generate",
               "--count", str(CLI_SHAPES), "--sampler", "dpmpp",
               "--sample_steps", str(DPMPP_STEPS), "--ckpt", hr_ckpt]
        kpack = {"OCTFUSION_CONV_KPACK": "1"}
        lines, fields, _ = run_torchrun(
            "striped generate (2 ranks)", 2, base + gen + ["--name", "gen2"],
            env=kpack)
        if " ".join(lines).count("(gloo)") != 2:
            raise AssertionError("the 2 ranks sharing the card did not both "
                                 "join over gloo")
        for f in fields:
            for name in ("graph_conv_fwd", "graph_conv_fwd_packed"):
                launches[name] += int(f.get(f"{name}_launches", 0))
        if not sum(int(f.get("graph_conv_fwd_packed_launches", 0))
                   for f in fields):
            raise AssertionError("striped generation launched no K5")
        # the reference: the same CLI in this process (no process group);
        # its launches are not counted
        os.environ.update(kpack)
        t0 = time.perf_counter()
        try:
            train_main(base + gen + ["--name", "gen1"])
        finally:
            del os.environ["OCTFUSION_CONV_KPACK"]
        print(f"generate (1 process): wall_s={time.perf_counter() - t0:.3f}",
              flush=True)
        names = [f"{i}.obj" for i in range(CLI_SHAPES)]
        dirs = [os.path.join(root, n, "results_airplane")
                for n in ("gen2", "gen1")]
        for d in dirs:
            if sorted(os.listdir(d)) != names:
                raise AssertionError(f"{d} holds {sorted(os.listdir(d))}")
        print(f"striped generation: {CLI_SHAPES} shapes, 2 ranks vs 1 "
              f"process: {_same_meshes(*dirs, names)}", flush=True)
    # (e) the sharded evaluation: rows of each tile over two devices
    dev = torch.device("cuda")
    gen_c = torch.Generator(device=dev).manual_seed(seed + 44)
    a = torch.rand(DP_EVAL_SETS, EVAL_POINTS, 3, device=dev,
                   generator=gen_c) - 0.5
    b = torch.rand(DP_EVAL_SETS, EVAL_POINTS, 3, device=dev,
                   generator=gen_c) - 0.5
    cd1, em1 = pairwise_cd_emd(a, b, EVAL_BATCH, True, EVAL_ROW_BLOCK)
    chamfer_cuda.reset_launches()
    t0 = time.perf_counter()
    cd2, em2 = pairwise_cd_emd(a, b, EVAL_BATCH, True, EVAL_ROW_BLOCK,
                               shard_devices=["cuda:0", "cuda:0"])
    t_shard = time.perf_counter() - t0
    launches["chamfer"] += chamfer_cuda.launches["chamfer"]
    if not (np.array_equal(cd1, cd2) and np.array_equal(em1, em2)):
        raise AssertionError("the sharded matrices differ from the "
                             "unsharded ones")
    print(f"sharded eval: {DP_EVAL_SETS} x {DP_EVAL_SETS} pairs over "
          f"['cuda:0', 'cuda:0'] bit-identical to unsharded, wall_s="
          f"{t_shard:.3f} k4_launches={chamfer_cuda.launches['chamfer']}",
          flush=True)
    print(f"phase 22: {time.perf_counter() - t_phase:.1f} s; launches "
          f"{launches}", flush=True)
    return launches


# phase 23: shading FID

def check_shading_fid(seed) -> None:
    """Phase 23: ``python -m octfusion_tpu_torch.evaluate --fid_standin
    --skip_pairwise`` on ``FID_SHAPES`` + ``FID_SHAPES`` meshes made as
    phase 10 makes its own, at 299², twice (the second
    reads each set's ``.fid_cache``), then the renderer and the stand-in
    features card vs CPU on ``FID_CHECK_MESHES`` meshes."""
    from octfusion_tpu_torch import evaluate
    from octfusion_tpu_torch.metrics import fid, render
    from octfusion_tpu_torch.utils import mesh as mesh_utils

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as root:
        samples, reference = write_meshes(root, seed, FID_SHAPES)
        argv = ["--samples", samples, "--reference", reference,
                "--fid_standin", "--skip_pairwise", "--fid_views",
                str(FID_VIEWS)]
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for attempt in (1, 2):
            t0 = time.perf_counter()
            res = evaluate.main(argv)
            runs.append((res, time.perf_counter() - t0))
            print(f"fid run {attempt}: shading_fid_standin="
                  f"{res['shading_fid_standin']!r} wall_s_fid="
                  f"{res['wall_s_fid']:.3f} wall_s={runs[-1][1]:.3f}",
                  flush=True)
        peak = torch.cuda.max_memory_allocated()
        cached = sum(len(os.listdir(os.path.join(root, kind, ".fid_cache")))
                     for kind in ("samples", "reference"))
        first, second = (r["shading_fid_standin"] for r, _ in runs)
        if not math.isfinite(first) or first <= 0:
            raise AssertionError(f"shading_fid_standin = {first}")
        if second != first or cached != 2 * FID_SHAPES:
            raise AssertionError(f"the cached rerun gave {second} against "
                                 f"{first}; {cached} cached feature files")

        paths = sorted(glob.glob(samples))[:FID_CHECK_MESHES]
        feat = {d: fid.standin_feature_extractor(device=d)
                for d in (dev, "cpu")}
        t_render = t_feat = 0.0
        for p in paths:
            v, f = mesh_utils.load_obj(p)
            t0 = time.perf_counter()
            card = render.render_mesh_views_raster(v, f, device=dev)
            t_render += time.perf_counter() - t0     # numpy out: synced
            t0 = time.perf_counter()
            f_card = feat[dev](card)
            t_feat += time.perf_counter() - t0
            cpu = render.render_mesh_views_raster(v, f, device="cpu")
            err = np.abs(card - cpu)
            apart = int((err > TOL_IMAGE).sum())
            print(f"fid {os.path.basename(p)} card vs cpu: faces={len(f)} "
                  f"pixels={err.size} beyond {TOL_IMAGE:g}: {apart} "
                  f"({apart / err.size:.2e}) max_abs_err={err.max():.3e}",
                  flush=True)
            if apart > (1 - IMAGE_SHARE) * err.size:
                raise AssertionError(f"{apart} pixels beyond {TOL_IMAGE}")
            f_cpu = feat["cpu"](card)
            print(f"fid features card vs cpu: max_abs_err="
                  f"{np.abs(f_card - f_cpu).max():.3e} tol {TOL_FEATURES}",
                  flush=True)
            np.testing.assert_allclose(f_card, f_cpu, **TOL_FEATURES)
    n = len(paths)
    print(f"fid: {FID_SHAPES}+{FID_SHAPES} meshes x {FID_VIEWS} views at "
          f"{FID_IMAGE}^2: render_s_per_mesh={t_render / n:.4f} "
          f"feature_s_per_mesh={t_feat / n:.4f} wall_s_fid="
          f"{runs[0][0]['wall_s_fid']:.3f} (cached rerun "
          f"{runs[1][0]['wall_s_fid']:.3f}) peak_memory_bytes={peak} "
          f"({peak / 2**30:.2f} GiB); phase 23 "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


# phase 24: dataset preparation

def write_prep_meshes(root, seed):
    """``PREP_MESHES`` lumpy spheres marched on the card at
    ``PREP_GRID``³ into ``root`` -> their face counts."""
    from octfusion_tpu_torch.utils import mesh as mesh_utils
    from octfusion_tpu_torch.utils.shapes import lumpy_sphere_fields

    os.makedirs(root)
    faces = []
    for i, field in enumerate(lumpy_sphere_fields(
            PREP_MESHES, PREP_GRID, seed, device=torch.device("cuda"))):
        v, f = mesh_utils.marching_tetrahedra(field)
        faces.append(f.shape[0])
        mesh_utils.save_obj(os.path.join(root, f"lumpy_{i}.obj"),
                            v.cpu().numpy(), f.cpu().numpy())
    return faces


def check_prep_card_vs_cpu(path) -> None:
    """Phase 24's check on one mesh at ``PREP_CHECK_QUERIES`` queries:
    the nearest sample and the winding numbers card vs CPU."""
    from octfusion_tpu_torch.tools import prepare_dataset as prep
    from octfusion_tpu_torch.utils import mesh as mesh_utils

    v, f = mesh_utils.load_obj(path)
    verts = prep.normalize_mesh(v)
    surf, _, q = prep.surface_and_queries(verts, f, PREP_SURFACE,
                                          PREP_CHECK_QUERIES)
    out, secs = {}, {}
    for d in ("cuda", "cpu"):
        t0 = time.perf_counter()
        dist, idx = prep.nearest_surface(q, surf, device=d)
        w = prep.winding_number(verts, f, q, device=d)
        secs[d] = time.perf_counter() - t0
        out[d] = dist, idx, w
    (d_card, i_card, w_card), (d_cpu, i_cpu, w_cpu) = out["cuda"], out["cpu"]
    moved = np.nonzero(i_card != i_cpu)[0]
    q64 = q[moved].astype(np.float64)
    gap = np.abs(((q64 - surf[i_card[moved]]) ** 2).sum(-1)
                 - ((q64 - surf[i_cpu[moved]]) ** 2).sum(-1))
    clear = np.abs(w_cpu - 0.5) > WINDING_TIE
    sign_card = np.where(w_card > 0.5, -1.0, 1.0)
    sign_cpu = np.where(w_cpu > 0.5, -1.0, 1.0)
    sdf_err = np.abs(d_card * sign_card - d_cpu * sign_cpu)[clear].max()
    print(f"prep card vs cpu ({os.path.basename(path)}, {len(f)} faces, "
          f"{PREP_SURFACE} samples, {len(q)} queries): dist max_abs_err="
          f"{np.abs(d_card - d_cpu).max():.3e} other nearest index at "
          f"{len(moved)} queries (near-ties, |d2 gap| max "
          f"{gap.max() if len(moved) else 0.0:.3e}) winding max_abs_err="
          f"{np.abs(w_card - w_cpu).max():.3e} within {WINDING_TIE:g} of "
          f"1/2: {int((~clear).sum())} sdf max_abs_err={sdf_err:.3e} "
          f"inside={float((w_cpu > 0.5).mean()):.3f} card_s="
          f"{secs['cuda']:.3f} cpu_s={secs['cpu']:.3f}", flush=True)
    np.testing.assert_allclose(d_card, d_cpu, rtol=0, atol=TOL_PREP_SDF)
    if len(moved) and gap.max() > NEAR_TIE:
        raise AssertionError(f"another nearest sample {gap.max()} apart")
    np.testing.assert_allclose(w_card, w_cpu, rtol=0, atol=TOL_WINDING)
    np.testing.assert_array_equal(sign_card[clear], sign_cpu[clear])
    if sdf_err > TOL_PREP_SDF:
        raise AssertionError(f"sdf card vs cpu {sdf_err}")
    if not 0.05 < (w_cpu > 0.5).mean() < 0.95:
        raise AssertionError("the queries are not inside and outside")


def check_prepare_dataset(seed) -> dict:
    """Phase 24: ``python -m octfusion_tpu_torch.tools.prepare_dataset``
    on the card at its defaults over lumpy-sphere meshes, the card vs the
    CPU on one mesh, then ``PREP_VAE_STEPS`` VAE steps of the train CLI
    on the prepared set -> the train run's K1 / K2 / K3 launches."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        raw, data = os.path.join(root, "raw"), os.path.join(root, "data")
        faces = write_prep_meshes(raw, seed + 400)
        print(f"prep meshes: {PREP_MESHES} lumpy spheres marched at "
              f"{PREP_GRID}^3, faces {faces}", flush=True)
        filelist = os.path.join(data, "filelist.txt")
        cmd = [sys.executable, "-m", "octfusion_tpu_torch.tools."
               "prepare_dataset", "--meshes", os.path.join(raw, "*.obj"),
               "--out", data, "--filelist", filelist]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                             timeout=CLI_TIMEOUT)
        wall = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"prepare_dataset failed ({res.returncode})"
                                 f":\n{res.stdout[-3000:]}\n"
                                 f"{res.stderr[-3000:]}")
        lines = res.stdout.splitlines()
        for line in lines:
            print(f"  {line}", flush=True)
        summary = [ln for ln in lines if ln.startswith("[*] prepared")]
        if len(summary) != 1 or f"prepared {PREP_MESHES} meshes on cuda" \
                not in summary[0]:
            raise AssertionError(f"prepare_dataset: {lines[-5:]}")
        for i in range(PREP_MESHES):
            sdf = np.load(os.path.join(data, f"lumpy_{i}", "sdf.npz"))
            pc = np.load(os.path.join(data, f"lumpy_{i}", "pointcloud.npz"))
            if (sdf["sdf"].shape != (PREP_QUERIES,)
                    or pc["points"].shape != (PREP_SURFACE, 3)
                    or not np.isfinite(sdf["sdf"]).all()
                    or not np.isfinite(sdf["grad"]).all()):
                raise AssertionError(f"lumpy_{i}: bad shards")
        print(f"prep: wall_s={wall:.3f} (the process, its start included)",
              flush=True)
        check_prep_card_vs_cpu(os.path.join(raw, "lumpy_0.obj"))

        cfg_path = cli_config(root, data, filelist,
                              point_scale=PREP_TRAIN_POINT_SCALE)
        _, fields, _ = run_cli("prep vae train", [
            "--config", cfg_path, "--logs_dir", root, "--seed", str(seed),
            "--model", "vae", "--name", "vae", "--batch_size", "2",
            "--max_steps", str(PREP_VAE_STEPS)])
        launches = check_cli_launches("prep vae train", fields)
        if int(fields["steps"]) != PREP_VAE_STEPS:
            raise AssertionError(f"prep vae train: {fields['steps']} steps")
    print(f"phase 24: {time.perf_counter() - t_phase:.1f} s; launches "
          f"{launches}", flush=True)
    return launches


# phase 25: depth 9

def check_depth9(seed):
    """Phase 25: K1 and K5 vs their plain versions at the depth-9 shapes
    of a 2-step warm-up, then ``configs/synthetic_depth9.yaml`` through
    the generate CLI (dpmpp-25, ``DEPTH9_SHAPES`` shapes, K5 on the grown
    graph) from seeded perturbed weights saved as phase 13 saves them ->
    ({kernel: KernelStats} at its shapes, {kernel: launches} of the CLI
    run)."""
    from octfusion_tpu_torch.config import load_config

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = load_config(DEPTH9_CONFIG)
    solver = dpmpp_solver(cfg, seed + 9)

    shapes = set()
    hooks = conv_shape_hooks([solver.df, solver.vae], shapes)
    warm = solver.sample(steps=2, kpack=False, compute_sdf=False,
                         generator=torch.Generator(device=dev).manual_seed(
                             seed + 91))
    for h in hooks:
        h.remove()
    g_dec = warm["decode_out"]["graph_out"]
    print_graph("depth9 warm-up decode", g_dec, allow_overflow=True)
    kgen = torch.Generator(device=dev).manual_seed(seed + 92)
    measured = check_kernels(g_dec, shapes, kgen, K1)
    measured["graph_conv_fwd"].summary("k1 phase 25 (depth-9 sampling)")
    measured.update(check_kernels(
        warm["graph"],
        {sh for sh in shapes if sh[0] <= cfg.model.depth_stop}, kgen, K5))
    check_packed_autograd(warm["graph"], kgen)
    measured["graph_conv_fwd_packed"].summary("k5 phase 25 (depth-9 "
                                              "sampling)")
    del warm, g_dec

    with tempfile.TemporaryDirectory() as root:
        ckpt_path, vae_path, cfg_path = save_for_generate(solver, cfg, root)
        del solver
        torch.cuda.empty_cache()
        cmd = [sys.executable, "-m", "octfusion_tpu_torch.generate",
               "--config", cfg_path, "--logs_dir", root, "--name", "d9",
               "--ckpt", ckpt_path, "--vq_ckpt", vae_path,
               "--count", str(DEPTH9_SHAPES), "--sampler", "dpmpp",
               "--sample_steps", str(DPMPP_STEPS), "--seed", str(seed)]
        env = dict(os.environ, OCTFUSION_CONV_KPACK="1")
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                             text=True, timeout=CLI_TIMEOUT)
        wall = time.perf_counter() - t0
        lines = res.stdout.splitlines()
        for line in lines:
            print(f"  {line}", flush=True)
        if res.returncode != 0:
            raise AssertionError(f"depth-9 generate failed "
                                 f"({res.returncode}):\n{res.stderr[-3000:]}")
        rdir = os.path.join(root, "d9", "results_airplane")
        faces = []
        for i in range(DEPTH9_SHAPES):
            path = os.path.join(rdir, f"{i}.obj")
            shape = [ln for ln in lines if ln.startswith(f"[*] shape {i}: ")]
            if len(shape) != 1:
                raise AssertionError(f"no line for shape {i}")
            fields = dict(tok.split("=", 1) for tok in shape[0].split()
                          if "=" in tok)
            flags = shape[0].split("per_depth=")[1].split("]")[0]
            flagged = ("1" in flags or fields["grow_graph"] == "1"
                       or fields["decoded_graph"] == "1")
            warned = any(ln.startswith("[!] static capacity overflow")
                         and path in ln for ln in lines)
            if flagged != warned:
                raise AssertionError(f"shape {i}: overflow flags {flagged} "
                                     f"but warning {warned}")
            if fields["sdf_finite"] != "True" or int(fields["d9"]) <= 0:
                raise AssertionError(f"shape {i}: {shape[0]}")
            faces.append(nonempty_mesh(path))
        summary = [ln for ln in lines if ln.startswith("[*] generated")]
        if not summary:
            raise AssertionError("depth-9 generate: no summary line")
        gen = dict(tok.split("=", 1) for tok in summary[0].split()
                   if "=" in tok)
    launches = {"graph_conv_fwd": int(gen.get("graph_conv_fwd_launches", 0)),
                "graph_conv_fwd_packed": int(
                    gen.get("graph_conv_fwd_packed_launches", 0))}
    if not launches["graph_conv_fwd_packed"]:
        raise AssertionError("depth-9 generate ran no K5 launch")
    print(f"depth9: {DEPTH9_SHAPES} shapes wall_s={wall:.3f} "
          f"s_per_shape={gen['s_per_shape']} mesh faces={faces} "
          f"(resolution {CLI_RESOLUTION}) peak_memory_bytes="
          f"{gen['peak_memory_bytes']}; phase 25 "
          f"{time.perf_counter() - t_phase:.1f} s; launches {launches}",
          flush=True)
    return measured, launches


# phase 26: the bf16 compute mode

def with_bf16(cfg):
    """``cfg`` with ``diffusion.compute_dtype: bfloat16``."""
    return dataclasses.replace(cfg, diffusion=dataclasses.replace(
        cfg.diffusion, compute_dtype="bfloat16"))


def check_bf16_hr_step(solver, g, seed):
    """Phase 26: one full-width bf16 hr denoise step, card against CPU,
    within ``GAP_FACTOR`` times the CPU's own bf16-vs-fp32 gap on the same
    weights and inputs (fp32 sums in another order can move a bf16
    rounding by an ulp, and the U-Net carries such an ulp on), and at
    least ``GAP_FLOOR`` times that gap from the CPU's fp32 result (a card
    that computed the bf16 layers in fp32 would sit on it)."""
    from octfusion_tpu_torch.nn.unet_union import UNetUnion

    df = copy.deepcopy(solver.df).cpu()
    gen = torch.Generator().manual_seed(seed)
    perturb_([df], gen)
    f32 = UNetUnion(dataclasses.replace(df.config, compute_dtype="float32"),
                    "hr")
    f32.load_state_dict(df.state_dict())
    lvl = g.level(solver.small_depth)
    x = torch.randn(lvl.g_cap, solver.cfg.model.embed_dim, generator=gen)
    x = torch.where(lvl.node_mask.cpu()[:, None], x, torch.zeros_like(x))
    t = solver.log_snr(torch.tensor([0.5]))
    g_cpu = g.to("cpu")
    with torch.no_grad():
        ref = df("hr", x, t, g=g_cpu)
        ref32 = f32("hr", x, t, g=g_cpu)
        dev = torch.device("cuda")
        got = df.to(dev)("hr", x.to(dev), t.to(dev), g=g).cpu()
    err = (got - ref).abs().max().item()
    gap = (ref - ref32).abs().max().item()
    off32 = (got - ref32).abs().max().item()
    print(f"bf16 hr_step G={lvl.g_cap} max_abs_err={err:.3e} "
          f"cpu_bf16_vs_fp32_gap={gap:.3e} card_vs_cpu_fp32={off32:.3e} "
          f"max_abs_ref={ref.abs().max().item():.3e} tol={GAP_FACTOR:g} x "
          f"gap share_of_tol={err / (GAP_FACTOR * gap):.3f} floor="
          f"{GAP_FLOOR:g} x gap", flush=True)
    if not (got.dtype == torch.float32 and gap > 0
            and err <= GAP_FACTOR * gap and off32 >= GAP_FLOOR * gap):
        raise AssertionError(f"bf16 hr step card vs CPU: {err:.3e} > "
                             f"{GAP_FACTOR:g} x {gap:.3e} or {off32:.3e} "
                             f"from fp32 < {GAP_FLOOR:g} x gap")


def run_bf16_cascade(label, solver, kpack, seed, **kw):
    """Phase 26: one counted cascade of ``solver`` (bf16): bf16 K1 (and,
    with ``kpack``, bf16 K5) launches must equal the bf16 GraphConv calls
    -> (the cascade's output, its launches)."""
    from octfusion_tpu_torch.nn.modules import GraphConv
    from octfusion_tpu_torch.ops import graph_conv_cuda as k

    gen = torch.Generator(device=solver.device).manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k.reset_launches()
    GraphConv.calls = GraphConv.calls_bf16 = 0
    t0 = time.perf_counter()
    out = solver.sample(resolution=RESOLUTION, kpack=kpack, generator=gen,
                        **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, calls = dict(k.launches), GraphConv.calls_bf16
    peak = torch.cuda.max_memory_allocated()
    m = solver.cfg.model
    code, sdfs = out["code"], out["sdfs"]
    octree = out["decode_out"]["octree_out"]
    print(f"bf16 {label}: wall_s={wall:.3f} "
          + " ".join(f"{n}_s={v:.3f}" for n, v in out["seconds"].items())
          + f" peak_memory_bytes={peak} ({peak / 2**30:.2f} GiB) "
          f"k1_bf16_launches={launches['graph_conv_fwd_bf16']} "
          f"k5_bf16_launches={launches['graph_conv_fwd_packed_bf16']} "
          f"bf16_graph_conv_calls={calls} graph_conv_calls={GraphConv.calls}"
          f" overflow grow_graph={bool(out['overflow'])} decoded_graph="
          f"{bool(out['decode_out']['graph_out'].any_overflow())} per_depth="
          f"{octree.overflow.int().tolist()} code_max_abs="
          f"{code.abs().max().item():.4f} sdf_min={sdfs.min().item():.4f} "
          f"sdf_max={sdfs.max().item():.4f}", flush=True)
    bf16_launches = (launches["graph_conv_fwd_bf16"]
                     + launches["graph_conv_fwd_packed_bf16"])
    if not (bf16_launches == calls > 0
            and (launches["graph_conv_fwd_packed_bf16"] > 0) == kpack):
        raise AssertionError(f"bf16 {label}: bf16 launches {launches} vs "
                             f"{calls} bf16 GraphConv calls")
    if code.shape != (out["graph"].level(m.depth_stop).g_cap, m.embed_dim):
        raise AssertionError(f"bf16 {label}: code shape {tuple(code.shape)}")
    if sdfs.shape != (1,) + (RESOLUTION,) * 3:
        raise AssertionError(f"bf16 {label}: sdf shape {tuple(sdfs.shape)}")
    if not (code.dtype == torch.float32 and torch.isfinite(code).all()
            and torch.isfinite(sdfs).all()):
        raise AssertionError(f"bf16 {label}: non-finite codes or SDF")
    return out, launches


def check_bf16(seed, steps):
    """Phase 26: the bf16 compute mode of the reference-parity model (the
    snet config's U-Nets with ``compute_dtype: bfloat16``): the bf16 K1 /
    K5 at the bf16 convs' shapes of a warm-up cascade's depth-8 sampling
    graph, one hr denoise step card vs CPU, the 200 + 200 ancestral
    cascade and dpmpp-25 with K5, the bf16 K2 / K3 at the bf16 shapes of
    the batch-4 training graph and ``BF16_TRAIN_STEPS`` hr train steps ->
    ({bf16 entry point: KernelStats}, {bf16 entry point: launches of the
    cascades and the training run})."""
    from octfusion_tpu_torch.config import Config
    from octfusion_tpu_torch.models.union_solver import UnionSolver
    from octfusion_tpu_torch.nn.modules import GraphConv
    from octfusion_tpu_torch.ops import graph_conv_cuda as k

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = with_bf16(Config())
    torch.manual_seed(seed)
    solver = UnionSolver(cfg, device=dev)
    shapes = set()
    hooks = conv_shape_hooks([solver.df], shapes, torch.bfloat16)
    warm = solver.sample(steps=2, resolution=RESOLUTION, kpack=False,
                         generator=torch.Generator(device=dev).manual_seed(
                             seed + 1))
    for h in hooks:
        h.remove()
    print(f"bf16 sampling shapes (level, C, C'): {sorted(shapes)}",
          flush=True)
    measured = check_kernels(
        warm["graph"], shapes,
        torch.Generator(device=dev).manual_seed(seed + 2), K1 + K5,
        torch.bfloat16)
    check_bf16_hr_step(solver, warm["graph"], seed)
    del warm

    launches = dict.fromkeys(measured, 0)
    launches.update({"graph_conv_col_bf16": 0, "graph_conv_bwd_dx_bf16": 0})
    _, n = run_bf16_cascade(f"cascade steps={steps}+{steps}", solver, False,
                            seed, steps=steps)
    for name in launches:
        launches[name] += n[name]
    del solver
    dsolver = dpmpp_solver(cfg, seed)
    dsolver.sample(steps=2, resolution=RESOLUTION, kpack=True)
    _, n = run_bf16_cascade(f"dpmpp cascade steps={DPMPP_STEPS}+"
                            f"{DPMPP_STEPS} kpack=True", dsolver, True, seed,
                            steps=DPMPP_STEPS)
    for name in launches:
        launches[name] += n[name]
    del dsolver

    trainer, _, batch, draws, g_train, _, shapes = training_setup(
        seed, edit=with_bf16, dtype=torch.bfloat16)
    print(f"bf16 training shapes (level, C, C'): {sorted(shapes)}",
          flush=True)
    measured.update(check_kernels(
        g_train, shapes, torch.Generator(device=dev).manual_seed(seed + 3),
        K2K3, torch.bfloat16))
    del g_train
    GraphConv.calls_bf16 = 0
    k.GraphConvFunction.backward_calls_bf16 = 0
    n = run_steps("bf16 train", trainer.make_train_step(), batch,
                  BF16_TRAIN_STEPS, False, **draws)
    calls, bwd = GraphConv.calls_bf16, k.GraphConvFunction.backward_calls_bf16
    print(f"bf16 train launches fwd_bf16={n['graph_conv_fwd_bf16']} "
          f"col_bf16={n['graph_conv_col_bf16']} bwd_dx_bf16="
          f"{n['graph_conv_bwd_dx_bf16']} bf16_graph_conv_calls={calls} "
          f"bf16_backward_calls={bwd}", flush=True)
    if not (n["graph_conv_fwd_bf16"] == calls > 0
            and n["graph_conv_col_bf16"] == n["graph_conv_bwd_dx_bf16"]
            == bwd > 0):
        raise AssertionError(f"bf16 train: launches {n} vs {calls} bf16 "
                             f"GraphConv calls, {bwd} bf16 backward calls")
    for name in launches:
        launches[name] += n[name]
    for name, label in (("graph_conv_fwd_bf16", "k1 bf16 phase 26"),
                        ("graph_conv_fwd_packed_bf16", "k5 bf16 phase 26"),
                        ("graph_conv_col_bf16", "k2 bf16 phase 26"),
                        ("graph_conv_bwd_dx_bf16", "k3 bf16 phase 26")):
        measured[name].summary(label)
    print(f"phase 26: {time.perf_counter() - t_phase:.1f} s; launches "
          + " ".join(f"{n}={v}" for n, v in launches.items()), flush=True)
    return measured, launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200,
                    help="ancestral steps of each diffusion stage")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    # ---- 1. device ---------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs "
                         "only on an NVIDIA GPU")
    from octfusion_tpu_torch.config import Config
    from octfusion_tpu_torch.models.union_solver import UnionSolver
    from octfusion_tpu_torch.nn.modules import GraphConv
    from octfusion_tpu_torch.ops import chamfer_cuda, graph_conv_cuda
    from octfusion_tpu_torch.utils import mesh as mesh_utils
    from octfusion_tpu_torch.utils import sdf as sdf_utils
    from octfusion_tpu_torch.utils.device import use_fp32_math

    dev = torch.device("cuda")
    card = smi()
    print(f"device: {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    use_fp32_math()

    # ---- 2. build: one nvcc per source, all at once ------------------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        builds = [pool.submit(mod.build) for mod in (graph_conv_cuda,
                                                     chamfer_cuda)]
        for fut in builds:
            fut.result()
    print(f"build: graph_conv.cu (K1, K2, K3, K5) and chamfer.cu (K4) "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # ---- 9. K4 vs plain; CD / EMD pairs/s (first: its device times come
    # from profiler traces, which a fresh process takes reliably) ---------
    k4 = check_chamfer(args.seed)
    k4.summary("k4 phase 9")

    cfg = Config()
    m = cfg.model
    torch.manual_seed(args.seed)
    solver = UnionSolver(cfg, device=dev)
    gen = torch.Generator(device=dev)

    # ---- 3. kernel vs plain on a warm-up cascade's levels -------------
    shapes = set()
    hooks = conv_shape_hooks([solver.df, solver.vae], shapes)
    warm = solver.sample(steps=2, resolution=RESOLUTION, kpack=False,
                         generator=gen.manual_seed(args.seed + 1))
    for h in hooks:
        h.remove()
    g_warm = warm["decode_out"]["graph_out"]
    k1 = check_kernels(
        g_warm, shapes, torch.Generator(device=dev).manual_seed(args.seed),
        K1)["graph_conv_fwd"]
    k1.summary("k1 phase 3 (sampling)")

    # ---- 11. K5 vs plain and K1 on the sampling graph's levels 4-6 -----
    k5_gen = torch.Generator(device=dev).manual_seed(args.seed + 6)
    k5 = check_kernels(
        warm["graph"], {sh for sh in shapes if sh[0] <= m.depth_stop}
        | RAGGED_PACKED, k5_gen, K5)["graph_conv_fwd_packed"]
    check_packed_autograd(warm["graph"], k5_gen)
    k5.summary("k5 phase 11")

    # ---- 4. one full-width hr denoise step, card vs CPU ---------------
    check_hr_step(solver, warm["graph"], args.seed)
    del warm, g_warm    # the peak below is the cascade's alone

    # ---- 5. the cascade ----------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    graph_conv_cuda.reset_launches()
    GraphConv.calls = 0
    t0 = time.perf_counter()
    out = solver.sample(steps=args.steps, resolution=RESOLUTION, kpack=False,
                        generator=gen.manual_seed(args.seed))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cascade_launches = graph_conv_cuda.launches["graph_conv_fwd"]
    calls = GraphConv.calls
    peak = torch.cuda.max_memory_allocated()
    print(f"cascade: steps={args.steps}+{args.steps} wall_s={wall:.3f} "
          + " ".join(f"{k}_s={v:.3f}" for k, v in out["seconds"].items()),
          flush=True)
    print(f"k1 launches={cascade_launches} graph_conv_calls={calls}",
          flush=True)
    if not (cascade_launches == calls and cascade_launches > 0):
        raise AssertionError(f"kernel launches {cascade_launches} != "
                             f"GraphConv calls {calls}")

    dec = out["decode_out"]
    octree = dec["octree_out"]
    print("nnum " + " ".join(f"d{d}={int(n)}" for d, n in
                             enumerate(octree.nnum.tolist())), flush=True)
    print(f"overflow grow_graph={bool(out['overflow'])} "
          f"decoded_graph={bool(dec['graph_out'].any_overflow())} "
          f"per_depth={octree.overflow.int().tolist()}", flush=True)
    code, sdfs = out["code"], out["sdfs"]
    if code.shape != (out["graph"].level(m.depth_stop).g_cap, m.embed_dim):
        raise AssertionError(f"code shape {tuple(code.shape)}")
    if sdfs.shape != (1,) + (RESOLUTION,) * 3:
        raise AssertionError(f"sdf shape {tuple(sdfs.shape)}")
    if not (torch.isfinite(code).all() and torch.isfinite(sdfs).all()):
        raise AssertionError("non-finite codes or SDF values")
    print(f"sdf decoded: shape={tuple(sdfs.shape)} "
          f"min={sdfs.min().item():.4f} max={sdfs.max().item():.4f}",
          flush=True)

    t0 = time.perf_counter()
    grid = sdf_utils.calc_sdf(analytic_reg(octree, m.full_depth, m.depth_out),
                              octree, m.full_depth, m.depth_out,
                              size=RESOLUTION,
                              bbmin=-cfg.solver.sdf_scale,
                              bbmax=cfg.solver.sdf_scale)
    torch.cuda.synchronize()
    t_grid = time.perf_counter() - t0
    t0 = time.perf_counter()
    verts, faces = mesh_utils.marching_tetrahedra(grid[0])
    torch.cuda.synchronize()
    t_march = time.perf_counter() - t0
    print(f"mesh analytic planes: sdf_s={t_grid:.3f} marching_s={t_march:.3f}"
          f" verts={verts.shape[0]} faces={faces.shape[0]}", flush=True)
    if faces.shape[0] == 0:
        raise AssertionError("empty mesh")
    print(f"peak_memory_bytes={peak} ({peak / 2**30:.2f} GiB)", flush=True)

    del out, dec, octree, grid, verts, faces, solver

    # ---- 12-13. the DPM-Solver++ cascade with K5 and K1; the CLI -------
    dsolver = dpmpp_solver(cfg, args.seed)
    k5_launches, dpmpp_k1_launches = check_dpmpp(dsolver, args.seed)
    check_cli(dsolver, cfg, args.seed)
    del dsolver

    # ---- 6-8. training ------------------------------------------------
    measured, train_launches = check_training(args.seed)
    # K1's entry covers both phases: the worst error, the summed times
    k1.merge(measured["graph_conv_fwd"])
    measured["graph_conv_fwd"] = k1
    launches = {name: train_launches[name] for name in measured}
    launches["graph_conv_fwd"] += cascade_launches + dpmpp_k1_launches

    # ---- 14. lr training ----------------------------------------------
    check_lr_training(args.seed)

    # ---- 15-18. VAE training and reconstruction -----------------------
    vae_measured, vae_launches = check_vae_training(args.seed)
    for name, stats in vae_measured.items():
        measured[name].merge(stats)
        launches[name] += vae_launches[name]

    measured["chamfer"] = k4

    # ---- 10. evaluation from meshes ----------------------------------
    launches["chamfer"] = check_evaluation(args.seed)
    measured["graph_conv_fwd_packed"] = k5
    launches["graph_conv_fwd_packed"] = k5_launches

    # ---- 19. the training CLI -----------------------------------------
    add_launches(launches, check_train_cli(args.seed))

    # ---- 20. the 3-stage solver at obja-3t-d10 -------------------------
    measured_3t, launches_3t = check_three_stage(args.seed, args.steps)
    for name, stats in measured_3t.items():
        measured[name].merge(stats)
        launches[name] += launches_3t[name]

    # ---- 21. the colour VAE -------------------------------------------
    measured_c, launches_c = check_color_vae(args.seed)
    for name, stats in measured_c.items():
        measured[name].merge(stats)
        launches[name] += launches_c[name]

    # ---- 22. data parallelism on the one card -------------------------
    add_launches(launches, check_data_parallel(args.seed))

    # ---- 23. shading FID ----------------------------------------------
    check_shading_fid(args.seed)

    # ---- 24. dataset preparation --------------------------------------
    add_launches(launches, check_prepare_dataset(args.seed))

    # ---- 25. depth 9 ---------------------------------------------------
    measured_d9, launches_d9 = check_depth9(args.seed)
    for name, stats in measured_d9.items():
        measured[name].merge(stats)
        launches[name] += launches_d9[name]

    # ---- 26. the bf16 compute mode ------------------------------------
    measured_bf, launches_bf = check_bf16(args.seed, args.steps)
    measured.update(measured_bf)
    launches.update(launches_bf)

    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name], "launches": launches[name],
        **stats.entry(),
    } for name, stats in measured.items()]}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
