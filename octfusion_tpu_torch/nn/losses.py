"""The graph VAE's geometry losses (port of ``octfusion_tpu/nn/losses.py``).

The SDF-gradient terms supervise the MPU's spatial gradient inside the
training loss.  ``geometry_loss`` takes it in closed form from
``ops/mpu.mpu_eval_grad`` (``spatial_grad="analytic"``, the default: one
pass per target depth, the corner lookups shared) or from three
forward-mode passes through ``torch.func.jvp`` (``"jvp"``, as the JAX
package's ``mpu_with_grad``), which is the analytic form's oracle.
Neither differentiates twice in reverse mode.  ``geometry_color_loss``
adds the colour VAE's per-depth colour regression.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..octree.octree import Octree
from ..ops import mpu as mpu_ops


def octree_split_loss(logits: Dict[int, torch.Tensor], octree: Octree):
    """Per-depth split cross-entropy and accuracy over the valid nodes."""
    out = {}
    for d, logit in logits.items():
        mask = octree.node_mask(d)
        label = octree.nempty_mask(d).to(torch.int64)
        logp = F.log_softmax(logit.to(torch.float32), dim=-1)
        ce = -torch.gather(logp, 1, label[:, None])[:, 0]
        denom = mask.sum().clamp(min=1)
        out[f"loss_{d}"] = torch.where(mask, ce, torch.zeros_like(ce)).sum() \
            / denom
        hit = (torch.argmax(logit, dim=-1) == label) & mask
        out[f"accu_{d}"] = hit.sum() / denom
    return out


def mpu_with_grad(pos, pt_batch, reg_levels, octree, full_depth, depth_end):
    """(sdf [N], dsdf/dpos [N, 3]): the spatial gradient as three
    forward-mode passes (``torch.func.jvp``), one per axis."""

    def f(p):
        return mpu_ops.mpu_eval(p, pt_batch, reg_levels, octree, full_depth,
                                depth_end)[0]

    sdf = f(pos)
    grads = []
    for axis in range(3):
        tangent = torch.zeros_like(pos)
        tangent[:, axis] = 1.0
        grads.append(torch.func.jvp(f, (pos,), (tangent,))[1])
    return sdf, torch.stack(grads, dim=-1)


def _masked_mean(x, m):
    return torch.where(m, x, torch.zeros_like(x)).sum() / m.sum().clamp(min=1)


def sdf_reg_loss(sdf, grad, sdf_gt, grad_gt, suffix=""):
    """200 · mse(sdf) + mse(grad)."""
    return {
        f"sdf_loss{suffix}": torch.mean((sdf - sdf_gt) ** 2) * 200.0,
        f"grad_loss{suffix}": torch.mean((grad - grad_gt) ** 2) * 1.0,
    }


def sdf_grad_loss(sdf, grad, sdf_gt, grad_gt, suffix=""):
    """The surface / eikonal variant: points with sdf_gt == -1 are
    off-surface."""
    on = sdf_gt != -1
    off = ~on
    return {
        f"sdf_loss{suffix}": _masked_mean(sdf**2, on) * 200.0,
        f"norm_loss{suffix}": _masked_mean(
            torch.mean((grad - grad_gt) ** 2, -1), on),
        f"inter_loss{suffix}": _masked_mean(
            torch.exp(-40.0 * sdf.abs()), off) * 0.1,
        f"grad_loss{suffix}": _masked_mean(
            (torch.linalg.norm(grad, dim=-1) - 1.0).abs(), off) * 0.1,
    }


def possion_grad_loss(sdf, grad, sdf_gt, grad_gt, suffix=""):
    """The Poisson-style variant: sdf_gt == 0 marks the surface, == 1
    points outside the bounding box."""
    on = sdf_gt == 0
    oob = sdf_gt == 1.0
    off = ~on
    return {
        f"sdf_loss{suffix}": _masked_mean(sdf**2, on) * 200.0,
        f"norm_loss{suffix}": _masked_mean(
            torch.sum((grad - grad_gt) ** 2, -1), on),
        f"inter_loss{suffix}": _masked_mean(
            torch.exp(-40.0 * sdf.abs()), off) * 0.1,
        f"grad_loss{suffix}": _masked_mean(torch.sum(grad**2, -1), off) * 0.1,
        f"bbox_loss{suffix}": _masked_mean(F.relu(-sdf), oob) * 100.0,
    }


LOSS_FUNCTIONS = {
    "sdf_reg_loss": sdf_reg_loss,
    "sdf_grad_loss": sdf_grad_loss,
    "possion_grad_loss": possion_grad_loss,
}


def geometry_loss(
    vae_out: Dict,
    pos: torch.Tensor,
    pt_batch: torch.Tensor,
    sdf_gt: torch.Tensor,
    grad_gt: torch.Tensor,
    full_depth: int,
    depth_stop: int,
    depth_out: int,
    kl_weight: float = 0.1,
    loss_type: str = "sdf_reg_loss",
    spatial_grad: str = "analytic",
) -> Dict[str, torch.Tensor]:
    """The VAE objective: per-depth split cross-entropy, per-depth SDF and
    gradient regression, and the weighted KL term.  Returns a dict with
    every term and the scalar "loss", the sum of the entries whose names
    hold "loss"."""
    reg_fn = LOSS_FUNCTIONS[loss_type]
    octree_out = vae_out["octree_out"]
    output = octree_split_loss(vae_out["logits"], octree_out)
    if spatial_grad == "analytic":
        cache = mpu_ops.corners_by_depth(octree_out, full_depth, depth_out,
                                         pos, pt_batch)
    elif spatial_grad != "jvp":
        raise ValueError(f"spatial_grad {spatial_grad!r}")
    for d in range(depth_stop, depth_out + 1):
        if spatial_grad == "analytic":
            sdf, grad = mpu_ops.mpu_eval_grad(
                pos, pt_batch, vae_out["reg_voxs"][d], octree_out,
                full_depth, d, corner_cache=cache)
        else:
            sdf, grad = mpu_with_grad(pos, pt_batch, vae_out["reg_voxs"][d],
                                      octree_out, full_depth, d)
        output.update(reg_fn(sdf, grad, sdf_gt, grad_gt, f"_{d}"))
    output["kl_loss"] = kl_weight * vae_out["kl_loss"]
    output["loss"] = sum(v for k, v in output.items() if "loss" in k)
    return output


def geometry_color_loss(
    vae_out: Dict,
    pos: torch.Tensor,
    pt_batch: torch.Tensor,
    sdf_gt: torch.Tensor,
    grad_gt: torch.Tensor,
    color_pos: torch.Tensor,
    color_batch: torch.Tensor,
    color_gt: torch.Tensor,
    full_depth: int,
    depth_stop: int,
    depth_out: int,
    kl_weight: float = 0.1,
    loss_type: str = "sdf_reg_loss",
) -> Dict[str, torch.Tensor]:
    """:func:`geometry_loss` plus, at each depth d of depth_stop..depth_out,
    "color_loss_{d}": 200 · mse of the predicted per-node colours
    (``vae_out["colors"][d]``) blended by ``mpu_interp`` at the surface
    points ``color_pos`` [K, 3] of samples ``color_batch`` [K] against
    their colours ``color_gt`` [K, 3].  "loss" sums every term."""
    output = geometry_loss(vae_out, pos, pt_batch, sdf_gt, grad_gt,
                           full_depth, depth_stop, depth_out,
                           kl_weight=kl_weight, loss_type=loss_type)
    octree_out = vae_out["octree_out"]
    total = output.pop("loss")
    for d in range(depth_stop, depth_out + 1):
        pred = mpu_ops.mpu_interp(color_pos, color_batch,
                                  vae_out["colors"][d], octree_out,
                                  full_depth, d)
        closs = 200.0 * torch.mean((pred - color_gt) ** 2)
        output[f"color_loss_{d}"] = closs
        total = total + closs
    output["loss"] = total
    return output
