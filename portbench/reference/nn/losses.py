"""The graph VAE's geometry loss, as the VAE training cell's configuration
computes it (``loss_type: sdf_reg_loss``, the spatial gradient in closed
form): per-depth split cross-entropy, per-depth SDF and gradient
regression at the batch's SDF samples, and the weighted KL term.

Only this configuration's variant is here: the other regression types
and the forward-mode (``jvp``) gradient raise.
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


def sdf_reg_loss(sdf, grad, sdf_gt, grad_gt, suffix=""):
    """200 · mse(sdf) + mse(grad)."""
    return {
        f"sdf_loss{suffix}": torch.mean((sdf - sdf_gt) ** 2) * 200.0,
        f"grad_loss{suffix}": torch.mean((grad - grad_gt) ** 2) * 1.0,
    }


def geometry_loss(vae_out: Dict, pos: torch.Tensor, pt_batch: torch.Tensor,
                  sdf_gt: torch.Tensor, grad_gt: torch.Tensor,
                  full_depth: int, depth_stop: int, depth_out: int,
                  kl_weight: float = 0.1, loss_type: str = "sdf_reg_loss",
                  spatial_grad: str = "analytic") -> Dict[str, torch.Tensor]:
    """Every term of the VAE objective and "loss", the sum of the entries
    whose names hold "loss"."""
    if loss_type != "sdf_reg_loss" or spatial_grad != "analytic":
        raise ValueError(f"reference has no {loss_type} / {spatial_grad}")
    octree_out = vae_out["octree_out"]
    output = octree_split_loss(vae_out["logits"], octree_out)
    cache = {dd: mpu_ops.octree_corner_info(octree_out, dd, pos, pt_batch)
             for dd in range(full_depth, depth_out + 1)}
    for d in range(depth_stop, depth_out + 1):
        sdf, grad = mpu_ops.mpu_eval_grad(
            pos, pt_batch, vae_out["reg_voxs"][d], octree_out, full_depth, d,
            corner_cache=cache)
        output.update(sdf_reg_loss(sdf, grad, sdf_gt, grad_gt, f"_{d}"))
    output["kl_loss"] = kl_weight * vae_out["kl_loss"]
    output["loss"] = sum(v for k, v in output.items() if "loss" in k)
    return output
