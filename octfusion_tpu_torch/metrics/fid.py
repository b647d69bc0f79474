"""Per-view shading FID (port of the JAX package's ``metrics/fid.py``;
the reference's ``metrics/calc_fid.py:29-46``).

Meshes are rendered by ``render.render_mesh_views_raster`` on the device,
each view's images go through a feature extractor, and the Fréchet
distance between the two sets' features is averaged over the views.  The
Fréchet arithmetic is float64 numpy / scipy on the host, as in the JAX
package.  The extractor here is the fixed-seed random-conv STAND-IN
(``standin_feature_extractor``; results are ``fid_standin``, not FID):
its weights are the JAX package's ``jax.random`` draws
(``standin_weights``), so both packages compute the same features and
share feature caches.  Inception features (``--fid``) need a local
torchvision InceptionV3 state dict, which this port does not ship.
"""

from __future__ import annotations

import inspect
import os
import sys
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from scipy import linalg

from ..utils import jax_prng
from ..utils.device import resolve_device
from ..utils.mesh import load_obj
from .render import render_mesh_views_raster


def _sqrtm(a: np.ndarray) -> np.ndarray:
    """scipy's sqrtm across its versions: ``disp=False`` (no printed
    warning; ``(matrix, errest)``, or the matrix alone once deprecated)
    where ``disp`` exists, the plain call where it was removed."""
    kwargs = ({"disp": False}
              if "disp" in inspect.signature(linalg.sqrtm).parameters
              else {})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # disp deprecation / LinAlgWarning
        out = linalg.sqrtm(a, **kwargs)
    return out[0] if isinstance(out, tuple) else out


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Fréchet distance between two Gaussians (``calc_fid.py:29-46``).

    A covariance from n samples has rank <= n - 1, and ``sqrtm(sigma1 @
    sigma2)`` of a rank-deficient product is unstable, so, as clean-fid
    does, ``eps`` is added to both diagonals up front when either is
    rank-deficient, and as a retry when the product's root is not
    finite."""
    diff = mu1 - mu2
    n_dim = sigma1.shape[0]
    deficient = (
        np.linalg.matrix_rank(sigma1, hermitian=True) < n_dim
        or np.linalg.matrix_rank(sigma2, hermitian=True) < n_dim
    )
    if deficient:
        offset = np.eye(n_dim) * eps
        covmean = _sqrtm((sigma1 + offset) @ (sigma2 + offset))
    else:
        covmean = _sqrtm(sigma1 @ sigma2)
        if not np.isfinite(covmean).all():
            offset = np.eye(n_dim) * eps
            covmean = _sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(
        diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean)
    )


def fid_from_features(feat1: np.ndarray, feat2: np.ndarray) -> float:
    mu1, s1 = feat1.mean(0), np.cov(feat1, rowvar=False)
    mu2, s2 = feat2.mean(0), np.cov(feat2, rowvar=False)
    return frechet_distance(mu1, s1, mu2, s2)


STANDIN_CHANNELS = (8, 16, 32)   # then dim // 2


def standin_weights(seed: int = 0, dim: int = 256):
    """The stand-in network's four 3x3 kernels, HWIO float32 numpy: the
    JAX package's ``jax.random.normal`` draws from ``split(PRNGKey(seed),
    4)``, scaled by ``1 / sqrt(9 cin)`` (drawn by ``utils/jax_prng``)."""
    keys = jax_prng.split(jax_prng.key(seed), 4)
    out, cin = [], 1
    for k, cout in zip(keys, STANDIN_CHANNELS + (dim // 2,)):
        w = jax_prng.normal(k, (3, 3, cin, cout))
        out.append(w / np.float32(np.sqrt(9 * cin)))
        cin = cout
    return out


def _same_pad(size: int, stride: int = 2, k: int = 3):
    """XLA's ``"SAME"`` padding (lo, hi) of one axis: the odd unit of the
    total goes after."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class StandinNet(torch.nn.Module):
    """4 x [3x3 conv, stride 2, "SAME" padding, ReLU], then the spatial
    mean and (population) std of each channel: [N, S, S] -> [N, dim]."""

    def __init__(self, seed: int = 0, dim: int = 256):
        super().__init__()
        for i, w in enumerate(standin_weights(seed, dim)):
            # HWIO -> OIHW
            self.register_buffer(f"w{i}", torch.from_numpy(
                np.ascontiguousarray(w.transpose(3, 2, 0, 1))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[:, None]
        for w in (self.w0, self.w1, self.w2, self.w3):
            ph, pw = _same_pad(h.shape[2]), _same_pad(h.shape[3])
            h = F.relu(F.conv2d(F.pad(h, (*pw, *ph)), w, stride=2))
        return torch.cat([h.mean(dim=(2, 3)),
                          h.std(dim=(2, 3), correction=0)], dim=-1)


def standin_feature_extractor(seed: int = 0, dim: int = 256,
                              image_size: int = 299,
                              device="cuda") -> Callable:
    """Fixed-seed random-convnet features: a DOCUMENTED STAND-IN for
    InceptionV3 where no pretrained weights exist.  Any fixed
    non-degenerate feature map gives a valid relative Fréchet distance
    between two sets under the SAME embedding; values are not comparable
    to Inception-FID numbers and are reported as ``fid_standin``.  Runs
    ``StandinNet`` in fp32 on ``device`` (the card unless ``"cpu"``) ->
    ``feat(images [N, S, S]) -> [N, dim]`` numpy, tagged
    ``standin_s{seed}_d{dim}`` for the feature cache, as in the JAX
    package.  ``image_size`` is accepted for the JAX signature; the net
    takes any size."""
    del image_size
    dev = resolve_device(device)
    net = StandinNet(seed, dim).to(dev)

    @torch.no_grad()
    def feat(images: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(images, np.float32), device=dev)
        return net(x).cpu().numpy()

    feat.cache_tag = f"standin_s{seed}_d{dim}"
    return feat


def per_view_fid(images1: np.ndarray, images2: np.ndarray,
                 feature_fn: Callable) -> float:
    """Average FID over the fixed views (``calc_fid.py:35-46``) of images
    [N, V, S, S] and [M, V, S, S]."""
    return float(np.mean([
        fid_from_features(feature_fn(images1[:, vi]),
                          feature_fn(images2[:, vi]))
        for vi in range(images1.shape[1])
    ]))


def render_mesh_set(paths, image_size: int = 299, n_views: int = 20,
                    device="cuda") -> np.ndarray:
    """[N, V, S, S] shading images of a set of OBJ meshes: the
    reference's ``generate_image_for_fid`` (``utils/render_utils.py:14-23``)
    without pyrender / EGL."""
    return np.stack([
        render_mesh_views_raster(*load_obj(p), image_size=image_size,
                                 n_views=n_views, device=device)
        for p in paths])


def mesh_set_features(paths, image_size: int = 299, n_views: int = 20, *,
                      feature_fn: Callable,
                      cache_dir: Optional[str] = None,
                      device="cuda") -> np.ndarray:
    """[N, V, D] per-view features of a mesh set, one mesh at a time.

    With ``cache_dir`` each mesh's feature matrix is kept on disk under
    ``<basename>-<mtime>-<size>-s<image_size>v<n_views>-<cache_tag>.npy``
    (the JAX package's key), so a set scored against several sample sets,
    such as a fixed reference set, renders once.  Extractors without a
    ``cache_tag`` never cache."""
    tag = getattr(feature_fn, "cache_tag", None)
    if cache_dir and tag:
        os.makedirs(cache_dir, exist_ok=True)
    out = []
    t0 = last = time.time()
    for i, p in enumerate(paths):
        if time.time() - last > 30:
            last = time.time()
            rate = max(i, 1) / (last - t0)
            sys.stderr.write(f"[fid render] {i}/{len(paths)} meshes (eta "
                             f"{(len(paths) - i) / max(rate, 1e-9):.0f}s)\n")
            sys.stderr.flush()
        cpath = None
        if cache_dir and tag:
            st = os.stat(p)
            cpath = os.path.join(
                cache_dir,
                f"{os.path.basename(p)}-{int(st.st_mtime)}-{st.st_size}"
                f"-s{image_size}v{n_views}-{tag}.npy")
            if os.path.exists(cpath):
                out.append(np.load(cpath))
                continue
        imgs = render_mesh_views_raster(*load_obj(p), image_size=image_size,
                                        n_views=n_views, device=device)
        feats = feature_fn(imgs)
        if cpath:
            np.save(cpath, feats)
        out.append(feats)
    return np.stack(out)


def per_view_fid_from_features(f1: np.ndarray, f2: np.ndarray) -> float:
    """Average FID over views, features [N, V, D] (``calc_fid.py:35-46``)."""
    return float(np.mean([
        fid_from_features(f1[:, vi], f2[:, vi])
        for vi in range(f1.shape[1])
    ]))


def shading_fid(sample_paths, reference_paths, image_size: int = 299,
                n_views: int = 20, *,
                feature_fn: Callable,
                cache_dir: Optional[str] = None,
                reference_cache_dir: Optional[str] = None,
                device="cuda") -> float:
    """End-to-end per-view shading FID between two mesh sets under
    ``feature_fn`` (``standin_feature_extractor``: the port has no
    Inception weights)."""
    f1 = mesh_set_features(sample_paths, image_size, n_views,
                           feature_fn=feature_fn, cache_dir=cache_dir,
                           device=device)
    f2 = mesh_set_features(reference_paths, image_size, n_views,
                           feature_fn=feature_fn, cache_dir=reference_cache_dir or cache_dir,
                           device=device)
    return per_view_fid_from_features(f1, f2)
