"""Marching tetrahedra on a dense SDF grid, in PyTorch
(port of ``marching_tetrahedra`` in ``octfusion_tpu/utils/mesh.py``).

Each cube is split into 6 tetrahedra sharing the main diagonal, so faces
match between neighbouring cubes.  The port runs on the grid's device (the
reference runs in numpy on the host) and gives the same vertices and faces:
the same active-cell order, the same float32 interpolation, and the same
welding by quantised vertex key with first-occurrence representatives.

The evaluation's mesh helpers stay numpy on the host, as in the JAX
package (``save_obj``, ``load_obj``, ``sample_surface``: copies of the
functions of the same names there, so a seed gives bit-identical clouds in
both packages), with the unit-cube normalisation of ``tools/evaluate.py``
(``normalize_unit_cube``).
"""

from __future__ import annotations

import numpy as np
import torch

# 6-tetrahedra decomposition of the unit cube; corner c has coordinates
# ((c>>2)&1, (c>>1)&1, c&1), x-major like the voxel indexing
_TETS = np.array(
    [[0, 4, 6, 7], [0, 6, 2, 7], [0, 2, 3, 7],
     [0, 3, 1, 7], [0, 1, 5, 7], [0, 5, 4, 7]], np.int64)
_CORNER_OFF = np.array(
    [[(c >> 2) & 1, (c >> 1) & 1, c & 1] for c in range(8)], np.int64)
# the 6 (corner, corner) edges of a tetrahedron
_TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def _edge_id(i: int, j: int) -> int:
    return _TET_EDGES.index((min(i, j), max(i, j)))


def _case_table() -> np.ndarray:
    """[16, 2, 3]: per sign code (bit i = corner i inside), up to two
    triangles as tet-edge ids; -1 = no triangle."""
    tab = np.full((16, 2, 3), -1, np.int64)
    for case in range(1, 15):
        ins = [i for i in range(4) if (case >> i) & 1]
        outs = [i for i in range(4) if not (case >> i) & 1]
        if len(ins) == 1:
            tab[case, 0] = [_edge_id(ins[0], o) for o in outs]
        elif len(ins) == 3:
            tab[case, 0] = [_edge_id(i, outs[0]) for i in ins]
        else:
            (i0, i1), (o0, o1) = ins, outs
            p00, p01 = _edge_id(i0, o0), _edge_id(i0, o1)
            p10, p11 = _edge_id(i1, o0), _edge_id(i1, o1)
            tab[case, 0] = [p00, p01, p11]
            tab[case, 1] = [p00, p11, p10]
    return tab


def _flip_table(tri: np.ndarray) -> np.ndarray:
    """[6, 16, 2] bool: triangles whose winding must flip so normals point
    toward positive values.  The tet-linear interpolant has a constant
    gradient, so this is a constant of (tet, case)."""
    flip = np.zeros((len(_TETS), 16, 2), bool)
    for ti, tet in enumerate(_TETS):
        p = _CORNER_OFF[tet].astype(np.float64)
        binv = np.linalg.inv((p[1:] - p[0]).T)
        for case in range(1, 15):
            v = np.where([(case >> i) & 1 for i in range(4)], -1.0, 1.0)
            grad = binv.T @ (v[1:] - v[0])
            for s in range(2):
                if tri[case, s, 0] < 0:
                    continue
                pts = []
                for eix in tri[case, s]:
                    i, j = _TET_EDGES[eix]
                    t = v[i] / (v[i] - v[j])
                    pts.append(p[i] + t * (p[j] - p[i]))
                nrm = np.cross(pts[1] - pts[0], pts[2] - pts[0])
                flip[ti, case, s] = float(nrm @ grad) < 0
    return flip


_TRI_TABLE = _case_table()
_FLIP_TABLE = _flip_table(_TRI_TABLE)


def marching_tetrahedra(sdf: torch.Tensor, level: float = 0.0):
    """Extract the ``level`` iso-surface of a dense [N, N, N] grid.

    Returns (verts [V, 3] float32 in voxel coordinates, faces [F, 3] int64),
    on the grid's device; triangles face toward positive SDF."""
    n = sdf.shape[0]
    assert sdf.shape == (n, n, n)
    dev = sdf.device
    f = (sdf - level).to(torch.float32)
    m = n - 1
    offs = [tuple(int(v) for v in o) for o in _CORNER_OFF]

    # active cubes: corners change sign
    neg = f < 0
    any_neg = torch.zeros((m, m, m), dtype=torch.bool, device=dev)
    all_neg = torch.ones_like(any_neg)
    for ox, oy, oz in offs:
        cc = neg[ox:ox + m, oy:oy + m, oz:oz + m]
        any_neg |= cc
        all_neg &= cc
    ai, aj, ak = torch.nonzero(any_neg & ~all_neg, as_tuple=True)
    origin = torch.stack([ai, aj, ak], -1).to(torch.float32)
    vals = torch.stack([f[ai + ox, aj + oy, ak + oz] for ox, oy, oz in offs],
                       -1)                                       # [M, 8]

    tri_tab = torch.as_tensor(_TRI_TABLE, device=dev)
    flip_tab = torch.as_tensor(_FLIP_TABLE, device=dev)
    ii_e = torch.tensor([e[0] for e in _TET_EDGES], device=dev)
    jj_e = torch.tensor([e[1] for e in _TET_EDGES], device=dev)
    bits = torch.tensor([1, 2, 4, 8], device=dev)
    tris = []
    for ti, tet in enumerate(_TETS):
        tv = vals[:, torch.as_tensor(tet, device=dev)]           # [M, 4]
        code = ((tv < 0).to(torch.int64) * bits).sum(-1)
        active = (code > 0) & (code < 15)
        tv_a = tv[active]
        code_a = code[active]
        origin_a = origin[active]
        cpos = torch.as_tensor(_CORNER_OFF[tet], dtype=torch.float32,
                               device=dev)
        edges2 = tri_tab[code_a]                                 # [Ma, 2, 3]
        for s in range(2):
            have = edges2[:, s, 0] >= 0
            e3 = edges2[:, s][have]
            tv_h = tv_a[have]
            i_ix, j_ix = ii_e[e3], jj_e[e3]
            a = torch.gather(tv_h, 1, i_ix)
            b = torch.gather(tv_h, 1, j_ix)
            den = a - b
            den = torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12),
                              den)
            t = torch.clamp(a / den, 0.0, 1.0)[..., None]
            pi, pj = cpos[i_ix], cpos[j_ix]
            tri = origin_a[have][:, None, :] + pi + t * (pj - pi)
            fl = flip_tab[ti, :, s][code_a[have]]
            tris.append(torch.where(fl[:, None, None], tri.flip(1), tri))
    verts = torch.cat(tris, 0).reshape(-1, 3)
    faces = torch.arange(verts.shape[0], device=dev).reshape(-1, 3)
    if verts.shape[0] == 0:
        return verts, faces

    # weld duplicates by a quantised key (21 bits per axis); the
    # representative of each key is its first occurrence
    k3 = torch.round(verts * 1024.0).to(torch.int64)
    key = (k3[:, 0] << 42) | ((k3[:, 1] & 0x1FFFFF) << 21) | (k3[:, 2] & 0x1FFFFF)
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    first = torch.full((uniq.shape[0],), verts.shape[0], device=dev)
    first = first.scatter_reduce(0, inv, torch.arange(verts.shape[0],
                                                      device=dev), "amin")
    faces_w = inv[faces]
    ok = ((faces_w[:, 0] != faces_w[:, 1]) & (faces_w[:, 1] != faces_w[:, 2])
          & (faces_w[:, 0] != faces_w[:, 2]))
    return verts[first], faces_w[ok]


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray):
    with open(path, "w") as fh:
        for v in verts:
            fh.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for f in faces:
            fh.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")


def load_obj(path: str):
    verts, faces = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:4]]
                faces.append(idx)
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def normalize_unit_cube(verts: np.ndarray) -> np.ndarray:
    """Centre the bounding box at the origin and scale its longest side to
    1 (the reference's ``metrics/generate_pointclouds.py:28-37``)."""
    centre = (verts.min(0) + verts.max(0)) / 2
    scale = (verts.max(0) - verts.min(0)).max()
    return (verts - centre) / max(scale, 1e-9)


def sample_surface(verts: np.ndarray, faces: np.ndarray, n: int, seed=0,
                   return_normals: bool = False):
    """Area-weighted uniform surface samples (replaces
    trimesh.sample.sample_surface for the eval protocol,
    `metrics/generate_pointclouds.py:23-37`)."""
    rng = np.random.RandomState(seed)
    tri = verts[faces]
    cross = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = 0.5 * np.linalg.norm(cross, axis=-1)
    total = area.sum()
    if total <= 0 or len(faces) == 0:
        pts = np.zeros((n, 3))
        return (pts, np.zeros((n, 3))) if return_normals else pts
    probs = area / total
    fi = rng.choice(len(faces), size=n, p=probs)
    r1 = np.sqrt(rng.uniform(size=n))
    r2 = rng.uniform(size=n)
    a, b, c = tri[fi, 0], tri[fi, 1], tri[fi, 2]
    pts = (1 - r1)[:, None] * a + (r1 * (1 - r2))[:, None] * b + (
        r1 * r2
    )[:, None] * c
    if return_normals:
        nrm = cross[fi]
        nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True),
                               1e-12)
        return pts, nrm
    return pts
