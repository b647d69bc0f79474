"""Datasets: ShapeNet-format file reader + procedural synthetic shapes
(copy of ``octfusion_tpu/data/dataset.py``: numpy on the host, item for
item the same arrays; the capacity checks read this package's
``OctreeSpec`` / ``GraphSpec``).

ShapeNet format follows the reference's per-shape directory layout
(``datasets/dualoctree_snet.py:110-168``): ``pointcloud.npz``
(points, normals) and ``sdf.npz`` (points, grad, sdf), with points scaled by
``point_scale`` into [-1, 1] at load time (``dualoctree_snet.py:36-58``).

The synthetic dataset generates unions of primitives (sphere / box / torus)
with exact SDFs: enough signal to train end to end without ShapeNet.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..octree.dual_graph import (DIR_TABLE, INTER_COL, INTER_DIR, INTER_ROW,
                                 REMAP, GraphSpec)
from .shapenet import synset_to_label


class ShapeNetDataset:
    """Reads the reference's preprocessed per-shape npz files."""

    def __init__(self, location: str, filelist: str, point_scale: float = 0.5,
                 point_sample_num: int = 10000, points_per_shape: int = 65536,
                 load_sdf: bool = True, load_split_small: bool = False,
                 load_pointcloud: bool = True, in_memory: bool = False,
                 load_color: bool = False):
        self.load_color = load_color
        self.location = location
        self._cache = {} if in_memory else None
        self.point_scale = point_scale
        self.point_sample_num = point_sample_num
        self.points_per_shape = points_per_shape
        self.load_sdf = load_sdf
        self.load_split_small = load_split_small
        self.load_pointcloud = load_pointcloud
        with open(filelist) as fh:
            lines = [ln.split()[0] for ln in fh if ln.strip()]
        self.filenames = lines
        # class label from the synset prefix (`solver/dataset.py:50-67`)
        self.labels = [synset_to_label(fn.split("/")[0]) for fn in lines]

    def __len__(self):
        return len(self.filenames)

    def _load(self, path):
        if self._cache is not None:
            if path not in self._cache:
                self._cache[path] = {k: v for k, v in np.load(path).items()}
            return self._cache[path]
        return np.load(path)

    def __getitem__(self, idx: int) -> Dict:
        fn = os.path.join(self.location, self.filenames[idx])
        rng = np.random.RandomState()
        out = {"filename": self.filenames[idx], "label": self.labels[idx]}
        if self.load_pointcloud:
            raw = self._load(os.path.join(fn, "pointcloud.npz"))
            pts = raw["points"].astype(np.float32) / self.point_scale
            nrm = raw["normals"].astype(np.float32)
            sel = rng.randint(0, len(pts), size=self.points_per_shape)
            out["points"] = np.clip(pts[sel], -1, 1)
            out["normals"] = nrm[sel]
            if self.load_color:
                # per-point colors aligned with the pointcloud
                # (`dualoctree_snet.py:133-136`)
                craw = self._load(os.path.join(fn, "color.npz"))
                out["point_colors"] = craw["colors"][sel].astype(np.float32)
        if self.load_split_small:
            raw = self._load(os.path.join(fn, "split_small.npz"))
            out["split_small"] = raw["split_small"].astype(np.float32)
        if self.load_sdf:
            sdf_raw = self._load(os.path.join(fn, "sdf.npz"))
            spts = sdf_raw["points"].astype(np.float32) / self.point_scale
            sel2 = rng.randint(0, len(spts), size=self.point_sample_num)
            out["pos"] = spts[sel2]
            out["sdf"] = sdf_raw["sdf"][sel2].astype(np.float32)
            out["grad"] = sdf_raw["grad"][sel2].astype(np.float32)
        return out


def _sd_sphere(p, c, r):
    return np.linalg.norm(p - c, axis=-1) - r


def _sd_box(p, c, b):
    q = np.abs(p - c) - b
    return np.linalg.norm(np.maximum(q, 0), axis=-1) + np.minimum(
        q.max(-1), 0.0
    )


def _sd_torus(p, c, R, r):
    d = p - c
    q = np.stack([np.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2) - R, d[..., 2]], -1)
    return np.linalg.norm(q, axis=-1) - r


class SyntheticDataset:
    """Procedural shapes with exact SDFs: per index, a deterministic union
    of 1-3 primitives.  Surface points found by sphere-tracing random rays /
    projecting near-surface samples along the SDF gradient.

    With ``class_families=True`` the label (``idx % num_classes``) selects a
    geometrically distinct shape family (sphere / box / torus / dumbbell /
    cross), making the labels *meaningful* — the stand-in for the
    reference's 5-category conditional ShapeNet workload
    (the reference's ``configs/octfusion_snet_cond.yaml:17-27``,
    ``scripts/run_snet_cond.sh``): class-conditional generation can then be
    checked by nearest-reference-class purity."""

    def __init__(self, size: int = 1000, point_sample_num: int = 10000,
                 points_per_shape: int = 65536, num_classes: int = 5,
                 load_color: bool = False, cache: bool = True,
                 class_families: bool = False):
        self.size = size
        self.point_sample_num = point_sample_num
        self.points_per_shape = points_per_shape
        self.num_classes = num_classes
        self.class_families = class_families
        self.load_color = load_color
        # items are deterministic functions of idx, and the Newton-projection
        # surface sampling costs ~0.5 s/item on one core — cache epochs 2+
        # (~0.3 MB/item; a dict write under the GIL is atomic, so worker
        # threads at worst duplicate one compute)
        self._cache: Optional[Dict[int, Dict]] = {} if cache else None

    def __len__(self):
        return self.size

    def _make_sdf(self, rng):
        prims = []
        n = rng.randint(1, 4)
        for _ in range(n):
            kind = rng.randint(0, 3)
            c = rng.uniform(-0.3, 0.3, size=3)
            if kind == 0:
                r = rng.uniform(0.15, 0.45)
                prims.append(lambda p, c=c, r=r: _sd_sphere(p, c, r))
            elif kind == 1:
                b = rng.uniform(0.1, 0.4, size=3)
                prims.append(lambda p, c=c, b=b: _sd_box(p, c, b))
            else:
                R = rng.uniform(0.2, 0.4)
                r = rng.uniform(0.05, 0.15)
                prims.append(lambda p, c=c, R=R, r=r: _sd_torus(p, c, R, r))

        def sdf(p):
            return np.minimum.reduce([f(p) for f in prims])

        return sdf

    def _make_family_sdf(self, rng, family: int):
        """One of 5 tightly-clustered families (see class docstring); shape
        parameters jitter within a family but classes stay separable under
        Chamfer distance (asserted by tests/test_conditional.py)."""
        c = rng.uniform(-0.08, 0.08, size=3)
        if family == 0:      # sphere
            r = rng.uniform(0.35, 0.5)
            prims = [lambda p: _sd_sphere(p, c, r)]
        elif family == 1:    # box
            b = rng.uniform(0.28, 0.42, size=3)
            prims = [lambda p: _sd_box(p, c, b)]
        elif family == 2:    # torus (in the xy-plane)
            R, r = rng.uniform(0.35, 0.45), rng.uniform(0.1, 0.16)
            prims = [lambda p: _sd_torus(p, c, R, r)]
        elif family == 3:    # dumbbell: two spheres split along x
            dx = rng.uniform(0.38, 0.5)
            r = rng.uniform(0.18, 0.26)
            prims = [
                lambda p: _sd_sphere(p, c + np.array([dx, 0, 0]), r),
                lambda p: _sd_sphere(p, c - np.array([dx, 0, 0]), r),
            ]
        else:                # cross: two elongated boxes
            l = rng.uniform(0.5, 0.62)
            w = rng.uniform(0.1, 0.16)
            prims = [
                lambda p: _sd_box(p, c, np.array([l, w, w])),
                lambda p: _sd_box(p, c, np.array([w, l, w])),
            ]

        def sdf(p):
            return np.minimum.reduce([f(p) for f in prims])

        return sdf

    @staticmethod
    def _gradient(sdf, p, eps=1e-4):
        g = np.stack(
            [
                sdf(p + np.array([eps, 0, 0])) - sdf(p - np.array([eps, 0, 0])),
                sdf(p + np.array([0, eps, 0])) - sdf(p - np.array([0, eps, 0])),
                sdf(p + np.array([0, 0, eps])) - sdf(p - np.array([0, 0, eps])),
            ],
            -1,
        ) / (2 * eps)
        n = np.linalg.norm(g, axis=-1, keepdims=True)
        return g / np.maximum(n, 1e-9)

    def _surface_points(self, sdf, rng, n):
        # project random points onto the zero level set (few Newton steps)
        p = rng.uniform(-0.85, 0.85, size=(int(n * 1.5), 3))
        for _ in range(12):
            d = sdf(p)[:, None]
            g = self._gradient(sdf, p)
            p = p - d * g
        d = np.abs(sdf(p))
        ok = d < 1e-3
        p = p[ok][:n]
        while len(p) < n:  # top up if projection lost too many
            extra = rng.uniform(-0.85, 0.85, size=(n, 3))
            for _ in range(12):
                dd = sdf(extra)[:, None]
                extra = extra - dd * self._gradient(sdf, extra)
            extra = extra[np.abs(sdf(extra)) < 1e-3]
            p = np.concatenate([p, extra])[: n]
        return p

    def __getitem__(self, idx: int) -> Dict:
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        rng = np.random.RandomState(idx * 9176 + 13)
        label = idx % self.num_classes
        sdf = (self._make_family_sdf(rng, label) if self.class_families
               else self._make_sdf(rng))
        surf = self._surface_points(sdf, rng, self.points_per_shape)
        normals = self._gradient(sdf, surf)
        # SDF supervision: near-surface + uniform volume samples
        n_half = self.point_sample_num // 2
        near = surf[rng.randint(0, len(surf), n_half)] + rng.normal(
            0, 0.03, size=(n_half, 3)
        )
        vol = rng.uniform(-0.95, 0.95, size=(self.point_sample_num - n_half, 3))
        pos = np.concatenate([near, vol]).astype(np.float32)
        pos = np.clip(pos, -1, 1)
        out = {
            "filename": f"synthetic/{idx}",
            "label": label,
            "points": np.clip(surf, -1, 1).astype(np.float32),
            "normals": normals.astype(np.float32),
            "pos": pos,
            "sdf": sdf(pos).astype(np.float32),
            "grad": self._gradient(sdf, pos).astype(np.float32),
        }
        if self.load_color:
            # analytic position-based RGB field (exact supervision)
            out["point_colors"] = (
                (np.clip(surf, -1, 1) + 1.0) / 2.0
            ).astype(np.float32)
        if self._cache is not None:
            self._cache[idx] = out
        return out


def octree_node_counts(points: np.ndarray, depth: int,
                       full_depth: int) -> Dict[int, int]:
    """Host-side per-depth *allocated* node counts for a point cloud in
    [-1, 1]^3 — the numbers ``build_octree`` will produce (depth d > full
    allocates 8 children per occupied node of d-1; see
    `octree/octree.py` layout invariants)."""
    size = 2 ** depth
    xyz = np.clip(
        np.floor((points + 1.0) * (size / 2.0)).astype(np.int64), 0, size - 1
    )
    counts = {}
    for d in range(depth, full_depth, -1):
        shift = depth - (d - 1)
        parent = (
            (xyz[:, 0] >> shift) << (2 * (d - 1))
            | (xyz[:, 1] >> shift) << (d - 1)
            | (xyz[:, 2] >> shift)
        )
        counts[d] = 8 * len(np.unique(parent))
    return counts


def dual_graph_edge_counts(points: np.ndarray, depth: int, full_depth: int,
                           ) -> Dict[int, int]:
    """Host-side per-level *carried* (pre-self-loop) directed edge counts of
    the dual graph a point cloud will produce — the exact numbers
    ``expand_level_edges`` checks against ``e_cap(d)``
    (`octree/dual_graph.py` refinement: leaf-leaf edges carry, edges with an
    internal endpoint expand to 4 face children, every subdivided node adds
    24 sibling edges)."""
    size = 2 ** depth
    xyz = np.clip(
        np.floor((points + 1.0) * (size / 2.0)).astype(np.int64), 0, size - 1
    )

    def pack(x, y, z):
        return (x << 40) | (y << 20) | z

    # occupied (= subdividing) cells per depth
    occ = {}
    for d in range(full_depth, depth):
        sh = depth - d
        occ[d] = np.unique(
            pack(xyz[:, 0] >> sh, xyz[:, 1] >> sh, xyz[:, 2] >> sh)
        )

    # octant id o = (dx<<2) | (dy<<1) | dz (per DIR_TABLE's face convention)
    OCT = np.arange(8)
    ODX, ODY, ODZ = (OCT >> 2) & 1, (OCT >> 1) & 1, OCT & 1

    # dense level at full_depth: 6-neighbour directed edges over ALL cells
    fd = full_depth
    n = 2 ** fd
    ax = np.arange(n, dtype=np.int64)
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    cells = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], -1)
    ngh = np.array([[0, 0, 1], [0, 0, -1], [0, 1, 0], [0, -1, 0],
                    [1, 0, 0], [-1, 0, 0]], np.int64)
    nb = cells[:, None, :] + ngh[None]                 # [N, 6, 3]
    inb = ((nb >= 0) & (nb < n)).all(-1)
    uu = np.repeat(cells, 6, 0)[inb.ravel()]
    vv = nb.reshape(-1, 3)[inb.ravel()]
    dirs = np.tile(np.arange(6, dtype=np.int64), len(cells))[inb.ravel()]
    ud = np.full(len(uu), fd, np.int64)
    vd = ud.copy()
    u = uu.T.copy()                                    # [3, E]
    v = vv.T.copy()
    counts = {fd: len(dirs)}

    dirtab = np.asarray(DIR_TABLE, np.int64)
    remap = np.asarray(REMAP, np.int64)

    for k in range(fd, depth):
        o = occ[k]
        u_int = (ud == k) & np.isin(pack(u[0], u[1], u[2]), o,
                                    assume_unique=False)
        v_int = (vd == k) & np.isin(pack(v[0], v[1], v[2]), o)

        def children_on_face(c, octants):
            # c [3, E], octants [E, 4] -> coords [3, E, 4] at depth k+1
            d4 = np.stack([ODX[octants], ODY[octants], ODZ[octants]])
            return c[:, :, None] * 2 + d4

        segs = []  # (u3, ud, v3, vd, dir)
        keep = ~u_int & ~v_int
        segs.append((u[:, keep], ud[keep], v[:, keep], vd[keep], dirs[keep]))

        m = u_int & ~v_int
        cu = children_on_face(u[:, m], dirtab[dirs[m]])
        segs.append((
            cu.reshape(3, -1), np.full(4 * m.sum(), k + 1, np.int64),
            np.repeat(v[:, m], 4, 1), np.repeat(vd[m], 4),
            np.repeat(dirs[m], 4),
        ))

        m = ~u_int & v_int
        cv = children_on_face(v[:, m], dirtab[remap[dirs[m]]])
        segs.append((
            np.repeat(u[:, m], 4, 1), np.repeat(ud[m], 4),
            cv.reshape(3, -1), np.full(4 * m.sum(), k + 1, np.int64),
            np.repeat(dirs[m], 4),
        ))

        m = u_int & v_int
        cu = children_on_face(u[:, m], dirtab[dirs[m]])
        cv = children_on_face(v[:, m], dirtab[remap[dirs[m]]])
        segs.append((
            cu.reshape(3, -1), np.full(4 * m.sum(), k + 1, np.int64),
            cv.reshape(3, -1), np.full(4 * m.sum(), k + 1, np.int64),
            np.repeat(dirs[m], 4),
        ))

        # 24 sibling edges inside every new 8-block
        ox, oy, oz = o >> 40, (o >> 20) & 0xFFFFF, o & 0xFFFFF
        oc = np.stack([ox, oy, oz])                    # [3, S]
        ir = np.asarray(INTER_ROW, np.int64)
        ic = np.asarray(INTER_COL, np.int64)
        su = (oc[:, :, None] * 2 + np.stack([ODX[ir], ODY[ir], ODZ[ir]])[:, None, :])
        sv = (oc[:, :, None] * 2 + np.stack([ODX[ic], ODY[ic], ODZ[ic]])[:, None, :])
        ns = oc.shape[1] * 24
        segs.append((
            su.reshape(3, -1), np.full(ns, k + 1, np.int64),
            sv.reshape(3, -1), np.full(ns, k + 1, np.int64),
            np.tile(np.asarray(INTER_DIR, np.int64), oc.shape[1]),
        ))

        u = np.concatenate([s[0] for s in segs], 1)
        ud = np.concatenate([s[1] for s in segs])
        v = np.concatenate([s[2] for s in segs], 1)
        vd = np.concatenate([s[3] for s in segs])
        dirs = np.concatenate([s[4] for s in segs])
        counts[k + 1] = len(dirs)
    return counts


def fits_capacity(points: np.ndarray, spec, edge_factor: int = 0) -> bool:
    """True iff a single-sample octree built from ``points`` fits the static
    per-depth capacities of ``spec`` (an :class:`OctreeSpec`, batch 1).

    With ``edge_factor > 0`` additionally checks the dual-graph edge
    capacities ``edge_factor * g_cap(d)`` (what ``expand_level_edges``
    flags as overflow); node caps alone cannot see those."""
    counts = octree_node_counts(points, spec.depth, spec.full_depth)
    if not all(counts[d] <= spec.node_caps[d]
               for d in range(spec.full_depth + 1, spec.depth + 1)):
        return False
    if edge_factor > 0:
        gspec = GraphSpec(spec, edge_factor)
        ecounts = dual_graph_edge_counts(
            points, spec.depth, spec.full_depth
        )
        if any(ecounts[d] > gspec.e_cap(d)
               for d in range(spec.full_depth + 1, spec.depth + 1)):
            return False
    return True


class CapacityFilteredDataset:
    """Wrapper that skips samples whose octree would overflow the static
    capacities (the loader-side consumer of the overflow contract at
    ``octree/octree.py``); the device-side flags remain the backstop
    for anything this pre-check cannot see (edge caps)."""

    def __init__(self, base, spec, max_probe: int = 64,
                 edge_factor: int = 0):
        self.base = base
        self.spec = spec
        self.max_probe = max_probe
        self.edge_factor = edge_factor
        self._warned = set()

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx: int) -> Dict:
        n = len(self.base)
        for k in range(min(self.max_probe, n)):
            s = self.base[(idx + k) % n]
            if "points" not in s or fits_capacity(
                s["points"], self.spec, self.edge_factor
            ):
                return s
            fn = s.get("filename", (idx + k) % n)
            if fn not in self._warned:
                self._warned.add(fn)
                print(f"[warn] sample {fn} exceeds octree capacity; skipped")
        raise RuntimeError(
            f"{self.max_probe} consecutive samples exceed the octree "
            f"capacities {self.spec.node_caps}; raise capacity.finest_cap"
        )


def collate(samples: List[Dict]) -> Dict:
    """Stack per-sample dicts into fixed-shape batch arrays."""
    out = {
        "label": np.asarray([s["label"] for s in samples], np.int32),
        "filename": [s["filename"] for s in samples],
    }
    if "points" in samples[0]:
        out["points"] = np.stack([s["points"] for s in samples])
        out["normals"] = np.stack([s["normals"] for s in samples])
    if "pos" in samples[0]:
        out["pos"] = np.stack([s["pos"] for s in samples])
        out["sdf"] = np.stack([s["sdf"] for s in samples])
        out["grad"] = np.stack([s["grad"] for s in samples])
    if "split_small" in samples[0]:
        out["split_small"] = np.stack([s["split_small"] for s in samples])
    if "point_colors" in samples[0]:
        out["point_colors"] = np.stack([s["point_colors"] for s in samples])
    return out


def get_dataset(cfg) -> object:
    if cfg.name == "synthetic":
        return SyntheticDataset(
            point_sample_num=cfg.point_sample_num,
            points_per_shape=cfg.points_per_shape,
            load_color=cfg.load_color,
            class_families=cfg.class_families,
        )
    if cfg.name == "shapenet":
        return ShapeNetDataset(
            cfg.location, cfg.filelist, cfg.point_scale,
            cfg.point_sample_num, cfg.points_per_shape, cfg.load_sdf,
            load_split_small=cfg.load_split_small,
            load_pointcloud=cfg.load_pointcloud,
            in_memory=cfg.in_memory,
            load_color=cfg.load_color,
        )
    raise ValueError(cfg.name)
