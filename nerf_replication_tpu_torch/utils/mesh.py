"""Mesh extraction: dense density sweep → iso-surface → PLY export (port of
``nerf_replication_tpu/utils/mesh.py``).

* :func:`sample_density_grid` queries the COARSE network's σ (relu of its raw
  density) at the ``R^3`` voxel-corner points of the bbox, in chunks of
  ``batch`` points made on the device from the per-axis coordinates (the
  JAX package's ``linspace`` axes, so every point is the same float32): at
  ``resolution 256`` (16.8 M points) only one chunk's points and
  activations are alive. The network runs as plain PyTorch (cuBLAS on the
  card): the JAX package sweeps it outside any Pallas kernel too.
* :func:`marching_tetrahedra` (each cube split into 6 tetrahedra; a sign
  case gives 0, 1 or 2 triangles with edge-interpolated vertices; crossings
  welded into shared vertices) and :func:`write_ply` (binary little-endian)
  are the JAX package's numpy code.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

# 6-tetrahedra decomposition of the unit cube (indices into its 8 corners,
# corner c ↔ offset bits (x=c&1, y=c>>1&1, z=c>>2&1)); all share diagonal 0-7
_TETS = (
    (0, 5, 1, 7), (0, 1, 3, 7), (0, 3, 2, 7),
    (0, 2, 6, 7), (0, 6, 4, 7), (0, 4, 5, 7),
)
_CORNER_OFFSETS = np.array(
    [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], np.float32
)


@torch.no_grad()
def sample_density_grid(network, bbox, resolution: int,
                        batch: int = 65536) -> np.ndarray:
    """[R, R, R] float σ of the COARSE head at voxel-corner grid points,
    computed on the network's device."""
    dev = next(network.parameters()).device
    lo = np.asarray(bbox[0], np.float32)
    hi = np.asarray(bbox[1], np.float32)
    axes = [torch.from_numpy(np.linspace(lo[d], hi[d], resolution,
                                         dtype=np.float32)).to(dev)
            for d in range(3)]
    n = resolution ** 3
    sigma = torch.empty(n, dtype=torch.float32, device=dev)
    dirs = torch.zeros((batch, 3), dtype=torch.float32, device=dev)
    for start in range(0, n, batch):
        idx = torch.arange(start, min(start + batch, n), device=dev)
        pts = torch.stack([axes[0][idx // (resolution * resolution)],
                           axes[1][(idx // resolution) % resolution],
                           axes[2][idx % resolution]], -1)
        raw = network(pts[:, None, :], dirs[:idx.numel()], model="coarse")
        sigma[start:start + idx.numel()] = torch.relu(raw[:, 0, 3])
    return sigma.cpu().numpy().reshape(resolution, resolution, resolution)


def marching_tetrahedra(grid: np.ndarray, level: float, bbox) -> tuple:
    """(vertices [V, 3] world coords, faces [F, 3]) of the iso-surface."""
    R = grid.shape[0]
    lo = np.asarray(bbox[0], np.float64)
    hi = np.asarray(bbox[1], np.float64)
    spacing = (hi - lo) / (R - 1)

    # cube-corner values for every cell, vectorized: [nc, 8]
    idx = np.arange(R - 1)
    ci, cj, ck = np.meshgrid(idx, idx, idx, indexing="ij")
    base = np.stack([ci, cj, ck], -1).reshape(-1, 3)  # [nc, 3]
    corner_vals = np.empty((base.shape[0], 8), grid.dtype)
    for c in range(8):
        o = _CORNER_OFFSETS[c].astype(int)
        corner_vals[:, c] = grid[
            base[:, 0] + o[0], base[:, 1] + o[1], base[:, 2] + o[2]
        ]

    # single-corner cases: the separated corner's 3 edges → one triangle
    SINGLES = {1: 0, 2: 1, 4: 2, 8: 3, 14: 0, 13: 1, 11: 2, 7: 3}
    # two-two splits: 4 crossed edges → a quad → two triangles
    PAIRS = {
        3: ((0, 2), (0, 3), (1, 3), (1, 2)),
        12: ((0, 2), (1, 2), (1, 3), (0, 3)),
        5: ((0, 1), (0, 3), (2, 3), (2, 1)),
        10: ((0, 1), (2, 1), (2, 3), (0, 3)),
        6: ((1, 0), (1, 3), (2, 3), (2, 0)),
        9: ((1, 0), (2, 0), (2, 3), (1, 3)),
    }

    verts, faces = [], []
    for tet in _TETS:
        vals = corner_vals[:, tet]  # [nc, 4]
        inside = vals > level
        case = (
            inside[:, 0] * 1 + inside[:, 1] * 2
            + inside[:, 2] * 4 + inside[:, 3] * 8
        )
        tet_offsets = _CORNER_OFFSETS[list(tet)]

        def edge_point(cells, a, b):
            """Iso-crossing on tet edge (a, b) for the selected cells."""
            va, vb = vals[cells, a], vals[cells, b]
            t = (level - va) / np.where(vb - va == 0, 1e-12, vb - va)
            pa = base[cells] + tet_offsets[a]
            pb = base[cells] + tet_offsets[b]
            return pa + t[:, None] * (pb - pa)

        for code, corner in SINGLES.items():
            cells = np.nonzero(case == code)[0]
            if cells.size == 0:
                continue
            others = [c for c in range(4) if c != corner]
            tri = [edge_point(cells, corner, o) for o in others]
            _append_tris(verts, faces, tri)

        for code, quad in PAIRS.items():
            cells = np.nonzero(case == code)[0]
            if cells.size == 0:
                continue
            p = [edge_point(cells, *e) for e in quad]
            _append_tris(verts, faces, [p[0], p[1], p[2]])
            _append_tris(verts, faces, [p[0], p[2], p[3]])

    if not faces:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    v = np.concatenate(verts, 0)
    f = np.concatenate(faces, 0)

    # weld: identical edge-crossings emitted by neighboring tets/cells merge
    # into shared vertices, so triangles connect into a manifold surface
    # (and the PLY shrinks ~6x). Quantize in index space; crossings of the
    # same grid edge agree to float rounding, so a fine grid snap is safe.
    quant = np.round(v * 1048576.0).astype(np.int64)
    _, first_idx, inverse = np.unique(
        quant, axis=0, return_index=True, return_inverse=True
    )
    v = v[first_idx]
    f = inverse[f]
    # drop triangles degenerated by the weld (two corners on one vertex)
    keep = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
    f = f[keep]

    world = lo + v * spacing
    return world.astype(np.float32), f


def _append_tris(verts, faces, tri_pts):
    """Append one triangle per cell: tri_pts = [p0, p1, p2] each [nc, 3]."""
    nc = tri_pts[0].shape[0]
    v0 = sum(v.shape[0] for v in verts)
    verts.extend(tri_pts)
    idx = np.arange(nc)
    faces.append(np.stack([v0 + idx, v0 + nc + idx, v0 + 2 * nc + idx], -1))
    return v0


def write_ply(path: str, vertices: np.ndarray, faces: np.ndarray) -> str:
    """Binary little-endian PLY (the role trimesh.export plays in the
    reference, mesh_utils.py:44-46)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(vertices)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        f.write(header.encode("ascii"))
        f.write(np.ascontiguousarray(vertices, "<f4").tobytes())
        for tri in np.asarray(faces, np.int32):
            f.write(struct.pack("<B3i", 3, *tri))
    return path


def extract_mesh(network, cfg, out_path: str | None = None) -> str:
    """The pipeline: density sweep at ``cfg.resolution`` (256), iso-surface
    at ``cfg.level`` (32), PLY into ``<result_dir>/mesh.ply``."""
    bbox = np.asarray(cfg.train_dataset.scene_bbox, np.float32)
    grid = sample_density_grid(network, bbox, int(cfg.get("resolution", 256)))
    verts, faces = marching_tetrahedra(grid, float(cfg.get("level", 32.0)),
                                       bbox)
    if out_path is None:
        out_path = os.path.join(cfg.result_dir, "mesh.ply")
    return write_ply(out_path, verts, faces)


def read_ply(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(vertices [V, 3] float32, faces [F, 3] int64) of a :func:`write_ply`
    file."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").split("\n")
    n_v = int(next(l for l in header if l.startswith("element vertex"))
              .split()[-1])
    n_f = int(next(l for l in header if l.startswith("element face"))
              .split()[-1])
    verts = np.frombuffer(data, "<f4", n_v * 3, end).reshape(n_v, 3)
    rec = np.dtype([("n", "u1"), ("idx", "<i4", (3,))])
    faces = np.frombuffer(data, rec, n_f, end + n_v * 12)
    if n_f and not (faces["n"] == 3).all():
        raise ValueError(f"{path}: a face is not a triangle")
    return verts.copy(), faces["idx"].astype(np.int64)
