"""Mesh extraction from a density field by marching tetrahedra (the port's
copy of `genefaceplusplus_tpu/utils/geometry.py`, numpy).

The reference's `extract_geometry` runs mcubes' marching cubes over a
sampled sigma grid; mcubes is absent, so each grid cube splits into 6
tetrahedra with a 16-case table: a watertight iso-surface of the same
field, triangulated more densely. Debug and visualisation tooling, on the
host; `extract_geometry` takes any density callable (for a head, the
port's `RADNeRF.density` wrapped to numpy).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

# cube-corner offsets (binary order: bit0=x, bit1=y, bit2=z)
_CORNERS = np.asarray(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
     [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]], np.int64
)
# 6-tet decomposition of a cube around the 0-7 diagonal
_TETS = np.asarray(
    [[0, 5, 1, 7], [0, 1, 3, 7], [0, 3, 2, 7],
     [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7]], np.int64
)
# tet edges as (vertex, vertex) index pairs within the tet
_TET_EDGES = np.asarray(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int64
)
# triangle table: case (4-bit inside mask) -> list of triangles, each a
# triple of tet-edge indices (into _TET_EDGES). Orientation is not
# guaranteed consistent (debug-grade surface).
_TRI_TABLE = {
    0b0001: [(0, 1, 2)],
    0b0010: [(0, 3, 4)],
    0b0100: [(1, 3, 5)],
    0b1000: [(2, 4, 5)],
    0b0011: [(1, 2, 3), (3, 2, 4)],
    0b0101: [(0, 2, 3), (3, 2, 5)],
    0b1001: [(0, 1, 4), (4, 1, 5)],
    0b0110: [(0, 1, 4), (1, 5, 4)],
    0b1010: [(0, 2, 3), (2, 5, 3)],
    0b1100: [(1, 2, 3), (2, 4, 3)],
    0b0111: [(2, 4, 5)],
    0b1011: [(1, 5, 3)],
    0b1101: [(0, 4, 3)],
    0b1110: [(0, 1, 2)],
}


def marching_tetrahedra(grid: np.ndarray, threshold: float,
                        bound: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Iso-surface of a [R, R, R] scalar grid at `threshold`.

    Returns (vertices [V, 3] in [-bound, bound], triangles [T, 3] int)."""
    g = np.asarray(grid, np.float32)
    R = g.shape[0]
    assert g.shape == (R, R, R)
    if R < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    # cube corner values/coords: [Nc, 8]
    base = np.stack(np.mgrid[0 : R - 1, 0 : R - 1, 0 : R - 1], -1).reshape(-1, 3)
    corner_idx = base[:, None, :] + _CORNERS[None]  # [Nc, 8, 3]
    vals = g[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]  # [Nc, 8]

    # tets: [Nc*6, 4] values + corner grid coords
    tv = vals[:, _TETS].reshape(-1, 4)  # [Nt, 4]
    tc = corner_idx[:, _TETS, :].reshape(-1, 4, 3).astype(np.float32)  # [Nt, 4, 3]

    inside = tv > threshold  # [Nt, 4]
    case = (inside * (1 << np.arange(4))[None]).sum(-1)  # [Nt]

    verts_out = []
    tris_out = []
    v_count = 0
    for c, tris in _TRI_TABLE.items():
        sel = np.nonzero(case == c)[0]
        if len(sel) == 0:
            continue
        sv, sc = tv[sel], tc[sel]  # [M, 4], [M, 4, 3]
        # interpolated point on each of the 6 tet edges
        e0, e1 = _TET_EDGES[:, 0], _TET_EDGES[:, 1]
        v0, v1 = sv[:, e0], sv[:, e1]  # [M, 6]
        denom = np.where(np.abs(v1 - v0) < 1e-12, 1e-12, v1 - v0)
        t = np.clip((threshold - v0) / denom, 0.0, 1.0)[..., None]
        p = sc[:, e0] + t * (sc[:, e1] - sc[:, e0])  # [M, 6, 3]
        for tri in tris:
            tri_pts = p[:, list(tri)]  # [M, 3, 3]
            M = len(tri_pts)
            verts_out.append(tri_pts.reshape(-1, 3))
            tris_out.append(np.arange(3 * M).reshape(M, 3) + v_count)
            v_count += 3 * M

    if not verts_out:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    verts = np.concatenate(verts_out)
    tris = np.concatenate(tris_out)

    # weld duplicate vertices (each edge point appears in up to ~6 tets)
    key = np.round(verts * 1e4).astype(np.int64)
    _, uniq_idx, inverse = np.unique(
        key.view([("x", np.int64), ("y", np.int64), ("z", np.int64)]).reshape(-1),
        return_index=True, return_inverse=True,
    )
    verts = verts[uniq_idx]
    tris = inverse[tris]

    # grid index -> world coords in [-bound, bound]
    verts = verts / (R - 1) * 2.0 * bound - bound
    return verts.astype(np.float32), tris.astype(np.int64)


def extract_geometry(
    density_fn: Callable[[np.ndarray], np.ndarray],
    resolution: int = 128,
    threshold: float = 10.0,
    bound: float = 1.0,
    chunk: int = 65536,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample `density_fn([M, 3]) -> [M]` on a grid and extract the
    iso-surface mesh (modules/radnerfs/utils.py:400-430 equivalent)."""
    xs = np.linspace(-bound, bound, resolution, dtype=np.float32)
    pts = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3)
    out = np.empty(len(pts), np.float32)
    for i in range(0, len(pts), chunk):
        out[i : i + chunk] = np.asarray(density_fn(pts[i : i + chunk])).reshape(-1)
    grid = out.reshape(resolution, resolution, resolution)
    return marching_tetrahedra(grid, threshold, bound)
