"""BFM mesh rendering: texture, vertex normals, SH lighting and a z-buffered
software rasteriser, the SECC render path (port of
`genefaceplusplus_tpu/data/bfm_render.py`).

  * the SH constants and lighting (deep_3drecon bfm.py:20-24, :129-198)
  * `rasterize_projected`: a z-buffer rasteriser with perspective-correct
    barycentric interpolation, vectorised over faces (each face scans its
    patch x patch window, cut to the power of two that holds its bbox; a
    far-to-near painter's assignment resolves depth; equal to JAX's
    arrays), shared by `rasterize_mesh` (BFM camera) and
    `data/synthetic_face.py` (the renderer's pinhole)
  * `SECCRenderer` (secc_renderer.py:10-60): the mesh with per-vertex NCC
    colours, -> (mask, secc in [-1, 1])

Host numpy, as in JAX (SECC is a debug panel); the pose rotation is the
port's `utils/rotation.py:compute_bfm_rotation`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from genefaceplusplus_tpu_torch.utils.rotation import compute_bfm_rotation

# SH irradiance constants (bfm.py:20-24)
SH_A = (np.pi, 2.0 * np.pi / np.sqrt(3.0), 2.0 * np.pi / np.sqrt(8.0))
SH_C = (
    1.0 / np.sqrt(4.0 * np.pi),
    np.sqrt(3.0) / np.sqrt(4.0 * np.pi),
    3.0 * np.sqrt(5.0) / np.sqrt(12.0 * np.pi),
)
# ambient offset added to the first band of every channel (bfm.py:32,87,181)
INIT_LIT = np.array([0.8, 0, 0, 0, 0, 0, 0, 0, 0], np.float32)


def compute_texture(tex_base: np.ndarray, mean_tex: np.ndarray,
                    tex_coeff: np.ndarray, normalize: bool = True) -> np.ndarray:
    """[80] tex coeff -> per-vertex RGB texture [N, 3] (bfm.py:129-141)."""
    tex = tex_base @ np.asarray(tex_coeff, np.float32) + mean_tex
    if normalize:
        tex = tex / 255.0
    return tex.reshape(-1, 3)


def compute_vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Vertex normals [N, 3]: the normalised sum of the unit normals of the
    faces around each vertex (bfm.py:144-164's point_buf adjacency, as a
    scatter-add over faces)."""
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.int64)
    e1 = v[f[:, 0]] - v[f[:, 1]]
    e2 = v[f[:, 1]] - v[f[:, 2]]
    fn = np.cross(e1, e2)
    fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)
    vn = np.zeros_like(v)
    for k in range(3):
        np.add.at(vn, f[:, k], fn)
    return vn / np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-12)


def compute_color(texture: np.ndarray, normals: np.ndarray,
                  gamma: np.ndarray) -> np.ndarray:
    """SH-lit per-vertex color [N, 3] (bfm.py:167-198).

    texture [N,3] in [0,1]; normals [N,3] (rotated); gamma [27] SH coeffs."""
    a, c = SH_A, SH_C
    g = np.asarray(gamma, np.float32).reshape(3, 9) + INIT_LIT[None]
    g = g.T  # [9, 3]
    n = np.asarray(normals, np.float32)
    nx, ny, nz = n[:, :1], n[:, 1:2], n[:, 2:]
    Y = np.concatenate([
        a[0] * c[0] * np.ones_like(nx),
        -a[1] * c[1] * ny,
        a[1] * c[1] * nz,
        -a[1] * c[1] * nx,
        a[2] * c[2] * nx * ny,
        -a[2] * c[2] * ny * nz,
        0.5 * a[2] * c[2] / np.sqrt(3.0) * (3.0 * nz ** 2 - 1.0),
        -a[2] * c[2] * nx * nz,
        0.5 * a[2] * c[2] * (nx ** 2 - ny ** 2),
    ], axis=-1)  # [N, 9]
    shading = Y @ g  # [N, 3]
    return shading * np.asarray(texture, np.float32)


def rasterize_projected(
    pts: np.ndarray,  # [N, 2] pixel coords (x=col, y=row)
    z: np.ndarray,  # [N] positive camera depth per vertex
    faces: np.ndarray,  # [F, 3] int
    attrs: np.ndarray,  # [N, C] per-vertex attributes (e.g. color)
    H: int,
    W: int,
    patch: int = 16,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Z-buffer rasterise already-projected vertices with perspective-correct
    barycentric attribute interpolation. Vectorised over faces: each face
    rasterises a fixed patch×patch pixel window around its bbox (triangles
    are a few px at 224-512 render sizes), far-to-near painter's assignment
    resolves depth. Projection-agnostic core shared by rasterize_mesh (BFM
    convention) and data/synthetic_face.py (the NeRF pixel_rays pinhole).

    Returns (mask [H,W] bool, depth [H,W] f32 (+inf empty), image [H,W,C]).
    """
    pts = np.asarray(pts, np.float32)
    z = np.asarray(z, np.float32)
    f = np.asarray(faces, np.int64)
    tri = pts[f]  # [F, 3, 2]
    tz = np.maximum(z[f], 1e-4)  # [F, 3]
    ta = np.asarray(attrs, np.float32)[f]  # [F, 3, C]

    # cull: degenerate / fully offscreen / behind-camera faces
    x0 = np.floor(tri[..., 0].min(1)).astype(np.int64)
    y0 = np.floor(tri[..., 1].min(1)).astype(np.int64)
    x1 = np.ceil(tri[..., 0].max(1)).astype(np.int64)
    y1 = np.ceil(tri[..., 1].max(1)).astype(np.int64)
    keep = (x1 >= 0) & (y1 >= 0) & (x0 < W) & (y0 < H)
    keep &= (x1 - x0 <= patch) & (y1 - y0 <= patch)  # window cap
    keep &= (z[f] > 1e-4).all(1)
    tri, tz, ta, x0, y0 = tri[keep], tz[keep], ta[keep], x0[keep], y0[keep]
    F = len(tri)
    C = ta.shape[-1]
    mask = np.zeros((H, W), bool)
    depth = np.full((H, W), np.inf, np.float32)
    img = np.zeros((H, W, C), np.float32)
    if F == 0:
        return mask, depth, img

    # each face scans the patch x patch window at its bbox's corner; no pixel
    # past the bbox's far edge can be inside (but for a degenerate face), so
    # faces are bucketed by extent and each scans the smallest power-of-two
    # window that holds its bbox (the same candidates, the same
    # per-candidate arithmetic)
    ext = np.maximum(x1[keep] - x0, y1[keep] - y0) + 1
    (ax, ay), (bx, by), (cx, cy) = tri[:, 0].T, tri[:, 1].T, tri[:, 2].T
    det = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)
    ext[np.abs(det) < 1e-9] = patch  # a degenerate face's clamped det can take its whole window
    cands = []
    for s in sorted({min(patch, 1 << int(np.ceil(np.log2(max(e, 1))))) for e in np.unique(ext)}):
        sel = np.nonzero((ext > s // 2) & (ext <= s) if s < patch else ext > s // 2)[0]
        if len(sel):
            cands.append(_candidates(tri[sel], tz[sel], ta[sel], x0[sel], y0[sel], sel, s, patch, H, W))
    fi, pi, pz, pa, px, py = (np.concatenate(c) for c in zip(*cands))

    # painter's algorithm: candidates far -> near, ties in (face, window
    # pixel) order, assigned in order
    order = np.lexsort((pi, fi, -pz))
    yy, xx = py[order], px[order]
    img[yy, xx] = pa[order]
    depth[yy, xx] = pz[order]
    mask[yy, xx] = True
    return mask, depth, img


def _candidates(tri, tz, ta, x0, y0, faces, s: int, patch: int, H: int, W: int):
    """The inside pixels of each face's s x s window: (face, its index in
    the patch x patch window, depth, attributes, x, y), one entry each."""
    F = len(tri)
    dy, dx = np.mgrid[0:s, 0:s]
    px = (x0[:, None, None] + dx[None]).reshape(F, -1)  # [F, s*s]
    py = (y0[:, None, None] + dy[None]).reshape(F, -1)
    pxf = px + 0.5
    pyf = py + 0.5

    # barycentric coords (vectorised): T @ [l1, l2] = p - c
    ax, ay = tri[:, 0, 0], tri[:, 0, 1]
    bx, by = tri[:, 1, 0], tri[:, 1, 1]
    cx, cy = tri[:, 2, 0], tri[:, 2, 1]
    det = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)
    det = np.where(np.abs(det) < 1e-9, 1e-9, det)
    l1 = ((by - cy)[:, None] * (pxf - cx[:, None]) + (cx - bx)[:, None] * (pyf - cy[:, None])) / det[:, None]
    l2 = ((cy - ay)[:, None] * (pxf - cx[:, None]) + (ax - cx)[:, None] * (pyf - cy[:, None])) / det[:, None]
    l3 = 1.0 - l1 - l2
    inside = (l1 >= -1e-5) & (l2 >= -1e-5) & (l3 >= -1e-5)
    inside &= (px >= 0) & (px < W) & (py >= 0) & (py < H)
    fi, pi = np.nonzero(inside)
    l1, l2, l3 = l1[fi, pi], l2[fi, pi], l3[fi, pi]

    # perspective-correct interpolation of z and attributes
    w1, w2, w3 = l1 / tz[fi, 0], l2 / tz[fi, 1], l3 / tz[fi, 2]
    pz = 1.0 / np.maximum(w1 + w2 + w3, 1e-12)
    pa = (w1[:, None] * ta[fi, 0] + w2[:, None] * ta[fi, 1] + w3[:, None] * ta[fi, 2]) * pz[:, None]
    window = (pi // s) * patch + pi % s
    return faces[fi], window, pz, pa, px[fi, pi], py[fi, pi]


def rasterize_mesh(
    vertices_cam: np.ndarray,  # [N, 3], camera space, +z away from camera
    faces: np.ndarray,  # [F, 3] int
    attrs: np.ndarray,  # [N, C] per-vertex attributes (e.g. color)
    size: int = 224,
    focal: float = 1015.0,
    center: float = 112.0,
    patch: int = 16,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Perspective-project (BFM camera convention, y up) + z-buffer
    rasterise. Returns (mask [S,S] bool, depth [S,S], image [S,S,C])."""
    v = np.asarray(vertices_cam, np.float32)
    z = np.maximum(v[:, 2], 1e-4)
    sx = (v[:, 0] * focal / z + center) * (size / (2.0 * center))
    sy = (size - 1.0) - (v[:, 1] * focal / z + center) * (size / (2.0 * center))
    pts = np.stack([sx, sy], -1)  # [N, 2] pixel coords
    return rasterize_projected(pts, z, faces, attrs, size, size, patch=patch)


class SECCRenderer:
    """SECC map renderer (secc_renderer.py:10-60): BFM mesh rasterised with
    per-vertex NCC colors, eye faces removed; -> (mask, secc in [-1, 1]).

    Needs the full BFM basis (mean_shape/id_base/exp_base over the mesh +
    face_buf); pass them explicitly or via a Face3DHelper carrying full
    buffers. ncc_code defaults to min-max normalised canonical positions.
    """

    def __init__(self, mean_shape, id_base, exp_base, faces,
                 ncc_code: Optional[np.ndarray] = None,
                 camera_distance: float = 10.0,
                 focal: float = 1015.0, center: float = 112.0,
                 size: Optional[int] = None):
        self.mean_shape = np.asarray(mean_shape, np.float32).reshape(-1, 3)
        self.id_base = np.asarray(id_base, np.float32)
        self.exp_base = np.asarray(exp_base, np.float32)
        self.faces = np.asarray(faces, np.int64)
        self.camera_distance = camera_distance
        self.focal, self.center = focal, center
        self.size = size or int(2 * center)
        if ncc_code is None:
            v = self.mean_shape
            lo, hi = v.min(0), v.max(0)
            ncc_code = (v - lo) / np.maximum(hi - lo, 1e-8)
        self.ncc_code = np.asarray(ncc_code, np.float32)

    def vertices(self, id_coeff, exp_coeff, euler, trans) -> np.ndarray:
        """Posed camera-space vertices (bfm.py:236-239,255-265 semantics)."""
        n = self.mean_shape.size
        shape = (self.mean_shape.reshape(-1)
                 + self.id_base[:n] @ np.asarray(id_coeff, np.float32)
                 + self.exp_base[:n] @ np.asarray(exp_coeff, np.float32)).reshape(-1, 3)
        angles = torch.as_tensor(np.asarray(euler, np.float32))[None]
        rot = compute_bfm_rotation(angles)[0].numpy()
        posed = shape @ rot + np.asarray(trans, np.float32)[None]
        posed[:, 2] = self.camera_distance - posed[:, 2]  # to_camera
        return posed

    def render(self, id_coeff, exp_coeff, euler, trans):
        """-> (mask [S,S] bool, secc [S,S,3] in [-1,1], black(-1) bg)."""
        v = self.vertices(id_coeff, exp_coeff, euler, trans)
        mask, _, img = rasterize_mesh(
            v, self.faces, self.ncc_code, size=self.size,
            focal=self.focal, center=self.center,
        )
        secc = img * 2.0 - 1.0
        secc[~mask] = -1.0
        return mask, secc
