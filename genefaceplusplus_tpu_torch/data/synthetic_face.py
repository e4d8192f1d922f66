"""Production-scale synthetic identity: a textured, deforming, face-like 3D
scene rendered at 512^2 with landmark-consistent conditioning (numpy copy
of `genefaceplusplus_tpu/data/synthetic_face.py`; equal arrays for equal
arguments).

A head mesh (an ellipsoid with nose, eye sockets and lips, ~12k faces)
whose jaw, mouth width and brows deform with per-frame coefficients and
whose eyelids close with the eye-area percent; a per-vertex skin texture
with SH lighting (`data/bfm_render.py`); 68 landmark vertices that track
the deformation, stored as the binarizer does (canonical lm3d x 10); a
camera orbit in the binarizer's c2w convention; a cloth torso drawn in
image space that moves with the head's yaw, with RGBA torso images.

GT frames are rasterised through the renderer's own pinhole
(`utils/rays.py:pixel_rays`), so a perfect fit reproduces them pixel for
pixel. `chip_smoke.py`'s onboard phase and the data-preparation tests make
their video from it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from genefaceplusplus_tpu_torch.data.bfm_render import (
    compute_color,
    compute_vertex_normals,
    rasterize_projected,
)

# fixed SH lighting: ambient + a soft key light from the upper left
GAMMA = np.array(
    [0.10, 0.06, -0.10, 0.05, 0.0, 0.0, 0.02, 0.0, 0.0] * 3, np.float32
)

# head-space feature locations (theta = latitude, up +Y; phi = longitude,
# nose at phi=0, +Z front)
THETA_EYE, PHI_EYE = 0.18, 0.38
THETA_BROW = 0.34
THETA_MOUTH = -0.42
THETA_NOSE = -0.08


def _gauss(x, mu, sigma):
    return np.exp(-0.5 * ((x - mu) / sigma) ** 2)


def build_head_mesh(nlat: int = 64, nlon: int = 96):
    """Canonical head mesh in head space (+Y up, +Z nose).

    Returns (verts0 [N,3], unit [N,3], theta [N], phi [N], faces [F,3])."""
    theta = np.linspace(-np.pi / 2, np.pi / 2, nlat, dtype=np.float32)
    phi = np.linspace(-np.pi, np.pi, nlon, endpoint=False, dtype=np.float32)
    tt, pp = np.meshgrid(theta, phi, indexing="ij")  # [nlat, nlon]
    ct = np.cos(tt)
    unit = np.stack([ct * np.sin(pp), np.sin(tt), ct * np.cos(pp)], -1)
    radii = np.asarray([0.20, 0.27, 0.22], np.float32)
    verts = unit * radii

    t, p = tt.reshape(-1), pp.reshape(-1)
    unit = unit.reshape(-1, 3)
    verts = verts.reshape(-1, 3)
    # nose: frontal bump
    bump = 0.055 * _gauss(t, THETA_NOSE, 0.14) * _gauss(p, 0.0, 0.14)
    # eye sockets: slight indentations
    bump -= 0.012 * _gauss(t, THETA_EYE, 0.10) * (
        _gauss(p, PHI_EYE, 0.17) + _gauss(p, -PHI_EYE, 0.17))
    # lips: protrusion around the mouth line
    bump += 0.014 * _gauss(t, THETA_MOUTH, 0.08) * _gauss(p, 0.0, 0.35)
    # chin
    bump += 0.010 * _gauss(t, -0.75, 0.15) * _gauss(p, 0.0, 0.45)
    verts = verts + unit * bump[:, None]

    # lat-long grid triangulation (wrap in phi)
    idx = np.arange(nlat * nlon).reshape(nlat, nlon)
    nxt = np.roll(idx, -1, axis=1)
    a, b = idx[:-1], idx[1:]
    c, d = nxt[:-1], nxt[1:]
    faces = np.concatenate([
        np.stack([a, b, c], -1).reshape(-1, 3),
        np.stack([c, b, d], -1).reshape(-1, 3),
    ], 0).astype(np.int64)
    return verts.astype(np.float32), unit.astype(np.float32), t, p, faces


def landmark_indices(theta: np.ndarray, phi: np.ndarray) -> np.ndarray:
    """68 vertex indices laid out like iBUG lm68 (jaw 17, brows 10, nose 9,
    eyes 12, mouth 20), found by nearest (theta, phi) target."""
    targets = []
    # 0-16 jaw: lower silhouette arc, ear to ear through the chin
    for k in range(17):
        a = np.pi * (1.0 - k / 16.0)  # pi .. 0
        targets.append((-0.30 - 0.55 * np.sin(a), (a - np.pi / 2) * 1.15))
    # 17-26 brows (right 17-21, left 22-26 in iBUG; here by phi sign)
    for k in range(5):
        targets.append((THETA_BROW, -PHI_EYE - 0.17 + 0.085 * k))
    for k in range(5):
        targets.append((THETA_BROW, PHI_EYE - 0.17 + 0.085 * k))
    # 27-30 nose bridge, 31-35 nose base
    for k in range(4):
        targets.append((0.16 - 0.08 * k, 0.0))
    for k in range(5):
        targets.append((-0.16, -0.10 + 0.05 * k))
    # 36-41 right eye, 42-47 left eye (hexagon around the socket)
    for sign in (-1.0, 1.0):
        for k in range(6):
            a = 2 * np.pi * k / 6
            targets.append((THETA_EYE + 0.055 * np.sin(a),
                            sign * PHI_EYE + 0.11 * np.cos(a)))
    # 48-59 outer lip ring, 60-67 inner ring
    for k in range(12):
        a = 2 * np.pi * k / 12
        targets.append((THETA_MOUTH + 0.055 * np.sin(a), 0.26 * np.cos(a)))
    for k in range(8):
        a = 2 * np.pi * k / 8
        targets.append((THETA_MOUTH + 0.028 * np.sin(a), 0.16 * np.cos(a)))

    tg = np.asarray(targets, np.float32)  # [68, 2] (theta, phi)
    d = (theta[None, :] - tg[:, :1]) ** 2 + (phi[None, :] - tg[:, 1:2]) ** 2
    return np.argmin(d, axis=1).astype(np.int64)


def deform(verts0: np.ndarray, theta: np.ndarray, phi: np.ndarray,
           jaw: float, width: float, brow: float) -> np.ndarray:
    """Expression deformation in head space.

    jaw in [0,1] rotates the sub-mouth region down about an ear-height
    pivot; width in [-1,1] scales mouth-region x; brow in [-1,1] lifts the
    brow band."""
    v = verts0.copy()
    # jaw: sharp ramp just below the mouth line so the lower lip + chin
    # visibly drop while the upper lip stays put
    w = np.clip((THETA_MOUTH + 0.04 - theta) / 0.12, 0.0, 1.0) ** 2
    alpha = 0.30 * jaw * w
    y, z = v[:, 1] - 0.02, v[:, 2]
    ca, sa = np.cos(alpha), np.sin(alpha)
    v[:, 1] = (ca * y - sa * z) + 0.02
    v[:, 2] = sa * y + ca * z
    # mouth width
    mw = _gauss(theta, THETA_MOUTH, 0.10)
    v[:, 0] *= 1.0 + 0.16 * width * mw
    # brow raise
    bw = _gauss(theta, THETA_BROW, 0.07) * (np.abs(phi) < 0.7)
    v[:, 1] += 0.016 * brow * bw
    return v


def base_texture(theta: np.ndarray, phi: np.ndarray, seed: int = 0) -> np.ndarray:
    """Static per-vertex skin texture with high-frequency detail [N, 3]."""
    rng = np.random.RandomState(seed)
    n = len(theta)
    skin = np.asarray([0.80, 0.62, 0.52], np.float32)
    detail = (0.05 * np.sin(47.0 * theta) * np.sin(53.0 * phi)
              + 0.04 * np.sin(23.0 * theta + 11.0 * phi))
    freckles = 0.10 * (rng.rand(n).astype(np.float32) - 0.5)
    tex = skin[None] * (1.0 + detail + freckles)[:, None]

    # lips
    lips = _gauss(theta, THETA_MOUTH, 0.045) * (np.abs(phi) < 0.30)
    tex = tex * (1 - lips[:, None]) + np.asarray([0.66, 0.30, 0.30])[None] * lips[:, None]
    # brows
    brows = _gauss(theta, THETA_BROW, 0.035) * (
        (np.abs(phi) > 0.16) & (np.abs(phi) < 0.60))
    tex = tex * (1 - brows[:, None]) + np.asarray([0.25, 0.18, 0.12])[None] * brows[:, None]
    return np.clip(tex, 0.0, 1.0).astype(np.float32)


def frame_texture(tex0: np.ndarray, theta: np.ndarray, phi: np.ndarray,
                  jaw: float, blink: float) -> np.ndarray:
    """Per-frame texture: eyes (sclera/iris + eyelid closure) and mouth
    interior darkening when the jaw opens. blink in [0,1], 1 = closed."""
    tex = tex0.copy()
    for sign in (-1.0, 1.0):
        de = ((theta - THETA_EYE) / 0.065) ** 2 + ((phi - sign * PHI_EYE) / 0.13) ** 2
        eye = np.clip(1.0 - de, 0.0, 1.0)
        iris = de < 0.25
        eye_col = np.asarray([0.93, 0.93, 0.91], np.float32)[None] * np.ones((len(theta), 1))
        eye_col[iris] = (0.15, 0.25, 0.38)
        # eyelid closes from the top: skin covers where theta above the
        # moving lid line
        lid = (theta - (THETA_EYE + 0.065 - 0.14 * blink)) > 0
        m = (eye > 0)[:, None] * (1.0 - lid[:, None].astype(np.float32))
        tex = tex * (1 - m * eye[:, None]) + eye_col * (m * eye[:, None])
    # open-mouth interior: the surface band stretched by the jaw rotation
    # reads as the dark mouth cavity, growing with the opening
    interior = _gauss(theta, THETA_MOUTH - 0.03, 0.018 + 0.035 * jaw) * (np.abs(phi) < 0.24)
    tex = tex * (1.0 - (0.85 * jaw) * interior[:, None])
    return np.clip(tex, 0.0, 1.0).astype(np.float32)


# head space -> ngp world: world up = -Y_cam, nose toward the camera (-Z)
HEAD_TO_WORLD = np.diag([1.0, -1.0, -1.0]).astype(np.float32)


def camera_pose_ngp(yaw: float, pitch: float, roll: float,
                    distance: float, pivot) -> np.ndarray:
    """c2w in ngp space: camera orbits `pivot`, optical axis through it
    (pixel_rays convention: looks along +z_cam, +y_cam = image rows down)."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    ry = np.asarray([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    rx = np.asarray([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
    rz = np.asarray([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]], np.float32)
    R = ry @ rx @ rz
    t = np.asarray(pivot, np.float32) - distance * R[:, 2]
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R
    pose[:3, 3] = t
    return pose


def ngp_to_nerf_matrix(ngp: np.ndarray, scale: float = 4.0) -> np.ndarray:
    """Inverse of utils/rotation.py:nerf_matrix_to_ngp (offset 0)."""
    p = np.eye(4, dtype=np.float32)
    for dst, src in ((0, 2), (1, 0), (2, 1)):
        p[dst, 0] = ngp[src, 0]
        p[dst, 1] = -ngp[src, 1]
        p[dst, 2] = -ngp[src, 2]
        p[dst, 3] = ngp[src, 3] / scale
    return p


def project(verts_world: np.ndarray, pose_ngp: np.ndarray,
            intr: Tuple[float, float, float, float]):
    """World verts -> (pixel pts [N,2], depth z [N]) under pixel_rays'
    pinhole: dir_cam = [(i+.5-cx)/fx, (j+.5-cy)/fy, 1]."""
    R, t = pose_ngp[:3, :3], pose_ngp[:3, 3]
    vc = (verts_world - t[None]) @ R  # R^T (v - t)
    fx, fy, cx, cy = intr
    z = vc[:, 2]
    zs = np.maximum(z, 1e-4)
    px = fx * vc[:, 0] / zs + cx - 0.5
    py = fy * vc[:, 1] / zs + cy - 0.5
    return np.stack([px, py], -1).astype(np.float32), z.astype(np.float32)


def draw_torso(H: int, W: int, yaw: float, seed: int = 0):
    """Cloth-textured shoulders+neck in image space, shifted with yaw.
    Returns float32 RGBA [H, W, 4]."""
    rng = np.random.RandomState(seed)
    rows = np.arange(H, dtype=np.float32)[:, None]
    cols = np.arange(W, dtype=np.float32)[None, :]
    shift = yaw * 0.06 * W
    cc = cols - W / 2 - shift
    shoulder_top = H * 0.86 - H * 0.14 * np.exp(-0.5 * (cc / (0.30 * W)) ** 2)
    neck = (np.abs(cc) < 0.085 * W) & (rows > H * 0.70)
    body = rows > shoulder_top
    alpha = (body | neck).astype(np.float32)
    # cloth: stripes + speckle; neck: skin
    stripe = 0.12 * np.sin(rows / 2.4 + cols / 7.0) + 0.06 * np.sin(cols / 1.7)
    speckle = 0.08 * (rng.rand(H, W).astype(np.float32) - 0.5)
    cloth = np.stack([
        0.24 * (1 + stripe + speckle),
        0.30 * (1 + stripe + speckle),
        0.46 * (1 + stripe + speckle),
    ], -1)
    skin = np.asarray([0.78, 0.60, 0.50], np.float32) * (
        1 + 0.05 * np.sin(rows / 3.1) + speckle)[..., None]
    img = np.where(neck[..., None] & ~body[..., None], skin, cloth)
    return np.concatenate([np.clip(img, 0, 1), alpha[..., None]], -1).astype(np.float32)


def background(H: int, W: int, seed: int = 1) -> np.ndarray:
    rng = np.random.RandomState(seed)
    rows = np.broadcast_to(np.arange(H, dtype=np.float32)[:, None] / H, (H, W))
    cols = np.broadcast_to(np.arange(W, dtype=np.float32)[None, :] / W, (H, W))
    base = np.stack([
        0.35 + 0.25 * rows, 0.38 + 0.20 * rows, 0.45 + 0.12 * cols,
    ], -1)
    tex = 0.05 * np.sin(rows * 61) * np.sin(cols * 57)
    noise = 0.04 * (rng.rand(H, W, 1).astype(np.float32) - 0.5)
    return np.clip(base + tex[..., None] + noise, 0, 1).astype(np.float32)


def synthetic_face(
    num_frames: int = 450,
    size: int = 512,
    seed: int = 0,
    camera_scale: float = 4.0,
    nlat: int = 64,
    nlon: int = 96,
    head_masks: bool = False,
) -> Dict:
    """Full binarizer-schema ds_dict for the production-scale synthetic
    identity. Deterministic in (num_frames, size, seed); `head_masks` keeps
    each frame's rasterised head mask in its sample as `head_mask` [H, W]
    bool."""
    T = num_frames
    H = W = size
    rng = np.random.RandomState(seed + 100)

    verts0, unit, theta, phi, faces = build_head_mesh(nlat, nlon)
    lm_idx = landmark_indices(theta, phi)
    tex0 = base_texture(theta, phi, seed)

    # schedules: smooth multi-sine "talking" motion
    tt = np.arange(T, dtype=np.float32) / 25.0  # seconds
    jaw = np.clip(0.45 + 0.45 * np.sin(2 * np.pi * 2.1 * tt)
                  * np.sin(2 * np.pi * 0.31 * tt + 1.0)
                  + 0.15 * np.sin(2 * np.pi * 3.7 * tt + 2.0), 0.0, 1.0)
    width = 0.6 * np.sin(2 * np.pi * 0.9 * tt + 0.5)
    brow = 0.7 * np.sin(2 * np.pi * 0.23 * tt + 1.7) * (
        0.5 + 0.5 * np.sin(2 * np.pi * 0.07 * tt))
    yaw = 0.14 * np.sin(2 * np.pi * 0.13 * tt) + 0.05 * np.sin(2 * np.pi * 0.41 * tt + 0.8)
    pitch = 0.06 * np.sin(2 * np.pi * 0.17 * tt + 0.3)
    roll = 0.03 * np.sin(2 * np.pi * 0.11 * tt + 2.1)
    # periodic blinks: fast close-open every ~3.2 s
    blink_phase = (tt % 3.2) / 0.24
    blink = np.where(blink_phase < 1.0, np.sin(np.pi * np.clip(blink_phase, 0, 1)), 0.0)
    eye_area = (0.25 * (1.0 - 0.9 * blink)).astype(np.float32)[:, None]

    # camera: orbit around a pivot below head centre so the head sits in
    # the upper part of the frame and the torso has room
    distance = 2.6
    pivot = (0.0, 0.10, 0.0)
    focal = 1585.0 * size / 512.0
    intr = (focal, focal, W / 2.0, H / 2.0)

    bg = background(H, W, seed + 1)
    torso_seed = seed + 2

    samples = []
    lm3d_all = np.zeros((T, 68, 3), np.float32)
    eulers = np.stack([-pitch, -yaw, -roll], -1).astype(np.float32)
    c2ws = np.zeros((T, 4, 4), np.float32)
    for i in range(T):
        v_head = deform(verts0, theta, phi, jaw[i], width[i], brow[i])
        v_world = v_head @ HEAD_TO_WORLD.T
        tex = frame_texture(tex0, theta, phi, jaw[i], blink[i])
        normals = compute_vertex_normals(v_world, faces)
        color = np.clip(compute_color(tex, normals, GAMMA), 0.0, 1.0)

        pose_ngp = camera_pose_ngp(yaw[i], pitch[i], roll[i], distance, pivot)
        c2ws[i] = ngp_to_nerf_matrix(pose_ngp, camera_scale)
        pts, z = project(v_world, pose_ngp, intr)
        mask, _, head_img = rasterize_projected(pts, z, faces, color, H, W)

        torso = draw_torso(H, W, yaw[i], torso_seed)
        talpha = torso[..., 3:]
        frame = bg * (1 - talpha) + torso[..., :3] * talpha
        frame = np.where(mask[..., None], head_img, frame)

        lm2d_px, _ = project(v_head[lm_idx] @ HEAD_TO_WORLD.T, pose_ngp, intr)
        lms = lm2d_px / np.asarray([W, H], np.float32)  # normalised (x, y)
        lm3d_all[i] = v_head[lm_idx]

        ys, xs = lm2d_px[:, 1], lm2d_px[:, 0]
        face_rect = [int(max(0, ys.min() - 0.06 * H)), int(min(H, ys.max() + 0.06 * H)),
                     int(max(0, xs.min() - 0.06 * W)), int(min(W, xs.max() + 0.06 * W))]
        mys, mxs = ys[48:], xs[48:]
        lip_rect = [int(max(0, mys.min() - 0.03 * H)), int(min(H, mys.max() + 0.03 * H)),
                    int(max(0, mxs.min() - 0.03 * W)), int(min(W, mxs.max() + 0.03 * W))]
        samples.append({
            "idx": i,
            "c2w": c2ws[i],
            "face_rect": face_rect,
            "lip_rect": lip_rect,
            "lms": lms.astype(np.float32),
            "gt_img": np.clip(np.round(frame * 255), 0, 255).astype(np.uint8),
            "torso_img": np.clip(np.round(torso * 255), 0, 255).astype(np.uint8),
        })
        if head_masks:
            samples[-1]["head_mask"] = mask

    # binarizer-style conditioning: canonical landmark positions x10
    idexp_lm3d = (lm3d_all * 10.0).reshape(T, 204)
    n_train = T // 11 * 10 if T >= 11 else max(1, T - 2)
    exp = np.stack([jaw, width, brow], -1).astype(np.float32)
    exp = np.concatenate([exp, np.zeros((T, 61), np.float32)], -1)
    return {
        "bg_img": np.clip(np.round(bg * 255), 0, 255).astype(np.uint8),
        "H": H, "W": W,
        "focal": focal, "cx": W / 2.0, "cy": H / 2.0,
        "id": np.zeros((T, 80), np.float32),
        "exp": exp,
        "euler": eulers,
        "trans": np.zeros((T, 3), np.float32),
        "eye_area_percent": eye_area,
        "idexp_lm3d": idexp_lm3d,
        "idexp_lm3d_mean": idexp_lm3d.mean(0),
        "idexp_lm3d_std": idexp_lm3d.std(0) + 1e-5,
        "hubert": rng.randn(2 * T, 1024).astype(np.float32),
        "mel": rng.randn(2 * T, 80).astype(np.float32),
        "f0": np.abs(rng.randn(2 * T)).astype(np.float32) * 100 + 100,
        "train_samples": samples[:n_train],
        "val_samples": samples[n_train:],
    }


def cached_synthetic_face(path: str, **kw) -> str:
    """Generate-once cache (the 512² x 450-frame build takes ~1-2 min).

    Keyed on the generation kwargs via a sidecar json: a cached file built
    with DIFFERENT parameters is regenerated, not silently returned."""
    import json
    import os

    meta_path = path + ".meta.json"
    meta = json.dumps({k: kw[k] for k in sorted(kw)}, default=str)
    if os.path.exists(path) and os.path.exists(meta_path):
        if open(meta_path).read() == meta:
            return path
        print(f"| synthetic-face cache params changed — regenerating {path}")
    elif os.path.exists(path):
        print(f"| synthetic-face cache has no meta sidecar — regenerating {path}")
    ds = synthetic_face(**kw)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.save(path, ds, allow_pickle=True)
    with open(meta_path, "w") as f:
        f.write(meta)
    return path
