"""Seeded synthetic camera sequences with exact ground truth.

Every whole-system input of the engine's end-to-end checks is rendered
here from a seed, with numpy only (no OpenCV): a procedural "dead leaves" texture,
a bilinear homography warp, a nearest-neighbour coverage mask, and the
camera paths of the monocular, stereo, RGB-D, visual-inertial and
loop/merge sequences.  The scene is two textured planes, a far wall at
z=5 and a near poster at z=3 (real 3-D structure, so two-view
initialisation is well posed), seen through a 640x480 pinhole camera
with f=500.

Poses are world-to-camera (R, t): p_cam = R p_world + t.
"""

from __future__ import annotations

import numpy as np

W, H = 640, 480
K = np.array([[500.0, 0.0, 320.0], [0.0, 500.0, 240.0], [0.0, 0.0, 1.0]])
STEREO_BASELINE = 0.1          # metres
BF = 500.0 * STEREO_BASELINE   # Camera.bf
G_W = np.array([0.0, -9.81, 0.0])
VI_FPS = 10.0                  # frame spacing 0.1 s -> 4 s in 40 frames

_E3 = np.array([[0.0, 0.0, 1.0]])


# --------------------------------------------------------------------------
# texture


def texture(seed: int, shape=(1024, 1024)) -> np.ndarray:
    """Multi-scale "dead leaves" texture: random overlapping discs and
    rotated rectangles with power-law sizes and random grey levels, then
    a [1,2,1] blur against aliasing.  Scale-invariant, so every pyramid
    level of a view finds corners, and aperiodic, so no two places look
    alike."""
    rng = np.random.default_rng(seed)
    h, w = shape
    r_min, r_max = 3.0, min(h, w) / 6.0
    # r ~ r^-3 (inverse CDF); enough shapes to cover the canvas ~4 times
    mean_area = np.pi * 2.0 * r_min ** 2 * np.log(r_max / r_min)
    n = int(4 * h * w / mean_area)
    u = rng.random(n)
    radius = (r_min ** -2 - u * (r_min ** -2 - r_max ** -2)) ** -0.5
    cx = rng.uniform(-r_max, w + r_max, n)
    cy = rng.uniform(-r_max, h + r_max, n)
    grey = rng.integers(0, 256, n).astype(np.float32)
    is_rect = rng.random(n) < 0.5
    theta = rng.uniform(0.0, np.pi, n)
    aspect = rng.uniform(0.3, 1.0, n)

    img = np.full(shape, rng.integers(0, 256), np.float32)
    for i in range(n):
        r = radius[i]
        x0, x1 = max(int(cx[i] - r), 0), min(int(cx[i] + r) + 2, w)
        y0, y1 = max(int(cy[i] - r), 0), min(int(cy[i] + r) + 2, h)
        if x0 >= x1 or y0 >= y1:
            continue
        dx = np.arange(x0, x1, dtype=np.float32)[None, :] - cx[i]
        dy = np.arange(y0, y1, dtype=np.float32)[:, None] - cy[i]
        if is_rect[i]:
            c, s = np.cos(theta[i]), np.sin(theta[i])
            inside = ((np.abs(c * dx + s * dy) <= r * 0.7)
                      & (np.abs(-s * dx + c * dy) <= r * 0.7 * aspect[i]))
        else:
            inside = dx * dx + dy * dy <= r * r
        img[y0:y1, x0:x1][inside] = grey[i]
    k = np.array([0.25, 0.5, 0.25], np.float32)
    img = np.apply_along_axis(np.convolve, 1, np.pad(img, ((0, 0), (1, 1)), "edge"), k, "valid")
    img = np.apply_along_axis(np.convolve, 0, np.pad(img, ((1, 1), (0, 0)), "edge"), k, "valid")
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


# --------------------------------------------------------------------------
# warps


def _source_coords(M, out_wh, dtype):
    """Source coordinates (X, Y) of every output pixel under homography
    M (M maps source to output, as cv2.warpPerspective takes it)."""
    w, h = out_wh
    Minv = np.linalg.inv(np.asarray(M, np.float64)).astype(dtype)
    xs, ys = np.meshgrid(np.arange(w, dtype=dtype), np.arange(h, dtype=dtype))
    den = Minv[2, 0] * xs + Minv[2, 1] * ys + Minv[2, 2]
    den = np.where(den != 0, den, dtype(1e-30))
    X = (Minv[0, 0] * xs + Minv[0, 1] * ys + Minv[0, 2]) / den
    Y = (Minv[1, 0] * xs + Minv[1, 1] * ys + Minv[1, 2]) / den
    return X, Y


def warp_bilinear(src: np.ndarray, M, out_wh=(W, H),
                  border: str = "replicate") -> np.ndarray:
    """uint8 homography warp with bilinear interpolation in float32, the
    arithmetic of OpenCV 5's warpPerspective (INTER_LINEAR).  ``border``
    is "replicate" or "constant" (zero)."""
    X, Y = _source_coords(M, out_wh, np.float32)
    lim = np.float32(1 << 30)
    X, Y = np.clip(X, -lim, lim), np.clip(Y, -lim, lim)
    x0, y0 = np.floor(X), np.floor(Y)
    fx, fy = X - x0, Y - y0
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    h, w = src.shape
    src = src.astype(np.float32)

    def tap(yy, xx):
        v = src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        if border == "replicate":
            return v
        return np.where((xx >= 0) & (xx < w) & (yy >= 0) & (yy < h), v, 0.0)

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    out = top * (1 - fy) + bot * fy
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def warp_mask(src_hw, M, out_wh=(W, H)) -> np.ndarray:
    """Nearest-neighbour coverage: True where an output pixel's nearest
    source pixel lies inside a source image of shape ``src_hw``."""
    X, Y = _source_coords(M, out_wh, np.float64)
    X, Y = np.rint(X), np.rint(Y)
    h, w = src_hw
    return (X >= 0) & (X < w) & (Y >= 0) & (Y < h)


# --------------------------------------------------------------------------
# the two-plane scene


def _planes(tex):
    """Texture-to-world maps (3x3, texture pixel -> plane point) of the
    far wall and the near poster."""
    s_far = 5.0 / tex.shape[0]
    A_far = np.array([[s_far, 0, -2.5], [0, s_far, -2.5], [0, 0, 5.0]])
    s_near = 1.6 / tex.shape[0]
    A_near = np.array([[s_near, 0, -1.1], [0, s_near, -0.8], [0, 0, 3.0]])
    return A_far, A_near


def render_view(tex, R, t, A_far, A_near) -> np.ndarray:
    """One 640x480 view of the far wall (``A_far``) with the mirrored
    texture on the near poster (``A_near``) in front of it."""
    img = warp_bilinear(tex, K @ (R @ A_far + t[:, None] @ _E3))
    M_near = K @ (R @ A_near + t[:, None] @ _E3)
    near = warp_bilinear(tex[:, ::-1], M_near, border="constant")
    return np.where(warp_mask(tex.shape, M_near), near, img)


def so3_exp(w) -> np.ndarray:
    """Rodrigues' formula in float64."""
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    Wx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + Wx
    return (np.eye(3) + np.sin(th) / th * Wx
            + (1 - np.cos(th)) / th ** 2 * Wx @ Wx)


def render_sequence(tex, n_frames=14, speed=0.12):
    """Camera translating and yawing in front of the two-plane scene.

    ``speed`` is the per-frame lateral translation; rotation scales with
    it so longer sequences (smaller speed, more frames) stay inside the
    textured volume.  Returns (frames, poses)."""
    A_far, A_near = _planes(tex)
    sc = speed / 0.12
    frames, poses = [], []
    for k in range(n_frames):
        R = so3_exp([0.0, 0.015 * sc * k, 0.0])
        t = -R @ np.array([speed * k, 0.015 * sc * k, 0.01 * sc * k])
        frames.append(render_view(tex, R, t, A_far, A_near))
        poses.append((R, t))
    return frames, poses


def render_stereo_pair(tex, n_frames):
    """Rectified left/right sequences: the right camera is displaced by
    STEREO_BASELINE along camera x.  Returns (left, right, poses)."""
    frames_l, poses = render_sequence(tex, n_frames)
    A_far, A_near = _planes(tex)
    frames_r = [render_view(tex, R, t - np.array([STEREO_BASELINE, 0, 0]),
                            A_far, A_near) for R, t in poses]
    return frames_l, frames_r, poses


def depth_map(R, t, near_mask) -> np.ndarray:
    """Analytic per-pixel depth of the two-plane scene.  Camera-frame
    depth of the ray through pixel p is lambda with
    C_z + lambda * d_wz = z_plane, d_w = R^T K^-1 p."""
    C = -R.T @ t
    us, vs = np.meshgrid(np.arange(W), np.arange(H))
    pix = np.stack([us, vs, np.ones_like(us)], -1).astype(np.float64)
    d_w = (pix @ np.linalg.inv(K).T) @ R
    z_plane = np.where(near_mask, 3.0, 5.0)
    lam = (z_plane - C[2]) / d_w[..., 2]
    return np.clip(lam, 0.1, 100.0).astype(np.float32)


def render_rgbd(tex, n_frames=10):
    """Monocular sequence plus exact depth maps: (frames, depths, poses)."""
    frames, poses = render_sequence(tex, n_frames)
    _, A_near = _planes(tex)
    depths = [depth_map(R, t, warp_mask(tex.shape, K @ (R @ A_near + t[:, None] @ _E3)))
              for R, t in poses]
    return frames, depths, poses


# --------------------------------------------------------------------------
# visual-inertial sequence

_VI_AMP = np.array([0.70, 0.25, 0.12])
_VI_OM = np.array([1.9, 1.4, 1.1])
_VI_PH = np.array([0.0, 1.0, 0.5])


def vi_pose(t):
    """Analytic camera trajectory with rich acceleration: monocular-
    inertial scale observability needs the accelerometer signal to
    dominate the visual pose noise."""
    R = so3_exp([0.0, 0.10 * np.sin(0.9 * t), 0.0])
    C = _VI_AMP * np.sin(_VI_OM * t + _VI_PH) - _VI_AMP * np.sin(_VI_PH)
    return R, -R @ C


def vi_imu_window(t0, t1, hz: float):
    """(t, acc, gyro) samples in [t0, t1] at ``hz`` (body == camera).
    The boundary sample at t0 is included so the preintegration's first
    clipped interval is covered (duplicates across windows collapse to
    zero-length intervals in the queue)."""
    out = []
    for i in range(int(round((t1 - t0) * hz)) + 1):
        t = t0 + i / hz
        R, _ = vi_pose(t)
        accel = -_VI_AMP * _VI_OM ** 2 * np.sin(_VI_OM * t + _VI_PH)
        # R_wb = exp(-ang(t) y_hat): omega_b = -ang'(t) * y
        gyro = np.array([0.0, -0.10 * 0.9 * np.cos(0.9 * t), 0.0])
        out.append((t, (R @ (accel - G_W)).astype(np.float32),
                    gyro.astype(np.float32)))
    return out


def render_vi_sequence(tex, n_frames=40):
    """Frames along vi_pose at VI_FPS: (frames, poses)."""
    A_far, A_near = _planes(tex)
    frames, poses = [], []
    for k in range(n_frames):
        R, t = vi_pose(k / VI_FPS)
        frames.append(render_view(tex, R, t, A_far, A_near))
        poses.append((R, t))
    return frames, poses


# --------------------------------------------------------------------------
# loop / merge sequence


def render_loop_sequence(tex, n_frames=40):
    """Out-and-back sweep over a WIDE wall (give ``tex`` a 4:1 aspect):
    the camera translates and yaws far enough that the turnaround view
    shares no scene content with the start, so the covisibility graph
    genuinely breaks between the outbound and return segments.  The wall
    plane z=5 spans x in [-3.4, 10.6], y in [-3, 3]; the turnaround view
    [3.5, 10.1] shares nothing with the start view [-3.2, 3.2].
    Returns (frames, poses)."""
    half = n_frames // 2
    A_far = np.array([[14.0 / tex.shape[1], 0, -3.4],
                      [0, 6.0 / tex.shape[0], -3.0],
                      [0, 0, 5.0]])
    _, A_near = _planes(tex)
    frames, poses = [], []
    for k in range(n_frames):
        j = k if k < half else (n_frames - 1 - k)
        R = so3_exp([0.0, 0.008 * j, 0.0])
        t = -R @ np.array([0.35 * j, 0.012 * j, 0.01 * j])
        frames.append(render_view(tex, R, t, A_far, A_near))
        poses.append((R, t))
    return frames, poses


# --------------------------------------------------------------------------
# trajectory error


def umeyama_align(est, gt, return_scale=False):
    """Sim3 alignment (scale, R, t) of est onto gt; returns aligned est
    (and the recovered scale when return_scale)."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    xe, xg = est - mu_e, gt - mu_g
    U, D, Vt = np.linalg.svd(xg.T @ xe / len(est))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = np.trace(np.diag(D) @ S) / ((xe ** 2).sum() / len(est))
    aligned = (s * (R @ est.T)).T + (mu_g - s * R @ mu_e)
    if return_scale:
        return aligned, s
    return aligned


def camera_centers(poses) -> np.ndarray:
    """(N, 3) camera centres -R^T t of (R, t) pairs."""
    return np.array([-R.T @ t for R, t in poses])
