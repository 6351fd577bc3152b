"""Augmentation primitives (pure NumPy — no albumentations/open3d): the
port's copy of the parts of box2mask_tpu/datasets/augmentation.py that
augment_scene reaches (the HAIS jitter and the elastic distortions, which
only the real readers use, wait with them).

Behavior-parity with dataprocessing/augmentation.py of the reference:
  * geometric: xyz rotation about the centroid (open3d mesh.rotate semantics),
    90-degree z rotations, x-flip, origin-centered scaling, position jitter,
  * color: jitter, brightness, chromatic translation / auto-contrast, the mix3d
    pipeline (RandomBrightnessContrast + RGBShift, each p=.5, on a uint8 pseudo
    image) followed by fixed mean/std normalization, and the hue/sat/value aug.

The reference loads the mix3d pipeline from an albumentations YAML
(mix3d_albumentations_aug.yaml); the transforms are reimplemented here with the
same parameters (brightness/contrast +-0.2, rgb shift +-20, OpenCV-convention
HSV for the hue aug).
"""

from __future__ import annotations

import numpy as np

MIX3D_COLOR_MEAN = (0.47793125906962, 0.4303257521323044, 0.3749598901421883)
MIX3D_COLOR_STD = (0.2834475483823543, 0.27566157565723015, 0.27018971370874995)


# ------------------------------------------------------------------- geometry
def rotation_matrix_xyz(rx, ry, rz):
    """open3d get_rotation_matrix_from_xyz: R = Rx(rx) @ Ry(ry) @ Rz(rz)."""
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rx @ Ry @ Rz


def rotate_about_center(positions, R):
    """open3d mesh.rotate default: rotation about the geometry centroid."""
    center = positions.mean(axis=0)
    return (positions - center) @ R.T + center


def rotate_points(positions, max_xy_angle=np.pi / 100, individual_prob=1.0,
                  rng=np.random):
    rz = rng.uniform(0, 2 * np.pi) if rng.random() < individual_prob else 0.0
    rx = rng.uniform(-max_xy_angle, max_xy_angle) \
        if rng.random() < individual_prob else 0.0
    ry = rng.uniform(-max_xy_angle, max_xy_angle) \
        if rng.random() < individual_prob else 0.0
    return rotate_about_center(positions, rotation_matrix_xyz(rx, ry, rz))


def rotate_points_90(positions, rng=np.random):
    rz = [0, 0.5 * np.pi, np.pi, 1.5 * np.pi][rng.randint(0, 4)]
    return rotate_about_center(positions, rotation_matrix_xyz(0, 0, rz))


def flip_x(positions):
    """x-axis mirror about the origin (reference applies mesh.transform with a
    -1 on [0][0], scannet.py:172-175)."""
    out = positions.copy()
    out[:, 0] *= -1
    return out


def scale_points(positions, min_scale=0.9, max_scale=1.1, rng=np.random):
    return positions * rng.uniform(min_scale, max_scale)


def position_jitter(positions, sigma=0.01, rng=np.random):
    return positions + sigma * rng.randn(*positions.shape)


def color_jittering(colors, lo=-0.05, hi=0.05, rng=np.random):
    return np.clip(colors + rng.uniform(lo, hi, colors.shape), 0, 1)


def random_brightness(colors, brightness_limit=0.2, rng=np.random):
    """albumentations RandomBrightnessContrast(contrast=0) equivalent on [0,1]
    float colors: img * (1) + beta."""
    beta = rng.uniform(-brightness_limit, brightness_limit)
    return np.clip(colors + beta, 0, 1).astype(np.float32)


def chromatic_translation(colors, trans_range_ratio=0.1, rng=np.random):
    if rng.random() < 0.95:
        tr = (rng.rand(1, 3) - 0.5) * 2 * trans_range_ratio
        colors = np.clip(colors + tr, 0, 1)
    return colors


def chromatic_auto_contrast(colors, randomize_blend_factor=True,
                            blend_factor=0.5, rng=np.random):
    lo = colors.min(0, keepdims=True)
    hi = colors.max(0, keepdims=True)
    assert hi.max() <= 1 + 1e-6, 'colors must be in [0,1]'
    scale = 1.0 / np.maximum(hi - lo, 1e-12)
    contrast = (colors - lo) * scale
    bf = rng.random() if randomize_blend_factor else blend_factor
    return (1 - bf) * colors + bf * contrast


def _rgb_to_hsv_cv(rgb_u8):
    """OpenCV-convention HSV from uint8 RGB: H in [0,180), S/V in [0,255]."""
    rgb = rgb_u8.astype(np.float32) / 255.0
    mx = rgb.max(-1)
    mn = rgb.min(-1)
    diff = mx - mn
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    h = np.zeros_like(mx)
    nz = diff > 0
    rmax = nz & (mx == r)
    gmax = nz & (mx == g) & ~rmax
    bmax = nz & ~rmax & ~gmax
    h[rmax] = (60 * (g - b) / np.maximum(diff, 1e-12))[rmax] % 360
    h[gmax] = (60 * (b - r) / np.maximum(diff, 1e-12) + 120)[gmax]
    h[bmax] = (60 * (r - g) / np.maximum(diff, 1e-12) + 240)[bmax]
    s = np.where(mx > 0, diff / np.maximum(mx, 1e-12), 0)
    return h / 2.0, s * 255.0, mx * 255.0


def _hsv_to_rgb_cv(h, s, v):
    h = h * 2.0 / 60.0
    s = s / 255.0
    v = v / 255.0
    i = np.floor(h).astype(int) % 6
    f = h - np.floor(h)
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.clip(np.stack([r, g, b], -1) * 255.0, 0, 255)


def hue_saturation_value(rgb_u8, hue_shift=50, sat_shift=60, val_shift=50,
                         rng=np.random):
    """albumentations HueSaturationValue equivalent (OpenCV HSV convention)."""
    h, s, v = _rgb_to_hsv_cv(rgb_u8)
    h = (h + rng.uniform(-hue_shift, hue_shift)) % 180.0
    s = np.clip(s + rng.uniform(-sat_shift, sat_shift), 0, 255)
    v = np.clip(v + rng.uniform(-val_shift, val_shift), 0, 255)
    return _hsv_to_rgb_cv(h, s, v).astype(np.uint8)


def _mix3d_pipeline(img_u8, rng=np.random):
    """RandomBrightnessContrast(+-0.2, p=.5) + RGBShift(+-20, p=.5) on uint8."""
    img = img_u8.astype(np.float32)
    if rng.random() < 0.5:
        alpha = 1.0 + rng.uniform(-0.2, 0.2)   # contrast
        beta = rng.uniform(-0.2, 0.2)          # brightness (by max value)
        img = np.clip(img * alpha + beta * 255.0, 0, 255)
    if rng.random() < 0.5:
        shift = np.array([rng.uniform(-20, 20) for _ in range(3)], np.float32)
        img = np.clip(img + shift, 0, 255)
    return img


def _normalize(img):
    mean = np.asarray(MIX3D_COLOR_MEAN, np.float32) * 255.0
    std = np.asarray(MIX3D_COLOR_STD, np.float32) * 255.0
    return (img - mean) / std


def apply_mix3d_color_aug(colors01, rng=np.random):
    """[0,1] colors -> mix3d-augmented NORMALIZED features (mean 0)."""
    img = (colors01 * 255).astype(np.uint8)
    return _normalize(_mix3d_pipeline(img, rng))


def apply_hue_aug(colors01, rng=np.random):
    img = (colors01 * 255).astype(np.uint8)
    img = hue_saturation_value(img, rng=rng)
    return _normalize(_mix3d_pipeline(img, rng))


# --------------------------------------------------------------- scene helper
def augment_scene(scene, cfg, rng=np.random):
    """Apply the standard geometric+color augmentation suite to a scene dict
    (positions/colors/normals in place of the mesh-based reader flow). Used by
    the synthetic dataset; the real readers apply augs inside their readers."""
    pos = scene['positions']
    if rng.rand() < cfg.rotation_aug[0]:
        pos = rotate_points(pos, cfg.rotation_aug[1], cfg.rotation_aug[2], rng)
    if cfg.rotation_90_aug:
        pos = rotate_points_90(pos, rng)
    if rng.rand() < cfg.flipping_aug:
        pos = flip_x(pos)
    if rng.rand() < cfg.position_jittering[0]:
        pos = position_jitter(pos, cfg.position_jittering[1], rng)
    if rng.rand() < cfg.scaling_aug[0]:
        pos = scale_points(pos, cfg.scaling_aug[1], cfg.scaling_aug[2], rng)
    colors = scene['colors']
    if rng.rand() < cfg.chromatic_auto_contrast:
        colors = chromatic_auto_contrast(colors, rng=rng)
    if rng.rand() < cfg.chromatic_translation[0]:
        colors = chromatic_translation(colors, cfg.chromatic_translation[1],
                                       rng)
    if rng.rand() < cfg.color_jittering_aug[0]:
        colors = color_jittering(colors, -cfg.color_jittering_aug[1],
                                 cfg.color_jittering_aug[1], rng)
    if rng.rand() < cfg.random_brightness[0]:
        colors = random_brightness(colors, cfg.random_brightness[1], rng)
    if cfg.mix_3d_color_aug:
        colors = apply_mix3d_color_aug(colors, rng)
    if cfg.apply_hue_aug:
        colors = apply_hue_aug(colors, rng)
    out = dict(scene)
    out['positions'] = pos
    out['colors'] = colors
    return out
