"""Rasterize an Environment into the pseudo-SDF image the obstacle factors
sample.

Behavioural port of the reference's `env_to_png` crate
(crates/env_to_png/src/lib.rs): obstacles are drawn black (0) on white (255),
tile box-drawing characters carve paths of `path_width` through tiles, each
shape can be expanded by a percentage, and the result is gaussian-blurred by
`blur * resolution` pixels to approximate a distance field. The obstacle
factor then reads `1 - value/255` at the robot's pixel
(factor/obstacle.rs:141-188).

Implementation is vectorised numpy (the rasterization happens once per
scenario load, host-side), quantised to u8 like the reference's RGB image so
finite-difference Jacobians see the same staircase.
"""

from __future__ import annotations

import math

import numpy as np

from magics_tpu_torch.env.model import Environment, RegularPolygon, Polygon


def env_to_sdf(env: Environment) -> np.ndarray:
    """Returns the blurred SDF as float32 in [0, 1] (= red channel / 255)."""
    img = env_to_image(env)  # u8, 0 obstacle / 255 free
    blur_pixels = env.sdf.blur * env.sdf.resolution
    if blur_pixels >= 1.0:
        img = _gaussian_blur_u8(img, blur_pixels)
    return img.astype(np.float32) / 255.0


def env_to_image(env: Environment, expansion: float | None = None) -> np.ndarray:
    """Binary obstacle raster (u8: 0 obstacle, 255 free), one sample per
    pixel center (env_to_png lib.rs:166-205).

    `expansion` overrides the SDF expansion percentage; pass 0.0 to get the
    raw collision geometry (the reference's parry2d colliders are built from
    unexpanded shapes, environment/map_generator.rs:22-38 — expansion only
    applies to the obstacle-factor SDF)."""
    res = env.sdf.resolution
    nrows, ncols = env.nrows, env.ncols
    H, W = nrows * res, ncols * res
    tile_size = env.tile_size
    expansion = env.sdf.expansion if expansion is None else expansion

    ys, xs = np.mgrid[0:H, 0:W]
    # pixel -> tile units (pixel centers), lib.rs:208-219
    xu = (xs + 0.5) / res * tile_size
    yu = (ys + 0.5) / res * tile_size
    # offset modulus -> percentage within tile, lib.rs:222-240
    px = _offset_modulus(xu, tile_size)
    py = _offset_modulus(yu, tile_size)
    trow = np.minimum((ys // res), nrows - 1)
    tcol = np.minimum((xs // res), ncols - 1)

    obstacle = np.zeros((H, W), dtype=bool)

    # tile-piece obstacles (lib.rs:341-478)
    tile_chars = np.empty((nrows, ncols), dtype="U1")
    for r, row in enumerate(env.grid):
        for c, ch in enumerate(row):
            tile_chars[r, c] = ch
    chars_img = tile_chars[trow, tcol]
    for ch in np.unique(chars_img):
        mask = chars_img == ch
        obstacle |= mask & _tile_obstacle(ch, px, py, env.path_width, expansion)

    # placeable obstacles (lib.rs:283-338)
    for ob in env.obstacles:
        tmask = (trow == ob.tile[0]) & (tcol == ob.tile[1])
        if not tmask.any():
            continue
        shape = ob.shape.expanded(expansion)
        tx = px - ob.translation[0]
        ty = py - ob.translation[1]
        # rotation offset depends on shape kind (lib.rs:305-318)
        if isinstance(ob.shape, RegularPolygon):
            off = math.pi + (math.pi / ob.shape.sides if ob.shape.sides % 2 != 0 else 0.0)
        elif isinstance(ob.shape, Polygon):
            off = 0.0
        else:
            off = math.pi / 2.0
        ang = ob.rotation + off
        ca, sa = math.cos(ang), math.sin(ang)
        rx = ca * tx - sa * ty
        ry = sa * tx + ca * ty
        obstacle |= tmask & shape.inside(rx, ry)

    return np.where(obstacle, 0, 255).astype(np.uint8)


def _offset_modulus(value: np.ndarray, modulus: float) -> np.ndarray:
    # lib.rs:243-246: -(ceil(v/m)*m - v)/m + 1
    return -(np.ceil(value / modulus) * modulus - value) / modulus + 1.0


def _tile_obstacle(ch: str, px, py, path_width: float, expansion: float) -> np.ndarray:
    """Which pixels of a tile with box-drawing char `ch` are obstacle.

    Reference: is_tile_obstacle (env_to_png lib.rs:341-478). `ow` is the
    obstacle band on each side of the carved path; `opw` its far edge.
    """
    pw = path_width - expansion
    ow = (1.0 - pw) / 2.0
    opw = ow + pw
    lo_half = 0.5 - expansion / 2.0
    hi_half = 0.5 + expansion / 2.0

    F = np.zeros_like(px, dtype=bool)
    if ch == "█":
        return F
    if ch == "─":
        return (py < ow) | (py > opw)
    if ch == "│":
        return (px < ow) | (px > opw)
    if ch == "╴":
        return (py < ow) | (py > opw) | (px > lo_half)
    if ch == "╶":
        return (py < ow) | (py > opw) | (px < hi_half)
    if ch == "╷":
        return (px < ow) | (px > opw) | (py < hi_half)
    if ch == "╵":
        return (px < ow) | (px > opw) | (py > lo_half)
    if ch == "┌":
        return (px < ow) | (py < ow) | ((px > opw) & (py > opw))
    if ch == "┐":
        return (px > opw) | (py < ow) | ((px < ow) & (py > opw))
    if ch == "└":
        return (px < ow) | (py > opw) | ((px > opw) & (py < ow))
    if ch == "┘":
        return (px > opw) | (py > opw) | ((px < ow) & (py < ow))
    if ch == "┬":
        return (py < ow) | ((py > opw) & ((px < ow) | (px > opw)))
    if ch == "┴":
        return (py > opw) | ((py < ow) & ((px < ow) | (px > opw)))
    if ch == "├":
        return (px < ow) | ((px > opw) & ((py < ow) | (py > opw)))
    if ch == "┤":
        return (px > opw) | ((px < ow) & ((py < ow) | (py > opw)))
    if ch == "┼":
        return ((px < ow) | (px > opw)) & ((py < ow) | (py > opw))
    if ch == " ":
        return np.ones_like(px, dtype=bool)
    # unknown char -> free space (reference returns false)
    return F


def _gaussian_blur_u8(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable gaussian blur matching `image::imageops::blur` semantics
    (gaussian with given sigma, edge-clamped), quantised back to u8."""
    radius = max(1, int(math.ceil(3.0 * sigma)))
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    kernel = np.exp(-(xs**2) / (2.0 * sigma * sigma))
    kernel /= kernel.sum()

    padded = np.pad(img.astype(np.float64), ((radius, radius), (0, 0)), mode="edge")
    tmp = np.zeros_like(img, dtype=np.float64)
    for i, k in enumerate(kernel):
        tmp += k * padded[i : i + img.shape[0], :]
    padded = np.pad(tmp, ((0, 0), (radius, radius)), mode="edge")
    out = np.zeros_like(tmp)
    for i, k in enumerate(kernel):
        out += k * padded[:, i : i + img.shape[1]]
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def distance_transform(obstacle: np.ndarray, meters_per_pixel: float) -> np.ndarray:
    """Exact euclidean distance (meters) from each pixel to the nearest
    obstacle pixel (Felzenszwalb & Huttenlocher squared-EDT, separable).

    Used for robot-environment collision detection: a robot whose center is
    closer to an obstacle than its radius intersects the environment — the
    dense analogue of the reference's parry2d collider intersection tests
    (planner/collisions.rs:72-140).
    """
    INF = 1e18
    f = np.where(obstacle, 0.0, INF)
    g = np.apply_along_axis(_edt_1d, 0, f)
    d2 = np.apply_along_axis(_edt_1d, 1, g)
    return np.sqrt(d2) * meters_per_pixel


def _edt_1d(f: np.ndarray) -> np.ndarray:
    n = len(f)
    d = np.empty(n)
    v = np.zeros(n, dtype=np.int64)
    z = np.empty(n + 1)
    k = 0
    v[0] = 0
    z[0], z[1] = -np.inf, np.inf
    for q in range(1, n):
        s = ((f[q] + q * q) - (f[v[k]] + v[k] * v[k])) / (2.0 * q - 2.0 * v[k])
        while s <= z[k]:
            k -= 1
            s = ((f[q] + q * q) - (f[v[k]] + v[k] * v[k])) / (2.0 * q - 2.0 * v[k])
        k += 1
        v[k] = q
        z[k] = s
        z[k + 1] = np.inf
    k = 0
    for q in range(n):
        while z[k + 1] < q:
            k += 1
        d[q] = (q - v[k]) ** 2 + f[v[k]]
    return d
