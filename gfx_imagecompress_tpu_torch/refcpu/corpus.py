"""Deterministic natural-image-like corpus for quality benchmarking.

The BASELINE north star asks for PSNR comparisons "on the Kodak set"; this
environment has no network egress, so the corpus is a seeded procedural
stand-in with the statistics that make block compression interesting:
smooth multi-octave shading (low-frequency PCA-friendly ramps), hard edges
(partition stress), saturated colour regions (endpoint precision stress),
fine texture/noise (index-quantizer stress) and near-solid patches
(single-colour paths).  Generation is bit-deterministic (fixed PCG seeds),
so results are comparable across machines without checked-in binaries.

Each "kodim-like" image mixes all feature classes at different mixture
weights; `corpus(n, size)` returns n float32 RGB images in [0, 1].
"""
from __future__ import annotations

import numpy as np


def _smooth_noise(rng, h, w, cells):
    """Bilinear-upsampled random grid (one octave of value noise)."""
    gy, gx = max(2, h // cells), max(2, w // cells)
    g = rng.random((gy + 1, gx + 1))
    yy = np.linspace(0, gy, h, endpoint=False)
    xx = np.linspace(0, gx, w, endpoint=False)
    y0 = yy.astype(int)
    x0 = xx.astype(int)
    fy = (yy - y0)[:, None]
    fx = (xx - x0)[None, :]
    a = g[y0][:, x0]
    b = g[y0][:, x0 + 1]
    c = g[y0 + 1][:, x0]
    d = g[y0 + 1][:, x0 + 1]
    return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
            + c * fy * (1 - fx) + d * fy * fx)


def _octaves(rng, h, w, base_cells=4, n=4, decay=0.55):
    out = np.zeros((h, w))
    amp, total = 1.0, 0.0
    cells = base_cells
    for _ in range(n):
        out += amp * _smooth_noise(rng, h, w, max(2, min(cells, h // 2)))
        total += amp
        amp *= decay
        cells *= 2
    return out / total


def _edges(rng, h, w, n_shapes=6):
    """Random half-plane / rectangle steps — hard edges."""
    out = np.zeros((h, w))
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    for _ in range(n_shapes):
        kind = rng.integers(0, 2)
        if kind == 0:
            nx, ny = rng.normal(size=2)
            c = rng.random()
            out += (nx * xx + ny * yy > c * (nx + ny)) * rng.uniform(-1, 1)
        else:
            y0, x0 = rng.random(2) * 0.8
            hh, ww = rng.random(2) * 0.4 + 0.05
            out += (((yy > y0) & (yy < y0 + hh) & (xx > x0) & (xx < x0 + ww))
                    * rng.uniform(-1, 1))
    return out


def make_image(seed: int, h: int = 128, w: int = 128) -> np.ndarray:
    """One deterministic RGB image (h, w, 3) float32 in [0, 1]."""
    rng = np.random.default_rng(np.random.PCG64(seed * 7919 + 13))
    # per-channel mixtures with correlated luma so colours look natural
    luma = _octaves(rng, h, w, base_cells=3, n=5)
    edges = _edges(rng, h, w)
    fine = rng.normal(0, 1, (h, w))
    chroma_scale = rng.uniform(0.1, 0.5, 3)
    base_col = rng.random(3)
    img = np.empty((h, w, 3))
    for c in range(3):
        tint = _octaves(rng, h, w, base_cells=2, n=3)
        img[..., c] = (0.55 * luma + 0.3 * edges * rng.uniform(0.5, 1.0)
                       + chroma_scale[c] * (tint - 0.5)
                       + 0.03 * fine + 0.35 * base_col[c])
    lo, hi = img.min(), img.max()
    img = (img - lo) / max(hi - lo, 1e-9)
    return img.astype(np.float32)


def corpus(n: int = 8, h: int = 128, w: int = 128) -> list[np.ndarray]:
    """n deterministic RGB images."""
    return [make_image(i, h, w) for i in range(n)]


def corpus_rgba(n: int = 8, h: int = 128, w: int = 128,
                alpha: str = "opaque") -> list[np.ndarray]:
    """RGBA variant; alpha in {'opaque', 'gradient', 'punch'}."""
    out = []
    for i, img in enumerate(corpus(n, h, w)):
        rng = np.random.default_rng(1000 + i)
        if alpha == "opaque":
            a = np.ones((h, w), np.float32)
        elif alpha == "gradient":
            a = _octaves(rng, h, w, base_cells=3, n=3).astype(np.float32)
        else:  # punch-through
            a = (_octaves(rng, h, w, base_cells=3, n=3) > 0.5
                 ).astype(np.float32)
        out.append(np.concatenate([img, a[..., None]], axis=-1))
    return out


def corpus_hdr(n: int = 4, h: int = 64, w: int = 64,
               ev_range: float = 8.0) -> list[np.ndarray]:
    """HDR RGB images spanning ~ev_range stops, for BC6H."""
    out = []
    for i, img in enumerate(corpus(n, h, w)):
        rng = np.random.default_rng(2000 + i)
        exposure = _octaves(rng, h, w, base_cells=2, n=3)
        scale = np.exp2(exposure * ev_range - ev_range / 2).astype(np.float32)
        out.append(img * scale[..., None])
    return out
