"""Seeded texture content, mip chains and the block layout, all the
benchmark's own.

Textures are RGBA8 and are made on the device from one ``torch.Generator``
in a few large calls: a smooth gradient, band-limited noise at several
octaves (random grids upsampled bicubically), hard-edged rectangles and discs
of flat colour, and fine detail (per-texel grain and a band of thin
stripes). Alpha is one of three kinds:

- ``opaque``: 255 everywhere;
- ``soft`` (particles, decals): a radial falloff modulated by noise, at most
  0.96, so below 1 in every texel;
- ``cutout`` (foliage): 1 over about 40% of the area and 0 elsewhere, from a
  threshold on smooth noise, with a soft edge about 1.5 texels wide.

A mip chain is a 2x2 box filter in float32 down to 1x1, each level rounded to
uint8 on its own. ``to_blocks`` cuts an (H, W, C) level into (N, 16, C) 4x4
blocks in raster order, clamping to the last row and column where H or W is
not a multiple of 4, as the BC formats' stored size requires.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

ALPHA_KINDS = ("opaque", "soft", "cutout")
SOFT_ALPHA_MAX = 0.96
CUTOUT_COVER = 0.40          # share of the area at alpha 1
CUTOUT_EDGE_TEXELS = 1.5


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from any whole number (wrapped to 64
    bits)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    return g


def _rand(g, shape, device):
    return torch.rand(shape, generator=g, device=device)


def _octaves(g, size, chans, device, finest=4, slope=0.8):
    """Band-limited noise in about [-0.5, 0.5]: random grids of 4, 8, ...
    cells up to cells of ``finest`` texels, each upsampled bicubically to
    ``size`` and weighted by (cells)^-slope."""
    total = torch.zeros((1, chans, size, size), device=device)
    norm = 0.0
    cells = 4
    while cells <= max(4, size // finest):
        grid = _rand(g, (1, chans, cells, cells), device) - 0.5
        amp = cells ** -slope
        total += amp * F.interpolate(grid, size=(size, size), mode="bicubic",
                                     align_corners=False)
        norm += amp
        cells *= 2
    return total[0] / norm                               # (chans, size, size)


def _shapes(g, size, device, count=24):
    """Hard-edged flat-colour shapes: (mask (size, size) int64 shape id + 1
    or 0, colours (count, 3))."""
    coords = (torch.arange(size, device=device, dtype=torch.float32) + 0.5
              ) / size
    ys, xs = coords[:, None], coords[None, :]
    params = _rand(g, (count, 6), device)
    colours = _rand(g, (count, 3), device)
    ids = torch.zeros((size, size), dtype=torch.int64, device=device)
    for k, (cx, cy, w, h, kind, _) in enumerate(params.tolist()):
        w, h = 0.02 + 0.12 * w, 0.02 + 0.12 * h
        if kind < 0.5:
            inside = ((xs - cx).abs() < w) & ((ys - cy).abs() < h)
        else:
            inside = ((xs - cx) / w) ** 2 + ((ys - cy) / h) ** 2 < 1.0
        ids = torch.where(inside, k + 1, ids)
    return ids, colours


def _alpha(g, kind, size, device):
    if kind == "opaque":
        return torch.ones((size, size), device=device)
    if kind == "soft":
        coords = (torch.arange(size, device=device, dtype=torch.float32)
                  + 0.5) / size - 0.5
        r = torch.sqrt(coords[:, None] ** 2 + coords[None, :] ** 2) / 0.5
        bump = torch.clamp(1.0 - r, 0.0, 1.0) ** 0.7
        mod = 0.55 + _octaves(g, size, 1, device, finest=8)[0]
        return torch.clamp(bump * mod * 1.3, 0.0, 1.0) * SOFT_ALPHA_MAX
    if kind == "cutout":
        f = _octaves(g, size, 1, device, finest=16, slope=0.5)[0]
        step = max(1, size // 512)
        thr = torch.quantile(f[::step, ::step].reshape(-1).float(),
                             1.0 - CUTOUT_COVER)
        gy = torch.zeros_like(f)
        gx = torch.zeros_like(f)
        gy[1:-1] = (f[2:] - f[:-2]) * 0.5
        gx[:, 1:-1] = (f[:, 2:] - f[:, :-2]) * 0.5
        grad = gx.abs() + gy.abs() + 1e-7
        return torch.clamp(0.5 + (f - thr) / (CUTOUT_EDGE_TEXELS * grad),
                           0.0, 1.0)
    raise ValueError(f"textures: unknown alpha kind {kind!r}; one of "
                     f"{ALPHA_KINDS}")


def texture(g: torch.Generator, size: int, alpha: str, device) -> torch.Tensor:
    """One square RGBA texture in [0, 1], float32 (size, size, 4)."""
    coords = (torch.arange(size, device=device, dtype=torch.float32)
              + 0.5) / size
    ys, xs = coords[:, None], coords[None, :]
    p = _rand(g, (12,), device).tolist()
    angle = 2 * math.pi * p[0]
    ramp = (math.cos(angle) * xs + math.sin(angle) * ys)
    ramp = (ramp - ramp.min()) / (ramp.max() - ramp.min() + 1e-6)
    c0 = torch.tensor(p[1:4], device=device)[:, None, None]
    c1 = torch.tensor(p[4:7], device=device)[:, None, None]
    rgb = c0 + (c1 - c0) * ramp[None]                     # (3, size, size)
    rgb = rgb + 0.9 * _octaves(g, size, 3, device)
    ids, colours = _shapes(g, size, device)
    grain = _rand(g, (3, size, size), device) - 0.5
    flat = colours.t()[:, (ids - 1).clamp(min=0)]         # (3, size, size)
    rgb = torch.where(ids[None] > 0, flat + 0.05 * grain, rgb)
    # a band of thin stripes, period 3 to 8 texels, at a random angle
    period = 3.0 + 5.0 * p[7]
    band = ((ys - p[8]).abs() < 0.08).float()
    stripes = torch.sin(2 * math.pi * size * (xs * math.cos(p[9] * 3)
                                              + ys * math.sin(p[9] * 3))
                        / period)
    rgb = rgb + band[None] * 0.25 * stripes[None] + 0.04 * grain
    a = _alpha(g, alpha, size, device)
    return torch.cat([rgb.clamp(0.0, 1.0), a[None]], 0).permute(1, 2, 0)


def to_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def mip_chain(base: torch.Tensor) -> list:
    """float32 (S, S, 4) with S a power of two -> uint8 levels S, S/2, ...,
    1, each (s, s, 4): 2x2 box filter in float32, each level rounded on its
    own."""
    levels = [to_u8(base)]
    cur = base.permute(2, 0, 1)[None]
    while cur.shape[-1] > 1:
        cur = F.avg_pool2d(cur, 2)
        levels.append(to_u8(cur[0].permute(1, 2, 0)))
    return levels


def chain_sizes(size: int) -> list:
    """Sides of a full mip chain of a square power-of-two texture."""
    out = [size]
    while out[-1] > 1:
        out.append(out[-1] // 2)
    return out


def to_blocks(img: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (N, 16, C) 4x4 blocks in raster order, pixels row-major
    in a block; rows and columns past the edge repeat the last one."""
    h, w, c = img.shape
    bh, bw = -(-h // 4), -(-w // 4)
    ys = torch.arange(bh * 4, device=img.device).clamp(max=h - 1)
    xs = torch.arange(bw * 4, device=img.device).clamp(max=w - 1)
    t = img.index_select(0, ys).index_select(1, xs)
    t = t.reshape(bh, 4, bw, 4, c).permute(0, 2, 1, 3, 4)
    return t.reshape(bh * bw, 16, c)


def from_blocks(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, 16, C) blocks of an (H, W) image -> (H, W, C), padding cut."""
    bh, bw = -(-h // 4), -(-w // 4)
    c = blocks.shape[-1]
    t = blocks.reshape(bh, bw, 4, 4, c).permute(0, 2, 1, 3, 4)
    return t.reshape(bh * 4, bw * 4, c)[:h, :w]
