#!/usr/bin/env python3
"""Hold the port's block entries against both of the JAX package's routes,
on the CPU: the XLA functions (which the JAX ``blockapi`` calls) and the
Pallas kernels in interpret mode (which the port's CUDA kernels mirror).
These comparisons are too slow for the test suite (about 2 minutes with a
warm ``.jax_cache``).

    JAX_PLATFORMS=cpu python scripts/blockapi_jax_routes.py [--out FILE]

- ``bc7``: full BC7 at quality 0.25, all 8 modes, on two 16x16 photos (16
  blocks each): the port's words (``compress_multi_mode_ldr_blocks``, plain
  versions) against ``encode_bc7_blocks_pallas(tile=4)`` and the XLA
  ``encode_bc7_blocks``, block by block, with each block's mode. The Pallas
  compile takes about 8 minutes cold (then the persistent cache in
  ``.jax_cache`` serves it).
- ``mode4``: mode 4 alone at quality 0.25 on eight 8x8 photos (seeds 80-87,
  4 blocks each), at the Pallas configuration ``tests/test_torch_bc7_full.py``
  compiles.

Prints one JSON object per part; ``--out`` also writes them to a file.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def _photo(h, w, seed):
    import jax.numpy as jnp
    import numpy as np
    from conftest import photo_rgba
    from gfx_imagecompress_tpu.pipeline.blocks import image_to_blocks
    img = photo_rgba(h, w, seed=seed)
    return np.array(image_to_blocks(jnp.asarray(img[None])), np.float32)


def _modes(words):
    import torch
    from gfx_imagecompress_tpu_torch.decode.bc7 import block_modes
    return block_modes(torch.from_numpy(words.view("int32"))).tolist()


def part_bc7():
    import jax.numpy as jnp
    import numpy as np
    from gfx_imagecompress_tpu.kernels import bc7_full as jxla
    from gfx_imagecompress_tpu.kernels.bc7_full_pallas import (
        encode_bc7_blocks_pallas)
    from gfx_imagecompress_tpu_torch import blockapi
    rows = []
    for seed in (81, 11):
        b = _photo(16, 16, seed)
        t0 = time.perf_counter()
        wp = np.asarray(encode_bc7_blocks_pallas(jnp.asarray(b), tile=4,
                                                 quality=0.25)[0])
        pallas_s = time.perf_counter() - t0
        wx = np.asarray(jxla.encode_bc7_blocks(jnp.asarray(b),
                                               quality=0.25)[0])
        wt = blockapi.compress_multi_mode_ldr_blocks(
            b, quality=0.25, device="cpu").numpy().view(np.uint32)
        rows.append({"seed": seed, "blocks": len(b), "pallas_s": pallas_s,
                     "modes_pallas": _modes(wp), "modes_xla": _modes(wx),
                     "port_eq_pallas": (wt == wp).all(1).astype(int).tolist(),
                     "xla_eq_pallas": (wx == wp).all(1).astype(int).tolist(),
                     "port_eq_xla": (wt == wx).all(1).astype(int).tolist()})
    return {"part": "bc7", "quality": 0.25, "rows": rows}


def part_mode4():
    import jax.numpy as jnp
    import numpy as np
    import torch
    from gfx_imagecompress_tpu.kernels import bc7_full as jxla
    from gfx_imagecompress_tpu.kernels.bc7_full_pallas import (
        encode_bc7_blocks_pallas)
    from gfx_imagecompress_tpu_torch.kernels import bc7_full
    tot = {"blocks": 0, "port_eq_pallas": 0, "xla_eq_pallas": 0,
           "port_eq_xla": 0}
    for seed in range(80, 88):
        b = _photo(8, 8, seed)
        kw = dict(quality=0.25, mode_mask=0x10, _plist=(0, 1), _topk=1)
        wp = np.asarray(encode_bc7_blocks_pallas(jnp.asarray(b), tile=4,
                                                 **kw)[0])
        wx = np.asarray(jxla.encode_bc7_blocks(jnp.asarray(b), quality=0.25,
                                               mode_mask=0x10)[0])
        wt = bc7_full.encode_bc7_blocks(torch.from_numpy(b), **kw)[
            0].numpy().view(np.uint32)
        tot["blocks"] += len(b)
        tot["port_eq_pallas"] += int((wt == wp).all(1).sum())
        tot["xla_eq_pallas"] += int((wx == wp).all(1).sum())
        tot["port_eq_xla"] += int((wt == wx).all(1).sum())
    return {"part": "mode4", "quality": 0.25, "seeds": [80, 87], **tot}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import conftest  # noqa: F401  (JAX on the CPU, the persistent cache)
    results = []
    for part in (part_bc7, part_mode4):
        res = part()
        print(json.dumps(res), flush=True)
        results.append(res)
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
