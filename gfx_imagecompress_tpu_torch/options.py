"""Codec option dataclasses.

Frozen dataclasses, field for field those of the JAX package's
``options.py`` (this is the port's own copy). The search budgets they resolve
to are ordinary arguments of the encoders and launch arguments of the CUDA
kernels.

Mirrors the reference option structs:
  - Image_CompressBC1Options            (imagecompress.h:35-38, defaults bc1:21-27)
  - Image_CompressAMDBackendOptions     (imagecompress.h:40-45, defaults amd_bcx_helpers.cpp:23-31)
  - Image_CompressRichGel999BackendOptions (imagecompress.h:47-50, defaults richgel999_bc7enc16.cpp:13-19)
plus the block-level quality knobs of Image_CompressAMDMultiModeLDRBlock
(imagecompress.h:129-136).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class BC1Options:
    use_alpha: bool = False
    alpha_threshold: int = 128  # 0-255, compared against A*255


@dataclass(frozen=True)
class AMDBackendOptions:
    b3d_refinement: bool = False
    adaptive_colour_weights: bool = False
    refinement_steps: int = 1
    mode_mask: int = 0xFF  # used by BC6H and BC7


@dataclass(frozen=True)
class RichGel999Options:
    perceptual: bool = True
    fast: bool = False


@dataclass(frozen=True)
class BC7Options:
    """Block-level quality knobs of the AMD BC7 path.

    The C++ image compressor hardwires quality=1.0, colourRestrict=True,
    alphaRestrict=True, performance=1.0 (amd_bc7_compressor.cpp:58-65).
    ``quality`` maps to search budgets (partitions tried per mode,
    refinement rounds), mirroring the ctor mapping in
    amd_bc7_body.hpp:108-148.
    """

    quality: float = 1.0
    colour_restrict: bool = True
    alpha_restrict: bool = True
    performance: float = 1.0
    mode_mask: int = 0xFF


@dataclass(frozen=True)
class BC6HOptions:
    signed: bool = False
    quality: float = 1.0
    mode_mask: int = 0xFFFF


# Perceptual channel weights (block_utils.cpp:162-175). The reference's
# "adaptive" path reads uninitialized memory (block_utils.cpp:201-203,
# flagged "not sure this is working yet" at imagecompress.h:42) — we
# implement a *correct* adaptive skew instead (see kernels/bc1.py).
UNIFORM_WEIGHTS = (1.0, 1.0, 1.0)
PERCEPTUAL_WEIGHTS = (0.3086, 0.6094, 0.0820)
