"""gfx_imagecompress_tpu_torch - BCn texture block compression in PyTorch
with hand-written CUDA kernels for NVIDIA Hopper.

The port of the JAX package beside it, module for module. Entry points run on
the CUDA device unless the caller passes ``device="cpu"``, where the kernels'
plain PyTorch versions run instead. ``compress()`` covers every codec of
the JAX package - BC1-BC5, BC6H (signed and unsigned) and BC7 (the full search
and the fast path) - with decode.
"""

from .api import (compress, compress_amd_bc1, compress_amd_bc2,
                  compress_amd_bc3, compress_amd_bc4, compress_amd_bc5,
                  compress_amd_bc6h, compress_amd_bc7, compress_chunked,
                  compress_richgel999_bc7, pick_compression_type)
from .formats import BlockFormat, CompressType, PickFlags
from .image import CompressedImage, Image
from .options import (AMDBackendOptions, BC1Options, BC6HOptions, BC7Options,
                      RichGel999Options)

__version__ = "0.1.0"

__all__ = [
    "compress", "compress_chunked", "pick_compression_type",
    "compress_amd_bc1", "compress_amd_bc2", "compress_amd_bc3",
    "compress_amd_bc4", "compress_amd_bc5", "compress_amd_bc6h",
    "compress_amd_bc7", "compress_richgel999_bc7",
    "CompressType", "PickFlags", "BlockFormat",
    "Image", "CompressedImage",
    "AMDBackendOptions", "BC1Options", "BC6HOptions", "BC7Options",
    "RichGel999Options",
]
