"""Carries data and options between the JAX package and this one.

This system has no weights; what crosses between the two packages is images,
packed blocks and option structs. Everything passes as numpy arrays or plain
attributes, so this module imports nothing of the other package: the caller
(a test) holds both.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import options as _options
from .formats import BlockFormat
from .image import (CompressedImage, DeviceLike, Image, words_from_numpy,
                    words_to_numpy)

_OPTION_TYPES = {cls.__name__: cls for cls in (
    _options.BC1Options, _options.AMDBackendOptions,
    _options.RichGel999Options, _options.BC7Options, _options.BC6HOptions)}


def image_from_reference(data_np, srgb: bool = False, signed: bool = False,
                         hdr: bool = False,
                         device: DeviceLike = None) -> Image:
    """The other package's ``Image`` fields (``np.asarray(img.data)`` and its
    flags) -> this package's ``Image`` on ``device``."""
    return Image.from_array(np.asarray(data_np), srgb=srgb, signed=signed,
                            hdr=hdr, device=device)


def compressed_from_reference(blocks_np_u32, format_name: str, width: int,
                              height: int, slices: int = 1,
                              device: DeviceLike = None) -> CompressedImage:
    """The other package's ``CompressedImage`` fields (uint32 block grid,
    ``format.name`` or ``format.value``) -> this package's container."""
    try:
        fmt = BlockFormat[format_name]
    except KeyError:
        fmt = BlockFormat(format_name)
    return CompressedImage(words_from_numpy(blocks_np_u32, device), fmt,
                           int(width), int(height), int(slices))


def compressed_to_numpy(ci: CompressedImage) -> np.ndarray:
    """Block grid as a little-endian ``<u4`` array of the same shape - what
    the other package's decoders take."""
    return words_to_numpy(ci.blocks)


def options_from_reference(obj):
    """Copy one of the five option dataclasses field by field, by attribute
    name, into this package's class of the same name."""
    cls = _OPTION_TYPES.get(type(obj).__name__)
    if cls is None:
        raise TypeError(f"not an options struct: {type(obj).__name__}")
    return cls(**{f.name: getattr(obj, f.name)
                  for f in dataclasses.fields(cls)})
