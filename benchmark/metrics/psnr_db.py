"""PSNR of the program's downloaded words, decoded by the benchmark's own
decoder, against the sources over a fixed prefix of the seeded work (RGB
for opaque mixes, RGBA for the alpha mixes)."""
import math


def read(run):
    if run.psnr_db is None or not math.isfinite(run.psnr_db):
        return None
    return run.psnr_db
