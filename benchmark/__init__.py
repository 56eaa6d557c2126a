"""The benchmark of the PyTorch and CUDA port (``gfx_imagecompress_tpu_torch``)
on one NVIDIA H100: ``run.py`` runs one cell once. It imports the program only
in ``run.py``; the reference, the comparison and the counts import nothing of
it, nor JAX."""
