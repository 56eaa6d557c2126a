"""One module per encoder that a configuration names (``"encoder"`` in its
file): how the cell calls ``compress``, the plain reference and the control
at the configuration's budget, the statistics of a texture's blocks that the
counts read, and each kernel's least time for those blocks."""
