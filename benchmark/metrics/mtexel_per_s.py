"""Texels of every level of the textures completed in the window, per
second of the window, in millions (host clock)."""


def read(run):
    texels = sum(it.texels for it in run.items if not it.failed)
    if not texels or run.window_s <= 0:
        return None
    return texels / run.window_s / 1e6
