"""Pixel samples completed in the window (width x height x spp a pass, over
every update that ended in it) per second of the window, in millions: the
reference renderer's own HUD figure, W*H*spp / frame time."""


def read(ctx):
    return ctx.samples / ctx.window_s / 1e6
