"""Seconds from the process's start to the window's first update: imports,
CUDA initialisation, loading (or, in a fresh checkout, building) the
port's kernel libraries, the scene, its acceleration build and the
warm-up update."""


def read(ctx):
    return ctx.setup_s
