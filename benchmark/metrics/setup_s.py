"""setup_s: seconds from the process's start to the window's first item
(CUDA start, the registry, its upload, the warm-up of this mix's shapes and
the fixtures)."""


def read(ctx):
    return ctx.setup_s
