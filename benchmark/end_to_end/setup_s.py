"""Set-up seconds: the script's start to the window's start — imports, the
CUDA context, the kernel library, the load from the seed and the warm
passes (host clock)."""


def read(ctx):
    return ctx["setup_s"]
