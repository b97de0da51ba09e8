"""readers.mfu, for the render mix."""

from gpubench.readers import mfu


def read(ctx):
    return mfu(ctx, "render")
