"""readers.mfu, for the train mix."""

from gpubench.readers import mfu


def read(ctx):
    return mfu(ctx, "train")
