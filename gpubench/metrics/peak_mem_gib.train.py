"""readers.peak_gib, for the train mix."""

from gpubench.readers import peak_gib


def read(ctx):
    return peak_gib(ctx, "train")
