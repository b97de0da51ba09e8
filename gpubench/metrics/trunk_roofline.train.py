"""readers.trunk_roofline, for the train mix."""

from gpubench.readers import trunk_roofline


def read(ctx):
    return trunk_roofline(ctx, "train")
