"""The point-gradient scatter (K6) and the two Adam updates by
readers.layer_ms, for the train mix."""

from gpubench.readers import layer_ms


def read(ctx):
    return layer_ms(ctx, "train", "optimizer")
