"""record.trunk_fill, for the train mix: the trunk's rows that carry a
valid neighbor over the slots K1 and K2 run, the slice's steps."""

from gpubench.record import trunk_fill


def read(ctx):
    return trunk_fill(ctx, "train")
