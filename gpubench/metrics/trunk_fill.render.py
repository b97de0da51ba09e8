"""record.trunk_fill, for the render mix: the trunk's rows that carry a
valid neighbor over the slots K1 runs, every rung of the traced image."""

from gpubench.record import trunk_fill


def read(ctx):
    return trunk_fill(ctx, "render")
