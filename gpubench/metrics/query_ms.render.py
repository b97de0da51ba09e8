"""The query's kernels (K3 occupancy, the KNN's sorts, the compaction's
searchsorted) by readers.layer_ms, for the render mix."""

from gpubench.readers import layer_ms


def read(ctx):
    return layer_ms(ctx, "render", "query")
