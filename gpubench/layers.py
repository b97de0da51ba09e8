"""Device kernels by family and families by layer: the frozen name table
that turns a trace's kernel names into per-layer device time.

FAMILIES is `profile_render.py`'s table (first match of a lower-case
substring wins), with `searchsorted` added for the query's compaction.
K2's weight-gradient phase (`wgrad_kernel`, `reduce_splits`,
`reduce_head`) belongs to K2. Elementwise and gather kernels run in every
layer and are left in their own families, counted in no layer.
"""

from __future__ import annotations

WGRAD = ("wgrad_kernel", "reduce_splits", "reduce_head")
FAMILIES = (("K1 trunk_fwd", ("trunk_fwd",)),
            ("K2 trunk_bwd", ("trunk_bwd",) + WGRAD),
            ("TF32 weight splits", ("split_weights",)),
            ("K3 occupancy", ("occupancy",)),
            ("K4 shade_fwd", ("shade_fwd",)),
            ("K5 shade_bwd", ("shade_bwd",)),
            ("K6 scatter_rows", ("scatter_rows",)),
            ("K7 row_select", ("row_select",)),
            ("max_pool3d (grid dilation)", ("max_pool", "pool3d")),
            ("Adam", ("adam", "multi_tensor")),
            ("cuDNN convs", ("fprop", "dgrad", "convolve", "conv_")),
            ("batch norm", ("bn_fw",)),
            ("grid_sample", ("grid_sampler",)),
            ("searchsorted", ("searchsorted", "bucketize")),
            ("scatters", ("scatter", "index_put", "indexing_backward")),
            ("gathers", ("gather", "index")),
            ("sorts", ("sort",)),
            ("GEMMs", ("gemm", "xmma", "cutlass")),
            ("scans", ("scan", "cumsum")))

# the layers of PERF.md's list that per-layer metrics read, by the families
# whose kernels they launch (the trunk: the aggregator's K1 and K2)
LAYERS = {
    "query": ("K3 occupancy", "sorts", "searchsorted"),
    "trunk": ("K1 trunk_fwd", "K2 trunk_bwd"),
    "optimizer": ("K6 scatter_rows", "Adam"),
}


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "rest"


def layer_seconds(families: dict, layer: str) -> float:
    return sum(families.get(f, 0.0) for f in LAYERS[layer])
