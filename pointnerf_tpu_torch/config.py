"""Structured configuration for pointnerf_tpu_torch.

The port's own copy of `pointnerf_tpu/config.py`: the same `Options`
fields and defaults, `validate_options`, the preset tables and functions,
and `PRESETS`. The port imports nothing of the JAX package, so it keeps
this copy; `tests/test_torch_port_config.py` holds it to the original
field by field and preset by preset. Comments on options that only the
JAX package reads (compile caches, dispatch) are kept as they are there;
those of the fused kernels, the K-tier split, the occupancy budget and
the point Adam say what each does in the port.

The reference (Xharlie/pointnerf) assembles ~150 argparse flags dynamically from the chosen
model/dataset classes (reference: options/base_options.py:118-137, models/neural_points/
neural_points.py:12-229, models/aggregators/point_aggregators.py:14-217). We keep the same
flag *names* so experiment scripts translate 1:1, but as one typed dataclass that is
hashable (usable as a jit static argument) and serializable.

Runtime "modes" the reference mutates on the options object (opt.is_train, opt.prob,
opt.query_size during probing — reference run/train_ft.py:629-644, 848-918) are explicit
function arguments in this framework, not config mutations.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _t(*vals):
    return field(default_factory=lambda: tuple(vals))


@dataclass(frozen=True)
class Options:
    # ---------------------------------------------------------------- global / experiment
    experiment: str = "default"
    checkpoints_dir: str = "./checkpoints"
    resume_dir: str = ""
    resume_iter: str = "latest"
    data_root: str = "./data_src"
    dataset_name: str = "nerf_synth360_ft"
    model: str = "mvs_points_volumetric"
    scan: str = "lego"
    split: str = "train"
    # Multi-device: the reference engages DataParallel from --gpu_ids
    # (reference: options/base_options.py:79-82 +
    # neural_points_volumetric_model.py:165-168). Here the equivalent is an
    # SPMD mesh: --n_devices N (0 = single device, -1 = all local devices)
    # spreads the ray batch over a ("batch","rays"[,"points"]) mesh;
    # --mesh_points M > 1 additionally shards the point buffers / voxel
    # buckets / their Adam moments over a "points" axis (HBM scaling).
    # --gpu_ids with >1 ids is translated to n_devices=len(gpu_ids) by
    # validate_options — never silently ignored.
    gpu_ids: Tuple[int, ...] = _t(0)
    n_devices: int = 0
    mesh_points: int = 1
    # SR_budget compaction groups along the ray axis (per batch row). 1 =
    # one global budget (single-chip default). On a mesh the parallel
    # factories set this to the ray-plane size so the compaction map, the
    # compacted gathers and the whole shade/backward phase stay BLOCK-LOCAL
    # to each ray shard — with a single global budget the compaction gather
    # crosses ray-shard boundaries and GSPMD replicates the entire compacted
    # phase on every device (round-5 finding: the MP/DP step's MLPs ran at
    # the full global row count per device; scripts/mp_hlo_context.py).
    comp_groups: int = 1
    debug: bool = False
    is_train: bool = True
    timestamp: bool = False
    verbose: bool = False

    # ---------------------------------------------------------------- rays / sampling
    random_sample: str = "random"          # patch | random | random2 | no_crop
    random_sample_size: int = 1024         # side of the sampled ray square (rays = size^2)
    batch_size: int = 1
    near_plane: float = 2.0
    far_plane: float = 6.0
    which_ray_generation: str = "near_far_linear"
    domain_size: int = 1
    dir_norm: int = 0
    z_depth_dim: int = 400                 # raw depth samples per ray for voxel walking
    SR: int = 24                           # max shading points per ray
    K: int = 32                            # max neighbor points per shading point
    P: int = 16                            # max points stored per voxel bucket
    NN: int = 2                            # 2: K-NN in world coords (reference NN flag)
    max_o: Optional[int] = None            # max occupied voxels (None = derived)
    SR_budget: int = 0                     # shading-row compaction budget: >0 explicit rows,
                                           # -1 auto (1/6 of B·R·SR, 128-lane rounded), 0 off;
                                           # overflow is reported in items["sr_overflow"]

    # ---------------------------------------------------------------- neural points
    load_points: int = 0
    point_noise: str = ""
    num_point: int = 8192
    construct_res: int = 0
    grid_res: int = 0
    cloud_path: str = ""
    shpnt_jitter: str = "uniform"          # passfunc | uniform | gaussian
    point_features_dim: int = 64
    gpu_maxthr: int = 1024                 # parity only (CUDA thread cap in reference)
    radius_limit_scale: float = 5.0
    depth_limit_scale: float = 1.3
    default_conf: float = -1.0
    vscale: Tuple[int, ...] = _t(2, 2, 2)
    kernel_size: Tuple[int, ...] = _t(3, 3, 3)
    query_size: Tuple[int, ...] = _t(0, 0, 0)
    vsize: Tuple[float, ...] = _t(0.004, 0.004, 0.004)
    wcoord_query: int = -1
    frustum_superset_P: int = 0            # >0: per-voxel candidate supersets on the
                                           # frustum SERVING path (grid prebuilt once
                                           # per camera by render_image); 0 = exact
                                           # 27-tile scan (training / per-chunk builds)
    ranges: Tuple[float, ...] = _t(-100.0, -100.0, -100.0, 100.0, 100.0, 100.0)
    xyz_grad: int = 0
    feat_grad: int = 1
    conf_grad: int = 1
    color_grad: int = 1
    dir_grad: int = 1
    feedforward: int = 0
    inverse: int = 0
    point_conf_mode: str = "1"             # "0": fold into features; "1": multiply weights
    point_color_mode: str = "1"            # "0": fold into features; "1": color branch input
    point_dir_mode: str = "1"              # "0": fold into features; "1": color branch input
    feature_init_method: str = "rand"
    point_init_emb_std: float = 0.0        # >0: init embeddings N(0, std) instead of U(-.5,.5)

    # ---------------------------------------------------------------- aggregator
    which_agg_model: str = "viewmlp"
    agg_distance_kernel: str = "linear"    # quadric | numquadric | linear | numlinear | avg | trilinear
    sh_degree: int = 4
    sh_dist_func: str = "sh_quadric"
    sh_act: str = "sigmoid"
    agg_axis_weight: Optional[Tuple[float, ...]] = None
    agg_dist_pers: int = 20
    apply_pnt_mask: int = 1
    modulator_concat: int = 0
    agg_intrp_order: int = 2
    shading_feature_mlp_layer0: int = 0
    shading_feature_mlp_layer1: int = 2
    shading_feature_mlp_layer2: int = 0
    shading_feature_mlp_layer3: int = 2
    shading_feature_num: int = 256
    point_hyper_dim: int = 256
    shading_alpha_mlp_layer: int = 1
    shading_color_mlp_layer: int = 4
    shading_color_channel_num: int = 3
    num_feat_freqs: int = 3
    num_hyperfeat_freqs: int = 0
    dist_xyz_freq: int = 5
    dist_xyz_deno: float = 0.0
    weight_xyz_freq: int = 2
    weight_feat_dim: int = 8
    agg_weight_norm: int = 1
    view_ori: int = 0
    agg_feat_xyz_mode: str = "None"
    agg_alpha_xyz_mode: str = "None"
    agg_color_xyz_mode: str = "None"
    act_type: str = "LeakyReLU"
    act_super: int = 1

    # ---------------------------------------------------------------- rendering
    which_render_func: str = "radiance"
    which_blend_func: str = "alpha"
    which_tonemap_func: str = "off"
    out_channels: int = 4
    num_pos_freqs: int = 10
    num_viewdir_freqs: int = 4
    fine_sample_num: int = 0
    bg_color: str = "white"
    bgmodel: str = "no"
    compute_depth: int = 0
    raydist_mode_unit: int = 1
    alpha_range: int = 0

    # ---------------------------------------------------------------- losses
    color_loss_items: Tuple[str, ...] = _t(
        "ray_masked_coarse_raycolor", "ray_miss_coarse_raycolor", "coarse_raycolor")
    color_loss_weights: Tuple[float, ...] = _t(1.0, 0.0, 0.0)
    test_color_loss_items: Tuple[str, ...] = _t(
        "coarse_raycolor", "ray_miss_coarse_raycolor", "ray_masked_coarse_raycolor")
    depth_loss_items: Tuple[str, ...] = _t()
    depth_loss_weights: Tuple[float, ...] = _t()
    bg_loss_items: Tuple[str, ...] = _t()
    bg_loss_weights: Tuple[float, ...] = _t()
    zero_one_loss_items: Tuple[str, ...] = _t("conf_coefficient")
    zero_one_loss_weights: Tuple[float, ...] = _t(0.0001)
    l2_size_loss_items: Tuple[str, ...] = _t()
    l2_size_loss_weights: Tuple[float, ...] = _t()
    zero_epsilon: float = 1e-3
    sparse_loss_weight: float = 0.0
    visual_items: Tuple[str, ...] = _t("coarse_raycolor", "gt_image")
    # Emit loss scalars to tensorboardX under checkpoints/{experiment}/tb
    # (reference: options/base_options.py:87-90, utils/visualizer.py:47-52).
    show_tensorboard: int = 0

    # ---------------------------------------------------------------- optimization
    lr: float = 0.0005
    plr: float = 0.002                     # neural-point parameter lr
    # Separate LR for the MVS chain in generalizable training; None falls back
    # to `lr` (reference: models/mvs_points_volumetric_model.py:73-77).
    mvs_lr: Optional[float] = None
    lr_policy: str = "iter_exponential_decay"
    lr_decay_iters: int = 1000000
    lr_decay_exp: float = 0.1
    niter: int = 10000
    niter_decay: int = 10000
    maximum_step: int = 200000
    alter_step: int = 0
    train_and_test: int = 0
    test_num: int = 10
    test_freq: int = 10000
    test_num_step: int = 10
    print_freq: int = 40
    save_iter_freq: int = 10000
    save_point_freq: int = 10000

    # ---------------------------------------------------------------- prune / grow
    prune_thresh: float = 0.1
    prune_iter: int = -1
    prune_max_iter: int = 9999999
    prob_freq: int = 0
    prob_num_step: int = 100
    prob_thresh: float = 0.8
    prob_mul: float = 1.0
    prob_kernel_size: Tuple[float, ...] = _t()
    prob_tiers: Tuple[int, ...] = _t(250000)
    far_thresh: float = -1.0
    prob: int = 0
    prob_mode: int = 0                     # 0: top ray-miss train frames; 1: test frames; else random
    prob_top: int = 1                      # 1: probe the top-ranked miss frames (reference prob_top)

    # ---------------------------------------------------------------- MVS init
    mode: int = 0
    manual_depth_view: int = 1
    pre_d_est: str = ""
    manual_std_depth: float = 0.0
    depth_conf_thresh: float = 0.8
    geo_cnsst_num: int = 2
    full_comb: int = 0
    depth_vid: str = "0"
    ref_vid: int = 0
    trgt_id: int = 0
    init_view_num: int = 3
    depth_occ: int = 0
    appr_feature_str0: Tuple[str, ...] = _t("imgfeat_0_0123", "dir_0", "point_conf")
    vox_res: int = 0
    resample_pnts: int = -1
    bg_filtering: int = 0
    far_plane_shift: Optional[float] = None  # push unmatched bg pixels to a far shell
    comb_file: Optional[str] = None          # extra txt point cloud merged at init
    mvs_img_wh: Tuple[int, ...] = _t(0, 0)   # MVS-net input size (0 = img_wh)
    num_each_depth: int = 1
    depth_grid: int = 128
    # learned-probability init (manual_depth_view == -1; reference
    # mvs_points_model.py:90-97, models.py:813-821)
    pad: int = 24                            # cost-volume spatial pad (pixels at feature res)
    dprob_thresh: float = 0.8                # prob_filter mass threshold
    num_neighbor: int = 1                    # prob_filter window (depth slices)
    mvs_point_sampler: str = "gau_single_sampler"

    # ---------------------------------------------------------------- data
    n_threads: int = 1
    pin_data_in_memory: int = 1
    normview: int = 0
    img_wh: Tuple[int, ...] = _t(800, 800)
    trainskip: int = 1
    testskip: int = 1

    # ---------------------------------------------------------------- misc runtime
    vid: int = 250000
    plane_ind: int = 0
    gen_vid: int = 0
    no_loss: int = 0

    # ---------------------------------------------------------------- tpu-native extras
    grid_rebuild_every: int = 1            # rebuild point grid every N steps (1 = per step)
    compute_dtype: str = "float32"         # float32 | bfloat16 for the aggregator MLP
    steps_per_dispatch: int = 8            # train steps in one dispatch (train_ft; 1 before
                                           # a prune/grow/print/save/test boundary). On the
                                           # card one train step is captured in a CUDA graph
                                           # and replayed (train/graph.py::graph_route): every
                                           # configuration but the frustum query (wcoord_query
                                           # 0: its step builds the camera grid, a host read),
                                           # which runs its steps in turn, as a MeshRunner
                                           # (--n_devices, --mesh_points) runs its sharded ones
    query_max_voxels: int = 14             # cull KNN candidate voxels to T nearest centers (0=all)
    superset_P: int = 0                    # >0: precomputed per-voxel neighborhood supersets (fast query)
    ray_chunk: int = 0                     # >0: map the train render over ray chunks of this size
    profile_dir: str = ""                  # write a torch.profiler trace of the train loop here
                                           # (train_loop.pt.trace.json) and the trace record's
                                           # counters beside it (train_loop.counters.json:
                                           # trunk rows and slots, captures; utils/profiling.py)
    # LPIPS weights (full torch state dicts; see utils/lpips_jax.py docstring
    # for the one-file drop). Empty = LPIPS reported as SKIPPED.
    lpips_alex_path: str = ""
    lpips_vgg_path: str = ""
    prefetch_depth: int = 2                # host batches prepared ahead of the device
    remat: int = 0                         # recompute the shade phase in the backward
                                           # (torch.utils.checkpoint): less memory, more work
    use_fused_trunk: int = -1              # the fused trunk (ops/trunk.py: K1 forward,
                                           # K2 backward). On the card it runs wherever
                                           # the aggregator's products are float32 and
                                           # the config is inside fused_trunk_ok, whatever
                                           # this says; on the CPU 1 runs its plain
                                           # versions, -1 and 0 the unfused composition.
                                           # 1 raises ValueError outside the envelope.
                                           # It must be nonzero for trunk_dtype bfloat16.
    fused_shade: int = 0                   # the fused shade (ops/trunk.py: K4, K5):
                                           # distances, linear weights, the conf clamp
                                           # and the trunk in one kernel whose backward
                                           # emits the per-attribute cotangents, inside
                                           # fused_shade_ok, with float32 products and
                                           # one Rw2c. 0 = off; -1 = on the card only;
                                           # 1 = on the card, and on the CPU as the
                                           # plain versions. It has no bfloat16 form.
    trunk_dtype: str = "float32"           # product operands of the fused trunk.
                                           # "float32": K1/K2 (3xTF32 on the tensor
                                           # cores). "bfloat16": K1b/K2b, every MLP
                                           # product on bf16-rounded operands summed in
                                           # float32 (the PE projections stay float32),
                                           # where the JAX package runs its bf16 kernel:
                                           # use_fused_trunk != 0, compute_dtype float32,
                                           # fused_trunk_ok, one Rw2c and the fused_shade
                                           # route not taken (on the CPU as their plain
                                           # versions); elsewhere it changes nothing.
    trunk_tile: int = 768                  # rows per tile of the JAX package's Pallas
                                           # trunk. Accepted and unused: the port's
                                           # tiles are fixed (64 rows forward, 32
                                           # backward); it changes no function.
    k_tier: int = -1                       # neighbor-count tiering of the compacted shade
                                           # phase (models/renderer.py): compacted rows
                                           # whose valid neighbors all fit in the first
                                           # k_tier slots run a narrow K=k_tier
                                           # aggregator, the rest the full-K one. Exact
                                           # (the tiers partition the rows; tested).
                                           # -1 = auto (1 when compaction is active),
                                           # 0 = off.
    k_tier_wide_frac: float = 0.25         # wide-tier row budget as a fraction of the
                                           # compaction budget (narrow tier always gets the
                                           # full budget — it cannot overflow). Wide-tier
                                           # overflow counts into sr_overflow (driver raises
                                           # / serving ladder escalates, like SR_budget).
    occ_segments: int = -1                 # the JAX package's row budget for its
                                           # segmented occupancy test. Accepted and
                                           # unused: the port's occupancy test and
                                           # select (K3, ops/query.occupancy_select) is
                                           # exact for every ray without a budget, so
                                           # occ_overflow stays 0; it changes no function.
    packed_point_adam: int = 1             # the JAX package's layout of the point-
                                           # attribute Adam state (one packed array or one
                                           # leaf per buffer). Adam is elementwise, so the
                                           # two are one function: the port keeps a
                                           # moment per buffer whatever this says, writes
                                           # {iter}_full.npz per buffer and reads either
                                           # layout (utils/checkpoint.py).
    seed: int = 0

    # ------------------------------------------------------------------------- helpers
    def replace(self, **kw) -> "Options":
        return dataclasses.replace(self, **kw)

    @property
    def effective_query_size(self) -> Tuple[int, ...]:
        # reference: neural_points.py:328 — query_size falls back to kernel_size
        return self.kernel_size if self.query_size[0] == 0 else self.query_size

    @property
    def radius_limit(self) -> float:
        # reference: point_query.py:35
        return float(self.radius_limit_scale * max(self.vsize[0], self.vsize[1]))

    def to_json(self) -> str:
        def enc(v):
            if isinstance(v, tuple):
                return list(v)
            return v
        return json.dumps({k: enc(v) for k, v in dataclasses.asdict(self).items()},
                          indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Options":
        raw = json.loads(text)
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kw = {}
        for k, v in raw.items():
            if k not in fields:
                continue
            if isinstance(v, list):
                v = tuple(v)
            kw[k] = v
        return cls(**kw)


# -------------------------------------------------------------------- validation
# Reference-CLI flags whose ONLY implemented behavior is the value every
# shipped reference dev_script uses. They parse (so reference scripts work
# verbatim) but any other value would silently change nothing — so the CLI
# layer rejects it loudly instead (round-1 review: "no flag parses that has
# no effect").
_SUPPORTED_VALUES = {
    "trunk_dtype": ("bfloat16", "float32"),
    "which_agg_model": ("viewmlp",),       # the only aggregator any dev_script uses
    "apply_pnt_mask": (1,),                # mask always applied (padded buffers)
    "NN": (2, 0, -1),                      # 2: world-coord KNN (frustum =
                                           # wcoord_query 0); 0: frustum
                                           # random-sample neighbors
                                           # (reference query_rand_along_ray,
                                           # query_point_indices.py:414-491);
                                           # -1: 8-corner vox-grid query
                                           # (ops/voxgrid.py)
    "normview": (0, 1),                    # 1: re-express poses in the first
                                           # test cam's frame (nerf_synth_ft);
                                           # 2 (norm mats kept for the model's
                                           # query embedding) has no consumer
                                           # here — per-point Rw2c covers it
    "alpha_range": (0,),
    "modulator_concat": (0,),
    "num_hyperfeat_freqs": (0,),
    "fine_sample_num": (0,),               # refine generators take counts directly
    "mvs_point_sampler": ("gau_single_sampler",),
    "no_loss": (0,),
    "shading_color_channel_num": (3,),
    # schedules implemented in models/networks.py::make_lr_schedule
    # (plateau = constant schedule + driver-owned PlateauTracker reduction)
    "lr_policy": ("iter_exponential_decay", "lambda", "step", "plateau"),
    "train_and_test": (0, 1),              # drivers always test at the end
}
# loss families (depth / bg / l2_size) are implemented in models/losses.py;
# each item list must come with a weight list of matching length (or a single
# broadcast weight, reference base_rendering_model.py:237-268)
_WEIGHTED_LOSSES = ("color_loss", "depth_loss", "bg_loss", "zero_one_loss",
                    "l2_size_loss")
# GPU/loader knobs with no TPU meaning (device use is via the jax mesh;
# items are host numpy + scan dispatch): accepted silently at any value
# — gpu_ids, gpu_maxthr, n_threads, pin_data_in_memory, mvs_img_wh.


def validate_options(opt: "Options") -> "Options":
    """Reject flag values that would silently change nothing."""
    for name, ok in _SUPPORTED_VALUES.items():
        v = getattr(opt, name)
        if v not in ok:
            raise NotImplementedError(
                f"--{name}={v!r}: only {ok} is implemented (the value every "
                f"shipped reference dev_script uses)")
    for fam in _WEIGHTED_LOSSES:
        its = getattr(opt, fam + "_items")
        ws = getattr(opt, fam + "_weights")
        if its and len(ws) != len(its) and len(ws) != 1:
            raise ValueError(
                f"--{fam}_weights must have 1 entry or match "
                f"--{fam}_items ({len(its)} items, {len(ws)} weights)")
    if opt.NN == 0 and opt.wcoord_query != 0:
        # the reference's world-coord pycuda module DECLARES a
        # query_rand_along_ray handle but its CUDA source never defines it
        # (query_point_indices_worldcoords.py:530 — only NN>0 is usable
        # there); the mode exists only on the frustum path
        raise ValueError(
            "--NN 0 (random-sample neighbors, reference "
            "query_rand_along_ray) is a frustum-path mode; it requires "
            "--wcoord_query 0")
    if opt.NN < 0:
        # vox-grid query: the cloud must be a construct_grid_points lattice
        # with frozen positions (ops/voxgrid.py derive_lattice)
        if opt.construct_res <= 0 or opt.grid_res < opt.construct_res:
            raise ValueError(
                "--NN -1 (vox-grid query) requires 0 < construct_res <= "
                f"grid_res, got construct_res={opt.construct_res} "
                f"grid_res={opt.grid_res}")
        if opt.xyz_grad:
            raise ValueError(
                "--NN -1 requires --xyz_grad 0: trainable positions drift "
                "off the lattice the corner table indexes (the reference "
                "never rebuilds full_grid_idx either, neural_points.py:261)")
        if opt.wcoord_query == 0:
            raise ValueError("--NN -1 is a world-coord mode; it cannot be "
                             "combined with the frustum querier "
                             "(--wcoord_query 0)")
    # multi-device: honor the reference's --gpu_ids spirit (DataParallel
    # engaged automatically from the flag) — multiple ids mean "use that many
    # devices", translated to the SPMD mesh; never a silent no-op
    if len(opt.gpu_ids) > 1:
        if opt.n_devices not in (0, len(opt.gpu_ids)):
            raise ValueError(
                f"--gpu_ids {opt.gpu_ids} conflicts with --n_devices "
                f"{opt.n_devices}; set one (gpu_ids maps to the first "
                f"len(gpu_ids) jax devices)")
        opt = opt.replace(n_devices=len(opt.gpu_ids))
    if opt.mesh_points < 1:
        raise ValueError(f"--mesh_points must be >= 1, got {opt.mesh_points}")
    if opt.mesh_points > 1:
        n = opt.n_devices
        if n > 0 and n % opt.mesh_points != 0:
            raise ValueError(
                f"--mesh_points {opt.mesh_points} must divide --n_devices {n}")
    if opt.point_noise:
        fn = opt.point_noise.split("_")[0]
        if fn not in ("pointgaussian", "pointuniform", "pointuniformadd",
                      "pointuniformdouble"):
            raise ValueError(f"--point_noise {opt.point_noise!r}: unknown "
                             "jitter function (data/load_blender.py)")
    return opt


# ---------------------------------------------------------------------------- presets
# Script-parity presets for the reference dev_scripts. Values transcribed from the
# corresponding bash configs (reference: dev_scripts/w_n360/<scene>_cuda.sh).

_NERF_SYNTH_RANGES = {
    # reference: dev_scripts/w_n360/*_cuda.sh `ranges=`
    "lego": (-0.638, -1.141, -0.346, 0.634, 1.149, 1.141),
    "chair": (-0.721, -0.695, -0.995, 0.658, 0.706, 1.050),
    "drums": (-1.126, -0.746, -0.492, 1.122, 0.962, 0.939),
    "ficus": (-0.377, -0.858, -1.034, 0.555, 0.578, 1.141),
    "hotdog": (-1.198, -1.286, -0.190, 1.198, 1.110, 0.312),
    "materials": (-1.123, -0.759, -0.232, 1.072, 0.986, 0.200),
    "mic": (-1.252, -0.910, -0.742, 0.767, 1.082, 1.151),
    "ship": (-1.277, -1.300, -0.550, 1.371, 1.349, 0.729),
}

# per-scene deltas from the shared base (reference: dev_scripts/w_n360/
# {scene}_cuda.sh — the in-process-grow variants, matching this framework's
# restartless design). prune_iter < 0 disables pruning; prob_thresh < 0
# disables opacity gating during probing (ficus grows from every miss).
_NERF_SYNTH_OVERRIDES = {
    "chair": dict(max_o=410000, prune_iter=-10001),
    "drums": dict(max_o=400000, prune_iter=-10001),
    "ficus": dict(max_o=290000, prob_thresh=-0.7, plr=0.008,
                  zero_one_loss_items=(), zero_one_loss_weights=()),
    "hotdog": dict(max_o=1000000),
    "lego": dict(max_o=830000),
    "materials": dict(max_o=930000, prune_iter=-10001),
    "mic": dict(max_o=300000, random_sample_size=110,
                zero_one_loss_items=(), zero_one_loss_weights=()),
    "ship": dict(max_o=1500000, vox_res=280, prob_thresh=0.5),
}


def nerf_synth_preset(scan: str = "lego", **overrides) -> Options:
    """Per-scene NeRF-Synthetic finetune config (reference: dev_scripts/w_n360/lego_cuda.sh)."""
    base = Options(
        experiment=f"{scan}_tpu",
        scan=scan,
        dataset_name="nerf_synth360_ft",
        model="mvs_points_volumetric",
        ranges=_NERF_SYNTH_RANGES.get(scan, (-100.0,) * 3 + (100.0,) * 3),
        vsize=(0.004, 0.004, 0.004),
        vscale=(2, 2, 2),
        kernel_size=(3, 3, 3),
        query_size=(3, 3, 3),
        z_depth_dim=400,
        max_o=830000,
        SR=80,
        K=8,
        P=9,
        NN=2,
        radius_limit_scale=4.0,
        depth_limit_scale=0.0,
        agg_dist_pers=20,
        agg_intrp_order=2,
        agg_distance_kernel="linear",
        agg_axis_weight=(1.0, 1.0, 1.0),
        point_features_dim=32,
        num_pos_freqs=10,
        num_viewdir_freqs=4,
        dist_xyz_freq=5,
        num_feat_freqs=3,
        shading_feature_mlp_layer1=2,
        shading_feature_mlp_layer3=2,
        shading_alpha_mlp_layer=1,
        shading_color_mlp_layer=4,
        shading_feature_num=256,
        act_type="LeakyReLU",
        point_conf_mode="1",
        point_dir_mode="1",
        point_color_mode="1",
        default_conf=0.15,
        which_ray_generation="near_far_linear",
        near_plane=2.0,
        far_plane=6.0,
        which_tonemap_func="off",
        which_render_func="radiance",
        which_blend_func="alpha",
        out_channels=4,
        random_sample="random",
        random_sample_size=60,
        bg_color="white",
        lr=0.0005,
        plr=0.002,
        lr_policy="iter_exponential_decay",
        lr_decay_iters=1000000,
        lr_decay_exp=0.1,
        maximum_step=200000,
        prune_thresh=0.1,
        prune_iter=10001,
        prune_max_iter=130000,
        prob_freq=10001,
        prob_num_step=20,
        prob_thresh=0.7,
        prob_mul=0.4,
        prob_kernel_size=(3.0, 3.0, 3.0),
        prob_tiers=(100000,),
        zero_epsilon=1e-3,
        zero_one_loss_items=("conf_coefficient",),
        zero_one_loss_weights=(0.0001,),
        color_loss_items=("ray_masked_coarse_raycolor",
                          "ray_miss_coarse_raycolor", "coarse_raycolor"),
        color_loss_weights=(1.0, 0.0, 0.0),
        depth_conf_thresh=0.8,
        geo_cnsst_num=0,
        full_comb=1,
        vox_res=320,
        manual_depth_view=1,
        init_view_num=3,
        shpnt_jitter="uniform",
        apply_pnt_mask=1,
        raydist_mode_unit=1,
        superset_P=64,
        SR_budget=-1,
        depth_occ=1,
        bg_filtering=1,
    )
    scene = _NERF_SYNTH_OVERRIDES.get(scan)
    if scene:
        base = base.replace(**scene)
    return base.replace(**overrides) if overrides else base


# reference: dev_scripts/w_scannet_etf/scene101.sh is a test_ft-only config —
# the per-scene deltas still matter for evaluating its released checkpoint.
_SCANNET_OVERRIDES = {
    "scene0101_04": dict(max_o=2000000, P=30),
}


def nerf_synth_colmap_preset(scan: str = "chair", **overrides) -> Options:
    """COLMAP-initialized NeRF-Synthetic finetune (reference:
    dev_scripts/w_colmap_n360/col_{chair,drums,ficus,hotdog,lego,materials,
    mic,ship}.sh): load_points=1 from the nerf_synthetic_colmap root
    (colmap_results/dense/fused.ply), pruning disabled, 70-ray-side batches,
    probe kernel 1³ with a single 60k tier, no zero-one conf loss."""
    base = nerf_synth_preset(scan).replace(
        experiment=f"col_{scan}_tpu",
        load_points=1, prune_thresh=-1.0, prune_iter=-1,
        random_sample_size=70, prob_num_step=50,
        prob_kernel_size=(1.0, 1.0, 1.0), prob_tiers=(60000,),
        vox_res=320,
        zero_one_loss_items=(), zero_one_loss_weights=(),
    )
    return base.replace(**overrides) if overrides else base


def scannet_preset(scan: str = "scene0241_01", **overrides) -> Options:
    """ScanNet per-scene finetune (reference: dev_scripts/w_scannet_etf/scene241.sh)."""
    base = Options(
        experiment=f"{scan}_tpu", scan=scan, dataset_name="scannet_ft",
        model="mvs_points_volumetric", load_points=2,
        img_wh=(640, 480), vox_res=900,
        prune_thresh=-1.0, prune_iter=-1, default_conf=-1.0,
        radius_limit_scale=4.0, depth_limit_scale=0.0,
        vscale=(2, 2, 2), kernel_size=(3, 3, 3), query_size=(3, 3, 3),
        vsize=(0.008, 0.008, 0.008), z_depth_dim=400, max_o=610000,
        ranges=(-10.0, -10.0, -10.0, 10.0, 10.0, 10.0),
        SR=24, K=8, P=26, apply_pnt_mask=1,
        near_plane=0.1, far_plane=8.0, random_sample_size=56,
        plr=0.002, lr=0.0005,
        prob_freq=10000, prob_num_step=100,
        prob_kernel_size=(3.0, 3.0, 3.0, 1.0, 1.0, 1.0),
        prob_tiers=(40000, 120000), prob_mode=0, prob_thresh=0.7, prob_mul=0.4,
        bg_color="white", point_features_dim=32,
        agg_dist_pers=20, agg_intrp_order=2, agg_distance_kernel="linear",
        point_conf_mode="1", point_dir_mode="1", point_color_mode="1",
        superset_P=64, SR_budget=-1,
        maximum_step=200000,
    )
    scene = _SCANNET_OVERRIDES.get(scan)
    if scene:
        base = base.replace(**scene)
    return base.replace(**overrides) if overrides else base


# per-scene deltas from the Barn base (reference: dev_scripts/w_tt_ft/
# {barn,caterpillar,family,ignatius,truck}.sh)
_TT_OVERRIDES = {
    "Barn": dict(
        ranges=(-2.05965, -0.48064, -2.2366, 1.78036, 0.6094, 1.28341),
        vsize=(0.003, 0.003, 0.003), max_o=1500000, P=11,
        far_plane=4.5, random_sample_size=48,
        prob_num_step=20, prob_tiers=(90000,)),
    "Caterpillar": dict(
        ranges=(-1.3345, -0.8172, -0.9727, 0.9255, 0.7428, 1.3273),
        vsize=(0.002, 0.002, 0.002), max_o=1800000, P=10,
        far_plane=3.0, random_sample_size=56,
        prob_num_step=50, prob_tiers=(130000,)),
    "Family": dict(
        ranges=(-0.31397, -0.20539, -0.33925, 0.26604, 0.37462, 0.24076),
        vsize=(0.001, 0.001, 0.001), max_o=800000, P=32,
        far_plane=1.0, random_sample_size=68,
        prob_num_step=50, prob_tiers=(80000,)),
    "Ignatius": dict(
        ranges=(-0.4767, -0.5928, -0.5274, 0.5833, 0.7872, 0.5326),
        vsize=(0.002, 0.002, 0.002), max_o=1050000, P=18,
        far_plane=3.2, random_sample_size=56,
        prob_num_step=25, prob_tiers=(70000,)),
    "Truck": dict(
        ranges=(-1.125, -0.598, -1.052, 0.795, 0.203, 1.029),
        vsize=(0.002, 0.002, 0.002), max_o=1600000, P=10,
        far_plane=3.5, random_sample_size=56,
        prob_num_step=50, prob_tiers=(40000,),
        prune_thresh=-1.0, default_conf=0.1),
}


def tt_preset(scan: str = "Barn", **overrides) -> Options:
    """Tanks&Temples per-scene finetune (reference: dev_scripts/w_tt_ft/*.sh)."""
    base = Options(
        experiment=f"{scan}_tpu", scan=scan, dataset_name="tt_ft",
        model="mvs_points_volumetric",
        img_wh=(1920, 1080), vox_res=640,
        prune_thresh=0.1, prune_iter=10001, default_conf=0.15,
        radius_limit_scale=4.0,
        vscale=(3, 3, 3), kernel_size=(3, 3, 3), query_size=(3, 3, 3),
        vsize=(0.003, 0.003, 0.003), z_depth_dim=400, max_o=1500000,
        ranges=(-100.0,) * 3 + (100.0,) * 3,
        SR=40, K=8, P=11,
        near_plane=0.0, far_plane=4.5,
        random_sample_size=48, plr=0.002, lr=0.0005,
        prob_freq=10001, prob_num_step=20, prob_thresh=0.7, prob_mul=0.4,
        prob_kernel_size=(3.0, 3.0, 3.0), prob_tiers=(90000,),
        bg_color="white", point_features_dim=32,
        agg_dist_pers=20, agg_intrp_order=2, agg_distance_kernel="linear",
        point_conf_mode="1", point_dir_mode="1", point_color_mode="1",
        depth_occ=1, appr_feature_str0=("imgfeat_0_0123", "dir_0",
                                        "point_conf"),
        zero_one_loss_items=("conf_coefficient",),
        zero_one_loss_weights=(0.0001,),
        superset_P=64, SR_budget=-1,
        maximum_step=200000,
    )
    scene = _TT_OVERRIDES.get(scan)
    if scene:
        base = base.replace(**scene)
    return base.replace(**overrides) if overrides else base


def dtu_ft_preset(scan: str = "scan1", **overrides) -> Options:
    """DTU per-scene finetune (reference: dtu_ft_dataset defaults +
    dev_scripts/dtu_test_inf/*.sh geometry; plane background per scan)."""
    base = Options(
        experiment=f"dtu_{scan}_tpu", scan=scan, dataset_name="dtu_ft",
        model="mvs_points_volumetric",
        img_wh=(640, 512), vox_res=320,
        prune_thresh=0.1, prune_iter=10001, default_conf=0.15,
        radius_limit_scale=4.0,
        vscale=(2, 2, 2), kernel_size=(3, 3, 3), query_size=(3, 3, 3),
        vsize=(0.002, 0.002, 0.002), z_depth_dim=400, max_o=500000,
        SR=40, K=8, P=16,
        near_plane=2.125, far_plane=4.525, random_sample_size=56,
        plr=0.002, lr=0.0005,
        init_view_num=3, manual_depth_view=1, depth_vid="0",
        depth_conf_thresh=0.8, geo_cnsst_num=2, depth_grid=128,
        appr_feature_str0=("imgfeat_0_0123", "dir_0", "point_conf"),
        shading_feature_mlp_layer0=1,
        prob_freq=10001, prob_num_step=20, prob_thresh=0.7, prob_mul=0.4,
        prob_kernel_size=(3.0, 3.0, 3.0), prob_tiers=(90000,),
        bg_color="white", point_features_dim=32,
        agg_dist_pers=20, agg_intrp_order=2, agg_distance_kernel="linear",
        point_conf_mode="1", point_dir_mode="1", point_color_mode="1",
        bgmodel="plane",
        zero_one_loss_items=("conf_coefficient",),
        zero_one_loss_weights=(0.0001,),
        superset_P=64, SR_budget=-1,
        maximum_step=200000,
    )
    return base.replace(**overrides) if overrides else base


def dtu_gen_preset(**overrides) -> Options:
    """Generalizable DTU training (reference: dev_scripts/ete/
    dtu_dgt_d012_img0123_conf_agg2_32_dirclr20.sh)."""
    base = Options(
        experiment="dtu_dgt_tpu", dataset_name="dtu",
        model="mvs_points_volumetric", feedforward=1,
        img_wh=(640, 512), ref_vid=0, depth_vid="012", trgt_id=3,
        init_view_num=3, manual_depth_view=1, depth_conf_thresh=0.8,
        geo_cnsst_num=2, depth_grid=128,
        appr_feature_str0=("imgfeat_0_0123", "dir_0", "point_conf"),
        point_features_dim=32, shading_feature_mlp_layer0=1,
        vscale=(2, 2, 2), kernel_size=(5, 5, 5), query_size=(5, 5, 5),
        vsize=(0.002, 0.002, 0.002), z_depth_dim=400,
        SR=40, K=8, P=16, max_o=500000,
        random_sample_size=56, lr=0.0005, alter_step=0,
        agg_dist_pers=20, agg_intrp_order=2, agg_distance_kernel="linear",
        point_conf_mode="1", point_dir_mode="1", point_color_mode="1",
        bg_color="black", maximum_step=250000,
    )
    return base.replace(**overrides) if overrides else base


def dtu_inf_preset(scan: str = "scan1", **overrides) -> Options:
    """Feed-forward DTU inference (reference: dev_scripts/dtu_test_inf/
    inftest_scan{1,8,21,103,114}.sh — maximum_step=0, perspective-frustum
    querier (wcoord_query defaults to 0 there), z-buffered occlusion warp
    (depth_occ=1), geo_cnsst_num=10, full_comb=2)."""
    base = Options(
        experiment=f"dtu_inf_{scan}", dataset_name="dtu",
        model="mvs_points_volumetric", feedforward=1, scan=scan,
        img_wh=(640, 512), ref_vid=0, depth_vid="0", init_view_num=3,
        manual_depth_view=1, manual_std_depth=0.0, num_each_depth=1,
        depth_conf_thresh=0.8, geo_cnsst_num=10, depth_grid=128,
        full_comb=2, default_conf=1.0, depth_occ=1,
        appr_feature_str0=("imgfeat_0_0123", "dir_0", "point_conf"),
        point_features_dim=32, shading_feature_mlp_layer0=1,
        point_conf_mode="01", point_dir_mode="01", point_color_mode="01",
        agg_feat_xyz_mode="None", agg_alpha_xyz_mode="None",
        agg_color_xyz_mode="None", agg_axis_weight=(1.0, 1.0, 1.0),
        agg_dist_pers=20, agg_intrp_order=1, agg_distance_kernel="linear",
        shpnt_jitter="uniform", wcoord_query=0,
        vscale=(2, 2, 1), kernel_size=(3, 3, 3), query_size=(3, 3, 3),
        SR=40, K=8, P=20, z_depth_dim=400, max_o=1000000,
        radius_limit_scale=0.0, depth_limit_scale=0.0,
        random_sample_size=48, bg_color="black", maximum_step=0,
        # pre-KNN shading-row compaction (round 4): the exact frustum KNN
        # runs on the budget rows only; render_image's overflow ladder
        # retries dense chunks uncompacted
        SR_budget=-1,
    )
    return base.replace(**overrides) if overrides else base


PRESETS = {
    "nerf_synth": nerf_synth_preset,
    "nerf_synth_colmap": nerf_synth_colmap_preset,
    "scannet": scannet_preset,
    "tt": tt_preset,
    "dtu_ft": dtu_ft_preset,
    "dtu_gen": lambda scan="": dtu_gen_preset(),
    "dtu_inf": dtu_inf_preset,
}
