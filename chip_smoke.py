"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from pointnerf_tpu_torch/csrc and holds each
kernel against its plain PyTorch version at the shapes its path gives it
(K1, K3 and K4 at a serving group's, K2 and K5 at a train step's, K1 and
K2 also at distance mode 30's 4-wide distances, K3's select mode also at a
train batch's, K6 at its micro-benchmark's and at a train step's, K7 at
its micro-benchmark's).
Then it drives the port's main paths on the NeRF-Synthetic lego preset
(random weights from a seeded torch.Generator, bench.py's 100k-point
shell-and-blobs cloud), each in the default configuration (fused_shade=0:
K1, K2, K3, K6) and in the fused_shade configuration (fused_shade=1: K4,
K5, K3, K6):

- serving: one full 800x800 image through render_image, the chunk of it
  with the most hits re-rendered on the CPU with the plain versions; the
  fused_shade image is held against the default one;
- training: bench.py's 3,600-ray batch through create_train_state and
  train_step, one warm-up step and TRAIN_STEPS timed ones, then one
  compute_grads on the card against the CPU's plain versions; the
  fused_shade step-1 loss is held against the default one;

then the finetune driver, run/train_ft.main, at the lego preset's
widths on a 400x400 plate scene it writes in the NeRF-Synthetic layout
(FT_STEPS steps with a prune, a probe-and-grow and a final checkpoint;
the test PSNR must pass FT_PSNR and the PSNR before training), then main
again, which must resume and stop at once, then run/render_vid.main on its
checkpoint (the NeRF-Synthetic render path's 20 frames and their GIF,
decoded back, each frame within the palette bound of its PNG); then the
aggregator's other shading envelopes on the same plate scene
(run/workload.envelope_options: distance mode 30 through K1 and K2 at a
4-wide distance, sh_intrp, gau_intrp, bfloat16 products, order 0 and
block2 through the composition; ENV_STEPS steps each, the loss must fall,
one chunk of a test view against the CPU, mode 30 also through test_ft
and one render_vid frame); then the MVS point init
(load_points 0, the lego preset's default) on an 800x800 plate scene:
gen_points_filter_embeddings over every view triplet of the 12 train views
(MVSNet depth over 128 planes, fusion, embeddings, the visual hull, the
voxel downsample), timed by phase, one triplet held against the CPU, and
train_ft.main from the MVS cloud for MVS_STEPS steps, whose test PSNR must
pass that of the initial cloud; then the feed-forward path on a 640x512
plate scene in the DTU layout (run/workload.make_dtu_scene): dtu_inf
inference through run/train.inference (MVSNet, the FPN points, the
32.8 M-voxel frustum grid once, the full image; K1 in order 1), timed by
phase, two chunks re-rendered on the CPU from the same points; and dtu_gen
training through run/train.gen_train_step (GEN_STEPS timed steps on one
item, the loss must fall; K1, K2, K3, K6), one step's gradients of the
aggregator, the FPN and the premlp against the CPU, a {steps}_gen.npz
written, read back and loaded by run/train.inference; then the DTU
per-scene finetune (dtu_ft_preset at 640x512, bgmodel plane, the plate's
white back plane patched into PLANE_PARAMS[0]): the MVS init and the
plane background's precompute, each timed, train_ft.main for DTU_FT_STEPS
steps (K1, K2, K3, K6) whose test PSNR must pass the initial cloud's, two
chunks of a held-out view rendered again on the CPU with their bg_ray
(within 1e-5), a planepoints run of DTU_FT_PP_STEPS steps that must add
the 8000 plane points, and one Rectified image written at 800x640 read
through the port's resampler, whose pixels must hash to Pillow's; then the
ScanNet per-scene finetune (scannet_preset at its widths, load_points 2):
the port's image I/O on a fixed 1296x968 frame and a 640x480 16-bit depth
map, whose JPEG bytes, decoded pixels, PNG round trip and nearest resizes
must hash to digests frozen from Pillow and cv2, the decode timed; a plate
scene in ScanNet's exported/ layout at the sensors' sizes
(run/workload.make_scannet_scene, 20 frames), its datasets and the depth
back-projection timed, train_ft.main for SCANNET_STEPS steps with a
probe (K1, K2, K3, K6) whose test PSNR on two views must pass the initial
cloud's, two chunks of a test view rendered again on the CPU (within
1e-5), and load_points 3 for SCANNET_LP3_STEPS steps on a 5-frame scene,
which must merge the mesh with the depth points in its empty voxels; then
the vox-grid querier (NN -1, trilinear) at lego widths on an 800x800
plate from a pickle of VOX_CLOUD_SIDE² surface samples (num_point,
point_noise, the lattice of construct_res and grid_res): the lattice,
its corner table and the share of shading samples with a full cell,
train_ft.main for VOX_STEPS steps with a prune (K1, K2, K3, K6), test_ft
on its checkpoint (K1, K3), two chunks against the CPU (within 1e-5);
the LLFF finetune (llff_ft, 1008x756, 20 views, a 100,489-point
fused.ply; LLFF_STEPS steps, two chunks against the CPU, render_vid over
LLFF_VID_FRAMES render poses); the legacy NeRF-Synthetic finetune
(nerf_synth_ft at 800x800, the MVS init over a pairs file's view groups,
pairs.th's test frames; NSFT_STEPS steps, two chunks against the CPU),
each phase's test PSNR before and after; the ProbNet init
(manual_depth_view -1) on an 800x800 plate, one depth view against the
CPU, the init timed by part, PN_STEPS finetune steps (K1, K2, K3, K6),
and ProbNet at dtu_gen's 640x512 (dtu_gen refuses it, as JAX fails
there; PNG_STEPS steps of ProbNet's own backward, one step's gradients
against the CPU); scene editing on the finetune phase's checkpoint (half
the cloud rotated and lifted, per-point Rw2c: K1 and K3, one chunk
against the CPU, test_ft reading the composite back) and the headless
viewer (PLY, turntable and growth frames splatted on the card, one
splat equal to the CPU's); and last
the evaluation phase at 1920x1080: a plate scene in the Tanks&Temples layout
(run/workload.make_tt_scene, 501,264 fused.ply points), train_ft.main with
tt_preset("Truck") for TT_STEPS steps and load_points 1 (K1, K2, K3, K6),
run/test_ft.main on its checkpoint with LPIPS alex and vgg from random
weights written for the run (K1, K3), a timed render of one test view,
one of its chunks rendered again on the CPU from the same checkpoint
(within 1e-5), and one 1920x1080 LPIPS distance on the card against the
CPU.

Before the checks it counts the HMMA instructions in the SASS of each
trunk kernel's library (K1, K2, K4, K5 run their products on the tensor
cores in a 3xTF32 split; a count of 0 fails) and the subroutine calls in
K3's (its indices are 32-bit; a call, such as 64-bit integer division,
fails), and turns TF32 off in cuBLAS and cuDNN, so the plain versions
stay full fp32. The trunk kernels' bound is their 3xTF32 tensor-core
products (`bound_ms`), with the fp32 SIMT bound beside it
(`bound_fp32_ms`).

To hold the script under 600 s with the ProbNet, editing and viewer
phases, the CPU re-renders of serving, dtu_inf, scannet and the T&T
test_ft take one chunk each (were two), the T&T plate holds one test view
(was two), and the earlier finetunes run fewer steps (PERF.md §4, "was").

Each path runs with the launch counts set to 0 just before it and read just
after; every kernel of the path's configuration must have launched in it,
and the other configuration's trunk kernels not at all. Any failed check
raises. The last line is a JSON object with the device; the line before it
is the card's name and power limit, and the line before that lists each
kernel's launches (summed over the paths; K7's from its micro-benchmark's
segmented pipeline), error, times, bound and library call. K1, K2, K4 and
K5 (milliseconds a call) are timed over eager loops; K3, K6 and K7, their
plain versions and library calls (tens of microseconds) from CUDA graphs
of captured calls (`graph_time`), each line naming its method beside the
eager, host-paced time. Needs a CUDA device; without one it exits nonzero
and prints no result.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

H = W = 800            # NeRF-Synthetic test views
FOCAL = 1111.1111      # 0.5 * 800 / tan(0.5 * camera_angle_x), angle 0.6911
RADIUS = 4.0           # camera distance of the NeRF-Synthetic test poses
GROUP = 8              # chunks per stacked serving group
K1_TOL = dict(rtol=1e-4, atol=1e-4)   # fp32, other summation order over
                                       # four <=284-term layers
CPU_TOL = dict(rtol=1e-4, atol=1e-4)  # card vs CPU: summation order differs
K2_ROW_TOL = K1_TOL                   # K2's per-row cotangents: as K1
KINK = 1e-5                           # rows with a LeakyReLU input this near
                                      # 0 get neighbor weight 0 in the K2
                                      # check: the two summation orders may
                                      # take different slopes there
K2_SUM_REL = 1e-4                     # K2's weight gradients sum ~1e5 rows in
                                      # another order: max error over the
                                      # gradient's largest entry
TRAIN_STEPS = 20                      # timed train steps after one warm-up
LOSS_RTOL = 1e-4                      # card vs CPU loss items
GRAD_REL = 1e-3                       # card vs CPU gradients, ||diff|| /
                                      # ||cpu|| per tensor: summation order
                                      # differs, and a row whose LeakyReLU
                                      # input lies within rounding of 0 may
                                      # take the other slope on the card
SHADE_IMAGE_TOL = 1e-4                # fused_shade=1 image vs the default
                                      # one: the same math, other order
STEP1_RTOL = 1e-5                     # fused_shade=1 step-1 loss vs default
SHADE_GRADS = ("demb", "dxyz", "dxyzp", "dcolor", "ddir", "dconf")
SCATTER_REL = 1e-4                    # K6 vs plain, per entry, of the sum
                                      # of |updates| reaching it: duplicate
                                      # indices sum in another order
SCATTER_SCRIPT = dict(S=384000, cap=102400, C=42, dup=6.0)  # scatter_pallas
OCC_U = 96                            # occ_micro3's distinct-row budget
FT_WH = 400                           # finetune views (plate scene)
FT_STEPS = 200                        # finetune steps
FT_PRUNE = 100                        # the one prune
FT_PROBE = 150                        # the one probe-and-grow (every
                                      # FT_PROBE steps)
FT_PSNR = 16.0                        # final test PSNR bar (dB)
PHASES = ("train_s", "prune_s", "grow_s", "test_s", "save_s")
FT_PROB_THRESH = -0.7                 # probe opacity gate off, as the ficus
                                      # preset sets it: after 800 steps at
                                      # the preset's lr no sample reaches
                                      # lego's 0.7 (no candidates at all)
MVS_WH = 800                          # MVS init views: lego's own size
                                      # (MVSNet's U-Net needs multiples of
                                      # 32; 400 is not one)
MVS_NEAR_FAR = (2.5, 3.5)             # the plate scene's own depth range
                                      # (camera radius 3): random weights
                                      # regress depths near the middle of
                                      # the range, and lego's [2, 6] puts
                                      # them a unit behind the plate, where
                                      # the visual hull removes them
MVS_CONF_THRESH = 0.0                 # random weights never reach lego's 0.8
MVS_STEPS = 50                        # finetune steps from the MVS cloud
MVS_TEST_VIEWS = 1                    # test views of the MVS plate scene
MVS_MIN_POINTS = 2000                 # the init must leave a few thousand
MVS_TOL = dict(rtol=1e-4, atol=1e-4)  # one triplet, card vs CPU
MVS_INDEX_TIE = 1e-4                  # conf jumps where the regressed depth
                                      # index crosses an integer
MVS_ONE_SIDE = 1e-3                   # share of rows kept on one device only
MVS_VIS_TIES = 1e-2                   # share of rows whose visibility in a
                                      # view differs (in-bounds and z-buffer
                                      # cells at pixel edges, by rounding)
DTU_WH = (640, 512)                   # the dtu presets' img_wh (MVSNet's
                                      # Rectified DTU images)
DTU_VIEWS = 6                         # plate views of the DTU scene (each
                                      # with the 5 others as sources)
DTU_CONF_THRESH = 0.0                 # random weights never reach the
                                      # presets' 0.8 (the MVS phase's cut)
DTU_GEO_CNSST = 0                     # dtu_gen's fusion: random MVSNet
                                      # depths of views 0, 1, 2 never agree
                                      # in 2 views (the preset's 2 kept 33
                                      # of 12,288 rows in a 64x64 rehearsal)
DTU_RANGES = (-0.6, -0.6, -0.25, 0.6, 0.6, 0.25)  # dtu_gen's world grid
                                      # over the plate's bounds, as
                                      # tests/test_generalizable.py sets
                                      # them: the preset's ±100 gives a
                                      # 50,005³-voxel grid
GEN_STEPS = 10                        # timed dtu_gen steps after a warm-up
GEN_CPU_RAYS = 784                    # rays of the card-vs-CPU gradient
                                      # check of a dtu_gen step (28²)
ALPHA_SHIFT = 5.0                     # alpha-head bias added for that
                                      # check: the random head's sigma
                                      # (softplus(raw - 1) ≈ 0.3) leaves the
                                      # plate's samples tiny opacities x,
                                      # where fp32's 1 - exp(-x) keeps
                                      # about eps/x of its value on either
                                      # device (without the shift the
                                      # color-branch gradients failed the
                                      # GRAD_REL bar with the query and the
                                      # outputs equal)
VIDEO_FRAMES = 20                     # the NeRF-Synthetic render path
TT_WH = (1920, 1080)                  # tt_preset's img_wh (the T&T PNGs)
TT_VIEWS = (6, 1)                     # train / test views of the T&T scene
                                      # (was 6 / 2)
TT_TEST_NUM = 1                       # of them rendered by the finetune's
                                      # final test and by test_ft (was 2)
TT_SIDE = 708                         # fused.ply: a 708² grid, 501,264
                                      # points (T&T clouds hold 0.5-1.6 M;
                                      # Truck's max_o is 1.6 M)
TT_HALF = 0.19                        # plate half-width: inside Truck's
                                      # ranges (y from -0.598 to 0.203)
TT_RADIUS = 0.6                       # camera distance: the plate spans
                                      # about 1,200 of 1,920 columns
TT_STEPS = 30                         # finetune steps: one checkpoint
TT_CPU_TOL = dict(rtol=1e-5, atol=1e-5)  # test_ft chunks, card vs CPU
LPIPS_RTOL = 1e-4                     # one LPIPS distance, card vs CPU
LPIPS_REPS = 5                        # timed LPIPS calls a net
DTU_FT_STEPS = 100                    # dtu_ft finetune steps (plane bg)
DTU_FT_TEST_STEP = 3                  # test_num_step: views 0 and 3 of the
                                      # 6 held out (the preset's 10 holds
                                      # out one of real DTU's 49)
DTU_FT_PP_STEPS = 20                  # the planepoints run's steps
DTU_FT_PLANE = ((0.0, 0.0, -0.2), (0.0, 0.0, -1.0), (1.0, 1.0, 1.0))
                                      # the plate scene's white back plane
                                      # under the plate, patched into
                                      # PLANE_PARAMS[0] as
                                      # tests/test_dtu_ft.py patches it
RESIZE_WH = (800, 640)                # a Rectified image written at this
                                      # size and read at DTU_WH
RESIZE_IN_SHA = ("32215462a0a9e2381689d838516d9004"
                 "ca5cf8709c168ea2fe7167ea071d4afc")
RESIZE_OUT_SHA = ("d6205e32ba872d26ddac141b18b49a92"
                  "ea4afbdee0db8cca29f05c485b4ed5ab")
                                      # sha256 of view 0's 800x640 pixels
                                      # and of Pillow 12.1.0's BILINEAR
                                      # resize of them to 640x512, taken
                                      # on a CPU machine with Pillow
SCANNET_SCAN = "scene0241_01"         # scannet_preset's default scene
SCANNET_COLOR_WH = (1296, 968)        # ScanNet's colour sensor
SCANNET_DEPTH_WH = (640, 480)         # and its depth sensor
SCANNET_FRAMES = 20                   # 4 train / 16 test (NSVF step-5 rule)
SCANNET_HALF = 2.0                    # plate half-width: a 4 x 4 m floor
SCANNET_RADIUS = 2.0                  # cameras 2.06 m from the origin, at
                                      # 29 deg: plate depths 1-4 m
SCANNET_SIDE = 200                    # pcd.ply: a 200² grid over the plate
SCANNET_HOLE = (0.6, -0.4, 0.5)       # less a disk the sensor depth fills
SCANNET_STEPS = 50                    # of the preset's 200,000
SCANNET_PROBE = 40                    # prob_freq: one probe-and-grow
SCANNET_TEST_VIEWS = 2                # test renders (test_num)
SCANNET_LP3_STEPS = 10                # the load_points 3 run's steps, on
SCANNET_LP3_FRAMES = 5                # a scene of its own: 1 train / 4
                                      # test frames (the driver's final
                                      # test renders every test frame)
SCANNET_MIN_POINTS = 100_000          # the sensor-depth cloud's floor
SCANNET_DECODES = 3                   # timed decodes of the codec frame
SCANNET_FRAME_SHA = ("5bb5f61db36690475e803fc1e6f85d10"
                     "1bb9c26b10bc12fbd605f1ca725da078")
SCANNET_JPEG_SHA = ("daee2699d575c8b1b58725335a50af1d"
                    "ef1a6e5fc61ad2cb336ef5256db47285")
SCANNET_DECODE_SHA = ("2cce91ef4e8bb987dc1509bcb17e70b4"
                      "0573a531d7d660f0a4f8746f3ef0fdb4")
SCANNET_DEPTH_SHA = ("7ce68e5ed6d733177e547d6448c658d0"
                     "79830f286ae14981005a7b893ba6080d")
SCANNET_UP_SHA = ("2c5fa83167f6a5fe9b5512b69e057982"
                  "1d37ef5a30fb79b4dbc86f1ff6426bbf")
SCANNET_DOWN_SHA = ("f56e12a84dd7792206161c58e9b6ce14"
                    "d59622731afe099b569ac6b9777abf5d")
                                      # sha256 of codec_frame's pixels, of
                                      # write_jpeg's bytes for it, of
                                      # Pillow 12.1.0's decode of those
                                      # bytes; of depth_frame read back by
                                      # cv2.imread(-1) from write_png's
                                      # file, and of cv2 5.0.0's
                                      # INTER_NEAREST resize of it in
                                      # metres to 1296x968 and 333x211;
                                      # taken on a CPU machine with Pillow
                                      # and cv2
VOX_WH = 800                          # the vox-grid phase's plate views
VOX_CLOUD_SIDE = 633                  # the pickled surface cloud: a 633²
                                      # grid over the plate, 400,689 samples
VOX_NUM_POINT = 100_000               # num_point: drawn from the pickle
VOX_NOISE = "pointuniform_0.002"      # point_noise
VOX_RES = (64, 256)                   # construct_res, grid_res: a lattice
                                      # of 299,441 points at pitch 3.6 mm
VOX_STEPS = 50                        # finetune steps
VOX_PRUNE = 25                        # the one prune
VOX_TEST_VIEWS = 1                    # test renders (test_num)
LLFF_WH = (1008, 756)                 # fern's images_4 size
LLFF_VIEWS = 20                       # forward-facing views
LLFF_TESTSKIP = 8                     # LLFF's hold-out of every 8th view:
                                      # 3 test, 17 train
LLFF_SIDE = 317                       # fused.ply: a 317² grid, 100,489
                                      # points
LLFF_STEPS = 50                       # finetune steps
LLFF_TEST_VIEWS = 2                   # test renders (test_num)
LLFF_VID_FRAMES = 3                   # poses of the render split rendered
NSFT_WH = 800                         # the legacy NeRF-Synthetic views
NSFT_PAIRS = dict(n_ref=3, n_extra=2, n_test=1)
                                      # pairs txt: 3 ref views, 2 more view
                                      # groups; pairs.th: 1 test frame
NSFT_STEPS = 50                       # finetune steps from the MVS cloud
NSFT_MIN_POINTS = 2000                # the init must leave a few thousand
ENV_TEST_VIEWS = 1                    # envelopes: test views rendered
                                      # before and after (was 4)
ENV_STEPS = dict(pers30=30, sh_intrp=30, gau_intrp=30, bf16=30, order0=20,
                 block2=20)           # envelopes phase: steps per run
ENV_BF16_TOL = dict(rtol=0.0, atol=2e-4)  # bf16 chunk, card vs CPU: the
                                      # envelope tests' BF16_REL (2e-4) of
                                      # the largest colour (1); the float32
                                      # sums differ in order, and an ulp can
                                      # flip a bf16 rounding
PEAK_FP32 = 67e12                     # H100 SXM fp32 FLOP/s outside the
                                      # tensor cores, at 700 W (data sheet)
PEAK_TF32 = 495e12                    # H100 SXM dense TF32 tensor-core
                                      # FLOP/s, at 700 W (data sheet)
TF32_PASSES = 3                       # the trunk kernels' 3xTF32 split: 3
                                      # TF32 products per fp32 multiply-add
PN_WH = 800                           # the ProbNet phase: lego's views
PN_TRAIN = 5                          # train views of its plate: a few
                                      # triplets (full_comb, hull)
PN_STEPS = 50                         # finetune steps from the ProbNet cloud
PN_DPROB_THRESH = 0.0                 # random weights: a near-uniform prob
                                      # volume, mass ~ num_neighbor / D, so
                                      # lego's 0.8 keeps nothing (logged)
PN_TOL = dict(rtol=1e-4, atol=1e-4)   # one depth view, card vs CPU
PN_MASS_TIE = 1e-4                    # keep masks compared away from this
                                      # distance to the threshold
PN_MIN_POINTS = 1000                  # the init must leave a thousand
PNG_STEPS = 5                         # ProbNet steps at dtu_gen's size
PNG_CPU_D = 32                        # depth planes of its card-vs-CPU
                                      # gradient (the CPU's float64 backward
                                      # grows with D)
PNG_F32_SPREAD = 2.0                  # the card's float32 gradient no
                                      # further off float64 than this times
                                      # the CPU's float32 (readings: 0.96 at
                                      # D 16, 1.13 at D 8, 0.68 at D 32;
                                      # PERF.md)
EDIT_LIFT = 0.15                      # the edited half: rotated 90° about z
                                      # and lifted this far
VIS_FRAMES = 8                        # turntable frames
VIS_SIZE = 512                        # turntable and growth frames' side
PEAK_BYTES = 3.35e12                  # H100 SXM HBM3 bytes/s (data sheet)
GRAPH_REPS = 100                      # calls captured in one CUDA graph
GRAPH_REPLAYS = 5                     # timed replays of it
EAGER_REPS = 200                      # eager calls of a function that cannot
                                      # be captured


def log(*a):
    print(*a, flush=True)


def cuda_time(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls, timed with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_pair(kernel_fn, plain_fn, reps: int = 3):
    """Warm both, then time plain, kernel, kernel, plain in turns."""
    kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    p1 = cuda_time(plain_fn, reps)
    k1 = cuda_time(kernel_fn, reps)
    k2 = cuda_time(kernel_fn, reps)
    p2 = cuda_time(plain_fn, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def graph_time(fn, eager_why: str = ""):
    """(ms per call, method) of a call under about 1 ms, timed on the card:
    GRAPH_REPS calls captured in one torch.cuda.CUDAGraph, one warm-up
    replay, then GRAPH_REPLAYS replays between two CUDA events (an eager
    loop of such calls measures how fast the host enqueues them). A
    function that cannot be captured (it syncs, or stages host data through
    pinned memory) is named so by `eager_why` and timed eagerly over
    EAGER_REPS calls. The launch counts are restored afterwards: no warm-up,
    capture or timed call counts."""
    from pointnerf_tpu_torch.ops import kernels
    counts = [k.launches for k in kernels.KERNELS]
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        if eager_why:
            return (cuda_time(fn, EAGER_REPS),
                    f"eager, {EAGER_REPS} calls ({eager_why})")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(GRAPH_REPS):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        return (cuda_time(graph.replay, GRAPH_REPLAYS) / GRAPH_REPS,
                f"graph of {GRAPH_REPS} calls x {GRAPH_REPLAYS} replays")
    finally:
        for k, c in zip(kernels.KERNELS, counts):
            k.launches = c


def graph_pair(kernel_fn, plain_fn, plain_eager_why: str = ""):
    """graph_time of plain, kernel, kernel, plain in turns: (kernel ms,
    plain ms, "kernel (method) plain (method)" for the printed line)."""
    p1, plain_how = graph_time(plain_fn, plain_eager_why)
    k1, how = graph_time(kernel_fn)
    k2, _ = graph_time(kernel_fn)
    p2, _ = graph_time(plain_fn, plain_eager_why)
    k, p = (k1 + k2) / 2, (p1 + p2) / 2
    return k, p, f"kernel={k:.4f} ms ({how}) plain={p:.4f} ms ({plain_how})"


def bound(flops: float, nbytes: float):
    """(least ms the card could take, what bounds it): the larger of the
    operations over the fp32 peak and the bytes over the memory rate."""
    ops_ms, bytes_ms = 1e3 * flops / PEAK_FP32, 1e3 * nbytes / PEAK_BYTES
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def trunk_bound(flops: float, nbytes_: float):
    """(least ms, what bounds it, least ms in fp32) of a trunk kernel
    (K1, K2, K4, K5): they issue each fp32 multiply-add as TF32_PASSES TF32
    tensor-core products, so their operations bound is those products at
    PEAK_TF32; the fp32 SIMT bound (`bound`) is kept beside it."""
    tc_ms, bytes_ms = (1e3 * TF32_PASSES * flops / PEAK_TF32,
                       1e3 * nbytes_ / PEAK_BYTES)
    ms, by = (tc_ms, "operations") if tc_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")
    return ms, by, bound(flops, nbytes_)[0]


def bound_text(flops: float, ms: float, b_ms: float, b_by: str,
               b32_ms: float) -> str:
    """A trunk kernel's rate and both its bounds, with the share of each."""
    return (f"({flops / ms / 1e9:.2f} TFLOP/s kernel) bound={b_ms:.3f} ms "
            f"({b_by}, 3xTF32 at {PEAK_TF32 / 1e12:.0f} TFLOP/s; "
            f"{100 * b_ms / ms:.0f}% of the kernel's time) "
            f"bound_fp32={b32_ms:.3f} ms ({100 * b32_ms / ms:.0f}%)")


def scratch_text(L1: int, L3: int, ops, S: int) -> str:
    """The bytes K2's and K5's phase 1 writes to its scratch (each layer's
    input and gated cotangent, csrc/trunk_bwd.cuh::plan) and phase 2 reads
    back, counted once each, and their time at the memory rate."""
    r4 = lambda n: -(-n // 4) * 4
    C1, H1 = sum(int(o.shape[0]) for o in ops[:3]), int(ops[3].shape[1])
    i = 4 + 2 * (L1 - 1)
    X3 = int(ops[i].shape[0] + ops[i + 1].shape[0])
    H3 = int(ops[i + 2].shape[1])
    cols = (r4(C1) + H1 + (2 * H1 if L1 == 2 else 0) + r4(X3) + H3
            + (2 * H3 if L3 == 2 else 0))
    moved = 2 * 4 * S * cols
    return (f"phase-1 scratch {cols} floats a row, {moved / 1e9:.3f} GB "
            f"written and read once ({1e3 * moved / PEAK_BYTES:.3f} ms at "
            f"{PEAK_BYTES / 1e12:.2f} TB/s)")


def sass(kernel) -> str:
    """The SASS of `kernel`'s built library (cuobjdump -sass)."""
    import shutil
    from pointnerf_tpu_torch.ops import kernels
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", str(kernels.library_path(kernel))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout


def tensor_core_products():
    """HMMA instructions in the SASS of each trunk kernel's library
    (cuobjdump -sass): K1, K2, K4 and K5 must issue their products on the
    tensor cores. Returns {kernel name: count}."""
    from pointnerf_tpu_torch.ops import kernels
    counts = {}
    for k in (kernels.TRUNK_FWD, kernels.TRUNK_BWD, kernels.SHADE_FWD,
              kernels.SHADE_BWD):
        counts[k.name] = sum("HMMA" in line
                             for line in sass(k).splitlines())
        if not counts[k.name]:
            raise AssertionError(f"{k.name} issues no HMMA instruction")
    return counts


def nbytes(*tensors) -> int:
    """Bytes of the tensors (each read or written once; None counts 0)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def trunk_macs(ops) -> int:
    """Multiply-adds per row of the trunk's products (every weight matrix
    of the packed operands, the alpha head's included; the biases, the PE
    sines and the shade kernels' front half, under 1%, are not counted)."""
    return sum(t.numel() for t in ops if t.shape[0] > 1)


def tier_sums(rows, mode: int = 20):
    """(ms, plain_ms, bound_ms, bound_fp32_ms) of the order-2 checks at the
    narrow and the wide tier summed, at distance mode `mode`: one group's or
    one step's work of the kernel."""
    picked = [r for r in rows
              if r["order"] == 2 and r.get("mode", 20) == mode]
    assert {r["tier"] for r in picked} == {"narrow", "wide"}
    return tuple(sum(r[k] for r in picked)
                 for k in ("ms", "plain_ms", "bound_ms", "bound_fp32_ms"))


def tier_shapes(opt, rows: int):
    """(narrow, wide) shading points of the K-tier split of `rows` samples
    (one serving group's or one train step's): the narrow tier holds the
    whole SR budget at K = k_tier, the wide one its k_tier_wide_frac share
    at full K."""
    from pointnerf_tpu_torch.models.renderer import effective_sr_budget
    budget = effective_sr_budget(opt, rows)
    return budget, min(budget, max(128, int(round(budget
                                                  * opt.k_tier_wide_frac))))


def make_item(opt, azimuth=0.7, elevation=0.5):
    """One full-image camera on the NeRF-Synthetic test sphere, looking at
    the origin (Blender convention: camera -z forward, +z up)."""
    from pointnerf_tpu_torch.ops.camera import get_blender_raydir
    campos = RADIUS * np.array([np.cos(elevation) * np.cos(azimuth),
                                np.cos(elevation) * np.sin(azimuth),
                                np.sin(elevation)])
    z = campos / np.linalg.norm(campos)            # camera looks along -z
    x = np.cross([0.0, 0.0, 1.0], z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    rot = np.stack([x, y, z], axis=1).astype(np.float32)
    px, py = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    pix = np.stack([px, py], -1).reshape(-1, 2)
    raydir = get_blender_raydir(pix, H, W, FOCAL, rot, dir_norm=False)
    return {"h": H, "w": W, "pixel_idx": pix[None],
            "raydir": raydir.reshape(1, -1, 3),
            "campos": campos.astype(np.float32)[None],
            "camrotc2w": rot[None],
            "near": np.float32(opt.near_plane), "far": np.float32(opt.far_plane),
            "bg_color": np.ones((1, 3), np.float32)}


def build_workload(dev):
    """The main path's inputs on `dev`: the lego preset, bench.py's cloud,
    its grid (built there), seeded aggregator weights and one camera.
    Returns (opt, state, spec, grid, agg, serve_state, item, grid_ms)."""
    from pointnerf_tpu_torch.models import neural_points as npc
    from pointnerf_tpu_torch.models.aggregator import init_aggregator_params
    from pointnerf_tpu_torch.run import common
    from pointnerf_tpu_torch.run.workload import lego_options, make_cloud
    from pointnerf_tpu_torch.train.trainer import ServeState
    opt = lego_options()
    xyz, emb, color, dirs, conf = make_cloud(opt)
    state = npc.create_point_cloud(xyz, emb, color, dirs, conf, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spec, grid = common.make_spec_and_grid(opt, state)
    torch.cuda.synchronize()
    grid_ms = 1e3 * (time.perf_counter() - t0)
    gen = torch.Generator(device="cpu").manual_seed(0)
    agg = init_aggregator_params(opt, generator=gen, device=dev)
    return (opt, state, spec, grid, agg, ServeState(agg, state),
            make_item(opt), grid_ms)


def trunk_cases(agg, agg30):
    """(dist mode, aggregator, distance width dd, order-1 flag) of the
    trunk checks: dd 6 (mode 20, lego's) at orders 2 and 1, and dd 4
    (mode 30, C1 264 at lego widths) at order 2."""
    return ((20, agg, 6, False), (20, agg, 6, True), (30, agg30, 4, False))


def check_trunk(agg, agg30, opt, Ncb: int, NtB: int):
    """K1 against fused_trunk_reference at one serving group's tier
    shapes, at the distance widths of modes 20 and 30."""
    from pointnerf_tpu_torch.ops import trunk as tt
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(1)
    L1, L3 = opt.shading_feature_mlp_layer1, opt.shading_feature_mlp_layer3
    nf, nd = opt.num_feat_freqs, abs(opt.dist_xyz_freq)
    Fe = opt.point_features_dim
    rows = []
    for tier, K, n_pts in (("narrow", opt.k_tier if opt.k_tier > 0 else 1, Ncb),
                           ("wide", opt.K, NtB)):
        S = n_pts * K
        emb = (torch.rand(S, Fe, generator=g) - 0.5).to(dev)
        d6 = (0.02 * torch.randn(S, 6, generator=g)).to(dev)
        ex3 = (2 * torch.rand(S, 7, generator=g) - 1).to(dev)
        w = (torch.rand(S, 1, generator=g)
             * (torch.rand(S, 1, generator=g) < 0.3)).to(dev)
        for mode, a, dd, order1 in trunk_cases(agg, agg30):
            d = d6 if dd == 6 else d6[:, :dd].contiguous()
            ops = tt.pack_trunk_params(a, Fe, dd, nf, nd,
                                       with_alpha=not order1)
            args = (L1, L3, nf, nd, K, opt.act_super > 0, order1, emb, d, ex3,
                    w, ops)
            got = tt.fused_trunk(*args)
            want = tt.fused_trunk_reference(*args)
            torch.cuda.synchronize()
            if (got[1] is None) != (want[1] is None):
                raise AssertionError("K1 alpha output presence differs")
            err = rel = 0.0
            for a, b in zip(got, want):
                if b is None:
                    continue
                torch.testing.assert_close(a, b, **K1_TOL)
                diff = (a - b).abs()
                err = max(err, float(diff.max()))
                rel = max(rel, float(diff.max() / b.abs().max()))
            ms, plain_ms = timed_pair(lambda: tt.fused_trunk(*args),
                                      lambda: tt.fused_trunk_reference(*args))
            mac = S * trunk_macs(ops)
            b_ms, b_by, b32_ms = trunk_bound(
                2 * mac, nbytes(emb, d, ex3, w, *ops, *got))
            log(f"K1 trunk_fwd {tier} K={K} order={1 if order1 else 2} "
                f"mode={mode} C1={sum(int(o.shape[0]) for o in ops[:3])} "
                f"rows={S}: max_abs_err={err:.3e} "
                f"max_abs_err/max|plain|={rel:.3e} "
                f"kernel={ms:.3f} ms plain={plain_ms:.3f} ms "
                + bound_text(2 * mac, ms, b_ms, b_by, b32_ms))
            rows.append(dict(tier=tier, order=1 if order1 else 2,
                             mode=mode, err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_fp32_ms=b32_ms))
        del emb, d, d6, ex3, w
    return rows


def trunk_bwd_inputs(opt, S: int, K: int, gen: torch.Generator, dev):
    """Seeded per-neighbor rows and per-point cotangents at the trunk's
    widths: (emb, d, ex3, w, dfeat, dalpha) on `dev`."""
    Fe, H = opt.point_features_dim, opt.shading_feature_num
    rnd = lambda *shape: torch.rand(*shape, generator=gen)
    emb = rnd(S, Fe) - 0.5
    d = 0.02 * torch.randn(S, 6, generator=gen)
    ex3 = 2 * rnd(S, 7) - 1
    w = rnd(S, 1) * (rnd(S, 1) < 0.3)
    dfeat = torch.randn(S // K, H, generator=gen)
    dalpha = torch.randn(S // K, 1, generator=gen)
    return [t.to(dev) for t in (emb, d, ex3, w, dfeat, dalpha)]


def check_trunk_bwd(agg, agg30, opt, Ncb: int, NtB: int):
    """K2 against fused_trunk_bwd_reference at one train step's tier
    shapes (narrow: Ncb rows at K=k_tier, wide: NtB shading points x K),
    orders 1 and 2 at mode 20's distance width and order 2 at mode 30's. The derivative of LeakyReLU jumps at 0, so rows with a
    pre-activation within KINK of 0 get neighbor weight 0 (no cotangent
    reaches their layers; their count is printed). Per-row cotangents are
    then held at K2_ROW_TOL; each weight gradient sums every row, so it is
    held relative to its largest entry (K2_SUM_REL). Two launches on the
    same inputs must give bit-equal weight gradients."""
    from pointnerf_tpu_torch.ops import trunk as tt
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(2)
    L1, L3 = opt.shading_feature_mlp_layer1, opt.shading_feature_mlp_layer3
    nf, nd = opt.num_feat_freqs, abs(opt.dist_xyz_freq)
    Fe = opt.point_features_dim
    rows = []
    for tier, K, n_pts in (("narrow", opt.k_tier if opt.k_tier > 0 else 1,
                            Ncb), ("wide", opt.K, NtB)):
        S = n_pts * K
        emb, d6, ex3, w, dfeat, dalpha = trunk_bwd_inputs(opt, S, K, g, dev)
        for mode, a, dd, order1 in trunk_cases(agg, agg30):
            d = d6 if dd == 6 else d6[:, :dd].contiguous()
            ops = tt.pack_trunk_params(a, Fe, dd, nf, nd,
                                       with_alpha=not order1)
            ops = [o.detach() for o in ops]
            zs = tt.trunk_activations(L1, L3, nf, nd, emb, d, ex3, ops,
                                      not order1)
            smooth = torch.ones(S, dtype=torch.bool, device=dev)
            for z in zs[2] + zs[4]:
                smooth &= (z.abs() >= KINK).all(dim=1)
            w_s = w * smooth[:, None]
            args = (L1, L3, nf, nd, K, opt.act_super > 0, order1, emb, d, ex3,
                    w_s, ops, dfeat, None if order1 else dalpha)
            got = tt.trunk_bwd(*args)
            again = tt.trunk_bwd(*args)
            want = tt.fused_trunk_bwd_reference(*args)
            torch.cuda.synchronize()
            row_err = row_rel = sum_rel = 0.0
            for a, b in zip(got[:4], want[:4]):
                torch.testing.assert_close(a, b, **K2_ROW_TOL)
                diff = float((a - b).abs().max())
                row_err = max(row_err, diff)
                row_rel = max(row_rel, diff / float(b.abs().max()))
            for a, b, c in zip(got[4], want[4], again[4]):
                if not torch.equal(a, c):
                    raise AssertionError("K2 weight gradients differ between "
                                         "two launches on the same inputs")
                rel = float((a - b).abs().max() / b.abs().max())
                if not rel <= K2_SUM_REL:
                    raise AssertionError(f"K2 weight gradient off by {rel:.3e}"
                                         f" of its largest entry")
                sum_rel = max(sum_rel, rel)
            ms, plain_ms = timed_pair(
                lambda: tt.trunk_bwd(*args),
                lambda: tt.fused_trunk_bwd_reference(*args))
            flops = 3 * 2 * S * trunk_macs(ops)
            b_ms, b_by, b32_ms = trunk_bound(
                flops,
                nbytes(*args[7:11], *ops, *args[12:], *got[:4], *got[4]))
            log(f"K2 trunk_bwd {tier} K={K} order={1 if order1 else 2} "
                f"mode={mode} C1={sum(int(o.shape[0]) for o in ops[:3])} "
                f"rows={S}: per-row max_abs_err={row_err:.3e} "
                f"({S - int(smooth.sum())} rows within {KINK:g} of a "
                f"LeakyReLU kink weighted 0) "
                f"max_abs_err/max|plain|={row_rel:.3e}, weight grads "
                f"max_abs_err/max|plain|={sum_rel:.3e}, dW bit-equal over two "
                f"launches; kernel={ms:.3f} ms plain={plain_ms:.3f} ms "
                + bound_text(flops, ms, b_ms, b_by, b32_ms) + "; "
                + scratch_text(L1, L3, ops, S))
            rows.append(dict(tier=tier, order=1 if order1 else 2,
                             mode=mode, err=row_err, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms,
                             bound_fp32_ms=b32_ms))
        del emb, d, d6, ex3, w, dfeat, dalpha
    return rows


def shade_inputs(opt, S: int, K: int, gen: torch.Generator, dev):
    """Seeded fused_shade row arguments shaped like the path's: neighbors
    within a few voxels of their sample, validity a prefix of each K-group
    (mostly short), confs across [0, 1.2] (past both clamp edges), unit
    point and view directions, a random rotation. Returns the 11 tensors
    emb, xyz, xyzp, color, pdir, conf, mask, sl, slw, ovd, RT on `dev`."""
    n = S // K
    rnd = lambda *shape: torch.rand(*shape, generator=gen)
    up = lambda x: x.repeat_interleave(K, dim=0)

    def unit(m):
        v = torch.randn(m, 3, generator=gen)
        return v / v.norm(dim=1, keepdim=True)

    mn = torch.tensor(opt.ranges[:3])
    mx = torch.tensor(opt.ranges[3:])
    slw = mn + (mx - mn) * rnd(n, 3)
    sl = torch.cat([0.6 * rnd(n, 2) - 0.3, 2.0 + 4.0 * rnd(n, 1)], dim=1)
    n_valid = torch.floor((K + 1) * rnd(n) ** 2)       # 0..K, mostly short
    mask = (torch.arange(S) % K < up(n_valid)).float()[:, None]
    vox = float(np.linalg.norm(opt.vsize))
    rt, _ = torch.linalg.qr(torch.randn(3, 3, generator=gen))
    rows = [rnd(S, opt.point_features_dim) - 0.5,
            up(slw) + 2 * vox * torch.randn(S, 3, generator=gen),
            up(sl) + 0.01 * torch.randn(S, 3, generator=gen), rnd(S, 3),
            unit(S), 1.2 * rnd(S, 1), mask, sl, slw, unit(n), rt]
    return [t.to(dev).contiguous() for t in rows]


def check_shade(aggs, opt, Ncb: int, NtB: int):
    """K4 against fused_shade_reference at one serving group's tier shapes
    (narrow: Ncb rows at K=k_tier, wide: NtB shading points x K), orders 1
    and 2 at dist mode 20 and dist mode 0 at the narrow shape (aggs: the
    aggregator of each mode). All four outputs are held at K1_TOL."""
    from pointnerf_tpu_torch.ops import trunk as tt
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(3)
    L1, L3 = opt.shading_feature_mlp_layer1, opt.shading_feature_mlp_layer3
    nf, nd = opt.num_feat_freqs, abs(opt.dist_xyz_freq)
    Fe = opt.point_features_dim
    rows = []
    for tier, K, n_pts, modes in (
            ("narrow", opt.k_tier if opt.k_tier > 0 else 1, Ncb, (20, 0)),
            ("wide", opt.K, NtB, (20,))):
        S = n_pts * K
        ins = shade_inputs(opt, S, K, g, dev)
        for mode in modes:
            for order1 in (False, True) if mode == 20 else (False,):
                ops = tt.pack_trunk_params(aggs[mode], Fe, tt.DIST_COLS[mode],
                                           nf, nd, with_alpha=not order1)
                args = (L1, L3, nf, nd, K, opt.act_super > 0, order1, mode,
                        *ins, ops)
                got = tt.fused_shade(*args)
                want = tt.fused_shade_reference(*args)
                torch.cuda.synchronize()
                if (got[1] is None) != (want[1] is None):
                    raise AssertionError("K4 alpha output presence differs")
                err = rel = 0.0
                for a, b in zip(got, want):
                    if b is None:
                        continue
                    torch.testing.assert_close(a, b, **K1_TOL)
                    diff = (a - b).abs()
                    err = max(err, float(diff.max()))
                    rel = max(rel, float(diff.max() / b.abs().max()))
                ms, plain_ms = timed_pair(
                    lambda: tt.fused_shade(*args),
                    lambda: tt.fused_shade_reference(*args))
                mac = S * trunk_macs(ops)
                b_ms, b_by, b32_ms = trunk_bound(2 * mac,
                                                 nbytes(*ins, *ops, *got))
                live = float(ins[6].mean())
                log(f"K4 shade_fwd {tier} K={K} order={1 if order1 else 2} "
                    f"dist_mode={mode} rows={S} (valid share {live:.3f}): "
                    f"max_abs_err={err:.3e} max_abs_err/max|plain|={rel:.3e} "
                    f"kernel={ms:.3f} ms plain={plain_ms:.3f} ms "
                    + bound_text(2 * mac, ms, b_ms, b_by, b32_ms))
                rows.append(dict(tier=tier, order=1 if order1 else 2,
                                 mode=mode, err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=b_ms, bound_fp32_ms=b32_ms))
        del ins
    return rows


def shade_bwd_scales(rows, K: int):
    """Per row, how much the front's backward scales an error of K2's
    per-row cotangents (dd_raw, dex3, dw_eff), each within K2_ROW_TOL:
    dxyzp = [ddp0·zp, ddp1·zp, ddp0·xp + ddp1·yp + ddp2], so up to
    1 + |xp| + |yp| + |zp|; dxyz = dd_raw[:3]·RTᵀ − (w_raw/nc)·dw_raw·d/nc
    with dw_raw = (dw_n − Σ_K dw_n·w_n)/S_w, so up to √3 + 2·w_n/nc (the
    weight of a near neighbor amplifies dw_eff's rounding). The other four
    outputs are not scaled."""
    from pointnerf_tpu_torch.ops import trunk as tt
    f = tt.shade_front(*rows[1:], 20, K)
    return {"dxyzp": 1.0 + rows[2].abs().sum(dim=1),
            "dxyz": 3 ** 0.5 + 2.0 * (f.w_n / f.nc)[:, 0]}


def assert_rows_close(what, a, b, scale=None):
    """|a − b| <= K2_ROW_TOL's atol (times `scale` [S] per row, if given)
    + its rtol·|b|, entry by entry."""
    atol = K2_ROW_TOL["atol"] * (1.0 if scale is None else scale[:, None])
    bad = (a - b).abs() > atol + K2_ROW_TOL["rtol"] * b.abs()
    if bool(bad.any()):
        i = int(bad.any(dim=1).nonzero()[0])
        raise AssertionError(f"{what}: {int(bad.sum())} entries past the "
                             f"tolerance, first in row {i}: "
                             f"{a[i].tolist()} vs {b[i].tolist()}")


def check_shade_bwd(agg, opt, Ncb: int, NtB: int):
    """K5 against fused_shade_bwd_reference at one train step's tier shapes,
    orders 1 and 2 at dist mode 20, with nonzero cotangents on all four
    outputs (dwout and dconfout exercise the weight and conf chains). Rows
    with a LeakyReLU input within KINK of 0 are masked out (no cotangent
    reaches their layers; see check_trunk_bwd). The six per-row cotangents
    are held at K2_ROW_TOL, with the atol of dxyz and dxyzp scaled per row
    as the front's backward scales K2's per-row errors (shade_bwd_scales),
    the weight gradients at K2_SUM_REL of their largest entry, and two
    launches must give bit-equal weight gradients."""
    from pointnerf_tpu_torch.ops import trunk as tt
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(4)
    L1, L3 = opt.shading_feature_mlp_layer1, opt.shading_feature_mlp_layer3
    nf, nd = opt.num_feat_freqs, abs(opt.dist_xyz_freq)
    Fe, H = opt.point_features_dim, opt.shading_feature_num
    rows = []
    for tier, K, n_pts in (("narrow", opt.k_tier if opt.k_tier > 0 else 1,
                            Ncb), ("wide", opt.K, NtB)):
        S = n_pts * K
        ins = shade_inputs(opt, S, K, g, dev)
        cts = [torch.randn(S // K, H, generator=g),
               torch.randn(S // K, 1, generator=g),
               torch.randn(S, 1, generator=g),
               torch.randn(S, 1, generator=g)]
        cts = [c.to(dev) for c in cts]
        for order1 in (False, True):
            ops = [o.detach() for o in tt.pack_trunk_params(
                agg, Fe, 6, nf, nd, with_alpha=not order1)]
            f = tt.shade_front(*ins[1:], 20, K)
            zs = tt.trunk_activations(L1, L3, nf, nd, ins[0], f.d_raw, f.ex3,
                                      ops, not order1)
            smooth = torch.ones(S, dtype=torch.bool, device=dev)
            for z in zs[2] + zs[4]:
                smooth &= (z.abs() >= KINK).all(dim=1)
            del f, zs
            rows_in = list(ins)
            rows_in[6] = ins[6] * smooth[:, None]
            args = (L1, L3, nf, nd, K, opt.act_super > 0, order1, 20,
                    *rows_in, ops, cts[0], None if order1 else cts[1],
                    cts[2], cts[3])
            got = tt.shade_bwd(*args)
            again = tt.shade_bwd(*args)
            want = tt.fused_shade_bwd_reference(*args)
            torch.cuda.synchronize()
            scales = shade_bwd_scales(rows_in, K)
            row_err = row_rel = sum_rel = 0.0
            errs = {}
            for name, a, b in zip(SHADE_GRADS, got[:6], want[:6]):
                assert_rows_close(f"K5 {name}", a, b, scales.get(name))
                diff = float((a - b).abs().max())
                errs[name] = f"{diff:.2e}"
                row_err = max(row_err, diff)
                row_rel = max(row_rel, diff / max(float(b.abs().max()),
                                                  1e-30))
            for a, b, c in zip(got[6], want[6], again[6]):
                if not torch.equal(a, c):
                    raise AssertionError("K5 weight gradients differ between "
                                         "two launches on the same inputs")
                rel = float((a - b).abs().max() / b.abs().max())
                if not rel <= K2_SUM_REL:
                    raise AssertionError(f"K5 weight gradient off by {rel:.3e}"
                                         f" of its largest entry")
                sum_rel = max(sum_rel, rel)
            ms, plain_ms = timed_pair(
                lambda: tt.shade_bwd(*args),
                lambda: tt.fused_shade_bwd_reference(*args))
            flops = 3 * 2 * S * trunk_macs(ops)
            b_ms, b_by, b32_ms = trunk_bound(
                flops, nbytes(*rows_in, *ops, *args[20:], *got[:6], *got[6]))
            log(f"K5 shade_bwd {tier} K={K} order={1 if order1 else 2} "
                f"dist_mode=20 rows={S}: per-row max_abs_err={row_err:.3e} "
                f"{errs} (atol scaled up to x{float(scales['dxyz'].max()):.0f}"
                f" for dxyz, x{float(scales['dxyzp'].max()):.2f} for dxyzp) "
                f"({S - int(smooth.sum())} rows within {KINK:g} of a "
                f"LeakyReLU kink masked) max_abs_err/max|plain|={row_rel:.3e},"
                f" weight grads max_abs_err/max|plain|={sum_rel:.3e}, dW "
                f"bit-equal over two launches; kernel={ms:.3f} ms "
                f"plain={plain_ms:.3f} ms "
                + bound_text(flops, ms, b_ms, b_by, b32_ms) + "; "
                + scratch_text(L1, L3, ops, S))
            rows.append(dict(tier=tier, order=1 if order1 else 2,
                             err=row_err, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_fp32_ms=b32_ms))
        del ins, cts
    return rows


def route_before(campos, raydir, t, grid, spec, SR: int):
    """The query's shading-point route before K3 selected them itself: K3
    in mask mode, select_shading_t, then campos + raydir·t of the picked
    depths in float64 (`ray_points`)."""
    from pointnerf_tpu_torch.ops import query as tq
    valid, _ = tq.mask_raypos_segmented(campos, raydir, t, grid, spec)
    t_sel, mask, counts = tq.select_shading_t(t, valid, SR)
    return torch.where(mask[..., None], tq.ray_points(campos, raydir, t_sel),
                       0.0), mask, counts


def occupancy_bound(t, valid, SR, campos, raydir):
    """(bound ms, by, samples the function must test) of K3 on these
    inputs. Bytes: the depths it needs (a broadcast axis read once; with
    SR, only each ray's depths up to its SR-th occupied one), the rays, and
    the outputs (SR None: the [B,R,D] mask; else positions, mask bits and
    counts). The table lookups (one byte of a 9 MB
    L2-resident table per in-range sample) are not counted. Operations: a
    dozen per tested sample."""
    B, R, D = t.shape
    if SR is None:
        tested = valid.numel()
    else:
        cum = torch.cumsum(valid.to(torch.int32), dim=-1, dtype=torch.int32)
        tested = int(((cum - valid.to(torch.int32)) < SR).sum())
    bcast = t.stride()[:2] == (0, 0)
    depths = D if bcast else tested
    out = valid.numel() if SR is None else B * R * (SR * 13 + 4)
    b_ms, b_by = bound(12 * tested, 4 * depths + nbytes(campos, raydir)
                       + out)
    return b_ms, b_by, tested


def serving_group(item, opt, rays: int):
    """(campos, raydir, tvals) of the serving group of `rays` rays that
    holds the image's center, on the card; tvals broadcast over the rays
    (strides 0, 0, 1), as the serving path builds them."""
    from pointnerf_tpu_torch.ops import raygen
    dev = torch.device("cuda")
    start = (H * W // 2) // rays * rays
    raydir = torch.as_tensor(item["raydir"][:, start:start + rays],
                             device=dev)
    campos = torch.as_tensor(item["campos"], device=dev)
    _, _, _, t = raygen.near_far_linear_ray_generation(
        campos, raydir, opt.z_depth_dim, near=float(item["near"]),
        far=float(item["far"]))
    return campos, raydir, t


def check_occupancy_mask(campos, raydir, t, grid, spec, SR: int):
    """K3 in mask mode (`mask_raypos_segmented`) against the dense plain
    mask, and the route the query ran before K3 selected (`route_before`),
    each timed. Returns [(shape, row)] for both."""
    from pointnerf_tpu_torch.ops import query as tq
    kern = lambda: tq.mask_raypos_segmented(campos, raydir, t, grid, spec)[0]
    plain = lambda: tq.mask_raypos(tq.ray_points(campos, raydir, t), grid,
                                   spec)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    n_diff = int((got != want).sum())
    if n_diff:
        raise AssertionError(f"K3 occupancy differs from the plain mask on "
                             f"{n_diff} samples")
    host_ms, host_plain_ms = timed_pair(kern, plain, reps=5)
    ms, plain_ms, timed = graph_pair(
        kern, plain, "host_const stages the grid's constants through pinned "
        "memory")
    b_ms, b_by, _ = occupancy_bound(t, want, None, campos, raydir)
    log(f"K3 occupancy mask mode rays={raydir.shape[1]} samples="
        f"{t.numel()}: equal (occupied share "
        f"{float(want.float().mean()):.4f}) {timed} bound={b_ms:.4f} ms "
        f"({b_by}); host-paced (5 eager calls, CUDA events): "
        f"kernel={host_ms:.4f} ms plain={host_plain_ms:.4f} ms")
    route_ms, route_how = graph_time(
        lambda: route_before(campos, raydir, t, grid, spec, SR))
    log(f"K3 route before (mask mode + select_shading_t + ray_points of the "
        f"picked depths), serving group SR={SR}: {route_ms:.4f} ms "
        f"({route_how})")
    return [("mask mode, serving group", dict(
        err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)),
        ("route before, serving group", dict(
            err=0.0, ms=route_ms, plain_ms=None, bound_ms=None,
            bound_by=None))]


def check_occupancy(item, grid, spec, opt, rays: int):
    """K3 on the rays x samples of the serving group that holds the image's
    center: mask mode and the route before (`check_occupancy_mask`), then
    select mode, `occupancy_select`, against its plain version bit for bit
    on that group (broadcast depths) and on bench.py's 3,600-ray train
    batch with jittered depths (draws from a seeded torch.Generator), with
    the route before's time beside it. Returns the kernels line's K3 row
    (select mode at the serving shape) with `rows`, one per mode and
    shape."""
    from pointnerf_tpu_torch.ops import query as tq
    from pointnerf_tpu_torch.ops import raygen
    from pointnerf_tpu_torch.models.renderer import TRAIN_JITTER
    from pointnerf_tpu_torch.run.workload import make_train_batch
    dev = torch.device("cuda")
    campos, raydir, t = serving_group(item, opt, rays)
    SR = opt.SR
    rows = check_occupancy_mask(campos, raydir, t, grid, spec, SR)
    route_ms = rows[1][1]["ms"]
    batch = make_train_batch(opt, dev)
    u = torch.rand((1, batch["raydir"].shape[1], opt.z_depth_dim),
                   generator=torch.Generator(device=dev).manual_seed(7),
                   device=dev)
    _, _, _, t_train = raygen.near_far_linear_ray_generation(
        batch["campos"], batch["raydir"], opt.z_depth_dim,
        near=float(batch["near"]), far=float(batch["far"]),
        jitter=TRAIN_JITTER, u=u)
    shapes = (("serving group", campos, raydir, t),
              ("train batch", batch["campos"], batch["raydir"], t_train))
    for shape, cp, rd, tt in shapes:
        fused = lambda: tq.occupancy_select(cp, rd, tt, grid, spec, SR)
        ref = lambda: tq.occupancy_select_reference(cp, rd, tt, grid, spec,
                                                    SR)
        got = fused()
        want = ref()
        valid = tq.mask_raypos(tq.ray_points(cp, rd, tt), grid, spec)
        torch.cuda.synchronize()
        for name, a, b in zip(("sample_loc_w", "sample_mask", "counts"),
                              got, want):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"K3 select mode, {shape}: {name} "
                                     f"differs from its plain version")
        f_ms, f_plain_ms, timed = graph_pair(
            fused, ref, "host_const stages the grid's constants through "
            "pinned memory")
        b_ms, b_by, tested = occupancy_bound(tt, valid, SR, cp, rd)
        before = (f", route before {route_ms:.4f} ms "
                  f"({route_ms / f_ms:.2f}x the kernel's time)"
                  if shape == "serving group" else "")
        kind = "broadcast" if tt.stride()[:2] == (0, 0) else "jittered"
        log(f"K3 occupancy select mode, {shape}: rays={rd.shape[1]} "
            f"samples={tt.numel()} ({kind} depths) SR={SR}: bit-equal; "
            f"occupied share "
            f"{float(valid.float().mean()):.4f}, rays at SR "
            f"{float((got[2] == SR).float().mean()):.4f}, samples tested "
            f"{tested}; {timed} bound={b_ms:.4f} ms ({b_by}; "
            f"{100 * b_ms / f_ms:.0f}% of the kernel's time){before}")
        rows.append((f"select mode, {shape}", dict(
            err=0.0, ms=f_ms, plain_ms=f_plain_ms, bound_ms=b_ms,
            bound_by=b_by)))
        del got, want, valid
    return dict(dict(rows)["select mode, serving group"], rows=rows)


def sass_calls(kernel):
    """{callee: count} of the CALL instructions in the SASS of `kernel`'s
    library: the subroutines it reaches, such as the 64-bit integer
    division (an unnamed callee prints as its address)."""
    import re
    calls = {}
    for line in sass(kernel).splitlines():
        m = re.search(r"\bCALL\.\S*\s+`?\(?([^)\s;`]+)", line)
        if m:
            callee = m.group(1).split("$")[-1]
            calls[callee] = calls.get(callee, 0) + 1
    return calls


def serve_path(opt, state, spec, grid, agg, ts, item, label, kerns):
    """The serving main path: one full image through render_image, twice
    (the first call warms the allocator and cuBLAS; the counts cover the
    second), then its chunk with the most hits re-rendered on the CPU.
    Every kernel of
    `kerns` must launch, no other trunk kernel. Returns (launch counts, the
    image's maps, render stats)."""
    from pointnerf_tpu_torch.ops import kernels
    from pointnerf_tpu_torch.run import common
    from pointnerf_tpu_torch.train.trainer import ServeState
    chunk = opt.random_sample_size ** 2
    common.render_image(ts, grid, opt, spec, item, group=GROUP)
    for k in kernels.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    maps = common.render_image(ts, grid, opt, spec, item, group=GROUP,
                               stats=stats)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    rgb, hit = maps["coarse_raycolor"], maps["ray_mask"][..., 0] > 0.5
    log(f"{label}: render 800x800: {1e3 * dt:.1f} ms/image, "
        f"{H * W / dt:.0f} rays/s, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"hit share {hit.mean():.4f}, groups {stats['groups']}, "
        f"sr_overflow {stats['sr_overflow']}, "
        f"occ_overflow {stats['occ_overflow']}, launches {launches}")
    check_launches(label, kerns)
    if rgb.shape != (H, W, 3) or not np.isfinite(rgb).all():
        raise AssertionError("rendered image is not a finite [800,800,3] map")
    if not 0.0 < hit.mean() < 1.0:
        raise AssertionError(f"hit share {hit.mean()} is degenerate")
    if rgb.min() < -0.01 or rgb.max() > 1.01:
        raise AssertionError(f"colors out of range [{rgb.min()}, {rgb.max()}]")
    if not np.allclose(rgb[~hit], 1.0, atol=1e-6):
        raise AssertionError("missed rays do not show the white background")

    # the chunk with the most hits rendered again on the CPU with the
    # plain versions
    per_chunk = hit.reshape(-1)[: (H * W // chunk) * chunk].reshape(-1, chunk)
    pick = np.sort(np.argsort(-per_chunk.sum(1), kind="stable")[:1])
    sel = np.concatenate([np.arange(c * chunk, (c + 1) * chunk) for c in pick])
    sub = dict(item, raydir=item["raydir"][:, sel],
               pixel_idx=item["pixel_idx"][:, sel])
    cpu_state = {k: (None if v is None else v.cpu()) for k, v in state.items()}
    cpu_grid = {k: v.cpu() for k, v in grid.items()}
    cpu_ts = ServeState(copy.deepcopy(agg).cpu(), cpu_state)
    t0 = time.perf_counter()
    cpu_maps = common.render_image(cpu_ts, cpu_grid,
                                   opt.replace(use_fused_trunk=1), spec, sub,
                                   group=GROUP)
    px, py = sub["pixel_idx"][0, :, 0].astype(int), \
        sub["pixel_idx"][0, :, 1].astype(int)
    np.testing.assert_array_equal(cpu_maps["ray_mask"][py, px],
                                  maps["ray_mask"][py, px])
    np.testing.assert_allclose(cpu_maps["coarse_raycolor"][py, px],
                               rgb[py, px], **CPU_TOL)
    cerr = float(np.abs(cpu_maps["coarse_raycolor"][py, px]
                        - rgb[py, px]).max())
    log(f"{label}: CPU re-render of chunks {pick.tolist()} ({len(sel)} rays,"
        f" {int(hit.reshape(-1)[sel].sum())} hit): max_abs_err {cerr:.3e} "
        f"in {time.perf_counter() - t0:.1f} s")
    return launches, maps, stats


def check_launches(label, kerns):
    """Every kernel of `kerns` launched since the counts were reset, and no
    trunk kernel outside it (K1/K2 on the default paths, K4/K5 on the
    fused_shade ones)."""
    from pointnerf_tpu_torch.ops import kernels
    for k in kernels.KERNELS:
        if k in kerns and k.launches == 0:
            raise AssertionError(f"{label} never launched {k.name}")
        if k not in kerns and k is not kernels.OCCUPANCY and k.launches:
            raise AssertionError(f"{label} launched {k.name} "
                                 f"{k.launches} times")


def train_path(opt, state, spec, grid, label, kerns):
    """The training main path: create_train_state, one warm-up train_step
    and TRAIN_STEPS timed ones on bench.py's batch (the counts cover the
    timed steps; every kernel of `kerns` must launch, no other trunk
    kernel). The loss must be finite and fall from the first step to the
    last. Returns (launch counts, the train state, the batch, the losses)."""
    from pointnerf_tpu_torch.ops import kernels
    from pointnerf_tpu_torch.run.workload import make_train_batch
    from pointnerf_tpu_torch.train import trainer
    dev = torch.device("cuda")
    st = trainer.create_train_state(opt, state,
                                    torch.Generator().manual_seed(0))
    batch = make_train_batch(opt, dev)
    R = batch["raydir"].shape[1]
    _, items = trainer.train_step(st, grid, batch, opt, spec)
    steps = [items]
    for k in kernels.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        _, items = trainer.train_step(st, grid, batch, opt, spec)
        steps.append(items)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = {k.name: k.launches for k in kernels.KERNELS}
    losses = [float(i["loss_total"]) for i in steps]
    over = [int(i["sr_overflow"]) for i in steps[1:]]
    log(f"{label}: {R} rays/step, {1e3 * dt:.1f} ms/step, "
        f"{R / dt:.0f} train rays/s over {TRAIN_STEPS} steps, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"sr_overflow per step {min(over)}-{max(over)}, launches {launches}")
    log(f"{label}: loss_total step 1 {losses[0]:.6f} -> step "
        f"{len(losses)} {losses[-1]:.6f}; items of the last step "
        f"{ {k: round(float(v), 6) for k, v in steps[-1].items()} }")
    check_launches(label, kerns)
    if not all(np.isfinite(float(v)) for i in steps for v in i.values()):
        raise AssertionError("a train step gave a non-finite loss item")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    return launches, st, batch, losses


class KinkMask:
    """Inside the block, the aggregator's fused_trunk and fused_shade calls
    give neighbor weight 0 (fused_shade: validity 0) to the rows whose
    LeakyReLU input lies within KINK of 0, as the kernel checks do. The
    masks are computed from the plain activations on the first run (the
    CPU's) and replayed call by call on the second (the card's), so both
    runs compute the same function: a row within rounding of a kink may
    take the other slope under another summation order, a jump no
    tolerance on the smooth rows should absorb."""

    def __init__(self):
        self.masks, self.replay, self.calls = [], False, 0

    def smooth(self, L1, L3, nf, nd, order1, emb, d, ex3, ops):
        from pointnerf_tpu_torch.ops import trunk as tt
        if self.replay:
            m = self.masks[self.calls].to(emb.device)
            self.calls += 1
            if m.shape[0] != emb.shape[0]:
                raise AssertionError("the card's trunk calls differ from "
                                     "the CPU's")
            return m
        with torch.no_grad():
            zs = tt.trunk_activations(L1, L3, nf, nd, emb, d, ex3,
                                      [o.detach() for o in ops], not order1)
            m = torch.ones(emb.shape[0], 1, dtype=emb.dtype,
                           device=emb.device)
            for z in zs[2] + zs[4]:
                m = m * (z.abs() >= KINK).all(dim=1, keepdim=True)
        self.masks.append(m.cpu())
        return m

    def __enter__(self):
        from pointnerf_tpu_torch.ops import trunk as tt
        self._trunk, self._shade = tt.fused_trunk, tt.fused_shade

        def trunk(L1, L3, nf, nd, K, act_super, order1, emb, d, ex3, w, ops):
            m = self.smooth(L1, L3, nf, nd, order1, emb, d, ex3, ops)
            return self._trunk(L1, L3, nf, nd, K, act_super, order1, emb, d,
                               ex3, w * m, ops)

        def shade(L1, L3, nf, nd, K, act_super, order1, dist_mode, emb, xyz,
                  xyzp, color, pdir, conf, mask, sl, slw, ovd, RT, ops):
            with torch.no_grad():
                f = tt.shade_front(xyz, xyzp, color, pdir, conf, mask, sl,
                                   slw, ovd, RT, dist_mode, K)
            m = self.smooth(L1, L3, nf, nd, order1, emb, f.d_raw, f.ex3, ops)
            return self._shade(L1, L3, nf, nd, K, act_super, order1,
                               dist_mode, emb, xyz, xyzp, color, pdir, conf,
                               mask * m, sl, slw, ovd, RT, ops)
        tt.fused_trunk, tt.fused_shade = trunk, shade
        return self

    def __exit__(self, *exc):
        from pointnerf_tpu_torch.ops import trunk as tt
        tt.fused_trunk, tt.fused_shade = self._trunk, self._shade

    def masked(self) -> int:
        return int(sum(float((1 - m).sum()) for m in self.masks))


def check_train_cpu(st, batch, opt, spec, grid, label):
    """One compute_grads on the card against the CPU's plain versions
    (use_fused_trunk=1; fused_shade as `opt` says) from the same state,
    batch and jitter draws: equal counters, losses within LOSS_RTOL, each
    gradient within GRAD_REL. `st` is a freshly created state: after
    trained steps the state itself differs from run to run (K6's float
    atomics, amplified by Adam). Rows within KINK of a LeakyReLU kink get
    neighbor weight 0 on both devices (KinkMask): which of them take the
    other slope on the card changes with every rounding difference, and
    one parent run in three failed this check from them (color gradient
    1.6e-3)."""
    from pointnerf_tpu_torch.train import trainer
    u = trainer.jitter_draws(st, batch, opt)
    points = {k: (None if v is None else v.detach().cpu())
              for k, v in st.points.items()}
    cpu_st = trainer.make_train_state(copy.deepcopy(st.aggregator).cpu(),
                                      points, opt, torch.Generator(), st.step)
    on_cpu = lambda d: {k: (v.cpu() if torch.is_tensor(v) else v)
                        for k, v in d.items()}
    t0 = time.perf_counter()
    with KinkMask() as kinks:
        cpu = trainer.compute_grads(cpu_st, on_cpu(grid), on_cpu(batch),
                                    opt.replace(use_fused_trunk=1), spec,
                                    u.cpu())
        cpu_s = time.perf_counter() - t0
        kinks.replay = True
        card = trainer.compute_grads(st, grid, batch, opt, spec, u)
    for k in ("sr_overflow", "occ_overflow"):
        if float(card[0][k]) != float(cpu[0][k]):
            raise AssertionError(f"{k} differs: card {float(card[0][k])}, "
                                 f"CPU {float(cpu[0][k])}")
    for k, v in cpu[0].items():
        np.testing.assert_allclose(float(card[0][k]), float(v),
                                   rtol=LOSS_RTOL, err_msg=k)
    worst, worst_abs = ("", 0.0), 0.0
    for part in (1, 2):
        for k, g in cpu[part].items():
            d = card[part][k].cpu() - g
            rel = float(d.norm() / g.norm()) if g.norm() > 0 \
                else float(d.norm())
            if not rel <= GRAD_REL:
                raise AssertionError(f"gradient of {k} off by {rel:.3e} "
                                     f"(||card - cpu|| / ||cpu||)")
            worst = max(worst, (k, rel), key=lambda t: t[1])
            worst_abs = max(worst_abs, float(d.abs().max()))
    log(f"{label}: card vs CPU compute_grads on the full "
        f"{batch['raydir'].shape[1]}-ray batch: loss_total "
        f"{float(card[0]['loss_total']):.7f} vs "
        f"{float(cpu[0]['loss_total']):.7f}; worst gradient {worst[0]} "
        f"||card - cpu||/||cpu|| {worst[1]:.3e}, max abs error "
        f"{worst_abs:.3e}; {kinks.masked()} rows within {KINK:g} of a "
        f"LeakyReLU kink weighted 0 on both; CPU {cpu_s:.1f} s")
    return worst[1]


# ------------------------------------------------------------ K6, K7 checks
def scatter_bad(got, want, abs_sum):
    """Entries of `got` off from `want` by more than SCATTER_REL of the sum
    of |updates| that reach them (the scale of a float sum's rounding in
    any order; 1e-30 absorbs denormals)."""
    return (got - want).abs() > SCATTER_REL * abs_sum + 1e-30


def check_scatter(label, idx, upd, n_rows):
    """K6 against scatter_add_rows_reference on the same inputs, each entry
    within SCATTER_REL of the sum of |updates| that reach it, so the
    tolerance follows the data at every shape (a train step's point
    gradients are ~1e-4, the script's updates ~1). The check must catch a
    scatter that drops one kept entry in 97: it is run on the plain version
    of such a scatter, which must fail it; the share of kept entries whose
    loss alone would fail it is printed. Also: the largest difference
    between two launches (float atomics sum in no fixed order), and the
    times of the kernel, the plain version and the library call
    `torch.zeros(n_rows, C).index_add_(0, idx, upd)` over the kept entries
    (filtered outside the timed region: index_add_ cannot skip). Bound:
    bytes, the indices and the kept updates read once and the table
    written once."""
    from pointnerf_tpu_torch.ops.scatter import (scatter_add_rows,
                                                 scatter_add_rows_reference)
    kern = lambda: scatter_add_rows(idx, upd, n_rows)
    plain = lambda: scatter_add_rows_reference(idx, upd, n_rows)
    keep = idx >= 0
    lib_idx, lib_upd = idx[keep].long(), upd[keep]
    library = lambda: torch.zeros((n_rows, upd.shape[1]),
                                  device=upd.device).index_add_(
        0, lib_idx, lib_upd)
    got, again, want = kern(), kern(), plain()
    abs_sum = scatter_add_rows_reference(idx, upd.abs(), n_rows)
    kept_at = torch.nonzero(keep)[:, 0]
    dropped = idx.clone()
    dropped[kept_at[::97]] = -1
    torch.cuda.synchronize()
    for what, out in (("K6", got), ("K6 again", again),
                      ("index_add_", library())):
        bad = scatter_bad(out, want, abs_sum)
        if bool(bad.any()):
            raise AssertionError(f"{what} differs from the plain version on "
                                 f"{int(bad.sum())} entries")
    if not bool(scatter_bad(scatter_add_rows_reference(dropped, upd, n_rows),
                            want, abs_sum).any()):
        raise AssertionError("the K6 check passes a scatter that drops one "
                             "kept entry in 97")
    caught = float((upd[keep].abs() > SCATTER_REL * abs_sum[idx[keep].long()]
                    ).any(dim=1).float().mean())
    err = float((got - want).abs().max())
    rerun = float((got - again).abs().max())
    top = float(want.abs().max())
    host_ms, host_plain_ms = timed_pair(kern, plain, reps=10)
    host_library_ms = cuda_time(library, 10)
    ms, plain_ms, timed = graph_pair(kern, plain)
    library_ms, library_how = graph_time(library)
    C = upd.shape[1]
    n_skip = int((~keep).sum())
    # skipped rows' updates are never read
    b_ms, b_by = bound(0, nbytes(idx) + 4 * C * (idx.shape[0] - n_skip)
                       + 4 * C * n_rows)
    log(f"K6 scatter_rows {label} S={idx.shape[0]} ({n_skip} skipped) "
        f"cap={n_rows} C={C}: max_abs_err={err:.3e} (max|plain| {top:.3e}; "
        f"each entry within {SCATTER_REL:g} of its sum of |updates|; a "
        f"scatter dropping one kept entry in 97 fails; the loss of any one "
        f"of {100 * caught:.2f}% of the kept entries alone would), two "
        f"launches differ by {rerun:.3e}; {timed} index_add_ over the "
        f"kept entries={library_ms:.4f} ms ({library_how}) bound="
        f"{b_ms:.4f} ms ({b_by}); host-paced (10 eager calls, CUDA events): "
        f"kernel={host_ms:.4f} ms plain={host_plain_ms:.4f} ms "
        f"index_add_={host_library_ms:.4f} ms")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


class ScatterRecorder:
    """Records the arguments of the point-gradient scatter calls of one
    compute_grads (neural_points' scatter_add_rows, wrapped for the call),
    so K6 is checked at the shapes and indices a train step gives it."""

    def __enter__(self):
        from pointnerf_tpu_torch.models import neural_points as npc
        self.calls, self._orig = [], npc.scatter_add_rows

        def record(idx, upd, n_rows):
            self.calls.append((idx.clone(), upd.clone(), n_rows))
            return self._orig(idx, upd, n_rows)
        npc.scatter_add_rows = record
        return self

    def __exit__(self, *exc):
        from pointnerf_tpu_torch.models import neural_points as npc
        npc.scatter_add_rows = self._orig


def check_row_select(dev):
    """K7 against row_select_reference at occ_micro3's shapes (bench.py's
    3,600-ray batch with jittered depths, D = 400, U = 96, LW = 128): each
    ray's gathered rows in int8 and bf16, Rt = 8/16/32/120 rays per CTA; the
    kernel must equal the plain version exactly. Then the segmented pipeline
    with K7 (its micro-benchmark's path; its launches are the ones
    reported) against the dense mask, equal on every ray with at most U
    distinct rows. Times the int8 Rt=16 launch against the plain version
    and the library call, one torch.gather over rows_g viewed [N, U·LW] at
    rank·LW + lane (the index computed outside the timed region). Bound:
    bytes of rank, lane, the output and the 32-byte sectors of rows_g that
    the samples reach."""
    from pointnerf_tpu_torch.ops import kernels
    from pointnerf_tpu_torch.ops.query import (mask_raypos, row_select,
                                               row_select_reference)
    from pointnerf_tpu_torch.scripts import occ_micro3 as om
    _, grid, spec, _, raypos, _ = om.bench_workload(dev)
    rows = grid["coor_occ_rows"]
    U, LW = OCC_U, rows.shape[-1]
    inb, rid, lane, is_start, rank = om.stages(raypos, spec, LW)
    rank_c = torch.clamp(rank, max=U - 1)
    rank32, lane32 = rank_c.to(torch.int32), lane.to(torch.int32)
    c = om.ray_rows(rid, is_start, rank, U).reshape(-1).long()
    N, D = rank.shape
    out = None
    for dtype in (torch.int8, torch.bfloat16):
        rows_g = rows.to(dtype)[c].reshape(N, U, LW)
        want = row_select_reference(rows_g, rank_c, lane)
        for Rt in (8, 16, 32, 120):
            got = row_select(rows_g, rank_c, lane, Rt)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"K7 {dtype} Rt={Rt} differs from the "
                                     f"plain version on "
                                     f"{int((got != want).sum())} samples")
        if dtype == torch.int8:
            flat = rows_g.reshape(N, U * LW)
            gidx = (rank_c * LW + lane).long()
            kern = lambda: row_select(rows_g, rank32, lane32, 16)
            plain = lambda: row_select_reference(rows_g, rank32, lane32)
            library = lambda: torch.gather(flat, 1, gidx)
            host_ms, host_plain_ms = timed_pair(kern, plain, reps=10)
            host_library_ms = cuda_time(library, 10)
            ms, plain_ms, timed = graph_pair(kern, plain)
            library_ms, library_how = graph_time(library)
            # int32 rank and lane in, float32 out, and of rows_g the 32-byte
            # sectors the samples reach: what this run's data needs (all of
            # rows_g is more than a gather reads)
            off = (torch.arange(N, device=dev)[:, None] * (U * LW)
                   + rank_c.clamp(0, U - 1) * LW + lane.clamp(0, LW - 1))
            sectors = int(torch.unique(off // 32).numel())
            b_ms, b_by = bound(0, 32 * sectors + 12 * N * D)
            whole_ms, _ = bound(0, nbytes(rows_g) + 12 * N * D)
            span = rank_c.max(dim=1).values - rank_c.min(dim=1).values + 1
            out = dict(err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=library_ms)
            log(f"K7 row_select int8 and bf16 rows, Rt 8/16/32/120, N={N} "
                f"D={D} U={U} LW={LW}: equal to the plain version; int8 Rt=16 "
                f"(int32 rank and lane, gather's int64 index, both made "
                f"outside the timed calls) {timed} gather={library_ms:.4f} ms "
                f"({library_how}) bound={b_ms:.4f} ms ({b_by}: {sectors} "
                f"sectors of rows_g, {100 * b_ms / ms:.0f}% of the kernel's "
                f"time; {whole_ms:.4f} ms with all of rows_g read); staged "
                f"rows a ray {float(span.float().mean()):.1f} of U={U} on "
                f"average; host-paced "
                f"(10 eager calls, CUDA events): kernel={host_ms:.4f} ms "
                f"plain={host_plain_ms:.4f} ms gather={host_library_ms:.4f} ms")
        del rows_g
    dense = mask_raypos(raypos, grid, spec)
    kernels.ROW_SELECT.launches = 0
    seg, over = om.segmented_mask(raypos, grid, spec, U, torch.int8, 16)
    out["launches"] = kernels.ROW_SELECT.launches
    keep = ~over.reshape(dense.shape[:2])
    if not torch.equal(dense[keep], seg[keep]):
        raise AssertionError("the segmented mask with K7 differs from the "
                             "dense mask on rays within U rows")
    log(f"K7 segmented pipeline vs dense mask: equal on the "
        f"{int(keep.sum())} rays within U={U} distinct rows; "
        f"{int(over.sum())} rays past U (max distinct rows "
        f"{int(rank.max()) + 1})")
    return out


# ------------------------------------------------------- the finetune phase
def finetune_options(root):
    """The lego preset at full widths on the plate scene, with the
    finetune phase's cadence: FT_STEPS steps, one prune, a probe-and-grow
    every FT_PROBE steps (opacity gate FT_PROB_THRESH), one checkpoint at
    the end, three point dumps (the visualize phase's growth video), test
    renders of the 4 test views before and after."""
    from pointnerf_tpu_torch.config import nerf_synth_preset
    return nerf_synth_preset("lego").replace(
        data_root=root, scan="plate", img_wh=(FT_WH, FT_WH), load_points=1,
        checkpoints_dir=os.path.join(root, "checkpoints"),
        experiment="plate_ft", maximum_step=FT_STEPS, prune_iter=FT_PRUNE,
        prune_max_iter=FT_PRUNE, prob_freq=FT_PROBE, print_freq=100,
        save_iter_freq=10 * FT_STEPS, save_point_freq=FT_STEPS // 3,
        test_freq=0, test_num=4, prob_thresh=FT_PROB_THRESH)


def finetune_path(root):
    """The finetune driver's main path on the card: train_ft.main at the
    lego preset's widths on the plate scene (prune, probe-and-grow, final
    checkpoint), with the PSNR of a test render of the initial state before
    it, then main again, which must resume from the checkpoint and stop at
    once. Returns the launch counts of the first main."""
    from pointnerf_tpu_torch.data import create_dataset
    from pointnerf_tpu_torch.ops import kernels
    from pointnerf_tpu_torch.run import common, train_ft
    from pointnerf_tpu_torch.run.workload import make_plate_scene
    from pointnerf_tpu_torch.train import trainer
    from pointnerf_tpu_torch.utils.visualizer import Visualizer
    n_written = make_plate_scene(root, wh=(FT_WH, FT_WH))
    opt = finetune_options(root)
    dev = torch.device("cuda")
    train_ds = create_dataset(opt, "train")
    state = common.init_point_state_from_dataset(opt, train_ds, device=dev)
    n_init = int(state["mask"].sum())
    st = trainer.create_train_state(opt, state,
                                    torch.Generator().manual_seed(opt.seed))
    spec, grid = common.make_spec_and_grid(opt, state)
    psnr0 = train_ft.test(st, grid, opt, spec, create_dataset(opt, "test"),
                          Visualizer(opt), 0, write_images=False)
    del st, state, grid, train_ds
    torch.cuda.empty_cache()
    log(f"finetune: plate scene {FT_WH}x{FT_WH}, 12 train / 4 test views, "
        f"{n_written} init points -> {n_init} after the voxel downsample "
        f"(vox_res {opt.vox_res}); lr {opt.lr} plr {opt.plr}; test PSNR "
        f"before training {psnr0:.3f}")
    for k in kernels.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train_ft.main(opt)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    tm = res["timing"]
    ms = 1e3 * tm["train_s"] / tm["steps"]
    R = opt.random_sample_size ** 2
    log(f"finetune: {tm['steps']} steps, {ms:.1f} ms/step, {1e3 * R / ms:.0f}"
        f" train rays/s ({R} rays a step, host clock around each step and "
        f"its items' fetch), wall {wall:.1f} s (prunes {tm['prune_s']:.1f} s, "
        f"probe-and-grows {tm['grow_s']:.1f} s, test renders "
        f"{tm['test_s']:.1f} s, checkpoints {tm['save_s']:.1f} s, the rest "
        f"{wall - sum(tm[k] for k in PHASES):.1f} s); prune (step, before, "
        f"after) "
        f"{tm['prune']}, grow {tm['grow']}; final test PSNR "
        f"{res['final_psnr']:.3f} (before training {psnr0:.3f}), scores "
        f"{ {k: round(v, 4) for k, v in res['scores'].items()} }; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{launches}")
    check_launches("finetune", (kernels.TRUNK_FWD, kernels.TRUNK_BWD,
                                kernels.OCCUPANCY, kernels.SCATTER_ROWS))
    ckpt = os.path.join(opt.checkpoints_dir, opt.experiment)
    for f in (f"{FT_STEPS}_net_ray_marching.npz", f"{FT_STEPS}_states.npz",
              f"{FT_STEPS}_full.npz", "log.txt"):
        if not os.path.exists(os.path.join(ckpt, f)):
            raise AssertionError(f"finetune wrote no {f}")
    if res["total_steps"] != FT_STEPS or not tm["prune"] or not tm["grow"]:
        raise AssertionError("the finetune did not run its steps, one prune "
                             "and a probe-and-grow")
    if not (res["final_psnr"] > FT_PSNR and res["final_psnr"] > psnr0):
        raise AssertionError(f"final test PSNR {res['final_psnr']:.3f} not "
                             f"above {FT_PSNR} and the initial {psnr0:.3f}")
    del res
    torch.cuda.empty_cache()
    res2 = train_ft.main(opt)
    log(f"finetune resume: total_steps {res2['total_steps']}, "
        f"{res2['timing']['steps']} steps run, final test PSNR "
        f"{res2['final_psnr']:.3f}")
    if res2["total_steps"] != FT_STEPS or res2["timing"]["steps"] != 0:
        raise AssertionError("the second main did not resume and stop")
    return launches


# ------------------------------------------------------- the MVS init phase
def mvs_options(root):
    """The lego preset with its own MVS init (load_points 0: depth_grid 128,
    init_view_num 3, full_comb 1, depth_occ 1, vox_res 320) on the plate
    scene at 800x800, with the premlp (shading_feature_mlp_layer0 1: the
    preset has none, and its 56-wide raw features do not fit
    point_features_dim 32), the cuts MVS_NEAR_FAR and MVS_CONF_THRESH, and
    MVS_STEPS finetune steps with no prune and no probe."""
    from pointnerf_tpu_torch.config import nerf_synth_preset
    return nerf_synth_preset("lego").replace(
        data_root=root, scan="plate", img_wh=(MVS_WH, MVS_WH), load_points=0,
        shading_feature_mlp_layer0=1, depth_conf_thresh=MVS_CONF_THRESH,
        near_plane=MVS_NEAR_FAR[0], far_plane=MVS_NEAR_FAR[1],
        checkpoints_dir=os.path.join(root, "checkpoints"),
        experiment="plate_mvs", maximum_step=MVS_STEPS, prune_iter=0,
        prob_freq=0, print_freq=100, save_iter_freq=10 * MVS_STEPS,
        save_point_freq=0, test_freq=0, test_num=MVS_TEST_VIEWS)


def mvs_triplet_check(opt, mvs, sample):
    """One triplet's gen_points on the card and on the CPU with the same
    weights: depth and prob maps everywhere, conf away from the pixels
    whose regressed index lies within MVS_INDEX_TIE of an integer (it jumps
    there), at MVS_TOL; the keep masks (rows kept on one device only at
    most MVS_ONE_SIDE of the rows); xyz, embedding, color, dir and conf at
    MVS_TOL on the rows kept on both, less two named ties: rows from an
    index-tie pixel, and rows whose visibility in a view differs (an
    in-bounds test or a z-buffer ceil cell decided by rounding), at most
    MVS_VIS_TIES of the rows."""
    from pointnerf_tpu_torch.models.mvs import points_model as pm
    maps_c, maps_h = {}, {}
    t0 = time.perf_counter()
    with torch.inference_mode():
        card = pm.gen_points(mvs, opt, sample, maps=maps_c)
    card_s = time.perf_counter() - t0
    mvs_cpu = copy.deepcopy(mvs).cpu()
    t0 = time.perf_counter()
    with torch.inference_mode():
        host = pm.gen_points(mvs_cpu, opt, sample, maps=maps_h)
    cpu_s = time.perf_counter() - t0
    np_ = lambda t: t.detach().cpu().numpy()
    for k in ("depth", "prob"):
        np.testing.assert_allclose(np_(maps_c[k][0]), np_(maps_h[k][0]),
                                   err_msg=k, **MVS_TOL)
    idx_c, idx_h = np_(maps_c["index"][0]), np_(maps_h["index"][0])
    tie_px = (np.abs(idx_c - np.round(idx_c)) < MVS_INDEX_TIE) | \
        (np.abs(idx_h - np.round(idx_h)) < MVS_INDEX_TIE)
    np.testing.assert_allclose(np_(maps_c["conf"][0])[~tie_px],
                               np_(maps_h["conf"][0])[~tie_px],
                               err_msg="conf", **MVS_TOL)
    keep_c, keep_h = np_(card["keep"]), np_(host["keep"])
    one_side = int((keep_c != keep_h).sum())
    n = len(keep_c)
    H, W = sample["mvs_images"].shape[-2:]
    hw = np.arange(n) % (H * W)
    row_tie = tie_px[(hw // W) // 4, (hw % W) // 4]
    vis_tie = np.any(np_(maps_c["vis"][0]) != np_(maps_h["vis"][0]), axis=-1)
    rows = keep_c & keep_h & ~row_tie & ~vis_tie
    errs = {}
    for k in ("xyz_w", "embedding", "color", "dir", "conf"):
        a, b = np_(card[k])[rows], np_(host[k])[rows]
        errs[k] = float(np.abs(a - b).max())
        np.testing.assert_allclose(a, b, err_msg=k, **MVS_TOL)
    log(f"mvs: one triplet {H}x{W}, D {opt.depth_grid}, card vs CPU: "
        f"depth/prob within {MVS_TOL}; conf on {int((~tie_px).sum())} of "
        f"{tie_px.size} low-res pixels ({int(tie_px.sum())} index ties); "
        f"rows {n}, kept on one device only {one_side} "
        f"({one_side / n:.2e}), compared {int(rows.sum())} (skipped: "
        f"{int((keep_c & keep_h & row_tie).sum())} index-tie rows, "
        f"{int((keep_c & keep_h & vis_tie & ~row_tie).sum())} visibility "
        f"ties); max abs err {errs}; card {card_s:.2f} s, CPU {cpu_s:.1f} s")
    if one_side > MVS_ONE_SIDE * n:
        raise AssertionError(f"{one_side} of {n} rows kept on one device "
                             f"only")
    if vis_tie.sum() > MVS_VIS_TIES * n:
        raise AssertionError(f"{int(vis_tie.sum())} of {n} rows see other "
                             f"views on the card and the CPU")


def mvs_path(root):
    """The MVS init (load_points 0) on the card: the plate scene at
    MVS_WH², one triplet held against the CPU, then
    gen_points_filter_embeddings over every triplet of the 12 train views,
    timed by phase; then
    train_ft.main from the MVS cloud for MVS_STEPS steps (the counts reset
    just before and read just after: K1, K2, K3 and K6 must launch), whose
    test PSNR must pass that of a test render of the initial cloud and
    whose start must hold as many points as the timed run made. Returns
    the launch counts of main."""
    from pointnerf_tpu_torch.data import create_dataset
    from pointnerf_tpu_torch.models import neural_points as npc
    from pointnerf_tpu_torch.models.mvs import points_model as pm
    from pointnerf_tpu_torch.ops import kernels
    from pointnerf_tpu_torch.run import common, train_ft
    from pointnerf_tpu_torch.run.workload import make_plate_scene
    from pointnerf_tpu_torch.train import trainer
    from pointnerf_tpu_torch.utils.visualizer import Visualizer
    make_plate_scene(root, wh=(MVS_WH, MVS_WH), n_test=MVS_TEST_VIEWS)
    opt = mvs_options(root)
    dev = torch.device("cuda")
    train_ds = create_dataset(opt, "train")
    mvs = pm.MvsPoints(opt, torch.Generator().manual_seed(opt.seed),
                       device=dev)
    # first: one triplet against the CPU (which also warms cuDNN up)
    mvs_triplet_check(opt, mvs, train_ds.get_init_item(0))
    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.inference_mode():
        state = common.gen_points_filter_embeddings(opt, train_ds, mvs=mvs,
                                                    device=dev, stats=stats)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    T = stats["triplets"]
    per = {k: 1e3 * stats[k] / T for k in ("mvs_s", "fusion_s", "embed_s")}
    log(f"mvs: plate scene {MVS_WH}x{MVS_WH}, 12 train views, {T} triplets "
        f"(full_comb {opt.full_comb}), D {opt.depth_grid}, near/far "
        f"{MVS_NEAR_FAR}, conf thresh {MVS_CONF_THRESH}: ms per triplet "
        f"MVSNet {per['mvs_s']:.1f}, fusion {per['fusion_s']:.1f}, embedding"
        f" {per['embed_s']:.1f}; hull {1e3 * stats['hull_s']:.1f} ms, voxel "
        f"downsample {1e3 * stats['vox_s']:.1f} ms (host); wall {wall:.2f} s;"
        f" points kept {stats['n_keep']}, after the hull {stats['n_hull']}, "
        f"after the downsample (vox_res {opt.vox_res}) {stats['n_vox']}; "
        f"peak {peak:.2f} GiB")
    if stats["n_vox"] < MVS_MIN_POINTS:
        raise AssertionError(f"the MVS init left {stats['n_vox']} points")
    del mvs
    torch.cuda.empty_cache()

    state = {k: (None if v is None else v.clone()) for k, v in state.items()}
    st = trainer.create_train_state(opt, state,
                                    torch.Generator().manual_seed(opt.seed))
    spec, grid = common.make_spec_and_grid(opt, state)
    psnr0 = train_ft.test(st, grid, opt, spec, create_dataset(opt, "test"),
                          Visualizer(opt), 0, write_images=False)
    del st, state, grid, train_ds
    torch.cuda.empty_cache()
    for k in kernels.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train_ft.main(opt)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    tm = res["timing"]
    n_start = int(npc.num_active(trainer.point_state_of(res["state"])))
    log(f"mvs finetune: {n_start} points from the MVS init, {tm['steps']} "
        f"steps, {1e3 * tm['train_s'] / tm['steps']:.1f} ms/step, wall "
        f"{wall:.1f} s (the init again, test renders {tm['test_s']:.1f} s, "
        f"checkpoints {tm['save_s']:.1f} s); final test PSNR "
        f"{res['final_psnr']:.3f} (initial MVS cloud {psnr0:.3f}); peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{launches}")
    check_launches("mvs finetune", (kernels.TRUNK_FWD, kernels.TRUNK_BWD,
                                    kernels.OCCUPANCY, kernels.SCATTER_ROWS))
    if n_start != stats["n_vox"]:
        raise AssertionError(f"main started from {n_start} points, the "
                             f"timed init made {stats['n_vox']}")
    if res["total_steps"] != MVS_STEPS or tm["prune"] or tm["grow"]:
        raise AssertionError("the MVS finetune did not run its steps alone")
    if not res["final_psnr"] > psnr0:
        raise AssertionError(f"final test PSNR {res['final_psnr']:.3f} not "
                             f"above the initial {psnr0:.3f}")
    return launches


# ---------------------------------------------- the feed-forward DTU phases
def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_gib(dev) -> float:
    return torch.cuda.max_memory_allocated(dev) / 2**30 \
        if dev.type == "cuda" else float("nan")


def dtu_inf_options(root):
    """The dtu_inf preset at its widths (640x512, 3 views, D 128,
    z_depth_dim 400, vscale (2, 2, 1): a 32.8 M-voxel frustum grid; SR 40,
    K 8, P 20, order 1, SR_budget -1) on the plate scene in the DTU
    layout, with the cut DTU_CONF_THRESH."""
    from pointnerf_tpu_torch.config import dtu_inf_preset
    return dtu_inf_preset("scan1").replace(
        data_root=root, img_wh=DTU_WH, depth_conf_thresh=DTU_CONF_THRESH,
        checkpoints_dir=os.path.join(root, "checkpoints"),
        experiment="dtu_inf_smoke")


def dtu_gen_options(root):
    """The dtu_gen preset at its widths (640x512, depth_vid 012: 983,040
    point slots a step, 56² rays, kernel 5³, K 8, SR 40, P 16) on the plate
    scene in the DTU layout, with the cuts DTU_CONF_THRESH, DTU_GEO_CNSST
    and DTU_RANGES."""
    from pointnerf_tpu_torch.config import dtu_gen_preset
    return dtu_gen_preset().replace(
        data_root=root, img_wh=DTU_WH, depth_conf_thresh=DTU_CONF_THRESH,
        geo_cnsst_num=DTU_GEO_CNSST, ranges=DTU_RANGES, checkpoints_dir=os.path.join(root, "checkpoints"),
        experiment="dtu_gen_smoke", print_freq=1000)


def dtu_inf_path(root, dev=torch.device("cuda")):
    """Feed-forward inference (dtu_inf) on the card: run/train.inference
    over one test item (points from its three views, the frustum grid once,
    the full 640x512 image; the counts reset just before and read just
    after: K1 must launch, in order 1, and K2, K4, K5 not), after one
    warm-up item; then the item again with its time by phase; then two of
    its chunks rendered again on the CPU with the plain versions from the
    same points. Returns the launch counts."""
    from pointnerf_tpu_torch.data import create_dataset
    from pointnerf_tpu_torch.ops import kernels
    from pointnerf_tpu_torch.run import common
    from pointnerf_tpu_torch.run import train as gen
    from pointnerf_tpu_torch.train.trainer import ServeState
    opt = dtu_inf_options(root)
    ds = create_dataset(opt, "test")
    spec = gen.make_render_spec(opt, ds, gen.point_slots(opt))
    state = gen.create_gen_state(opt, device=dev)
    item = ds.get_item(0, full_img=True)
    gen.infer_item(state, opt, spec, item)
    for k in kernels.KERNELS:
        k.launches = 0
    sync(dev)
    reset_peak(dev)
    t0 = time.perf_counter()
    res = gen.inference(opt, state=state, max_images=1, device=dev)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    peak = peak_gib(dev)
    check_launches("dtu_inf", (kernels.TRUNK_FWD,))
    stats = {}
    img = gen.infer_item(state, opt, spec, item, stats=stats)
    W, H = opt.img_wh
    ms = lambda k: 1e3 * stats[k]
    log(f"dtu_inf: {W}x{H}, frustum grid {spec.vdim} "
        f"({spec.grid_size_vol} voxels), SR {opt.SR}, K {opt.K}, P {opt.P}, "
        f"order {opt.agg_intrp_order}: inference() {1e3 * wall:.1f} ms for "
        f"one item, PSNR {res['psnr']:.3f}, peak {peak:.2f} GiB, launches "
        f"{launches}")
    log(f"dtu_inf: ms by phase (second run): MVSNet {ms('mvs_s'):.1f}, "
        f"fusion {ms('fusion_s'):.1f}, embedding {ms('embed_s'):.1f} "
        f"(points {ms('points_s'):.1f}), frustum grid {ms('grid_s'):.1f}, "
        f"render {ms('render_s') - ms('grid_s'):.1f}; points kept "
        f"{stats['n_points']} of {gen.point_slots(opt)}, occupied voxels "
        f"{stats['num_occ']}, sr_overflow (q_overflow + wide tier) "
        f"{stats['sr_overflow']}, groups {stats['groups']}")
    if img.shape != (H, W, 3) or not np.isfinite(img).all():
        raise AssertionError("the dtu_inf image is not a finite map")
    if img.min() < 0.0 or img.max() > 1.0:
        raise AssertionError(f"dtu_inf colors out of [0, 1]: "
                             f"[{img.min()}, {img.max()}]")
    if stats["n_points"] == 0 or not (img > 0).any():
        raise AssertionError("the dtu_inf image rendered no point")

    # the brightest chunk, the card and the CPU rendering it from the same
    # points
    chunk = opt.random_sample_size ** 2
    per_chunk = img.reshape(-1, 3).sum(-1)[: (H * W // chunk) * chunk]
    pick = np.sort(np.argsort(-per_chunk.reshape(-1, chunk).sum(1),
                              kind="stable")[:1])
    sel = np.concatenate([np.arange(c * chunk, (c + 1) * chunk) for c in pick])
    sub = dict(item, raydir=item["raydir"][:, sel],
               pixel_idx=item["pixel_idx"][:, sel])
    with torch.inference_mode():
        ps = gen.feedforward_point_state(state.mvs, opt, item["mvs_sample"])
        card = common.render_image(ServeState(state.aggregator, ps), None,
                                   opt, spec, sub)["coarse_raycolor"]
        cpu_ts = ServeState(copy.deepcopy(state.aggregator).cpu(),
                            {k: v.cpu() for k, v in ps.items()})
        t0 = time.perf_counter()
        cpu = common.render_image(cpu_ts, None, opt.replace(use_fused_trunk=1),
                                  spec, sub)["coarse_raycolor"]
    px, py = sub["pixel_idx"][0, :, 0].astype(int), \
        sub["pixel_idx"][0, :, 1].astype(int)
    np.testing.assert_allclose(cpu[py, px], card[py, px], **CPU_TOL)
    log(f"dtu_inf: CPU re-render of chunks {pick.tolist()} ({len(sel)} rays) "
        f"from the card's points: max_abs_err "
        f"{float(np.abs(cpu[py, px] - card[py, px]).max()):.3e} in "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


class FPNProbe:
    """Inside the block, the FPN `net` records the cotangents reaching its
    outputs (`cot`), and with `feats` returns those values with its own
    backward (each output o becomes o + (f − o).detach()). The CPU's FPN
    takes the card's features: on the plate scene's uniform background the
    batch statistics divide near-constant channels by a tiny deviation, so
    two fp32 runs (cuDNN's convolutions and the CPU's) part there; with
    equal features the check holds the path after the FPN, the kernels',
    to the card."""

    def __init__(self, net, feats=None):
        self.net, self.feats, self.cot = net, feats, None

    def __enter__(self):
        net, feats, plain, probe = self.net, self.feats, \
            type(self.net).forward, self

        def forward(imgs, batch_stats=False):
            outs = plain(net, imgs, batch_stats)
            # new nodes, so a hook sees only the cotangent of the returned
            # map, not that of the layers the FPN runs on after it
            outs = [o.clone() if feats is None else
                    o + (f.to(o.device) - o).detach()
                    for o, f in zip(outs, feats or outs)]
            probe.cot = [None] * len(outs)
            for i, o in enumerate(outs[1:], 1):
                if o.requires_grad:
                    o.register_hook(
                        lambda g, i=i: probe.cot.__setitem__(i, g.detach()))
            return outs
        net.forward = forward
        return self

    def __exit__(self, *exc):
        del self.net.forward


def fpn_grad_errors(net, imgs, cot, grads):
    """||g − g64|| / ||g64|| of each FPN weight gradient g (`grads`, by
    MvsPoints name), g64 the float64 FPN's (on the CPU) for the same output
    cotangents `cot`."""
    f64 = copy.deepcopy(net).cpu().double()
    outs = f64(imgs.cpu().double(), batch_stats=True)
    loss = sum((o * c.cpu().double()).sum()
               for o, c in zip(outs[1:], cot[1:]) if c is not None)
    names, params = zip(*f64.named_parameters())
    g64 = torch.autograd.grad(loss, params)
    return {f"featurenet.{n}": float(
        (grads[f"featurenet.{n}"].cpu().double() - g).norm() / g.norm())
        for n, g in zip(names, g64)}


def check_gen_cpu(st, sample, batch, opt, spec):
    """One gen_compute_grads on the card against the CPU's plain versions
    (use_fused_trunk=1) from a freshly created state, its alpha head's bias
    raised by ALPHA_SHIFT, on the first GEN_CPU_RAYS rays of the batch,
    with the same draws, the same frozen half (the card's MVSNet depths,
    fusion and keep mask) and the card's FPN feature values on the CPU
    (FPNProbe; each device's own FPN backward). Loss items within
    LOSS_RTOL; each gradient of the aggregator and the premlp within
    GRAD_REL in norm, rows within KINK of a LeakyReLU kink weighted 0 on
    both (KinkMask). The FPN's weight gradients: off the float64 FPN's
    gradient (for each device's own output cotangents) by at most twice the
    CPU's distance, or GRAD_REL."""
    from pointnerf_tpu_torch.models.mvs import points_model as pm
    from pointnerf_tpu_torch.run import train as gen
    batch = {k: (v[:, :GEN_CPU_RAYS] if k in ("raydir", "gt_image") else v)
             for k, v in batch.items()}
    with torch.no_grad():
        [m for m in st.aggregator.alpha_branch
         if isinstance(m, torch.nn.Linear)][-1].bias += ALPHA_SHIFT
    u = gen.render_draws(st, batch, opt)
    depths = pm.mvs_depths(st.mvs, opt, sample)
    cpu_st = gen.make_gen_state(copy.deepcopy(st.aggregator).cpu(),
                                copy.deepcopy(st.mvs).cpu(), opt,
                                torch.Generator(), st.step)
    on_cpu = lambda d: {k: (v.cpu() if torch.is_tensor(v) else v)
                        for k, v in d.items()}
    imgs = torch.as_tensor(sample["mvs_images"])
    with torch.no_grad():
        feats = [f.cpu() for f in st.mvs.featurenet(
            imgs.to(batch["raydir"].device), batch_stats=True)]
        own = cpu_st.mvs.featurenet(imgs, batch_stats=True)
    fpn_apart = max(float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(own[1:], feats[1:]))
    t0 = time.perf_counter()
    with KinkMask() as kinks:
        with FPNProbe(cpu_st.mvs.featurenet, feats) as cpu_fpn:
            cpu = gen.gen_compute_grads(cpu_st, sample, on_cpu(batch),
                                        opt.replace(use_fused_trunk=1), spec,
                                        u.cpu(), depths=on_cpu(depths))
        cpu_s = time.perf_counter() - t0
        kinks.replay = True
        with FPNProbe(st.mvs.featurenet) as card_fpn:
            card = gen.gen_compute_grads(st, sample, batch, opt, spec, u,
                                         depths=depths)
    for k, v in cpu[0].items():
        np.testing.assert_allclose(float(card[0][k]), float(v),
                                   rtol=LOSS_RTOL, err_msg=k)
    fpn_cpu = fpn_grad_errors(cpu_st.mvs.featurenet, imgs, cpu_fpn.cot,
                              cpu[2])
    fpn_card = fpn_grad_errors(st.mvs.featurenet, imgs, card_fpn.cot,
                               card[2])
    worst, bad = {}, []
    for part, what in ((1, "aggregator"), (2, "mvs")):
        for k, g in cpu[part].items():
            d = card[part][k].cpu() - g
            rel = float(d.norm() / g.norm()) if g.norm() > 0 \
                else float(d.norm())
            group = what if what == "aggregator" else k.split(".")[0]
            if k in fpn_card:
                bar = max(2 * fpn_cpu[k], GRAD_REL)
                if not fpn_card[k] <= bar:
                    bad.append(f"{k} {fpn_card[k]:.3e} off float64 (CPU "
                               f"{fpn_cpu[k]:.3e})")
            elif not rel <= GRAD_REL:
                bad.append(f"{k} {rel:.3e}")
            worst[group] = max(worst.get(group, 0.0), rel)
    log(f"dtu_gen: card vs CPU gen_compute_grads on {GEN_CPU_RAYS} rays "
        f"(alpha bias + {ALPHA_SHIFT}): loss_total "
        f"{float(card[0]['loss_total']):.7f} vs "
        f"{float(cpu[0]['loss_total']):.7f}; worst ||card - cpu||/||cpu|| "
        f"by group { {k: f'{v:.3e}' for k, v in worst.items()} }; FPN "
        f"weight gradients off the float64 FPN's, worst: card "
        f"{max(fpn_card.values()):.3e}, CPU {max(fpn_cpu.values()):.3e}; "
        f"{kinks.masked()} rows within {KINK:g} of a LeakyReLU kink weighted"
        f" 0 on both; FPN features of the two devices apart by "
        f"{fpn_apart:.3e} of the largest (the CPU ran the card's); CPU "
        f"{cpu_s:.1f} s")
    if bad:
        raise AssertionError(f"dtu_gen gradients off: {bad}")


def dtu_gen_path(root, dev=torch.device("cuda")):
    """Generalizable training (dtu_gen) on the card: gen_train_step on one
    item of the train split, a warm-up step and GEN_STEPS timed ones (the
    counts reset just before and read just after: K1, K2, K3 and K6 must
    launch); the loss must fall. Then one step's gradients against the
    CPU's from a fresh state (check_gen_cpu); then a {steps}_gen.npz of the
    trained state, which run/train.inference must load. Returns the launch
    counts."""
    from pointnerf_tpu_torch.data import create_dataset
    from pointnerf_tpu_torch.ops import kernels
    from pointnerf_tpu_torch.run import train as gen
    from pointnerf_tpu_torch.utils.checkpoint import load_gen_npz, \
        save_gen_npz
    opt = dtu_gen_options(root)
    ds = create_dataset(opt, "train")
    spec = gen.make_render_spec(opt, ds, gen.point_slots(opt))
    item = ds.get_item(0, rng=np.random.RandomState(0))
    sample = item.pop("mvs_sample")
    batch = gen.batch_of(item, dev)
    st = gen.create_gen_state(opt, device=dev)
    _, items = gen.gen_train_step(st, sample, batch, opt, spec)
    steps = [items]
    for k in kernels.KERNELS:
        k.launches = 0
    sync(dev)
    reset_peak(dev)
    t0 = time.perf_counter()
    for _ in range(GEN_STEPS):
        _, items = gen.gen_train_step(st, sample, batch, opt, spec)
        steps.append(items)
    sync(dev)
    dt = (time.perf_counter() - t0) / GEN_STEPS
    launches = {k.name: k.launches for k in kernels.KERNELS}
    peak = peak_gib(dev)
    losses = [float(i["loss_total"]) for i in steps]
    R = batch["raydir"].shape[1]
    with torch.inference_mode():
        n_kept = int(gen.feedforward_point_state(st.mvs, opt, sample)
                     ["mask"].sum())
    log(f"dtu_gen: {R} rays/step, world grid {spec.vdim} "
        f"({spec.grid_size_vol} voxels), {n_kept} of {gen.point_slots(opt)} "
        f"point slots kept: {1e3 * dt:.1f} ms/step over {GEN_STEPS} steps, "
        f"{R / dt:.0f} train rays/s, peak {peak:.2f} GiB, launches "
        f"{launches}; loss_total step 1 {losses[0]:.6f} -> step "
        f"{len(losses)} {losses[-1]:.6f}; items of the last step "
        f"{ {k: round(float(v), 6) for k, v in steps[-1].items()} }")
    check_launches("dtu_gen", (kernels.TRUNK_FWD, kernels.TRUNK_BWD,
                               kernels.OCCUPANCY, kernels.SCATTER_ROWS))
    if not all(np.isfinite(float(v)) for i in steps for v in i.values()):
        raise AssertionError("a dtu_gen step gave a non-finite loss item")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the dtu_gen loss did not fall: {losses}")
    check_gen_cpu(gen.create_gen_state(opt, device=dev), sample, batch, opt,
                  spec)

    ckpt = os.path.join(opt.checkpoints_dir, opt.experiment)
    os.makedirs(ckpt, exist_ok=True)
    path = os.path.join(ckpt, f"{st.step}_gen.npz")
    save_gen_npz(path, st)
    back = load_gen_npz(path, opt, device=dev)
    for a, b in ((st.aggregator, back.aggregator), (st.mvs, back.mvs)):
        for (k, v), w in zip(a.state_dict().items(),
                             b.state_dict().values()):
            if not torch.equal(v, w):
                raise AssertionError(f"{k} differs after the _gen.npz")
    t0 = time.perf_counter()
    res = gen.inference(opt.replace(maximum_step=0), max_images=1,
                        device=dev)
    with open(os.path.join(ckpt, "log.txt")) as f:
        if f"loaded {path}" not in f.read():
            raise AssertionError("inference did not load the _gen.npz")
    log(f"dtu_gen: {os.path.basename(path)} written and read back; "
        f"inference() from it: PSNR {res['psnr']:.3f} over {res['n']} "
        f"image in {time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------------- the evaluation phase
def video_path(root):
    """render_vid on the finetune phase's checkpoint (the plate scene at
    FT_WH, lego widths): the NeRF-Synthetic render split's VIDEO_FRAMES
    poses through render_image, the frames as PNGs and an animated GIF
    (counts reset just before, read just after: K1 and K3 must launch).
    The GIF must decode to every frame, each within the palette bound of
    its PNG. Returns the launch counts."""
    from pointnerf_tpu_torch.ops import kernels
    from pointnerf_tpu_torch.run import render_vid
    from pointnerf_tpu_torch.utils.gif import QUANT_BOUND, read_gif
    from pointnerf_tpu_torch.utils.png import read_png
    opt = finetune_options(root)
    for k in kernels.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = render_vid.main(opt)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    check_launches("render_vid", (kernels.TRUNK_FWD, kernels.OCCUPANCY))
    t0 = time.perf_counter()
    frames = read_gif(res["video"])
    read_s = time.perf_counter() - t0
    size = os.path.getsize(res["video"])
    frame_dir = os.path.join(opt.checkpoints_dir, opt.experiment, "images",
                             f"vid_{FT_STEPS}")
    err = max(int(np.abs(f.astype(int) - read_png(os.path.join(
        frame_dir, f"step-{i:04d}-coarse_raycolor.png")).astype(int)).max())
        for i, f in enumerate(frames))
    log(f"render_vid: {res['n_frames']} frames {FT_WH}x{FT_WH} in "
        f"{wall:.1f} s ({1e3 * wall / res['n_frames']:.1f} ms a frame with "
        f"its PNG and the GIF's share), GIF {size} bytes, decoded "
        f"{len(frames)} frames in {read_s:.2f} s, max palette error {err} "
        f"levels (bound {QUANT_BOUND}); peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{launches}")
    if res["n_frames"] != VIDEO_FRAMES or len(frames) != VIDEO_FRAMES:
        raise AssertionError(f"the video holds {len(frames)} frames, not "
                             f"{VIDEO_FRAMES}")
    if size <= 1000 or err > QUANT_BOUND:
        raise AssertionError(f"the GIF ({size} bytes) is too small or off "
                             f"its frames by {err} levels")
    return launches


def dtu_ft_options(root, **kw):
    """dtu_ft_preset("scan1") at its widths (640x512, vox_res 320, SR 40,
    K 8, P 16, point_features_dim 32, load_points 0 with its MVS init over
    128 depth planes, bgmodel plane) on the DTU-layout plate scene, with
    the cuts DTU_CONF_THRESH, DTU_GEO_CNSST, DTU_FT_TEST_STEP and
    DTU_RANGES, and DTU_FT_STEPS steps (the preset's prune and probe come
    at 10001). The ranges: random-weight depths spread over the views'
    frusta, and at the preset's ±100 the cloud's grid held 973 x 898 x 532
    voxels, the phase peaked at 14.7 GiB and took 82 s, most of it in the
    CPU re-render's grid; the plane points' 10 x 10 span passes a 32-bit
    grid index there (2503 x 2503 x 532 voxels)."""
    from pointnerf_tpu_torch.config import dtu_ft_preset
    return dtu_ft_preset("scan1").replace(
        data_root=root, depth_conf_thresh=DTU_CONF_THRESH,
        geo_cnsst_num=DTU_GEO_CNSST, test_num_step=DTU_FT_TEST_STEP,
        ranges=DTU_RANGES,
        checkpoints_dir=os.path.join(root, "checkpoints"),
        experiment="dtu_ft_smoke", maximum_step=DTU_FT_STEPS,
        print_freq=100, save_iter_freq=10 * DTU_FT_STEPS, save_point_freq=0,
        test_freq=0).replace(**kw)


def check_resize(root):
    """View 0's Rectified image written at RESIZE_WH and read by dtu_ft at
    DTU_WH, through the port's resampler (Pillow's BILINEAR; the GPU
    machine has no Pillow): its pixels and the resized ones must hash to
    RESIZE_IN_SHA and RESIZE_OUT_SHA."""
    import hashlib
    from pointnerf_tpu_torch.data import create_dataset
    from pointnerf_tpu_torch.data.dtu import read_rgb
    from pointnerf_tpu_torch.run.workload import make_dtu_scene
    make_dtu_scene(root, n_views=1, wh=DTU_WH, image_wh=RESIZE_WH)
    src = read_rgb(os.path.join(root, "Rectified/scan1_train/"
                                "rect_001_3_r5000.png"))
    t0 = time.perf_counter()
    img = create_dataset(dtu_ft_options(root), "test").render_gtimgs[0]
    dt = time.perf_counter() - t0
    out = np.round(img * 255.0).astype(np.uint8)
    got_in = hashlib.sha256(src.tobytes()).hexdigest()
    got_out = hashlib.sha256(out.tobytes()).hexdigest()
    log(f"resampler: {RESIZE_WH[0]}x{RESIZE_WH[1]} -> {DTU_WH[0]}x"
        f"{DTU_WH[1]} BILINEAR: the test split read in {1e3 * dt:.1f} ms "
        f"(host: cameras, PNG decode, resize); input sha256 {got_in[:16]}.. "
        f"(want {RESIZE_IN_SHA[:16]}..), output {got_out[:16]}.. (want "
        f"Pillow's {RESIZE_OUT_SHA[:16]}..)")
    if got_in != RESIZE_IN_SHA:
        raise AssertionError("the plate image written at 800x640 differs "
                             "from the one Pillow's digest was taken on")
    if out.shape != (DTU_WH[1], DTU_WH[0], 3) or got_out != RESIZE_OUT_SHA:
        raise AssertionError("the resampler's 640x512 image differs from "
                             "Pillow's")


def dtu_ft_path(root, smi: str):
    """The DTU per-scene finetune on the card (dtu_ft_preset, bgmodel
    plane) on a 640x512 DTU-layout plate scene with DTU_FT_PLANE as its
    back plane: the MVS init and the plane background's precompute, each
    timed, the PSNR of a test render of the initial cloud with its maps,
    then train_ft.main for DTU_FT_STEPS steps (the counts reset just before
    and read just after: K1, K2, K3 and K6 must launch), whose test PSNR
    must pass the initial one; two chunks of one held-out view rendered
    again on the CPU from the checkpoint, bg_ray included (within
    TT_CPU_TOL); a planepoints run of DTU_FT_PP_STEPS steps (the same
    kernels); and the resampler's check. Returns the two runs' launch
    counts."""
    import pointnerf_tpu_torch.data.dtu_ft as dtu_ft
    from pointnerf_tpu_torch.data import create_dataset
    from pointnerf_tpu_torch.ops import kernels
    from pointnerf_tpu_torch.run import common, train_ft
    from pointnerf_tpu_torch.run.workload import make_dtu_scene
    from pointnerf_tpu_torch.train import trainer
    from pointnerf_tpu_torch.utils.checkpoint import load_checkpoint
    from pointnerf_tpu_torch.utils.visualizer import Visualizer
    phase0 = time.perf_counter()
    t0 = time.perf_counter()
    make_dtu_scene(root, n_views=DTU_VIEWS, wh=DTU_WH)
    dtu_ft.PLANE_PARAMS[0] = DTU_FT_PLANE
    opt = dtu_ft_options(root)
    dev = torch.device("cuda")
    train_ds = create_dataset(opt, "train")
    test_ds = create_dataset(opt, "test")
    log(f"dtu_ft: plate scene {DTU_WH[0]}x{DTU_WH[1]}, {len(train_ds)} "
        f"train / {len(test_ds)} test views, init bundles "
        f"{train_ds.view_id_list}, plane_ind {train_ds.plane_ind}: written "
        f"and read in {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train_ft.initial_points(opt, train_ds, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_init = int(state["mask"].sum())
    vis = Visualizer(opt)
    torch.cuda.synchronize()
    bg_train, bg_test, bg_s = train_ft.plane_background(
        opt, train_ds, test_ds, state, dev, vis)
    set_share = [float((m.max(-1) > 0).mean()) for m in bg_test]
    st = trainer.create_train_state(opt, state,
                                    torch.Generator().manual_seed(opt.seed))
    spec, grid = common.make_spec_and_grid(opt, state)
    psnr0 = train_ft.test(st, grid, opt, spec, test_ds, vis, 0,
                          write_images=False, bg_maps=bg_test)
    log(f"dtu_ft: MVS init (D {opt.depth_grid}, {len(train_ds.view_id_list)}"
        f" bundles) {init_s:.2f} s, {n_init} points; plane background "
        f"precompute {bg_s:.2f} s for {len(bg_train)} train + "
        f"{len(bg_test)} test frames of {DTU_WH[0]}x{DTU_WH[1]} x "
        f"{len(train_ds.view_id_list)} views (host projections and masks, "
        f"colours sampled on the card), map share set "
        f"{[round(v, 4) for v in set_share]}; test PSNR before training "
        f"{psnr0:.3f}; peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB; {smi}")
    if not all(0.0 < v < 1.0 for v in set_share):
        raise AssertionError(f"the test background maps are set on "
                             f"{set_share} of their pixels")
    del st, state, grid, bg_train
    torch.cuda.empty_cache()

    for k in kernels.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train_ft.main(opt)
    wall = time.perf_counter() - t0
    ft = {k.name: k.launches for k in kernels.KERNELS}
    tm = res["timing"]
    R = opt.random_sample_size ** 2
    n_pts = int(res["state"].points["mask"].sum())
    log(f"dtu_ft finetune (bgmodel plane): {n_pts} points, grid "
        f"{res['spec'].vdim}; {tm['steps']} steps, "
        f"{1e3 * tm['train_s'] / tm['steps']:.1f} ms/step ({R} rays a step),"
        f" wall {wall:.1f} s (plane background {tm['bg_s']:.1f} s, test "
        f"renders {tm['test_s']:.1f} s, checkpoints {tm['save_s']:.1f} s, "
        f"the MVS init and the rest "
        f"{wall - sum(tm[k] for k in PHASES) - tm['bg_s']:.1f} s); final "
        f"test PSNR {res['final_psnr']:.3f} (before training {psnr0:.3f}); "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches"
        f" {ft}; {smi}")
    check_launches("dtu_ft finetune", (kernels.TRUNK_FWD, kernels.TRUNK_BWD,
                                       kernels.OCCUPANCY,
                                       kernels.SCATTER_ROWS))
    if res["total_steps"] != DTU_FT_STEPS or res["bg_test"] is None:
        raise AssertionError("the dtu_ft finetune did not run its steps "
                             "with a plane background")
    if not res["final_psnr"] > psnr0:
        raise AssertionError(f"final test PSNR {res['final_psnr']:.3f} not "
                             f"above the initial {psnr0:.3f}")

    # one held-out view rendered again with its bg_ray; two of its chunks
    # on the CPU from the same checkpoint
    bg_test = res["bg_test"]
    del res
    torch.cuda.empty_cache()
    ckpt = os.path.join(opt.checkpoints_dir, opt.experiment)
    ts, _ = load_checkpoint(ckpt, opt, device="cuda")
    spec, grid = common.make_spec_and_grid(opt, ts.points)
    item = train_ft.with_bg_ray(test_ds.get_item(0, full_img=True),
                                bg_test[0])
    counts = [k.launches for k in kernels.KERNELS]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    maps = common.render_image(ts, grid, opt, spec, item)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for k, c in zip(kernels.KERNELS, counts):
        k.launches = c
    W, H = DTU_WH
    rgb, hit = maps["coarse_raycolor"], maps["ray_mask"][..., 0] > 0.5
    chunk = opt.random_sample_size ** 2
    per_chunk = hit.reshape(-1)[: (H * W // chunk) * chunk].reshape(-1, chunk)
    # the two chunks with the most hits and the most background
    bg_rays = (bg_test[0].max(-1) > 0).reshape(-1)[
        : (H * W // chunk) * chunk].reshape(-1, chunk)
    pick = sorted({int(np.argmax(per_chunk.sum(1))),
                   int(np.argmax(bg_rays.sum(1) - per_chunk.sum(1)))})
    sel = np.concatenate([np.arange(c * chunk, (c + 1) * chunk) for c in pick])
    sub = dict(item, raydir=item["raydir"][:, sel],
               pixel_idx=item["pixel_idx"][:, sel],
               bg_ray=item["bg_ray"][:, sel])
    sub.pop("gt_image", None)
    t0 = time.perf_counter()
    cpu_ts, _ = load_checkpoint(ckpt, opt, device="cpu")
    _, cpu_grid = common.make_spec_and_grid(opt, cpu_ts.points)
    cpu = common.render_image(cpu_ts, cpu_grid, opt.replace(use_fused_trunk=1),
                              spec, sub)
    px, py = sub["pixel_idx"][0, :, 0].astype(int), \
        sub["pixel_idx"][0, :, 1].astype(int)
    np.testing.assert_array_equal(cpu["ray_mask"][py, px],
                                  maps["ray_mask"][py, px])
    np.testing.assert_allclose(cpu["coarse_raycolor"][py, px], rgb[py, px],
                               **TT_CPU_TOL)
    n_bg = int((sub["bg_ray"][0].max(-1) > 0).sum())
    err = float(np.abs(cpu["coarse_raycolor"][py, px] - rgb[py, px]).max())
    log(f"dtu_ft render {W}x{H} with bg_ray: {1e3 * dt:.1f} ms/image, hit "
        f"share {hit.mean():.4f}; CPU re-render of chunks {pick} ({len(sel)}"
        f" rays, {int(hit.reshape(-1)[sel].sum())} hit, {n_bg} with a "
        f"background colour) from the same checkpoint: max_abs_err "
        f"{err:.3e}"
        f" in {time.perf_counter() - t0:.1f} s (the checkpoint's load and the"
        f" grid's build on the CPU included)")
    if n_bg == 0 or not 0.0 < hit.mean() < 1.0:
        raise AssertionError("the re-rendered chunks hold no background "
                             "rays, or the view no hits and misses")
    del ts, grid, cpu_ts, cpu_grid, maps, cpu
    torch.cuda.empty_cache()

    # planepoints: the plane's points join the MVS cloud
    pp_opt = opt.replace(bgmodel="planepoints", maximum_step=DTU_FT_PP_STEPS,
                         experiment="dtu_ft_planepoints")
    for k in kernels.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train_ft.main(pp_opt)
    wall = time.perf_counter() - t0
    pp = {k.name: k.launches for k in kernels.KERNELS}
    tm = res["timing"]
    n_pts = int(res["state"].points["mask"].sum())
    log(f"dtu_ft planepoints: {tm['plane_points']} "
        f"plane points added ({n_pts - tm['plane_points']} from the MVS "
        f"init, {n_pts} in all), grid {res['spec'].vdim}, {tm['steps']} steps,"
        f" {1e3 * tm['train_s'] / tm['steps']:.1f} ms/step, wall {wall:.1f}"
        f" s, final test PSNR {res['final_psnr']:.3f}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {pp}")
    check_launches("dtu_ft planepoints", (kernels.TRUNK_FWD,
                                          kernels.TRUNK_BWD,
                                          kernels.OCCUPANCY,
                                          kernels.SCATTER_ROWS))
    if tm["plane_points"] != 8000 or n_pts <= 8000 or \
            res["total_steps"] != DTU_FT_PP_STEPS or \
            not np.isfinite(res["final_psnr"]):
        raise AssertionError("the planepoints run did not add the 8000 "
                             "plane points and train")
    del res
    torch.cuda.empty_cache()
    check_resize(os.path.join(root, "resize"))
    log(f"dtu_ft phase: {time.perf_counter() - phase0:.1f} s")
    return ft, pp


# ------------------------------------------------------- the ScanNet phase
def codec_frame():
    """A fixed 1296x968 colour frame from integers only (a ramp, a
    checkerboard and RandomState noise), so its bytes are the same on every
    machine."""
    W, H = SCANNET_COLOR_WH
    y, x = np.mgrid[0:H, 0:W]
    noise = np.random.RandomState(12).randint(-24, 25, (H, W, 3))
    base = np.stack([x * 255 // (W - 1), y * 255 // (H - 1),
                     (x // 16 + y // 16) % 2 * 128 + 64], -1)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def depth_frame():
    """A fixed 640x480 16-bit depth map in millimetres, from integers."""
    W, H = SCANNET_DEPTH_WH
    y, x = np.mgrid[0:H, 0:W]
    return (300 + x * 11 + y * 7 + np.random.RandomState(13).randint(
        0, 50, (H, W))).astype(np.uint16)


def check_image_io(root):
    """The port's image I/O on the host against digests frozen from Pillow
    and cv2 (the GPU machine has neither): write_jpeg's bytes for
    codec_frame and the decoder's pixels for them, timed; depth_frame's
    16-bit PNG round trip and cv2's nearest resize of it in metres; and the
    frame's blur score (BGR2GRAY, Laplacian variance). Returns the decode's
    ms per frame."""
    import hashlib
    from pointnerf_tpu_torch.utils import cvimg, jpeg, png
    sha = lambda b: hashlib.sha256(b).hexdigest()
    frame = codec_frame()
    t0 = time.perf_counter()
    data = jpeg.encode_jpeg(frame, 75)
    enc_ms = 1e3 * (time.perf_counter() - t0)
    dec_ms = []
    for _ in range(SCANNET_DECODES):
        t0 = time.perf_counter()
        rgb = jpeg.decode_jpeg(data)
        dec_ms.append(1e3 * (time.perf_counter() - t0))
    t0 = time.perf_counter()
    blur = cvimg.laplacian_var(cvimg.bgr2gray(rgb[..., ::-1]))
    blur_ms = 1e3 * (time.perf_counter() - t0)
    got = {"frame": sha(frame.tobytes()), "jpeg": sha(data),
           "decode": sha(rgb.tobytes())}
    want = {"frame": SCANNET_FRAME_SHA, "jpeg": SCANNET_JPEG_SHA,
            "decode": SCANNET_DECODE_SHA}
    W, H = SCANNET_COLOR_WH
    log(f"scannet JPEG: codec_frame {W}x{H} (4:2:0, q75, {len(data)} bytes)"
        f" encoded in {enc_ms:.1f} ms, decoded in "
        f"{[round(v, 1) for v in dec_ms]} ms (host, one thread); blur score"
        f" {blur!r} in {blur_ms:.1f} ms; sha256 frame {got['frame'][:16]}.."
        f", bytes {got['jpeg'][:16]}.., decode {got['decode'][:16]}.. (want"
        f" {SCANNET_FRAME_SHA[:16]}.., {SCANNET_JPEG_SHA[:16]}.., Pillow's "
        f"{SCANNET_DECODE_SHA[:16]}..)")
    for k in got:
        if got[k] != want[k]:
            raise AssertionError(f"the JPEG check's {k} digest differs from "
                                 f"the frozen one")
    depth = depth_frame()
    path = os.path.join(root, "depth.png")
    t0 = time.perf_counter()
    png.write_png(path, depth)
    back = png.read_png(path)
    png_ms = 1e3 * (time.perf_counter() - t0)
    metres = back.astype(np.float32) / 1000.0
    t0 = time.perf_counter()
    up = cvimg.resize_nearest(metres, SCANNET_COLOR_WH)
    down = cvimg.resize_nearest(metres, (333, 211))
    near_ms = 1e3 * (time.perf_counter() - t0)
    got = {"depth": sha(back.tobytes()), "up": sha(up.tobytes()),
           "down": sha(down.tobytes())}
    want = {"depth": SCANNET_DEPTH_SHA, "up": SCANNET_UP_SHA,
            "down": SCANNET_DOWN_SHA}
    log(f"scannet 16-bit PNG {depth.shape[1]}x{depth.shape[0]} written and "
        f"read in {png_ms:.1f} ms ({back.dtype}); nearest resizes to "
        f"{W}x{H} and 333x211 in {near_ms:.1f} ms; sha256 "
        f"{ {k: v[:16] for k, v in got.items()} } (want cv2's "
        f"{ {k: v[:16] for k, v in want.items()} })")
    if back.dtype != np.uint16 or not np.array_equal(back, depth):
        raise AssertionError("the 16-bit PNG does not read back")
    for k in got:
        if got[k] != want[k]:
            raise AssertionError(f"the {k} digest differs from cv2's")
    return min(dec_ms)


# ---------------------------------- shared by the scene finetune phases
class StepItems:
    """Within the block, the sum of every train_step's sr_overflow (the
    query's and the shade-side compaction's dropped rows), each step's
    loss_total and the step count, from the items the driver fetches
    anyway."""

    def __enter__(self):
        from pointnerf_tpu_torch.train import trainer
        self.trainer, self.step = trainer, trainer.train_step
        self.sr_overflow, self.steps = 0, 0

        self.losses = []

        def spy(*a, **kw):
            ts, items = self.step(*a, **kw)
            self.sr_overflow += int(float(items["sr_overflow"]))
            self.losses.append(float(items["loss_total"]))
            self.steps += 1
            return ts, items
        trainer.train_step = spy
        return self

    def __exit__(self, *exc):
        self.trainer.train_step = self.step


def chunks_vs_cpu(label, ckpt, opt, item, tol=TT_CPU_TOL, n_chunks=2):
    """The checkpoint on the card: a timed render of the full view, then
    n_chunks of its chunks (one with hits and misses, and with two the one
    with the most hits) rendered again on the CPU from the same checkpoint
    with the kernels' plain versions; ray_mask equal, colours within
    `tol`. Launches made here are put back. Returns (ms per image,
    max_abs_err, hit share, the render's counters)."""
    from pointnerf_tpu_torch.ops.trunk import fused_trunk_ok
    from pointnerf_tpu_torch.ops import kernels
    from pointnerf_tpu_torch.run import common
    from pointnerf_tpu_torch.utils.checkpoint import load_checkpoint
    counts = [k.launches for k in kernels.KERNELS]
    ts, _ = load_checkpoint(ckpt, opt, device="cuda")
    spec, grid = common.make_spec_and_grid(opt, ts.points)
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    maps = common.render_image(ts, grid, opt, spec, item, stats=stats)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for k, c in zip(kernels.KERNELS, counts):
        k.launches = c
    Hi, Wi = int(item["h"]), int(item["w"])
    rgb, hit = maps["coarse_raycolor"], maps["ray_mask"][..., 0] > 0.5
    chunk = opt.random_sample_size ** 2
    per_chunk = hit.reshape(-1)[: (Hi * Wi // chunk) * chunk].reshape(
        -1, chunk).sum(1)
    mixed = int(np.argmin(np.abs(per_chunk - chunk / 2)))
    pick = sorted({int(np.argmax(per_chunk)), mixed}) if n_chunks == 2 \
        else [mixed]
    sel = np.concatenate([np.arange(c * chunk, (c + 1) * chunk)
                          for c in pick])
    sub = dict(item, raydir=item["raydir"][:, sel],
               pixel_idx=item["pixel_idx"][:, sel])
    sub.pop("gt_image", None)
    t0 = time.perf_counter()
    cpu_ts, _ = load_checkpoint(ckpt, opt, device="cpu")
    _, cpu_grid = common.make_spec_and_grid(opt, cpu_ts.points)
    # the CPU runs K1's plain version where the card runs K1
    cpu = common.render_image(
        cpu_ts, cpu_grid, opt.replace(use_fused_trunk=int(fused_trunk_ok(
            opt))), spec, sub)
    px, py = sub["pixel_idx"][0, :, 0].astype(int), \
        sub["pixel_idx"][0, :, 1].astype(int)
    np.testing.assert_array_equal(cpu["ray_mask"][py, px],
                                  maps["ray_mask"][py, px])
    np.testing.assert_allclose(cpu["coarse_raycolor"][py, px], rgb[py, px],
                               **tol)
    err = float(np.abs(cpu["coarse_raycolor"][py, px] - rgb[py, px]).max())
    log(f"{label} render {Wi}x{Hi}: {1e3 * dt:.1f} ms/image, hit share "
        f"{hit.mean():.4f}, sr_overflow {stats.get('sr_overflow')}, "
        f"occ_overflow {stats.get('occ_overflow')}; CPU re-render of chunks "
        f"{pick} ({len(sel)} rays, {int(hit.reshape(-1)[sel].sum())} hit) "
        f"from the same checkpoint: max_abs_err {err:.3e} in "
        f"{time.perf_counter() - t0:.1f} s")
    if not 0.0 < hit.mean() < 1.0:
        raise AssertionError(f"{label}: the view has no hits and misses")
    del ts, grid, cpu_ts, cpu_grid
    torch.cuda.empty_cache()
    return 1e3 * dt, err, float(hit.mean()), stats


def finetune_run(label, opt, kerns, losses=None):
    """train_ft.main with the counts set to 0 just before and read just
    after, its train steps' sr_overflow summed (and each step's loss_total
    appended to `losses`); every kernel of `kerns` must launch. Returns
    (the result, its launches, wall seconds, the steps' sr_overflow, peak
    GiB)."""
    from pointnerf_tpu_torch.ops import kernels
    from pointnerf_tpu_torch.run import train_ft
    for k in kernels.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with StepItems() as steps:
        res = train_ft.main(opt)
    wall = time.perf_counter() - t0
    if losses is not None:
        losses += steps.losses
    launches = {k.name: k.launches for k in kernels.KERNELS}
    check_launches(label, kerns)
    tm = res["timing"]
    if res["total_steps"] != opt.maximum_step or tm["steps"] != steps.steps:
        raise AssertionError(f"{label} did not run its steps")
    if not np.isfinite(res["final_psnr"]):
        raise AssertionError(f"{label}: final PSNR {res['final_psnr']}")
    return res, launches, wall, steps.sr_overflow, \
        torch.cuda.max_memory_allocated() / 2**30


def start_psnr(opt, train_ds, test_ds, n_views):
    """The starting cloud's test PSNR over n_views views (seeded weights,
    as main makes them), the cloud's size, and the grid's spec, build ms
    and table."""
    from pointnerf_tpu_torch.run import common, train_ft
    from pointnerf_tpu_torch.train import trainer
    from pointnerf_tpu_torch.utils.visualizer import Visualizer
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = train_ft.initial_points(opt, train_ds, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    spec, grid = common.make_spec_and_grid(opt, state)
    torch.cuda.synchronize()
    grid_ms = 1e3 * (time.perf_counter() - t0)
    st = trainer.create_train_state(opt, state,
                                    torch.Generator().manual_seed(opt.seed))
    psnr0 = train_ft.test(st, grid, opt, spec, test_ds, Visualizer(opt), 0,
                          write_images=False, max_images=n_views)
    return dict(st=st, spec=spec, grid=grid, init_s=init_s, grid_ms=grid_ms,
                psnr0=psnr0, n=int(state["mask"].sum()))


def scannet_options(root, **kw):
    """scannet_preset("scene0241_01") at its widths (640x480, vox_res 900,
    vsize 0.008, vscale 2, kernel and query 3³, SR 24, K 8, P 26, max_o
    610,000, 56² rays, 32-wide points with colour, direction and
    confidence, load_points 2, bg white) with SCANNET_STEPS steps, a
    probe-and-grow at SCANNET_PROBE (the preset's two tiers), and
    SCANNET_TEST_VIEWS test renders."""
    from pointnerf_tpu_torch.config import scannet_preset
    return scannet_preset(SCANNET_SCAN).replace(
        data_root=root, checkpoints_dir=os.path.join(root, "checkpoints"),
        experiment="scannet_smoke", maximum_step=SCANNET_STEPS,
        prob_freq=SCANNET_PROBE, test_num=SCANNET_TEST_VIEWS,
        print_freq=100, save_iter_freq=10 * SCANNET_STEPS, save_point_freq=0,
        test_freq=0).replace(**kw)


def scannet_path(root, smi: str):
    """The ScanNet finetune on the card (scannet_preset, load_points 2) on
    a plate scene in ScanNet's exported/ layout at the sensors' sizes
    (run/workload.make_scannet_scene: 1296x968 JPEG colour, 640x480 16-bit
    depth): the image I/O's checks; the datasets' reads and the depth
    back-projection, timed; the PSNR of the initial cloud's test renders;
    train_ft.main for SCANNET_STEPS steps (the counts reset just before
    and read just after: K1, K2, K3 and K6 must launch, a probe must run),
    whose test PSNR must pass the initial one; two chunks of a test view
    rendered again on the CPU from the checkpoint (within TT_CPU_TOL); then
    load_points 3 for SCANNET_LP3_STEPS steps on a scene of
    SCANNET_LP3_FRAMES frames. Returns the decode's ms per
    frame and the two runs' launch counts."""
    from pointnerf_tpu_torch.data import create_dataset
    from pointnerf_tpu_torch.ops import kernels
    from pointnerf_tpu_torch.run import common, train_ft
    from pointnerf_tpu_torch.run.workload import make_scannet_scene
    from pointnerf_tpu_torch.utils.checkpoint import load_checkpoint
    from pointnerf_tpu_torch.utils.visualizer import Visualizer
    phase0 = time.perf_counter()
    dec_ms = check_image_io(root)
    t0 = time.perf_counter()
    make_scannet_scene(root, SCANNET_SCAN, n=SCANNET_FRAMES,
                       wh=SCANNET_COLOR_WH, depth_wh=SCANNET_DEPTH_WH,
                       half=SCANNET_HALF, radius=SCANNET_RADIUS,
                       side=SCANNET_SIDE, hole=SCANNET_HOLE)
    write_s = time.perf_counter() - t0
    opt = scannet_options(root)
    t0 = time.perf_counter()
    train_ds = create_dataset(opt, "train")
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    test_ds = create_dataset(opt, "test")
    test_s = time.perf_counter() - t0
    stats = {}
    t0 = time.perf_counter()
    depth_pts = train_ds.load_init_depth_points(vox_res=100, stats=stats)
    back_s = time.perf_counter() - t0
    per = stats["n_frame"]
    W, H = SCANNET_COLOR_WH
    log(f"scannet: scene of {SCANNET_FRAMES} frames ({W}x{H} JPEG, "
        f"{SCANNET_DEPTH_WH[0]}x{SCANNET_DEPTH_WH[1]} depth) written in "
        f"{write_s:.1f} s; train split ({len(train_ds)} frames) read in "
        f"{train_s:.2f} s, test split ({len(test_ds)}) in {test_s:.2f} s "
        f"(host: decode, LANCZOS to {opt.img_wh[0]}x{opt.img_wh[1]}); depth "
        f"back-projection of {stats['frames']} frames in {back_s:.2f} s: "
        f"{min(per)}-{max(per)} points a frame after its vox_res-100 "
        f"downsample, {stats['n_points']} in all, {len(depth_pts)} after "
        f"the ranges crop")
    torch.cuda.reset_peak_memory_stats()
    s0 = start_psnr(opt, train_ds, test_ds, SCANNET_TEST_VIEWS)
    psnr0, n_init = s0["psnr0"], s0["n"]
    log(f"scannet: load_points 2 init {s0['init_s']:.2f} s, {n_init} points"
        f" after vox_res {opt.vox_res}; grid {s0['spec'].vdim} built in "
        f"{s0['grid_ms']:.1f} ms, {int(s0['grid']['num_occ'])} occupied "
        f"voxels; test PSNR before training {psnr0:.3f} "
        f"({SCANNET_TEST_VIEWS} views); peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")
    if n_init < SCANNET_MIN_POINTS:
        raise AssertionError(f"the sensor-depth cloud has {n_init} points")
    del s0, train_ds
    torch.cuda.empty_cache()

    res, ft, wall, _, peak = finetune_run(
        "scannet finetune", opt, (kernels.TRUNK_FWD, kernels.TRUNK_BWD,
                                  kernels.OCCUPANCY, kernels.SCATTER_ROWS))
    tm = res["timing"]
    R = opt.random_sample_size ** 2
    n_pts = int(res["state"].points["mask"].sum())
    log(f"scannet finetune (load_points 2): {n_pts} points, grid "
        f"{res['spec'].vdim}; {tm['steps']} steps, "
        f"{1e3 * tm['train_s'] / tm['steps']:.1f} ms/step ({R} rays a step),"
        f" wall {wall:.1f} s (probe-and-grow {tm['grow_s']:.1f} s, grow "
        f"{tm['grow']}, test renders {tm['test_s']:.1f} s, checkpoints "
        f"{tm['save_s']:.1f} s, datasets, init and the rest "
        f"{wall - sum(tm[k] for k in PHASES):.1f} s); final test PSNR "
        f"{res['final_psnr']:.3f} over {len(test_ds)} views; peak "
        f"{peak:.2f} GiB; launches {ft}; {smi}")
    if not tm["grow_s"] > 0:
        raise AssertionError("the scannet finetune ran no probe")
    final_all = res["final_psnr"]
    del res
    torch.cuda.empty_cache()

    # the test PSNR of the same views after training, then two chunks of a
    # test view on the CPU from the same checkpoint
    ckpt = os.path.join(opt.checkpoints_dir, opt.experiment)
    ts, _ = load_checkpoint(ckpt, opt, device="cuda")
    spec, grid = common.make_spec_and_grid(opt, ts.points)
    psnr1 = train_ft.test(ts, grid, opt, spec, test_ds, Visualizer(opt),
                          SCANNET_STEPS, write_images=False,
                          max_images=SCANNET_TEST_VIEWS)
    log(f"scannet: test PSNR on the {SCANNET_TEST_VIEWS} views {psnr0:.3f} "
        f"before and {psnr1:.3f} after {SCANNET_STEPS} steps (all "
        f"{len(test_ds)} test views after: {final_all:.3f})")
    if not psnr1 > psnr0:
        raise AssertionError(f"test PSNR {psnr1:.3f} after training not "
                             f"above the initial {psnr0:.3f}")
    del ts, grid
    torch.cuda.empty_cache()
    chunks_vs_cpu("scannet", ckpt, opt, test_ds.get_item(0, full_img=True),
                  n_chunks=1)

    # load_points 3 on a scene of SCANNET_LP3_FRAMES frames: the mesh
    # points and the depth points in its empty voxels
    lp3_root = os.path.join(root, "lp3")
    make_scannet_scene(lp3_root, SCANNET_SCAN, n=SCANNET_LP3_FRAMES,
                       wh=SCANNET_COLOR_WH, depth_wh=SCANNET_DEPTH_WH,
                       half=SCANNET_HALF, radius=SCANNET_RADIUS,
                       side=SCANNET_SIDE, hole=SCANNET_HOLE)
    lp3 = opt.replace(data_root=lp3_root, load_points=3,
                      maximum_step=SCANNET_LP3_STEPS,
                      experiment="scannet_lp3", prob_freq=0)
    ds = create_dataset(lp3, "train")
    mesh = ds.load_init_points()
    t0 = time.perf_counter()
    kept = common.filter_depth_by_pc_occupancy(
        mesh, ds.load_init_depth_points(vox_res=80), filter_res=100)
    filt_s = time.perf_counter() - t0
    del ds
    res, l3, wall, _, peak = finetune_run(
        "scannet load_points 3", lp3, (kernels.TRUNK_FWD, kernels.TRUNK_BWD,
                                       kernels.OCCUPANCY,
                                       kernels.SCATTER_ROWS))
    n3 = int(res["state"].points["mask"].sum())
    log(f"scannet load_points 3 ({SCANNET_LP3_FRAMES} frames): {len(mesh)} "
        f"mesh points, {len(kept)} depth"
        f" points in voxels the mesh leaves empty (back-projection and "
        f"filter {filt_s:.2f} s), {n3} merged after the per-source "
        f"downsample; {res['timing']['steps']} steps in {wall:.1f} s, final"
        f" test PSNR {res['final_psnr']:.3f}; peak {peak:.2f} GiB; launches "
        f"{l3}")
    if len(kept) == 0 or not len(mesh) < n3 <= len(mesh) + len(kept):
        raise AssertionError("the load_points 3 run did not merge the two "
                             "clouds and train")
    del res
    torch.cuda.empty_cache()
    log(f"scannet phase: {time.perf_counter() - phase0:.1f} s")
    return dec_ms, ft, l3


# ------------------------------------- the vox-grid, LLFF and legacy phases
def full_cell_share(st, grid, spec, opt, item):
    """Over every ray of a full view (in groups of GROUP chunks): the
    occupancy-selected shading samples (positions off the origin, where
    the query parks empty slots), the share of them whose lattice cell
    has all 8 corners, the empty slots that the corner query gives a full
    cell anyway (the origin's, as JAX's query does), and the query's
    q_overflow. Launches made here are put back."""
    from pointnerf_tpu_torch.models.renderer import render_query
    from pointnerf_tpu_torch.ops import kernels
    from pointnerf_tpu_torch.train import trainer
    counts = [k.launches for k in kernels.KERNELS]
    ps = trainer.point_state_of(st)
    dev = torch.device("cuda")
    R = item["raydir"].shape[1]
    step = GROUP * opt.random_sample_size ** 2
    sel = full = origin = q_over = 0
    with torch.inference_mode():
        for s in range(0, R, step):
            batch = {"raydir": torch.as_tensor(item["raydir"][:, s:s + step],
                                               device=dev),
                     "campos": torch.as_tensor(item["campos"], device=dev),
                     "camrotc2w": torch.as_tensor(item["camrotc2w"],
                                                  device=dev),
                     "near": float(item["near"]), "far": float(item["far"])}
            q = render_query(ps, grid, spec, opt, batch)
            on = torch.any(q.sample_loc_w != 0, dim=-1)
            cell = torch.all(q.sample_pidx >= 0, dim=-1)
            sel += int(on.sum())
            full += int((on & cell).sum())
            origin += int((~on & cell).sum())
            q_over += int(q.q_overflow)
    for k, c in zip(kernels.KERNELS, counts):
        k.launches = c
    return sel, full, origin, q_over


def voxgrid_options(root, cpath):
    """The lego preset's widths (32-wide points, the 256-wide trunk, K 8,
    SR 80, 400 depth samples, auto SR_budget) with the vox-grid querier:
    NN -1 from the pickled cloud (num_point, point_noise, construct_res
    and grid_res of VOX_*), the trilinear kernel without a second
    normalisation, frozen positions, and k_tier 0 (every row of the
    8-corner query fills its 8 slots, so K-tiering's narrow tier would
    stay empty and its wide tier's quarter budget drop rows); VOX_STEPS
    steps, one prune at VOX_PRUNE, the checkpoint at the end, no probe (it
    refuses NN -1); the scene has VOX_TEST_VIEWS test views."""
    from pointnerf_tpu_torch.config import nerf_synth_preset
    return nerf_synth_preset("lego").replace(
        data_root=root, scan="plate", img_wh=(VOX_WH, VOX_WH), load_points=1,
        cloud_path=cpath, num_point=VOX_NUM_POINT, point_noise=VOX_NOISE,
        NN=-1, construct_res=VOX_RES[0], grid_res=VOX_RES[1],
        agg_distance_kernel="trilinear", agg_weight_norm=0, xyz_grad=0,
        k_tier=0, checkpoints_dir=os.path.join(root, "checkpoints"),
        experiment="plate_voxgrid", maximum_step=VOX_STEPS,
        prune_iter=VOX_PRUNE, prune_max_iter=VOX_PRUNE, prob_freq=0,
        print_freq=100, save_iter_freq=10 * VOX_STEPS, save_point_freq=0,
        test_freq=0, test_num=VOX_TEST_VIEWS)


def voxgrid_path(root, smi: str):
    """The vox-grid querier on the card: a plate scene at VOX_WH² and a
    pickle of VOX_CLOUD_SIDE² plate samples; the cloud drawn, jittered and
    snapped to the lattice (host), its corner table and grid built, the
    share of shading samples with a full cell, the starting test PSNR;
    train_ft.main for VOX_STEPS steps with a prune (K1, K2, K3, K6), then
    test_ft.main on its checkpoint (K1, K3), whose PSNR must equal the
    driver's final test on the same views and pass the start; two chunks of a test view on
    the CPU from the checkpoint (within TT_CPU_TOL). Returns the two runs'
    launch counts."""
    from pointnerf_tpu_torch.data import create_dataset
    from pointnerf_tpu_torch.data.load_blender import (apply_point_noise,
                                                       load_blender_cloud)
    from pointnerf_tpu_torch.ops import kernels
    from pointnerf_tpu_torch.ops.voxgrid import construct_grid_points
    from pointnerf_tpu_torch.run import test_ft
    from pointnerf_tpu_torch.run.workload import (make_plate_scene,
                                                  write_cloud_pickle)
    phase0 = time.perf_counter()
    make_plate_scene(root, wh=(VOX_WH, VOX_WH), n_test=VOX_TEST_VIEWS)
    cpath = os.path.join(root, "plate_cloud.pkl")
    n_raw = write_cloud_pickle(cpath, side=VOX_CLOUD_SIDE)
    opt = voxgrid_options(root, cpath)
    t0 = time.perf_counter()
    rng = np.random.RandomState(opt.seed)
    drawn, _ = load_blender_cloud(cpath, opt.num_point, rng)
    noisy = apply_point_noise(drawn, opt.point_noise, rng)
    lattice, gvs = construct_grid_points(noisy, *VOX_RES)
    host_s = time.perf_counter() - t0
    train_ds, test_ds = create_dataset(opt, "train"), \
        create_dataset(opt, "test")
    torch.cuda.reset_peak_memory_stats()
    s0 = start_psnr(opt, train_ds, test_ds, VOX_TEST_VIEWS)
    spec, grid = s0["spec"], s0["grid"]
    table = grid["vox_table"]
    sel, full, origin, q_over = full_cell_share(
        s0["st"], grid, spec, opt, test_ds.get_item(0, full_img=True))
    log(f"voxgrid: plate scene {VOX_WH}x{VOX_WH}; pickle {n_raw} samples, "
        f"{len(drawn)} drawn, {len(noisy)} after {opt.point_noise}, "
        f"{len(lattice)} lattice points (construct_res {VOX_RES[0]}, "
        f"grid_res {VOX_RES[1]}, pitch {gvs:.6f}) in {host_s:.2f} s (host); "
        f"init {s0['init_s']:.2f} s, {s0['n']} points; grid {spec.vdim}, "
        f"{int(grid['num_occ'])} occupied voxels, corner table "
        f"{spec.vox_dim} ({table.numel()} corners, "
        f"{int((table >= 0).sum())} held), built in {s0['grid_ms']:.1f} ms;"
        f" a test view's {sel} shading samples: {full} ({full / sel:.4f}) "
        f"in a full cell, {origin} empty slots given the origin's cell, "
        f"q_overflow {q_over}; test PSNR before training "
        f"{s0['psnr0']:.3f} ({VOX_TEST_VIEWS} views); peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")
    if s0["n"] != len(lattice) or not 0 < full < sel:
        raise AssertionError("the lattice or its full cells are off")
    psnr0 = s0["psnr0"]
    del s0, grid, table, train_ds
    torch.cuda.empty_cache()

    res, ft, wall, sr_over, peak = finetune_run(
        "voxgrid finetune", opt, (kernels.TRUNK_FWD, kernels.TRUNK_BWD,
                                  kernels.OCCUPANCY, kernels.SCATTER_ROWS))
    tm = res["timing"]
    log(f"voxgrid finetune: {tm['steps']} steps, "
        f"{1e3 * tm['train_s'] / tm['steps']:.1f} ms/step, wall {wall:.1f} s"
        f" (prune {tm['prune_s']:.2f} s, test renders {tm['test_s']:.1f} s, "
        f"checkpoints {tm['save_s']:.1f} s); prune (step, before, after) "
        f"{tm['prune']}; corner table {res['spec'].vox_dim} kept through "
        f"it; sr_overflow over the steps {sr_over}; final test PSNR "
        f"{res['final_psnr']:.3f}; peak {peak:.2f} GiB; launches {ft}")
    if len(tm["prune"]) != 1:
        raise AssertionError("the voxgrid finetune did not prune once")
    final = res["final_psnr"]
    del res
    torch.cuda.empty_cache()

    ckpt = os.path.join(opt.checkpoints_dir, opt.experiment)
    for k in kernels.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = test_ft.main(opt.replace(resume_dir=ckpt))
    test_s = time.perf_counter() - t0
    tf = {k.name: k.launches for k in kernels.KERNELS}
    check_launches("voxgrid test_ft", (kernels.TRUNK_FWD,
                                       kernels.OCCUPANCY))
    log(f"voxgrid test_ft: step {out['step']}, PSNR {out['psnr']:.3f} "
        f"over {VOX_TEST_VIEWS} views (before training {psnr0:.3f}, the "
        f"driver's final test {final:.3f}) in {test_s:.1f} s; launches {tf}")
    # test_ft re-derives the lattice from the checkpoint's points: the same
    # views render as the driver's last test rendered them
    if out["step"] != VOX_STEPS or not abs(out["psnr"] - final) < 1e-3 \
            or not out["psnr"] > psnr0:
        raise AssertionError(f"test_ft PSNR {out['psnr']:.3f}: the driver's"
                             f" {final:.3f}, the start's {psnr0:.3f}")
    chunks_vs_cpu("voxgrid", ckpt, opt, test_ds.get_item(0, full_img=True))
    log(f"voxgrid phase: {time.perf_counter() - phase0:.1f} s")
    return ft, tf


def llff_options(root):
    """The lego preset's widths on an LLFF scene (dataset_name llff_ft,
    LLFF_WH, load_points 1 from its fused.ply, the hold-out of every
    LLFF_TESTSKIP-th view; no ranges crop: the loader's normalised frame
    is not lego's box): LLFF_STEPS steps, no prune or probe, a checkpoint
    at the end, LLFF_TEST_VIEWS test renders."""
    from pointnerf_tpu_torch.config import nerf_synth_preset
    return nerf_synth_preset("lego").replace(
        dataset_name="llff_ft", data_root=root, scan="fern", img_wh=LLFF_WH,
        load_points=1, testskip=LLFF_TESTSKIP,
        ranges=(-100.0,) * 3 + (100.0,) * 3,
        checkpoints_dir=os.path.join(root, "checkpoints"),
        experiment="fern_llff", maximum_step=LLFF_STEPS, prune_iter=0,
        prob_freq=0, print_freq=100, save_iter_freq=10 * LLFF_STEPS,
        save_point_freq=0, test_freq=0, test_num=LLFF_TEST_VIEWS)


def llff_path(root, smi: str):
    """The LLFF finetune on the card: a plate scene in the LLFF layout
    (run/workload.make_llff_scene, LLFF_VIEWS views at LLFF_WH, LLFF_SIDE²
    fused.ply points), its splits read (host PNG decode), the starting
    test PSNR; train_ft.main for LLFF_STEPS steps (K1, K2, K3, K6) whose
    test PSNR must pass the start; two chunks of a test view on the CPU;
    render_vid over LLFF_VID_FRAMES poses of the render split (K1, K3),
    the GIF decoded back. Returns the two runs' launch counts."""
    from pointnerf_tpu_torch.data import create_dataset
    from pointnerf_tpu_torch.ops import kernels
    from pointnerf_tpu_torch.run import common
    from pointnerf_tpu_torch.run.render_vid import render_vid
    from pointnerf_tpu_torch.run.workload import make_llff_scene
    from pointnerf_tpu_torch.utils.checkpoint import load_checkpoint
    from pointnerf_tpu_torch.utils.gif import read_gif
    from pointnerf_tpu_torch.utils.visualizer import Visualizer
    phase0 = time.perf_counter()
    t0 = time.perf_counter()
    n_written = make_llff_scene(root, n=LLFF_VIEWS, wh=LLFF_WH,
                                side=LLFF_SIDE)
    write_s = time.perf_counter() - t0
    opt = llff_options(root)
    t0 = time.perf_counter()
    train_ds, test_ds = create_dataset(opt, "train"), \
        create_dataset(opt, "test")
    read_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    s0 = start_psnr(opt, train_ds, test_ds, LLFF_TEST_VIEWS)
    log(f"llff: scene {LLFF_WH[0]}x{LLFF_WH[1]}, {LLFF_VIEWS} views "
        f"({len(train_ds)} train, {len(test_ds)} test: holdoff "
        f"{max(2, LLFF_TESTSKIP)}), near/far {train_ds.near_far}, written "
        f"in {write_s:.1f} s, splits read in {read_s:.2f} s (host); "
        f"{n_written} fused.ply points -> {s0['n']} after vox_res "
        f"{opt.vox_res} in {s0['init_s']:.2f} s; grid {s0['spec'].vdim} "
        f"built in {s0['grid_ms']:.1f} ms, "
        f"{int(s0['grid']['num_occ'])} occupied voxels; test PSNR before "
        f"training {s0['psnr0']:.3f} ({LLFF_TEST_VIEWS} views); peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")
    psnr0 = s0["psnr0"]
    del s0, train_ds
    torch.cuda.empty_cache()

    res, ft, wall, sr_over, peak = finetune_run(
        "llff finetune", opt, (kernels.TRUNK_FWD, kernels.TRUNK_BWD,
                               kernels.OCCUPANCY, kernels.SCATTER_ROWS))
    tm = res["timing"]
    log(f"llff finetune: {tm['steps']} steps, "
        f"{1e3 * tm['train_s'] / tm['steps']:.1f} ms/step, wall {wall:.1f} s"
        f" (test renders {tm['test_s']:.1f} s, checkpoints "
        f"{tm['save_s']:.1f} s); sr_overflow over the steps {sr_over}; "
        f"final test PSNR {res['final_psnr']:.3f} (before {psnr0:.3f}); "
        f"peak {peak:.2f} GiB; launches {ft}")
    if not res["final_psnr"] > psnr0:
        raise AssertionError(f"llff test PSNR {res['final_psnr']:.3f} not "
                             f"above the start's {psnr0:.3f}")
    del res
    torch.cuda.empty_cache()
    ckpt = os.path.join(opt.checkpoints_dir, opt.experiment)
    chunks_vs_cpu("llff", ckpt, opt, test_ds.get_item(0, full_img=True))

    render_ds = create_dataset(opt, "render")
    n_poses = len(render_ds)
    render_ds.render_poses = render_ds.render_poses[:LLFF_VID_FRAMES]
    render_ds.total = LLFF_VID_FRAMES
    ts, _ = load_checkpoint(ckpt, opt, device="cuda")
    spec, grid = common.make_spec_and_grid(opt, ts.points)
    for k in kernels.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vid = render_vid(ts, grid, opt, spec, render_ds, Visualizer(opt),
                     LLFF_STEPS)
    vid_s = time.perf_counter() - t0
    rv = {k.name: k.launches for k in kernels.KERNELS}
    check_launches("llff render_vid", (kernels.TRUNK_FWD, kernels.OCCUPANCY))
    frames = read_gif(vid["video"])
    log(f"llff render_vid: {vid['n_frames']} of the render split's {n_poses}"
        f" poses in {vid_s:.1f} s ({1e3 * vid_s / vid['n_frames']:.1f} ms a "
        f"frame with its PNG), GIF of {len(frames)} frames; launches {rv}")
    if vid["n_frames"] != LLFF_VID_FRAMES or len(frames) != LLFF_VID_FRAMES:
        raise AssertionError("the llff video does not hold its frames")
    del ts, grid
    torch.cuda.empty_cache()
    log(f"llff phase: {time.perf_counter() - phase0:.1f} s")
    return ft, rv


def envelopes_options(root, name):
    """The finetune phase's lego options on its plate scene with the
    envelope `name` of run/workload.ENVELOPES switched on: ENV_STEPS[name]
    steps, no prune or probe, a checkpoint at the end, the final test
    over ENV_TEST_VIEWS of the scene's 4 test views."""
    from pointnerf_tpu_torch.run.workload import envelope_options
    steps = ENV_STEPS[name]
    return envelope_options(name, finetune_options(root)).replace(
        experiment=f"env_{name}", maximum_step=steps, prune_iter=0,
        prune_max_iter=0, prob_freq=0, print_freq=steps,
        save_iter_freq=10 * steps, test_num=ENV_TEST_VIEWS)


def envelopes_path(root, smi: str):
    """The aggregator's other shading envelopes on the card, each a
    train_ft run on the finetune phase's plate scene (FT_WH², lego widths):
    pers30 (distance mode 30: K1, K2 at dd 4, K3, K6), sh_intrp,
    gau_intrp, bf16, order0 and block2 (the composition around K3 and K6:
    no K1, K2, K4 or K5). Each prints ms/step, the test PSNR before and
    after over ENV_TEST_VIEWS test view, the peak and the launches, and renders
    one chunk of a test view on the CPU from its checkpoint (1e-5; bf16
    ENV_BF16_TOL). pers30 also renders through test_ft and one render_vid
    frame. Raises on a non-finite output, a loss that does not fall (the
    mean of the last five steps against the first five), a chunk outside
    its tolerance, or the kernels above. Returns each run's launches."""
    from pointnerf_tpu_torch.data import create_dataset
    from pointnerf_tpu_torch.ops import kernels
    from pointnerf_tpu_torch.run import common, test_ft
    from pointnerf_tpu_torch.run.render_vid import render_vid
    from pointnerf_tpu_torch.utils.checkpoint import load_checkpoint
    from pointnerf_tpu_torch.utils.visualizer import Visualizer
    phase0 = time.perf_counter()
    fused = (kernels.TRUNK_FWD, kernels.TRUNK_BWD, kernels.SHADE_FWD,
             kernels.SHADE_BWD)
    runs = []
    for name in ENV_STEPS:
        opt = envelopes_options(root, name)
        train_ds, test_ds = create_dataset(opt, "train"), \
            create_dataset(opt, "test")
        torch.cuda.reset_peak_memory_stats()
        s0 = start_psnr(opt, train_ds, test_ds, ENV_TEST_VIEWS)
        psnr0 = s0["psnr0"]
        del s0, train_ds
        torch.cuda.empty_cache()
        kerns = fused[:2] if name == "pers30" else ()
        losses = []
        res, ft, wall, _, peak = finetune_run(
            f"envelopes {name}", opt,
            kerns + (kernels.OCCUPANCY, kernels.SCATTER_ROWS), losses)
        tm = res["timing"]
        head, tail = np.mean(losses[:5]), np.mean(losses[-5:])
        ms_step = 1e3 * tm["train_s"] / tm["steps"]
        ckpt = os.path.join(opt.checkpoints_dir, opt.experiment)
        tol = ENV_BF16_TOL if name == "bf16" else TT_CPU_TOL
        ms_img, err, _, _ = chunks_vs_cpu(
            f"envelopes {name}", ckpt, opt,
            test_ds.get_item(0, full_img=True), tol=tol, n_chunks=1)
        log(f"envelopes {name}: {tm['steps']} steps, {ms_step:.1f} ms/step "
            f"(host clock around each step and its items' fetch), wall "
            f"{wall:.1f} s (test renders {tm['test_s']:.1f} s, checkpoint "
            f"{tm['save_s']:.1f} s); loss_total mean of the first 5 steps "
            f"{head:.6f} -> last 5 {tail:.6f}; test PSNR {psnr0:.3f} -> "
            f"{res['final_psnr']:.3f} ({ENV_TEST_VIEWS} view); one chunk "
            f"card vs CPU max_abs_err {err:.3e} (tolerance {tol}); render "
            f"{ms_img:.1f} ms/image; peak {peak:.2f} GiB; launches {ft}")
        if not (np.isfinite(losses).all() and tail < head):
            raise AssertionError(f"envelopes {name}: the loss does not fall "
                                 f"({head} -> {tail})")
        if name != "pers30" and any(ft[k.name] for k in fused):
            raise AssertionError(f"envelopes {name} launched a fused trunk "
                                 f"or shade kernel: {ft}")
        runs.append(ft)
        del res
        torch.cuda.empty_cache()
        if name != "pers30":
            continue
        for k in kernels.KERNELS:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = test_ft.main(opt.replace(resume_dir=ckpt))
        test_s = time.perf_counter() - t0
        tf = {k.name: k.launches for k in kernels.KERNELS}
        check_launches("envelopes pers30 test_ft",
                       (kernels.TRUNK_FWD, kernels.OCCUPANCY))
        render_ds = create_dataset(opt, "render")
        render_ds.render_poses = render_ds.render_poses[:1]
        render_ds.total = 1
        ts, _ = load_checkpoint(ckpt, opt, device="cuda")
        spec, grid = common.make_spec_and_grid(opt, ts.points)
        for k in kernels.KERNELS:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vid = render_vid(ts, grid, opt, spec, render_ds, Visualizer(opt),
                         opt.maximum_step)
        vid_s = time.perf_counter() - t0
        rv = {k.name: k.launches for k in kernels.KERNELS}
        check_launches("envelopes pers30 render_vid",
                       (kernels.TRUNK_FWD, kernels.OCCUPANCY))
        log(f"envelopes pers30 test_ft: step {out['step']}, PSNR "
            f"{out['psnr']:.3f} in {test_s:.1f} s; launches {tf}; "
            f"render_vid: {vid['n_frames']} frame in {vid_s:.1f} s; "
            f"launches {rv}")
        if out["step"] != opt.maximum_step or not np.isfinite(out["psnr"]) \
                or vid["n_frames"] != 1:
            raise AssertionError("the pers30 test_ft or render_vid failed")
        runs += [tf, rv]
        del ts, grid
        torch.cuda.empty_cache()
    log(f"envelopes phase: {time.perf_counter() - phase0:.1f} s; {smi}")
    return runs


def nsft_options(root):
    """The lego preset's widths on the legacy NeRF-Synthetic dataset
    (nerf_synth_ft, NSFT_WH²) with the MVS init over the pairs file's
    view groups (load_points 0, the premlp and MVS_CONF_THRESH as in the
    mvs phase): NSFT_STEPS steps, no prune or probe, a checkpoint at the
    end, test renders of pairs.th's test frames."""
    from pointnerf_tpu_torch.config import nerf_synth_preset
    return nerf_synth_preset("lego").replace(
        dataset_name="nerf_synth_ft", data_root=root, scan="plate",
        img_wh=(NSFT_WH, NSFT_WH), load_points=0,
        shading_feature_mlp_layer0=1, depth_conf_thresh=MVS_CONF_THRESH,
        checkpoints_dir=os.path.join(root, "checkpoints"),
        experiment="plate_legacy", maximum_step=NSFT_STEPS, prune_iter=0,
        prob_freq=0, print_freq=25, save_iter_freq=10 * NSFT_STEPS,
        save_point_freq=0, test_freq=0, test_num=NSFT_PAIRS["n_test"])


def nsft_path(root, smi: str):
    """The legacy NeRF-Synthetic finetune on the card: a plate scene at
    NSFT_WH² with the pairs tables of NSFT_PAIRS
    (run/workload.write_legacy_pairs); the MVS init over the pairs file's
    view groups, timed (the dataset's fixed [2, 6] depth range cut to
    MVS_NEAR_FAR for random weights, as the mvs phase cuts its planes);
    the starting test PSNR on pairs.th's test frames; train_ft.main for
    NSFT_STEPS steps (K1, K2, K3, K6) whose test PSNR must pass the
    start; two chunks of a test view on the CPU. Returns the run's launch
    counts."""
    from pointnerf_tpu_torch.data import create_dataset, nerf_synth_ft
    from pointnerf_tpu_torch.ops import kernels
    from pointnerf_tpu_torch.run.workload import (make_plate_scene,
                                                  write_legacy_pairs)
    phase0 = time.perf_counter()
    make_plate_scene(root, wh=(NSFT_WH, NSFT_WH))
    write_legacy_pairs(root, **NSFT_PAIRS)
    opt = nsft_options(root)
    legacy = nerf_synth_ft.LEGACY_NEAR_FAR.copy()
    nerf_synth_ft.LEGACY_NEAR_FAR[:] = MVS_NEAR_FAR
    try:
        train_ds, test_ds = create_dataset(opt, "train"), \
            create_dataset(opt, "test")
        torch.cuda.reset_peak_memory_stats()
        s0 = start_psnr(opt, train_ds, test_ds, len(test_ds))
        log(f"nerf_synth_ft: plate scene {NSFT_WH}x{NSFT_WH}; train ids "
            f"{train_ds.id_list}, view groups {train_ds.view_id_list} (pairs"
            f" txt), test ids {test_ds.id_list} (pairs.th); near/far "
            f"{train_ds.near_far} (the dataset's {legacy} cut); MVS init "
            f"{s0['init_s']:.2f} s: {s0['n']} points after the hull and "
            f"vox_res {opt.vox_res}; grid {s0['spec'].vdim} built in "
            f"{s0['grid_ms']:.1f} ms; test PSNR before training "
            f"{s0['psnr0']:.3f}; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")
        if s0["n"] < NSFT_MIN_POINTS:
            raise AssertionError(f"the MVS init left {s0['n']} points")
        psnr0 = s0["psnr0"]
        del s0, train_ds
        torch.cuda.empty_cache()
        res, ft, wall, sr_over, peak = finetune_run(
            "nerf_synth_ft finetune", opt,
            (kernels.TRUNK_FWD, kernels.TRUNK_BWD, kernels.OCCUPANCY,
             kernels.SCATTER_ROWS))
        tm = res["timing"]
        log(f"nerf_synth_ft finetune: {tm['steps']} steps, "
            f"{1e3 * tm['train_s'] / tm['steps']:.1f} ms/step, wall "
            f"{wall:.1f} s (the MVS init again, test renders "
            f"{tm['test_s']:.1f} s, checkpoints {tm['save_s']:.1f} s); "
            f"sr_overflow over the steps {sr_over}; final test PSNR "
            f"{res['final_psnr']:.3f} (before {psnr0:.3f}); peak "
            f"{peak:.2f} GiB; launches {ft}")
        if not res["final_psnr"] > psnr0:
            raise AssertionError(f"nerf_synth_ft test PSNR "
                                 f"{res['final_psnr']:.3f} not above the "
                                 f"start's {psnr0:.3f}")
        del res
        torch.cuda.empty_cache()
        ckpt = os.path.join(opt.checkpoints_dir, opt.experiment)
        chunks_vs_cpu("nerf_synth_ft", ckpt, opt,
                      test_ds.get_item(0, full_img=True))
    finally:
        nerf_synth_ft.LEGACY_NEAR_FAR[:] = legacy
    log(f"nerf_synth_ft phase: {time.perf_counter() - phase0:.1f} s")
    return ft


# ------------------------------------------------ the ProbNet point init
def probnet_options(root):
    """The lego preset with the ProbNet init (load_points 0,
    manual_depth_view -1 at the preset's depth_grid 128, pad 24,
    num_neighbor 1) on the PN_WH² plate scene, with the premlp and the MVS
    phase's depth range (MVS_NEAR_FAR) for random weights, dprob_thresh
    PN_DPROB_THRESH, PN_STEPS finetune steps with no prune or probe, one
    test view."""
    return mvs_options(root).replace(
        manual_depth_view=-1, dprob_thresh=PN_DPROB_THRESH,
        experiment="plate_probnet", maximum_step=PN_STEPS,
        save_iter_freq=10 * PN_STEPS, test_num=1)


PN_PARTS = ("cost_s", "unet_s", "filter_s", "embed_s")


def probnet_view_check(opt, mvs, sample):
    """One depth view of the ProbNet init on the card and on the CPU with
    the same weights and draws: the mass within PN_TOL; the keep masks at
    dprob_thresh and at lego's 0.8 equal away from PN_MASS_TIE of the
    threshold; the card's own keep rows at the CPU's median mass off the
    uniform plateau (a threshold that splits the pixels) equal to the
    CPU's mass filter there, with both kept and dropped pixels among those
    compared; xyz,
    embedding, color, dir and conf within PN_TOL on the rows kept on both
    whose visibility agrees. Returns the card's ms by part."""
    from pointnerf_tpu_torch.models.mvs import points_model as pm
    hp = sample["mvs_images"].shape[-2] // 4 + 2 * opt.pad
    wp = sample["mvs_images"].shape[-1] // 4 + 2 * opt.pad
    noise = [torch.randn((opt.num_each_depth, hp, wp),
                         generator=torch.Generator().manual_seed(1))]
    out, maps, stats, secs = {}, {}, {}, {}
    for name, net in (("card", mvs), ("cpu", copy.deepcopy(mvs).cpu())):
        maps[name], stats[name] = {}, {}
        t0 = time.perf_counter()
        with torch.inference_mode():
            out[name] = pm.gen_points(net, opt, sample, noise=noise,
                                      maps=maps[name], stats=stats[name])
        secs[name] = time.perf_counter() - t0
    np_ = lambda t: t.detach().cpu().numpy()
    mass_c, mass_h = np_(maps["card"]["mass"][0]), np_(maps["cpu"]["mass"][0])
    np.testing.assert_allclose(mass_c, mass_h, err_msg="mass", **PN_TOL)
    kept = {}
    for thresh in (opt.dprob_thresh, 0.8):
        away = np.abs(mass_h - thresh) > PN_MASS_TIE
        kc, kh = mass_c > thresh, mass_h > thresh
        if not np.array_equal(kc[away], kh[away]):
            raise AssertionError(f"probnet keep masks differ at {thresh}")
        kept[thresh] = int(kh.sum())
    # the median mass off the uniform plateau num_neighbor / D (the
    # padding's and the featureless pixels')
    flat = opt.num_neighbor / opt.depth_grid
    split = float(np.median(mass_h[np.abs(mass_h - flat) > PN_MASS_TIE]))
    with torch.inference_mode():
        keep_s = np_(pm.gen_points(mvs, opt.replace(dprob_thresh=split),
                                   sample, noise=noise)["keep"])
    away = np.tile((np.abs(mass_h - split) > PN_MASS_TIE).reshape(-1),
                   opt.num_each_depth)
    want = np.tile((mass_h > split).reshape(-1), opt.num_each_depth)
    n_split = (int(want[away].sum()), int((~want[away]).sum()))
    if not np.array_equal(keep_s[away], want[away]) or min(n_split) == 0:
        raise AssertionError(f"probnet keep rows at the median mass {split}"
                             f" differ from the CPU's filter, or one side "
                             f"is empty {n_split}")
    keep_c, keep_h = np_(out["card"]["keep"]), np_(out["cpu"]["keep"])
    vis = np.all(np_(maps["card"]["vis"][0]) == np_(maps["cpu"]["vis"][0]),
                 axis=-1)
    rows = keep_c & keep_h & vis
    errs = {}
    for k in ("xyz_w", "embedding", "color", "dir", "conf"):
        a, b = np_(out["card"][k])[rows], np_(out["cpu"][k])[rows]
        errs[k] = float(np.abs(a - b).max())
        np.testing.assert_allclose(a, b, err_msg=k, **PN_TOL)
    ms = {k: 1e3 * stats["card"][k] for k in PN_PARTS}
    log(f"probnet: one depth view {hp}x{wp} padded, D {opt.depth_grid}, "
        f"card vs CPU: mass within {PN_TOL} (range {mass_h.min():.5f}-"
        f"{mass_h.max():.5f}); kept at dprob_thresh {opt.dprob_thresh}: "
        f"{kept[opt.dprob_thresh]} of {mass_h.size}, at lego's 0.8: "
        f"{kept[0.8]}; the card's keep rows at the CPU's median mass off "
        f"the plateau {flat:.6f}, {split:.6f}, equal to its filter on the "
        f"{int(away.sum())} rows "
        f"away from it ({n_split[0]} kept, {n_split[1]} dropped); rows "
        f"{len(keep_h)}, compared {int(rows.sum())} "
        f"({int((keep_c & keep_h & ~vis).sum())} visibility ties); max abs "
        f"err {errs}; card {secs['card']:.2f} s (ms by part {ms}), CPU "
        f"{secs['cpu']:.1f} s")
    if rows.sum() < 0.9 * keep_h.sum():
        raise AssertionError("probnet: too few rows compared card vs CPU")
    return ms


def probnet_path(root, smi: str):
    """The ProbNet-initialised finetune on the card (load_points 0,
    manual_depth_view -1; no kernel of its own: cuDNN convs and plain
    PyTorch): the plate scene at PN_WH², one depth view held against the
    CPU, the init over every triplet timed by part (cost volume, U-Net,
    moments and filter, samples and embedding), the starting test PSNR,
    then train_ft.main for PN_STEPS steps (K1, K2, K3, K6), whose start
    must hold the timed init's points and whose test PSNR must pass the
    start. Returns the run's launch counts."""
    from pointnerf_tpu_torch.data import create_dataset
    from pointnerf_tpu_torch.models import neural_points as npc
    from pointnerf_tpu_torch.models.mvs import points_model as pm
    from pointnerf_tpu_torch.ops import kernels
    from pointnerf_tpu_torch.run import common
    from pointnerf_tpu_torch.run.workload import make_plate_scene
    from pointnerf_tpu_torch.train import trainer
    phase0 = time.perf_counter()
    make_plate_scene(root, wh=(PN_WH, PN_WH), n_train=PN_TRAIN, n_test=1)
    opt = probnet_options(root)
    dev = torch.device("cuda")
    train_ds, test_ds = create_dataset(opt, "train"), \
        create_dataset(opt, "test")
    mvs = pm.MvsPoints(opt, torch.Generator().manual_seed(opt.seed),
                       device=dev)
    probnet_view_check(opt, mvs, train_ds.get_init_item(0))
    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.inference_mode():
        common.gen_points_filter_embeddings(opt, train_ds, mvs=mvs,
                                            device=dev, stats=stats)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    T = stats["triplets"]
    per = {k: round(1e3 * stats[k] / T, 1) for k in PN_PARTS}
    log(f"probnet: plate scene {PN_WH}x{PN_WH}, {PN_TRAIN} train views, "
        f"{T} triplets (one depth view each), D {opt.depth_grid}, pad "
        f"{opt.pad}, near/far {MVS_NEAR_FAR}, dprob_thresh "
        f"{opt.dprob_thresh}: ms per depth view by part {per}; hull "
        f"{1e3 * stats['hull_s']:.1f} ms, voxel downsample "
        f"{1e3 * stats['vox_s']:.1f} ms (host); wall {wall:.2f} s; points "
        f"kept {stats['n_keep']}, after the hull {stats['n_hull']}, after "
        f"the downsample (vox_res {opt.vox_res}) {stats['n_vox']}; peak "
        f"{peak:.2f} GiB; {smi}")
    if stats["n_vox"] < PN_MIN_POINTS:
        raise AssertionError(f"the ProbNet init left {stats['n_vox']} points")
    del mvs
    torch.cuda.empty_cache()
    s0 = start_psnr(opt, train_ds, test_ds, 1)
    psnr0 = s0["psnr0"]
    del s0, train_ds
    torch.cuda.empty_cache()
    res, ft, wall, sr_over, peak = finetune_run(
        "probnet finetune", opt, (kernels.TRUNK_FWD, kernels.TRUNK_BWD,
                                  kernels.OCCUPANCY, kernels.SCATTER_ROWS))
    tm = res["timing"]
    n_start = int(npc.num_active(trainer.point_state_of(res["state"])))
    log(f"probnet finetune: {n_start} points from the ProbNet init, "
        f"{tm['steps']} steps, {1e3 * tm['train_s'] / tm['steps']:.1f} "
        f"ms/step, wall {wall:.1f} s (the init again, test renders "
        f"{tm['test_s']:.1f} s, checkpoints {tm['save_s']:.1f} s); "
        f"sr_overflow over the steps {sr_over}; final test PSNR "
        f"{res['final_psnr']:.3f} (initial cloud {psnr0:.3f}); peak "
        f"{peak:.2f} GiB; launches {ft}")
    if n_start != stats["n_vox"]:
        raise AssertionError(f"main started from {n_start} points, the "
                             f"timed init made {stats['n_vox']}")
    if not res["final_psnr"] > psnr0:
        raise AssertionError(f"probnet test PSNR {res['final_psnr']:.3f} "
                             f"not above the start's {psnr0:.3f}")
    log(f"probnet phase: {time.perf_counter() - phase0:.1f} s")
    return ft


def first_views(sample, n: int):
    """A feed-forward bundle cut to its first n views (dtu's hold 3
    sources and the target; ProbNet's cost volume takes 3)."""
    out = {}
    for k, v in sample.items():
        v = np.asarray(v)
        if k == "proj_mats":
            v = v[:n, :n]
        elif v.ndim >= 1 and v.shape[0] == len(sample["view_ids"]) and \
                k != "near_fars_depth":
            v = v[:n]
        out[k] = v
    return out


PN_SLICE_TIE = 1e-4                   # e·D this near an integer: the mass's
                                      # slice floor(e·D) jumps there


def slice_tie_weights(mvs, opt, sample, noise):
    """Per row 0 where the pixel's e·D lies within PN_SLICE_TIE of an
    integer (uniform prob volumes put it at D/2 exactly, and the two
    devices' sums land on either side), else 1: [rows, 1] on the CPU."""
    from pointnerf_tpu_torch.models.mvs import points_model as pm
    from pointnerf_tpu_torch.models.mvs.probnet import prob_moments
    maps = {}
    with torch.no_grad():
        pm.gen_points(copy.deepcopy(mvs).cpu(), opt, sample, noise=noise,
                      maps=maps, training=True)
    w = []
    for prob in maps["prob"]:
        eD = prob_moments(prob)[0].reshape(-1) * prob.shape[0]
        far = (eD - torch.round(eD)).abs() >= PN_SLICE_TIE
        w.append(far.repeat(opt.num_each_depth))
    return torch.cat(w).to(torch.float32)[:, None]


def probnet_grads(mvs, opt, sample, noise, w=None):
    """ProbNet's parameter gradients of sum(w·conf) + 1e-3·sum(xyz_w)
    through gen_points on batch statistics, flattened."""
    from pointnerf_tpu_torch.models.mvs import points_model as pm
    mvs.probnet.requires_grad_(True)
    out = pm.gen_points(mvs, opt, sample, noise=noise, training=True)
    conf = out["conf"] if w is None else out["conf"] * w.to(
        out["conf"].device)
    loss = conf.sum() + (out["xyz_w"] * 1e-3).sum()
    grads = torch.autograd.grad(loss, list(mvs.probnet.parameters()))
    return loss, torch.cat([g.reshape(-1) for g in grads])


def probnet_gen_path(root, smi: str):
    """ProbNet at dtu_gen's size (640x512, D 128, pad 24). dtu_gen itself
    refuses it on the card (a ValueError naming manual_depth_view: dtu's
    bundles hold 4 views, ProbNet takes 3; JAX's conv fails there). Then
    ProbNet trains on the first three views of a dtu_gen item: PNG_STEPS
    Adam steps of sum(conf) + 1e-3·sum(xyz) through gen_points on batch
    statistics (ProbNet's backward, the path dtu_gen would run), timed;
    every gradient finite and one nonzero; one step's gradients against
    the CPU's at PNG_CPU_D planes and one depth view, the conf of
    slice-tie rows weighted 0 (`slice_tie_weights`), in float64 on both
    devices within GRAD_REL in norm; in float32 within GRAD_REL, or the
    card's no further off the CPU's float64 than PNG_F32_SPREAD times the
    CPU's float32 (float32 alone sits ~1e-3 off float64 there: a 3D U-Net
    on batch statistics over a million voxels)."""
    from pointnerf_tpu_torch.data import create_dataset
    from pointnerf_tpu_torch.run import train as gen
    phase0 = time.perf_counter()
    dev = torch.device("cuda")
    opt = dtu_gen_options(root).replace(manual_depth_view=-1,
                                        dprob_thresh=PN_DPROB_THRESH)
    ds = create_dataset(opt, "train")
    item = ds.get_item(0, rng=np.random.RandomState(0))
    sample = item.pop("mvs_sample")
    st = gen.create_gen_state(opt, device=dev)
    try:
        gen.gen_train_step(st, sample, gen.batch_of(item, dev), opt,
                           gen.make_render_spec(opt, ds, gen.point_slots(opt)))
    except ValueError as e:
        log(f"probnet_gen: dtu_gen refuses ProbNet on the card: {e}")
    else:
        raise AssertionError("dtu_gen ran ProbNet on a 4-view bundle")
    mvs = st.mvs.requires_grad_(False)
    del st
    sample3 = first_views(sample, 3)
    H, W = DTU_WH[1], DTU_WH[0]
    hp, wp = H // 4 + 2 * opt.pad, W // 4 + 2 * opt.pad
    gen_ = torch.Generator().manual_seed(2)
    mvs.probnet.requires_grad_(True)
    adam = torch.optim.Adam(list(mvs.probnet.parameters()), lr=opt.lr)
    losses, gnorms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(PNG_STEPS):
        noise = [torch.randn((opt.num_each_depth, hp, wp), generator=gen_)
                 for _ in str(opt.depth_vid)]
        loss, g = probnet_grads(mvs, opt, sample3, noise)
        if not bool(torch.isfinite(g).all()) or not float(g.abs().max()) > 0:
            raise AssertionError("ProbNet's gradients are not finite and "
                                 "nonzero")
        off = 0
        for p in mvs.probnet.parameters():
            p.grad = g[off:off + p.numel()].reshape(p.shape)
            off += p.numel()
        adam.step()
        adam.zero_grad(set_to_none=True)
        losses.append(float(loss.detach()))
        gnorms.append(float(g.norm()))
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / PNG_STEPS
    peak = torch.cuda.max_memory_allocated() / 2**30
    # one step's gradients, card against CPU, at PNG_CPU_D planes and one
    # depth view
    cut = opt.replace(depth_grid=PNG_CPU_D, depth_vid="0")
    noise = [torch.randn((cut.num_each_depth, hp, wp), generator=gen_)
             for _ in str(cut.depth_vid)]
    t1 = time.perf_counter()
    w = slice_tie_weights(mvs, cut, sample3, noise)
    nets = {"card": mvs, "cpu": copy.deepcopy(mvs).cpu()}
    nets.update({k + "64": copy.deepcopy(v).double()
                 for k, v in list(nets.items())})
    grads = {k: probnet_grads(v, cut, sample3, noise, w)[1].double().cpu()
             for k, v in nets.items()}
    del nets
    rd = lambda a, b: float((grads[a] - grads[b]).norm() / grads[b].norm())
    rel, rel64 = rd("card", "cpu"), rd("card64", "cpu64")
    off = {k: rd(k, "cpu64") for k in ("card", "cpu")}
    log(f"probnet_gen: ProbNet on 3 views of a dtu_gen item at "
        f"{W}x{H} ({hp}x{wp} padded, D {opt.depth_grid}), batch statistics:"
        f" {PNG_STEPS} steps of forward + backward + Adam at {step_ms:.1f} "
        f"ms/step, loss {losses[0]:.4f} -> {losses[-1]:.4f}, gradient "
        f"norms {[round(v, 4) for v in gnorms]}; peak {peak:.2f} GiB; one "
        f"step's gradients card vs CPU at D {PNG_CPU_D}, one depth view, "
        f"the conf of {int((w == 0).sum())} of {len(w)} slice-tie rows "
        f"weighted 0: ||diff|| / ||cpu|| float64 {rel64:.3e}, float32 "
        f"{rel:.3e} (bar {GRAD_REL}); float32 off the CPU's float64: card "
        f"{off['card']:.3e}, CPU {off['cpu']:.3e} "
        f"({time.perf_counter() - t1:.1f} s); {smi}")
    if not rel64 <= GRAD_REL:
        raise AssertionError(f"ProbNet float64 gradients card vs CPU: "
                             f"{rel64:.3e}")
    if not (rel <= GRAD_REL or off["card"] <= PNG_F32_SPREAD * off["cpu"]):
        raise AssertionError(f"ProbNet float32 gradients card vs CPU: "
                             f"{rel:.3e}, off float64 {off}")
    mvs.probnet.requires_grad_(False)
    log(f"probnet_gen phase: {time.perf_counter() - phase0:.1f} s")


# ---------------------------------------- scene editing and the viewer
def editing_path(root, smi: str):
    """Scene editing on the card from the finetune phase's checkpoint,
    staged as edit_srcs/plate_ft: the whole cloud, plus its x < 0 half
    rotated 90° about z and lifted EDIT_LIFT (per-point Rw2c), composed by
    run/editing.main, which renders one test view and the render split's
    video (20 poses; the counts reset just before and read just after: K1
    and K3 must launch, K4 not) and saves the composite; one chunk of the test
    view rendered again on the CPU from it (within 1e-5); test_ft reads it
    back (K1, K3). Returns the launch counts of main and of test_ft."""
    import shutil
    from pointnerf_tpu_torch.data import create_dataset
    from pointnerf_tpu_torch.ops import kernels
    from pointnerf_tpu_torch.run import editing, test_ft
    phase0 = time.perf_counter()
    ft = finetune_options(root)
    src = os.path.join(ft.checkpoints_dir, "edit_srcs", ft.experiment)
    for d in ("parts_index", "transforms"):
        os.makedirs(os.path.join(src, d), exist_ok=True)
    for f in (f"{FT_STEPS}_net_ray_marching.npz", f"{FT_STEPS}_states.npz"):
        shutil.copy(os.path.join(ft.checkpoints_dir, ft.experiment, f), src)
    raw = np.load(os.path.join(src, f"{FT_STEPS}_net_ray_marching.npz"))
    xyz = raw["neural_points.xyz"][0]
    half = xyz[:, 0] < 0
    np.savetxt(os.path.join(src, "parts_index", "half.txt"),
               half.astype(np.int32))
    M = np.eye(4)
    M[:3, :3] = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
    M[2, 3] = EDIT_LIFT
    np.savetxt(os.path.join(src, "transforms", "rot90lift.txt"), M)
    opt = ft.replace(experiment="plate_edit", test_num=1, save_point_freq=0)
    parts = ([ft.experiment] * 2, ["all", "half"], ["no", "rot90lift"])
    for k in kernels.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = editing.main(opt, *parts, device="cuda")
    wall = time.perf_counter() - t0
    n_poses = len(create_dataset(opt, "render"))
    ed = {k.name: k.launches for k in kernels.KERNELS}
    check_launches("editing", (kernels.TRUNK_FWD, kernels.OCCUPANCY))
    log(f"editing: {len(xyz)} source points + {int(half.sum())} moved = "
        f"{out['n_points']} composed (per-point Rw2c), test PSNR "
        f"{out['psnr']:.3f} on 1 view, render_vid {out['n_frames']} frames "
        f"(the render split's {n_poses}), "
        f"composite saved; wall {wall:.1f} s; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{ed}")
    if out["n_points"] != len(xyz) + int(half.sum()) or \
            out["n_frames"] != n_poses or not np.isfinite(out["psnr"]):
        raise AssertionError("editing.main did not compose and render")
    ckpt = os.path.join(opt.checkpoints_dir, opt.experiment)
    chunks_vs_cpu("editing", ckpt, opt,
                  create_dataset(opt, "test").get_item(0, full_img=True),
                  n_chunks=1)
    for k in kernels.KERNELS:
        k.launches = 0
    back = test_ft.main(opt.replace(resume_dir=ckpt))
    tf = {k.name: k.launches for k in kernels.KERNELS}
    check_launches("editing test_ft", (kernels.TRUNK_FWD, kernels.OCCUPANCY))
    log(f"editing test_ft: step {back['step']}, PSNR {back['psnr']:.3f} "
        f"(editing's {out['psnr']:.3f}); launches {tf}")
    if back["step"] != 0 or abs(back["psnr"] - out["psnr"]) > 1e-4:
        raise AssertionError("test_ft did not read the composite back")
    log(f"editing phase: {time.perf_counter() - phase0:.1f} s; {smi}")
    return ed, tf


def visualize_path(root, smi: str):
    """The headless viewer on the finetune phase's checkpoint: the PLY,
    a VIS_FRAMES-frame turntable at VIS_SIZE² and a growth video from its
    point dumps, splatted on the card (run/visualize.py); one frame's
    splat must equal the CPU's pixel for pixel."""
    from pointnerf_tpu_torch.run import visualize as vz
    phase0 = time.perf_counter()
    ft = finetune_options(root)
    ckpt = os.path.join(ft.checkpoints_dir, ft.experiment)
    out = os.path.join(root, "vis")
    os.makedirs(out, exist_ok=True)
    xyz, rgb, conf = vz.load_point_cloud(ckpt)
    vz.write_ply(os.path.join(out, "cloud.ply"), xyz, rgb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vid = vz.render_turntable(xyz, rgb, os.path.join(out, "turntable"),
                              n_frames=VIS_FRAMES, size=VIS_SIZE)
    turn_s = time.perf_counter() - t0
    dumps = sorted(os.listdir(os.path.join(ckpt, "points")))
    t0 = time.perf_counter()
    grow = vz.render_grow(os.path.join(ckpt, "points"),
                          os.path.join(out, "grow"), size=VIS_SIZE)
    grow_s = time.perf_counter() - t0
    center, radius = vz.frame_cloud(xyz)
    focal = VIS_SIZE / (2.0 * np.tan(np.deg2rad(50.0) / 2.0))
    c2w = vz.orbit_pose(center, radius, 1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = vz.splat_render(xyz, rgb, c2w, VIS_SIZE, VIS_SIZE, focal)
    torch.cuda.synchronize()
    splat_ms = 1e3 * (time.perf_counter() - t0)
    host = vz.splat_render(xyz, rgb, c2w, VIS_SIZE, VIS_SIZE, focal,
                           device="cpu")
    same = bool(torch.equal(card.cpu(), host))
    log(f"visualize: {len(xyz)} points above conf 0.1, PLY "
        f"{os.path.getsize(os.path.join(out, 'cloud.ply'))} bytes; "
        f"turntable {VIS_FRAMES} frames at {VIS_SIZE}² in {turn_s:.2f} s "
        f"({vid}); growth video of dumps {dumps} in {grow_s:.2f} s; one "
        f"splat {splat_ms:.1f} ms on the card, equal to the CPU's: {same}; "
        f"{smi}")
    if not same or grow is None or len(dumps) < 3:
        raise AssertionError("visualize: the splat differs from the CPU's "
                             "or the dumps are missing")
    log(f"visualize phase: {time.perf_counter() - phase0:.1f} s")


def tt_options(root):
    """tt_preset("Truck") at its widths (1920x1080, ranges, vsize 0.002,
    vscale 3, SR 40, K 8, P 10, max_o 1.6 M, the 256-wide MLP, auto
    SR_budget) with load_points 1 (the scene's fused.ply; its own
    load_points 0 has no view triplets on tt_ft and fails in both
    packages), TT_STEPS steps and a final checkpoint, 2 test views."""
    from pointnerf_tpu_torch.config import tt_preset
    return tt_preset("Truck").replace(
        data_root=root, img_wh=TT_WH, load_points=1,
        checkpoints_dir=os.path.join(root, "checkpoints"),
        experiment="truck_ft", maximum_step=TT_STEPS, print_freq=50,
        save_iter_freq=10 * TT_STEPS, save_point_freq=0, test_freq=0,
        test_num=TT_TEST_NUM)


def tt_eval_path(root, smi: str):
    """The evaluation phase at 1920x1080 on a T&T-layout plate scene
    (run/workload.make_tt_scene, TT_SIDE² points): train_ft.main with
    tt_preset("Truck") for TT_STEPS steps (K1, K2, K3, K6), then
    test_ft.main on its checkpoint with LPIPS alex and vgg from random
    weights written here (K1, K3; each run with the counts reset just
    before and read just after); a timed render of one test view; two of
    its chunks rendered again on the CPU from the same checkpoint; one
    1920x1080 LPIPS distance on the card against the CPU, and LPIPS timed
    on the card. Returns the two runs' launch counts."""
    from pointnerf_tpu_torch.data import create_dataset
    from pointnerf_tpu_torch.ops import kernels
    from pointnerf_tpu_torch.run import common, test_ft, train_ft
    from pointnerf_tpu_torch.run.workload import (lpips_state_dict,
                                                  make_tt_scene)
    from pointnerf_tpu_torch.utils.checkpoint import load_checkpoint
    from pointnerf_tpu_torch.utils.lpips import load_lpips
    from pointnerf_tpu_torch.utils.png import read_png
    t0 = time.perf_counter()
    n_written = make_tt_scene(root, wh=TT_WH, n_train=TT_VIEWS[0],
                              n_test=TT_VIEWS[1], radius=TT_RADIUS,
                              half=TT_HALF, side=TT_SIDE)
    weights = {}
    for net in ("alex", "vgg"):
        weights[net] = os.path.join(root, f"lpips_{net}_full.pth")
        torch.save(lpips_state_dict(net, seed=len(net)), weights[net])
    log(f"T&T plate scene {TT_WH[0]}x{TT_WH[1]}, {TT_VIEWS[0]} train / "
        f"{TT_VIEWS[1]} test views, {n_written} fused.ply points: written "
        f"in {time.perf_counter() - t0:.1f} s")

    opt = tt_options(root)
    for k in kernels.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train_ft.main(opt)
    wall = time.perf_counter() - t0
    ft = {k.name: k.launches for k in kernels.KERNELS}
    tm = res["timing"]
    R = opt.random_sample_size ** 2
    n_pts = int(res["state"].points["mask"].sum())
    log(f"T&T finetune (tt_preset Truck, load_points 1): {n_pts} points, "
        f"grid {res['spec'].vdim}; {tm['steps']} steps, "
        f"{1e3 * tm['train_s'] / tm['steps']:.1f} ms/step ({R} rays a "
        f"step), wall {wall:.1f} s (test renders {tm['test_s']:.1f} s, "
        f"checkpoints {tm['save_s']:.1f} s); final test PSNR "
        f"{res['final_psnr']:.3f}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {ft}")
    check_launches("T&T finetune", (kernels.TRUNK_FWD, kernels.TRUNK_BWD,
                                    kernels.OCCUPANCY, kernels.SCATTER_ROWS))
    if res["total_steps"] != TT_STEPS or not np.isfinite(res["final_psnr"]):
        raise AssertionError("the T&T finetune did not run its steps")
    del res
    torch.cuda.empty_cache()

    ckpt = os.path.join(opt.checkpoints_dir, opt.experiment)
    eval_opt = opt.replace(resume_dir=ckpt,
                           checkpoints_dir=os.path.join(root, "eval"),
                           lpips_alex_path=weights["alex"],
                           lpips_vgg_path=weights["vgg"])
    for k in kernels.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = test_ft.main(eval_opt)
    wall = time.perf_counter() - t0
    test = {k.name: k.launches for k in kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_launches("test_ft", (kernels.TRUNK_FWD, kernels.OCCUPANCY))
    scores = out["scores"]
    log(f"test_ft {TT_WH[0]}x{TT_WH[1]}: {TT_TEST_NUM} image in "
        f"{wall:.1f} s ({1e3 * wall / TT_TEST_NUM:.1f} ms an image with the "
        f"checkpoint load, PNG writes and scoring), PSNR {out['psnr']:.3f}, "
        f"scores { {k: round(v, 5) for k, v in scores.items()} }, peak "
        f"{peak:.2f} GiB; launches {test}; {smi}")
    if sorted(scores) != ["lpips", "psnr", "rmse", "ssim", "vgglpips"] or \
            not all(np.isfinite(v) for v in scores.values()):
        raise AssertionError(f"test_ft scored {scores}")

    # one test view rendered again (warm: test_ft rendered it), timed; two
    # of its chunks on the CPU
    ts, _ = load_checkpoint(ckpt, opt, device="cuda")
    spec, grid = common.make_spec_and_grid(opt, ts.points)
    item = create_dataset(opt, "test").get_item(0, full_img=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = [k.launches for k in kernels.KERNELS]
    stats = {}
    t0 = time.perf_counter()
    maps = common.render_image(ts, grid, opt, spec, item, stats=stats)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for k, c in zip(kernels.KERNELS, counts):
        k.launches = c
    W, H = TT_WH
    rgb, hit = maps["coarse_raycolor"], maps["ray_mask"][..., 0] > 0.5
    log(f"test_ft render {W}x{H}: {1e3 * dt:.1f} ms/image, "
        f"{W * H / dt:.0f} rays/s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, hit share "
        f"{hit.mean():.4f}, groups {stats['groups']}, sr_overflow "
        f"{stats['sr_overflow']}; {smi}")
    if rgb.shape != (H, W, 3) or not np.isfinite(rgb).all() or \
            not 0.0 < hit.mean() < 1.0:
        raise AssertionError("the test_ft image is not a finite map with "
                             "hits and misses")
    chunk = opt.random_sample_size ** 2
    per_chunk = hit.reshape(-1)[: (H * W // chunk) * chunk].reshape(-1, chunk)
    pick = np.sort(np.argsort(-per_chunk.sum(1), kind="stable")[:1])
    sel = np.concatenate([np.arange(c * chunk, (c + 1) * chunk) for c in pick])
    sub = dict(item, raydir=item["raydir"][:, sel],
               pixel_idx=item["pixel_idx"][:, sel])
    sub.pop("gt_image", None)
    cpu_ts, _ = load_checkpoint(ckpt, opt, device="cpu")
    _, cpu_grid = common.make_spec_and_grid(opt, cpu_ts.points)
    t0 = time.perf_counter()
    cpu = common.render_image(cpu_ts, cpu_grid, opt.replace(use_fused_trunk=1),
                              spec, sub)
    px, py = sub["pixel_idx"][0, :, 0].astype(int), \
        sub["pixel_idx"][0, :, 1].astype(int)
    np.testing.assert_array_equal(cpu["ray_mask"][py, px],
                                  maps["ray_mask"][py, px])
    np.testing.assert_allclose(cpu["coarse_raycolor"][py, px], rgb[py, px],
                               **TT_CPU_TOL)
    log(f"test_ft: CPU re-render of chunks {pick.tolist()} ({len(sel)} rays,"
        f" {int(hit.reshape(-1)[sel].sum())} hit) from the same checkpoint: "
        f"max_abs_err "
        f"{float(np.abs(cpu['coarse_raycolor'][py, px] - rgb[py, px]).max()):.3e}"
        f" in {time.perf_counter() - t0:.1f} s")
    del ts, grid, cpu_ts, cpu_grid, maps, cpu
    torch.cuda.empty_cache()

    # LPIPS on test_ft's first 1920x1080 pair: card vs CPU (alex at full
    # size, vgg on a 256x256 crop at the center, on the plate), then timed
    # on the card
    img_dir = os.path.join(eval_opt.checkpoints_dir, opt.experiment,
                           "images", f"test_{TT_STEPS}")
    pair = [read_png(os.path.join(img_dir, f"step-0000-{n}.png"))
            .astype(np.float32)[..., :3] / 255.0
            for n in ("gt_image", "coarse_raycolor")]
    center = (slice(H // 2 - 128, H // 2 + 128),
              slice(W // 2 - 128, W // 2 + 128))
    parts = []
    for net, crop in (("alex", False), ("vgg", True)):
        a, b = (p[center] for p in pair) if crop else pair
        card_m = load_lpips(weights[net], "cuda")
        card = float(card_m.distance(a, b))
        cpu_d = float(load_lpips(weights[net], "cpu").distance(a, b))
        if not cpu_d > 0:
            raise AssertionError(f"LPIPS {net} of the pair is {cpu_d}: the "
                                 f"check compares nothing")
        np.testing.assert_allclose(card, cpu_d, rtol=LPIPS_RTOL)
        card_m.distance(*pair)
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_time(lambda: card_m.distance(*pair), LPIPS_REPS)
        parts.append(f"{net}: card {card:.7f} vs CPU {cpu_d:.7f} at "
                     f"{a.shape[1]}x{a.shape[0]} (relative "
                     f"{abs(card - cpu_d) / abs(cpu_d):.2e}), "
                     f"{ms:.1f} ms a {W}x{H} distance on the card, peak "
                     f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del card_m
        torch.cuda.empty_cache()
    log(f"LPIPS {'; '.join(parts)}; {smi}")
    return ft, test


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pointnerf_tpu_torch.ops import kernels

    start = time.perf_counter()

    def timeline(label):
        log(f"timeline: {label} done, {time.perf_counter() - start:.1f} s "
            f"from the start")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    kernels.library()
    build_s, build_log = kernels.build_info()
    log(f"kernel build: {build_s:.1f} s compile, "
        f"{time.perf_counter() - t0:.1f} s build+load")
    for line in build_log.splitlines():
        if ("==" in line or "registers" in line or "spill" in line
                or "error" in line):
            log("  ptxas:", line.strip())
    log(f"tensor-core products (HMMA instructions in cuobjdump -sass): "
        f"{tensor_core_products()}")
    calls = sass_calls(kernels.OCCUPANCY)
    log(f"K3 subroutine calls (CALL instructions in cuobjdump -sass): "
        f"{calls}")
    if calls:
        raise AssertionError("K3 calls a subroutine: its indices must stay "
                             "32-bit (64-bit division is one)")
    # the plain versions stay full fp32: no TF32 in cuBLAS or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    opt, state, spec, grid, agg, ts, item, grid_ms = build_workload(
        torch.device("cuda"))
    log(f"grid build on card: {grid_ms:.1f} ms, "
        f"vdim {spec.vdim}, occupied voxels {int(grid['num_occ'])}")

    # kernels against their plain versions: K1, K3 and K4 at one serving
    # group's shapes, K2 and K5 at one train step's
    from pointnerf_tpu_torch.models.aggregator import init_aggregator_params
    dev = torch.device("cuda")
    chunk = opt.random_sample_size ** 2
    tier_rows = lambda rows: tier_shapes(opt, rows)
    agg0 = init_aggregator_params(opt.replace(agg_dist_pers=0),
                                  torch.Generator().manual_seed(5), device=dev)
    agg30 = init_aggregator_params(opt.replace(agg_dist_pers=30),
                                   torch.Generator().manual_seed(6),
                                   device=dev)
    with torch.inference_mode():
        k1 = check_trunk(agg, agg30, opt,
                         *tier_rows(GROUP * chunk * opt.SR))
        k3 = check_occupancy(item, grid, spec, opt, GROUP * chunk)
        k4 = check_shade({20: agg, 0: agg0}, opt,
                         *tier_rows(GROUP * chunk * opt.SR))
    k2 = check_trunk_bwd(agg, agg30, opt, *tier_rows(chunk * opt.SR))
    k5 = check_shade_bwd(agg, opt, *tier_rows(chunk * opt.SR))
    for name, rows in (("K1", k1), ("K2", k2)):
        t20, t30 = tier_sums(rows), tier_sums(rows, 30)
        log(f"{name} narrow + wide, C1 284 (mode 20) -> 264 (mode 30): "
            f"kernel {t20[0]:.3f} -> {t30[0]:.3f} ms (the C1 284 time "
            f"scaled by 264/284: {t20[0] * 264 / 284:.3f}), plain "
            f"{t20[1]:.3f} -> {t30[1]:.3f} ms, bound (3xTF32) "
            f"{t20[2]:.3f} -> {t30[2]:.3f} ms, bound_fp32 {t20[3]:.3f} -> "
            f"{t30[3]:.3f} ms")
    del agg0, agg30
    torch.cuda.empty_cache()
    # K6 at its script's shapes (its train-step shapes follow the train
    # path), K7 at occ_micro3's
    from pointnerf_tpu_torch.scripts.scatter_pallas import script_inputs
    idx_np, upd_np = script_inputs(**SCATTER_SCRIPT)
    check_scatter("scatter_pallas.py shapes (dup 6)",
                  torch.as_tensor(idx_np, device=dev),
                  torch.as_tensor(upd_np, device=dev), SCATTER_SCRIPT["cap"])
    del idx_np, upd_np
    k7 = check_row_select(dev)
    torch.cuda.empty_cache()
    timeline("kernel checks")

    # the main paths, default (K1, K2, K3, K6 in training) then fused_shade
    # (K4, K5, K3, K6 in training)
    shade_opt = opt.replace(fused_shade=1)
    default_k = (kernels.TRUNK_FWD, kernels.OCCUPANCY, kernels.TRUNK_BWD,
                 kernels.SCATTER_ROWS)
    shade_k = (kernels.SHADE_FWD, kernels.OCCUPANCY, kernels.SHADE_BWD,
               kernels.SCATTER_ROWS)
    serve, maps, stats = serve_path(opt, state, spec, grid, agg, ts, item,
                                    "serve", default_k[:2])
    torch.cuda.empty_cache()
    serve_s, maps_s, stats_s = serve_path(shade_opt, state, spec, grid, agg,
                                          ts, item, "serve fused_shade",
                                          shade_k[:2])
    diff = float(np.abs(maps_s["coarse_raycolor"]
                        - maps["coarse_raycolor"]).max())
    log(f"serve fused_shade vs default image: max_abs_diff {diff:.3e}; "
        f"sr_overflow {stats_s['sr_overflow']} vs {stats['sr_overflow']}, "
        f"occ_overflow {stats_s['occ_overflow']} vs {stats['occ_overflow']}")
    if not diff <= SHADE_IMAGE_TOL:
        raise AssertionError(f"the fused_shade image differs by {diff:.3e}")
    for k in ("sr_overflow", "occ_overflow"):
        if stats_s[k] != stats[k]:
            raise AssertionError(f"{k} differs between the configurations")
    del maps, maps_s
    torch.cuda.empty_cache()
    from pointnerf_tpu_torch.train import trainer
    fresh = lambda: trainer.create_train_state(
        opt, state, torch.Generator().manual_seed(0))
    train, st, batch, losses = train_path(opt, state, spec, grid, "train",
                                          default_k)
    check_train_cpu(fresh(), batch, opt, spec, grid, "train")
    with ScatterRecorder() as rec:
        trainer.compute_grads(st, grid, batch, opt, spec,
                              trainer.jitter_draws(st, batch, opt))
    log(f"train step's point-gradient scatters: S "
        f"{[c[0].shape[0] for c in rec.calls]}, cap {rec.calls[0][2]}")
    k6 = check_scatter("one train step's wide tier",
                       *max(rec.calls, key=lambda c: c[0].shape[0]))
    del st, rec
    torch.cuda.empty_cache()
    train_s, st, batch, losses_s = train_path(shade_opt, state, spec, grid,
                                              "train fused_shade", shade_k)
    check_train_cpu(fresh(), batch, shade_opt, spec, grid,
                    "train fused_shade")
    rel = abs(losses_s[0] - losses[0]) / abs(losses[0])
    log(f"train fused_shade vs default: step-1 loss_total {losses_s[0]:.7f} "
        f"vs {losses[0]:.7f} (relative difference {rel:.3e})")
    if not rel <= STEP1_RTOL:
        raise AssertionError(f"the fused_shade step-1 loss differs by {rel}")
    del st, batch, state, grid, ts, agg
    torch.cuda.empty_cache()
    timeline("serve and train")

    # the finetune driver at lego widths: K1, K2, K3, K6; then from the
    # MVS init
    import tempfile
    with tempfile.TemporaryDirectory() as root:
        finetune = finetune_path(root)
        torch.cuda.empty_cache()
        video = video_path(root)
        torch.cuda.empty_cache()
        # the other shading envelopes on the same plate scene: pers30
        # (K1, K2, K3, K6), the rest around K3 and K6
        envelopes = envelopes_path(root, smi)
        torch.cuda.empty_cache()
        # scene editing from the finetune's checkpoint (K1, K3; test_ft
        # K1, K3) and the viewer on it and its point dumps
        edit, edit_test = editing_path(root, smi)
        torch.cuda.empty_cache()
        visualize_path(root, smi)
    torch.cuda.empty_cache()
    timeline("finetune, render_vid, envelopes, editing, visualize")
    with tempfile.TemporaryDirectory() as root:
        mvs = mvs_path(root)
    torch.cuda.empty_cache()
    timeline("mvs")
    # the ProbNet-initialised finetune (K1, K2, K3, K6)
    with tempfile.TemporaryDirectory() as root:
        probnet = probnet_path(root, smi)
    torch.cuda.empty_cache()
    timeline("probnet")

    # the feed-forward DTU paths: inference (frustum querier, K1 in order
    # 1), then generalizable training (K1, K2, K3, K6)
    from pointnerf_tpu_torch.run.workload import make_dtu_scene
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        make_dtu_scene(root, n_views=DTU_VIEWS, wh=DTU_WH)
        log(f"DTU plate scene {DTU_WH[0]}x{DTU_WH[1]}, {DTU_VIEWS} views: "
            f"written in {time.perf_counter() - t0:.1f} s")
        dtu_inf = dtu_inf_path(root)
        torch.cuda.empty_cache()
        dtu_gen = dtu_gen_path(root)
        torch.cuda.empty_cache()
        # ProbNet at dtu_gen's size: dtu_gen refuses it, ProbNet's own
        # backward on 3 of the item's views (cuDNN, no kernel of the port)
        probnet_gen_path(root, smi)
    torch.cuda.empty_cache()
    timeline("dtu_inf, dtu_gen, probnet_gen")

    # the DTU per-scene finetune with the plane background (K1, K2, K3,
    # K6), its planepoints run and the resampler
    with tempfile.TemporaryDirectory() as root:
        dtu_ft, dtu_pp = dtu_ft_path(root, smi)
    torch.cuda.empty_cache()
    timeline("dtu_ft")

    # the ScanNet finetune from sensor depth (K1, K2, K3, K6) at the
    # sensors' sizes, its image I/O and its load_points 3 run
    with tempfile.TemporaryDirectory() as root:
        _, scannet_ft, scannet_lp3 = scannet_path(root, smi)
    torch.cuda.empty_cache()
    timeline("scannet")

    # the vox-grid querier from a pickled cloud (K1, K2, K3, K6; test_ft:
    # K1, K3), the LLFF finetune and its render path, and the legacy
    # NeRF-Synthetic finetune from the pairs file's MVS init
    with tempfile.TemporaryDirectory() as root:
        vox_ft, vox_test = voxgrid_path(root, smi)
    torch.cuda.empty_cache()
    timeline("voxgrid")
    with tempfile.TemporaryDirectory() as root:
        llff_ft, llff_vid = llff_path(root, smi)
    torch.cuda.empty_cache()
    timeline("llff")
    with tempfile.TemporaryDirectory() as root:
        nsft_ft = nsft_path(root, smi)
    torch.cuda.empty_cache()
    timeline("nerf_synth_ft")

    # the evaluation phase: the T&T finetune, test_ft and LPIPS at
    # 1920x1080 (K1, K2, K3, K6)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        tt_ft, tt_test = tt_eval_path(root, smi)
    log(f"evaluation phase: {time.perf_counter() - t0:.1f} s")

    log(f"chip_smoke: {time.perf_counter() - start:.1f} s from the start")
    runs = (serve, serve_s, train, train_s, finetune, video, *envelopes,
            edit, edit_test, mvs, probnet, dtu_inf, dtu_gen, dtu_ft, dtu_pp,
            scannet_ft, scannet_lp3, vox_ft, vox_test, llff_ft, llff_vid,
            nsft_ft, tt_ft, tt_test)
    report = {"kernels": []}
    for k, rows in ((kernels.TRUNK_FWD, k1), (kernels.TRUNK_BWD, k2),
                    (kernels.OCCUPANCY, k3), (kernels.SHADE_FWD, k4),
                    (kernels.SHADE_BWD, k5), (kernels.SCATTER_ROWS, k6),
                    (kernels.ROW_SELECT, k7)):
        extra = {}
        if isinstance(rows, dict):
            err, by, library_ms = rows["err"], rows["bound_by"], \
                rows.get("library_ms")
            ms, plain_ms, b_ms = rows["ms"], rows["plain_ms"], \
                rows["bound_ms"]
        else:
            err, by, library_ms = max(r["err"] for r in rows), \
                "operations", None
            ms, plain_ms, b_ms, b32_ms = tier_sums(rows)
            extra = {"bound_fp32_ms": b32_ms,
                     "bound_note": f"{TF32_PASSES} TF32 tensor-core products "
                                   f"per multiply-add at "
                                   f"{PEAK_TF32 / 1e12:.0f} TFLOP/s"}
        launches = rows["launches"] if k is kernels.ROW_SELECT else \
            sum(run[k.name] for run in runs)
        report["kernels"].append(
            {"name": k.name, "route": "cuda", "source": k.source,
             "replaces": k.replaces, "launches": launches,
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": by, "library_ms": library_ms,
             **extra})
    log(json.dumps(report))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
