#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

The main path is bench.py's self-consistent FlyLight pipeline, run by the
port (``patchperpix_tpu_torch``): the trained ppp+dec crop model
(``parity/bench_ckpt_params.npz``) predicts codes and numinst on the 50^3
fixture in one 52^3 window, the numinst head (0.9 / 0.1) gives the
foreground, foreground codes decode to 7^3 patches and ``to_instance_seg``
assembles them (pt 0.6, fc 0.5, mws); then inst[~fg] = 0 and components
under 400 voxels go.  Phases, each printed as one JSON line:

1. device: the card, and nvidia-smi's name and power limit (also printed
   alone on its own line); then the libraries the blosc decoder binds
   (libzstd.so.1, liblz4.so.1 and their version numbers, or null);
2. build: nvcc of every source under csrc/ (eight kernels), in parallel,
   and g++ of the host thinning (native/thinning.cpp) beside them;
3. f32 main path (TF32 off): a warm-up run, then the counted run with
   per-stage times; each CUDA kernel is held against its plain PyTorch
   version on this run's decoded affinities (consensus atol = rtol =
   1e-4, rank atol 1e-3 / rtol 1e-4: the JAX package's own kernel
   tolerances), launched a second time for equal bits, and timed against
   it (plain, kernel, kernel, plain; CUDA events; medians).  The counted
   run launches K1, K2 and the thin cover K6 (``csrc/thin_cover.cu``);
   then phase cover_kernels on the warm-up run's thin-cover input (held by
   ``CoverCapture``): K6 against its plain version (the host loops of
   ``ops/cover.py``), ``selected`` equal bit for bit (integer counts, no
   tolerance), timed like the kernels above, with the loop's rounds,
   picks and refreshes, the device ms of each kernel of the call and the
   loop's cycles by phase, and again with the lazy loop capped at a
   quarter of its candidates in rounds (the cap a kernel argument), where
   the full loop takes over; and, for information, K6 on the JAX package's own greedy
   cover list of the crop against its thin cover list;
4. held against the JAX package's float32 CPU run stored in
   parity/torch_port_ref_f32.npz: foreground agreement >= 99.9 %, equal
   instance count, >= 99 % of foreground voxels agreeing after best-IoU
   matching; per-stage agreement is printed to find where two runs part;
5. bf16 main path (the configuration's own dtype; warm-up, then a timed
   run): instance count, own-fg voxels, AP@0.5 (IoU, Hungarian) and
   avg_f1_cov (bench.py's recipe: rm 400, clDice, greedy, keep_gt_shape)
   beside the TPU's figures in BENCH_r05.json and the JAX package's bf16
   CPU run in parity/torch_port_ref_bf16.json (information only: bf16
   convolutions add in another order on each); after each of phases 3
   and 5 a roofline line (information, no gate; ``utils/roofline.py`` at
   the card's published peaks): bench.py's consensus + rank cost against
   the assembly's wall, ``assembly_mfu_summary`` by stage, ``unet_cost``
   against the predict stage;
6. probe: the row-window probe's twelve cases and one that stages past
   48 KB (``ops/probe.py``), kernel against plain version, max error <
   1e-4; the case W = 768, n_slab = 3 timed against the plain version and
   against ``F.conv2d`` along the rows; then conv_wgrad
   (``run_conv_wgrad``): the weight-gradient kernel of the U-Net's valid
   3x3x3 convolutions (``ops/conv_kernels.py``) at each convolution of
   the published FlyLight ppp+dec U-Net at batch 2 of 140^3
   (``WGRAD_SHAPES``), against its plain version in float64 (largest
   error under 1e-5 of the largest value), equal bits from a second
   call, timed like phase 3 beside its bound, the plain
   version in float32 and cuDNN's exact-f32 weight gradient by its
   heuristic and its best algorithm (library_ms, the yardstick); its
   launches are counted in phase 12's valid step, not here;
7. path2d: the 2D assembly at full width, the worm image (16 worms, seed
   0) at 520x696 with 25x25 patches through ``to_instance_seg`` in f32
   under settings (A) (the 2D bench's: pt 0.5, mws, sparse-data cover) and
   (B) (configs/bbbc010.toml's: pt 0.9, label propagation, dense-data
   cover, overlaps): a warm-up, then the counted run with stage times.
   Gates: in (A) every ground-truth worm is matched by exactly one
   predicted instance with IoU >= 0.5; (A) and (B) agree with the JAX
   package's f32 CPU runs in parity/torch_port_ref2d_f32.npz (at the size
   stored there) under the limits of phase 4.  K3, K4, the cascade K5
   (``csrc/cover_cascade.cu``, setting (B)) and K6 are each launched; after
   phase 8, phase cover_kernels on (B)'s warm-up inputs: K5 (``selected``
   and the still-uncovered volume equal bit for bit) and K6 against their
   plain versions, as in phase 3;
8. kernels2d: the 2D consensus and rank kernels against their plain
   versions on path2d's inputs, f32 and bf16 half (consensus atol = rtol =
   1e-4 in f32, 1e-4 + 2^-7 |x| in bf16, one rounding step of the stored
   type; rank atol 1e-3 / rtol 1e-4), each launched a second time for
   equal bits, timed like phase 3; then the same checks and the kernels'
   times on dense2d, a denser worm image (64 worms, seed 1, setting (A)),
   a kernel check only (no path, no JAX reference);
9. model2d: the BBBC010 model (configs/bbbc010.toml widths, seeded
   weights) on one 512x512 window, predict and decode at seeded pixel
   positions, against parity/torch_port_model2d_ref.npz (1e-4 + 1e-4 |x|);
10. blockwise (run right after phase 4, with phase 3's float32 model and
   decoded affinities): the out-of-core sample path, the reference CLI's
   predict -> decode -> label --blockwise, on a stand-in sample: the 50^3
   crop reflected to 100^3, larger than the 52^3 window.
   predict_sample_to_zarr writes pred_code / pred_numinst (f16, zlib) to
   a temporary store;
   blockwise_vote_instances_zarr streams codes through CodeAffReader
   (chunksize 64^3, 70^3 block windows: K1 + K2 per block, K1 per stitch
   window), counted from zero; then the staged variant, decode_sample in
   at least two z-slabs and blockwise from the dense pred_affs store
   (ZarrAffReader, no decoder); one stitch-sized window's read split into
   zlib, decoder and crossing seconds; and the whole volume at 100^3 for
   comparison (information only).  Gates: (a) the stored heads equal
   predict_volume_device within 1e-3; (b) the code-reader map equals the
   staged map after relabel, with equal foreground, each run having read
   through its own reader; (c) the blockwise map (chunksize 32^3, in
   memory) of phase 3's f32 decoded affinities agrees with the JAX
   package's f32 CPU blockwise run in
   parity/torch_port_blockwise_ref_f32.npz (at the size stored there)
   under phase 4's limits; (d) benchmarks/blockwise_scale.py's synthetic
   120^3 tube volume (ops/synthetic.py's copy), written as an f16 store
   and assembled blockwise at chunksize 64: 12 instances, each
   ground-truth tube matched by exactly one at IoU >= 0.5; (e) K1 and K2 on a border block window
   (center_valid set) against their plain versions at phase 3's
   tolerances, equal bits on two launches.  K1 / K2 launches on the path
   must equal the blocks (K2) and the blocks plus stitch windows (K1) that
   reached the consensus stage, and K6 must be launched;
11. cli: the reference CLI's path through the port's CLI
   (``patchperpix_tpu_torch.cli.main`` in-process, on the card), the way
   users run it: ``-c configs/flylight_crop_dec.toml -c <override> -d
   mknet predict decode label evaluate`` in a temporary experiment root
   under experiments_out/ (the CLI's default root, gitignored), the
   override setting the model to float32 and the data
   folders to one holding only the crop, the checkpoint written from
   parity/bench_ckpt_params.npz by ``weights.write_checkpoint``: pt 0.5,
   mws, skeletonize_foreground, remove_small_comps 60, evaluation under
   clDice, greedy, keep_gt_shape, rm 60.  Gates against the JAX package's
   CPU run of the same chain in parity/torch_port_cli_ref_f32.npz:
   phase 4's limits on the map, the skeleton of the mask to cover equal
   bit for bit (the port's thinning of the stored foreground always; the
   run's own when its foreground equals the stored one), |avg_f1_cov -
   the JAX run's| <= 0.01; K1, K2 and K6 launched within the CLI run; then
   ``postprocess``.  The results are ``<sample>.hdf`` (``IoHDF5``): every
   array the run gave ``IoHDF5`` to write, read back from its file, equal
   bit for bit, with the write and read seconds; and the JAX package's
   own result file of the same chain (parity/torch_port_jax_result.hdf,
   written by h5py) through the port's ``evaluate``: its metric dict
   (|avg_f1_cov - JAX's| <= 0.01, equal instance counts).  Then
   phase visualize on that f32 experiment (``run_visualize``): (a) ``-d
   visualize`` with show_patches, each PNG read back with the port's
   reader equal to the port's render of the stored arrays; (b) the port's
   renders on the card (``render_instances`` plain, over the raw,
   outlined; ``patch_mosaic`` twice; ``render_patch_tiles``;
   ``render_graph_edges``) of ``viz_inputs()`` equal bit for bit to the
   JAX package's in parity/torch_port_viz_ref.npz; (c) ``label`` plain
   and with vote_debug, save_mip and save_tif: K1 / K2 once per label, the
   two maps and phase cli's equal, (7 * 50)^2 canvases, the MIPs and the
   relabelled uint16 TIF; (d) 2D vote_debug through ``do_all`` on a 128^2
   crop of the worm image, setting (A): K3 / K4 once, (25 * 128)^2
   canvases, the map equal to ``to_instance_seg``'s.  Then
   ``-d infer_fused evaluate`` with the config as it stands (bf16), for
   information beside the TPU's and the JAX bf16 CPU figures (those are
   bench.py's pipeline).  Stage seconds per task, the skeleton seconds in
   label and evaluate, and the phase's wall;
12. train: (a) one float32 train step (TF32 off) at full width on a fixed
   batch (three 40^3 crops of the fixture at stored centres, no
   augmentation), the code branch (configs/flylight_crop_dec.toml's model,
   the trained parameters, the JAX step's own code corners) and the dense
   branch (configs/flylight_crop.toml's model, 343-channel head, seeded
   weights), against the JAX package's CPU step in
   parity/torch_port_train_ref_f32.npz: loss parts within 1e-5 relative,
   each gradient leaf's norm and 256 seeded entries within 1e-4 relative
   L2, or within twice the JAX f32 step's own error against the JAX
   package's float64 step where that is larger (stored beside it), capped
   at 1e-4 / 5e-3; then, under the same limits against
   parity/torch_port_train_valid_ref_f32.npz, the code branch with valid
   padding on 52^3 crops at the same centres, whose U-Net's nine narrow
   valid 3x3x3 convolutions take their weight gradient from W1 (nine
   launches, the kernels line's count); (b) four batches of the device
   sampler (the config's crops and augmentations) against the host
   sampler's numpy on the same decisions (raw 1e-6, labels equal), then
   train_until with the device sampler, f32, 200 steps, constant lr 1e-3,
   from init_tree, on the crop model cut in width to TRAIN_RUN_WIDTHS: the
   mean loss of the last 50 steps within the band of two JAX runs of the
   same (seeds 0 and 1), widened below by the larger of 15 % and their
   spread, above by the larger of 5 % and their spread; (c) ``-d all``
   through the port's CLI on the crop as users run it (bf16, Adam,
   warmup-cosine, device sampler), the override cutting max_iterations to 400,
   checkpoints to 200 and the warmup to 100 steps, from the trained
   parameters seeded as train_net_checkpoint_0 (no optimizer state): log
   rows at steps 1, 100, ... 400 with finite losses, checkpoints [0, 200,
   400] all scored in results.json with a best, the final evaluate's
   avg_f1_cov, K1 and K2 launched 4 times each (3 checkpoints + the final
   label), and ``train`` resumed to 600 with the Adam state read back
   (update count 400, then 600); seconds per task and per checkpoint;
13. isbi: the ISBI 2012 protocol, configs/isbi_rehearsal.toml as users run
   it on the stand-in data data/synth_isbi as the JAX package wrote it
   (blosc: zstd, bitshuffle), against the JAX package's CPU runs in
   parity/torch_port_isbi_ref_f32.*: first its 20 arrays read by the port
   equal bit for bit to the zlib copy data/synth_isbi_zlib, with the
   decode seconds; (a) ``to_instance_seg`` on the ideal
   25x25 affinities of both test samples at 512^2 (94 % foreground):
   maps identical up to relabelling, the same candidate count, metric
   dicts equal, K3 / K4 launched once each, K5 / K6 at least once; then
   K3 / K4 against their
   plain versions on that input (1e-4 / 1e-3 absolute as in phase 8), two
   launches equal, times and bounds; (b) keep_single_slice, the sparse
   grid and the boundary filter on a seeded three-slice stack, bit for
   bit; (c) the port's CLI ``mknet predict label evaluate
   cross_validate`` in f32 from a seeded checkpoint, each val / test map
   under phase 4's limits, |rand_fscore - JAX's| <= 0.01, the same best
   checkpoint and applied scores within 0.01, K3 / K4 once per labelled
   sample; (d) configs/isbi2012.toml's full-width model (seeded) on one
   512^2 window in f32 (TF32 off), sampled affinities and foreground
   within 1e-4 relative L2 per head, then f32 and bf16 times and peak
   memory; (e) one f32 step of the rehearsal model on a fixed batch
   under phase 12's gate (a) limits (its own float64 witness), the 2D
   device sampler against the host's; (f) ``-d all`` with the rehearsal
   config (6,000 bf16 steps, checkpoints every 2,000): every checkpoint
   validated, K3 / K4 launched once per labelled sample (the validated
   checkpoints' val samples and the final test label), rand_fscore /
   adapted_rand_error / VOI per test sample beside the JAX rehearsal's
   (parity/isbi_rehearsal) and the seeded model's;
14. swin (``run_swin``; f32 with TF32 off unless bf16 is named), held
   against the JAX package's CPU runs in parity/torch_port_swin_ref_f32.*:
   (a) configs/flylight.toml's model as a SwinUNETR (3 stages 20/40/80,
   heads 2/5/10, window 7, 343-channel head) at full width with seeded
   weights on one 156^3 window (the crop reflected): each head's seeded
   entries within 1e-4 relative L2; f32 and bf16 forward ms and peak
   memory; a 2D Swin at configs/bbbc010.toml's widths on the model2d
   window (1e-4 + 1e-4 |x|); (b) one f32 step of configs/flylight_crop
   .toml's model as a Swin on phase 12's batch under phase 12(a)'s
   limits, ``rel_pos_bias`` and the qkv leaves named; (c) ``-d all``
   with that config as a Swin (bf16, device sampler, 400
   steps, checkpoints every 200, foreground by the numinst argmax) from
   the seeded tree as checkpoint 0:
   every checkpoint scored, K1 / K2 once per validated checkpoint plus
   the final label; (d) information: the bf16 step of the full-width
   Swin, batch 2 of 140^3;
15. multidevice (``run_multidevice``, run inside phase 10 before its
   store goes), meshes of n shards on the one card through
   ``parallel/sharded.py``'s ``local_devices`` hook: (a)
   ``sharded_consensus_and_rank`` with 2 shards on phase 3's 50^3
   decoded affinities and 4 on phase 10's 100^3 stand-in against the
   whole-volume K1 + K2 under phase 3's tolerances, one launch per shard,
   whether bit for bit; (b) ``to_instance_seg(sharded_devices=4)`` on the
   stand-in: the map identical up to relabelling to the one-device map,
   the cover equal, the graph weights within 1e-5; (c) ``block_devices =
   2`` on the stand-in's dense store: the block_devices = 0 map; (d) the
   data-parallel f32 step with 3 shards on phase 12's batch, both
   branches, within 1e-6 relative of the one-device step and phase
   12(a)'s limits of the JAX fixture, then ``-d train`` through the CLI
   with ``training.num_devices = 2`` (batch 4, the host sampler), 20
   steps, finite losses; (e) (a) and (d) across real cards where there
   are two, else a printed skip;
16. the script's wall, the kernels line (K1-K4, P1, K5, K6, the weight
   gradient (its row the sum over ``WGRAD_SHAPES``), each row
   with its launches by counted phase), then the contract's last line.

Any failure raises and exits non-zero before the last line; with no CUDA
device, or without the repository beside it, it exits 2.
"""

import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "data", "JRC_SS05008-20160318_24_B2_crop.zarr")
REF_NPZ = os.path.join(REPO, "parity", "torch_port_ref_f32.npz")
REF_JSON = os.path.join(REPO, "parity", "torch_port_ref_f32.json")
BENCH_TPU = os.path.join(REPO, "BENCH_r05.json")
REF2D_NPZ = os.path.join(REPO, "parity", "torch_port_ref2d_f32.npz")
REF2D_JSON = os.path.join(REPO, "parity", "torch_port_ref2d_f32.json")
MODEL2D_NPZ = os.path.join(REPO, "parity", "torch_port_model2d_ref.npz")
MODEL2D_JSON = os.path.join(REPO, "parity", "torch_port_model2d_ref.json")
BW_REF_NPZ = os.path.join(REPO, "parity", "torch_port_blockwise_ref_f32.npz")
BW_REF_JSON = os.path.join(REPO, "parity",
                           "torch_port_blockwise_ref_f32.json")
CLI_CONFIG = os.path.join(REPO, "configs", "flylight_crop_dec.toml")
CLI_REF_NPZ = os.path.join(REPO, "parity", "torch_port_cli_ref_f32.npz")
CLI_REF_JSON = os.path.join(REPO, "parity", "torch_port_cli_ref_f32.json")
# the JAX package's own result file of that chain (h5py) and its metric dict
JAX_RESULT = os.path.join(REPO, "parity", "torch_port_jax_result.hdf")
JAX_RESULT_JSON = os.path.join(REPO, "parity", "torch_port_jax_result.json")
BF16_REF_JSON = os.path.join(REPO, "parity", "torch_port_ref_bf16.json")
CLI_STEP = 1
WIN = (52, 52, 52)
# the blockwise phase: the crop reflected by 25 per side stands in for a
# FlyLight sample; predicted in batches of 2, assembled in 64^3 blocks;
# decode_sample's host budget forces three z-slabs at 100^3
SAMPLE_PAD = 25
SAMPLE_BATCH = 2
SAMPLE_CHUNK = (64, 64, 64)
DECODE_RAM_MB = 1024.0
DECODE_BATCH = 4096
SYNTH_EXTENT = 120
# the visualize phase: the JAX package's renders of viz_inputs()
# (scripts/export_torch_fixtures.py --viz), the 7^3 patches of the crop,
# the volume plane of the second mosaic, and the 2D vote_debug crop: 128^2
# of the worm image at (104, 168), its four worms
VIZ_REF_NPZ = os.path.join(REPO, "parity", "torch_port_viz_ref.npz")
VIZ_REF_JSON = os.path.join(REPO, "parity", "torch_port_viz_ref.json")
VIZ_PS = (7, 7, 7)
VIZ_Z = 25
VIZ_CROP2D = (104, 168, 128)
CONS_OPS_PER_TERM = 15   # pp, sc, cnt: 4 ops each + 3 accumulations
RANK_OPS_PER_TERM = 7    # w_hh, w_hl (3), difference, product, sum


# the 2D path: the worm image of the 2D workload at BBBC010 size
# (520x696, 25x25 patches) under the two [vote_instances] settings the
# repo's 2D users run: (A) the 2D bench's (mws, sparse-data cover), (B)
# configs/bbbc010.toml's (label propagation, dense-data cover, overlaps)
IMG2D = (520, 696)
PS2D = (1, 25, 25)
PATH2D = {
    "A": dict(patchshape=PS2D, patch_threshold=0.5, fc_threshold=0.5,
              mws=True, select_patches_for_sparse_data=True),
    "B": dict(patchshape=PS2D, patch_threshold=0.9, fc_threshold=0.5,
              mws=False, select_patches_for_sparse_data=False,
              includeSinglePatchCCS=False, removeIntersection=True,
              overlapping_inst=True, skeletonize_foreground=False,
              numinst_threshs=(0.9, 0.1)),
}
# configs/bbbc010.toml [model] + [model.autoencoder] at full width
BBBC010_MODEL = dict(
    patchshape=PS2D, num_channels=1, num_fmaps=20,
    fmap_inc_factors=(2, 2, 2, 2), fmap_dec_factors=(1.0, 1.0, 1.0, 1.0),
    downsample_factors=((1, 2, 2),) * 4, kernel_size=3, num_repetitions=2,
    padding="same", upsampling="trans_conv", overlapping_inst=True,
    max_num_inst=2, train_code=True, code_units=512, ae_code_fmaps=8,
    ae_num_fmaps=(32, 64), ae_downsample_factors=((2, 2), (2, 2)),
    ae_kernel_size=3, ae_num_repetitions=2, ae_upsampling="resize_conv",
    num_code_samples=1024, dtype="float32")
MODEL2D_WINDOW = (512, 512)
MODEL2D_SEED = 0
# the train phase: the JAX package's f32 CPU train step and 200-step runs
# (scripts/export_torch_fixtures.py --train); the dense branch is
# configs/flylight_crop.toml's model with weights.seeded_tree weights
TRAIN_REF_NPZ = os.path.join(REPO, "parity", "torch_port_train_ref_f32.npz")
TRAIN_REF_JSON = os.path.join(REPO, "parity",
                              "torch_port_train_ref_f32.json")
TRAIN_DENSE_CONFIG = os.path.join(REPO, "configs", "flylight_crop.toml")
TRAIN_SEED = 0          # batch centres, dense weights, gradient samples
TRAIN_CORNER_KEY = 7    # the JAX step's PRNGKey (its code corners)
TRAIN_GRAD_SAMPLES = 256
# gate (a)'s valid branch: the code branch's model and trained parameters
# with valid padding, on 52^3 crops at the same centres (output 12^3,
# labels 18^3), held against the JAX package's CPU step
# (scripts/export_torch_fixtures.py --train-valid); its U-Net's valid
# 3x3x3 convolutions with fewer than 128 channels on one side (3 -> 20, 20
# -> 20, 20 -> 60, 60 -> 60, 60 -> 180, and the decoder's 120 -> 60, 60 ->
# 60, 40 -> 20, 20 -> 20) take their weight gradient from W1
# (ops/conv_kernels.py), one launch each
TRAIN_VALID_REF_NPZ = os.path.join(REPO, "parity",
                                   "torch_port_train_valid_ref_f32.npz")
TRAIN_VALID_REF_JSON = os.path.join(REPO, "parity",
                                    "torch_port_train_valid_ref_f32.json")
TRAIN_VALID_EXTENT = (52, 12)
TRAIN_VALID_ROUTED = 9
# gate (a) widens a limit to twice the JAX f32 step's own error against
# the JAX float64 step (on this batch up to 2.5e-3 on the trained code
# model's leaves, 2e-5 on the dense loss_patch), never past these caps
TRAIN_GRAD_CAP = 5e-3
TRAIN_LOSS_CAP = 1e-4
TRAIN_RUN_STEPS = 200   # gate (b): constant lr 1e-3, f32, device sampler
TRAIN_RUN_TAIL = 50     # mean loss over the last 50 steps
# gate (b)'s model: the crop model cut in width only (XLA on the CPU takes
# ~150 s per full-width step, so the JAX reference runs could not be made
# at full width); crops, batch, code, samples and sampler stay the config's
TRAIN_RUN_WIDTHS = {"num_fmaps": 4, "ae_num_fmaps": (8, 16)}
# the band's upper edge: the JAX runs' higher tail plus the larger of 5 %
# and their spread (a sampler flipping or transposing raw and not labels
# reads 1.050 / 0.983 in the CPU rehearsal, the port 0.809, JAX 0.860 /
# 0.874; 15 % above would let the transpose through); the lower edge
# keeps 15 %
TRAIN_RUN_ABOVE, TRAIN_RUN_BELOW = 0.05, 0.15

# the isbi phase: the ISBI 2012 protocol (configs/isbi_rehearsal.toml, the
# way users run it) on the stand-in data, data/synth_isbi as the JAX
# package wrote it (blosc), first held bit for bit against its zlib copy
# (scripts/export_torch_fixtures.py --isbi), then against the JAX
# package's CPU runs in parity/torch_port_isbi_ref_f32.*; the full-width
# configs/isbi2012.toml model beside it
ISBI_CONFIG = os.path.join(REPO, "configs", "isbi_rehearsal.toml")
ISBI2012_CONFIG = os.path.join(REPO, "configs", "isbi2012.toml")
ISBI_DATA = os.path.join(REPO, "data", "synth_isbi")
ISBI_ZLIB = os.path.join(REPO, "data", "synth_isbi_zlib")
ISBI_REF_NPZ = os.path.join(REPO, "parity", "torch_port_isbi_ref_f32.npz")
ISBI_REF_JSON = os.path.join(REPO, "parity", "torch_port_isbi_ref_f32.json")
ISBI_REHEARSAL = os.path.join(REPO, "parity", "isbi_rehearsal")
ISBI_TEST = ("isbi_test_00", "isbi_test_01")
ISBI_SEED = 0
ISBI_CLI_STEP = 1
# the seeded models' heads are scaled by this gain: their probabilities
# then sit far from the 0.5 thresholds, where float32 sums in another
# order (cuDNN, XLA) and the float16 store could flip a decision; their
# biases are then shifted so that ~89 % of a window is foreground and
# ~73 % of the affinities high (unshifted, the seeded model's foreground
# is 5 % and its map empty)
ISBI_HEAD_GAIN = 8.0
ISBI_HEAD_SHIFT = {"params/head_code_affs/bias": 6.0,
                   "params/head_fgbg_numinst/bias": 10.0}
ISBI_FWD_SAMPLES = 4096       # (d): sampled affinities and fg pixels
ISBI_STACK_CROP = 256         # (b): the three-slice stack's extent
ISBI_BATCH = (2, 160)         # (e): batch 2 of 160^2, the rehearsal's


# the swin phase: configs/flylight.toml's model with network_style
# "swinunetr" (3 stages, widths 20/40/80, heads 2/5/10, window 7, the
# 343-channel dense head and 3 numinst classes) at full width with seeded
# weights (weights.seeded_tree), on one 156^3 test window, the crop
# reflected to that size; the crop config's Swin train step on the train
# phase's batch; a 2D Swin at configs/bbbc010.toml's widths on the model2d
# window; all against the JAX package's f32 CPU runs
# (scripts/export_torch_fixtures.py --swin)
SWIN_CONFIG = os.path.join(REPO, "configs", "flylight.toml")
SWIN_REF_NPZ = os.path.join(REPO, "parity", "torch_port_swin_ref_f32.npz")
SWIN_REF_JSON = os.path.join(REPO, "parity", "torch_port_swin_ref_f32.json")
SWIN_SEED = 0
SWIN_SAMPLES = 4096   # seeded (channel, voxel) entries per head
SWIN_MODEL2D = dict(BBBC010_MODEL, network_style="swinunetr")


def swin_model_config(mod, path=SWIN_CONFIG, **kw):
    """[model] of ``path`` with network_style "swinunetr", float32, as
    ``mod.PPPConfig`` (either package's)."""
    return train_model_config(mod, path, network_style="swinunetr", **kw)


def swin_window():
    """(1, 3, 156, 156, 156) float32: the crop (clipmax 1500) reflected to
    configs/flylight.toml's test window (53 / 53 voxels per side)."""
    import tomllib

    import numpy as np

    from patchperpix_tpu_torch.utils.io import IoZarr

    with open(SWIN_CONFIG, "rb") as f:
        win = tomllib.load(f)["model"]["test_input_shape_valid"]
    raw = np.clip(IoZarr(FIXTURE).read(key="volumes/raw").astype(
        np.float32), 0, 1500.0) / 1500.0
    pads = [(0, 0)] + [((w - s) // 2, w - s - (w - s) // 2)
                       for w, s in zip(win, raw.shape[1:])]
    return np.pad(raw, pads, mode="reflect")[None]


def swin_positions(shape):
    """Seeded (channel, flat voxel) entries of a (C, *S) head."""
    import zlib

    import numpy as np

    rng = np.random.default_rng([SWIN_SEED, zlib.crc32(repr(
        tuple(shape)).encode())])
    return (rng.integers(0, shape[0], SWIN_SAMPLES),
            rng.integers(0, int(np.prod(shape[1:])), SWIN_SAMPLES))


def isbi_toml(path=ISBI_CONFIG):
    import tomllib

    with open(path, "rb") as f:
        return tomllib.load(f)


def isbi_vote_kwargs():
    """The rehearsal's [vote_instances] as the CLI's ``label`` composes it
    (patchshape and overlapping_inst from [model])."""
    cfg = isbi_toml()
    return dict(cfg["vote_instances"], patchshape=cfg["model"]["patchshape"],
                overlapping_inst=cfg["model"]["overlapping_inst"])


def isbi_eval_kwargs():
    """The rehearsal's [evaluation] as ``evaluate_labels`` keywords."""
    ev = isbi_toml()["evaluation"]
    return dict(localization_criterion=ev["localization_criterion"],
                assignment_strategy=ev["assignment_strategy"],
                add_general_metrics=ev["add_general_metrics"])


def isbi_gt(sample, split="test"):
    """(1, 512, 512) int32 ground truth of one stand-in sample, read from
    the blosc data by the port's store (``utils/blosc.py``)."""
    import numpy as np

    from patchperpix_tpu_torch.utils.io import IoZarr

    return IoZarr(os.path.join(ISBI_DATA, split, sample + ".zarr")).read(
        key="volumes/gt_instances").astype(np.int32)


def isbi_ideal(sample):
    """Ideal 25x25 affinities of one test sample's ground truth (the
    port's labels_to_affinities, numpy), its foreground and the labels."""
    import numpy as np

    from patchperpix_tpu_torch.ops.synthetic import labels_to_affinities

    gt = isbi_gt(sample)
    ps = np.asarray(isbi_toml()["model"]["patchshape"])
    return labels_to_affinities(gt, ps), gt > 0, gt


def isbi_stack():
    """The three-slice stack of gate (b): the ground truths of three
    training samples cut to ISBI_STACK_CROP^2 with their membranes filled
    by the nearest cell (touching cells: the stand-in's membranes are
    wider than the filter's radius-2 rings, which then never reach a
    neighbour's pixels), their ideal 25x25 affinities with seeded noise
    (sd 0.25, clipped to [0, 1]), and the foreground."""
    import numpy as np
    from scipy import ndimage

    from patchperpix_tpu_torch.ops.synthetic import labels_to_affinities

    n = ISBI_STACK_CROP
    labels = np.concatenate([isbi_gt(f"isbi_train_0{i}", "train")[:, :n, :n]
                             for i in range(3)])
    idx = ndimage.distance_transform_edt(labels == 0, return_distances=False,
                                         return_indices=True)
    labels = labels[tuple(idx)]
    affs = labels_to_affinities(labels, (1, 25, 25))
    rng = np.random.RandomState(ISBI_SEED)
    affs = np.clip(affs + rng.normal(0.0, 0.25, affs.shape), 0.0,
                   1.0).astype(np.float32)
    return affs, labels > 0


def isbi_seeded_tree(leaves):
    """``weights.seeded_tree`` over ``leaves`` with both heads scaled by
    ISBI_HEAD_GAIN and their biases shifted by ISBI_HEAD_SHIFT."""
    import numpy as np

    from patchperpix_tpu_torch.weights import seeded_tree

    tree = seeded_tree(leaves, ISBI_SEED)
    for name in tree:
        if name.startswith(("params/head_code_affs/",
                            "params/head_fgbg_numinst/")):
            tree[name] = (tree[name] * np.float32(ISBI_HEAD_GAIN)
                          + np.float32(ISBI_HEAD_SHIFT.get(name, 0.0)))
    return tree


def isbi_train_batch(data_mod):
    """Gate (e)'s fixed batch through ``data_mod`` (either package's
    train/data.py, numpy in both): one 160^2 raw crop and its 184^2 label
    crop (25x25 patch context) per training sample isbi_train_00 / _01,
    centred on a foreground pixel drawn with ISBI_SEED, no augmentation.
    Returns (raw (2, 1, 160, 160) f32, labels (2, 1, 184, 184) int32)."""
    import numpy as np

    n, size = ISBI_BATCH
    rng = np.random.RandomState(ISBI_SEED)
    raws, labels = [], []
    for i in range(n):
        s = data_mod.load_sample(
            os.path.join(ISBI_DATA, "train", f"isbi_train_0{i}.zarr"),
            "volumes/raw", "volumes/gt_instances")
        pts = np.argwhere(s.fg_mask)
        c = pts[rng.randint(len(pts))]
        crop = data_mod.CropSampler([s], data_mod.SamplerConfig(
            input_shape=(size,) * 2, output_shape=(size,) * 2,
            patchshape=(25, 25)))
        raws.append(crop._crop_at(s.raw, c, np.array((size,) * 2)))
        labels.append(crop._crop_at(s.labels, c,
                                    np.array((size + 24,) * 2)))
    return np.stack(raws).astype(np.float32), \
        np.stack(labels).astype(np.int32)


def isbi_sampler_config(data_mod, path=ISBI_CONFIG):
    """The sampler of the ISBI config at ``path`` (its train window, batch
    and pools; 25x25 patches; the default augmentations)."""
    toml = isbi_toml(path)
    shape = tuple(toml["model"]["train_input_shape_same"])
    smp = toml["training"]["sampling"]
    return data_mod.SamplerConfig(
        input_shape=shape, output_shape=shape, patchshape=(25, 25),
        batch_size=toml["training"]["batch_size"],
        probability_fg=smp["probability_fg"],
        probability_overlap=smp["probability_overlap"],
        probability_random=smp["probability_random"])

def isbi_cli_override(work):
    """An override of the rehearsal config, written into ``work``: the
    model in float32 and the data folders on the stand-in data."""
    path = os.path.join(work, "override.toml")
    with open(path, "w") as f:
        f.write('[model]\ndtype = "float32"\n[data]\n' + "".join(
            f'{k}_data = "{os.path.join(ISBI_DATA, k)}"\n'
            for k in ("train", "val", "test")))
    return path


def isbi_cli_argv(exps, override, expid):
    """Gate (c)'s CLI arguments before the tasks (either package's CLI)."""
    return ["-c", ISBI_CONFIG, "-c", override, "--root", exps, "-id", expid,
            "--checkpoint", str(ISBI_CLI_STEP)]


def isbi_window(data_mod):
    """Gate (d)'s input: the raw of isbi_test_00 as ``data_mod`` loads it,
    (1, 512, 512) float32."""
    return data_mod.load_sample(
        os.path.join(ISBI_DATA, "test", ISBI_TEST[0] + ".zarr"),
        "volumes/raw", "volumes/gt_instances").raw


def isbi_forward_positions(shape):
    """Gate (d)'s seeded (channel, flat pixel) positions in a (C, H, W)
    head."""
    import numpy as np

    rng = np.random.RandomState(ISBI_SEED)
    return (rng.randint(0, shape[0], ISBI_FWD_SAMPLES),
            rng.randint(0, int(np.prod(shape[1:])), ISBI_FWD_SAMPLES))

def emit(obj):
    print(json.dumps(obj), flush=True)


class HdfWrites:
    """While entered, records the last array ``IoHDF5`` was given for each
    (file, key), whole as it will be written, and the seconds and count of
    the ``close()`` calls that write a file (encode and write it);
    ``check()`` reads every recorded key back from its file."""

    def __init__(self):
        from patchperpix_tpu_torch.utils import io as tio

        self.cls = tio.IoHDF5
        self.real = (self.cls.write, self.cls.close)
        self.arrays, self.close_s, self.closes = {}, 0.0, 0

    def __enter__(self):
        real_write, real_close = self.real

        def write(io, out, bb=None, *, key, attrs=None):
            real_write(io, out, bb, key=key, attrs=attrs)
            self.arrays[(os.path.abspath(io.path), key.strip("/"))] = \
                io.read(key=key)

        def close(io):
            writing = io._dirty and io.mode != "r"
            t0 = time.perf_counter()
            real_close(io)
            if writing:
                self.close_s += time.perf_counter() - t0
                self.closes += 1

        self.cls.write, self.cls.close = write, close
        return self

    def __exit__(self, *exc):
        self.cls.write, self.cls.close = self.real

    def check(self) -> dict:
        import numpy as np

        t0 = time.perf_counter()
        equal = {}
        for (path, key), want in self.arrays.items():
            io = self.cls(path)
            got = io.read(key=key)
            io.close()
            equal[f"{os.path.basename(path)}:{key}"] = bool(
                got.dtype == want.dtype and np.array_equal(got, want))
        return {"keys_equal": equal, "write_s": self.close_s,
                "files_written": self.closes,
                "read_back_s": time.perf_counter() - t0,
                "bytes": sum(os.path.getsize(p)
                             for p in {p for p, _ in self.arrays})}


# {phase: {kernel name: launches}} of every counted run, for the kernels line
LAUNCHES: dict = {}


def count_launches(phase, kernels) -> dict:
    """The launches of ``kernels`` since their counts were set to 0, kept
    under ``phase`` for the kernels line."""
    out = {k.name: k.launches for k in kernels}
    LAUNCHES[phase] = out
    return out


def train_model_config(mod, path, **widths):
    """The [model] of the crop config at ``path`` as ``mod.PPPConfig`` (the
    JAX package's or the port's), in float32, with ``widths`` replaced."""
    import dataclasses
    import tomllib

    with open(path, "rb") as f:
        cfg = tomllib.load(f)
    return dataclasses.replace(mod.PPPConfig.from_config(
        {**cfg["model"], "num_channels": cfg["data"]["num_channels"],
         "dtype": "float32"}), **widths)


def train_batch(data_mod, centres=None, extent=(40, 40)):
    """The fixed batch of the train phase through ``data_mod`` (either
    package's train/data.py, numpy in both): the crop loaded as the CLI
    loads it (clipmax 1500), then per centre the raw crop of the input
    extent and the label crop of the output extent plus the 7^3 patch
    context (``extent``: 40^3 and 46^3 by default) as CropSampler crops
    them, no augmentation.  Without ``centres``, three foreground voxels
    drawn with TRAIN_SEED.  Returns (raw (3, 3, 40^3) f32, labels (3, 3,
    46^3) int32, centres, the sample)."""
    import numpy as np

    s = data_mod.load_sample(FIXTURE, "volumes/raw", "volumes/gt_instances",
                             clipmax=1500)
    if centres is None:
        pts = np.argwhere(s.fg_mask)
        centres = pts[np.random.RandomState(TRAIN_SEED).choice(
            len(pts), 3, replace=False)]
    crop = data_mod.CropSampler([s], data_mod.SamplerConfig(
        input_shape=(40,) * 3, output_shape=(40,) * 3, patchshape=(7,) * 3))
    raw = np.stack([crop._crop_at(s.raw, c, np.array((extent[0],) * 3))
                    for c in centres])
    labels = np.stack([crop._crop_at(s.labels, c,
                                     np.array((extent[1] + 6,) * 3))
                       for c in centres])
    return raw.astype(np.float32), labels.astype(np.int32), \
        np.asarray(centres, np.int64), s


def train_sampler_config(data_mod):
    """configs/flylight_crop_dec.toml's sampler: 40^3 crops (same
    padding), 7^3 patches, batch 3, pools 0.8 / 0.15 / 0.05, the default
    augmentations (mirror, transpose, intensity)."""
    return data_mod.SamplerConfig(
        input_shape=(40,) * 3, output_shape=(40,) * 3, patchshape=(7,) * 3,
        batch_size=3, probability_fg=0.8, probability_overlap=0.15,
        probability_random=0.05)


def leaf_rel_err(name, g, norm, samples):
    """How far the flat gradient leaf ``g`` is from a stored one, given by
    its L2 norm and its seeded entries: the larger of the relative norm
    difference and the relative L2 error on those entries."""
    import numpy as np

    g = np.asarray(g, np.float64).reshape(-1)
    w = np.asarray(samples, np.float64)
    return max(abs(np.linalg.norm(g) - norm) / max(norm, 1e-30),
               np.linalg.norm(g[grad_sample_index(name, g.size)] - w)
               / max(np.linalg.norm(w), 1e-30))


def grad_sample_index(name, size):
    """The seeded flat entries of one gradient leaf kept in the fixture."""
    import zlib

    import numpy as np

    rng = np.random.default_rng([TRAIN_SEED, zlib.crc32(name.encode())])
    return np.sort(rng.choice(size, min(size, TRAIN_GRAD_SAMPLES),
                              replace=False))


def path2d_inputs(setting, crop=None):
    """Inputs of the 2D path under ``setting`` ("A" or "B"), numpy only:
    worm labels (16 worms, seed 0) cut to the top-left ``crop`` (H, W) if
    given, their ideal 25x25 affinities, the foreground, and numinst (2 on
    the worms' crossing pixels under (B), where overlaps are modelled)."""
    import numpy as np

    from patchperpix_tpu_torch.ops.synthetic import (labels_to_affinities,
                                                     worm_labels)

    labels, crossing = worm_labels(*IMG2D, n_worms=16, seed=0,
                                   with_crossings=True)
    if crop is not None:
        labels = labels[:, :crop[0], :crop[1]]
        crossing = crossing[:, :crop[0], :crop[1]]
    fg = labels > 0
    numinst = fg.astype(np.uint8)
    if PATH2D[setting].get("overlapping_inst"):
        numinst[crossing] = 2
    return dict(labels=labels, fg=fg, numinst=numinst,
                affs=labels_to_affinities(labels, np.array(PS2D)))


def dense2d_affs():
    """Ideal 25x25 affinities of the dense2d image: 64 worms (seed 1) at
    520x696, about four times path2d's foreground."""
    import numpy as np

    from patchperpix_tpu_torch.ops.synthetic import (labels_to_affinities,
                                                     worm_labels)

    labels, _ = worm_labels(*IMG2D, n_worms=64, seed=1, with_crossings=True)
    return labels_to_affinities(labels, np.array(PS2D))


def model2d_sample(n=512):
    """Seeded raw 512x512 window and the flat pixel positions whose model
    outputs are compared."""
    import numpy as np

    rng = np.random.default_rng(MODEL2D_SEED)
    raw = rng.random((1,) + MODEL2D_WINDOW, dtype=np.float32)
    pos = np.sort(rng.choice(MODEL2D_WINDOW[0] * MODEL2D_WINDOW[1], n,
                             replace=False))
    return raw, pos


def crop_config(dtype):
    from patchperpix_tpu_torch.models import PPPConfig

    return PPPConfig(
        patchshape=(7, 7, 7), num_channels=3, num_fmaps=20,
        fmap_inc_factors=(3, 3), fmap_dec_factors=(1.0, 1.0),
        downsample_factors=((2, 2, 2), (2, 2, 2)), kernel_size=3,
        num_repetitions=2, padding="same", overlapping_inst=True,
        max_num_inst=2, train_code=True, code_units=176, ae_code_fmaps=22,
        ae_num_fmaps=(64, 128), num_code_samples=1024, dtype=dtype)


def vote_params():
    from patchperpix_tpu_torch.assembly import VoteInstancesParams

    return VoteInstancesParams(
        patchshape=(7, 7, 7), patch_threshold=0.6, fc_threshold=0.5,
        overlapping_inst=True, mws=True, select_patches_for_sparse_data=True,
        skeletonize_foreground=False, numinst_threshs=(0.9, 0.1))


def run_path(model, cfg, raw, dev):
    """One pass of the main path through the port's entry points."""
    import numpy as np
    import torch

    from patchperpix_tpu_torch.assembly import (numinst_from_probs,
                                                to_instance_seg)
    from patchperpix_tpu_torch.infer.fused import (decode_volume_device,
                                                   predict_volume_device)
    from patchperpix_tpu_torch.utils.postprocess import \
        remove_small_components

    vp = vote_params()
    t = {}
    torch.cuda.synchronize(dev)
    t0 = t1 = time.perf_counter()
    code, prob = predict_volume_device(model, raw, cfg, WIN, WIN, device=dev)
    torch.cuda.synchronize(dev)
    t["predict"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    prob = prob.cpu().numpy()
    numinst = numinst_from_probs(prob, vp)
    fg = numinst > 0
    dec = decode_volume_device(model, code, fg, cfg, device=dev)
    torch.cuda.synchronize(dev)
    t["decode"] = time.perf_counter() - t1
    inter = {}
    inst, _ = to_instance_seg(dec, fg, fg.copy(), numinst, vp, device=dev,
                              timings=t, intermediates=inter)
    inst[~fg] = 0
    inst = remove_small_components(inst, 400)
    t["total"] = time.perf_counter() - t0
    return dict(prob=prob, numinst=numinst, fg=fg, dec=dec, inst=inst,
                inter=inter, times=t)


def n_instances(inst):
    import numpy as np

    return int(len(np.unique(inst[inst > 0])))


def match_agreement(a, b):
    """(fraction of voxels in a > 0 or b > 0 whose ids agree after mapping
    a's ids onto b's by best-IoU Hungarian matching, identical up to
    relabelling)."""
    import numpy as np
    from scipy.optimize import linear_sum_assignment

    ia, ib = np.unique(a[a > 0]), np.unique(b[b > 0])
    iou = np.zeros((len(ia), len(ib)))
    for i, x in enumerate(ia):
        ma = a == x
        for j, y in enumerate(ib):
            mb = b == y
            inter = np.logical_and(ma, mb).sum()
            if inter:
                iou[i, j] = inter / np.logical_or(ma, mb).sum()
    mapped = np.zeros_like(b, dtype=np.int64)
    fresh = int(b.max()) + 1
    ri, ci = linear_sum_assignment(-iou) if iou.size else ([], [])
    matched = {ia[r]: ib[c] for r, c in zip(ri, ci) if iou[r, c] > 0}
    for x in ia:
        if x in matched:
            mapped[a == x] = matched[x]
        else:
            mapped[a == x] = fresh
            fresh += 1
    fgu = (a > 0) | (b > 0)
    agree = float(np.mean(mapped[fgu] == b[fgu])) if fgu.any() else 1.0
    pairs = np.unique(np.stack([a.ravel(), b.ravel()], 1), axis=0)
    same = (np.array_equal(a > 0, b > 0)
            and len(np.unique(pairs[:, 0])) == len(pairs)
            == len(np.unique(pairs[:, 1])))
    return agree, bool(same)


def time_pair(plain_fn, kernel_fn, dev, rounds=2):
    """Median ms of each, timed in turns plain, kernel, kernel, plain."""
    import statistics

    import torch

    def once(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end)

    plain, kernel = [], []
    for _ in range(rounds):
        plain.append(once(plain_fn))
        kernel.append(once(kernel_fn))
        kernel.append(once(kernel_fn))
        plain.append(once(plain_fn))
    return statistics.median(kernel), statistics.median(plain)


def check_kernels(run, dev):
    """Each kernel against its plain version on this run's affinities."""
    import torch

    from patchperpix_tpu_torch.ops import consensus as C
    from patchperpix_tpu_torch.ops import consensus_kernels as K

    ccfg = vote_params().consensus_config()
    dec = run["dec"]
    overlap = torch.as_tensor(run["numinst"] > 1, device=dev)
    hi, lo, _ = C._masks(dec, ccfg, overlap)
    a, b = dec * hi, (1.0 - dec) * lo
    half_k = K.consensus_half_cuda(a, b, hi, lo, ccfg)
    half_p = C.consensus_half_plain(dec, hi, lo, ccfg)
    torch.cuda.synchronize(dev)
    err_c = float((half_k - half_p).abs().max())
    ok_c = bool(torch.all((half_k - half_p).abs()
                          <= 1e-4 + 1e-4 * half_p.abs()))
    acc_k = K.rank_acc_cuda(hi, lo, half_k, ccfg)
    acc_p = C.rank_acc_plain(hi, lo, half_k, ccfg)
    torch.cuda.synchronize(dev)
    err_r = float((acc_k - acc_p).abs().max())
    ok_r = bool(torch.all((acc_k - acc_p).abs()
                          <= 1e-3 + 1e-4 * acc_p.abs()))
    # a second launch of each gives the same bits (sums in a fixed order)
    same_c = bool(torch.equal(half_k,
                              K.consensus_half_cuda(a, b, hi, lo, ccfg)))
    same_r = bool(torch.equal(acc_k, K.rank_acc_cuda(hi, lo, half_k, ccfg)))
    emit({"phase": "kernel_check", "consensus_max_abs_err": err_c,
          "consensus_ok": ok_c, "consensus_max_abs": float(
              half_p.abs().max()), "rank_max_abs_err": err_r,
          "rank_ok": ok_r, "rank_max_abs": float(acc_p.abs().max()),
          "consensus_two_launches_equal": same_c,
          "rank_two_launches_equal": same_r})
    if not (ok_c and ok_r):
        raise AssertionError("a CUDA kernel disagrees with its plain version")
    if not (same_c and same_r):
        raise AssertionError("two launches of a CUDA kernel differ")

    ms_c, plain_c = time_pair(
        lambda: C.consensus_half_plain(dec, hi, lo, ccfg),
        lambda: K.consensus_half_cuda(a, b, hi, lo, ccfg), dev)
    ms_r, plain_r = time_pair(
        lambda: C.rank_acc_plain(hi, lo, half_k, ccfg),
        lambda: K.rank_acc_cuda(hi, lo, half_k, ccfg), dev)

    # bounds from this run's inputs: bytes each input read once and each
    # output written once; operations over the pixel pairs the data needs
    # (eligible centers, both pixels hi or lo, not both lo)
    elig = ((hi != 0) | (lo != 0)).sum(0).double()
    n_lo = (lo != 0).sum(0).double()
    terms = float((elig * (elig - 1) / 2 - n_lo * (n_lo - 1) / 2).sum())
    f4 = 4 * hi.numel()
    bytes_c = 4 * f4 + half_k.numel() * half_k.element_size()
    bytes_r = 2 * f4 + half_k.numel() * half_k.element_size() \
        + 4 * acc_k.numel()

    emit({"phase": "kernel_bounds", "pair_terms": terms,
          "consensus_bytes": bytes_c, "rank_bytes": bytes_r})
    return [
        kernel_row(K.CONSENSUS, err_c, ms_c, plain_c,
                   bound_ms(bytes_c, CONS_OPS_PER_TERM * terms)),
        kernel_row(K.RANK, err_r, ms_r, plain_r,
                   bound_ms(bytes_r, RANK_OPS_PER_TERM * terms)),
    ]


def kernel_row(kernel, err, ms, plain_ms, bound, library_ms=None):
    return {"name": kernel.name, "route": "cuda", "source": kernel.source,
            "replaces": kernel.replaces.split(" ")[0], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms}


def bound_ms(nbytes, ops):
    """Least time for the work: bytes over the memory rate or operations
    over the f32 rate (outside the tensor cores), whichever is larger, at
    the H100 SXM5's published peaks (``utils/roofline.H100_SXM5``)."""
    from patchperpix_tpu_torch.utils.roofline import H100_SXM5

    tb = nbytes / (H100_SXM5.hbm_gbps * 1e9) * 1e3
    to = ops / (H100_SXM5.fp32_tflops * 1e12) * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


PROBE_CASE = (3, 768)   # n_slab, W of the probe's timed case
PROBE_ROUNDS = 25       # tens of microseconds a call, most of it host work:
                        # medians of 50


def probe_timed_case(PR, dev):
    """The probe's timed case (``PROBE_CASE``) on ``dev``: its seeded
    input, the plain version's result, and the callables that are timed:
    the kernel in each mode, the plain version, and the one PyTorch call
    that computes the same sums (a convolution along the row axis with
    the weights s + 1).  ``PR`` is a checkout's ``ops/probe`` module."""
    import torch
    import torch.nn.functional as F

    n_slab, W = PROBE_CASE
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((8, PR.V, W), generator=gen, device=dev)
    n_out, n_start = 8 - n_slab + 1, (n_slab - 1) * PR.V
    k = torch.arange(1, n_start + 1, dtype=torch.float32,
                     device=dev).reshape(1, 1, n_start, 1)
    fns = {"plain": lambda: PR.probe_window_plain(x, n_slab),
           "smem": lambda: PR.probe_window_cuda(x, n_slab, "smem"),
           "gmem": lambda: PR.probe_window_cuda(x, n_slab, "gmem"),
           "library": lambda: F.conv2d(x.reshape(1, 1, 8 * PR.V, W), k)[
               0, 0, :n_out * PR.V].reshape(n_out, PR.V, W)}
    return x, fns["plain"](), fns


def probe_times(fns, dev, rounds=PROBE_ROUNDS) -> dict:
    """ms of one call of each of ``probe_timed_case``'s callables, as
    ``time_pair`` times them (medians of 2 * rounds calls): each kernel
    in turns with the library call, so that both are timed beside the
    same work (a call timed after the plain version's many small
    launches reads slower), and the plain version alone."""
    ms, lib = time_pair(fns["library"], fns["smem"], dev, rounds)
    gmem, lib2 = time_pair(fns["library"], fns["gmem"], dev, rounds)
    _, plain = time_pair(fns["plain"], lambda: None, dev, rounds)
    return {"ms": ms, "gmem_ms": gmem, "plain_ms": plain, "library_ms": lib,
            "library_ms_beside_gmem": lib2}


def run_probe(dev):
    """Phase probe: the twelve cases and the one staging past 48 KB through
    the probe's entry point, then the case W = 768, n_slab = 3 timed
    against its plain version and against the library call
    (``probe_timed_case``, ``probe_times``)."""
    from patchperpix_tpu_torch.ops import probe as PR

    PR.PROBE.launches = 0
    cases = PR.run_cases(dev)
    launches = count_launches("probe", (PR.PROBE,))[PR.PROBE.name]
    emit({"phase": "probe", "launches": launches, "cases": cases})
    if not all(c["ok"] for c in cases) or launches != len(PR.CASES) + 1:
        raise AssertionError("the row-window probe failed")
    x, want, fns = probe_timed_case(PR, dev)
    err = float((fns["smem"]() - want).abs().max())
    if not float((fns["library"]() - want).abs().max()) < 1e-3:
        raise AssertionError("the probe's library yardstick disagrees")
    t = probe_times(fns, dev)
    n_start = (PROBE_CASE[0] - 1) * PR.V
    nbytes = 4 * (x.numel() + want.numel())
    row = kernel_row(PR.PROBE, err, t["ms"], t["plain_ms"],
                     bound_ms(nbytes, 2 * n_start * want.numel()),
                     t["library_ms"])
    row["launches"] = launches
    return row


# the conv_wgrad phase: the valid 3x3x3 convolutions of the published
# FlyLight ppp+dec U-Net (portbench/configs/flylight_ppp_dec.json: 20 / 60
# / 180 / 540 maps, up factors 1.2) at batch 2 of 140^3, as (input
# channels, output channels, input extent); the output extent is 2 less
WGRAD_SHAPES = ((3, 20, 140), (20, 20, 138), (20, 60, 68), (60, 60, 66),
                (60, 180, 32), (180, 180, 30), (180, 540, 14),
                (540, 540, 12), (396, 216, 20), (216, 216, 18),
                (132, 72, 32), (72, 72, 30), (44, 24, 56), (24, 24, 54))
WGRAD_BATCH = 2
WGRAD_TOL = 1e-5       # of the largest |dW| or |dB|: float32 sums in
                       # split-K order against float64


def wgrad_inputs(ci, co, e, dev, seed=0):
    """Seeded x (2, ci, e, e, e) and dy (2, co, e - 2, ...) on ``dev``."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((WGRAD_BATCH, ci, e, e, e), generator=gen, device=dev)
    dy = torch.randn((WGRAD_BATCH, co) + (e - 2,) * 3, generator=gen,
                     device=dev)
    return x, dy


def cudnn_wgrad(x, dy):
    """cuDNN's weight and bias gradient of the same convolution (the
    library's yardstick; the port's routed path never calls it)."""
    import torch

    w = torch.empty((dy.shape[1], x.shape[1], 3, 3, 3), device=x.device)
    return torch.ops.aten.convolution_backward(
        dy, x, w, [dy.shape[1]], [1, 1, 1], [0, 0, 0], [1, 1, 1], False,
        [0, 0, 0], 1, [False, True, True])[1:]


def wgrad_shape_row(ci, co, e, dev) -> dict:
    """One shape of the conv_wgrad phase: the kernel against its plain
    version in float64 (largest error over the largest |value|, for dW
    and dB), a second call's bits, and ms of the kernel, the plain
    version in float32 and cuDNN's exact-f32 weight gradient by its
    heuristic and by its best algorithm (``cudnn.benchmark``, after one
    call that chooses it), each in turns with the kernel
    (``time_pair``)."""
    import torch

    from patchperpix_tpu_torch.ops import conv_kernels as CK
    from patchperpix_tpu_torch.utils.device import exact_f32

    x, dy = wgrad_inputs(ci, co, e, dev)
    N, _, D, H, W = x.shape
    gflop = 2.0 * co * ci * 27 * dy[:, 0].numel() / 1e9
    plan = CK.device_plan(N, ci, co, D, H, W, x.device)
    row = {"ci": ci, "co": co, "extent": e, "gflop": gflop,
           "bound_ms": bound_ms(0, gflop * 1e9)[0], "plan": plan._asdict()}
    dw, db = CK.conv3d_wgrad_cuda(x, dy)
    rw, rb = CK.conv3d_wgrad_plain(x.double(), dy.double())
    row["err_w"] = float((dw.double() - rw).abs().max() / rw.abs().max())
    row["err_b"] = float((db.double() - rb).abs().max() / rb.abs().max())
    del rw, rb
    dw2, db2 = CK.conv3d_wgrad_cuda(x, dy)
    row["same_bits"] = bool(torch.equal(dw, dw2) and torch.equal(db, db2))

    def kernel():
        CK.conv3d_wgrad_cuda(x, dy)

    row["ms"], row["plain_ms"] = time_pair(
        lambda: CK.conv3d_wgrad_plain(x, dy), kernel, dev)
    bench = torch.backends.cudnn.benchmark
    with exact_f32():
        try:
            torch.backends.cudnn.benchmark = False
            _, row["library_ms"] = time_pair(lambda: cudnn_wgrad(x, dy),
                                             kernel, dev)
            torch.backends.cudnn.benchmark = True
            cudnn_wgrad(x, dy)
            _, row["library_best_ms"] = time_pair(
                lambda: cudnn_wgrad(x, dy), kernel, dev)
        finally:
            torch.backends.cudnn.benchmark = bench
    return row


def run_conv_wgrad(dev, shapes=WGRAD_SHAPES):
    """Phase conv_wgrad: the weight-gradient kernel
    (``ops/conv_kernels.py``) at each of ``shapes``, one line per shape
    (``wgrad_shape_row``), gated on the error and equal bits; the kernel
    row sums the shapes (the published U-Net's weight gradients of a
    training step), its library_ms cuDNN's best, its launches those of
    phase train's valid step (none where that has not run)."""
    from patchperpix_tpu_torch.ops import conv_kernels as CK

    rows = []
    for ci, co, e in shapes:
        row = wgrad_shape_row(ci, co, e, dev)
        emit({"phase": "conv_wgrad", **row})
        rows.append(row)
    bad = [r for r in rows if not (r["err_w"] <= WGRAD_TOL
                                   and r["err_b"] <= WGRAD_TOL
                                   and r["same_bits"])]
    if bad:
        raise AssertionError(f"the weight-gradient kernel disagrees: {bad}")
    total = {k: sum(r[k] for r in rows)
             for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                       "library_best_ms", "gflop")}
    emit({"phase": "conv_wgrad_total", **total})
    row = kernel_row(CK.WGRAD, max(max(r["err_w"], r["err_b"])
                                   for r in rows),
                     total["ms"], total["plain_ms"],
                     bound_ms(0, total["gflop"] * 1e9),
                     total["library_best_ms"])
    row["launches"] = LAUNCHES.get("train_step_valid", {}).get(
        CK.WGRAD.name)
    return row


def gt_match_counts(inst, labels, thr=0.5):
    """For each ground-truth label, the number of predicted instances with
    IoU >= thr."""
    import numpy as np

    pairs, n = np.unique(np.stack([labels.ravel(), inst.ravel()], 1), axis=0,
                         return_counts=True)
    size_gt = dict(zip(*np.unique(labels, return_counts=True)))
    size_pr = dict(zip(*np.unique(inst, return_counts=True)))
    out = {int(g): 0 for g in size_gt if g > 0}
    for (g, q), c in zip(pairs, n):
        if g > 0 and q > 0 and c / (size_gt[g] + size_pr[q] - c) >= thr:
            out[int(g)] += 1
    return out


def compare_reference_2d(setting, inst, inter, ref, meta):
    """A 2D run against the stored JAX float32 run of the same inputs."""
    import numpy as np

    want = ref[f"{setting}_inst"]
    fg_agree = float(np.mean((inst > 0) == (want > 0)))
    agree, same = match_agreement(inst, want)
    stages = {}
    for key in ("ranked_centers", "cover_centers", "thin_centers", "pairs"):
        got, exp = np.asarray(inter[key]), ref[f"{setting}_{key}"]
        stages[f"{key}_equal"] = bool(got.shape == exp.shape
                                      and np.array_equal(got, exp))
    rs, exp = np.asarray(inter["ranked_scores"]), \
        ref[f"{setting}_ranked_scores"]
    stages["sorted_scores_max_abs_err"] = float(np.abs(rs - exp).max()) \
        if rs.shape == exp.shape else None
    if stages["pairs_equal"]:
        stages["weights_max_abs_err"] = float(np.abs(
            inter["weights"] - ref[f"{setting}_weights"]).max())
    stages["n_components"] = [int(inter["n_components"]),
                              int(ref[f"{setting}_n_components"])]
    res = {"phase": "path2d_vs_jax_f32", "setting": setting,
           "size": list(inst.shape[1:]), "fg_agreement": fg_agree,
           "n_instances": n_instances(inst),
           "ref_n_instances": meta[setting]["n_instances"],
           "matched_agreement": agree, "identical_up_to_relabel": same,
           "stages": stages}
    emit(res)
    if fg_agree < 0.999:
        raise AssertionError(f"2D ({setting}) foreground agreement "
                             f"{fg_agree} < 0.999")
    if res["n_instances"] != res["ref_n_instances"]:
        raise AssertionError(f"2D ({setting}) instance count differs from "
                             "the JAX run")
    if agree < 0.99:
        raise AssertionError(f"2D ({setting}) instance agreement {agree} "
                             "< 0.99")


def assemble_2d(setting, inp, affs, dev, timings=None):
    """One 2D assembly through the port's entry point: (instance map,
    intermediates)."""
    from patchperpix_tpu_torch.assembly import (VoteInstancesParams,
                                                to_instance_seg)

    inter = {}
    inst, _ = to_instance_seg(
        affs, inp["fg"], inp["fg"].copy(), inp["numinst"],
        VoteInstancesParams(**PATH2D[setting]), device=dev,
        timings=timings, intermediates=inter)
    return inst, inter


def run_path2d(dev, kernels, capture=None):
    """Phase path2d.  Returns the launch counts of the counted runs and
    the device affinities of the full image (for kernels2d).  ``capture``
    (a ``CoverCapture``) is entered around the warm-up runs."""
    import numpy as np
    import torch

    ref, meta = np.load(REF2D_NPZ), json.load(open(REF2D_JSON))
    crop = tuple(meta["crop"])

    full = {s: path2d_inputs(s) for s in PATH2D}
    affs = torch.as_tensor(full["A"]["affs"], device=dev)  # same in (A), (B)
    warm = {}
    for s in PATH2D:
        t0 = time.perf_counter()
        if capture is not None and s == "B":
            with capture:
                assemble_2d(s, full[s], affs, dev)
        else:
            assemble_2d(s, full[s], affs, dev)
        torch.cuda.synchronize(dev)
        warm[s] = time.perf_counter() - t0
    for k in kernels:
        k.launches = 0
    runs = {}
    for s in PATH2D:
        torch.cuda.reset_peak_memory_stats(dev)
        t, t0 = {}, time.perf_counter()
        inst, inter = assemble_2d(s, full[s], affs, dev, t)
        t["total"] = time.perf_counter() - t0
        runs[s] = (inst, inter)
        emit({"phase": "path2d", "setting": s, "size": list(IMG2D),
              "patch": list(PS2D[1:]), "warmup_s": warm[s], "steady_s": t,
              "fg_vox": int(full[s]["fg"].sum()),
              "n_candidates": len(inter["ranked_centers"]),
              "n_cover": len(inter["cover_centers"]),
              "n_thin": len(inter["thin_centers"]),
              "n_pairs": len(inter["pairs"]),
              "n_components": inter["n_components"],
              "n_instances": n_instances(inst),
              "gt_instances": int(full[s]["labels"].max()),
              "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
    launches = count_launches("path2d", kernels)

    counts = gt_match_counts(runs["A"][0], full["A"]["labels"])
    emit({"phase": "path2d_gt", "setting": "A", "matches_per_gt_worm": counts})
    if not all(c == 1 for c in counts.values()):
        raise AssertionError(f"2D (A): a ground-truth worm is not matched "
                             f"by exactly one instance: {counts}")
    for s in PATH2D:
        if crop == IMG2D:
            inst, inter = runs[s]
        else:
            inp = path2d_inputs(s, crop)
            inst, inter = assemble_2d(
                s, inp, torch.as_tensor(inp["affs"], device=dev), dev)
        compare_reference_2d(s, inst, inter, ref, meta)
    return launches, affs, full


def bounds_2d(ag, tgt, cfg, half):
    """What the data needs of the 2D kernels: operations over the eligible
    pair terms, as for the 3D kernels; bytes: the mid plane (the center
    gate), the stack's columns at eligible centers (the rest holds the
    sentinel), the target plane; K3 writes the whole half (zeros
    included), K4 reads only the half's live entries (both ends
    target-eligible) and writes one plane."""
    import torch

    from patchperpix_tpu_torch.ops import consensus as C

    hi, lo = C.derive_2d(ag, tgt, cfg)
    elig = ((hi != 0) | (lo != 0)).sum(0).double()
    n_lo = (lo != 0).sum(0).double()
    terms = float((elig * (elig - 1) / 2 - n_lo * (n_lo - 1) / 2).sum())
    del hi, lo
    p = int(cfg.ps[1])
    n_centers = int((ag[cfg.mid] >= 0).sum())
    win = C._target_windows_2d(tgt, 2 * p - 1)
    live = 0
    for dy in range(p):
        n = (win[dy + p - 1] * tgt).sum(dim=(1, 2))
        live += int(n[p:].sum() if dy == 0 else n.sum())
    in_bytes = 4 * (2 * tgt.numel() + cfg.P * n_centers)
    size = half.element_size()
    return {"pair_terms": terms, "eligible_centers": n_centers,
            "target_pixels": int((tgt != 0).sum()),
            "live_half_entries": live,
            "consensus2d_bytes": in_bytes + half.numel() * size,
            "rank2d_bytes": in_bytes + live * size + 4 * tgt.numel(),
            "dense_bytes": 4 * (ag.numel() + tgt.numel())
            + half.numel() * size}

class CoverCapture:
    """While entered, keeps the arguments of the assembly's last cover
    calls (``vote_instances.greedy_cover_device`` with dense data, the
    cascade's input, and ``thin_out_cover_device``, the thin cover's): the
    affinity tensor on its device, the mask to cover, the candidates'
    centers in order, the overlap rows, the patch shape and fc.  The calls
    themselves run as they are."""

    def __init__(self):
        from patchperpix_tpu_torch.assembly import vote_instances as vi

        self.vi = vi
        self.real = (vi.greedy_cover_device, vi.thin_out_cover_device)
        self.cascade = self.thin = None

    def __enter__(self):
        import numpy as np

        greedy, thin = self.real

        def case(affs, mask, patches, ps, fc, overlap=None):
            centers = np.array([c for c, _ in patches], dtype=np.int64)
            rows = np.zeros(len(centers), bool) if overlap is None \
                else np.asarray(overlap)[tuple(centers.T)] > 0
            return {"affs": affs, "mask": np.array(mask, dtype=bool),
                    "centers": centers, "overlap_rows": rows,
                    "ps": tuple(int(p) for p in ps), "fc": float(fc)}

        def rec_greedy(affs, mask, ranked, ps, fc_threshold=0.5,
                       overlap=None, sparse_data=True, mesh=None):
            if not sparse_data and ranked:
                self.cascade = case(affs, mask, ranked, ps, fc_threshold,
                                    overlap)
            return greedy(affs, mask, ranked, ps, fc_threshold=fc_threshold,
                          overlap=overlap, sparse_data=sparse_data, mesh=mesh)

        def rec_thin(affs, mask, selected, ps, fc_threshold=0.5):
            if selected:
                self.thin = case(affs, mask, selected, ps, fc_threshold)
            return thin(affs, mask, selected, ps, fc_threshold=fc_threshold)

        self.vi.greedy_cover_device = rec_greedy
        self.vi.thin_out_cover_device = rec_thin
        return self

    def __exit__(self, *exc):
        self.vi.greedy_cover_device, self.vi.thin_out_cover_device = self.real


def pix_thresholds(ps):
    """The dense-data cascade's pixel thresholds (below P // 2)."""
    import numpy as np

    mid = int(np.prod(ps)) // 2
    return tuple(t for t in (500, 100, 50, 10, 0) if t < mid)


COVER_DEVICE_KERNELS = ("pack_masks", "pack_running", "thin_cover_kernel",
                        "cover_cascade_kernel")


def cover_split(fn, dev, rounds=3):
    """Where a cover wrapper's call goes on the card: the device ms of each
    of its kernels (``COVER_DEVICE_KERNELS``), a mean over ``rounds`` calls
    under ``torch.profiler`` (where the profiler sees no device time, the
    call's CUDA-event ms instead), and each phase's share of the loop
    kernel's cycles (the ``clock64`` sums in the statistics that ``fn``
    returns last; K5's bounding and walking warps run side by side, so its
    shares need not add up to 1)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    st = fn()[-1]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        for _ in range(rounds):
            fn()
        torch.cuda.synchronize(dev)
    dev_ms = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = next((k for k in COVER_DEVICE_KERNELS if k in e.name), None)
        if name is not None:
            t = e.device_time if hasattr(e, "device_time") else e.cuda_time
            dev_ms[name] = dev_ms.get(name, 0.0) + t / rounds / 1e3
    out = {"device_ms": dev_ms or None}
    if not dev_ms:
        out["call_ms"] = time_pair(fn, fn, dev, 1)[0]
    cyc = dict(st["cycles"])
    total = cyc.pop("total")
    out["cycle_share"] = {k: v / total if total else 0.0
                          for k, v in cyc.items()}
    return out


def cover_case(name, kind, inp, dev, max_it=None, rounds=2):
    """Phase cover_kernels, one case: K5 (``kind`` "cascade") or K6
    ("thin", capped at ``max_it`` where given) and its plain version (the
    host loop, ``ops/cover.py``) on a captured input.  Gate: ``selected``
    equal bit for bit, and the cascade's still-uncovered volume equal (the
    counts are integers: no tolerance).  Times: CUDA events, medians of
    plain, kernel, kernel, plain (each call from the host's arrays to the
    host's selection).  Bound: the bytes the loop needs (the n affinity
    columns, the mask, centers and overlap rows read once, the selection
    and the volume written once) against 2 P operations for each window
    this run counted; the iteration counts beside it, and ``split``
    (``cover_split``: device ms by kernel, the loop's cycles by phase)."""
    import numpy as np

    from patchperpix_tpu_torch.ops import cover as COV
    from patchperpix_tpu_torch.ops import cover_kernels as CK

    a, mask, centers = inp["affs"], inp["mask"], inp["centers"]
    ps, fc, ovl = inp["ps"], inp["fc"], inp["overlap_rows"]
    n, P, V = len(centers), int(np.prod(ps)), int(mask.size)
    if kind == "cascade":
        ths = pix_thresholds(ps)
        kernel = CK.COVER_CASCADE

        def kern():
            return CK.cover_cascade_cuda(a, mask, centers, ovl, ps, fc, ths)

        def plain():
            return COV.cover_cascade_plain(a, mask, centers, ovl, ps, fc, ths)
        sel_k, run_k, st = kern()
        sel_p, run_p = plain()
        equal = bool(np.array_equal(sel_k, sel_p)
                     and np.array_equal(run_k, run_p))
        err = max(int(np.abs(sel_k.astype(int) - sel_p).max()),
                  int(np.abs(run_k.astype(int) - run_p).max()))
        windows = st["bounded"] + st["visits"] + st["takes"]
        nbytes = 4 * n * P + 2 * V + 12 * n + 2 * n
    else:
        kernel = CK.THIN_COVER

        def kern():
            return CK.thin_cover_cuda(a, mask, centers, ps, fc, max_it=max_it)

        def plain():
            return COV.thin_cover_plain(a, mask, centers, ps, fc, max_it)
        sel_k, st = kern()
        sel_p = plain()
        equal = bool(np.array_equal(sel_k, sel_p))
        err = int(np.abs(sel_k.astype(int) - sel_p).max())
        windows = n + st["refreshes"] + st["picks"]
        if "full" in st:
            windows += st["full"]["refreshes"] + st["full"]["picks"]
        nbytes = 4 * n * P + V + 12 * n + n
    ms, plain_ms = time_pair(plain, kern, dev, rounds)
    split = cover_split(kern, dev, rounds=1 if max_it is not None else 3)
    bound = bound_ms(nbytes, 2 * P * windows)
    res = {"phase": "cover_kernels", "case": name, "kernel": kernel.name,
           "n": n, "P": P, "volume": list(mask.shape),
           "selected": int(sel_k.sum()), "plain_selected": int(sel_p.sum()),
           "selected_equal": equal, "max_abs_err": err, "stats": st,
           "max_it": max_it, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound[0], "bound_by": bound[1], "bytes": nbytes,
           "windows": windows, "split": split}
    emit(res)
    if not equal:
        raise AssertionError(f"cover_kernels {name}: {kernel.name} differs "
                             f"from its plain version")
    if max_it is not None and not st["capped"]:
        raise AssertionError(f"cover_kernels {name}: the cap was not reached")
    return kernel_row(kernel, float(err), ms, plain_ms, bound)


def run_cover_kernels_3d(cap, dev):
    """Phase cover_kernels on the f32 main path's thin-cover input, then the
    same input with the lazy loop capped at a quarter of its candidates
    (the full loop takes over).  Information, no gate: K6 on the JAX
    package's own greedy cover of the crop (parity/torch_port_ref_f32.npz,
    whose ranked order differs from the port's where scores tie within
    float32 noise) with the port's affinities, against the JAX run's thin
    cover.  Returns K6's row."""
    import numpy as np

    from patchperpix_tpu_torch.ops import cover_kernels as CK

    row = cover_case("f32_path_thin", "thin", cap.thin, dev)
    n = len(cap.thin["centers"])
    cover_case("f32_path_thin_capped", "thin", cap.thin, dev,
               max_it=n // 4, rounds=1)
    ref, t = np.load(REF_NPZ), cap.thin
    sel, st = CK.thin_cover_cuda(t["affs"], t["mask"], ref["cover_centers"],
                                 t["ps"], t["fc"])
    kept = ref["cover_centers"][sel]
    emit({"phase": "cover_kernels", "case": "f32_path_thin_of_jax_cover",
          "n": len(sel), "selected": int(sel.sum()),
          "jax_selected": len(ref["thin_centers"]),
          "equal_jax_thin_centers": bool(
              kept.shape == ref["thin_centers"].shape
              and np.array_equal(kept, ref["thin_centers"])),
          "stats": st})
    return row


def run_cover_kernels_2d(cap, dev):
    """Phase cover_kernels on 2D setting (B)'s cascade input and its
    thin-cover input.  Returns K5's row."""
    row = cover_case("path2d_B_cascade", "cascade", cap.cascade, dev)
    cover_case("path2d_B_thin", "thin", cap.thin, dev)
    return row


def check_kernels_2d(affs, full, dev):
    """Phase kernels2d: the 2D kernels against their plain versions on
    path2d's inputs; errors and two launches under both settings and both
    storage types, times and bounds for (A) in f32; then the same checks and
    the kernels' times on dense2d."""
    import dataclasses

    import torch

    from patchperpix_tpu_torch.assembly import VoteInstancesParams
    from patchperpix_tpu_torch.ops import consensus as C
    from patchperpix_tpu_torch.ops import consensus_kernels as K

    def close(got, want, atol, rtol):
        d = (got.float() - want.float()).abs()
        return float(d.max()), bool(torch.all(d <= atol + rtol
                                              * want.float().abs()))

    def check(name, cfg, ag, tgt):
        """Errors of both kernels and the two-launch test under one
        configuration; also the kernel's half, for the timing."""
        half_k = K.consensus_half_2d_cuda(ag, tgt, cfg)
        half_p = C.consensus_half_2d_plain(ag, tgt, cfg)
        err_c, ok_c = close(half_k, half_p, 1e-4,
                            2.0 ** -7 if cfg.cons_bf16 else 1e-4)
        max_c = float(half_p.float().abs().max())
        del half_p
        acc_k = K.rank_acc_2d_cuda(ag, tgt, half_k, cfg)
        acc_p = C.rank_acc_2d_plain(ag, tgt, half_k, cfg)
        torch.cuda.synchronize(dev)
        err_r, ok_r = close(acc_k, acc_p, 1e-3, 1e-4)
        # a second launch of each gives the same bits (sums in a fixed order)
        same_c = bool(torch.equal(half_k,
                                  K.consensus_half_2d_cuda(ag, tgt, cfg)))
        same_r = bool(torch.equal(acc_k,
                                  K.rank_acc_2d_cuda(ag, tgt, half_k, cfg)))
        return {"case": name, "half": "bf16" if cfg.cons_bf16 else "f32",
                "consensus2d_max_abs_err": err_c, "consensus2d_ok": ok_c,
                "consensus2d_max_abs": max_c,
                "consensus2d_two_launches_equal": same_c,
                "rank2d_max_abs_err": err_r, "rank2d_ok": ok_r,
                "rank2d_max_abs": float(acc_p.abs().max()),
                "rank2d_two_launches_equal": same_r}, half_k

    def gate(checks, what):
        if not all(c["consensus2d_ok"] and c["rank2d_ok"] for c in checks):
            raise AssertionError(f"a 2D CUDA kernel disagrees with its plain "
                                 f"version ({what})")
        if not all(c["consensus2d_two_launches_equal"]
                   and c["rank2d_two_launches_equal"] for c in checks):
            raise AssertionError(f"two launches of a 2D CUDA kernel differ "
                                 f"({what})")

    def kernel_ms(cfg, ag, tgt, half):
        ms_c, _ = time_pair(lambda: None,
                            lambda: K.consensus_half_2d_cuda(ag, tgt, cfg),
                            dev)
        ms_r, _ = time_pair(lambda: None,
                            lambda: K.rank_acc_2d_cuda(ag, tgt, half, cfg),
                            dev)
        return ms_c, ms_r

    def setting(s, bf16):
        cfg = dataclasses.replace(
            VoteInstancesParams(**PATH2D[s]).consensus_config(),
            cons_bf16=bf16)
        overlap = torch.as_tensor(full[s]["numinst"] > 1, device=dev)
        return (cfg,) + C.gated_stack_2d(affs, cfg, overlap)

    cfg, ag, tgt = setting("A", False)
    first, half = check("A", cfg, ag, tgt)
    checks = [first]
    for s, bf16 in (("A", True), ("B", False), ("B", True)):
        c, h = check(s, *setting(s, bf16))
        checks.append(c)
        del h
    err_c, err_r = first["consensus2d_max_abs_err"], \
        first["rank2d_max_abs_err"]
    emit({"phase": "kernels2d_check", "checks": checks})
    gate(checks, "path2d")

    ms_c, plain_c = time_pair(
        lambda: C.consensus_half_2d_plain(ag, tgt, cfg),
        lambda: K.consensus_half_2d_cuda(ag, tgt, cfg), dev)
    ms_r, plain_r = time_pair(
        lambda: C.rank_acc_2d_plain(ag, tgt, half, cfg),
        lambda: K.rank_acc_2d_cuda(ag, tgt, half, cfg), dev)
    cfg16 = dataclasses.replace(cfg, cons_bf16=True)
    half16 = K.consensus_half_2d_cuda(ag, tgt, cfg16)
    ms_c16, ms_r16 = kernel_ms(cfg16, ag, tgt, half16)
    del half16
    b = bounds_2d(ag, tgt, cfg, half)
    emit({"phase": "kernels2d_bounds", "setting": "A", **b,
          "consensus2d_bf16_ms": ms_c16, "rank2d_bf16_ms": ms_r16})
    rows = [
        kernel_row(K.CONSENSUS2D, err_c, ms_c, plain_c,
                   bound_ms(b["consensus2d_bytes"],
                            CONS_OPS_PER_TERM * b["pair_terms"])),
        kernel_row(K.RANK2D, err_r, ms_r, plain_r,
                   bound_ms(b["rank2d_bytes"],
                            RANK_OPS_PER_TERM * b["pair_terms"])),
    ]
    del ag, tgt, half

    # dense2d: setting (A)'s configuration on the 64-worm image
    affs_d = torch.as_tensor(dense2d_affs(), device=dev)
    res = {"phase": "kernels2d_dense", "size": list(IMG2D),
           "n_worms": 64, "checks": []}
    for bf16 in (False, True):
        c = dataclasses.replace(cfg, cons_bf16=bf16)
        ag, tgt = C.gated_stack_2d(affs_d, c)
        chk, half = check("dense2d", c, ag, tgt)
        res["checks"].append(chk)
        ms_c, ms_r = kernel_ms(c, ag, tgt, half)
        res[f"consensus2d_{chk['half']}_ms"] = ms_c
        res[f"rank2d_{chk['half']}_ms"] = ms_r
        if not bf16:
            b = bounds_2d(ag, tgt, c, half)
            res.update(b)
            res["consensus2d_bound_ms"], res["consensus2d_bound_by"] = \
                bound_ms(b["consensus2d_bytes"],
                         CONS_OPS_PER_TERM * b["pair_terms"])
            res["rank2d_bound_ms"], res["rank2d_bound_by"] = bound_ms(
                b["rank2d_bytes"], RANK_OPS_PER_TERM * b["pair_terms"])
        del ag, tgt, half
    emit(res)
    gate(res["checks"], "dense2d")
    return rows


def check_model2d(dev):
    """Phase model2d: the seeded BBBC010 model against the JAX outputs."""
    import numpy as np
    import torch

    from patchperpix_tpu_torch.infer.fused import (decode_volume_device,
                                                   lift_2d,
                                                   predict_volume_device)
    from patchperpix_tpu_torch.models import PPPConfig
    from patchperpix_tpu_torch.weights import build_model, seeded_tree

    meta, ref = json.load(open(MODEL2D_JSON)), np.load(MODEL2D_NPZ)
    cfg = PPPConfig(**BBBC010_MODEL)
    model = build_model(cfg, seeded_tree(meta["leaves"], meta["seed"]),
                        device=dev)
    raw, pos = model2d_sample(meta["n_positions"])
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    code, prob = predict_volume_device(model, raw, cfg, MODEL2D_WINDOW,
                                       MODEL2D_WINDOW, device=dev)
    torch.cuda.synchronize(dev)
    t_predict = time.perf_counter() - t0
    fg = np.zeros(MODEL2D_WINDOW, bool)
    fg.reshape(-1)[pos] = True
    t0 = time.perf_counter()
    dec = decode_volume_device(model, code, fg, cfg, device=dev)
    torch.cuda.synchronize(dev)
    t_decode = time.perf_counter() - t0
    dec4, fg3 = lift_2d(dec, fg)
    if tuple(dec4.shape) != (625, 1) + MODEL2D_WINDOW or fg3.shape != \
            (1,) + MODEL2D_WINDOW:
        raise AssertionError(f"model2d shapes {tuple(dec4.shape)}")
    pos_t = torch.as_tensor(pos, device=dev)
    got = {"code": code.reshape(cfg.code_units, -1)[:, pos_t].T,
           "prob": prob.reshape(3, -1)[:, pos_t].T,
           "patches": dec.reshape(625, -1)[:, pos_t].T.reshape(-1, 25, 25)}
    res = {"phase": "model2d", "n_parameters": meta["n_parameters"],
           "window": list(MODEL2D_WINDOW), "n_positions": len(pos),
           "predict_s": t_predict, "decode_s": t_decode}
    ok = True
    for key, val in got.items():
        val, want = val.cpu().numpy(), ref[key]
        d = np.abs(val - want)
        res[f"{key}_max_abs_err"] = float(d.max())
        ok &= bool(np.isfinite(val).all()
                   and np.all(d <= 1e-4 + 1e-4 * np.abs(want)))
    emit(res)
    if not ok:
        raise AssertionError("the 2D model disagrees with the JAX outputs")


def extra_peak_gb(dev, base):
    """Device memory a run needed above what was allocated before it (the
    caller resets the peak and reads ``base`` just before the run)."""
    import torch

    return (torch.cuda.max_memory_allocated(dev) - base) / 1e9


def sample_params(**kw):
    """The main path's [vote_instances] for blockwise assembly from a
    prediction store."""
    import dataclasses

    return dataclasses.replace(
        vote_params(), blockwise=True, numinst_key="volumes/pred_numinst",
        chunksize=SAMPLE_CHUNK, **kw)


def map_agreement(got, want, fg_got, fg_want):
    """Phase 4's three numbers for two instance maps."""
    import numpy as np

    agree, same = match_agreement(got, want)
    return {"fg_agreement": float(np.mean(fg_got == fg_want)),
            "n_instances": n_instances(got), "ref_n_instances":
            n_instances(want), "matched_agreement": agree,
            "identical_up_to_relabel": same}


def gate_agreement(res, what):
    if res["fg_agreement"] < 0.999:
        raise AssertionError(f"{what}: foreground agreement "
                             f"{res['fg_agreement']} < 0.999")
    if res["n_instances"] != res["ref_n_instances"]:
        raise AssertionError(f"{what}: instance count differs")
    if res["matched_agreement"] < 0.99:
        raise AssertionError(f"{what}: instance agreement "
                             f"{res['matched_agreement']} < 0.99")


def check_border_window(model, cfg, store, fg_mask, numinst, dev):
    """Gate (e): K1 and K2 on the sample's first border block window, with
    the window's center_valid, against their plain versions; also the
    peak device memory of that one block, its window read included."""
    import dataclasses

    import numpy as np
    import torch

    from patchperpix_tpu_torch.assembly import to_instance_seg
    from patchperpix_tpu_torch.assembly.blockwise import (
        _crop, _global_center_valid, get_offsets)
    from patchperpix_tpu_torch.infer.decode import CodeAffReader, CodeDecoder
    from patchperpix_tpu_torch.ops import consensus as C
    from patchperpix_tpu_torch.ops import consensus_kernels as K

    vp = sample_params()
    rad = np.asarray(vp.patchshape) // 2
    vol = np.array(fg_mask.shape)
    nz = np.argwhere(fg_mask)
    bb_start = np.maximum(nz.min(axis=0) - rad, 0)
    bb_stop = np.minimum(nz.max(axis=0) + rad + 1, vol)
    chunk = np.asarray(SAMPLE_CHUNK)
    for off in get_offsets(bb_stop - bb_start, chunk):
        w_start = bb_start + off - rad
        w_stop = bb_start + off + chunk + rad
        core = np.minimum(bb_start + off + chunk, bb_stop) - bb_start - off
        cv = _global_center_valid(w_start, w_stop - w_start, vol, rad)
        if cv is not None:
            break
    if cv is None:
        raise AssertionError("(e) the sample has no border block")
    reader = CodeAffReader(store, CodeDecoder(model, cfg, DECODE_BATCH, dev))
    ni = _crop(numinst, w_start, w_stop)
    fg_w = _crop(fg_mask, w_start, w_stop)
    # the block as compute_blocks runs it (its core as the mask), its
    # window read included, measured like the blockwise run's peak
    mask_w = np.zeros_like(fg_w)
    mask_w[tuple(slice(int(r), int(r + c)) for r, c in zip(rad, core))] = \
        True
    mask_w &= fg_w & (ni <= 1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    affs = reader.read_window(w_start, w_stop)
    to_instance_seg(affs, fg_w, mask_w, ni, dataclasses.replace(
        vp, return_intermediates=True, center_valid=cv), device=dev)
    peak_block = extra_peak_gb(dev, base)
    reader.close()
    ccfg = vp.consensus_config()
    cv_t = torch.as_tensor(cv, device=dev)
    hi, lo, _ = C._masks(affs, ccfg, torch.as_tensor(ni > 1, device=dev),
                         cv_t)
    a, b = affs * hi, (1.0 - affs) * lo
    half_k = K.consensus_half_cuda(a, b, hi, lo, ccfg)
    half_p = C.consensus_half_plain(affs, hi, lo, ccfg)
    err_c = float((half_k - half_p).abs().max())
    ok_c = bool(torch.all((half_k - half_p).abs()
                          <= 1e-4 + 1e-4 * half_p.abs()))
    del half_p
    acc_k = K.rank_acc_cuda(hi, lo, half_k, ccfg)
    acc_p = C.rank_acc_plain(hi, lo, half_k, ccfg)
    err_r = float((acc_k - acc_p).abs().max())
    ok_r = bool(torch.all((acc_k - acc_p).abs()
                          <= 1e-3 + 1e-4 * acc_p.abs()))
    same_c = bool(torch.equal(half_k,
                              K.consensus_half_cuda(a, b, hi, lo, ccfg)))
    same_r = bool(torch.equal(acc_k, K.rank_acc_cuda(hi, lo, half_k, ccfg)))
    gated = int((~cv_t).sum())
    live_gated = bool(hi[:, ~cv_t].any() or lo[:, ~cv_t].any())
    del hi, lo, a, b, half_k, acc_k, acc_p, affs
    torch.cuda.empty_cache()
    res = {"window_start": [int(v) for v in w_start],
           "window_shape": [int(v) for v in w_stop - w_start],
           "centers_gated_out": gated,
           "consensus_max_abs_err": err_c, "consensus_ok": ok_c,
           "rank_max_abs_err": err_r, "rank_ok": ok_r,
           "consensus_two_launches_equal": same_c,
           "rank_two_launches_equal": same_r}
    if not (ok_c and ok_r) or live_gated:
        raise AssertionError(f"(e) a kernel disagrees with its plain version "
                             f"on a border window: {res}")
    if not (same_c and same_r):
        raise AssertionError("(e) two launches differ on a border window")
    return res, peak_block


def synthetic_case(dev, work):
    """Gate (d): benchmarks/blockwise_scale.py's tube volume at 120^3."""
    import numpy as np

    from patchperpix_tpu_torch.assembly import VoteInstancesParams
    from patchperpix_tpu_torch.assembly.blockwise import (
        BlockStats, blockwise_vote_instances_zarr)
    from patchperpix_tpu_torch.ops.synthetic import (labels_to_affinities,
                                                     synth_labels)
    from patchperpix_tpu_torch.utils.io import IoZarr

    ps = (7, 7, 7)
    labels = synth_labels(SYNTH_EXTENT)
    affs = labels_to_affinities(labels, np.array(ps)).astype(np.float16)
    path = os.path.join(work, "synth.zarr")
    io = IoZarr(path, mode="w")
    io.create("volumes/pred_affs", affs.shape, np.float16,
              chunks=(affs.shape[0], 32, 32, 32))
    io.write(affs, key="volumes/pred_affs")
    io.close()
    del affs
    # benchmarks/blockwise_scale.py's [vote_instances]
    vp = VoteInstancesParams(
        patchshape=ps, patch_threshold=0.5, fc_threshold=0.5, mws=True,
        blockwise=True, chunksize=(64, 64, 64), consensus_bf16=True,
        select_patches_for_sparse_data=True)
    stats = BlockStats()
    t0 = time.perf_counter()
    inst, _ = blockwise_vote_instances_zarr(path, vp, chunksize=(64, 64, 64),
                                            device=dev, stats=stats)
    wall = time.perf_counter() - t0
    n_gt = n_instances(labels)
    counts = gt_match_counts(inst, labels)
    res = {"extent": SYNTH_EXTENT, "fg_vox": int((labels > 0).sum()),
           "n_gt": n_gt, "n_pred": n_instances(inst), "wall_s": wall,
           "matches_per_gt": counts, **stats.as_dict()}
    if res["n_pred"] != n_gt or n_gt != 12 or \
            not all(c == 1 for c in counts.values()):
        raise AssertionError(f"(d) synthetic 120^3: {res}")
    return res


def reader_split(store, dec, fg, extent, dev):
    """One stitch-sized window (a block's where the run had no stitch
    window) at the volume's center, read from a cold store, split into its
    stages: zlib (the store read), the decoder (codes to the dense window
    on the card), the crossing of the f16 dense window (staged), each
    synchronised."""
    import numpy as np
    import torch

    from patchperpix_tpu_torch.utils.io import IoZarr

    vol = np.array(fg.shape)
    extent = np.asarray(extent if extent else SAMPLE_CHUNK)
    lo = np.maximum((vol - extent) // 2, 0)
    box = tuple(slice(int(a), int(min(a + e, v)))
                for a, e, v in zip(lo, extent, vol))
    out = {"window": [b.stop - b.start for b in box]}
    for key in ("volumes/pred_code", "volumes/pred_affs"):
        io = IoZarr(store)
        t0 = time.perf_counter()
        data = io.read(bb=(slice(None),) + box, key=key)
        out["zlib_s_" + key.split("_")[-1]] = time.perf_counter() - t0
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if key.endswith("code"):
            dec.decode_dense(data, fg[box]).half().float()
            name = "decoder_s"
        else:
            torch.from_numpy(data).to(dev).float()
            name = "crossing_s_affs"
        torch.cuda.synchronize(dev)
        out[name] = time.perf_counter() - t0
        io.close()
    return out


def run_blockwise(model, cfg, raw, run, dev, kernels, then=None):
    """Phase blockwise (gates (a)-(e)); returns the launches of
    ``kernels`` (K1, K2, then any other kernel the blocks run, each at
    least once) in the counted code-reader run.  ``then(ctx)`` runs
    before the phase's temporary store goes (the multidevice phase)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from patchperpix_tpu_torch.assembly import (numinst_from_probs,
                                                to_instance_seg)
    from patchperpix_tpu_torch.assembly.blockwise import (
        BlockStats, blockwise_vote_instances, blockwise_vote_instances_zarr)
    from patchperpix_tpu_torch.infer.decode import (CodeDecoder,
                                                    _slab_height,
                                                    decode_sample)
    from patchperpix_tpu_torch.infer.fused import predict_volume_device
    from patchperpix_tpu_torch.infer.predict import (predict_sample_to_zarr,
                                                     predict_volume)
    from patchperpix_tpu_torch.utils.io import IoZarr
    from patchperpix_tpu_torch.utils.postprocess import relabel

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="ppp_blockwise_")
    try:
        sample = np.pad(raw, [(0, 0)] + [(SAMPLE_PAD, SAMPLE_PAD)] * 3,
                        mode="reflect")
        store = os.path.join(work, "sample.zarr")
        t = {}
        # a warm-up (batch-2 convolution setup), then predict alone, then
        # predict + store: the store write is the difference
        predict_volume(model, sample, cfg, WIN, WIN, SAMPLE_BATCH,
                       device=dev)
        t0 = time.perf_counter()
        predict_volume(model, sample, cfg, WIN, WIN, SAMPLE_BATCH,
                       device=dev)
        t["predict"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        predict_sample_to_zarr(model, sample, cfg, WIN, WIN, store,
                               batch_size=SAMPLE_BATCH, device=dev)
        t["store_write"] = time.perf_counter() - t0 - t["predict"]

        # (a) the stored heads against the device-resident prediction
        io = IoZarr(store)
        code16 = io.read(key="volumes/pred_code")
        prob16 = io.read(key="volumes/pred_numinst")
        code_d, prob_d = predict_volume_device(model, sample, cfg, WIN, WIN,
                                               device=dev)
        err_a = max(
            float((torch.as_tensor(code16, device=dev).float()
                   - code_d).abs().max()),
            float((torch.as_tensor(prob16, device=dev).float()
                   - prob_d).abs().max()))
        del code_d, prob_d
        emit({"phase": "blockwise_store", "sample": list(sample.shape),
              "pred_code": list(code16.shape),
              "store_mb": sum(os.path.getsize(os.path.join(d, f))
                              for d, _, fs in os.walk(store) for f in fs)
              / 2 ** 20, "heads_max_abs_err": err_a})
        if not err_a <= 1e-3:
            raise AssertionError(f"(a) stored heads differ by {err_a}")
        numinst = numinst_from_probs(prob16.astype(np.float32),
                                     sample_params())
        fg = numinst > 0
        del code16, prob16

        # the code-reader path, counted from zero
        vp = sample_params()
        dec = CodeDecoder(model, cfg, DECODE_BATCH, dev)
        stats = BlockStats()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        inst_c, fg_c = blockwise_vote_instances_zarr(
            store, vp, SAMPLE_CHUNK, os.path.join(work, "codes"),
            decoder=dec, device=dev, stats=stats)
        torch.cuda.synchronize(dev)
        t["blockwise_codes"] = time.perf_counter() - t0
        launches = count_launches("blockwise", kernels)
        peak_codes = extra_peak_gb(dev, base)
        k1, k2 = kernels[:2]
        if not (launches[k2.name] == stats.blocks_consensus >= 1
                and launches[k1.name] == stats.blocks_consensus
                + stats.stitch_consensus
                and all(launches[k.name] >= 1 for k in kernels[2:])):
            raise AssertionError(f"blockwise launches {launches} disagree "
                                 f"with the run: {stats.as_dict()}")

        # the staged variant: decode to a dense store in z-slabs, assemble
        sz = _slab_height(sample.shape[1:], cfg.patchsize, cfg.code_units,
                          DECODE_RAM_MB)
        t0 = time.perf_counter()
        decode_sample(model, store, cfg, batch_size=DECODE_BATCH,
                      max_ram_mb=DECODE_RAM_MB, device=dev)
        t["decode"] = time.perf_counter() - t0
        stats_s = BlockStats()
        t0 = time.perf_counter()
        inst_s, fg_s = blockwise_vote_instances_zarr(
            store, vp, SAMPLE_CHUNK, os.path.join(work, "staged"),
            device=dev, stats=stats_s)
        torch.cuda.synchronize(dev)
        t["blockwise_staged"] = time.perf_counter() - t0
        if (stats.reader, stats_s.reader) != ("CodeAffReader",
                                              "ZarrAffReader"):
            raise AssertionError(f"(b) the runs read through {stats.reader} "
                                 f"and {stats_s.reader}")
        # (b) equal after relabel, equal foreground
        same_b = bool(np.array_equal(fg_c, fg_s) and np.array_equal(
            relabel(inst_c), relabel(inst_s)))
        readers = reader_split(store, dec, fg, stats.stitch_extent, dev)

        # whole volume at 100^3 (information only: it differs by design)
        mask = fg.copy()
        mask[numinst > 1] = False
        affs16 = IoZarr(store).read(key="volumes/pred_affs")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        affs = torch.as_tensor(affs16, device=dev).float()
        inter_w = {}
        inst_w, _ = to_instance_seg(affs, fg, mask, numinst, vote_params(),
                                    device=dev, intermediates=inter_w)
        torch.cuda.synchronize(dev)
        t_whole = time.perf_counter() - t0
        peak_whole = extra_peak_gb(dev, base)
        del affs
        torch.cuda.empty_cache()
        emit({"phase": "blockwise", "sample": list(sample.shape[1:]),
              "chunksize": list(SAMPLE_CHUNK), "wall_s": t,
              "codes": stats.as_dict(), "staged": stats_s.as_dict(),
              "decode_slabs": -(-sample.shape[1] // sz), "slab_z": sz,
              "launches": launches, "fg_vox": int(fg_c.sum()),
              "n_instances": n_instances(inst_c),
              "codes_equal_staged_after_relabel": same_b,
              "stitch_window_read": readers,
              "peak_mem_gb_codes_run": peak_codes,
              "whole_volume": {
                  "seconds": t_whole, "peak_mem_gb": peak_whole,
                  "n_instances": n_instances(inst_w),
                  **{f"vs_blockwise_{k}": v for k, v in map_agreement(
                      inst_c * fg, inst_w * fg, fg_c > 0, fg).items()}}})
        if not same_b:
            raise AssertionError("(b) the code-reader map differs from the "
                                 "staged map")

        # (c) the f32 crop against the JAX package's blockwise run
        ref, meta = np.load(BW_REF_NPZ), json.load(open(BW_REF_JSON))
        sl = tuple(slice(0, int(n)) for n in meta["size"])
        fg32, ni32 = run["fg"][sl], run["numinst"][sl]
        stats_c = BlockStats()
        t0 = time.perf_counter()
        inst32, fg32_out = blockwise_vote_instances(
            run["dec"][(slice(None),) + sl].contiguous(), fg32, ni32, vp,
            chunksize=tuple(meta["chunksize"]), device=dev, stats=stats_c)
        res_c = map_agreement(inst32, ref["inst"], fg32_out > 0,
                              ref["fg"].astype(bool))
        emit({"phase": "blockwise_vs_jax_f32", "size": meta["size"],
              "chunksize": meta["chunksize"],
              "seconds": time.perf_counter() - t0,
              "ref_cpu_seconds": meta["cpu_seconds"], **res_c,
              **stats_c.as_dict()})
        if stats_c.blocks < 8:
            raise AssertionError("(c) fewer than 2 blocks per axis")
        gate_agreement(res_c, "(c) blockwise vs the JAX f32 run")

        # (d) synthetic 120^3, (e) a border window
        emit({"phase": "blockwise_synthetic", **synthetic_case(dev, work)})
        res_e, peak_block = check_border_window(model, cfg, store, fg,
                                                numinst, dev)
        emit({"phase": "blockwise_border_window", **res_e,
              "peak_mem_gb_one_block": peak_block,
              "phase_wall_s": time.perf_counter() - t_phase})
        if then is not None:
            then({"run": run, "store": store, "vp": vp, "work": work,
                  "affs16": affs16, "fg": fg, "mask": mask,
                  "numinst": numinst, "inst_w": inst_w, "inter_w": inter_w,
                  "t_whole": t_whole, "inst_s": inst_s,
                  "t_staged": t["blockwise_staged"]})
        del affs16
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


def viz_inputs():
    """The arrays the visualize phase renders (numpy, all from the
    repository): the JAX CLI's f32 map of the crop, the crop's raw, ideal
    7^3 affinities of the map scaled by 0.5 + 0.5 x the stored decoded
    center channel, the f32 reference run's foreground, pairs, weights
    and thinned cover centers."""
    import numpy as np

    from patchperpix_tpu_torch.ops.synthetic import labels_to_affinities
    from patchperpix_tpu_torch.utils.io import IoZarr

    ref, cli_ref = np.load(REF_NPZ), np.load(CLI_REF_NPZ)
    inst = cli_ref["inst"]
    scale = (0.5 + 0.5 * ref["dec_center"]).astype(np.float32)
    affs = labels_to_affinities(inst, VIZ_PS) * scale[None]
    return {"inst": inst,
            "raw": IoZarr(FIXTURE).read(key="volumes/raw").astype(
                np.float32),
            "affs": affs.astype(np.float32), "fg": ref["fg"],
            "pairs": ref["pairs"], "weights": ref["weights"],
            "selected": ref["thin_centers"].astype(np.int64)}


def viz_renders(inp, dev):
    """The port's renders of ``viz_inputs()`` on ``dev``, under the keys of
    parity/torch_port_viz_ref.npz."""
    from patchperpix_tpu_torch.assembly import debug_viz as DV
    from patchperpix_tpu_torch.visualize import instances as VI
    from patchperpix_tpu_torch.visualize import patches as VP

    return {
        "inst_plain": VI.render_instances(inp["inst"], device=dev),
        "inst_raw": VI.render_instances(inp["inst"], raw=inp["raw"],
                                        device=dev),
        "inst_outline": VI.render_instances(inp["inst"], raw=inp["raw"],
                                            outline=True, device=dev),
        "mosaic": VP.patch_mosaic(inp["affs"], VIZ_PS, device=dev),
        "mosaic_z": VP.patch_mosaic(inp["affs"], VIZ_PS, z=VIZ_Z,
                                    selected=inp["selected"], device=dev),
        "tiles": DV.render_patch_tiles(inp["affs"], inp["fg"], VIZ_PS,
                                       device=dev),
        "edges": DV.render_graph_edges(inp["pairs"], inp["weights"],
                                       inp["fg"].shape, VIZ_PS),
    }


def run_visualize(ctx, dev, kernels, kernels2d):
    """Phase visualize (inside phase cli, on its f32 experiment): (a) ``-d
    visualize`` with show_patches, each PNG read back with the port's
    reader against the port's render of the stored arrays; (b) the port's
    renders on the card against the JAX package's in
    parity/torch_port_viz_ref.npz, bit for bit; (c) ``label`` twice on the
    crop, plain and with vote_debug, save_mip and save_tif: K1 / K2 once
    per label (vote_debug's second pass labels the given graph, with no
    consensus or rank, as in the JAX package), the vote_debug map equal to
    the plain one and to phase cli's, (7 * 50)^2 canvases, the MIPs and
    the TIF; (d) 2D ``do_all`` with vote_debug on a 128^2 crop of the worm
    image, setting (A): K3 / K4 once each, (25 * 128)^2 canvases, the map
    equal to ``to_instance_seg``'s without vote_debug."""
    import numpy as np

    from patchperpix_tpu_torch import cli
    from patchperpix_tpu_torch.assembly import VoteInstancesParams
    from patchperpix_tpu_torch.assembly import vote_instances as TV
    from patchperpix_tpu_torch.utils.io import (IoHDF5, IoZarr, read_png,
                                                read_tif)
    from patchperpix_tpu_torch.visualize import instances as VI
    from patchperpix_tpu_torch.visualize import patches as VP

    t_phase = time.perf_counter()
    t = {}
    argv, sample = ctx["argv"] + ["-id", "f32"], ctx["sample"]
    inst_dir = os.path.join(ctx["paths"]["test_instanced"], str(CLI_STEP))
    proc_dir = os.path.join(ctx["paths"]["test_processed"], str(CLI_STEP))
    res_path = os.path.join(inst_dir, sample + ".hdf")

    # (a) the visualize task on the cli phase's results
    t0 = time.perf_counter()
    cli.main(argv + ["--set", "visualize.show_patches=true", "-d",
                     "visualize"])
    t["a_visualize_task"] = time.perf_counter() - t0
    inst = IoHDF5(res_path).read(key="vote_instances")
    affs = IoZarr(os.path.join(proc_dir, sample + ".zarr")).read(
        key="volumes/pred_affs").astype(np.float32)
    png_inst = read_png(os.path.join(inst_dir, sample + ".png"))
    png_mosaic = read_png(os.path.join(proc_dir, sample + "_patches.png"))
    a = {"instance_png": list(png_inst.shape),
         "patches_png": list(png_mosaic.shape),
         "instance_png_equal": bool(np.array_equal(
             png_inst, VI.render_instances(inst, device=dev))),
         "patches_png_equal": bool(np.array_equal(png_mosaic, VP.mosaic_png(
             VP.patch_mosaic(affs, VIZ_PS, device=dev))))}
    del affs

    # (b) the port's renders against the JAX package's
    t0 = time.perf_counter()
    ref = np.load(VIZ_REF_NPZ)
    got = viz_renders(viz_inputs(), dev)
    b = {k: bool(v.shape == ref[k].shape and v.dtype == ref[k].dtype
                 and np.array_equal(v, ref[k])) for k, v in got.items()}
    t["b_renders"] = time.perf_counter() - t0

    # (c) label, plain and with vote_debug / save_mip / save_tif
    t0 = time.perf_counter()
    runs = {}
    for key, extra in (("viz_plain", []), ("viz_debug", [
            "--set", "vote_instances.vote_debug=true",
            "--set", "vote_instances.save_mip=true",
            "--set", "vote_instances.save_tif=true"])):
        for k in kernels:
            k.launches = 0
        cli.main(argv + ["--set", f"vote_instances.res_key={key}"] + extra
                 + ["-d", "label"])
        phase = key.replace("viz_", "visualize_")
        runs[phase] = count_launches(phase, kernels)
    t["c_labels"] = time.perf_counter() - t0
    res = IoHDF5(res_path)
    maps = {k: res.read(key=k) for k in ("vote_instances", "viz_plain",
                                         "viz_debug")}
    canvases = {k: res.read(key=k) for k in ("vote_debug", "vote_debug2")}
    tif = read_tif(os.path.join(inst_dir, sample + ".tif"))
    mips = [read_png(os.path.join(inst_dir, sample + f))
            for f in (".png", "_cleaned.png")]
    side = VIZ_PS[1] * inst.shape[1]
    c = {"map_equal_plain": bool(np.array_equal(maps["viz_debug"],
                                                maps["viz_plain"])),
         "map_equal_cli": bool(np.array_equal(maps["viz_debug"],
                                              maps["vote_instances"])),
         "canvas_shapes": {k: list(v.shape) for k, v in canvases.items()},
         "canvas_nonzero": {k: int(np.count_nonzero(v))
                            for k, v in canvases.items()},
         "canvases_finite": bool(all(np.isfinite(v).all()
                                     for v in canvases.values())),
         "tif": [list(tif.shape), str(tif.dtype), int(tif.max())],
         "mips": [list(m.shape) for m in mips]}
    c_ok = (c["map_equal_plain"] and c["map_equal_cli"]
            and c["canvases_finite"]
            and all(v == [side, side] for v in c["canvas_shapes"].values())
            and all(n > 0 for n in c["canvas_nonzero"].values())
            and tif.shape == inst.shape and tif.dtype == np.uint16
            and int(tif.max()) == n_instances(maps["viz_debug"])
            and all(m.shape == inst.shape[1:] + (3,) for m in mips)
            and all(n == {k.name: 1 for k in kernels} for n in runs.values()))

    # (d) 2D vote_debug through do_all on a crop of the worm image
    t0 = time.perf_counter()
    y0, x0, n = VIZ_CROP2D
    inp = path2d_inputs("A")
    labels = inp["labels"][:, y0:y0 + n, x0:x0 + n]
    fg = labels > 0
    from patchperpix_tpu_torch.ops.synthetic import labels_to_affinities
    affs2 = labels_to_affinities(labels, np.array(PS2D))
    store = os.path.join(ctx["work"], "viz2d", "worms.zarr")
    out = IoZarr(store, mode="w")
    for key, arr in (("volumes/pred_affs", affs2),
                     ("volumes/pred_fgbg", fg.astype(np.float32))):
        out.create(key, arr.shape, np.float32)
        out.write(arr, key=key)
    out.close()
    vp = VoteInstancesParams(**PATH2D["A"], fg_key="volumes/pred_fgbg",
                             vote_debug=True)
    for k in kernels2d:
        k.launches = 0
    res2 = TV.do_all(store, vp, os.path.join(ctx["work"], "viz2d", "inst"),
                     device=dev)
    launches2d = count_launches("visualize_2d", kernels2d)
    res2 = IoHDF5(res2)
    plain2, _ = TV.to_instance_seg(affs2, fg, fg.copy(), fg.astype(np.uint8),
                                   VoteInstancesParams(**PATH2D["A"]),
                                   device=dev)
    plain2[~fg] = 0
    canv2 = {k: res2.read(key=k) for k in ("vote_debug", "vote_debug2")}
    d = {"launches": launches2d, "fg_px": int(fg.sum()),
         "n_instances": n_instances(res2.read(key="vote_instances")),
         "map_equal": bool(np.array_equal(res2.read(key="vote_instances"),
                                          plain2)),
         "canvas_shapes": {k: list(v.shape) for k, v in canv2.items()},
         "canvas_nonzero": {k: int(np.count_nonzero(v))
                            for k, v in canv2.items()}}
    side2 = PS2D[1] * n
    d_ok = (d["map_equal"] and d["n_instances"] >= 2
            and all(v == [side2, side2] for v in d["canvas_shapes"].values())
            and all(v > 0 for v in d["canvas_nonzero"].values())
            and all(v == 1 for v in launches2d.values()))
    t["d_2d"] = time.perf_counter() - t0
    emit({"phase": "visualize", "launches": runs, "a": a, "b": b,
          "c": c, "d": d, "seconds": t,
          "phase_wall_s": time.perf_counter() - t_phase})
    if not (a["instance_png_equal"] and a["patches_png_equal"]):
        raise AssertionError(f"visualize (a): a PNG differs from the render "
                             f"of its arrays: {a}")
    if not all(b.values()):
        raise AssertionError(f"visualize (b): a render differs from the JAX "
                             f"package's: {b}")
    if not c_ok:
        raise AssertionError(f"visualize (c) failed: {c}")
    if not d_ok:
        raise AssertionError(f"visualize (d) failed: {d}")


def cli_hdf(writes, inst, rm, attrs, argv, exps, sample, want_rm):
    """Phase cli's HDF5 results: every array of the f32 run's result
    file read back equal to what the run gave ``IoHDF5`` (the map, the
    foreground, the masked and dilated maps, postprocess's
    ``vote_instances_rm_60``), the JAX package's ``offset`` /
    ``resolution`` attributes; then the JAX package's own result file of
    the same chain through the port's ``evaluate``: its metric dict
    (|avg_f1_cov - JAX's| <= 0.01, equal instance counts)."""
    import shutil

    import numpy as np

    from patchperpix_tpu_torch import cli
    from patchperpix_tpu_torch.utils.io import IoHDF5

    back = writes.check()
    jax_meta = json.load(open(JAX_RESULT_JSON))
    inst_dir = os.path.join(cli.create_folders(exps, "jax_result")[
        "test_instanced"], str(CLI_STEP))
    os.makedirs(inst_dir, exist_ok=True)
    shutil.copyfile(JAX_RESULT, os.path.join(inst_dir, sample + ".hdf"))
    t0 = time.perf_counter()
    paths = cli.main(argv + ["-id", "jax_result", "-d", "evaluate"])
    eval_s = time.perf_counter() - t0
    got = json.load(open(os.path.join(paths["test_evaluated"],
                                      str(CLI_STEP), sample + ".json")))
    want = jax_meta["metrics"]
    out = {"phase": "cli_hdf", **back,
           "rm_60_equal": bool(rm.dtype == np.uint16
                               and np.array_equal(rm, want_rm)),
           "attrs": {k: np.asarray(v).tolist() for k, v in attrs.items()},
           "jax_result": {
               "evaluate_s": eval_s,
               "avg_f1_cov_score": got["general"]["avg_f1_cov_score"],
               "jax_avg_f1_cov_score": want["general"]["avg_f1_cov_score"],
               "num_pred": got["general"]["Num Pred"],
               "jax_num_pred": want["general"]["Num Pred"],
               "jax_n_instances": jax_meta["n_instances"],
               "n_instances_read": n_instances(IoHDF5(JAX_RESULT).read(
                   key=jax_meta["res_key"])),
               "metrics_equal": got == want}}
    emit(out)
    j = out["jax_result"]
    if not (back["keys_equal"] and all(back["keys_equal"].values())):
        raise AssertionError(f"cli: an .hdf result read back differs: "
                             f"{back['keys_equal']}")
    if not out["rm_60_equal"] or out["attrs"] != {
            "offset": [0, 0, 0], "resolution": [1, 1, 1]}:
        raise AssertionError(f"cli: postprocess's key or the attributes "
                             f"differ: {out}")
    if abs(j["avg_f1_cov_score"] - j["jax_avg_f1_cov_score"]) > 0.01 or \
            j["num_pred"] != j["jax_num_pred"] or \
            j["n_instances_read"] != j["jax_n_instances"]:
        raise AssertionError(f"cli: the JAX result through the port's "
                             f"evaluate: {j}")


def run_cli(dev, kernels, then=None):
    """Phase cli: the reference CLI's predict -> decode -> label ->
    evaluate through the port's CLI on the crop, gated against the JAX
    package's run of the same chain; ``then(ctx)`` (phase visualize) on
    its f32 experiment; then infer_fused in bf16."""
    import shutil
    import tempfile

    import numpy as np

    from patchperpix_tpu_torch import cli, weights
    from patchperpix_tpu_torch.assembly import vote_instances as TV
    from patchperpix_tpu_torch.evaluate import instance_metrics as TM
    from patchperpix_tpu_torch.utils.io import IoHDF5
    from patchperpix_tpu_torch.utils.postprocess import (
        relabel, remove_small_components)
    from patchperpix_tpu_torch.utils.skeleton import skeletonize

    t_phase = time.perf_counter()
    out_root = os.path.join(REPO, "experiments_out")
    os.makedirs(out_root, exist_ok=True)
    work = tempfile.mkdtemp(prefix="ppp_cli_", dir=out_root)
    sample = os.path.splitext(os.path.basename(FIXTURE))[0]
    # per-task wall seconds and the skeletons' calls, by the module
    # calling skeletonize
    task_s, skel = {}, {"label": [], "evaluate": []}
    real_tasks = {n: getattr(cli, n) for n in (
        "mknet", "predict", "decode", "label", "evaluate", "infer_fused")}

    def timed(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                task_s[name] = task_s.get(name, 0.0) \
                    + time.perf_counter() - t0
        return run

    def skel_shim(where):
        def run(volume, *a, **kw):
            t0 = time.perf_counter()
            out = skeletonize(volume, *a, **kw)
            skel[where].append((time.perf_counter() - t0, out))
            return out
        return run

    try:
        data = os.path.join(work, "data")
        os.makedirs(data)
        os.symlink(FIXTURE, os.path.join(data, os.path.basename(FIXTURE)))
        exps = os.path.join(work, "exps")
        override = os.path.join(work, "override.toml")

        def write_override(dtype):
            with open(override, "w") as f:
                if dtype:
                    f.write(f'[model]\ndtype = "{dtype}"\n')
                f.write("[data]\n" + "".join(
                    f'{k}_data = "{data}"\n' for k in ("train", "val",
                                                       "test")))
        for expid in ("f32", "bf16"):
            weights.write_checkpoint(weights.load_npz(),
                                     os.path.join(exps, expid, "train"),
                                     CLI_STEP)
        for name, fn in real_tasks.items():
            setattr(cli, name, timed(name, fn))
        TV.skeletonize = skel_shim("label")
        TM.skeletonize = skel_shim("evaluate")

        # the f32 run, its kernel launches counted from zero
        write_override("float32")
        argv = ["-c", CLI_CONFIG, "-c", override, "--root", exps,
                "--checkpoint", str(CLI_STEP)]
        for k in kernels:
            k.launches = 0
        with HdfWrites() as writes:
            paths = cli.main(argv + ["-id", "f32", "-d", "mknet", "predict",
                                     "decode", "label", "evaluate",
                                     "postprocess"])
        launches = count_launches("cli_f32", kernels)
        res = IoHDF5(os.path.join(paths["test_instanced"], str(CLI_STEP),
                                  sample + ".hdf"))
        inst = res.read(key="vote_instances")
        fg = res.read(key="vote_foreground") > 0
        rm = res.read(key="vote_instances_rm_60")
        attrs = res.attrs("vote_instances")
        res.close()
        metrics = json.load(open(os.path.join(
            paths["test_evaluated"], str(CLI_STEP), sample + ".json")))
        ref = np.load(CLI_REF_NPZ)
        meta = json.load(open(CLI_REF_JSON))
        shape = tuple(int(s) for s in ref["shape"])

        def unpack(key):
            n = int(np.prod(shape))
            return np.unpackbits(ref[key])[:n].reshape(shape).astype(bool)
        ref_fg, ref_skel = unpack("fg"), unpack("skel")
        fg_agree = float(np.mean(fg == ref_fg))
        agree, same = match_agreement(inst, ref["inst"])
        run_skel = skel["label"][0][1] > 0 if len(skel["label"]) == 1 \
            else None
        skel_of_ref_fg = skeletonize(ref_fg) > 0
        score = metrics["general"]["avg_f1_cov_score"]
        f32 = {
            "phase": "cli", "run": "f32 predict decode label evaluate",
            "launches": launches, "fg_agreement": fg_agree,
            "foreground_equal": bool(np.array_equal(fg, ref_fg)),
            "n_instances": n_instances(inst),
            "ref_n_instances": meta["n_instances"],
            "matched_agreement": agree, "identical_up_to_relabel": same,
            "own_fg_vox": int((inst > 0).sum()),
            "ref_own_fg_vox": meta["own_fg_vox"],
            "skeletonize_calls_in_label": len(skel["label"]),
            "skel_vox": None if run_skel is None else int(run_skel.sum()),
            "ref_skel_vox": meta["skel_vox"],
            "skel_of_ref_fg_equal": bool(np.array_equal(skel_of_ref_fg,
                                                        ref_skel)),
            "skel_equal": (None if run_skel is None
                           else bool(np.array_equal(run_skel, ref_skel))),
            "avg_f1_cov_score": score,
            "ref_avg_f1_cov_score": meta["avg_f1_cov_score"],
            "AP_0.5_cldice_greedy": metrics["confusion_matrix"]["th_0_5"][
                "AP"],
            "ref_AP_0.5_cldice_greedy": meta["AP_0.5_cldice_greedy"],
            "metrics_equal_ref": metrics == meta["metrics"]}
        emit(f32)
        if not all(n >= 1 for n in launches.values()):
            raise AssertionError(f"a kernel was not launched in the CLI "
                                 f"run: {launches}")
        if fg_agree < 0.999:
            raise AssertionError(f"cli foreground agreement {fg_agree}")
        if f32["n_instances"] != meta["n_instances"]:
            raise AssertionError("cli instance count differs from the JAX "
                                 "run")
        if agree < 0.99:
            raise AssertionError(f"cli instance agreement {agree} < 0.99")
        if run_skel is None:
            raise AssertionError(f"label skeletonized {len(skel['label'])} "
                                 "times, not once")
        if not f32["skel_of_ref_fg_equal"] or (
                f32["foreground_equal"] and not f32["skel_equal"]):
            raise AssertionError("skeleton of the mask to cover differs "
                                 "from the JAX run's")
        if abs(score - meta["avg_f1_cov_score"]) > 0.01:
            raise AssertionError(f"cli avg_f1_cov {score} vs the JAX run's "
                                 f"{meta['avg_f1_cov_score']}")
        cli_hdf(writes, inst, rm, attrs, argv, exps, sample,
                relabel(remove_small_components(inst, 60)))
        f32_tasks, f32_skel = dict(task_s), {
            k: [sum(t for t, _ in v), len(v)] for k, v in skel.items()}
        if then is not None:
            for name, fn in real_tasks.items():
                setattr(cli, name, fn)
            then({"argv": argv, "paths": paths, "sample": sample,
                  "work": work})
            for name, fn in real_tasks.items():
                setattr(cli, name, timed(name, fn))

        # bf16, the config as it stands, through infer_fused
        task_s.clear()
        for v in skel.values():
            v.clear()
        write_override(None)
        for k in kernels:
            k.launches = 0
        paths = cli.main(argv + ["-id", "bf16", "-d", "infer_fused",
                                 "evaluate"])
        metrics16 = json.load(open(os.path.join(
            paths["test_evaluated"], str(CLI_STEP), sample + ".json")))
        inst16 = IoHDF5(os.path.join(
            paths["test_instanced"], str(CLI_STEP), sample + ".hdf")).read(
                key="vote_instances")
        tpu = tpu_figures()
        emit({"phase": "cli", "run": "bf16 infer_fused evaluate",
              "launches": count_launches("cli_bf16", kernels),
              "n_instances": n_instances(inst16),
              "own_fg_vox": int((inst16 > 0).sum()),
              "avg_f1_cov_score": metrics16["general"]["avg_f1_cov_score"],
              "AP_0.5_cldice_greedy": metrics16["confusion_matrix"][
                  "th_0_5"]["AP"],
              "note": "configs/flylight_crop_dec.toml's pipeline (pt 0.5, "
                      "skeletonize_foreground, rm 60); the TPU and JAX bf16 "
                      "figures are bench.py's (pt 0.6, rm 400)",
              "tpu_bf16": {k: tpu[k] for k in ("avg_f1_cov", "AP_0.5",
                                               "n_instances")},
              "jax_bf16_cpu": json.load(open(BF16_REF_JSON))})
        emit({"phase": "cli_times", "f32_task_s": f32_tasks,
              "f32_skeleton_s_calls": f32_skel,
              "bf16_task_s": dict(task_s), "bf16_skeleton_s_calls": {
                  k: [sum(t for t, _ in v), len(v)] for k, v in skel.items()},
              "phase_wall_s": time.perf_counter() - t_phase})
    finally:
        for name, fn in real_tasks.items():
            setattr(cli, name, fn)
        TV.skeletonize = skeletonize
        TM.skeletonize = skeletonize
        shutil.rmtree(work, ignore_errors=True)


def step_errors(dev, branch, cfg, tree, raw, labels, want, ref,
                corners=None, mesh=None, named=(), grads_out=None):
    """One f32 step (TF32 off) of the port's model ``cfg`` with the flat
    parameters ``tree`` on the batch against a stored JAX step (``want``:
    the branch's record, ``ref``: the arrays keyed ``<branch>/<leaf>`` and
    ``f64/<branch>/<leaf>``): loss parts within 1e-5 relative, each
    gradient leaf's norm and seeded entries within 1e-4 relative L2, or
    within twice the JAX f32 step's own error against the JAX package's
    float64 step where that is larger, up to TRAIN_LOSS_CAP /
    TRAIN_GRAD_CAP.  ``mesh``: the step data-parallel over those devices;
    ``named``: substrings of leaves whose errors the record lists;
    ``grads_out`` (a dict) receives the gradient leaves and loss parts
    as float64 numpy.  Returns the branch's record."""
    import torch

    from patchperpix_tpu_torch import models, weights
    from patchperpix_tpu_torch.train.trainer import (TrainConfig,
                                                     compute_losses)
    from patchperpix_tpu_torch.utils.device import exact_f32

    model = models.PPPModel(cfg)
    model.load_state_dict(weights.to_state_dict(tree), strict=True)
    model.to(dev).train()
    with exact_f32():
        loss, mets = compute_losses(model, cfg, TrainConfig(),
                                    torch.as_tensor(raw, device=dev),
                                    torch.as_tensor(labels, device=dev),
                                    corners=corners, mesh=mesh)
        loss.backward()
    grads = weights.from_state_dict(
        {n: p.grad for n, p in model.named_parameters()})
    if grads_out is not None:
        grads_out.update({k: g.detach().double().cpu().numpy()
                          for k, g in grads.items()})
        grads_out.update({k: float(mets[k])
                          for k in ("loss", "loss_patch", "loss_fg")})
    loss_err = {k: abs(float(mets[k]) - want["metrics"][k])
                / abs(want["metrics"][k])
                for k in ("loss", "loss_patch", "loss_fg")}
    f64 = want["float64_err"]
    loss_lim = {k: min(TRAIN_LOSS_CAP, max(1e-5, 2 * f64["loss"][k]))
                for k in loss_err}
    grad_err, grad_lim, exact_err = {}, {}, {}
    for name, g in grads.items():
        g = g.detach().double().cpu().numpy()
        grad_err[name] = leaf_rel_err(
            name, g, want["grad_norms"][name], ref[f"{branch}/{name}"])
        grad_lim[name] = min(TRAIN_GRAD_CAP,
                             max(1e-4, 2 * f64["grads"][name]))
        exact_err[name] = leaf_rel_err(
            name, g, want["float64_grad_norms"][name],
            ref[f"f64/{branch}/{name}"])
    worst = max(grad_err, key=lambda k: grad_err[k] / grad_lim[k])
    del model, grads, loss
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"loss": float(mets["loss"]),
            "ref_loss": want["metrics"]["loss"],
            "loss_rel_err": loss_err, "loss_limit": loss_lim,
            "grad_worst_leaf": worst,
            "grad_worst_rel_err": grad_err[worst],
            "grad_worst_limit": grad_lim[worst],
            "grad_max_rel_err": max(grad_err.values()),
            "n_leaves": len(grad_err),
            # the leaves whose limit is widened (fixed by the fixture),
            # and those past 1e-4 against JAX's f32
            "n_widened": sum(v > 1e-4 for v in grad_lim.values()),
            "over_1e-4": {k.removeprefix("params/"): v
                          for k, v in grad_err.items() if v > 1e-4},
            # for information: both f32 steps against the exact (float64)
            # one, worst leaf
            "port_vs_f64_max": max(exact_err.values()),
            "jax_f32_vs_f64_max": max(f64["grads"].values()),
            "named": {k.removeprefix("params/"): [grad_err[k], grad_lim[k]]
                      for k in grad_err if any(n in k for n in named)}}


def gate_step(res):
    """Raise when a branch of ``step_errors`` is past its limits."""
    for branch, r in res.items():
        if any(r["loss_rel_err"][k] > r["loss_limit"][k]
               for k in r["loss_rel_err"]):
            raise AssertionError(f"{branch} loss parts vs JAX: "
                                 f"{r['loss_rel_err']}")
        if r["grad_worst_rel_err"] > r["grad_worst_limit"]:
            raise AssertionError(f"{branch} gradient {r['grad_worst_leaf']}"
                                 f" vs JAX: {r['grad_worst_rel_err']}")


def check_train_step(dev, ref, meta, raw, labels):
    """Gate (a): one f32 step of both branches at full width against the
    JAX package's, under ``step_errors``' limits (on the trained model's
    cancelling leaves XLA's f32 sums are off by up to 2.5e-3, on the dense
    loss_patch, a mean of 66M terms, by 2e-5); then the valid branch, its
    U-Net's narrow valid 3x3x3 convolutions on W1, whose launches in that
    step the kernels line takes (``TRAIN_VALID_ROUTED``)."""
    import numpy as np
    import torch

    from patchperpix_tpu_torch import models, weights
    from patchperpix_tpu_torch.models.init import flax_leaves
    from patchperpix_tpu_torch.ops import conv_kernels as CK
    from patchperpix_tpu_torch.train import data as td

    res = {}
    for branch, path in (("code", CLI_CONFIG), ("dense", TRAIN_DENSE_CONFIG)):
        cfg = train_model_config(models, path)
        tree = (weights.load_npz() if branch == "code" else
                weights.seeded_tree(flax_leaves(cfg), TRAIN_SEED))
        corners = (torch.from_numpy(ref["corners"].astype(np.int64))
                   if branch == "code" else None)
        res[branch] = step_errors(dev, branch, cfg, tree, raw, labels,
                                  meta["branches"][branch], ref,
                                  corners=corners)

    vref = np.load(TRAIN_VALID_REF_NPZ)
    vmeta = json.load(open(TRAIN_VALID_REF_JSON))
    vraw, vlabels, _, _ = train_batch(td, vref["centres"],
                                      TRAIN_VALID_EXTENT)
    if int(vlabels.astype(np.int64).sum()) != \
            vmeta["batch"]["labels_sum"] or \
            float(vraw.astype(np.float64).sum()) != vmeta["batch"]["raw_sum"]:
        raise AssertionError("the valid batch differs from the JAX run's")
    CK.WGRAD.launches = 0
    res["valid"] = step_errors(
        dev, "valid", train_model_config(models, CLI_CONFIG,
                                         padding="valid"),
        weights.load_npz(), vraw, vlabels, vmeta["branches"]["valid"], vref,
        corners=torch.from_numpy(vref["corners"].astype(np.int64)))
    res["valid"]["launches"] = count_launches("train_step_valid",
                                              (CK.WGRAD,))
    emit({"phase": "train_step_vs_jax_f32", **res})
    gate_step(res)
    if res["valid"]["launches"][CK.WGRAD.name] != TRAIN_VALID_ROUTED:
        raise AssertionError(f"W1 launches in the valid step: "
                             f"{res['valid']['launches']}, not "
                             f"{TRAIN_VALID_ROUTED}")


def check_sampler_alignment(ds, samples, data_mod, draws=4):
    """Gate (b), first part: batches that the device sampler ``ds`` (over
    ``samples``) draws and applies on its device against the host
    sampler's own crop, flip, transpose, permute, hue and intensity
    (``data_mod.CropSampler``, numpy) on the same decisions: raw within
    1e-6, labels equal.  A sampler whose raw and labels part ways fails
    here at once.  Returns how often each augmentation was applied."""
    import numpy as np
    import torch

    host = data_mod.CropSampler(samples, ds.cfg)
    big = ds.big
    g = torch.Generator(device=ds.device)
    worst = 0.0
    seen = {"flip": 0, "transpose": 0, "permute": 0, "hue": 0}
    for k in range(draws):
        g.manual_seed(TRAIN_SEED + k)
        d = ds.draw(g)
        raw, labels, _ = ds.apply(d)
        raw, labels = raw.cpu().numpy(), labels.cpu().numpy()
        d = {key: v.cpu() for key, v in d.items()}
        for b in range(raw.shape[0]):
            s = samples[int(d["si"][b])]
            c = d["center"][b].numpy()
            r = host._crop_at(s.raw, c, big)
            lab = host._crop_at(np.pad(s.labels, [(0, labels.shape[1]
                                                   - s.labels.shape[0])]
                                       + [(0, 0)] * ds.ndim), c, big)
            for dim in range(ds.ndim):
                if d["flip"][b, dim]:
                    r, lab = np.flip(r, 1 + dim), np.flip(lab, 1 + dim)
                    seen["flip"] += 1
            if d["transpose"][b] and ds.pairs:
                i, j = ds.pairs[int(d["pair"][b])]
                order = list(range(1 + ds.ndim))
                order[i - 1], order[j - 1] = order[j - 1], order[i - 1]
                r, lab = np.transpose(r, order), np.transpose(lab, order)
                seen["transpose"] += 1
            if d["permute"][b] and r.shape[0] >= 2:
                r = r[d["perm"][b].numpy()]
                seen["permute"] += 1
            if d["hue"][b] and r.shape[0] >= 3:
                amt = float(d["hue_amount"][b])
                r = r.copy()
                r[:3] = np.clip((1 - amt) * r[:3]
                                + amt * np.roll(r[:3], 1, axis=0), 0, 1)
                seen["hue"] += 1
            r = np.clip(r * float(d["scale"][b]) + float(d["shift"][b]),
                        0, 1)
            r = host._crop_at(np.ascontiguousarray(r), big // 2,
                              np.array(ds.cfg.input_shape))
            lab = host._crop_at(np.ascontiguousarray(lab), big // 2,
                                np.array(host.label_shape))
            worst = max(worst, float(np.abs(raw[b] - r).max()))
            if not np.array_equal(labels[b], lab):
                raise AssertionError(f"device sampler labels of item {b}, "
                                     f"draw {k}, differ from the host's")
    emit({"phase": "train_sampler_vs_host", "items": draws * raw.shape[0],
          "raw_max_abs_err": worst, **seen})
    if worst > 1e-6 or not (seen["flip"] and seen["transpose"]):
        raise AssertionError(f"device sampler vs host: {worst}, {seen}")
    return seen


def check_train_run(dev, ds, runs, work):
    """Gate (b), second part: train_until (device sampler, f32, TF32 off,
    constant lr 1e-3, from init_tree under seed 0; the crop model at
    TRAIN_RUN_WIDTHS) for the JAX runs' step count; the mean loss over
    the last 50 steps lies in the band the two JAX runs span, widened
    below by the larger of 15 % and their spread, above by the larger of
    5 % and their spread."""
    import numpy as np

    from patchperpix_tpu_torch import models
    from patchperpix_tpu_torch.train.trainer import TrainConfig, train_until
    from patchperpix_tpu_torch.utils.device import exact_f32

    cfg = train_model_config(models, CLI_CONFIG, **TRAIN_RUN_WIDTHS)
    out = os.path.join(work, "b")
    t0 = time.perf_counter()
    with exact_f32():
        train_until(models.PPPModel(cfg), cfg, TrainConfig(
            max_iterations=runs["steps"], checkpoints=runs["steps"],
            snapshots=0, lr=runs["lr"], output_folder=out, log_every=1,
            tensorboard=False), ds, rng_seed=0, device=dev)
    wall = time.perf_counter() - t0
    with open(os.path.join(out, "train_log.jsonl")) as f:
        # by step: with log_every 1 the device loop logs step 1 twice
        by_step = {r["step"]: r["loss"] for r in map(json.loads, f)}
    losses = [by_step[k] for k in sorted(by_step)]
    tail = float(np.mean(losses[-runs["tail"]:]))
    jax_tails = [r["tail_mean_loss"] for r in runs["runs"]]
    lo, hi = min(jax_tails), max(jax_tails)
    band = [lo - max(TRAIN_RUN_BELOW * (lo + hi) / 2, hi - lo),
            hi + max(TRAIN_RUN_ABOVE * (lo + hi) / 2, hi - lo)]
    emit({"phase": "train_run_vs_jax", "steps": len(losses),
          "tail_mean_loss": tail, "jax_tail_mean_losses": jax_tails,
          "band": band, "first_loss": losses[0], "wall_s": wall,
          "jax_cpu_wall_s": [r["wall_s"] for r in runs["runs"]]})
    if len(losses) != runs["steps"] or not band[0] <= tail <= band[1]:
        raise AssertionError(f"{runs['steps']}-step loss level {tail} "
                             f"outside {band}")


# gate (c): configs/flylight_crop_dec.toml's run cut to fit the smoke; the
# warmup scales with it, since optax's schedule (and the port's) refuses
# max_iterations <= warmup_steps
ALL_STEPS, ALL_CHECKPOINTS, ALL_WARMUP, RESUME_STEPS = 400, 200, 100, 600
LOG_EVERY = 100   # TrainConfig's default: no config key sets it


def crop_override(work, name, extra=""):
    """An override TOML under ``work`` pointing every data folder at a
    folder holding only the crop, plus ``extra`` (TOML text)."""
    data = os.path.join(work, "data")
    if not os.path.isdir(data):
        os.makedirs(data)
        os.symlink(FIXTURE, os.path.join(data, os.path.basename(FIXTURE)))
    override = os.path.join(work, name)
    with open(override, "w") as f:
        f.write(extra + "[data]\n" + "".join(
            f'{k}_data = "{data}"\n' for k in ("train", "val", "test")))
    return override


def run_train_all(dev_args, kernels, work, phase="train_all",
                  config=CLI_CONFIG, model_toml="", vote_toml="", tree=None,
                  resume=True):
    """Gate (c): ``-d all`` through the port's CLI in-process with
    ``config`` (and ``model_toml`` / ``vote_toml`` lines in its [model] /
    [vote_instances]), from ``tree``
    (default: the trained crop parameters) seeded as
    train_net_checkpoint_0 (no optimizer state), then with ``resume``
    ``train`` resumed to RESUME_STEPS.  Returns the phase's record."""
    import numpy as np

    from patchperpix_tpu_torch import cli, weights
    from patchperpix_tpu_torch.utils.io import IoHDF5

    override = crop_override(
        work, phase + ".toml",
        (f"[model]\n{model_toml}" if model_toml else "")
        + (f"[vote_instances]\n{vote_toml}" if vote_toml else "")
        + f"[training]\nmax_iterations = {ALL_STEPS}\n"
        f"checkpoints = {ALL_CHECKPOINTS}\n"
        f"[optimizer.optimizer]\nwarmup_steps = {ALL_WARMUP}\n")
    exps = os.path.join(work, "exps_" + phase)
    weights.write_checkpoint(weights.load_npz() if tree is None else tree,
                             os.path.join(exps, "all", "train"), 0)
    calls = []
    real_tasks = {n: getattr(cli, n) for n in (
        "mknet", "train", "validate_checkpoints", "predict", "decode",
        "label", "evaluate")}

    def timed(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                calls.append((name, kw.get("mode"), kw.get("checkpoint"),
                              time.perf_counter() - t0))
        return run

    argv = ["-c", config, "-c", override, "--root", exps,
            "-id", "all"] + dev_args
    wall_resume = None
    try:
        for name, fn in real_tasks.items():
            setattr(cli, name, timed(name, fn))
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        paths = cli.main(argv + ["-d", "all"])
        wall_all = time.perf_counter() - t0
        launches = count_launches(phase, kernels)
        if resume:
            t0 = time.perf_counter()
            cli.main(argv + ["--set",
                             f"training.max_iterations={RESUME_STEPS}",
                             "-d", "train"])
            wall_resume = time.perf_counter() - t0
    finally:
        for name, fn in real_tasks.items():
            setattr(cli, name, fn)

    with open(os.path.join(paths["train"], "train_log.jsonl")) as f:
        rows = [json.loads(line) for line in f if '"loss"' in line]
    first_run = [r for r in rows if r["step"] <= ALL_STEPS]
    with open(os.path.join(paths["base"], "results.json")) as f:
        results = json.load(f)
    last = ALL_STEPS
    sample = os.path.splitext(os.path.basename(FIXTURE))[0]
    with open(os.path.join(paths["test_evaluated"], str(last),
                           sample + ".json")) as f:
        final = json.load(f)
    inst = IoHDF5(os.path.join(paths["test_instanced"], str(last),
                               sample + ".hdf")).read(key="vote_instances")
    top, per_cp = {}, {}
    for name, mode, cp, sec in calls:
        if mode == "val":
            per_cp.setdefault(str(cp), {})[name] = sec
        elif name != "train" or "train" not in top:
            top[name] = top.get(name, 0.0) + sec
    counts = {cp: weights.load_checkpoint(weights.checkpoint_path(
        paths["train"], cp)).get("opt_state", {}).get("count")
        for cp in cli.get_checkpoint_list(paths["train"])}
    with open(os.path.join(paths["base"], "run.log")) as f:
        log = f.read()
    resumed = log[log.rfind("=== task train ==="):]
    res = {"phase": phase, "launches": launches,
           "log_steps": [r["step"] for r in first_run],
           "losses": [r["loss"] for r in first_run],
           "checkpoints": [cp for cp in counts if cp <= ALL_STEPS],
           "scores": {str(r["checkpoint"]): r["score"]
                      for r in results["results"]},
           "best": results["best"],
           "final_avg_f1_cov_score": final["general"].get(
               "avg_f1_cov_score"),
           "final_n_instances": n_instances(inst),
           "task_s": top, "validate_s_per_checkpoint": per_cp,
           "all_wall_s": wall_all, "resume_wall_s": wall_resume,
           "opt_counts": counts}
    emit(res)
    want_steps = [1] + list(range(LOG_EVERY, ALL_STEPS + 1, LOG_EVERY))
    want_cps = list(range(0, ALL_STEPS + 1, ALL_CHECKPOINTS))
    if res["log_steps"] != want_steps or \
            not all(np.isfinite(res["losses"])):
        raise AssertionError(f"train log rows {res['log_steps']} / "
                             f"{res['losses']}")
    if res["checkpoints"] != want_cps:
        raise AssertionError(f"checkpoints {res['checkpoints']}")
    if len(results["results"]) != len(want_cps) or \
            results["best"] is None or \
            not all(np.isfinite(r["score"]) for r in results["results"]):
        raise AssertionError(f"results.json {results}")
    if res["final_avg_f1_cov_score"] is None:
        raise AssertionError("no general.avg_f1_cov_score in evaluate")
    if any(n != len(want_cps) + 1 for n in launches.values()):
        raise AssertionError(f"K1 / K2 launches in all: {launches}, not "
                             "one per checkpoint + the final label")
    if counts.get(ALL_STEPS) != ALL_STEPS:
        raise AssertionError(f"update counts {counts}")
    if resume and (counts.get(RESUME_STEPS) != RESUME_STEPS
                   or "resuming from" not in resumed
                   or "reinitializing optimizer moments" in resumed):
        raise AssertionError(f"resume to {RESUME_STEPS}: counts {counts}")
    return res


def run_train(dev, kernels):
    """Phase train: (a) one train step at full width in f32 against the
    JAX package's, both branches; (b) the loss level of a 200-step run
    against two JAX runs; (c) the reference CLI's ``-d all`` on the
    crop, then a resumed ``train``."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from patchperpix_tpu_torch.train import data as td
    from patchperpix_tpu_torch.train.device_data import DeviceSampler

    t_phase = time.perf_counter()
    ref = np.load(TRAIN_REF_NPZ)
    meta = json.load(open(TRAIN_REF_JSON))
    raw, labels, _, sample = train_batch(td, ref["centres"])
    if int(labels.astype(np.int64).sum()) != meta["batch"]["labels_sum"] \
            or float(raw.astype(np.float64).sum()) != \
            meta["batch"]["raw_sum"]:
        raise AssertionError("the train batch differs from the JAX run's")
    check_train_step(dev, ref, meta, raw, labels)
    torch.cuda.empty_cache()

    ds = DeviceSampler([sample], train_sampler_config(td),
                       max_gt_channels=labels.shape[1], device=dev)
    out_root = os.path.join(REPO, "experiments_out")
    os.makedirs(out_root, exist_ok=True)
    work = tempfile.mkdtemp(prefix="ppp_train_", dir=out_root)
    try:
        check_sampler_alignment(ds, [sample], td)
        check_train_run(dev, ds, meta["runs"], work)
        torch.cuda.empty_cache()
        run_train_all([], kernels, work)
        emit({"phase": "train_wall",
              "phase_wall_s": time.perf_counter() - t_phase})
    finally:
        shutil.rmtree(work, ignore_errors=True)


SWIN_TIMED = 3          # timed forwards / steps after one warm-up
SWIN_FULL_BATCH = (2, 140)   # (d): batch 2 of 140^3, configs/flylight.toml
# (c)'s checkpoint 0: the seeded crop Swin with the numinst head's class-1
# bias raised, so that the seeded checkpoint has foreground to label; the
# run labels by the numinst argmax (numinst_threshs = []): 400 steps from
# a seeded Swin leave class 1 below the config's 0.9 everywhere (on an
# H100: no foreground at checkpoints 200 and 400, so nothing to label)
SWIN_ALL_SHIFT = {"params/head_fgbg_numinst/bias": (0.0, 4.0, 0.0)}


def rel_l2(got, want) -> float:
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def timed_calls(fn, dev, n=SWIN_TIMED):
    """(median ms of ``n`` calls after one warm-up, extra peak GB, the
    last result)."""
    import numpy as np
    import torch

    fn()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3, extra_peak_gb(dev, base), out


def swin_forward(dev, ref, meta):
    """(a) configs/flylight.toml's Swin at full width on the 156^3 window
    in f32 (TF32 off): each head's seeded entries within 1e-4 relative L2
    of the JAX run; f32 and bf16 forward ms and peak memory; then the 2D
    Swin at the BBBC010 widths (code, numinst, decoded patches at the
    model2d positions, 1e-4 + 1e-4 |x|)."""
    import dataclasses

    import numpy as np
    import torch

    from patchperpix_tpu_torch import models
    from patchperpix_tpu_torch.infer.fused import (decode_volume_device,
                                                   predict_volume_device)
    from patchperpix_tpu_torch.models.init import flax_leaves
    from patchperpix_tpu_torch.utils.device import exact_f32
    from patchperpix_tpu_torch.weights import build_model, seeded_tree

    fwd = meta["forward"]
    cfg = swin_model_config(models)
    if dict(flax_leaves(cfg)) != {k: tuple(v) for k, v in fwd["leaves"]}:
        raise AssertionError("the Swin leaves differ from the JAX model's")
    tree = seeded_tree(fwd["leaves"], fwd["seed"])
    x = torch.as_tensor(swin_window(), device=dev)
    res = {"phase": "swin_forward", "window": fwd["window"],
           "n_parameters": fwd["n_parameters"]}
    model = build_model(cfg, tree, device=dev)
    with exact_f32(), torch.no_grad():
        ms, peak, heads = timed_calls(lambda: model(x), dev)
    res["f32_ms"], res["f32_extra_peak_gb"] = ms, peak
    ok = True
    for name, h in zip(("head_code_affs", "head_fgbg_numinst"), heads):
        ch, vox = swin_positions(tuple(h.shape[1:]))
        got = h[0].reshape(h.shape[1], -1)[
            torch.as_tensor(ch, device=dev),
            torch.as_tensor(vox, device=dev)].cpu().numpy()
        err = rel_l2(got, ref[f"fwd/{name}"])
        res[f"{name}_rel_l2"] = err
        ok &= bool(np.isfinite(got).all() and err <= 1e-4)
    del heads, model
    torch.cuda.empty_cache()
    model = build_model(dataclasses.replace(cfg, dtype="bfloat16"), tree,
                        device=dev)
    with torch.no_grad():
        ms, peak, _ = timed_calls(lambda: model(x), dev)
    res["bf16_ms"], res["bf16_extra_peak_gb"] = ms, peak
    del model
    torch.cuda.empty_cache()

    m2 = meta["model2d"]
    cfg2 = models.PPPConfig(**SWIN_MODEL2D)
    model = build_model(cfg2, seeded_tree(m2["leaves"], m2["seed"]),
                        device=dev)
    raw, pos = model2d_sample(m2["n_positions"])
    with exact_f32():
        code, prob = predict_volume_device(model, raw, cfg2, MODEL2D_WINDOW,
                                           MODEL2D_WINDOW, device=dev)
        fg = np.zeros(MODEL2D_WINDOW, bool)
        fg.reshape(-1)[pos] = True
        dec = decode_volume_device(model, code, fg, cfg2, device=dev)
    pos_t = torch.as_tensor(pos, device=dev)
    got = {"code": code.reshape(cfg2.code_units, -1)[:, pos_t].T,
           "prob": prob.reshape(3, -1)[:, pos_t].T,
           "patches": dec.reshape(625, -1)[:, pos_t].T.reshape(-1, 25, 25)}
    for key, val in got.items():
        val, want = val.cpu().numpy(), ref[f"model2d/{key}"]
        d = np.abs(val - want)
        res[f"model2d_{key}_max_abs_err"] = float(d.max())
        ok &= bool(np.isfinite(val).all()
                   and np.all(d <= 1e-4 + 1e-4 * np.abs(want)))
    del model, code, prob, dec
    torch.cuda.empty_cache()
    emit(res)
    if not ok:
        raise AssertionError("the Swin forward disagrees with the JAX run")


def swin_full_step(dev):
    """(d) information: the bf16 step of configs/flylight.toml's Swin at
    full width (batch 2 of 140^3 crops of the reflected window, labels the
    crop's reflected likewise), Adam."""
    import numpy as np
    import torch

    from patchperpix_tpu_torch import models, weights
    from patchperpix_tpu_torch.models.init import init_tree
    from patchperpix_tpu_torch.train.trainer import (TrainConfig,
                                                     make_optimizer,
                                                     make_train_step)
    from patchperpix_tpu_torch.utils.io import IoZarr

    b, w = SWIN_FULL_BATCH
    cfg = swin_model_config(models, dtype="bfloat16")
    model = models.PPPModel(cfg)
    model.load_state_dict(weights.to_state_dict(init_tree(
        cfg, torch.Generator().manual_seed(SWIN_SEED))))
    model.to(dev).train()
    win = swin_window()[0]
    off = (win.shape[1] - w) // 2
    raw = np.stack([win[:, off:off + w, off:off + w, off:off + w]] * b)
    gt = IoZarr(FIXTURE).read(key="volumes/gt_instances").astype(np.int32)
    r = (w + 6 - gt.shape[1]) // 2
    lab = np.pad(gt, [(0, 0)] + [(r, w + 6 - gt.shape[1] - r)] * 3,
                 mode="reflect")
    labels = np.stack([lab] * b)
    tcfg = TrainConfig(lr=1e-4)
    opt, sched = make_optimizer(tcfg, model.parameters())
    step, _ = make_train_step(model, cfg, tcfg, opt, sched)
    raw_t = torch.as_tensor(raw, device=dev)
    lab_t = torch.as_tensor(labels, device=dev)
    ms, peak, mets = timed_calls(lambda: step(raw_t, lab_t), dev)
    res = {"phase": "swin_full_step", "batch": [b, w], "bf16_step_ms": ms,
           "crops_per_s": b / ms * 1e3, "extra_peak_gb": peak,
           "loss": float(mets["loss"]),
           "note": "configs/flylight.toml as a Swin, init_tree, Adam"}
    del model, opt, raw_t, lab_t
    torch.cuda.empty_cache()
    emit(res)


def run_swin(dev, kernels):
    """Phase swin: (a) ``swin_forward``; (b) the crop config's Swin step
    in f32 against the JAX fixture under phase 12(a)'s limits; (c)
    ``-d all`` with
    configs/flylight_crop.toml as a Swin (bf16, the device sampler,
    ALL_STEPS steps, checkpoints every ALL_CHECKPOINTS) from the seeded
    tree as checkpoint 0: every checkpoint scored, K1 / K2 once per
    validated checkpoint plus the final label (foreground by the numinst
    argmax); (d) ``swin_full_step``."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from patchperpix_tpu_torch import models
    from patchperpix_tpu_torch.models.init import flax_leaves
    from patchperpix_tpu_torch.train import data as td
    from patchperpix_tpu_torch.weights import seeded_tree

    t_phase = time.perf_counter()
    ref = np.load(SWIN_REF_NPZ)
    meta = json.load(open(SWIN_REF_JSON))
    swin_forward(dev, ref, meta)

    train_ref = np.load(TRAIN_REF_NPZ)
    raw, labels, _, sample = train_batch(td, train_ref["centres"])
    want = meta["branches"]["swin"]
    if int(labels.astype(np.int64).sum()) != want["batch"]["labels_sum"]:
        raise AssertionError("the Swin step's batch differs from the JAX's")
    cfg = swin_model_config(models, TRAIN_DENSE_CONFIG)
    tree = seeded_tree(flax_leaves(cfg), TRAIN_SEED)
    step = step_errors(dev, "swin", cfg, tree, raw, labels, want, ref,
                       named=("rel_pos_bias", "WindowAttention_0/Dense_0"))
    emit({"phase": "swin_step_vs_jax_f32", **step})
    gate_step({"swin": step})
    torch.cuda.empty_cache()

    out_root = os.path.join(REPO, "experiments_out")
    os.makedirs(out_root, exist_ok=True)
    work = tempfile.mkdtemp(prefix="ppp_swin_", dir=out_root)
    try:
        seeded = dict(tree)
        for name, shift in SWIN_ALL_SHIFT.items():
            seeded[name] = seeded[name] + np.asarray(shift, np.float32)
        run_train_all([], kernels, work, phase="swin_all",
                      config=TRAIN_DENSE_CONFIG,
                      model_toml='network_style = "swinunetr"\n',
                      vote_toml="numinst_threshs = []\n",
                      tree=seeded, resume=False)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    swin_full_step(dev)
    emit({"phase": "swin_wall", "phase_wall_s": time.perf_counter()
          - t_phase})


# the multidevice phase: meshes of n shards, all on the one card through
# parallel/sharded.py's local_devices hook (the tests lay them on the CPU)
MD_SHARDS_50, MD_SHARDS_100, MD_SHARDS_BLOCKS, MD_SHARDS_STEP = 2, 4, 2, 3
MD_TRAIN_STEPS, MD_TRAIN_DEVICES, MD_TRAIN_BATCH = 20, 2, 4


class on_mesh:
    """Within the block, ``local_devices`` lists ``devices`` (n shards of
    one card, or several cards)."""

    def __init__(self, devices):
        self.devices = list(devices)

    def __enter__(self):
        from patchperpix_tpu_torch.parallel import sharded

        self.saved = sharded.local_devices
        sharded.local_devices = lambda kind="cuda": list(self.devices)
        return self.devices

    def __exit__(self, *exc):
        from patchperpix_tpu_torch.parallel import sharded

        sharded.local_devices = self.saved


def md_consensus(phase, affs, cfg, mesh, dev, kernels, overlap=None):
    """(a) ``sharded_consensus_and_rank`` over ``mesh`` against the
    whole-volume K1 + K2 on ``dev``: half within 1e-4, scores within 1e-3
    absolute / 1e-4 relative (phase 3's tolerances); K1 / K2 launched once
    per shard; whether the results are equal bit for bit; both timed."""
    import torch

    from patchperpix_tpu_torch.ops.consensus_kernels import (
        consensus_half, consensus_operands, rank_scores)
    from patchperpix_tpu_torch.parallel import sharded

    def whole():
        ops = consensus_operands(affs, cfg, overlap)
        half = consensus_half(affs, ops, cfg)
        return half, rank_scores(affs, half, ops, cfg)

    ms1, _, (half1, sc1) = timed_calls(whole, dev, 1)
    for k in kernels:
        k.launches = 0
    half, sc = sharded.sharded_consensus_and_rank(affs, cfg, mesh, overlap)
    torch.cuda.synchronize(dev)
    launches = count_launches(phase, kernels)
    ms, _, _ = timed_calls(lambda: sharded.sharded_consensus_and_rank(
        affs, cfg, mesh, overlap), dev, 1)
    d_half = (half.float() - half1.float()).abs()
    d_sc = (sc - sc1).abs()
    res = {"volume": list(affs.shape[1:]), "shards": len(mesh),
           "devices": sorted({str(d) for d in mesh}),
           "launches": launches, "whole_ms": ms1, "sharded_ms": ms,
           "half_max_abs_err": float(d_half.max()),
           "scores_max_abs_err": float(d_sc.max()),
           "half_bit_equal": bool(torch.equal(half, half1)),
           "scores_bit_equal": bool(torch.equal(sc, sc1))}
    ok = bool((d_half <= 1e-4 + 1e-4 * half1.float().abs()).all()
              and (d_sc <= 1e-3 + 1e-4 * sc1.abs()).all()
              and all(n == len(mesh) for n in launches.values()))
    return res, ok


def md_step(dev, mesh, ref, meta, raw, labels):
    """(d) the data-parallel f32 step over ``mesh`` on phase 12(a)'s batch,
    both branches: within phase 12(a)'s limits of the JAX fixture; loss
    parts and gradient leaves within 1e-6 relative of the port's
    one-device step when both run the same convolution algorithms (cuDNN
    off: PyTorch's own convolutions take one sample at a time), and, for
    information, the same distance with cuDNN, which picks other
    algorithms for a shard of one crop than for the batch of three."""
    import numpy as np
    import torch

    from patchperpix_tpu_torch import models, weights
    from patchperpix_tpu_torch.models.init import flax_leaves

    res, ok = {}, True
    for branch, path in (("code", CLI_CONFIG), ("dense", TRAIN_DENSE_CONFIG)):
        cfg = train_model_config(models, path)
        tree = (weights.load_npz() if branch == "code" else
                weights.seeded_tree(flax_leaves(cfg), TRAIN_SEED))
        corners = (torch.from_numpy(ref["corners"].astype(np.int64))
                   if branch == "code" else None)
        out = {}
        for cudnn in (True, False):
            one, dp = {}, {}
            saved = torch.backends.cudnn.enabled
            torch.backends.cudnn.enabled = cudnn
            try:
                step_errors(dev, branch, cfg, tree, raw, labels,
                            meta["branches"][branch], ref, corners=corners,
                            grads_out=one)
                r = step_errors(dev, branch, cfg, tree, raw, labels,
                                meta["branches"][branch], ref,
                                corners=corners, mesh=mesh, grads_out=dp)
            finally:
                torch.backends.cudnn.enabled = saved
            if cudnn:
                gate_step({branch: r})
                out.update({
                    "vs_jax_grad_worst_rel_err": r["grad_worst_rel_err"],
                    "vs_jax_grad_worst_limit": r["grad_worst_limit"],
                    "loss_rel_err_vs_jax": r["loss_rel_err"]})
            errs = {k: (abs(dp[k] - one[k]) / max(abs(one[k]), 1e-30)
                        if np.isscalar(one[k]) else rel_l2(dp[k], one[k]))
                    for k in one}
            worst = max(errs, key=errs.get)
            tag = "cudnn" if cudnn else "same_algorithms"
            out[f"vs_one_device_{tag}"] = [worst, errs[worst]]
        res[branch] = out
        ok &= out["vs_one_device_same_algorithms"][1] <= 1e-6
    return res, ok


def md_train_cli(dev, work):
    """(d) ``-d train`` through the port's CLI with training.num_devices =
    MD_TRAIN_DEVICES (the host sampler: the CLI falls back from the device
    sampler) for MD_TRAIN_STEPS steps, batch MD_TRAIN_BATCH (a batch of 3
    does not split over 2 devices); the log rows must be finite."""
    import numpy as np

    from patchperpix_tpu_torch import cli

    override = crop_override(
        work, "md_train.toml",
        f"[training]\nmax_iterations = {MD_TRAIN_STEPS}\n"
        f"checkpoints = {MD_TRAIN_STEPS}\nbatch_size = {MD_TRAIN_BATCH}\n"
        f"num_devices = {MD_TRAIN_DEVICES}\n"
        f"[optimizer.optimizer]\nwarmup_steps = {MD_TRAIN_STEPS // 2}\n")
    t0 = time.perf_counter()
    paths = cli.main(["-c", CLI_CONFIG, "-c", override, "--root",
                      os.path.join(work, "md_exps"), "-id", "dp", "-d",
                      "train"])
    wall = time.perf_counter() - t0
    with open(os.path.join(paths["train"], "train_log.jsonl")) as f:
        rows = [json.loads(line) for line in f if '"loss"' in line]
    with open(os.path.join(paths["base"], "run.log")) as f:
        fell_back = "falling back to the host prefetcher" in f.read()
    res = {"steps": MD_TRAIN_STEPS, "devices": MD_TRAIN_DEVICES,
           "batch": MD_TRAIN_BATCH, "wall_s": wall,
           "log_steps": [r["step"] for r in rows],
           "losses": [r["loss"] for r in rows],
           "host_sampler": fell_back,
           "checkpoints": cli.get_checkpoint_list(paths["train"])}
    ok = bool(rows and all(np.isfinite(r["loss"]) for r in rows)
              and fell_back and res["checkpoints"] == [MD_TRAIN_STEPS])
    return res, ok


def run_multidevice(ctx, dev, kernels):
    """Phase multidevice, from inside the blockwise phase (``ctx``: its
    store, parameters and maps, and phase 3's run), with meshes of n
    shards on ``dev``: (a) ``md_consensus`` on phase 3's 50^3 decoded
    affinities (MD_SHARDS_50 shards) and on the 100^3 stand-in
    (MD_SHARDS_100); (b) ``to_instance_seg(sharded_devices =
    MD_SHARDS_100)`` on the stand-in: the map identical up to relabelling
    to the one-device map, the cover's selected set equal, the graph
    weights within 1e-5; (c) ``block_devices = MD_SHARDS_BLOCKS`` on the
    stand-in's dense store equals the ``block_devices = 0`` map; (d)
    ``md_step`` with MD_SHARDS_STEP shards and ``md_train_cli``; (e) (a)
    and (d) across real cards where there are two."""
    import dataclasses

    import numpy as np
    import torch

    from patchperpix_tpu_torch.assembly import to_instance_seg
    from patchperpix_tpu_torch.assembly.blockwise import (
        BlockStats, blockwise_vote_instances_zarr)
    from patchperpix_tpu_torch.train import data as td
    from patchperpix_tpu_torch.utils.postprocess import relabel

    t_phase = time.perf_counter()
    run = ctx["run"]
    ccfg = vote_params().consensus_config()
    ok = True
    out = {"phase": "multidevice"}
    # (a)
    a50, ok50 = md_consensus(
        "multidevice_a50", run["dec"], ccfg, [dev] * MD_SHARDS_50, dev,
        kernels, torch.as_tensor(run["numinst"] > 1, device=dev))
    affs = torch.as_tensor(ctx["affs16"], device=dev).float()
    overlap = torch.as_tensor(ctx["numinst"] > 1, device=dev)
    a100, ok100 = md_consensus("multidevice_a100", affs, ccfg,
                               [dev] * MD_SHARDS_100, dev, kernels, overlap)
    out["a"] = {"50": a50, "100": a100}
    ok &= ok50 and ok100
    torch.cuda.empty_cache()
    # (b)
    vp = dataclasses.replace(vote_params(), sharded_devices=MD_SHARDS_100)
    inter = {}
    with on_mesh([dev] * MD_SHARDS_100):
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        inst, _ = to_instance_seg(affs, ctx["fg"], ctx["mask"],
                                  ctx["numinst"], vp, device=dev,
                                  intermediates=inter)
        torch.cuda.synchronize(dev)
        t_b = time.perf_counter() - t0
        launches_b = count_launches("multidevice_b", kernels)
    del affs
    torch.cuda.empty_cache()
    one = ctx["inter_w"]
    same_map = bool(np.array_equal(relabel(inst), relabel(ctx["inst_w"])))
    same_sel = bool(np.array_equal(inter["cover_centers"],
                                   one["cover_centers"]))
    same_pairs = bool(np.array_equal(inter["pairs"], one["pairs"]))
    w_err = (float(np.abs(inter["weights"] - one["weights"]).max())
             if same_pairs else None)
    out["b"] = {"shards": MD_SHARDS_100, "seconds": t_b,
                "one_device_seconds": ctx["t_whole"],
                "launches": launches_b, "map_identical": same_map,
                "cover_equal": same_sel, "pairs_equal": same_pairs,
                "weights_max_abs_err": w_err}
    ok &= same_map and same_sel and same_pairs and w_err <= 1e-5 \
        and all(n == MD_SHARDS_100 for n in launches_b.values())
    # (c)
    stats = BlockStats()
    with on_mesh([dev] * MD_SHARDS_BLOCKS):
        t0 = time.perf_counter()
        inst_c, _ = blockwise_vote_instances_zarr(
            ctx["store"], dataclasses.replace(
                ctx["vp"], block_devices=MD_SHARDS_BLOCKS),
            SAMPLE_CHUNK, os.path.join(ctx["work"], "block_devices"),
            device=dev, stats=stats)
        torch.cuda.synchronize(dev)
    same_c = bool(np.array_equal(relabel(inst_c), relabel(ctx["inst_s"])))
    out["c"] = {"block_devices": MD_SHARDS_BLOCKS,
                "seconds": time.perf_counter() - t0,
                "one_device_seconds": ctx["t_staged"],
                "blocks_consensus": stats.blocks_consensus,
                "equal_to_block_devices_0": same_c}
    ok &= same_c
    torch.cuda.empty_cache()
    # (d)
    ref = np.load(TRAIN_REF_NPZ)
    meta = json.load(open(TRAIN_REF_JSON))
    raw, labels, _, _ = train_batch(td, ref["centres"])
    out["d"], ok_d = md_step(dev, [dev] * MD_SHARDS_STEP, ref, meta, raw,
                             labels)
    with on_mesh([dev] * MD_TRAIN_DEVICES):
        out["d"]["cli_train"], ok_cli = md_train_cli(dev, ctx["work"])
    ok &= ok_d and ok_cli
    torch.cuda.empty_cache()
    # (e)
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        cards = [torch.device("cuda", i) for i in range(n_cards)]
        e50, ok_e = md_consensus("multidevice_e", run["dec"], ccfg,
                                 cards[:2], dev, kernels,
                                 torch.as_tensor(run["numinst"] > 1,
                                                 device=dev))
        out["e"] = {"a": e50}
        out["e"]["d"], ok_ed = md_step(
            dev, [cards[i % n_cards] for i in range(MD_SHARDS_STEP)], ref,
            meta, raw, labels)
        ok &= ok_e and ok_ed
    else:
        out["e"] = {"skipped": f"{n_cards} card: copies between cards need "
                               "two; (a) and (d) ran with every shard on "
                               f"{dev}"}
    out["phase_wall_s"] = time.perf_counter() - t_phase
    emit(out)
    if not ok:
        raise AssertionError("a multidevice gate failed")


def same_json(a, b) -> bool:
    """Two metric dicts equal as the fixture stores them (numpy numbers as
    floats, NaN equal to NaN)."""
    def norm(d):
        return json.dumps(json.loads(json.dumps(d, default=float)),
                          sort_keys=True)
    return norm(a) == norm(b)


def isbi_kernels(affs, dev):
    """The 2D kernels against their plain versions on the ISBI input (the
    rehearsal's settings, f32 half): errors, two launches equal, times
    (plain, kernel, kernel, plain) and the bounds of what this input needs
    (``bounds_2d``)."""
    import torch

    from patchperpix_tpu_torch.assembly import VoteInstancesParams
    from patchperpix_tpu_torch.ops import consensus as C
    from patchperpix_tpu_torch.ops import consensus_kernels as K

    cfg = VoteInstancesParams.from_config(
        isbi_vote_kwargs()).consensus_config()
    ag, tgt = C.gated_stack_2d(affs, cfg)
    half_k = K.consensus_half_2d_cuda(ag, tgt, cfg)
    half_p = C.consensus_half_2d_plain(ag, tgt, cfg)
    d = (half_k - half_p).abs()
    err_c = float(d.max())
    ok_c = bool(torch.all(d <= 1e-4 + 1e-4 * half_p.abs()))
    del half_p, d
    acc_k = K.rank_acc_2d_cuda(ag, tgt, half_k, cfg)
    acc_p = C.rank_acc_2d_plain(ag, tgt, half_k, cfg)
    d = (acc_k - acc_p).abs()
    err_r = float(d.max())
    ok_r = bool(torch.all(d <= 1e-3 + 1e-4 * acc_p.abs()))
    same = (torch.equal(half_k, K.consensus_half_2d_cuda(ag, tgt, cfg))
            and torch.equal(acc_k, K.rank_acc_2d_cuda(ag, tgt, half_k, cfg)))
    del acc_p, d
    # one round (plain, kernel, kernel, plain): the plain consensus takes
    # ~5 s on this input
    ms_c, plain_c = time_pair(
        lambda: C.consensus_half_2d_plain(ag, tgt, cfg),
        lambda: K.consensus_half_2d_cuda(ag, tgt, cfg), dev, rounds=1)
    ms_r, plain_r = time_pair(
        lambda: C.rank_acc_2d_plain(ag, tgt, half_k, cfg),
        lambda: K.rank_acc_2d_cuda(ag, tgt, half_k, cfg), dev, rounds=1)
    b = bounds_2d(ag, tgt, cfg, half_k)
    res = {"phase": "isbi_kernels", "input": ISBI_TEST[0] + " ideal 25x25",
           "fg_share": float((tgt != 0).float().mean()),
           "consensus2d_max_abs_err": err_c, "consensus2d_ok": ok_c,
           "rank2d_max_abs_err": err_r, "rank2d_ok": ok_r,
           "two_launches_equal": bool(same),
           "consensus2d_ms": ms_c, "consensus2d_plain_ms": plain_c,
           "rank2d_ms": ms_r, "rank2d_plain_ms": plain_r, **b}
    res["consensus2d_bound_ms"], res["consensus2d_bound_by"] = bound_ms(
        b["consensus2d_bytes"], CONS_OPS_PER_TERM * b["pair_terms"])
    res["rank2d_bound_ms"], res["rank2d_bound_by"] = bound_ms(
        b["rank2d_bytes"], RANK_OPS_PER_TERM * b["pair_terms"])
    emit(res)
    if not (ok_c and ok_r):
        raise AssertionError("a 2D CUDA kernel disagrees with its plain "
                             "version on the ISBI input")
    if not same:
        raise AssertionError("two launches of a 2D CUDA kernel differ on "
                             "the ISBI input")


def isbi_assembly(dev, kernels, ref, meta, cover=()):
    """Gate (a): the rehearsal's assembly on the ideal affinities of both
    test samples at 512^2 against the JAX package's maps and metric
    dicts; K3 / K4 held against their plain versions on the first."""
    import numpy as np
    import torch

    from patchperpix_tpu_torch.assembly import (VoteInstancesParams,
                                                to_instance_seg)
    from patchperpix_tpu_torch.evaluate import evaluate_labels

    params = VoteInstancesParams.from_config(isbi_vote_kwargs())
    for i, sample in enumerate(ISBI_TEST):
        affs_np, fg, gt = isbi_ideal(sample)
        affs = torch.as_tensor(affs_np, device=dev)
        del affs_np
        if i == 0:
            to_instance_seg(affs, fg, fg.copy(), fg.astype(np.uint8),
                            params, device=dev)        # warm-up
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        for k in kernels + cover:
            k.launches = 0
        t, inter, t0 = {}, {}, time.perf_counter()
        inst, fg_out = to_instance_seg(affs, fg, fg.copy(),
                                       fg.astype(np.uint8), params,
                                       device=dev, timings=t,
                                       intermediates=inter)
        t["total"] = time.perf_counter() - t0
        launches = count_launches("isbi_assembly", kernels + cover)
        inst[fg_out == 0] = 0
        metrics = evaluate_labels(inst, gt, **isbi_eval_kwargs())
        want = meta["assembly"][sample]
        agree, same = match_agreement(inst, ref[f"a/{sample}/inst"])
        res = {"phase": "isbi_assembly", "sample": sample,
               "size": list(fg.shape[1:]), "launches": launches,
               "steady_s": t, "fg_share": float(fg.mean()),
               "n_candidates": len(inter["ranked_centers"]),
               "ref_n_candidates": want["n_candidates"],
               "n_cover": len(inter["cover_centers"]),
               "n_thin": len(inter["thin_centers"]),
               "n_pairs": len(inter["pairs"]),
               "n_instances": n_instances(inst),
               "ref_n_instances": want["n_instances"],
               "gt_instances": n_instances(gt),
               "fg_agreement": float(np.mean((inst > 0) ==
                                             (ref[f"a/{sample}/inst"] > 0))),
               "matched_agreement": agree, "identical_up_to_relabel": same,
               "metrics_equal_ref": same_json(metrics, want["metrics"]),
               "rand_fscore": metrics["general"]["rand_fscore"],
               "ref_rand_fscore": want["metrics"]["general"]["rand_fscore"],
               "jax_cpu_s": want["cpu_seconds"],
               "peak_extra_gb": extra_peak_gb(dev, base)}
        emit(res)
        if not (all(launches[k.name] == 1 for k in kernels)
                and all(launches[k.name] >= 1 for k in cover)):
            raise AssertionError(f"isbi assembly launches {launches}")
        if not (same and res["metrics_equal_ref"]
                and res["n_candidates"] == want["n_candidates"]):
            raise AssertionError(f"isbi assembly of {sample} differs from "
                                 "the JAX run")
        if i == 0:
            isbi_kernels(affs, dev)
        del affs
        torch.cuda.empty_cache()


def isbi_boundary(ref):
    """Gate (b): keep_single_slice, the sparse grid and the boundary filter
    on the three-slice stack, bit for bit."""
    import numpy as np

    from patchperpix_tpu_torch.assembly import isbi_hacks as H
    from patchperpix_tpu_torch.ops.np_reference import interior

    affs, fg = isbi_stack()
    ps = np.array([1, 25, 25])
    t0 = time.perf_counter()
    keep = H.keep_single_slice(fg)
    cand = [tuple(c) for c in np.argwhere(keep & interior(fg.shape,
                                                          ps // 2))]
    grid = H.sparsify_patches(cand, 20, vol_shape=fg.shape)
    mask = H.filter_instance_boundaries_from_fg(affs, fg, cand, ps,
                                                keep.copy())
    sec = time.perf_counter() - t0
    n = int(np.prod(fg.shape))

    def bits(key):
        return np.unpackbits(ref[key])[:n].reshape(fg.shape).astype(bool)
    res = {"phase": "isbi_boundary", "shape": list(fg.shape),
           "n_candidates": len(cand), "n_grid": len(grid),
           "keep_vox": int(keep.sum()), "mask_vox": int(mask.sum()),
           "keep_equal": bool(np.array_equal(keep, bits("b/keep"))),
           "grid_equal": bool(np.array_equal(np.asarray(grid),
                                             ref["b/grid"])),
           "mask_equal": bool(np.array_equal(mask, bits("b/mask"))),
           "host_s": sec}
    emit(res)
    if not (res["keep_equal"] and res["grid_equal"] and res["mask_equal"]):
        raise AssertionError("the ISBI boundary filter differs from the "
                             "JAX run")


def isbi_cli(dev_args, kernels, ref, meta, work):
    """Gate (c): the port's CLI (in-process, on the card) runs ``mknet
    predict label evaluate cross_validate`` with the rehearsal config on
    the stand-in data, float32, from the seeded checkpoint, against the JAX
    CLI's run: every labelled map under phase 4's limits, |rand_fscore -
    JAX's| <= 0.01 per sample, the same best checkpoint and applied
    scores within 0.01.  Returns the test samples' metrics."""
    import numpy as np

    from patchperpix_tpu_torch import cli, models, weights
    from patchperpix_tpu_torch.models.init import flax_leaves
    from patchperpix_tpu_torch.utils.io import IoHDF5

    exps = os.path.join(work, "exps")
    cfg = train_model_config(models, ISBI_CONFIG)
    weights.write_checkpoint(isbi_seeded_tree(flax_leaves(cfg)),
                             os.path.join(exps, "port", "train"),
                             ISBI_CLI_STEP)
    override = isbi_cli_override(work)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    paths = cli.main(isbi_cli_argv(exps, override, "port") + dev_args + [
        "-d", "mknet", "predict", "label", "evaluate", "cross_validate"])
    wall = time.perf_counter() - t0
    launches = count_launches("isbi_cli", kernels)
    want = meta["cli"]
    maps, scores = {}, {}
    for key in sorted(k for k in ref.files if k.startswith("c/")
                      and k.endswith("/inst")):
        _, mode, sample, _ = key.split("/")
        res = IoHDF5(os.path.join(paths[f"{mode}_instanced"],
                                  str(ISBI_CLI_STEP), sample + ".hdf"))
        inst = res.read(key="vote_instances")
        fg = res.read(key="vote_foreground") > 0
        ref_fg = np.unpackbits(ref[f"c/{mode}/{sample}/fg"])[
            :fg.size].reshape(fg.shape).astype(bool)
        agree, same = match_agreement(inst, ref[key])
        with open(os.path.join(paths[f"{mode}_evaluated"],
                               str(ISBI_CLI_STEP), sample + ".json")) as f:
            m = json.load(f)
        wm = want["metrics"][f"{mode}/{sample}"]
        maps[f"{mode}/{sample}"] = {
            "fg_agreement": float(np.mean(fg == ref_fg)),
            "n_instances": n_instances(inst),
            "ref_n_instances": n_instances(ref[key]),
            "matched_agreement": agree, "identical_up_to_relabel": same,
            "rand_fscore": m["general"]["rand_fscore"],
            "ref_rand_fscore": wm["general"]["rand_fscore"],
            "metrics_equal_ref": same_json(m, wm)}
        if mode == "test":
            scores[sample] = m["general"]
    with open(os.path.join(paths["base"], "cross_val_results.json")) as f:
        cross = json.load(f)
    wc = want["cross_val_results"]
    folds = {k: {"best_checkpoint": cross[k]["best"]["checkpoint"],
                 "ref_best_checkpoint": wc[k]["best"]["checkpoint"],
                 "applied_score": cross[k]["applied_score"],
                 "ref_applied_score": wc[k]["applied_score"]}
             for k in wc if k != "mean_score"}
    res = {"phase": "isbi_cli", "launches": launches,
           "predicted_launches": len(maps), "wall_s": wall, "maps": maps,
           "cross_validate": folds, "mean_score": cross["mean_score"],
           "ref_mean_score": wc["mean_score"],
           "jax_cpu_s": want["cpu_seconds"]}
    emit(res)
    for key, r in maps.items():
        if r["fg_agreement"] < 0.999 or r["matched_agreement"] < 0.99 or \
                r["n_instances"] != r["ref_n_instances"]:
            raise AssertionError(f"isbi cli map {key} vs the JAX run: {r}")
        if abs(r["rand_fscore"] - r["ref_rand_fscore"]) > 0.01:
            raise AssertionError(f"isbi cli rand_fscore of {key}: {r}")
    for k, f in folds.items():
        if f["best_checkpoint"] != f["ref_best_checkpoint"] or \
                abs(f["applied_score"] - f["ref_applied_score"]) > 0.01:
            raise AssertionError(f"isbi cross_validate {k}: {f}")
    if any(n != len(maps) for n in launches.values()):
        raise AssertionError(f"isbi cli launches {launches}, not one per "
                             f"labelled sample ({len(maps)})")
    return scores


def isbi_forward(dev, ref, meta):
    """Gate (d): the full-width isbi2012 model (seeded) on one 512^2
    window in f32 (TF32 off) against the JAX package's sampled outputs,
    1e-4 relative L2 per head; then its f32 and bf16 forward times and
    peak memory."""
    import dataclasses

    import numpy as np
    import torch

    from patchperpix_tpu_torch import models
    from patchperpix_tpu_torch.infer.fused import predict_volume_device
    from patchperpix_tpu_torch.models.init import flax_leaves
    from patchperpix_tpu_torch.train import data as td
    from patchperpix_tpu_torch.utils.device import exact_f32
    from patchperpix_tpu_torch.weights import build_model

    cfg = train_model_config(models, ISBI2012_CONFIG)
    tree = isbi_seeded_tree(flax_leaves(cfg))
    raw = isbi_window(td)
    win = tuple(isbi_toml(ISBI2012_CONFIG)["model"]["test_input_shape_same"])

    def rel(got, want):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        return float(np.linalg.norm(got - want) / np.linalg.norm(want))

    def timed(model, c, n=5):
        predict_volume_device(model, raw, c, win, win, device=dev)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            out = predict_volume_device(model, raw, c, win, win, device=dev)
            torch.cuda.synchronize(dev)
            ts.append(time.perf_counter() - t0)
        return out, float(np.median(ts)) * 1e3, extra_peak_gb(dev, base)

    model = build_model(cfg, tree, device=dev)
    with exact_f32():
        (affs, fg), ms32, gb32 = timed(model, cfg)
    ch, pix = isbi_forward_positions(tuple(affs.shape))
    affs = affs.reshape(affs.shape[0], -1)
    got = {"affs": affs[torch.as_tensor(ch, device=dev),
                        torch.as_tensor(pix, device=dev)].cpu().numpy(),
           "fg": fg.reshape(-1)[torch.as_tensor(pix, device=dev)]
           .cpu().numpy(),
           "affs_channel_mean": affs.mean(1).cpu().numpy(),
           "fg_mean": fg.mean().reshape(1).cpu().numpy()}
    errs = {k: rel(v, ref[f"d/{k}"]) for k, v in got.items()}
    del model, affs, fg
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    model16 = build_model(cfg16, tree, device=dev)
    _, ms16, gb16 = timed(model16, cfg16)
    del model16
    torch.cuda.empty_cache()
    res = {"phase": "isbi_forward", "config": "configs/isbi2012.toml",
           "n_parameters": meta["forward"]["n_parameters"],
           "window": list(win), "rel_l2_vs_jax_f32": errs,
           "f32_ms": ms32, "f32_peak_extra_gb": gb32,
           "bf16_ms": ms16, "bf16_peak_extra_gb": gb16,
           "note": "seeded weights (chip_smoke.isbi_seeded_tree); f32 with "
                   "TF32 off; median of 5 after a warm-up; sigmoid heads"}
    emit(res)
    if max(errs.values()) > 1e-4:
        raise AssertionError(f"isbi2012 forward vs JAX: {errs}")


def isbi_step(dev, ref, meta):
    """Gate (e): one f32 step of the rehearsal model (seeded) on the fixed
    batch against the JAX package's, under ``step_errors``' limits (the
    train phase's gate (a)); then the device sampler's batches of the
    stand-in's training samples against the host sampler's."""
    import numpy as np

    from patchperpix_tpu_torch import models
    from patchperpix_tpu_torch.models.init import flax_leaves
    from patchperpix_tpu_torch.train import data as td
    from patchperpix_tpu_torch.train.device_data import DeviceSampler

    raw, labels = isbi_train_batch(td)
    want = meta["branches"]["isbi"]
    if float(raw.astype(np.float64).sum()) != want["batch"]["raw_sum"] or \
            int(labels.astype(np.int64).sum()) != \
            want["batch"]["labels_sum"]:
        raise AssertionError("the isbi train batch differs from the JAX "
                             "run's")
    cfg = train_model_config(models, ISBI_CONFIG)
    res = {"isbi": step_errors(dev, "isbi", cfg,
                               isbi_seeded_tree(flax_leaves(cfg)), raw,
                               labels, want, ref)}
    emit({"phase": "isbi_step_vs_jax_f32", **res})
    gate_step(res)

    samples = [td.load_sample(os.path.join(
        ISBI_DATA, "train", f"isbi_train_0{i}.zarr"), "volumes/raw",
        "volumes/gt_instances") for i in range(6)]
    ds = DeviceSampler(samples, isbi_sampler_config(td, ISBI_CONFIG),
                       max_gt_channels=1, device=dev)
    check_sampler_alignment(ds, samples, td)


def isbi_all(dev_args, kernels, work, seeded):
    """Gate (f): ``-d all`` with the rehearsal config as users run it (bf16,
    6,000 steps, checkpoints every 2,000, device sampler) on the zlib
    copy: every checkpoint validated, K3 / K4 launched once per labelled
    sample (each validated checkpoint's val samples and the final test
    label), and rand_fscore / adapted_rand_error / VOI per test sample
    beside the JAX rehearsal's and the seeded model's."""
    import glob

    import numpy as np

    from patchperpix_tpu_torch import cli

    exps = os.path.join(work, "exps_all")
    override = os.path.join(work, "override_all.toml")
    with open(override, "w") as f:
        f.write("[data]\n" + "".join(
            f'{k}_data = "{os.path.join(ISBI_DATA, k)}"\n'
            for k in ("train", "val", "test")))
    toml = isbi_toml()
    steps, every = (toml["training"]["max_iterations"],
                    toml["training"]["checkpoints"])
    n_val = len(glob.glob(os.path.join(ISBI_DATA, "val", "*.zarr")))
    n_test = len(glob.glob(os.path.join(ISBI_DATA, "test", "*.zarr")))
    predicted = (steps // every) * n_val + n_test
    calls = []
    real = {n: getattr(cli, n) for n in (
        "mknet", "train", "validate_checkpoints", "predict", "decode",
        "label", "evaluate")}

    def timed(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                calls.append((name, kw.get("mode"), kw.get("checkpoint"),
                              time.perf_counter() - t0))
        return run

    try:
        for name, fn in real.items():
            setattr(cli, name, timed(name, fn))
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        paths = cli.main(["-c", ISBI_CONFIG, "-c", override, "--root", exps,
                          "-id", "all", "-d", "all"] + dev_args)
        wall = time.perf_counter() - t0
        launches = count_launches("isbi_all", kernels)
    finally:
        for name, fn in real.items():
            setattr(cli, name, fn)
    with open(os.path.join(paths["base"], "results.json")) as f:
        results = json.load(f)
    with open(os.path.join(paths["train"], "train_log.jsonl")) as f:
        rows = [json.loads(line) for line in f if '"loss"' in line]
    final = {}
    for sample in ISBI_TEST:
        with open(os.path.join(paths["test_evaluated"], str(steps),
                               sample + ".json")) as f:
            g = json.load(f)["general"]
        with open(os.path.join(ISBI_REHEARSAL, sample + ".json")) as f:
            jg = json.load(f)["general"]
        keys = ("rand_fscore", "adapted_rand_error", "voi_split",
                "voi_merge", "Num GT", "Num Pred")
        final[sample] = {"port_trained": {k: g[k] for k in keys},
                         "jax_rehearsal": {k: jg[k] for k in keys},
                         "port_seeded": {k: seeded[sample][k] for k in keys}}
    top, per_cp = {}, {}
    for name, mode, cp, sec in calls:
        if mode == "val":
            per_cp.setdefault(str(cp), {})[name] = sec
        elif name != "train" or "train" not in top:
            top[name] = top.get(name, 0.0) + sec
    res = {"phase": "isbi_all", "launches": launches,
           "predicted_launches": predicted,
           "checkpoints": cli.get_checkpoint_list(paths["train"]),
           "scores": {str(r["checkpoint"]): r["score"]
                      for r in results["results"]},
           "best": results["best"], "metric": toml["evaluation"]["metric"],
           "first_loss": rows[0]["loss"], "last_loss": rows[-1]["loss"],
           "test": final, "task_s": top, "validate_s_per_checkpoint": per_cp,
           "all_wall_s": wall,
           "jax_rehearsal": "parity/isbi_rehearsal (the JAX package on the "
                            "TPU, 6,000 steps, scripts/run_isbi_rehearsal.sh)"}
    emit(res)
    want_cps = list(range(every, steps + 1, every))
    if res["checkpoints"] != want_cps or len(results["results"]) != \
            len(want_cps) or results["best"] is None or \
            not all(np.isfinite(r["score"]) for r in results["results"]):
        raise AssertionError(f"isbi all: checkpoints {res['checkpoints']}, "
                             f"results {results}")
    if not all(np.isfinite(v) for s in final.values()
               for v in s["port_trained"].values()):
        raise AssertionError(f"isbi all: test metrics {final}")
    if any(n != predicted for n in launches.values()):
        raise AssertionError(f"isbi all: K3 / K4 launches {launches}, "
                             f"predicted {predicted}")


def isbi_blosc():
    """The phase's data as the JAX package wrote it (blosc: zstd,
    bitshuffle), read by the port: each of its 20 arrays bit for bit the
    zlib copy's; the seconds of the blosc and of the zlib reads."""
    import glob

    from patchperpix_tpu_torch.utils.io import IoZarr

    equal, secs, nbytes = {}, {"blosc_s": 0.0, "zlib_s": 0.0}, 0
    for path in sorted(glob.glob(os.path.join(ISBI_DATA, "*", "*.zarr"))):
        rel = os.path.relpath(path, ISBI_DATA)
        for key in IoZarr(path).list_keys():
            got = {}
            for name, root in (("blosc_s", ISBI_DATA), ("zlib_s", ISBI_ZLIB)):
                t0 = time.perf_counter()
                got[name] = IoZarr(os.path.join(root, rel)).read(key=key)
                secs[name] += time.perf_counter() - t0
            a, b = got["blosc_s"], got["zlib_s"]
            equal[f"{rel}:{key}"] = bool(a.dtype == b.dtype and a.shape ==
                                         b.shape and a.tobytes() ==
                                         b.tobytes())
            nbytes += a.nbytes
    emit({"phase": "isbi_blosc", "arrays": len(equal),
          "all_equal": all(equal.values()), "decoded_mb": nbytes / 1e6,
          **secs})
    if len(equal) != 20 or not all(equal.values()):
        raise AssertionError(f"isbi: the blosc data read by the port "
                             f"differs from the zlib copy: {equal}")


def run_isbi(dev, kernels, cover=()):
    """Phase isbi: the blosc data against its zlib copy, then gates (a)
    to (f) of the ISBI 2012 protocol; the ``cover`` kernels are counted in
    gate (a)'s assemblies."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    t_phase = time.perf_counter()
    ref, meta = np.load(ISBI_REF_NPZ), json.load(open(ISBI_REF_JSON))
    isbi_blosc()
    isbi_assembly(dev, kernels, ref, meta, cover)
    isbi_boundary(ref)
    out_root = os.path.join(REPO, "experiments_out")
    os.makedirs(out_root, exist_ok=True)
    work = tempfile.mkdtemp(prefix="ppp_isbi_", dir=out_root)
    try:
        seeded = isbi_cli([], kernels, ref, meta, work)
        torch.cuda.empty_cache()
        isbi_forward(dev, ref, meta)
        isbi_step(dev, ref, meta)
        torch.cuda.empty_cache()
        isbi_all([], kernels, work, seeded)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "isbi_wall", "phase_wall_s": time.perf_counter() - t_phase})


def compare_reference(run):
    """Gates against the stored JAX float32 run, plus per-stage agreement."""
    import numpy as np

    ref = np.load(REF_NPZ)
    meta = json.load(open(REF_JSON))
    inter = run["inter"]
    fg_agree = float(np.mean(run["fg"] == ref["fg"]))
    agree, same = match_agreement(run["inst"], ref["inst"])
    stages = {
        "prob_max_abs_err": float(np.abs(run["prob"] - ref["prob"]).max()),
        "numinst_equal": bool(np.array_equal(run["numinst"],
                                             ref["numinst"])),
        "dec_center_max_abs_err": float(np.abs(
            run["dec"][171].cpu().numpy() - ref["dec_center"]).max()),
        "dec_sum_max_abs_err": float(np.abs(
            run["dec"].sum(0).cpu().numpy() - ref["dec_sum"]).max()),
    }
    for key in ("ranked_centers", "cover_centers", "thin_centers", "pairs"):
        got, want = np.asarray(inter[key]), ref[key]
        stages[f"{key}_equal"] = bool(got.shape == want.shape
                                      and np.array_equal(got, want))
    rs = np.asarray(inter["ranked_scores"])
    stages["ranked_scores_max_abs_err"] = float(
        np.abs(rs - ref["ranked_scores"]).max()) \
        if rs.shape == ref["ranked_scores"].shape else None
    if stages["pairs_equal"]:
        stages["weights_max_abs_err"] = float(
            np.abs(inter["weights"] - ref["weights"]).max())
    stages["n_components"] = [int(inter["n_components"]),
                              int(ref["n_components"])]
    res = {"phase": "vs_jax_f32", "fg_agreement": fg_agree,
           "n_instances": n_instances(run["inst"]),
           "ref_n_instances": meta["n_instances"],
           "matched_agreement": agree, "identical_up_to_relabel": same,
           "own_fg_vox": int((run["inst"] > 0).sum()),
           "ref_own_fg_vox": meta["own_fg_vox"], "stages": stages}
    emit(res)
    if fg_agree < 0.999:
        raise AssertionError(f"foreground agreement {fg_agree} < 0.999")
    if res["n_instances"] != meta["n_instances"]:
        raise AssertionError("instance count differs from the JAX run")
    if agree < 0.99:
        raise AssertionError(f"instance agreement {agree} < 0.99")
    return res


# to_instance_seg's stages: their sum is bench.py's "assemble" wall
ASSEMBLY_STAGES = ("consensus", "rank", "cover", "thin_cover", "pairs",
                   "graph", "mws_paint")


def emit_roofline(tag, run, cfg, dev):
    """Information, no gate: bench.py's roofline line for the port
    (bench.py:360-373: the consensus + rank cost charged to the whole
    assembly's wall), ``assembly_mfu_summary`` of the consensus, rank and
    graph stages, and ``unet_cost``'s share of the predict stage (the f32
    path's convolutions run without TF32, so against the f32 peak; bf16
    against the tensor cores'), at the card's published peaks."""
    from patchperpix_tpu_torch.utils import roofline as R

    peaks = R.chip_peaks(dev)
    t = run["times"]
    vol = run["fg"].shape
    ps, cons_bf16 = tuple(cfg.patchshape), vote_params().consensus_bf16
    cc = R.consensus_cost(vol, ps, cons_bf16)
    rc = R.rank_cost(vol, ps, cons_bf16)
    assemble = sum(t[k] for k in ASSEMBLY_STAGES if k in t)
    unet = R.unet_cost(WIN, cfg.num_fmaps, cfg.fmap_inc_factors[0],
                       len(cfg.downsample_factors) + 1, cfg.num_channels)
    if cfg.dtype == "float32":
        unet = R.KernelCost(unet.flops, unet.hbm_bytes, "fp32")
    emit({"phase": "roofline", "path": tag, "peaks": vars(peaks),
          "assemble_s": assemble,
          "roofline_consensus_rank_vs_assemble": R.analyze(
              R.KernelCost(cc.flops + rc.flops, cc.hbm_bytes + rc.hbm_bytes,
                           "fp32"), assemble, peaks),
          "assembly_mfu_summary": R.assembly_mfu_summary(
              vol, ps, len(run["inter"]["pairs"]),
              {k: t[k] for k in ("consensus", "rank", "graph")},
              cons_bf16=cons_bf16, peaks=peaks),
          "unet_forward_vs_predict": R.analyze(unet, t["predict"], peaks)})


def tpu_figures():
    """The TPU bf16 bench figures recorded in BENCH_r05.json."""
    metric = json.load(open(BENCH_TPU))["parsed"]["metric"]
    m = re.search(r"(\d+) instances, (\d+) own-fg vox, avg_f1_cov ([\d.]+), "
                  r"AP@0.5 ([\d.]+)", metric)
    return {"n_instances": int(m.group(1)), "own_fg_vox": int(m.group(2)),
            "avg_f1_cov": float(m.group(3)), "AP_0.5": float(m.group(4)),
            "source": "BENCH_r05.json (JAX package, bf16, TPU v5e)"}


def main() -> int:
    t_script = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (os.path.isdir(os.path.join(REPO, "patchperpix_tpu_torch"))
            and all(os.path.exists(f) for f in (REF_NPZ, REF2D_NPZ,
                                                MODEL2D_NPZ, BW_REF_NPZ,
                                                CLI_REF_NPZ, TRAIN_REF_NPZ,
                                                TRAIN_VALID_REF_NPZ,
                                                ISBI_REF_NPZ, ISBI_DATA,
                                                ISBI_ZLIB, JAX_RESULT,
                                                SWIN_REF_NPZ, VIZ_REF_NPZ))):
        print("chip_smoke: the repository is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np

    from patchperpix_tpu_torch.evaluate import evaluate_labels
    from patchperpix_tpu_torch import native
    from patchperpix_tpu_torch.ops import _build
    from patchperpix_tpu_torch.ops import consensus_kernels as K
    from patchperpix_tpu_torch.ops import cover_kernels as CK
    from patchperpix_tpu_torch.ops.consensus_kernels import KERNELS
    from patchperpix_tpu_torch.utils.io import IoZarr
    from patchperpix_tpu_torch.weights import build_model

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    emit({"phase": "device", "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    from patchperpix_tpu_torch.utils import blosc
    emit({"phase": "libraries", "found": blosc.library_versions()})

    # the host thinning library (g++) builds beside the five nvcc processes
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as ex:
        gxx = ex.submit(lambda: (native.build("thinning"),
                                 time.perf_counter() - t0))
        info = _build.build([k.name for k in KERNELS])
        gxx_s = gxx.result()[1]
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "gxx_thinning_s": gxx_s,
          "nvcc_s": {n: v["seconds"] for n, v in info.items()},
          "ptxas": {n: [ln for ln in v["log"].splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n, v in info.items()}})

    io = IoZarr(FIXTURE)
    raw = np.clip(io.read(key="volumes/raw").astype(np.float32), 0,
                  1500.0) / 1500.0
    gt = io.read(key="volumes/gt_instances").astype(np.int32)

    # f32 main path: warm-up, then the counted run
    cfg = crop_config("float32")
    model = build_model(cfg, device=dev)
    with CoverCapture() as cap3d:
        warm = run_path(model, cfg, raw, dev)
    for k in KERNELS:
        k.launches = 0
    run = run_path(model, cfg, raw, dev)
    launches = count_launches("f32_path",
                              (K.CONSENSUS, K.RANK, CK.THIN_COVER))
    emit({"phase": "f32_path", "launches": launches,
          "warmup_s": warm["times"], "steady_s": run["times"],
          "fg_vox": int(run["fg"].sum()),
          "n_candidates": len(run["inter"]["ranked_centers"]),
          "n_cover": len(run["inter"]["cover_centers"]),
          "n_thin": len(run["inter"]["thin_centers"]),
          "n_pairs": len(run["inter"]["pairs"]),
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
    del warm
    if not all(n >= 1 for n in launches.values()):
        raise AssertionError(f"a kernel was not launched: {launches}")

    kernels = check_kernels(run, dev)
    kernels.append(run_cover_kernels_3d(cap3d, dev))
    del cap3d
    for k in kernels:
        k["launches"] = launches[k["name"]]
    ref = compare_reference(run)

    def scores(inst):
        """AP@0.5 (IoU, Hungarian) and avg_f1_cov / AP@0.5 (clDice,
        greedy) as bench.py scores its map (rm 400 done by run_path)."""
        iou = evaluate_labels(inst, gt, localization_criterion="iou",
                              assignment_strategy="hungarian",
                              keep_gt_shape=True)
        cl = evaluate_labels(inst, gt, localization_criterion="cldice",
                             assignment_strategy="greedy",
                             keep_gt_shape=True)
        return {"AP_0.5_iou_hungarian": iou["confusion_matrix"]["th_0_5"][
                    "AP"],
                "avg_f1_cov_score": cl["general"]["avg_f1_cov_score"],
                "AP_0.5_cldice_greedy": cl["confusion_matrix"]["th_0_5"][
                    "AP"]}
    scores32 = scores(run["inst"])
    emit_roofline("f32", run, cfg, dev)
    run_blockwise(model, cfg, raw, run, dev,
                  (K.CONSENSUS, K.RANK, CK.THIN_COVER),
                  then=lambda ctx: run_multidevice(ctx, dev,
                                                   (K.CONSENSUS, K.RANK)))
    del run
    torch.cuda.empty_cache()

    cfg16 = crop_config("bfloat16")
    model16 = build_model(cfg16, device=dev)
    run_path(model16, cfg16, raw, dev)       # warm-up (bf16 conv setup)
    run16 = run_path(model16, cfg16, raw, dev)
    emit({"phase": "bf16_path", "n_instances": n_instances(run16["inst"]),
          "own_fg_vox": int((run16["inst"] > 0).sum()),
          **scores(run16["inst"]), "steady_s": run16["times"],
          "f32": {"n_instances": ref["n_instances"],
                  "own_fg_vox": ref["own_fg_vox"], **scores32},
          "tpu_bf16": tpu_figures(),
          "jax_bf16_cpu": json.load(open(BF16_REF_JSON))})
    emit_roofline("bf16", run16, cfg16, dev)
    del run16, model16, model
    torch.cuda.empty_cache()

    run_cli(dev, (K.CONSENSUS, K.RANK, CK.THIN_COVER),
            then=lambda ctx: run_visualize(ctx, dev, (K.CONSENSUS, K.RANK),
                                           (K.CONSENSUS2D, K.RANK2D)))
    torch.cuda.empty_cache()
    run_train(dev, (K.CONSENSUS, K.RANK))
    torch.cuda.empty_cache()
    run_swin(dev, (K.CONSENSUS, K.RANK))
    torch.cuda.empty_cache()
    run_isbi(dev, (K.CONSENSUS2D, K.RANK2D),
             (CK.COVER_CASCADE, CK.THIN_COVER))
    torch.cuda.empty_cache()

    kernels.append(run_probe(dev))
    kernels.append(run_conv_wgrad(dev))
    torch.cuda.empty_cache()
    cap2d = CoverCapture()
    launches2d, affs2d, full2d = run_path2d(
        dev, (K.CONSENSUS2D, K.RANK2D, CK.COVER_CASCADE, CK.THIN_COVER),
        cap2d)
    if not all(n >= 1 for n in launches2d.values()):
        raise AssertionError(f"a 2D kernel was not launched: {launches2d}")
    rows2d = check_kernels_2d(affs2d, full2d, dev)
    rows2d.append(run_cover_kernels_2d(cap2d, dev))
    for k in rows2d:
        k["launches"] = launches2d[k["name"]]
    kernels += rows2d
    del affs2d, full2d, cap2d
    torch.cuda.empty_cache()
    check_model2d(dev)

    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    names = [k.name for k in KERNELS]
    kernels.sort(key=lambda k: names.index(k["name"]))
    for k in kernels:
        k["launches_by_phase"] = {ph: n[k["name"]] for ph, n in
                                  LAUNCHES.items() if k["name"] in n}
    emit({"phase": "script_wall", "wall_s": time.perf_counter() - t_script})
    print(smi, flush=True)
    emit({"kernels": [{key: k[key] for key in order + ("launches_by_phase",)}
                      for k in kernels]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
