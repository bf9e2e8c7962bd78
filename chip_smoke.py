'''Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Phases (each raises on failure, so the process exits non-zero):

1. environment: torch / CUDA versions, the card's name and power limit;
2. build: compile the CUDA kernels from dnncancerannotator_torch/csrc;
3. forward kernels: at every site of the unet.yaml prediction path (B=64,
   256 x 256) each kernel against its plain PyTorch version on the same
   inputs, TF32 off, to max|diff| <= 1e-4 * max|ref| (the chain also no
   further from its f64 plain version than F64_RATIO times the plain f32
   version, and again at B=8 with c1 as training calls it, with its bound
   counting c1's write; the head conv at B=8 as well, as training calls
   it), and the median of 20
   CUDA-event timings of each around the Python call, taken in turns, and
   its device time alone (torch.profiler's summed kernel time of 10 calls,
   over 10; the larger of two such windows), for the kernel, its plain
   version and the library call;
3b. backward and warp kernels: at every site of the training step (B=8,
   256 x 256 crops) each backward kernel against its plain version (the
   data and weight gradients of the plain forward, with the same saved relu
   masks): dx to 1e-5 * max|ref|, dw and db to 2e-5 * max|ref|, with the
   plain f32 version's own error against f64 printed beside (the chain,
   transposed-conv and head conv backwards held to F64_RATIO of it, their
   dw and db the same bits on two calls, and their device time by kernel
   name in a deferred profiler window, and their launches a call,
   CHAIN_BWD_LAUNCHES, TCONV_BWD_LAUNCHES and STENCIL_BWD_LAUNCHES, from
   the kernel library's own count); the two-pass
   warp on [8, 256, 256, 6] at a flow from a real warp bank and at a random
   flow past +-8 px, exactly equal to its plain version, on the tile route
   (ops/kernels/warp_twopass.py: route; printed, and a failure if not) at
   WARP_LAUNCHES a call (the kernel library's count); timings as in 3;
4. prediction: seeded synthetic .tfrecords and a seeded checkpoint, then the
   port's ``predict`` CLI at batch 64 on the card. Checks the file count,
   that every map is finite and in [0, 1], that every kernel launched at
   least (sites x batches) times during the run, and that the maps equal a
   plain-PyTorch forward of the same weights on the card (<= 1e-5);
5. training: seeded synthetic 512 x 512 exams, then the port's ``train``
   CLI with the unet.yaml stack (B=8 256 x 256 crops, banked warp, weighted
   BCE, Adam) for 50 steps in chunks of 25, checkpointing every 25. Checks
   every loss is finite, ckpt-25 and ckpt-50 hold params and optimizer
   state, every kernel launched at least (steps x sites) times, a second
   call resumes at step 50, and ``predict`` maps from the trained
   checkpoint equal the plain forward of its weights. Then one train step's
   loss and every parameter gradient through the kernels against a plain
   train step on the same batch and draws (loss to 1e-5 relative, each
   gradient to 1e-4 * max|ref|, else no further from an f64 step than
   F64_RATIO times the plain step), the train step's time with the kernels and
   plain (CUDA events, median of 20, in turns), its device busy time (a
   deferred profiler window of 5 steps), and the train throughput in
   slices/s, measured differentially: the difference of two ``train`` calls
   that differ only in step count, each the minimum of three.
3c. connected components: the CCA kernel against its plain version, exactly
   equal, on both of its routes (ops/kernels/cca.py: route), each set's
   route printed and its launches a call (1 shared, 3 global) checked by
   the kernel library's count: the thresholded, opened predictions of one
   real slice at the region PR curve's 100 thresholds ([100, 128, 128]);
   the evaluate path's calls for one chunk of the region metrics, the
   predictions of 20 slices ([2000, 128, 128]) and their labels
   ([20, 128, 128]); the Visualizer's at a ratio of 1 ([500, 256, 256]);
   256 x 256 planes of a spiral, a checkerboard, all ones, all zeros and
   noise at p = 0.6; [3, 192, 300] noise (H != W, W not a multiple of 32);
   and [2, 384, 384] noise, over the shared route's cap; timings as in 3;
3d. input sensitivity: the chain backward with dx at down_0 (which
   training never asks for) on the first predict batch (B=64, 256 x 256)
   against its plain version with the same relu masks, to DX_TOL *
   max|ref|; then d(sum of probabilities)/d(input) through the kernels
   against plain autograd of the plain forward, where a relu or pool
   decision rounded the other way may change a few pixels (see
   sensitivity_site), and the normalized per-channel sensitivity of
   utils/viz.py to DX_TOL * its max;
6. evaluation: the ``train`` CLI with metrics.yaml, ``--validate`` on the
   phase-4 records, ``--early_stop_steps`` and ``--visualize`` for 4 steps
   (val_loss and every metric in the history); then the ``evaluate`` CLI
   with metrics.yaml and every export over phase 5's checkpoints on the
   phase-4 records (160 slices, batch 64). Checks one results.csv row a
   checkpoint with the loss and the 13 metrics, 160 casewise rows and PNGs
   a checkpoint, that the event file reads back with the port's record
   reader, that the CCA kernel ran at least once a batch and checkpoint,
   and that every region count (the metrics.yaml suite, the casewise rows,
   the region PR curves) equals the counts from the plain CCA on the same
   probabilities on the card. Prints the seconds per checkpoint and the
   evaluated slices/s.
3e. unet_big kernel sites: a seeded unet_big forward (64 first filters, 4
   levels, BatchNorm, NHWC, B=8, 256 x 256, train mode) gives the inputs of
   the NHWC pool (down_1..3) and transposed conv (up_0..2) kernels; each
   kernel against its plain version there: the pool forward and backward
   exactly equal, the tconv forward and dx to DX_TOL * max|ref|, dw and db
   to DW_TOL * max|ref|, each no further from its f64 plain version than
   F64_RATIO times the plain f32 version (the 3xTF32 tensor-core GEMM), the
   backward bit-equal across two calls; timings as in 3;
7. unet_big training: the ``train`` CLI with the unet_big + f32 +
   pallas_decoder stack (BIG_CONFIGS; B=8 256 x 256 crops, banked warp,
   weighted BCE, Adam) for 20 steps in chunks of 10, checkpointing every 10,
   then a second call that resumes to 30. Checks every loss is finite, each
   checkpoint holds batch_stats that moved, each of the four NHWC kernels
   launched at least 3 x steps times and the warp kernel every step,
   ``predict`` from ckpt-30 equals a plain forward of its weights (BatchNorm
   on its running statistics; where the two f32 forwards differ by more
   than 1e-5, the maps are held to an f64 forward, no further from it than
   F64_RATIO times the plain f32 forward), one train step's loss, gradients
   and updated batch_stats through the kernels equal a plain step on the
   same batch and draws (held to an f64 step likewise), taken on a seeded
   state (the initial weights of SEED, a seeded batch and draws, cuDNN
   deterministic inside the check) so that it meets the same inputs in
   every run, and the stack without pallas_decoder.yaml launches none
   of the four. Times the train step (kernels and plain) and the train
   throughput as in 5, but from calls of BIG_THROUGHPUT steps, each the
   minimum of two (as in phases 10 and 11).
3f. crop-fused warp: the warp_crop kernel against its plain version, exactly
   equal, on [8, 268, 268, 6] windows (256 + 2 x 6 of crop jitter) cropped
   to 256 x 256 at d = 8 (data_options.yaml's warp) and d = 18
   (augment_options.yaml's), at the flows of a real per-step solve
   (ops/warp.py:cropped_twopass_flows) and at a random flow past +-d, with
   crop offsets 0, in - out and mirrored ones, on the tile route at
   WARP_LAUNCHES a call, as in 3b; timings as in 3;
8. fused augmentation: the ``train`` CLI with the unet.yaml stack and an
   overlay ``deploy_options.fused_aug: true`` after deploy_options.yaml
   (which replaces the whole dict) for 50 steps in chunks of 25 on the
   phase-5 exams: every loss finite, warp_crop launched once a step,
   warp_twopass never, no warp bank solved; then 4 steps with
   ``deploy_options.warp_bank: false`` (the composed per-step solve,
   warp_twopass once a step) and 4 with intra_channelwarp_std5.yaml
   stacked (the exact per-group warps beside the banked warp). On one
   smooth batch and one draw list the fused route against the composed
   per-step route within tests/test_augment_fused.py's bounds (mean |diff|
   < 5e-3, max < 0.25, 99.9th percentile < 0.1); both routes against an f64
   oracle with the rule of tools/chip_fusedaug_parity.py (B=4, 268 -> 256, 6
   channels, 100 points); the augmentation's ms a step on the banked, the
   per-step composed and the fused route (CUDA events, median of 20, in
   turns); the fused chain's train throughput as in 5.

3g. MulmoUNet kernel sites: a seeded MulmoUNet forward (16 first filters,
   4 levels, five per-channel encoders, BatchNorm, NHWC, B=8, 256 x 256,
   train mode) gives the inputs of the NHWC stencil conv at its six sites
   (each encoder's first conv, 3x3 SAME 1 -> 16 with relu, reading its
   channel of the batch in place, and the 1x1 16 -> 1 head; also at B=64
   as evaluate and predict call them), of the NHWC pool at the five down_3
   sites (C 128 at 32 x 32) and of the NHWC tconv at up_0 (Ci 640 -> 128):
   the stencil conv to KERNEL_TOL * max|ref| at one launch a call by the
   kernel library's own count, the pool and tconv as in 3e; timings as in
   3;
10. MulmoUNet: the ``train`` CLI with mulmo_unet.yaml + data_options.yaml +
   deploy_options.yaml + pallas_decoder.yaml as phase 7 runs unet_big (20
   steps in chunks of 10, a resume to 30, every loss finite, the 144
   batch_stats moved, each kernel launched at least sites x steps times,
   predict from ckpt-30 against a plain forward of its weights, one seeded
   step against a plain step, the stack without pallas_decoder.yaml
   launching none of the four NHWC pool and tconv kernels and still the
   stencil conv), then the ``evaluate`` CLI with metrics.yaml on ckpt-30
   (batch 64, the phase-4 records; every region count equal to the plain
   CCA's) and the input sensitivity of 4 slices, the train step's time,
   its device busy share (deferred) and the throughput as in 7;
11. MultiResUnet: the same for multiresunet.yaml + data_options.yaml +
   deploy_options.yaml (its kernels: the warp in training, the CCA in
   evaluate); its one seeded step, whose only kernel is the bit-equal
   warp, is held to the f64 step of the same weights, batch and draws
   (gradients within MRU_F64_TOL of their scale, the loss and statistics
   within MRU_STAT_TOL).
3h. bf16 kernel forms: a seeded bf16 forward of unet.yaml + bf16.yaml
   gives the inputs of its four whole chains and two stencil convs
   (down_2's first conv, the head), at B=8 as training calls them (the
   chain with c1 and the f32 c2, each backward on the relu-masked
   cotangent) and at B=64 as predict calls the forwards; one of MulmoUNet
   + bf16.yaml those of its six NHWC stencil sites (B=8). Each bf16 form
   is bit-equal to its f32 form on the upcast inputs, rounded to bf16
   (the chain's c1 and f32 c2 bit-equal unrounded), launches what its f32
   form does a call by the library's count, and is timed as in 3 (the
   library call: F.conv2d or the conv backward in bf16), with its bound in
   bf16 bytes; the B=8 sites make the kernels line's ``<kernel>_bf16``
   entries;
12. unet_big in bf16: unet_big.yaml as shipped (precision bfloat16) +
   data_options.yaml + deploy_options.yaml + pallas_decoder.yaml +
   bf16.yaml (last: deploy_options.yaml replaces the whole dict) as phase
   7 runs unet_big, with the four NHWC kernels at 0 launches (their gates
   take f32 only) and the evaluate CLI on ckpt-30 as in 10; its seeded
   step (cuDNN deterministic) within BF16_LOSS_TOL (the loss),
   BF16_STAT_TOL (every statistic) and BF16_F64_TOL (every gradient) of
   the f64 step of an f32
   model on the same weights, batch and draws, a broken control (the same
   step with models/fastbn.py's ``wide`` the identity) past those limits,
   the step at least BF16_ON_SHARE from the f32 step (bf16 is on), and the
   dtype census of every conv, transposed conv and BatchNorm output; then
   for bf16_f32head.yaml and bf16_f32level0.yaml each the seeded step held
   to the same limits, the census, the step's time and the throughput;
12b. unet.yaml and MulmoUNet in bf16: each stack + bf16.yaml trains
   BF16_SLICE_STEPS steps through the CLI (every loss finite, each bf16
   form launched at least its sites x steps times, the f32 forms and the
   f32-only kernels never), then one seeded step through the bf16 forms
   against the plain bf16 step, by tests/test_torch_bf16.py's rule (each
   value within BF16_STEP_TOL of its scale, else no further from the f64
   step than F64_RATIO times the plain step).
3i. leaky stencil sites: a seeded forward of unet.yaml + leakyReLU.yaml
   (every conv alone: a chain fuses relu only) gives the inputs of the
   NCHW stencil conv's nine sites (LEAKY_STENCIL_SITES, 3x3 SAME at 3-12
   channels, no relu), in f32 and bf16 at B=8 and B=64: each on the tile
   route (printed; a failure otherwise), the f32 form to KERNEL_TOL *
   max|ref| of its plain version, the bf16 form bit-equal to its f32 form
   on the upcast inputs, rounded, one launch a call by the library's
   count, its times as in 3 (the library call ``F.conv2d`` with the bias)
   and its bound; at B=8 also the stencil backward on the leaky-masked
   cotangent, held as in 3b, with its route and time beside
   ``convolution_backward``; the B=8 sites make the kernels line's
   ``stencil_conv_tile`` entries; then the direct route kept at
   STENCIL_DIRECT_SITE (32 -> 32 at 8 x 8192), as 3g holds the NHWC one;
13. unet.yaml + leakyReLU.yaml training: the ``train`` CLI (B=8 256 x 256
   crops, banked warp) for LEAKY_STEPS steps in one chunk: every loss
   finite, the tile route and the stencil backward launched at least 9 x
   steps times, no chain kernel; ``predict`` from the checkpoint against a
   plain forward of its weights (MAP_TOL); one step on a seeded state
   through the kernels against a plain step (STEP_TOL, else F64_RATIO of
   the plain step's distance from the f64 step, as 5).
14. training options: the unet.yaml stack (B=8 256 x 256 crops, banked
   warp) + enable_label_smoothing.yaml + kernel_regularizer.yaml. (a) the
   ``train`` CLI for OPTIONS_STEPS steps: every loss finite, each kernel
   of the train step launched at least (sites x steps) times and the
   library's own count above 0, then one step on the trained weights
   through the kernels against a plain step as in 5, the regularizer's
   share in the loss and every gradient; (b) each optimizer of the
   registry for OPTIMIZER_STEPS steps of ``Engine.train``: losses finite,
   state on the card, lamb's and lion's updated parameters against a
   plain step's; (c) the (a) run with ``debug_asserts: true``, and the
   step time with and without the checks; (d) SIGTERM to the ``train``
   CLI in a subprocess after its first logged step: exit 0, a checkpoint
   at the stop step, a resume of two steps; (e) ``--profile`` over
   PROFILE_TRAIN_STEPS steps: the trace names the chain kernel. The
   phase's train throughput is printed beside phase 5's.
15. host data layer: (a) the host library (csrc/host/*.cc, built with
   g++ in phase 2) and CRC32C's rate, native against its plain version, on
   one CRC_BYTES buffer, the same CRC; (b) a seeded PNG exam tree (5
   cancer and 5 healthy exams of 16 slices, 512 x 512) through the
   ``generate_tfrecords`` CLI: every record decodes natively to the Python
   codec's bytes and to ``prepare_combined_slices`` of its exam, the
   library declines none; the decode rates (native serial, native with
   the pool, Python); (c) the ``train`` CLI as phase 5 with
   ``data_options.train.device_cache: false`` (an overlay in the phase's
   work directory), streaming phase 5's records through the prefetcher:
   every loss finite, the stream started once a call, the seven kernels
   of the step launched at least (sites x steps) times and the library's
   own count at least their sum, ckpt-25 and ckpt-50, a resume, predict
   from the checkpoint against a plain forward (MAP_TOL); (d) one streamed
   step bit-equal (loss and every gradient) to the resident step on the
   same raw batch and draws, the first STREAM_CHECK_BATCHES streamed
   batches equal to ``raw_batches(seed)`` on the host, and a
   ``load_resident`` budget one byte below the set falling back to the
   stream; (e) ``train`` from the exam tree for TREE_STEPS steps,
   resident and streamed, and ``evaluate`` from the tree equal to
   ``evaluate`` from its records; (f) train throughput streamed against
   resident (phase 5's differential calls, in turns) and evaluate s/ckpt
   at phase 6's setting, prefetched against the serial pass (in turns,
   results equal), beside phase 6's figure. The phase writes no set past
   the 8 GiB resident budget: the fallback is the same code at any budget.
16. export and serve: phase 5's unet.yaml run (a symbolic batch) and
   phase 12's unet_big.yaml as shipped in bf16 (``batch_size`` 8) through
   the ``export_model`` CLI (a ``torch.export`` program traced on the host
   under ``gates.library_only()``), each loaded and moved to the card
   (every parameter, buffer, constant and ``device`` keyword there) and
   served by ``runs/serve.py``'s ``make_server`` on a thread; phase 4's
   first record slices POSTed at B = 1, 8 and 64 (unet.yaml) and 3
   (padded) and 8 (unet_big; 9 refused with a 400). Checks /healthz and
   /spec, each answer float32 [B, 256, 256, 1], finite, in [0, 1] and
   within SERVE_TOL of ``load_exported`` on the same slices; unet.yaml's
   within MAP_TOL of the kernel path's eval step on the same checkpoint,
   unet_big's against its live forward under the force-off scope by
   tests/test_torch_bf16.py's rule; TF32 off while serving (turned on
   before the load); no kernel launched during export and serving (each
   kernel's count and the library's own). Prints the export seconds and
   artifact MB, the load-and-move seconds, each batch's request latency
   beside the eval step's (host clock, median of SERVE_TIMED, in turns)
   and the served slices/s at B = 64 beside the kernel path's.
17. data parallelism (``parallel/``, ``enable_multigpu``): (a) one NCCL
   rank through ``python -m torch.distributed.run --standalone
   --nproc_per_node 1`` with DNNCA_MULTIHOST=1 trains phase 5's stack +
   multigpu.yaml DP_STEPS steps (one checkpoint) and evaluates it: the
   losses the same bits as the same run with no group, results.csv the
   same; (b) two ranks on the one card over gloo (NCCL refuses two ranks
   on one card) take one seeded step each of unet.yaml (phase 5's trained
   checkpoint and batch), unet_big f32 with pallas_decoder.yaml and
   unet_big.yaml as shipped in bf16 (``big_check_state``), B=8, 4 rows a
   rank, through ``Engine.train_step``: every rank drew its rows of the
   one-rank batch and the one bank, holds the same summed gradients and
   statistics and, after 3 more steps, the same parameters (bits), and
   launched every kernel of its step; the step against the one-rank kernel
   step by phase 5's rule (``_compare_step``; unet_big's statistics by
   phase 7's limit), bf16 by phase 12's (``_reading``); a 2-rank
   ``evaluate`` of phase 5's run whose results.csv equals phase 6's
   (region metrics exactly, the rest within 1e-6 relative), and only rank
   0's files (one event file); (c) 2 ranks train to DP_STEPS, one rank
   resumes to 2 x DP_STEPS, the losses within LOSS_TOL of an unbroken
   2-rank run; (d) with more than one card the CLI's own spawn (one
   process a card, NCCL) trains and evaluates, else it prints that it did
   not run. Then the unet.yaml step with and without a world-1 NCCL group
   in this process (phase 5's differential calls, in turns), and in phase
   9 the grouped step's profile with its NCCL kernels' device time.
19. spatial partition (``deploy_options.spatial_partition: 2``, after
   phase 17, whose seeded steps and one-rank references it reuses; its
   files beside phase 17's): (a) two gloo ranks on the card at (data 1,
   model 2), each running its 128 of the 256 rows plus its halo: the
   seeded unet.yaml, unet_big f32 + pallas_decoder and unet_big bf16
   steps against the one-rank kernel step by phase 17's rules, both ranks
   the same bits after 3 more steps, each kernel of the step launched on
   each rank (the wrappers' counts and the library's own), and each
   kernel call's route or launch geometry printed a rank (``_route_log``);
   (b) through the CLI at N = 2: ``evaluate`` of phase 5's run whose
   results.csv equals phase 6's (region metrics exactly), ``predict``
   maps within MAP_TOL and a 4-step ``train --validate`` within LOSS_TOL
   of one rank; (c) four gloo ranks at (data 2, model 2): the unet.yaml
   step and one more against one rank; (d) a rank's peak device memory
   over 3 train steps (B=8, 256 x 256) and one eval step (B=8, 512 x 512)
   and the train step's ms (differential calls) at N = 1 and N = 2; (e)
   with an even count of cards above one, the CLI's own NCCL spawn,
   else it prints that it did not run.
18. extract_all: a seeded tree of 4 cancer and 4 healthy exams of 8
   clinical collages (1080 x 1600, tests/test_extract.py's grid offset by
   a few px; the cancer label panes a coloured ring, ellipse outline or
   blob, half of them with a 1-px ruler across it), written with the
   port's ``imwrite``, extracted by ``python -m dnncancerannotator_torch
   extract_all --path TREE --debug`` on the card with the default pool.
   Checks (a) every pane file bit-equal to the generator's pane and the
   card's boxes equal to the drawn grid; (b) the card's corner responses
   on 4 collages bit-equal to the CPU path's, on 2 to
   ``scipy.signal.convolve2d``; (c) every file of the tree decoding to the
   bytes of ``extract_all(device='cpu', num_workers=0)`` on a copy; (d)
   each label within EX_IOU of the generator's filled annotation; (e) no
   healthy label directory, and a healthy exam with a coloured pane
   raising; (f) the tree through ``generate_tfrecords``, 5 ``train``
   steps of unet.yaml and one ``evaluate``. Prints extract_all's seconds
   and collages/s, ``detect_internals`` ms a collage on the card against
   the CPU path (in turns; also batched 8 a call) and ``extract_label``
   ms a pane.
20. the JAX package's Orbax checkpoints (the committed fixtures of
   tools/make_torch_orbax_fixture.py under tests/fixtures_torch/orbax/:
   unet.yaml at full width and unet_big.yaml with 4 first filters, each a
   JAX save_path): (a) the host library with the zstd decoder builds, and
   every array ``ckpt.orbax`` reads from both is the same bits as its
   ``expected.npz``; (b) ``predict`` (npy) of phase 4's records from the
   unet.yaml JAX run writes the bytes of ``predict`` from its npz twin
   (written here from expected.npz in the port's layout); (c) ``evaluate``
   with metrics.yaml: results.csv (the loss and the region metrics) and
   casewise_results.csv the same bytes as the twin's; (d) ``train`` resumes
   each fixture for ORBAX_STEPS steps on phase 5's exams (ORBAX_OVERLAY: a
   16-field bank), cuDNN deterministic: steps ``step + 1`` on, the losses
   and every tensor of the model the same bits as a resume from the twin,
   the unet.yaml step's kernels launched; (e) each fixture's load ms (Orbax
   and npz, in turns) and the decoder's MB/s, median of ORBAX_TIMED. Every
   count is set to 0 before each predict, evaluate and train call and read
   after it.
21. model geometries (after phase 20): (a) unet.yaml at upsampling rate 3
   (GEO_OVERLAY: 243 x 243 train and eval crops, 3 ** 3 dividing them;
   B=8, the banked warp and phase 5's steps_per_call) through the CLI:
   ``train`` GEO_STEPS steps (every loss finite, ckpt-25 and ckpt-50, each
   fused chain and the head conv and their backwards and the warp
   launched every step, no 2x2 tconv, each kernel call's route printed
   and the chains at 243, 81 and 27); the five chains forward (with c1)
   and backward on a seeded forward's activations against their plain
   versions as 3b holds them, and the warp at [8, 243, 243, 6] on a bank
   flow exactly equal to its plain version, each at the library's
   launches a call, with CUDA-event times beside the plain version and
   its bound; the train throughput as phase 5 takes it, printed beside
   phase 5's; ``evaluate`` with metrics.yaml (``model_eval``: every
   region count equal to the plain CCA's, each CCA call's route
   printed); ``predict`` within MAP_TOL of a plain forward; one seeded
   step against the plain step (phase 13's rule); (b) rate 4 on the
   shipped 256 x 256 crops: one seeded step likewise; (c) unet.yaml at
   VALID (B=8, 256 x 256 in, VALID_OUT out): its nine 3x3 convs on the
   stencil kernel with zero pads, forward and backward against their
   plain versions (KERNEL_TOL; DX_TOL, DW_TOL, F64_RATIO), at the
   library's launches a call, timed beside ``F.conv2d`` and
   ``convolution_backward``; the model's forward within MAP_TOL of the
   plain forward; ``predict`` raising a ValueError, as the JAX engine's
   raises there; (d) conv_stride 2: UNetAnnotator (unet.yaml) and
   MulmoUNetAnnotator (mulmo_unet.yaml, 2 levels) at 512 x 512 through the
   kernels against the same forward under ``gates.library_only()``,
   finite and of the side the geometry gives. Its times are CUDA events
   alone (``_time_sites``: no profiler window).
22. the Orbax writer (after phase 21): (a) unet.yaml at phase 5's
   operating point with checkpoints kept to one (CKPT_OVERLAY) through
   ``Engine.train``: 50 steps, a background save every 25, every kernel of
   the step launched every step, ckpt-25 pruned and no temporary
   directory left, ckpt-50 (the JAX engine's Orbax layout) read back by
   ``engine.read_ckpt`` to the live model's and optimizer's state bit for
   bit; (b) a fresh Engine resumed from a copy of ckpt-25 (taken when it
   committed) to step 50: the unbroken run's losses and state bit for bit
   (where a kernel is not deterministic on the card, phase 5's rule, with
   what differs printed); (c) ``evaluate`` of the run with metrics.yaml
   (``model_eval``: the CCA kernel, every region count equal to the plain
   CCA's); (d) unet_big.yaml as shipped (bf16, 64 first filters, Adam; a
   16-field bank), one step, then ``save_ckpt``: the checkpoint's MB, the
   ms ``save_ckpt`` blocks (the host copy), the ms until the directory
   commits and ``read_ckpt``'s ms (median of CKPT_LOADS), its arrays the
   live state's bits; (e) unet.yaml's train throughput with a save every 5
   steps and with one at the end of each call (phase 5's differential
   calls of 25 and 100 steps, each the minimum of three, in turns) and
   their ratio.

9. profiler windows: torch.profiler slows every later CUDA call on the host,
   so the device times of phases 3-3i and the train-step profiles of
   phases 5, 7, 8, 10, 11 and 12 are taken last, after phase 16 and every
   host-clock and
   CUDA-event measurement; then a line of the B=8 chain forward's times
   summed over the six sites, and one of the NHWC pool and tconv kernels'
   times summed over MulmoUNet's sites.

Each phase's wall time is printed when it ends. The last three lines of
stdout are a JSON object of per-kernel results for all fourteen kernels
(with each one's launches in phase 21's rate-3 train call,
``rate3_launches``, and in phase 22's train call, ``ckpt_launches``),
the NCHW stencil conv's tile route (``stencil_conv_tile``) and the six
bf16 forms (with each kernel's bound:
the larger of its bytes over 3.35 TB/s and its FLOPs over the 67 TFLOP/s of
f32 outside the tensor cores, from the inputs of this run, for the 3xTF32
tconv GEMM also 3 x its FLOPs over the 495 TFLOP/s of TF32, the device
times, and the time of one PyTorch call computing the same function where
one exists), the card's
name and power limit, and {"ok": true, "device": {...}}. Without a CUDA
device it exits non-zero before printing any of them.
'''

import contextlib
import copy
import functools
import hashlib
import io
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, 'build', 'chip_smoke')
CONFIGS = ('configs/unet.yaml', 'configs/additionals/deploy_options.yaml',
           'configs/additionals/data_options.yaml')
BATCH = 64
SIZE = 256
N_EXAMS = (5, 5)        # cancer, healthy: 160 slices -> batches 64, 64, 32
SLICES_PER_EXAM = 16
SEED = 0
KERNEL_TOL = 1e-4       # relative to max|ref|: f32, <= 9 * 32 terms a sum
MAP_TOL = 1e-5          # absolute, on probabilities
TIMED_RUNS = 20
# training: B=8 256 x 256 crops of 512 x 512 exams (configs/unet.yaml stack)
TRAIN_BATCH = 8
EXAM_SIZE = 512
TRAIN_EXAMS = (2, 2)    # cancer, healthy
TRAIN_SLICES = 4
TRAIN_STEPS = 50
SAVE_FREQ = 25
STEPS_PER_CALL = 25
# relative to max|ref|, each about 10x the worst error measured on an H100
# (dx <= 2.4e-7, dw and db <= 1.9e-6; the plain f32 versions are as far from
# f64): dx sums at most 9 * 32 terms a pixel, dw and db up to 8 * 256 * 256
# pixels a tap
DX_TOL = 1e-5
DW_TOL = 2e-5
# one train step, kernels vs plain: the loss (relative), and each parameter
# gradient relative to its max|ref| (1.0e-6 measured; the forward kernels'
# own rounding can flip a relu mask where a pre-activation is near 0)
LOSS_TOL = 1e-5
STEP_TOL = 1e-4
# the unet_big step's updated BatchNorm statistics, relative to max|ref|
STATS_TOL = 1e-5
# input gradient end to end: the share of values past DX_TOL that relu and
# max-pool decisions rounded the other way may leave (2.3e-4 measured)
SENS_FLIP_SHARE = 1e-3

# sites of the unet.yaml prediction path: (module path, JAX kernel there)
CHAIN_SITES = (
    ('unet.encoder.down_0', 'conv_kernel.py:340'),
    ('unet.encoder.down_1', 'conv_kernel.py:340'),
    ('unet.encoder.down_2', 'flatchain.py:416'),
    ('unet.decoder.up_0', 'flatchain.py:416'),
    ('unet.decoder.up_1', 'flatchain.py:416'),
    ('unet.decoder.up_2', 'conv_kernel.py:340'),
)
TCONV_SITES = ('unet.decoder.up_0', 'unet.decoder.up_1', 'unet.decoder.up_2')
PALLAS = 'dnncancerannotator_tpu/ops/pallas/'
# the Pallas kernels each CUDA kernel replaces (function definitions)
REPLACES = {
    'conv_chain': ('conv_kernel.py:340 conv_chain_pallas',
                   'flatchain.py:416 conv_chain_flat_nchw'),
    'conv_chain_bwd': ('conv_kernel.py:487 conv_chain_bwd_pallas',
                       'flatchain.py:293 _bwd_call_im2col',
                       'flatchain.py:372 _bwd_call'),
    'tconv2x2': ('flattconv.py:200 conv_transpose2x2_flat_nchw',),
    'tconv2x2_bwd': ('flattconv.py:156 _bwd_call',),
    'stencil_conv': ('conv_kernel.py:84 stencil_conv2d_pallas',),
    'stencil_conv_bwd': ('conv_kernel.py:175 stencil_conv2d_bwd_pallas',),
    'warp_twopass': ('warp_kernel.py:242 dense_image_warp_twopass_pallas',),
    'cca': ('cca_kernel.py:105 cca_raw_labels_pallas',),
    'pool2x2_nhwc': ('pool_kernel.py:120 max_pool2x2_nhwc',),
    'pool2x2_nhwc_bwd': ('pool_kernel.py:96 _bwd_call',),
    'tconv2x2_nhwc': ('tconv_kernel.py:161 conv_transpose2x2_nhwc',),
    'tconv2x2_nhwc_bwd': ('tconv_kernel.py:123 _bwd_call',),
    'warp_crop': ('warp_kernel.py:194 dense_image_warp_crop_pallas',),
    'stencil_conv_nhwc': ('conv_kernel.py:84 stencil_conv2d_pallas '
                          '(nchw=False)',),
    'stencil_conv_tile': ('conv_kernel.py:84 stencil_conv2d_pallas',),
}
# the bf16 forms (their entries ``<entry>_bf16``) replace the same kernels
REPLACES.update({name + '_bf16': REPLACES[name] for name in (
    'conv_chain', 'conv_chain_bwd', 'stencil_conv', 'stencil_conv_bwd',
    'stencil_conv_nhwc', 'stencil_conv_tile')})
# a kernel's source where it is not csrc/<name>.cu
SOURCE = {'conv_chain_bf16': 'conv_chain',
          'conv_chain_bwd_bf16': 'conv_chain_bwd',
          'stencil_conv_bf16': 'stencil_conv',
          'stencil_conv_bwd_bf16': 'stencil_conv_bwd',
          'stencil_conv_nhwc_bf16': 'stencil_conv_nhwc',
          'stencil_conv_tile': 'stencil_conv',
          'stencil_conv_tile_bf16': 'stencil_conv'}
METRICS_CONFIG = 'configs/additionals/metrics.yaml'
EVAL_TAG = 'smoke'
# unet_big in f32 with the NHWC pool and tconv gates on; the overlays come
# after deploy_options.yaml, which replaces the whole deploy_options dict
BIG_CONFIGS = ('configs/unet_big.yaml',
               'configs/additionals/data_options.yaml',
               'configs/additionals/deploy_options.yaml',
               'configs/additionals/f32.yaml',
               'configs/additionals/pallas_decoder.yaml')
BIG_STEPS = 20
BIG_SAVE_FREQ = 10
# the step counts of phases 7, 10 and 11's two throughput calls
BIG_THROUGHPUT = (10, 30)
POOL_SITES = ('unet.encoder.down_1', 'unet.encoder.down_2',
              'unet.encoder.down_3')
BIG_TCONV_SITES = ('unet.decoder.up_0', 'unet.decoder.up_1',
                   'unet.decoder.up_2')
NHWC_KERNELS = ('pool2x2_nhwc', 'pool2x2_nhwc_bwd', 'tconv2x2_nhwc',
                'tconv2x2_nhwc_bwd')
# MulmoUNet (16 first filters, 4 levels, an encoder per input channel, BN,
# NHWC) with the NHWC pool and tconv gates on, and MultiResUnet (32 base
# filters), each trained, resumed, evaluated and predicted as unet_big
MULMO_CONFIGS = ('configs/mulmo_unet.yaml',
                 'configs/additionals/data_options.yaml',
                 'configs/additionals/deploy_options.yaml',
                 'configs/additionals/pallas_decoder.yaml')
MRU_CONFIGS = ('configs/multiresunet.yaml',
               'configs/additionals/data_options.yaml',
               'configs/additionals/deploy_options.yaml')
# MulmoUNet's sites of the NHWC stencil conv (each encoder's first conv,
# 3x3 SAME 1 -> 16 with relu on its channel of the batch, and the 1x1
# 16 -> 1 head), of the NHWC pool (C = 128 at 32 x 32) and of the NHWC tconv
# (Ci = 5 x 128 = 640 -> 128)
MULMO_STENCIL_SITES = tuple(f'mulmo_unet.encoder_{i}.down_0.convchain.conv_0'
                            for i in range(5)) + ('last_conv',)
MULMO_POOL_SITES = tuple(f'mulmo_unet.encoder_{i}.down_3' for i in range(5))
MULMO_TCONV_SITE = 'mulmo_unet.decoder.up_0'
# the NHWC stencil kernel's launches a call, counted by the kernel library
# (either route: ops/kernels/stencil_conv_nhwc.py: route)
STENCIL_NHWC_LAUNCHES = 1
# the kept direct route's site: one output row (8192 x 32 values) past a
# block's shared memory, so the tile does not fit
NHWC_DIRECT_SITE = dict(shape=(1, 4, 8192, 1), co=32, k=3)
# MultiResUnet runs no kernel but the warp, which is bit-equal to its plain
# version, so its kernel step is the plain step; the step is held to the
# f64 step instead (f64_step_shares): each gradient within MRU_F64_TOL of
# its scale, the loss and each updated statistic within MRU_STAT_TOL. On an
# H100 (tools/check_torch_mru_step.py) the sound step reads 4.8e-3-6.2e-3
# at its worst gradient, 7.6e-8 at its worst statistic and 3.0e-7 at the
# loss; with TF32 convs 0.26, 2.0e-5 and 4.9e-4; with one running mean
# left at its pre-step value 4.7e-3 at that statistic
MRU_F64_TOL = 1e-2
MRU_STAT_TOL = 2e-6
# the fused augmentation chain: 268 x 268 host windows (256 + 2 x 6 of crop
# jitter, data/pipeline.py:host_crop) cropped to 256 x 256, with the warp
# options of data_options.yaml (d = 8) and of augment_options.yaml (d = 18)
CROP_IN = SIZE + 12
CROP_WARPS = (dict(n_points=100, max_diff=5, stddev=2.0),
              dict(n_points=150, max_diff=15, stddev=20.0))
FUSED_STEPS = 50
ROUTE_STEPS = 4
INTRA_CONFIG = 'configs/additionals/intra_channelwarp_std5.yaml'
# the fused route against the composed per-step route on the same draws and
# smooth images (tests/test_augment_fused.py:76-80): their stride-4 coarse
# grids differ by the crop shift, which can move a sample ~0.3 px
FUSED_MEAN, FUSED_MAX, FUSED_Q999 = 5e-3, 0.25, 0.1
ORACLE_BATCH = 4
# the H100 SXM's published peaks: HBM bytes/s, f32 FLOP/s outside the
# tensor cores (the port keeps TF32 off but in the 3xTF32 tconv GEMM) and
# dense TF32 FLOP/s on the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
# device time: calls under torch.profiler per kernel, plain version or
# library call
DEVICE_RUNS = 10
# the 3xTF32 tconv GEMM's error against f64, at most this many times the
# plain f32 version's (the dropped small*small term, ~2^-22 a product)
F64_RATIO = 4.0


def log(*args):
    print(*args, flush=True)


@contextlib.contextmanager
def phase(name):
    start = time.perf_counter()
    yield
    log(f'phase {name}: {time.perf_counter() - start:.2f} s')


def spiral_mask(h, w):
    '''[h, w] bool: one path one pixel wide that spirals inward from the
    top-left corner with one pixel between its arms (a single 4-connected
    component that turns about (h + w) / 2 times).'''
    mask = np.zeros((h, w), bool)
    r = c = 0
    dr, dc = 0, 1
    mask[0, 0] = True

    def free(y, x):
        return 0 <= y < h and 0 <= x < w and not mask[y, x]

    def taken(y, x):
        return 0 <= y < h and 0 <= x < w and mask[y, x]

    while True:
        for _ in range(2):   # straight on, else turn right once
            if free(r + dr, c + dc) and not taken(r + 2 * dr, c + 2 * dc):
                r, c = r + dr, c + dc
                mask[r, c] = True
                break
            dr, dc = dc, -dr
        else:
            return mask


# -- phase 1 -----------------------------------------------------------------
def environment():
    if not torch.cuda.is_available():
        sys.exit('chip_smoke: torch.cuda.is_available() is False; '
                 'this script needs a CUDA GPU')
    log(f'python {sys.version.split()[0]}  torch {torch.__version__}  '
        f'cuda {torch.version.cuda}')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f'card: {smi}')
    for mod in ('yaml', 'PIL', 'pandas', 'matplotlib'):
        try:
            __import__(mod)
            log(f'{mod}: importable')
        except ImportError:
            log(f'{mod}: missing')
    return smi


# -- phase 2 -----------------------------------------------------------------
def build():
    from dnncancerannotator_torch.ops.kernels import _build
    stale = _build.library_path()
    if os.path.exists(stale):
        os.remove(stale)  # build from the checkout's sources, every run
    _build.library()
    log(f'build: {_build.build_seconds:.2f} s -> {_build.library_path()}')
    from dnncancerannotator_torch.data import _native
    stale = _native.library_path()
    if os.path.exists(stale):
        os.remove(stale)
    _native.library()
    log(f'host library build (g++): {_native.build_seconds:.2f} s -> '
        f'{_native.library_path()}')
    with open(os.path.join(_build.BUILD_DIR, 'nvcc.log')) as fh:
        for line in fh:
            if 'Compiling entry function' in line:
                log('  nvcc:', line.split("'")[1][:72])
            elif 'registers' in line or 'spill' in line:
                log('  nvcc:   ', line.strip())


# -- phase 3 -----------------------------------------------------------------
def _time_fns(fns):
    '''{name: median CUDA-event ms} of each callable, timed in turns after
    warm-up.'''
    for _ in range(3):
        for fn in fns.values():
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(TIMED_RUNS):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(t) for name, t in times.items()}


def _time_pair(kernel_fn, plain_fn):
    '''Median CUDA-event ms of each, timed in turns after warm-up.'''
    t = _time_fns({'plain': plain_fn, 'kernel': kernel_fn})
    return t['kernel'], t['plain']


# torch.profiler's tracing can leave later CUDA calls of the process slower
# on the host (a call that took device times in phases 3-3f measured the
# unet.yaml train throughput 40% below the call before it), so every
# profiler window is queued here and run after the last host-clock or
# CUDA-event measurement
_DEFERRED = []


def _frozen(fn):
    '''A copy of ``fn`` whose free variables keep the values they have now:
    the sites' lambdas close over their loops' variables, and a queued call
    must see its own site's tensors.'''
    cells = []
    for cell in fn.__closure__ or ():
        try:
            cells.append(types.CellType(cell.cell_contents))
        except ValueError:   # not bound yet
            cells.append(cell)
    return types.FunctionType(fn.__code__, fn.__globals__, fn.__name__,
                              fn.__defaults__, tuple(cells) or None)


def _device_ms(fn, runs=DEVICE_RUNS):
    '''Device time of one call of ``fn``: the device time of every kernel,
    copy and fill that ``runs`` calls launched, summed by torch.profiler,
    over ``runs``; no host time.'''
    cuda = torch.profiler.ProfilerActivity.CUDA
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, cuda]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not getattr(e, 'is_user_annotation', False))
    return us / 1e3 / runs


def _device_split(fn, runs=DEVICE_RUNS):
    '''{kernel name: (device ms, launches)} of one call of ``fn``, from
    one torch.profiler window of ``runs`` calls (``_device_ms``'s window,
    by name).'''
    cuda = torch.profiler.ProfilerActivity.CUDA
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, cuda]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / 1e3 / runs, e.count / runs)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', False)
            and e.self_device_time_total > 0}


def _fullest_split(fn, windows=3, most=10):
    '''``_device_split`` of the window, of ``windows``, that recorded the
    most launches (then the most time): now and then a window misses the
    records of some kernels or of all of them (seen once or twice a run),
    never adds any. While every window taken recorded nothing (all three
    of one CCA set in one run on an H100), more are taken, up to ``most``.'''
    splits = [_device_split(fn) for _ in range(windows)]
    while not any(splits) and len(splits) < most:
        splits.append(_device_split(fn))
    return max(splits, key=lambda s: (sum(c for _, c in s.values()),
                                      sum(ms for ms, _ in s.values())))


def _time_site(kernel_fn, plain_fn, library_fn=None):
    '''{ms, plain_ms, library_ms}: median CUDA-event ms around each call
    (host time included), timed in turns; and {device_ms, plain_device_ms,
    library_device_ms}: the device time alone (``_device_ms``); the
    library's None without a library call.'''
    fns = {'': kernel_fn, 'plain_': plain_fn}
    if library_fn is not None:
        fns['library_'] = library_fn
    t = _time_fns(fns)
    times = {'library_ms': None, 'library_device_ms': None}
    for key in fns:
        times[key + 'ms'] = t[key]
    log('    ' + '  '.join(f'{key or "kernel_"}ms {t[key]:.4f}' for key in fns))

    frozen = {key: _frozen(fn) for key, fn in fns.items()}

    def device_times():
        for key, fn in frozen.items():
            # the larger of two windows: now and then a window misses the
            # records of some kernels (seen once or twice a run, as a time
            # near 0)
            times[key + 'device_ms'] = max(_device_ms(fn), _device_ms(fn))
        log(f'  {times["label"]:44s} ' + '  '.join(
            f'{key or "kernel_"}device_ms {times[key + "device_ms"]:.4f}'
            for key in fns))
    _DEFERRED.append(device_times)
    return times


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes, flops, rate=F32_FLOP_PER_S):
    '''(ms, what bounds it): the least time the H100 could take to move
    ``n_bytes`` and do ``flops`` operations at ``rate`` (f32 FMAs outside
    the tensor cores by default).'''
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def tf32x3_bound(n_bytes, flops):
    '''``bound`` of a 3xTF32 product: three TF32 products for each f32
    one, on the tensor cores.'''
    return bound(n_bytes, 3 * flops, TF32_FLOP_PER_S)


def _check_close(name, got, want, tol=KERNEL_TOL):
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    log(f'  {name:44s} max|diff| {err:.3e}  max|ref| {scale:.3e}')
    if not err <= tol * scale:
        raise AssertionError(f'{name}: kernel disagrees with its plain '
                             f'version: {err} > {tol} * {scale}')
    return err


def record(results, name, err, times, site_bound, tc_bound=None):
    '''Sum a site's times (``_time_site``) and its bound (ms, what bounds
    it; and for a tensor-core kernel its ``tf32x3_bound`` as well) into its
    kernel's entry; keep the worst error. The entry is bound by what bounds
    the larger share of its summed bound.'''
    acc = results.setdefault(name, dict(
        max_abs_err=0.0, site_times=[], bound_ms=0.0,
        by={'bytes': 0.0, 'operations': 0.0}, sites=0))
    acc['max_abs_err'] = max(acc['max_abs_err'], err)
    times['label'] = f'{name} site {acc["sites"] + 1}'
    acc['site_times'].append(times)
    acc['bound_ms'] += site_bound[0]
    acc['by'][site_bound[1]] += site_bound[0]
    if tc_bound is not None:
        acc['tf32x3_bound_ms'] = acc.get('tf32x3_bound_ms', 0.0) + tc_bound[0]
    acc['sites'] += 1


def summed_times(acc):
    '''A kernel's times (``_time_site``) summed over its sites; None where
    a site has no library call.'''
    out = {}
    for times in acc['site_times']:
        for key, value in times.items():
            if key != 'label':
                out[key] = (None if value is None or out.get(key, 0.0) is None
                            else out.get(key, 0.0) + value)
    return out


def _site_hw(path, size):
    '''Spatial size of a chain site's input at crop size ``size``.'''
    level = int(path[-1])
    return size >> level if 'encoder' in path else size >> (2 - level)


# the forward as the 300 training launches call it: B=8, need_c1=True;
# (site label, times of _time_site, bound ms) for the summary line
TRAIN_FORWARD = []


def train_chain_site(path, w1, b1, w2, b2, hw, gen):
    '''The chain forward at a site as training calls it (B=8 with c1 for
    the backward's mask): c1 and c2 against the plain version, within
    F64_RATIO of it against f64, its times and its bound (c1's write
    counted).'''
    from dnncancerannotator_torch.ops.kernels import conv_chain as CC
    x = torch.rand((TRAIN_BATCH, w1.shape[1], hw, hw), generator=gen,
                   device=gen.device)
    c1, c2 = CC.conv_chain(x, w1, b1, w2, b2, need_c1=True)
    want = CC.plain(x, w1, b1, w2, b2)
    want64 = CC.plain(*_f64(x, w1, b1, w2, b2))
    name = f'conv_chain B={TRAIN_BATCH} need_c1 {path}'
    for label, got_t, want_t, want64_t in zip(('c1', 'c2'), (c1, c2), want,
                                              want64):
        _check_close(f'{name} {label}', got_t, want_t)
        _f64_errors(f'{name} {label}', got_t, want_t, want64_t, F64_RATIO)
    times = _time_site(lambda: CC.conv_chain(x, w1, b1, w2, b2, need_c1=True),
                       lambda: CC.plain(x, w1, b1, w2, b2))
    times['label'] = name
    taps = w1.shape[2] * w1.shape[3]
    flops = 2 * x[:, :1].numel() * taps * (w1.shape[0] * w1.shape[1]
                                           + w2.shape[0] * w2.shape[1])
    site_bound = bound(nbytes(x, w1, b1, w2, b2, c1, c2), flops)[0]
    log(f'  {name:44s} bound {site_bound:.4f} ms (c1 written)')
    TRAIN_FORWARD.append((name, times, site_bound))


@torch.no_grad()
def kernel_sites(model, device, results):
    '''Each kernel against its plain version at every main-path site.'''
    from dnncancerannotator_torch.ops.kernels import conv_chain as CC
    from dnncancerannotator_torch.ops.kernels import stencil_conv as SC
    from dnncancerannotator_torch.ops.kernels import tconv2x2 as TC

    gen = torch.Generator(device=device).manual_seed(SEED)
    modules = dict(model.named_modules())

    log(f'kernels (B={BATCH}, {SIZE}x{SIZE} input):')
    F = torch.nn.functional
    for path, _ in CHAIN_SITES:
        chain = modules[path + '.convchain']
        w1, b1 = chain.conv_0.weight, chain.conv_0.bias
        w2, b2 = chain.conv_1.weight, chain.conv_1.bias
        hw = _site_hw(path, SIZE)
        x = torch.rand((BATCH, w1.shape[1], hw, hw), generator=gen,
                       device=device)
        _, got = CC.conv_chain(x, w1, b1, w2, b2)
        _, want = CC.plain(x, w1, b1, w2, b2)
        name = (f'conv_chain {path} {w1.shape[1]}->{w1.shape[0]}->'
                f'{w2.shape[0]} @{hw}')
        err = _check_close(name, got, want)
        _f64_errors(name, got, want, CC.plain(*_f64(x, w1, b1, w2, b2))[1],
                    F64_RATIO)
        times = _time_site(lambda: CC.conv_chain(x, w1, b1, w2, b2),
                           lambda: CC.plain(x, w1, b1, w2, b2))
        taps = w1.shape[2] * w1.shape[3]
        flops = 2 * x[:, :1].numel() * taps * (w1.shape[0] * w1.shape[1]
                                               + w2.shape[0] * w2.shape[1])
        record(results, 'conv_chain', err, times,
               bound(nbytes(x, w1, b1, w2, b2, got), flops))
        train_chain_site(path, w1, b1, w2, b2, hw, gen)
    for path in TCONV_SITES:
        tconv = modules[path + '.tconv']
        w, b = tconv.weight, tconv.bias
        hw = SIZE >> (3 - int(path[-1]))
        x = torch.rand((BATCH, w.shape[0], hw, hw), generator=gen,
                       device=device)
        got, want = TC.tconv2x2(x, w, b), TC.plain(x, w, b)
        err = _check_close(
            f'tconv2x2 {path} {w.shape[0]}->{w.shape[1]} @{hw}', got, want)
        times = _time_site(lambda: TC.tconv2x2(x, w, b),
                           lambda: TC.plain(x, w, b),
                           lambda: F.conv_transpose2d(x, w, b, stride=2))
        record(results, 'tconv2x2', err, times,
               bound(nbytes(x, w, b, got), 2 * got.numel() * w.shape[0]))
    head = modules['last_conv']
    w, b = head.weight, head.bias
    pads = ((0, 0), (0, 0))
    x = torch.rand((BATCH, w.shape[1], SIZE, SIZE), generator=gen,
                   device=device)
    got, want = SC.stencil_conv(x, w, b, pads), SC.plain(x, w, b, pads)
    err = _check_close(f'stencil_conv last_conv 1x1 {w.shape[1]}->1 @{SIZE}',
                       got, want)
    times = _time_site(lambda: SC.stencil_conv(x, w, b, pads),
                       lambda: SC.plain(x, w, b, pads),
                       lambda: F.conv2d(x, w, b))
    record(results, 'stencil_conv', err, times,
           bound(nbytes(x, w, b, got), 2 * got.numel() * w[0].numel()))
    # the head as training calls it (B=8): its times and bound on a line of
    # their own, beside the prediction site's in the kernels line
    x = x[:TRAIN_BATCH].contiguous()
    got = SC.stencil_conv(x, w, b, pads)
    name = f'stencil_conv last_conv B={TRAIN_BATCH}'
    _check_close(name, got, SC.plain(x, w, b, pads))
    times = _time_site(lambda: SC.stencil_conv(x, w, b, pads),
                       lambda: SC.plain(x, w, b, pads),
                       lambda: F.conv2d(x, w, b))
    times['label'] = name
    site_bound = bound(nbytes(x, w, b, got), 2 * got.numel() * w[0].numel())
    log(f'  {name:44s} bound {site_bound[0]:.4f} ms ({site_bound[1]})')


# -- phase 3b ----------------------------------------------------------------
# the chain backward's launches a call at the unet.yaml sites: the fused
# kernel and the partial sums' finish; the tconv backward's and the head
# conv's backward's (the pointwise route): one
CHAIN_BWD_LAUNCHES = 2
CHAIN_BWD_SPLIT_LAUNCHES = 5   # a plan that is not fused: + csrc/wgrad.cu
TCONV_BWD_LAUNCHES = 1
STENCIL_BWD_LAUNCHES = 1
# the two warp kernels' launches a call, on either route
WARP_LAUNCHES = 1


def library_launches(call, calls=10):
    '''Kernels the kernel library launched a call of ``call``, from its own
    count (``_build.library_launches``), no profiler.'''
    from dnncancerannotator_torch.ops.kernels import _build
    torch.cuda.synchronize()
    before = _build.library_launches()
    for _ in range(calls):
        call()
    torch.cuda.synchronize()
    return (_build.library_launches() - before) / calls


def _launch_split(name, call, want):
    '''Prints a call's device time by kernel (a deferred profiler window,
    ``_device_split``) and raises unless the call launched ``want`` of the
    library's kernels (``library_launches``).'''
    log(f'  {name} by kernel, device ms a call:')
    for key, (ms, count) in sorted(_device_split(call).items(),
                                   key=lambda kv: -kv[1][0]):
        log(f'    {ms:.4f} ms {count:4.1f}x  {key[:90]}')
    count = library_launches(call)
    if count != want:
        raise AssertionError(f'{name}: {count} launches a call, want {want}')


def _f64_errors(name, got, want, want64, ratio=None):
    '''Prints the kernel's and the plain f32 version's max|diff| from the
    f64 plain version and their ratio; with ``ratio``, raises where the
    kernel's is more than ``ratio`` times the plain version's.'''
    err = float((got.double() - want64).abs().max())
    plain_err = float((want.double() - want64).abs().max())
    share = err / plain_err if plain_err else float('inf') if err else 1.0
    log(f'  {"":44s} vs f64: kernel {err:.3e}  plain f32 {plain_err:.3e}  '
        f'ratio {share:.2f}')
    if ratio is not None and not err <= ratio * plain_err:
        raise AssertionError(f'{name}: the kernel is {share:.2f}x as far from '
                             f'f64 as the plain f32 version (> {ratio})')


def _check_grads(name, got, want, want64, ratio=None):
    '''(dx or None, weight and bias gradients...) of a backward kernel
    against its plain version: dx to DX_TOL, the rest to DW_TOL, relative
    to max|ref|; prints the kernel's and the plain f32 version's error
    against f64 (``_f64_errors``, ``ratio`` as there).'''
    worst = 0.0
    for label, g, w, w64 in zip(('dx', 'dw1', 'db1', 'dw2', 'db2')
                                if len(got) == 5 else ('dx', 'dw', 'db'),
                                got, want, want64):
        if w is None:
            continue
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        tol = DX_TOL if label == 'dx' else DW_TOL
        log(f'  {name:40s} {label:3s} max|diff| {err:.3e}  max|ref| '
            f'{scale:.3e}')
        _f64_errors(f'{name} {label}', g, w, w64, ratio)
        if not err <= tol * scale:
            raise AssertionError(f'{name} {label}: kernel disagrees with its '
                                 f'plain version: {err} > {tol} * {scale}')
        worst = max(worst, err)
    return worst


def _f64(*tensors):
    return [t.double() for t in tensors]


@torch.no_grad()
def backward_sites(model, device, results):
    '''Each backward kernel against its plain version at every site of the
    training step, and the warp kernel at the augmentation's shapes.'''
    from dnncancerannotator_torch.ops.kernels import conv_chain as CC
    from dnncancerannotator_torch.ops.kernels import conv_chain_bwd as CCB
    from dnncancerannotator_torch.ops.kernels import stencil_conv_bwd as SCB
    from dnncancerannotator_torch.ops.kernels import tconv2x2_bwd as TCB
    from dnncancerannotator_torch.ops.kernels import warp_twopass as WT

    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    modules = dict(model.named_modules())
    conv_bwd = torch.ops.aten.convolution_backward
    b = TRAIN_BATCH
    log(f'backward kernels (B={b}, {SIZE}x{SIZE} crops):')
    for path, _ in CHAIN_SITES:
        chain = modules[path + '.convchain']
        w1, b1 = chain.conv_0.weight, chain.conv_0.bias
        w2, b2 = chain.conv_1.weight, chain.conv_1.bias
        hw = _site_hw(path, SIZE)
        x = torch.rand((b, w1.shape[1], hw, hw), generator=gen, device=device)
        c1, c2 = CC.plain(x, w1, b1, w2, b2)
        g = torch.randn(c2.shape, generator=gen, device=device)
        need_dx = path != 'unet.encoder.down_0'   # the input needs no grad
        args = (x, c1, c2, g, w1, w2, need_dx)
        name = (f'conv_chain_bwd {path} {w1.shape[1]}->{w1.shape[0]}->'
                f'{w2.shape[0]} @{hw}')
        got = CCB.conv_chain_bwd(*args)
        again = CCB.conv_chain_bwd(*args)
        if not all(torch.equal(a, b) for a, b in zip(got[1:], again[1:])):
            raise AssertionError(f'{name}: dw, db differ between two calls')
        err = _check_grads(name, got, CCB.plain(*args),
                           CCB.plain(*_f64(*args[:-1]), need_dx), F64_RATIO)
        times = _time_site(lambda: CCB.conv_chain_bwd(*args),
                           lambda: CCB.plain(*args))
        _DEFERRED.append(functools.partial(
            _launch_split, name, functools.partial(CCB.conv_chain_bwd, *args),
            CHAIN_BWD_LAUNCHES))
        # dc1 and dw2 through conv_1, dw1 (and dx) through conv_0
        pix = x[:, :1].numel() * w1.shape[2] * w1.shape[3]
        flops = 2 * pix * (2 * w2.shape[0] * w2.shape[1]
                           + (2 if need_dx else 1) * w1.shape[0] * w1.shape[1])
        record(results, 'conv_chain_bwd', err, times,
               bound(nbytes(*args[:6], *got), flops))
    for path in TCONV_SITES:
        w = modules[path + '.tconv'].weight
        hw = SIZE >> (3 - int(path[-1]))
        x = torch.rand((b, w.shape[0], hw, hw), generator=gen, device=device)
        g = torch.randn((b, w.shape[1], 2 * hw, 2 * hw), generator=gen,
                        device=device)
        name = f'tconv2x2_bwd {path} {w.shape[0]}->{w.shape[1]} @{hw}'
        got = TCB.tconv2x2_bwd(x, g, w)
        again = TCB.tconv2x2_bwd(x, g, w)
        if not all(torch.equal(a, b) for a, b in zip(got[1:], again[1:])):
            raise AssertionError(f'{name}: dw, db differ between two calls')
        err = _check_grads(name, got, TCB.plain(x, g, w),
                           TCB.plain(*_f64(x, g, w)), F64_RATIO)
        times = _time_site(
            lambda: TCB.tconv2x2_bwd(x, g, w), lambda: TCB.plain(x, g, w),
            lambda: conv_bwd(g, x, w, [w.shape[1]], [2, 2], [0, 0], [1, 1],
                             True, [0, 0], 1, [True, True, True]))
        _DEFERRED.append(functools.partial(
            _launch_split, name, functools.partial(TCB.tconv2x2_bwd, x, g, w),
            TCONV_BWD_LAUNCHES))
        record(results, 'tconv2x2_bwd', err, times,
               bound(nbytes(x, g, w, *got), 4 * g.numel() * w.shape[0]))
    w = modules['last_conv'].weight
    pads = ((0, 0), (0, 0))
    x = torch.rand((b, w.shape[1], SIZE, SIZE), generator=gen, device=device)
    g = torch.randn((b, 1, SIZE, SIZE), generator=gen, device=device)
    name = f'stencil_conv_bwd last_conv 1x1 {w.shape[1]}->1 @{SIZE}'
    got = SCB.stencil_conv_bwd(x, g, w, pads)
    again = SCB.stencil_conv_bwd(x, g, w, pads)
    if not all(torch.equal(a, b) for a, b in zip(got[1:], again[1:])):
        raise AssertionError(f'{name}: dw, db differ between two calls')
    err = _check_grads(name, got, SCB.plain(x, g, w, pads),
                       SCB.plain(*_f64(x, g, w), pads), F64_RATIO)
    times = _time_site(
        lambda: SCB.stencil_conv_bwd(x, g, w, pads),
        lambda: SCB.plain(x, g, w, pads),
        lambda: conv_bwd(g, x, w, [w.shape[0]], [1, 1], [0, 0], [1, 1],
                         False, [0, 0], 1, [True, True, True]))
    _DEFERRED.append(functools.partial(
        _launch_split, name,
        functools.partial(SCB.stencil_conv_bwd, x, g, w, pads),
        STENCIL_BWD_LAUNCHES))
    record(results, 'stencil_conv_bwd', err, times,
           bound(nbytes(x, g, w, *got), 4 * g.numel() * w[0].numel()))

    # the warp: a dense flow from a real bank, and a random one past +-d
    d, image, flows = warp_inputs(device)
    for label, flow in flows.items():
        name = f'warp_twopass [{b},{SIZE},{SIZE},6] d={d} {label}'
        route = WT.route(*image.shape, d)
        got, want = WT.warp_twopass(image, flow, d), WT.plain(image, flow, d)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        log(f'  {name:52s} route {route} max|diff| {err:.3e}  max|ref| '
            f'{float(want.abs().max()):.3e}')
        if not torch.equal(got, want):   # same rounded operations: exact
            raise AssertionError(f'{name} differs from its plain version by '
                                 f'{err}')
        if route != 'tile':
            raise AssertionError(f'{name}: the main path\'s shape takes the '
                                 f'{route} route')
        times = _time_site(lambda: WT.warp_twopass(image, flow, d),
                           lambda: WT.plain(image, flow, d))
        _DEFERRED.append(functools.partial(
            _launch_split, name,
            functools.partial(WT.warp_twopass, image, flow, d),
            WARP_LAUNCHES))
        # about 12 operations an output value (two clamped bilinear passes)
        record(results, 'warp_twopass', err, times,
               bound(nbytes(image, flow, got), 12 * got.numel()))


def warp_inputs(device):
    '''(d, image, {label: flow}): the banked train step's warp_twopass
    inputs, [8, 256, 256, 6] at a dense flow from a real warp bank and at a
    random flow past +-d.'''
    from dnncancerannotator_torch.data import augment
    from dnncancerannotator_torch.ops import warp

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    b = TRAIN_BATCH
    bank = augment.build_warp_bank(gen, b, (SIZE, SIZE))
    image = torch.rand((b, SIZE, SIZE, 6), generator=gen, device=device)
    flows = {
        'bank flow': warp._upsample_flow(bank['flows'], SIZE, SIZE,
                                         bank['stride']).contiguous(),
        'random flow past +-d': torch.randn(
            (b, SIZE, SIZE, 2), generator=gen, device=device) * 12.0,
    }
    return bank['max_displacement'], image, flows


# -- phase 4 -----------------------------------------------------------------
def write_records(data_dir, size=SIZE, n_exams=N_EXAMS,
                  slices_per_exam=SLICES_PER_EXAM):
    '''Seeded synthetic exams (uint8 [S, size, size, 6], disc lesions) in
    two .tfrecords files, written with the port's codec.'''
    from dnncancerannotator_torch.data import tfrecord as tfr
    from dnncancerannotator_torch.data.records import DEFAULT_SLICE_TYPES

    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[:size, :size]
    paths = []
    for category, n_exams in zip(('cancer', 'healthy'), n_exams):
        path = os.path.join(data_dir, f'{category}.tfrecords')
        with open(path, 'wb') as f:
            for pid in range(1, n_exams + 1):
                slices = rng.integers(
                    0, 255, (slices_per_exam, size, size, 6), np.uint8)
                slices[..., 5] = 0
                if category == 'cancer':
                    for s in range(slices_per_exam):
                        cy, cx = rng.integers(size // 5, size - size // 5, 2)
                        r = rng.integers(size // 32, size // 8)
                        disk = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
                        slices[s][disk, :5] = 220
                        slices[s][disk, 5] = 255
                example = tfr.encode_example({
                    'slices': tfr.serialize_tensor(slices),
                    'patientID': pid,
                    'examID': 1,
                    'path': f'/exams/{category}/{pid}/1'.encode(),
                    'category': category.encode(),
                    'shape': list(slices.shape),
                    'slice_types': [t.encode() for t in DEFAULT_SLICE_TYPES],
                })
                tfr.write_record(f, example)
        paths.append(path)
    return paths


def write_save_path(save_path, data_paths, device):
    '''options.yaml (JSON, which is YAML) with the stacked unet.yaml options,
    and a seeded checkpoint ckpt-1.'''
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.utils import config as config_lib

    config = config_lib.load_config([os.path.join(REPO, c) for c in CONFIGS])
    os.makedirs(save_path, exist_ok=True)
    with open(os.path.join(save_path, 'options.yaml'), 'w') as fh:
        json.dump(dict(config=config, save_path=save_path,
                       data_path=data_paths), fh)
    eng = engine.Engine(config, seed=SEED, device=device)
    eng.build((BATCH, SIZE, SIZE, 5))
    gen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():  # non-zero biases, so a misplaced bias shows
        for name, param in eng.model.named_parameters():
            if name.endswith('.bias'):
                param.copy_(torch.randn(param.shape, generator=gen) * 0.1)
    eng.save_ckpt(os.path.join(save_path, 'checkpoints'), 1)
    eng.finalize_checkpoints()
    return config


def plain_logits(model, x):
    '''The UNetAnnotator forward written out with the kernels' plain
    PyTorch versions (differentiable by autograd): the reference for the
    maps and the gradients. x: NHWC features -> NHWC logits.'''
    from dnncancerannotator_torch.models.blocks import center_crop_to
    from dnncancerannotator_torch.ops.kernels import conv_chain as CC
    from dnncancerannotator_torch.ops.kernels import stencil_conv as SC
    from dnncancerannotator_torch.ops.kernels import tconv2x2 as TC
    from dnncancerannotator_torch.ops.pooling import max_pool2d

    def chain(cc, h):
        return CC.plain(h, cc.conv_0.weight, cc.conv_0.bias,
                        cc.conv_1.weight, cc.conv_1.bias)[1]

    h = x.permute(0, 3, 1, 2).contiguous()
    skips = []
    for i in range(3):
        skip = chain(getattr(model.unet.encoder, f'down_{i}').convchain, h)
        skips.append(skip)
        h = max_pool2d(skip, 2)
    for i, skip in enumerate(reversed(skips)):
        up_mod = getattr(model.unet.decoder, f'up_{i}')
        up = TC.plain(h, up_mod.tconv.weight, up_mod.tconv.bias)
        skip = center_crop_to(skip, up.shape[2], up.shape[3])
        h = chain(up_mod.convchain, torch.cat([up, skip], dim=1))
    logits = SC.plain(h, model.last_conv.weight, model.last_conv.bias,
                      ((0, 0), (0, 0)))
    return logits.permute(0, 2, 3, 1)


def plain_forward(model, x):
    '''Probabilities of plain_logits.'''
    return torch.sigmoid(plain_logits(model, x))


def _check_maps(model, data_paths, out_dir, n_slices, reference=None,
                exact=None, size=SIZE):
    '''The predict CLI's maps: one file per slice, finite, in [0, 1], and
    within MAP_TOL of the plain forward of ``model`` on the card (or of
    ``reference``, NHWC features -> probabilities), at ``size`` x ``size``.

    With ``exact`` (the f64 forward, the same features -> probabilities),
    maps further than that from the plain f32 forward are held to it as
    ``_compare_step`` holds a step: they pass if they are no further from
    it than F64_RATIO times the plain f32 forward's maps, the kernels' own
    rule (phase 3e). Two f32 forwards of a deep model on the same weights
    differ by the rounding of every layer, which no fixed tolerance
    bounds.'''
    from dnncancerannotator_torch.data import pipeline

    reference = reference or (lambda x: plain_forward(model, x))
    device = next(model.parameters()).device
    ds = pipeline.predict_ds(data_paths, output_size=(size, size),
                             batch_size=BATCH)
    worst, n_files = 0.0, 0
    worst64 = plain64 = 0.0   # from the f64 forward: the maps, the plain
    with torch.no_grad():
        for batch in ds.batches():
            x = torch.from_numpy(batch['slices']).to(device).float() / 255.0
            ref = reference(x[..., :5]).cpu().numpy()
            ref64 = (exact(x[..., :5]).cpu().numpy() if exact is not None
                     else None)
            for i, meta in enumerate(batch['meta']):
                path = os.path.join(out_dir, *meta['path'].split('/')[-3:],
                                    f"{meta['sliceID']:02d}.npy")
                got = np.load(path)
                if got.shape != (size, size) or not np.isfinite(got).all() \
                        or got.min() < 0 or got.max() > 1:
                    raise AssertionError(f'bad map {path}: {got.shape}, '
                                         f'[{got.min()}, {got.max()}]')
                worst = max(worst, float(np.abs(got - ref[i, :, :, 0]).max()))
                if ref64 is not None:
                    worst64 = max(worst64, float(
                        np.abs(got - ref64[i, :, :, 0]).max()))
                    plain64 = max(plain64, float(
                        np.abs(ref[i, :, :, 0] - ref64[i, :, :, 0]).max()))
                n_files += 1
    log(f'maps vs plain forward on the card: {n_files} maps, '
        f'max|diff| {worst:.3e}' + (
            '' if exact is None else f'; from the f64 forward: maps '
            f'{worst64:.3e}, plain f32 forward {plain64:.3e}'))
    if n_files != n_slices:
        raise AssertionError(f'{n_files} maps, want {n_slices}')
    if not worst <= MAP_TOL and not (exact is not None
                                     and worst64 <= F64_RATIO * plain64):
        raise AssertionError(f'maps disagree with the plain forward: '
                             f'{worst} (tol {MAP_TOL}), {n_files} maps' + (
                                 '' if exact is None else
                                 f'; from the f64 forward {worst64} against '
                                 f'the plain f32 forward\'s {plain64}'))


def run_slice(eng, data_paths, save_path, out_dir):
    '''The predict CLI, then its maps against the plain forward of the
    same loaded weights (``eng``).'''
    from dnncancerannotator_torch.ops import kernels
    from dnncancerannotator_torch.runs.__main__ import main

    argv = ['predict', '--save_path', save_path, '--data_path', *data_paths,
            '--output_path', out_dir, '--batch_size', str(BATCH),
            '--output_format', 'npy', '--device', eng.device.type]
    kernels.reset_launches()
    torch.cuda.synchronize()
    start = time.perf_counter()
    count = main(argv=argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = kernels.launch_counts()

    n_slices = sum(N_EXAMS) * SLICES_PER_EXAM
    n_batches = -(-n_slices // BATCH)
    log(f'predict: {count} maps in {seconds:.3f} s -> '
        f'{count / seconds:.2f} slices/s (host clock, build excluded)')
    log(f'launches during predict: {launches}')
    if count != n_slices:
        raise AssertionError(f'predict wrote {count} maps, want {n_slices}')
    for name, sites in (('conv_chain', len(CHAIN_SITES)),
                        ('tconv2x2', len(TCONV_SITES)), ('stencil_conv', 1)):
        if launches[name] < sites * n_batches:
            raise AssertionError(
                f'{name} launched {launches[name]} times during predict, '
                f'want >= {sites} x {n_batches}')

    _check_maps(eng.model, data_paths, out_dir, n_slices)

    # whole-model forward at B=64: kernels vs plain versions, in turns
    x = torch.rand((BATCH, SIZE, SIZE, 5), device=eng.device)
    with torch.no_grad():
        ms, plain_ms = _time_pair(lambda: eng.model(x),
                                  lambda: plain_forward(eng.model, x))
    log(f'model forward B={BATCH}: kernels {ms:.4f} ms  plain {plain_ms:.4f} '
        f'ms  ({BATCH * 1000 / ms:.1f} vs {BATCH * 1000 / plain_ms:.1f} '
        'slices/s device-side)')
    return launches


# -- phase 5 -----------------------------------------------------------------
# every kernel of the train step, and its sites in one step
TRAIN_SITES = {'conv_chain': 6, 'conv_chain_bwd': 6, 'tconv2x2': 3,
               'tconv2x2_bwd': 3, 'stencil_conv': 1, 'stencil_conv_bwd': 1,
               'warp_twopass': 1}


@contextlib.contextmanager
def _plain_versions(*modules):
    '''Within the block each kernel module's wrapper (the function named as
    the module) runs the module's plain version instead of the kernel.'''
    saved = [(mod, mod.__name__.rsplit('.', 1)[-1]) for mod in modules]
    saved = [(mod, name, getattr(mod, name)) for mod, name in saved]
    for mod, name, _ in saved:
        setattr(mod, name, _plain_chain if name == 'conv_chain' else mod.plain)
    try:
        yield
    finally:
        for mod, name, kernel in saved:
            setattr(mod, name, kernel)


def _plain_warp():
    '''Within the block, the augmentation's resample runs its plain
    version instead of the kernel.'''
    from dnncancerannotator_torch.ops.kernels import warp_twopass as WT
    return _plain_versions(WT)


def _step_grads(eng, ds, raw, draws, plain, f64=False):
    '''Loss and parameter gradients of one train step on ``raw`` with the
    given augmentation draws, through the kernels or their plain
    versions; the loss is the engine's (label smoothing included) plus its
    kernel regularizer's term, where it has one. With ``f64`` the plain
    step's model and loss run in f64 on the same augmented f32 batch, and
    the model is put back in f32 after (as ``_big_step``).'''
    from dnncancerannotator_torch.data import augment

    bank = eng._warp_bank(ds)
    with _plain_warp() if plain else contextlib.nullcontext():
        images = augment.apply_chain(ds.augment_methods, raw.float() / 255.0,
                                     draws, bank)
    x, y = augment.to_feature_label(images, ds.slice_types)
    try:
        if f64:
            eng.model.double()
            x = x.double()
        eng.model.zero_grad(set_to_none=True)
        logits = plain_logits(eng.model, x) if plain else eng.model(
            x, return_logits=True)
        loss = eng.loss(y, logits)
        reg = eng.regularization()
        if reg is not None:
            loss = loss + reg
        loss.backward()
        return float(loss.detach()), {n: p.grad.clone()
                                      for n, p in eng.model.named_parameters()}
    finally:
        if f64:
            eng.model.float()
            eng.model.zero_grad(set_to_none=True)


def check_step_grads(eng, ds, raw, gen, label):
    """One train step's loss and every parameter gradient through the
    kernels against a plain train step on ``raw`` and the same draws (from
    ``gen``): the loss to LOSS_TOL relative, each gradient to STEP_TOL of
    max|ref|, else no further from an f64 step than F64_RATIO times the
    plain step."""
    from dnncancerannotator_torch.data import augment

    draws = augment.draw_chain(ds.augment_methods, raw.shape, gen,
                               eng._warp_bank(ds))
    loss, grads = _step_grads(eng, ds, raw, draws, plain=False)
    plain_loss, plain_grads = _step_grads(eng, ds, raw, draws, plain=True)
    log(f'one {label}: loss {loss:.7f} kernels, {plain_loss:.7f} plain')
    if not abs(loss - plain_loss) <= LOSS_TOL * abs(plain_loss):
        raise AssertionError(f'{label} loss {loss} vs plain {plain_loss}')
    # a gradient further than STEP_TOL from the plain step is held to the
    # f64 step, as _compare_step holds unet_big's: no further from it than
    # F64_RATIO times the plain f32 step
    worst, exact = 0.0, []
    for name, want in plain_grads.items():
        err = float((grads[name] - want).abs().max())
        scale = float(want.abs().max())
        if err <= STEP_TOL * scale:
            worst = max(worst, err / scale)
            continue
        if not exact:
            exact.append(_step_grads(eng, ds, raw, draws, plain=True,
                                     f64=True)[1])
        err64, plain64 = (float((t.double() - exact[0][name]).abs().max())
                          for t in (grads[name], want))
        log(f'  {name}: {err:.3e} > {STEP_TOL} * {scale:.3e} from the plain '
            f'step; from the f64 step: kernels {err64:.3e}, plain '
            f'{plain64:.3e}')
        if not err64 <= F64_RATIO * plain64:
            raise AssertionError(f'{name}: gradient {err} > {STEP_TOL} * '
                                 f'{scale} from the plain {label}, and '
                                 f'{err64} from the f64 step against the '
                                 f'plain step\'s {plain64}')
    log(f'one {label}: {len(grads)} parameter gradients within '
        f'{worst:.3e} * max|ref| of the plain step, but for those held to '
        'the f64 step above')


def train_slice(device):
    '''Phase 5; returns the launch counts of the first train CLI call, the
    run's save_path and its data paths.'''
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.data import augment, pipeline
    from dnncancerannotator_torch.ops import kernels
    from dnncancerannotator_torch.runs.__main__ import main as cli
    from dnncancerannotator_torch.utils import config as config_lib

    data_paths = write_records(os.path.join(WORK, 'train_data'), EXAM_SIZE,
                               TRAIN_EXAMS, TRAIN_SLICES)
    overlay = os.path.join(WORK, 'steps_per_call.json')
    with open(overlay, 'w') as fh:
        json.dump({'deploy_options.steps_per_call': STEPS_PER_CALL}, fh)
    save_path = os.path.join(WORK, 'train_run')
    ckpt_dir = os.path.join(save_path, 'checkpoints')
    argv = ['train', '--config', *[os.path.join(REPO, c) for c in CONFIGS],
            overlay, '--save_path', save_path, '--data_path', *data_paths,
            '--save_freq', str(SAVE_FREQ), '--seed', str(SEED), '--device',
            device.type, '--max_steps']

    kernels.reset_launches()
    torch.cuda.synchronize()
    start = time.perf_counter()
    res = cli(argv=argv + [str(TRAIN_STEPS)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = kernels.launch_counts()
    losses = res.history['loss']
    log(f'train: {TRAIN_STEPS} steps of B={TRAIN_BATCH} in {seconds:.3f} s '
        f'(host clock; the warp bank solve, data load and checkpoints '
        f'included); loss {losses[0]:.4f} -> {losses[-1]:.4f}')
    log(f'launches during train: {launches}')
    if res.epoch != list(range(1, TRAIN_STEPS + 1)) or \
            not np.isfinite(losses).all():
        raise AssertionError(f'train steps {res.epoch}, losses {losses}')
    for step in range(SAVE_FREQ, TRAIN_STEPS + 1, SAVE_FREQ):
        files = set(os.listdir(os.path.join(ckpt_dir, f'ckpt-{step}')))
        if files != ORBAX_FILES:
            raise AssertionError(f'ckpt-{step} holds {sorted(files)}')
    for name, sites in TRAIN_SITES.items():
        if launches[name] < sites * TRAIN_STEPS:
            raise AssertionError(
                f'{name} launched {launches[name]} times during train, '
                f'want >= {sites} x {TRAIN_STEPS}')

    last = TRAIN_STEPS + SAVE_FREQ
    res = cli(argv=argv + [str(last)])
    if res.epoch != list(range(TRAIN_STEPS + 1, last + 1)):
        raise AssertionError(f'the second train call ran steps {res.epoch}, '
                             f'want {TRAIN_STEPS + 1}..{last}')
    log(f'train resumed at step {TRAIN_STEPS}: steps {res.epoch[0]}-'
        f'{res.epoch[-1]}, loss {res.history["loss"][-1]:.4f}')

    # predict from the trained checkpoint
    config = config_lib.load_config(
        os.path.join(save_path, 'options.yaml'))['config']
    eng = engine.Engine(config, seed=SEED, device=device)
    ds = pipeline.train_ds(data_paths, **config['data_options']['train'])
    eng._setup_training(ds)
    eng.load(os.path.join(ckpt_dir, f'ckpt-{last}'))
    out_dir = os.path.join(WORK, 'train_maps')
    count = cli(argv=['predict', '--save_path', save_path, '--data_path',
                      *data_paths, '--output_path', out_dir, '--batch_size',
                      str(BATCH), '--output_format', 'npy', '--device',
                      device.type])
    log(f'predict from ckpt-{last}: {count} maps')
    _check_maps(eng.model, data_paths, out_dir,
                sum(TRAIN_EXAMS) * TRAIN_SLICES)

    # one step: the kernels against a plain train step, same batch and draws
    resident = eng._resident(ds)
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    raw = eng.sample_batch(resident, TRAIN_BATCH, gen)
    check_step_grads(eng, ds, raw, gen, 'train step')

    # the train step's time, kernels vs plain (a copy of the model and its
    # own Adam for the plain step)
    plain_model = copy.deepcopy(eng.model)
    plain_opt = torch.optim.Adam(plain_model.parameters(), lr=1e-3, eps=1e-7)

    def plain_step():
        with _plain_warp():
            images = eng._augment(raw.float() / 255.0, gen)
        x, y = augment.to_feature_label(images, ds.slice_types)
        plain_opt.zero_grad(set_to_none=True)
        eng.loss(y, plain_logits(plain_model, x)).backward()
        plain_opt.step()

    ms, plain_ms = _time_pair(lambda: eng.train_step(raw, last, gen),
                              plain_step)
    log(f'train step B={TRAIN_BATCH}: kernels {ms:.4f} ms  plain '
        f'{plain_ms:.4f} ms (CUDA events, median of {TIMED_RUNS})')
    _DEFERRED.append(lambda: _profile_steps(
        'unet.yaml train step', lambda: eng.train_step(raw, last, gen)))

    RATES['unet.yaml (phase 5)'] = _train_rate(eng, ds, 'train')
    return launches, save_path, data_paths


def _train_rate(eng, ds, label):
    '''Train throughput in slices/s from ``Engine.train`` calls that differ
    only in step count (25 and 100), each the minimum of three, after a
    warm-up call.'''
    short, long = 25, 100
    eng.train(ds, max_steps=eng.current_step + 10, save_freq=1 << 30)
    times = {}
    for n in (short, long):
        for _ in range(3):
            torch.cuda.synchronize()
            start = time.perf_counter()
            eng.train(ds, max_steps=eng.current_step + n, save_freq=1 << 30)
            torch.cuda.synchronize()
            times.setdefault(n, []).append(time.perf_counter() - start)
    rate = (long - short) * TRAIN_BATCH / (min(times[long]) -
                                           min(times[short]))
    log(f'{label} throughput: {rate:.2f} slices/s ({short}-step calls '
        f'{times[short]} s, {long}-step calls {times[long]} s; '
        f'steps_per_call {eng.steps_per_call})')
    return rate


# -- phase 3c ----------------------------------------------------------------
def _first_batch(eng, data_paths):
    '''(y, probs) of the first predict batch through the kernels, the
    raw uint8 batch and its slice types.'''
    from dnncancerannotator_torch.data import pipeline

    ds = pipeline.eval_ds(data_paths, batch_size=BATCH,
                          output_size=(SIZE, SIZE))
    raw = next(ds.batches())['slices']
    _, probs, y = eng._make_eval_step(ds.slice_types)(raw)
    return y, probs, raw, ds.slice_types


# kernels a call on each CCA route (ops/kernels/cca.py: route)
CCA_LAUNCHES = {'shared': 1, 'global': 3}
# the evaluate path's region-metric chunk: PIXEL_BUDGET // (100 * 128 * 128)
# images (metrics/region.py), and the Visualizer's at a ratio of 1
EVAL_CHUNK, EVAL_CHUNK_256 = 20, 5


@torch.no_grad()
def cca_sites(eng, data_paths, results):
    '''The CCA kernel against its plain version: exactly equal labels, on
    both routes, with each set's launches a call from the kernel library's
    count.'''
    from dnncancerannotator_torch.metrics import region
    from dnncancerannotator_torch.ops.kernels import cca as K
    from dnncancerannotator_torch.ops.morphology import morph_open
    from dnncancerannotator_torch.utils.viz import PR_THRESHOLDS

    device = eng.device
    y, probs, _, _ = _first_batch(eng, data_paths)
    thresholds = torch.tensor(PR_THRESHOLDS, dtype=torch.float32,
                              device=device)

    def opened_masks(n, ratio):
        '''The region metrics' calls for a chunk of n slices: the
        thresholded, opened predictions [n * 100, h, w] and the labels.'''
        lab, p = region._resized(y[:n], probs[:n], ratio)
        masks = morph_open(p, 5)[:, None] >= thresholds[None, :, None, None]
        return masks.reshape(-1, *masks.shape[2:]), lab > 0.5

    preds, labels = opened_masks(EVAL_CHUNK, 0.5)
    preds_256, _ = opened_masks(EVAL_CHUNK_256, 1.0)
    rng = np.random.default_rng(SEED)
    ii, jj = np.mgrid[:SIZE, :SIZE]
    n_thr = len(PR_THRESHOLDS)
    planes = {
        'thresholded opened predictions': preds[:n_thr],
        f'evaluate chunk: predictions of {EVAL_CHUNK} slices': preds,
        f'evaluate chunk: labels of {EVAL_CHUNK} slices': labels,
        f'ratio 1: predictions of {EVAL_CHUNK_256} slices': preds_256,
        'spiral': spiral_mask(SIZE, SIZE)[None],
        'checkerboard': ((ii + jj) % 2 == 0)[None],
        'all ones': np.ones((1, SIZE, SIZE), bool),
        'all zeros': np.zeros((1, SIZE, SIZE), bool),
        'noise p=0.6': rng.random((4, SIZE, SIZE)) < 0.6,
        'noise, H != W, W % 32 != 0': rng.random((3, 192, 300)) < 0.55,
        'noise over the shared cap': rng.random((2, 384, 384)) < 0.55,
    }
    log('connected components (CCA kernel vs plain, exact):')
    routes = set()
    for name, masks in planes.items():
        x = torch.as_tensor(masks, device=device).contiguous()
        route = K.route(*x.shape)
        routes.add(route)
        got, want = K.cca_raw_labels(x), K.plain(x)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        n_regions = int((want.reshape(len(x), -1) == torch.arange(
            x[0].numel(), device=device)).sum())
        log(f'  cca {name:46s} {str(list(x.shape)):16s} route {route:6s} '
            f'regions {n_regions:6d}  max|diff| {err}')
        if not torch.equal(got, want):
            raise AssertionError(f'cca ({name}) differs from its plain '
                                 f'version by {err}')
        times = _time_site(lambda: K.cca_raw_labels(x), lambda: K.plain(x))
        _DEFERRED.append(functools.partial(
            _launch_split, f'cca {name} ({route})',
            functools.partial(K.cca_raw_labels, x), CCA_LAUNCHES[route]))
        # a few integer operations a pixel (runs, unions, flattening)
        record(results, 'cca', float(err), times,
               bound(nbytes(x, got), 4 * x.numel()))
    if routes != set(CCA_LAUNCHES):
        raise AssertionError(f'phase 3c took the routes {routes}')


# -- phase 3d ----------------------------------------------------------------
def sensitivity_site(eng, data_paths):
    '''d(sum of probs)/d(input) at B=64 through the kernels (dx at down_0)
    against plain autograd of the plain forward.

    The chain backward at down_0 is held to DX_TOL * max|ref| on the
    model's own activations with the same saved relu masks. End to end a
    relu or max-pool decision can fall the other way where the kernels'
    forward and the plain one round a value near 0 or a near-tie
    differently (1 in 10^9 a value, but 10^7 values a batch); the gradient
    then differs at full size in the few pixels behind that decision (on an
    H100: 4,827 of 21 M values, all in one slice, 2.2e-3 of max|ref| 0.13;
    summed over the batch 9.2e-7 relative). So end to end: at most
    SENS_FLIP_SHARE of the values beyond DX_TOL * max|ref|, the summed
    absolute difference within DX_TOL of the summed |ref|, and the
    normalized per-channel sensitivity within DX_TOL * its max.'''
    from dnncancerannotator_torch.data import augment
    from dnncancerannotator_torch.ops.kernels import conv_chain as CC
    from dnncancerannotator_torch.ops.kernels import conv_chain_bwd as CCB
    from dnncancerannotator_torch.utils import viz

    with torch.no_grad():
        _, _, raw, slice_types = _first_batch(eng, data_paths)
        images = torch.from_numpy(raw).to(eng.device).float() / 255.0
        x, _ = augment.to_feature_label(images, slice_types)
        chain = eng.model.unet.encoder.down_0.convchain
        w1, w2 = chain.conv_0.weight.detach(), chain.conv_1.weight.detach()
        xc = x.permute(0, 3, 1, 2).contiguous()
        c1, c2 = CC.plain(xc, w1, chain.conv_0.bias, w2, chain.conv_1.bias)
        g = torch.randn(c2.shape, device=eng.device,
                        generator=torch.Generator(device=eng.device)
                        .manual_seed(SEED + 5))
        _check_grads(f'conv_chain_bwd down_0 with dx (B={BATCH})',
                     CCB.conv_chain_bwd(xc, c1, c2, g, w1, w2),
                     CCB.plain(xc, c1, c2, g, w1, w2),
                     CCB.plain(*_f64(xc, c1, c2, g, w1, w2)))

    def input_grad(forward):
        v = x.detach().requires_grad_()
        (dx,) = torch.autograd.grad(forward(v).sum(), v)
        return dx

    got = input_grad(eng.model)
    want = input_grad(lambda v: plain_forward(eng.model, v))
    diff = (got - want).abs()
    scale = float(want.abs().max())
    beyond = float((diff > DX_TOL * scale).float().mean())
    summed = float(diff.sum() / want.abs().sum())
    log(f'input gradient B={BATCH} {SIZE}x{SIZE}x5 vs plain autograd: '
        f'max|diff| {float(diff.max()):.3e} (max|ref| {scale:.3e}) in slices '
        f'{sorted(set(torch.nonzero(diff > DX_TOL * scale)[:, 0].tolist()))}'
        f'; share beyond {DX_TOL} * max|ref| {beyond:.3e}; summed |diff| / '
        f'summed |ref| {summed:.3e}')
    if not (beyond <= SENS_FLIP_SHARE and summed <= DX_TOL):
        raise AssertionError('input gradient through the kernels disagrees '
                             'with plain autograd')
    _, sens = viz.input_sensitivity(eng.model, x)
    ref = want.abs().sum(dim=(1, 2))
    ref = ref / ref.sum(dim=1, keepdim=True)
    sens_err = float((sens - ref).abs().max())
    log(f'  normalized sensitivity [{BATCH}, 5]: max|diff| {sens_err:.3e}')
    if not sens_err <= DX_TOL * float(ref.abs().max()):
        raise AssertionError(f'sensitivity differs by {sens_err}')
    ms, plain_ms = _time_pair(
        lambda: input_grad(eng.model),
        lambda: input_grad(lambda v: plain_forward(eng.model, v)))
    log(f'    forward + input gradient: kernels {ms:.4f} ms  plain '
        f'{plain_ms:.4f} ms')


# -- phase 6 -----------------------------------------------------------------
@contextlib.contextmanager
def _plain_cca():
    '''Within the block, connected components run the plain version on
    the card instead of the kernel.'''
    from dnncancerannotator_torch.ops.kernels import cca as K
    kernel = K.cca_raw_labels
    K.cca_raw_labels = K.plain
    try:
        yield
    finally:
        K.cca_raw_labels = kernel


def _read_csv(path):
    import csv
    with open(path, newline='') as fh:
        return list(csv.reader(fh))


def _pr_curves(path):
    '''(number of records, {(step, tag): [6, T] array}) of an event file,
    read with the port's record reader.'''
    from dnncancerannotator_torch.data import tfrecord as tfr
    count, curves = 0, {}
    for record_bytes in tfr.read_records(path, verify_crc=True):
        count += 1
        event = {f: v for f, _, v in tfr.iter_fields(record_bytes)}
        if 5 not in event:
            continue
        for _, _, value in tfr.iter_fields(event[5]):
            fields = {f: v for f, _, v in tfr.iter_fields(value)}
            if 8 in fields:
                curves[(event[2], bytes(fields[1]).decode())] = \
                    tfr.parse_tensor(fields[8])
    return count, curves


def _check_region_counts(device, run, data_paths, header, rows, casewise,
                         curves):
    '''Recompute every region count of the evaluate run with the plain
    CCA on the card, from the same probabilities, and require equality.'''
    from dnncancerannotator_torch import engine, metrics
    from dnncancerannotator_torch.data import pipeline
    from dnncancerannotator_torch.utils import config as config_lib
    from dnncancerannotator_torch.utils import viz

    config = config_lib.load_config(os.path.join(run, 'options.yaml'))[
        'config']
    config = config_lib.apply_config(config, config_lib.load_config(
        os.path.join(REPO, METRICS_CONFIG)))
    eng = engine.Engine(config, device=device)
    ds = pipeline.eval_ds(data_paths, **config['data_options']['eval'])
    eng.build(ds.feature_shape)
    visualizer = viz.Visualizer('plain', ds, 1, save_dir=WORK)
    step_fn = eng._make_eval_step(ds.slice_types)
    region_cols = [i for i, name in enumerate(header)
                   if name.startswith('region/')]
    n_slices = sum(N_EXAMS) * SLICES_PER_EXAM
    for i, row in enumerate(rows):
        step = int(row[0])
        eng.load(os.path.join(run, 'checkpoints', f'ckpt-{step}'))
        suite = eng._build_metrics()
        cm = metrics.RegionBasedConfusionMatrix(
            viz.PR_THRESHOLDS, viz.PR_IOU_THRESHOLD, resize_factor=0.5)
        per_slice = []
        with _plain_cca():
            for batch in ds.batches():
                _, probs, y = step_fn(batch['slices'])
                for metric in suite:
                    metric.update_state(y, probs)
                _, y, probs, _ = visualizer._viz_batch(eng, batch['slices'])
                per_slice.append(np.concatenate(
                    cm.update_state_raw(y, probs), axis=1))
        values = {m.name: float(m.result()) for m in suite}
        for c in region_cols:
            if float(row[c]) != values[header[c]]:
                raise AssertionError(
                    f'ckpt-{step} {header[c]}: evaluate wrote {row[c]}, the '
                    f'plain CCA gives {values[header[c]]}')
        want = np.concatenate(per_slice)
        got = np.asarray([r[1:-1] for r in casewise[
            1 + i * n_slices:1 + (i + 1) * n_slices]], np.int64)
        if not np.array_equal(got, want):
            raise AssertionError(f'ckpt-{step}: casewise region counts differ '
                                 'from the plain CCA in '
                                 f'{int((got != want).sum())} entries')
        curve = curves[(step, 'region/PR_curve/pr_curves')]
        result = cm.result_dict()
        for r, key in ((0, 'true_positive_counts'),
                       (1, 'false_positive_counts'),
                       (3, 'false_negative_counts')):
            if not np.array_equal(curve[r], result[key].astype(np.float32)):
                raise AssertionError(f'ckpt-{step}: region PR curve {key} '
                                     'differs from the plain CCA')
        log(f'  ckpt-{step}: region counts equal the plain CCA\'s: '
            f'{", ".join(header[c] + "=" + row[c] for c in region_cols[2:5])}'
            f'; PR curve TP at 0.5 {int(result["true_positive_counts"][50])}')


def eval_slice(device, val_paths, train_paths, run):
    '''Phase 6: train --validate with metrics, then evaluate over the
    checkpoints of ``run``; returns the launch counts of the evaluate
    call.'''
    from dnncancerannotator_torch.ops import kernels
    from dnncancerannotator_torch.runs.__main__ import main as cli

    metrics_config = os.path.join(REPO, METRICS_CONFIG)
    overlay = os.path.join(WORK, 'validate.json')
    with open(overlay, 'w') as fh:
        json.dump({'deploy_options.steps_per_call': 2}, fh)
    start = time.perf_counter()
    res = cli(argv=['train', '--config', *[os.path.join(REPO, c)
                                           for c in CONFIGS],
                    metrics_config, overlay, '--save_path',
                    os.path.join(WORK, 'val_run'), '--data_path', *train_paths,
                    '--save_freq', '2', '--max_steps', '4', '--validate',
                    '--val_data_path', *val_paths, '--early_stop_steps', '4',
                    '--visualize', '--seed', str(SEED), '--device',
                    device.type])
    seconds = time.perf_counter() - start
    val_keys = sorted(k for k in res.history if k.startswith('val_'))
    log(f'train --validate --visualize: steps {res.epoch} in {seconds:.3f} s; '
        f'val_loss {res.history.get("val_loss")}; {len(val_keys)} val '
        f'scalars, {len(res.history) - len(val_keys) - 2} train metrics')
    if res.epoch != [1, 2, 3, 4] or len(res.history.get('val_loss', [])) != 2 \
            or len(val_keys) != 14 or len(res.history) != 2 + 13 + 14 or \
            not np.isfinite(res.history['val_loss']).all():
        raise AssertionError(f'train --validate history: {res.history}')

    kernels.reset_launches()
    torch.cuda.synchronize()
    start = time.perf_counter()
    result_rows = cli(argv=[
        'evaluate', '--save_path', run, '--data_path', *val_paths, '--tag',
        EVAL_TAG, '--config', metrics_config, '--export_csv',
        '--export_images', '--export_casewise_metrics', '--device',
        device.type])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = kernels.launch_counts()
    n_ckpt = len(result_rows)
    n_slices = sum(N_EXAMS) * SLICES_PER_EXAM
    EVAL_SECONDS['phase 6'] = seconds / n_ckpt
    log(f'evaluate: {n_ckpt} checkpoints x {n_slices} slices in '
        f'{seconds:.3f} s -> {seconds / n_ckpt:.3f} s per checkpoint, '
        f'{n_ckpt * n_slices / seconds:.2f} slices/s (host clock, the '
        'metrics pass and the Visualizer pass with every export)')
    log(f'launches during evaluate: {launches}')

    out = os.path.join(run, 'tfevents', EVAL_TAG)
    table = _read_csv(os.path.join(out, 'results.csv'))
    header, rows = table[0], table[1:]
    n_saved = len(os.listdir(os.path.join(run, 'checkpoints')))
    if n_ckpt != n_saved or len(rows) != n_ckpt or \
            header[:2] != ['step', 'loss'] or len(header) != 2 + 13:
        raise AssertionError(f'results.csv: {header}, {len(rows)} rows for '
                             f'{n_ckpt} checkpoints')
    casewise = _read_csv(os.path.join(out, 'casewise_results.csv'))
    pngs = sum(f.endswith('.png') for _, _, files in
               os.walk(os.path.join(out, 'images')) for f in files)
    (events,) = [os.path.join(out, f) for f in os.listdir(out)
                 if f.startswith('events')]
    n_records, curves = _pr_curves(events)
    log(f'  results.csv {len(rows)} rows x {len(header)} columns, '
        f'casewise_results.csv {len(casewise) - 1} rows, {pngs} PNGs, '
        f'{n_records} event records')
    if len(casewise) - 1 != n_slices * n_ckpt or pngs != n_slices * n_ckpt \
            or n_records != 1 + n_ckpt * (n_slices + 2):
        raise AssertionError('evaluate exports are incomplete')
    n_batches = -(-n_slices // BATCH)
    if launches['cca'] < n_batches * n_ckpt:
        raise AssertionError(f'cca launched {launches["cca"]} times during '
                             f'evaluate, want >= {n_batches} x {n_ckpt}')
    _check_region_counts(device, run, val_paths, header, rows, casewise,
                         curves)
    return launches


# -- phase 3e ----------------------------------------------------------------
def _config(configs):
    from dnncancerannotator_torch.utils import config as config_lib
    return config_lib.load_config([os.path.join(REPO, c) for c in configs])


def _big_config(gates_on=True):
    '''The unet_big stack, with or without pallas_decoder.yaml.'''
    return _config(BIG_CONFIGS if gates_on else BIG_CONFIGS[:-1])


def _nhwc_modules():
    from dnncancerannotator_torch.ops.kernels import (
        pool2x2_nhwc, pool2x2_nhwc_bwd, tconv2x2_nhwc, tconv2x2_nhwc_bwd)
    return pool2x2_nhwc, pool2x2_nhwc_bwd, tconv2x2_nhwc, tconv2x2_nhwc_bwd


@torch.no_grad()
def big_kernel_sites(device, results):
    '''The four NHWC kernels against their plain versions at their
    unet_big sites, on the activations of a seeded unet_big forward.'''
    from dnncancerannotator_torch import engine
    PN, PNB, TN, TNB = _nhwc_modules()
    F = torch.nn.functional
    conv_bwd = torch.ops.aten.convolution_backward

    eng = engine.Engine(_big_config(), seed=SEED, device=device)
    eng.build((TRAIN_BATCH, SIZE, SIZE, 5))
    modules = dict(eng.model.named_modules())
    seen = {}
    hooks = [modules[path + '.convchain'].register_forward_hook(
        lambda mod, args, out, path=path: seen.__setitem__(path, out))
        for path in POOL_SITES]
    hooks += [modules[path + '.tconv'].register_forward_hook(
        lambda mod, args, out, path=path: seen.__setitem__(path, args[0]))
        for path in BIG_TCONV_SITES]
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    with eng.scope(training=True):
        eng.model(torch.rand((TRAIN_BATCH, SIZE, SIZE, 5), generator=gen,
                             device=device))
    for hook in hooks:
        hook.remove()

    log(f'unet_big NHWC kernels (B={TRAIN_BATCH}, {SIZE}x{SIZE} input, '
        'activations of a train-mode forward):')
    for path in POOL_SITES:
        x = seen[path].contiguous()
        b, h, w, c = x.shape
        got, want = PN.pool2x2_nhwc(x), PN.plain(x)
        g = torch.randn(want.shape, generator=gen, device=device)
        dx, dx_want = PNB.pool2x2_nhwc_bwd(x, g), PNB.plain(x, g)
        torch.cuda.synchronize()
        tied = float(((x.view(b, h // 2, 2, w // 2, 2, c)
                       == want[:, :, None, :, None]).sum((2, 4)) > 1)
                     .float().mean())
        errs = []
        for name, k, ref in (('pool2x2_nhwc', got, want),
                             ('pool2x2_nhwc_bwd', dx, dx_want)):
            errs.append(float((k - ref).abs().max()))
            log(f'  {name} {path} {list(x.shape)} max|diff| {errs[-1]:.3e} '
                f'(windows with a tie {tied:.3%})')
            if not torch.equal(k, ref):   # maxima, g * {1, 0.5, 0.25}: exact
                raise AssertionError(f'{name} at {path} differs from its '
                                     f'plain version by {errs[-1]}')
        times = _time_site(lambda: PN.pool2x2_nhwc(x), lambda: PN.plain(x),
                           lambda: F.max_pool2d(x.permute(0, 3, 1, 2), 2))
        record(results, 'pool2x2_nhwc', errs[0], times,
               bound(nbytes(x, got), 3 * got.numel()))
        # no library call: max_pool2d's backward sends a tie to one input
        times = _time_site(lambda: PNB.pool2x2_nhwc_bwd(x, g),
                           lambda: PNB.plain(x, g))
        record(results, 'pool2x2_nhwc_bwd', errs[1], times,
               bound(nbytes(x, g, dx), 12 * g.numel()))
    for path in BIG_TCONV_SITES:
        tconv = modules[path + '.tconv']
        x, w, bias = seen[path].contiguous(), tconv.weight, tconv.bias
        site = f'{path} {w.shape[0]}->{w.shape[1]} @{x.shape[1]}'
        got, want = TN.tconv2x2_nhwc(x, w, bias), TN.plain(x, w, bias)
        name = f'tconv2x2_nhwc {site}'
        err = _check_close(name, got, want, DX_TOL)
        _f64_errors(name, got, want, TN.plain(*_f64(x, w, bias)), F64_RATIO)
        # the forward as predict calls it (the weight packed in the call)
        times = _time_site(
            lambda: TN.tconv2x2_nhwc(x, w, bias),
            lambda: TN.plain(x, w, bias),
            lambda: F.conv_transpose2d(x.permute(0, 3, 1, 2), w, bias,
                                       stride=2))
        work = (nbytes(x, w, bias, got), 2 * got.numel() * w.shape[0])
        record(results, 'tconv2x2_nhwc', err, times, bound(*work),
               tf32x3_bound(*work))
        g = torch.randn(got.shape, generator=gen, device=device)
        # the backward as training calls it: the weight packed by the
        # forward; two calls give the same bits
        wpt = TN.pack(w)
        grads = TNB.tconv2x2_nhwc_bwd(x, g, w, wpt=wpt)
        again = TNB.tconv2x2_nhwc_bwd(x, g, w, wpt=wpt)
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError(f'tconv2x2_nhwc_bwd {site}: two calls differ')
        err = _check_grads(f'tconv2x2_nhwc_bwd {site}', grads,
                           TNB.plain(x, g, w), TNB.plain(*_f64(x, g, w)),
                           F64_RATIO)
        times = _time_site(
            lambda: TNB.tconv2x2_nhwc_bwd(x, g, w, wpt=wpt),
            lambda: TNB.plain(x, g, w),
            lambda: conv_bwd(g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w,
                             [w.shape[1]], [2, 2], [0, 0], [1, 1], True,
                             [0, 0], 1, [True, True, True]))
        work = (nbytes(x, g, w, *grads), 4 * g.numel() * w.shape[0])
        record(results, 'tconv2x2_nhwc_bwd', err, times, bound(*work),
               tf32x3_bound(*work))


# -- phase 3g ----------------------------------------------------------------
def nhwc_direct_site(device, gen, dtype):
    '''The NHWC stencil conv's kept direct route at NHWC_DIRECT_SITE (3x3
    SAME 1 -> 32 with relu): against its plain version (f32: KERNEL_TOL;
    bf16: bit-equal to the f32 form on the upcast inputs), one launch a
    call, its times logged.'''
    from dnncancerannotator_torch.ops.kernels import stencil_conv_nhwc as SN
    site = NHWC_DIRECT_SITE
    bsz, h, wd, ci = site['shape']
    co, k, pads = site['co'], site['k'], ((1, 1), (1, 1))
    x = torch.rand(site['shape'], generator=gen, device=device).to(dtype)
    w = torch.randn((co, ci, k, k), generator=gen, device=device).to(dtype)
    b = torch.randn((co,), generator=gen, device=device).to(dtype)
    route = SN.route(bsz, h, wd, ci, co, k, k, pads, x.element_size())
    name = (f'stencil_conv_nhwc{"_bf16" if dtype != torch.float32 else ""} '
            f'{list(x.shape)} {k}x{k} {ci}->{co} relu ({route})')
    if route != 'direct':
        raise AssertionError(f'{name}: the kept site takes the {route} route')
    got = SN.stencil_conv_nhwc(x, w, b, pads, True)
    if dtype == torch.float32:
        _check_close(name, got, SN.plain(x, w, b, pads, True))
    else:
        _bits_equal(name, got, SN.stencil_conv_nhwc(
            *_upcast(x, w, b), pads, True).to(dtype))
        _bf16_err(name, got, SN.plain(x, w, b, pads, True))
    _check_launches(name, lambda: SN.stencil_conv_nhwc(x, w, b, pads, True),
                    STENCIL_NHWC_LAUNCHES)
    times = _time_site(lambda: SN.stencil_conv_nhwc(x, w, b, pads, True),
                       lambda: SN.plain(x, w, b, pads, True))
    times['label'] = name


@torch.no_grad()
def mulmo_kernel_sites(device, results, site_results):
    '''The NHWC stencil conv at MulmoUNet's six sites, and the NHWC pool
    and tconv kernels at its five down_3 sites and at up_0 (Ci 640), on the
    activations of a seeded MulmoUNet forward (B=8, train mode): each
    against its plain version as phase 3e holds them, the stencil conv to
    KERNEL_TOL at STENCIL_NHWC_LAUNCHES a call (the library's count), each
    site's route printed (every site takes the tile); the stencil conv also
    at B=64 at the first encoder and the head, as evaluate and predict call
    it, and its kept direct route at NHWC_DIRECT_SITE. The stencil conv's
    B=8 sites go into ``results``, the pool's and tconv's into
    ``site_results`` (their kernels line entries stay unet_big's).'''
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.ops.kernels import stencil_conv_nhwc as SN
    PN, PNB, TN, TNB = _nhwc_modules()
    F = torch.nn.functional
    conv_bwd = torch.ops.aten.convolution_backward

    eng = engine.Engine(_config(MULMO_CONFIGS), seed=SEED, device=device)
    eng.build((TRAIN_BATCH, SIZE, SIZE, 5))
    modules = dict(eng.model.named_modules())
    seen = {}
    hooks = [modules[path].register_forward_hook(
        lambda mod, args, out, path=path: seen.__setitem__(path, args[0]))
        for path in MULMO_STENCIL_SITES]
    hooks += [modules[path + '.convchain'].register_forward_hook(
        lambda mod, args, out, path=path: seen.__setitem__(path, out))
        for path in MULMO_POOL_SITES]
    hooks.append(modules[MULMO_TCONV_SITE + '.tconv'].register_forward_hook(
        lambda mod, args, out: seen.__setitem__(MULMO_TCONV_SITE, args[0])))
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    batch = torch.rand((BATCH, SIZE, SIZE, 5), generator=gen, device=device)
    with eng.scope(training=True):
        eng.model(batch[:TRAIN_BATCH])
    for hook in hooks:
        hook.remove()

    log(f'MulmoUNet kernels (B={TRAIN_BATCH}, {SIZE}x{SIZE} input, '
        'activations of a train-mode forward):')
    for path in MULMO_STENCIL_SITES:
        conv = modules[path]
        w, b, relu = conv.weight, conv.bias, conv.relu
        co, ci, kh, kw = w.shape
        pads = ((kh // 2, kh // 2), (kw // 2, kw // 2))
        inputs = {TRAIN_BATCH: seen[path]}
        if path in (MULMO_STENCIL_SITES[0], 'last_conv'):
            # the site at B=64 (evaluate, predict): the first encoder reads
            # its channel of the batch in place
            inputs[BATCH] = batch[..., :1] if path != 'last_conv' else \
                torch.rand((BATCH,) + tuple(seen[path].shape[1:]),
                           generator=gen, device=device)
        for bsz, x in inputs.items():
            route = SN.route(bsz, *x.shape[1:3], ci, co, kh, kw, pads,
                             x.element_size())
            name = (f'stencil_conv_nhwc B={bsz} {path} {kh}x{kw} {ci}->{co}'
                    f'{" relu" if relu else ""} @{x.shape[1]} ({route})')
            got = SN.stencil_conv_nhwc(x, w, b, pads, relu)
            err = _check_close(name, got, SN.plain(x, w, b, pads, relu))
            log(f'    x strides {tuple(x.stride())}')
            per_call = library_launches(
                lambda: SN.stencil_conv_nhwc(x, w, b, pads, relu))
            if per_call != STENCIL_NHWC_LAUNCHES:
                raise AssertionError(f'{name}: {per_call} launches a call, '
                                     f'want {STENCIL_NHWC_LAUNCHES}')
            # no library call fuses the relu: F.conv2d alone
            times = _time_site(
                lambda: SN.stencil_conv_nhwc(x, w, b, pads, relu),
                lambda: SN.plain(x, w, b, pads, relu),
                lambda: F.conv2d(x.permute(0, 3, 1, 2), w, b,
                                 padding=(kh // 2, kw // 2)))
            # x read once: the channels the conv takes, not the batch's
            work = (4 * x[..., :ci].numel() + nbytes(w, b, got),
                    2 * got.numel() * ci * kh * kw)
            if bsz == TRAIN_BATCH:
                record(results, 'stencil_conv_nhwc', err, times, bound(*work))
            else:
                times['label'] = name
                site_bound = bound(*work)
                log(f'  {name:44s} bound {site_bound[0]:.4f} ms '
                    f'({site_bound[1]})')
    nhwc_direct_site(device, gen, torch.float32)

    for path in MULMO_POOL_SITES:
        x = seen[path].contiguous()
        got, want = PN.pool2x2_nhwc(x), PN.plain(x)
        g = torch.randn(want.shape, generator=gen, device=device)
        dx, dx_want = PNB.pool2x2_nhwc_bwd(x, g), PNB.plain(x, g)
        torch.cuda.synchronize()
        errs = []
        for name, k, ref in (('pool2x2_nhwc', got, want),
                             ('pool2x2_nhwc_bwd', dx, dx_want)):
            errs.append(float((k - ref).abs().max()))
            log(f'  {name} {path} {list(x.shape)} max|diff| {errs[-1]:.3e}')
            if not torch.equal(k, ref):
                raise AssertionError(f'{name} at {path} differs from its '
                                     f'plain version by {errs[-1]}')
        times = _time_site(lambda: PN.pool2x2_nhwc(x), lambda: PN.plain(x),
                           lambda: F.max_pool2d(x.permute(0, 3, 1, 2), 2))
        record(site_results, 'pool2x2_nhwc', errs[0], times,
               bound(nbytes(x, got), 3 * got.numel()))
        times = _time_site(lambda: PNB.pool2x2_nhwc_bwd(x, g),
                           lambda: PNB.plain(x, g))
        record(site_results, 'pool2x2_nhwc_bwd', errs[1], times,
               bound(nbytes(x, g, dx), 12 * g.numel()))

    tconv = modules[MULMO_TCONV_SITE + '.tconv']
    x, w, bias = seen[MULMO_TCONV_SITE].contiguous(), tconv.weight, tconv.bias
    site = f'{MULMO_TCONV_SITE} {w.shape[0]}->{w.shape[1]} @{x.shape[1]}'
    got, want = TN.tconv2x2_nhwc(x, w, bias), TN.plain(x, w, bias)
    name = f'tconv2x2_nhwc {site}'
    err = _check_close(name, got, want, DX_TOL)
    _f64_errors(name, got, want, TN.plain(*_f64(x, w, bias)), F64_RATIO)
    times = _time_site(
        lambda: TN.tconv2x2_nhwc(x, w, bias), lambda: TN.plain(x, w, bias),
        lambda: F.conv_transpose2d(x.permute(0, 3, 1, 2), w, bias, stride=2))
    work = (nbytes(x, w, bias, got), 2 * got.numel() * w.shape[0])
    record(site_results, 'tconv2x2_nhwc', err, times, bound(*work),
           tf32x3_bound(*work))
    g = torch.randn(got.shape, generator=gen, device=device)
    wpt = TN.pack(w)
    grads = TNB.tconv2x2_nhwc_bwd(x, g, w, wpt=wpt)
    again = TNB.tconv2x2_nhwc_bwd(x, g, w, wpt=wpt)
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError(f'tconv2x2_nhwc_bwd {site}: two calls differ')
    err = _check_grads(f'tconv2x2_nhwc_bwd {site}', grads,
                       TNB.plain(x, g, w), TNB.plain(*_f64(x, g, w)),
                       F64_RATIO)
    times = _time_site(
        lambda: TNB.tconv2x2_nhwc_bwd(x, g, w, wpt=wpt),
        lambda: TNB.plain(x, g, w),
        lambda: conv_bwd(g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w,
                         [w.shape[1]], [2, 2], [0, 0], [1, 1], True, [0, 0],
                         1, [True, True, True]))
    work = (nbytes(x, g, w, *grads), 4 * g.numel() * w.shape[0])
    record(site_results, 'tconv2x2_nhwc_bwd', err, times, bound(*work),
           tf32x3_bound(*work))


# -- phase 3h ----------------------------------------------------------------
# bf16 compute: bf16.yaml (or a policy's overlay) goes last, after
# deploy_options.yaml, which replaces the whole deploy_options dict
BF16 = 'configs/additionals/bf16.yaml'
BF16_POLICIES = ('configs/additionals/bf16_f32head.yaml',
                 'configs/additionals/bf16_f32level0.yaml')
# unet.yaml + bf16.yaml's kernel sites: the chains the stencil chain's rule
# keeps whole in bf16 (K * K * Ci * Cm and K * K * Cm * Co <= 1024) and the
# two stencil convs (down_2's first, 6 -> 12, and the head); MulmoUNet's are
# its f32 sites (MULMO_STENCIL_SITES)
BF16_CHAIN_SITES = ('unet.encoder.down_0', 'unet.encoder.down_1',
                    'unet.decoder.up_1', 'unet.decoder.up_2')
BF16_STENCIL_SITES = ('unet.encoder.down_2.convchain.conv_0', 'last_conv')
# the stencil backward's launches a call by the forward's route: the
# pointwise kernel, or the stencil route's one-launch tile; 'split' is the
# stencil route's kept form (ops/kernels/stencil_conv_bwd.py: route), dgrad,
# wgrad and its fixed-order sum, for shapes whose tile does not fit
STENCIL_BWD_ROUTE_LAUNCHES = {'pointwise': 1, 'tile': 1, 'stencil': 1,
                              'split': 3}
# unet.yaml + leakyReLU.yaml: no chain fuses (a chain fuses relu only), so
# every conv runs alone; these nine (kh * kw * Ci * Co <= 1024) take the
# NCHW stencil conv's tile route, 3x3 SAME with no relu (the leaky relu is
# a separate op), the three others the library's conv and the head the
# pointwise route
LEAKY = 'configs/additionals/leakyReLU.yaml'
LEAKY_CONFIGS = CONFIGS + (LEAKY,)
LEAKY_STENCIL_SITES = tuple(f'unet.{part}.convchain.conv_{i}' for part in (
    'encoder.down_0', 'encoder.down_1', 'encoder.down_2') for i in (0, 1)
    if part != 'encoder.down_2' or i == 0) + tuple(
    f'unet.decoder.{up}.convchain.conv_{i}' for up in ('up_1', 'up_2')
    for i in (0, 1))
# the kept direct route's site: 32 channels of 8192-wide rows, whose one
# staged row passes a block's shared memory
STENCIL_DIRECT_SITE = dict(shape=(1, 32, 8, 8192), co=32, k=3)
# phase 13: the leaky stack's train CLI, in one chunk
LEAKY_STEPS = 10
# the split form's site: 7 x 7, 32 -> 32, whose f64 partial (50208 items)
# passes a block's shared memory
STENCIL_SPLIT_SITE = dict(shape=(2, 32, 20, 24), co=32, k=7)


def _bits_equal(name, got, want):
    '''Raise unless got and want hold the same bits in the same dtype.'''
    torch.cuda.synchronize()
    view = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    if got.dtype != want.dtype or not torch.equal(
            got.contiguous().view(view), want.contiguous().view(view)):
        raise AssertionError(f'{name}: the bf16 form is not bit-equal to its '
                             'f32 form on the upcast inputs, rounded')


def _bf16_err(name, got, want):
    '''A bf16 form's max|diff| from its plain version (f32 sums of the same
    values in another order, rounded: an ulp where a rounding moves).'''
    err = float((got.float() - want.float()).abs().max())
    log(f'  {name:60s} bits = f32 form; max|diff| from plain {err:.3e}  '
        f'max|ref| {float(want.float().abs().max()):.3e}')
    return err


def _upcast(*tensors):
    return [None if t is None else t.float() for t in tensors]


def _bf16(*tensors):
    return [None if t is None else t.to(torch.bfloat16) for t in tensors]


def _site_inputs(configs, paths, batch, device):
    '''(modules, {path: the input of the module at path}) of a seeded
    eval-mode forward of ``batch`` through the model of ``configs``.'''
    from dnncancerannotator_torch import engine
    eng = engine.Engine(_config(configs), seed=SEED, device=device)
    eng.build(tuple(batch.shape))
    modules = dict(eng.model.named_modules())
    seen = {}
    hooks = [modules[path].register_forward_hook(
        lambda mod, args, out, path=path: seen.__setitem__(path, args[0]))
        for path in paths]
    with eng.scope():
        eng.model(batch)
    for hook in hooks:
        hook.remove()
    return modules, seen


def stencil_split_site(device, gen, dtype):
    '''The stencil backward's kept split form at STENCIL_SPLIT_SITE (7 x 7
    SAME, 32 -> 32): f32 against its plain version (DX_TOL, DW_TOL), bf16
    bit-equal to the f32 form on the upcast inputs; three launches a call;
    its times logged.'''
    from dnncancerannotator_torch.ops.kernels import stencil_conv_bwd as SCB
    site = STENCIL_SPLIT_SITE
    bsz, ci, h, wd = site['shape']
    co, k = site['co'], site['k']
    pads = ((k // 2, k // 2), (k // 2, k // 2))
    x = torch.rand(site['shape'], generator=gen, device=device).to(dtype)
    w = (torch.randn((co, ci, k, k), generator=gen, device=device)
         * 0.05).to(dtype)
    g = torch.randn((bsz, co, h, wd), generator=gen, device=device).to(dtype)
    route = SCB.route(bsz, ci, co, h, wd, k, k, pads)
    name = (f'stencil_conv_bwd{"_bf16" if dtype != torch.float32 else ""} '
            f'{list(x.shape)} {k}x{k} {ci}->{co} ({route})')
    if route != 'split':
        raise AssertionError(f'{name}: the kept site takes the {route} form')
    got = SCB.stencil_conv_bwd(x, g, w, pads)
    if dtype == torch.float32:
        _check_grads(name, got, SCB.plain(x, g, w, pads),
                     SCB.plain(*_f64(x, g, w), pads))
    else:
        for label, a, f in zip(('dx', 'dw', 'db'), got,
                               SCB.stencil_conv_bwd(*_upcast(x, g, w), pads)):
            _bits_equal(f'{name} {label}', a, f.to(dtype))
    _check_launches(name, lambda: SCB.stencil_conv_bwd(x, g, w, pads),
                    STENCIL_BWD_ROUTE_LAUNCHES['split'])
    times = _time_site(lambda: SCB.stencil_conv_bwd(x, g, w, pads),
                       lambda: SCB.plain(x, g, w, pads))
    times['label'] = name


def _check_launches(name, call, want):
    per_call = library_launches(call)
    if per_call != want:
        raise AssertionError(f'{name}: {per_call} launches a call, want '
                             f'{want}')


@torch.no_grad()
def bf16_kernel_sites(device, results):
    '''The five bf16 forms at their bf16 sites, on the activations of a
    seeded bf16 forward: unet.yaml + bf16.yaml's four chains and two stencil
    convs at B=8 as training calls them (the chain with c1 and the f32 c2,
    each backward with the relu-masked cotangent) and at B=64 as predict
    and evaluate call the forwards (the stencil backwards at B=64 too), and
    MulmoUNet's six NHWC stencil sites at B=8 (the first encoder and the
    head also at B=64). Each bit-equal to its f32 form on the upcast inputs,
    rounded; its launches a call by the library's count (the stencil
    backward's by its route, STENCIL_BWD_ROUTE_LAUNCHES; its dw and db the
    same bits on two calls); its max|diff| from its plain version; timings
    as in 3 (the library call: F.conv2d or the conv backward in bf16). The
    B=8 sites go into ``results`` as the ``<kernel>_bf16`` entries, with
    their bounds in bf16 bytes. Then the kept forms: the NHWC conv's direct
    route in bf16 and the stencil backward's split form in f32 and bf16.'''
    from dnncancerannotator_torch.ops.kernels import conv_chain as CC
    from dnncancerannotator_torch.ops.kernels import conv_chain_bwd as CCB
    from dnncancerannotator_torch.ops.kernels import stencil_conv as SC
    from dnncancerannotator_torch.ops.kernels import stencil_conv_bwd as SCB
    from dnncancerannotator_torch.ops.kernels import stencil_conv_nhwc as SN
    F = torch.nn.functional
    conv_bwd = torch.ops.aten.convolution_backward
    bf16 = torch.bfloat16

    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    batch = torch.rand((BATCH, SIZE, SIZE, 5), generator=gen, device=device)
    modules, seen = _site_inputs(
        CONFIGS + (BF16,), [p + '.convchain' for p in BF16_CHAIN_SITES]
        + list(BF16_STENCIL_SITES), batch, device)
    log(f'bf16 forms at unet.yaml + bf16.yaml\'s sites ({SIZE}x{SIZE}, the '
        'activations of a bf16 forward):')
    for path in BF16_CHAIN_SITES:
        chain = modules[path + '.convchain']
        w1, b1, w2, b2 = _bf16(chain.conv_0.weight, chain.conv_0.bias,
                               chain.conv_1.weight, chain.conv_1.bias)
        x_all = seen[path + '.convchain'].to(bf16)
        desc = (f'{path} {w1.shape[1]}->{w1.shape[0]}->{w2.shape[0]} '
                f'@{x_all.shape[-1]}')
        for bsz in (BATCH, TRAIN_BATCH):
            train = bsz == TRAIN_BATCH
            x = x_all[:bsz].contiguous()
            args = (x, w1, b1, w2, b2)
            name = f'conv_chain_bf16 B={bsz}{" need_c1" if train else ""} {desc}'
            c1, c2, c2f = CC.conv_chain(*args, need_c1=train, need_c2f=True)
            f1, f2 = CC.conv_chain(*_upcast(*args), need_c1=train)
            if train:
                _bits_equal(name + ' c1', c1, f1)
            _bits_equal(name + ' c2f', c2f, f2)
            _bits_equal(name, c2, f2.to(bf16))
            err = _bf16_err(name, c2, CC.plain(*args)[1].to(bf16))

            def call():
                return CC.conv_chain(*args, need_c1=train, need_c2f=train)
            _check_launches(name, call, 1)
            times = _time_site(call, lambda: CC.plain(*args)[1].to(bf16))
            taps = w1.shape[2] * w1.shape[3]
            flops = 2 * x[:, :1].numel() * taps * (w1.shape[0] * w1.shape[1]
                                                   + w2.shape[0] * w2.shape[1])
            site = bound(nbytes(*args, c2, *((c1, c2f) if train else ())),
                         flops)
            if not train:
                times['label'] = name
                log(f'  {name:60s} bound {site[0]:.4f} ms ({site[1]})')
                continue
            record(results, 'conv_chain_bf16', err, times, site)
            # the backward on this forward's residuals, as training calls it
            g = torch.randn(c2.shape, generator=gen, device=device).to(bf16)
            need_dx = path != 'unet.encoder.down_0'
            bargs = (x, c1, c2f, g, w1, w2, need_dx)
            name = f'conv_chain_bwd_bf16 {desc}'
            got = CCB.conv_chain_bwd(*bargs)
            want = CCB.conv_chain_bwd(x.float(), c1, c2f, g.float(),
                                      w1.float(), w2.float(), need_dx)
            plain = CCB.plain(*bargs)
            errs = []
            for label, a, f, p in zip(('dx', 'dw1', 'db1', 'dw2', 'db2'),
                                      got, want, plain):
                if f is not None:
                    _bits_equal(f'{name} {label}', a, f.to(bf16))
                    errs.append(_bf16_err(f'{name} {label}', a, p))
            _check_launches(name, lambda: CCB.conv_chain_bwd(*bargs),
                            CHAIN_BWD_LAUNCHES)
            times = _time_site(lambda: CCB.conv_chain_bwd(*bargs),
                               lambda: CCB.plain(*bargs))
            pix = x[:, :1].numel() * taps
            flops = 2 * pix * (2 * w2.shape[0] * w2.shape[1]
                               + (2 if need_dx else 1) * w1.shape[0]
                               * w1.shape[1])
            record(results, 'conv_chain_bwd_bf16', max(errs), times,
                   bound(nbytes(*bargs[:6], *got), flops))

    for path in BF16_STENCIL_SITES:
        conv = modules[path]
        w, b = _bf16(conv.weight, conv.bias)
        relu = conv.relu
        co, ci, kh, kw = w.shape
        pads = ((kh // 2, kh // 2), (kw // 2, kw // 2))
        x_all = seen[path].to(bf16)
        route = SC.route(ci, co, kh, kw, pads, *x_all.shape[2:])
        desc = (f'{path} {kh}x{kw} {ci}->{co}{" relu" if relu else ""} '
                f'@{x_all.shape[-1]}')
        for bsz in (BATCH, TRAIN_BATCH):
            train = bsz == TRAIN_BATCH
            x = x_all[:bsz].contiguous()
            name = f'stencil_conv_bf16 B={bsz} {desc} ({route})'
            got = SC.stencil_conv(x, w, b, pads, relu)
            _bits_equal(name, got, SC.stencil_conv(
                *_upcast(x, w, b), pads, relu).to(bf16))
            err = _bf16_err(name, got, SC.plain(x, w, b, pads, relu))
            _check_launches(name, lambda: SC.stencil_conv(x, w, b, pads,
                                                          relu), 1)
            # no library call fuses the relu: F.conv2d alone
            times = _time_site(
                lambda: SC.stencil_conv(x, w, b, pads, relu),
                lambda: SC.plain(x, w, b, pads, relu),
                lambda: F.conv2d(x, w, b, padding=(kh // 2, kw // 2)))
            site = bound(nbytes(x, w, b, got), 2 * got.numel() * ci * kh * kw)
            if train:
                record(results, 'stencil_conv_bf16', err, times, site)
            else:
                times['label'] = name
                log(f'  {name:60s} bound {site[0]:.4f} ms ({site[1]})')
            g = torch.randn(got.shape, generator=gen, device=device).to(bf16)
            if relu:
                g = g * (got > 0)
            bwd_route = SCB.route(bsz, ci, co, *x.shape[2:], kh, kw, pads)
            name = f'stencil_conv_bwd_bf16 B={bsz} {desc} ({bwd_route})'
            bgot = SCB.stencil_conv_bwd(x, g, w, pads)
            want = SCB.stencil_conv_bwd(*_upcast(x, g, w), pads)
            plain = SCB.plain(x, g, w, pads)
            errs = []
            for label, a, f, p in zip(('dx', 'dw', 'db'), bgot, want, plain):
                _bits_equal(f'{name} {label}', a, f.to(bf16))
                errs.append(_bf16_err(f'{name} {label}', a, p))
            if bwd_route != 'split':
                again = SCB.stencil_conv_bwd(x, g, w, pads)
                if not all(torch.equal(p, q)
                           for p, q in zip(bgot[1:], again[1:])):
                    raise AssertionError(f'{name}: dw, db differ on two '
                                         'calls')
            _check_launches(name, lambda: SCB.stencil_conv_bwd(x, g, w, pads),
                            STENCIL_BWD_ROUTE_LAUNCHES[
                                'split' if bwd_route == 'split' else route])
            times = _time_site(
                lambda: SCB.stencil_conv_bwd(x, g, w, pads),
                lambda: SCB.plain(x, g, w, pads),
                lambda: conv_bwd(g, x, w, [co], [1, 1], [kh // 2, kw // 2],
                                 [1, 1], False, [0, 0], 1, [True] * 3))
            site = bound(nbytes(x, g, w, *bgot), 4 * g.numel() * ci * kh * kw)
            if train:
                record(results, 'stencil_conv_bwd_bf16', max(errs), times,
                       site)
            else:
                times['label'] = name
                log(f'  {name:60s} bound {site[0]:.4f} ms ({site[1]})')

    modules, seen = _site_inputs(MULMO_CONFIGS + (BF16,), MULMO_STENCIL_SITES,
                                 batch[:TRAIN_BATCH], device)
    log(f'bf16 forms at MulmoUNet + bf16.yaml\'s sites (B={TRAIN_BATCH}; '
        f'the first encoder and the head also at B={BATCH}):')
    for path in MULMO_STENCIL_SITES:
        conv = modules[path]
        w, b = _bf16(conv.weight, conv.bias)
        relu = conv.relu
        co, ci, kh, kw = w.shape
        pads = ((kh // 2, kh // 2), (kw // 2, kw // 2))
        # an encoder casts its channel of the batch
        inputs = {TRAIN_BATCH: seen[path].to(bf16)}
        if path in (MULMO_STENCIL_SITES[0], 'last_conv'):
            inputs[BATCH] = (batch[..., :1].to(bf16) if path != 'last_conv'
                             else torch.rand(
                                 (BATCH,) + tuple(seen[path].shape[1:]),
                                 generator=gen, device=device).to(bf16))
        for bsz, x in inputs.items():
            route = SN.route(bsz, *x.shape[1:3], ci, co, kh, kw, pads,
                             x.element_size())
            name = (f'stencil_conv_nhwc_bf16 B={bsz} {path} {kh}x{kw} '
                    f'{ci}->{co}{" relu" if relu else ""} @{x.shape[1]} '
                    f'({route})')
            got = SN.stencil_conv_nhwc(x, w, b, pads, relu)
            _bits_equal(name, got, SN.stencil_conv_nhwc(
                *_upcast(x, w, b), pads, relu).to(bf16))
            err = _bf16_err(name, got, SN.plain(x, w, b, pads, relu))
            _check_launches(name, lambda: SN.stencil_conv_nhwc(x, w, b, pads,
                                                               relu),
                            STENCIL_NHWC_LAUNCHES)
            times = _time_site(
                lambda: SN.stencil_conv_nhwc(x, w, b, pads, relu),
                lambda: SN.plain(x, w, b, pads, relu),
                lambda: F.conv2d(x.permute(0, 3, 1, 2), w, b,
                                 padding=(kh // 2, kw // 2)))
            site = bound(nbytes(x, w, b, got), 2 * got.numel() * ci * kh * kw)
            if bsz == TRAIN_BATCH:
                record(results, 'stencil_conv_nhwc_bf16', err, times, site)
            else:
                times['label'] = name
                log(f'  {name:60s} bound {site[0]:.4f} ms ({site[1]})')

    # the kept forms: the NHWC conv's direct route, the stencil backward's
    # split form
    nhwc_direct_site(device, gen, bf16)
    for dtype in (torch.float32, bf16):
        stencil_split_site(device, gen, dtype)


# -- phase 3i ----------------------------------------------------------------
def stencil_direct_site(device, gen, dtype):
    """The NCHW stencil conv's kept direct route at STENCIL_DIRECT_SITE (3x3
    SAME 32 -> 32 with relu at 8 x 8192): against its plain version (f32:
    KERNEL_TOL; bf16: bit-equal to the f32 form on the upcast inputs), one
    launch a call, its times logged."""
    from dnncancerannotator_torch.ops.kernels import stencil_conv as SC
    site = STENCIL_DIRECT_SITE
    bsz, ci, h, wd = site['shape']
    co, k, pads = site['co'], site['k'], ((1, 1), (1, 1))
    x = torch.rand(site['shape'], generator=gen, device=device).to(dtype)
    w = (torch.randn((co, ci, k, k), generator=gen, device=device)
         * 0.1).to(dtype)
    b = torch.randn((co,), generator=gen, device=device).to(dtype)
    route = SC.route(ci, co, k, k, pads, h, wd)
    name = (f'stencil_conv{"_bf16" if dtype != torch.float32 else ""} '
            f'{list(x.shape)} {k}x{k} {ci}->{co} relu ({route})')
    if route != 'stencil':
        raise AssertionError(f'{name}: the kept site takes the {route} route')
    got = SC.stencil_conv(x, w, b, pads, True)
    if dtype == torch.float32:
        _check_close(name, got, SC.plain(x, w, b, pads, True))
    else:
        _bits_equal(name, got, SC.stencil_conv(
            *_upcast(x, w, b), pads, True).to(dtype))
        _bf16_err(name, got, SC.plain(x, w, b, pads, True))
    _check_launches(name, lambda: SC.stencil_conv(x, w, b, pads, True), 1)
    times = _time_site(lambda: SC.stencil_conv(x, w, b, pads, True),
                       lambda: SC.plain(x, w, b, pads, True))
    times['label'] = name


@torch.no_grad()
def leaky_kernel_sites(device, results):
    """Phase 3i: the NCHW stencil conv's tile route at unet.yaml +
    leakyReLU.yaml's nine sites (LEAKY_STENCIL_SITES), on the activations
    of a seeded forward of that stack, in f32 and bf16 at B=8 (training)
    and B=64 (predict, evaluate). At each: the route (a failure unless the
    tile), the f32 form against its plain version to KERNEL_TOL, the bf16
    form bit-equal to the f32 form on the upcast inputs, rounded, one
    launch a call by the library's count, and its times (``_time_site``;
    the library call ``F.conv2d`` with the bias) and bound. The B=8 sites
    go into ``results`` as ``stencil_conv_tile`` and
    ``stencil_conv_tile_bf16``. At B=8 also the stencil backward on the
    leaky-masked cotangent, as phase 3b holds the backward (f32: DX_TOL,
    DW_TOL and F64_RATIO of the plain version's error against f64; bf16 bit-
    equal to its f32 form; dw and db the same bits on two calls), with its
    route and time beside ``convolution_backward``. Then the direct route
    kept at STENCIL_DIRECT_SITE."""
    from dnncancerannotator_torch.ops.kernels import stencil_conv as SC
    from dnncancerannotator_torch.ops.kernels import stencil_conv_bwd as SCB
    F = torch.nn.functional
    conv_bwd = torch.ops.aten.convolution_backward
    alpha = 0.3   # leakyReLU.yaml

    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    batch = torch.rand((BATCH, SIZE, SIZE, 5), generator=gen, device=device)
    modules, seen = _site_inputs(LEAKY_CONFIGS, LEAKY_STENCIL_SITES, batch,
                                 device)
    log(f'the NCHW stencil conv at unet.yaml + leakyReLU.yaml\'s '
        f'{len(LEAKY_STENCIL_SITES)} sites ({SIZE}x{SIZE}; the activations '
        'of a seeded forward):')
    for path in LEAKY_STENCIL_SITES:
        conv = modules[path]
        co, ci, kh, kw = conv.weight.shape
        pads = ((kh // 2, kh // 2), (kw // 2, kw // 2))
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            tag = '_bf16' if bf16 else ''
            w, b = conv.weight.to(dtype), conv.bias.to(dtype)
            for bsz in (BATCH, TRAIN_BATCH):
                x = seen[path][:bsz].contiguous().to(dtype)
                route = SC.route(ci, co, kh, kw, pads, *x.shape[2:])
                desc = (f'B={bsz} {path} {kh}x{kw} {ci}->{co} '
                        f'@{x.shape[-1]}')
                name = f'stencil_conv{tag} {desc} ({route})'
                if route != 'tile':
                    raise AssertionError(f'{name}: not the tile route')
                got = SC.stencil_conv(x, w, b, pads)
                if bf16:
                    _bits_equal(name, got, SC.stencil_conv(
                        *_upcast(x, w, b), pads).to(dtype))
                    err = _bf16_err(name, got, SC.plain(x, w, b, pads))
                else:
                    err = _check_close(name, got, SC.plain(x, w, b, pads))
                _check_launches(name, lambda: SC.stencil_conv(x, w, b, pads),
                                1)
                times = _time_site(
                    lambda: SC.stencil_conv(x, w, b, pads),
                    lambda: SC.plain(x, w, b, pads),
                    lambda: F.conv2d(x, w, b, padding=(kh // 2, kw // 2)))
                site = bound(nbytes(x, w, b, got),
                             2 * got.numel() * ci * kh * kw)
                if bsz == BATCH:
                    times['label'] = name
                    log(f'  {name:60s} bound {site[0]:.4f} ms ({site[1]})')
                    continue
                record(results, f'stencil_conv_tile{tag}', err, times, site)
                # the backward on the leaky-masked cotangent, as training
                # calls it
                g = torch.randn(got.shape, generator=gen,
                                device=device).to(dtype)
                g = torch.where(got > 0, g, g * alpha)
                bwd_route = SCB.route(bsz, ci, co, *x.shape[2:], kh, kw, pads)
                name = f'stencil_conv_bwd{tag} {desc} ({bwd_route})'
                bgot = SCB.stencil_conv_bwd(x, g, w, pads)
                if bf16:
                    want = SCB.stencil_conv_bwd(*_upcast(x, g, w), pads)
                    for label, a, f in zip(('dx', 'dw', 'db'), bgot, want):
                        _bits_equal(f'{name} {label}', a, f.to(dtype))
                else:
                    _check_grads(name, bgot, SCB.plain(x, g, w, pads),
                                 SCB.plain(*_f64(x, g, w), pads))
                if bwd_route != 'split':
                    again = SCB.stencil_conv_bwd(x, g, w, pads)
                    if not all(torch.equal(p, q)
                               for p, q in zip(bgot[1:], again[1:])):
                        raise AssertionError(f'{name}: dw, db differ on two '
                                             'calls')
                _check_launches(
                    name, lambda: SCB.stencil_conv_bwd(x, g, w, pads),
                    STENCIL_BWD_ROUTE_LAUNCHES[bwd_route])
                times = _time_site(
                    lambda: SCB.stencil_conv_bwd(x, g, w, pads),
                    lambda: SCB.plain(x, g, w, pads),
                    lambda: conv_bwd(g, x, w, [co], [1, 1],
                                     [kh // 2, kw // 2], [1, 1], False,
                                     [0, 0], 1, [True] * 3))
                times['label'] = name
                site = bound(nbytes(x, g, w, *bgot),
                             4 * g.numel() * ci * kh * kw)
                log(f'  {name:60s} bound {site[0]:.4f} ms ({site[1]})')
    for dtype in (torch.float32, torch.bfloat16):
        stencil_direct_site(device, gen, dtype)


# -- phase 13 ----------------------------------------------------------------
def _plain_model_forward(model, x):
    """Probabilities of ``model`` on NHWC features x with every unet.yaml
    kernel swapped for its plain version."""
    with _plain_versions(*_unet_modules()):
        return torch.sigmoid(model(x, return_logits=True))


def leaky_train_slice(device, data_paths):
    """Phase 13: the ``train`` CLI with unet.yaml + leakyReLU.yaml at the
    unet.yaml operating point (B=8 256 x 256 crops, banked warp) for
    LEAKY_STEPS steps in one chunk: every loss finite, the stencil conv's
    tile route launched at least 9 x steps times (its nine sites), its
    backward as often, no chain kernel; ``predict`` from the checkpoint
    equals a plain forward of its weights (MAP_TOL); one step on a seeded
    state (SEED's initial weights, a seeded batch and draws) through the
    kernels against a plain step (``_compare_step``: STEP_TOL, else
    F64_RATIO of the plain step's distance from the f64 step). Returns the
    launch counts of the train call and of the predict call."""
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.data import pipeline
    from dnncancerannotator_torch.ops import kernels
    from dnncancerannotator_torch.runs.__main__ import main as cli

    overlay = os.path.join(WORK, 'leaky_steps_per_call.json')
    with open(overlay, 'w') as fh:
        json.dump({'deploy_options.steps_per_call': LEAKY_STEPS}, fh)
    save_path = os.path.join(WORK, 'leaky_run')
    kernels.reset_launches()
    torch.cuda.synchronize()
    start = time.perf_counter()
    res = cli(argv=[
        'train', '--config', *[os.path.join(REPO, c) for c in LEAKY_CONFIGS],
        overlay, '--save_path', save_path, '--data_path', *data_paths,
        '--save_freq', str(LEAKY_STEPS), '--seed', str(SEED), '--device',
        device.type, '--max_steps', str(LEAKY_STEPS)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = kernels.launch_counts()
    losses = res.history['loss']
    log(f'unet.yaml + leakyReLU.yaml train: {LEAKY_STEPS} steps in '
        f'{seconds:.3f} s (host clock, the bank solve and data load '
        f'included); loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches '
        f'{launches}')
    if res.epoch != list(range(1, LEAKY_STEPS + 1)) or \
            not np.isfinite(losses).all():
        raise AssertionError(f'train steps {res.epoch}, losses {losses}')
    n_sites = len(LEAKY_STENCIL_SITES)
    for name in ('stencil_conv_tile', 'stencil_conv_bwd'):
        if launches[name] < n_sites * LEAKY_STEPS:
            raise AssertionError(f'{name} launched {launches[name]} times, '
                                 f'want >= {n_sites} x {LEAKY_STEPS}')
    if launches['conv_chain'] or launches['conv_chain_bwd']:
        raise AssertionError('a chain kernel ran under leakyReLU.yaml')

    config = _config(LEAKY_CONFIGS)
    eng = engine.Engine(config, seed=SEED, device=device)
    eng.build((BATCH, SIZE, SIZE, 5))
    eng.load(os.path.join(save_path, 'checkpoints', f'ckpt-{LEAKY_STEPS}'))
    out_dir = os.path.join(WORK, 'leaky_maps')
    kernels.reset_launches()
    count = cli(argv=['predict', '--save_path', save_path, '--data_path',
                      *data_paths, '--output_path', out_dir, '--batch_size',
                      str(BATCH), '--output_format', 'npy', '--device',
                      device.type])
    predict_launches = kernels.launch_counts()
    log(f'predict from ckpt-{LEAKY_STEPS}: {count} maps; launches '
        f'{predict_launches}')
    if predict_launches['stencil_conv_tile'] < n_sites:
        raise AssertionError('predict launched the tile '
                             f'{predict_launches["stencil_conv_tile"]} times')
    _check_maps(eng.model, data_paths, out_dir,
                sum(TRAIN_EXAMS) * TRAIN_SLICES,
                reference=lambda x: _plain_model_forward(eng.model, x))

    ds = pipeline.train_ds(data_paths, **config['data_options']['train'])
    eng, raw, draws = big_check_state(config, ds, SEED, device)
    modules = _unet_modules()
    with _deterministic_cudnn():
        _compare_step(
            _big_step(eng, ds, raw, draws, plain=False, modules=modules),
            _big_step(eng, ds, raw, draws, plain=True, modules=modules),
            lambda: _big_step(eng, ds, raw, draws, plain=True, f64=True,
                              modules=modules),
            'unet.yaml + leakyReLU.yaml')
    return launches, predict_launches


# -- phase 14 ----------------------------------------------------------------
# the training options: label smoothing and the kernel regularizer on the
# unet.yaml stack (overlays last: deploy_options.yaml replaces the dict)
OPTIONS_CONFIGS = CONFIGS + ('configs/additionals/enable_label_smoothing.yaml',
                             'configs/additionals/kernel_regularizer.yaml')
OPTIONS_STEPS = 20          # (a), (c): the train CLI, in chunks of 10
OPTIONS_SPC = 10
OPTIMIZER_STEPS = 3         # (b): each optimizer of the registry
PROFILE_TRAIN_STEPS = 212   # (e): past the profiler window [200, 210)
SIGTERM_TIMEOUT = 300       # (d): seconds the train subprocess may take
RATES = {}                  # train throughput by phase, slices/s


def _overlay_file(name, options):
    path = os.path.join(WORK, name)
    with open(path, 'w') as fh:
        json.dump(options, fh)
    return path


def _options_argv(device, data_paths, save_path, *overlays):
    return ['train', '--config',
            *[os.path.join(REPO, c) for c in OPTIONS_CONFIGS], *overlays,
            '--save_path', save_path, '--data_path', *data_paths, '--seed',
            str(SEED), '--device', device.type]


def _options_engine(device, ds, bank_from=None, **deploy):
    """An Engine of the options stack with ``deploy`` options set, sharing
    the warp bank of ``bank_from`` (solved once)."""
    from dnncancerannotator_torch import engine
    config = _config(OPTIONS_CONFIGS)
    config['deploy_options'].update(deploy)
    eng = engine.Engine(config, seed=SEED, device=device)
    if bank_from is not None:
        eng._bank_cache = bank_from._bank_cache
    return eng


def options_cli(device, data_paths):
    """(a) The train CLI with the options stack for OPTIONS_STEPS steps:
    every loss finite, every kernel of the train step launched at least
    (sites x steps) times by its wrapper's count and the library's own
    count above 0; then one step on the trained weights through the
    kernels against a plain step (``check_step_grads``, the regularizer's
    share included). Returns the run's losses, an Engine of the stack
    holding the trained state, and its dataset."""
    from dnncancerannotator_torch.data import pipeline
    from dnncancerannotator_torch.ops import kernels
    from dnncancerannotator_torch.ops.kernels import _build
    from dnncancerannotator_torch.runs.__main__ import main as cli

    save_path = os.path.join(WORK, 'options_run')
    spc = _overlay_file('options_spc.json',
                        {'deploy_options.steps_per_call': OPTIONS_SPC})
    kernels.reset_launches()
    torch.cuda.synchronize()
    library = _build.library_launches()
    start = time.perf_counter()
    res = cli(argv=_options_argv(device, data_paths, save_path, spc) + [
        '--save_freq', str(OPTIONS_STEPS), '--max_steps',
        str(OPTIONS_STEPS)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    library = _build.library_launches() - library
    launches = kernels.launch_counts()
    losses = res.history['loss']
    log(f'options-stack train: {OPTIONS_STEPS} steps in {seconds:.3f} s '
        f'(host clock, the bank solve and data load included); loss '
        f'{losses[0]:.4f} -> {losses[-1]:.4f}; launches {launches}; the '
        f'library counted {library}')
    if res.epoch != list(range(1, OPTIONS_STEPS + 1)) or \
            not np.isfinite(losses).all():
        raise AssertionError(f'train steps {res.epoch}, losses {losses}')
    for name, sites in TRAIN_SITES.items():
        if launches[name] < sites * OPTIONS_STEPS:
            raise AssertionError(
                f'{name} launched {launches[name]} times under the options '
                f'stack, want >= {sites} x {OPTIONS_STEPS}')
    if library <= 0:
        raise AssertionError('the kernel library counted no launch')

    ds = pipeline.train_ds(data_paths,
                           **_config(OPTIONS_CONFIGS)['data_options']['train'])
    eng = _options_engine(device, ds)
    eng._setup_training(ds)
    eng.load(os.path.join(save_path, 'checkpoints', f'ckpt-{OPTIONS_STEPS}'))
    eng.current_step = OPTIONS_STEPS
    if eng.l2_scale != 0.01 or not eng.loss.label_smoothing:
        raise AssertionError('the options stack lost an option: l2 '
                             f'{eng.l2_scale}, smoothing '
                             f'{eng.loss.label_smoothing}')
    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    raw = eng.sample_batch(eng._resident(ds), TRAIN_BATCH, gen)
    log(f'kernel regularizer on the trained weights: '
        f'{float(eng.regularization().detach()):.7f}')
    check_step_grads(eng, ds, raw, gen, 'options-stack train step')
    return losses, eng, ds


def _updated_params(eng, ds, raw, draws, plain, f64=False):
    """The parameters after one optimizer step on the gradients of
    ``_step_grads`` (the kernels, their plain versions, or with ``f64`` the
    plain step in f64, its optimizer state cast to f64 too), and those
    gradients; the model, its gradients and the optimizer state are put
    back after."""
    model0 = copy.deepcopy(eng.model.state_dict())
    opt0 = copy.deepcopy(eng.optimizer.state_dict())
    _, grads = _step_grads(eng, ds, raw, draws, plain, f64)
    try:
        if f64:
            eng.model.double()
        # load_state_dict casts the state to its parameter's dtype
        eng.optimizer.load_state_dict(copy.deepcopy(opt0))
        for group in eng.optimizer.param_groups:
            group['lr'] = eng.schedule(eng.current_step)
        for n, p in eng.model.named_parameters():
            p.grad = grads[n]
        eng.optimizer.step()
        return ({n: p.detach().clone()
                 for n, p in eng.model.named_parameters()}, grads)
    finally:
        eng.model.float()
        eng.model.load_state_dict(model0)
        eng.optimizer.load_state_dict(opt0)
        eng.model.zero_grad(set_to_none=True)


def check_optimizer_step(eng, ds, name):
    """One step of lamb or lion on the trained state through the kernels
    against the plain step, by phase 5's rule on the updated parameters:
    each within STEP_TOL of its plain update's max|.|, else no further from
    the f64 step than F64_RATIO times the plain step. For lion an element
    may take the other sign where its sign argument, (1 - b1) g + b1 mu,
    lies within the gradient's tolerance of 0 on the plain step: those
    elements are counted and left out."""
    from dnncancerannotator_torch.data import augment

    gen = torch.Generator(device=eng.device).manual_seed(SEED + 15)
    raw = eng.sample_batch(eng._resident(ds), TRAIN_BATCH, gen)
    draws = augment.draw_chain(ds.augment_methods, raw.shape, gen,
                               eng._warp_bank(ds))
    before = {n: p.detach().clone() for n, p in eng.model.named_parameters()}
    mu = {n: eng.optimizer.state[p]['mu'].clone()
          for n, p in eng.model.named_parameters()}
    b1 = eng.optimizer.param_groups[0]['b1']
    got, _ = _updated_params(eng, ds, raw, draws, plain=False)
    want, grads = _updated_params(eng, ds, raw, draws, plain=True)
    worst, flips, exact = 0.0, 0, []
    for n, w in want.items():
        scale = float((w - before[n]).abs().max())
        keep = torch.ones_like(w, dtype=torch.bool)
        if name == 'lion':
            sign_arg = ((1 - b1) * grads[n] + b1 * mu[n]).abs()
            near = sign_arg <= (1 - b1) * STEP_TOL * float(
                grads[n].abs().max())
            flips += int((near & ((got[n] - w).abs() > STEP_TOL * scale))
                         .sum())
            keep = ~near
        err = float(((got[n] - w).abs() * keep).max())
        if err <= STEP_TOL * scale:
            worst = max(worst, err / scale if scale else 0.0)
            continue
        if not exact:
            exact.append(_updated_params(eng, ds, raw, draws, plain=True,
                                         f64=True)[0])
        err64, plain64 = (float(((t.double() - exact[0][n]).abs() * keep)
                                .max()) for t in (got[n], w))
        log(f'  {name}: {n} updated {err:.3e} > {STEP_TOL} * {scale:.3e} '
            f'from the plain step; from the f64 step: kernels {err64:.3e}, '
            f'plain {plain64:.3e}')
        if not err64 <= F64_RATIO * plain64:
            raise AssertionError(
                f'{name}: {n} updated {err} from the plain step, past '
                f'{STEP_TOL} * {scale}, and {err64} from the f64 step '
                f'against the plain step\'s {plain64}')
    log(f'{name}: one step through the kernels against the plain step: '
        f'every parameter within {worst:.3e} of its update\'s max|.|, but '
        'for those held to the f64 step above'
        + (f'; {flips} sign flips, each at a sign argument within the '
           'gradient tolerance of 0' if flips else ''))


def options_optimizers(device, ds, base):
    """(b) A few steps of Engine.train with each optimizer of the
    registry: every loss finite and every state tensor on the card; lamb
    and lion also against a plain step (``check_optimizer_step``)."""
    from dnncancerannotator_torch.train import optimizers

    for name in sorted(optimizers._REGISTRY):
        eng = _options_engine(device, ds, base, optimizer=name,
                              steps_per_call=OPTIMIZER_STEPS)
        res = eng.train(ds, max_steps=OPTIMIZER_STEPS, save_freq=1 << 30)
        losses = res.history['loss']
        if len(losses) != OPTIMIZER_STEPS or not np.isfinite(losses).all():
            raise AssertionError(f'{name}: losses {losses}')
        state = [(key, v) for st in eng.optimizer.state.values()
                 for key, v in st.items() if key != 'step']
        # sgd without momentum keeps no state, as optax.sgd keeps none
        if (not state and name != 'sgd') or any(
                v.device != device for _, v in state):
            raise AssertionError(f'{name}: state tensors on '
                                 f'{sorted({str(v.device) for _, v in state})}')
        log(f'{name}: {type(eng.optimizer).__name__}, {OPTIMIZER_STEPS} '
            f'steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}, '
            f'{len(state)} state tensors on {device} '
            f'({", ".join(sorted({k for k, _ in state}))})')
        if name in ('lamb', 'lion'):
            check_optimizer_step(eng, ds, name)


def options_debug_asserts(device, data_paths, ds, base, losses):
    """(c) The (a) run with ``deploy_options.debug_asserts: true`` as an
    inline overlay: it passes; its losses beside (a)'s; the train step's
    time with and without the checks, and a profiler window of each step
    (deferred to phase 9)."""
    from dnncancerannotator_torch.runs.__main__ import main as cli

    save_path = os.path.join(WORK, 'options_checked_run')
    overlays = (_overlay_file('options_spc.json', {
        'deploy_options.steps_per_call': OPTIONS_SPC}),
        _overlay_file('debug_asserts.json',
                      {'deploy_options.debug_asserts': True}))
    res = cli(argv=_options_argv(device, data_paths, save_path, *overlays)
              + ['--save_freq', str(OPTIONS_STEPS), '--max_steps',
                 str(OPTIONS_STEPS)])
    checked = res.history['loss']
    if len(checked) != OPTIONS_STEPS or not np.isfinite(checked).all():
        raise AssertionError(f'debug_asserts run: losses {checked}')
    log(f'debug_asserts: true: {OPTIONS_STEPS} steps pass; max|loss - '
        f'(a)\'s loss| {max(abs(a - b) for a, b in zip(checked, losses))}')
    # the step's time, from Engine.train calls that differ only in step
    # count (as phase 5: 25 and 100 steps, each the minimum of three),
    # with and without the checks in turns
    engines = {label: _options_engine(device, ds, base, debug_asserts=on,
                                      steps_per_call=STEPS_PER_CALL)
               for label, on in (('without', False), ('with', True))}
    times = {}
    for eng in engines.values():
        eng.train(ds, max_steps=10, save_freq=1 << 30)
    for _ in range(3):
        for label, eng in engines.items():
            for n in (25, 100):
                torch.cuda.synchronize()
                start = time.perf_counter()
                eng.train(ds, max_steps=eng.current_step + n,
                          save_freq=1 << 30)
                torch.cuda.synchronize()
                times.setdefault((label, n), []).append(
                    time.perf_counter() - start)
    gen = torch.Generator(device=device).manual_seed(SEED + 17)
    raw = base.sample_batch(base._resident(ds), TRAIN_BATCH, gen)
    for label, eng in engines.items():
        _DEFERRED.append(lambda eng=eng, label=label: _profile_steps(
            f'options-stack train step {label} debug_asserts',
            lambda: eng.train_step(raw, eng.current_step, gen)))
        ms, median_ms = (1e3 * (f(times[label, 100]) - f(times[label, 25]))
                         / 75 for f in (min, statistics.median))
        RATES[f'options stack, {label} debug_asserts'] = \
            1e3 * TRAIN_BATCH / ms
        log(f'options-stack train step {label} debug_asserts: {ms:.4f} ms, '
            f'{1e3 * TRAIN_BATCH / ms:.2f} slices/s ({median_ms:.4f} ms from '
            f'the medians; 25-step calls {times[label, 25]} s, 100-step '
            f'calls {times[label, 100]} s; steps_per_call {STEPS_PER_CALL})')


def options_sigterm(device, data_paths):
    """(d) The train CLI in a subprocess, signalled with SIGTERM after its
    first logged step: it exits 0 and leaves one checkpoint, at the step
    it stopped at; a second call resumes there for two more steps."""
    import re
    import signal
    import threading
    from dnncancerannotator_torch.runs.__main__ import main as cli

    save_path = os.path.join(WORK, 'sigterm_run')
    argv = _options_argv(device, data_paths, save_path)
    proc = subprocess.Popen(
        [sys.executable, '-m', 'dnncancerannotator_torch', *argv,
         '--save_freq', '50000', '--max_steps', '100000'],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    timer = threading.Timer(SIGTERM_TIMEOUT, proc.kill)
    timer.start()
    first = None
    try:
        for line in proc.stdout:
            m = re.search(r'step (\d+)/100000', line)
            if m:
                first = int(m.group(1))
                proc.send_signal(signal.SIGTERM)
                break
        rest = proc.communicate()[0]
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if first is None or proc.returncode != 0:
        raise AssertionError(f'the train subprocess: rc {proc.returncode}, '
                             f'first logged step {first}; its end:\n'
                             f'{rest[-2000:] if rest else ""}')
    m = re.search(r'Preempted \(SIGTERM\) at step (\d+)', rest)
    ckpts = sorted(os.listdir(os.path.join(save_path, 'checkpoints')))
    if not m or ckpts != [f'ckpt-{m.group(1)}'] or int(m.group(1)) < first:
        raise AssertionError(f'SIGTERM after step {first}: checkpoints '
                             f'{ckpts}, log {m and m.group(0)}')
    stop = int(m.group(1))
    res = cli(argv=argv + ['--save_freq', '50000', '--max_steps',
                           str(stop + 2)])
    if res.epoch != [stop + 1, stop + 2] or \
            not np.isfinite(res.history['loss']).all():
        raise AssertionError(f'the resumed call ran {res.epoch}: '
                             f'{res.history["loss"]}')
    log(f'SIGTERM after logged step {first}: rc 0, ckpt-{stop}; resumed '
        f'steps {res.epoch}')


def options_profile(device, data_paths):
    """(e) The train CLI with --profile for PROFILE_TRAIN_STEPS steps: one
    trace under save_path/tfevents/profile, naming the chain kernel."""
    from dnncancerannotator_torch.runs.__main__ import main as cli

    save_path = os.path.join(WORK, 'profile_run')
    cli(argv=_options_argv(device, data_paths, save_path) + [
        '--profile', '--save_freq', '1000', '--max_steps',
        str(PROFILE_TRAIN_STEPS)])
    out_dir = os.path.join(save_path, 'tfevents', 'profile')
    files = os.listdir(out_dir)
    if len(files) != 1:
        raise AssertionError(f'profile files {files}')
    with open(os.path.join(out_dir, files[0])) as fh:
        events = json.load(fh)['traceEvents']
    names = {e['name'] for e in events if e.get('cat') == 'kernel'}
    chain = sorted(n for n in names if 'conv_chain' in n)
    if not chain:
        raise AssertionError(f'the trace {files[0]} names no chain kernel '
                             f'among {sorted(names)[:20]}')
    log(f'profile: {files[0]}: {len(events)} events, {len(names)} kernel '
        f'names; the chain\'s: {chain}')


def options_slice(device, data_paths):
    """Phase 14: (a)-(e) above."""
    losses, eng, ds = options_cli(device, data_paths)
    options_optimizers(device, ds, eng)
    options_debug_asserts(device, data_paths, ds, eng, losses)
    log('train throughput, slices/s: ' + json.dumps(RATES) + ' ('
        + torch.cuda.get_device_name(0) + ')')
    options_sigterm(device, data_paths)
    # last: a profiler session slows the host's later CUDA calls
    options_profile(device, data_paths)


# -- phase 7 -----------------------------------------------------------------
def _busy_us(prof):
    '''Microseconds of a profiler window in which the device ran a kernel,
    copy or fill: the union of their intervals, so that kernels that
    overlap (on cuDNN's or the allocator's other streams) count once.'''
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, 'is_user_annotation', False))
    if not spans:
        raise AssertionError('the profiler window holds no device event')
    busy, end = 0.0, float('-inf')
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def _profile_steps(label, step, steps=5, top=12):
    '''Where a step's device time goes: ``steps`` calls of ``step`` under
    torch.profiler, the device's busy time (``_busy_us``) and its share of
    the window's wall time, the kernel times summed, and the ``top``
    kernels by device time; returns the window's device events.'''
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        start = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, 'is_user_annotation', False)]
    summed_us = sum(e.self_device_time_total for e in device)
    busy_us = _busy_us(prof)
    log(f'{label} under torch.profiler: {wall * 1e3 / steps:.3f} ms a step, '
        f'device busy {busy_us / 1e3 / steps:.3f} ms a step '
        f'({100 * busy_us / 1e6 / wall:.1f}% of the wall time; kernel times '
        f'summed {summed_us / 1e3 / steps:.3f} ms; '
        f'{sum(e.count for e in device) / steps:.1f} kernels a step); by '
        'kernel:')
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:top]:
        log(f'  {e.self_device_time_total / 1e3 / steps:9.3f} ms '
            f'{e.count // steps:4d}x  {e.key[:90]}')
    return device


def _batch_stats(path):
    from dnncancerannotator_torch import engine
    return {k: v for k, v in engine.read_ckpt(path, opt_state=False).items()
            if k.startswith('batch_stats/')}


def _big_step(eng, ds, raw, draws, plain, f64=False, modules=None):
    '''Loss, parameter gradients and updated BatchNorm statistics of one
    train-mode step on ``raw`` with the given draws, through the kernels or
    their plain versions (those of ``modules``, by default unet_big's NHWC
    kernels and the warp); the statistics are put back after. With ``f64``
    the plain step's model and loss run in f64 on the same augmented f32
    batch (the kernels take f32 only, so none routes), and the model is
    put back in f32 after: an exact reference for ``_compare_step``.'''
    from dnncancerannotator_torch.data import augment

    if modules is None:
        modules = (*_nhwc_modules(), _warp_module())
    start = {n: b.clone() for n, b in eng.model.named_buffers()}
    try:
        with (_plain_versions(*modules) if plain
              else contextlib.nullcontext()):
            images = augment.apply_chain(
                ds.augment_methods, raw.float() / 255.0, draws,
                eng._warp_bank(ds))
            x, y = augment.to_feature_label(images, ds.slice_types)
            if f64:
                eng.model.double()
                x = x.double()
            eng.model.zero_grad(set_to_none=True)
            with eng.scope(training=True):
                logits = eng.model(x, return_logits=True)
            loss = eng.loss(y, logits)
            loss.backward()
        grads = {n: p.grad.clone() for n, p in eng.model.named_parameters()}
        stats = {}
        for n, b in eng.model.named_buffers():
            stats[n] = b.clone()
            b.copy_(start[n])
    finally:
        if f64:
            eng.model.float()
            eng.model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads, stats


def _step_errors(got, want, exact):
    '''{name: entry} of one step through the kernels against the plain
    step: the loss, then each gradient and statistic with its max|diff|
    from the plain step (``err``), the scale it is held on and its
    tolerance; where ``err`` exceeds them, also the kernel step's and the
    plain step's max|diff| from the f64 step (``exact()``, made once, when
    first needed). A bias right before a BatchNorm (the tconv biases) has
    an exact gradient of 0, so both sides hold rounding noise there: a bias
    is held on the scale of its layer's weight gradient.'''
    (loss, grads, stats), (plain_loss, plain_grads, plain_stats) = got, want
    out = {'loss': dict(kind='loss', err=abs(loss - plain_loss),
                        scale=abs(plain_loss), tol=LOSS_TOL, got=loss,
                        plain=plain_loss)}
    exact_step = []
    for kind, tol, ours, ref in (('grad', STEP_TOL, grads, plain_grads),
                                 ('stat', STATS_TOL, stats, plain_stats)):
        for name, w in ref.items():
            layer = name.rsplit('.', 1)[0]
            scale = max(float(w.abs().max()), float(
                ref.get(layer + '.weight', w).abs().max()))
            entry = dict(kind=kind, err=float((ours[name] - w).abs().max()),
                         scale=scale, tol=tol)
            if not entry['err'] <= tol * scale:
                if not exact_step:
                    exact_step.append(exact())
                ref64 = exact_step[0][1 if kind == 'grad' else 2][name]
                entry['err64'], entry['plain64'] = (
                    float((t.double() - ref64).abs().max())
                    for t in (ours[name], w))
            out[name] = entry
    return out


def _compare_step(got, want, exact, label='unet_big'):
    '''One step through the kernels against the plain step
    (``_step_errors``): the loss to LOSS_TOL relative, each gradient to
    STEP_TOL and each statistic to STATS_TOL of its scale.

    Where the kernel step is further than that from the plain f32 step,
    both are held to the f64 step: the kernel step passes if it is no
    further from it than F64_RATIO times the plain step, the kernels' own
    rule (phase 3e). A gradient that is a sum cancelling to near 0 (a
    BatchNorm bias whose incoming gradient has zero pixel mean before a
    relu mask) holds the rounding of every term it sums, and the plain f32
    step is no truth there.'''
    errors = _step_errors(got, want, exact)
    loss = errors.pop('loss')
    log(f'one {label} train step: loss {loss["got"]:.7f} kernels, '
        f'{loss["plain"]:.7f} plain')
    if not loss['err'] <= LOSS_TOL * loss['scale']:
        raise AssertionError(f'train-step loss {loss["got"]} vs plain '
                             f'{loss["plain"]}')
    worst = {'grad': 0.0, 'stat': 0.0}
    for name, e in errors.items():
        if 'err64' not in e:
            worst[e['kind']] = max(worst[e['kind']], e['err'] / e['scale'])
            continue
        log(f'  {name}: {e["err"]:.3e} > {e["tol"]} * {e["scale"]:.3e} from '
            f'the plain step; from the f64 step: kernels {e["err64"]:.3e}, '
            f'plain {e["plain64"]:.3e}')
        if not e['err64'] <= F64_RATIO * e['plain64']:
            raise AssertionError(f'{name}: {e["err"]} > {e["tol"]} * '
                                 f'{e["scale"]} from the plain train step, '
                                 f'and the kernels are {e["err64"]} from the '
                                 f'f64 step against the plain step\'s '
                                 f'{e["plain64"]}')
    n_grads = sum(e['kind'] == 'grad' for e in errors.values())
    log(f'  {n_grads} parameter gradients within {worst["grad"]:.3e} and '
        f'{len(errors) - n_grads} BatchNorm statistics within '
        f'{worst["stat"]:.3e} of max|ref| of the plain step, but for those '
        'held to the f64 step above')


@contextlib.contextmanager
def _deterministic_cudnn():
    '''cuDNN set deterministic (no benchmark search) inside the block and
    put back after: the one-step checks take no time measurement.'''
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def big_check_state(config, ds, seed, device):
    '''A unet_big engine with the initial weights of ``seed`` (no trained
    step, so no non-deterministic sum before the check), and one batch and
    its draws from a generator of ``seed``: the same inputs in every run.'''
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.data import augment

    eng = engine.Engine(config, seed=seed, device=device)
    eng._setup_training(ds)
    gen = torch.Generator(device=device).manual_seed(seed + 7)
    raw = eng.sample_batch(eng._resident(ds), TRAIN_BATCH, gen)
    draws = augment.draw_chain(ds.augment_methods, raw.shape, gen,
                               eng._warp_bank(ds))
    return eng, raw, draws


def step_digest(step):
    '''A digest of a step's loss, gradients and statistics (their bits):
    equal digests, the same step.'''
    digest = hashlib.sha256(np.float64(step[0]).tobytes())
    for part in step[1:]:
        for name in sorted(part):
            digest.update(part[name].detach().cpu().numpy().tobytes())
    return digest.hexdigest()[:16]


def check_big_step(eng, ds, raw, draws, modules=None, label='unet_big'):
    '''Phase 7's one-step check (``_compare_step``) with cuDNN
    deterministic; the kernel step is taken twice and must give the same
    bits (its digest printed, to compare across runs). ``modules``: the
    kernel modules the plain step swaps (``_big_step``).'''
    with _deterministic_cudnn():
        got = _big_step(eng, ds, raw, draws, plain=False, modules=modules)
        again = step_digest(_big_step(eng, ds, raw, draws, plain=False,
                                      modules=modules))
        log(f'one {label} train step on the seeded state: digest '
            f'{step_digest(got)}, again {again}')
        if again != step_digest(got):
            raise AssertionError('the one-step check is not deterministic')
        _compare_step(got, _big_step(eng, ds, raw, draws, plain=True,
                                     modules=modules),
                      lambda: _big_step(eng, ds, raw, draws, plain=True,
                                        f64=True, modules=modules), label)


def f64_step_shares(got, exact):
    '''(loss, {'grad': (share, name), 'stat': (share, name)}): how far a
    step (``_big_step``'s loss, gradients, statistics) is from the f64 step
    of the same weights, batch and draws, as a share of each value's scale:
    the loss's own; each gradient's max|f64| or its layer's weight (or
    BatchNorm scale, or for a BatchNorm without one its conv's weight)
    gradient's, whichever is larger (a BatchNorm bias whose output reaches
    the next BatchNorm through linear layers alone has an exact gradient of
    0); each running mean's its own or the root of its running variance's.
    The worst gradient and statistic.'''
    worst = {}
    for kind, ours, ref in (('grad', got[1], exact[1]),
                            ('stat', got[2], exact[2])):
        for name, want in ref.items():
            layer, leaf = name.rsplit('.', 1)
            conv = layer.rsplit('.', 1)[0] + '.conv.weight'
            peer = (ref.get(layer + '.weight', ref.get(
                layer + '.scale', ref.get(conv, want)))
                    if kind == 'grad' else ref[layer + '.var'].sqrt()
                    if leaf == 'mean' else want)
            scale = max(float(want.abs().max()), float(peer.abs().max()))
            share = float((ours[name].double() - want).abs().max()) / scale
            if share > worst.get(kind, (0.0, ''))[0]:
                worst[kind] = (share, name)
    return abs(got[0] - exact[0]) / abs(exact[0]), worst


def check_f64_step(eng, ds, raw, draws, modules, label):
    '''A step with no kernel but the bit-equal warp (MultiResUnet) against
    the f64 step of the same weights, batch and draws
    (``f64_step_shares``): the loss and every updated statistic within
    MRU_STAT_TOL of its scale, every gradient within MRU_F64_TOL.'''
    with _deterministic_cudnn():
        got = _big_step(eng, ds, raw, draws, plain=False, modules=modules)
        exact = _big_step(eng, ds, raw, draws, plain=True, f64=True,
                          modules=modules)
    loss_share, worst = f64_step_shares(got, exact)
    log(f'one {label} train step against the f64 step: loss {got[0]:.7f} '
        f'(f64 {exact[0]:.7f}, {loss_share:.3e}); worst gradient '
        f'{worst["grad"][0]:.3e} of its scale ({worst["grad"][1]}), worst '
        f'statistic {worst["stat"][0]:.3e} ({worst["stat"][1]}); tolerances '
        f'{MRU_F64_TOL} (gradients), {MRU_STAT_TOL} (loss, statistics)')
    if not (max(loss_share, worst['stat'][0]) <= MRU_STAT_TOL
            and worst['grad'][0] <= MRU_F64_TOL):
        raise AssertionError(f'{label}: the train step is further from the '
                             f'f64 step than its tolerances: loss '
                             f'{loss_share}, {worst}')


def model_eval(device, val_paths, run, step, label, size=SIZE):
    '''The evaluate CLI with metrics.yaml on ckpt-``step`` of ``run``
    (batch 64, the phase-4 records, the Visualizer with the casewise
    metrics): one results row with the loss and the 13 metrics, the CCA
    kernel at least once a batch, every region count equal to the plain
    CCA's; the input sensitivity of a batch through the model finite and
    normalized. Returns the launch counts of the evaluate call.'''
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.ops import kernels
    from dnncancerannotator_torch.runs.__main__ import main as cli
    from dnncancerannotator_torch.utils import config as config_lib
    from dnncancerannotator_torch.utils import viz

    tag = f'{EVAL_TAG}_{step}'
    kernels.reset_launches()
    torch.cuda.synchronize()
    start = time.perf_counter()
    cli(argv=['evaluate', '--save_path', run, '--data_path', *val_paths,
              '--tag', tag, '--config', os.path.join(REPO, METRICS_CONFIG),
              '--step_range', str(step), str(step), '--export_csv',
              '--export_casewise_metrics', '--device', device.type])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = kernels.launch_counts()
    n_slices = sum(N_EXAMS) * SLICES_PER_EXAM
    log(f'{label} evaluate ckpt-{step}: {n_slices} slices in {seconds:.3f} s '
        f'({n_slices / seconds:.2f} slices/s, host clock); launches '
        f'{launches}')
    out = os.path.join(run, 'tfevents', tag)
    table = _read_csv(os.path.join(out, 'results.csv'))
    header, rows = table[0], table[1:]
    if len(rows) != 1 or int(rows[0][0]) != step or len(header) != 2 + 13:
        raise AssertionError(f'results.csv: {header}, {rows}')
    casewise = _read_csv(os.path.join(out, 'casewise_results.csv'))
    (events,) = [os.path.join(out, f) for f in os.listdir(out)
                 if f.startswith('events')]
    if launches['cca'] < -(-n_slices // BATCH):
        raise AssertionError(f'cca launched {launches["cca"]} times')
    _check_region_counts(device, run, val_paths, header, rows, casewise,
                         _pr_curves(events)[1])

    config = config_lib.load_config(os.path.join(run, 'options.yaml'))[
        'config']
    eng = engine.Engine(config, seed=SEED, device=device)
    eng.build((BATCH, size, size, 5))
    eng.load(os.path.join(run, 'checkpoints', f'ckpt-{step}'))
    x = torch.rand((4, size, size, 5), device=device)
    with eng.scope():
        _, sens = viz.input_sensitivity(eng.model, x)
    log(f'{label} input sensitivity of 4 slices: {sens.cpu().numpy()}')
    if not (torch.isfinite(sens).all()
            and torch.allclose(sens.sum(1), torch.ones(4, device=device))):
        raise AssertionError(f'{label}: input sensitivity {sens}')
    return launches


def bn_train_slice(device, data_paths, spec, val_paths=None):
    '''Phase 7 (unet_big), 10 (MulmoUNet) or 11 (MultiResUnet), as
    ``spec`` (BIG_SPEC, MULMO_SPEC, MRU_SPEC) says: the train CLI for
    BIG_STEPS steps in chunks of BIG_SAVE_FREQ, a resume to BIG_STEPS +
    BIG_SAVE_FREQ, predict from the last checkpoint against a plain forward
    of its weights, the one-step check on a seeded state, the stack without
    pallas_decoder.yaml, with ``val_paths`` the evaluate CLI on the last
    checkpoint (``model_eval``), the train step's time and the throughput.
    Returns the launch counts of the first train call, of the predict call
    and of the evaluate call (None without ``val_paths``).'''
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.data import pipeline
    from dnncancerannotator_torch.ops import kernels
    from dnncancerannotator_torch.runs.__main__ import main as cli
    from dnncancerannotator_torch.utils import config as config_lib

    label, modules = spec['label'], spec['modules']()
    overlay = os.path.join(WORK, 'big_steps_per_call.json')
    with open(overlay, 'w') as fh:
        json.dump({'deploy_options.steps_per_call': BIG_SAVE_FREQ}, fh)
    save_path = os.path.join(WORK, spec['run'])
    ckpt_dir = os.path.join(save_path, 'checkpoints')

    def argv(configs, save, save_freq, steps):
        return ['train', '--config', *[os.path.join(REPO, c) for c in configs],
                overlay, '--save_path', save, '--data_path', *data_paths,
                '--save_freq', str(save_freq), '--seed', str(SEED),
                '--device', device.type, '--max_steps', str(steps)]

    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    start = time.perf_counter()
    res = cli(argv=argv(spec['configs'], save_path, BIG_SAVE_FREQ, BIG_STEPS))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = kernels.launch_counts()
    losses = res.history['loss']
    log(f'{label} train: {BIG_STEPS} steps of B={TRAIN_BATCH} in '
        f'{seconds:.3f} s (host clock; bank solve, data load and checkpoints '
        f'included); loss {losses[0]:.4f} -> {losses[-1]:.4f}; peak device '
        f'memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    log(f'launches during {label} train: {launches}')
    if res.epoch != list(range(1, BIG_STEPS + 1)) or \
            not np.isfinite(losses).all():
        raise AssertionError(f'train steps {res.epoch}, losses {losses}')
    for name, sites in spec['sites'].items():
        if launches[name] < sites * BIG_STEPS:
            raise AssertionError(f'{name} launched {launches[name]} times, '
                                 f'want >= {sites} x {BIG_STEPS}')
    ran = [name for name in spec.get('zero', ()) if launches[name]]
    if ran:
        raise AssertionError(f'{label}: {ran} launched')
    for step in range(BIG_SAVE_FREQ, BIG_STEPS + 1, BIG_SAVE_FREQ):
        path = os.path.join(ckpt_dir, f'ckpt-{step}')
        if any('/batch_stats/' in k for k in engine.read_ckpt(path)):
            raise AssertionError('optimizer state for batch_stats')
        stats = _batch_stats(path)
        still = [k for k, v in stats.items()
                 if np.array_equal(v, np.full_like(v, k.endswith('/var')))]
        if len(stats) != spec['n_stats'] or still:
            raise AssertionError(f'ckpt-{step}: {len(stats)} batch_stats, '
                                 f'unmoved {still}')
    last = BIG_STEPS + BIG_SAVE_FREQ
    res = cli(argv=argv(spec['configs'], save_path, BIG_SAVE_FREQ, last))
    if res.epoch != list(range(BIG_STEPS + 1, last + 1)):
        raise AssertionError(f'the second train call ran steps {res.epoch}')
    before, after = (_batch_stats(os.path.join(ckpt_dir, f'ckpt-{s}'))
                     for s in (BIG_STEPS, last))
    moved = sum(not np.array_equal(before[k], after[k]) for k in before)
    log(f'{label} train resumed at step {BIG_STEPS}: steps {res.epoch[0]}-'
        f'{res.epoch[-1]}, loss {res.history["loss"][-1]:.4f}; '
        f'{len(before)} batch_stats in each checkpoint, {moved} moved from '
        f'ckpt-{BIG_STEPS} to ckpt-{last}')
    if moved != len(before):
        raise AssertionError('batch_stats did not move after the resume')

    # predict from the last checkpoint against the plain forward in eval
    # mode
    config = config_lib.load_config(
        os.path.join(save_path, 'options.yaml'))['config']
    eng = engine.Engine(config, seed=SEED, device=device)
    ds = pipeline.train_ds(data_paths, **config['data_options']['train'])
    eng._setup_training(ds)
    eng.load(os.path.join(ckpt_dir, f'ckpt-{last}'))
    out_dir = os.path.join(WORK, spec['run'] + '_maps')
    kernels.reset_launches()
    count = cli(argv=['predict', '--save_path', save_path, '--data_path',
                      *data_paths, '--output_path', out_dir, '--batch_size',
                      str(BATCH), '--output_format', 'npy', '--device',
                      device.type])
    predict_launches = kernels.launch_counts()
    log(f'predict from {label} ckpt-{last}: {count} maps; launches '
        f'{predict_launches}')
    for name, sites in spec['predict_sites'].items():
        if predict_launches[name] < sites:
            raise AssertionError(f'predict launched {name} '
                                 f'{predict_launches[name]} times, want >= '
                                 f'{sites}')
    ran = [name for name in spec.get('zero', ()) if predict_launches[name]]
    if ran:
        raise AssertionError(f'predict from {label}: {ran} launched')

    def reference(x):
        with _plain_versions(*modules[:-1]), eng.scope():
            return eng.model(x)

    def exact(x):
        # the kernels take f32 only: in f64 the plain versions run
        try:
            eng.model.double()
            return reference(x.double())
        finally:
            eng.model.float()

    # in bf16 the model's double() still computes in bf16: no f64 forward
    _check_maps(eng.model, data_paths, out_dir,
                sum(TRAIN_EXAMS) * TRAIN_SLICES, reference,
                None if spec.get('bf16_step') else exact)

    # one step: the kernels against a plain step, same batch and draws, on
    # a seeded state (the trained steps above differ run to run)
    if spec.get('bf16_step'):
        raw = check_bf16_step(config, ds, device, label)
    else:
        check_eng, raw, draws = big_check_state(config, ds, SEED, device)
        if spec['f64_step']:
            check_f64_step(check_eng, ds, raw, draws, modules, label)
        else:
            check_big_step(check_eng, ds, raw, draws, modules, label)
        del check_eng

    # the stack without pallas_decoder.yaml: the NHWC kernels stay off
    if spec['gated']:
        kernels.reset_launches()
        cli(argv=argv(spec['configs'][:-1],
                      os.path.join(WORK, spec['run'] + '_off'), 2, 2))
        off = kernels.launch_counts()
        log(f'{label} without pallas_decoder.yaml, 2 steps: launches {off}')
        kept = {n: s for n, s in spec['sites'].items()
                if n not in NHWC_KERNELS}
        if any(off[name] for name in NHWC_KERNELS) or any(
                off[name] < 2 * sites for name, sites in kept.items()):
            raise AssertionError('a gate that is off launched a kernel, or '
                                 'a kernel of the path did not run')

    eval_launches = (model_eval(device, val_paths, save_path, last, label)
                     if val_paths else None)

    # the train step's time, kernels vs plain (the trained engine)
    gen = torch.Generator(device=device).manual_seed(SEED + 8)

    def plain_step():
        with _plain_versions(*modules):
            eng.train_step(raw, last, gen)

    ms, plain_ms = _time_pair(lambda: eng.train_step(raw, last, gen),
                              plain_step)
    log(f'{label} train step B={TRAIN_BATCH}: kernels {ms:.4f} ms  plain '
        f'{plain_ms:.4f} ms (CUDA events, median of {TIMED_RUNS})')

    _DEFERRED.append(lambda: _profile_steps(
        f'{label} train step', lambda: eng.train_step(raw, last, gen)))

    _throughput(eng, ds, label)
    return launches, predict_launches, eval_launches


def _warp_module():
    from dnncancerannotator_torch.ops.kernels import warp_twopass as WT
    return WT


def _mulmo_modules():
    from dnncancerannotator_torch.ops.kernels import stencil_conv_nhwc as SN
    return (*_nhwc_modules(), SN, _warp_module())


# phases 7, 10 and 11 (bn_train_slice): the stack, each kernel's sites a
# step (launches >= sites x steps) and in a predict call, the BatchNorm
# statistics of a checkpoint, the kernel modules the plain step swaps (the
# warp last; the plain forward swaps the others), whether the stack ends
# with pallas_decoder.yaml, and whether the one-step check is against the
# f64 step alone
BIG_SPEC = dict(
    label='unet_big', configs=BIG_CONFIGS, run='big_run',
    sites={**{name: 3 for name in NHWC_KERNELS}, 'warp_twopass': 1},
    predict_sites={'pool2x2_nhwc': 3, 'tconv2x2_nhwc': 3},
    # mean and var of 24 BatchNorms: 4 levels x (bn_0, bn_1 and pool_bn
    # down, tconv_bn, bn_0 and bn_1 up)
    n_stats=2 * 4 * 6,
    modules=lambda: (*_nhwc_modules(), _warp_module()), gated=True,
    f64_step=False)
MULMO_SPEC = dict(
    label='MulmoUNet', configs=MULMO_CONFIGS, run='mulmo_run',
    sites={'stencil_conv_nhwc': len(MULMO_STENCIL_SITES),
           'pool2x2_nhwc': len(MULMO_POOL_SITES),
           'pool2x2_nhwc_bwd': len(MULMO_POOL_SITES), 'tconv2x2_nhwc': 1,
           'tconv2x2_nhwc_bwd': 1, 'warp_twopass': 1},
    predict_sites={'stencil_conv_nhwc': len(MULMO_STENCIL_SITES),
                   'pool2x2_nhwc': len(MULMO_POOL_SITES), 'tconv2x2_nhwc': 1},
    # 5 encoders x 4 levels x (bn_0, bn_1, pool_bn) and 4 decoder levels x
    # (tconv_bn, bn_0, bn_1): 72 BatchNorms
    n_stats=2 * (5 * 4 * 3 + 4 * 3), modules=_mulmo_modules, gated=True,
    f64_step=False)
MRU_SPEC = dict(
    label='MultiResUnet', configs=MRU_CONFIGS, run='mru_run',
    sites={'warp_twopass': 1}, predict_sites={},
    # 9 MultiResBlocks x 6, ResPaths of 4 + 3 + 2 + 1 steps x 3, head_bn
    n_stats=2 * (9 * 6 + 10 * 3 + 1), modules=lambda: (_warp_module(),),
    gated=False, f64_step=True)


# -- phases 12 and 12b ---------------------------------------------------------
# unet_big as shipped, in bf16, with the NHWC gates asked for (they stay off
# for bf16 levels, as the JAX gates do): bf16.yaml last, after
# deploy_options.yaml
BF16_BIG_CONFIGS = BIG_CONFIGS[:3] + ('configs/additionals/pallas_decoder.yaml',
                                      BF16)
# unet_big's seeded bf16 step against the f64 step of the same weights,
# batch and draws (f64_step_shares): the loss within BF16_LOSS_TOL of its
# value, every updated statistic within BF16_STAT_TOL and every gradient
# within BF16_F64_TOL of its scale. Read on an NVIDIA H100 80GB HBM3 at
# 700 W over seeds 0-2 and the three bf16 overlays
# (tools/check_torch_bf16_step.py): the sound step's loss 3.6e-6-1.9e-3,
# worst statistic 4.3e-5-9.6e-5, worst gradient 0.25-0.73 (a BatchNorm
# network's gradients in bf16); a broken control, the same step with
# models/fastbn.py's ``wide`` the identity (the BatchNorm statistics, its
# backward's sums and the logits left in bf16), reads 3.2e-4-4.6e-4 at
# its worst statistic, so BF16_STAT_TOL lies between the two and the check
# requires the control to fail it; the control's loss (3.6e-5-1.9e-2) and
# gradients (0.27-1.42) overlap the sound step's, so those limits are set
# at about twice the sound step's worst reading, against gross faults
BF16_LOSS_TOL = 5e-3
BF16_STAT_TOL = 1.75e-4
BF16_F64_TOL = 1.5
# bf16 is really on: the step's worst gradient at least this share of its
# scale away from the f32 step of the same weights, batch and draws (0.25-
# 0.73 read; a step that quietly computes in f32 reads 0, cuDNN
# deterministic)
BF16_ON_SHARE = 1e-2
# phase 12b: a step through the bf16 kernel forms against the plain bf16
# step, by tests/test_torch_bf16.py's rule: each value within BF16_STEP_TOL
# of its scale, else no further from the f64 step than F64_RATIO times the
# plain step by root-mean-square distance
BF16_STEP_TOL = 2e-2
BF16_SLICE_STEPS = 4
BF16_BIG_SPEC = dict(
    label='unet_big bf16', configs=BF16_BIG_CONFIGS, run='big16_run',
    sites={'warp_twopass': 1}, zero=NHWC_KERNELS, predict_sites={},
    n_stats=2 * 4 * 6, modules=lambda: (_warp_module(),), gated=False,
    f64_step=False, bf16_step=True)


def _unset_precision(config):
    out = copy.deepcopy(config)
    out['deploy_options'].pop('precision', None)
    return out


def dtype_census(model, x):
    '''{module path: output dtype} of every conv, transposed conv and
    BatchNorm of ``model`` in one train-mode forward of ``x``.'''
    from dnncancerannotator_torch.models import fastbn, fastconv
    kinds = (fastconv.Conv2DFast, fastconv.ConvTranspose2DFast,
             fastbn.BatchNormFast)
    seen = {}
    hooks = [mod.register_forward_hook(
        lambda m, args, out, path=path: seen.__setitem__(path, out.dtype))
        for path, mod in model.named_modules() if isinstance(mod, kinds)]
    try:
        model.train()
        with torch.no_grad():
            logits = model(x, return_logits=True)
    finally:
        for hook in hooks:
            hook.remove()
    seen['logits'] = logits.dtype
    return seen


def check_census(label, model, x, options):
    '''The dtype census of a bf16 UNetAnnotator is the JAX model's
    (tests/test_torch_bf16.py holds the two against each other): bf16 but
    the f32 logits, the head under f32_head, and under f32_level0 down_0
    and the last Upsample.'''
    census = dtype_census(model, x)
    last_up = f'unet.decoder.up_{options["n_downsample"] - 1}.'
    want = {}
    for path in census:
        f32 = (path == 'logits'
               or (options.get('f32_head') and path == 'last_conv')
               or (options.get('f32_level0') and path.startswith(
                   ('unet.encoder.down_0.', last_up))))
        want[path] = torch.float32 if f32 else torch.bfloat16
    wrong = {p: str(d) for p, d in census.items() if d != want[p]}
    n32 = sum(d == torch.float32 for d in census.values())
    log(f'{label} dtype census: {len(census)} outputs, {n32} in f32')
    if wrong:
        raise AssertionError(f'{label}: dtypes unlike the JAX model\'s: '
                             f'{wrong}')


def bf16_step(config, ds, device, seed=SEED, control=False):
    '''(bf16 step, f32 step, f64 step, control step or None, the bf16
    engine, the batch) of unet_big (the steps ``_big_step``'s) on the
    seeded state of ``seed``: the f32 and f64 steps on an f32 engine of the
    same weights, batch and draws; the control, the bf16 step with
    ``fastbn.wide`` the identity; cuDNN deterministic.'''
    from dnncancerannotator_torch.models import fastbn
    eng, raw, draws = big_check_state(config, ds, seed, device)
    eng32, raw32, _ = big_check_state(_unset_precision(config), ds, seed,
                                      device)
    state, state32 = eng.model.state_dict(), eng32.model.state_dict()
    if not torch.equal(raw, raw32) or any(
            not torch.equal(v, state32[k]) for k, v in state.items()):
        raise AssertionError('the bf16 and f32 engines start apart')
    modules = (_warp_module(),)
    with _deterministic_cudnn():
        got = _big_step(eng, ds, raw, draws, plain=False, modules=modules)
        f32 = _big_step(eng32, ds, raw, draws, plain=False, modules=modules)
        exact = _big_step(eng32, ds, raw, draws, plain=True, f64=True,
                          modules=modules)
        ctl = None
        if control:
            wide = fastbn.wide
            fastbn.wide = lambda t: t
            try:
                ctl = _big_step(eng, ds, raw, draws, plain=False,
                                modules=modules)
            finally:
                fastbn.wide = wide
    return got, f32, exact, ctl, eng, raw


def grad_rms_share(step, exact):
    '''The root-mean-square distance of all a step's parameter gradients
    from the f64 step's, over the f64 gradients' root mean square.'''
    diff = sum(float((step[1][n].double() - g).pow(2).sum())
               for n, g in exact[1].items())
    norm = sum(float(g.pow(2).sum()) for g in exact[1].values())
    return (diff / norm) ** 0.5


def _reading(label, step, exact):
    loss, worst = f64_step_shares(step, exact)
    log(f'  {label}: loss {step[0]:.7f} ({loss:.3e} from f64), worst '
        f'gradient {worst["grad"][0]:.3e} ({worst["grad"][1]}), worst '
        f'statistic {worst["stat"][0]:.3e} ({worst["stat"][1]})')
    return (loss <= BF16_LOSS_TOL and worst['stat'][0] <= BF16_STAT_TOL
            and worst['grad'][0] <= BF16_F64_TOL)


def check_bf16_step(config, ds, device, label):
    '''Phase 12's one-step checks on the seeded state: the bf16 step within
    BF16_LOSS_TOL / BF16_STAT_TOL / BF16_F64_TOL of the f64 step, the
    broken control past them, the step at least BF16_ON_SHARE from the f32 step, and the dtype
    census. Returns the seeded batch.'''
    got, f32, exact, ctl, eng, raw = bf16_step(config, ds, device,
                                              control=True)
    log(f'one {label} train step on the seeded state against the f64 step '
        f'(limits: loss {BF16_LOSS_TOL}, statistics {BF16_STAT_TOL}, '
        f'gradients {BF16_F64_TOL}):')
    sound = _reading('bf16 step', got, exact)
    _reading('f32 step', f32, exact)
    broken = _reading('control (fastbn.wide the identity)', ctl, exact)
    _, on = f64_step_shares(got, f32)
    log(f'  bf16 step from the f32 step: worst gradient {on["grad"][0]:.3e} '
        f'({on["grad"][1]}); bf16 is on at >= {BF16_ON_SHARE}')
    if not sound:
        raise AssertionError(f'{label}: the bf16 step is further from the '
                             'f64 step than its limits')
    if broken:
        raise AssertionError(f'{label}: the broken control passes the limits')
    if not on['grad'][0] >= BF16_ON_SHARE:
        raise AssertionError(f'{label}: the step is the f32 step: bf16 is off')
    check_census(label, eng.model, raw.float()[..., :5] / 255.0,
                 config['model_options'])
    return raw


def _throughput(eng, ds, label):
    '''Train throughput from calls that differ only in step count
    (BIG_THROUGHPUT), each the minimum of two, after a warm-up call.'''
    short, long = BIG_THROUGHPUT
    eng.train(ds, max_steps=eng.current_step + 5, save_freq=1 << 30)
    times = {}
    for n in (short, long):
        for _ in range(2):
            torch.cuda.synchronize()
            start = time.perf_counter()
            eng.train(ds, max_steps=eng.current_step + n, save_freq=1 << 30)
            torch.cuda.synchronize()
            times.setdefault(n, []).append(time.perf_counter() - start)
    rate = (long - short) * TRAIN_BATCH / (min(times[long]) -
                                           min(times[short]))
    log(f'{label} train throughput: {rate:.2f} slices/s ({short}-step calls '
        f'{times[short]} s, {long}-step calls {times[long]} s; '
        f'steps_per_call {eng.steps_per_call})')
    return rate


def bf16_policy(device, data_paths, overlay):
    '''unet_big bf16 under a policy's overlay (after bf16.yaml): the dtype
    census, the seeded step against the f64 step (logged, held to phase
    12's limits), the train step's time and the throughput.'''
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.data import pipeline
    config = _config(BF16_BIG_CONFIGS + (overlay,))
    label = 'unet_big ' + os.path.basename(overlay)[:-5]
    ds = pipeline.train_ds(data_paths, **config['data_options']['train'])
    got, _, exact, _, check_eng, raw = bf16_step(config, ds, device)
    log(f'one {label} train step on the seeded state against the f64 step:')
    if not _reading(label, got, exact):
        raise AssertionError(f'{label}: the step is further from the f64 '
                             'step than phase 12\'s limits')
    check_census(label, check_eng.model, raw.float()[..., :5] / 255.0,
                 config['model_options'])
    del check_eng
    eng = engine.Engine(config, seed=SEED, device=device)
    eng._setup_training(ds)
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    ms = _time_fns({'step': lambda: eng.train_step(raw, 1, gen)})['step']
    log(f'{label} train step B={TRAIN_BATCH}: {ms:.4f} ms (CUDA events, '
        f'median of {TIMED_RUNS})')
    _DEFERRED.append(lambda: _profile_steps(
        f'{label} train step', lambda: eng.train_step(raw, 1, gen)))
    _throughput(eng, ds, label)


def _plain_chain(x, w1, b1, w2, b2, need_c1=False, need_c2f=False):
    '''conv_chain's plain version with its wrapper's outputs: c2 in x's
    dtype, c1 and the f32 c2 where asked for.'''
    from dnncancerannotator_torch.ops.kernels import conv_chain as CC
    c1, c2f = CC.plain(x, w1, b1, w2, b2)
    out = (c1 if need_c1 else None, c2f.to(x.dtype))
    return out + (c2f,) if need_c2f else out


def _unet_modules():
    from dnncancerannotator_torch.ops.kernels import (
        conv_chain, conv_chain_bwd, stencil_conv, stencil_conv_bwd, tconv2x2,
        tconv2x2_bwd)
    return (conv_chain, conv_chain_bwd, stencil_conv, stencil_conv_bwd,
            tconv2x2, tconv2x2_bwd, _warp_module())


# phase 12b: each stack with bf16.yaml, the bf16 forms' launches a step
# (and the f32 forms' and the f32-only kernels', none), and the kernel
# modules the plain step swaps
BF16_SLICES = (
    dict(label='unet.yaml bf16', configs=CONFIGS + (BF16,), run='unet16_run',
         sites={'conv_chain_bf16': len(BF16_CHAIN_SITES),
                'conv_chain_bwd_bf16': len(BF16_CHAIN_SITES),
                'stencil_conv_bf16': len(BF16_STENCIL_SITES),
                'stencil_conv_bwd_bf16': len(BF16_STENCIL_SITES),
                'stencil_conv_tile_bf16': 1,   # down_2.conv_0
                'warp_twopass': 1},
         zero=('conv_chain', 'conv_chain_bwd', 'stencil_conv',
               'stencil_conv_bwd', 'tconv2x2', 'tconv2x2_bwd'),
         modules=_unet_modules),
    dict(label='MulmoUNet bf16', configs=MULMO_CONFIGS + (BF16,),
         run='mulmo16_run',
         sites={'stencil_conv_nhwc_bf16': len(MULMO_STENCIL_SITES),
                'warp_twopass': 1},
         zero=('stencil_conv_nhwc',) + NHWC_KERNELS, modules=_mulmo_modules),
)


def _compare_bf16_step(label, got, plain, exact):
    '''The loss, every gradient and every statistic of a step through the
    bf16 forms against the plain bf16 step: within BF16_STEP_TOL of its
    scale (a bias is held on its layer's weight gradient's), else no
    further from the f64 step than F64_RATIO times the plain step by
    root-mean-square distance.'''
    def rms(a, b):
        return float((torch.as_tensor(a).double()
                      - torch.as_tensor(b).double()).pow(2).mean().sqrt())

    items = [('loss', got[0], plain[0], exact[0], abs(plain[0]))]
    for part in (1, 2):
        for name, want in plain[part].items():
            layer = name.rsplit('.', 1)[0]
            scale = max(float(want.abs().max()), float(
                plain[part].get(layer + '.weight', want).abs().max()))
            items.append((name, got[part][name], want, exact[part][name],
                          scale))
    held, worst = [], 0.0
    for name, ours, want, ref, scale in items:
        err = float((torch.as_tensor(ours).double()
                     - torch.as_tensor(want).double()).abs().max())
        if err <= BF16_STEP_TOL * scale:
            worst = max(worst, err / scale) if scale else worst
            continue
        held.append(name)
        mine, theirs = rms(ours, ref), rms(want, ref)
        log(f'  {name}: {err:.3e} > {BF16_STEP_TOL} * {scale:.3e} from the '
            f'plain step; from the f64 step (rms): kernels {mine:.3e}, '
            f'plain {theirs:.3e}')
        if not mine <= F64_RATIO * theirs:
            raise AssertionError(f'{label}: {name} through the bf16 forms is '
                                 f'{mine} from the f64 step against the '
                                 f'plain step\'s {theirs}')
    log(f'one {label} step: {len(items) - len(held)} values within '
        f'{worst:.3e} of their scale of the plain bf16 step, {len(held)} '
        'held to the f64 step above')


def bf16_slices(device, data_paths):
    '''Phase 12b: each BF16_SLICES stack trains BF16_SLICE_STEPS steps
    through the CLI (every loss finite; each bf16 form launched at least
    its sites x steps times, the f32 forms and the f32-only kernels never),
    then one seeded step through the kernels against the plain bf16 step
    (``_compare_bf16_step``). Returns the launch counts of the train calls
    (the bf16 forms' from their stack).'''
    from dnncancerannotator_torch.data import pipeline
    from dnncancerannotator_torch.ops import kernels
    from dnncancerannotator_torch.runs.__main__ import main as cli

    counts = {}
    for spec in BF16_SLICES:
        label = spec['label']
        kernels.reset_launches()
        res = cli(argv=[
            'train', '--config', *[os.path.join(REPO, c)
                                   for c in spec['configs']],
            '--save_path', os.path.join(WORK, spec['run']), '--data_path',
            *data_paths, '--save_freq', str(BF16_SLICE_STEPS), '--seed',
            str(SEED), '--device', device.type, '--max_steps',
            str(BF16_SLICE_STEPS)])
        launches = kernels.launch_counts()
        log(f'{label} train, {BF16_SLICE_STEPS} steps: loss '
            f'{res.history["loss"]}; launches {launches}')
        if not np.isfinite(res.history['loss']).all():
            raise AssertionError(f'{label}: losses {res.history["loss"]}')
        for name, sites in spec['sites'].items():
            if launches[name] < sites * BF16_SLICE_STEPS:
                raise AssertionError(f'{name} launched {launches[name]} '
                                     f'times, want >= {sites} x '
                                     f'{BF16_SLICE_STEPS}')
        ran = [n for n in spec['zero'] if launches[n]]
        if ran:
            raise AssertionError(f'{label}: {ran} launched in bf16')
        counts.update({n: launches[n] for n in spec['sites']
                       if n.endswith('_bf16')})

        config = _config(spec['configs'])
        ds = pipeline.train_ds(data_paths, **config['data_options']['train'])
        eng, raw, draws = big_check_state(config, ds, SEED, device)
        eng32, _, _ = big_check_state(_unset_precision(config), ds, SEED,
                                      device)
        modules = spec['modules']()
        with _deterministic_cudnn():
            got = _big_step(eng, ds, raw, draws, plain=False, modules=modules)
            plain = _big_step(eng, ds, raw, draws, plain=True,
                              modules=modules)
            exact = _big_step(eng32, ds, raw, draws, plain=True, f64=True,
                              modules=modules)
        _compare_bf16_step(label, got, plain, exact)
    return counts

# -- phase 3f ----------------------------------------------------------------
def crop_inputs(device):
    '''(image, off, [(d, label, fy_ext, fx)]): the fused chain's warp_crop
    inputs, [8, 268, 268, 6] windows cropped to 256 x 256 at offsets 0, in
    - out and mirrored ones (w_in - w_out - ox), at d = 8 and 18: the flows
    of a real per-step solve and a random flow past +-d.'''
    from dnncancerannotator_torch.data import augment
    from dnncancerannotator_torch.ops import warp

    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    b, span = TRAIN_BATCH, CROP_IN - SIZE
    image = torch.rand((b, CROP_IN, CROP_IN, 6), generator=gen, device=device)
    oy = (0, span, 6, 3, span, 0, 9, 6)
    ox = (0, span, span - 6, span - 2, 0, span, span - 9, 6)
    off = torch.tensor(list(zip(oy, ox)), dtype=torch.int32, device=device)
    sites = []
    for opts in CROP_WARPS:
        d = augment._max_displacement(opts['max_diff'])
        src, dst = augment.draw_warp(gen, b, SIZE, **opts)
        flows = {
            'per-step solve': warp.cropped_twopass_flows(
                src, dst, off, (CROP_IN, CROP_IN), (SIZE, SIZE),
                max_displacement=d),
            'random flow past +-d': tuple(torch.randn(
                shape, generator=gen, device=device) * 1.5 * d
                for shape in ((b, SIZE, CROP_IN), (b, SIZE, SIZE))),
        }
        sites.extend((d, label, fy.contiguous(), fx.contiguous())
                     for label, (fy, fx) in flows.items())
    return image, off, sites


@torch.no_grad()
def crop_kernel_sites(device, results):
    '''The crop-fused warp kernel against its plain version at
    ``crop_inputs``' sites, exactly equal, on the tile route, one launch a
    call.'''
    from dnncancerannotator_torch.ops.kernels import warp_crop as WC

    image, off, sites = crop_inputs(device)
    log(f'crop-fused warp (B={TRAIN_BATCH}, {CROP_IN}x{CROP_IN}x6 -> '
        f'{SIZE}x{SIZE}, offsets {off.tolist()}):')
    for d, label, fy, fx in sites:
        name = f'warp_crop d={d:2d} {label}'
        route = WC.route(TRAIN_BATCH, SIZE, SIZE, 6, d)
        got = WC.warp_crop(image, fy, fx, off, d)
        want = WC.plain(image, fy, fx, off, d)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        log(f'  {name:36s} route {route} max|diff| {err:.3e}  max|ref| '
            f'{float(want.abs().max()):.3e}')
        if not torch.equal(got, want):   # same rounded operations: exact
            raise AssertionError(f'{name} differs from its plain version by '
                                 f'{err}')
        if route != 'tile':
            raise AssertionError(f'{name}: the main path\'s shape takes the '
                                 f'{route} route')
        times = _time_site(lambda: WC.warp_crop(image, fy, fx, off, d),
                           lambda: WC.plain(image, fy, fx, off, d))
        _DEFERRED.append(functools.partial(
            _launch_split, name,
            functools.partial(WC.warp_crop, image, fy, fx, off, d),
            WARP_LAUNCHES))
        # reads the crop region (as large as the output) and the flows,
        # writes the output; about 12 operations an output value
        record(results, 'warp_crop', err, times,
               bound(2 * nbytes(got) + nbytes(fy, fx, off),
                     12 * got.numel()))


# -- phase 8 -----------------------------------------------------------------
def smooth_batch(b, size, c, seed):
    '''[b, size, size, c] f32 Gaussian blobs in [0, 1] (the batch of
    tools/chip_fusedaug_parity.py): the fused and composed routes differ by
    where their coarse flow grids fall, so they are compared on smooth
    content.'''
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    imgs = np.zeros((b, size, size, c), np.float32)
    for i in range(b):
        for _ in range(6):
            cy, cx = rng.uniform(10, size - 10, 2)
            imgs[i, ..., rng.integers(0, c)] += np.exp(
                -(((yy - cy) ** 2 + (xx - cx) ** 2) / (0.02 * size * size))
            ).astype(np.float32)
    return np.clip(imgs, 0, 1)


def _phi(r2):
    return 0.5 * r2 * np.log(np.maximum(r2, 1e-10))


def _spline(q, tp, vals):
    '''The thin-plate spline through (tp, vals) at q, in f64.'''
    n = tp.shape[0]
    a = _phi(((tp[:, None, :] - tp[None, :, :]) ** 2).sum(-1))
    bm = np.concatenate([np.ones((n, 1)), tp], axis=1)
    sol = np.linalg.solve(np.block([[a, bm], [bm.T, np.zeros((3, 3))]]),
                          np.concatenate([vals, np.zeros((3, 2))], axis=0))
    d2 = ((q[:, None, :] - tp[None, :, :]) ** 2).sum(-1)
    return _phi(d2) @ sol[:n] + np.concatenate(
        [np.ones((q.shape[0], 1)), q], axis=1) @ sol[n:]


def _resample(img, q, axis):
    '''Bilinear resample of [h, w, c] along ``axis`` at positions q [h, w]
    (clipped to the image), taps clamped to the edge.'''
    n = img.shape[axis]
    q0 = np.floor(q).astype(int)
    r = (q - q0)[..., None]
    rows, cols = np.mgrid[:img.shape[0], :img.shape[1]]
    lo = np.clip(q0, 0, n - 1)
    hi = np.clip(q0 + 1, 0, n - 1)
    if axis == 0:
        return img[lo, cols] * (1.0 - r) + img[hi, cols] * r
    return img[rows, lo] * (1.0 - r) + img[rows, hi] * r


def oracle_chain(images, off, flip, factors, src, dst, out_size, tmask,
                 max_diff):
    '''The fused chain in f64 with the spline evaluated at every output
    pixel (no coarse grid): crop, flip, contrast on the crop's mean, the
    clamped flow with fy at the source column, the two-pass resample (a
    copy of tools/chip_fusedaug_parity.py:oracle_chain, which imports
    JAX).'''
    th, tw = out_size
    d = float(int(np.ceil(max_diff)) + 3)
    scale = 1.0 / float(max(th, tw))
    gy, gx = np.mgrid[:th, :tw].astype(np.float64)
    out = np.empty((images.shape[0], th, tw, images.shape[-1]))
    for i in range(images.shape[0]):
        oy, ox = int(off[i, 0]), int(off[i, 1])
        win = images[i, oy:oy + th, ox:ox + tw].astype(np.float64)
        if flip[i]:
            win = win[:, ::-1]
        m = win.mean(axis=(0, 1))
        win = np.where(tmask[None, None, :], (win - m) * float(factors[i]) + m,
                       win)
        tp = dst[i].astype(np.float64) * scale
        vals = (dst[i] - src[i]).astype(np.float64)
        q = np.stack([gy.ravel(), gx.ravel()], axis=-1) * scale
        fl = np.clip(_spline(q, tp, vals).reshape(th, tw, 2), -d, d)
        q2 = np.stack([gy.ravel(), (gx + fl[..., 1]).ravel()], axis=-1) * scale
        fy = np.clip(_spline(q2, tp, vals)[:, 0].reshape(th, tw), -d, d)
        qy = np.clip(gy - fy, 0.0, th - 1.0)
        qx = np.clip(gx - fl[..., 1], 0.0, tw - 1.0)
        out[i] = _resample(_resample(win, qy, 0), qx, 1)
    return out


def _routes(augment, methods, images, draws):
    '''(fused, composed per-step) outputs of one batch and draw list, and
    the launches of the two resample kernels.'''
    from dnncancerannotator_torch.ops import kernels
    kernels.reset_launches()
    fused = augment.apply_fused_chain(methods, images, draws)
    composed = augment.apply_chain(methods, images, draws)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if (counts['warp_crop'], counts['warp_twopass']) != (1, 1):
        raise AssertionError(f'the two routes launched {counts}')
    return fused, composed


def fused_aug_slice(device, data_paths):
    '''Phase 8; returns the launch counts of the fused train call.'''
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.data import augment, pipeline
    from dnncancerannotator_torch.ops import gates, kernels
    from dnncancerannotator_torch.runs.__main__ import main as cli
    from dnncancerannotator_torch.utils import config as config_lib

    def overlay(name, options):
        path = os.path.join(WORK, f'{name}.json')
        with open(path, 'w') as fh:
            json.dump({'deploy_options.steps_per_call': STEPS_PER_CALL,
                       **options}, fh)
        return path

    solved = []
    build_bank = augment.build_warp_bank

    def counted_bank(*args, **kwargs):
        solved.append(args[1])
        return build_bank(*args, **kwargs)

    def train(name, configs, steps):
        '''One train CLI call: (history, launches, banks solved).'''
        solved.clear()
        kernels.reset_launches()
        torch.cuda.synchronize()
        start = time.perf_counter()
        res = cli(argv=['train', '--config', *configs, '--save_path',
                        os.path.join(WORK, name), '--data_path', *data_paths,
                        '--save_freq', str(min(steps, SAVE_FREQ)), '--seed',
                        str(SEED), '--device', device.type, '--max_steps',
                        str(steps)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = kernels.launch_counts()
        losses = res.history['loss']
        log(f'train {name}: {steps} steps in {seconds:.3f} s (host clock, '
            f'data load and checkpoints included); loss {losses[0]:.4f} -> '
            f'{losses[-1]:.4f}; banks solved {solved}; warp_crop '
            f'{launches["warp_crop"]}, warp_twopass '
            f'{launches["warp_twopass"]} launches')
        if res.epoch != list(range(1, steps + 1)) or \
                not np.isfinite(losses).all():
            raise AssertionError(f'{name}: steps {res.epoch}, losses {losses}')
        return launches, list(solved)

    base = [os.path.join(REPO, c) for c in CONFIGS]
    fused_configs = base + [overlay('fused', {'deploy_options.fused_aug':
                                              True})]
    augment.build_warp_bank = counted_bank
    try:
        launches, banks = train('fused_run', fused_configs, FUSED_STEPS)
        if (launches['warp_crop'], launches['warp_twopass'], banks) != (
                FUSED_STEPS, 0, []):
            raise AssertionError('the fused train run did not launch '
                                 'warp_crop once a step, and only it, or '
                                 'solved a bank')
        step_launches, banks = train(
            'per_step_run', base + [overlay('per_step', {
                'deploy_options.warp_bank': False})], ROUTE_STEPS)
        if (step_launches['warp_crop'], step_launches['warp_twopass'],
                banks) != (0, ROUTE_STEPS, []):
            raise AssertionError('the per-step train run did not launch '
                                 'warp_twopass once a step')
        intra_launches, banks = train(
            'intra_run', base + [os.path.join(REPO, INTRA_CONFIG),
                                 overlay('intra', {})], ROUTE_STEPS)
        if (intra_launches['warp_crop'], intra_launches['warp_twopass'],
                len(banks)) != (0, ROUTE_STEPS, 1):
            raise AssertionError('the intra-channel train run did not take '
                                 'the banked warp once a step')
    finally:
        augment.build_warp_bank = build_bank

    # the two routes on one batch and one draw list
    config = config_lib.load_config(fused_configs)
    ds = pipeline.train_ds(data_paths, **config['data_options']['train'])
    methods = ds.augment_methods
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    images = torch.from_numpy(smooth_batch(
        TRAIN_BATCH, CROP_IN, 6, SEED)).to(device)
    fused, composed = _routes(augment, methods, images, augment.draw_chain(
        methods, images.shape, gen))
    err = (fused - composed).abs()
    mean, worst = float(err.mean()), float(err.max())
    q999 = float(torch.quantile(err.reshape(-1), 0.999))
    log(f'fused vs composed per-step route [{TRAIN_BATCH},{CROP_IN},'
        f'{CROP_IN},6] -> {SIZE}: mean|diff| {mean:.3e}, max {worst:.3e}, '
        f'99.9th percentile {q999:.3e}')
    if not (mean < FUSED_MEAN and worst < FUSED_MAX and q999 < FUSED_Q999):
        raise AssertionError('the fused route strays from the composed one')

    # both routes against the f64 oracle (tools/chip_fusedaug_parity.py's
    # production case and rule)
    images = torch.from_numpy(smooth_batch(
        ORACLE_BATCH, CROP_IN, 6, SEED + 1)).to(device)
    draws = augment.draw_chain(methods, images.shape, gen)
    fused, composed = (t.cpu().numpy() for t in _routes(
        augment, methods, images, draws))
    diff, flips, factors, (src, dst) = draws
    top, left = augment._crop_offsets(diff, images.shape[1:3], (SIZE, SIZE))
    tmask = np.zeros(6, bool)
    tmask[list(methods[2][1]['target_channels'])] = True
    oracle = oracle_chain(
        images.cpu().numpy(), torch.stack([top, left], 1).cpu().numpy(),
        flips.cpu().numpy(), factors.cpu().numpy(), src.cpu().numpy(),
        dst.cpu().numpy(), (SIZE, SIZE), tmask,
        methods[3][1].get('max_diff', 5))
    e_c, e_f = np.abs(composed - oracle), np.abs(fused - oracle)
    log(f'f64 oracle [{ORACLE_BATCH},{CROP_IN},{CROP_IN},6] -> {SIZE}, '
        f'{src.shape[1]} points: composed mean {e_c.mean():.3e} max '
        f'{e_c.max():.3e}; fused mean {e_f.mean():.3e} max {e_f.max():.3e}')
    # the fused route as close to the truth as the composed one, and both
    # within the interpolation envelope
    if not (e_f.mean() <= 1.5 * e_c.mean() + 2e-3
            and e_f.max() <= 1.5 * e_c.max() + 2e-2
            and e_f.mean() < 2e-2 and e_c.mean() < 2e-2):
        raise AssertionError('the f64 oracle adjudication failed')

    # the augmentation's time a step on each route
    raw = torch.randint(0, 256, (TRAIN_BATCH, CROP_IN, CROP_IN, 6),
                        generator=gen, device=device, dtype=torch.uint8)
    bank = augment.build_warp_bank(
        torch.Generator(device=device).manual_seed(SEED + 10),
        int(config['deploy_options'].get('warp_bank_size', 512)),
        (SIZE, SIZE), **methods[3][1])

    def route(fused_gate, warp_bank):
        fn = augment.build_augment_fn(methods, warp_bank)

        def run():
            with gates.active(gates.KernelGates(fused_aug=fused_gate)):
                return fn(raw.float() / 255.0, gen)
        return run

    t = _time_fns({'banked': route(False, bank),
                   'per-step composed': route(False, None),
                   'fused': route(True, bank)})
    log(f'augmentation a step, B={TRAIN_BATCH} {CROP_IN}x{CROP_IN}x6 uint8 -> '
        f'{SIZE}x{SIZE}: ' + ', '.join(
        f'{name} {ms:.4f} ms' for name, ms in t.items())
        + f' (CUDA events, median of {TIMED_RUNS}, in turns)')

    # throughput of the fused chain: train calls that differ only in step
    # count, min of three (as phase 5)
    eng = engine.Engine(config, seed=SEED, device=device)
    short, long = 25, 100
    eng.train(ds, max_steps=10, save_freq=1 << 30)
    batch = eng.sample_batch(eng._resident(ds), TRAIN_BATCH, gen)
    _DEFERRED.append(lambda: _profile_steps(
        'fused-chain train step',
        lambda: eng.train_step(batch, eng.current_step, gen), top=8))
    times = {}
    for n in (short, long):
        for _ in range(3):
            torch.cuda.synchronize()
            start = time.perf_counter()
            eng.train(ds, max_steps=eng.current_step + n, save_freq=1 << 30)
            torch.cuda.synchronize()
            times.setdefault(n, []).append(time.perf_counter() - start)
    rate = (long - short) * TRAIN_BATCH / (min(times[long]) -
                                           min(times[short]))
    log(f'fused-chain train throughput: {rate:.2f} slices/s ({short}-step '
        f'calls {times[short]} s, {long}-step calls {times[long]} s; '
        f'steps_per_call {STEPS_PER_CALL})')
    return launches


# -- phase 15 ----------------------------------------------------------------
# the host data layer: a PNG exam tree of phase 4's count (5 cancer and 5
# healthy exams of 16 slices) at phase 5's 512 x 512, trained on TREE_STEPS
# steps; CRC32C over one CRC_BYTES buffer; streaming against resident
# throughput from phase 5's differential calls
TREE_EXAMS = (5, 5)
TREE_SLICES = 16
TREE_STEPS = 20
CRC_BYTES = 64 << 20
STREAM_CHECK_BATCHES = 8
EVAL_SECONDS = {}            # evaluate s/ckpt by phase and route


def write_exam_tree(root, size=EXAM_SIZE, n_exams=TREE_EXAMS,
                    n_slices=TREE_SLICES):
    """A seeded PNG exam tree root/{cancer,healthy}/<pid>/1/<type>/<s>.png
    of write_records' exams (noise, disc lesions; a healthy exam has no
    label directory), written by 8 threads."""
    from concurrent.futures import ThreadPoolExecutor
    from PIL import Image
    from dnncancerannotator_torch.data.records import DEFAULT_SLICE_TYPES

    rng = np.random.default_rng(SEED + 15)
    yy, xx = np.mgrid[:size, :size]
    jobs = []
    for category, n in zip(('cancer', 'healthy'), n_exams):
        types = DEFAULT_SLICE_TYPES if category == 'cancer' else \
            DEFAULT_SLICE_TYPES[:-1]
        for pid in range(1, n + 1):
            exam = os.path.join(root, category, str(pid), '1')
            for t in types:
                os.makedirs(os.path.join(exam, t))
            for s in range(1, n_slices + 1):
                img = rng.integers(0, 255, (len(types), size, size), np.uint8)
                if category == 'cancer':
                    cy, cx = rng.integers(size // 5, size - size // 5, 2)
                    r = rng.integers(size // 32, size // 8)
                    disk = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
                    img[:5, disk] = 220
                    img[5] = disk * np.uint8(255)
                jobs += [(img[c], os.path.join(exam, t, f'{s:02d}.png'))
                         for c, t in enumerate(types)]
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda job: Image.fromarray(job[0]).save(job[1]), jobs))
    return root


def _timed(fn, runs=1):
    """(result, min seconds over ``runs`` calls)."""
    best = float('inf')
    for _ in range(runs):
        start = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - start)
    return out, best


def host_library_rates(smi):
    """(a) The host library's build and CRC32C's rate, native against its
    plain version, on one CRC_BYTES buffer: the same CRC."""
    from dnncancerannotator_torch.data import _native
    from dnncancerannotator_torch.data import tfrecord as tfr

    built = ('an earlier build' if _native.build_seconds is None else
             f'built in {_native.build_seconds:.2f} s (phase 2)')
    log(f'host library: {built} -> {_native.library_path()}')
    buf = np.random.default_rng(SEED).integers(
        0, 256, CRC_BYTES, np.uint8).tobytes()
    crc, native_s = _timed(lambda: tfr.crc32c(buf), runs=3)
    plain, plain_s = _timed(lambda: tfr.crc32c_plain(buf))
    mb = CRC_BYTES / 1e6
    log(f'CRC32C of {CRC_BYTES >> 20} MiB: native {mb / native_s:.1f} MB/s '
        f'(min of 3), plain {mb / plain_s:.1f} MB/s, both {crc:#010x} '
        f'[{smi}]')
    if crc != plain:
        raise AssertionError(f'CRC32C: native {crc:#x}, plain {plain:#x}')


def tree_records(work, smi):
    """(b) generate_tfrecords on a seeded PNG tree: every record decodes
    natively to the Python codec's bytes and to prepare_combined_slices of
    its exam, the library declines none; the decode rates. Returns (tree,
    its records)."""
    from glob import glob
    from dnncancerannotator_torch.data import pipeline, records
    from dnncancerannotator_torch.data import tfrecord as tfr
    from dnncancerannotator_torch.runs.__main__ import main as cli

    declined = records.declined
    _, seconds = _timed(lambda: write_exam_tree(os.path.join(work, 'tree')))
    tree = os.path.join(work, 'tree')
    log(f'exam tree: {sum(TREE_EXAMS)} exams x {TREE_SLICES} slices of '
        f'{EXAM_SIZE}^2 PNGs in {seconds:.2f} s')
    out = os.path.join(work, 'tree.tfrecords')
    n, seconds = _timed(lambda: cli(argv=['generate_tfrecords', '--path',
                                          tree, '--output', out]))
    log(f'generate_tfrecords: {n} exams in {seconds:.2f} s, '
        f'{os.path.getsize(out) / 1e6:.1f} MB')
    exam_dirs = sorted(glob(os.path.join(tree, '*', '*', '*')))
    bufs = list(tfr.read_records(out, verify_crc=True))
    if n != sum(TREE_EXAMS) or len(bufs) != n:
        raise AssertionError(f'{n} exams written, {len(bufs)} records')
    for buf, exam_dir in zip(bufs, exam_dirs):
        native = records.parse_example_exam_native(buf)
        plain = records.parse_example_exam_plain(buf)
        want = records.prepare_combined_slices(exam_dir)
        if native is None or not np.array_equal(native['slices'],
                                                plain['slices']) or \
                not np.array_equal(native['slices'], want['slices']):
            raise AssertionError(f'the record of {exam_dir} decodes to '
                                 'other bytes')
        for key in ('patientID', 'examID', 'path', 'category'):
            if not native[key] == plain[key] == want[key]:
                raise AssertionError(f'{exam_dir}: {key} {native[key]!r}, '
                                     f'{plain[key]!r}, {want[key]!r}')

    def decode(pool):
        reader = records.TFRecordExamReader(out)   # a fresh cache
        return sum(e['slices'].nbytes for e in reader.iter_exams(pool=pool))

    def decode_plain():
        reader = records.TFRecordExamReader(out)
        return sum(records.parse_example_exam_plain(tfr.read_record_at(
            out, *at))['slices'].nbytes for at in reader.index)

    pool = pipeline._resolve_pool('auto')
    nbytes, serial_s = _timed(lambda: decode(0), runs=3)
    _, pool_s = _timed(lambda: decode(pool), runs=3)
    _, plain_s = _timed(decode_plain, runs=3)
    mb = nbytes / 1e6
    log(f'exam decode of {mb:.1f} MB of slices (min of 3, warm page '
        f'cache): native serial {mb / serial_s:.1f} MB/s, native with a '
        f'pool of {pool} {mb / pool_s:.1f} MB/s, Python '
        f'{mb / plain_s:.1f} MB/s [{smi}]')
    log(f'records the host library declined: {records.declined - declined}')
    if records.declined != declined:
        raise AssertionError(f'{records.declined - declined} records '
                             'declined')
    return tree, out


@contextlib.contextmanager
def _spied_raw_batches():
    """Within the block, the seeds of every TrainDataset.raw_batches call."""
    from dnncancerannotator_torch.data import pipeline

    calls, raw_batches = [], pipeline.TrainDataset.raw_batches

    def spy(self, seed=None):
        calls.append(seed)
        yield from raw_batches(self, seed)
    pipeline.TrainDataset.raw_batches = spy
    try:
        yield calls
    finally:
        pipeline.TrainDataset.raw_batches = raw_batches


def stream_cli(device, train_paths, work):
    """(c) The train CLI streaming phase 5's records from the host
    (device_cache: false): as phase 5, the stream started once a call."""
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.data import pipeline
    from dnncancerannotator_torch.ops import kernels
    from dnncancerannotator_torch.ops.kernels import _build
    from dnncancerannotator_torch.runs.__main__ import main as cli
    from dnncancerannotator_torch.utils import config as config_lib

    overlay = os.path.join(work, 'stream.json')
    with open(overlay, 'w') as fh:
        json.dump({'deploy_options.steps_per_call': STEPS_PER_CALL,
                   'data_options.train.device_cache': False}, fh)
    save_path = os.path.join(work, 'stream_run')
    ckpt_dir = os.path.join(save_path, 'checkpoints')
    argv = ['train', '--config', *[os.path.join(REPO, c) for c in CONFIGS],
            overlay, '--save_path', save_path, '--data_path', *train_paths,
            '--save_freq', str(SAVE_FREQ), '--seed', str(SEED), '--device',
            device.type, '--max_steps']
    kernels.reset_launches()
    torch.cuda.synchronize()
    before = _build.library_launches()
    with _spied_raw_batches() as calls:
        res, seconds = _timed(lambda: cli(argv=argv + [str(TRAIN_STEPS)]))
    torch.cuda.synchronize()
    library = _build.library_launches() - before
    launches = kernels.launch_counts()
    losses = res.history['loss']
    log(f'streamed train: {TRAIN_STEPS} steps in {seconds:.3f} s, loss '
        f'{losses[0]:.4f} -> {losses[-1]:.4f}; raw_batches calls {calls}; '
        f'the library launched {library} kernels')
    log(f'launches during the streamed train: {launches}')
    if calls != [SEED] or res.epoch != list(range(1, TRAIN_STEPS + 1)) or \
            not np.isfinite(losses).all():
        raise AssertionError(f'streamed train: stream calls {calls}, steps '
                             f'{res.epoch}, losses {losses}')
    for step in range(SAVE_FREQ, TRAIN_STEPS + 1, SAVE_FREQ):
        files = set(os.listdir(os.path.join(ckpt_dir, f'ckpt-{step}')))
        if files != ORBAX_FILES:
            raise AssertionError(f'ckpt-{step} holds {sorted(files)}')
    for name, sites in TRAIN_SITES.items():
        if launches[name] < sites * TRAIN_STEPS:
            raise AssertionError(f'{name} launched {launches[name]} times, '
                                 f'want >= {sites} x {TRAIN_STEPS}')
    if library < sum(TRAIN_SITES.values()) * TRAIN_STEPS:
        raise AssertionError(f'the library launched {library} kernels')

    last = TRAIN_STEPS + SAVE_FREQ
    with _spied_raw_batches() as calls:
        res = cli(argv=argv + [str(last)])
    if calls != [SEED] or res.epoch != list(range(TRAIN_STEPS + 1,
                                                  last + 1)):
        raise AssertionError(f'the resumed call ran steps {res.epoch}, '
                             f'stream calls {calls}')
    log(f'streamed train resumed at step {TRAIN_STEPS}: steps '
        f'{res.epoch[0]}-{res.epoch[-1]}, the stream started again')
    config = config_lib.load_config(
        os.path.join(save_path, 'options.yaml'))['config']
    eng = engine.Engine(config, seed=SEED, device=device)
    eng.build(pipeline.train_ds(
        train_paths, **config['data_options']['train']).feature_shape)
    eng.load(os.path.join(ckpt_dir, f'ckpt-{last}'))
    out_dir = os.path.join(work, 'stream_maps')
    count = cli(argv=['predict', '--save_path', save_path, '--data_path',
                      *train_paths, '--output_path', out_dir, '--batch_size',
                      str(BATCH), '--output_format', 'npy', '--device',
                      device.type])
    log(f'predict from the streamed ckpt-{last}: {count} maps')
    _check_maps(eng.model, train_paths, out_dir,
                sum(TRAIN_EXAMS) * TRAIN_SLICES)
    return launches


def _first_step_spy(eng, seen, first):
    """Record the raw batch of every train step of ``eng`` in ``seen``, and
    the first step's loss and gradients in ``first``."""
    step_fn = eng.train_step

    def train_step(raw, *args, **kwargs):
        seen.append(raw.clone())
        out = step_fn(raw, *args, **kwargs)
        if len(seen) == 1:
            first['loss'] = (out[0] if isinstance(out, tuple) else out).clone()
            first['grads'] = {n: p.grad.clone()
                              for n, p in eng.model.named_parameters()}
        return out
    eng.train_step = train_step


def stream_step_check(device, train_paths):
    """(d) A streamed step against the resident step on the same raw batch
    and draws (loss and every gradient the same bits), the first
    STREAM_CHECK_BATCHES streamed batches against raw_batches(seed) on the
    host, and the fallback to streaming under a budget below the set."""
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.data import pipeline

    config = _config(CONFIGS)
    resident_opts = config['data_options']['train']
    stream_opts = dict(resident_opts, device_cache=False)
    a = engine.Engine(config, seed=SEED, device=device)
    seen, streamed = [], {}
    _first_step_spy(a, seen, streamed)
    a.train(pipeline.train_ds(train_paths, **stream_opts),
            max_steps=STREAM_CHECK_BATCHES, save_freq=1 << 30)
    host = itertools.islice(pipeline.train_ds(
        train_paths, **stream_opts).raw_batches(SEED), STREAM_CHECK_BATCHES)
    n_equal = sum(torch.equal(got.cpu(), torch.from_numpy(want))
                  for got, want in zip(seen, host))
    log(f'streamed batches equal to raw_batches({SEED}) on the host: '
        f'{n_equal} of {STREAM_CHECK_BATCHES}')
    if n_equal != STREAM_CHECK_BATCHES or len(seen) != n_equal:
        raise AssertionError('the streamed batches differ from the host '
                             'stream')

    b = engine.Engine(config, seed=SEED, device=device)
    b._bank_cache = a._bank_cache
    b.sample_batch = lambda pool, size, gen: seen[0]
    resident_seen, resident = [], {}
    _first_step_spy(b, resident_seen, resident)
    ds = pipeline.train_ds(train_paths, **resident_opts)
    b.train(ds, max_steps=1, save_freq=1 << 30)
    if b._resident(ds) is None:
        raise AssertionError('the resident check streamed')
    unequal = [n for n, g in streamed['grads'].items()
               if not torch.equal(g, resident['grads'][n])]
    log(f'streamed step vs resident step on the same batch and draws: loss '
        f'{float(streamed["loss"]):.7f} / {float(resident["loss"]):.7f}, '
        f'{len(streamed["grads"]) - len(unequal)} of '
        f'{len(streamed["grads"])} gradients the same bits')
    if not torch.equal(streamed['loss'], resident['loss']) or unequal:
        raise AssertionError(f'streamed step differs: gradients {unequal}')

    size = ds.load_resident()['data'].nbytes
    over = pipeline.train_ds(train_paths, **resident_opts)
    over.load_resident = functools.partial(over.load_resident,
                                           budget_bytes=size - 1)
    c = engine.Engine(config, seed=SEED, device=device)
    c._bank_cache = a._bank_cache
    with _spied_raw_batches() as calls:
        res = c.train(over, max_steps=2, save_freq=1 << 30)
    log(f'budget {size - 1} bytes below the set\'s {size}: resident pool '
        f'{c._resident(over)}, raw_batches calls {calls}, losses '
        f'{res.history["loss"]}')
    if c._resident(over) is not None or calls != [SEED] or \
            not np.isfinite(res.history['loss']).all() or \
            pipeline.train_ds(train_paths, **resident_opts).load_resident(
                budget_bytes=size) is None:
        raise AssertionError('no fallback to streaming under the budget')


def tree_slice(device, tree, tree_records_path, work):
    """(e) The train CLI from the exam tree, resident and streaming, for
    TREE_STEPS steps; evaluate from the tree, equal to evaluate from its
    records."""
    from dnncancerannotator_torch.runs.__main__ import main as cli

    runs = {}
    for cache in (True, False):
        overlay = os.path.join(work, f'tree_{cache}.json')
        with open(overlay, 'w') as fh:
            json.dump({'deploy_options.steps_per_call': TREE_STEPS // 2,
                       'data_options.train.device_cache': cache}, fh)
        save_path = os.path.join(work, f'tree_run_{cache}')
        with _spied_raw_batches() as calls:
            res, seconds = _timed(lambda: cli(argv=[
                'train', '--config', *[os.path.join(REPO, c)
                                       for c in CONFIGS], overlay,
                '--save_path', save_path, '--data_path', tree,
                '--max_steps', str(TREE_STEPS), '--save_freq',
                str(TREE_STEPS), '--seed', str(SEED), '--device',
                device.type]))
        route = 'resident' if cache else 'streamed'
        log(f'train from the exam tree ({route}): steps {res.epoch[0]}-'
            f'{res.epoch[-1]} in {seconds:.2f} s, loss '
            f'{res.history["loss"][0]:.4f} -> {res.history["loss"][-1]:.4f}'
            f', raw_batches calls {calls}')
        if res.epoch != list(range(1, TREE_STEPS + 1)) or \
                not np.isfinite(res.history['loss']).all() or \
                calls != ([] if cache else [SEED]):
            raise AssertionError(f'train from the tree ({route}): '
                                 f'{res.epoch}, {res.history["loss"]}')
        runs[route] = save_path
    tables = {}
    for tag, paths in (('tree', [tree]), ('records', [tree_records_path])):
        _, seconds = _timed(lambda: cli(argv=[
            'evaluate', '--save_path', runs['resident'], '--data_path',
            *paths, '--tag', tag, '--config',
            os.path.join(REPO, METRICS_CONFIG), '--export_csv',
            '--skip_visualization', '--device', device.type]))
        tables[tag] = _read_csv(os.path.join(
            runs['resident'], 'tfevents', tag, 'results.csv'))
        log(f'evaluate from the {tag}: {seconds:.2f} s, {tables[tag][1]}')
    if tables['tree'] != tables['records'] or len(tables['tree']) != 2:
        raise AssertionError(f'evaluate from the tree {tables["tree"]} '
                             f'!= from its records {tables["records"]}')


class _InlineBatches:
    """engine._Prefetcher's interface without its thread: each item is read
    and copied to the device (pageable) when the loop asks for it, as the
    serial evaluate pass did before the prefetcher."""

    def __init__(self, iterator, device, to_host=lambda item: item):
        self._iterator, self._device = iterator, device
        self._to_host = to_host

    def __iter__(self):
        return self

    def __next__(self):
        item = next(self._iterator)
        return item, torch.from_numpy(self._to_host(item)).to(self._device)

    def close(self):
        self._iterator.close()


def host_rates(device, val_paths, train_paths, run, smi):
    """(f) Train throughput streaming against resident (phase 5's
    differential calls, each the minimum of three, in turns), and evaluate
    s/ckpt at phase 6's setting prefetched against the serial pass, in
    turns, beside phase 6's figure; the two passes' results equal."""
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.data import pipeline
    from dnncancerannotator_torch.runs.__main__ import main as cli

    config = _config(CONFIGS)
    config['deploy_options']['steps_per_call'] = STEPS_PER_CALL
    opts = config['data_options']['train']
    routes = {}
    for route, cache in (('resident', True), ('streamed', False)):
        eng = engine.Engine(config, seed=SEED, device=device)
        if routes:
            eng._bank_cache = routes['resident'][0]._bank_cache
        ds = pipeline.train_ds(train_paths, **dict(opts, device_cache=cache))
        eng.train(ds, max_steps=10, save_freq=1 << 30)
        routes[route] = (eng, ds)
    short, long = 25, 100
    times = {}
    for n in (short, long):
        for _ in range(3):
            for route, (eng, ds) in routes.items():
                torch.cuda.synchronize()
                start = time.perf_counter()
                eng.train(ds, max_steps=eng.current_step + n,
                          save_freq=1 << 30)
                torch.cuda.synchronize()
                times.setdefault((route, n), []).append(
                    time.perf_counter() - start)
    rates = {route: (long - short) * TRAIN_BATCH / (
        min(times[route, long]) - min(times[route, short]))
        for route in routes}
    for route in routes:
        log(f'{route} train throughput: {rates[route]:.2f} slices/s '
            f'({short}-step calls {times[route, short]} s, {long}-step calls '
            f'{times[route, long]} s) [{smi}]')
    log(f'streamed / resident throughput: '
        f'{rates["streamed"] / rates["resident"]:.3f} [{smi}]')

    n_slices = sum(N_EXAMS) * SLICES_PER_EXAM
    tables = {}
    for tag in ('prefetched', 'serial', 'prefetched_', 'serial_'):
        with contextlib.ExitStack() as stack:
            if tag.startswith('serial'):
                stack.enter_context(_swapped(engine, '_Prefetcher',
                                             _InlineBatches))
            torch.cuda.synchronize()
            start = time.perf_counter()
            rows = cli(argv=[
                'evaluate', '--save_path', run, '--data_path', *val_paths,
                '--tag', f'rate_{tag}', '--config',
                os.path.join(REPO, METRICS_CONFIG), '--export_csv',
                '--export_images', '--export_casewise_metrics', '--device',
                device.type])
            torch.cuda.synchronize()
        seconds = (time.perf_counter() - start) / len(rows)
        EVAL_SECONDS.setdefault(tag.rstrip('_'), []).append(seconds)
        tables[tag] = _read_csv(os.path.join(run, 'tfevents', f'rate_{tag}',
                                             'results.csv'))
    log(f'evaluate at phase 6\'s setting ({n_slices} slices a checkpoint, '
        f'every export), s/ckpt: prefetched {EVAL_SECONDS["prefetched"]}, '
        f'serial {EVAL_SECONDS["serial"]}, phase 6 (prefetched) '
        f'{EVAL_SECONDS["phase 6"]:.3f} [{smi}]')
    if len({json.dumps(t) for t in tables.values()}) != 1:
        raise AssertionError('the prefetched and serial evaluate passes '
                             f'differ: {tables}')


@contextlib.contextmanager
def _swapped(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def data_layer_slice(device, val_paths, train_paths, run, smi):
    """Phase 15: the host data layer on the card, (a)-(f)."""
    from dnncancerannotator_torch.data import records

    work = os.path.join(WORK, 'data_layer')
    os.makedirs(work)
    host_library_rates(smi)
    tree, tree_records_path = tree_records(work, smi)
    launches = stream_cli(device, train_paths, work)
    stream_step_check(device, train_paths)
    tree_slice(device, tree, tree_records_path, work)
    host_rates(device, val_paths, train_paths, run, smi)
    log(f'records the host library declined in this run: {records.declined}')
    return launches


# -- phase 16 -----------------------------------------------------------------
# the runs phase 16 exports and serves: phase 5's unet.yaml run with a
# symbolic batch, and phase 12's unet_big.yaml as shipped (bf16) with a fixed
# batch; each with the batches its requests carry
SERVE_RUNS = (
    dict(label='unet.yaml', name='unet', batch=None, batches=(1, 8, 64)),
    dict(label='unet_big bf16', name='unet_big', batch=8, batches=(3, 8)),
)
SERVE_TOL = 1e-6     # a served answer against load_exported on its slices
SERVE_TIMED = 10     # request latency: the median of this many, in turns


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _post(url, body):
    '''(status, answer) of a POST of ``body`` (bytes).'''
    try:
        with urllib.request.urlopen(url, body, timeout=300) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


@contextlib.contextmanager
def _serving(artifact, device):
    '''The port's server for ``artifact`` on ``device``, on a thread; yields
    its URL and stops it after.'''
    from dnncancerannotator_torch.runs.serve import make_server
    server = make_server(artifact, port=0, device=device.type)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f'http://127.0.0.1:{server.server_address[1]}'
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError('the server thread did not stop')


def _launches():
    '''(each kernel's count, the library's own count) now.'''
    from dnncancerannotator_torch.ops import kernels
    from dnncancerannotator_torch.ops.kernels import _build
    return kernels.launch_counts(), _build.library_launches()


def _check_no_launches(label, before):
    '''Raise if a kernel launched since ``before`` (``_launches()``).'''
    counts, library = _launches()
    moved = {name: n - before[0][name] for name, n in counts.items()
             if n != before[0][name]}
    if moved or library != before[1]:
        raise AssertionError(f'{label}: kernels launched {moved}, the '
                             f'library {library - before[1]} times')


def _check_on_card(path, device):
    '''Every parameter, buffer and constant of the moved program, and every
    ``device`` keyword of its graph, on ``device``.'''
    from torch.export.passes import move_to_device_pass
    program = move_to_device_pass(torch.export.load(path), device)
    tensors = {**program.state_dict, **program.constants}
    off = [name for name, t in tensors.items()
           if torch.is_tensor(t) and t.device.type != device.type]
    off += [node.name for node in program.graph.nodes
            if isinstance(node.kwargs.get('device'), torch.device)
            and node.kwargs['device'].type != device.type]
    if off:
        raise AssertionError(f'{path}: not on {device}: {off}')
    return len(tensors)


def serve_run(spec, device, save_path, features, smi):
    '''Export ``save_path`` through the CLI, load it, serve it and ask for
    ``spec['batches']`` slices of ``features``: every answer 200, float32
    [B, H, W, 1], finite, in [0, 1] and within SERVE_TOL of
    ``load_exported`` on the same slices; a fixed batch also padded below
    and refused above. Returns (artifact, {batch: answer}).'''
    from dnncancerannotator_torch.runs.__main__ import main as cli
    from dnncancerannotator_torch.runs.export import load_exported

    label, fixed = spec['label'], spec['batch']
    argv = ['export_model', '--save_path', save_path, '--output_path',
            os.path.join(WORK, 'serve', spec['name'])]
    start = time.perf_counter()
    path = cli(argv=argv + (['--batch_size', str(fixed)] if fixed else []))
    seconds = time.perf_counter() - start
    log(f'{label}: export {seconds:.3f} s, artifact '
        f'{os.path.getsize(path) / 2**20:.3f} MB ({smi})')
    start = time.perf_counter()
    infer = load_exported(path, device=device.type)
    seconds = time.perf_counter() - start
    n = _check_on_card(path, device)
    log(f'{label}: load and move {seconds:.3f} s; {n} tensors, each on the '
        f'card ({smi})')

    # the server's load turns TF32 off again, as the Engine's device does
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    answers = {}
    with _serving(path, device) as url:
        with urllib.request.urlopen(url + '/healthz', timeout=60) as resp:
            if resp.read() != b'ok':
                raise AssertionError(f'{label}: /healthz')
        with urllib.request.urlopen(url + '/spec', timeout=60) as resp:
            shape = json.loads(resp.read())['input']['shape']
        if shape != [fixed or -1, *features.shape[1:]]:
            raise AssertionError(f'{label}: /spec input shape {shape}')
        for b in spec['batches']:
            status, body = _post(url + '/predict', _npy(features[:b]))
            if status != 200:
                raise AssertionError(f'{label} B={b}: {status} {body[:200]}')
            got = np.load(io.BytesIO(body))
            if got.shape != (b, *features.shape[1:3], 1) or \
                    got.dtype != np.float32 or not np.isfinite(got).all() \
                    or got.min() < 0 or got.max() > 1:
                raise AssertionError(f'{label} B={b}: {got.dtype} '
                                     f'{got.shape}, [{got.min()}, '
                                     f'{got.max()}]')
            x = features[:b]
            if fixed:
                x = np.concatenate([x, np.zeros_like(features[:fixed - b])])
            err = float(np.abs(got - infer(x)[:b].cpu().numpy()).max())
            log(f'{label} B={b}: served against load_exported max|diff| '
                f'{err:.3e}')
            if not err <= SERVE_TOL:
                raise AssertionError(f'{label} B={b}: {err} > {SERVE_TOL}')
            answers[b] = got
        if fixed:
            status, body = _post(url + '/predict',
                                 _npy(features[:fixed + 1]))
            want = f'artifact has fixed batch {fixed}; got {fixed + 1}'
            if status != 400 or json.loads(body)['error'] != want:
                raise AssertionError(f'{label} B={fixed + 1}: {status} '
                                     f'{body[:200]}')
        if torch.backends.cudnn.allow_tf32 or \
                torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError(f'{label}: TF32 on while serving')
    return path, answers


def _bf16_maps_close(label, got, live, exact):
    '''tests/test_torch_bf16.py's rule for the served bf16 maps against the
    live bf16 forward: within BF16_STEP_TOL of its scale, else no further
    from the f64 forward (``exact()``) than F64_RATIO times the live one
    by root-mean-square distance.'''
    err = float(np.abs(got - live).max())
    scale = float(np.abs(live).max())
    log(f'{label}: served against the live forward under the force-off '
        f'scope max|diff| {err:.3e} (scale {scale:.3e})')
    if err <= BF16_STEP_TOL * scale:
        return
    want = exact()
    mine = float(np.sqrt(np.mean((got.astype(np.float64) - want) ** 2)))
    theirs = float(np.sqrt(np.mean((live.astype(np.float64) - want) ** 2)))
    log(f'  from the f64 forward (rms): served {mine:.3e}, live {theirs:.3e}')
    if not mine <= F64_RATIO * theirs:
        raise AssertionError(f'{label}: served maps {mine} from the f64 '
                             f'forward against the live forward\'s {theirs}')


def _engine(save_path, device, config=None):
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.utils import config as config_lib
    config = config or config_lib.load_config(
        os.path.join(save_path, 'options.yaml'))['config']
    eng = engine.Engine(config, seed=SEED, device=device)
    eng.build((1, SIZE, SIZE, 5))
    ckpts = eng.get_ckpts(os.path.join(save_path, 'checkpoints'))
    eng.load(ckpts[max(ckpts)])
    return eng


def export_serve_slice(device, data_paths, unet_run, smi):
    '''Phase 16: each SERVE_RUNS run exported and served on the card
    (``serve_run``) with no kernel launched, the unet.yaml answers against
    the kernel path's eval step of the same checkpoint (MAP_TOL), the
    unet_big bf16 answers against its live forward under the force-off
    scope (``_bf16_maps_close``), then the request latency in turns with
    the eval step.'''
    from dnncancerannotator_torch.data import pipeline
    from dnncancerannotator_torch.ops import gates

    ds = pipeline.predict_ds(data_paths, output_size=(SIZE, SIZE),
                             batch_size=BATCH)
    raw = next(iter(ds.batches()))['slices']
    features = np.ascontiguousarray(raw[..., :5])
    saves = {'unet': unet_run,
             'unet_big': os.path.join(WORK, BF16_BIG_SPEC['run'])}

    before = _launches()
    served = {spec['name']: serve_run(spec, device, saves[spec['name']],
                                      features, smi)
              for spec in SERVE_RUNS}
    _check_no_launches('export and serving', before)
    log('launches during export and serving: none (kernels and library)')

    engines = {name: _engine(saves[name], device) for name in saves}
    steps = {name: eng._make_eval_step(ds.slice_types)
             for name, eng in engines.items()}
    for b, got in served['unet'][1].items():
        want = steps['unet'](raw[:b])[1].cpu().numpy()
        err = float(np.abs(got - want).max())
        log(f'unet.yaml B={b}: served against the kernel path\'s eval step '
            f'max|diff| {err:.3e}')
        if not err <= MAP_TOL:
            raise AssertionError(f'unet.yaml B={b}: {err} > {MAP_TOL}')
    big = engines['unet_big']
    for b, got in served['unet_big'][1].items():
        x = torch.from_numpy(features[:b]).to(device).float() / 255.0
        with torch.no_grad(), big.scope(), gates.library_only():
            live = torch.sigmoid(big.model(x, return_logits=True))

        def exact(x=x):
            eng = _engine(saves['unet_big'], device,
                          _unset_precision(big.model_config))
            eng.model.double()
            with torch.no_grad(), eng.scope(), gates.library_only():
                return torch.sigmoid(eng.model(
                    x.double(), return_logits=True)).cpu().numpy()

        _bf16_maps_close(f'unet_big bf16 B={b}', got, live.cpu().numpy(),
                         exact)

    # request latency against the eval step on the same batch, in turns
    # (host clock; the eval step's maps copied to the host as the server's)
    for spec in SERVE_RUNS:
        name = spec['name']
        path = served[name][0]
        with _serving(path, device) as url:
            for b in spec['batches']:
                times = {'served': [], 'eval': []}
                body = _npy(features[:b])
                for _ in range(SERVE_TIMED + 1):
                    before = _launches()
                    start = time.perf_counter()
                    status, _ = _post(url + '/predict', body)
                    times['served'].append(time.perf_counter() - start)
                    _check_no_launches(f'{spec["label"]} B={b}', before)
                    if status != 200:
                        raise AssertionError(f'{spec["label"]} B={b}: '
                                             f'{status}')
                    torch.cuda.synchronize()
                    start = time.perf_counter()
                    steps[name](raw[:b])[1].cpu()
                    times['eval'].append(time.perf_counter() - start)
                served_ms, eval_ms = (1e3 * statistics.median(t[1:])
                                      for t in times.values())
                log(f'{spec["label"]} B={b}: request {served_ms:.3f} ms, '
                    f'eval step {eval_ms:.3f} ms (host clock, median of '
                    f'{SERVE_TIMED}, in turns; {smi})')
                if b == BATCH:
                    log(f'{spec["label"]} B={b}: served '
                        f'{b * 1e3 / served_ms:.2f} slices/s, kernel path '
                        f'{b * 1e3 / eval_ms:.2f} slices/s ({smi})')


# -- phase 17 ----------------------------------------------------------------
MULTIGPU = 'configs/additionals/multigpu.yaml'
DP_STEPS = 10        # (a), (c): k steps, one checkpoint
DP_TIMEOUT = 600     # seconds a torchrun launch may take
DP_REPS = 2          # the world-1 cost: each train call the minimum of this many
DP_WORLD = 2         # (b), (c): ranks on the one card
# (b): each seeded step on 2 ranks, the kernels it must launch on every rank
DP_STEP_KERNELS = {'unet.yaml': tuple(TRAIN_SITES),
                   'unet_big f32': (*NHWC_KERNELS, 'warp_twopass'),
                   'unet_big bf16': ('warp_twopass',)}


def _dp(*names):
    return os.path.join(WORK, 'dp', *names)


def _write_spec(name, jobs, device, backend=None):
    '''The jobs of a ``rank_jobs`` launch, in a group of ``backend``
    (None: NCCL on the card).'''
    path = _dp(f'{name}.json')
    with open(path, 'w') as fh:
        json.dump({'device': device.type, 'backend': backend, 'jobs': jobs},
                  fh)
    return path


def _torchrun(nproc, spec):
    '''``spec``'s jobs (``rank_jobs``) in ``nproc`` processes started by
    ``python -m torch.distributed.run --standalone`` with DNNCA_MULTIHOST=1;
    returns (process, log).'''
    env = dict(os.environ, DNNCA_MULTIHOST='1')
    log_path = spec[:-len('.json')] + '.log'
    with open(log_path, 'w') as fh:
        proc = subprocess.Popen(
            [sys.executable, '-m', 'torch.distributed.run', '--standalone',
             '--nproc_per_node', str(nproc),
             os.path.join(REPO, 'chip_smoke.py'), '--rank-jobs', spec],
            cwd=REPO, env=env, stdout=fh, stderr=subprocess.STDOUT)
    return proc, log_path


def _finish(label, launch):
    '''Wait for a ``_torchrun`` launch (stopping it at DP_TIMEOUT); raise
    with its log's end unless it exited 0.'''
    proc, log_path = launch
    try:
        rc = proc.wait(timeout=DP_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.terminate()   # torchrun passes it on to its workers
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        rc = 'timed out'
    if rc != 0:
        with open(log_path) as fh:
            raise AssertionError(f'{label}: torchrun {rc}:\n'
                                 f'{fh.read()[-4000:]}')


def rank_jobs(spec_path):
    '''One rank of a phase 17 torchrun launch: join the launcher's group
    (DNNCA_MULTIHOST=1: NCCL on the card, or the spec's backend), run the
    spec's jobs in order (``cli``: the port's CLI; ``step``:
    ``_rank_step``; ``cost``: ``_rank_cost``), write this rank's group and
    results beside the spec, leave the group.'''
    import torch.distributed as dist
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.parallel import multihost
    from dnncancerannotator_torch.runs.__main__ import main as cli

    with open(spec_path) as fh:
        spec = json.load(fh)
    multihost.maybe_initialize(spec['device'], spec['backend'])
    engine.resolve_device(spec['device'])
    rank = dist.get_rank()
    try:
        for job in spec['jobs']:
            if job['kind'] == 'cli':
                cli(argv=job['argv'])
            else:
                run = _rank_cost if job['kind'] == 'cost' else _rank_step
                torch.save(run(job, spec['device']),
                           f"{job['out']}.rank{rank}.pt")
        with open(f'{spec_path}.rank{rank}.json', 'w') as fh:
            json.dump(dict(backend=str(dist.get_backend()),
                           world=dist.get_world_size()), fh)
    finally:
        dist.destroy_process_group()


def _rank_step(job, device):
    '''This rank's part of one seeded train step on its rows (the batch and
    draws of ``big_check_state``, or of phase 5's check on its trained
    checkpoint), through ``Engine.train_step``: the global loss, the summed
    gradients, the updated statistics, the rank's rows, the bank's digest,
    the kernels' launches and the route of each kernel call
    (``_route_log``); then ``more`` (default 3) ``Engine.train`` steps and
    the parameters.'''
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.data import augment, pipeline
    from dnncancerannotator_torch.ops import kernels

    config = job['config']
    eng = engine.Engine(config, seed=SEED, device=device)
    ds = pipeline.train_ds(job['data_paths'],
                           **config['data_options']['train'])
    eng._setup_training(ds)
    if job['ckpt']:
        eng.load(job['ckpt'])
    lo, hi, b = eng._rows
    gen = torch.Generator(device=eng.device).manual_seed(job['gen_seed'])
    raw = eng.sample_batch(eng._resident(ds), b, gen)[lo:hi]
    bank = eng._warp_bank(ds)
    draws = augment.take_rows(augment.draw_chain(
        ds.augment_methods, (b,) + tuple(raw.shape[1:]), gen, bank), lo, hi)
    augment_fn = eng._augment
    eng._augment = lambda images, _gen: augment.apply_chain(
        ds.augment_methods, images, draws, bank)
    kernels.reset_launches()
    library = _library_count(eng.device)
    with _deterministic_cudnn(), _route_log() as routes:
        loss = float(eng.train_step(raw, 0, None))
    out = dict(loss=loss, raw=raw.cpu(), launches=kernels.launch_counts(),
               routes=routes, library=_library_count(eng.device) - library,
               bank=hashlib.sha256(bank['flows'].cpu().numpy().tobytes()
                                   ).hexdigest() if bank else None,
               grads={n: p.grad.to('cpu', copy=True)
                      for n, p in eng.model.named_parameters()},
               stats={n: t.to('cpu', copy=True)
                      for n, t in eng.model.named_buffers()})
    eng._augment = augment_fn
    eng.train(ds, max_steps=job.get('more', 3), save_freq=1 << 30)
    out['params'] = {n: p.detach().cpu()
                     for n, p in eng.model.named_parameters()}
    return out


def _dp_references(device, train_paths, train_run, specs):
    '''{label: (one-rank kernel step, f64 step or its maker, the batch)}:
    each seeded step of ``specs`` on one rank, as phases 5, 7 and 12 take
    them (no group in this process).'''
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.data import augment, pipeline

    refs = {}
    for spec in specs:
        config, label = spec['config'], spec['label']
        ds = pipeline.train_ds(train_paths, **config['data_options']['train'])
        if label == 'unet.yaml':
            eng = engine.Engine(config, seed=SEED, device=device)
            eng._setup_training(ds)
            eng.load(spec['ckpt'])
            gen = torch.Generator(device=device).manual_seed(spec['gen_seed'])
            raw = eng.sample_batch(eng._resident(ds), TRAIN_BATCH, gen)
            draws = augment.draw_chain(ds.augment_methods, raw.shape, gen,
                                       eng._warp_bank(ds))
            loss, grads = _step_grads(eng, ds, raw, draws, plain=False)
            refs[label] = ((loss, grads, {}), functools.partial(
                _step_grads, eng, ds, raw, draws, plain=True, f64=True), raw,
                eng._warp_bank(ds))
        elif label == 'unet_big f32':
            eng, raw, draws = big_check_state(config, ds, SEED, device)
            with _deterministic_cudnn():
                one = _big_step(eng, ds, raw, draws, plain=False)

            def exact(eng=eng, ds=ds, raw=raw, draws=draws):
                with _deterministic_cudnn():
                    return _big_step(eng, ds, raw, draws, plain=True,
                                     f64=True)
            refs[label] = (one, exact, raw, eng._warp_bank(ds))
        else:
            one, _, exact, _, eng, raw = bf16_step(config, ds, device)
            refs[label] = (one, exact, raw, eng._warp_bank(ds))
    return refs


def _dp_step_check(label, out, ref, device, world=DP_WORLD, spatial=1):
    '''(b): the step on ``world`` ranks (in data groups of ``spatial``, which
    split the image rows) against the one-rank kernel step on the same
    batch and draws. Every rank drew its data group's rows of the one-rank
    batch and the one bank, holds the same summed gradients and, after the
    job's further steps, the same parameters (bits), and launched each
    kernel of its path; the step by phase 5's rule (``_compare_step``: the
    loss to LOSS_TOL, each gradient to STEP_TOL, each statistic to
    STATS_TOL of its scale, else F64_RATIO of the one-rank step's distance
    from f64); in bf16 by phase 12's (``_reading``) and each statistic by
    phase 7's. Returns the ranks' results.'''
    one, exact, raw, bank = ref
    outs = [torch.load(f'{out}.rank{r}.pt') for r in range(world)]
    digest = hashlib.sha256(bank['flows'].cpu().numpy().tobytes()
                            ).hexdigest() if bank else None
    parts = world // spatial
    for r, o in enumerate(outs):
        part = r // spatial
        lo, hi = part * TRAIN_BATCH // parts, (part + 1) * TRAIN_BATCH // parts
        if not torch.equal(o['raw'], raw[lo:hi].cpu()) or o['bank'] != digest:
            raise AssertionError(f'{label}: rank {r} drew other rows or '
                                 'another bank than one rank')
        for key in ('grads', 'params', 'stats'):
            for name, value in outs[0][key].items():
                if not torch.equal(o[key][name], value):
                    raise AssertionError(f'{label}: rank {r} {key} {name} '
                                         'differs from rank 0')
        missing = [k for k in DP_STEP_KERNELS[label] if not o['launches'][k]]
        if missing:
            raise AssertionError(f'{label}: rank {r} launched no {missing}')
    log(f'{label}: {world} ranks ({parts} data group(s) of {spatial}) drew '
        f'their rows of the one-rank batch (B={TRAIN_BATCH}, '
        f'{TRAIN_BATCH // parts} a data group) and one bank; gradients, '
        'statistics and the parameters after the further steps the same '
        'bits on every rank; launches a rank: ' + json.dumps(
            {k: outs[0]['launches'][k] for k in DP_STEP_KERNELS[label]}))
    got = (outs[0]['loss'],
           {n: g.to(device) for n, g in outs[0]['grads'].items()},
           {n: s.to(device) for n, s in outs[0]['stats'].items()})
    if label == 'unet.yaml':
        _compare_step(got, one, exact, label=f'{label} {world}-rank '
                      '("kernels") against 1-rank ("plain")')
        return outs
    if label == 'unet_big f32':
        _compare_deep_step(label, got, one, exact())
        return outs
    if not _reading(f'{label} on {world} ranks', got, exact):
        raise AssertionError(f'{label}: the {world}-rank step is further from '
                             'the f64 step than phase 12\'s limits')
    _reading(f'{label} on 1 rank', one, exact)
    for name, e in _step_errors(got, one, lambda: exact).items():
        if e['kind'] == 'stat' and not e['err'] <= e['tol'] * e['scale'] \
                and not e['err64'] <= F64_RATIO * e['plain64']:
            raise AssertionError(f'{label}: statistic {name} {e}')
    log(f'{label}: every updated statistic within STATS_TOL of the 1-rank '
        'step, or F64_RATIO of its distance from f64')
    return outs


def _rms_share(ours, ref):
    '''The root-mean-square distance of a dict of tensors from ``ref``'s,
    over ``ref``'s root mean square.'''
    diff = sum(float((ours[n].double() - r.double()).pow(2).sum())
               for n, r in ref.items())
    return (diff / sum(float(r.double().pow(2).sum())
                       for r in ref.values())) ** 0.5


def _compare_deep_step(label, got, one, exact):
    '''unet_big f32's 2-rank step against the 1-rank step: the loss to
    LOSS_TOL, each gradient to STEP_TOL and each statistic to STATS_TOL of
    its scale (phase 7's limits); past them, the gradients (statistics) as
    a whole no further from the f64 step by root-mean-square distance than
    F64_RATIO times the 1-rank step (phase 12b's rule). One value is no
    truth here: on one rank too, f32 gradients of this deep BatchNorm
    model sit up to ~1e-3 of their scale from f64.'''
    errors = _step_errors(got, one, lambda: exact)
    loss = errors.pop('loss')
    log(f'one {label} train step: loss {loss["got"]:.7f} on the ranks, '
        f'{loss["plain"]:.7f} on 1')
    if not loss['err'] <= LOSS_TOL * loss['scale']:
        raise AssertionError(f'{label}: loss {loss}')
    for kind, index in (('grad', 1), ('stat', 2)):
        past = [n for n, e in errors.items()
                if e['kind'] == kind and not e['err'] <= e['tol'] * e['scale']]
        worst = max(e['err'] / e['scale'] for e in errors.values()
                    if e['kind'] == kind)
        two, ref = _rms_share(got[index], exact[index]), _rms_share(
            one[index], exact[index])
        log(f'  {kind}: worst {worst:.3e} of scale from 1 rank, '
            f'{len(past)} past {errors[past[0]]["tol"] if past else "-"}; '
            f'rms from f64: the ranks {two:.3e}, 1 rank {ref:.3e}')
        if past and not two <= F64_RATIO * ref:
            raise AssertionError(f'{label}: {kind} {past} past the 1-rank '
                                 f'step, and {two} from f64 against {ref}')


def _compare_results(label, got_path, want_path):
    '''results.csv against another: the region metrics (whole counts of
    regions) exactly, the others within 1e-6 relative.'''
    got, want = _read_csv(got_path), _read_csv(want_path)
    if got[0] != want[0] or len(got) != len(want):
        raise AssertionError(f'{label}: results.csv {got[0]} ({len(got)} '
                             f'rows) against {want[0]} ({len(want)})')
    worst = 0.0
    for row_got, row_want in zip(got[1:], want[1:]):
        for name, a, b in zip(got[0], row_got, row_want):
            if name == 'step' or name.startswith('region/'):
                if a != b:
                    raise AssertionError(f'{label}: {name} {a} != {b}')
                continue
            a, b = float(a), float(b)
            err = abs(a - b) / max(abs(b), 1e-30)
            worst = max(worst, err)
            if not err <= 1e-6:
                raise AssertionError(f'{label}: {name} {a} vs {b}')
    log(f'{label}: results.csv {len(got) - 1} rows x {len(got[0])} columns, '
        'the region metrics equal, the others within '
        f'{worst:.3e} relative')


def _results_losses(save_path):
    import pickle
    with open(os.path.join(save_path, 'results.pkl'), 'rb') as fh:
        return pickle.load(fh)['history']['loss']


def nccl_world1_cost(device, train_paths, train_run, smi):
    '''The unet.yaml step with and without a world-1 NCCL group in this
    process (phase 5's differential ``Engine.train`` calls of 25 and 100
    steps, each the minimum of DP_REPS, in turns); the group stays for the
    deferred profile of the grouped step (its all-reduces' device time) and
    is left at the end of ``main``.'''
    import torch.distributed as dist
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.data import pipeline
    from dnncancerannotator_torch.parallel import multihost
    from dnncancerannotator_torch.utils import config as config_lib

    config = config_lib.load_config(
        os.path.join(train_run, 'options.yaml'))['config']
    ds = pipeline.train_ds(train_paths, **config['data_options']['train'])
    kwargs = dict(device_id=device) if device.type == 'cuda' else {}
    dist.init_process_group(
        'nccl' if device.type == 'cuda' else 'gloo',
        init_method=f'tcp://localhost:{multihost.free_port()}',
        world_size=1, rank=0, **kwargs)
    grouped_config = copy.deepcopy(config)
    grouped_config['deploy_options']['enable_multigpu'] = True
    engines = {'no group': engine.Engine(config, seed=SEED, device=device),
               'world-1 NCCL group': engine.Engine(grouped_config, seed=SEED,
                                                   device=device)}
    if engines['no group'].group is not None or \
            engines['world-1 NCCL group'].group is None:
        raise AssertionError('the engines are not one without and one in '
                             'the group')
    for eng in engines.values():
        eng.train(ds, max_steps=10, save_freq=1 << 30)
    short, long = 25, 100
    times = {}
    for n in (short, long):
        for _ in range(DP_REPS):
            for label, eng in engines.items():
                torch.cuda.synchronize()
                start = time.perf_counter()
                eng.train(ds, max_steps=eng.current_step + n,
                          save_freq=1 << 30)
                torch.cuda.synchronize()
                times.setdefault((label, n), []).append(
                    time.perf_counter() - start)
    for label in engines:
        seconds = min(times[(label, long)]) - min(times[(label, short)])
        log(f'unet.yaml train step, {label}: {seconds * 1e3 / (long - short):.4f}'
            f' ms a step, {(long - short) * TRAIN_BATCH / seconds:.2f} '
            f'slices/s ({short}-step calls {times[(label, short)]} s, '
            f'{long}-step calls {times[(label, long)]} s; {smi})')
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    raw = engines['no group'].sample_batch(
        engines['no group']._resident(ds), TRAIN_BATCH, gen)

    def profile():
        sums = {}
        for label, eng in engines.items():
            events = _profile_steps(f'unet.yaml train step, {label}',
                                    lambda: eng.train_step(raw, 0, gen))
            nccl = [e for e in events if 'nccl' in e.key.lower()]
            sums[label] = (
                sum(e.self_device_time_total for e in events) / 1e3 / 5,
                sum(e.count for e in events) / 5,
                sum(e.self_device_time_total for e in nccl) / 1e3 / 5,
                sum(e.count for e in nccl) / 5)
        (ms0, n0, _, _), (ms1, n1, nccl_ms, nccl_n) = sums.values()
        log(f'world-1 NCCL group against none, a step: NCCL kernels '
            f'{nccl_ms:.4f} ms device ({nccl_n:.1f} launches); all kernels '
            f'{ms1:.4f} against {ms0:.4f} ms, {n1:.1f} against {n0:.1f} '
            f'launches ({smi})')
    _DEFERRED.append(profile)


def dp_slice(device, data_paths, train_paths, train_run, smi):
    '''Phase 17; see the module docstring.'''
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.runs.__main__ import main as cli
    from dnncancerannotator_torch.utils import config as config_lib

    os.makedirs(_dp())
    configs = [os.path.join(REPO, c) for c in CONFIGS] + [
        os.path.join(WORK, 'steps_per_call.json'), os.path.join(REPO, MULTIGPU)]
    one_card = f'{device.type}:0' if device.type == 'cuda' else device.type

    def train_argv(save, steps, on=device.type):
        return ['train', '--config', *configs, '--save_path', save,
                '--data_path', *train_paths, '--save_freq', str(DP_STEPS),
                '--seed', str(SEED), '--device', on, '--max_steps',
                str(steps)]

    # one overlay for evaluate: overlays stacked on their own would merge
    # into one dict that replaces the run's whole deploy_options
    eval_overlay = _dp('evaluate.json')
    with open(eval_overlay, 'w') as fh:
        json.dump({'deploy_options.metrics': _config(
            CONFIGS + (METRICS_CONFIG,))['deploy_options']['metrics'],
            'deploy_options.enable_multigpu': True}, fh)

    def eval_argv(save, tag, on=device.type):
        return ['evaluate', '--save_path', save, '--data_path', *data_paths,
                '--tag', tag, '--config', eval_overlay, '--export_csv',
                '--skip_visualization', '--device', on]

    def on(config):
        config = copy.deepcopy(config)
        config['deploy_options']['enable_multigpu'] = True
        return config

    unet = config_lib.load_config(
        os.path.join(train_run, 'options.yaml'))['config']
    steps = [
        dict(kind='step', label='unet.yaml', config=on(unet),
             gen_seed=SEED + 4, ckpt=os.path.join(
                 train_run, 'checkpoints', f'ckpt-{TRAIN_STEPS + SAVE_FREQ}')),
        dict(kind='step', label='unet_big f32', config=on(_config(
            BIG_CONFIGS)), gen_seed=SEED + 7, ckpt=None),
        dict(kind='step', label='unet_big bf16', config=on(_config(
            BF16_BIG_CONFIGS)), gen_seed=SEED + 7, ckpt=None)]
    for spec in steps:
        spec.update(data_paths=train_paths,
                    out=_dp(spec['label'].replace(' ', '_')))
    runs = {name: _dp(name) for name in ('nccl', 'plain', 'broken',
                                         'unbroken')}
    # (a) one NCCL rank through torchrun: train, and evaluate its checkpoint
    spec_a = _write_spec('a', [
        dict(kind='cli', argv=train_argv(runs['nccl'], DP_STEPS)),
        dict(kind='cli', argv=eval_argv(runs['nccl'], 'nccl'))], device)
    # (b), (c): two ranks on the one card over gloo: the seeded steps, train
    # to k and (unbroken) to 2k, evaluate phase 5's run
    spec_b = _write_spec('b', steps + [
        dict(kind='cli', argv=train_argv(runs['broken'], DP_STEPS)),
        dict(kind='cli', argv=train_argv(runs['unbroken'], 2 * DP_STEPS)),
        dict(kind='cli', argv=eval_argv(train_run, 'dp'))], device, 'gloo')
    launches = {'(a)': _torchrun(1, spec_a),
                '(b), (c)': _torchrun(DP_WORLD, spec_b)}
    try:
        # meanwhile in this process (no group): the one-rank references
        start = time.perf_counter()
        refs = _dp_references(device, train_paths, train_run, steps)
        plain = cli(argv=train_argv(runs['plain'], DP_STEPS, one_card))
        cli(argv=eval_argv(runs['plain'], 'one', one_card))
        log(f'one-rank references: {time.perf_counter() - start:.2f} s')
    finally:
        for label, launch in launches.items():
            _finish(label, launch)

    # (a): a real NCCL group, the same bits as no group, one checkpoint
    info = []
    for path in [f'{spec_a}.rank0.json'] + [f'{spec_b}.rank{r}.json'
                                            for r in range(DP_WORLD)]:
        with open(path) as fh:
            info.append(json.load(fh))
    log(f'groups: (a) {info[0]}, (b) {info[1:]}')
    want_backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if info[0] != dict(backend=want_backend, world=1) or any(
            i != dict(backend='gloo', world=DP_WORLD) for i in info[1:]):
        raise AssertionError(f'groups {info}')
    nccl_losses = _results_losses(runs['nccl'])
    if nccl_losses != plain.history['loss']:
        raise AssertionError(f'(a) the NCCL world-1 losses {nccl_losses} '
                             f'are not the bits of no group\'s '
                             f'{plain.history["loss"]}')
    ckpts = sorted(os.listdir(os.path.join(runs['nccl'], 'checkpoints')))
    if ckpts != [f'ckpt-{DP_STEPS}']:
        raise AssertionError(f'(a) checkpoints {ckpts}')
    paths = [os.path.join(runs[name], 'tfevents', tag, 'results.csv')
             for name, tag in (('nccl', 'nccl'), ('plain', 'one'))]
    if _read_csv(paths[0]) != _read_csv(paths[1]):
        raise AssertionError('(a) evaluate through torchrun differs from '
                             'evaluate with no group')
    log(f'(a) one NCCL rank: {DP_STEPS} losses the same bits as no group '
        f'({nccl_losses[0]:.6f} -> {nccl_losses[-1]:.6f}), one checkpoint, '
        'evaluate results.csv the same')

    # (b): the seeded steps, evaluate, rank 0's files alone
    for spec in steps:
        _dp_step_check(spec['label'], spec['out'], refs[spec['label']],
                       device)
    _compare_results('(b) evaluate on 2 ranks against phase 6\'s 1 rank',
                     os.path.join(train_run, 'tfevents', 'dp', 'results.csv'),
                     os.path.join(train_run, 'tfevents', EVAL_TAG,
                                  'results.csv'))
    files = {name: sorted(os.listdir(os.path.join(*parts))) for name, parts in (
        ('evaluate', (train_run, 'tfevents', 'dp')),
        ('run', (runs['unbroken'],)),
        ('events', (runs['unbroken'], 'tfevents', 'train')))}
    if files['evaluate'] != ['casewise_results.csv', 'results.csv'] or \
            files['run'] != ['checkpoints', 'options.yaml', 'results.pkl',
                             'tfevents'] or len(files['events']) != 1:
        raise AssertionError(f'(b) files of the 2-rank runs: {files}')
    log(f'(b) files of the 2-rank runs, rank 0\'s alone: {files}')

    # (c): 2 ranks to k, one rank to 2k, against 2 ranks to 2k
    unbroken = _results_losses(runs['unbroken'])
    broken = _results_losses(runs['broken'])
    if broken != unbroken[:DP_STEPS]:
        raise AssertionError(f'(c) the 2-rank run to {DP_STEPS} {broken} '
                             f'against the unbroken run {unbroken}')
    resumed = cli(argv=train_argv(runs['broken'], 2 * DP_STEPS, one_card))
    if resumed.epoch != list(range(DP_STEPS + 1, 2 * DP_STEPS + 1)):
        raise AssertionError(f'(c) the resume ran steps {resumed.epoch}')
    worst = max(abs(a - b) / abs(b) for a, b in zip(
        resumed.history['loss'], unbroken[DP_STEPS:]))
    if not worst <= LOSS_TOL:
        raise AssertionError(f'(c) resumed losses {resumed.history["loss"]} '
                             f'against unbroken {unbroken[DP_STEPS:]}')
    log(f'(c) {DP_WORLD} ranks to step {DP_STEPS}, resumed by 1 rank to '
        f'{2 * DP_STEPS}: losses within {worst:.3e} relative of the '
        f'unbroken {DP_WORLD}-rank run')

    # (d): every visible card through the CLI's own spawn
    cards = torch.cuda.device_count() if device.type == 'cuda' else 1
    if cards < 2:
        log('nccl multi-card: 1 card visible, not run')
    else:
        multi = _dp('multi')
        res = cli(argv=train_argv(multi, DP_STEPS))
        worst = max(abs(a - b) / abs(b) for a, b in zip(
            res.history['loss'], plain.history['loss']))
        if res.epoch != list(range(1, DP_STEPS + 1)) or not worst <= LOSS_TOL:
            raise AssertionError(f'(d) {cards} cards: {res.history}')
        # the one-card run's checkpoint, evaluated on every card
        cli(argv=eval_argv(runs['plain'], 'multi'))
        _compare_results(f'(d) evaluate on {cards} cards',
                         os.path.join(runs['plain'], 'tfevents', 'multi',
                                      'results.csv'), paths[1])
        log(f'nccl multi-card: {cards} cards through the CLI\'s spawn, '
            f'losses within {worst:.3e} relative of one card')

    # the cost of the group at world size 1
    nccl_world1_cost(device, train_paths, train_run, smi)
    return steps, refs


# -- phase 19 -----------------------------------------------------------------
SPATIAL = 2            # spatial_partition of phase 19's launches
SP_WORLD = 4           # (c): ranks of the (data 2, model 2) launch
SP_TRAIN_STEPS = 4     # (b): the train CLI's steps, at N = 2 and N = 1
SP_COST_STEPS = (4, 12)   # (d): the differential Engine.train calls
SP_EVAL = (8, 512)     # (d): the eval step whose peak memory is read (B, H=W)


def _library_count(device):
    '''The kernel library's own launch count (``_build.library_launches``)
    on a CUDA device, else 0.'''
    if device.type != 'cuda':
        return 0
    from dnncancerannotator_torch.ops.kernels import _build
    torch.cuda.synchronize(device)
    return _build.library_launches()


def _kernel_module(name):
    import importlib
    return importlib.import_module(
        f'dnncancerannotator_torch.ops.kernels.{name}')


def _route_rules():
    '''{kernel module name: the route or launch geometry its wrapper takes
    for its arguments} (the functions the wrappers consult: ``plan`` where
    a TUNED table may override the rule, else ``route``).'''
    K = {n: _kernel_module(n) for n in (
        'conv_chain', 'conv_chain_bwd', 'stencil_conv', 'stencil_conv_bwd',
        'tconv2x2_bwd', 'warp_twopass', 'stencil_conv_nhwc', 'cca')}
    pads = K['stencil_conv']._pads
    return {
        'conv_chain': lambda x, w1, b1, w2, b2, *a, **k: K['conv_chain'].plan(
            x.shape[0], w1.shape[1], w1.shape[0], w2.shape[0], x.shape[2],
            x.shape[3], w1.shape[-1]),
        'conv_chain_bwd': lambda x, c1, c2, g, w1, w2, need_dx=True: K[
            'conv_chain_bwd'].plan(x.shape[0], w1.shape[1], w1.shape[0],
                                   w2.shape[0], x.shape[2], x.shape[3],
                                   w1.shape[-1], need_dx),
        'stencil_conv': lambda x, w, b, p, relu=False: K[
            'stencil_conv'].route(w.shape[1], w.shape[0], w.shape[2],
                                  w.shape[3], pads(p), x.shape[2],
                                  x.shape[3]),
        'stencil_conv_bwd': lambda x, g, w, p, need_dx=True: K[
            'stencil_conv_bwd'].route(x.shape[0], w.shape[1], w.shape[0],
                                      x.shape[2], x.shape[3], w.shape[2],
                                      w.shape[3], pads(p)),
        'tconv2x2_bwd': lambda x, g, w, need_dx=True: K['tconv2x2_bwd'].plan(
            x.shape[0], w.shape[0], w.shape[1], x.shape[2], x.shape[3],
            need_dx),
        'warp_twopass': lambda image, flow, max_displacement=8: K[
            'warp_twopass'].route(*image.shape, int(max_displacement)),
        'stencil_conv_nhwc': lambda x, w, b, p, relu=False: K[
            'stencil_conv_nhwc'].route(x.shape[0], x.shape[1], x.shape[2],
                                       w.shape[1], w.shape[0], w.shape[2],
                                       w.shape[3], pads(p),
                                       x.element_size()),
        'cca': lambda masks: K['cca'].route(*masks.shape)}


@contextlib.contextmanager
def _route_log():
    '''Within the block each kernel wrapper records its calls: the block
    yields a list of 'kernel [input shape] route' lines, one a distinct
    call, in call order.'''
    rules = _route_rules()
    names = ('conv_chain', 'conv_chain_bwd', 'stencil_conv',
             'stencil_conv_bwd', 'tconv2x2', 'tconv2x2_bwd', 'pool2x2_nhwc',
             'pool2x2_nhwc_bwd', 'tconv2x2_nhwc', 'tconv2x2_nhwc_bwd',
             'warp_twopass', 'stencil_conv_nhwc', 'cca')
    wrappers = {'cca': 'cca_raw_labels'}   # else the module's own name
    lines, saved = [], []
    for module_name in names:
        module = _kernel_module(module_name)
        name = wrappers.get(module_name, module_name)
        real = getattr(module, name)

        def logged(*args, _real=real, _name=module_name, **kwargs):
            rule = rules.get(_name)
            route = rule(*args, **kwargs) if rule else 'one route'
            line = f'{_name} {list(args[0].shape)} {route}'
            if line not in lines:
                lines.append(line)
            return _real(*args, **kwargs)
        saved.append((module, name, real))
        setattr(module, name, logged)
    try:
        yield lines
    finally:
        for module, name, real in saved:
            setattr(module, name, real)


def _rank_cost(job, device):
    '''(d): this rank's peak device memory over 3 train steps (after 2
    warm-up steps) and over one eval step of a seeded uint8 batch of
    SP_EVAL, each beside the memory allocated before it, and the train
    step's time from the differential ``Engine.train`` calls of
    SP_COST_STEPS (host clock, synchronized).'''
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.data import pipeline

    config = job['config']
    eng = engine.Engine(config, seed=SEED, device=device)
    ds = pipeline.train_ds(job['data_paths'],
                           **config['data_options']['train'])
    eng.train(ds, max_steps=2, save_freq=1 << 30)
    out = {}
    cuda = eng.device.type == 'cuda'   # else a CPU rehearsal

    def sync():
        if cuda:
            torch.cuda.synchronize(eng.device)

    def peak(key, call):
        if not cuda:   # not measured
            call()
            out[key] = (0, 0)
            return
        sync()
        torch.cuda.reset_peak_memory_stats(eng.device)
        before = torch.cuda.memory_allocated(eng.device)
        call()
        sync()
        out[key] = (torch.cuda.max_memory_allocated(eng.device), before)

    peak('train', lambda: eng.train(ds, max_steps=eng.current_step + 3,
                                    save_freq=1 << 30))
    seconds = {}
    for n in SP_COST_STEPS:
        sync()
        start = time.perf_counter()
        eng.train(ds, max_steps=eng.current_step + n, save_freq=1 << 30)
        sync()
        seconds[n] = time.perf_counter() - start
    short, long = SP_COST_STEPS
    out['step_ms'] = (seconds[long] - seconds[short]) / (long - short) * 1e3
    b, size = SP_EVAL
    gen = torch.Generator(device=eng.device).manual_seed(SEED + 19)
    raw = torch.randint(0, 256, (b, size, size, 6), generator=gen,
                        device=eng.device, dtype=torch.uint8)
    raw[..., -1] = torch.where(raw[..., -1] > 200, 255, 0)
    step = eng._make_eval_step(ds.slice_types)
    step(raw)
    peak('eval', lambda: step(raw))
    return out


def _spatial_config(config, spatial=SPATIAL):
    config = copy.deepcopy(config)
    config['deploy_options'].update(enable_multigpu=True,
                                    spatial_partition=spatial)
    return config


def _mib(n):
    return f'{n / 2 ** 20:.1f} MiB'


def spatial_slice(device, data_paths, train_paths, train_run, dp_steps, refs,
                  smi):
    '''Phase 19; see the module docstring.'''
    from dnncancerannotator_torch.runs.__main__ import main as cli
    from dnncancerannotator_torch.utils import config as config_lib

    work = _dp('spatial')   # beside phase 17's launches
    os.makedirs(work)
    one_card = f'{device.type}:0' if device.type == 'cuda' else device.type
    overlay = os.path.join(work, 'spatial.json')
    with open(overlay, 'w') as fh:
        json.dump({'deploy_options.metrics': _config(
            CONFIGS + (METRICS_CONFIG,))['deploy_options']['metrics'],
            'deploy_options.enable_multigpu': True,
            'deploy_options.spatial_partition': SPATIAL}, fh)
    configs = [os.path.join(REPO, c) for c in CONFIGS] + [
        os.path.join(WORK, 'steps_per_call.json')]

    def train_argv(save, on=device.type, spatial=True):
        return ['train', '--config', *configs,
                *([overlay] if spatial else []), '--save_path', save,
                '--data_path', *train_paths, '--save_freq',
                str(SP_TRAIN_STEPS // 2), '--validate', '--val_data_path',
                *data_paths, '--seed', str(SEED), '--device', on,
                '--max_steps', str(SP_TRAIN_STEPS)]

    def predict_argv(out, on=device.type, spatial=True):
        return ['predict', '--save_path', train_run, '--data_path',
                *data_paths, '--output_path', out, '--output_format', 'npy',
                '--batch_size', str(BATCH),
                *(['--config', overlay] if spatial else []), '--device', on]

    w = lambda *p: os.path.join(work, *p)   # noqa: E731
    steps = [dict(spec, config=_spatial_config(spec['config']),
                  out=w(spec['label'].replace(' ', '_'))) for spec in dp_steps]
    unet = config_lib.load_config(
        os.path.join(train_run, 'options.yaml'))['config']
    cost = dict(kind='cost', config=_spatial_config(unet),
                data_paths=train_paths, out=w('cost'))
    spec2 = _write_spec(os.path.join('spatial', 'two'), steps + [
        cost,
        dict(kind='cli', argv=['evaluate', '--save_path', train_run,
                               '--data_path', *data_paths, '--tag', 'spatial',
                               '--config', overlay, '--export_csv',
                               '--skip_visualization', '--device',
                               device.type]),
        dict(kind='cli', argv=predict_argv(w('maps_two'))),
        dict(kind='cli', argv=train_argv(w('train_two')))], device, 'gloo')
    spec4 = _write_spec(os.path.join('spatial', 'four'), [
        dict(steps[0], out=w('unet_four'), more=1)], device, 'gloo')
    launches = {'2 ranks': _torchrun(SPATIAL, spec2),
                f'{SP_WORLD} ranks': _torchrun(SP_WORLD, spec4)}
    try:
        # meanwhile in this process, one rank (no group): the cost, the maps
        # and the train CLI run
        start = time.perf_counter()
        one_cost = _rank_cost(dict(cost, config=unet), device)
        cli(argv=predict_argv(w('maps_one'), one_card, spatial=False))
        one_train = cli(argv=train_argv(w('train_one'), one_card,
                                        spatial=False))
        log(f'one-rank references: {time.perf_counter() - start:.2f} s')
    finally:
        for label, launch in launches.items():
            _finish(f'phase 19 {label}', launch)
    for path, world in [(f'{spec2}.rank{r}.json', SPATIAL)
                        for r in range(SPATIAL)] + [
            (f'{spec4}.rank{r}.json', SP_WORLD) for r in range(SP_WORLD)]:
        with open(path) as fh:
            info = json.load(fh)
        if info != dict(backend='gloo', world=world):
            raise AssertionError(f'phase 19 group {path}: {info}')

    # (a) the seeded steps at (data 1, model 2), each rank's routes
    for spec in steps:
        outs = _dp_step_check(spec['label'], spec['out'], refs[spec['label']],
                              device, world=SPATIAL, spatial=SPATIAL)
        for r, o in enumerate(outs):
            if device.type == 'cuda' and not o['library'] > 0:
                raise AssertionError(f'{spec["label"]}: rank {r} launched '
                                     'nothing by the library\'s count')
            log(f'  {spec["label"]} rank {r}: {o["library"]} launches by the '
                'library\'s count; each kernel call\'s route:')
            for line in o['routes']:
                log(f'    {line}')
    # (b) evaluate, predict and train through the CLI at N = 2
    _compare_results('(19) evaluate at spatial_partition 2 against phase 6\'s'
                     ' 1 rank', os.path.join(train_run, 'tfevents', 'spatial',
                                             'results.csv'),
                     os.path.join(train_run, 'tfevents', EVAL_TAG,
                                  'results.csv'))
    maps = [sorted(os.path.relpath(os.path.join(d, f), w(m))
                   for d, _, fs in os.walk(w(m)) for f in fs)
            for m in ('maps_two', 'maps_one')]
    if maps[0] != maps[1] or not maps[0]:
        raise AssertionError(f'(19) predict wrote {len(maps[0])} maps at N = '
                             f'2 and {len(maps[1])} at N = 1')
    worst = max(float(np.abs(np.load(w('maps_two', p)) -
                             np.load(w('maps_one', p))).max())
                for p in maps[0])
    if not worst <= MAP_TOL:
        raise AssertionError(f'(19) predict maps at N = 2 {worst} from N = 1')
    two_train = _results_losses(w('train_two'))
    worst_loss = max(abs(a - b) / abs(b) for a, b in zip(
        two_train, one_train.history['loss']))
    if len(two_train) != SP_TRAIN_STEPS or not worst_loss <= LOSS_TOL:
        raise AssertionError(f'(19) train at N = 2 {two_train} against N = 1 '
                             f'{one_train.history["loss"]}')
    log(f'(19) predict: {len(maps[0])} maps within {worst:.3e} of one rank; '
        f'train --validate {SP_TRAIN_STEPS} steps: losses within '
        f'{worst_loss:.3e} relative of one rank')
    # (c) (data 2, model 2): the seeded step and one more
    _dp_step_check('unet.yaml', w('unet_four'), refs['unet.yaml'], device,
                   world=SP_WORLD, spatial=SPATIAL)
    # (d) a rank's peak memory and the step time
    costs = {'N = 1': [one_cost], f'N = {SPATIAL}': [
        torch.load(f'{cost["out"]}.rank{r}.pt') for r in range(SPATIAL)]}
    for label, ranks in costs.items():
        for r, c in enumerate(ranks):
            log(f'(19) {label} rank {r}: unet.yaml train step '
                f'{c["step_ms"]:.3f} ms (B={TRAIN_BATCH}, {SIZE}^2); peak '
                f'{_mib(c["train"][0])} over 3 train steps '
                f'({_mib(c["train"][0] - c["train"][1])} above the '
                f'{_mib(c["train"][1])} before); eval step B={SP_EVAL[0]} at '
                f'{SP_EVAL[1]}^2 peak {_mib(c["eval"][0])} '
                f'({_mib(c["eval"][0] - c["eval"][1])} above '
                f'{_mib(c["eval"][1])}); {smi}')
    # (e) every visible card through the CLI's own spawn
    cards = torch.cuda.device_count() if device.type == 'cuda' else 1
    if cards < 2 or cards % SPATIAL:
        log(f'spatial multi-card: {cards} card(s) visible, not run')
    else:
        res = cli(argv=train_argv(w('train_multi')))
        worst = max(abs(a - b) / abs(b) for a, b in zip(
            res.history['loss'], one_train.history['loss']))
        if res.epoch != list(range(1, SP_TRAIN_STEPS + 1)) or \
                not worst <= LOSS_TOL:
            raise AssertionError(f'(19) {cards} cards: {res.history}')
        log(f'spatial multi-card: {cards} cards through the CLI\'s spawn '
            f'(NCCL, {cards // SPATIAL} data groups of {SPATIAL}), losses '
            f'within {worst:.3e} relative of one card')


# -- phase 18 -----------------------------------------------------------------
# extract_all: a seeded tree of EX_EXAMS (cancer, healthy) exams of EX_SLICES
# clinical collages each, in tests/test_extract.py's grid (1080 x 1600, 2 x 3
# panes of EX_PANE px behind 1-px bright lines), extracted by the CLI on the
# card, then packed, trained on and evaluated
EX_SHAPE = (1080, 1600)
EX_PANE = 520
EX_START = 20
EX_EXAMS = (4, 4)
EX_SLICES = 8
EX_SHIFT = 6            # the grid's seeded offset, at most this many px
EX_IOU = 0.85           # a label against the generator's filled annotation
EX_TRAIN_STEPS = 5
EX_TIMED = 10           # detection times: the median of this many, in turns
# annotation and ruler colours (BGR): blue stays under the detector's
# separator value (100), so the grid alone binarises
EX_COLOURS = ((0, 0, 255), (0, 255, 0), (0, 255, 255), (60, 20, 230))


def _disc(h, w, cy, cx, r):
    yy, xx = np.mgrid[:h, :w]
    return (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r


def _ellipse(h, w, cy, cx, a, b, angle):
    yy, xx = np.mgrid[:h, :w]
    u = (xx - cx) * np.cos(angle) + (yy - cy) * np.sin(angle)
    v = -(xx - cx) * np.sin(angle) + (yy - cy) * np.cos(angle)
    return (u / a) ** 2 + (v / b) ** 2 <= 1


def annotation(rng, size, ruler=False):
    """A seeded hand annotation of a size x size label pane: (outline mask,
    filled mask), a ring, an ellipse outline or a filled blob within the
    extractor's central disc; with ``ruler`` a ring or a blob (see
    screenshot). A blob stays under 100 px across: the extractor's Hough
    step takes any straight run of 100 px for a ruler."""
    c = size // 2
    cy, cx = c + rng.integers(-30, 31, 2)
    kinds = ('ring', 'blob') if ruler else ('ring', 'ellipse', 'blob')
    kind = kinds[rng.integers(len(kinds))]
    width = int(rng.integers(2, 4))
    if kind == 'ring':
        r = int(rng.integers(40, 81))
        filled = _disc(size, size, cy, cx, r)
        outline = filled & ~_disc(size, size, cy, cx, r - width)
    elif kind == 'ellipse':
        a, b = int(rng.integers(45, 86)), int(rng.integers(30, 60))
        angle = rng.uniform(0, np.pi)
        filled = _ellipse(size, size, cy, cx, a, b, angle)
        outline = filled & ~_ellipse(size, size, cy, cx, a - width,
                                     b - width, angle)
    else:
        filled = np.zeros((size, size), bool)
        for _ in range(3):
            dy, dx = rng.integers(-15, 16, 2)
            filled |= _disc(size, size, cy + dy, cx + dx,
                            int(rng.integers(15, 31)))
        outline = filled
    return outline, filled, (cy, cx)


def screenshot(seed, annotate=False, ruler=False):
    """A seeded clinical collage: (BGR uint8 [1080, 1600, 3], the six
    boxes (startx, starty, endx, endy) the detector reads off its grid, the
    label pane's filled annotation or None). The grid sits EX_SHIFT px
    around EX_START, each pane a smooth monochrome image under 100 (the
    detector's separator); a cancer label pane carries a coloured ring,
    ellipse outline or blob, with ``ruler`` a ring or blob and a 1-px
    coloured line of 150-300 px from its centre out across it."""
    from dnncancerannotator_torch.ops import raster

    rng = np.random.default_rng(seed)
    h, w = EX_SHAPE
    p = EX_PANE
    y0, x0 = (EX_START + rng.integers(-EX_SHIFT, EX_SHIFT + 1, 2)).tolist()
    img = np.full((h, w, 3), 40, np.uint8)
    yy, xx = np.mgrid[:p - 2, :p - 2]
    for r in range(2):
        for c in range(3):
            fy, fx = rng.uniform(0.005, 0.03, 2)
            pane = (50 + 8 * (r * 3 + c) + 20 * np.sin(fy * yy) * np.cos(
                fx * xx) + rng.integers(0, 4, (p - 2, p - 2)))
            img[y0 + r * p + 2:y0 + (r + 1) * p,
                x0 + c * p + 2:x0 + (c + 1) * p] = pane.astype(
                    np.uint8)[..., None]
    for y in (y0, y0 + p, y0 + 2 * p):
        img[y, :, :] = 255
    for x in (x0, x0 + p, x0 + 2 * p, min(x0 + 3 * p, w - 1)):
        img[:, x, :] = 255
    # the detector's boxes: one past each pane's far line
    size = p + 1
    boxes = [(y0 + r * size, x0 + c * size, y0 + (r + 1) * size,
              x0 + (c + 1) * size) for r in range(2) for c in range(3)]
    filled = None
    if annotate:
        sy, sx, ey, ex = boxes[0]
        pane = img[sy:ey, sx:ex]
        outline, filled, (cy, cx) = annotation(rng, size, ruler)
        pane[outline] = EX_COLOURS[rng.integers(len(EX_COLOURS))]
        if ruler:
            # from the annotation's centre along an axis: it crosses a
            # ring where the ring runs across it, a gap the extractor's
            # square closing bridges again (a slanted one it does not, in
            # the JAX package too: the label is then the outline alone)
            length = int(rng.integers(150, 301))
            dy, dx = ((0, 1), (1, 0), (0, -1), (-1, 0))[rng.integers(4)]
            colour = EX_COLOURS[rng.integers(len(EX_COLOURS))]
            ruled = np.zeros((size, size), np.uint8)
            raster.draw_line(ruled, (cx, cy), (cx + dx * length,
                                               cy + dy * length), 1)
            pane[ruled > 0] = colour
    return img, boxes, filled


def write_collage_tree(root, n_exams=EX_EXAMS, n_slices=EX_SLICES):
    """root/{cancer,healthy}/<pid>/1/<s>.png of seeded screenshots (the
    cancer ones annotated, every second one with a ruler), written with the
    port's imwrite by 8 threads. Returns {path: (image, boxes, filled,
    ruler)}."""
    from concurrent.futures import ThreadPoolExecutor
    from dnncancerannotator_torch.ops import raster

    jobs = []
    for category, n in zip(('cancer', 'healthy'), n_exams):
        for pid in range(1, n + 1):
            exam = os.path.join(root, category, str(pid), '1')
            os.makedirs(exam)
            for s in range(1, n_slices + 1):
                seed = (SEED + 18) * 10000 + (category == 'cancer') * 1000 \
                    + pid * 100 + s
                jobs.append((os.path.join(exam, f'{s:02d}.png'), seed,
                             category == 'cancer', s % 2 == 0))

    def write(job):
        path, seed, annotate, ruler = job
        shot = screenshot(seed, annotate, ruler)
        raster.imwrite(path, shot[0])
        return path, shot + (ruler,)

    with ThreadPoolExecutor(8) as pool:
        return dict(pool.map(write, jobs))


def _png(path):
    """A PNG's decoded array, as stored."""
    from PIL import Image
    with Image.open(path) as img:
        return np.asarray(img)


def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _scipy_responses(binary):
    """scipy.signal.convolve2d of one binary collage with the two corner
    filters, as the JAX package's host path computes them."""
    from scipy import signal
    from dnncancerannotator_torch.runs import extract as ex

    filt = ex.get_orthogonal_detector(25)
    return [signal.convolve2d(binary, np.flip(f), 'valid')
            for f in (filt, np.flip(filt))]


def _cpu_extract(tree):
    """extract_all on the CPU path, serially: its seconds."""
    from dnncancerannotator_torch.runs import extract as ex

    start = time.perf_counter()
    ex.extract_all(tree, debug=True, num_workers=0, device='cpu')
    return time.perf_counter() - start


def ruler_erased(p, pane, filled, label):
    """(d) on a ruled label pane: the Hough step finds a line on it, and
    no ruler pixel outside the annotation survives in the label. Without
    a line found, every such pixel in the extractor's central disc would
    (the closing keeps what it closes); returns their count."""
    from dnncancerannotator_torch.ops import raster
    from dnncancerannotator_torch.runs import extract as ex

    colour = ~ex._monochrome_mask(pane)
    lines = raster.hough_lines_p(colour[..., None].astype(np.uint8) * 255,
                                 0.5, np.pi / 1800, 50, min_line_length=100,
                                 max_line_gap=2)
    stray = colour & ~filled & (ex._center_mask(filled.shape) > 0)
    if not len(lines) or not stray.any():
        raise AssertionError(f'{p}: {len(lines)} Hough lines, '
                             f'{stray.sum()} ruler px in the disc')
    if (label & stray).any():
        raise AssertionError(f'{p}: {(label & stray).sum()} of the ruler\'s '
                             f'{stray.sum()} px outside the annotation '
                             'survive in the label')
    return int(stray.sum())


def extract_checks(device, shots, tree, cpu_tree):
    """(a) the panes and boxes, (c) the tree against the CPU run's, (d)
    each label's IoU with its annotation and the rulers erased, (e) no
    healthy label."""
    from dnncancerannotator_torch.runs import extract as ex

    kinds = {'DCEE': 1, 'DCEL': 2, 'DWI': 3, 'ADC': 4, 'TRA': 5}
    paths = sorted(shots)
    for p in paths:                                            # (a)
        boxes = [tuple(map(int, b)) for b in ex.detect_internals(
            shots[p][0], device=device)]
        if boxes != shots[p][1]:
            raise AssertionError(f'{p}: boxes {boxes}, the grid '
                                 f'{shots[p][1]}')
    ious, erased = [], []
    for p in paths:
        img, boxes, filled, ruler = shots[p]
        exam, name = os.path.split(p)
        for kind, i in kinds.items():
            sx, sy, ex_, ey = boxes[i]
            got = ex.raster.imread_bgr(os.path.join(exam, kind, name))
            if not np.array_equal(got, img[sx:ex_, sy:ey]):
                raise AssertionError(f'{p}: the {kind} pane differs from '
                                     'the generator\'s')
        label_dir = os.path.join(exam, 'label')
        if filled is None:                                     # (e)
            if os.path.exists(label_dir):
                raise AssertionError(f'{exam}: a healthy exam with labels')
            continue
        label = _png(os.path.join(label_dir, name)) > 0        # (d)
        iou = (label & filled).sum() / (label | filled).sum()
        ious.append(float(iou))
        if not iou >= EX_IOU:
            raise AssertionError(f'{p}: label IoU {iou:.4f} < {EX_IOU}')
        if ruler:
            sx, sy, ex_, ey = boxes[0]
            erased.append(ruler_erased(p, img[sx:ex_, sy:ey], filled,
                                       label))
    files = _tree_files(tree)                                  # (c)
    if files != _tree_files(cpu_tree):
        raise AssertionError('the card\'s tree and the CPU run\'s hold '
                             'other files')
    for rel in files:
        if not np.array_equal(_png(os.path.join(tree, rel)),
                              _png(os.path.join(cpu_tree, rel))):
            raise AssertionError(f'{rel}: the card\'s run and the CPU '
                                 'run\'s differ')
    n_written = sum(1 for f in files if os.path.dirname(f).split(
        os.sep)[-1] in (*kinds, 'label', 'label_comparison'))
    log(f'extract_all: {n_written} files equal to the CPU run\'s, every '
        f'pane the generator\'s, label IoU min {min(ious):.4f} median '
        f'{statistics.median(ious):.4f} over {len(ious)} (limit {EX_IOU}); '
        f'{len(erased)} rulers found by Hough, none of their '
        f'{min(erased)}-{max(erased)} px outside the annotation in the '
        'label')


def extract_responses(device, shots, scipy_jobs):
    """(b) The card's corner responses on 4 collages against the CPU path,
    and on 2 of them (computed in ``scipy_jobs``) against scipy."""
    from dnncancerannotator_torch.runs import extract as ex

    filt = ex.get_orthogonal_detector(25)
    paths = sorted(shots)[:4]
    for i, p in enumerate(paths):
        binary = (ex._gray(shots[p][0]) >= 100).astype(np.uint8)
        for f in (filt, np.flip(filt)):
            card = ex.corner_response(binary, f, device).cpu().numpy()
            cpu = ex.corner_response(binary, f, 'cpu').numpy()
            if not np.array_equal(card, cpu):
                raise AssertionError(f'{p}: the card\'s corner response '
                                     'differs from the CPU path\'s')
        if i < len(scipy_jobs):
            want = scipy_jobs[i].result()
            got = [ex.corner_response(binary, f, device).cpu().numpy()
                   for f in (filt, np.flip(filt))]
            if not all(np.array_equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f'{p}: the card\'s corner response '
                                     'differs from scipy\'s')
    log(f'corner responses: {len(paths)} collages bit-equal to the CPU '
        f'path, {len(scipy_jobs)} to scipy.signal.convolve2d')


def extract_times(device, shots, smi):
    """Detection ms a collage, the card against the CPU path (in turns,
    the median of EX_TIMED), and extract_label ms a pane."""
    from dnncancerannotator_torch.runs import extract as ex

    img = shots[sorted(shots)[0]][0]
    times = {'card': [], 'cpu': []}
    for dev in (device, 'cpu'):                    # warm-up
        ex.detect_internals(img, device=dev)
    for _ in range(EX_TIMED):
        for key, dev in (('card', device), ('cpu', 'cpu')):
            start = time.perf_counter()
            ex.detect_internals(img, device=dev)
            times[key].append(time.perf_counter() - start)
    panes = [shot[0][shot[1][0][0]:shot[1][0][2], shot[1][0][1]:shot[1][0][3]]
             for shot in shots.values() if shot[2] is not None]
    label_s = []
    for pane in panes:
        start = time.perf_counter()
        ex.extract_label(pane, kernel_size=5, iterations=7)
        label_s.append(time.perf_counter() - start)
    ms = {k: 1e3 * statistics.median(v) for k, v in times.items()}
    log(f'detect_internals ms a 1080x1600 collage (median of {EX_TIMED}, '
        f'in turns, host clock): card {ms["card"]:.3f}, CPU path '
        f'{ms["cpu"]:.3f} [{smi}]')
    log(f'extract_label ms a {EX_PANE + 1}^2 pane (host): median '
        f'{1e3 * statistics.median(label_s):.1f}, max '
        f'{1e3 * max(label_s):.1f} over {len(panes)} [{smi}]')


def extract_chain(device, tree, work):
    """(f) The extracted tree through generate_tfrecords (512^2 crops),
    EX_TRAIN_STEPS train steps of the unet.yaml stack and one evaluate."""
    from dnncancerannotator_torch.runs.__main__ import main as cli

    records = os.path.join(work, 'extracted.tfrecords')
    n, seconds = _timed(lambda: cli(argv=[
        'generate_tfrecords', '--path', tree, '--output', records,
        '--output_size', '512', '512']))
    if n != sum(EX_EXAMS):
        raise AssertionError(f'generate_tfrecords wrote {n} exams')
    save_path = os.path.join(work, 'run')
    res, train_s = _timed(lambda: cli(argv=[
        'train', '--config', *[os.path.join(REPO, c) for c in CONFIGS],
        '--save_path', save_path, '--data_path', records, '--max_steps',
        str(EX_TRAIN_STEPS), '--save_freq', str(EX_TRAIN_STEPS), '--seed',
        str(SEED), '--device', device.type]))
    if res.epoch != list(range(1, EX_TRAIN_STEPS + 1)) or \
            not np.isfinite(res.history['loss']).all():
        raise AssertionError(f'train on the extracted tree: {res.epoch}, '
                             f'{res.history["loss"]}')
    _, eval_s = _timed(lambda: cli(argv=[
        'evaluate', '--save_path', save_path, '--data_path', records,
        '--tag', 'extracted', '--export_csv', '--skip_visualization',
        '--device', device.type]))
    table = _read_csv(os.path.join(save_path, 'tfevents', 'extracted',
                                   'results.csv'))
    loss = table[1][table[0].index('loss')]
    if len(table) != 2 or not np.isfinite(float(loss)):
        raise AssertionError(f'evaluate on the extracted tree: {table}')
    log(f'extracted tree: generate_tfrecords {n} exams in {seconds:.2f} s, '
        f'train {EX_TRAIN_STEPS} steps in {train_s:.2f} s (loss '
        f'{res.history["loss"][0]:.4f} -> {res.history["loss"][-1]:.4f}), '
        f'evaluate in {eval_s:.2f} s (loss {loss})')


def extract_slice(device, smi):
    """Phase 18: extract_all on the card through the CLI, (a)-(f)."""
    import multiprocessing
    import re
    from concurrent.futures import ProcessPoolExecutor
    from dnncancerannotator_torch.runs import extract as ex

    work = os.path.join(WORK, 'extract')
    tree, cpu_tree = os.path.join(work, 'tree'), os.path.join(work, 'cpu')
    shots, seconds = _timed(lambda: write_collage_tree(tree))
    shutil.copytree(tree, cpu_tree)
    log(f'collage tree: {len(shots)} screenshots of {EX_SHAPE[0]}x'
        f'{EX_SHAPE[1]} in {seconds:.2f} s')
    env = dict(os.environ, PYTHONPATH=REPO)
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'dnncancerannotator_torch', 'extract_all',
         '--path', tree, '--debug', '--device', device.type], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - start
    if proc.returncode != 0:
        raise AssertionError(f'extract_all CLI: rc {proc.returncode}\n'
                             f'{proc.stderr[-4000:]}')
    found = re.search(r'Extracted (\d+) slices in ([0-9.]+) s', proc.stderr)
    if not found or int(found.group(1)) != len(shots):
        raise AssertionError(f'extract_all CLI: {proc.stderr[-2000:]}')
    inner = float(found.group(2))
    log(f'extract_all CLI on the card ({os.cpu_count()} workers): '
        f'{len(shots)} collages in {inner:.2f} s inside extract_all, '
        f'{len(shots) / inner:.2f} collages/s; the process {wall:.2f} s '
        f'[{smi}]')
    # the CPU reference run and scipy's host correlation of 2 collages in
    # spawned processes, beside (f) on the card
    binaries = [(ex._gray(shots[p][0]) >= 100).astype(np.float32)
                for p in sorted(shots)[:2]]
    with ProcessPoolExecutor(3, mp_context=multiprocessing.get_context(
            'spawn')) as pool:
        cpu_job = pool.submit(_cpu_extract, cpu_tree)
        scipy_jobs = [pool.submit(_scipy_responses, b) for b in binaries]
        extract_chain(device, tree, work)
        extract_responses(device, shots, scipy_jobs)
        log(f'extract_all on the CPU path, serial (in a process of its '
            f'own, beside (f)): {cpu_job.result():.2f} s')
    extract_checks(device, shots, tree, cpu_tree)
    bad = os.path.join(work, 'bad')                            # (e)
    os.makedirs(os.path.join(bad, 'cancer'))
    os.makedirs(os.path.join(bad, 'healthy', '9', '1'))
    ex.raster.imwrite(os.path.join(bad, 'healthy', '9', '1', '01.png'),
                      screenshot(SEED + 19, annotate=True)[0])
    try:
        ex.extract_all(bad, num_workers=0, device=device)
    except AssertionError as exc:
        log(f'a healthy exam with a coloured pane raises: {exc}')
    else:
        raise AssertionError('a healthy exam with a label did not raise')
    extract_times(device, shots, smi)


# -- phase 20 -----------------------------------------------------------------
# the JAX package's Orbax checkpoints: the committed fixtures of
# tools/make_torch_orbax_fixture.py (unet.yaml at full width, unet_big with 4
# first filters), each run directory beside the flat arrays the JAX engine
# saved (``<name>.expected.npz``)
ORBAX_FIXTURES = os.path.join(REPO, 'tests', 'fixtures_torch', 'orbax')
ORBAX_NAMES = ('unet', 'bn')
ORBAX_STEPS = 3          # train steps of each resume
ORBAX_TIMED = 10         # load timings a fixture and format, in turns
# phase 20's train overlay: the bank and the chunk of a 3-step resume
ORBAX_OVERLAY = {'deploy_options.warp_bank_size': 16,
                 'deploy_options.steps_per_call': ORBAX_STEPS}


def _orbax_fixture(name):
    '''(run directory, checkpoint directory, expected flat dict).'''
    run = os.path.join(ORBAX_FIXTURES, name)
    (ckpt,) = os.listdir(os.path.join(run, 'checkpoints'))
    with np.load(os.path.join(ORBAX_FIXTURES, f'{name}.expected.npz')) as npz:
        expected = {k: npz[k] for k in npz.files}
    return run, os.path.join(run, 'checkpoints', ckpt), expected


def _same_bits(label, got, want):
    if sorted(got) != sorted(want):
        raise AssertionError(f'{label}: keys {sorted(set(got) ^ set(want))}')
    for key, value in want.items():
        g = np.asarray(got[key])
        if (g.dtype, g.shape) != (value.dtype, value.shape) or \
                g.tobytes() != value.tobytes():
            raise AssertionError(f'{label}: {key} differs')


def _orbax_runs(work, name):
    """A copy of fixture ``name``'s JAX run and its npz twin (options.yaml
    with ORBAX_OVERLAY, ``params.npz`` and ``opt_state.npz`` written from
    expected.npz in the port's layout); returns (jax run, twin, step)."""
    import yaml
    from dnncancerannotator_torch.utils import config as config_lib

    src, ckpt, expected = _orbax_fixture(name)
    jax_run, twin = (os.path.join(work, n) for n in (name, f'{name}_twin'))
    shutil.copytree(src, jax_run)
    options_path = os.path.join(jax_run, 'options.yaml')
    with open(options_path) as fh:
        options = yaml.safe_load(fh)
    options['config'] = config_lib.apply_config(options['config'],
                                                dict(ORBAX_OVERLAY))
    with open(options_path, 'w') as fh:
        yaml.safe_dump(options, fh)
    twin_ckpt = os.path.join(twin, 'checkpoints', os.path.basename(ckpt))
    os.makedirs(twin_ckpt)
    shutil.copy(options_path, twin)
    model = {k: v for k, v in expected.items()
             if k.split('/')[0] in ('params', 'batch_stats')}
    np.savez(os.path.join(twin_ckpt, 'params.npz'), **model)
    np.savez(os.path.join(twin_ckpt, 'opt_state.npz'),
             **{k: v for k, v in expected.items()
                if k not in model and k != 'count'})
    return jax_run, twin, int(expected['step'])


def _files_equal(label, a, b):
    '''Every file under ``a`` has the bytes of the same file under ``b``;
    returns their number.'''
    names, other = (sorted(os.path.relpath(os.path.join(d, f), root)
                           for d, _, files in os.walk(root) for f in files)
                    for root in (a, b))
    if names != other or not names:
        raise AssertionError(f'{label}: {len(names)} and {len(other)} files')
    for name in names:
        with open(os.path.join(a, name), 'rb') as fa, \
                open(os.path.join(b, name), 'rb') as fb:
            if fa.read() != fb.read():
                raise AssertionError(f'{label}: {name} differs')
    return len(names)


def _counted(label, fn, need=()):
    '''fn() with every kernel count set to 0 before it; raises if a kernel
    of ``need`` did not launch. Returns (its result, the counts).'''
    from dnncancerannotator_torch.ops import kernels
    kernels.reset_launches()
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    counts = {k: n for k, n in kernels.launch_counts().items() if n}
    missing = [k for k in need if not counts.get(k)]
    if missing:
        raise AssertionError(f'{label}: {missing} never launched ({counts})')
    return out, counts


def orbax_load_rates(smi):
    '''(e) Each fixture's load (``engine.read_ckpt``: the Orbax reader, and
    np.load of its npz twin, in turns) and the decoder's rate over its
    chunks, median of ORBAX_TIMED, on the host of the card.'''
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.ckpt import ocdbt, zstd

    for name in ORBAX_NAMES:
        _, ckpt, _ = _orbax_fixture(name)
        twin = os.path.join(WORK, 'orbax', f'{name}_twin', 'checkpoints',
                            os.path.basename(ckpt))
        times = {'orbax': [], 'npz': []}
        for _ in range(ORBAX_TIMED):
            for label, path in (('orbax', ckpt), ('npz', twin)):
                start = time.perf_counter()
                engine.read_ckpt(path)
                times[label].append(time.perf_counter() - start)
        store = ocdbt.OcdbtStore(ckpt)
        frames = [store.read(k) for k in store.keys()
                  if not k.endswith('/.zarray')]
        sizes = [len(zstd.decompress(f)) for f in frames]
        decode = []
        for _ in range(ORBAX_TIMED):
            start = time.perf_counter()
            for frame, size in zip(frames, sizes):
                zstd.decompress(frame, size)
            decode.append(time.perf_counter() - start)
        total = sum(sizes)
        ms = {k: statistics.median(v) * 1e3 for k, v in times.items()}
        log(f'phase 20 load {name}: Orbax {ms["orbax"]:.3f} ms, npz twin '
            f'{ms["npz"]:.3f} ms (engine.read_ckpt, median of '
            f'{ORBAX_TIMED}, in turns); zstd {len(frames)} chunks, '
            f'{sum(map(len, frames))} -> {total} bytes at '
            f'{total / statistics.median(decode) / 1e6:.1f} MB/s (median of '
            f'{ORBAX_TIMED}) [{smi}]')


def orbax_slice(device, data_paths, train_paths, smi):
    '''Phase 20; see the module docstring.'''
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.ckpt import orbax
    from dnncancerannotator_torch.data import _native, pipeline
    from dnncancerannotator_torch.runs.__main__ import main as cli
    from dnncancerannotator_torch.utils import config as config_lib

    # (a) the host library and every array of both fixtures
    _native.library()
    for name in ORBAX_NAMES:
        _, ckpt, expected = _orbax_fixture(name)
        _same_bits(f'phase 20 {name}', orbax.read_checkpoint(ckpt), expected)
        log(f'phase 20 read {name}: {len(expected)} arrays the same bits as '
            f'{name}.expected.npz ({os.path.basename(ckpt)})')
    work = os.path.join(WORK, 'orbax')
    runs = {name: _orbax_runs(work, name) for name in ORBAX_NAMES}

    # (b) predict on the unet.yaml JAX run and on its twin
    jax_run, twin, step = runs['unet']
    maps = {}
    for label, save in (('jax_run', jax_run), ('twin', twin)):
        out = os.path.join(work, f'maps_{label}')
        n, counts = _counted(f'phase 20 predict {label}', lambda: cli(argv=[
            'predict', '--save_path', save, '--data_path', *data_paths,
            '--output_path', out, '--output_format', 'npy', '--device',
            device.type]), ('conv_chain', 'tconv2x2', 'stencil_conv'))
        maps[label] = out
        log(f'phase 20 predict {label}: {n} maps, launches {counts}')
    n = _files_equal('phase 20 predict', maps['jax_run'], maps['twin'])
    log(f'phase 20 predict: {n} maps of the JAX run the same bytes as the '
        'twin\'s')

    # (c) evaluate both with metrics.yaml
    metrics_config = os.path.join(REPO, METRICS_CONFIG)
    for label, save in (('jax_run', jax_run), ('twin', twin)):
        _, counts = _counted(f'phase 20 evaluate {label}', lambda: cli(argv=[
            'evaluate', '--save_path', save, '--data_path', *data_paths,
            '--tag', 'orbax', '--config', metrics_config, '--export_csv',
            '--skip_visualization', '--device', device.type]),
            ('conv_chain', 'cca'))
        log(f'phase 20 evaluate {label}: launches {counts}')
    tables = [os.path.join(s, 'tfevents', 'orbax', name)
              for name in ('results.csv', 'casewise_results.csv')
              for s in (jax_run, twin)]
    for path, twin_path in zip(tables[::2], tables[1::2]):
        with open(path, 'rb') as fa, open(twin_path, 'rb') as fb:
            if fa.read() != fb.read():
                raise AssertionError(f'phase 20 evaluate: {path} differs '
                                     'from the twin\'s')
    rows = _read_csv(tables[0])
    log(f'phase 20 evaluate: results.csv {rows} and casewise_results.csv '
        'the same bytes as the twin\'s')

    # (d) train resumes from both fixtures and from their twins
    need = {'unet': tuple(TRAIN_SITES), 'bn': ('warp_twopass',)}
    for name, (jax_run, twin, step) in runs.items():
        got = {}
        for label, save in (('jax_run', jax_run), ('twin', twin)):
            config = config_lib.load_config(
                os.path.join(save, 'options.yaml'))['config']

            def resume():
                eng = engine.Engine(config, seed=SEED, device=device)
                with _deterministic_cudnn():
                    res = eng.train(pipeline.train_ds(
                        train_paths, **config['data_options']['train']),
                        save_path=save, max_steps=step + ORBAX_STEPS,
                        save_freq=10 ** 6)
                return res, eng.model.state_dict()

            (res, params), counts = _counted(
                f'phase 20 train {name} {label}', resume, need[name])
            got[label] = (res.epoch, res.history['loss'], params)
            log(f'phase 20 train {name} {label}: steps {res.epoch}, losses '
                f'{res.history["loss"]}, launches {counts}')
        (epoch, loss, params), (epoch_t, loss_t, params_t) = \
            got['jax_run'], got['twin']
        if epoch != epoch_t or epoch != list(range(step + 1, step + 1 +
                                                   ORBAX_STEPS)):
            raise AssertionError(f'phase 20 train {name}: steps {epoch}, '
                                 f'{epoch_t} after step {step}')
        if loss != loss_t or not np.isfinite(loss).all():
            raise AssertionError(f'phase 20 train {name}: losses {loss}, '
                                 f'twin {loss_t}')
        moved = [k for k in params if not torch.equal(params[k], params_t[k])]
        if moved:
            raise AssertionError(f'phase 20 train {name}: {moved} differ')
        log(f'phase 20 train {name}: {ORBAX_STEPS} steps from step {step}, '
            f'losses and {len(params)} tensors the same bits as the twin\'s')

    # (e) load and decode rates
    orbax_load_rates(smi)


# -- phase 21 ----------------------------------------------------------------
# the model geometries past unet.yaml's, at its widths: upsampling rate 3
# through the CLI (3 ** 3 must divide the crop: 243 = 3 ** 5 is the full-
# width size nearest the shipped 256), a seeded step at rate 4, a VALID
# model's zero-pad stencil sites, and strided forwards
GEO_RATE = 3
GEO_SIZE = 243
GEO_STEPS = 50                  # two chunks of STEPS_PER_CALL
GEO_SIDES = (243, 81, 27)       # the chain planes at rate 3
GEO_OVERLAY = {'model_options.rate': GEO_RATE,
               'data_options.train.output_size': [GEO_SIZE, GEO_SIZE],
               'data_options.eval.output_size': [GEO_SIZE, GEO_SIZE],
               'deploy_options.steps_per_call': STEPS_PER_CALL}
# unet.yaml at VALID: 256 in, 196 out (three levels of two 3x3 VALID convs)
VALID_OUT = 196
# strided forwards: the sizes whose pools leave no plane empty, and the
# output side the geometry gives there
STRIDE_CASES = (
    ('unet.yaml', CONFIGS, {}, 512, 1),
    ('mulmo_unet.yaml', MULMO_CONFIGS[:3], {'model_options.n_downsample': 2},
     512, 2),
)


def _time_sites(fns):
    '''``_time_fns`` of a site, logged: CUDA-event ms, median of
    TIMED_RUNS, in turns. No profiler window: torch.profiler dropped the
    records of most of these kernels, and the windows lengthen phase 9.'''
    t = _time_fns(fns)
    log('    ' + '  '.join(f'{key} ms {ms:.4f}' for key, ms in t.items()))
    return t


def _geometry_chain_sites(model, raw_x, device):
    '''The rate-3 model's chains at B=8 on the activations of a seeded
    forward: each forward (with c1, as training calls it) and backward
    kernel against its plain version (phase 3b's rules), launches by the
    library's count (a backward whose plan is not fused takes csrc/wgrad.cu
    too: CHAIN_BWD_SPLIT_LAUNCHES), times beside the plain version, and
    bounds.'''
    from dnncancerannotator_torch.models import blocks
    from dnncancerannotator_torch.ops.kernels import conv_chain as CC
    from dnncancerannotator_torch.ops.kernels import conv_chain_bwd as CCB

    chains = {path: m for path, m in model.named_modules()
              if isinstance(m, blocks.ConvChain) and m.fused}
    seen = {}
    hooks = [m.register_forward_hook(
        lambda mod, args, out, path=path: seen.__setitem__(path, args[0]))
        for path, m in chains.items()]
    with torch.no_grad():
        model(raw_x)
    for hook in hooks:
        hook.remove()
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    for path, chain in chains.items():
        x = seen[path].contiguous()
        w1, b1 = chain.conv_0.weight.detach(), chain.conv_0.bias.detach()
        w2, b2 = chain.conv_1.weight.detach(), chain.conv_1.bias.detach()
        b, ci, h, w = x.shape
        cm, co, k = w1.shape[0], w2.shape[0], w1.shape[-1]
        name = (f'conv_chain B={b} {path} {ci}->{cm}->{co} @{h}x{w} '
                f'{CC.plan(b, ci, cm, co, h, w, k)}')
        with torch.no_grad():
            c1, c2 = CC.conv_chain(x, w1, b1, w2, b2, need_c1=True)
            p1, p2 = CC.plain(x, w1, b1, w2, b2)
            _check_close(name + ' c2', c2, p2)
            _check_close(name + ' c1', c1, p1)
        _check_launches(name, lambda: CC.conv_chain(x, w1, b1, w2, b2,
                                                    need_c1=True), 1)
        _time_sites({'kernel': lambda: CC.conv_chain(x, w1, b1, w2, b2,
                                                     need_c1=True),
                     'plain': lambda: CC.plain(x, w1, b1, w2, b2)})
        site = bound(nbytes(x, w1, b1, w2, b2, c1, c2),
                     2 * b * h * w * k * k * (ci * cm + cm * co))
        log(f'  {name} bound {site[0]:.4f} ms ({site[1]})')
        g = torch.randn(c2.shape, generator=gen, device=device)
        plan = CCB.plan(b, ci, cm, co, h, w, k, True)
        name = f'conv_chain_bwd B={b} {path} @{h}x{w} {plan}'
        got = CCB.conv_chain_bwd(x, c1, c2, g, w1, w2)
        want = CCB.plain(x, c1, c2, g, w1, w2)
        want64 = CCB.plain(*_f64(x, c1, c2, g, w1, w2))
        _check_grads(name, got, want, want64)
        _check_launches(name, lambda: CCB.conv_chain_bwd(x, c1, c2, g, w1,
                                                         w2),
                        CHAIN_BWD_LAUNCHES if plan.fused
                        else CHAIN_BWD_SPLIT_LAUNCHES)
        _time_sites({'kernel': lambda: CCB.conv_chain_bwd(x, c1, c2, g, w1,
                                                          w2),
                     'plain': lambda: CCB.plain(x, c1, c2, g, w1, w2)})
        site = bound(nbytes(x, c1, c2, g, w1, w2, *got),
                     4 * b * h * w * k * k * (ci * cm + cm * co))
        log(f'  {name} bound {site[0]:.4f} ms ({site[1]})')
    return {tuple(t.shape[2:]) for t in seen.values()}


def _geometry_warp_site(device, ds, eng):
    '''The banked warp at the rate-3 crop: the kernel on a bank flow
    against its plain version (exactly equal), its route and launches, its
    times and bound.'''
    from dnncancerannotator_torch.ops import warp
    from dnncancerannotator_torch.ops.kernels import warp_twopass as WT
    bank = eng._warp_bank(ds)
    h = w = GEO_SIZE
    flow = warp._upsample_flow(bank['flows'][:TRAIN_BATCH], h, w,
                               bank['stride']).contiguous()
    gen = torch.Generator(device=device).manual_seed(SEED + 22)
    image = torch.rand((TRAIN_BATCH, h, w, 6), generator=gen, device=device)
    d = bank['max_displacement']
    route = WT.route(TRAIN_BATCH, h, w, 6, d)
    name = f'warp_twopass [{TRAIN_BATCH}, {h}, {w}, 6] d={d} ({route})'
    got = WT.warp_twopass(image, flow, d)
    want = WT.plain(image, flow, d)
    if not torch.equal(got, want):
        raise AssertionError(f'{name}: differs from its plain version by '
                             f'{float((got - want).abs().max())}')
    log(f'  {name}: equal to its plain version')
    _check_launches(name, lambda: WT.warp_twopass(image, flow, d),
                    WARP_LAUNCHES)
    _time_sites({'kernel': lambda: WT.warp_twopass(image, flow, d),
                 'plain': lambda: WT.plain(image, flow, d)})
    site = bound(nbytes(image, flow, got), 0)
    log(f'  {name} bound {site[0]:.4f} ms ({site[1]})')
    return route


def geometry_rate3(device, val_paths, train_paths):
    '''(a) unet.yaml at rate 3, B=8 243 x 243 crops (GEO_OVERLAY), through
    the CLI: ``train`` GEO_STEPS steps (every loss finite, both checkpoints,
    each fused chain, the head conv, their backwards and the warp
    launched every step, no 2x2 tconv; each kernel call's route printed,
    the chains at 243, 81 and 27), ``evaluate`` with metrics.yaml
    (``model_eval``: every region count equal to the plain CCA's, the CCA
    calls' routes printed) and ``predict`` (MAP_TOL of a plain forward);
    the kernels at the path's sites against their plain versions; one
    seeded step against a plain step (phase 13's rule); the throughput
    beside phase 5's. Returns the train call's launch counts.'''
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.data import pipeline
    from dnncancerannotator_torch.models import blocks
    from dnncancerannotator_torch.ops import kernels
    from dnncancerannotator_torch.runs.__main__ import main as cli
    from dnncancerannotator_torch.utils import config as config_lib

    overlay = _overlay_file('geometry_rate3.json', GEO_OVERLAY)
    save_path = os.path.join(WORK, 'rate3_run')
    kernels.reset_launches()
    torch.cuda.synchronize()
    start = time.perf_counter()
    with _route_log() as routes:
        res = cli(argv=[
            'train', '--config', *[os.path.join(REPO, c) for c in CONFIGS],
            overlay, '--save_path', save_path, '--data_path', *train_paths,
            '--save_freq', str(STEPS_PER_CALL), '--seed', str(SEED),
            '--device', device.type, '--max_steps', str(GEO_STEPS)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = kernels.launch_counts()
    losses = res.history['loss']
    log(f'rate {GEO_RATE} train: {GEO_STEPS} steps of B={TRAIN_BATCH} '
        f'{GEO_SIZE}x{GEO_SIZE} in {seconds:.3f} s (host clock, the bank '
        f'solve and data load included); loss {losses[0]:.4f} -> '
        f'{losses[-1]:.4f}; launches {launches}')
    for line in routes:
        log(f'  {line}')
    if res.epoch != list(range(1, GEO_STEPS + 1)) or \
            not np.isfinite(losses).all():
        raise AssertionError(f'train steps {res.epoch}, losses {losses}')
    ckpt_dir = os.path.join(save_path, 'checkpoints')
    for step in range(STEPS_PER_CALL, GEO_STEPS + 1, STEPS_PER_CALL):
        if not os.path.exists(os.path.join(ckpt_dir, f'ckpt-{step}',
                                           '_CHECKPOINT_METADATA')):
            raise AssertionError(f'no ckpt-{step}')

    config = config_lib.load_config(
        os.path.join(save_path, 'options.yaml'))['config']
    eng = engine.Engine(config, seed=SEED, device=device)
    ds = pipeline.train_ds(train_paths, **config['data_options']['train'])
    eng._setup_training(ds)
    eng.load(os.path.join(ckpt_dir, f'ckpt-{GEO_STEPS}'))
    n_chains = sum(isinstance(m, blocks.ConvChain) and m.fused
                   for m in eng.model.modules())
    want = {'conv_chain': n_chains, 'conv_chain_bwd': n_chains,
            'stencil_conv': 1, 'stencil_conv_bwd': 1, 'warp_twopass': 1}
    for name, sites in want.items():
        if launches[name] < sites * GEO_STEPS:
            raise AssertionError(f'{name} launched {launches[name]} times, '
                                 f'want >= {sites} x {GEO_STEPS}')
    if launches['tconv2x2'] or launches['tconv2x2_bwd']:
        raise AssertionError('a 2x2 tconv kernel ran at rate 3')
    for side in GEO_SIDES:
        if not any(line.startswith('conv_chain [') and
                   line.endswith(f'{side}, {side}] ' + line.split('] ')[-1])
                   for line in routes):
            raise AssertionError(f'no chain ran at {side}x{side}: {routes}')

    # the kernels at the path's sites: the chains, the warp
    x = torch.rand((TRAIN_BATCH, GEO_SIZE, GEO_SIZE, 5),
                   generator=torch.Generator(device=device).manual_seed(SEED),
                   device=device)
    sides = _geometry_chain_sites(eng.model, x, device)
    log(f'rate {GEO_RATE}: {n_chains} fused chains at {sorted(sides)}')
    _geometry_warp_site(device, ds, eng)
    if not any(line.startswith(f'warp_twopass [{TRAIN_BATCH}, {GEO_SIZE}, '
                               f'{GEO_SIZE}, ') for line in routes):
        raise AssertionError(f'no warp ran at {GEO_SIZE}x{GEO_SIZE}')
    RATES[f'unet.yaml rate {GEO_RATE} (phase 21)'] = _train_rate(
        eng, ds, f'rate {GEO_RATE} train')
    log(f'train throughput by phase (slices/s): {json.dumps(RATES)}')

    # evaluate, with each CCA call's route
    with _route_log() as routes:
        model_eval(device, val_paths, save_path, GEO_STEPS,
                   f'rate {GEO_RATE}', size=GEO_SIZE)
    for line in routes:
        if line.startswith('cca'):
            log(f'  evaluate: {line}')

    # predict, against the plain forward of the checkpoint's weights
    eng = engine.Engine(config, seed=SEED, device=device)
    eng.build((BATCH, GEO_SIZE, GEO_SIZE, 5))
    eng.load(os.path.join(ckpt_dir, f'ckpt-{GEO_STEPS}'))
    out_dir = os.path.join(WORK, 'rate3_maps')
    n_slices = sum(N_EXAMS) * SLICES_PER_EXAM
    kernels.reset_launches()
    count = cli(argv=['predict', '--save_path', save_path, '--data_path',
                      *val_paths, '--output_path', out_dir, '--batch_size',
                      str(BATCH), '--output_format', 'npy', '--device',
                      device.type])
    predict_launches = kernels.launch_counts()
    log(f'rate {GEO_RATE} predict: {count} maps; launches '
        f'{predict_launches}')
    if predict_launches['conv_chain'] < n_chains * -(-n_slices // BATCH):
        raise AssertionError('predict launched the chain '
                             f'{predict_launches["conv_chain"]} times')
    _check_maps(eng.model, val_paths, out_dir, n_slices,
                reference=lambda x: _plain_model_forward(eng.model, x),
                size=GEO_SIZE)

    # one seeded step against the plain step
    eng, raw, draws = big_check_state(config, ds, SEED, device)
    check_big_step(eng, ds, raw, draws, modules=_unet_modules(),
                   label=f'unet.yaml rate {GEO_RATE}')
    return launches


def geometry_rate4(device, train_paths):
    '''(b) unet.yaml at rate 4 on the shipped 256 x 256 crops: one seeded
    step against the plain step (phase 13's rule).'''
    from dnncancerannotator_torch.data import pipeline
    config = _config(CONFIGS)
    config['model_options']['rate'] = 4
    ds = pipeline.train_ds(train_paths, **config['data_options']['train'])
    eng, raw, draws = big_check_state(config, ds, SEED, device)
    check_big_step(eng, ds, raw, draws, modules=_unet_modules(),
                   label='unet.yaml rate 4')


def geometry_valid(device, val_paths):
    '''(c) unet.yaml at VALID (B=8, 256 x 256 in, VALID_OUT out): every
    3x3 conv on the stencil route (zero pads) on the activations of a
    seeded forward, forward and backward against their plain versions
    (KERNEL_TOL; DX_TOL, DW_TOL and F64_RATIO), at the library's launches
    a call, timed beside ``F.conv2d`` and ``convolution_backward``; the
    model's forward through the kernels against the plain forward
    (MAP_TOL); and the predict CLI raising as the JAX engine's predict
    raises there (its loss cannot take the smaller output).'''
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.models import fastconv
    from dnncancerannotator_torch.ops.kernels import stencil_conv as SC
    from dnncancerannotator_torch.ops.kernels import stencil_conv_bwd as SCB
    from dnncancerannotator_torch.runs.__main__ import main as cli
    F = torch.nn.functional
    conv_bwd = torch.ops.aten.convolution_backward

    overlay = _overlay_file('geometry_valid.json',
                            {'model_options.padding': 'valid'})
    configs = CONFIGS + (overlay,)
    config = _config(configs)
    probe = engine.Engine(config, seed=SEED, device=device)
    probe.build((TRAIN_BATCH, SIZE, SIZE, 5))
    paths = [path for path, m in probe.model.named_modules()
             if isinstance(m, fastconv.Conv2DFast)
             and m.weight.shape[-1] == 3
             and SC.eligible(*m.weight.shape[1::-1], 3, 3)]
    gen = torch.Generator(device=device).manual_seed(SEED + 23)
    batch = torch.rand((TRAIN_BATCH, SIZE, SIZE, 5), generator=gen,
                       device=device)
    modules, seen = _site_inputs(configs, paths, batch, device)
    pads = ((0, 0), (0, 0))
    log(f'unet.yaml at VALID: {len(paths)} 3x3 stencil sites (zero pads, '
        f'B={TRAIN_BATCH}, {SIZE}x{SIZE} in):')
    for path in paths:
        conv = modules[path]
        co, ci, kh, kw = conv.weight.shape
        w, b = conv.weight.detach(), conv.bias.detach()
        x = seen[path].detach().contiguous()
        route = SC.route(ci, co, kh, kw, pads, *x.shape[2:])
        name = (f'stencil_conv {path} {ci}->{co} relu @{x.shape[-1]} '
                f'({route})')
        with torch.no_grad():
            got = SC.stencil_conv(x, w, b, pads, True)
            _check_close(name, got, SC.plain(x, w, b, pads, True))
        _check_launches(name, lambda: SC.stencil_conv(x, w, b, pads, True),
                        1)
        _time_sites({
            'kernel': lambda: SC.stencil_conv(x, w, b, pads, True),
            'plain': lambda: SC.plain(x, w, b, pads, True),
            'library': lambda: F.relu(F.conv2d(x, w, b))})
        site = bound(nbytes(x, w, b, got), 2 * got.numel() * ci * kh * kw)
        log(f'  {name} bound {site[0]:.4f} ms ({site[1]})')
        g = torch.randn(got.shape, generator=gen, device=device)
        g = torch.where(got > 0, g, torch.zeros_like(g))
        bwd_route = SCB.route(x.shape[0], ci, co, *x.shape[2:], kh, kw, pads)
        name = f'stencil_conv_bwd {path} @{x.shape[-1]} ({bwd_route})'
        bgot = SCB.stencil_conv_bwd(x, g, w, pads)
        _check_grads(name, bgot, SCB.plain(x, g, w, pads),
                     SCB.plain(*_f64(x, g, w), pads))
        _check_launches(name, lambda: SCB.stencil_conv_bwd(x, g, w, pads),
                        STENCIL_BWD_ROUTE_LAUNCHES[bwd_route])
        _time_sites({
            'kernel': lambda: SCB.stencil_conv_bwd(x, g, w, pads),
            'plain': lambda: SCB.plain(x, g, w, pads),
            'library': lambda: conv_bwd(g, x, w, [co], [1, 1], [0, 0],
                                        [1, 1], False, [0, 0], 1,
                                        [True] * 3)})
        site = bound(nbytes(x, g, w, *bgot), 4 * g.numel() * ci * kh * kw)
        log(f'  {name} bound {site[0]:.4f} ms ({site[1]})')

    with torch.no_grad():
        (probs, counts) = _counted('VALID forward',
                                   lambda: probe.model(batch),
                                   need=('stencil_conv',))
        plain = _plain_model_forward(probe.model, batch)
    err = float((probs - plain).abs().max())
    log(f'unet.yaml at VALID: forward {list(batch.shape)} -> '
        f'{list(probs.shape)}, max|diff| from the plain forward {err:.3e}; '
        f'launches {counts}')
    if tuple(probs.shape) != (TRAIN_BATCH, VALID_OUT, VALID_OUT, 1) or \
            not torch.isfinite(probs).all() or not err <= MAP_TOL:
        raise AssertionError(f'VALID forward: {tuple(probs.shape)}, {err}')

    # predict: the JAX engine's eval step takes the loss, which raises at
    # the smaller output; so does the port's
    save_path = os.path.join(WORK, 'valid_run')
    os.makedirs(save_path, exist_ok=True)
    with open(os.path.join(save_path, 'options.yaml'), 'w') as fh:
        json.dump(dict(config=config, save_path=save_path,
                       data_path=val_paths), fh)
    probe.save_ckpt(os.path.join(save_path, 'checkpoints'), 1)
    probe.finalize_checkpoints()
    try:
        cli(argv=['predict', '--save_path', save_path, '--data_path',
                  *val_paths, '--output_path', os.path.join(WORK,
                                                            'valid_maps'),
                  '--batch_size', str(BATCH), '--device', device.type])
    except ValueError as exc:
        log(f'unet.yaml at VALID: predict raises, as the JAX engine\'s: '
            f'{exc}')
    else:
        raise AssertionError('predict at VALID did not raise')


def geometry_strided(device):
    '''(d) strided forwards (conv_stride 2; the strided convs are library
    calls, as in the JAX package): UNetAnnotator at unet.yaml's widths and
    MulmoUNetAnnotator at mulmo_unet.yaml's (2 levels) through the kernels
    against the same forward under ``gates.library_only()`` (MAP_TOL), each
    output finite and of the side the geometry gives.'''
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.ops import gates
    gen = torch.Generator(device=device).manual_seed(SEED + 24)
    for label, configs, extra, size, side in STRIDE_CASES:
        overlay = _overlay_file('geometry_stride.json', dict(
            {'model_options.conv_stride': 2}, **extra))
        eng = engine.Engine(_config(configs + (overlay,)), seed=SEED,
                            device=device)
        batch = torch.rand((TRAIN_BATCH, size, size, 5), generator=gen,
                           device=device)
        eng.build(tuple(batch.shape))
        with torch.no_grad(), eng.scope():
            probs, counts = _counted(label, lambda: eng.model(batch))
            with gates.library_only():
                plain = eng.model(batch)
        err = float((probs - plain).abs().max())
        log(f'{label} conv_stride 2: {list(batch.shape)} -> '
            f'{list(probs.shape)}, max|diff| from the library forward '
            f'{err:.3e}; launches {counts}')
        if tuple(probs.shape) != (TRAIN_BATCH, side, side, 1) or \
                not torch.isfinite(probs).all() or not err <= MAP_TOL:
            raise AssertionError(f'{label} strided forward: '
                                 f'{tuple(probs.shape)}, {err}')


def geometry_slice(device, val_paths, train_paths):
    '''Phase 21: (a)-(d); returns the rate-3 train call's launch
    counts.'''
    launches = geometry_rate3(device, val_paths, train_paths)
    geometry_rate4(device, train_paths)
    geometry_valid(device, val_paths)
    geometry_strided(device)
    return launches


# -- phase 22 ----------------------------------------------------------------
# the Orbax writer: phase 5's operating point with checkpoints kept to one
# (CKPT_OVERLAY), a resume from a copy of the first, evaluate of the run,
# unet_big.yaml's full-width save, and what the background save costs
# training
CKPT_STEPS = 50
CKPT_SAVE_FREQ = 25
CKPT_OVERLAY = {'deploy_options.steps_per_call': STEPS_PER_CALL,
                'deploy_options.max_checkpoints_to_keep': 1}
# (d): unet_big.yaml and data_options.yaml as shipped (bf16, 64 first
# filters, Adam), its warp bank cut to 16 fields (a bank is solved per
# Engine and never saved)
CKPT_BIG_CONFIGS = ('configs/unet_big.yaml',
                    'configs/additionals/data_options.yaml')
CKPT_BIG_OVERLAY = {'deploy_options.warp_bank_size': 16}
CKPT_LOADS = 5               # (d): read_ckpt timings, the median
CKPT_RATE_FREQS = (5, 1000)  # (e): save_freq of the differential calls
CKPT_RATE_STEPS = (25, 100)  # (e): the step counts of the calls
ORBAX_FILES = {'_METADATA', '_CHECKPOINT_METADATA', 'manifest.ocdbt', 'd'}


@contextlib.contextmanager
def _committed(copies=None):
    """Within the block every checkpoint the engine writes is timed at its
    commit (perf_counter into the yielded {name: time}), and those named
    in ``copies`` ({name: destination}) are copied once committed, on the
    writer thread."""
    from dnncancerannotator_torch.ckpt import orbax
    write = orbax.write_checkpoint
    commits = {}

    def spy(path, flat, chain):
        out = write(path, flat, chain)
        name = os.path.basename(path)
        commits[name] = time.perf_counter()
        if name in (copies or {}):
            shutil.copytree(path, copies[name])
        return out

    orbax.write_checkpoint = spy
    try:
        yield commits
    finally:
        orbax.write_checkpoint = write


def _state_flat(eng, step):
    """The live model's and optimizer's state as a checkpoint's flat
    dict."""
    from dnncancerannotator_torch import convert
    flat = convert.flax_from_torch_state(eng.model.state_dict())
    flat.update(eng._opt_state_flat(step))
    return flat


def _ckpt_run(config, save_path, data_paths):
    os.makedirs(save_path, exist_ok=True)
    with open(os.path.join(save_path, 'options.yaml'), 'w') as fh:
        json.dump(dict(config=config, save_path=save_path,
                       data_path=data_paths), fh)


def _check_train_launches(label, counts, steps):
    for name, sites in TRAIN_SITES.items():
        if counts.get(name, 0) < sites * steps:
            raise AssertionError(f'{label}: {name} launched '
                                 f'{counts.get(name, 0)} times, want >= '
                                 f'{sites} x {steps}')


def _resume_state(label, got, want, losses, want_losses):
    """(b): the resumed run's state the same bits as the unbroken run's;
    where a kernel of the path is not deterministic on the card, phase 5's
    rule instead (losses within LOSS_TOL relative, each tensor within
    STEP_TOL of its largest value), with the tensors that differ printed."""
    if sorted(got) != sorted(want):
        raise AssertionError(f'{label}: keys {sorted(set(got) ^ set(want))}')
    differ = [k for k in want if np.asarray(got[k]).tobytes() !=
              np.asarray(want[k]).tobytes()]
    if not differ and losses == want_losses:
        log(f'{label}: {len(want)} arrays and {len(losses)} losses the same '
            'bits as the unbroken run\'s')
        return
    errs = {k: float(np.abs(got[k] - want[k]).max() /
                     max(np.abs(want[k]).max(), 1e-30)) for k in differ}
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
    log(f'{label}: NOT bit-equal: {len(differ)} arrays differ (worst '
        f'{max(errs.items(), key=lambda kv: kv[1]) if errs else None}), '
        f'losses within {loss_err:.3e}; a kernel of the path is not '
        f'deterministic on the card (the first that differs: '
        f'{differ[:3]}); held to phase 5\'s rule')
    if loss_err > LOSS_TOL or any(e > STEP_TOL for e in errs.values()):
        raise AssertionError(f'{label}: past phase 5\'s rule: {errs}, '
                             f'losses {loss_err}')


def ckpt_train(device, val_paths, train_paths):
    """(a)-(c); returns the launch counts of (a)'s train call."""
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.data import pipeline
    from dnncancerannotator_torch.utils import config as config_lib

    config = config_lib.apply_config(_config(CONFIGS), dict(CKPT_OVERLAY))
    run, resume = (os.path.join(WORK, n) for n in ('ckpt_run',
                                                   'ckpt_resume'))
    for save in (run, resume):
        _ckpt_run(config, save, train_paths)
    ds = pipeline.train_ds(train_paths, **config['data_options']['train'])
    first = f'ckpt-{CKPT_SAVE_FREQ}'
    eng = engine.Engine(config, seed=SEED, device=device)
    with _committed({first: os.path.join(resume, 'checkpoints', first)}), \
            _deterministic_cudnn():
        res, counts = _counted('phase 22 train', lambda: eng.train(
            ds, save_path=run, max_steps=CKPT_STEPS,
            save_freq=CKPT_SAVE_FREQ))
    losses = res.history['loss']
    log(f'phase 22 train: {CKPT_STEPS} steps, loss {losses[0]:.4f} -> '
        f'{losses[-1]:.4f}; launches {counts}')
    if res.epoch != list(range(1, CKPT_STEPS + 1)) or \
            not np.isfinite(losses).all():
        raise AssertionError(f'phase 22 train: {res.epoch}, {losses}')
    _check_train_launches('phase 22 train', counts, CKPT_STEPS)
    ckpts = os.path.join(run, 'checkpoints')
    names = sorted(os.listdir(ckpts))
    last = os.path.join(ckpts, f'ckpt-{CKPT_STEPS}')
    if names != [f'ckpt-{CKPT_STEPS}'] or \
            set(os.listdir(last)) != ORBAX_FILES:
        raise AssertionError(f'phase 22: {names} in checkpoints, '
                             f'{sorted(os.listdir(last))} in the last')
    want = _state_flat(eng, CKPT_STEPS)
    _same_bits('phase 22 ckpt-50', engine.read_ckpt(last), want)
    log(f'phase 22: {names} alone ({first} pruned, no temporary '
        f'directory); ckpt-{CKPT_STEPS} reads back to the live state\'s '
        f'{len(want)} arrays, bit for bit')

    # (b) a resume from the copy of the first checkpoint
    eng_b = engine.Engine(config, seed=SEED, device=device)
    with _deterministic_cudnn():
        res_b, counts_b = _counted('phase 22 resume', lambda: eng_b.train(
            ds, save_path=resume, max_steps=CKPT_STEPS,
            save_freq=CKPT_SAVE_FREQ))
    if res_b.epoch != list(range(CKPT_SAVE_FREQ + 1, CKPT_STEPS + 1)):
        raise AssertionError(f'phase 22 resume: steps {res_b.epoch}')
    _check_train_launches('phase 22 resume', counts_b,
                          CKPT_STEPS - CKPT_SAVE_FREQ)
    _resume_state('phase 22 resume from a copy of ' + first,
                  _state_flat(eng_b, CKPT_STEPS), want,
                  res_b.history['loss'], losses[CKPT_SAVE_FREQ:])

    # (c) evaluate the run: the CCA kernel, region counts against the plain
    # CCA's
    model_eval(device, val_paths, run, CKPT_STEPS, 'phase 22')
    return counts


def ckpt_big(device, train_paths, smi):
    """(d) unet_big.yaml's full-width save: MB, the blocking ms of
    save_ckpt, the ms until commit, read_ckpt's ms (median of
    CKPT_LOADS)."""
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.data import pipeline
    from dnncancerannotator_torch.utils import config as config_lib

    config = config_lib.apply_config(_config(CKPT_BIG_CONFIGS),
                                     dict(CKPT_BIG_OVERLAY))
    ds = pipeline.train_ds(train_paths, **config['data_options']['train'])
    eng = engine.Engine(config, seed=SEED, device=device)
    res = eng.train(ds, max_steps=1, save_freq=1 << 30)
    n_params = sum(p.numel() for p in eng.model.parameters())
    if not np.isfinite(res.history['loss']).all() or \
            eng.compute_dtype != torch.bfloat16:
        raise AssertionError(f'phase 22 unet_big: {res.history}, '
                             f'{eng.compute_dtype}')
    ckpts = os.path.join(WORK, 'ckpt_big', 'checkpoints')
    with _committed() as commits:
        torch.cuda.synchronize()
        start = time.perf_counter()
        path = eng.save_ckpt(ckpts, 1)
        blocking = time.perf_counter() - start
        eng.finalize_checkpoints()
        done = time.perf_counter() - start
    committed = commits[os.path.basename(path)] - start
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)
    loads = []
    for _ in range(CKPT_LOADS):
        t = time.perf_counter()
        flat = engine.read_ckpt(path)
        loads.append(time.perf_counter() - t)
    _same_bits('phase 22 unet_big', flat, _state_flat(eng, 1))
    arrays = sum(v.nbytes for v in flat.values())
    log(f'phase 22 unet_big.yaml ({n_params} parameters, bf16 compute, '
        f'Adam): checkpoint {size / 1e6:.3f} MB on disk for '
        f'{arrays / 1e6:.3f} MB of arrays; save_ckpt blocks '
        f'{blocking * 1e3:.3f} ms (the host copy), commits at '
        f'{committed * 1e3:.3f} ms ({done * 1e3:.3f} ms to '
        f'finalize_checkpoints\' return); read_ckpt '
        f'{statistics.median(loads) * 1e3:.3f} ms (median of {CKPT_LOADS}: '
        f'{", ".join(f"{t * 1e3:.1f}" for t in loads)}) [{smi}]')


def ckpt_cost(device, train_paths, smi):
    """(e) unet.yaml's train throughput with a background save every 5
    steps and with one at the end of a call: phase 5's differential calls
    of 25 and 100 steps, each the minimum of three, the two settings in
    turns."""
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.data import pipeline
    from dnncancerannotator_torch.utils import config as config_lib

    config = config_lib.apply_config(_config(CONFIGS), dict(CKPT_OVERLAY))
    ds = pipeline.train_ds(train_paths, **config['data_options']['train'])
    engines = {}
    for freq in CKPT_RATE_FREQS:
        eng = engine.Engine(config, seed=SEED, device=device)
        save = os.path.join(WORK, f'ckpt_cost_{freq}')
        eng.train(ds, save_path=save, max_steps=10, save_freq=freq)
        engines[freq] = (eng, save)
    times = {}
    for _ in range(3):
        for n in CKPT_RATE_STEPS:
            for freq, (eng, save) in engines.items():
                torch.cuda.synchronize()
                start = time.perf_counter()
                eng.train(ds, save_path=save, max_steps=eng.current_step + n,
                          save_freq=freq)
                torch.cuda.synchronize()
                times.setdefault((freq, n), []).append(
                    time.perf_counter() - start)
    short, long = CKPT_RATE_STEPS
    rates = {freq: (long - short) * TRAIN_BATCH / (
        min(times[(freq, long)]) - min(times[(freq, short)]))
        for freq in CKPT_RATE_FREQS}
    every, rare = CKPT_RATE_FREQS
    log(f'phase 22 train throughput: save_freq {every} {rates[every]:.2f} '
        f'slices/s, save_freq {rare} {rates[rare]:.2f} slices/s, ratio '
        f'{rates[every] / rates[rare]:.4f} (differential calls of {short} '
        f'and {long} steps, each the minimum of three, in turns: '
        + json.dumps({f'{f}/{n}': [round(t, 4) for t in v]
                      for (f, n), v in times.items()}) + f') [{smi}]')
    return rates


def ckpt_slice(device, val_paths, train_paths, smi):
    """Phase 22; returns (a)'s launch counts."""
    counts = ckpt_train(device, val_paths, train_paths)
    ckpt_big(device, train_paths, smi)
    ckpt_cost(device, train_paths, smi)
    return counts


def main():
    with phase('1 environment'):
        smi = environment()
    from dnncancerannotator_torch import engine
    device = engine.resolve_device('cuda')
    with phase('2 build'):
        build()

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    results, mulmo_sites = {}, {}
    try:
        data_paths = write_records(os.path.join(WORK, 'data'))
        save_path = os.path.join(WORK, 'run')
        config = write_save_path(save_path, data_paths, device)
        eng = engine.Engine(config, seed=SEED, device=device)
        eng.build((BATCH, SIZE, SIZE, 5))
        eng.load(os.path.join(save_path, 'checkpoints', 'ckpt-1'))
        with phase('3 forward kernels'):
            kernel_sites(eng.model, device, results)
        with phase('3b backward and warp kernels'):
            backward_sites(eng.model, device, results)
        with phase('3c cca kernel'):
            cca_sites(eng, data_paths, results)
        with phase('3d input sensitivity'):
            sensitivity_site(eng, data_paths)
        with phase('3e unet_big kernels'):
            big_kernel_sites(device, results)
        with phase('3f crop-fused warp kernel'):
            crop_kernel_sites(device, results)
        with phase('3g MulmoUNet kernels'):
            mulmo_kernel_sites(device, results, mulmo_sites)
        with phase('3h bf16 kernel forms'):
            bf16_kernel_sites(device, results)
        with phase('3i leaky stencil sites'):
            leaky_kernel_sites(device, results)
        with phase('4 predict'):
            predict_launches = run_slice(eng, data_paths, save_path,
                                         os.path.join(WORK, 'maps'))
        with phase('5 train'):
            launches, train_run, train_paths = train_slice(device)
        with phase('6 evaluate'):
            eval_launches = eval_slice(device, data_paths, train_paths,
                                       train_run)
        with phase('7 unet_big train'):
            big_launches, big_predict, _ = bn_train_slice(
                device, train_paths, BIG_SPEC)
        with phase('8 fused augmentation'):
            fused_launches = fused_aug_slice(device, train_paths)
        with phase('10 MulmoUNet'):
            mulmo_launches = bn_train_slice(device, train_paths, MULMO_SPEC,
                                            data_paths)
        with phase('11 MultiResUnet'):
            bn_train_slice(device, train_paths, MRU_SPEC, data_paths)
        with phase('12 unet_big bf16'):
            bn_train_slice(device, train_paths, BF16_BIG_SPEC, data_paths)
            for overlay in BF16_POLICIES:
                bf16_policy(device, train_paths, overlay)
        with phase('12b unet.yaml and MulmoUNet in bf16'):
            bf16_launches = bf16_slices(device, train_paths)
        with phase('13 unet.yaml + leakyReLU.yaml train'):
            leaky_launches, leaky_predict = leaky_train_slice(device,
                                                              train_paths)
        with phase('14 training options'):
            options_slice(device, train_paths)
        with phase('15 host data layer'):
            data_layer_slice(device, data_paths, train_paths, train_run, smi)
        with phase('16 export and serve'):
            export_serve_slice(device, data_paths, train_run, smi)
        with phase('17 data parallel'):
            dp_steps, dp_refs = dp_slice(device, data_paths, train_paths,
                                         train_run, smi)
        with phase('19 spatial partition'):
            spatial_slice(device, data_paths, train_paths, train_run,
                          dp_steps, dp_refs, smi)
        with phase('18 extract_all'):
            extract_slice(device, smi)
        with phase('20 Orbax checkpoints'):
            orbax_slice(device, data_paths, train_paths, smi)
        with phase('21 model geometries'):
            geo_launches = geometry_slice(device, data_paths, train_paths)
        with phase('22 Orbax writer'):
            ckpt_launches = ckpt_slice(device, data_paths, train_paths, smi)
        with phase('9 profiler windows'):
            for job in _DEFERRED:
                job()
            sums = {key: sum(t[key] for _, t, _ in TRAIN_FORWARD)
                    for key in ('ms', 'plain_ms', 'device_ms',
                                'plain_device_ms')}
            sums['bound_ms'] = sum(b for _, _, b in TRAIN_FORWARD)
            log(f'conv_chain B={TRAIN_BATCH} need_c1, six sites: '
                + json.dumps(sums))
            log('MulmoUNet sites of the NHWC pool and tconv kernels: '
                + json.dumps({name: dict(
                    max_abs_err=acc['max_abs_err'], **summed_times(acc),
                    bound_ms=acc['bound_ms'], sites=acc['sites'])
                    for name, acc in mulmo_sites.items()}))
    finally:
        # phase 17's world-1 group, kept for its deferred profile
        if torch.distributed.is_available() and \
                torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        shutil.rmtree(WORK, ignore_errors=True)

    # each kernel's launches in the run of its path: train for the seven of
    # the unet.yaml train step, evaluate for the CCA, the unet_big train and
    # predict for the four NHWC kernels, the fused-chain train for the crop
    # warp, the MulmoUNet train, predict and evaluate for the NHWC stencil
    launches['cca'] = eval_launches['cca']
    launches['warp_crop'] = fused_launches['warp_crop']
    for name in NHWC_KERNELS:
        launches[name] = big_launches[name]
        predict_launches[name] = big_predict[name]
    for counts, mulmo in zip((launches, predict_launches, eval_launches),
                             mulmo_launches):
        counts['stencil_conv_nhwc'] = mulmo['stencil_conv_nhwc']
    # the bf16 forms': phase 12b's train calls
    launches.update(bf16_launches)
    # the NCHW stencil conv's tile route: phase 13's train and predict calls
    launches['stencil_conv_tile'] = leaky_launches['stencil_conv_tile']
    predict_launches['stencil_conv_tile'] = leaky_predict['stencil_conv_tile']
    csrc = 'dnncancerannotator_torch/csrc/'
    kernels_line = {'kernels': [
        {'name': name, 'route': 'cuda',
         'source': f'{csrc}{SOURCE.get(name, name)}.cu',
         'replaces': ', '.join(PALLAS + r for r in REPLACES[name]),
         'launches': launches[name],
         'predict_launches': predict_launches[name],
         'eval_launches': eval_launches[name],
         'rate3_launches': geo_launches.get(name, 0),
         'ckpt_launches': ckpt_launches.get(name, 0),
         'max_abs_err': acc['max_abs_err'], **summed_times(acc),
         'bound_ms': acc['bound_ms'],
         'bound_by': max(acc['by'], key=acc['by'].get),
         **({'tf32x3_bound_ms': acc['tf32x3_bound_ms']}
            if 'tf32x3_bound_ms' in acc else {}),
         'sites': acc['sites']}
        for name, acc in results.items()]}
    log(json.dumps(kernels_line))
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    if sys.argv[1:2] == ['--rank-jobs']:
        rank_jobs(sys.argv[2])
    else:
        main()
