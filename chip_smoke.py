#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # all phases, as a check
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --profile       # also torch.profiler breakdowns
    python3 chip_smoke.py --phases build,kernels --baseline DIR [DIR ...]
                                          # also time the wgmma kernels
                                          # (WGMMA_KERNELS) built from each
                                          # DIR's deepl_project_tpu_torch/csrc

Phases (any failure exits non-zero and prints no result):

1. build: compile the Hopper kernel sources of deepl_project_tpu_torch/csrc
   (nine launchers in seven files) with nvcc for sm_90a, all in parallel, and
   print ptxas' register and shared memory report (in full for the six
   wgmma/TMA kernels, WGMMA_KERNELS).
2. kernels: run each kernel at the main paths' shapes and hold it against
   its plain PyTorch version on the same inputs: max |kernel - plain| <=
   2**-6 * max|plain|, i.e. two bf16 rounding steps (ulp <= 2**-7 |v|) at
   the largest magnitude. The sublayer kernels at large f16d32 @256px,
   batch 32 ([B,4096,384] for ln_qkv_rope; [B,1024,768] and [B,256,1536]
   for all three); the flash kernels (forward; the backward's dq, dk and dv,
   run twice to bound dq's run-to-run difference, which its L2 reductions in
   a run-dependent order allow, and twice more under
   torch.use_deterministic_algorithms(True), where the deterministic
   launcher must give bit-equal results; its time and memory are logged) at
   the training microbatch (8 images, 6 heads, N=4096; also timed at phase
   recipe's and remat's, FLASH_TRAIN_TIMED), the forward also at
   512px serving (2 images, N=16384), at 256px serving batch 32 against the
   plain chunked core (the inference dispatch's evidence) and at the 1024px
   sweep's stage 2 (4 images, N=65536); small_attention
   at the 512px stage-4 shape (8 images, N=1024, 24 heads, q/k/v slices of
   one [B, N, 3C] buffer as ln_qkv_rope leaves them); group_norm_silu (stats
   and apply kernels) on channels_last maps at the large f16d32 ResBlock
   shapes at b32, [32, 192, 256, 256] and [32, 192, 128, 128] bf16, and at
   [8, 384, 128, 128] fp32, the stats kernel's per-channel fp32 sums each
   within 1e-5 relative of the plain fp32 sums, an NCHW-contiguous input
   refused; checked only, at every other map the paths below give them
   (norm_checked_shapes: norm_sites at each path's batch and resolution,
   NORM_PATH_BATCHES). Times each kernel,
   its plain version and, where one exists, the one PyTorch call computing
   the same function (SDPA, its backward, F.linear, torch.var_mean for the
   GroupNorm stats; F.group_norm + F.silu for the whole group_norm_silu, on
   the same channels_last map and on an NCHW copy;
   for ln_qkv_rope, which no one call computes, a two-call yardstick:
   F.layer_norm with one affine + F.linear on the packed [3C, C] weight),
   with CUDA events (proj_bias_gemm and F.linear on the same bf16 weight,
   cast once as the model caches it); and the two routes of an attention
   sublayer at (N=1024, C=1536, b=8): the whole-sublayer kernels against
   ln_qkv_rope + small_attention + the projection; ln_qkv_rope also at the
   sweep's six shapes (QKV_SWEEP). With --baseline DIR ..., ln_qkv_rope
   (the three 256px shapes and (4, 65536, 384)), proj_bias_gemm (both
   shapes), small_attention, the flash forward (the
   four flash shapes above), attention_core (both sublayer shapes) and the
   flash backward (DIR's flash_attention_bwd, or its flash_attention_bwd_dq
   + flash_attention_bwd_dkv pair behind the plain delta) are also built
   from each DIR's sources that exist and each build timed beside this
   tree's on the same inputs in turns (baseline, this tree, this tree,
   baseline). The sublayer kernels on one rank's heads at model 2
   (LOCAL_SHAPES: ln_qkv_rope at W = C / 2 = 192 / 384 / 768, the partial
   projection [C, W], attention_core on 6 and 12 heads), checked at b8 and
   b4 and timed at b8 beside their plain versions, yardsticks and bounds.
3. grad: the sublayer kernels' backward (their plain versions' VJP) at the
   stage-3 training shape: gradients of x, the LN affines and every weight
   on the kernel path against the plain path's.
3b. fold_thin (phase_fold_thin; no kernel of the port): (b)
   AttentionRoPE(fuse_qkv=True) at the three stage shapes (FOLD_SHAPES, b8,
   bf16) on the composable route against fuse_qkv=False, forward and
   backward, each against an fp32 run (the fold within MODEL_MEAN_RATIO /
   MODEL_MAX_RATIO of the unfolded route's error), the two timed in turns;
   (c) ThinConv3x3 at large f16d32's boundary convs (3 -> 192 im2col,
   192 -> 3 tap-major; b32, 256^2, bf16, NCHW and channels_last) within
   KERNEL_RTOL of F.conv2d, timed in turns beside that cuDNN call and its
   bound.
4. train: large f16d32 (fp32 params from a seed, bf16 compute) trained by
   Trainer.fit on synthetic 256px images, batch 16 as 2 microbatches of 8,
   L1 + LPIPS (random VGG) + KL, AdamW with warmup, a checkpoint at the
   end; launch counters set to 0 before and read after: exactly 12 flash
   forward and 12 flash backward launches per step and no other kernel;
   finite losses, params moved; one batch's loss and gradient norm on the
   kernel path against the plain attention core. Times steps, img/s and
   peak memory.
5. gan: stage 2 of the same model (README's recipe) through Trainer.fit:
   phase train's stage-1 checkpoint resumed into a GAN trainer (frozen
   encoder, PatchGAN at gan 0.05 with R1 10 and the disc loss floor 0.6,
   EMA 0.999, LPIPS on random VGG), batch 8, 5 steps; the hand-off checked
   (step carried over, optimizer count 0 and zero moments, EMA restarted,
   discriminator fresh); launch counters set to 0 before and read after:
   exactly 12 flash forward (the generator's 6, the discriminator update's
   fresh forward 6) and 6 flash backward launches per step and no other
   kernel; finite losses, disc_loss and disc_r1; the decoder and the
   discriminator moved, the encoder bit-equal; one batch's generator loss
   and gradient norm on the kernel path against the plain attention core
   (the train phase's bounds). Times steps, img/s and peak memory (< 80 GB).
   Phase train's checkpoint is hard-linked, not moved: phase remat reads it.
6. recipe: the repo's own stage-1 recipe, configs/transvae_large_f16d32.yaml
   read by the train CLI's load_yaml_config: large f16d32 @256, batch 8 in 4
   microbatches of 2, L1 + LPIPS (random VGG) + KL 1e-8 + VF 0.1 through
   make_vf_teacher (the stub teacher where no DINOv2 weights are on the
   machine), AdamW (warmup cut to 2), 5 steps of Trainer.fit; exactly 24
   flash forward and 24 backward launches per step and no other kernel;
   finite losses, the VF term finite and > 0, vf_proj moved. Times steps,
   img/s and peak memory. With --profile (here and in remat), one step
   (one compute_grads without remat, under none and under dots) under
   torch.profiler: wall and device ms, aten calls, a table in chiprun_out/.
7. remat: gradient checkpointing. One compute_grads of a batch of 8 @256
   (L1 + LPIPS + KL) with no remat and under each policy (none, dots,
   dots_all, conv_dots, dots + remat_resample): ms (median of 3 after a
   warm-up), peak memory, flash launches (6 forward without remat, 12 with:
   each block's forward runs again in its recompute; 6 backward), loss and
   grad norm within 1e-3 relative of no remat. Then Trainer.fit with remat
   'dots' and Adafactor at batch 16 in one microbatch (5 steps, < 80 GB,
   12 + 6 flash launches a step), and one step with perceptual='self' on
   phase train's checkpoint (its frozen encoder at attention 'auto': the
   flash and sublayer kernels on the target, on the reconstruction and in
   that checkpoint's recompute; the flash backward on the reconstruction's
   side): ms, peak and launches.
8. serve: build large f16d32 in bf16 from a seed, serve it over HTTP on
   localhost through InferenceEngine (concurrent uint8/float reconstruct,
   encode and decode requests), with the launch counters set to 0 before and
   read after; check shapes, finiteness and the [0,1] range; check one
   reconstruct's launches per kernel and shape; hold one reconstruct (b=4)
   of the kernel path and of the plain bf16 path (plain attention, plain
   GroupNorm and SiLU) against the same weights in fp32; one 512px
   reconstruct (b=2) with its flash forward launches.
9. time: reconstruct images/s at batch 32 through InferenceEngine.run, and
   with the JAX package's exact rewrites (ConvFFN fold_output, the fused
   resample convs; the model's default) on and off in turns (on, off, off,
   on), the module flags toggled, then the same with the fused GroupNorm ->
   SiLU (ops.norms.FUSE_NORM_SILU) on and off; train times the step with
   the rewrites on and off the same way after its fit with --profile.
   (a) The b32 reconstruct with every AttentionRoPE at impl 'fused'
   (fused_impl_reconstruct): its launches (counters set to 0 just before,
   read just after) the sublayer kernels of launches_per_reconstruct(256)
   with no flash and no small_attention launch (stage 2's core is the
   plain chunked one), routes sublayer 20 and ln_qkv_rope 6; each sublayer
   on 'auto''s input: stages 3-4 bit-equal to 'auto''s, stage 2 within
   KERNEL_RTOL of max; 4 images against the fp32 twin within
   MODEL_MEAN_RATIO / MODEL_MAX_RATIO of 'auto''s error; 'auto' and
   'fused' timed in turns.
10. eval: evaluate_model at 256px on the shapes source (2 batches of 16, LPIPS
   and vgg_rfid on random VGG); extrapolation_sweep at 256/512/1024px on 8
   shapes images made at 1024px (chunks of 8, 8 and 4), with the launch
   counters set to 0 before and read after each resolution: at 512px 12
   small_attention and 12 + 6 + 8 ln_qkv_rope per chunk and no sublayer
   kernel, at 1024px 6 + 8 + 12 flash forwards and no small_attention;
   finite PSNR/SSIM, images/s and peak memory per resolution; each
   resolution's sweep with the fused GroupNorm -> SiLU on and off in turns;
   one 512px
   reconstruct (b=2) of the kernel path and of the plain bf16 path against
   fp32 (the serve phase's rule); cli/generate.py --mode random on the card.
   With --profile, a torch.profiler table of one 1024px chunk's reconstruct
   (as the train and time phases profile one step and one reconstruct).
11. quant: int8 post-training quantization of the same model, calibrated as
   cli.serve calibrates (8 synthetic shapes images at 256px, two batches of
   4), at the three scopes. The int32 accumulators of torch._int_mm and the
   int8 im2col on the card bit-equal to the CPU's at a stage-0 ResBlock conv
   (b1) and the stage-4 FFN w_head / w_fold shapes (b4); each int8 site
   alone (quantize + im2col / int GEMM + dequantize) timed at the b32
   shapes beside its bf16 cuDNN conv or F.linear and its bound (operations
   at 1979 TOP/s int8 or bytes at 3.35 TB/s, im2col not counted), its output
   within 5% (relative L2) of the bf16 call's; reconstruct b32 img/s and
   peak memory for 'none', 'resblock', 'ffn' and 'all' in turns; attention
   launches per int8 reconstruct equal to the bf16 table; the int8
   reconstruct (b4) against the fp32 twin within relative L2 0.15 (the JAX
   package's bound), the bf16 path's error beside it; one HTTP round trip
   through cli.serve's engine with --quantize unset and one with --quantize
   int8 (scope resblock). Writes
   chiprun_out/quant.json; with --profile, a table of one int8 reconstruct.
12. data (run after the training phases): training and evaluation from a
   folder of images. Probes the decoders (the native C++ decoder built from
   native/image_loader.cpp, PIL) and prints which one decodes; writes 112
   PNGs (4 class directories, 8 loose; 256x320, 384x256, 300x300) and times
   their decode at min(cpu_count, 16) threads; cli.train --variant large
   --data <folder> (batch 16 = 2 x 8, 5 steps, one validation batch of 16 at
   step 5) with launches counted: 12 + 12 flash a step and 6 flash forward
   in the validation pass, group_norm_silu as norm_table for that one
   no-grad forward, no other kernel; history.jsonl, and tb/ exactly when
   tensorboardX is installed; the same step fed by the folder pipeline and
   by synthetic batches in turns (folder, synthetic, synthetic, folder; 3
   steps a turn); one step under utils.logging.profiler_trace (its trace
   written); InceptionV3 (seeded random params, fp32 with TF32 off) at b32
   256 -> 299px timed beside its bound, its first 4 images against the CPU
   fp32 path (INCEPTION_RTOL), rFID of the originals against themselves (~0)
   and against the trained model's reconstructions (its scipy sqrtm in a
   process on FID_BLAS_THREADS BLAS threads and cli.smoke_test in another,
   started after the Inception timing, both beside what follows);
   cli.evaluate --data <folder> --rfid (2 batches of 16; vgg_rfid without
   the Inception weights) with launches as two 256px reconstructs;
   pool_latents over the folder, latent_diagnostics, linear_probe on the 4
   class labels;
   from_pretrained('transvae-large-f16d32') through DEEPL_PRETRAINED_DIR,
   its reconstruct bit-equal to model_from_checkpoint's; python -m
   deepl_project_tpu_torch.cli.smoke_test exiting 0. Deletes its folder and
   checkpoint. Where neither decoder is present (the probe says so), it
   trains and evaluates on --data shapes instead.
13. dit (run after data): the latent DiT. cli.train_dit --dit_variant B
   --vae_variant large on a labelled folder (_write_image_folder: training
   is class-conditional) at 256px, b64, 10 steps, 2 stats batches, a
   checkpoint, a sample grid and a vgg_rfid-keyed generation FID (64
   samples, 50 steps, CFG 4) at step 10, with launches counted: each b64
   encode exactly the encoder half of the 256px tables (half of
   launches_per_reconstruct's attention table, norm_table of the encoder),
   the FID's and the grid's decodes the decoder half, no flash launch in the
   DiT (N=64: the plain core); finite losses, the params moved, the
   sidecar, history.jsonl, best/metrics.json. cli.sample_dit on that
   checkpoint (16 samples, 50 steps, CFG 4): the decoder half at b16,
   grid.png and 16 sample files. DiT-B/2 (every parameter random) at b16 in
   bf16 against its fp32 twin on the same weights and draws: the loss
   within 1% and the gradient norm within 5% (phase train's bounds).
   DiT-B/1 on 32x32 latents (N=1024, b8): exactly 12 small_attention
   launches and no other kernel, as close to fp32 as the plain bf16 core
   (MODEL_MEAN_RATIO / MODEL_MAX_RATIO). Times the b64 encode, the b16
   decode, one folder batch's serial decode, the DiT-B/2 step at b64 on
   ready latents (median of steps 2-5, with its peak), a CFG Euler step at
   b16 and cli.train_dit's img/s (with --profile, torch.profiler tables of
   a b64 encode, a DiT step and a CFG Euler step). Phase kernels also checks the attention
   kernels at b64 and b16 and small_attention on DiT-B/1's operands (v a
   strided view of the qkv product).

14. parallel (run last; needs phase train's rows): parallel training on the
   one card. (a) World size 1 over NCCL in this process (a FileStore under
   outputs/): Trainer.fit of phase train's run (2 x 8, 5 steps, 12 + 12
   flash launches a step) reported step by step beside phase train's
   rows; the plain and the distributed compute_grads on the same weights,
   batch and noise (loss within PARALLEL_LOSS_RTOL, grad norm within
   PARALLEL_GRAD_NORM_RTOL; bit-equality logged), the two steps in turns
   and the gradient all-reduce alone; the process group is destroyed
   before (b). `python -m torch.distributed.run --nproc_per_node 1 -m
   deepl_project_tpu_torch.cli.train` for PARALLEL_CLI_STEPS steps at
   global b PARALLEL_CLI_BATCH (2 microbatches), started beside (b)'s
   ranks once they are past PARALLEL_CLI_AFTER, its checkpoint resumed by
   one process (step and optimizer count PARALLEL_CLI_STEPS). (b) Two processes on the card
   over gloo (this script under torchrun, --worker dp; NCCL refuses two
   ranks on one device), each run of DP_RUNS against one process on the
   same weights and global batch of PARALLEL_BATCH under remat 'none' (the
   stage-1 runs and their one process at PARALLEL_STEP_DEPTHS, the GAN
   runs at full depth; one process's steps run beside the ranks):
   replicate stage 1 (2 x 4) and GAN, in bf16 and in fp32 without TF32
   (the adaptive weight, unclamped, within PARALLEL_ADAPTIVE_RTOL, the
   global disc loss within PARALLEL_LOSS_RTOL, the same decision of a floor
   near it; in fp32 the grad norm within the stage-1 bar and the loss
   within the weight's),
   FSDP and tensor
   parallel stage 1 at model 2 (each rank all 8 rows); stage-1 loss and
   grad norm within the bars; the parameters every rank holds whole
   bit-identical across ranks (checksums); flash launches a rank (2 + 1 a
   stage-2 sublayer a stage-1 step: 8 + 4 at PARALLEL_STEP_DEPTHS; 18 + 6
   a bf16 GAN step, none in fp32; 3 heads under tensor); peak memory.
   The FSDP and tensor runs' scan-layout twins
   (fsdp_scan, tensor_scan: the seed's weights stacked, the same rows) are
   held to those bars against one process and against their unrolled
   twin on each rank: the ranks step those four runs
   (PARALLEL_DETERMINISTIC) under torch.use_deterministic_algorithms
   (warn_only: any op without a deterministic version is logged; the
   flash backward's deterministic launcher), and each twin's loss and
   launches equal its unrolled run's, the tensor twin's grad norm and each
   block's first moment bit-equal too (PARALLEL_SCAN_BIT_EQUAL), the FSDP
   twin's within the PARALLEL_SCAN_* bars. (d) `cli.train
   --variant large --scan_blocks --param_sharding tensor --mesh_model 2
   --gradient_checkpointing --optimizer adafactor` (the README's big-model
   recipe) on (b)'s two ranks after its runs (cli.train takes their gloo
   group), SCAN_TP_STEPS steps at global b SCAN_TP_BATCH: finite losses,
   12 + 6 flash launches a rank a step, its checkpoint holding whole
   stacks. (e) cli.train on the JAX trainer's subset mesh: (b)'s two ranks
   after (d) at global --batch_size SUBSET_BATCH (gcd(3, 2) = 1 data rank:
   rank 0 trains, rank 1 is left out), large f16d32 at PARALLEL_STEP_DEPTHS
   with remat, SUBSET_STEPS steps under torch.use_deterministic_algorithms,
   each rank its own --output_dir: losses and grad norms within (b)'s bars
   of one process's cli.train of the same flags (--worker subset-one,
   started beside (a)'s cli.train; bit-equality logged), the flash launches
   of rank 0 (8 + 4 a step) equal to one process's, the left-out rank
   saying so, launching nothing and writing nothing (its directory empty)
   and the torchrun exiting 0. (f) A tensor-parallel (model 2) train-mode
   forward of the same model at dropout DROPOUT_P (no grad, b
   DROPOUT_BATCH, torch.manual_seed(DROPOUT_SEED)) on the two ranks after
   (e): both ranks' reconstructions bit-identical, every dropout mask
   equal on both ranks and to one process's at the same seed (sha256),
   the dropped share within 0.01 of p, the L1 distance to the input within
   PARALLEL_LOSS_RTOL of one process's, the attention on the local heads'
   route; ops.layers.dropout (its seed broadcast over the group) and
   F.dropout timed at DROPOUT_TIMED.
   (c) The stage-2 attention sublayer's two head shards of model=2 (3 of 6
   heads each, the composable route that training takes; phase serve_mesh
   drives the no-grad kernel routes) summed against the whole sublayer
   (KERNEL_RTOL), their route
   counts and flash launches at 3 heads; the flash kernels timed at 3 and
   6 heads (phase kernels checks them at FLASH_LOCAL_HEADS).
   Not in the defaults: refusals (two ranks on the card: NCCL's group and
   gloo's collectives on CUDA tensors, each accepted or refused, with the
   message); gan_cut ((b)'s GAN runs, bf16 and fp32, two ranks against one
   process with both cut to PARALLEL_STEP_DEPTHS: the adaptive weight's
   gap in each dtype logged, the fp32 twin held to (b)'s bars).
15. context (run before parallel): ring context parallelism on the one
   card, large f16d32 (depth cut to CONTEXT_DEPTHS) at 1024px over a
   context axis of 2: first the flash kernels timed at the ring's local
   shapes (CONTEXT_RING_SHAPES) beside their plain versions, SDPA and their
   bounds; then, beside each other, a probe of gloo's point-to-point
   transfers of host and CUDA tensors (accepted or refused, with the
   message), one process's fp32 and bf16 forward (b1) and stage-1 step (b2,
   L1 + KL + LPIPS on random VGG, remat 'none', the global latent noise
   handed in, AdamW), and two processes on the card over gloo (this
   script under torchrun, --worker context; results in CONTEXT_DIR): (a)
   the ring at CONTEXT_RING split 2 ways, forward and dq, dk, dv within
   KERNEL_RTOL of one process's flash attention and of the plain ring
   (ring_attention_reference; the plain partials' backward), 2 + 2 flash
   launches and ring steps a rank, ms a call; (b) the no-grad forward,
   each rank its 512 rows: the gathered reconstruction's mean abs error
   against the fp32 forward within CONTEXT_MEAN_RATIO of one process's
   bf16 forward's, 12 ring routes and 24 flash forwards a rank and no
   other kernel (group_norm_silu included), peak; then the same forward on
   the scan layout (the seed's weights stacked): its gathered
   reconstruction within KERNEL_RTOL of max of the unrolled one's
   (bit-equality logged), the same routes, launches and ring steps; (c) the step on the same
   weights, batch and noise: loss and grad norm within phase parallel's
   bars of one process's, the parameters bit-identical across the ranks
   after the update, 48 + 24 flash launches and as many ring steps a
   rank, peak, ms and the bytes staged through host memory (gloo refuses
   CUDA point-to-point: not a speed). Before (c), each kind of halo conv
   (CONTEXT_HALO_MAP: 3x3, the stride-2 downsample, the fused upsample,
   LPIPS's VGG conv, the int8 QConv2d) against the whole map's conv sliced,
   forward and input gradient, fp32 without TF32 within CONTEXT_HALO_RTOL
   of max (int8 bit-equal), and the same with every halo row zeroed, which
   must fail it. After (c): (d) one GAN step at CONTEXT_GAN_RES b2 (VF
   through the stub teacher, the self-perceptual term from a frozen random
   twin, the adaptive weight, R1 and the disc loss floor) against one
   process's, in bf16 (120 + 48 flash launches and as many ring steps a
   rank) and in fp32 without TF32, cuDNN deterministic, at 256px b1
   (CONTEXT_GAN_RUNS): in both
   vf_proj's gradient within PIPE_BLOCK_GRAD_RTOL relative L2, the floor's
   decision the same, both models bit-identical across the ranks after
   the update; in fp32 the loss and grad norm within phase parallel's bars
   and the adaptive weight within PARALLEL_ADAPTIVE_RTOL (in bf16 they are
   logged beside those bars); (e) the int8 model (scope CONTEXT_INT8_SCOPE) under the group:
   the fp32 calibration within CONTEXT_AMAX_RTOL of one process's on the
   whole image at every site, the bf16 int8 forward's gathered
   reconstruction's mean abs error against one process's fp32 forward
   within CONTEXT_MEAN_RATIO of one process's int8 forward's, 24 flash
   forwards a rank and no other kernel. The flash kernels are also held
   and timed at (d)'s local ring shapes (CONTEXT_GAN_RING_SHAPES); (g) the
   same model at CONTEXT_G_RES (720px), whose maps the two ranks split
   unevenly from stage 4 on (23 / 22 of 45 rows): the b1 forward against
   one process's fp32 / bf16 (CONTEXT_MEAN_RATIO) and the b2 step against
   one process's (PARALLEL_LOSS_RTOL / PARALLEL_GRAD_NORM_RTOL), every
   ring partial a flash launch at the ragged local token counts
   (CONTEXT_G_TOKENS); the kernels held and timed at CONTEXT_G_RING first.
16. pipeline (run after context, before parallel): GPipe and Switch-MoE
   expert parallelism of the latent DiT-L/2 (full width, depth cut to
   PIPE_DEPTH, every parameter random). The flash kernels at a pipeline stage's microbatch
   (PIPE_FLASH) held against their plain versions and timed beside SDPA
   (its backward) and their bounds. Then each run of PIPE_RUNS: one
   process's no-grad forward and step (make_dit_train_step, AdamW) saved
   to PIPE_DIR, then the run's ranks under torchrun over gloo (this script
   with --worker pipeline-<run>): (a) bf16, pipe 2, 512px latents b32 in
   8 microbatches, core 'pallas': exactly 16 flash forward + 16 backward
   launches a rank a step (2 blocks x 8) and 16 forwards a no-grad
   forward; (b) 4 experts, fp32, (data, pipe, expert) = (1, 2, 2), 256px
   latents b16 in 4, no kernel launch. Each rank against one process: the
   loss (PARALLEL_LOSS_RTOL), grad norm (PARALLEL_GRAD_NORM_RTOL), the
   no-grad forward (KERNEL_RTOL of max), each block's gradient
   (PIPE_BLOCK_GRAD_RTOL relative L2) and its update signs
   (PIPE_UPDATE_AGREE), the microbatch runs; in (a) also a reading of an
   fp32 twin's distance, the ranks' beside one process's. Logs peak memory,
   step seconds and host-staged bytes a rank (not a speed). (c)
   `python -m deepl_project_tpu_torch.parallel.dryrun --nproc 8`, started
   after the kernel timings and run beside (a) and (b): phase 5 (pipe x
   expert on (2, 2, 2)) equal to the sequential step. Runs (a)
   and (b) hold the blocks stacked (pipeline_axis: blocks.block.<path>
   [depth, ...]) and each stage its consecutive slices; each block's
   gradient is its slice of the stack. Then one process's DiT-L/2 of run
   (a) built with scan_blocks and unrolled from the same seed: the no-grad
   forward bit-equal, PIPE_DEPTH flash forwards each.

17. serve_mesh (run after serve): large f16d32 @256px with phase serve's
   random weights (handed to the ranks in a checkpoint file) served by two
   processes on the card over gloo (this script under torchrun, --worker
   serve-mesh-<i>: the runs of SERVE_MESH_GROUPS[i], the two groups on two
   ranks each, beside each other), cli.serve's own code building each
   placement of SERVE_MESH_RUNS at --max_batch 8: (a) tensor, model 2, through
   cli.serve.serve: rank 0 serves HTTP on port 0 (four concurrent requests,
   two reconstruct b8 uint8, an encode b4 float16 and a decode b4, then one
   b8 reconstruct alone) while rank 1 follows; (b) replicate, data 2: a b8
   reconstruct (4 rows a rank), a batch of 3 (bucket 4: 2 rows a rank) and
   one image (every rank whole); (c) fsdp, model 2: a b8 reconstruct. Each
   response's shape, range and error against one process's fp32 twin
   within MODEL_MEAN_RATIO / MODEL_MAX_RATIO of one process's plain bf16
   path's; each rank's launches in the last reconstruct equal to
   launches_per_local_reconstruct (a) or launches_per_reconstruct (b, c),
   its routes local_sublayer / local_ln_qkv_rope only under tensor; peak
   GiB, seconds and bytes staged a rank logged (not a speed); (d) one
   process under torchrun on a (1, 1, 1) mesh, joined by cli.serve's own
   join_mesh over NCCL (the backend of a multi-card deployment; headers
   and payloads broadcast on the engine's stream), run beside the two
   ranks: a reconstruct b8 uint8 and a b8 over HTTP, held to the same
   rule, its launches to launches_per_reconstruct; one process's responses
   are computed beside the ranks; (e) tensor_scan: the
   same weights in the scan layout (a scan_blocks checkpoint, written
   while (a)-(c) run) under
   'tensor' at model 2 through cli.serve.build_engine, the b8
   reconstruct, held to the same rule, the same
   launches and routes as (a) (the sublayer kernels on a rank's heads
   inside the stacks), bit-equality with (a)'s responses logged; the
   card's memory back after the ranks; (f) beside them, four ranks
   (--worker tensor4): large at TENSOR4_DEPTHS placed 'tensor' at model 4,
   where stage 2's 6 heads are cut as the JAX rule cuts them (route
   gathered_heads), a b4 no-grad forward within TENSOR4_MEAN_RATIO of
   rank 0's one-process bf16 error against fp32, stage 2's q/k/v/proj
   bytes a rank a quarter of the whole.
18. scan (run after quant, with phase serve's weights): the scan layout
   (scan_blocks: each stage's blocks one BlockStack of stacked parameters).
   (a) The weights stacked by ops.stack.to_scanned_params (no second init);
   a b32 reconstruct at 256px of each layout through InferenceEngine, the
   rewrites and the fused norm on: max |scan - unrolled| within KERNEL_RTOL
   of max|unrolled| (0 expected), each one's launches equal to
   launches_per_reconstruct(256) of the unrolled model, the two timed in
   turns. (b) One stage-1 step of each layout (SCAN_STEP_BATCH =
   SCAN_STEP_ACCUM x 8, L1 + KL, 'auto_train', remat 'none', AdamW) from
   the same weights and batch under torch.use_deterministic_algorithms(True)
   after one warm-up: loss within SCAN_LOSS_RTOL and grad norm within
   SCAN_GRAD_NORM_RTOL (bit-equality logged), exactly 12 flash forward and
   12 deterministic flash backward launches each and no other kernel; ms in
   turns and peak GiB. (c) python -m deepl_project_tpu_torch.cli.train
   --variant large --gradient_checkpointing --scan_blocks --optimizer
   adafactor --data synthetic, SCAN_CLI_STEPS steps at b SCAN_CLI_BATCH:
   finite losses, 12 + 6 flash launches a step, a checkpoint of stacked keys
   whose config.json says scan_blocks, reloaded through load_config
   (model_from_checkpoint) into an InferenceEngine and one b8 reconstruct
   with launches_per_reconstruct(256)'s launches. (d) The extrapolation
   sweep of that checkpoint at SCAN_SWEEP (256, 512px; EVAL_IMAGES images
   in chunks of EVAL_CHUNKS) against the same weights unrolled: one chunk's
   logits within KERNEL_RTOL of max (bit-equality logged), each layout's
   launches launches_per_reconstruct(res) (512px: 12 small_attention
   launches a chunk, stage 4 inside its stack).

Launches are checked against one table per resolution (256, 512, 1024px;
launches_per_reconstruct; phase dit's tokenizer halves, tokenizer_launches). group_norm_silu's launches are checked on every
path against norm_table, derived from the module structure (norm_sites: two
sites a ResBlock and the decoder's norm_out, a stats and an apply launch
each, in no-grad bf16 forwards): a 256px reconstruct 13 at 256x256 and 12
at 128x128 (C=192), the sweep's chunks, int8 serving, the GAN step's
no-grad forward of the discriminator update, the self-perceptual target
pass (the encoder's 12), and none in any forward that builds a graph. The DINOv2
teacher is looked up with the Hugging Face libraries offline. The line before the last is the
``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time

# H100 SXM dense peaks (NVIDIA data sheet) for the bound of each kernel:
# bf16 tensor cores, fp32 outside the tensor cores (elementwise work), HBM.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12
KERNEL_RTOL = 2 ** -6
# group_norm_stats' per-channel fp32 sums (6.6e4 values an image at 256px)
# against the plain fp32 sums: two summation orders differ by ~1e-6
# relative; a slab or a row left out would move a sum by far more.
STATS_RTOL = 1e-5
# Whole-model check: the kernel path and the plain bf16 path round at
# different places in 26 attention sublayers, and a random-weight model
# carries each rounding difference through the decoder, so neither is held to
# the other; both are held to the fp32 computation, and the kernel path must
# be about as close to it as the plain bf16 path.
MODEL_MEAN_RATIO = 1.5
MODEL_MAX_RATIO = 2.0
# Training: the flash path and the plain attention core round at different
# places in 6 stage-2 sublayers of a bf16 model; on the same weights and
# images (the mean decoded, no sampling noise) their losses must agree to 1%
# and their gradient norms to 5%.
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GRAD_NORM_RTOL = 5e-2
TRAIN_STEPS = 5
COMPARE_BATCH = 4  # the plain core's saved [B, h, N, N] weights bound it
# Stage 2 (phase gan): the yaml's stage-2 batch, no accumulation (the GAN
# step takes the whole batch); flash launches per step: the generator's
# forward and backward at stage 2 (6 + 6) and the discriminator update's
# fresh forward (6).
GAN_BATCH = 8
GAN_STEPS = 5
GAN_LAUNCHES_PER_STEP = {"flash_attention_fwd": 12, "flash_attention_bwd": 6}
# Phase recipe: the repo's stage-1 recipe as the yaml sets it (batch 8 in 4
# microbatches of 2): per step 4 x (6 forward + 6 backward) flash launches.
RECIPE_YAML = "configs/transvae_large_f16d32.yaml"
RECIPE_STEPS = 5
# Phase remat: one compute_grads of a batch of 8 under each setting
# (policy, remat_resample); None is no remat.
REMAT_BATCH = 8
REMAT_CASES = (("no remat", None, False), ("none", "none", False), ("dots", "dots", False),
               ("dots_all", "dots_all", False), ("conv_dots", "conv_dots", False),
               ("dots+resample", "dots", True))
REMAT_RTOL = 1e-3  # loss and grad norm against no remat
REMAT_FIT_BATCH = 16  # one microbatch: without remat 2 x 8 peaks at ~68 GiB
REMAT_FIT_STEPS = 5
# Phase data: an image folder of DATA_IMAGES PNGs (DATA_CLASSES class
# directories and DATA_LOOSE loose images) in (H, W) sizes that make the
# resize and the crop run; cli.train's 5 steps of 16 and a validation batch
# repeat over it. The folder-fed and synthetic steps in turns, DATA_TURN_STEPS
# a turn. InceptionV3 at b32; its first INCEPTION_CHECKED images also on the
# CPU in fp32 (TF32 off on the card), max abs error within INCEPTION_RTOL x
# the largest feature: fp32 on both sides, summed in other orders (4.8e-7
# measured; TF32's 10-bit mantissa alone would be ~1e-3).
DATA_IMAGES = 112
DATA_CLASSES = 4
DATA_LOOSE = 8
DATA_SIZES = ((256, 320), (384, 256), (300, 300))
DATA_TURN_STEPS = 3
INCEPTION_BATCH = 32
INCEPTION_CHECKED = 4
INCEPTION_RTOL = 1e-5
# The rFIDs' sqrtm: a process of its own with its BLAS on FID_BLAS_THREADS
# threads, reading the features from the file named by its argument and
# printing {"same", "rfid", "s"}.
FID_BLAS_THREADS = 2
FID_JOB = ("import json, sys, time\n"
           "import numpy as np\n"
           "from deepl_project_tpu_torch.utils.fid import fid_from_features\n"
           "f = np.load(sys.argv[1])\n"
           "t = time.time()\n"
           "out = {'same': fid_from_features(f['real'], f['real']),\n"
           "       'rfid': fid_from_features(f['real'], f['fake'])}\n"
           "print(json.dumps({**out, 's': time.time() - t}))\n")
# Phase dit: the latent DiT-B/2 (hidden 768, depth 12, 12 heads; RMSNorm,
# SwiGLU, RoPE) trained by cli.train_dit on large f16d32 @256 latents (16 x
# 16 x 32) of a labelled image folder at the CLI's batch of 64, then sampled
# by cli.sample_dit (16 samples, 50 Euler steps, CFG 4: one b16 decode).
# The tokenizer's no-grad bf16 encode and decode take the attention and
# GroupNorm -> SiLU kernels; the DiT's own attention at N=64 takes the plain
# core. DiT-B/1 on 32 x 32 latents (N=1024, b8) takes small_attention.
DIT_BATCH = 64
DIT_STEPS = 10
DIT_STATS_BATCHES = 2
DIT_FID_SAMPLES = 64
DIT_SAMPLES = 16
DIT_SAMPLE_STEPS = 50
DIT_CFG = 4.0
DIT_B1 = (8, 32)  # (batch, latent grid) of the DiT-B/1 forward
DIT_TIMED_STEPS = 5  # the b64 step on ready latents: median of steps 2-5
# (batch, N, heads) of the flash kernels' shapes: the training microbatch,
# 256px serving at batch 32 (stage 2), 512px serving at batch 2 and the
# 1024px sweep's chunk of 4 (stage 2).
FLASH_TRAIN = (8, 4096, 6)
# The other training shapes, checked: phase recipe's microbatch of 2,
# phase remat's fit at batch 16, stage 2's local heads under tensor
# parallelism at model=2 (3 of 6; phase parallel (c)) and phase parallel
# (e)'s batch of 3 on the subset mesh's one rank (SUBSET_BATCH).
FLASH_LOCAL_HEADS = (8, 4096, 3)
FLASH_TRAIN_CHECKED = ((2, 4096, 6), (16, 4096, 6), FLASH_LOCAL_HEADS, (3, 4096, 6))
# The first two also timed beside their plain versions, SDPA and its
# backward (the kernels line's train_ms_by_shape); the local heads are
# timed in phase parallel (c).
FLASH_TRAIN_TIMED = FLASH_TRAIN_CHECKED[:2]
FLASH_SERVE_256 = (32, 4096, 6)
FLASH_SERVE_512 = (2, 16384, 6)
FLASH_SWEEP_1024 = (4, 65536, 6)
# Forward only, checked: phase dit's b64 encode (its b16 and b8 decodes are
# FLASH_TRAIN_CHECKED's and FLASH_TRAIN's shapes), phase serve_mesh's
# stage 2: tensor's b4 encode and decode on 3 heads a rank, replicate's
# rows a rank (4 of a b8, 2 of a bucket of 4, 1) on 6 heads, and phase
# parallel (f)'s tensor-parallel dropout forward at b2 (DROPOUT_BATCH) on 3.
SERVE_MESH_FLASH = ((4, 4096, 3), (4, 4096, 6), (1, 4096, 6))
FLASH_FWD_CHECKED = ((DIT_BATCH, 4096, 6),) + SERVE_MESH_FLASH + ((2, 4096, 3),)
# small_attention at 512px stage 4, (batch, N, heads); group_norm_silu at the
# large f16d32 ResBlock shapes (stages 0 and 1) at b32.
SMALL_512 = (8, 1024, 24)
# small_attention in DiT-B/1 (12 heads at N=1024): q and k fresh from RoPE,
# v a view of the [B, N, 3C] qkv product with row stride 3C.
SMALL_DIT = (DIT_B1[0], DIT_B1[1] ** 2, 12)
GROUP_NORM_SHAPES = ((32, 192, 256, 256), (32, 192, 128, 128))
# Also one fp32 map, at large_f8d16's stage-1 width (C=384).
GROUP_NORM_CASES = tuple((s, "bf16") for s in GROUP_NORM_SHAPES) + (((8, 384, 128, 128), "fp32"),)
# extrapolation_sweep: resolution -> images per forward (chunk).
EVAL_CHUNKS = {256: 8, 512: 8, 1024: 4}
# Resolution -> the other batches at which a path runs large f16d32's no-grad
# bf16 forward (the fused GroupNorm -> SiLU): at 256px the engine's padded
# batches (a power of two up to 32: serve's requests of 2, 4 and 8, the
# quant calibration's 4) and evaluate_model's 16, the GAN discriminator
# update's and the self-perceptual target pass's 8, the sweep's chunk, phase
# dit's encode and FID decode at 64 and its sample decodes at 8 and 16, phase
# serve_mesh's rows a rank (8, 4, 2, 1); at
# 512px serve's and eval's b2 and the sweep's chunk; at 1024px the sweep's
# chunk. Their maps (norm_checked_shapes) are checked only: the kernels'
# grid (slabs, B) depends on B and H*W.
NORM_PATH_BATCHES = {256: (1, 2, 4, GAN_BATCH, REMAT_BATCH, EVAL_CHUNKS[256], 16, DIT_BATCH),
                     512: (2, EVAL_CHUNKS[512]), 1024: (EVAL_CHUNKS[1024],)}
# ln_qkv_rope's shapes in the sweep, (batch, N, C, height, width): stages 2-4
# of a 512px chunk of 8 and of a 1024px chunk of 4.
QKV_SWEEP = ((8, 16384, 384, 128, 128), (8, 4096, 768, 64, 64), (8, 1024, 1536, 32, 32),
             (4, 65536, 384, 256, 256), (4, 16384, 768, 128, 128), (4, 4096, 1536, 64, 64))
EVAL_IMAGES = 8
# Int8: the scopes, the JAX package's bound on the int8 reconstruction's
# relative L2 error against the float model (tests/test_quant.py), and the
# bound on one int8 site's output against its bf16 call (per-tensor int8
# activations of normal data: ~1.3% expected).
QUANT_SCOPES = ("resblock", "ffn", "all")
QUANT_REL_L2 = 0.15
QUANT_SITE_REL_L2 = 0.05

# The kernels built on wgmma and TMA (csrc/hopper_tma_wgmma.cuh).
WGMMA_KERNELS = ("ln_qkv_rope", "proj_bias_gemm", "small_attention", "flash_attention_bwd",
                 "flash_attention_fwd", "attention_core")
# The flash backward of checkouts from before its single pass: two
# launchers, built by --baseline from such a DIR with these signatures.
PAIR_KERNELS = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
# Launcher name -> its source file's name, where they differ.
SOURCE_OF_FLASH = {"flash_attention_bwd_det": "flash_attention_bwd"}

# Phase parallel: (b)'s global batch (2 ranks x 4 rows under remat 'none'
# against one process at 8); its bars, loss within PARALLEL_LOSS_RTOL and
# grad norm within PARALLEL_GRAD_NORM_RTOL relative (the same in (a) against
# phase train's rows). The GAN step, in bf16 and in fp32 without TF32:
# its adaptive weight (unclamped: PARALLEL_GAN_ADAPTIVE_MAX) within
# PARALLEL_ADAPTIVE_RTOL, its global disc loss within PARALLEL_LOSS_RTOL,
# the same decision of a floor near the untrained discriminator's hinge
# loss (PARALLEL_GAN_FLOOR; ~2 with D's outputs near 0); in fp32 only its
# grad norm within PARALLEL_GRAD_NORM_RTOL and its loss, which carries the
# weight's gap through the weighted GAN term, within the weight's bar
# (in bf16 one process at b8 lies percents from fp32 in grad norm where
# the ranks do not; PERF.md).
PARALLEL_BATCH = 8
# (b)'s stage-1 runs (stage1, fsdp, tensor and the scan twins) and their
# one-process twin run large f16d32 cut in depth to PARALLEL_STEP_DEPTHS
# (two blocks a transformer stage keep a stack of depth 2 in the scan
# twins), to keep the script's time; the GAN runs keep the full depth:
# cut to these depths one process's bf16 GAN step and the bf16 ranks' part
# by more than PARALLEL_ADAPTIVE_RTOL in the adaptive weight (phase
# gan_cut, not in the defaults, reads it beside the fp32 twin).
PARALLEL_STEP_DEPTHS = (1, 1, 2, 2, 2)
# (a)'s cli.train under torchrun: its global batch (in 2 microbatches, ~30
# GiB) and steps, its checkpoint resumed by one process. It starts once both
# of (b)'s ranks are past PARALLEL_CLI_AFTER, their last run that holds
# more than ~15 GiB a rank, and runs beside the rest of (b) and (d).
PARALLEL_CLI_BATCH, PARALLEL_CLI_STEPS = 4, 2
PARALLEL_CLI_AFTER = "gan_fp32"
# (e) cli.train on a subset mesh: (b)'s two ranks (after (d)) at global
# --batch_size SUBSET_BATCH, which the data axis of 2 does not divide: the
# JAX trainer's subset mesh of gcd(3, 2) = 1 data rank, rank 0; rank 1 is
# left out. Large f16d32 cut to PARALLEL_STEP_DEPTHS with remat ('none', as
# (b)), SUBSET_STEPS steps under torch.use_deterministic_algorithms, each
# rank its own --output_dir under SUBSET_DIR (the left-out rank's must stay
# empty); one process's cli.train of the same flags runs beside the ranks
# (this script's --worker subset-one, a process of its own for cuBLAS's
# deterministic workspace), its losses and grad norms the reference.
SUBSET_BATCH, SUBSET_STEPS = 3, 2
# (f) A tensor-parallel (model 2) train-mode forward of the same model at
# dropout DROPOUT_P, deterministic=False, no grad, on a synthetic batch of
# DROPOUT_BATCH at 256px after torch.manual_seed(DROPOUT_SEED), on (b)'s
# two ranks after (e), against --worker subset-one's one-process forward of
# the same seed: the ranks' reconstructions bit-identical, every dropout
# mask equal to one process's (sha256 of its bytes), the L1 distance to the
# input within PARALLEL_LOSS_RTOL of one process's. DROPOUT_TIMED: the
# shape at which ops.layers.dropout (its seed broadcast over the two ranks'
# group) and F.dropout are timed (stage 2's tokens at b2).
DROPOUT_P, DROPOUT_BATCH, DROPOUT_SEED = 0.1, 2, 5
DROPOUT_TIMED = (2, 4096, 384)
PARALLEL_LOSS_RTOL = 1e-3
PARALLEL_GRAD_NORM_RTOL = 1e-2
# A scan-layout twin (fsdp_scan, tensor_scan) against its unrolled run on
# the same rank, both stepped deterministic (PARALLEL_DETERMINISTIC): the
# loss bit-equal; the twins of PARALLEL_SCAN_BIT_EQUAL bit-equal in the
# grad norm and each block's first moment after the step (_moment_stats:
# by the unrolled name, a stack's slice j as block j) too; the others' grad
# norm within PARALLEL_SCAN_GRAD_NORM_RTOL and first moments within
# PARALLEL_SCAN_SLICE_RTOL in their sums of squares and, over the norm, in
# their position-weighted sums. On an H100 80GB HBM3 (700 W) the tensor
# twin reads bit-equal and the FSDP twin 7.4e-8 (grad norm) and 2.0e-7
# (moments) apart: FSDP sums a split stack's squares in another grouping.
# Without
# the deterministic flash backward they read up to 4.2e-5 and 5.5e-3
# apart (its run-dependent dq order); two slices or two ranks' shards
# swapped move the moments by 0.36-0.89 in the micro model on the CPU.
PARALLEL_SCAN_BIT_EQUAL = ("tensor_scan",)
PARALLEL_SCAN_GRAD_NORM_RTOL = 1e-6
PARALLEL_SCAN_SLICE_RTOL = 1e-5
PARALLEL_ADAPTIVE_RTOL = 1e-2
PARALLEL_GAN_ADAPTIVE_MAX = 1e4
PARALLEL_GAN_FLOOR = 2.0
# Phase context: large f16d32 at CONTEXT_RES split over a context axis of 2
# (two processes on the card over gloo). (a) the ring alone at stage 2's
# shape (B, N, heads); (b) the no-grad forward of CONTEXT_FWD_BATCH images,
# whose gathered reconstruction must lie within CONTEXT_MEAN_RATIO of one
# process's bf16 forward in mean abs error against one process's fp32 (the
# serve phase's rule for a rounding change); (c) one stage-1 step at global
# CONTEXT_STEP_BATCH against one process (phase parallel's bars). The
# model's CONTEXT_SUBLAYERS attention sublayers (half encoder, half decoder)
# each run a ring of 2 steps; the flash kernels are held to their plain
# versions and timed at the step's local ring shapes (stages 2-4,
# CONTEXT_RING_SHAPES; the forward also at CONTEXT_FWD_BATCH), and the
# two-rank ring is checked at CONTEXT_RING and at each of those shapes'
# global N (CONTEXT_RING_CHECKED).
CONTEXT_RES = 1024
CONTEXT_RING = (1, 65536, 6)
CONTEXT_FWD_BATCH = 1
CONTEXT_STEP_BATCH = 2
CONTEXT_MEAN_RATIO = 1.1
# The phase's large f16d32: full width, the depth of each stage cut from
# (3, 3, 3, 4, 6) to CONTEXT_DEPTHS to keep the script's time (since PR 20;
# two blocks a transformer stage keep a stack of depth 2 in the scan
# layout's forward).
CONTEXT_DEPTHS = (1, 1, 2, 2, 2)
CONTEXT_SUBLAYERS = 2 * sum(CONTEXT_DEPTHS[2:])
CONTEXT_RING_SHAPES = ((2, 32768, 6), (2, 8192, 12), (2, 2048, 24))
CONTEXT_RING_CHECKED = (CONTEXT_RING,) + tuple((b, 2 * n, h) for b, n, h in CONTEXT_RING_SHAPES)
# Phase context's halo conv check: an fp32 map [B, C, H, W] split over the
# two ranks' rows; each conv within CONTEXT_HALO_RTOL of max of the whole
# map's conv sliced (forward and input gradient; the int8 conv bit-equal).
CONTEXT_HALO_MAP = (1, 128, 128, 128)
CONTEXT_HALO_RTOL = 1e-5
# Phase context (d): one GAN step of large f16d32 at CONTEXT_GAN_RES, global
# b CONTEXT_GAN_BATCH (each rank its 256 rows of both images), bf16, remat
# 'none', on the two ranks and on one process from the same weights, batch
# and latent noise: L1, the self-perceptual term of a frozen random twin
# (seed 1) in the LPIPS slot, VF 0.1 through the stub teacher (DINOv2 is
# not on the card's machine) and vf_proj, GAN 0.1 with the adaptive weight
# (unclamped), R1 (CONTEXT_GAN_R1) and the disc loss floor
# (CONTEXT_GAN_FLOOR, under the untrained hinge loss of ~2, so D updates).
# Every context rank runs the teacher and the discriminator on the gathered
# images. Ring steps a rank: the encoder's sublayers run 7 times forward
# (the generator's forward and its recompute, the fresh reconstruction,
# the twin on the reconstruction and on the target, the twin's recompute in
# the adaptive weight's backward and in the step's) and 3 times backward,
# the decoder's three times forward and once backward; 2 steps each.
CONTEXT_GAN_RES = 512
CONTEXT_GAN_BATCH = 2
CONTEXT_GAN_R1 = 10.0
CONTEXT_GAN_FLOOR = 0.6
CONTEXT_ENC_SUBLAYERS = sum(CONTEXT_DEPTHS[2:])
CONTEXT_GAN_RING_SHAPES = ((2, 8192, 6), (2, 2048, 12), (2, 512, 24))
# (d)'s runs, (key, dtype, batch, resolution): the bf16 step drives the
# flash kernels; its fp32 twin without TF32 and with cuDNN's deterministic
# algorithms (the plain ring partials), at full width but b1 at 256px so that two ranks fit on the card (at 512px
# b1 one process peaks at 51.8 GiB), holds the loss, grad norm and
# adaptive weight to the bars. In bf16 the GAN step's rounding moves them by percents (one
# process against its own fp32 step, and two ranks against one process:
# phase parallel, PERF.md), as it does in the JAX package
# (tests/gan_step_parity.py's bf16_gaps); bf16 holds the rest.
CONTEXT_GAN_RUNS = (("gan", "bfloat16", CONTEXT_GAN_BATCH, CONTEXT_GAN_RES),
                    ("gan_fp32", "float32", 1, 256))
# Phase context (e): the int8 model at CONTEXT_RES b1 (the forward's image),
# calibrated and run under the group. Its calibration in fp32 without TF32
# (bf16 rounds a site's maximum to 2^-8, above the bar) within
# CONTEXT_AMAX_RTOL of one process's on the whole image; the bf16 int8
# model quantized under the group from the bf16 calibration, as cli.serve
# calibrates.
CONTEXT_INT8_SCOPE = "all"
CONTEXT_AMAX_RTOL = 1e-3
# Phase context (g): the same model at CONTEXT_G_RES on the same two ranks, a
# height whose maps the context size does not all divide (720 % 32 = 16):
# each rank holds 360, 180, 90 and 45 rows of stages 0-3 and 23 / 22 of
# stage 4's 45 (GSPMD's uneven split, parallel.context.row_split). The b1
# no-grad forward against one process's fp32 and bf16 forwards ((b)'s bar)
# and the b2 stage-1 step against one process's ((c)'s bars); every ring
# partial on the flash kernels (launches = ring steps), at ragged local
# token counts. CONTEXT_G_RING: rank 0's (B, N_local, heads) at b1 with the
# key chunks of its two ring steps (its own, the other rank's), held to the
# plain versions and timed in phase context's kernel rows.
CONTEXT_G_RES = 720
CONTEXT_G_RING = (((1, 16200, 6), (16200, 16200)), ((1, 4050, 12), (4050, 4050)),
                  ((1, 1035, 24), (1035, 990)))
# The ragged local token counts each rank's ring partials must launch at, by
# heads: rank 0 holds 23 of stage 4's 45 rows, rank 1 22.
CONTEXT_G_TOKENS = ({6: 16200, 12: 4050, 24: 1035}, {6: 16200, 12: 4050, 24: 990})
# Phase serve_mesh (f): large f16d32 at TENSOR4_DEPTHS, bf16, attention
# 'auto', placed 'tensor' on a model axis of 4 (four ranks on the card over
# gloo, --worker tensor4): stage 2's 6 heads do not split over 4, so
# to_q/k/v hold 96 of its 384 columns and proj 96 input rows, as the JAX
# rule places them; q, k and v are gathered for the core (route
# gathered_heads). The no-grad forward of TENSOR4_BATCH images at 256px
# against one process's fp32 forward: its mean error within
# TENSOR4_MEAN_RATIO of one process's bf16 forward's.
TENSOR4_DEPTHS = (1, 1, 2, 2, 2)
TENSOR4_BATCH = 4
TENSOR4_MEAN_RATIO = 1.1
TENSOR4_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "outputs",
                           "chip_smoke_tensor4")

# Phase pipeline: the latent DiT-L/2 (hidden 1024, 16 heads of 64), full
# width, depth cut from 24 to PIPE_DEPTH (12 in PRs 18-19, 4 since PR 20;
# to keep the script's time; every
# block is alike), bf16, every parameter random, one step of rectified flow
# (AdamW 1e-4) pipelined over the ranks of one card on gloo.
# (a) pipe 2 at 512px latents (32x32x32: N=256), global b32 in 8
# microbatches, attention 'pallas': every block's core is the flash
# forward and backward at PIPE_FLASH, 2 blocks x 8 microbatches a rank;
# (b) (data, pipe, expert) = (1, 2, 2) with 4 Switch experts at 256px
# latents (16x16: N=64, the plain core), global b16 in 4 microbatches, in
# fp32: the router's argmax is discontinuous, so in bf16 the rounding of a
# microbatch's products against the whole batch's could send a near-tie
# token to another expert, a difference of routing and not of placement.
# Each against one process's step on the same weights, t, noise and labels.
PIPE_RUNS = {
    "a": dict(mesh=(1, 2, 1), grid=32, batch=32, micro=8, impl="pallas", experts=0,
              dtype="bfloat16"),
    "b": dict(mesh=(1, 2, 2), grid=16, batch=16, micro=4, impl="auto", experts=4,
              dtype="float32"),
}
PIPE_DEPTH = 4
PIPE_FLASH = (4, 256, 16)
PIPE_SEED = 5
PIPE_LR = 1e-4
# A block's gradient against one process's (relative L2 over its tensors;
# KERNEL_RTOL's two bf16 steps), and the share of its entries whose AdamW
# update takes the one process's sign (the first step moves each entry by
# ~lr sign(g), so an entry whose gradient lies within rounding of zero may
# flip).
PIPE_BLOCK_GRAD_RTOL = 2 ** -6
PIPE_UPDATE_AGREE = 0.99
PIPE_DRYRUN_NPROC = 8

ROOT = os.path.dirname(os.path.abspath(__file__))
CARD = ""
# Phase parallel's files: the (a) FileStore, the (b) ranks' results.
PARALLEL_DIR = os.path.join(ROOT, "outputs", "chip_smoke_parallel_ipc")
SUBSET_DIR = os.path.join(ROOT, "outputs", "chip_smoke_subset")  # phase parallel (e)
# Phase parallel's paths -> launches by kernel name in that path's run.
PARALLEL_PATHS: dict = {}
# Path label -> group_norm_silu's launches by (kernel, H*W, C) in that
# path's checked run (each equal to its norm_table).
NORM_PATHS: dict = {}
# Phase dit's paths ('dit_train', 'dit_sample', 'dit_b1') -> launches by
# kernel name in that path's run.
DIT_PATHS: dict = {}
# Phase context's files (the ranks' results), its paths (each rank's
# forward and step) -> launches by kernel name, and the flash kernels'
# times at its ring shapes (the kernels line's ring_ms_by_shape).
CONTEXT_DIR = os.path.join(ROOT, "outputs", "chip_smoke_context")
CONTEXT_PATHS: dict = {}
CONTEXT_RING_ROWS: dict = {}
# Phase pipeline's files, its paths (each rank's forward and step) ->
# launches by kernel name, and the flash kernels' rows at PIPE_FLASH.
PIPE_DIR = os.path.join(ROOT, "outputs", "chip_smoke_pipeline")
PIPE_PATHS: dict = {}
PIPE_ROWS: dict = {}
# Phase serve_mesh: large f16d32 @256px (phase serve's random weights,
# handed to the ranks in a checkpoint file) served by two processes on the
# card over gloo (this script under torchrun, --worker serve-mesh-<i>), each
# placement of SERVE_MESH_RUNS, (--mesh_sharding, --mesh_model), in turn in
# its group of SERVE_MESH_GROUPS through cli.serve's own code, at --max_batch
# SERVE_MESH_BATCH, then one process on a (1, 1, 1) mesh over NCCL (--worker
# serve-nccl); its files, and its paths (each run a rank) -> launches by
# kernel name.
SERVE_MESH_DIR = os.path.join(ROOT, "outputs", "chip_smoke_serve_mesh")
# (name, --mesh_sharding, --mesh_model, checkpoint file): tensor_scan serves
# the same weights stacked (a scan_blocks checkpoint) under 'tensor'.
SERVE_MESH_RUNS = (("tensor", "tensor", 2, "model.pt"), ("replicate", "replicate", 1, "model.pt"),
                   ("fsdp", "fsdp", 2, "model.pt"), ("tensor_scan", "tensor", 2, "model_scan.pt"))
# The runs' two groups, each on two ranks of its own torchrun, the groups
# beside each other (--worker serve-mesh-<i>; ~8 GiB a rank).
SERVE_MESH_GROUPS = (("tensor",), ("replicate", "fsdp", "tensor_scan"))
SERVE_MESH_BATCH = 8
SERVE_MESH_PATHS: dict = {}
# Phase scan: large f16d32 in the scan layout (scan_blocks, ops/stack.py).
# (a) phase serve's weights stacked by ops.stack.to_scanned_params, a b32
# reconstruct at 256px with the rewrites and the fused norm on; (b) a
# stage-1 step, SCAN_STEP_BATCH images in SCAN_STEP_ACCUM microbatches (L1
# + KL, attention 'auto_train', remat 'none', AdamW) under
# torch.use_deterministic_algorithms(True) on both layouts from the same
# weights and batch, held to PERF.md section 2's step bars; (c) the README's
# big-model command on the port for SCAN_CLI_STEPS steps at b SCAN_CLI_BATCH
# (its checkpoint, in SCAN_DIR, served and deleted). Its paths -> launches by
# kernel name in that path's run.
SCAN_DIR = os.path.join(ROOT, "outputs", "chip_smoke_scan")
SCAN_STEP_BATCH, SCAN_STEP_ACCUM = 16, 2
SCAN_LOSS_RTOL, SCAN_GRAD_NORM_RTOL = 1e-3, 1e-2
SCAN_CLI_STEPS, SCAN_CLI_BATCH = 3, 8
SCAN_RECON_REPS = 3
# (d) the extrapolation sweep of (c)'s checkpoint at these resolutions.
SCAN_SWEEP = (256, 512)
SCAN_PATHS: dict = {}
# Phase fold_thin: (b) the folded QKV at the three stage shapes (N, C), b
# FOLD_BATCH, FOLD_REPS calls a turn; (c) ThinConv3x3 at large f16d32's
# boundary convs (name, Ci, Co), b THIN_BATCH at 256^2.
FOLD_SHAPES = ((4096, 384), (1024, 768), (256, 1536))
FOLD_BATCH = 8
FOLD_REPS = 5
THIN_CONVS = (("encoder conv_in", 3, 192), ("decoder conv_out", 192, 3))
THIN_BATCH = 32
# Phase time (a)'s path: one reconstruct at attention 'fused'.
TIME_PATHS: dict = {}


def fail(msg: str):
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(f"[chip_smoke] {msg}", flush=True)


@contextlib.contextmanager
def phase_clock(name: str):
    """Log the host seconds a phase took."""
    t = time.time()
    yield
    log(f"phase {name} took {time.time() - t:.1f}s")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time of one call: CUDA events around ``iters`` calls. A sleep
    kernel ahead of them (~1.5 ms of clocks a call) keeps the card busy
    while the host enqueues, so the calls run back to back and a slow or
    shared host does not enter the time (it would for calls shorter than
    their Python and launch overhead)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(3_000_000 * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 1 -------------------------------------------------------------
def phase_build():
    from deepl_project_tpu_torch.ops.hopper import build

    t = time.time()
    paths = build.build()
    log(f"built {sorted(paths)} in {time.time() - t:.1f}s")
    for name, text in build.BUILD_LOGS.items():
        whole = name in WGMMA_KERNELS
        for line in text.splitlines():
            if whole or "registers" in line or "spill" in line or "warning" in line:
                log(f"ptxas {name}: {line.strip()}")


# -- phase 2 -------------------------------------------------------------
def kernel_shapes(batch: int = 32):
    """(N, C, height, width, batch) of the main path's attention stages."""
    return [(4096, 384, 64, 64, batch), (1024, 768, 32, 32, batch),
            (256, 1536, 16, 16, batch)]


def norm_sites(model, res: int, parts=("encoder", "decoder")) -> dict:
    """(H*W, C) -> GroupNorm -> SiLU sites of one forward of ``model``'s
    ``parts`` at ``res`` px that take the fused kernels, from the module
    structure: with the switch (``ops.norms.FUSE_NORM_SILU``) on, two per
    ResBlock (norm1 at its input width, norm2 at its output width), encoder
    stage i at res / 2^i, decoder stage i at res / 2^(stages - 1 - i), and
    the decoder's norm_out at res; none with it off."""
    from deepl_project_tpu_torch.ops import norms
    from deepl_project_tpu_torch.ops.blocks import ResBlock

    sites: dict = {}
    if not norms.FUSE_NORM_SILU:
        return sites

    def add(side, c, n=1):
        key = (side * side, c)
        sites[key] = sites.get(key, 0) + n

    for part in parts:
        stages = getattr(model, part).stages
        for i, stage in enumerate(stages):
            side = res >> (i if part == "encoder" else len(stages) - 1 - i)
            for block in stage:
                if isinstance(block, ResBlock):
                    add(side, block.norm1.weight.numel())
                    add(side, block.norm2.weight.numel())
    if "decoder" in parts:
        add(res, model.decoder.norm_out.weight.numel())
    return sites


def norm_table(model, res: int, forwards: int = 1, parts=("encoder", "decoder")) -> dict:
    """group_norm_silu's launches by (kernel, H*W, C) in ``forwards``
    no-grad bf16 forwards: one stats and one apply launch a site."""
    return {(name, hw, c): n * forwards
            for (hw, c), n in norm_sites(model, res, parts).items()
            for name in ("group_norm_stats", "group_norm_apply")}


def launches_per_reconstruct(res: int = 256, forwards: int = 1,
                             model=None) -> tuple[dict, dict, dict, dict]:
    """Launches of large f16d32's kernels in ``forwards`` reconstructs at
    ``res`` px, in kernel_launches' order: sublayer kernels by (name, N, C),
    flash forwards by (name, N, heads), small_attention by (name, N, heads),
    group_norm_silu's kernels by (name, H*W, C) (``norm_table`` of
    ``model``; none without it). Stages 2-4 hold 3, 4 and 6 blocks, each in
    the encoder and the decoder: 6, 8 and 12 attention sublayers."""
    sub = ("ln_qkv_rope", "attention_core", "proj_bias_gemm")
    table = {
        # Stage 2 (4096, 384): ln_qkv_rope + flash forward; stages 3
        # (1024, 768) and 4 (256, 1536): the whole-sublayer kernels.
        256: ({("ln_qkv_rope", 4096, 384): 6, **{(k, 1024, 768): 8 for k in sub},
               **{(k, 256, 1536): 12 for k in sub}},
              {("flash_attention_fwd", 4096, 6): 6}, {}),
        # ln_qkv_rope everywhere; flash forwards at stages 2-3, and at stage 4
        # (1024, 1536), where the sublayer gate refuses, small_attention.
        512: ({("ln_qkv_rope", 16384, 384): 6, ("ln_qkv_rope", 4096, 768): 8,
               ("ln_qkv_rope", 1024, 1536): 12},
              {("flash_attention_fwd", 16384, 6): 6, ("flash_attention_fwd", 4096, 12): 8},
              {("small_attention", 1024, 24): 12}),
        1024: ({("ln_qkv_rope", 65536, 384): 6, ("ln_qkv_rope", 16384, 768): 8,
                ("ln_qkv_rope", 4096, 1536): 12},
               {("flash_attention_fwd", 65536, 6): 6, ("flash_attention_fwd", 16384, 12): 8,
                ("flash_attention_fwd", 4096, 24): 12}, {}),
    }
    norm = {} if model is None else norm_table(model, res, forwards)
    return tuple({k: v * forwards for k, v in d.items()} for d in table[res]) + (norm,)


def launches_per_local_reconstruct(model, model_size: int, res: int = 256
                                   ) -> tuple[dict, dict, dict, dict]:
    """Launches of one rank in a reconstruct at ``res`` px of ``model`` with
    its attention split over ``model_size`` ranks (tensor placement), in
    kernel_launches' order, from the module structure: each attention
    module of an encoder or decoder stage (N = (res / 2^i)^2 tokens, the
    rank's heads of width W = C / model_size) runs at N <= 1024 the whole
    local sublayer (ln_qkv_rope, attention_core, proj_bias_gemm at (N, W))
    and above it ln_qkv_rope, the flash forward on W / 64 heads and the
    partial projection; group_norm_silu at every site (norm_table: the
    ResBlocks' maps are gathered whole before their norms)."""
    from deepl_project_tpu_torch.ops.attention import AttentionRoPE

    sub: dict = {}
    flash: dict = {}
    for part in ("encoder", "decoder"):
        stages = getattr(model, part).stages
        for i, stage in enumerate(stages):
            side = res >> (i if part == "encoder" else len(stages) - 1 - i)
            for block in stage:
                attn = getattr(block, "attn", None)
                if not isinstance(attn, AttentionRoPE):
                    continue
                n, w = side * side, attn.dim // model_size
                whole = n <= 1024
                for name in (("ln_qkv_rope", "attention_core", "proj_bias_gemm") if whole
                             else ("ln_qkv_rope", "proj_bias_gemm")):
                    sub[(name, n, w)] = sub.get((name, n, w), 0) + 1
                if not whole:
                    key = ("flash_attention_fwd", n, w // 64)
                    flash[key] = flash.get(key, 0) + 1
    return sub, flash, {}, norm_table(model, res)


def norm_checked_shapes() -> list:
    """[B, C, H, W] of every GroupNorm -> SiLU map of large f16d32 at
    NORM_PATH_BATCHES, from norm_sites (a meta-device model), less
    GROUP_NORM_SHAPES."""
    import torch

    from deepl_project_tpu_torch import get_config
    from deepl_project_tpu_torch.models import TransVAE

    with torch.device("meta"):
        model = TransVAE(get_config("large", 16, 32))
    shapes = {(b, c, math.isqrt(hw), math.isqrt(hw))
              for res, batches in NORM_PATH_BATCHES.items() for b in batches
              for hw, c in norm_sites(model, res)}
    return sorted(shapes - set(GROUP_NORM_SHAPES))


def set_fused_norm(on: bool) -> None:
    """The fused GroupNorm -> SiLU switch (``ops.norms.FUSE_NORM_SILU``)
    on or off."""
    from deepl_project_tpu_torch.ops import norms

    norms.FUSE_NORM_SILU = on


def kernel_launches() -> tuple[dict, dict, dict, dict]:
    """Launches by shape since the last reset, in launches_per_reconstruct's
    order."""
    from deepl_project_tpu_torch.ops.hopper import flash_attention as fla
    from deepl_project_tpu_torch.ops.hopper import fused_attention_block as fab
    from deepl_project_tpu_torch.ops.hopper import fused_norm as fnorm
    from deepl_project_tpu_torch.ops.hopper import small_attention as sma

    return (fab.launch_counts_by_shape(), fla.launch_counts_by_shape(),
            sma.launch_counts_by_shape(), fnorm.launch_counts_by_shape())


def norm_launches() -> dict:
    """group_norm_silu's launches by kernel name since the last reset."""
    from deepl_project_tpu_torch.ops.hopper import fused_norm as fnorm

    return fnorm.launch_counts()


def check_norms(path: str, want: dict) -> None:
    """group_norm_silu's launches by (kernel, H*W, C) since the last reset
    must equal ``want`` (a norm_table, or {} for a run that builds a
    graph); kept under ``path`` for the kernels line."""
    from deepl_project_tpu_torch.ops.hopper import fused_norm as fnorm

    got = fnorm.launch_counts_by_shape()
    if got != want:
        fail(f"group_norm_silu launches, {path}: {got} != {want}")
    NORM_PATHS[path] = got
    log(f"group_norm_silu launches, {path}: {got or 'none'} (as expected)")


def reset_launches() -> None:
    from deepl_project_tpu_torch.ops.hopper import flash_attention as fla
    from deepl_project_tpu_torch.ops.hopper import fused_attention_block as fab
    from deepl_project_tpu_torch.ops.hopper import fused_norm as fnorm
    from deepl_project_tpu_torch.ops.hopper import small_attention as sma

    for mod in (fab, fla, sma, fnorm):
        mod.reset_launch_counts()


def flash_bound(name, b, n, h):
    """(flops, bytes) a flash function must do/move: its products (the
    forward's two, 4 x BH N^2 64; the backward's five, S, dP, dV, dK and dQ,
    10 x BH N^2 64), each bf16 [B, N, h, 64] operand read or written once
    and the fp32 [B, h, N] lse rows."""
    bh, d = b * h, 64
    t, row = bh * n * d * 2, bh * n * 4
    if name == "flash_attention_fwd":
        return 4 * bh * n * n * d, 4 * t + row          # q k v -> o, lse
    return 10 * bh * n * n * d, 8 * t + row             # q k v o dO lse -> dq dk dv


def bound(name, b, n, c):
    """(flops, bytes) the kernel must do/move at this shape."""
    m = b * n
    if name == "ln_qkv_rope":
        return 2 * m * c * 3 * c, m * c * 2 + 3 * c * c * 2 + 6 * c * 4 + 4 * n * 32 * 4 + 3 * m * c * 2
    if name == "attention_core":
        return 4 * b * n * n * c, 4 * m * c * 2
    return 2 * m * c * c, 2 * m * c * 2 + c * c * 2 + c * 4


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from deepl_project_tpu_torch.ops.hopper import fused_attention_block as fab
    from deepl_project_tpu_torch.ops.rope import apply_rope2d

    results = {}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    dev, bf = "cuda", torch.bfloat16

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def check(name, shape, got, ref):
        got, ref = got.float(), ref.float()
        if not bool(torch.isfinite(got).all()):
            fail(f"{name} (B, N, C)={shape}: non-finite output")
        err = (got - ref).abs().max().item()
        top = ref.abs().max().item()
        lim = KERNEL_RTOL * top
        log(f"check {name} (B, N, C)={shape}: max_abs_err={err:.3e} max|plain|={top:.3e} "
            f"rel={err / top:.3e} bound={lim:.3e} (rel {KERNEL_RTOL:.3e})")
        if not err <= lim:
            fail(f"{name} (B, N, C)={shape}: max_abs_err {err:.3e} > {lim:.3e}")
        return err

    # Serving at b32 (checked and timed), then the self-perceptual step's
    # frozen encoder at b8 and phase dit's encode at b64 and decode at b16
    # (checked only; each max_abs_err joins the row's).
    for n, c, hh, ww, b in (kernel_shapes() + kernel_shapes(REMAT_BATCH)
                            + kernel_shapes(DIT_BATCH) + kernel_shapes(DIT_SAMPLES)):
        timed, shape = b == 32, (b, n, c)
        nh = c // 64
        x = randn(b, n, c, dtype=bf)
        ln = tuple((1 + randn(c, scale=0.1), randn(c, scale=0.1)) for _ in range(3))
        # Weights of std 2/sqrt(C): logits of std ~6, a peaked softmax.
        wq, wk, wv, wp = (randn(c, c, scale=2 / c ** 0.5) for _ in range(4))
        bp = randn(c, scale=0.1)
        packed = fab.pack_qkv(ln, wq, wk, wv)
        args = (x, ln, wq, wk, wv, hh, ww)
        q, k, v = fab.ln_qkv_rope(*args, packed=packed)
        torch.cuda.synchronize()
        ref = fab.qkv_rope_reference(*args)
        errs = {"ln_qkv_rope": max(check("ln_qkv_rope", shape, t, r)
                                   for t, r in zip((q, k, v), ref))}
        rec = {}
        if timed:
            rec["ln_qkv_rope"] = {
                "ms": cuda_time_ms(lambda: fab.ln_qkv_rope(*args, packed=packed), 20),
                "plain_ms": cuda_time_ms(lambda: fab.qkv_rope_reference(*args), 5),
                "library_ms": None,  # no single PyTorch call
                "yardstick_ms": qkv_yardstick_ms(x, ln, packed[0])}
        if n <= fab.MAX_SUBLAYER_TOKENS:
            scale = 64 ** -0.5
            o = fab.attention_core(q, k, v, scale)
            torch.cuda.synchronize()
            errs["attention_core"] = check("attention_core", shape, o,
                                           fab.attention_core_reference(q, k, v, scale))
            heads = [t.reshape(b, n, nh, 64).transpose(1, 2) for t in (q, k, v)]
            if timed:
                rec["attention_core"] = {
                    "ms": cuda_time_ms(lambda: fab.attention_core(q, k, v, scale), 20),
                    "plain_ms": cuda_time_ms(
                        lambda: fab.attention_core_reference(q, k, v, scale), 5),
                    "library_ms": cuda_time_ms(
                        lambda: F.scaled_dot_product_attention(*heads), 20)}
            o = o.contiguous()
            # The weight cast once, as AttentionRoPE caches it: the kernel and
            # F.linear are timed on the same bf16 weight.
            wpk, bpk = fab.pack_proj(wp, bp)
            bpb = bp.to(bf)
            out = fab.proj_bias_gemm(o, wpk, bpk)
            torch.cuda.synchronize()
            errs["proj_bias_gemm"] = check("proj_bias_gemm", shape, out,
                                           fab.proj_bias_reference(o, wp, bp))
            if timed:
                rec["proj_bias_gemm"] = {
                    "ms": cuda_time_ms(lambda: fab.proj_bias_gemm(o, wpk, bpk), 20),
                    "plain_ms": cuda_time_ms(lambda: fab.proj_bias_reference(o, wp, bp), 5),
                    "library_ms": cuda_time_ms(lambda: F.linear(o, wpk, bpb), 20)}
            # Row 1 as a whole, and its library composition for comparison.
            sub = (x, ln, wq, wk, wv, wp, bp, hh, ww)
            full = fab.fused_attention_sublayer(*sub, packed=packed, packed_proj=(wpk, bpk))
            torch.cuda.synchronize()
            check("fused_attention_sublayer", shape, full, fab.sublayer_reference(*sub))
            wb = [w.to(bf) for w in (wq, wk, wv)]

            def library_sublayer():
                t = [F.linear(F.layer_norm(x, (c,), g.to(bf), bb.to(bf)), w).reshape(b, n, nh, 64)
                     for (g, bb), w in zip(ln, wb)]
                qh, kh = (apply_rope2d(u, hh, ww) for u in t[:2])
                a = F.scaled_dot_product_attention(
                    *(u.transpose(1, 2) for u in (qh, kh, t[2])))
                return F.linear(a.transpose(1, 2).reshape(b, n, c), wpk, bpb)

            if timed:
                sub_ms = cuda_time_ms(lambda: fab.fused_attention_sublayer(
                    *sub, packed=packed, packed_proj=(wpk, bpk)), 20)
                lib_ms = cuda_time_ms(library_sublayer, 20)
                log(f"time fused_attention_sublayer N={n} C={c} b={b}: kernels "
                    f"{sub_ms:.4f} ms, library composition (cuBLAS + SDPA) "
                    f"{lib_ms:.4f} ms [{CARD}]")
        if not timed:
            for name, err in errs.items():
                row = results[(name, n, c)]
                row["err"] = max(row["err"], err)
                row["checked_batches"].append(b)
            continue
        for name, r in rec.items():
            r["err"], r["checked_batches"] = errs[name], [b]
            flops, nbytes = bound(name, b, n, c)
            r["flops"], r["bytes"] = flops, nbytes
            r["bound_ms"] = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
            lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            yard = (f", yardstick {r['yardstick_ms']:.4f} ms ({QKV_YARDSTICK})"
                    if "yardstick_ms" in r else "")
            log(f"time {name} N={n} C={c} b={b}: kernel {r['ms']:.4f} ms "
                f"({flops / r['ms'] / 1e9:.1f} TFLOP/s), plain {r['plain_ms']:.4f} ms, "
                f"library {lib} ms{yard}, bound {r['bound_ms']:.4f} ms ({flops:.4e} FLOP, "
                f"{nbytes:.4e} B) [{CARD}]")
            results[(name, n, c)] = r
        del x, args, packed, q, k, v, ref
        torch.cuda.empty_cache()

    # ln_qkv_rope at the sweep's shapes (512px and 1024px chunks): checked,
    # timed beside its plain version and the yardstick.
    for b, n, c, hh, ww in QKV_SWEEP:
        x = randn(b, n, c, dtype=bf)
        ln = tuple((1 + randn(c, scale=0.1), randn(c, scale=0.1)) for _ in range(3))
        wq, wk, wv = (randn(c, c, scale=2 / c ** 0.5) for _ in range(3))
        packed = fab.pack_qkv(ln, wq, wk, wv)
        args = (x, ln, wq, wk, wv, hh, ww)
        got = fab.ln_qkv_rope(*args, packed=packed)
        torch.cuda.synchronize()
        err = max(check("ln_qkv_rope", (b, n, c), t, r)
                  for t, r in zip(got, fab.qkv_rope_reference(*args)))
        del got
        flops, nbytes = bound("ln_qkv_rope", b, n, c)
        r = {"err": err, "ms": cuda_time_ms(lambda: fab.ln_qkv_rope(*args, packed=packed), 10),
             "plain_ms": cuda_time_ms(lambda: fab.qkv_rope_reference(*args), 3),
             "yardstick_ms": qkv_yardstick_ms(x, ln, packed[0], 10),
             "bound_ms": max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3}
        log(f"time ln_qkv_rope (B, N, C)={(b, n, c)}: kernel {r['ms']:.4f} ms "
            f"({flops / r['ms'] / 1e9:.1f} TFLOP/s), plain {r['plain_ms']:.4f} ms, yardstick "
            f"{r['yardstick_ms']:.4f} ms ({QKV_YARDSTICK}), bound {r['bound_ms']:.4f} ms "
            f"({flops:.4e} FLOP, {nbytes:.4e} B) [{CARD}]")
        results[("ln_qkv_rope_sweep", b, n, c)] = r
        del x, args, packed
        torch.cuda.empty_cache()
    return results


QKV_YARDSTICK = "two calls, one affine, no RoPE"
# One rank's heads of large f16d32 @256px at model 2 (phase serve_mesh's
# tensor placement), (batch, N, C, height, width): the heads' width W = C / 2
# (stage 2's 192 pads each branch of ln_qkv_rope's weight to 256). Timed at
# b8 (the reconstructs), checked at b4 too (the encode and the decode).
LOCAL_SHAPES = ((8, 4096, 384, 64, 64), (8, 1024, 768, 32, 32), (8, 256, 1536, 16, 16))
LOCAL_CHECKED_BATCHES = (4,)


def local_bound(name, b, n, c, w):
    """(flops, bytes) of a kernel on a rank's heads of width ``w``: each
    input read once and each output written once (ln_qkv_rope's padding
    is not work the function needs)."""
    m = b * n
    if name == "ln_qkv_rope":
        return 2 * m * c * 3 * w, m * c * 2 + 3 * w * c * 2 + 6 * c * 4 + 4 * n * 32 * 4 + 3 * m * w * 2
    if name == "attention_core":
        return 4 * b * n * n * w, 4 * m * w * 2
    return 2 * m * w * c, m * w * 2 + c * w * 2 + c * 4 + m * c * 2  # the partial projection


def phase_local_kernels():
    """The sublayer kernels on one rank's heads (LOCAL_SHAPES) against
    their plain versions: ln_qkv_rope at W = C / 2, the partial projection
    [C, W] (zero bias), attention_core on W / 64 heads (N <= 1024); each
    timed beside its plain version, its yardstick (F.layer_norm + F.linear
    on the [3W, C] weight; F.linear; SDPA) and its bound."""
    import torch
    import torch.nn.functional as F

    from deepl_project_tpu_torch.ops.hopper import fused_attention_block as fab

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    bf = torch.bfloat16
    results = {}

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    def check(name, shape, got, ref):
        got, ref = got.float(), ref.float()
        if not bool(torch.isfinite(got).all()):
            fail(f"{name} (B, N, C, W)={shape}: non-finite output")
        err = (got - ref).abs().max().item()
        top = ref.abs().max().item()
        log(f"check {name} (B, N, C, W)={shape}: max_abs_err={err:.3e} max|plain|={top:.3e} "
            f"rel={err / top:.3e} bound={KERNEL_RTOL * top:.3e} (rel {KERNEL_RTOL:.3e})")
        if not err <= KERNEL_RTOL * top:
            fail(f"{name} (B, N, C, W)={shape}: max_abs_err {err:.3e} > {KERNEL_RTOL * top:.3e}")
        return err

    scale = 64 ** -0.5
    for b0, n, c, hh, ww in LOCAL_SHAPES:
        w = c // 2
        for b in (b0,) + LOCAL_CHECKED_BATCHES:
            timed, shape = b == b0, (b, n, c, w)
            x = randn(b, n, c, dtype=bf)
            ln = tuple((1 + randn(c, scale=0.1), randn(c, scale=0.1)) for _ in range(3))
            # The last rank's rows of whole [C, C] weights of std 2/sqrt(C).
            wq, wk, wv = (randn(w, c, scale=2 / c ** 0.5) for _ in range(3))
            wp = randn(c, w, scale=2 / c ** 0.5)
            packed = fab.pack_qkv(ln, wq, wk, wv)
            args = (x, ln, wq, wk, wv, hh, ww)
            q, k, v = fab.ln_qkv_rope(*args, packed=packed)
            torch.cuda.synchronize()
            errs = {"ln_qkv_rope": max(check("ln_qkv_rope local", shape, t, r)
                                       for t, r in zip((q, k, v), fab.qkv_rope_reference(*args)))}
            wcat = torch.cat([wq, wk, wv]).to(bf)
            g, bb = (t.to(bf) for t in ln[0])
            # Each kernel's call, its plain version and its yardstick.
            rec = {"ln_qkv_rope": (lambda: fab.ln_qkv_rope(*args, packed=packed),
                                   lambda: fab.qkv_rope_reference(*args),
                                   lambda: F.linear(F.layer_norm(x, (c,), g, bb), wcat))}
            o = randn(b, n, w, dtype=bf)
            wpk, bpk = fab.pack_proj(wp, None)
            out = fab.proj_bias_gemm(o, wpk, bpk)
            torch.cuda.synchronize()
            errs["proj_bias_gemm"] = check("proj_bias_gemm partial", shape, out,
                                           fab.proj_bias_reference(o, wp, None))
            rec["proj_bias_gemm"] = (lambda: fab.proj_bias_gemm(o, wpk, bpk),
                                     lambda: fab.proj_bias_reference(o, wp, None),
                                     lambda: F.linear(o, wpk))
            if n <= fab.MAX_SUBLAYER_TOKENS:
                a = fab.attention_core(q, k, v, scale)
                torch.cuda.synchronize()
                errs["attention_core"] = check("attention_core local", shape, a,
                                               fab.attention_core_reference(q, k, v, scale))
                heads = [t.reshape(b, n, w // 64, 64).transpose(1, 2) for t in (q, k, v)]
                rec["attention_core"] = (lambda: fab.attention_core(q, k, v, scale),
                                         lambda: fab.attention_core_reference(q, k, v, scale),
                                         lambda: F.scaled_dot_product_attention(*heads))
            for name, err in errs.items():
                key = (name + "_local", b0, n, c, w)
                if not timed:
                    results[key]["err"] = max(results[key]["err"], err)
                    results[key]["checked_batches"].append(b)
                    continue
                kern, plain, yard = rec[name]
                flops, nbytes = local_bound(name, b, n, c, w)
                r = {"err": err, "checked_batches": [b], "flops": flops, "bytes": nbytes,
                     "ms": cuda_time_ms(kern, 20), "plain_ms": cuda_time_ms(plain, 5),
                     "yardstick_ms": cuda_time_ms(yard, 20),
                     "bound_ms": max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3,
                     "bound_by": ("operations" if flops / PEAK_BF16_FLOPS
                                  >= nbytes / PEAK_HBM_BYTES else "bytes")}
                log(f"time {name} local (B, N, C, W)={shape}: kernel {r['ms']:.4f} ms "
                    f"({flops / r['ms'] / 1e9:.1f} TFLOP/s), plain {r['plain_ms']:.4f} ms, "
                    f"yardstick {r['yardstick_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                    f"({r['bound_by']}; {flops:.4e} FLOP, {nbytes:.4e} B) [{CARD}]")
                results[key] = r
            del x, args, packed, q, k, v, o, out, rec
            torch.cuda.empty_cache()
    return results


def qkv_yardstick_ms(x, ln, w, iters=20):
    """ln_qkv_rope's yardstick, timed only (no one PyTorch call computes LN,
    three affines, the products and RoPE): F.layer_norm with the q branch's
    affine, then one F.linear on the packed [3C, C] bf16 weight."""
    import torch.nn.functional as F

    g, b = (t.to(x.dtype) for t in ln[0])
    return cuda_time_ms(lambda: F.linear(F.layer_norm(x, (x.shape[-1],), g, b), w), iters)


def phase_flash_kernels():
    """The flash forward and backward against their plain versions; times."""
    import torch
    import torch.nn.functional as F

    from deepl_project_tpu_torch.ops.attention import xla_attention
    from deepl_project_tpu_torch.ops.hopper import flash_attention as fla

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    scale = 64 ** -0.5

    def inputs(b, n, h):
        # Entries of std 1.5: scores q.k/8 of std ~1.1, a spread softmax row.
        return [(1.5 * torch.randn(b, n, h, 64, generator=gen, device="cuda"))
                .to(torch.bfloat16) for _ in range(4)]

    def check(name, shape, got, ref):
        got, ref = got.float(), ref.float()
        if not bool(torch.isfinite(got).all()):
            fail(f"{name} {shape}: non-finite output")
        err = (got - ref).abs().max().item()
        top = ref.abs().max().item()
        lim = KERNEL_RTOL * top
        log(f"check {name} (B, N, h)={shape}: max_abs_err={err:.3e} max|plain|={top:.3e} "
            f"rel={err / top:.3e} bound={lim:.3e} (rel {KERNEL_RTOL:.3e})")
        if not err <= lim:
            fail(f"{name} {shape}: max_abs_err {err:.3e} > {lim:.3e}")
        return err

    def record(name, shape, err, ms, plain_ms, library_ms):
        flops, nbytes = flash_bound(name, *shape)
        r = {"err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
             "flops": flops, "bytes": nbytes,
             "bound_ms": max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3}
        lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
        log(f"time {name} (B, N, h)={shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib} ms, bound {r['bound_ms']:.4f} ms ({flops:.4e} FLOP, "
            f"{nbytes:.4e} B) [{CARD}]")
        results[(name, *shape)] = r

    results = {}
    # Training microbatch: forward and backward.
    shape = FLASH_TRAIN
    q, k, v, do = inputs(*shape)
    o, lse = fla.flash_forward(q, k, v, scale)
    torch.cuda.synchronize()
    o_ref, lse_ref = fla.flash_forward_reference(q, k, v, scale)
    err = max(check("flash_attention_fwd", shape, o, o_ref),
              check("flash_attention_fwd lse", shape, lse, lse_ref))
    del o_ref, lse_ref
    # The backward twice on the same inputs: dq's fp32 partial sums reach L2
    # in a run-dependent order, so the two dq may differ (bounded like the
    # error); dk and dv are summed in registers and must be bit-equal.
    first = fla.flash_backward(q, k, v, o, lse, do, scale)
    second = fla.flash_backward(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    ref = fla.flash_backward_reference(q, k, v, o, lse, do, scale)
    err_bwd = max(check(f"flash_attention_bwd {nm}", shape, g, r)
                  for nm, g, r in zip(("dq", "dk", "dv"), first, ref))
    rerun = (first[0].float() - second[0].float()).abs().max().item()
    top = ref[0].float().abs().max().item()
    log(f"check flash_attention_bwd (B, N, h)={shape}: dq run-to-run max_abs_diff={rerun:.3e} "
        f"({(first[0] != second[0]).sum().item()} of {first[0].numel()} values differ; bound "
        f"{KERNEL_RTOL * top:.3e}); dk, dv bit-equal: "
        f"{torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])}")
    if not (rerun <= KERNEL_RTOL * top and torch.equal(first[1], second[1])
            and torch.equal(first[2], second[2])):
        fail("flash_attention_bwd: two runs on the same inputs differ beyond the bound")
    # Under torch.use_deterministic_algorithms(True): the deterministic
    # launcher, two runs bit-equal, within the bound of the plain version;
    # its time and the device memory one call adds.
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        det = [fla.flash_backward(q, k, v, o, lse, do, scale)]
        torch.cuda.synchronize()
        det_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        det.append(fla.flash_backward(q, k, v, o, lse, do, scale))
        det_ms = cuda_time_ms(lambda: fla.flash_backward(q, k, v, o, lse, do, scale), 20)
    finally:
        torch.use_deterministic_algorithms(was)
    same = all(torch.equal(a, b) for a, b in zip(*det))
    log(f"check flash_attention_bwd deterministic (B, N, h)={shape}: two runs bit-equal "
        f"(dq, dk, dv): {same}; one call's peak device memory above its inputs "
        f"{det_gib:.3f} GiB")
    err_det = max(check(f"flash_attention_bwd_det {nm}", shape, g, r)
                  for nm, g, r in zip(("dq", "dk", "dv"), det[0], ref))
    if not same:
        fail("flash_attention_bwd_det: two runs on the same inputs are not bit-equal")
    del first, second, ref, det
    heads = [t.transpose(1, 2) for t in (q, k, v)]
    sdpa_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(*heads), 20)
    hq = [t.detach().requires_grad_(True) for t in heads]
    out = F.scaled_dot_product_attention(*hq)
    g = do.transpose(1, 2)
    sdpa_bwd_ms = cuda_time_ms(
        lambda: torch.autograd.grad(out, hq, g, retain_graph=True), 20)
    del out, hq
    plain_fwd_ms = cuda_time_ms(lambda: fla.flash_forward_reference(q, k, v, scale), 3)
    plain_bwd_ms = cuda_time_ms(
        lambda: fla.flash_backward_reference(q, k, v, o, lse, do, scale), 3)
    record("flash_attention_fwd", shape, err,
           cuda_time_ms(lambda: fla.flash_forward(q, k, v, scale), 20), plain_fwd_ms, sdpa_ms)
    # The whole flash_backward call (delta, the pass, dq's rounding) beside
    # SDPA's backward, which also includes its own preprocess and rounding.
    record("flash_attention_bwd", shape, err_bwd,
           cuda_time_ms(lambda: fla.flash_backward(q, k, v, o, lse, do, scale), 20),
           plain_bwd_ms, sdpa_bwd_ms)
    row = results[("flash_attention_bwd", *shape)]
    row.update(rerun_max_abs_diff=rerun, det_ms=det_ms, det_max_abs_err=err_det,
               det_peak_gib=det_gib)
    log(f"time flash_attention_bwd (B, N, h)={shape}: default {row['ms']:.4f} ms, "
        f"deterministic {det_ms:.4f} ms [{CARD}]")
    del q, k, v, do, o, lse
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        results[(name, *FLASH_TRAIN)]["checked_shapes"] = [FLASH_TRAIN]
    # The other training shapes: forward and backward checked, each error
    # joining the training row's max_abs_err.
    for shape in FLASH_TRAIN_CHECKED:
        q, k, v, do = inputs(*shape)
        o, lse = fla.flash_forward(q, k, v, scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = fla.flash_forward_reference(q, k, v, scale)
        errs = {"flash_attention_fwd": max(check("flash_attention_fwd", shape, o, o_ref),
                                           check("flash_attention_fwd lse", shape, lse, lse_ref))}
        del o_ref, lse_ref
        got = fla.flash_backward(q, k, v, o, lse, do, scale)
        torch.cuda.synchronize()
        ref = fla.flash_backward_reference(q, k, v, o, lse, do, scale)
        errs["flash_attention_bwd"] = max(check(f"flash_attention_bwd {nm}", shape, g, r)
                                          for nm, g, r in zip(("dq", "dk", "dv"), got, ref))
        for name, err in errs.items():
            row = results[(name, *FLASH_TRAIN)]
            row["err"] = max(row["err"], err)
            row["checked_shapes"].append(shape)
        del got, ref
        if shape in FLASH_TRAIN_TIMED:
            heads = [t.transpose(1, 2) for t in (q, k, v)]
            hq = [t.detach().requires_grad_(True) for t in heads]
            out = F.scaled_dot_product_attention(*hq)
            g = do.transpose(1, 2)
            timed = {
                "flash_attention_fwd": (
                    cuda_time_ms(lambda: fla.flash_forward(q, k, v, scale), 10),
                    cuda_time_ms(lambda: fla.flash_forward_reference(q, k, v, scale), 2),
                    cuda_time_ms(lambda: F.scaled_dot_product_attention(*heads), 10)),
                "flash_attention_bwd": (
                    cuda_time_ms(lambda: fla.flash_backward(q, k, v, o, lse, do, scale), 10),
                    cuda_time_ms(
                        lambda: fla.flash_backward_reference(q, k, v, o, lse, do, scale), 2),
                    cuda_time_ms(lambda: torch.autograd.grad(out, hq, g, retain_graph=True),
                                 10))}
            for name, (ms, plain_ms, library_ms) in timed.items():
                flops, nbytes = flash_bound(name, *shape)
                bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
                results[("flash_train_timed", name, *shape)] = {
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "library_ms": library_ms}
                log(f"time {name} (B, N, h)={shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                    f"ms, {'SDPA' if name.endswith('fwd') else 'SDPA backward'} "
                    f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({flops:.4e} FLOP, "
                    f"{nbytes:.4e} B) [{CARD}]")
            del heads, hq, out, g
        del q, k, v, do, o, lse
    # Forward-only paths (phase dit's b64 encode): the forward checked.
    for shape in FLASH_FWD_CHECKED:
        q, k, v, _ = inputs(*shape)
        o, lse = fla.flash_forward(q, k, v, scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = fla.flash_forward_reference(q, k, v, scale)
        row = results[("flash_attention_fwd", *FLASH_TRAIN)]
        row["err"] = max(row["err"], check("flash_attention_fwd", shape, o, o_ref),
                         check("flash_attention_fwd lse", shape, lse, lse_ref))
        row["checked_shapes"].append(shape)
        del q, k, v, o, lse, o_ref, lse_ref

    # Serving: 512px stage 2, and the 256px stage-2 decision (flash forward
    # against the plain chunked core, in turns: plain, kernel, kernel, plain).
    for shape in (FLASH_SERVE_512, FLASH_SERVE_256):
        q, k, v, _ = inputs(*shape)
        o, _ = fla.flash_forward(q, k, v, scale)
        torch.cuda.synchronize()
        plain = xla_attention(q, k, v, scale)
        err = check("flash_attention_fwd", shape, o, plain)
        del o, plain
        t_plain = [cuda_time_ms(lambda: xla_attention(q, k, v, scale), 3)]
        t_kern = [cuda_time_ms(lambda: fla.flash_forward(q, k, v, scale), 10) for _ in range(2)]
        t_plain.append(cuda_time_ms(lambda: xla_attention(q, k, v, scale), 3))
        heads = [t.transpose(1, 2) for t in (q, k, v)]
        sdpa_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(*heads), 10)
        log(f"serve core (B, N, h)={shape}: flash forward {t_kern[0]:.4f} / {t_kern[1]:.4f} ms, "
            f"plain chunked core {t_plain[0]:.4f} / {t_plain[1]:.4f} ms [{CARD}]")
        record("flash_attention_fwd", shape, err, min(t_kern), min(t_plain), sdpa_ms)
        del q, k, v, heads

    # The 1024px sweep's stage 2: once against the plain forward (its one
    # call timed by events), then the kernel and SDPA.
    shape = FLASH_SWEEP_1024
    q, k, v, _ = inputs(*shape)
    o, lse = fla.flash_forward(q, k, v, scale)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    o_ref, lse_ref = fla.flash_forward_reference(q, k, v, scale)
    end.record()
    torch.cuda.synchronize()
    err = max(check("flash_attention_fwd", shape, o, o_ref),
              check("flash_attention_fwd lse", shape, lse, lse_ref))
    del o, lse, o_ref, lse_ref
    heads = [t.transpose(1, 2) for t in (q, k, v)]
    record("flash_attention_fwd", shape, err,
           cuda_time_ms(lambda: fla.flash_forward(q, k, v, scale), 3), start.elapsed_time(end),
           cuda_time_ms(lambda: F.scaled_dot_product_attention(*heads), 3))
    del q, k, v, heads
    torch.cuda.empty_cache()
    return results


def phase_eval_kernels():
    """small_attention and group_norm_silu (channels_last) against their
    plain versions at the shapes their paths give them; times; and the two
    routes of an attention sublayer at (N=1024, C=1536)."""
    import torch
    import torch.nn.functional as F

    from deepl_project_tpu_torch.ops.hopper import fused_attention_block as fab
    from deepl_project_tpu_torch.ops.hopper import fused_norm as fnorm
    from deepl_project_tpu_torch.ops.hopper import small_attention as sma
    from deepl_project_tpu_torch.ops.rope import apply_rope2d

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    bf = torch.bfloat16
    results = {}

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    def check(name, shape, got, ref):
        got, ref = got.float(), ref.float()
        if not bool(torch.isfinite(got).all()):
            fail(f"{name} {shape}: non-finite output")
        err = (got - ref).abs().max().item()
        top = ref.abs().max().item()
        lim = KERNEL_RTOL * top
        log(f"check {name} {shape}: max_abs_err={err:.3e} max|plain|={top:.3e} "
            f"rel={err / top:.3e} bound={lim:.3e} (rel {KERNEL_RTOL:.3e})")
        if not err <= lim:
            fail(f"{name} {shape}: max_abs_err {err:.3e} > {lim:.3e}")
        return err

    def check_fp32(name, shape, got, ref):
        """An fp32 result, each value within STATS_RTOL of the plain one's."""
        if not bool(torch.isfinite(got).all()):
            fail(f"{name} {shape}: non-finite output")
        err = (got - ref).abs()
        rel = (err / ref.abs()).max().item()
        log(f"check {name} {shape}: max_abs_err={err.max().item():.3e} max "
            f"rel={rel:.3e} bound rel {STATS_RTOL:.1e} (fp32)")
        if not rel <= STATS_RTOL:
            fail(f"{name} {shape}: max rel err {rel:.3e} > {STATS_RTOL:.1e}")
        return err.max().item()

    def record(key, err, ms, plain_ms, library_ms, flops, nbytes, peak):
        r = {"err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
             "flops": flops, "bytes": nbytes,
             "bound_ms": max(flops / peak, nbytes / PEAK_HBM_BYTES) * 1e3,
             "bound_by": "operations" if flops / peak >= nbytes / PEAK_HBM_BYTES else "bytes"}
        lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
        log(f"time {key[0]} {key[1:]}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{lib} ms, bound {r['bound_ms']:.4f} ms ({flops:.4e} FLOP, {nbytes:.4e} B) [{CARD}]")
        results[key] = r

    # small_attention at 512px stage 4: q/k/v are column slices of one
    # [B, N, 3C] buffer, as ln_qkv_rope leaves them. Entries of std 1.5:
    # scores q.k/8 of std ~1.1, a spread softmax row.
    b, n, h = SMALL_512
    c = h * 64
    qkv = randn(b, n, 3 * c, scale=1.5).to(bf)
    q, k, v = (qkv[..., i * c:(i + 1) * c].reshape(b, n, h, 64) for i in range(3))
    scale = 64 ** -0.5
    o = sma.small_attention(q, k, v, scale)
    torch.cuda.synchronize()
    err = check("small_attention", SMALL_512, o, sma.small_attention_reference(q, k, v, scale))
    heads = [t.transpose(1, 2) for t in (q, k, v)]
    record(("small_attention", *SMALL_512), err,
           cuda_time_ms(lambda: sma.small_attention(q, k, v, scale), 20),
           cuda_time_ms(lambda: sma.small_attention_reference(q, k, v, scale), 5),
           cuda_time_ms(lambda: F.scaled_dot_product_attention(*heads), 20),
           4 * b * h * n * n * 64, 4 * b * n * c * 2, PEAK_BF16_FLOPS)
    del qkv, q, k, v, o, heads
    # DiT-B/1's operands: q and k fresh from the standard-pairing RoPE, v a
    # view of the qkv product (row stride 3C) that the wrapper takes as it is.
    b, n, h = SMALL_DIT
    c = h * 64
    qkv = randn(b, n, 3 * c, scale=1.5).to(bf)
    q, k, v = qkv.reshape(b, n, 3 * h, 64).split(h, dim=2)
    q, k = (apply_rope2d(t, DIT_B1[1], DIT_B1[1], "standard") for t in (q, k))
    if v.is_contiguous() or v.stride(1) != 3 * c:
        fail(f"small_attention: the DiT's v is not a strided view ({v.stride()})")
    o = sma.small_attention(q, k, v, scale)
    torch.cuda.synchronize()
    err = check("small_attention", SMALL_DIT, o, sma.small_attention_reference(q, k, v, scale))
    heads = [t.transpose(1, 2) for t in (q, k, v)]
    record(("small_attention", *SMALL_DIT), err,
           cuda_time_ms(lambda: sma.small_attention(q, k, v, scale), 20),
           cuda_time_ms(lambda: sma.small_attention_reference(q, k, v, scale), 5),
           cuda_time_ms(lambda: F.scaled_dot_product_attention(*heads), 20),
           4 * b * h * n * n * 64, 4 * b * n * c * 2, PEAK_BF16_FLOPS)
    del qkv, q, k, v, o, heads

    # group_norm_silu at the large ResBlock shapes (bf16) and one fp32 shape,
    # on channels_last maps as the model holds them: the stats kernel reads
    # x once and writes its partials (3 fp32 operations a value), the apply
    # kernel reads the partials, x, scale and bias and writes y (about 8:
    # an affine, exp, add, divide); both bound by bytes. Then, checked only,
    # every other map the paths give them (norm_checked_shapes), each
    # error joining its kernel's max_abs_err.
    checked = {"group_norm_stats": 0.0, "group_norm_apply": 0.0, "shapes": []}
    for shape, dname, timed in ([(s, d, True) for s, d in GROUP_NORM_CASES]
                                + [(s, "bf16", False) for s in norm_checked_shapes()]):
        bb, cc, hh, ww = shape
        dtype = {"bf16": bf, "fp32": torch.float32}[dname]
        x = (randn(*shape, scale=2.0) + 1).to(dtype).contiguous(
            memory_format=torch.channels_last)
        gs, gb = 1 + randn(cc, scale=0.1), randn(cc, scale=0.1)
        label = (*shape, dname)
        y = fnorm.group_norm_silu(x, gs, gb, 32)
        partial = fnorm.stats(x)
        torch.cuda.synchronize()
        if not y.is_contiguous(memory_format=torch.channels_last):
            fail(f"group_norm_silu {label}: output strides {y.stride()}, not channels_last")
        rows = fnorm._rows_per_slab(x)
        log(f"group_norm_silu {label}: {partial.shape[1]} slabs of {rows} rows, the last "
            f"{hh * ww - (partial.shape[1] - 1) * rows}")
        err = check("group_norm_silu", label, y, fnorm.group_norm_silu_reference(x, gs, gb, 32))
        # The kernel's partials summed over its slabs (torch, for this
        # check only) against the plain per-channel sums.
        err_stats = check_fp32("group_norm_stats", label, partial.sum(1),
                               fnorm.channel_stats_reference(x))
        mul, add = fnorm.mul_add(fnorm.group_sums(partial.sum(1), 32),
                                 (cc // 32) * hh * ww, gs, gb, 1e-5)
        err_apply = check("group_norm_apply", label, fnorm.apply(x, partial, gs, gb, 32),
                          fnorm.apply_reference(x, mul, add))
        if not timed:
            checked["group_norm_stats"] = max(checked["group_norm_stats"], err_stats)
            checked["group_norm_apply"] = max(checked["group_norm_apply"], err, err_apply)
            checked["shapes"].append(shape)
            del x, y, partial, mul, add
            continue
        try:
            fnorm.group_norm_silu(x.contiguous(), gs, gb, 32)
        except ValueError as e:
            refusal = str(e)
        else:
            fail(f"group_norm_silu {label}: took an NCHW-contiguous input")
        # Library calls, timed only: F.group_norm + F.silu for the whole
        # function on the same channels_last x (what the model would call)
        # and on an NCHW-contiguous copy; for the stats pass the one call
        # computing the same per-(image, channel) moments; none for apply.
        gsb, gbb = gs.to(dtype), gb.to(dtype)
        xn = x.contiguous()
        lib_cl = cuda_time_ms(lambda: F.silu(F.group_norm(x, 32, gsb, gbb)), 10)
        lib_nchw = cuda_time_ms(lambda: F.silu(F.group_norm(xn, 32, gsb, gbb)), 10)
        del xn
        var_mean_ms = cuda_time_ms(lambda: torch.var_mean(x, dim=(2, 3), correction=0), 10)
        whole = cuda_time_ms(lambda: fnorm.group_norm_silu(x, gs, gb, 32), 10)
        plain = cuda_time_ms(lambda: fnorm.group_norm_silu_reference(x, gs, gb, 32), 3)
        values, xbytes = x.numel(), x.numel() * x.element_size()
        pbytes = partial.numel() * 4
        whole_bound = (2 * xbytes + xbytes + 2 * cc * 4) / PEAK_HBM_BYTES * 1e3
        log(f"time group_norm_silu {label} whole (2 launches): {whole:.4f} ms, bound "
            f"{whole_bound:.4f} ms (x read twice, y written once), plain {plain:.4f} ms, "
            f"F.group_norm + F.silu channels_last {lib_cl:.4f} ms, NCHW {lib_nchw:.4f} ms; "
            f"NCHW input refused: {refusal} [{CARD}]")
        record(("group_norm_stats", *label), err_stats,
               cuda_time_ms(lambda: fnorm.stats(x), 10),
               cuda_time_ms(lambda: fnorm.channel_stats_reference(x), 3),
               var_mean_ms, 3 * values, xbytes + pbytes, PEAK_FP32_FLOPS)
        record(("group_norm_apply", *label), max(err, err_apply),
               cuda_time_ms(lambda: fnorm.apply(x, partial, gs, gb, 32), 10),
               cuda_time_ms(lambda: fnorm.apply_reference(x, mul, add), 3),
               None, 8 * values, 2 * xbytes + pbytes + 2 * cc * 4, PEAK_FP32_FLOPS)
        results[("group_norm_silu", *label)] = {
            "ms": whole, "plain_ms": plain, "bound_ms": whole_bound, "library_ms": lib_cl,
            "library_nchw_ms": lib_nchw}
        del x, y, partial
    results[("group_norm_checked",)] = checked
    torch.cuda.empty_cache()

    # The two routes of a sublayer at (N=1024, C=1536, b=8), in turns: the
    # whole-sublayer kernels (the route the JAX gate refuses at this shape)
    # against ln_qkv_rope + small_attention + the projection (its route).
    b, n, c, hh, ww = 8, 1024, 1536, 32, 32
    x = randn(b, n, c).to(bf)
    ln = tuple((1 + randn(c, scale=0.1), randn(c, scale=0.1)) for _ in range(3))
    wq, wk, wv, wp = (randn(c, c, scale=2 / c ** 0.5) for _ in range(4))
    bp = randn(c, scale=0.1)
    packed, packed_proj = fab.pack_qkv(ln, wq, wk, wv), fab.pack_proj(wp, bp)
    wpb, bpb = wp.to(bf), bp.to(bf)

    def sublayer():
        return fab.fused_attention_sublayer(x, ln, wq, wk, wv, wp, bp, hh, ww, packed=packed,
                                            packed_proj=packed_proj)

    def qkv_small_proj():
        q, k, v = (t.reshape(b, n, c // 64, 64)
                   for t in fab.ln_qkv_rope(x, ln, wq, wk, wv, hh, ww, packed=packed))
        return F.linear(sma.small_attention(q, k, v, 64 ** -0.5).reshape(b, n, c), wpb, bpb)

    a, s2 = sublayer(), qkv_small_proj()
    torch.cuda.synchronize()
    check("route ln_qkv_rope+small_attention+proj vs sublayer", (b, n, c), s2, a)
    t_sub = [cuda_time_ms(sublayer, 20)]
    t_small = [cuda_time_ms(qkv_small_proj, 20) for _ in range(2)]
    t_sub.append(cuda_time_ms(sublayer, 20))
    log(f"time sublayer routes (N, C, b)=({n}, {c}, {b}): whole-sublayer kernels "
        f"{t_sub[0]:.4f} / {t_sub[1]:.4f} ms, ln_qkv_rope + small_attention + proj "
        f"{t_small[0]:.4f} / {t_small[1]:.4f} ms [{CARD}]")
    results[("routes", n, c)] = {"sublayer_ms": min(t_sub), "small_route_ms": min(t_small)}
    del x, a, s2
    torch.cuda.empty_cache()
    return results


def phase_baseline(dirs):
    """ln_qkv_rope, proj_bias_gemm, small_attention, the flash backward, the
    flash forward and attention_core of this tree against the same functions
    built from other checkouts' sources (DIR/deepl_project_tpu_torch/csrc for
    each DIR), each launched through
    its ctypes launcher on the same inputs at the main paths' shapes; all
    held to the plain version; each DIR timed beside this tree in turns
    (DIR, change, change, DIR). A DIR from before the single-pass backward
    has the flash_attention_bwd_dq + flash_attention_bwd_dkv pair instead: it
    is timed with the plain delta it was given (the device work of that
    tree's flash_backward) against this tree's launcher, which computes delta
    itself. Returns kernel name -> DIR -> shape -> times."""
    import ctypes
    from pathlib import Path

    import torch

    from deepl_project_tpu_torch.ops.hopper import build
    from deepl_project_tpu_torch.ops.hopper import flash_attention as fla
    from deepl_project_tpu_torch.ops.hopper import fused_attention_block as fab
    from deepl_project_tpu_torch.ops.hopper import small_attention as sma
    from deepl_project_tpu_torch.ops.rope import rope2d_tables

    P, I = ctypes.c_void_p, ctypes.c_int
    pair_sigs = {"flash_attention_bwd_dq": [P] * 7 + [I] * 8 + [ctypes.c_float, P],
                 "flash_attention_bwd_dkv": [P] * 8 + [I] * 8 + [ctypes.c_float, P]}
    srcs = {}
    for d in dirs:
        csrc = os.path.join(os.path.abspath(d), "deepl_project_tpu_torch", "csrc")
        if not os.path.isdir(csrc):
            fail(f"--baseline {d}: no deepl_project_tpu_torch/csrc there")
        names = [n for n in WGMMA_KERNELS + PAIR_KERNELS
                 if os.path.exists(os.path.join(csrc, f"{n}.cu"))]
        t = time.time()
        build.build(names, csrc)
        log(f"built {names} of {d} in {time.time() - t:.1f}s")
        for name in names:
            for line in build.BUILD_LOGS.get(f"{name} [{Path(csrc).resolve()}]", "").splitlines():
                if "registers" in line or "spill" in line or "C75" in line:
                    log(f"ptxas {name} ({d}): {line.strip()}")
        srcs[d] = (csrc, names)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    bf = torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream
    results = {}

    def turns(name, shape, d, fns, outs, refs, flops):
        """fns: "baseline" (DIR's) and "change" (this tree's) -> a function
        launching one call; outs are compared with refs after each."""
        for who, fn in fns.items():
            for out in outs:
                out.zero_()
            fn()
            torch.cuda.synchronize()
            for out, ref in zip(outs, refs):
                top = ref.float().abs().max().item()
                err = (out.float() - ref.float()).abs().max().item()
                if not err <= KERNEL_RTOL * top:
                    fail(f"baseline {name} {shape}: {who} max_abs_err {err:.3e} > "
                         f"{KERNEL_RTOL * top:.3e}")
        times = {"baseline": [], "change": []}
        iters = 20 if flops < 5e12 else 3  # the 1024px flash forward: ~0.1 s a call
        for who in ("baseline", "change", "change", "baseline"):
            times[who].append(cuda_time_ms(fns[who], iters))
        log(f"baseline {name} {shape}: {d} {times['baseline'][0]:.4f} / "
            f"{times['baseline'][1]:.4f} ms, change {times['change'][0]:.4f} / "
            f"{times['change'][1]:.4f} ms (turns {d}, change, change, {d}); "
            f"{flops / min(times['baseline']) / 1e9:.1f} -> "
            f"{flops / min(times['change']) / 1e9:.1f} TFLOP/s [{CARD}]")
        results.setdefault(name, {}).setdefault(d, {})[shape] = {
            w: min(v) for w, v in times.items()}

    def launch(fn, *args):
        def run():
            if fn(*args) != 0:
                fail(f"baseline: a launch failed ({fn.__name__})")
        return run

    def same_launcher(name, shape, args, outs, refs, flops, unbounded=None):
        """``unbounded``: (argtypes, args) of a DIR whose flash launcher
        takes one length N (before the length bounds: no ``int Nk``)."""
        for d, (csrc, names) in srcs.items():
            if name not in names:
                continue
            old = False
            if unbounded is not None:
                with open(os.path.join(csrc, f"{SOURCE_OF_FLASH.get(name, name)}.cu")) as f:
                    old = not re.search(r"\bint Nk\b", f.read())
            base = (launch(build.launcher(name, csrc, unbounded[0]), *unbounded[1]) if old
                    else launch(build.launcher(name, csrc), *args))
            turns(name, shape, d, {"baseline": base, "change": launch(build.launcher(name), *args)},
                  outs, refs, flops)

    for n, c, _, _, b in kernel_shapes()[1:]:
        o = torch.randn(b * n, c, generator=gen, device="cuda").to(bf)
        wp = torch.randn(c, c, generator=gen, device="cuda") * 2 / c ** 0.5
        bp = torch.randn(c, generator=gen, device="cuda") * 0.1
        wpk, bpk = fab.pack_proj(wp, bp)
        out = torch.empty_like(o)
        args = (o.data_ptr(), wpk.data_ptr(), bpk.data_ptr(), out.data_ptr(), b * n, c, c,
                stream)
        same_launcher("proj_bias_gemm", (b, n, c), args, [out],
                      [fab.proj_bias_reference(o, wp, bp)], 2 * b * n * c * c)

    # ln_qkv_rope at the three 256px b32 shapes and the 1024px sweep's stage
    # 2. A DIR from before the normalisation pass (its csrc still has
    # tile_mma.cuh) has a launcher without the x-hat scratch.
    for b, n, c, hh, ww in [(b, n, c, hh, ww) for n, c, hh, ww, b in kernel_shapes()] + [
            QKV_SWEEP[3]]:
        x = torch.randn(b, n, c, generator=gen, device="cuda").to(bf)
        ln = tuple((1 + 0.1 * torch.randn(c, generator=gen, device="cuda"),
                    0.1 * torch.randn(c, generator=gen, device="cuda")) for _ in range(3))
        wq, wk, wv = (torch.randn(c, c, generator=gen, device="cuda") * 2 / c ** 0.5
                      for _ in range(3))
        w, gbt = fab.pack_qkv(ln, wq, wk, wv)
        tables = rope2d_tables(64, hh, ww, "reference", "cuda")
        out = torch.empty(b, n, 3 * c, device="cuda", dtype=bf)
        xhat = torch.empty_like(x)  # the scratch of this tree's launcher
        ref = torch.cat(fab.qkv_rope_reference(x, ln, wq, wk, wv, hh, ww), dim=-1)
        ptrs = [t.data_ptr() for t in (x, w, gbt, *tables)]
        tail = (b * n, n, c, 1, stream)
        # This tree's launcher takes the heads' width W (= C here); a DIR's
        # launcher has it where its source declares it.
        change = launch(build.launcher("ln_qkv_rope"), *ptrs, xhat.data_ptr(),
                        out.data_ptr(), b * n, n, c, c, 1, stream)
        for d, (csrc, names) in srcs.items():
            if "ln_qkv_rope" not in names:
                continue
            with open(os.path.join(csrc, "ln_qkv_rope.cu")) as f:
                takes_w = re.search(r"ln_qkv_rope_launch\([^)]*\bint W\b", f.read())
            if takes_w:
                base = launch(build.launcher("ln_qkv_rope", csrc), *ptrs, xhat.data_ptr(),
                              out.data_ptr(), b * n, n, c, c, 1, stream)
            elif os.path.exists(os.path.join(csrc, "tile_mma.cuh")):
                base = launch(build.launcher("ln_qkv_rope", csrc, [P] * 8 + [I] * 4 + [P]),
                              *ptrs, out.data_ptr(), *tail)
            else:
                base = launch(build.launcher("ln_qkv_rope", csrc, [P] * 9 + [I] * 4 + [P]),
                              *ptrs, xhat.data_ptr(), out.data_ptr(), *tail)
            turns("ln_qkv_rope", (b, n, c), d, {"baseline": base, "change": change}, [out],
                  [ref], 2 * b * n * c * 3 * c)
        del x, out, ref, xhat
        torch.cuda.empty_cache()
    b, n, h = SMALL_512
    c = h * 64
    qkv = (1.5 * torch.randn(b, n, 3 * c, generator=gen, device="cuda")).to(bf)
    q, k, v = (qkv[..., i * c:(i + 1) * c].reshape(b, n, h, 64) for i in range(3))
    o = torch.empty(b, n, h, 64, device="cuda", dtype=bf)
    scale = 64 ** -0.5
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, n, h, 3 * c, 3 * c,
            3 * c, c, scale, stream)
    same_launcher("small_attention", SMALL_512, args, [o],
                  [sma.small_attention_reference(q, k, v, scale)], 4 * b * h * n * n * 64)
    del qkv, q, k, v, o

    # The forward tile: flash_attention_fwd at its four shapes (training,
    # serving at 256 and 512px, the 1024px sweep), attention_core at the two
    # sublayer shapes with q/k/v column slices of one [B, N, 3C] buffer.
    for b, n, h in (FLASH_TRAIN, FLASH_SERVE_256, FLASH_SERVE_512, FLASH_SWEEP_1024):
        c = h * 64
        q, k, v = ((1.5 * torch.randn(b, n, h, 64, generator=gen, device="cuda")).to(bf)
                   for _ in range(3))
        o, lse = torch.empty_like(q), torch.empty(b, h, n, device="cuda")
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr())
        args = ptrs + (b, n, n, h, c, c, c, c, scale, stream)
        same_launcher("flash_attention_fwd", (b, n, h), args, [o, lse],
                      list(fla.flash_forward_reference(q, k, v, scale)),
                      flash_bound("flash_attention_fwd", b, n, h)[0],
                      ([P] * 5 + [I] * 7 + [ctypes.c_float, P],
                       ptrs + (b, n, h, c, c, c, c, scale, stream)))
        del q, k, v, o, lse
        torch.cuda.empty_cache()
    for n, c, _, _, b in kernel_shapes()[1:]:
        qkv = (1.5 * torch.randn(b, n, 3 * c, generator=gen, device="cuda")).to(bf)
        q, k, v = (qkv[..., i * c:(i + 1) * c] for i in range(3))
        o = torch.empty(b, n, c, device="cuda", dtype=bf)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, n, c // 64, 3 * c, c,
                scale, stream)
        same_launcher("attention_core", (b, n, c), args, [o],
                      [fab.attention_core_reference(q, k, v, scale)], 4 * b * n * n * c)
        del qkv, q, k, v, o

    # The flash backward at the training microbatch.
    b, n, h = FLASH_TRAIN
    c = h * 64
    q, k, v, do = ((1.5 * torch.randn(b, n, h, 64, generator=gen, device="cuda")).to(bf)
                   for _ in range(4))
    o, lse = fla.flash_forward(q, k, v, scale)
    refs = fla.flash_backward_reference(q, k, v, o, lse, do, scale)
    outs = [torch.empty_like(q) for _ in range(3)]
    delta = torch.empty(b, h, n, device="cuda")
    acc = torch.empty(b, h, n, 64, device="cuda")
    flops = flash_bound("flash_attention_bwd", b, n, h)[0]
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), acc.data_ptr(), *(t.data_ptr() for t in outs))
    args = ptrs + (b, n, n, h, c, c, c, c, c, c, scale, stream)
    same_launcher("flash_attention_bwd", FLASH_TRAIN, args, outs, refs, flops,
                  ([P] * 11 + [I] * 9 + [ctypes.c_float, P],
                   ptrs + (b, n, h, c, c, c, c, c, c, scale, stream)))
    for d, (csrc, names) in srcs.items():
        if not set(PAIR_KERNELS) <= set(names):
            continue
        dq_fn, dkv_fn = (build.launcher(nm, csrc, pair_sigs[nm]) for nm in PAIR_KERNELS)
        common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                  delta.data_ptr())

        def pair():
            for fn, outp in ((dq_fn, (outs[0].data_ptr(),)),
                             (dkv_fn, (outs[1].data_ptr(), outs[2].data_ptr()))):
                if fn(*common, *outp, b, n, h, c, c, c, c, c, scale, stream) != 0:
                    fail(f"baseline: the {d} flash backward pair failed to launch")

        def parent_call():
            # That tree's flash_backward on the device: the plain delta, dq, dk/dv.
            delta.copy_((do.float() * o.float()).sum(dim=-1).transpose(1, 2))
            pair()

        turns("flash_attention_bwd", FLASH_TRAIN, d,
              {"baseline": parent_call,
               "change": launch(build.launcher("flash_attention_bwd"), *args)},
              outs, refs, flops)
        log(f"baseline flash_attention_bwd {FLASH_TRAIN}: {d}'s dq + dk/dv kernels alone "
            f"(delta given) {cuda_time_ms(pair, 20):.4f} ms [{CARD}]")
    torch.cuda.empty_cache()
    return results


def phase_grad():
    """Part of the sublayer kernels' contract since they are differentiable:
    at the stage-3 training shape (8 images, N=1024, C=768) the gradients of
    x, the LN affines and every weight through the kernel path equal the
    plain path's (the backward is the plain version's VJP)."""
    import torch

    from deepl_project_tpu_torch.ops.hopper import fused_attention_block as fab

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    b, n, c, hh, ww = 8, 1024, 768, 32, 32

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    x = randn(b, n, c).to(torch.bfloat16)
    ln = tuple((1 + randn(c, scale=0.1), randn(c, scale=0.1)) for _ in range(3))
    wq, wk, wv, wp = (randn(c, c, scale=2 / c ** 0.5) for _ in range(4))
    bp = randn(c, scale=0.1)
    leaves = [x, *[t for pair in ln for t in pair], wq, wk, wv, wp, bp]
    for t in leaves:
        t.requires_grad_(True)
    for kind in ("fused_attention_sublayer", "ln_qkv_rope"):
        if kind == "ln_qkv_rope":
            wrt = leaves[:-2]
            kern = lambda: torch.cat(fab.ln_qkv_rope(x, ln, wq, wk, wv, hh, ww), -1)  # noqa: E731
            plain = lambda: torch.cat(fab.qkv_rope_reference(x, ln, wq, wk, wv, hh, ww), -1)  # noqa: E731
        else:
            wrt = leaves
            kern = lambda: fab.fused_attention_sublayer(x, ln, wq, wk, wv, wp, bp, hh, ww)  # noqa: E731
            plain = lambda: fab.sublayer_reference(x, ln, wq, wk, wv, wp, bp, hh, ww)  # noqa: E731
        out = kern()
        ct = randn(*out.shape)
        got = torch.autograd.grad((out.float() * ct).sum(), wrt)
        want = torch.autograd.grad((plain().float() * ct).sum(), wrt)
        worst = 0.0
        for gk, gp in zip(got, want):
            if not bool(torch.isfinite(gk).all()):
                fail(f"grad {kind}: non-finite gradient")
            err = (gk.float() - gp.float()).abs().max().item()
            top = gp.float().abs().max().item()
            if not err <= KERNEL_RTOL * top:
                fail(f"grad {kind}: max_abs_err {err:.3e} > {KERNEL_RTOL * top:.3e}")
            worst = max(worst, err / top)
        log(f"grad {kind} N={n} C={c} b={b}: {len(wrt)} gradients match the plain "
            f"path (worst rel err {worst:.3e}, bound {KERNEL_RTOL:.3e})")


def _synthetic(batch: int, seed: int = 0):
    """Synthetic 256px batches on the card, prefetched."""
    from deepl_project_tpu_torch.data import input_pipeline, make_dataset

    return input_pipeline(make_dataset("synthetic", resolution=256, num_samples=10 ** 6,
                                       seed=seed), batch, "cuda")


def _fit_timed(trainer, state, data):
    """Trainer.fit over ``data``: (state, step intervals in seconds after the
    first, peak GiB, flash launches, other kernels' launches but
    group_norm_silu's, fit seconds). The launch counters are set to 0 just
    before and read just after; the caller checks group_norm_silu's
    (check_norms) before the next reset."""
    import numpy as np
    import torch

    from deepl_project_tpu_torch.ops.hopper import flash_attention as fla
    from deepl_project_tpu_torch.ops.hopper import fused_attention_block as fab

    stamps = []

    def timed(it):
        for b in it:
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            yield b

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    state = trainer.fit(timed(data), state=state)
    fit_s = time.time() - t0
    counts = fla.launch_counts()
    other = {**fab.launch_counts(), **kernel_launches()[2]}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return state, np.diff(stamps)[1:], peak, counts, other, fit_s


def _profile(fn, name: str) -> None:
    """One call of ``fn`` under torch.profiler: its wall ms, the host and
    device time totals, and the table (chiprun_out/profile_<name>.txt)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof

    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = p.key_averages()
    ops = sum(e.count for e in events if e.key.startswith("aten::"))
    table = events.table(sort_by="cuda_time_total", row_limit=40)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"profile_{name}.txt"), "w") as f:
        f.write(f"{CARD}\n{table}\n")
    # The table's footer: host time of the ops and device time of the kernels.
    totals = [line for line in table.splitlines() if "time total" in line]
    log(f"profile {name}: wall {wall:.1f} ms (profiled), {'; '.join(totals)}, "
        f"{ops} aten calls [{CARD}]")


def _history(out_dir: str) -> list[dict]:
    """The train rows of a run's history.jsonl."""
    with open(os.path.join(out_dir, "history.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == "train"]


def phase_train(profile: bool, keep_checkpoint: bool = False):
    """Stage-1 training of large f16d32 at 256px through Trainer.fit. With
    ``keep_checkpoint`` its checkpoint directory is kept (phase gan resumes
    it) and returned, else deleted."""
    import shutil

    import numpy as np
    import torch

    from deepl_project_tpu_torch import get_config
    from deepl_project_tpu_torch.losses import LossWeights
    from deepl_project_tpu_torch.ops.attention import AttentionRoPE
    from deepl_project_tpu_torch.ops.hopper import flash_attention as fla
    from deepl_project_tpu_torch.training import Trainer, TrainerConfig
    from deepl_project_tpu_torch.training.train_step import compute_grads, global_norm

    out_dir = os.path.join(ROOT, "outputs", "chip_smoke_train")
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = get_config("large", 16, 32, norm_latents=True, attention_impl="auto_train")
    weights = LossWeights(l1=1.0, lpips=1.0, kl=1e-8, vf=0.0, gan=0.0)
    tc = TrainerConfig(batch_size=16, accum_steps=2, warmup_steps=2, num_epochs=1,
                       steps_per_epoch=TRAIN_STEPS, log_every=1, save_every_epochs=1,
                       output_dir=out_dir, weights=weights, seed=0)
    trainer = Trainer(cfg, tc, device="cuda")
    state = trainer.create_state()
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()
              if n in ("encoder.conv_in.weight", "decoder.conv_out.weight")}
    data = _synthetic(16)
    state, steps_s, peak, counts, other, fit_s = _fit_timed(trainer, state, data)
    if state.step != TRAIN_STEPS:
        fail(f"train: {state.step} steps taken, {TRAIN_STEPS} asked")
    want = {k: 12 * TRAIN_STEPS for k in ("flash_attention_fwd", "flash_attention_bwd")}
    if counts != want or other:
        fail(f"train: flash launches {counts} (want {want}), other kernels' launches {other}")
    check_norms(f"train: {TRAIN_STEPS} stage-1 steps (graph-building forwards)", {})
    log(f"train: {TRAIN_STEPS} steps launched {fla.launch_counts_by_shape()} "
        f"(12 forward + 12 backward per step), no sublayer kernel, small_attention "
        f"or group_norm_silu kernel")
    rows = _history(out_dir)
    losses = [r["total"] for r in rows]
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        fail(f"train: losses {losses}")
    moved = {n: (p - before[n]).abs().max().item() for n, p in state.model.named_parameters()
             if n in before}
    if not all(v > 0 for v in moved.values()):
        fail(f"train: params did not move {moved}")
    step_ms = float(np.median(steps_s)) * 1e3
    log(f"train: losses {[round(v, 5) for v in losses]}, grad_norm "
        f"{[round(r['grad_norm'], 4) for r in rows]}, param change {moved}")
    log(f"time train step large f16d32 @256 batch 16 (2 x 8), bf16: {step_ms:.1f} ms/step "
        f"(steps 2-{TRAIN_STEPS}: {[round(float(v) * 1e3, 1) for v in steps_s]}), "
        f"{16 / step_ms * 1e3:.2f} img/s, peak memory {peak:.2f} GiB, fit incl. "
        f"build and checkpoint {fit_s:.1f}s [{CARD}]")

    if profile:
        batch = torch.as_tensor(next(data)).to("cuda")

        def step():
            trainer.step_fn(state, batch)
            torch.cuda.synchronize()

        step()
        in_turns(lambda on: set_rewrites(state.model, on), step,
                 "train step batch 16 (2 x 8)", 2)
        _profile(step, "train_step")

    # The kernel path against the plain attention core on one batch: the
    # same weights and images, the mean decoded.
    del state.optimizer
    batch = torch.as_tensor(next(data)[:COMPARE_BATCH]).to("cuda")
    attn = [m for m in state.model.modules() if isinstance(m, AttentionRoPE)]
    res = {}
    for impl in ("auto_train", "xla"):
        for m in attn:
            m.impl = impl
        reset_launches()
        grads, metrics = compute_grads(state.model, batch, weights, trainer.lpips_params,
                                       sample=False)
        res[impl] = (metrics["total"].item(), global_norm(grads).item(),
                     fla.launch_counts().get("flash_attention_bwd", 0))
        check_norms(f"train compare, attention {impl}: compute_grads", {})
        del grads
    (lk, gk, nk), (lp, gp, npl) = res["auto_train"], res["xla"]
    log(f"train compare ({COMPARE_BATCH} images): loss kernel path {lk:.6f} plain core "
        f"{lp:.6f} (rel {abs(lk - lp) / abs(lp):.3e}, bound {TRAIN_LOSS_RTOL}); grad norm "
        f"{gk:.6f} / {gp:.6f} (rel {abs(gk - gp) / gp:.3e}, bound {TRAIN_GRAD_NORM_RTOL})")
    if nk != 6 or npl != 0:
        fail(f"train compare: flash backward launches {nk} / {npl}, want 6 / 0")
    if not (abs(lk - lp) <= TRAIN_LOSS_RTOL * abs(lp)
            and abs(gk - gp) <= TRAIN_GRAD_NORM_RTOL * gp):
        fail("train compare: the kernel path and the plain core disagree")
    del trainer, state, attn
    ckpt_dir = os.path.join(out_dir, "checkpoints") if keep_checkpoint else None
    if not keep_checkpoint:
        shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts, {"step_ms": step_ms, "peak_gib": peak, "rows": rows}, ckpt_dir


def phase_gan(stage1_ckpt: str, profile: bool):
    """Stage 2 of large f16d32 at 256px through Trainer.fit: the stage-1
    checkpoint of phase train resumed into a GAN trainer (README's recipe:
    frozen encoder, gan 0.05, R1 10, floor 0.6, EMA 0.999), batch 8."""
    import shutil

    import numpy as np
    import torch

    from deepl_project_tpu_torch import get_config
    from deepl_project_tpu_torch.losses import LossWeights
    from deepl_project_tpu_torch.ops.attention import AttentionRoPE
    from deepl_project_tpu_torch.ops.hopper import flash_attention as fla
    from deepl_project_tpu_torch.training import Trainer, TrainerConfig
    from deepl_project_tpu_torch.training.train_step import gan_generator_grads, global_norm

    out_dir = os.path.join(ROOT, "outputs", "chip_smoke_gan")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    # The stage hand-off: stage 2 resumes the stage-1 checkpoint from its
    # own output_dir (hard links: phase remat reads the stage-1 files too).
    shutil.copytree(stage1_ckpt, os.path.join(out_dir, "checkpoints"), copy_function=os.link)
    cfg = get_config("large", 16, 32, norm_latents=True, attention_impl="auto_train")
    weights = LossWeights(l1=1.0, lpips=1.0, kl=1e-8, vf=0.0, gan=0.05)
    tc = TrainerConfig(batch_size=GAN_BATCH, warmup_steps=2, num_epochs=1,
                       steps_per_epoch=GAN_STEPS, log_every=1, save_every_epochs=1,
                       output_dir=out_dir, weights=weights, seed=0, freeze_encoder=True,
                       ema_decay=0.999, gan_r1_gamma=10.0, gan_disc_loss_floor=0.6)
    t0 = time.time()
    trainer = Trainer(cfg, tc, device="cuda")
    state, _ = trainer.maybe_resume(trainer.create_state())
    resume_s = time.time() - t0
    opt = state.optimizer
    fresh = opt.count == 0 and all(not bool(m.any()) for m in opt.mu if m is not None)
    ema_restart = all(torch.equal(t, state.model.get_parameter(n)) for n, t in state.ema.items())
    if (state.step != TRAIN_STEPS or not fresh or not ema_restart
            or trainer._disc_state is not None):
        fail(f"gan hand-off: step {state.step} (want {TRAIN_STEPS}), optimizer count "
             f"{opt.count} with zero moments {fresh}, EMA from the restored params "
             f"{ema_restart}, discriminator {trainer._disc_state}")
    log(f"gan hand-off: resumed the stage-1 checkpoint at step {state.step} in "
        f"{resume_s:.1f}s; optimizer fresh (count 0, zero moments), EMA restarted from "
        f"the restored params, discriminator fresh")
    shutil.rmtree(os.path.join(out_dir, "checkpoints"))
    disc = trainer._ensure_disc_state()  # as the first step would make it
    disc_before = disc.model.conv0.weight.detach().clone()
    encoder = {n: (p.double().sum().item(), p.double().square().sum().item())
               for n, p in state.model.named_parameters() if n.startswith("encoder.")}
    # The decoder's last conv and its last attention block's query weight
    # (stage 2, the flash kernels' stage).
    watch = ("decoder.conv_out.weight",
             [n for n, _ in state.model.named_parameters()
              if n.startswith("decoder.") and n.endswith(".attn.to_q.weight")][-1])
    before = {n: state.model.get_parameter(n).detach().clone() for n in watch}
    data = _synthetic(GAN_BATCH, seed=3)
    state, steps_s, peak, counts, other, fit_s = _fit_timed(trainer, state, data)
    if state.step != TRAIN_STEPS + GAN_STEPS or disc.step != GAN_STEPS:
        fail(f"gan: generator step {state.step}, discriminator {disc.step}; want "
             f"{TRAIN_STEPS + GAN_STEPS} and {GAN_STEPS}")
    want = {k: v * GAN_STEPS for k, v in GAN_LAUNCHES_PER_STEP.items()}
    if counts != want or other:
        fail(f"gan: flash launches {counts} (want {want}), other kernels' launches {other}")
    # The generator's forward builds a graph (plain norms); the
    # discriminator update's fresh forward runs without grad: every site.
    check_norms(f"gan: {GAN_STEPS} steps (the discriminator update's no-grad forward, "
                f"b{GAN_BATCH})", norm_table(state.model, 256, GAN_STEPS))
    log(f"gan: {GAN_STEPS} steps launched {fla.launch_counts_by_shape()} (12 forward + 6 "
        f"backward per step), no sublayer kernel or small_attention")
    rows = _history(out_dir)
    keys = ("total", "disc_loss", "disc_r1", "grad_norm")
    if len(rows) != GAN_STEPS or not all(np.isfinite(r[k]) for r in rows for k in keys):
        fail(f"gan: metrics {[{k: r.get(k) for k in keys} for r in rows]}")
    moved = {n: (state.model.get_parameter(n) - before[n]).abs().max().item() for n in watch}
    moved["disc.conv0.weight"] = (disc.model.conv0.weight - disc_before).abs().max().item()
    enc_after = {n: (p.double().sum().item(), p.double().square().sum().item())
                 for n, p in state.model.named_parameters() if n.startswith("encoder.")}
    if not all(v > 0 for v in moved.values()) or enc_after != encoder:
        fail(f"gan: decoder and discriminator change {moved}, encoder unchanged "
             f"{enc_after == encoder}")
    saved = sorted(os.listdir(os.path.join(out_dir, "checkpoints")))
    step_ms = float(np.median(steps_s)) * 1e3
    log(f"gan: losses {[round(r['total'], 5) for r in rows]}, disc_loss "
        f"{[round(r['disc_loss'], 4) for r in rows]}, disc_r1 "
        f"{[round(r['disc_r1'], 4) for r in rows]}, grad_norm "
        f"{[round(r['grad_norm'], 4) for r in rows]}, disc_update_scale "
        f"{[r['disc_update_scale'] for r in rows]}; parameter change {moved}, "
        f"{len(encoder)} encoder tensors bit-equal, checkpoint {saved}")
    log(f"time gan step large f16d32 @256 batch {GAN_BATCH}, bf16, frozen encoder, R1: "
        f"{step_ms:.1f} ms/step (steps 2-{GAN_STEPS}: "
        f"{[round(float(v) * 1e3, 1) for v in steps_s]}), {GAN_BATCH / step_ms * 1e3:.2f} "
        f"img/s, peak memory {peak:.2f} GiB, fit incl. checkpoint {fit_s:.1f}s [{CARD}]")
    if peak >= 80e9 / 2 ** 30:
        fail(f"gan: peak memory {peak:.2f} GiB does not fit in 80 GB")

    batch = torch.as_tensor(next(data)).to("cuda")
    if profile:
        _profile(lambda: trainer.step_fn(state, batch), "gan_step")

    # The GAN step's generator loss and gradients on the kernel path
    # against the plain attention core: the same weights, discriminator and
    # images, the mean decoded.
    del state.optimizer, state.ema, disc.optimizer
    torch.cuda.empty_cache()
    batch = batch[:COMPARE_BATCH]
    attn = [m for m in state.model.modules() if isinstance(m, AttentionRoPE)]
    res = {}
    for impl in ("auto_train", "xla"):
        for m in attn:
            m.impl = impl
        reset_launches()
        grads, metrics = gan_generator_grads(state.model, disc.model, batch, weights,
                                             trainer.lpips_params, sample=False)
        res[impl] = (metrics["total"].item(), global_norm(grads).item(),
                     fla.launch_counts().get("flash_attention_bwd", 0))
        check_norms(f"gan compare, attention {impl}: gan_generator_grads", {})
        del grads
    (lk, gk, nk), (lp, gp, npl) = res["auto_train"], res["xla"]
    log(f"gan compare ({COMPARE_BATCH} images): generator loss kernel path {lk:.6f} plain "
        f"core {lp:.6f} (rel {abs(lk - lp) / abs(lp):.3e}, bound {TRAIN_LOSS_RTOL}); grad "
        f"norm {gk:.6f} / {gp:.6f} (rel {abs(gk - gp) / gp:.3e}, bound "
        f"{TRAIN_GRAD_NORM_RTOL})")
    if nk != 6 or npl != 0:
        fail(f"gan compare: flash backward launches {nk} / {npl}, want 6 / 0")
    if not (abs(lk - lp) <= TRAIN_LOSS_RTOL * abs(lp)
            and abs(gk - gp) <= TRAIN_GRAD_NORM_RTOL * gp):
        fail("gan compare: the kernel path and the plain core disagree")
    del trainer, state, disc, attn
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts, {"step_ms": step_ms, "peak_gib": peak}


def phase_recipe(profile: bool = False):
    """The repo's own stage-1 recipe: configs/transvae_large_f16d32.yaml read
    by the train CLI's load_yaml_config (large f16d32 @256, batch 8 in 4
    microbatches, L1 1 + LPIPS 1 on random VGG + KL 1e-8 + VF 0.1 through
    make_vf_teacher, the stub where DINOv2 is absent), AdamW, Trainer.fit
    for RECIPE_STEPS steps; the warmup cut to 2 so that the steps move."""
    import shutil

    import numpy as np
    import torch

    from deepl_project_tpu_torch import get_config
    from deepl_project_tpu_torch.cli.train import (CLI_REMAT_POLICY, build_parser,
                                                   load_yaml_config)
    from deepl_project_tpu_torch.losses import LossWeights, make_vf_teacher
    from deepl_project_tpu_torch.training import Trainer, TrainerConfig

    out_dir = os.path.join(ROOT, "outputs", "chip_smoke_recipe")
    shutil.rmtree(out_dir, ignore_errors=True)
    args = build_parser().parse_args(["--config", os.path.join(ROOT, RECIPE_YAML)])
    load_yaml_config(args.config, args)
    cfg = get_config(args.variant, args.compression_ratio, args.latent_dim,
                     remat=args.gradient_checkpointing, remat_policy=CLI_REMAT_POLICY,
                     norm_latents=args.norm_latents, attention_impl=args.attention_impl)
    weights = LossWeights(l1=args.l1_weight, lpips=args.lpips_weight, kl=args.kl_weight,
                          vf=args.vf_weight, gan=0.0)
    batch, accum = args.batch_size, args.accum_steps
    if (cfg.variant, batch, accum, weights.vf, cfg.remat) != ("large_f16d32", 8, 4, 0.1, False):
        fail(f"recipe: {RECIPE_YAML} read as {cfg.variant}, batch {batch} x accumulation "
             f"{accum}, vf {weights.vf}, remat {cfg.remat}")
    teacher = make_vf_teacher(args.dino_model, device="cuda")
    tc = TrainerConfig(batch_size=batch, accum_steps=accum, learning_rate=args.lr,
                       warmup_steps=2, num_epochs=1, steps_per_epoch=RECIPE_STEPS,
                       log_every=1, output_dir=out_dir, weights=weights, seed=0,
                       use_lpips=args.lpips_weight > 0)
    trainer = Trainer(cfg, tc, teacher_fn=teacher, device="cuda")
    state = trainer.create_state()
    kernel_before = state.vf_proj.kernel.detach().clone()
    log(f"recipe: {RECIPE_YAML}: {cfg.variant} @256, batch {batch} = {accum} x "
        f"{batch // accum}, {weights}, teacher feature_dim {teacher.feature_dim}, "
        f"vf_proj {tuple(state.vf_proj.kernel.shape)}")
    state, steps_s, peak, counts, other, fit_s = _fit_timed(trainer, state, _synthetic(batch))
    # Stage 2's 3 + 3 blocks in each of the step's microbatches.
    want = {k: 6 * accum * RECIPE_STEPS for k in ("flash_attention_fwd", "flash_attention_bwd")}
    if state.step != RECIPE_STEPS or counts != want or other:
        fail(f"recipe: {state.step} steps, flash launches {counts} (want {want}), other "
             f"kernels {other}")
    check_norms(f"recipe: {RECIPE_STEPS} steps (graph-building forwards)", {})
    rows = _history(out_dir)
    vf = [r["vf"] for r in rows]
    moved = (state.vf_proj.kernel.detach() - kernel_before).abs().max().item()
    if (len(rows) != RECIPE_STEPS or not np.isfinite([r["total"] for r in rows]).all()
            or not all(np.isfinite(v) and v > 0 for v in vf) or not moved > 0):
        fail(f"recipe: losses {[r['total'] for r in rows]}, vf {vf}, vf_proj change {moved}")
    step_ms = float(np.median(steps_s)) * 1e3
    log(f"recipe: losses {[round(r['total'], 5) for r in rows]}, vf {[round(v, 6) for v in vf]}, "
        f"grad_norm {[round(r['grad_norm'], 4) for r in rows]}, vf_proj change {moved:.3e}; "
        f"flash launches per step {accum * 6} forward + {accum * 6} backward at "
        f"(B, N, h)=({batch // accum}, 4096, 6), no other kernel")
    log(f"time recipe step large f16d32 @256 batch {batch} ({accum} x {batch // accum}), "
        f"L1 + LPIPS + KL + VF, AdamW: {step_ms:.1f} ms/step (steps 2-{RECIPE_STEPS}: "
        f"{[round(float(v) * 1e3, 1) for v in steps_s]}), {batch / step_ms * 1e3:.2f} img/s, "
        f"peak memory {peak:.2f} GiB, fit incl. checkpoint {fit_s:.1f}s [{CARD}]")
    if profile:
        from deepl_project_tpu_torch.data import make_dataset

        batch_t = torch.as_tensor(np.stack(list(make_dataset(
            "synthetic", resolution=256, num_samples=batch, seed=9)))).to("cuda")
        _profile(lambda: trainer.step_fn(state, batch_t), "recipe_step")
    del trainer, state
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts, {"step_ms": step_ms, "peak_gib": peak}


def phase_remat(stage1_ckpt: str, profile: bool = False):
    """Gradient checkpointing of large f16d32 @256: one compute_grads of a
    batch of 8 under each of REMAT_CASES (time, peak memory, flash launches,
    loss and grad norm against no remat); Trainer.fit with remat 'dots' and
    Adafactor at batch 16 in one microbatch; one step with perceptual='self'
    on phase train's stage-1 checkpoint."""
    import shutil

    import numpy as np
    import torch

    from deepl_project_tpu_torch import get_config
    from deepl_project_tpu_torch.data import make_dataset
    from deepl_project_tpu_torch.losses import LossWeights, get_lpips_params
    from deepl_project_tpu_torch.models import TransVAE, enable_gradient_checkpointing
    from deepl_project_tpu_torch.models import init_weights
    from deepl_project_tpu_torch.ops.hopper import flash_attention as fla
    from deepl_project_tpu_torch.training import Trainer, TrainerConfig
    from deepl_project_tpu_torch.training.train_step import (compute_grads, global_norm,
                                                             step_generator)

    cfg = get_config("large", 16, 32, norm_latents=True, attention_impl="auto_train")
    weights = LossWeights(l1=1.0, lpips=1.0, kl=1e-8, vf=0.0, gan=0.0)
    with torch.device("meta"):
        model = TransVAE(cfg)
    model = model.to_empty(device="cuda")
    init_weights(model, torch.Generator(device="cuda").manual_seed(0))
    lpips = get_lpips_params(device="cuda", generator=torch.Generator(device="cuda").manual_seed(7))
    images = np.stack(list(make_dataset("synthetic", resolution=256, num_samples=REMAT_BATCH,
                                        seed=5)))
    batch = torch.as_tensor(images).to("cuda")

    def grads_of(m):
        g, metrics = compute_grads(m, batch, weights, lpips,
                                   generator=step_generator(0, 0, "cuda"))
        norm = global_norm(g).item()
        del g
        return metrics["total"].item(), norm

    rows = {}
    for name, policy, resample in REMAT_CASES:
        m = model
        if policy is not None:
            m = enable_gradient_checkpointing(model, policy)
            if resample:
                with torch.device("meta"):
                    m = TransVAE(m.config.replace(remat_resample=True))
                m.load_state_dict(model.state_dict(keep_vars=True), assign=True)
        reset_launches()
        loss, gnorm = grads_of(m)
        launches = fla.launch_counts()
        check_norms(f"remat {name}: compute_grads", {})
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            grads_of(m)  # ends in a host read of the grad norm
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rows[name] = dict(ms=float(np.median(times)), peak_gib=peak, loss=loss,
                          grad_norm=gnorm, launches=launches)
        if profile and name in ("no remat", "none", "dots"):
            _profile(lambda: grads_of(m), f"remat_{name.replace(' ', '_')}")
        log(f"remat {name}: compute_grads batch {REMAT_BATCH} @256 {np.median(times):.1f} ms "
            f"({[round(t, 1) for t in times]}), peak {peak:.2f} GiB, flash launches "
            f"{launches}, loss {loss:.6f}, grad norm {gnorm:.6f} [{CARD}]")
        del m
    base = rows["no remat"]
    for name, r in rows.items():
        fwd = 6 if name == "no remat" else 12
        want = {"flash_attention_fwd": fwd, "flash_attention_bwd": 6}
        rel = (abs(r["loss"] - base["loss"]) / abs(base["loss"]),
               abs(r["grad_norm"] - base["grad_norm"]) / base["grad_norm"])
        log(f"remat {name}: {r['ms'] / base['ms']:.3f}x the time and "
            f"{r['peak_gib'] / base['peak_gib']:.3f}x the peak of no remat; loss rel "
            f"{rel[0]:.2e}, grad norm rel {rel[1]:.2e} (bound {REMAT_RTOL})")
        if r["launches"] != want or max(rel) > REMAT_RTOL:
            fail(f"remat {name}: flash launches {r['launches']} (want {want}), loss and grad "
                 f"norm relative to no remat {rel}")
    del model, batch
    torch.cuda.empty_cache()

    out_dir = os.path.join(ROOT, "outputs", "chip_smoke_remat")
    shutil.rmtree(out_dir, ignore_errors=True)
    rcfg = cfg.replace(remat=True, remat_policy="dots")
    tc = TrainerConfig(batch_size=REMAT_FIT_BATCH, warmup_steps=2, num_epochs=1,
                       steps_per_epoch=REMAT_FIT_STEPS, log_every=1, output_dir=out_dir,
                       weights=weights, seed=0, optimizer="adafactor")
    trainer = Trainer(rcfg, tc, device="cuda")
    state, steps_s, peak, counts, other, fit_s = _fit_timed(trainer, None,
                                                            _synthetic(REMAT_FIT_BATCH))
    want = {"flash_attention_fwd": 12 * REMAT_FIT_STEPS,
            "flash_attention_bwd": 6 * REMAT_FIT_STEPS}
    rows_fit = _history(out_dir)
    if (state.step != REMAT_FIT_STEPS or counts != want or other
            or not np.isfinite([r["total"] for r in rows_fit]).all()
            or peak >= 80e9 / 2 ** 30 or state.optimizer.kind != "adafactor"):
        fail(f"remat fit: {state.step} steps, flash launches {counts} (want {want}), other "
             f"{other}, losses {[r['total'] for r in rows_fit]}, peak {peak:.2f} GiB")
    check_norms(f"remat fit: {REMAT_FIT_STEPS} steps (graph-building forwards)", {})
    step_ms = float(np.median(steps_s)) * 1e3
    log(f"remat fit: losses {[round(r['total'], 5) for r in rows_fit]}, grad_norm "
        f"{[round(r['grad_norm'], 4) for r in rows_fit]}; 12 flash forward (6 + 6 "
        f"recomputed) + 6 backward per step, no other kernel")
    log(f"time remat-dots + Adafactor step large f16d32 @256 batch {REMAT_FIT_BATCH} (one "
        f"microbatch): {step_ms:.1f} ms/step (steps 2-{REMAT_FIT_STEPS}: "
        f"{[round(float(v) * 1e3, 1) for v in steps_s]}), "
        f"{REMAT_FIT_BATCH / step_ms * 1e3:.2f} img/s, peak memory {peak:.2f} GiB, fit incl. "
        f"checkpoint {fit_s:.1f}s [{CARD}]")
    fit = {"step_ms": step_ms, "peak_gib": peak}
    del trainer, state
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # perceptual='self': phase train's checkpoint as the frozen feature net
    # (its saved config: attention_impl 'auto', so the inference kernels).
    sp_weights = LossWeights(l1=1.0, lpips=1.0, kl=1e-8, vf=0.0, gan=0.0)
    tc = TrainerConfig(batch_size=REMAT_BATCH, warmup_steps=2, output_dir=out_dir,
                       weights=sp_weights, seed=0, optimizer="adafactor", perceptual="self",
                       perceptual_checkpoint=stage1_ckpt)
    t0 = time.time()
    trainer = Trainer(rcfg, tc, device="cuda")
    load_s = time.time() - t0
    state = trainer.create_state()
    batch = torch.as_tensor(images).to("cuda")
    trainer.step_fn(state, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    metrics = trainer.step_fn(state, batch)
    lpips_term = metrics["lpips"].item()
    sp_ms = (time.perf_counter() - t0) * 1e3
    sp_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    sp_counts = {**fla.launch_counts(), **kernel_launches()[0]}
    sub = {}
    for (name, _, _), n in kernel_launches()[0].items():
        sub[name] = sub.get(name, 0) + n
    # The model (remat dots): 6 + 6 forward, 6 backward; the frozen encoder
    # (3 + 4 + 6 blocks at stages 2-4) on the target, on the reconstruction
    # and again in that checkpoint's recompute: 3 flash forwards and 3 + 4 +
    # 6 ln_qkv_rope, 4 + 6 attention_core and proj_bias_gemm each time; the
    # reconstruction's backward: 3 flash backwards.
    want = {"flash_attention_fwd": 12 + 3 * 3, "flash_attention_bwd": 6 + 3}
    want_sub = {"ln_qkv_rope": 3 * 13, "attention_core": 3 * 10, "proj_bias_gemm": 3 * 10}
    # group_norm_silu: the frozen encoder's target pass only (no grad); the
    # reconstruction's pass and its recompute build a graph.
    check_norms("self-perceptual step (the frozen encoder's no-grad target pass, "
                f"b{REMAT_BATCH})", norm_table(state.model, 256, 1, parts=("encoder",)))
    if (fla.launch_counts() != want or sub != want_sub
            or not (np.isfinite(lpips_term) and lpips_term > 0)):
        fail(f"remat self-perceptual: flash launches {fla.launch_counts()} (want {want}), "
             f"sublayer kernels {sub} (want {want_sub}), lpips slot {lpips_term}")
    log(f"remat self-perceptual step (remat dots + Adafactor, batch {REMAT_BATCH}, the frozen "
        f"encoder of {stage1_ckpt}, loaded in {load_s:.1f}s): {sp_ms:.1f} ms, peak "
        f"{sp_peak:.2f} GiB, self-perceptual term {lpips_term:.6f}, launches {sp_counts} "
        f"[{CARD}]")
    del trainer, state, batch
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    counts = {k: counts.get(k, 0) + fla.launch_counts().get(k, 0) for k in counts}
    return counts, {"rows": rows, "fit": fit, "self_perceptual_ms": sp_ms,
                    "self_perceptual_peak_gib": sp_peak}


# -- phase data ----------------------------------------------------------
def _write_image_folder(root: str) -> dict:
    """DATA_IMAGES PNGs (utils.image.save_image: zlib, no PIL) of shapes
    content under ``root``: DATA_CLASSES class directories and a few loose
    images, in DATA_SIZES (H, W), so that the resize and the crop both
    run. Returns {'files': n, 'bytes': total}."""
    import numpy as np

    from deepl_project_tpu_torch.data import make_dataset
    from deepl_project_tpu_torch.utils.image import save_image

    per_class = (DATA_IMAGES - DATA_LOOSE) // DATA_CLASSES
    dirs = [f"class_{c}" for c in range(DATA_CLASSES) for _ in range(per_class)]
    dirs += [""] * DATA_LOOSE
    side = max(max(s) for s in DATA_SIZES)
    src = make_dataset("shapes", resolution=side, num_samples=len(dirs), seed=11)
    total = 0
    for i, (sub, img) in enumerate(zip(dirs, src)):
        h, w = DATA_SIZES[i % len(DATA_SIZES)]
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        path = os.path.join(root, sub, f"img_{i:03d}.png")
        save_image((img[:h, :w] * 255).round().astype(np.uint8), path)
        total += os.path.getsize(path)
    return {"files": len(dirs), "bytes": total}


def phase_data():
    """Training and evaluation of large f16d32 on a folder of images (the
    data slice's user path): the decoder probe, the folder written and its
    decode timed, cli.train on it (5 steps, one validation pass), its steps
    in turns with synthetic ones, a step under profiler_trace, InceptionV3
    on the card against its fp32 CPU path, cli.evaluate --rfid over the
    folder, the latent diagnostics and linear probe, from_pretrained
    against model_from_checkpoint, and cli.smoke_test."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from deepl_project_tpu_torch import from_pretrained, get_config
    from deepl_project_tpu_torch.cli import evaluate as evaluate_cli
    from deepl_project_tpu_torch.cli import train as train_cli
    from deepl_project_tpu_torch.data import (image_folder_dataset, input_pipeline,
                                              make_dataset, native_loader)
    from deepl_project_tpu_torch.data.transforms import pil_available
    from deepl_project_tpu_torch.evaluation import model_from_checkpoint, reconstruct
    from deepl_project_tpu_torch.models import TransVAE
    from deepl_project_tpu_torch.ops.hopper import flash_attention as fla
    from deepl_project_tpu_torch.utils import inception as inc
    from deepl_project_tpu_torch.utils import latent_metrics as lm
    from deepl_project_tpu_torch.utils.logging import profiler_trace

    out_dir = os.path.join(ROOT, "outputs", "chip_smoke_data")
    shutil.rmtree(out_dir, ignore_errors=True)
    folder = os.path.join(out_dir, "images")
    run_dir = os.path.join(out_dir, "run")
    ckpt = os.path.join(run_dir, "checkpoints")
    workers = min(os.cpu_count() or 1, 16)
    with torch.device("meta"):
        meta = TransVAE(get_config("large", 16, 32, norm_latents=True))

    # 1. The decoders: the only branch of this phase.
    native, pil = native_loader.native_available(), pil_available()
    decoder = "native" if native else "PIL" if pil else None
    why = "" if native else " (its build: {})".format(
        " | ".join((native_loader.build_error() or "").splitlines()[:3]))
    log(f"data: decoders: native {'built and loaded' if native else 'unavailable'}{why}; "
        f"PIL {'imports' if pil else 'absent'}; the folder decodes with "
        f"{decoder or 'nothing: training and evaluation read --data shapes instead'}")

    # 2. The folder, and its decode at the CLI's thread count.
    written = _write_image_folder(folder)
    data = folder if decoder else "shapes"
    if decoder:
        t = time.perf_counter()
        n = sum(1 for _ in image_folder_dataset(folder, 256, num_workers=workers))
        dt = time.perf_counter() - t
        if n != written["files"]:
            fail(f"data: decoded {n} of {written['files']} images")
        log(f"data: {written['files']} PNGs ({written['bytes'] / 2 ** 20:.2f} MiB, sizes "
            f"{DATA_SIZES}) decoded to 256px with {decoder} on {workers} threads in "
            f"{dt:.3f}s: {n / dt:.1f} img/s")

    # 3. cli.train on the folder: 5 steps of 16 = 2 x 8, one validation pass
    # of one batch at step 5; its steps stamped at each batch.
    made = {}
    stamps = []

    class Recording(train_cli.Trainer):
        def fit(self, data_iter, state=None, val_batches=None):
            made["trainer"] = self
            made["state"] = super().fit(data_iter, state, val_batches)
            return made["state"]

    def stamped(source, batch_size, device, **kw):
        for b in input_pipeline(source, batch_size, device, **kw):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            yield b

    argv = ["--variant", "large", "--data", data, "--batch_size", "16", "--accum_steps", "2",
            "--num_epochs", "1", "--steps_per_epoch", str(TRAIN_STEPS), "--log_every", "1",
            "--warmup_steps", "2", "--eval_every_steps", str(TRAIN_STEPS),
            "--val_batches", "1", "--no_keep_best", "--output_dir", run_dir]
    real = train_cli.Trainer, train_cli.input_pipeline
    train_cli.Trainer, train_cli.input_pipeline = Recording, stamped
    reset_launches()
    t = time.time()
    try:
        train_cli.main(argv)
    finally:
        train_cli.Trainer, train_cli.input_pipeline = real
    fit_s = time.time() - t
    trainer, state = made["trainer"], made["state"]
    counts = fla.launch_counts()
    want = {("flash_attention_fwd", 4096, 6): 12 * TRAIN_STEPS + 6,
            ("flash_attention_bwd", 4096, 6): 12 * TRAIN_STEPS}
    got = kernel_launches()
    if state.step != TRAIN_STEPS or got[1] != want or got[0] or got[2]:
        fail(f"data: cli.train took {state.step} steps; launched {got}, want flash {want} "
             f"and no sublayer or small_attention kernel")
    check_norms("data: cli.train on the folder, its validation pass (1 batch of 16)",
                norm_table(meta, 256))
    rows = [json.loads(r) for r in open(os.path.join(run_dir, "history.jsonl"))]
    train_rows = [r for r in rows if r["kind"] == "train"]
    val_rows = [r for r in rows if r["kind"] == "val"]
    if (len(train_rows) != TRAIN_STEPS or len(val_rows) != 1
            or not np.isfinite([r["total"] for r in train_rows] + [val_rows[0]["val_psnr"]]).all()):
        fail(f"data: history.jsonl rows {rows}")
    try:
        import tensorboardX  # noqa: F401
        has_tbx = True
    except ImportError:
        has_tbx = False
    tb = os.path.join(run_dir, "tb")
    tb_files = os.listdir(tb) if os.path.isdir(tb) else []
    if has_tbx != bool(tb_files):
        fail(f"data: tensorboardX {'installed' if has_tbx else 'absent'}, tb/ holds {tb_files}")
    steps_ms = np.diff(stamps)[1:] * 1e3
    log(f"data: cli.train --data <folder> large f16d32 @256 batch 16 (2 x 8): losses "
        f"{[round(r['total'], 5) for r in train_rows]}, val_psnr "
        f"{val_rows[0]['val_psnr']:.3f} dB; flash launches {got[1]} (12 + 12 a step, 6 "
        f"forward in the validation pass); tb/ {tb_files or 'not written (no tensorboardX)'}; "
        f"batch intervals after the first {[round(float(v), 1) for v in steps_ms]} ms, fit incl. "
        f"build and checkpoint {fit_s:.1f}s [{CARD}]")

    # The same step fed by the folder pipeline and by the synthetic one, in
    # turns (folder, synthetic, synthetic, folder), DATA_TURN_STEPS a turn.
    feeds = {"folder": input_pipeline(make_dataset(data, resolution=256,
                                                   **train_cli.source_kwargs(data, -1)),
                                      16, "cuda"),
             "synthetic": _synthetic(16)}
    turns = {"folder": [], "synthetic": []}
    for name in ("folder", "synthetic", "synthetic", "folder"):
        marks = []
        for _ in range(DATA_TURN_STEPS + 1):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            trainer.step_fn(state, next(feeds[name]))
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        turns[name] += [round(float(v) * 1e3, 1) for v in np.diff(marks)[1:]]
    folder_ms, synth_ms = (float(np.median(turns[k])) for k in ("folder", "synthetic"))
    log(f"time train step batch 16 (2 x 8) fed by the folder ({decoder or 'shapes'}) / by "
        f"synthetic batches, in turns (folder, synthetic, synthetic, folder; "
        f"{DATA_TURN_STEPS} a turn): folder {turns['folder']} ms, synthetic "
        f"{turns['synthetic']} ms; medians {folder_ms:.1f} / {synth_ms:.1f} ms "
        f"({folder_ms / synth_ms:.4f}x) [{CARD}]")
    smoke = fid = None
    try:
        batch = next(feeds["folder"])
        trace_dir = os.path.join(out_dir, "trace")
        with profiler_trace(trace_dir):
            trainer.step_fn(state, batch)
            torch.cuda.synchronize()
        traces = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
        if len(traces) != 1 or os.path.getsize(os.path.join(trace_dir, traces[0])) == 0:
            fail(f"data: profiler_trace wrote {os.listdir(trace_dir)}")
        log(f"data: profiler_trace of one step wrote {traces[0]} "
            f"({os.path.getsize(os.path.join(trace_dir, traces[0])) / 2 ** 20:.1f} MiB)")
        made.clear()
        del feeds, trainer, state, batch
        train_counts = {k: counts.get(k, 0)
                        for k in ("flash_attention_fwd", "flash_attention_bwd")}
        torch.cuda.empty_cache()

        # InceptionV3 on the card: seeded random params, b32 at 256px (resized
        # to 299 inside), against its fp32 CPU path on the first images.
        model = model_from_checkpoint(ckpt, "cuda")
        items = list(image_folder_dataset(folder, 256, shuffle=False, with_labels=True)
                     if decoder else make_dataset("shapes", 256, with_labels=True,
                                                  num_samples=written["files"]))
        images = np.stack([x for x, _ in items])
        x = torch.from_numpy(images[:INCEPTION_BATCH]).permute(0, 3, 1, 2).to("cuda")
        params = inc.init_inception_params(device="cuda")
        feats = inc.inception_features(params, x)
        cpu_params = {k: v.cpu() for k, v in params.items()}
        plain = inc.inception_features(cpu_params, x[:INCEPTION_CHECKED].cpu())
        err = (feats[:INCEPTION_CHECKED].cpu() - plain).abs().max().item()
        scale = plain.abs().max().item()
        ms = cuda_time_ms(lambda: inc.inception_features(params, x), 10)
        # cli.smoke_test, a process of its own on the tiny model, runs beside
        # the rest of the phase (after the last timed call); read at the end.
        smoke = Beside([sys.executable, "-m", "deepl_project_tpu_torch.cli.smoke_test"],
                       os.path.join(out_dir, "smoke_test.log"))
        from torch.utils.flop_counter import FlopCounterMode

        with FlopCounterMode(display=False) as fc:
            inc.inception_features(params, x[:1])
        flops = fc.get_total_flops() * INCEPTION_BATCH
        nbytes = 4 * (x.numel() + sum(p.numel() for p in params.values()) + feats.numel())
        bound_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
        log(f"data: InceptionV3 (fp32, TF32 off) b{INCEPTION_BATCH} 256 -> 299px: {ms:.3f} "
            f"ms, "
            f"{INCEPTION_BATCH / ms * 1e3:.1f} img/s, {flops / INCEPTION_BATCH / 1e9:.3f} GFLOP "
            f"an image, bound {bound_ms:.3f} ms ({bound_ms / ms:.1%}); first "
            f"{INCEPTION_CHECKED} images vs the fp32 CPU path max abs {err:.3e} (max |f| "
            f"{scale:.3e}, rel {err / scale:.3e}, bound {INCEPTION_RTOL}) [{CARD}]")
        if not (torch.isfinite(feats).all() and err <= INCEPTION_RTOL * scale):
            fail("data: InceptionV3 on the card disagrees with its fp32 CPU path")
        recon = torch.from_numpy(reconstruct(model, None, images[:INCEPTION_BATCH]))
        recon = recon.permute(0, 3, 1, 2)
        real_f = feats.double().cpu().numpy()
        fake_f = inc.inception_features(params, recon.to("cuda")).double().cpu().numpy()
        del params, cpu_params, feats, x, recon
        # The rFIDs' scipy sqrtm (host only) in a process of its own, its BLAS
        # on FID_BLAS_THREADS threads (more spin on the cores that section 4
        # and the smoke test need), beside section 4 and sections 5 and 6.
        feats_path = os.path.join(out_dir, "fid_features.npz")
        np.savez(feats_path, real=real_f, fake=fake_f)
        blas = {k: str(FID_BLAS_THREADS)
                for k in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS", "MKL_NUM_THREADS")}
        fid = Beside([sys.executable, "-c", FID_JOB, feats_path],
                     os.path.join(out_dir, "fid.log"), env=blas)
        # 4. cli.evaluate over the folder with --rfid (vgg_rfid without the
        # Inception weights): 2 batches of 16 through the inference kernels.
        reset_launches()
        t = time.time()
        metrics = evaluate_cli.main(["--checkpoint", ckpt, "--data", data, "--rfid",
                                     "--batch_size", "16", "--num_batches", "2",
                                     "--save_grids", "1",
                                     "--output_dir", os.path.join(out_dir, "eval")])
        eval_s = time.time() - t
        want = launches_per_reconstruct(256, forwards=2, model=meta)
        if kernel_launches() != want:
            fail(f"data: cli.evaluate launched {kernel_launches()}, want {want}")
        NORM_PATHS["data: cli.evaluate, 2 batches of 16"] = kernel_launches()[3]
        key = "rfid" if inc.inception_params_available() else "vgg_rfid"
        flat = [metrics[k][s] for k in ("psnr", "ssim", "lpips") for s in ("mean", "min", "max")]
        if (metrics["num_images"] != 32
                or not np.isfinite(flat + [metrics.get(key, np.nan)]).all()):
            fail(f"data: cli.evaluate gave {metrics}")
        log(f"data: cli.evaluate --data <folder> --rfid (32 images): psnr "
            f"{metrics['psnr']['mean']:.4f} dB, ssim {metrics['ssim']['mean']:.5f}, lpips "
            f"{metrics['lpips']['mean']:.5f}, {key} {metrics[key]:.4f}; launches as "
            f"launches_per_reconstruct(256) x 2; {eval_s:.1f}s incl. the checkpoint load "
            f"[{CARD}]")
        _data_tail(model, images, items, decoder, ckpt, out_dir, lm, from_pretrained,
                   reconstruct)
        smoke_rc, smoke_out = smoke.wait(timeout=600)
        fid_rc, fid_out = fid.wait(timeout=600)
    finally:
        for run in (smoke, fid):
            if run is not None:
                run.stop()
    rows = [ln for ln in fid_out.splitlines() if ln.startswith("{")]
    if fid_rc != 0 or not rows:
        fail(f"data: rFID failed:\n{fid_out[-3000:]}")
    fid = json.loads(rows[-1])
    same, rfid = fid["same"], fid["rfid"]
    log(f"data: InceptionV3 rFID (random params) originals vs originals {same:.3e}, vs the "
        f"reconstructions {rfid:.4f} ({INCEPTION_BATCH} images; {fid['s']:.1f}s of scipy "
        f"sqrtm on the host in a process on {FID_BLAS_THREADS} BLAS threads, beside sections "
        f"4, 5 and 6)")
    if not (abs(same) < 1e-3 and np.isfinite(rfid) and rfid > 0):
        fail(f"data: rFID {same} / {rfid}")
    if smoke_rc != 0:
        fail(f"data: cli.smoke_test exited {smoke_rc}:\n{smoke_out}")
    last = [ln for ln in smoke_out.splitlines() if "checks passed" in ln]
    log(f"data: cli.smoke_test on the card: {last[-1] if last else smoke_out[-300:]} in "
        f"{smoke.s:.1f}s (beside the rFID's sqrtm and sections 4, 5 and 6)")
    shutil.rmtree(out_dir, ignore_errors=True)
    return train_counts, {"decoder": decoder, "step_ms_in_turns": turns,
                          "inception_ms": ms, "inception_bound_ms": bound_ms}


def _data_tail(model, images, items, decoder, ckpt, out_dir, lm, from_pretrained,
               reconstruct) -> None:
    """Phase data's sections 5 and 6: the latent diagnostics and linear
    probe, and from_pretrained against model_from_checkpoint's model."""
    import tempfile

    import numpy as np
    import torch

    # 5. Latent diagnostics and the linear probe on the class labels (numbers
    # of random-init weights trained 5 steps: they mean nothing yet).
    labels = np.array([y for _, y in items]) if decoder else np.arange(len(items)) % 4
    latents = lm.pool_latents(model, None, (images[i:i + 16] for i in range(0, len(images), 16)))
    keep = labels >= 0
    diag = lm.latent_diagnostics(latents)
    probe = lm.linear_probe(latents[keep], labels[keep], DATA_CLASSES, device="cuda")
    if latents.shape != (len(images), 32) or not np.isfinite(list(diag.values())
                                                             + list(probe.values())).all():
        fail(f"data: latents {latents.shape}, diagnostics {diag}, probe {probe}")
    log(f"data: pool_latents {latents.shape}; latent_diagnostics {diag}; linear_probe on "
        f"{int(keep.sum())} labelled images, {DATA_CLASSES} classes: {probe}")

    # 6. from_pretrained through DEEPL_PRETRAINED_DIR, bit-equal to the
    # checkpoint's model.
    registry = tempfile.mkdtemp(dir=out_dir)
    os.symlink(ckpt, os.path.join(registry, "transvae-large-f16d32"))
    old = os.environ.get("DEEPL_PRETRAINED_DIR")
    os.environ["DEEPL_PRETRAINED_DIR"] = registry
    try:
        named = from_pretrained("transvae-large-f16d32", norm_latents=True)
    finally:
        if old is None:
            del os.environ["DEEPL_PRETRAINED_DIR"]
        else:
            os.environ["DEEPL_PRETRAINED_DIR"] = old
    a = reconstruct(named, None, images[:8])
    b = reconstruct(model, None, images[:8])
    if not np.array_equal(a, b):
        fail(f"data: from_pretrained's reconstruct differs from the checkpoint's "
             f"(max abs {np.abs(a - b).max():.3e})")
    log("data: from_pretrained('transvae-large-f16d32') via DEEPL_PRETRAINED_DIR: "
        "reconstruct of 8 images bit-equal to model_from_checkpoint's")
    del named
    torch.cuda.empty_cache()


def flash_by_shape() -> dict:
    """The flash kernels' launches since the last reset by "name N heads"."""
    from deepl_project_tpu_torch.ops.hopper import flash_attention as fla

    return {f"{k} {n} {h}": c for (k, n, h), c in fla.launch_counts_by_shape().items()}


def launches_by_name() -> dict:
    """Every kernel's launches by name since the last reset."""
    from deepl_project_tpu_torch.ops.hopper import flash_attention as fla
    from deepl_project_tpu_torch.ops.hopper import fused_attention_block as fab
    from deepl_project_tpu_torch.ops.hopper import fused_norm as fnorm
    from deepl_project_tpu_torch.ops.hopper import small_attention as sma

    return {k: v for mod in (fab, fla, sma, fnorm) for k, v in mod.launch_counts().items()}


def tokenizer_launches(model, forwards: dict) -> tuple[dict, dict, dict, dict]:
    """Launches of the tokenizer's no-grad bf16 halves at 256px, ``forwards``
    = {'encoder': n, 'decoder': m} passes, in kernel_launches' order: half
    of launches_per_reconstruct(256)'s attention tables a pass (the encoder
    and the decoder hold the same blocks at each stage) and norm_table of
    that half."""
    out: tuple = ({}, {}, {}, {})
    for part, n in forwards.items():
        if not n:
            continue
        halves = [{k: v // 2 * n for k, v in d.items()}
                  for d in launches_per_reconstruct(256)[:3]]
        for d, more in zip(out, halves + [norm_table(model, 256, n, parts=(part,))]):
            for k, v in more.items():
                d[k] = d.get(k, 0) + v
    return out


def _dit_twin(model, **changes):
    """A DiT of ``model``'s config with ``changes`` on the same parameter
    tensors (another dtype or attention core, no copy)."""
    import torch

    from deepl_project_tpu_torch.models import DiT

    with torch.device("meta"):
        twin = DiT(model.config.replace(**changes))
    twin.load_state_dict(model.state_dict(keep_vars=True), strict=True, assign=True)
    return twin.train(model.training)


def _dit_random(cfg, seed: int):
    """A DiT on the card with every parameter random: the JAX initializers,
    then N(0, 0.02^2) in the zero-initialised adaLN and head layers, so
    that every block shapes the output (a trained-like model)."""
    import torch

    from deepl_project_tpu_torch.models import create_dit

    model = create_dit(cfg, device="cuda", seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not p.any():
                p.normal_(0.0, 0.02, generator=gen)
    return model


def dit_step_flops(model, batch: int, tokens: int) -> float:
    """Forward + backward FLOPs of one DiT training step: 6 per parameter
    applied to each token (patch embedding, qkv, proj, FFN, head), 6 per
    parameter applied once an image (the timestep MLP and the adaLN
    layers; the label table is a lookup), and the attention products (3 x
    4 B N^2 D a block)."""
    d = model.config.hidden_dim
    per_image = {"t_embed", "adaln", "adaln_out"}
    n_img = sum(p.numel() for n, p in model.named_parameters()
                if per_image & set(n.split(".")))
    n_tok = sum(p.numel() for n, p in model.named_parameters()
                if not per_image & set(n.split(".")) and not n.startswith("y_embed"))
    attn = 3 * 4 * batch * tokens ** 2 * d * model.config.depth
    return 6 * (n_tok * batch * tokens + n_img * batch) + attn


def phase_dit(profile: bool = False):
    """The latent-DiT slice on the card: cli.train_dit (DiT-B/2 on the
    random large f16d32 tokenizer's latents of a labelled folder, b64, with
    its FID, sample grid and checkpoints) and cli.sample_dit (16 samples,
    CFG 4) with their launches against the tokenizer's tables; a DiT-B/2
    forward and loss in bf16 against fp32 on the same weights; DiT-B/1's
    small_attention path; times of the b64 encode, the b64 DiT step on ready
    latents, the CLI's img/s, a CFG Euler step at b16 and the b16 decode.
    With ``profile``, torch.profiler tables of a b64 encode, a DiT step and
    a CFG Euler step."""
    import shutil

    import numpy as np
    import torch

    from deepl_project_tpu_torch import get_config
    from deepl_project_tpu_torch.cli import sample_dit as sample_cli
    from deepl_project_tpu_torch.cli import train_dit as train_cli
    from deepl_project_tpu_torch.data import batch_iterator, make_dataset, native_loader
    from deepl_project_tpu_torch.data.transforms import pil_available
    from deepl_project_tpu_torch.models import DiTConfig, TransVAE, create_dit, get_dit_config
    from deepl_project_tpu_torch.training import (TrainState, encode_to_latents,
                                                  make_dit_train_step, make_optimizer,
                                                  make_sampler, rectified_flow_loss,
                                                  restore_checkpoint)
    from deepl_project_tpu_torch.training.train_step import global_norm, init_ema, step_generator

    out_dir = os.path.join(ROOT, "outputs", "chip_smoke_dit")
    shutil.rmtree(out_dir, ignore_errors=True)
    folder, run_dir = os.path.join(out_dir, "images"), os.path.join(out_dir, "run")
    samples_dir = os.path.join(out_dir, "samples")
    if not (native_loader.native_available() or pil_available()):
        fail("dit: no image decoder (native or PIL) for the labelled folder")
    _write_image_folder(folder)
    with torch.device("meta"):
        meta = TransVAE(get_config("large", 16, 32))
    out = {}

    # 1. cli.train_dit, the tokenizer kept (random, in memory) for the times.
    made = {}
    real_load = train_cli.load_tokenizer

    def recording(*a, **kw):
        made["vae"] = real_load(*a, **kw)
        return made["vae"]

    argv = ["--dit_variant", "B", "--vae_variant", "large", "--data", folder,
            "--resolution", "256", "--batch_size", str(DIT_BATCH), "--total_steps",
            str(DIT_STEPS), "--stats_batches", str(DIT_STATS_BATCHES), "--log_every", "1",
            "--save_every", str(DIT_STEPS), "--sample_every", str(DIT_STEPS), "--fid_every",
            str(DIT_STEPS), "--fid_samples", str(DIT_FID_SAMPLES), "--sample_steps",
            str(DIT_SAMPLE_STEPS), "--cfg_scale", str(DIT_CFG), "--output_dir", run_dir]
    train_cli.load_tokenizer = recording
    reset_launches()
    t = time.time()
    try:
        train_cli.main(argv)
    finally:
        train_cli.load_tokenizer = real_load
    train_s = time.time() - t
    vae = made.pop("vae")
    encodes = DIT_STATS_BATCHES + DIT_STEPS
    decodes = -(-DIT_FID_SAMPLES // DIT_BATCH) + 1  # the FID's and the 8-sample grid's
    want = tokenizer_launches(meta, {"encoder": encodes, "decoder": decodes})
    got = kernel_launches()
    if got != want:
        fail(f"dit: cli.train_dit launched {got}, want {want} ({encodes} b{DIT_BATCH} "
             f"encodes, {decodes} decodes; no flash launch in the DiT)")
    DIT_PATHS["dit_train"] = launches_by_name()
    NORM_PATHS[f"dit: cli.train_dit, {encodes} encodes and {decodes} decodes"] = got[3]
    side = json.load(open(os.path.join(run_dir, "dit_config.json")))
    rows = [json.loads(r) for r in open(os.path.join(run_dir, "history.jsonl"))]
    train_rows = [r for r in rows if r["kind"] == "train"]
    fid_rows = [r for r in rows if r["kind"] == "fid"]
    best = json.load(open(os.path.join(run_dir, "best", "metrics.json")))
    state, ck_meta = restore_checkpoint(run_dir, map_location="cuda")
    inner = state["state"]
    # The CLI's initial weights (seed + 1, its default seed 42) against the
    # trained ones.
    start = create_dit(DiTConfig(**side["dit"]), side["grid"], device="cuda", seed=43)
    moved = max((inner["model"][k] - p).abs().max().item()
                for k, p in start.state_dict().items())
    del start
    if (side["unconditional"] or side["dit"]["hidden_dim"] != 768 or side["grid"] != 16
            or len(train_rows) != DIT_STEPS or len(fid_rows) != 1
            or not np.isfinite([r["loss"] for r in train_rows] + [r["grad_norm"] for r in
                                                                   train_rows]).all()
            or not np.isfinite(best.get("vgg_gen_fid", best.get("gen_fid", np.nan)))
            or ck_meta["step"] != DIT_STEPS or inner["optimizer"]["count"] != DIT_STEPS
            or not os.path.exists(os.path.join(run_dir, f"samples_{DIT_STEPS:07d}.png"))
            or not moved > 0):
        fail(f"dit: cli.train_dit wrote sidecar {side}, history {rows}, best {best}, "
             f"checkpoint step {ck_meta['step']}, params-vs-EMA {moved}")
    ips = [r["images_per_sec"] for r in train_rows[1:]]
    out["cli_img_s"] = float(np.median(ips))
    log(f"dit: cli.train_dit DiT-B/2 on large f16d32 @256 latents (16x16x32) of the folder, "
        f"b{DIT_BATCH}, {DIT_STEPS} steps: losses {[round(r['loss'], 5) for r in train_rows]}, "
        f"grad norms {[round(r['grad_norm'], 4) for r in train_rows]}; {list(best)[-1]} "
        f"{best[list(best)[-1]]:.4f} ({DIT_FID_SAMPLES} samples, {DIT_SAMPLE_STEPS} steps, "
        f"CFG {DIT_CFG}); img/s of steps 2-{DIT_STEPS} {[round(v, 2) for v in ips]} "
        f"(median {out['cli_img_s']:.2f}); params moved up to {moved:.3e} from their init; "
        f"launches {got} as tokenizer_launches; {train_s:.1f}s in all [{CARD}]")

    # 2. cli.sample_dit on that checkpoint: 16 samples, 50 steps, CFG 4;
    # the decoder random (no tokenizer checkpoint recorded), in memory.
    reset_launches()
    t = time.time()
    imgs = sample_cli.main(["--checkpoint", run_dir, "--num_samples", str(DIT_SAMPLES),
                            "--sample_steps", str(DIT_SAMPLE_STEPS), "--cfg_scale",
                            str(DIT_CFG), "--output_dir", samples_dir])
    sample_s = time.time() - t
    want = tokenizer_launches(meta, {"decoder": 1})
    got = kernel_launches()
    if got != want:
        fail(f"dit: cli.sample_dit launched {got}, want the decoder half at b{DIT_SAMPLES} {want}")
    DIT_PATHS["dit_sample"] = launches_by_name()
    NORM_PATHS[f"dit: cli.sample_dit, one b{DIT_SAMPLES} decode"] = got[3]
    files = sorted(os.listdir(samples_dir))
    if (imgs.shape != (DIT_SAMPLES, 256, 256, 3) or not np.isfinite(imgs).all()
            or files[0] != "grid.png" or len(files) != DIT_SAMPLES + 1):
        fail(f"dit: cli.sample_dit gave {imgs.shape} images, files {files}")
    log(f"dit: cli.sample_dit {DIT_SAMPLES} samples, {DIT_SAMPLE_STEPS} steps, CFG {DIT_CFG}: "
        f"{len(files)} files, images in [{imgs.min():.4f}, {imgs.max():.4f}], launches {got} "
        f"(the decoder half); {sample_s:.1f}s incl. the tokenizer's build [{CARD}]")

    # 3. DiT-B/2 in bf16 against fp32 on the card, same weights and draws:
    # the forward at b16, one loss and its gradient norm.
    b = DIT_SAMPLES
    model = _dit_random(get_dit_config("B", 2), 1)
    exact = _dit_twin(model, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(2)
    z = torch.randn(b, 16, 16, 32, generator=gen, device="cuda")
    t_ = torch.rand(b, generator=gen, device="cuda")
    y = torch.randint(0, 1001, (b,), generator=gen, device="cuda")
    noise = torch.randn(z.shape, generator=gen, device="cuda")
    with torch.no_grad():
        v16, v32 = model(z, t_, y), exact(z, t_, y)
    err = (v16 - v32).abs()
    res = {}
    for name, m in (("bf16", model), ("fp32", exact)):
        loss, _ = rectified_flow_loss(m, z, y, step_generator(0, 0, "cuda"), t=t_, noise=noise)
        params = [p for p in m.parameters()]
        res[name] = (loss.item(), global_norm(list(torch.autograd.grad(loss, params))).item())
    dl = abs(res["bf16"][0] - res["fp32"][0]) / res["fp32"][0]
    dg = abs(res["bf16"][1] - res["fp32"][1]) / res["fp32"][1]
    log(f"dit: DiT-B/2 b{b} bf16 vs fp32 (same weights, all random): forward max abs "
        f"{err.max().item():.3e} mean {err.mean().item():.3e} (max|v| "
        f"{v32.abs().max().item():.3e}, mean {v32.abs().mean().item():.3e}); loss "
        f"{res['bf16'][0]:.6f} / {res['fp32'][0]:.6f} (rel {dl:.2e}, bound "
        f"{TRAIN_LOSS_RTOL}), grad norm {res['bf16'][1]:.5f} / {res['fp32'][1]:.5f} "
        f"(rel {dg:.2e}, bound {TRAIN_GRAD_NORM_RTOL})")
    if not (torch.isfinite(v16).all() and dl <= TRAIN_LOSS_RTOL and dg <= TRAIN_GRAD_NORM_RTOL):
        fail("dit: DiT-B/2 in bf16 disagrees with fp32")
    del model, exact, v16, v32

    # 4. DiT-B/1 on 32x32 latents (N=1024): small_attention in every block
    # and no other kernel; as close to fp32 as the plain bf16 core.
    b1, g1 = DIT_B1
    model = _dit_random(get_dit_config("B", 1), 3)
    z = torch.randn(b1, g1, g1, 32, generator=gen, device="cuda")
    t_ = torch.rand(b1, generator=gen, device="cuda")
    y = torch.randint(0, 1000, (b1,), generator=gen, device="cuda")
    reset_launches()
    with torch.no_grad():
        vk = model(z, t_, y)
    torch.cuda.synchronize()
    got = kernel_launches()
    want = ({}, {}, {("small_attention", g1 * g1, 12): 12}, {})
    if got != want:
        fail(f"dit: DiT-B/1 forward launched {got}, want {want}")
    DIT_PATHS["dit_b1"] = launches_by_name()
    with torch.no_grad():
        vp = _dit_twin(model, attention_impl="xla")(z, t_, y)
        v32 = _dit_twin(model, dtype="float32")(z, t_, y)
    ek, ep = (vk - v32).abs(), (vp - v32).abs()
    log(f"dit: DiT-B/1 b{b1} @{g1}x{g1} (N={g1 * g1}) against fp32: kernel path mean abs "
        f"{ek.mean().item():.4e} max {ek.max().item():.4e}; plain bf16 core mean "
        f"{ep.mean().item():.4e} max {ep.max().item():.4e} (ratios {MODEL_MEAN_RATIO}, "
        f"{MODEL_MAX_RATIO}); launches {got}")
    if not (torch.isfinite(vk).all() and ek.mean() <= MODEL_MEAN_RATIO * ep.mean()
            and ek.max() <= MODEL_MAX_RATIO * ep.max()):
        fail("dit: DiT-B/1's kernel path is not as close to fp32 as the plain bf16 core")
    out["b1_forward_ms"] = cuda_time_ms(lambda: model(z, t_, y), 5)
    del model, vk, vp, v32
    torch.cuda.empty_cache()

    # 5. Times [card]: the b64 encode and the b16 decode (the CLI's
    # tokenizer), the serial decode of one folder batch, the DiT-B/2 step at
    # b64 on ready latents, a CFG Euler step at b16.
    x = torch.rand(DIT_BATCH, 256, 256, 3, generator=gen, device="cuda")
    with torch.no_grad():
        out["encode_b64_ms"] = cuda_time_ms(lambda: encode_to_latents(vae, None, x), 5)
        zd = torch.randn(DIT_SAMPLES, 32, 16, 16, generator=gen, device="cuda")
        out["decode_b16_ms"] = cuda_time_ms(lambda: vae.decode(zd), 5)
    del x, zd
    src = batch_iterator(make_dataset(folder, 256, with_labels=True), DIT_BATCH)
    t = time.perf_counter()
    next(src)
    out["folder_batch_s"] = time.perf_counter() - t

    dit = _dit_random(get_dit_config("B", 2), 4).train()
    state_ = TrainState(step=0, model=dit, ema=init_ema(dit),
                        optimizer=make_optimizer(list(dit.named_parameters()),
                                                 learning_rate=2e-4, warmup_steps=1000, b2=0.95))
    step = make_dit_train_step(dit, ema_decay=0.9999)
    z0 = torch.randn(DIT_BATCH, 16, 16, 32, generator=gen, device="cuda")
    y = torch.randint(0, 1000, (DIT_BATCH,), generator=gen, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stamps = []
    for _ in range(DIT_TIMED_STEPS + 1):
        stamps.append(time.perf_counter())
        step(state_, z0, y)
        torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    steps_ms = np.diff(stamps)[1:] * 1e3
    out["step_b64_ms"] = float(np.median(steps_ms[:DIT_TIMED_STEPS - 1]))
    out["step_b64_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    n_params = sum(p.numel() for p in dit.parameters())
    flops = dit_step_flops(dit, DIT_BATCH, 64)
    if profile:
        _profile(lambda: step(state_, z0, y), "dit_step_b64")
    sampler = make_sampler(dit.eval(), num_steps=10, cfg_scale=DIT_CFG, num_classes=1000)
    labels = torch.arange(DIT_SAMPLES, device="cuda")
    out["euler_cfg_b16_ms"] = cuda_time_ms(
        lambda: sampler(labels, 16, 32, torch.Generator(device="cuda").manual_seed(0)), 2) / 10
    if profile:
        one = make_sampler(dit, num_steps=1, cfg_scale=DIT_CFG, num_classes=1000)
        _profile(lambda: one(labels, 16, 32), "dit_euler_cfg_b16")
        x = torch.rand(DIT_BATCH, 256, 256, 3, generator=gen, device="cuda")
        _profile(lambda: encode_to_latents(vae, None, x), "dit_encode_b64")
        del x
    log(f"time dit: tokenizer encode b{DIT_BATCH} @256 {out['encode_b64_ms']:.2f} ms, decode "
        f"b{DIT_SAMPLES} {out['decode_b16_ms']:.2f} ms (CUDA events); one folder batch of "
        f"{DIT_BATCH} PNGs decoded serially (the CLI's source) {out['folder_batch_s']:.3f} s; "
        f"DiT-B/2 step b{DIT_BATCH} on ready latents (AdamW, EMA; host clock, synchronised) "
        f"{[round(float(v), 2) for v in steps_ms]} ms, median of steps 2-{DIT_TIMED_STEPS} "
        f"{out['step_b64_ms']:.2f} ms ({n_params / 1e6:.1f}M params, {flops / 1e12:.3f} TFLOP "
        f"a step (dit_step_flops): {flops / PEAK_BF16_FLOPS * 1e3:.3f} ms at the bf16 peak), peak "
        f"{out['step_b64_peak_gib']:.2f} GiB; Euler step with CFG at b{DIT_SAMPLES} (a "
        f"doubled batch of {2 * DIT_SAMPLES}) {out['euler_cfg_b16_ms']:.3f} ms; DiT-B/1 "
        f"forward b{b1} {out['b1_forward_ms']:.2f} ms; cli.train_dit {out['cli_img_s']:.2f} "
        f"img/s [{CARD}]")
    del dit, state_, vae
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


# -- phase 3 -------------------------------------------------------------
def phase_serve(model):
    import urllib.request

    import numpy as np
    import torch

    from deepl_project_tpu_torch.models import TransVAE
    from deepl_project_tpu_torch.ops.attention import AttentionRoPE
    from deepl_project_tpu_torch.ops.hopper import flash_attention as fla
    from deepl_project_tpu_torch.ops.hopper import fused_attention_block as fab
    from deepl_project_tpu_torch.serving import InferenceEngine, make_http_server

    cfg = model.config
    rng = np.random.default_rng(0)
    engine = InferenceEngine(model, max_batch=32, batch_window_ms=50.0)
    engine.start()
    server = make_http_server(engine, "127.0.0.1", 0)
    port = server.server_address[1]
    srv = threading.Thread(target=server.serve_forever, daemon=True)
    srv.start()

    def post(op, arr, dtype=None):
        import io

        buf = io.BytesIO()
        np.save(buf, arr)
        url = f"http://127.0.0.1:{port}/{op}" + (f"?dtype={dtype}" if dtype else "")
        with urllib.request.urlopen(url, data=buf.getvalue(), timeout=600) as r:
            return np.load(io.BytesIO(r.read()))

    imgs = rng.integers(0, 256, (32, 256, 256, 3), dtype=np.uint8)
    lat = rng.standard_normal((4, 16, 16, cfg.latent_dim)).astype(np.float32)
    requests = ([("reconstruct", imgs[i:i + 8], "uint8") for i in range(0, 32, 8)]
                + [("reconstruct", imgs[:2].astype(np.float32) / 255.0, None),
                   ("encode", imgs[:4].astype(np.float32) / 255.0, "float16"),
                   ("decode", lat, None)])
    outs = [None] * len(requests)
    errors = []

    def worker(i):
        try:
            outs[i] = post(*requests[i])
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(f"{requests[i][0]}: {type(e).__name__}: {e}")

    reset_launches()
    t = time.time()
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(requests))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    served_s = time.time() - t
    counts = {**fab.launch_counts(), **fla.launch_counts(), **norm_launches()}
    server.shutdown()
    server.server_close()
    engine.stop()
    if errors:
        fail("served requests failed: " + "; ".join(errors))
    log(f"served {len(requests)} concurrent requests in {served_s:.2f}s; "
        f"kernel launches {counts}")
    for (op, arr, dt), out in zip(requests, outs):
        want = ((arr.shape[0], 16, 16, cfg.latent_dim) if op == "encode"
                else (arr.shape[0], 256, 256, 3))
        if out.shape != want:
            fail(f"{op}: shape {out.shape} != {want}")
        o = out.astype(np.float32)
        if not np.isfinite(o).all():
            fail(f"{op}: non-finite output")
        if op != "encode" and not (o.min() >= 0 and o.max() <= (255 if dt == "uint8" else 1)):
            fail(f"{op}: output outside its range")
    for name in ("ln_qkv_rope", "attention_core", "proj_bias_gemm"):
        if counts.get(name, 0) == 0:
            fail(f"{name} was not launched while serving")

    # Exactly 20 sublayers + 6 stage-2 qkv kernels and flash forwards per
    # reconstruct, and a stats and an apply launch per GroupNorm -> SiLU
    # site (norm_sites: the table derived from the module structure).
    for res in (256, 512):
        log(f"GroupNorm -> SiLU sites per {res}px reconstruct, (H*W, C) -> sites: "
            f"{norm_sites(model, res)}")
    want = launches_per_reconstruct(256, model=model)
    reset_launches()
    kern = engine.run("reconstruct", imgs[:4])
    by_shape = kernel_launches()
    if by_shape != want:
        fail(f"launches per reconstruct {by_shape} != {want}")
    NORM_PATHS["serve: one 256px reconstruct, b4"] = by_shape[3]
    log(f"one reconstruct launched {by_shape}")

    # 512px: stages 2-3 (N=16384, 4096) take the flash forward, stage 4
    # (N=1024, C=1536) ln_qkv_rope + small_attention.
    want = launches_per_reconstruct(512, model=model)
    reset_launches()
    big = engine.run("reconstruct", rng.integers(0, 256, (2, 512, 512, 3), dtype=np.uint8))
    by_shape = kernel_launches()
    if big.shape != (2, 512, 512, 3) or not np.isfinite(big.astype(np.float32)).all():
        fail(f"512px reconstruct: shape {big.shape} or non-finite output")
    if by_shape != want:
        fail(f"512px launches per reconstruct {by_shape} != {want}")
    NORM_PATHS["serve: one 512px reconstruct, b2"] = by_shape[3]
    counts["flash_attention_fwd_512"] = sum(by_shape[1].values())
    log(f"512px reconstruct b=2: finite {big.shape}, launched {by_shape}")

    # Accuracy: the kernel path and the plain bf16 path (every attention
    # sublayer through the plain modules, the plain GroupNorm and SiLU),
    # each against the same weights computed in fp32 on the plain path with
    # TF32 off.
    attn = [m for m in model.modules() if isinstance(m, AttentionRoPE)]
    for m in attn:
        m.impl = "xla"
    set_fused_norm(False)
    reset_launches()
    plain = engine.run("reconstruct", imgs[:4])
    for m in attn:
        m.impl = cfg.attention_impl
    set_fused_norm(True)
    if any(kernel_launches()):
        fail(f"plain path launched kernels {kernel_launches()}")
    with torch.device("meta"):
        twin = TransVAE(cfg.replace(dtype="float32"))
    twin = twin.to_empty(device="cuda").eval()
    twin.load_state_dict(model.state_dict())
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    exact = InferenceEngine(twin).run("reconstruct", imgs[:4])
    torch.backends.cudnn.allow_tf32 = tf32
    del twin
    ek, ep = np.abs(kern - exact), np.abs(plain - exact)
    log(f"reconstruct b=4 sigmoid images vs fp32: kernel path max_abs="
        f"{ek.max():.3e} mean_abs={ek.mean():.3e}; plain bf16 path max_abs="
        f"{ep.max():.3e} mean_abs={ep.mean():.3e}; kernel vs plain max_abs="
        f"{np.abs(kern - plain).max():.3e}")
    if not (ek.mean() <= MODEL_MEAN_RATIO * ep.mean()
            and ek.max() <= MODEL_MAX_RATIO * ep.max()):
        fail("reconstruct: the kernel path is less accurate than the plain bf16 path")
    return counts


def serve_mesh_requests(imgs, lat) -> dict:
    """Phase serve_mesh's requests by run, (key, op, array, dtype): (a) two
    b8 reconstructs (uint8), a b4 encode and a b4 decode, sent at once over
    HTTP, then one b8 reconstruct alone (its launches counted); (b) that
    reconstruct, an odd batch of 3 (bucket 4) and one image; (c) that
    reconstruct; (d) the first of (a) and that reconstruct; (e) that
    reconstruct on the scan checkpoint. A key names the same request in
    every run."""
    import numpy as np

    b8 = ("b8", "reconstruct", imgs[:8], None)
    tensor = ([(f"a{i}", "reconstruct", imgs[8 * i:8 * i + 8], "uint8") for i in range(2)]
              + [("encode", "encode", imgs[:4].astype(np.float32) / 255.0, "float16"),
                 ("decode", "decode", lat, None), b8])
    return {"tensor": tensor,
            "replicate": [b8, ("b3", "reconstruct", imgs[:3], None),
                          ("b1", "reconstruct", imgs[:1], None)],
            "fsdp": [b8], "nccl": [tensor[0], b8], "tensor_scan": [b8]}


def _count_groups(engine, groups: list) -> None:
    """Record each group a mesh engine runs on this rank: its bucket, the
    rows this rank computes, host seconds (device synced), launches by
    shape, attention routes and bytes staged through host memory."""
    import torch

    from deepl_project_tpu_torch.ops import attention as attn_mod
    from deepl_project_tpu_torch.parallel import collectives as col
    from deepl_project_tpu_torch.parallel import serving_rows

    run = engine._group

    def counted(op, payload, out_dtype, keep=True):
        torch.cuda.synchronize()
        reset_launches()
        attn_mod.reset_route_counts()
        col.reset_staged_counts()
        t0 = time.perf_counter()
        out = run(op, payload, out_dtype, keep)
        torch.cuda.synchronize()
        rows = serving_rows(engine.mesh, payload.shape[0])
        groups.append({"op": op, "dtype": out_dtype, "bucket": int(payload.shape[0]),
                       "rows": int(payload.shape[0] if rows is None else len(rows)),
                       "s": time.perf_counter() - t0,
                       "launches": [sorted([list(k), v] for k, v in d.items())
                                    for d in kernel_launches()],
                       "routes": attn_mod.route_counts(), "staged": col.staged_counts()})
        return out

    engine._group = counted


def _serve_http(engine, server, requests) -> dict:
    """Rank 0 of run (a): all but the last request at once over HTTP, then
    the last alone, from a client thread, while this thread runs cli.serve's
    run_server; the server shuts down after them and stop() releases the
    follower."""
    import io
    import urllib.request

    import numpy as np

    from deepl_project_tpu_torch.cli import serve as serve_cli

    port = server.server_address[1]
    outs, errors = {}, []

    def post(key, op, arr, dtype):
        buf = io.BytesIO()
        np.save(buf, arr)
        url = f"http://127.0.0.1:{port}/{op}" + (f"?dtype={dtype}" if dtype else "")
        try:
            with urllib.request.urlopen(url, data=buf.getvalue(), timeout=600) as r:
                outs[key] = np.load(io.BytesIO(r.read()))
        except Exception as e:  # noqa: BLE001 -- raised below, after the server stops
            errors.append(f"{key}: {type(e).__name__}: {e}")

    def client():
        try:
            threads = [threading.Thread(target=post, args=r) for r in requests[:-1]]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            post(*requests[-1])
        finally:
            server.shutdown()

    threading.Thread(target=client, daemon=True).start()
    serve_cli.run_server(engine, server)
    if errors:
        raise RuntimeError("serve_mesh (a): requests failed: " + "; ".join(errors))
    return outs


def serve_mesh_worker(group: int) -> None:
    """A rank of phase serve_mesh, started by torchrun: two processes on the
    card over gloo (NCCL refuses two ranks on one device). Each run of
    SERVE_MESH_RUNS in SERVE_MESH_GROUPS[group] builds cli.serve's engine
    from the checkpoint file on a fresh mesh: (a) through cli.serve.serve
    (rank 0 serves HTTP, rank 1 follows), (b), (c) and (e) through
    cli.serve.build_engine (rank 0 runs the requests, rank 1 follows).
    Writes each rank's groups and peak memory to
    SERVE_MESH_DIR/rank<r>_<group>.json and rank 0's responses to
    out_<run>.npz; any failure exits non-zero."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from deepl_project_tpu_torch.cli import serve as serve_cli
    from deepl_project_tpu_torch.parallel import create_mesh, initialize_multihost

    initialize_multihost(backend="gloo", device="cuda:0")
    rank = dist.get_rank()
    inputs = np.load(os.path.join(SERVE_MESH_DIR, "inputs.npz"))
    requests = serve_mesh_requests(inputs["imgs"], inputs["lat"])
    report = {}
    for name, sharding, model_size, checkpoint in SERVE_MESH_RUNS:
        if name not in SERVE_MESH_GROUPS[group]:
            continue
        path = os.path.join(SERVE_MESH_DIR, checkpoint)
        deadline = time.time() + 300
        while not os.path.exists(path):  # run (e)'s file is written beside runs (a)-(c)
            if time.time() > deadline:
                raise FileNotFoundError(path)
            time.sleep(0.5)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        args = serve_cli.build_parser().parse_args([
            "--checkpoint", path, "--device", "cuda:0",
            "--max_batch", str(SERVE_MESH_BATCH), "--batch_window_ms", "50", "--port", "0",
            "--mesh_model", str(model_size), "--mesh_sharding", sharding])
        t0 = time.perf_counter()
        mesh = create_mesh(model=model_size)
        if name == "tensor":
            engine, server = serve_cli.serve(args, mesh)
        else:
            engine, server = serve_cli.build_engine(args, mesh), None
        built_s = time.perf_counter() - t0
        groups: list = []
        _count_groups(engine, groups)
        outs = {}
        if rank != 0:
            engine.follow()
        elif server is not None:
            outs = _serve_http(engine, server, requests[name])
        else:
            outs = {key: engine.run(op, arr, dt) for key, op, arr, dt in requests[name]}
            engine.stop()
        torch.cuda.synchronize()
        pl = engine.placement
        report[name] = {"groups": groups, "built_s": built_s,
                        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                        "split": sum(pl.dim(n) is not None for n in pl.specs),
                        "stacked": sum(".scan.block." in n for n in pl.specs),
                        "mesh": engine.stats()["mesh"]}
        if rank == 0:
            np.savez(os.path.join(SERVE_MESH_DIR, f"out_{name}.npz"), **outs)
        del engine, server, mesh, pl
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(SERVE_MESH_DIR, f"rank{rank}_{group}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()


def tensor4_worker() -> None:
    """Run (f) of phase serve_mesh, started by torchrun on four processes on
    the card over gloo: large f16d32 at TENSOR4_DEPTHS from seed 0 (bf16,
    attention 'auto'), rank 0's one-process fp32 and bf16 forwards of
    TENSOR4_BATCH seeded images first, then every rank places the model
    'tensor' on a model axis of 4 and runs the no-grad forward with the
    launch and route counts set to 0 just before. Writes
    TENSOR4_DIR/rank<r>.json (counts, stage 2's q/k/v/proj bytes held and
    whole) and rank 0's reconstructions; any failure exits non-zero."""
    import torch
    import torch.distributed as dist

    from deepl_project_tpu_torch import create_transvae
    from deepl_project_tpu_torch.ops import attention as attn_mod
    from deepl_project_tpu_torch.parallel import (create_mesh, initialize_multihost,
                                                  shard_params)

    initialize_multihost(backend="gloo", device="cuda:0")
    rank = dist.get_rank()
    gen = torch.Generator(device="cuda").manual_seed(41)
    x = torch.rand(TENSOR4_BATCH, 3, 256, 256, generator=gen, device="cuda")

    def build(dtype):
        return create_transvae("large", 16, 32, device="cuda", seed=0, dtype=dtype,
                               depths=TENSOR4_DEPTHS, attention_impl="auto").eval()

    stage2 = ("encoder.stages.2.0.attn.", ("to_q", "to_k", "to_v", "proj"))
    model = build("bfloat16")
    names = [n for n, _ in model.named_parameters()
             if n.startswith(stage2[0]) and n.split(".")[-2] in stage2[1]]
    whole_bytes = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                      if n in names)
    if rank == 0:
        recon = {}
        for dtype in ("float32", "bfloat16"):
            m = build(dtype) if dtype == "float32" else model
            tf32 = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = dtype == "bfloat16"
            with torch.no_grad():
                recon[dtype] = torch.sigmoid(m(x.to(getattr(torch, dtype)))[0].float()).cpu()
            torch.backends.cudnn.allow_tf32 = tf32
            del m
        torch.save(recon, os.path.join(TENSOR4_DIR, "one.pt"))
        torch.cuda.empty_cache()
    mesh = create_mesh(model=4)
    shard_params(mesh, model, "tensor")
    held = dict(model.named_parameters())
    held_bytes = sum(held[n].numel() * held[n].element_size() for n in names)
    dist.barrier()
    torch.cuda.synchronize()
    reset_launches()
    attn_mod.reset_route_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        got = torch.sigmoid(model(x.to(torch.bfloat16))[0].float())
    torch.cuda.synchronize()
    report = {"ms": (time.perf_counter() - t0) * 1e3, "launches": launches_by_name(),
              "routes": attn_mod.route_counts(), "held_bytes": held_bytes,
              "whole_bytes": whole_bytes, "stage2": names,
              "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if rank == 0:
        torch.save(got.cpu(), os.path.join(TENSOR4_DIR, "tensor4.pt"))
    with open(os.path.join(TENSOR4_DIR, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()


def _tensor4_check(run: "Beside") -> None:
    """Phase serve_mesh (f): the model-4 ranks' forward against one
    process's fp32 and bf16 forwards, and what each rank held and ran."""
    import torch

    rc, text = run.wait(timeout=600)
    if rc != 0:
        fail(f"serve_mesh (f): the four ranks exited {rc}:\n{text[-6000:]}")
    one = torch.load(os.path.join(TENSOR4_DIR, "one.pt"))
    got = torch.load(os.path.join(TENSOR4_DIR, "tensor4.pt"))
    e_tp = (got - one["float32"]).abs()
    e_one = (one["bfloat16"] - one["float32"]).abs()
    log(f"serve_mesh (f): model-4 tensor forward (large at {TENSOR4_DEPTHS}, b{TENSOR4_BATCH} "
        f"@256px) vs one process's fp32: mean_abs {e_tp.mean():.4e} max_abs {e_tp.max():.4e}; "
        f"one process's bf16: mean_abs {e_one.mean():.4e} max_abs {e_one.max():.4e} (ratio "
        f"{e_tp.mean() / e_one.mean():.3f}, bound {TENSOR4_MEAN_RATIO}); {run.s:.1f} s with "
        f"the set-up")
    if not (torch.isfinite(got).all() and e_tp.mean() <= TENSOR4_MEAN_RATIO * e_one.mean()):
        fail("serve_mesh (f): the model-4 tensor forward is less accurate than one process's "
             "bf16 forward")
    for r in range(4):
        with open(os.path.join(TENSOR4_DIR, f"rank{r}.json")) as f:
            g = json.load(f)
        log(f"serve_mesh (f) rank {r}: stage 2's q/k/v/proj {g['held_bytes']} of "
            f"{g['whole_bytes']} bytes held ({g['held_bytes'] / g['whole_bytes']:.4f}), "
            f"{g['ms']:.1f} ms (four ranks on one card over gloo: not a speed), peak "
            f"{g['peak_gib']:.2f} GiB, routes {g['routes']}, launches {g['launches']} [{CARD}]")
        # The weights are 4 x [384, 384] and a 384 bias: the bias stays whole.
        if g["held_bytes"] * 4 > g["whole_bytes"] + 3 * 384 * 4 or not g["routes"].get(
                "gathered_heads") or not g["launches"].get("flash_attention_fwd"):
            fail(f"serve_mesh (f) rank {r}: held {g['held_bytes']} of {g['whole_bytes']} "
                 f"bytes, routes {g['routes']}, launches {g['launches']}; want a quarter, the "
                 f"gathered heads and the flash core")
        SERVE_MESH_PATHS[f"serve_mesh_tensor4_rank{r}"] = g["launches"]


def serve_nccl_worker() -> None:
    """Run (d) of phase serve_mesh, started by torchrun as one process:
    cli.serve's own join_mesh (NCCL on the card) and serve on the (1, 1, 1)
    mesh, so the engine's headers and payloads go over NCCL on its stream;
    its requests over HTTP. Writes SERVE_MESH_DIR/nccl.json and
    out_nccl.npz; any failure exits non-zero."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from deepl_project_tpu_torch.cli import serve as serve_cli

    inputs = np.load(os.path.join(SERVE_MESH_DIR, "inputs.npz"))
    requests = serve_mesh_requests(inputs["imgs"], inputs["lat"])["nccl"]
    args = serve_cli.build_parser().parse_args([
        "--checkpoint", os.path.join(SERVE_MESH_DIR, "model.pt"), "--device", "cuda",
        "--max_batch", str(SERVE_MESH_BATCH), "--batch_window_ms", "50", "--port", "0",
        "--mesh_model", "1", "--mesh_sharding", "tensor"])
    mesh = serve_cli.join_mesh(args)
    engine, server = serve_cli.serve(args, mesh)
    groups: list = []
    _count_groups(engine, groups)
    outs = _serve_http(engine, server, requests)
    torch.cuda.synchronize()
    report = {"groups": groups, "backend": dist.get_backend(), "wire": str(engine._wire),
              "mesh": engine.stats()["mesh"],
              "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    np.savez(os.path.join(SERVE_MESH_DIR, "out_nccl.npz"), **outs)
    with open(os.path.join(SERVE_MESH_DIR, "nccl.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()


def phase_serve_mesh(model) -> None:
    """Serving on a mesh of two processes on the one card (PERF.md, section
    6): one process's responses (the kernel path, the plain bf16 path, the
    fp32 twin) to every request of serve_mesh_requests, then the ranks of
    serve_mesh_worker; each response held to phase serve's rule against the
    fp32 twin, each rank's launches and routes to their tables. Every time
    is gloo host staging with both ranks on one card: not a speed."""
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist

    from deepl_project_tpu_torch.models import TransVAE
    from deepl_project_tpu_torch.ops.attention import AttentionRoPE
    from deepl_project_tpu_torch.serving import InferenceEngine

    if dist.is_initialized():
        fail("serve_mesh: a process group exists before the phase")
    shutil.rmtree(SERVE_MESH_DIR, ignore_errors=True)
    os.makedirs(SERVE_MESH_DIR)
    cfg = model.config
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (32, 256, 256, 3), dtype=np.uint8)
    lat = rng.standard_normal((4, 16, 16, cfg.latent_dim)).astype(np.float32)
    np.savez(os.path.join(SERVE_MESH_DIR, "inputs.npz"), imgs=imgs, lat=lat)
    t0 = time.time()
    from deepl_project_tpu_torch.ops.stack import to_scanned_params

    host = {k: v.cpu() for k, v in model.state_dict().items()}
    spec = {"variant": cfg.variant.split("_")[0], "compression_ratio": 16,
            "latent_dim": cfg.latent_dim}
    torch.save({"model_state_dict": host, "config": spec},
               os.path.join(SERVE_MESH_DIR, "model.pt"))
    log(f"serve_mesh: weights written for the ranks in {time.time() - t0:.1f}s")
    requests = serve_mesh_requests(imgs, lat)
    unique = {key: (op, arr, dt) for run in requests.values() for key, op, arr, dt in run}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    free0, reserved0 = torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved()

    # The two ranks and run (d) start now (run (d) shares nothing with them
    # but the card); one process's responses to the same requests are
    # computed beside them: the kernel path, the plain bf16 path (plain
    # attention, GroupNorm and SiLU) and the fp32 twin (TF32 off). The card
    # holds all four processes (~8 GiB a rank).
    with contextlib.ExitStack() as stack:
        groups_run = [stack.enter_context(_beside_torchrun(
            2, f"serve-mesh-{i}", os.path.join(SERVE_MESH_DIR, f"ranks_{i}.log")))
            for i in range(len(SERVE_MESH_GROUPS))]
        nccl_run = stack.enter_context(_beside_torchrun(
            1, "serve-nccl", os.path.join(SERVE_MESH_DIR, "nccl.log")))
        shutil.rmtree(TENSOR4_DIR, ignore_errors=True)
        os.makedirs(TENSOR4_DIR)
        tensor4_run = stack.enter_context(_beside_torchrun(
            4, "tensor4", os.path.join(TENSOR4_DIR, "ranks.log")))
        # Run (e)'s checkpoint, the same weights in the scan layout, written
        # while runs (a)-(c) go on (the ranks wait for the file).
        t1 = time.time()
        part = os.path.join(SERVE_MESH_DIR, "model_scan.pt.part")
        torch.save({"model_state_dict": to_scanned_params(host, cfg),
                    "config": {**spec, "scan_blocks": True}}, part)
        os.replace(part, os.path.join(SERVE_MESH_DIR, "model_scan.pt"))
        del host
        log(f"serve_mesh: the scan layout's weights written in {time.time() - t1:.1f}s, "
            f"beside the ranks")
        t1 = time.time()
        engine = InferenceEngine(model, max_batch=SERVE_MESH_BATCH)
        one = {k: engine.run(*r) for k, r in unique.items()}
        attn = [m for m in model.modules() if isinstance(m, AttentionRoPE)]
        for m in attn:
            m.impl = "xla"
        set_fused_norm(False)
        plain = {k: engine.run(*r) for k, r in unique.items()}
        for m in attn:
            m.impl = cfg.attention_impl
        set_fused_norm(True)
        with torch.device("meta"):
            twin = TransVAE(cfg.replace(dtype="float32"))
        twin = twin.to_empty(device="cuda").eval()
        twin.load_state_dict(model.state_dict())
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        exact_engine = InferenceEngine(twin, max_batch=SERVE_MESH_BATCH)
        exact = {k: exact_engine.run(*r) for k, r in unique.items()}
        torch.backends.cudnn.allow_tf32 = tf32
        del twin, exact_engine, engine
        gc.collect()
        torch.cuda.empty_cache()
        alloc0 = torch.cuda.memory_allocated()
        one_s = time.time() - t1
        text = ""
        for i, run in enumerate(groups_run):
            rc, out = run.wait(timeout=900)
            if rc != 0:
                fail(f"serve_mesh: the two ranks of {SERVE_MESH_GROUPS[i]} exited {rc}:\n"
                     f"{out[-6000:]}")
            text += out
        nccl_rc, nccl_out = nccl_run.wait(timeout=300)
        _tensor4_check(tensor4_run)
        shutil.rmtree(TENSOR4_DIR, ignore_errors=True)
    if nccl_rc != 0:
        fail(f"serve_mesh (nccl): the process exited {nccl_rc}:\n{nccl_out[-6000:]}")
    nccl_s, ranks_s = nccl_run.s, [run.s for run in groups_run]
    log(f"serve_mesh: one process's responses took {one_s:.1f}s beside the ranks")
    for line in (text + nccl_out).splitlines():
        if line.startswith("[serve]"):
            log(f"serve_mesh rank output: {line}")
    ranks = [{}, {}]
    for r in range(2):
        for i in range(len(SERVE_MESH_GROUPS)):
            with open(os.path.join(SERVE_MESH_DIR, f"rank{r}_{i}.json")) as f:
                ranks[r].update(json.load(f))
    with open(os.path.join(SERVE_MESH_DIR, "nccl.json")) as f:
        nccl = json.load(f)

    def table(entry) -> tuple:
        return tuple({tuple(k): v for k, v in d} for d in entry)

    def check_outs(name: str) -> None:
        outs = np.load(os.path.join(SERVE_MESH_DIR, f"out_{name}.npz"))
        for key, op, arr, dt in requests[name]:
            got = outs[key]
            want = ((arr.shape[0], 16, 16, cfg.latent_dim) if op == "encode"
                    else (arr.shape[0], 256, 256, 3))
            kind = {"uint8": np.uint8, "float16": np.float16, None: np.float32}[dt]
            if got.shape != want or got.dtype != kind:
                fail(f"serve_mesh ({name}) {key}: {got.shape} {got.dtype}, want {want} {kind}")
            g = got.astype(np.float32)
            if not np.isfinite(g).all():
                fail(f"serve_mesh ({name}) {key}: non-finite output")
            if op != "encode" and not (g.min() >= 0 and g.max() <= (255 if dt == "uint8" else 1)):
                fail(f"serve_mesh ({name}) {key}: output outside its range")
            ref = exact[key].astype(np.float32)
            em, ep = np.abs(g - ref), np.abs(plain[key].astype(np.float32) - ref)
            d1 = np.abs(g - one[key].astype(np.float32)).max()
            log(f"serve_mesh ({name}) {key} {op} b{arr.shape[0]} dtype={dt}: vs fp32 max_abs "
                f"{em.max():.3e} mean_abs {em.mean():.3e}; one process's plain bf16 max_abs "
                f"{ep.max():.3e} mean_abs {ep.mean():.3e} (bounds x{MODEL_MAX_RATIO} / "
                f"x{MODEL_MEAN_RATIO}); vs one process's kernel path max_abs {d1:.3e}")
            if not (em.mean() <= MODEL_MEAN_RATIO * ep.mean()
                    and em.max() <= MODEL_MAX_RATIO * ep.max()):
                fail(f"serve_mesh ({name}) {key}: less accurate than one process's plain bf16")

    def launch_totals(groups) -> dict:
        total: dict = {}
        for g in groups:
            for d in g["launches"]:
                for k, v in d:
                    total[k[0]] = total.get(k[0], 0) + v
        return total

    want_one = launches_per_reconstruct(256, model=model)
    want_local = launches_per_local_reconstruct(model, 2)
    routes_one = {"sublayer": 20, "ln_qkv_rope": 6}
    routes_local = {"local_sublayer": 20, "local_ln_qkv_rope": 6}
    for name, sharding, model_size, _ in SERVE_MESH_RUNS:
        check_outs(name)
        for r, rep_ in enumerate(ranks):
            run = rep_[name]
            groups = run["groups"]
            if len(groups) != len(requests[name]) or run["mesh"] != {
                    "data": 2 // model_size, "context": 1, "model": model_size}:
                fail(f"serve_mesh ({name}) rank {r}: {len(groups)} groups on mesh "
                     f"{run['mesh']}; want {len(requests[name])}")
            if (run["stacked"] > 0) != name.endswith("_scan"):
                fail(f"serve_mesh ({name}) rank {r}: {run['stacked']} stacked parameters")
            if (run["split"] > 0) != (sharding != "replicate"):
                fail(f"serve_mesh ({sharding}) rank {r}: {run['split']} tensors split")
            for i, grp in enumerate(groups):
                if grp["op"] != "reconstruct":
                    continue
                got_t = table(grp["launches"])
                routes = grp["routes"]
                last = sharding != "tensor" or i == len(groups) - 1
                want_t = want_local if sharding == "tensor" else want_one
                if last and got_t != want_t:
                    fail(f"serve_mesh ({name}) rank {r} group {i}: launches {got_t} != "
                         f"{want_t}")
                if routes != (routes_local if sharding == "tensor" else routes_one):
                    fail(f"serve_mesh ({name}) rank {r} group {i}: routes {routes}")
            if sharding == "tensor" and any(set(g["routes"]) - set(routes_local)
                                            for g in groups):
                fail(f"serve_mesh (tensor) rank {r}: a group took another route: "
                     f"{[g['routes'] for g in groups]}")
            if sharding == "replicate" and [g["rows"] for g in groups] != [4, 2, 1]:
                fail(f"serve_mesh (replicate) rank {r}: rows {[g['rows'] for g in groups]}; "
                     "want [4, 2, 1] (b8 split, 3 placed by its bucket 4, 1 whole)")
            recon = [g for g in groups if g["op"] == "reconstruct"]
            staged = [g["staged"].get("collective_bytes", 0) for g in recon]
            log(f"serve_mesh ({name}: {sharding}, model {model_size}) rank {r}: "
                f"{run['split']} tensors split, built in {run['built_s']:.1f}s, peak "
                f"{run['peak_gib']:.2f} GiB; reconstruct groups (bucket, rows a rank, s, "
                f"staged bytes): {[(g['bucket'], g['rows'], round(g['s'], 3), b) for g, b in zip(recon, staged)]}; "
                f"routes {recon[-1]['routes']}; last reconstruct's launches "
                f"{table(recon[-1]['launches'])} (gloo on one card: not a speed) [{CARD}]")
            SERVE_MESH_PATHS[f"serve_mesh_{name}_rank{r}"] = launch_totals(groups)
    # (e) against (a): the scan checkpoint's responses and the unrolled one's.
    scan_outs = np.load(os.path.join(SERVE_MESH_DIR, "out_tensor_scan.npz"))
    flat_outs = np.load(os.path.join(SERVE_MESH_DIR, "out_tensor.npz"))
    for key, _, arr, dt in requests["tensor_scan"]:
        a, b = scan_outs[key].astype(np.float32), flat_outs[key].astype(np.float32)
        log(f"serve_mesh (tensor_scan) {key} b{arr.shape[0]} dtype={dt}: the scan "
            f"checkpoint's response vs the unrolled one's under tensor: max_abs "
            f"{np.abs(a - b).max():.3e}, bit-equal {bool(np.array_equal(a, b))}")
    # (d): the NCCL wire of one process on a (1, 1, 1) mesh.
    check_outs("nccl")
    groups = nccl["groups"]
    if (nccl["backend"] != "nccl" or not nccl["wire"].startswith("cuda")
            or nccl["mesh"] != {"data": 1, "context": 1, "model": 1}
            or len(groups) != len(requests["nccl"])):
        fail(f"serve_mesh (nccl): backend {nccl['backend']}, wire {nccl['wire']}, mesh "
             f"{nccl['mesh']}, {len(groups)} groups; want nccl, cuda, (1, 1, 1), "
             f"{len(requests['nccl'])}")
    if table(groups[-1]["launches"]) != want_one:
        fail(f"serve_mesh (nccl): launches {table(groups[-1]['launches'])} != {want_one}")
    if any(g["routes"] != routes_one for g in groups):
        fail(f"serve_mesh (nccl): routes {[g['routes'] for g in groups]}")
    log(f"serve_mesh (nccl, model 1): peak {nccl['peak_gib']:.2f} GiB; reconstruct groups "
        f"(bucket, s): {[(g['bucket'], round(g['s'], 3)) for g in groups]}; process "
        f"{nccl_s:.1f}s, beside the two ranks [{CARD}]")
    SERVE_MESH_PATHS["serve_mesh_nccl_rank0"] = launch_totals(groups)
    log(f"serve_mesh: the two ranks of each group of runs took "
        f"{', '.join(f'{g}: {t:.1f}s' for g, t in zip(SERVE_MESH_GROUPS, ranks_s))}, the "
        f"groups beside each other")
    shutil.rmtree(SERVE_MESH_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    free1, alloc1 = torch.cuda.mem_get_info()[0], torch.cuda.memory_allocated()
    # What this process reserved meanwhile (the engines' cached operands, as
    # one process's responses ran beside the ranks) is not the ranks'.
    grown = torch.cuda.memory_reserved() - reserved0
    log(f"serve_mesh: card memory free {free0 / 2**30:.2f} GiB before the ranks, "
        f"{free1 / 2**30:.2f} after, {grown / 2**30:.2f} GiB of it reserved by this process "
        f"meanwhile; this process {alloc0 / 2**30:.2f} / {alloc1 / 2**30:.2f} GiB allocated "
        f"after its responses / after the ranks")
    if free1 < free0 - grown - 2 ** 30 or alloc1 > alloc0 + 2 ** 30:
        fail("serve_mesh: the card's memory was not returned after the ranks")


def set_rewrites(model, on: bool) -> None:
    """The JAX package's exact rewrites (ConvFFN fold_output, the fused
    resample convs) on or off in every module of ``model``."""
    from deepl_project_tpu_torch.ops.ffn import ConvFFN
    from deepl_project_tpu_torch.ops.resample import Downsample, Upsample

    for m in model.modules():
        if isinstance(m, ConvFFN):
            m.fold_output = on
        elif isinstance(m, Downsample):
            m.fuse_dc = on
        elif isinstance(m, Upsample):
            m.fuse_main = m.fuse_dc = on


def in_turns(setter, fn, label: str, reps: int, what: str = "rewrites") -> dict:
    """Host time of ``fn()`` (which ends in a device sync) with the flags
    ``setter(on)`` sets on and off in turns (on, off, off, on), ``reps``
    calls a turn; the flags are left on."""
    times = {True: [], False: []}
    for on in (True, False, False, True):
        setter(on)
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        times[on].append((time.perf_counter() - t) / reps * 1e3)
    setter(True)
    log(f"time {label}, {what} on / off in turns (on, off, off, on; {reps} a turn): "
        f"on {[round(v, 2) for v in times[True]]} ms, off "
        f"{[round(v, 2) for v in times[False]]} ms [{CARD}]")
    return {"on_ms": times[True], "off_ms": times[False]}



def set_attention_impl(model, impl: str) -> None:
    """Every AttentionRoPE of ``model`` at attention ``impl``."""
    from deepl_project_tpu_torch.ops.attention import AttentionRoPE

    for m in model.modules():
        if isinstance(m, AttentionRoPE):
            m.impl = impl


def fused_impl_reconstruct(model) -> None:
    """Phase time (a): the b32 256px reconstruct with every AttentionRoPE at
    impl 'fused' (the JAX package's value: the sublayer kernels where their
    gates hold, the plain core elsewhere) against 'auto' on the same
    weights and images. The 'fused' run's launches (counters set to 0 just
    before, read just after): the sublayer kernels of
    launches_per_reconstruct(256), no flash and no small_attention launch,
    routes sublayer 20 and ln_qkv_rope 6. Each sublayer run at 'fused' on
    the input it had at 'auto': stages 3-4 (N <= 1024) bit-equal, stage 2
    (the plain core in the place of the flash forward) within KERNEL_RTOL
    of max (phase kernels' bar for the flash kernels against the plain
    core). The reconstruct of 4 images against the fp32 twin: 'fused''s
    error within MODEL_MEAN_RATIO / MODEL_MAX_RATIO of 'auto''s (phase
    serve's rule for a rounding change: two bf16 paths of this random
    model differ by ~0.14 at some pixel, PERF.md). Then the two timed in
    turns. The model is left at 'auto'."""
    import numpy as np
    import torch

    from deepl_project_tpu_torch.models import TransVAE
    from deepl_project_tpu_torch.ops import attention as attn_mod
    from deepl_project_tpu_torch.ops.attention import AttentionRoPE
    from deepl_project_tpu_torch.serving import InferenceEngine

    engine = InferenceEngine(model, max_batch=32)
    imgs = np.random.default_rng(21).random((32, 256, 256, 3), dtype=np.float32)
    kept = []

    def keep(mod, args, out):
        kept.append((mod, args[0].clone(), out.clone()))

    set_attention_impl(model, "auto")
    engine.run("reconstruct", imgs)  # warm
    hooks = [m.register_forward_hook(keep) for m in model.modules()
             if isinstance(m, AttentionRoPE)]
    try:
        auto = engine.run("reconstruct", imgs)
    finally:
        for h in hooks:
            h.remove()
    set_attention_impl(model, "fused")
    engine.run("reconstruct", imgs)  # warm
    reset_launches()
    attn_mod.reset_route_counts()
    fused = engine.run("reconstruct", imgs)
    got, routes = kernel_launches(), attn_mod.route_counts()
    TIME_PATHS["reconstruct_fused"] = launches_by_name()
    sub, _, _, norm = launches_per_reconstruct(256, model=model)
    if got != (sub, {}, {}, norm) or routes != {"sublayer": 20, "ln_qkv_rope": 6}:
        fail(f"time (a): 'fused' reconstruct launches {got}, routes {routes}; want "
             f"{(sub, {}, {}, norm)} and sublayer 20, ln_qkv_rope 6")
    NORM_PATHS["time (a): one 256px reconstruct at attention 'fused', b32"] = got[3]
    same, stage2 = 0, []
    with torch.inference_mode():
        for mod, x, y in kept:
            out = mod(x)
            if x.shape[2] * x.shape[3] <= 1024:
                same += bool(torch.equal(out, y))
            else:
                stage2.append(float((out.float() - y.float()).abs().max())
                              / float(y.float().abs().max()))
    n_small = sum(x.shape[2] * x.shape[3] <= 1024 for _, x, _ in kept)
    del kept
    # 'auto', 'fused' and the fp32 twin (plain paths, TF32 off) on 4 images.
    with torch.device("meta"):
        twin = TransVAE(model.config.replace(dtype="float32"))
    twin = twin.to_empty(device="cuda").eval()
    twin.load_state_dict(model.state_dict())
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    exact = InferenceEngine(twin).run("reconstruct", imgs[:4])
    torch.backends.cudnn.allow_tf32 = tf32
    del twin
    ea, ef = np.abs(auto[:4] - exact), np.abs(fused[:4] - exact)
    log(f"time (a): reconstruct b32 @256px at attention 'fused' vs 'auto': launches "
        f"{TIME_PATHS['reconstruct_fused']} (no flash, no small_attention), routes {routes}; "
        f"{same} of {n_small} stage-3/4 sublayers bit-equal to 'auto''s on its input; the "
        f"{len(stage2)} stage-2 sublayers (plain core vs flash) within "
        f"{max(stage2, default=float('inf')):.3e} of max (bar {KERNEL_RTOL:.3e}); reconstruct "
        f"'fused' vs 'auto' max_abs {np.abs(fused - auto).max():.3e}; b4 vs fp32: 'fused' "
        f"mean_abs {ef.mean():.3e} max_abs {ef.max():.3e}, 'auto' mean_abs {ea.mean():.3e} "
        f"max_abs {ea.max():.3e} (bounds x{MODEL_MEAN_RATIO} / x{MODEL_MAX_RATIO}) [{CARD}]")
    if n_small != 20 or same != n_small or len(stage2) != 6:
        fail("time (a): a stage-3/4 sublayer at 'fused' differs from 'auto''s")
    if max(stage2) > KERNEL_RTOL:
        fail("time (a): a stage-2 sublayer at 'fused' is off 'auto''s")
    if not (ef.mean() <= MODEL_MEAN_RATIO * ea.mean() and ef.max() <= MODEL_MAX_RATIO * ea.max()):
        fail("time (a): the 'fused' reconstruct is less accurate than the 'auto' one")
    recon = lambda: engine.run("reconstruct", imgs)  # noqa: E731
    turns = in_turns(lambda on: set_attention_impl(model, "auto" if on else "fused"), recon,
                     "reconstruct b=32 @256px", 2, "attention 'auto' (off: 'fused')")
    on, off = min(turns["on_ms"]), min(turns["off_ms"])
    log(f"time (a): reconstruct b=32 @256px: 'auto' {on:.2f} ms ({32 / on * 1e3:.2f} img/s), "
        f"'fused' {off:.2f} ms ({32 / off * 1e3:.2f} img/s), best of each: {off / on:.4f}x "
        f"[{CARD}]")


def _timed_in_turns(fns: dict, reps: int) -> dict:
    """cuda_time_ms of each of two ``fns`` (name -> fn) in turns (first,
    second, second, first), ``reps`` calls a turn: name -> [ms, ms]."""
    a, b = fns
    times = {a: [], b: []}
    for name in (a, b, b, a):
        times[name].append(cuda_time_ms(fns[name], reps, warmup=1))
    return times


def phase_fold_thin() -> None:
    """Phase fold_thin: (b) AttentionRoPE(fuse_qkv=True) at the three
    stage shapes (FOLD_SHAPES, b FOLD_BATCH, bf16) on the composable
    route (impl 'auto_train': the flash kernels at N = 4096, the plain
    core below), forward and backward, against fuse_qkv=False on the same
    weights and inputs: each one's output and input gradient against an
    fp32 run (the plain core), the fold's mean and max error within
    MODEL_MEAN_RATIO / MODEL_MAX_RATIO of the unfolded route's (a rounding
    change), the parameters' gradients' errors logged; ms of each
    (forward, and forward + backward) in turns. (c) ThinConv3x3 at large
    f16d32's boundary convs (THIN_CONVS, b THIN_BATCH, 256^2, bf16), on an
    NCHW and a channels_last input: each form (im2col for 3 -> 192,
    tap-major for 192 -> 3) within KERNEL_RTOL of max|F.conv2d| on the same
    bf16 weights, the output in the input's memory format; ms in turns
    beside that cuDNN call and the bound (max of operations / 989 TFLOP/s
    and bytes / 3.35 TB/s). Evidence only: the model calls neither."""
    import torch
    import torch.nn.functional as F

    from deepl_project_tpu_torch.ops.attention import AttentionRoPE
    from deepl_project_tpu_torch.ops.thin_conv import ThinConv3x3

    gen = torch.Generator(device="cuda").manual_seed(21)

    def randn(*shape, scale=1.0, shift=0.0, dtype=torch.float32):
        return (torch.randn(*shape, device="cuda", generator=gen) * scale + shift).to(dtype)

    # (b) The folded QKV.
    for n, c in FOLD_SHAPES:
        side = math.isqrt(n)
        mods = {f: AttentionRoPE(c, 64, impl="auto_train", fuse_qkv=f, device="cuda")
                for f in (False, True)}
        with torch.no_grad():
            # Weights N(0, 1/C); LayerNorm scales 1 + N(0, 0.01), biases N(0, 0.01).
            for name, p in mods[False].named_parameters():
                shift = 1.0 if name.startswith("norm_") and name.endswith("weight") else 0.0
                p.copy_(randn(*p.shape, scale=c ** -0.5) if p.dim() == 2
                        else randn(*p.shape, scale=0.1, shift=shift))
        mods[True].load_state_dict(mods[False].state_dict())
        x = randn(FOLD_BATCH, c, side, side, dtype=torch.bfloat16)
        ct = randn(FOLD_BATCH, c, side, side, dtype=torch.bfloat16)

        def run(m, dtype):
            m.zero_grad(set_to_none=True)
            xr = x.detach().to(dtype).requires_grad_(True)
            y = m(xr)
            y.backward(ct.to(dtype))
            grads = {k: p.grad.float() for k, p in m.named_parameters()}
            return y.detach().float(), xr.grad.float(), grads

        y32, dx32, g32 = run(mods[False], torch.float32)
        errs = {}
        for fuse, m in mods.items():
            y, dx, g = run(m, torch.bfloat16)
            errs[fuse] = {"y": ((y - y32).abs().mean().item(), (y - y32).abs().max().item()),
                          "dx": ((dx - dx32).abs().mean().item(),
                                 (dx - dx32).abs().max().item()),
                          "params_max": max((g[k] - g32[k]).abs().max().item()
                                            / g32[k].abs().max().item() for k in g32)}
        del y32, dx32, g32

        def fwd(m):
            with torch.no_grad():
                m(x)

        def fwd_bwd(m):
            xr = x.detach().requires_grad_(True)
            m(xr).backward(ct)

        fwd_ms = _timed_in_turns({"unfolded": lambda: fwd(mods[False]),
                                  "folded": lambda: fwd(mods[True])}, FOLD_REPS)
        step_ms = _timed_in_turns({"unfolded": lambda: fwd_bwd(mods[False]),
                                   "folded": lambda: fwd_bwd(mods[True])}, FOLD_REPS)
        u, f = errs[False], errs[True]
        log(f"fold_thin (b): AttentionRoPE fuse_qkv at (B, N, C)=({FOLD_BATCH}, {n}, {c}) bf16, "
            f"impl 'auto_train' (composable), against fp32: output mean/max abs error "
            f"folded {f['y'][0]:.3e}/{f['y'][1]:.3e}, unfolded {u['y'][0]:.3e}/{u['y'][1]:.3e}; "
            f"input gradient folded {f['dx'][0]:.3e}/{f['dx'][1]:.3e}, unfolded "
            f"{u['dx'][0]:.3e}/{u['dx'][1]:.3e} (bars {MODEL_MEAN_RATIO}x / "
            f"{MODEL_MAX_RATIO}x the unfolded's); parameter gradients' largest error over "
            f"max|grad| folded {f['params_max']:.3e}, unfolded {u['params_max']:.3e}; in turns "
            f"(unfolded, folded, folded, unfolded; {FOLD_REPS} calls a turn): forward "
            f"unfolded {[round(v, 4) for v in fwd_ms['unfolded']]} ms, folded "
            f"{[round(v, 4) for v in fwd_ms['folded']]} ms; forward + backward unfolded "
            f"{[round(v, 4) for v in step_ms['unfolded']]} ms, folded "
            f"{[round(v, 4) for v in step_ms['folded']]} ms [{CARD}]")
        for key in ("y", "dx"):
            if not (f[key][0] <= MODEL_MEAN_RATIO * u[key][0]
                    and f[key][1] <= MODEL_MAX_RATIO * u[key][1]):
                fail(f"fold_thin (b): the folded QKV's {key} at N={n}, C={c} is further from "
                     f"fp32 than the unfolded route's")
        del mods, x, ct

    # (c) The thin convs.
    for name, ci, co in THIN_CONVS:
        conv = ThinConv3x3(ci, co, device="cuda")
        with torch.no_grad():
            conv.weight.copy_(randn(*conv.weight.shape, scale=(2.0 / (9 * co)) ** 0.5))
            conv.bias.copy_(randn(co, scale=0.1))
        wb, bb = conv.weight.to(torch.bfloat16), conv.bias.to(torch.bfloat16)
        x = randn(THIN_BATCH, ci, 256, 256, dtype=torch.bfloat16)
        m = THIN_BATCH * 256 * 256
        flops = 2 * m * 9 * ci * co
        nbytes = m * (ci + co) * 2 + 9 * ci * co * 2 + co * 4
        bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
        form = "im2col" if ci <= 32 else "tap-major"
        for layout in ("nchw", "channels_last"):
            fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
            xl = x.contiguous(memory_format=fmt)
            with torch.no_grad():
                y = conv(xl)
                ref = F.conv2d(xl, wb, bb, padding=1)
                err = (y.float() - ref.float()).abs().max().item()
                top = ref.float().abs().max().item()
                in_format = y.is_contiguous(memory_format=fmt)
                del y, ref
                ms = _timed_in_turns({"cudnn": lambda: F.conv2d(xl, wb, bb, padding=1),
                                      form: lambda: conv(xl)}, 10)
            log(f"fold_thin (c): ThinConv3x3 {name} {ci} -> {co} ({form}) at "
                f"({THIN_BATCH}, {ci}, 256, 256) bf16 {layout}: max_abs={err:.3e} = "
                f"{err / top:.3e} of max|F.conv2d| (bar {KERNEL_RTOL:.3e}), output in the "
                f"input's format {in_format}; in turns (cuDNN, {form}, {form}, cuDNN; 10 calls "
                f"a turn): {form} {[round(v, 4) for v in ms[form]]} ms, cuDNN "
                f"{[round(v, 4) for v in ms['cudnn']]} ms, bound {bound_ms:.4f} ms (by "
                f"{'operations' if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_HBM_BYTES else 'bytes'}"
                f") [{CARD}]")
            if not err <= KERNEL_RTOL * top or not in_format:
                fail(f"fold_thin (c): ThinConv3x3 {name} ({layout}) is off F.conv2d")
            del xl
        del conv, x
    torch.cuda.empty_cache()


# -- phase 4 -------------------------------------------------------------
def phase_time(model, profile: bool):
    import numpy as np
    import torch

    from deepl_project_tpu_torch.serving import InferenceEngine

    engine = InferenceEngine(model, max_batch=32)
    imgs = np.random.default_rng(1).integers(0, 256, (32, 256, 256, 3), dtype=np.uint8)
    engine.run("reconstruct", imgs)  # warm
    torch.cuda.reset_peak_memory_stats()
    iters = 5
    t = time.time()
    for _ in range(iters):
        engine.run("reconstruct", imgs)
    step = (time.time() - t) / iters
    log(f"time reconstruct b=32 @256px bf16: {step * 1e3:.2f} ms/batch, "
        f"{32 / step:.2f} img/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{CARD}]")
    recon = lambda: engine.run("reconstruct", imgs)  # noqa: E731
    in_turns(lambda on: set_rewrites(model, on), recon, "reconstruct b=32 @256px", 2)
    # The fused GroupNorm -> SiLU kernels (25 sites) against the plain
    # GroupNorm and SiLU modules: the evidence for the module flag's default.
    fused = in_turns(set_fused_norm, recon, "reconstruct b=32 @256px", 3,
                     "fused GroupNorm -> SiLU")
    on, off = min(fused["on_ms"]), min(fused["off_ms"])
    log(f"time reconstruct b=32 @256px: fused GroupNorm -> SiLU {on:.2f} ms "
        f"({32 / on * 1e3:.2f} img/s), plain {off:.2f} ms ({32 / off * 1e3:.2f} img/s), "
        f"best of each: {off / on:.4f}x [{CARD}]")
    if profile:
        _profile(recon, "reconstruct_b32")
        set_fused_norm(False)
        _profile(recon, "reconstruct_b32_plain_norm")
        set_fused_norm(True)
    fused_impl_reconstruct(model)
    return step


# -- phase 5 -------------------------------------------------------------
def phase_eval(model, profile: bool):
    """The evaluation slice on large f16d32: evaluate_model at 256px, the
    extrapolation sweep at 256/512/1024px with its launches, the 512px
    accuracy check, and the generate CLI; with ``profile``, a torch.profiler
    table of one 1024px chunk's reconstruct."""
    import tempfile

    import numpy as np
    import torch

    from deepl_project_tpu_torch.cli import generate
    from deepl_project_tpu_torch.data import batch_iterator, make_dataset
    from deepl_project_tpu_torch.evaluation import (evaluate_model, extrapolation_sweep,
                                                    reconstruct, resize_images)
    from deepl_project_tpu_torch.models import TransVAE
    from deepl_project_tpu_torch.ops.attention import AttentionRoPE

    cfg = model.config
    out = {}

    # Reconstruction metrics at 256px: 2 batches of 16 shapes images.
    eval_dir = os.path.join(ROOT, "outputs", "chip_smoke_eval")
    torch.cuda.synchronize()
    t = time.time()
    metrics = evaluate_model(model, None, batch_iterator(make_dataset("shapes", resolution=256),
                                                         16),
                             max_batches=2, compute_rfid=True, output_dir=eval_dir,
                             save_grids=1)
    torch.cuda.synchronize()
    log(f"evaluate_model 256px shapes, 32 images, LPIPS + vgg_rfid (random VGG): "
        f"{json.dumps(metrics)} in {time.time() - t:.2f}s [{CARD}]")
    flat = [metrics[k][s] for k in ("psnr", "ssim", "lpips") for s in ("mean", "min", "max")]
    if metrics["num_images"] != 32 or not np.isfinite(flat + [metrics["vgg_rfid"]]).all():
        fail(f"evaluate_model: {metrics}")
    if sorted(os.listdir(eval_dir)) != ["comparison_000.png", "metrics.json"]:
        fail(f"evaluate_model wrote {os.listdir(eval_dir)}")

    # The extrapolation sweep, one resolution at a time so that each one's
    # launches are counted alone: a warm-up on one chunk, then all images.
    imgs = next(batch_iterator(make_dataset("shapes", resolution=1024), EVAL_IMAGES))
    sweep = {}
    for res in sorted(EVAL_CHUNKS):
        chunk = EVAL_CHUNKS[res]
        extrapolation_sweep(model, None, imgs[:chunk], (res,), chunk=chunk)
        want = launches_per_reconstruct(res, forwards=EVAL_IMAGES // chunk, model=model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t = time.perf_counter()
        r = extrapolation_sweep(model, None, imgs, (res,), chunk=chunk)[res]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        got = kernel_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        vals = [r[s] for s in ("mean", "min", "max")] + [r["ssim"][s] for s in ("mean", "min", "max")]
        log(f"sweep {res}px ({EVAL_IMAGES} images, chunk {chunk}): psnr {r['mean']:.4f} dB "
            f"(min {r['min']:.4f}, max {r['max']:.4f}), ssim {r['ssim']['mean']:.5f}; "
            f"{EVAL_IMAGES / dt:.3f} img/s ({dt:.3f}s), peak memory {peak:.2f} GiB; "
            f"launched {got} [{CARD}]")
        if not np.isfinite(vals).all():
            fail(f"sweep {res}px: non-finite metrics {r}")
        if got != want:
            fail(f"sweep {res}px: launches {got} != {want}")
        NORM_PATHS[f"eval: sweep {res}px, {EVAL_IMAGES} images in chunks of {chunk}"] = got[3]
        sweep[res] = {"img_s": EVAL_IMAGES / dt, "seconds": dt, "peak_gib": peak,
                      "psnr": r["mean"], "ssim": r["ssim"]["mean"], "launches": got}
    # Each resolution's sweep with the fused GroupNorm -> SiLU on and off
    # in turns, one sweep a turn: what the switch moves in the sweep.
    for res, chunk in sorted(EVAL_CHUNKS.items()):
        ab = in_turns(set_fused_norm,
                      lambda res=res, chunk=chunk: extrapolation_sweep(model, None, imgs, (res,),
                                                                       chunk=chunk),
                      f"sweep {res}px ({EVAL_IMAGES} images, chunk {chunk})", 1,
                      "fused GroupNorm -> SiLU")
        on, off = min(ab["on_ms"]), min(ab["off_ms"])
        log(f"sweep {res}px: fused GroupNorm -> SiLU {EVAL_IMAGES / on * 1e3:.3f} img/s, "
            f"plain {EVAL_IMAGES / off * 1e3:.3f} img/s, best of each {off / on:.4f}x [{CARD}]")
        sweep[res]["fused_norm_in_turns_ms"] = ab
    out["sweep"] = sweep
    out["small_attention_launches"] = sum(sweep[512]["launches"][2].values())
    if profile:
        chunk = imgs[:EVAL_CHUNKS[1024]]
        reconstruct(model, None, chunk)
        _profile(lambda: reconstruct(model, None, chunk), "sweep_1024")

    # Accuracy at 512px (b=2): the kernel path (small_attention at stage 4)
    # and the plain bf16 path, each against the same weights in fp32.
    x512 = resize_images(torch.from_numpy(imgs[:2]).permute(0, 3, 1, 2), 512)
    x512 = x512.permute(0, 2, 3, 1).numpy()
    reset_launches()
    kern = reconstruct(model, None, x512)
    if kernel_launches() != launches_per_reconstruct(512, model=model):
        fail(f"512px reconstruct launched {kernel_launches()}")
    attn = [m for m in model.modules() if isinstance(m, AttentionRoPE)]
    for m in attn:
        m.impl = "xla"
    set_fused_norm(False)
    reset_launches()
    plain = reconstruct(model, None, x512)
    for m in attn:
        m.impl = cfg.attention_impl
    set_fused_norm(True)
    if any(kernel_launches()):
        fail(f"512px plain path launched kernels {kernel_launches()}")
    with torch.device("meta"):
        twin = TransVAE(cfg.replace(dtype="float32"))
    twin = twin.to_empty(device="cuda").eval()
    twin.load_state_dict(model.state_dict())
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    exact = reconstruct(twin, None, x512)
    torch.backends.cudnn.allow_tf32 = tf32
    del twin
    torch.cuda.empty_cache()
    ek, ep = np.abs(kern - exact), np.abs(plain - exact)
    log(f"reconstruct 512px b=2 sigmoid images vs fp32: kernel path max_abs={ek.max():.3e} "
        f"mean_abs={ek.mean():.3e}; plain bf16 path max_abs={ep.max():.3e} "
        f"mean_abs={ep.mean():.3e}; kernel vs plain max_abs={np.abs(kern - plain).max():.3e}")
    if not (ek.mean() <= MODEL_MEAN_RATIO * ep.mean()
            and ek.max() <= MODEL_MAX_RATIO * ep.max()):
        fail("512px reconstruct: the kernel path is less accurate than the plain bf16 path")

    # The generate CLI on the card: random latents of large f16d32, PNGs.
    with tempfile.TemporaryDirectory() as tmp:
        t = time.time()
        generate.main(["--mode", "random", "--variant", "large", "--num_samples", "4",
                       "--output_dir", tmp])
        files = sorted(os.listdir(tmp))
        if files != ["random.png"] + [f"sample_{i:03d}.png" for i in range(4)]:
            fail(f"generate wrote {files}")
        for f in files:
            with open(os.path.join(tmp, f), "rb") as fh:
                if fh.read(8) != b"\x89PNG\r\n\x1a\n":
                    fail(f"generate: {f} is not a PNG")
        log(f"cli.generate --mode random (large, 4 samples): {files} in "
            f"{time.time() - t:.2f}s")
    torch.cuda.empty_cache()
    return out


# -- phase 8 -------------------------------------------------------------
def int8_sites():
    """(name, kind, B, H, W, C_in, C_out) of large f16d32's int8 sites at
    256px b32: the ResBlock 3x3 convs of stages 0 and 1, and each ConvFFN
    product of stages 2-4 (proj_in, w_head = [conv_0 | proj_out], the 3x3
    conv_1, w_fold = conv_2 proj_out)."""
    sites = [(f"resblock conv3x3 stage {i}", "conv", 32, hw, hw, 192, 192)
             for i, hw in ((0, 256), (1, 128))]
    for stage, hw, c in ((2, 64, 384), (3, 32, 768), (4, 16, 1536)):
        sites += [(f"ffn proj_in stage {stage}", "linear", 32, hw, hw, c, 4 * c),
                  (f"ffn w_head stage {stage}", "linear", 32, hw, hw, 4 * c, 2 * c),
                  (f"ffn conv_1 stage {stage}", "conv", 32, hw, hw, c, c),
                  (f"ffn w_fold stage {stage}", "linear", 32, hw, hw, c, c)]
    return sites


def model_gib(model) -> float:
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers())) / 2 ** 30


def phase_quant(model, profile: bool):
    """Int8 post-training quantization of ``model`` (large f16d32 from the
    seed): card-vs-CPU accumulators, each int8 site against its bf16 call
    and bound, the four scopes' reconstruct in turns, launches, accuracy
    against fp32, and cli.serve's engine with --quantize unset over HTTP."""
    import io
    import urllib.request

    import numpy as np
    import torch
    import torch.nn.functional as F

    from deepl_project_tpu_torch.cli import serve as serve_cli
    from deepl_project_tpu_torch.models import TransVAE
    from deepl_project_tpu_torch.ops import quant
    from deepl_project_tpu_torch.serving import InferenceEngine, make_http_server

    out = {"card": CARD}
    tq = time.time()
    # The card's int8 products against the CPU's exact ones.
    g = torch.Generator().manual_seed(0)
    i8 = lambda *s: torch.randint(-127, 128, s, generator=g, dtype=torch.int8)  # noqa: E731
    for name, fn, x, w in (
            ("resblock conv3x3 stage 0, b1", quant.int_conv, i8(1, 256, 256, 192),
             i8(192, 3, 3, 192)),
            ("ffn w_head stage 4, b4", quant.int_mm, i8(4 * 256, 6144), i8(3072, 6144)),
            ("ffn w_fold stage 4, b4", quant.int_mm, i8(4 * 256, 1536), i8(1536, 1536))):
        cpu = fn(x, w)
        card = fn(x.cuda(), w.cuda()).cpu()
        if not torch.equal(cpu, card):
            fail(f"quant {name}: the card's int32 accumulators differ from the CPU's "
                 f"({int((cpu != card).sum())} values)")
        log(f"quant {name}: int32 accumulators bit-equal card vs CPU ({cpu.numel()} values, "
            f"max |acc| {int(cpu.abs().max())})")

    log(f"quant: accumulators took {time.time() - tq:.1f}s")
    tq = time.time()
    # Each int8 site alone against its bf16 call, with its bound.
    sites = []
    for name, kind, b, h, w, ci, co in int8_sites():
        gen = torch.Generator(device="cuda").manual_seed(1)
        x = torch.randn(b, h, w, ci, generator=gen, device="cuda").to(torch.bfloat16)
        a = x.float().abs().amax() / quant.QMAX
        bias = 0.1 * torch.randn(co, generator=gen, device="cuda")
        k = (3, 3) if kind == "conv" else ()
        wf = torch.randn(co, ci, *k, generator=gen, device="cuda") * (ci * (9 if k else 1)) ** -0.5
        kq, ks = quant.quantize_weight(wf, axis=0)
        wb, bb = wf.to(torch.bfloat16), bias.to(torch.bfloat16)
        if kind == "conv":
            kq = kq.permute(0, 2, 3, 1).contiguous()
            xc = x.permute(0, 3, 1, 2)  # NCHW, channels-last in memory
            f8 = lambda: quant.qconv(x, kq, ks, a, bias, torch.bfloat16)  # noqa: E731
            fb = lambda: F.conv2d(xc, wb, bb, padding=1).permute(0, 2, 3, 1)  # noqa: E731
        else:
            f8 = lambda: quant.qmatmul(x, kq, ks, a, bias, torch.bfloat16)  # noqa: E731
            fb = lambda: F.linear(x, wb, bb)  # noqa: E731
        got, want = f8().float(), fb().float()
        rel = ((got - want).norm() / want.norm()).item()
        if rel > QUANT_SITE_REL_L2:
            fail(f"quant site {name}: int8 vs bf16 relative L2 {rel:.4f} > {QUANT_SITE_REL_L2}")
        del got, want
        ops = 2 * b * h * w * ci * co * (9 if k else 1)
        nbytes = b * h * w * (ci + co) * 2 + kq.numel()
        bound_ms = max(ops / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES) * 1e3
        t8, tb = cuda_time_ms(f8, 10), cuda_time_ms(fb, 10)
        row = {"site": name, "shape": [b, h, w, ci, co], "int8_ms": t8, "bf16_ms": tb,
               "bound_ms": bound_ms,
               "bound_by": "operations" if ops / PEAK_INT8_OPS >= nbytes / PEAK_HBM_BYTES
               else "bytes", "rel_l2_vs_bf16": rel}
        sites.append(row)
        log(f"quant site {name} [{b}, {h}, {w}, {ci}] -> {co}: int8 {t8:.4f} ms, bf16 "
            f"{'cuDNN conv' if k else 'F.linear'} {tb:.4f} ms, int8 bound {bound_ms:.4f} ms "
            f"({row['bound_by']}), int8 vs bf16 rel L2 {rel:.4f} [{CARD}]")
        del x, kq, wf, wb
        torch.cuda.empty_cache()
    out["sites"] = sites
    log(f"quant: sites took {time.time() - tq:.1f}s")
    tq = time.time()

    # The three scopes, calibrated as cli.serve calibrates.
    t = time.time()
    models = {"none": model}
    for scope in QUANT_SCOPES:
        models[scope] = serve_cli.quantize_for_serving(model, scope, 256)
    log(f"quant: calibrated and quantized {list(QUANT_SCOPES)} in {time.time() - t:.1f}s")
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (32, 256, 256, 3), dtype=np.uint8)
    engines = {s: InferenceEngine(m, max_batch=32) for s, m in models.items()}
    # One b32 reconstruct at each scope (which also warms each engine)
    # launches the bf16 table.
    want = launches_per_reconstruct(256, model=model)
    for scope in models:
        reset_launches()
        engines[scope].run("reconstruct", imgs)
        if kernel_launches() != want:
            fail(f"quant {scope}: launches per reconstruct {kernel_launches()} != {want}")
        if scope != "none":
            NORM_PATHS[f"quant: one int8 reconstruct, scope {scope}, b32"] = kernel_launches()[3]
    log(f"quant: one reconstruct at each scope launched the bf16 table {want}")

    # Reconstruct b32 in turns, one a turn: none, resblock, ffn, all, all,
    # ffn, resblock, none.
    order = list(models) + list(reversed(models))
    times = {s: [] for s in models}
    peaks = {s: 0.0 for s in models}
    for s in order:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        engines[s].run("reconstruct", imgs)
        times[s].append(time.perf_counter() - t)
        peaks[s] = max(peaks[s], (torch.cuda.max_memory_allocated() - base) / 2 ** 30
                       + model_gib(models[s]))
    whole = {}
    for s in models:
        whole[s] = {"ms": [v * 1e3 for v in times[s]], "img_s": [32 / v for v in times[s]],
                    "peak_gib": peaks[s], "weights_gib": model_gib(models[s])}
        log(f"quant reconstruct b=32 @256px scope {s}: {[round(v * 1e3, 2) for v in times[s]]} "
            f"ms ({[round(32 / v, 2) for v in times[s]]} img/s) in turns, peak memory "
            f"{peaks[s]:.2f} GiB (weights {model_gib(models[s]):.2f}) [{CARD}]")
    out["reconstruct"] = whole
    if profile:
        _profile(lambda: engines["resblock"].run("reconstruct", imgs), "reconstruct_b32_int8")
    del engines
    log(f"quant: scopes took {time.time() - tq:.1f}s")
    tq = time.time()

    # Accuracy: each scope's reconstruction logits (b4) against the fp32
    # twin's, the bf16 model's beside them.
    with torch.device("meta"):
        twin = TransVAE(model.config.replace(dtype="float32"))
    twin = twin.to_empty(device="cuda").eval()
    twin.load_state_dict(model.state_dict())
    x = torch.from_numpy(imgs[:4]).cuda().permute(0, 3, 1, 2).float() / 255.0
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        exact = twin(x)[0].float()
        errs = {s: ((m(x)[0].float() - exact).norm() / exact.norm()).item()
                for s, m in models.items()}
    torch.backends.cudnn.allow_tf32 = tf32
    del twin, exact
    out["rel_l2_vs_fp32"] = errs
    log(f"quant reconstruct b=4 logits vs the fp32 twin, relative L2: "
        f"{ {s: round(v, 5) for s, v in errs.items()} } (bound {QUANT_REL_L2} for int8)")
    if not all(np.isfinite(v) and v < QUANT_REL_L2 for s, v in errs.items() if s != "none"):
        fail(f"quant: int8 reconstruction error {errs} exceeds {QUANT_REL_L2}")
    for scope in QUANT_SCOPES:
        del models[scope]
    torch.cuda.empty_cache()
    log(f"quant: accuracy took {time.time() - tq:.1f}s")

    # cli.serve's engine over HTTP: --quantize unset, then int8 at the
    # default scope (the other scopes' engines are the turns' above, built
    # by the same quantize_for_serving).
    out["serve"] = []
    for argv in ([], ["--quantize", "int8"]):
        args = serve_cli.build_parser().parse_args(["--variant", "large", "--max_batch", "8"]
                                                   + argv)
        resolved = serve_cli.resolve_quantize(args.quantize, args.mesh_model)
        t = time.time()
        engine = serve_cli.build_engine(args)
        built_s = time.time() - t
        cfg = engine.model.config
        if (cfg.quant or "none") != resolved or (resolved == "int8"
                                                 and cfg.quant_scope != args.quantize_scope):
            fail(f"cli.serve {argv}: resolved {resolved!r} but built quant={cfg.quant!r} "
                 f"scope {cfg.quant_scope!r}")
        engine.start()
        server = make_http_server(engine, "127.0.0.1", 0)
        srv = threading.Thread(target=server.serve_forever, daemon=True)
        srv.start()
        buf = io.BytesIO()
        np.save(buf, imgs[:4])
        try:
            url = f"http://127.0.0.1:{server.server_address[1]}/reconstruct?dtype=uint8"
            with urllib.request.urlopen(url, data=buf.getvalue(), timeout=600) as r:
                rec = np.load(io.BytesIO(r.read()))
        finally:
            server.shutdown()
            server.server_close()
            engine.stop()
        if rec.shape != (4, 256, 256, 3) or rec.dtype != np.uint8:
            fail(f"cli.serve {argv} round trip: {rec.shape} {rec.dtype}")
        label = " ".join(argv) or "--quantize unset"
        log(f"cli.serve --variant large {label} -> {resolved}"
            f"{' scope ' + cfg.quant_scope if cfg.quant else ''}: engine built in "
            f"{built_s:.1f}s, HTTP reconstruct of 4 uint8 images -> {rec.shape} {rec.dtype}")
        out["serve"].append({"argv": argv, "resolved": resolved, "quant": cfg.quant,
                             "scope": cfg.quant_scope})
        del engine
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "quant.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


# -- phase parallel ------------------------------------------------------------
def phase_scan(model) -> None:
    """The scan layout on large f16d32 (phase 18): phase serve's weights
    stacked, its reconstruct and a deterministic stage-1 step against the
    unrolled model's, then the README's big-model command. The steps move
    ``model``'s weights: run it after every other phase that reads them."""
    import shutil

    import numpy as np
    import torch

    from deepl_project_tpu_torch.cli import train as train_cli
    from deepl_project_tpu_torch.data import batch_iterator, make_dataset
    from deepl_project_tpu_torch.evaluation import model_from_checkpoint, resize_images
    from deepl_project_tpu_torch.losses import LossWeights
    from deepl_project_tpu_torch.models import TransVAE
    from deepl_project_tpu_torch.ops.stack import (BlockStack, from_scanned_params,
                                                   to_scanned_params)
    from deepl_project_tpu_torch.serving import InferenceEngine
    from deepl_project_tpu_torch.training import (load_config, make_optimizer,
                                                  restore_model_params)
    from deepl_project_tpu_torch.training.train_step import (TrainState, compute_grads,
                                                             make_train_step,
                                                             named_trainables)

    cfg = model.config
    # A copy of its own: the unstacked tensors (stem, resamples, heads) are
    # not shared with ``model``, whose step in (b) moves them.
    with torch.device("meta"):
        scan = TransVAE(cfg.replace(scan_blocks=True))
    scan = scan.to_empty(device="cuda").eval()
    scan.load_state_dict(to_scanned_params(model.state_dict(), cfg), strict=True)
    stacks = [m for m in scan.modules() if isinstance(m, BlockStack)]
    log(f"scan: {len(stacks)} stage stacks of depths {[m.depth for m in stacks]}, "
        f"e.g. encoder.stages.4.scan.block.attn.to_q.weight "
        f"{tuple(scan.encoder.stages[4].scan.block.attn.to_q.weight.shape)}")

    # (a) The reconstruct, b32 @256px, each layout with the counters set to
    # 0 just before and read just after.
    imgs = np.random.default_rng(3).random((32, 256, 256, 3), dtype=np.float32)
    engines = {"unrolled": InferenceEngine(model, max_batch=32),
               "scan": InferenceEngine(scan, max_batch=32)}
    want = launches_per_reconstruct(256, model=model)
    outs = {}
    for name, engine in engines.items():
        engine.run("reconstruct", imgs)  # warm: operand caches, cuDNN plans
        reset_launches()
        outs[name] = engine.run("reconstruct", imgs)
        got = kernel_launches()
        by_name = launches_by_name()
        if got != want:
            fail(f"scan (a): {name} launches per reconstruct {got} != {want}")
        if name == "scan":
            SCAN_PATHS["scan_reconstruct"] = by_name
            NORM_PATHS["scan: one 256px reconstruct of the scan layout, b32"] = got[3]
    top = float(np.abs(outs["unrolled"]).max())
    err = float(np.abs(outs["scan"] - outs["unrolled"]).max())
    log(f"scan (a): reconstruct b32 @256px, scan vs unrolled max_abs={err:.3e} = "
        f"{err / top:.3e} of max|unrolled| (bar {KERNEL_RTOL:.3e}; bit-equal: "
        f"{bool(np.array_equal(outs['scan'], outs['unrolled']))}); launches of each = "
        f"launches_per_reconstruct(256): {SCAN_PATHS['scan_reconstruct']}")
    if not err <= KERNEL_RTOL * top:
        fail("scan (a): the scan layout's reconstruct differs from the unrolled model's")
    times: dict = {"unrolled": [], "scan": []}
    for name in ("unrolled", "scan", "scan", "unrolled"):
        t = time.perf_counter()
        for _ in range(SCAN_RECON_REPS):
            engines[name].run("reconstruct", imgs)
        times[name].append((time.perf_counter() - t) / SCAN_RECON_REPS * 1e3)
    log(f"time scan (a) reconstruct b32 @256px bf16 in turns (unrolled, scan, scan, "
        f"unrolled; {SCAN_RECON_REPS} a turn): unrolled "
        f"{[round(v, 2) for v in times['unrolled']]} ms, scan "
        f"{[round(v, 2) for v in times['scan']]} ms [{CARD}]")
    del engines, outs
    # ``model`` is not used again: its card memory goes to the steps, and so
    # do the bf16 serving operands cached in ``scan``'s modules.
    for m in [*model.modules(), *scan.modules()]:
        m.__dict__.pop("_operand_cache", None)
    model.to("cpu")
    gc.collect()
    torch.cuda.empty_cache()

    # (b) One deterministic stage-1 step of each layout, every one from the
    # same weights (``start``, restored into the stacks before each) and
    # batch. The step models' parameters are ``scan``'s: the scan model's
    # the stacks themselves, the unrolled model's views of their slices.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    weights = LossWeights(l1=1.0, lpips=0.0, kl=1e-8, vf=0.0, gan=0.0)
    batch = torch.as_tensor(np.stack(list(make_dataset(
        "synthetic", resolution=256, num_samples=SCAN_STEP_BATCH, seed=11)))).to("cuda")
    step_fn = make_train_step(weights, accum_steps=SCAN_STEP_ACCUM, seed=0)
    start = {k: v.to("cpu") for k, v in scan.state_dict().items()}

    def step_model(layout_cfg, sd):
        with torch.device("meta"):
            m = TransVAE(layout_cfg.replace(attention_impl="auto_train"))
        m.load_state_dict(sd, strict=True, assign=True)
        return m.train()

    models = {"unrolled": step_model(cfg, from_scanned_params(scan.state_dict(), cfg)),
              "scan": step_model(scan.config, scan.state_dict(keep_vars=True))}
    log(f"scan (b): {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated before "
        f"the steps")
    per_step = SCAN_STEP_ACCUM * 6  # stage 2's 3 + 3 blocks a microbatch
    results, step_ms = {"unrolled": [], "scan": []}, {"unrolled": [], "scan": []}
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        # A warm-up of each (no update): cuDNN and cuBLAS plans, the allocator.
        for m in models.values():
            compute_grads(m, batch, weights, accum_steps=SCAN_STEP_ACCUM, sample=False)
        for name in ("unrolled", "scan", "scan", "unrolled"):
            m = models[name]
            scan.load_state_dict(start)
            state = TrainState(step=0, model=m, optimizer=make_optimizer(
                named_trainables(m), learning_rate=1e-4, warmup_steps=0))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t = time.perf_counter()
            metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            step_ms[name].append((time.perf_counter() - t) * 1e3)
            counts = launches_by_name()
            if counts != {"flash_attention_fwd": per_step, "flash_attention_bwd_det": per_step}:
                fail(f"scan (b): {name} step launched {counts}, want {per_step} flash forward "
                     f"and {per_step} deterministic flash backward and no other kernel")
            check_norms(f"scan (b): {name} stage-1 step (graph-building forwards)", {})
            results[name].append((metrics["total"].item(), metrics["grad_norm"].item(),
                                  torch.cuda.max_memory_allocated() / 2 ** 30))
            del state, metrics
    finally:
        torch.use_deterministic_algorithms(was)
    # The row of flash_attention_bwd.cu counts both of its launchers.
    SCAN_PATHS["scan_step"] = {"flash_attention_fwd": per_step, "flash_attention_bwd": per_step}
    (lu, gu, pu), (ls, gs, ps) = results["unrolled"][0], results["scan"][0]
    same = len({r[:2] for rs in results.values() for r in rs}) == 1
    log(f"scan (b): stage-1 step {SCAN_STEP_BATCH} = {SCAN_STEP_ACCUM} x "
        f"{SCAN_STEP_BATCH // SCAN_STEP_ACCUM} deterministic: loss unrolled {lu!r} scan {ls!r} "
        f"(rel {abs(ls - lu) / abs(lu):.3e}, bar {SCAN_LOSS_RTOL}); grad norm {gu!r} / {gs!r} "
        f"(rel {abs(gs - gu) / gu:.3e}, bar {SCAN_GRAD_NORM_RTOL}); all four steps' loss and "
        f"grad norm bit-equal: {same}; {per_step} flash forward + {per_step} deterministic "
        f"backward launches each, no other kernel")
    log(f"time scan (b) stage-1 step large f16d32 @256 batch {SCAN_STEP_BATCH} "
        f"({SCAN_STEP_ACCUM} x {SCAN_STEP_BATCH // SCAN_STEP_ACCUM}), AdamW, deterministic, in "
        f"turns (unrolled, scan, scan, unrolled): unrolled "
        f"{[round(v, 1) for v in step_ms['unrolled']]} ms, scan "
        f"{[round(v, 1) for v in step_ms['scan']]} ms; peak memory unrolled {pu:.2f} GiB, "
        f"scan {ps:.2f} GiB [{CARD}]")
    if not (abs(ls - lu) <= SCAN_LOSS_RTOL * abs(lu) and abs(gs - gu) <= SCAN_GRAD_NORM_RTOL * gu):
        fail("scan (b): the scan layout's step differs from the unrolled model's")
    del models, scan, batch, start
    torch.cuda.empty_cache()

    # (c) The README's big-model command on the port.
    shutil.rmtree(SCAN_DIR, ignore_errors=True)
    argv = ["--variant", "large", "--gradient_checkpointing", "--scan_blocks",
            "--optimizer", "adafactor", "--data", "synthetic",
            "--batch_size", str(SCAN_CLI_BATCH), "--num_epochs", "1",
            "--steps_per_epoch", str(SCAN_CLI_STEPS), "--warmup_steps", "1",
            "--log_every", "1", "--save_every_epochs", "1", "--output_dir", SCAN_DIR]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t = time.time()
    train_cli.main(argv)
    cli_s = time.time() - t
    counts = launches_by_name()
    cli_want = {"flash_attention_fwd": 12 * SCAN_CLI_STEPS, "flash_attention_bwd": 6 * SCAN_CLI_STEPS}
    if counts != cli_want:
        fail(f"scan (c): cli.train launched {counts}, want {cli_want} (remat recomputes each "
             f"block's forward) and no other kernel")
    check_norms("scan (c): cli.train --scan_blocks (graph-building forwards)", {})
    SCAN_PATHS["scan_cli_train"] = counts
    rows = _history(SCAN_DIR)
    losses = [r["total"] for r in rows]
    if len(losses) != SCAN_CLI_STEPS or not np.isfinite(losses).all():
        fail(f"scan (c): losses {losses}")
    ckpt = os.path.join(SCAN_DIR, "checkpoints")
    saved = restore_model_params(ckpt)
    stacked = [k for k in saved if ".scan.block." in k]
    if not (load_config(ckpt).scan_blocks and stacked
            and not any(".stages.4.0." in k for k in saved)):
        fail(f"scan (c): the checkpoint is not in the scan layout ({len(stacked)} stacked keys)")
    del saved
    log(f"scan (c): cli.train {' '.join(argv)}: losses {[round(v, 5) for v in losses]}, "
        f"grad_norm {[round(r['grad_norm'], 4) for r in rows]}, {counts}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, {cli_s:.1f}s with the "
        f"build and the checkpoint; {len(stacked)} stacked keys [{CARD}]")
    loaded = model_from_checkpoint(ckpt, "cuda")
    engine = InferenceEngine(loaded, max_batch=SCAN_CLI_BATCH)
    reset_launches()
    out = engine.run("reconstruct", np.random.default_rng(4).integers(
        0, 256, (SCAN_CLI_BATCH, 256, 256, 3), dtype=np.uint8), "uint8")
    got = kernel_launches()
    SCAN_PATHS["scan_cli_reconstruct"] = launches_by_name()
    if got != want:
        fail(f"scan (c): launches of the reloaded checkpoint's reconstruct {got} != {want}")
    NORM_PATHS["scan: the cli.train checkpoint's 256px reconstruct, b8"] = got[3]
    if out.shape != (SCAN_CLI_BATCH, 256, 256, 3) or out.dtype != np.uint8:
        fail(f"scan (c): reconstruct of the reloaded checkpoint: {out.shape} {out.dtype}")
    log(f"scan (c): the checkpoint reloaded through load_config ({type(loaded).__name__}, "
        f"scan_blocks={loaded.config.scan_blocks}) served a b{SCAN_CLI_BATCH} reconstruct, "
        f"launches {SCAN_PATHS['scan_cli_reconstruct']}")
    del engine

    # (d) The extrapolation sweep of that checkpoint at 256 and 512px (512px
    # stage 4 is small_attention's: row 6 inside a stack), against the same
    # weights unrolled, each resolution's launches counted alone.
    from deepl_project_tpu_torch.evaluation import extrapolation_sweep
    from deepl_project_tpu_torch.utils.convert import load_state_dict

    with torch.device("meta"):
        flat = TransVAE(loaded.config.replace(scan_blocks=False))
    flat = load_state_dict(flat.to_empty(device="cuda"), loaded.state_dict()).eval()
    imgs = next(batch_iterator(make_dataset("shapes", resolution=SCAN_SWEEP[-1]), EVAL_IMAGES))
    for res in SCAN_SWEEP:
        chunk = EVAL_CHUNKS[res]
        rows, recon = {}, {}
        for name, m in (("unrolled", flat), ("scan", loaded)):
            extrapolation_sweep(m, None, imgs[:chunk], (res,), chunk=chunk)  # warm
            reset_launches()
            t = time.perf_counter()
            rows[name] = extrapolation_sweep(m, None, imgs, (res,), chunk=chunk)[res]
            torch.cuda.synchronize()
            rows[name]["s"] = time.perf_counter() - t
            rows[name]["launches"] = kernel_launches()
            with torch.inference_mode():
                x = resize_images(torch.as_tensor(imgs[:chunk]).permute(0, 3, 1, 2).to("cuda"),
                                  res)
                recon[name] = m(x.to(m.config.compute_dtype), sample=False)[0].float()
        want = launches_per_reconstruct(res, forwards=EVAL_IMAGES // chunk, model=flat)
        err = (recon["scan"] - recon["unrolled"]).abs().max().item()
        top = recon["unrolled"].abs().max().item()
        u, sc = rows["unrolled"], rows["scan"]
        log(f"scan (d): sweep {res}px of the cli.train checkpoint ({EVAL_IMAGES} images, chunk "
            f"{chunk}): psnr scan {sc['mean']!r} / unrolled {u['mean']!r}; one chunk's logits "
            f"max_abs {err:.3e} (rel {err / top:.3e}, bound {KERNEL_RTOL:.3e}), bit-equal "
            f"{bool(torch.equal(recon['scan'], recon['unrolled']))}; {sc['s']:.3f} / "
            f"{u['s']:.3f} s; launches scan {sc['launches']} [{CARD}]")
        if (not err <= KERNEL_RTOL * top or sc["launches"] != want
                or u["launches"] != want):
            fail(f"scan (d): the scan sweep at {res}px differs from the unrolled one (launches "
                 f"scan {sc['launches']}, unrolled {u['launches']}, want {want})")
        NORM_PATHS[f"scan: sweep {res}px of the scan checkpoint, {EVAL_IMAGES} images"] = \
            sc["launches"][3]
        SCAN_PATHS[f"scan_sweep_{res}"] = {
            k[0]: sum(v for kk, v in d.items() if kk[0] == k[0])
            for d in sc["launches"] for k in d}
        del recon
    del loaded, flat
    shutil.rmtree(SCAN_DIR, ignore_errors=True)
    torch.cuda.empty_cache()


def _fingerprint(params) -> "torch.Tensor":
    """Two int64 checksums of each parameter's bits ([n, 2] on the CPU):
    the sum of its int32 words and their sum weighted by position mod
    65521 + 1. Two ranks whose rows all agree hold bit-identical copies
    (short of a collision the weighting makes unlikely)."""
    import torch

    rows = []
    for p in params:
        words = p.detach().contiguous().view(torch.int32).reshape(-1).to(torch.int64)
        weight = torch.arange(words.numel(), device=words.device) % 65521 + 1
        rows.append(torch.stack([words.sum(), (words * weight).sum()]))
    return torch.stack(rows).cpu()


def _position_stats(t, whole_shape, dim, offset) -> "torch.Tensor":
    """[sum t^2, sum t h(i)] in fp64 of a part of a whole tensor of
    ``whole_shape``: i each entry's row-major index in the whole, h(i) =
    frac(43758.5453 sin(12.9898 i)) - 0.5 a hash of it; the part is the
    whole's slice [offset, offset + t.shape[dim]) along ``dim`` (None:
    the whole)."""
    import torch

    idx = torch.zeros((), dtype=torch.float64, device=t.device)
    stride = 1
    for k in reversed(range(t.ndim)):
        a = torch.arange(t.shape[k], dtype=torch.float64, device=t.device)
        a = a + (offset if k == dim else 0)
        idx = idx + (a * stride).reshape([-1 if j == k else 1 for j in range(t.ndim)])
        stride *= whole_shape[k]
    g = t.detach().double()
    h = torch.frac(torch.sin(idx * 12.9898) * 43758.5453).abs() - 0.5
    return torch.stack([g.square().sum(), (g * h).sum()])


def _moment_stats(trainer, state) -> dict:
    """Phase parallel (b): _position_stats of each parameter's AdamW first
    moment after the step ((1 - b1) times its clipped gradient), by its
    unrolled name (a stack's slice j under block j's), each whole tensor's
    the sum of the model peers' parts (a collective over the model group)."""
    import torch
    import torch.distributed as dist

    pl, opt = trainer.placement, state.optimizer
    names, parts = [], []
    for n, m in zip(opt.names, opt.mu):
        if m is None:
            continue
        d, whole = pl.dim(n), pl.full_shape(n, m)
        offset = 0 if d is None else pl.model_rank * m.shape[d]
        mine = d is not None or pl.model_rank == 0  # a replicated tensor counted once
        if ".scan.block." not in n:
            names.append(n)
            parts.append(_position_stats(m, whole, d, offset) if mine
                         else m.new_zeros(2, dtype=torch.float64))
            continue
        depth = whole[0]
        for j in range(depth):
            names.append(n.replace(".scan.block.", f".{j}."))
            if d == 0:  # the depth axis split: this rank holds slices [offset, ...)
                held = offset <= j < offset + m.shape[0]
                parts.append(_position_stats(m[j - offset], whole[1:], None, 0) if held
                             else m.new_zeros(2, dtype=torch.float64))
            else:
                parts.append(_position_stats(m[j], whole[1:], None if d is None else d - 1,
                                             offset) if mine
                             else m.new_zeros(2, dtype=torch.float64))
    stats = torch.stack(parts).cpu()
    dist.all_reduce(stats, group=pl.model_group)
    return {n: v.tolist() for n, v in zip(names, stats)}


def _slice_gap(got: dict, want: dict) -> tuple[float, float, str]:
    """The largest gaps of _moment_stats ``got`` from ``want`` (the same
    names): sums of squares relative, weighted sums over the norm; and
    the name where the larger lies."""
    if set(got) != set(want):
        return float("inf"), float("inf"), sorted(set(got) ^ set(want))[0]
    sq = wsum = 0.0
    where = ""
    for n, (a2, a1) in got.items():
        b2, b1 = want[n]
        if b2 == 0.0:
            e2 = e1 = 0.0 if a2 == 0.0 else float("inf")
        else:
            e2, e1 = abs(a2 - b2) / b2, abs(a1 - b1) / b2 ** 0.5
        if max(e2, e1) > max(sq, wsum):
            where = n
        sq, wsum = max(sq, e2), max(wsum, e1)
    return sq, wsum, where


def _dp_configs(dtype: str, scan: bool = False, depths=None):
    """Phase parallel (b)'s model in ``dtype`` (``scan``: the scan layout,
    scan_blocks; ``depths``: cut to these, else full depth), trainers'
    configs and batch: large f16d32 @256 under remat 'none', a global batch
    of PARALLEL_BATCH; stage 1 (L1 + LPIPS + KL) and one GAN step (frozen
    encoder, the adaptive weight unclamped, R1, a floor near the initial
    disc loss)."""
    import numpy as np

    from deepl_project_tpu_torch import get_config
    from deepl_project_tpu_torch.data import make_dataset
    from deepl_project_tpu_torch.losses import LossWeights
    from deepl_project_tpu_torch.training import TrainerConfig

    cut = {"depths": tuple(depths)} if depths else {}
    cfg = get_config("large", 16, 32, norm_latents=True, attention_impl="auto_train",
                     remat=True, remat_policy="none", dtype=dtype, scan_blocks=scan, **cut)
    common = dict(batch_size=PARALLEL_BATCH, accum_steps=1, warmup_steps=2, num_epochs=1,
                  steps_per_epoch=1, seed=0,
                  output_dir=os.path.join(ROOT, "outputs", "chip_smoke_parallel_b"))
    stage1 = TrainerConfig(weights=LossWeights(l1=1.0, lpips=1.0, kl=1e-8, vf=0.0, gan=0.0),
                           **common)
    gan = TrainerConfig(weights=LossWeights(l1=1.0, lpips=1.0, kl=1e-8, vf=0.0, gan=0.05),
                        freeze_encoder=True, gan_adaptive_weight=True,
                        gan_adaptive_max=PARALLEL_GAN_ADAPTIVE_MAX,
                        gan_disc_loss_floor=PARALLEL_GAN_FLOOR, gan_r1_gamma=10.0, **common)
    batch = np.stack(list(make_dataset("synthetic", resolution=256, num_samples=PARALLEL_BATCH,
                                       seed=11)))
    return cfg, stage1, gan, batch


# Phase parallel (b)'s runs: (name, step, param_sharding, mesh_model). The
# single process runs the steps; the two ranks each of these. gan_fp32 is
# the GAN step in fp32 with TF32 off (the plain attention core and norms:
# no kernel takes fp32). A name ending in _scan: the scan layout's twin of
# the run without it (the same seed's weights, stacked, and rows), held to
# that run as to one process.
DP_RUNS = (("stage1", "stage1", "replicate", 1), ("gan", "gan", "replicate", 1),
           ("gan_fp32", "gan_fp32", "replicate", 1),
           ("fsdp", "stage1", "fsdp", 2), ("tensor", "stage1", "tensor", 2),
           ("fsdp_scan", "stage1", "fsdp", 2), ("tensor_scan", "stage1", "tensor", 2))
# Each step's depths (a step not named: full depth), the ranks' and one
# process's alike.
DP_DEPTHS = {"stage1": PARALLEL_STEP_DEPTHS}
# Phase gan_cut (not in the defaults): (b)'s GAN runs with their steps cut
# to PARALLEL_STEP_DEPTHS, two ranks against one process.
GAN_CUT_RUNS = tuple(r for r in DP_RUNS if r[1].startswith("gan"))
GAN_CUT_DEPTHS = {step: PARALLEL_STEP_DEPTHS for _, step, _, _ in GAN_CUT_RUNS}
# The runs the ranks step under torch.use_deterministic_algorithms (the
# deterministic flash backward; warn_only, the ops without a deterministic
# version recorded): the scan twins and their unrolled runs.
PARALLEL_DETERMINISTIC = ("fsdp", "tensor", "fsdp_scan", "tensor_scan")
# Phase parallel (d), cli.train --scan_blocks --param_sharding tensor
# --mesh_model 2 on (b)'s two ranks: its steps, global batch and output.
SCAN_TP_STEPS, SCAN_TP_BATCH = 2, 4
SCAN_TP_DIR = os.path.join(ROOT, "outputs", "chip_smoke_scan_tp")


def _dp_marker(name: str, rank: int) -> str:
    """The file a rank of (b) writes once its run ``name`` is done."""
    return os.path.join(PARALLEL_DIR, f"done_{name}_rank{rank}")


def _dp_steps(runs, depths=DP_DEPTHS, rank=None) -> dict:
    """One step of _dp_configs() from the seed's weights for each of
    ``runs`` (DP_RUNS' rows; without a process group the single process;
    ``rank``: this rank's _dp_marker written after each run), each step at
    its ``depths`` (full where not named): the step's loss,
    grad norm, the GAN step's adaptive weight, disc loss and floor
    decision, peak memory, launches by kernel and flash launches by heads,
    the run's seconds with its build, and under a process group the
    fingerprints of the parameters every rank holds whole after the
    update."""
    import dataclasses
    import warnings

    import torch

    from deepl_project_tpu_torch.ops.hopper import flash_attention as fla
    from deepl_project_tpu_torch.parallel import shard_batch
    from deepl_project_tpu_torch.training import Trainer
    from deepl_project_tpu_torch.training.train_step import named_trainables

    out = {}
    for name, step, mode, model in runs:
        t_run = time.time()
        fp32 = step == "gan_fp32"
        cfg, stage1, gan, batch = _dp_configs("float32" if fp32 else "bfloat16",
                                              scan=name.endswith("_scan"),
                                              depths=depths.get(step))
        tc = dataclasses.replace(stage1 if step == "stage1" else gan, param_sharding=mode,
                                 mesh_model=model)
        # True fp32: cuDNN's convolutions default to TF32 (cuBLAS's products
        # do not); PyTorch's default is restored after the runs.
        torch.backends.cudnn.allow_tf32 = not fp32
        trainer = Trainer(cfg, tc, device="cuda")
        state = trainer.create_state()
        local = torch.as_tensor(shard_batch(trainer.mesh, batch)).to("cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        det = trainer.mesh is not None and name in PARALLEL_DETERMINISTIC
        was = torch.are_deterministic_algorithms_enabled()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(det, warn_only=True)
            try:
                t0 = time.perf_counter()
                m = trainer.step_fn(state, local)
                torch.cuda.synchronize()
                step_ms = (time.perf_counter() - t0) * 1e3
            finally:
                torch.use_deterministic_algorithms(was)
        row = {"ms": step_ms, "launches": launches_by_name(), "deterministic": det,
               "nondeterministic_ops": sorted({str(w.message).split(" does not")[0]
                                               for w in caught
                                               if "deterministic" in str(w.message)}),
               "flash_heads": sorted({h for (_, _, h) in fla.launch_counts_by_shape()}),
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "rows": int(local.shape[0]),
               **{k: float(m[k]) for k in ("total", "grad_norm", "adaptive_gan_weight",
                                            "disc_loss", "disc_update_scale") if k in m}}
        if trainer.mesh is not None:
            pl = trainer.placement
            whole = [p for n, p in named_trainables(state.model) if pl.dim(n) is None]
            disc = [] if trainer._disc_state is None else list(
                trainer._disc_state.model.parameters())
            row["fingerprint"] = _fingerprint(whole + disc)
            row["sharded"] = sum(pl.dim(n) is not None for n, _ in named_trainables(state.model))
            if mode != "replicate":
                row["moments"] = _moment_stats(trainer, state)
        row["depths"] = list(cfg.depths)
        row["s"] = time.time() - t_run
        out[name] = row
        del trainer, state, local, m
        torch.cuda.empty_cache()
        if rank is not None:
            open(_dp_marker(name, rank), "w").close()
    torch.backends.cudnn.allow_tf32 = True
    return out


def dp_worker(gan_cut: bool = False) -> None:
    """A rank of phase parallel (b) and (d), started by torchrun: two
    processes on the one card over gloo (CUDA tensors; NCCL refuses two
    ranks on one device), each of DP_RUNS, then _scan_cli_run. Writes its
    results to PARALLEL_DIR/rank<r>.json and scan_cli_rank<r>.json; any
    failure exits non-zero. ``gan_cut``: a rank of phase gan_cut, each of
    GAN_CUT_RUNS at GAN_CUT_DEPTHS, to gan_cut_rank<r>.json."""
    import torch
    import torch.distributed as dist

    from deepl_project_tpu_torch.parallel import initialize_multihost

    # cuBLAS's deterministic workspace, set before its first use
    # (PARALLEL_DETERMINISTIC's runs).
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    info = initialize_multihost(backend="gloo", device="cuda:0")
    rank = info["process_index"]
    out = (_dp_steps(GAN_CUT_RUNS, GAN_CUT_DEPTHS, rank) if gan_cut
           else _dp_steps(DP_RUNS, rank=rank))
    for row in out.values():
        fp = row.pop("fingerprint")
        lo, hi = fp.clone(), fp.clone()
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        row["params_bit_identical"] = bool(torch.equal(lo, hi))
        row["params_checked"] = int(fp.shape[0])
    with open(os.path.join(PARALLEL_DIR, f"{'gan_cut_' if gan_cut else ''}rank{rank}.json"),
              "w") as f:
        json.dump(out, f)
    torch.cuda.empty_cache()
    if not gan_cut:
        _scan_cli_run(rank)
        torch.cuda.empty_cache()
        _subset_and_dropout_run(rank)
    dist.destroy_process_group()


def _scan_cli_run(rank: int) -> None:
    """Phase parallel (d) on this rank of dp_worker's gloo group (NCCL
    refuses two ranks on one device; cli.train takes a group already
    joined): ``cli.train --variant large --scan_blocks --param_sharding
    tensor --mesh_model 2`` with the README big-model recipe's remat and
    Adafactor (whose factored moments keep the checkpoint small) on cuda:0
    for SCAN_TP_STEPS steps at global b SCAN_TP_BATCH. Writes this rank's
    launches, peak and seconds to PARALLEL_DIR/scan_cli_rank<r>.json."""
    import torch

    from deepl_project_tpu_torch.cli import train as train_cli

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    train_cli.main(["--variant", "large", "--scan_blocks", "--param_sharding", "tensor",
                    "--mesh_model", "2", "--gradient_checkpointing", "--optimizer", "adafactor",
                    "--data", "synthetic",
                    "--batch_size", str(SCAN_TP_BATCH), "--num_epochs", "1",
                    "--steps_per_epoch", str(SCAN_TP_STEPS), "--warmup_steps", "1",
                    "--log_every", "1", "--save_every_epochs", "1", "--device", "cuda:0",
                    "--output_dir", SCAN_TP_DIR])
    torch.cuda.synchronize()
    row = {"s": time.time() - t0, "launches": launches_by_name(),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    with open(os.path.join(PARALLEL_DIR, f"scan_cli_rank{rank}.json"), "w") as f:
        json.dump(row, f)


def _subset_cli(out_dir: str) -> dict:
    """cli.train --batch_size SUBSET_BATCH (phase parallel (e)) to
    ``out_dir`` in this process, large f16d32 cut to PARALLEL_STEP_DEPTHS
    (cli.train's get_config wrapped), under torch.use_deterministic_algorithms
    (warn_only): on a gloo group already joined the subset mesh's rank or
    a rank left out, else one process. Its seconds, launches and peak."""
    import torch

    from deepl_project_tpu_torch import get_config
    from deepl_project_tpu_torch.cli import train as train_cli

    train_cli.get_config = lambda *a, **kw: get_config(*a, **{**kw,
                                                             "depths": PARALLEL_STEP_DEPTHS})
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        train_cli.main(["--variant", "large", "--data", "synthetic",
                        "--batch_size", str(SUBSET_BATCH), "--num_epochs", "1",
                        "--steps_per_epoch", str(SUBSET_STEPS), "--log_every", "1",
                        "--warmup_steps", "2", "--save_every_epochs", "1",
                        "--gradient_checkpointing", "--seed", "0", "--device", "cuda:0",
                        "--output_dir", out_dir])
    finally:
        torch.use_deterministic_algorithms(was)
        train_cli.get_config = get_config
    torch.cuda.synchronize()
    return {"s": time.time() - t0, "launches": launches_by_name(),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "files": sorted(os.path.relpath(os.path.join(d, f), out_dir)
                            for d, _, fs in os.walk(out_dir) for f in fs)}


def _dropout_forward(model_size: int | None) -> dict:
    """Phase parallel (f)'s train-mode forward: large f16d32 at
    PARALLEL_STEP_DEPTHS with dropout DROPOUT_P, bf16 weights from seed 0,
    placed 'tensor' over model_size ranks (None: one process), on a
    synthetic b DROPOUT_BATCH after torch.manual_seed(DROPOUT_SEED). The
    reconstruction's sha256, its L1 distance to the input, each mask's
    sha256 and dropped share, launches, routes, ms and the reconstruction
    itself (fp32, on the host)."""
    import hashlib

    import numpy as np
    import torch

    from deepl_project_tpu_torch import get_config
    from deepl_project_tpu_torch.data import make_dataset
    from deepl_project_tpu_torch.models.transvae import TransVAE, init_weights
    from deepl_project_tpu_torch.ops import attention
    from deepl_project_tpu_torch.ops.layers import record_dropout_masks
    from deepl_project_tpu_torch.parallel import create_mesh, shard_params

    cfg = get_config("large", 16, 32, norm_latents=True, attention_impl="auto_train",
                     dtype="bfloat16", depths=PARALLEL_STEP_DEPTHS, dropout=DROPOUT_P)
    with torch.device("meta"):
        model = TransVAE(cfg)
    model = model.to_empty(device="cuda")
    init_weights(model, torch.Generator(device="cuda").manual_seed(0))
    if model_size:
        shard_params(create_mesh(model=model_size), model, "tensor")
    x = torch.as_tensor(np.stack(list(make_dataset(
        "synthetic", resolution=256, num_samples=DROPOUT_BATCH, seed=11)))).to("cuda")
    x = x.permute(0, 3, 1, 2)  # NCHW, channels_last in memory
    torch.cuda.synchronize()
    reset_launches()
    attention.reset_route_counts()
    torch.manual_seed(DROPOUT_SEED)
    t0 = time.perf_counter()
    with torch.no_grad(), record_dropout_masks() as masks:
        recon, _, _ = model(x.to(cfg.compute_dtype), deterministic=False)
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches, routes = launches_by_name(), attention.route_counts()
    l1 = float((torch.sigmoid(recon.float()) - x).abs().mean())

    def sha(t):  # of the bytes (bf16 or bool)
        return hashlib.sha256(t.contiguous().cpu().view(torch.uint8).numpy().tobytes()).hexdigest()

    out = {"recon_sha": sha(recon), "l1": l1, "masks": [sha(m) for m in masks],
           "dropped": [1.0 - m.float().mean().item() for m in masks],
           "shapes": [list(m.shape) for m in masks], "launches": launches, "routes": routes,
           "ms": ms, "recon": recon.float().cpu()}
    del model, recon, masks
    torch.cuda.empty_cache()
    return out


def _dropout_timed(group) -> dict:
    """ops.layers.dropout over ``group`` (None: alone) and F.dropout at
    DROPOUT_TIMED in bf16, each the median of host-clocked calls with a
    device sync (the group's seed broadcast is a host collective)."""
    import statistics

    import torch
    import torch.nn.functional as F

    from deepl_project_tpu_torch.ops.layers import dropout

    x = torch.randn(*DROPOUT_TIMED, device="cuda", dtype=torch.bfloat16)
    out = {}
    for name, fn in (("layers.dropout", lambda: dropout(x, DROPOUT_P, group)),
                     ("F.dropout", lambda: F.dropout(x, DROPOUT_P))):
        times = []
        for _ in range(12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times[2:])
    return out


def _subset_and_dropout_run(rank: int) -> None:
    """Phase parallel (e) and (f) on this rank of dp_worker's gloo group:
    cli.train on the subset mesh (rank 0 trains, rank 1 is left out; each
    its own output directory), then the tensor-parallel dropout forward.
    Writes PARALLEL_DIR/subset_rank<r>.json (rank 0 also the
    reconstruction, subset_recon.pt)."""
    import torch
    import torch.distributed as dist

    from deepl_project_tpu_torch.parallel import create_mesh

    row = {"subset": _subset_cli(os.path.join(SUBSET_DIR, f"rank{rank}"))}
    fwd = _dropout_forward(2)
    recon = fwd.pop("recon")
    if rank == 0:
        torch.save(recon, os.path.join(PARALLEL_DIR, "subset_recon.pt"))
    row["dropout"] = fwd
    row["dropout_timed"] = _dropout_timed(create_mesh(model=2).get_group("model"))
    with open(os.path.join(PARALLEL_DIR, f"subset_rank{rank}.json"), "w") as f:
        json.dump(row, f)
    dist.barrier()


def subset_one_worker() -> None:
    """Phase parallel (e) and (f)'s one process (no process group): cli.train
    at SUBSET_BATCH to SUBSET_DIR/one and the dropout forward at
    DROPOUT_SEED. Writes PARALLEL_DIR/subset_one.json and the
    reconstruction, subset_one_recon.pt."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    row = {"subset": _subset_cli(os.path.join(SUBSET_DIR, "one"))}
    fwd = _dropout_forward(None)
    torch.save(fwd.pop("recon"), os.path.join(PARALLEL_DIR, "subset_one_recon.pt"))
    row["dropout"] = fwd
    row["dropout_timed"] = _dropout_timed(None)
    with open(os.path.join(PARALLEL_DIR, "subset_one.json"), "w") as f:
        json.dump(row, f)


def refusal_worker(kind: str) -> None:
    """Under torchrun, two ranks on the one card: 'nccl' joins an NCCL group
    from both (one device) and all-reduces; 'gloo' tries each collective the
    parallel paths use on CUDA tensors. Prints one RESULT line per probe,
    accepted or refused with the library's message."""
    import torch
    import torch.distributed as dist

    from deepl_project_tpu_torch.parallel import initialize_multihost

    def probe(op, fn):
        try:
            fn()
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 -- the refusal is what this probe records
            msg = " ".join(str(e).split())[:300]
            print(f"RESULT {kind} {op} rank {os.environ.get('RANK')}: refused: "
                  f"{type(e).__name__}: {msg}", flush=True)
            return False
        print(f"RESULT {kind} {op} rank {os.environ.get('RANK')}: accepted", flush=True)
        return True

    if not probe("init", lambda: initialize_multihost(backend=kind, device="cuda:0",
                                                      timeout_s=60)):
        return
    x = torch.ones(4, device="cuda")
    world = dist.get_world_size()
    probe("all_reduce", lambda: dist.all_reduce(x))
    probe("broadcast", lambda: dist.broadcast(x, 0))
    probe("all_gather", lambda: dist.all_gather([torch.empty_like(x) for _ in range(world)], x))
    probe("reduce_scatter", lambda: dist.reduce_scatter(
        torch.empty(2, device="cuda"), list(torch.ones(2 * world, device="cuda").chunk(world))))


def p2p_probe_worker() -> None:
    """Under torchrun, two ranks on the one card over gloo: one
    batch_isend_irecv exchange of host tensors and one of CUDA tensors, each
    accepted (with its values checked) or refused with the message."""
    import torch
    import torch.distributed as dist

    from deepl_project_tpu_torch.parallel import initialize_multihost

    initialize_multihost(backend="gloo", device="cuda:0", timeout_s=60)
    rank = dist.get_rank()
    for dev in ("cpu", "cuda"):
        x = torch.arange(1 << 20, device=dev, dtype=torch.float32) * (rank + 1)
        buf = torch.zeros_like(x)
        try:
            for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1 - rank),
                                               dist.P2POp(dist.irecv, buf, 1 - rank)]):
                req.wait()
            torch.cuda.synchronize()
            right = torch.equal(buf, x / (rank + 1) * (2 - rank))
            print(f"RESULT gloo batch_isend_irecv {dev} rank {rank}: accepted, values "
                  f"{'right' if right else 'WRONG'}", flush=True)
        except Exception as e:  # noqa: BLE001 -- the refusal is what this probe records
            print(f"RESULT gloo batch_isend_irecv {dev} rank {rank}: refused: "
                  f"{type(e).__name__}: {' '.join(str(e).split())[:300]}", flush=True)
            return


def _torchrun_cmd(nproc: int, args: list) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(nproc), *args]


def _torchrun(nproc: int, args: list, timeout: int) -> subprocess.CompletedProcess:
    return subprocess.run(_torchrun_cmd(nproc, args), cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout, env={**os.environ, "PYTHONPATH": ROOT})


class Beside:
    """A torchrun (or any command) started in the background, its output to
    ``log_path``, while this process works beside it; wait() returns its
    exit code and output. Leaving the block stops it if it still runs
    (torchrun passes SIGTERM on to its workers), so a failure here leaves
    no process behind."""

    def __init__(self, cmd: list, log_path: str, env: dict | None = None):
        self.log_path = log_path
        self.t0 = time.time()
        with open(log_path, "w") as out:
            self.proc = subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=subprocess.STDOUT,
                                         text=True,
                                         env={**os.environ, "PYTHONPATH": ROOT, **(env or {})})
        # The seconds it ran (s), stamped when it ends, not when it is waited for.
        self._ended = threading.Thread(target=self._stamp, daemon=True)
        self._ended.start()

    def _stamp(self) -> None:
        self.proc.wait()
        self.s = time.time() - self.t0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()

    def wait(self, timeout: int) -> tuple[int, str]:
        rc = self.proc.wait(timeout=timeout)
        self._ended.join()
        with open(self.log_path) as f:
            return rc, f.read()


def _beside_torchrun(nproc: int, worker: str, log_path: str) -> Beside:
    """This script's ``--worker`` on ``nproc`` torchrun ranks, in the
    background."""
    return Beside(_torchrun_cmd(nproc, [os.path.join(ROOT, "chip_smoke.py"), "--worker",
                                        worker]), log_path)


def phase_refusals() -> None:
    """What two ranks on the card's one device may do (PERF.md): NCCL's
    group, and gloo's collectives on CUDA tensors, each accepted or refused
    with the library's message."""
    for kind in ("nccl", "gloo"):
        try:
            proc = _torchrun(2, [os.path.join(ROOT, "chip_smoke.py"), "--worker",
                                 f"refusal-{kind}"], timeout=180)
            text = proc.stdout + proc.stderr
        except subprocess.TimeoutExpired as e:
            text = f"TIMEOUT after 180 s: {(e.stdout or '')[-2000:]}"
        lines = sorted({ln.strip() for ln in text.splitlines() if "RESULT" in ln
                        or "TIMEOUT" in ln})
        for ln in lines:
            log(f"collective probe {kind}: {ln[ln.find('RESULT'):][:500]}")
        if not lines:
            fail(f"collective probe {kind}: no result recorded:\n{text[-3000:]}")


def _dp_compare(gan_cut: bool = False, start=None) -> tuple[dict, list, Beside | None]:
    """Two ranks on the card (torchrun, ``--worker dp``; ``gan_cut``:
    ``dp-gan-cut``, GAN_CUT_RUNS at GAN_CUT_DEPTHS) and beside them one
    process's steps of the same runs, its largest first while the ranks
    start and run their smallest; ``start()`` is called (its Beside
    started) once both ranks are past PARALLEL_CLI_AFTER: (one process's
    rows by step, each rank's rows by run name, that Beside)."""
    import shutil

    import torch

    runs, depths, prefix = ((GAN_CUT_RUNS, GAN_CUT_DEPTHS, "gan_cut_") if gan_cut
                            else (DP_RUNS, DP_DEPTHS, ""))
    shutil.rmtree(SCAN_TP_DIR, ignore_errors=True)
    for r in range(2):
        for path in [os.path.join(PARALLEL_DIR, f"{prefix}rank{r}.json"),
                     os.path.join(PARALLEL_DIR, f"scan_cli_rank{r}.json"),
                     *(_dp_marker(name, r) for name, _, _, _ in runs)]:
            if os.path.exists(path):
                os.remove(path)
    worker = "dp-gan-cut" if gan_cut else "dp"
    log_path = os.path.join(PARALLEL_DIR, f"{prefix}ranks.log")
    with _beside_torchrun(2, worker, log_path) as ranks_run:
        t0 = time.time()
        steps = list(dict.fromkeys(r[1] for r in runs))[::-1]
        ref = _dp_steps([(step, step, "replicate", 1) for step in steps], depths)
        torch.cuda.empty_cache()
        one_s = time.time() - t0
        started = None
        if start is not None:
            files = [_dp_marker(PARALLEL_CLI_AFTER, r) for r in range(2)]
            while ranks_run.proc.poll() is None and not all(map(os.path.exists, files)):
                time.sleep(1)
            started = start()
        rc, text = ranks_run.wait(timeout=900)
    if rc != 0:
        fail(f"parallel (b): the two ranks exited {rc}:\n{text[-6000:]}")
    log(f"parallel (b): one process's steps ({', '.join(steps)}) took {one_s:.1f}s beside the "
        f"two ranks, which took {ranks_run.s:.1f}s")
    ranks = []
    for r in range(2):
        with open(os.path.join(PARALLEL_DIR, f"{prefix}rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ref, ranks, started


def phase_parallel(train_rows: list) -> None:
    """Parallel training on the one card (PERF.md, section 6):
    (a) world size 1 over NCCL in this process, against phase train's rows,
    the step in turns with the plain one, and cli.train under torchrun
    (beside (b)'s ranks) with its checkpoint resumed by one process;
    (b) two processes over gloo against one process; (c) the
    tensor-parallel attention sublayer's two head shards (composable route,
    flash at 3 heads) against the whole sublayer. The process group is gone
    when the phase ends."""
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist

    from deepl_project_tpu_torch import get_config
    from deepl_project_tpu_torch.losses import LossWeights
    from deepl_project_tpu_torch.ops import attention as attn_mod
    from deepl_project_tpu_torch.ops.hopper import flash_attention as fla
    from deepl_project_tpu_torch.parallel import all_reduce_mean_, initialize_multihost
    from deepl_project_tpu_torch.parallel.collectives import BUCKET_NUMEL
    from deepl_project_tpu_torch.training import Trainer, TrainerConfig
    from deepl_project_tpu_torch.training.checkpoint import load_config, restore_model_params
    from deepl_project_tpu_torch.training.train_step import (compute_grads, global_norm,
                                                             named_trainables, step_generator)

    if dist.is_initialized():
        fail("parallel: a process group exists before phase parallel (the single-process "
             "phases must create none)")
    os.makedirs(PARALLEL_DIR, exist_ok=True)
    out_dir = os.path.join(ROOT, "outputs", "chip_smoke_parallel")
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = get_config("large", 16, 32, norm_latents=True, attention_impl="auto_train")
    weights = LossWeights(l1=1.0, lpips=1.0, kl=1e-8, vf=0.0, gan=0.0)
    tc = TrainerConfig(batch_size=16, accum_steps=2, warmup_steps=2, num_epochs=1,
                       steps_per_epoch=TRAIN_STEPS, log_every=1, save_every_epochs=10,
                       output_dir=out_dir, weights=weights, seed=0)
    plain = Trainer(cfg, tc, device="cuda")  # no process group yet: the plain step
    store = os.path.join(PARALLEL_DIR, "store_ws1")
    if os.path.exists(store):
        os.remove(store)

    # (a) World size 1 over NCCL, in process.
    initialize_multihost(backend="nccl", device="cuda:0", init_method=f"file://{store}",
                         rank=0, world_size=1)
    trainer = Trainer(cfg, tc, device="cuda")
    if trainer.mesh is None or trainer.placement.data_size != 1:
        fail("parallel (a): the trainer built no mesh of one rank")
    state = trainer.create_state()
    data = _synthetic(16)
    state, steps_s, peak, counts, other, fit_s = _fit_timed(trainer, state, data)
    want = {k: 12 * TRAIN_STEPS for k in ("flash_attention_fwd", "flash_attention_bwd")}
    if counts != want or other:
        fail(f"parallel (a): flash launches {counts} (want {want}), others {other}")
    check_norms(f"parallel (a): {TRAIN_STEPS} steps at world size 1", {})
    PARALLEL_PATHS["parallel_ws1_fit"] = dict(counts)
    # The run against phase train's (same seed, batches): reported, not
    # held (the two fits part from step 1's grad norm, a cause not isolated:
    # PERF.md section 7).
    pairs = list(zip(train_rows, _history(out_dir), strict=True))
    rel = {key: [f"{abs(b[key] - a[key]) / abs(a[key]):.2e}" for a, b in pairs]
           for key in ("total", "grad_norm")}
    log(f"parallel (a): world size 1 (NCCL) fit vs phase train's plain fit, same seed and "
        f"batches, step by step: loss rel {rel['total']}, grad norm rel {rel['grad_norm']}")
    # The check: the plain and the distributed compute_grads on the same
    # weights, batch and noise (the plain one twice: its own spread).
    batch = torch.as_tensor(next(data)).to("cuda")
    got = {}
    for label, placement in (("plain", None), ("plain again", None),
                             ("distributed", trainer.placement)):
        grads, m = compute_grads(state.model, batch, weights, trainer.lpips_params,
                                 accum_steps=2, generator=step_generator(0, state.step, "cuda"),
                                 placement=placement)
        got[label] = (m["total"].item(), global_norm(grads).item())
        del grads, m
    (lp, gp), (lp2, gp2), (ld, gd) = got["plain"], got["plain again"], got["distributed"]
    lr_, gr_ = abs(ld - lp) / abs(lp), abs(gd - gp) / gp
    log(f"parallel (a): same weights and batch, world size 1 vs plain: loss {ld:.7f} / {lp:.7f} "
        f"(rel {lr_:.2e}, bit-equal {ld == lp}; bound {PARALLEL_LOSS_RTOL}), grad norm "
        f"{gd:.7f} / {gp:.7f} (rel {gr_:.2e}, bit-equal {gd == gp}; bound "
        f"{PARALLEL_GRAD_NORM_RTOL}); plain twice: loss rel {abs(lp2 - lp) / abs(lp):.2e}, "
        f"grad norm rel {abs(gp2 - gp) / gp:.2e}")
    if lr_ > PARALLEL_LOSS_RTOL or gr_ > PARALLEL_GRAD_NORM_RTOL:
        fail("parallel (a): the distributed step's loss or grad norm is off the plain one's")
    step_ms = float(np.median(steps_s)) * 1e3
    log(f"time parallel (a) train step at world size 1, batch 16 (2 x 8): {step_ms:.1f} ms "
        f"(steps 2-{TRAIN_STEPS}: {[round(float(v) * 1e3, 1) for v in steps_s]}), peak "
        f"{peak:.2f} GiB [{CARD}]")
    # The plain and the distributed step on the same state, in turns.
    turns = {"plain": [], "distributed": []}
    for label in ("plain", "distributed", "distributed", "plain"):
        fn = plain.step_fn if label == "plain" else trainer.step_fn
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(state, batch)
        torch.cuda.synchronize()
        turns[label].append((time.perf_counter() - t0) * 1e3)
    grads = [torch.zeros_like(p) for _, p in named_trainables(state.model)]
    ar_ms = cuda_time_ms(lambda: all_reduce_mean_(grads, trainer.placement.data_group), 3, 1)
    numel = sum(g.numel() for g in grads)
    log(f"time parallel (a) in turns (plain, distributed, distributed, plain): plain "
        f"{[round(v, 1) for v in turns['plain']]} ms, distributed "
        f"{[round(v, 1) for v in turns['distributed']]} ms a step; the gradient all-reduce "
        f"alone ({numel} fp32 values, {math.ceil(numel / BUCKET_NUMEL)} buckets) "
        f"{ar_ms:.2f} ms [{CARD}]")
    del state, grads, batch, trainer, plain, data
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    shutil.rmtree(out_dir, ignore_errors=True)

    # (b) Two processes on the one card over gloo against one process:
    # data parallel (stage 1 and GAN), FSDP and tensor parallel (stage 1).
    # (a)'s cli.train under torchrun (one process over NCCL) starts once the
    # ranks are past PARALLEL_CLI_AFTER and runs beside the rest of (b) and
    # (d); its checkpoint is then resumed by a single process.
    run_dir = os.path.join(ROOT, "outputs", "chip_smoke_torchrun")
    shutil.rmtree(run_dir, ignore_errors=True)
    # (e) and (f)'s one process (--worker subset-one) starts beside (a)'s
    # cli.train; the ranks run theirs after (d).
    shutil.rmtree(SUBSET_DIR, ignore_errors=True)
    for name in ("subset_one.json", "subset_one_recon.pt", "subset_recon.pt",
                 *(f"subset_rank{r}.json" for r in range(2))):
        if os.path.exists(os.path.join(PARALLEL_DIR, name)):
            os.remove(os.path.join(PARALLEL_DIR, name))
    t0 = time.time()
    with contextlib.ExitStack() as stack:
        def start_cli() -> tuple[Beside, Beside]:
            cli = stack.enter_context(Beside(_torchrun_cmd(1, [
                "-m", "deepl_project_tpu_torch.cli.train", "--variant", "large",
                "--data", "synthetic", "--batch_size", str(PARALLEL_CLI_BATCH),
                "--accum_steps", "2", "--num_epochs", "1",
                "--steps_per_epoch", str(PARALLEL_CLI_STEPS), "--log_every", "1",
                "--warmup_steps", "2", "--save_every_epochs", "1", "--output_dir", run_dir]),
                os.path.join(PARALLEL_DIR, "cli_train.log")))
            one = stack.enter_context(Beside(
                [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--worker", "subset-one"],
                os.path.join(PARALLEL_DIR, "subset_one.log")))
            return cli, one

        ref, ranks, (cli, one) = _dp_compare(start=start_cli)
        rc, text = cli.wait(timeout=600)
        one_rc, one_text = one.wait(timeout=600)
    if rc != 0:
        fail(f"parallel (a): torchrun cli.train exited {rc}:\n{text[-4000:]}")
    if one_rc != 0:
        fail(f"parallel (e): the one process (--worker subset-one) exited {one_rc}:\n"
             f"{one_text[-4000:]}")
    ckpt = os.path.join(run_dir, "checkpoints")
    run_rows = _history(run_dir)
    steps = list(range(1, PARALLEL_CLI_STEPS + 1))
    if [r["step"] for r in run_rows] != steps or not np.isfinite(
            [r["total"] for r in run_rows]).all():
        fail(f"parallel (a): torchrun cli.train rows {run_rows}")
    resumer = Trainer(load_config(ckpt).replace(attention_impl="auto_train"),
                      TrainerConfig(batch_size=PARALLEL_CLI_BATCH, accum_steps=2,
                                    output_dir=run_dir, weights=LossWeights(gan=0.0)),
                      device="cuda")
    if resumer.mesh is not None:
        fail("parallel (a): the single-process resume built a mesh")
    state, _ = resumer.maybe_resume(resumer.create_state())
    if state.step != steps[-1] or state.optimizer.count != steps[-1]:
        fail(f"parallel (a): resumed step {state.step}, optimizer count "
             f"{state.optimizer.count}; want {steps[-1]} and {steps[-1]}")
    log(f"parallel (a): torchrun --nproc_per_node 1 cli.train, {steps[-1]} steps at b"
        f"{PARALLEL_CLI_BATCH}, losses {[round(r['total'], 5) for r in run_rows]}, "
        f"checkpoint resumed by one process at step {steps[-1]} with its optimizer "
        f"({cli.s:.1f}s, beside (b)'s ranks from their {PARALLEL_CLI_AFTER} run on)")
    del state, resumer
    torch.cuda.empty_cache()
    shutil.rmtree(run_dir, ignore_errors=True)
    for name, step, mode, model in DP_RUNS:
        a = ref[step]
        for r, got in enumerate(ranks):
            b = got[name]
            lr = abs(b["total"] - a["total"]) / abs(a["total"])
            gr = abs(b["grad_norm"] - a["grad_norm"]) / a["grad_norm"]
            held = "not held in bf16, " if step == "gan" else ""
            loss_bar = PARALLEL_ADAPTIVE_RTOL if step == "gan_fp32" else PARALLEL_LOSS_RTOL
            if b["depths"] != a["depths"]:
                fail(f"parallel (b) {name}: depths {b['depths']}, one process {a['depths']}")
            log(f"parallel (b) {name} ({mode}, model {model}, depths {b['depths']}) rank {r}: "
                f"{b['rows']} of {PARALLEL_BATCH} rows, {b['sharded']} tensors split, loss "
                f"{b['total']:.6f} vs "
                f"one process {a['total']:.6f} (rel {lr:.2e}, {held}bound {loss_bar}), "
                f"grad norm {b['grad_norm']:.6f} vs {a['grad_norm']:.6f} (rel {gr:.2e}, {held}"
                f"bound {PARALLEL_GRAD_NORM_RTOL}), the whole parameters bit-identical across ranks "
                f"{b['params_bit_identical']} ({b['params_checked']} tensors), peak "
                f"{b['peak_gib']:.2f} GiB (one process {a['peak_gib']:.2f}), first step, "
                f"warm-up included, {b['ms']:.1f} ms (one process {a['ms']:.1f}), the run with "
                f"its build {b['s']:.1f}s (one process {a['s']:.1f}s), launches "
                f"{b['launches']}, flash at {b['flash_heads']} heads [{CARD}]")
            if step != "gan" and (lr > loss_bar or gr > PARALLEL_GRAD_NORM_RTOL):
                fail(f"parallel (b) {name} rank {r}: loss or grad norm off the one process's")
            if not b["params_bit_identical"]:
                fail(f"parallel (b) {name}: the ranks' whole parameters differ after the update")
            if (mode == "replicate") != (b["sharded"] == 0):
                fail(f"parallel (b) {name}: {b['sharded']} tensors split under {mode}")
            # Stage 2's sublayers (6 at full depth; 3 heads a rank under
            # tensor): forward, its recompute under remat, (GAN) the
            # discriminator update's fresh forward; one backward.
            bwd = "flash_attention_bwd_det" if b["deterministic"] else "flash_attention_bwd"
            sub = 2 * b["depths"][2]
            want = ({} if step == "gan_fp32" else
                    {"flash_attention_fwd": (2 if step == "stage1" else 3) * sub, bwd: sub})
            if b["deterministic"] != (name in PARALLEL_DETERMINISTIC):
                fail(f"parallel (b) {name} rank {r}: deterministic {b['deterministic']}")
            heads = [3] if mode == "tensor" else [6]
            if ({k: v for k, v in b["launches"].items() if k.startswith("flash")} != want
                    or b["flash_heads"] != (heads if want else [])
                    or (step == "gan_fp32" and b["launches"])):
                fail(f"parallel (b) {name} rank {r}: launches {b['launches']} at "
                     f"{b['flash_heads']} heads; flash {want} at {heads}")
            if step.startswith("gan"):
                w_rel = abs(b["adaptive_gan_weight"] - a["adaptive_gan_weight"]) / a[
                    "adaptive_gan_weight"]
                d_rel = abs(b["disc_loss"] - a["disc_loss"]) / abs(a["disc_loss"])
                log(f"parallel (b) {name} rank {r}: adaptive weight {b['adaptive_gan_weight']:.5f} "
                    f"vs {a['adaptive_gan_weight']:.5f} (rel {w_rel:.2e}, bound "
                    f"{PARALLEL_ADAPTIVE_RTOL}; clamp {PARALLEL_GAN_ADAPTIVE_MAX:g}), disc loss "
                    f"{b['disc_loss']:.6f} vs {a['disc_loss']:.6f} (rel {d_rel:.2e}, bound "
                    f"{PARALLEL_LOSS_RTOL}), floor {PARALLEL_GAN_FLOOR} decision "
                    f"{b['disc_update_scale']} vs {a['disc_update_scale']}")
                if (w_rel > PARALLEL_ADAPTIVE_RTOL or d_rel > PARALLEL_LOSS_RTOL
                        or a["adaptive_gan_weight"] >= PARALLEL_GAN_ADAPTIVE_MAX
                        or b["disc_update_scale"] != a["disc_update_scale"]):
                    fail(f"parallel (b) {name}: the adaptive weight, the disc loss or the "
                         "floor decision differs (or the weight sits at its clamp)")
            if b["launches"]:
                # The row of flash_attention_bwd.cu counts both of its launchers.
                PARALLEL_PATHS[f"parallel_gloo_rank{r}_{name}"] = {
                    k.removesuffix("_det"): v for k, v in b["launches"].items()}
            if name.endswith("_scan"):
                # The scan layout against the unrolled run of its placement.
                u = got[name[:-len("_scan")]]
                slr = abs(b["total"] - u["total"]) / abs(u["total"])
                sgr = abs(b["grad_norm"] - u["grad_norm"]) / u["grad_norm"]
                sq, wsum, where = _slice_gap(b["moments"], u["moments"])
                exact = name in PARALLEL_SCAN_BIT_EQUAL
                norm_bar, slice_bar = ((0.0, 0.0) if exact else
                                       (PARALLEL_SCAN_GRAD_NORM_RTOL, PARALLEL_SCAN_SLICE_RTOL))
                nondet = sorted(set(b["nondeterministic_ops"]) | set(u["nondeterministic_ops"]))
                log(f"parallel (b) {name} rank {r}: scan layout vs the unrolled {mode} run, "
                    f"both deterministic (ops without a deterministic version: "
                    f"{nondet or 'none'}): loss {b['total']!r} / {u['total']!r} (rel "
                    f"{slr:.2e}, bit-equal "
                    f"{b['total'] == u['total']}; held bit-equal), grad norm "
                    f"{b['grad_norm']!r} / {u['grad_norm']!r} (rel {sgr:.2e}, bit-equal "
                    f"{b['grad_norm'] == u['grad_norm']}; bound "
                    f"{norm_bar or 'bit-equal'}), first moments of {len(u['moments'])} "
                    f"tensors (each stack's slices as blocks): largest gap {sq:.2e} in the sum "
                    f"of squares, {wsum:.2e} of the norm in the position-weighted sum (at "
                    f"{where or 'none'}; bit-equal {sq == 0.0 and wsum == 0.0}; bound "
                    f"{slice_bar or 'bit-equal'}), "
                    f"{b['sharded']} / {u['sharded']} tensors split, peak {b['peak_gib']:.2f} / "
                    f"{u['peak_gib']:.2f} GiB, launches {b['launches']} / {u['launches']} "
                    f"[{CARD}]")
                if (b["total"] != u["total"] or sgr > norm_bar or max(sq, wsum) > slice_bar
                        or b["launches"] != u["launches"]):
                    fail(f"parallel (b) {name} rank {r}: the scan layout's step is off the "
                         f"unrolled {mode} step's")
    log(f"parallel (b): two processes over gloo took {time.time() - t0:.1f}s")

    # (d) cli.train in the scan layout under tensor parallelism, run by the
    # same two ranks after (b); its checkpoint's whole stacks read back.
    rows = _history(SCAN_TP_DIR)
    losses = [r["total"] for r in rows]
    if [r["step"] for r in rows] != list(range(1, SCAN_TP_STEPS + 1)) or not np.isfinite(
            losses).all():
        fail(f"parallel (d): cli.train rows {rows}")
    ckpt = os.path.join(SCAN_TP_DIR, "checkpoints")
    saved = restore_model_params(ckpt, map_location="cpu")
    stacked = {k: tuple(v.shape) for k, v in saved.items() if ".scan.block." in k}
    key = "encoder.stages.2.scan.block.attn.to_q.weight"
    if not (load_config(ckpt).scan_blocks and stacked and stacked.get(key) == (3, 384, 384)):
        fail(f"parallel (d): the checkpoint holds {len(stacked)} stacked keys, {key} "
             f"{stacked.get(key)}; want whole stacks (3, 384, 384)")
    want = {"flash_attention_fwd": 12 * SCAN_TP_STEPS, "flash_attention_bwd": 6 * SCAN_TP_STEPS}
    for r in range(2):
        with open(os.path.join(PARALLEL_DIR, f"scan_cli_rank{r}.json")) as f:
            got = json.load(f)
        log(f"parallel (d) rank {r}: cli.train --variant large --scan_blocks --param_sharding "
            f"tensor --mesh_model 2 --gradient_checkpointing --optimizer adafactor, "
            f"{SCAN_TP_STEPS} steps at global "
            f"b{SCAN_TP_BATCH}: losses {[round(v, 5) for v in losses]}, launches "
            f"{got['launches']} (want {want}: stage 2's 3 + 3 blocks on 3 of 6 heads, their "
            f"recompute and backward), peak {got['peak_gib']:.2f} GiB, {got['s']:.1f}s with "
            f"the start-up and the checkpoint (gloo on one card: not a speed) [{CARD}]")
        if got["launches"] != want:
            fail(f"parallel (d) rank {r}: launches {got['launches']} != {want}")
        PARALLEL_PATHS[f"parallel_scan_cli_tensor_rank{r}"] = got["launches"]
    log(f"parallel (d): {len(stacked)} whole stacks in the checkpoint (e.g. {key} "
        f"{stacked[key]})")
    del saved
    shutil.rmtree(SCAN_TP_DIR, ignore_errors=True)
    shutil.rmtree(os.path.join(ROOT, "outputs", "chip_smoke_parallel_b"), ignore_errors=True)
    _subset_and_dropout_check(one.s)

    # (c) The tensor-parallel attention sublayer at stage 2 (C=384, 6 heads),
    # its two head shards of model=2 in one process, against the whole one.
    from deepl_project_tpu_torch.ops.attention import AttentionRoPE

    b, n, h = FLASH_LOCAL_HEADS
    c = 2 * h * 64
    full = AttentionRoPE(c, 64, impl="auto", device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    with torch.no_grad():
        for name, p in full.named_parameters():
            scale = 1.0 if name.startswith("norm") and name.endswith("weight") else 0.0
            p.copy_(torch.randn(p.shape, generator=gen, device="cuda") * 0.05 + scale)
    side = int(n ** 0.5)
    x = torch.randn(b, c, side, side, generator=gen, device="cuda").to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    xf = x.permute(0, 2, 3, 1).reshape(b, n, c)
    shards = []
    for r in range(2):
        s = AttentionRoPE(c, 64, impl="auto", device="cuda")
        s.load_state_dict(full.state_dict())
        rows = slice(r * c // 2, (r + 1) * c // 2)
        with torch.no_grad():
            for lin in (s.to_q, s.to_k, s.to_v):
                lin.weight = torch.nn.Parameter(lin.weight[rows].clone())
            s.proj.weight = torch.nn.Parameter(s.proj.weight[:, rows].clone())
        shards.append(s)
    reset_launches()
    attn_mod.reset_route_counts()
    with torch.no_grad():
        got = sum(s.partial_heads(xf, side, side) for s in shards) + full.proj.bias.to(x.dtype)
        torch.cuda.synchronize()
        launches, by_shape = launches_by_name(), fla.launch_counts_by_shape()
        routes = attn_mod.route_counts()
        full.impl = "pallas"  # the whole sublayer on the composable route, flash core
        want_out = full(x).permute(0, 2, 3, 1).reshape(b, n, c)
    err = (got.float() - want_out.float()).abs().max().item()
    top = want_out.float().abs().max().item()
    log(f"parallel (c): two head shards (3 of 6 heads each) of the stage-2 sublayer at "
        f"(B, N, C)=({b}, {n}, {c}), summed, vs the whole sublayer: max_abs_err {err:.3e} "
        f"(rel {err / top:.3e}, bound {KERNEL_RTOL:.3e}); routes {routes}, launches "
        f"{launches}, by shape {by_shape}")
    if routes != {"local_heads": 2} or by_shape != {("flash_attention_fwd", n, h): 2}:
        fail(f"parallel (c): routes {routes}, flash launches by shape {by_shape}; want two "
             "local_heads routes and two flash forwards at 3 heads")
    if not err <= KERNEL_RTOL * top:
        fail("parallel (c): the head shards' sum differs from the whole sublayer")
    PARALLEL_PATHS["parallel_tensor_local_heads"] = launches
    # The flash kernels at the local heads (checked in phase kernels), timed
    # beside the 6-head call, their plain versions, SDPA and their bounds.
    import torch.nn.functional as F

    scale = 64 ** -0.5
    for shape in (FLASH_LOCAL_HEADS, FLASH_TRAIN):
        q, k, v, do = (torch.randn(*shape, 64, generator=gen, device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        o, lse = fla.flash_forward(q, k, v, scale)
        ms = [cuda_time_ms(lambda: fla.flash_forward(q, k, v, scale), 10),
              cuda_time_ms(lambda: fla.flash_backward(q, k, v, o, lse, do, scale), 10)]
        plain = [cuda_time_ms(lambda: fla.flash_forward_reference(q, k, v, scale), 3),
                 cuda_time_ms(lambda: fla.flash_backward_reference(q, k, v, o, lse, do, scale),
                              3)]
        hq = [t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*hq)
        library = [cuda_time_ms(lambda: F.scaled_dot_product_attention(*hq), 10),
                   cuda_time_ms(lambda: torch.autograd.grad(out, hq, do.transpose(1, 2),
                                                            retain_graph=True), 10)]
        bounds = [max(f / PEAK_BF16_FLOPS, nb / PEAK_HBM_BYTES) * 1e3
                  for f, nb in (flash_bound(nm, *shape) for nm in ("flash_attention_fwd",
                                                                    "flash_attention_bwd"))]
        for i, name in enumerate(("forward", "backward")):
            log(f"time parallel (c) flash {name} at (B, N, h)={shape}: kernel {ms[i]:.4f} ms, "
                f"plain {plain[i]:.4f} ms, SDPA {library[i]:.4f} ms, bound {bounds[i]:.4f} ms "
                f"[{CARD}]")
        del q, k, v, do, o, lse, hq, out


def _subset_and_dropout_check(one_s: float) -> None:
    """Phase parallel (e) and (f), from the files of (b)'s ranks and of the
    one process (--worker subset-one, which ran ``one_s`` seconds beside
    them)."""
    import shutil

    import numpy as np
    import torch

    with open(os.path.join(PARALLEL_DIR, "subset_one.json")) as f:
        one = json.load(f)
    ranks = []
    for r in range(2):
        with open(os.path.join(PARALLEL_DIR, f"subset_rank{r}.json")) as f:
            ranks.append(json.load(f))
    with open(os.path.join(PARALLEL_DIR, "ranks.log")) as f:
        said = "[trainer] rank 1 is outside the subset mesh" in f.read()

    # (e) cli.train on the subset mesh against one process's.
    want_rows, got_rows = _history(os.path.join(SUBSET_DIR, "one")), _history(
        os.path.join(SUBSET_DIR, "rank0"))
    steps = list(range(1, SUBSET_STEPS + 1))
    if [r["step"] for r in got_rows] != steps or [r["step"] for r in want_rows] != steps:
        fail(f"parallel (e): subset rows {got_rows}, one process's {want_rows}")
    bit = all(a[k] == b[k] for a, b in zip(want_rows, got_rows) for k in ("total", "grad_norm"))
    rel = [(abs(b["total"] - a["total"]) / abs(a["total"]),
            abs(b["grad_norm"] - a["grad_norm"]) / a["grad_norm"])
           for a, b in zip(want_rows, got_rows)]
    left, mesh_rank = ranks[1]["subset"], ranks[0]["subset"]
    bwd = "flash_attention_bwd_det"
    want = {"flash_attention_fwd": 2 * 2 * PARALLEL_STEP_DEPTHS[2] * SUBSET_STEPS,
            bwd: 2 * PARALLEL_STEP_DEPTHS[2] * SUBSET_STEPS}
    flash = {k: v for k, v in mesh_rank["launches"].items() if k.startswith("flash")}
    log(f"parallel (e): cli.train --batch_size {SUBSET_BATCH} on 2 ranks (subset mesh: data "
        f"gcd({SUBSET_BATCH}, 2) = 1, rank 0), depths {list(PARALLEL_STEP_DEPTHS)}, remat, "
        f"deterministic, {SUBSET_STEPS} steps: losses {[r['total'] for r in got_rows]} vs one "
        f"process {[r['total'] for r in want_rows]}, grad norms "
        f"{[r['grad_norm'] for r in got_rows]} vs {[r['grad_norm'] for r in want_rows]} "
        f"(rel {[f'{a:.2e}/{b:.2e}' for a, b in rel]}; bit-equal {bit}; bounds "
        f"{PARALLEL_LOSS_RTOL} / {PARALLEL_GRAD_NORM_RTOL}); rank 0 {mesh_rank['s']:.1f}s, "
        f"peak {mesh_rank['peak_gib']:.2f} GiB, launches {mesh_rank['launches']}, wrote "
        f"{len(mesh_rank['files'])} files; rank 1 left out (said so: {said}), "
        f"{left['s']:.1f}s, wrote {left['files']}, launches {left['launches']}; one process "
        f"{one['subset']['s']:.1f}s of its {one_s:.1f}s [{CARD}]")
    if any(a > PARALLEL_LOSS_RTOL or b > PARALLEL_GRAD_NORM_RTOL for a, b in rel):
        fail("parallel (e): the subset mesh's losses or grad norms are off one process's")
    if left["files"] or any(left["launches"].values()) or not said:
        fail("parallel (e): the rank left out of the subset mesh wrote files, launched "
             "kernels or did not say so")
    if flash != want or one["subset"]["launches"] != mesh_rank["launches"]:
        fail(f"parallel (e): flash launches {flash} (want {want}), one process's "
             f"{one['subset']['launches']}")
    PARALLEL_PATHS["parallel_subset_cli_rank0"] = {
        k.removesuffix("_det"): v for k, v in mesh_rank["launches"].items()}

    # (f) The tensor-parallel dropout forward against one process's.
    a, b = (ranks[r]["dropout"] for r in range(2))
    o = one["dropout"]
    got = torch.load(os.path.join(PARALLEL_DIR, "subset_recon.pt"))
    ref = torch.load(os.path.join(PARALLEL_DIR, "subset_one_recon.pt"))
    rel_l2 = float((got - ref).norm() / ref.norm())
    l1_rel = abs(a["l1"] - o["l1"]) / o["l1"]
    same_masks = a["masks"] == b["masks"] == o["masks"]
    dropped = np.array(a["dropped"])
    sizes = np.array([np.prod(s) for s in a["shapes"]])
    share = float((dropped * sizes).sum() / sizes.sum())
    log(f"parallel (f): tensor-parallel (model 2) train-mode forward at dropout {DROPOUT_P}, "
        f"b{DROPOUT_BATCH}, seed {DROPOUT_SEED}: {len(a['masks'])} masks, every one equal on "
        f"both ranks and to one process's {same_masks}, dropped share {share:.5f} (per mask "
        f"{dropped.min():.4f}-{dropped.max():.4f}); the ranks' reconstructions bit-identical "
        f"{a['recon_sha'] == b['recon_sha']}; L1 to the input {a['l1']:.6f} vs one process "
        f"{o['l1']:.6f} (rel {l1_rel:.2e}, bound {PARALLEL_LOSS_RTOL}), reconstruction rel L2 "
        f"{rel_l2:.3e}; routes {a['routes']} (one process {o['routes']}); forward "
        f"{a['ms']:.1f} ms a rank (one process {o['ms']:.1f}), launches {a['launches']}; at "
        f"{DROPOUT_TIMED} bf16: layers.dropout {ranks[0]['dropout_timed']['layers.dropout']:.3f} "
        f"ms over the two ranks' group, {one['dropout_timed']['layers.dropout']:.3f} ms alone, "
        f"F.dropout {one['dropout_timed']['F.dropout']:.3f} ms (host clock, with a sync) "
        f"[{CARD}]")
    if not same_masks or a["recon_sha"] != b["recon_sha"] or l1_rel > PARALLEL_LOSS_RTOL:
        fail("parallel (f): the ranks' masks or outputs differ, or they are off one "
             "process's")
    if abs(share - DROPOUT_P) > 0.01 or a["routes"].get("sublayer") or not a["routes"].get(
            "local_heads"):
        fail(f"parallel (f): dropped share {share} (p {DROPOUT_P}), routes {a['routes']}")
    for r in range(2):
        PARALLEL_PATHS[f"parallel_tp_dropout_rank{r}"] = ranks[r]["dropout"]["launches"]
    shutil.rmtree(SUBSET_DIR, ignore_errors=True)


def phase_gan_cut() -> None:
    """Not in the defaults: phase parallel (b)'s GAN step in bf16 and its
    fp32 twin (TF32 off) with the model cut to PARALLEL_STEP_DEPTHS, two
    gloo ranks against one process at the same depths. Logs how far the
    ranks' adaptive weight, loss, grad norm and disc loss lie from one
    process's in each dtype; fails only where the fp32 twin misses (b)'s
    bars (in bf16 they are the reading)."""
    os.makedirs(PARALLEL_DIR, exist_ok=True)
    ref, ranks, _ = _dp_compare(gan_cut=True)
    for name, step, _, _ in GAN_CUT_RUNS:
        a = ref[step]
        for r, got in enumerate(ranks):
            b = got[name]
            rel = {k: abs(b[k] - a[k]) / abs(a[k])
                   for k in ("adaptive_gan_weight", "total", "grad_norm", "disc_loss")}
            log(f"gan_cut {name} depths {b['depths']} rank {r}: adaptive weight "
                f"{b['adaptive_gan_weight']:.5f} vs one process {a['adaptive_gan_weight']:.5f} "
                f"(rel {rel['adaptive_gan_weight']:.2e}; (b)'s bar {PARALLEL_ADAPTIVE_RTOL}), "
                f"loss {b['total']:.6f} vs {a['total']:.6f} (rel {rel['total']:.2e}), grad norm "
                f"{b['grad_norm']:.6f} vs {a['grad_norm']:.6f} (rel {rel['grad_norm']:.2e}; "
                f"bar {PARALLEL_GRAD_NORM_RTOL}), disc loss {b['disc_loss']:.6f} vs "
                f"{a['disc_loss']:.6f} (rel {rel['disc_loss']:.2e}; bar {PARALLEL_LOSS_RTOL}), "
                f"floor decision {b['disc_update_scale']} vs {a['disc_update_scale']} [{CARD}]")
            if step == "gan_fp32" and (rel["adaptive_gan_weight"] > PARALLEL_ADAPTIVE_RTOL
                                       or rel["total"] > PARALLEL_ADAPTIVE_RTOL
                                       or rel["grad_norm"] > PARALLEL_GRAD_NORM_RTOL
                                       or rel["disc_loss"] > PARALLEL_LOSS_RTOL):
                fail(f"gan_cut {name} rank {r}: the fp32 twin is off the one process's step")


# -- phase context -------------------------------------------------------------
def _context_inputs(what: str, shape=CONTEXT_RING, res: int = CONTEXT_RES):
    """Phase context's inputs, made from seeds on the card identically in
    every process: 'ring' q, k, v, dO at ``shape`` (B, N, heads); 'images' the forward's
    CONTEXT_FWD_BATCH images and 'batch' the step's CONTEXT_STEP_BATCH ([B, H,
    W, 3] in [0, 1], shapes at ``res``); 'noise' the step's global latent
    noise [B, 32, H/16, W/16]; 'lpips' the random VGG."""
    import numpy as np
    import torch

    from deepl_project_tpu_torch.data import make_dataset
    from deepl_project_tpu_torch.losses.lpips import init_lpips_params

    gen = torch.Generator(device="cuda").manual_seed(21)
    if what == "ring":
        return [torch.randn(*shape, 64, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(4)]
    if what == "lpips":
        return init_lpips_params(gen, "cuda")
    if what == "noise":
        side = res // 16
        return torch.randn(CONTEXT_STEP_BATCH, 32, side, side, generator=gen, device="cuda")
    n = CONTEXT_FWD_BATCH if what == "images" else CONTEXT_STEP_BATCH
    return np.stack(list(make_dataset("shapes", resolution=res, num_samples=n,
                                      seed=31 if what == "images" else 32)))


def _context_model(**kw):
    """Large f16d32 at CONTEXT_DEPTHS from seed 0 (fp32 parameters, bf16
    compute unless ``dtype`` says otherwise), the step's remat 'none'; ``kw``
    over these."""
    from deepl_project_tpu_torch import create_transvae

    return create_transvae("large", 16, 32, device="cuda",
                           **{"seed": 0, "remat": True, "remat_policy": "none",
                              "depths": CONTEXT_DEPTHS, **kw})


def _context_step(model, batch, placement=None, update: bool = True,
                  res: int = CONTEXT_RES) -> dict:
    """Phase context (c)'s step on ``model``: compute_grads of ``batch`` (L1 +
    KL + LPIPS on the random VGG, the handed-in noise), the grad norm and,
    with ``update``, an AdamW update; loss, grad norm, ms, peak and
    launches, and under a placement the fingerprints of the updated
    parameters."""
    import torch

    from deepl_project_tpu_torch.losses import LossWeights
    from deepl_project_tpu_torch.parallel import collectives as col
    from deepl_project_tpu_torch.parallel.ring_attention import reset_step_counts, step_counts
    from deepl_project_tpu_torch.training.optim import make_optimizer
    from deepl_project_tpu_torch.training.train_step import (compute_grads, global_norm,
                                                             named_trainables)

    named = named_trainables(model)
    opt = (make_optimizer(named, learning_rate=1e-4, warmup_steps=0, placement=placement)
           if update else None)
    weights = LossWeights(l1=1.0, lpips=1.0, kl=1e-8, vf=0.0, gan=0.0)
    lpips, noise = _context_inputs("lpips"), _context_inputs("noise", res=res)
    model.train()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reset_step_counts()
    col.reset_staged_counts()
    t0 = time.perf_counter()
    grads, m = compute_grads(model, batch, weights, lpips, noise=[noise], placement=placement)
    norm = global_norm(grads, placement, [n for n, _ in named])
    if update:
        opt.step(grads)
    del grads
    torch.cuda.synchronize()
    row = {"ms": (time.perf_counter() - t0) * 1e3, "launches": launches_by_name(),
           "ring_steps": step_counts(), "staged": col.staged_counts(),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "total": float(m["total"]), "grad_norm": float(norm),
           "lpips": float(m["lpips"]), "applied": update and bool(opt.last_finite)}
    if placement is not None and update:
        row["fingerprint"] = _fingerprint([p for _, p in named])
    return row


@contextlib.contextmanager
def _planted_zero_halo():
    """For the block, every row fetch of the model (the convs' halos, the
    fused upsample, the int8 convs) replaces the rows it takes from other
    ranks by zeros: each convolution then sees its neighbour's edge as the
    image's (the planted fault)."""
    import torch

    import torch.distributed as dist

    from deepl_project_tpu_torch.ops import resample as resample_mod
    from deepl_project_tpu_torch.parallel import halo as halo_mod

    # Every row exchange (halo.exchange_rows, which the int8 conv calls, the
    # convs' and the pool's fetches, the literal down DC path's) goes
    # through fetch_rows: the rows it takes from other ranks become zeros.
    fetch = halo_mod.fetch_rows

    def zeroed(x, held, need, group_):
        xp = fetch(x, held, need, group_)
        rank = dist.get_rank(group_)
        (lo, hi), (a, b) = held[rank], need[rank]
        keep = torch.zeros(b - a, 1, dtype=xp.dtype, device=xp.device)
        keep[max(lo, a) - a:max(min(hi, b) - a, 0)] = 1
        return xp * keep

    halo_mod.fetch_rows = resample_mod.fetch_rows = zeroed
    try:
        yield
    finally:
        halo_mod.fetch_rows = resample_mod.fetch_rows = fetch


def _halo_convs(mesh) -> dict:
    """Each kind of halo conv of the model under ``mesh``'s context group on
    this rank's rows of a seeded CONTEXT_HALO_MAP map (identical on every
    rank), against the whole map's conv sliced to those rows: the 3x3
    stride-1 conv, the stride-2 downsample conv, the fused upsample (its
    transposed conv's halo), LPIPS's VGG conv (``conv2d_rows``), in fp32
    without TF32, forward and input gradient for a seeded cotangent; the
    int8 ``QConv2d`` on the bf16 map, forward. {name: [max |err|, max
    |whole|, max |grad err|, max |whole grad|]}; the int8 conv's errors
    must be exactly 0."""
    import torch

    from deepl_project_tpu_torch.ops.layers import Conv2d, init_conv_
    from deepl_project_tpu_torch.ops.quant import QConv2d, quantize_weight
    from deepl_project_tpu_torch.ops.resample import Upsample
    from deepl_project_tpu_torch.parallel import context_parallel
    from deepl_project_tpu_torch.parallel.context import split_rows
    from deepl_project_tpu_torch.parallel.halo import conv2d_rows

    group = mesh.get_group("context")
    rank, size = torch.distributed.get_rank(group), torch.distributed.get_world_size(group)
    gen = torch.Generator(device="cuda").manual_seed(51)
    b, c, h, w = CONTEXT_HALO_MAP
    whole = torch.randn(b, c, h, w, generator=gen, device="cuda")
    mods = {"conv3x3": Conv2d(c, c, 3, padding=1, device="cuda"),
            "downsample_stride2": Conv2d(c, c, 3, stride=2, padding=1, device="cuda"),
            "upsample_fused": Upsample(c, c, device="cuda")}
    for m in mods.values():
        for conv in m.modules():
            if isinstance(conv, torch.nn.Conv2d):
                init_conv_(conv, gen)
    vgg_w = torch.randn(c, c, 3, 3, generator=gen, device="cuda") * (2.0 / (9 * c)) ** 0.5
    vgg_b = torch.randn(c, generator=gen, device="cuda") * 0.1

    def lpips_vgg(x):
        from deepl_project_tpu_torch.parallel import context as cp

        st = cp.current()
        if st is None:
            return torch.nn.functional.conv2d(x, vgg_w, vgg_b, padding=1)
        return conv2d_rows(x, vgg_w, vgg_b, 1, (1, 1), 1, st)

    mods["lpips_vgg"] = lpips_vgg
    out = {}
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, m in mods.items():
            x = whole.clone().requires_grad_(True)
            want = m(x)
            cot = torch.randn(want.shape, generator=gen, device="cuda")
            (gw,) = torch.autograd.grad((want * cot).sum(), x)
            local = split_rows(whole, rank, size, 2).requires_grad_(True)
            with context_parallel(mesh):
                got = m(local)
            (gl,) = torch.autograd.grad((got * split_rows(cot, rank, size, 2)).sum(), local)
            out[name] = [(got - split_rows(want.detach(), rank, size, 2)).abs().max().item(),
                         want.abs().max().item(),
                         (gl - split_rows(gw, rank, size, 2)).abs().max().item(),
                         gw.abs().max().item()]
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    q = QConv2d(c, c, 3, device="cuda")
    wq, ws = quantize_weight(torch.randn(c, 3, 3, c, generator=gen, device="cuda"), axis=0)
    with torch.no_grad():
        q.kernel_q.copy_(wq)
        q.kernel_scale.copy_(ws)
        q.act_scale.fill_(float(whole.abs().max()) / 127)
        q.bias.normal_(generator=gen)
        xb = whole.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        want = split_rows(q(xb), rank, size, 2)
        with context_parallel(mesh):
            got = q(split_rows(xb, rank, size, 2))
    out["int8_qconv"] = [(got.float() - want.float()).abs().max().item(),
                         want.float().abs().max().item(), 0.0, 0.0]
    return out


def _context_gan(mesh=None, dtype: str = "bfloat16", batch: int = CONTEXT_GAN_BATCH,
                 res: int = CONTEXT_GAN_RES) -> dict:
    """Phase context (d)'s GAN step in ``dtype`` (fp32: TF32 off) on the
    first ``batch`` images at ``res``: under ``mesh``'s context group
    on this rank's rows, else on one process. Its metrics, vf_proj.kernel's
    gradient as the step applied it (fp32, CPU), ms, peak, launches, ring
    steps, staged bytes; under a mesh the fingerprints of both models'
    parameters after the update."""
    import numpy as np
    import torch

    from deepl_project_tpu_torch.data import make_dataset
    from deepl_project_tpu_torch.losses import LossWeights, make_self_perceptual
    from deepl_project_tpu_torch.losses.teachers import make_stub_teacher
    from deepl_project_tpu_torch.models.discriminator import PatchDiscriminator, init_disc_weights
    from deepl_project_tpu_torch.parallel import Placement, shard_params, shard_rows
    from deepl_project_tpu_torch.parallel import collectives as col
    from deepl_project_tpu_torch.parallel.ring_attention import reset_step_counts, step_counts
    from deepl_project_tpu_torch.training.optim import make_optimizer
    from deepl_project_tpu_torch.training.train_step import (TrainState, make_gan_train_step,
                                                             make_vf_proj_params,
                                                             named_trainables)

    gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)  # noqa: E731
    model = _context_model(context_axis="context", attention_impl="auto_train", dtype=dtype)
    twin = _context_model(context_axis="context", seed=1, remat=False, dtype=dtype)
    teacher = make_stub_teacher(device="cuda")
    vf_proj = make_vf_proj_params(32, teacher.feature_dim, gen(41), device="cuda")
    disc = PatchDiscriminator(dtype=getattr(torch, dtype), device="cuda")
    init_disc_weights(disc, gen(42))
    placement = disc_placement = None
    if mesh is not None:
        placement = shard_params(mesh, model, "replicate")
        shard_params(mesh, vf_proj, "replicate", prefix="vf_proj.", placement=placement)
        disc_placement = Placement(mesh)
    named = named_trainables(model, vf_proj)
    g = TrainState(0, model, make_optimizer(named, learning_rate=1e-4, warmup_steps=0,
                                            placement=placement), vf_proj=vf_proj)
    d = TrainState(0, disc, make_optimizer(disc.named_parameters(), learning_rate=1e-4,
                                           warmup_steps=0, placement=disc_placement))
    kept, apply = {}, g.optimizer.step

    def keep(grads):  # the gradients the step hands its optimizer
        kept["vf_kernel"] = grads[[n for n, _ in named].index("vf_proj.kernel")].float().cpu()
        return apply(grads)

    g.optimizer.step = keep
    step = make_gan_train_step(
        LossWeights(l1=1.0, lpips=1.0, kl=1e-8, vf=0.1, gan=0.1), adaptive_weight=True,
        adaptive_max=PARALLEL_GAN_ADAPTIVE_MAX, disc_loss_floor=CONTEXT_GAN_FLOOR,
        r1_gamma=CONTEXT_GAN_R1, seed=0, teacher_fn=teacher,
        perceptual_fn=make_self_perceptual(twin), placement=placement,
        disc_placement=disc_placement)
    images = np.stack(list(make_dataset("shapes", resolution=res,
                                        num_samples=CONTEXT_GAN_BATCH, seed=33)))[:batch]
    batch = torch.as_tensor(shard_rows(mesh, images)).to("cuda")
    model.train()
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    if dtype == "float32":
        # The fp32 twin is the held reading: no TF32, and cuDNN's
        # deterministic algorithms, so that a run's own noise does not enter
        # the one-process / two-rank gap (the PatchGAN's instance norms
        # amplify rounding, PERF.md section 6, PR 18).
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reset_step_counts()
    col.reset_staged_counts()
    t0 = time.perf_counter()
    try:
        m = step(g, d, batch)
        torch.cuda.synchronize()
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = saved
        del g.optimizer.step  # the wrapper's cycle would keep the models alive
    row = {"ms": (time.perf_counter() - t0) * 1e3, "launches": launches_by_name(),
           "ring_steps": step_counts(), "staged": col.staged_counts(),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "rows": int(batch.shape[1]),
           "vf_kernel": kept["vf_kernel"], **{k: float(v) for k, v in m.items()}}
    if mesh is not None:
        row["fingerprint_gen"] = _fingerprint([p for _, p in named])
        row["fingerprint_disc"] = _fingerprint(list(disc.parameters()))
    return row


def _context_int8(mesh=None) -> tuple:
    """Phase context (e) under ``mesh``'s context group on this rank's rows
    of the forward's image, else on one process: the fp32 model's
    calibration without TF32 ({module: {site: amax}}), then the bf16
    model's ``quantize_model`` (scope CONTEXT_INT8_SCOPE, calibrated on the
    same rows) and its no-grad forward, timed with its launches, ring steps,
    routes, norm launches, staged bytes and peak. (row, sigmoid of the
    reconstruction in fp32 (this rank's rows), amax)."""
    import torch

    from deepl_project_tpu_torch.ops import attention as attn_mod
    from deepl_project_tpu_torch.parallel import collectives as col
    from deepl_project_tpu_torch.parallel import context_parallel, shard_rows
    from deepl_project_tpu_torch.parallel.ring_attention import reset_step_counts, step_counts
    from deepl_project_tpu_torch.quantize import calibrate_amax, quantize_model

    rows = shard_rows(mesh, _context_inputs("images"))
    ambient = (lambda: context_parallel(mesh)) if mesh is not None else contextlib.nullcontext
    t0 = time.perf_counter()
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        f32 = _context_model(context_axis="context", dtype="float32").eval()
        with ambient():
            amax = calibrate_amax(f32, [rows])
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    del f32
    torch.cuda.empty_cache()
    calib_s = time.perf_counter() - t0
    model = _context_model(context_axis="context", attention_impl="auto_train").eval()
    with ambient():
        qmodel = quantize_model(model, [rows], CONTEXT_INT8_SCOPE)
    del model
    torch.cuda.empty_cache()
    x = torch.as_tensor(rows).to("cuda").permute(0, 3, 1, 2).to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reset_step_counts()
    col.reset_staged_counts()
    attn_mod.reset_route_counts()
    t1 = time.perf_counter()
    with torch.no_grad(), ambient():
        recon = torch.sigmoid(qmodel(x)[0].float())
    torch.cuda.synchronize()
    row = {"ms": (time.perf_counter() - t1) * 1e3, "launches": launches_by_name(),
           "ring_steps": step_counts(), "routes": attn_mod.route_counts(),
           "norm_launches": norm_launches(), "staged": col.staged_counts(),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "rows": int(x.shape[2]),
           "calibration_s": calib_s, "quantized": qmodel.config.quant_scope}
    amax = {n: {k: float(v) for k, v in sites.items()} for n, sites in amax.items()}
    return row, recon, amax


def _same_on_every_rank(fp) -> tuple[bool, int]:
    """Whether the fingerprints ``fp`` ([n, 2], ``_fingerprint``) agree on
    every rank, and n."""
    import torch
    import torch.distributed as dist

    lo, hi = fp.clone(), fp.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    return bool(torch.equal(lo, hi)), int(fp.shape[0])


def context_worker() -> None:
    """A rank of phase context, started by torchrun: two processes on the
    one card over gloo, a context axis of 2 (data 1). (a) the ring alone,
    (b) the no-grad forward, the halo convs, (c) the stage-1 step, (d) the
    GAN step, (e) the int8 model; results in CONTEXT_DIR/rank<r>.json, the
    gathered reconstructions in CONTEXT_DIR/recon_context.pt and
    recon_int8_context.pt, (d)'s vf_proj gradient in vf_kernel_context.pt;
    any failure exits non-zero."""
    import torch
    import torch.distributed as dist

    from deepl_project_tpu_torch.ops import attention as attn_mod
    from deepl_project_tpu_torch.ops.hopper.flash_attention import (flash_backward,
                                                                    flash_forward)
    from deepl_project_tpu_torch.parallel import (context_parallel, create_mesh,
                                                  initialize_multihost, shard_params,
                                                  shard_rows)
    from deepl_project_tpu_torch.parallel import collectives as col
    from deepl_project_tpu_torch.parallel.ring_attention import (
        reset_step_counts, ring_attention, ring_attention_reference, step_counts)

    initialize_multihost(backend="gloo", device="cuda:0")
    rank = dist.get_rank()
    mesh = create_mesh(data=1, context=2)
    group = mesh.get_group("context")
    out = {"staged_backend": dist.get_backend(group)}

    def counts():
        return {"launches": launches_by_name(), "ring_steps": step_counts(),
                "staged": col.staged_counts()}

    def reset():
        reset_launches()
        reset_step_counts()
        col.reset_staged_counts()

    # (a) The ring alone, against one process's flash attention on the whole
    # N and against the plain ring: at stage 2's 1024px b1 shape (timed) and
    # at each stage's b2 step shape (CONTEXT_RING_SHAPES' local N, twice).
    scale = 64 ** -0.5
    mine = lambda t: t.chunk(2, 1)[rank].contiguous()  # noqa: E731
    err = lambda a, b: [(a.float() - b.float()).abs().max().item(),  # noqa: E731
                        b.float().abs().max().item()]
    out["ring"] = {}
    for shape in CONTEXT_RING_CHECKED:
        q, k, v, do = _context_inputs("ring", shape)
        o_ref, lse = flash_forward(q, k, v, scale)
        g_ref = flash_backward(q, k, v, o_ref, lse, do, scale)
        local = [mine(t).requires_grad_(True) for t in (q, k, v)]
        do = mine(do)
        reset()
        o = ring_attention(*local, scale, group)
        grads = torch.autograd.grad(o, local, do)
        torch.cuda.synchronize()
        ring = {"counts": counts()}
        ring["vs_flash"] = {"o": err(o, mine(o_ref)),
                            **{n: err(g, mine(w)) for n, g, w in zip("qkv", grads, g_ref)}}
        ref_o = ring_attention_reference(*[t.detach() for t in local], scale, group)
        plain = [t.detach().clone().requires_grad_(True) for t in local]
        plain_o = ring_attention(*plain, scale, group, plain=True)
        plain_g = torch.autograd.grad(plain_o, plain, do)
        ring["vs_plain"] = {"o": err(o, ref_o), "o_plain_partials": err(o, plain_o),
                            **{n: err(g, w) for n, g, w in zip("qkv", grads, plain_g)}}
        del q, k, v, o_ref, lse, g_ref, plain, plain_o, plain_g, ref_o, grads, o

        def fwd_bwd():
            out_ = ring_attention(*local, scale, group)
            torch.autograd.grad(out_, local, do)

        if shape == CONTEXT_RING:
            dist.barrier()
            ring["ms"] = cuda_time_ms(lambda: ring_attention(*local, scale, group), 5, 1)
            dist.barrier()
            ring["fwd_bwd_ms"] = cuda_time_ms(fwd_bwd, 3, 1)
        out["ring"][str(shape)] = ring
        del local, do
        torch.cuda.empty_cache()

    # (b) The no-grad forward at 1024px, this rank's rows.
    model = _context_model(context_axis="context", attention_impl="auto_train")
    x = torch.as_tensor(shard_rows(mesh, _context_inputs("images"))).to("cuda")
    x = x.permute(0, 3, 1, 2).to(torch.bfloat16)
    dist.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    attn_mod.reset_route_counts()
    t0 = time.perf_counter()
    with torch.no_grad(), context_parallel(mesh):
        recon = model.eval()(x)[0]
    torch.cuda.synchronize()
    out["forward"] = {"ms": (time.perf_counter() - t0) * 1e3, **counts(),
                      "routes": attn_mod.route_counts(),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                      "norm_launches": norm_launches(), "rows": int(x.shape[2])}
    whole = col.all_gather_cat(torch.sigmoid(recon.float()), 2, group)
    if rank == 0:
        torch.save(whole.cpu(), os.path.join(CONTEXT_DIR, "recon_context.pt"))
    del recon, whole

    # (b) again on the scan layout: the seed's weights stacked (scan_blocks
    # draws the unrolled model's values), the same rows.
    scan = _context_model(context_axis="context", attention_impl="auto_train",
                          scan_blocks=True)
    dist.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    attn_mod.reset_route_counts()
    t0 = time.perf_counter()
    with torch.no_grad(), context_parallel(mesh):
        recon = scan.eval()(x)[0]
    torch.cuda.synchronize()
    out["forward_scan"] = {"ms": (time.perf_counter() - t0) * 1e3, **counts(),
                           "routes": attn_mod.route_counts(),
                           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                           "norm_launches": norm_launches()}
    whole = col.all_gather_cat(torch.sigmoid(recon.float()), 2, group)
    if rank == 0:
        torch.save(whole.cpu(), os.path.join(CONTEXT_DIR, "recon_context_scan.pt"))
    del recon, whole, x, scan
    torch.cuda.empty_cache()

    # Each kind of halo conv against the whole map's, then with the halo
    # rows zeroed (which must fail the same bars).
    t0 = time.time()
    out["halo"] = _halo_convs(mesh)
    with _planted_zero_halo():
        out["halo_zeroed"] = _halo_convs(mesh)
    out["halo_s"] = time.time() - t0
    torch.cuda.empty_cache()

    # (c) One stage-1 step at global b2, this rank's rows of each image.
    placement = shard_params(mesh, model, "replicate")
    batch = torch.as_tensor(shard_rows(mesh, _context_inputs("batch"))).to("cuda")
    dist.barrier()
    row = _context_step(model, batch, placement)
    fp = row.pop("fingerprint")
    row["params_bit_identical"], row["params_checked"] = _same_on_every_rank(fp)
    row["rows"] = int(batch.shape[1])
    out["step"] = row
    del model, batch, placement
    torch.cuda.empty_cache()

    # (g) At CONTEXT_G_RES, whose maps split unevenly from stage 4 on: the b1
    # forward and the b2 step, from the seed's weights.
    model = _context_model(context_axis="context", attention_impl="auto_train")
    x = torch.as_tensor(shard_rows(mesh, _context_inputs("images", res=CONTEXT_G_RES)))
    x = x.to("cuda").permute(0, 3, 1, 2).to(torch.bfloat16)
    dist.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    attn_mod.reset_route_counts()
    t0 = time.perf_counter()
    with torch.no_grad(), context_parallel(mesh):
        recon = model.eval()(x)[0]
    torch.cuda.synchronize()
    out["g_forward"] = {"ms": (time.perf_counter() - t0) * 1e3, **counts(),
                        "routes": attn_mod.route_counts(), "by_shape": flash_by_shape(),
                        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                        "rows": int(x.shape[2])}
    whole = col.all_gather_cat(torch.sigmoid(recon.float()), 2, group)
    if rank == 0:
        torch.save(whole.cpu(), os.path.join(CONTEXT_DIR, "recon_g_context.pt"))
    del recon, whole, x
    placement = shard_params(mesh, model, "replicate")
    batch = torch.as_tensor(shard_rows(mesh, _context_inputs("batch", res=CONTEXT_G_RES)))
    dist.barrier()
    row = _context_step(model, batch.to("cuda"), placement, res=CONTEXT_G_RES)
    row["by_shape"] = flash_by_shape()
    fp = row.pop("fingerprint")
    row["params_bit_identical"], row["params_checked"] = _same_on_every_rank(fp)
    out["g_step"] = row
    del model, batch, placement
    torch.cuda.empty_cache()

    # (d) One GAN step: bf16 at CONTEXT_GAN_RES b2, its fp32 twin.
    for key, dtype, b, res in CONTEXT_GAN_RUNS:
        dist.barrier()
        t0 = time.time()
        row = _context_gan(mesh, dtype, b, res)
        for which in ("gen", "disc"):
            fp = row.pop(f"fingerprint_{which}")
            row[f"{which}_bit_identical"], row[f"{which}_checked"] = _same_on_every_rank(fp)
        vf_kernel = row.pop("vf_kernel")
        if rank == 0:
            torch.save(vf_kernel, os.path.join(CONTEXT_DIR, f"vf_kernel_{key}.pt"))
        row["s"] = time.time() - t0
        out[key] = row
        torch.cuda.empty_cache()

    # (e) The int8 model at CONTEXT_RES b1.
    dist.barrier()
    t0 = time.time()
    row, recon, amax = _context_int8(mesh)
    whole = col.all_gather_cat(recon, 2, group)
    if rank == 0:
        torch.save(whole.cpu(), os.path.join(CONTEXT_DIR, "recon_int8_context.pt"))
    del recon, whole
    row["s"], row["amax"] = time.time() - t0, amax
    out["int8"] = row
    with open(os.path.join(CONTEXT_DIR, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _ring_partials_check(shape, gen, backward: bool, keys=None) -> dict:
    """The flash kernels as one rank's two-step ring runs them, in one
    process at the local ``shape`` (B, N_local, heads): the local queries
    against two chunks of ``keys`` keys (default N_local each; an uneven
    split's chunks differ). Each step's partial (o, lse) from
    the forward kernel and from its plain version on the same inputs; with
    ``backward``, the merged o and lse (of the kernels' partials) handed to
    the backward kernel and to its plain version at each step, as the ring's
    backward hands them (an o and lse the kernel did not make itself).
    {output: [max_abs_err, max |plain|]} over both steps."""
    import torch

    from deepl_project_tpu_torch.ops.hopper import flash_attention as fla
    from deepl_project_tpu_torch.parallel.ring_attention import _merge

    scale, errs = 64 ** -0.5, {}
    b, n, h = shape
    q, do = (torch.randn(*shape, 64, generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    kv = [torch.randn(b, nk, h, 64, generator=gen, device="cuda").to(torch.bfloat16)
          for nk in (keys or (n, n)) for _ in range(2)]

    def hold(name, got, want):
        e = (got.float() - want.float()).abs().max().item()
        top = want.float().abs().max().item()
        old = errs.get(name, [0.0, 0.0])
        errs[name] = [max(old[0], e), max(old[1], top)]

    o_acc = lse_acc = None
    for k, v in (kv[:2], kv[2:]):
        o_i, lse_i = fla.flash_forward(q, k, v, scale)
        o_p, lse_p = fla.flash_forward_reference(q, k, v, scale)
        hold("o", o_i, o_p)
        hold("lse", lse_i, lse_p)
        o_acc, lse_acc = ((o_i.float(), lse_i) if o_acc is None
                          else _merge(o_acc, lse_acc, o_i, lse_i))
        del o_p, lse_p
    if backward:
        o, lse = o_acc.to(q.dtype), lse_acc.contiguous()
        for k, v in (kv[:2], kv[2:]):
            for name, got, want in zip(("dq", "dk", "dv"),
                                       fla.flash_backward(q, k, v, o, lse, do, scale),
                                       fla.flash_backward_reference(q, k, v, o, lse, do, scale)):
                hold(name, got, want)
    return errs


def _ring_kernel_rows() -> dict:
    """The flash kernels at the ring's local shapes (each step: the local
    queries against one visiting chunk of as many keys; (c)'s, (d)'s and
    (g)'s, whose token counts are no multiple of 64 and whose last chunks
    differ in length, CONTEXT_G_RING):
    held against their plain versions as the ring runs them
    (:func:`_ring_partials_check`; the forward also at the b1 forward's
    shapes, which (e) runs too), failing beyond KERNEL_RTOL of
    max, then timed beside their plain versions, SDPA on the same local
    shape and their bounds."""
    import torch
    import torch.nn.functional as F

    from deepl_project_tpu_torch.ops.hopper import flash_attention as fla

    gen = torch.Generator(device="cuda").manual_seed(4)
    scale, rows = 64 ** -0.5, {}
    ragged = dict(CONTEXT_G_RING)
    for shape in CONTEXT_RING_SHAPES + CONTEXT_GAN_RING_SHAPES + tuple(ragged):
        checks = [(shape, _ring_partials_check(shape, gen, backward=True,
                                               keys=ragged.get(shape)))]
        if CONTEXT_FWD_BATCH != shape[0] and shape in CONTEXT_RING_SHAPES:
            b1 = (CONTEXT_FWD_BATCH,) + shape[1:]
            checks.append((b1, _ring_partials_check(b1, gen, backward=False)))
        for at, errs in checks:
            for name, (e, top) in errs.items():
                log(f"context ring partial at {at} {name}: kernel vs plain max_abs_err {e:.3e} "
                    f"(rel {e / top:.3e}, bound {KERNEL_RTOL:.3e})")
                if not e <= KERNEL_RTOL * top:
                    fail(f"context: the flash kernels' ring partial {name} at {at} differs "
                         f"from the plain version")
        errs = checks[0][1]
        q, k, v, do = (torch.randn(*shape, 64, generator=gen, device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        o, lse = fla.flash_forward(q, k, v, scale)
        hq = [t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v)]
        sd = F.scaled_dot_product_attention(*hq)
        for name, kern, plain, lib, outs in (
                ("flash_attention_fwd", lambda: fla.flash_forward(q, k, v, scale),
                 lambda: fla.flash_forward_reference(q, k, v, scale),
                 lambda: F.scaled_dot_product_attention(*hq), ("o", "lse")),
                ("flash_attention_bwd", lambda: fla.flash_backward(q, k, v, o, lse, do, scale),
                 lambda: fla.flash_backward_reference(q, k, v, o, lse, do, scale),
                 lambda: torch.autograd.grad(sd, hq, do.transpose(1, 2), retain_graph=True),
                 ("dq", "dk", "dv"))):
            flops, nbytes = flash_bound(name, *shape)
            rows[f"{name} {shape}"] = {
                "ms": cuda_time_ms(kern, 10), "plain_ms": cuda_time_ms(plain, 2, 1),
                "library_ms": cuda_time_ms(lib, 10),
                "bound_ms": max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3,
                "bound_by": ("operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_HBM_BYTES
                             else "bytes"),
                "max_abs_err": max(errs[n][0] for n in outs),
                "max_abs_err_by_output": {n: errs[n] for n in outs}}
        del q, k, v, do, o, lse, hq, sd
        torch.cuda.empty_cache()
    return rows


def _context_probe(probe: Beside) -> list:
    """What gloo does with point-to-point transfers of CUDA tensors between
    two ranks on the card (accepted or refused, with the message): the
    reason the ring and the halo stage through host memory there. ``probe``:
    this script's ``--worker refusal-gloo-p2p`` on two ranks."""
    try:
        _, text = probe.wait(timeout=120)
    except subprocess.TimeoutExpired:
        with open(probe.log_path) as f:
            text = f"TIMEOUT after 120 s: {f.read()[-2000:]}"
    lines = sorted({ln.strip()[ln.find("RESULT"):][:400] for ln in text.splitlines()
                    if "RESULT" in ln or "TIMEOUT" in ln})
    if not lines:
        fail(f"context: the point-to-point probe recorded nothing:\n{text[-3000:]}")
    return lines


def _context_one_process() -> dict:
    """Phase context's one-process runs: the forward in fp32 (TF32 off) and
    in bf16, the int8 model, the step and the GAN steps; their results and
    the seconds they took."""
    import torch

    t0 = time.time()
    images = torch.as_tensor(_context_inputs("images")).to("cuda").permute(0, 3, 1, 2)
    recon = {}
    for dtype in ("float32", "bfloat16"):
        model = _context_model(dtype=dtype).eval()
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = dtype == "bfloat16"
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            recon[dtype] = torch.sigmoid(model(images.to(getattr(torch, dtype)))[0].float())
        torch.backends.cudnn.allow_tf32 = tf32
        log(f"context (b): one process's {dtype} forward at {CONTEXT_RES}px "
            f"b{CONTEXT_FWD_BATCH}, peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        del model
        torch.cuda.empty_cache()
    t1 = time.time()
    one_int8, one_int8_recon, one_amax = _context_int8()
    one_int8_recon = one_int8_recon.cpu()
    torch.cuda.empty_cache()
    log(f"context (e): one process's int8 ({CONTEXT_INT8_SCOPE}) forward at {CONTEXT_RES}px "
        f"b{CONTEXT_FWD_BATCH}: {one_int8['ms']:.1f} ms, peak {one_int8['peak_gib']:.2f} GiB, "
        f"fp32 calibration {one_int8['calibration_s']:.1f} s; all {time.time() - t1:.1f} s "
        f"[{CARD}]")
    model = _context_model(attention_impl="auto_train")
    batch = torch.as_tensor(_context_inputs("batch")).to("cuda")
    one = _context_step(model, batch)
    del model, batch, images
    torch.cuda.empty_cache()
    log(f"context (c): one process's step at {CONTEXT_RES}px b{CONTEXT_STEP_BATCH}: loss "
        f"{one['total']:.6f}, grad norm {one['grad_norm']:.6f}, {one['ms']:.1f} ms, peak "
        f"{one['peak_gib']:.2f} GiB, launches {one['launches']} [{CARD}]")
    # (g): the forward in fp32 and bf16 and the b2 step at CONTEXT_G_RES.
    g_images = torch.as_tensor(_context_inputs("images", res=CONTEXT_G_RES)).to("cuda")
    g_recon = {}
    for dtype in ("float32", "bfloat16"):
        model = _context_model(dtype=dtype).eval()
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = dtype == "bfloat16"
        with torch.no_grad():
            g_recon[dtype] = torch.sigmoid(
                model(g_images.permute(0, 3, 1, 2).to(getattr(torch, dtype)))[0].float()).cpu()
        torch.backends.cudnn.allow_tf32 = tf32
        del model
    model = _context_model(attention_impl="auto_train")
    batch = torch.as_tensor(_context_inputs("batch", res=CONTEXT_G_RES)).to("cuda")
    g_one = _context_step(model, batch, res=CONTEXT_G_RES)
    del model, batch, g_images
    torch.cuda.empty_cache()
    log(f"context (g): one process's step at {CONTEXT_G_RES}px b{CONTEXT_STEP_BATCH}: loss "
        f"{g_one['total']:.6f}, grad norm {g_one['grad_norm']:.6f}, {g_one['ms']:.1f} ms, peak "
        f"{g_one['peak_gib']:.2f} GiB, launches {g_one['launches']} [{CARD}]")
    one_gan = {}
    for key, dtype, b, res in CONTEXT_GAN_RUNS:
        t1 = time.time()
        o = one_gan[key] = _context_gan(None, dtype, b, res)
        torch.cuda.empty_cache()
        log(f"context (d): one process's {dtype} GAN step at {res}px b{b}: loss "
            f"{o['total']:.6f}, grad norm {o['grad_norm']:.6f}, adaptive weight "
            f"{o['adaptive_gan_weight']:.6f}, disc loss {o['disc_loss']:.6f}, {o['ms']:.1f} ms, "
            f"peak {o['peak_gib']:.2f} GiB, launches {o['launches']}; "
            f"{time.time() - t1:.1f} s with the set-up [{CARD}]")
    return {"recon": recon, "int8": one_int8, "int8_recon": one_int8_recon, "amax": one_amax,
            "step": one, "gan": one_gan, "g_recon": g_recon, "g_step": g_one,
            "s": time.time() - t0}


def phase_context() -> None:
    """Ring context parallelism on the one card (PERF.md, section 6): two
    processes over gloo, a context axis of 2, large f16d32 at 1024px.
    (a) the ring alone at stage 2's shape and at each stage's b2 shape
    against one process's flash attention and the plain ring; (b) the
    no-grad forward against one process's fp32 and bf16 forwards; each
    kind of halo conv against the whole map's, and the same with the halo
    rows zeroed (which must fail); (c) the stage-1 step against one
    process's; (d) a GAN step at CONTEXT_GAN_RES with VF, the
    self-perceptual term, the adaptive weight, R1 and the floor against one
    process's, in bf16 and in fp32 (CONTEXT_GAN_RUNS); (e) the int8 model's
    calibration and forward against one process's. The flash kernels at
    the ring's local shapes are held to their plain versions and timed in
    this process first."""
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        fail("context: a process group exists before phase context")
    shutil.rmtree(CONTEXT_DIR, ignore_errors=True)
    os.makedirs(CONTEXT_DIR)
    # The kernels' times first, with nothing else on the card.
    kernel_rows = _ring_kernel_rows()
    for name, r in kernel_rows.items():
        log(f"time context ring partial {name} (N_local queries x N_local keys): kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) [{CARD}]")
    CONTEXT_RING_ROWS.update(kernel_rows)
    # The two ranks and the point-to-point probe run beside one process's
    # runs (the card holds both: one process's largest, the b2 step, peaks
    # at ~30 GiB, a rank's at ~18).
    with _beside_torchrun(2, "context", os.path.join(CONTEXT_DIR, "ranks.log")) as ranks_run, \
            _beside_torchrun(2, "refusal-gloo-p2p",
                             os.path.join(CONTEXT_DIR, "probe.log")) as probe:
        one = _context_one_process()
        for ln in _context_probe(probe):
            log(f"context: gloo point-to-point probe: {ln}")
        rc, text = ranks_run.wait(timeout=900)
    if rc != 0:
        fail(f"context: the two ranks exited {rc}:\n{text[-6000:]}")
    ranks = []
    for r in range(2):
        with open(os.path.join(CONTEXT_DIR, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    log(f"context: the two ranks took {ranks_run.s:.1f}s, one process's runs "
        f"{one['s']:.1f}s beside them")
    recon, one_int8, one_int8_recon, one_amax, one_gan = (
        one["recon"], one["int8"], one["int8_recon"], one["amax"], one["gan"])
    g_recon, g_one, one = one["g_recon"], one["g_step"], one["step"]

    # (a) The ring.
    steps_want = {"forward": 2, "backward": 2}
    want = {"flash_attention_fwd": 2, "flash_attention_bwd": 2}
    for r, got in enumerate(ranks):
        for shape in CONTEXT_RING_CHECKED:
            a = got["ring"][str(shape)]
            for which in ("vs_flash", "vs_plain"):
                for name, (e, top) in a[which].items():
                    log(f"context (a) rank {r} ring at {shape} {name} {which}: max_abs_err "
                        f"{e:.3e} (rel {e / top:.3e}, bound {KERNEL_RTOL:.3e})")
                    if not e <= KERNEL_RTOL * top:
                        fail(f"context (a): the ring's {name} at {shape} differs from "
                             f"{which[3:]}")
            c = a["counts"]
            timed = (f"{a['ms']:.3f} ms a forward, {a['fwd_bwd_ms']:.3f} ms forward + backward "
                     f"(both ranks on the card at once), " if "ms" in a else "")
            log(f"context (a) rank {r}: ring at {shape} split 2 ways: {timed}ring steps "
                f"{c['ring_steps']}, launches {c['launches']}, host-staged transfers "
                f"{c['staged']} over {got['staged_backend']} [{CARD}]")
            if c["ring_steps"] != steps_want or c["launches"] != want:
                fail(f"context (a) rank {r} at {shape}: ring steps {c['ring_steps']}, launches "
                     f"{c['launches']}; want {steps_want} and {want}")

    # (b) The forward.
    got = torch.load(os.path.join(CONTEXT_DIR, "recon_context.pt"))
    exact = recon["float32"].cpu()
    e_ctx = (got - exact).abs()
    e_one = (recon["bfloat16"].cpu() - exact).abs()
    log(f"context (b): gathered 2-rank bf16 reconstruction vs one process's fp32: mean_abs "
        f"{e_ctx.mean():.4e} max_abs {e_ctx.max():.4e}; one process's bf16: mean_abs "
        f"{e_one.mean():.4e} max_abs {e_one.max():.4e} (ratio {e_ctx.mean() / e_one.mean():.3f}, "
        f"bound {CONTEXT_MEAN_RATIO})")
    if not (np.isfinite(got.numpy()).all() and e_ctx.mean() <= CONTEXT_MEAN_RATIO * e_one.mean()):
        fail("context (b): the context forward is less accurate than one process's bf16 forward")
    per_fwd = 2 * CONTEXT_SUBLAYERS  # two ring steps a sublayer
    for r, g in enumerate(ranks):
        f_ = g["forward"]
        log(f"context (b) rank {r}: {f_['rows']} rows of {CONTEXT_RES}, {f_['ms']:.1f} ms, peak "
            f"{f_['peak_gib']:.2f} GiB, routes {f_['routes']}, launches {f_['launches']}, "
            f"ring steps {f_['ring_steps']}, staged {f_['staged']} [{CARD}]")
        if (f_["routes"] != {"ring": CONTEXT_SUBLAYERS} or f_["norm_launches"]
                or f_["launches"] != {"flash_attention_fwd": per_fwd}
                or f_["ring_steps"] != {"forward": per_fwd}):
            fail(f"context (b) rank {r}: routes {f_['routes']}, launches {f_['launches']}; want "
                 f"{CONTEXT_SUBLAYERS} ring routes and {per_fwd} flash forwards only")
        CONTEXT_PATHS[f"context_forward_rank{r}"] = f_["launches"]
        # The scan layout's forward: the unrolled one's launches and ring steps.
        s_ = g["forward_scan"]
        log(f"context (b) rank {r} scan layout: {s_['ms']:.1f} ms, peak {s_['peak_gib']:.2f} "
            f"GiB, routes {s_['routes']}, launches {s_['launches']}, ring steps "
            f"{s_['ring_steps']}, staged {s_['staged']} [{CARD}]")
        if (s_["routes"] != f_["routes"] or s_["launches"] != f_["launches"]
                or s_["ring_steps"] != f_["ring_steps"] or s_["norm_launches"]):
            fail(f"context (b) rank {r}: the scan layout's forward launched {s_['launches']}, "
                 f"routes {s_['routes']}, ring steps {s_['ring_steps']}; the unrolled one's "
                 f"{f_['launches']}, {f_['routes']}, {f_['ring_steps']}")
        CONTEXT_PATHS[f"context_forward_scan_rank{r}"] = s_["launches"]
    got_scan = torch.load(os.path.join(CONTEXT_DIR, "recon_context_scan.pt"))
    e_scan = (got_scan - got).abs().max().item()
    log(f"context (b): the scan layout's gathered reconstruction vs the unrolled one's: "
        f"max_abs {e_scan:.3e} (bound {KERNEL_RTOL:.3e} of max), bit-equal "
        f"{bool(torch.equal(got_scan, got))}")
    if not e_scan <= KERNEL_RTOL * got.abs().max().item():
        fail("context (b): the scan layout's context forward differs from the unrolled one's")

    # (c) The step.
    for r, g in enumerate(ranks):
        b = g["step"]
        lr = abs(b["total"] - one["total"]) / abs(one["total"])
        gr = abs(b["grad_norm"] - one["grad_norm"]) / one["grad_norm"]
        log(f"context (c) rank {r}: {b['rows']} of {CONTEXT_RES} rows of b{CONTEXT_STEP_BATCH}: "
            f"loss {b['total']:.6f} vs one process {one['total']:.6f} (rel {lr:.2e}, bound "
            f"{PARALLEL_LOSS_RTOL}), grad norm {b['grad_norm']:.6f} vs {one['grad_norm']:.6f} "
            f"(rel {gr:.2e}, bound {PARALLEL_GRAD_NORM_RTOL}), parameters bit-identical across "
            f"ranks {b['params_bit_identical']} ({b['params_checked']} tensors), peak "
            f"{b['peak_gib']:.2f} GiB (one process {one['peak_gib']:.2f}), step {b['ms']:.1f} ms "
            f"(one process {one['ms']:.1f}; two ranks share the card and gloo stages through "
            f"host memory: not a speed), launches {b['launches']}, ring steps "
            f"{b['ring_steps']}, staged {b['staged']} [{CARD}]")
        if lr > PARALLEL_LOSS_RTOL or gr > PARALLEL_GRAD_NORM_RTOL or not b["applied"]:
            fail(f"context (c) rank {r}: loss or grad norm off the one process's (or skipped)")
        if not b["params_bit_identical"]:
            fail("context (c): the ranks' parameters differ after the update")
        # Under remat 'none' each sublayer's ring runs in the forward and
        # again in its recompute (2 steps each), and backward once.
        want = {"flash_attention_fwd": 2 * per_fwd, "flash_attention_bwd": per_fwd}
        if (b["launches"] != want
                or b["ring_steps"] != {"forward": 2 * per_fwd, "backward": per_fwd}):
            fail(f"context (c) rank {r}: launches {b['launches']}, ring steps "
                 f"{b['ring_steps']}; want {want} and as many ring steps")
        CONTEXT_PATHS[f"context_step_rank{r}"] = b["launches"]

    # (g) The uneven split at CONTEXT_G_RES: the forward, then the step.
    got = torch.load(os.path.join(CONTEXT_DIR, "recon_g_context.pt"))
    e_ctx = (got - g_recon["float32"]).abs()
    e_one = (g_recon["bfloat16"] - g_recon["float32"]).abs()
    log(f"context (g): gathered 2-rank bf16 reconstruction at {CONTEXT_G_RES}px vs one "
        f"process's fp32: mean_abs {e_ctx.mean():.4e} max_abs {e_ctx.max():.4e}; one process's "
        f"bf16: mean_abs {e_one.mean():.4e} max_abs {e_one.max():.4e} (ratio "
        f"{e_ctx.mean() / e_one.mean():.3f}, bound {CONTEXT_MEAN_RATIO})")
    if not (np.isfinite(got.numpy()).all() and e_ctx.mean() <= CONTEXT_MEAN_RATIO * e_one.mean()):
        fail(f"context (g): the {CONTEXT_G_RES}px context forward is less accurate than one "
             f"process's bf16 forward")
    for r, g in enumerate(ranks):
        f_, b = g["g_forward"], g["g_step"]
        ragged = {h: f"flash_attention_fwd {n} {h}" for h, n in CONTEXT_G_TOKENS[r].items()}
        log(f"context (g) rank {r}: {f_['rows']} rows of {CONTEXT_G_RES}, {f_['ms']:.1f} ms, peak "
            f"{f_['peak_gib']:.2f} GiB, routes {f_['routes']}, launches {f_['launches']} by "
            f"shape {f_['by_shape']}, ring steps {f_['ring_steps']}, staged {f_['staged']} "
            f"[{CARD}]")
        if (f_["routes"] != {"ring": CONTEXT_SUBLAYERS}
                or f_["launches"] != {"flash_attention_fwd": per_fwd}
                or f_["ring_steps"] != {"forward": per_fwd}
                or not all(f_["by_shape"].get(k) for k in ragged.values())):
            fail(f"context (g) rank {r}: routes {f_['routes']}, launches {f_['launches']} "
                 f"({f_['by_shape']}); want {CONTEXT_SUBLAYERS} ring routes, {per_fwd} flash "
                 f"forwards, one a ring step, at {sorted(ragged.values())}")
        CONTEXT_PATHS[f"context_g_forward_rank{r}"] = f_["launches"]
        lr = abs(b["total"] - g_one["total"]) / abs(g_one["total"])
        gr = abs(b["grad_norm"] - g_one["grad_norm"]) / g_one["grad_norm"]
        log(f"context (g) rank {r}: step at {CONTEXT_G_RES}px b{CONTEXT_STEP_BATCH}: loss "
            f"{b['total']:.6f} vs one process {g_one['total']:.6f} (rel {lr:.2e}, bound "
            f"{PARALLEL_LOSS_RTOL}), grad norm {b['grad_norm']:.6f} vs {g_one['grad_norm']:.6f} "
            f"(rel {gr:.2e}, bound {PARALLEL_GRAD_NORM_RTOL}), parameters bit-identical across "
            f"ranks {b['params_bit_identical']}, peak {b['peak_gib']:.2f} GiB (one process "
            f"{g_one['peak_gib']:.2f}), {b['ms']:.1f} ms (one process {g_one['ms']:.1f}; not a "
            f"speed), launches {b['launches']} by shape {b['by_shape']}, ring steps "
            f"{b['ring_steps']}, staged {b['staged']} [{CARD}]")
        if lr > PARALLEL_LOSS_RTOL or gr > PARALLEL_GRAD_NORM_RTOL or not b["applied"]:
            fail(f"context (g) rank {r}: loss or grad norm off the one process's (or skipped)")
        if not b["params_bit_identical"]:
            fail("context (g): the ranks' parameters differ after the update")
        want = {"flash_attention_fwd": 2 * per_fwd, "flash_attention_bwd": per_fwd}
        bwd = {h: f"flash_attention_bwd {n} {h}" for h, n in CONTEXT_G_TOKENS[r].items()}
        if (b["launches"] != want
                or b["ring_steps"] != {"forward": 2 * per_fwd, "backward": per_fwd}
                or not all(b["by_shape"].get(k) for k in bwd.values())):
            fail(f"context (g) rank {r}: launches {b['launches']} ({b['by_shape']}), ring steps "
                 f"{b['ring_steps']}; want {want}, one a ring step, at {sorted(bwd.values())}")
        CONTEXT_PATHS[f"context_g_step_rank{r}"] = b["launches"]

    # The halo convs, and the planted fault, which must fail their bars.
    for r, g in enumerate(ranks):
        log(f"context halo convs rank {r}: {g['halo_s']:.1f} s with the planted fault")
        for name, (e, top, ge, gtop) in g["halo"].items():
            bitwise = name == "int8_qconv"
            log(f"context halo conv rank {r} {name}: max_abs_err {e:.3e} (rel {e / top:.3e}), "
                f"input grad {ge:.3e} (rel {ge / max(gtop, 1e-30):.3e}), bound "
                f"{'bit-equal' if bitwise else CONTEXT_HALO_RTOL}")
            ok = e == 0.0 if bitwise else (e <= CONTEXT_HALO_RTOL * top
                                           and ge <= CONTEXT_HALO_RTOL * gtop)
            if not ok:
                fail(f"context: the halo conv {name} differs from the whole map's on rank {r}")
    for name in ranks[0]["halo_zeroed"]:
        readings = [g["halo_zeroed"][name] for g in ranks]
        caught = any(e > (0.0 if name == "int8_qconv" else CONTEXT_HALO_RTOL * top)
                     or ge > CONTEXT_HALO_RTOL * gtop for e, top, ge, gtop in readings)
        log(f"context halo conv {name} with the halo rows zeroed (planted): rel err by rank "
            f"{[f'{e / top:.3e}' for e, top, _, _ in readings]}, grad "
            f"{[f'{ge / max(gtop, 1e-30):.3e}' for _, _, ge, gtop in readings]}: "
            f"{'caught' if caught else 'NOT caught'}")
        if not caught:
            fail(f"context: the halo check of {name} passes with zeroed halo rows")

    # (d) The GAN step: bf16 (the kernels' path) and its fp32 twin. Every
    # problem of (d) and (e) is reported before the phase fails.
    problems = []
    enc = CONTEXT_ENC_SUBLAYERS
    dec = CONTEXT_SUBLAYERS - enc
    steps = {"forward": 2 * (7 * enc + 3 * dec), "backward": 2 * (3 * enc + dec)}
    for key, dtype, bsz, res in CONTEXT_GAN_RUNS:
        ref = one_gan[key]
        got_vf = torch.load(os.path.join(CONTEXT_DIR, f"vf_kernel_{key}.pt"))
        vf_err = float((got_vf - ref["vf_kernel"]).norm() / ref["vf_kernel"].norm())
        # fp32 takes the plain ring partials: no kernel launches.
        want = ({"flash_attention_fwd": steps["forward"], "flash_attention_bwd": steps["backward"]}
                if dtype == "bfloat16" else {})
        held = dtype == "float32"
        for r, g in enumerate(ranks):
            b = g[key]
            rel = {k: abs(b[k] - ref[k]) / abs(ref[k])
                   for k in ("total", "grad_norm", "adaptive_gan_weight", "disc_loss")}
            how = "bound" if held else "bar (fp32 only)"
            log(f"context (d) {dtype} rank {r}: {b['rows']} of {res} rows of "
                f"b{bsz}: loss {b['total']:.6f} vs one process {ref['total']:.6f} (rel "
                f"{rel['total']:.2e}, {how} {PARALLEL_LOSS_RTOL}), grad norm "
                f"{b['grad_norm']:.6f} vs {ref['grad_norm']:.6f} (rel {rel['grad_norm']:.2e}, "
                f"{how} {PARALLEL_GRAD_NORM_RTOL}), adaptive weight "
                f"{b['adaptive_gan_weight']:.6f} vs {ref['adaptive_gan_weight']:.6f} (rel "
                f"{rel['adaptive_gan_weight']:.2e}, {how} {PARALLEL_ADAPTIVE_RTOL}), "
                f"vf_proj.kernel gradient rel L2 {vf_err:.2e} (bound "
                f"{PIPE_BLOCK_GRAD_RTOL:.3e}), disc loss {b['disc_loss']:.6f} vs "
                f"{ref['disc_loss']:.6f} (rel {rel['disc_loss']:.2e}), disc update "
                f"{b['disc_update_scale']} vs {ref['disc_update_scale']}, vf {b['vf']:.6f} vs "
                f"{ref['vf']:.6f}, self-perceptual {b['lpips']:.6f} vs {ref['lpips']:.6f}, R1 "
                f"{b['disc_r1']:.4f} vs {ref['disc_r1']:.4f}; generator bit-identical across "
                f"ranks {b['gen_bit_identical']} ({b['gen_checked']} tensors), discriminator "
                f"{b['disc_bit_identical']} ({b['disc_checked']}); peak {b['peak_gib']:.2f} GiB "
                f"(one process {ref['peak_gib']:.2f}), step {b['ms']:.1f} ms (one process "
                f"{ref['ms']:.1f}; not a speed), {b['s']:.1f} s with the set-up, launches "
                f"{b['launches']} (want {want}), ring steps {b['ring_steps']} (want {steps}), "
                f"staged {b['staged']} [{CARD}]")
            if held and (rel["total"] > PARALLEL_LOSS_RTOL
                         or rel["grad_norm"] > PARALLEL_GRAD_NORM_RTOL
                         or rel["adaptive_gan_weight"] > PARALLEL_ADAPTIVE_RTOL):
                problems.append(f"(d) {dtype} rank {r}: loss, grad norm or adaptive weight off "
                                f"the one process's")
            if vf_err > PIPE_BLOCK_GRAD_RTOL or b["disc_update_scale"] != ref["disc_update_scale"]:
                problems.append(f"(d) {dtype} rank {r}: vf_proj's gradient or the floor's "
                                f"decision differs from the one process's")
            if not (b["gen_bit_identical"] and b["disc_bit_identical"]):
                problems.append(f"(d) {dtype}: the ranks' parameters differ after the update")
            if b["launches"] != want or b["ring_steps"] != steps:
                problems.append(f"(d) {dtype} rank {r}: launches {b['launches']}, ring steps "
                                f"{b['ring_steps']}; want {want} and {steps}")
            if dtype == "bfloat16":
                CONTEXT_PATHS[f"context_gan_rank{r}"] = b["launches"]

    # (e) The int8 model.
    got = torch.load(os.path.join(CONTEXT_DIR, "recon_int8_context.pt"))
    e_ctx = (got - exact).abs()
    e_one = (one_int8_recon - exact).abs()
    log(f"context (e): gathered 2-rank int8 ({CONTEXT_INT8_SCOPE}) reconstruction vs one "
        f"process's fp32: mean_abs {e_ctx.mean():.4e} max_abs {e_ctx.max():.4e}; one process's "
        f"int8: mean_abs {e_one.mean():.4e} max_abs {e_one.max():.4e} (ratio "
        f"{e_ctx.mean() / e_one.mean():.3f}, bound {CONTEXT_MEAN_RATIO})")
    if not (np.isfinite(got.numpy()).all() and e_ctx.mean() <= CONTEXT_MEAN_RATIO * e_one.mean()):
        problems.append("(e): the int8 model under context is less accurate than on one "
                        "process")
    for r, g in enumerate(ranks):
        q = g["int8"]
        worst = max((abs(v - one_amax[m][k]) / one_amax[m][k], f"{m}.{k}")
                    for m, sites in q["amax"].items() for k, v in sites.items())
        log(f"context (e) rank {r}: fp32 calibration at {sum(map(len, q['amax'].values()))} "
            f"sites, largest rel difference from one process's {worst[0]:.3e} at {worst[1]} "
            f"(bound {CONTEXT_AMAX_RTOL}); int8 forward {q['rows']} rows of {CONTEXT_RES}, "
            f"{q['ms']:.1f} ms (one process {one_int8['ms']:.1f}), peak {q['peak_gib']:.2f} "
            f"GiB, routes {q['routes']}, launches {q['launches']}, ring steps "
            f"{q['ring_steps']}, staged {q['staged']}, {q['s']:.1f} s with calibration "
            f"({q['calibration_s']:.1f} s fp32) [{CARD}]")
        if set(q["amax"]) != set(one_amax) or worst[0] > CONTEXT_AMAX_RTOL:
            problems.append(f"(e) rank {r}: the calibration under context is off the whole "
                            f"image's")
        if (q["routes"] != {"ring": CONTEXT_SUBLAYERS} or q["norm_launches"]
                or q["launches"] != {"flash_attention_fwd": per_fwd}
                or q["ring_steps"] != {"forward": per_fwd}):
            problems.append(f"(e) rank {r}: routes {q['routes']}, launches {q['launches']}; "
                            f"want {CONTEXT_SUBLAYERS} ring routes and {per_fwd} flash forwards "
                            f"only")
        CONTEXT_PATHS[f"context_int8_rank{r}"] = q["launches"]
    if problems:
        fail("context: " + "; ".join(problems))
    shutil.rmtree(CONTEXT_DIR, ignore_errors=True)


def _pipe_cfg(run: dict):
    from deepl_project_tpu_torch.models import get_dit_config

    return get_dit_config("L", 2, depth=PIPE_DEPTH, attention_impl=run["impl"],
                          pipeline_axis="pipe",
                          pipeline_microbatches=run["micro"], moe_experts=run["experts"],
                          dtype=run["dtype"])


def _pipe_inputs(run: dict) -> tuple:
    """The global batch of a run, made on the card from a seed identically in
    every process: z0 [B, grid, grid, 32], labels, t, noise."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(PIPE_SEED + 1)
    shape = (run["batch"], run["grid"], run["grid"], 32)
    z0 = torch.randn(shape, generator=gen, device="cuda")
    labels = torch.randint(0, 1000, (run["batch"],), generator=gen, device="cuda")
    t = torch.sigmoid(torch.randn(run["batch"], generator=gen, device="cuda"))
    return z0, labels, t, torch.randn(shape, generator=gen, device="cuda")


def _pipe_run(run: dict, placement=None) -> tuple:
    """One process's (placement None) or this rank's run: the model from
    PIPE_SEED, its no-grad forward of the noised batch, then one
    make_dit_train_step step. (row, forward output, {block parameter name:
    (gradient, update)})."""
    import torch

    from deepl_project_tpu_torch.models import create_dit, perturb_zero_init
    from deepl_project_tpu_torch.parallel import collectives as col
    from deepl_project_tpu_torch.parallel import use_axes
    from deepl_project_tpu_torch.parallel.pipeline import reset_run_counts, run_counts
    from deepl_project_tpu_torch.training import TrainState, make_dit_train_step, make_optimizer
    from deepl_project_tpu_torch.training.train_step import named_trainables

    cfg = _pipe_cfg(run)
    model = perturb_zero_init(create_dit(cfg, run["grid"], device="cuda", seed=PIPE_SEED,
                                         placement=placement), PIPE_SEED)
    z0, labels, t, noise = _pipe_inputs(run)
    row = {"params": sum(p.numel() for p in model.parameters())}
    tb = t[:, None, None, None]
    mesh = None if placement is None else placement.mesh

    def reset():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        reset_run_counts()
        col.reset_staged_counts()
        return time.perf_counter()

    def counts(t0):
        torch.cuda.synchronize()
        return {"s": time.perf_counter() - t0, "launches": launches_by_name(),
                "runs": run_counts(), "staged": col.staged_counts(),
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}

    t0 = reset()
    with torch.no_grad(), use_axes(mesh):
        v = model.eval()(((1.0 - tb) * z0 + tb * noise), t, labels).float()
    row["forward"] = counts(t0)
    named = named_trainables(model)
    opt = make_optimizer(named, learning_rate=PIPE_LR, warmup_steps=0, placement=placement)
    blocks = [(n, p) for n, p in named if n.startswith("blocks.block.")]
    before = [p.detach().clone() for _, p in blocks]
    grads = {}
    apply = opt.step

    def step(gs):  # keep the block gradients the update sees
        grads.update({n: gs[i].detach().clone() for i, (n, _) in enumerate(named)
                      if n.startswith("blocks.block.")})
        return apply(gs)

    opt.step = step
    step_fn = make_dit_train_step(model.train(), placement=placement)
    t0 = reset()
    m = step_fn(TrainState(0, model, opt), z0, labels, t, noise)
    row["step"] = counts(t0)
    del opt.step  # the wrapper's cycle would keep the optimizer's state alive
    row.update({k: float(x) for k, x in m.items()})
    row["applied"] = bool(opt.last_finite)
    # The stacks (this stage's slices) by the unrolled block they hold.
    held = model.blocks.held
    out = {f"block{held.start + j}.{n[len('blocks.block.'):]}": (grads[n][j], (p.detach() - b)[j])
           for (n, p), b in zip(blocks, before) for j in range(len(held))}
    return row, v, out


def _rel_l2(pairs) -> float:
    """sqrt(sum |a - b|^2 / sum |b|^2) over (a, b) pairs."""
    d = sum(float((a.float() - b.float()).square().sum()) for a, b in pairs)
    return (d / sum(float(b.float().square().sum()) for _, b in pairs)) ** 0.5


def _by_block(names) -> dict:
    out: dict = {}
    for n in names:
        out.setdefault(n.split(".")[0], []).append(n)
    return out


def _pipe_compare(ref: dict, mine: dict, placement) -> dict:
    """Each block this rank holds against one process's: the relative L2 of
    its gradient (over the block's tensors; an expert weight against the
    matching slice), the share of its update entries of the same sign, and
    where the reference has an fp32 twin's gradients, the relative L2 from
    those."""
    import torch

    def theirs(x, name, like):  # one block's tensor: its experts on dim 0
        dim = 0 if ".experts." in name and placement.expert_size > 1 else None
        return placement.scatter(x.to(like.device), dim)

    out = {}
    for blk, names in _by_block(mine).items():
        rows = {"grad_rel": _rel_l2([(mine[n][0], theirs(ref["blocks"][n][0], n, mine[n][0]))
                                     for n in names])}
        agree = sum(int((torch.sign(mine[n][1])
                         == theirs(ref["blocks"][n][1], n, mine[n][1]).to(torch.int8)).sum())
                    for n in names)
        rows["update_agree"] = agree / sum(mine[n][1].numel() for n in names)
        if "fp32" in ref:
            rows["fp32_rel"] = _rel_l2([(mine[n][0], theirs(ref["fp32"][n], n, mine[n][0]))
                                        for n in names])
        out[blk] = rows
    return out


def pipeline_worker(name: str) -> None:
    """A rank of phase pipeline's run ``name``, started by torchrun: gloo on
    the one card, the run's (data, pipe, expert) mesh; its forward and step
    against the one process's (PIPE_DIR/ref_<name>.pt); results in
    PIPE_DIR/<name>_rank<r>.json."""
    import torch
    import torch.distributed as dist

    from deepl_project_tpu_torch.parallel import (PipelinePlacement, create_dit_mesh,
                                                  initialize_multihost)

    initialize_multihost(backend="gloo", device="cuda:0")
    run = PIPE_RUNS[name]
    placement = PipelinePlacement(create_dit_mesh(*run["mesh"]))
    row, v, mine = _pipe_run(run, placement)
    ref = torch.load(os.path.join(PIPE_DIR, f"ref_{name}.pt"), map_location="cpu",
                     mmap=True)
    want = ref["forward"].to("cuda")
    row["forward_err"] = [float((v - want).abs().max()), float(want.abs().max())]
    if "forward_fp32" in ref:
        row["forward_fp32_mean_err"] = float((v - ref["forward_fp32"].to("cuda")).abs().mean())
    row["blocks"] = _pipe_compare(ref, mine, placement)
    row["held"] = sorted({n.split(".")[0] for n in mine}, key=lambda b: int(b[5:]))
    row["staged_backend"] = dist.get_backend(placement.pipe_group)
    with open(os.path.join(PIPE_DIR, f"{name}_rank{dist.get_rank()}.json"), "w") as f:
        json.dump(row, f)
    dist.destroy_process_group()


def _pipeline_kernel_rows() -> dict:
    """The flash kernels at PIPE_FLASH, as a stage's blocks run them in run
    (a): held against their plain versions on the same inputs (the backward
    fed the kernel's own o and lse), failing beyond KERNEL_RTOL of max, then
    timed beside their plain versions, SDPA (forward; its backward) and
    their bounds."""
    import torch
    import torch.nn.functional as F

    from deepl_project_tpu_torch.ops.hopper import flash_attention as fla

    gen = torch.Generator(device="cuda").manual_seed(6)
    scale, rows = 64 ** -0.5, {}
    q, k, v, do = (torch.randn(*PIPE_FLASH, 64, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    o, lse = fla.flash_forward(q, k, v, scale)
    o_p, lse_p = fla.flash_forward_reference(q, k, v, scale)
    errs = {"o": (o, o_p), "lse": (lse, lse_p)}
    errs.update(zip(("dq", "dk", "dv"), zip(
        fla.flash_backward(q, k, v, o, lse, do, scale),
        fla.flash_backward_reference(q, k, v, o, lse, do, scale))))
    errs = {n: [float((a.float() - b.float()).abs().max()), float(b.float().abs().max())]
            for n, (a, b) in errs.items()}
    for n, (e, top) in errs.items():
        log(f"pipeline: flash at {PIPE_FLASH} {n}: kernel vs plain max_abs_err {e:.3e} "
            f"(rel {e / top:.3e}, bound {KERNEL_RTOL:.3e})")
        if not e <= KERNEL_RTOL * top:
            fail(f"pipeline: the flash kernels' {n} at {PIPE_FLASH} differs from the plain "
                 f"version")
    hq = [x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v)]
    sd = F.scaled_dot_product_attention(*hq)
    for name, kern, plain, lib, outs in (
            ("flash_attention_fwd", lambda: fla.flash_forward(q, k, v, scale),
             lambda: fla.flash_forward_reference(q, k, v, scale),
             lambda: F.scaled_dot_product_attention(*hq), ("o", "lse")),
            ("flash_attention_bwd", lambda: fla.flash_backward(q, k, v, o, lse, do, scale),
             lambda: fla.flash_backward_reference(q, k, v, o, lse, do, scale),
             lambda: torch.autograd.grad(sd, hq, do.transpose(1, 2), retain_graph=True),
             ("dq", "dk", "dv"))):
        flops, nbytes = flash_bound(name, *PIPE_FLASH)
        rows[name] = {
            "ms": cuda_time_ms(kern, 20), "plain_ms": cuda_time_ms(plain, 5, 1),
            "library_ms": cuda_time_ms(lib, 20),
            "bound_ms": max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3,
            "bound_by": ("operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_HBM_BYTES
                         else "bytes"),
            "max_abs_err": max(errs[n][0] for n in outs)}
    return rows


def _pipe_scan_forward() -> None:
    """One process's DiT-L/2 of run (a) built with scan_blocks (no pipeline
    axis: its slices one after another) and unrolled, from the same seed:
    the no-grad forward bit-equal, the same launches."""
    import torch

    from deepl_project_tpu_torch.models import create_dit, perturb_zero_init

    run = PIPE_RUNS["a"]
    z0, labels, t, noise = _pipe_inputs(run)
    tb = t[:, None, None, None]
    outs, launches = {}, {}
    for name, kw in (("unrolled", {}), ("scan", {"scan_blocks": True})):
        cfg = _pipe_cfg(run).replace(pipeline_axis=None, **kw)
        model = perturb_zero_init(create_dit(cfg, run["grid"], device="cuda",
                                             seed=PIPE_SEED), PIPE_SEED).eval()
        reset_launches()
        with torch.no_grad():
            outs[name] = model((1.0 - tb) * z0 + tb * noise, t, labels)
        torch.cuda.synchronize()
        launches[name] = launches_by_name()
        del model
        torch.cuda.empty_cache()
    err = (outs["scan"] - outs["unrolled"]).abs().max().item()
    same = bool(torch.equal(outs["scan"], outs["unrolled"]))
    want = {"flash_attention_fwd": PIPE_DEPTH}
    log(f"pipeline: one process's DiT-L/2 (depth {PIPE_DEPTH}) forward, scan_blocks vs "
        f"unrolled, b{run['batch']} at {run['grid']}x{run['grid']} latents: max_abs {err:.3e}, "
        f"bit-equal {same}; launches {launches['scan']} / {launches['unrolled']} [{CARD}]")
    if not same or launches["scan"] != want or launches["unrolled"] != want:
        fail(f"pipeline: the scan DiT's forward is not the unrolled one's (launches "
             f"{launches}, want {want} each)")
    PIPE_PATHS["pipeline_scan_dit_forward"] = launches["scan"]


def phase_pipeline() -> None:
    """GPipe and expert parallelism of the latent DiT on the one card
    (PERF.md, section 6): the flash kernels at PIPE_FLASH held to their
    plain versions and timed; runs (a) and (b) of PIPE_RUNS, each one
    process's step first, then the run's ranks under torchrun over gloo
    (--worker pipeline-<run>); (c) the dry run's five phases on
    PIPE_DRYRUN_NPROC processes, started first and run beside (a) and (b)
    (it shares nothing with them but the card and the host). Every step
    time is gloo host staging with all the ranks on one card: not a
    speed."""
    import shutil

    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        fail("pipeline: a process group exists before phase pipeline")
    shutil.rmtree(PIPE_DIR, ignore_errors=True)
    os.makedirs(PIPE_DIR)
    # The kernels' times first, with nothing else on the card.
    PIPE_ROWS.update(_pipeline_kernel_rows())
    for name, r in PIPE_ROWS.items():
        log(f"time pipeline {name} {PIPE_FLASH}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
            f"ms ({r['bound_by']}) [{CARD}]")
    t_dry = time.time()
    dry_log = os.path.join(PIPE_DIR, "dryrun.log")
    with open(dry_log, "w") as out:
        dry = subprocess.Popen([sys.executable, "-m", "deepl_project_tpu_torch.parallel.dryrun",
                                "--nproc", str(PIPE_DRYRUN_NPROC)], cwd=ROOT, stdout=out,
                               stderr=subprocess.STDOUT, text=True,
                               env={**os.environ, "PYTHONPATH": ROOT})
    try:
        _pipeline_runs(dry, dry_log, t_dry)
    finally:
        if dry.poll() is None:
            dry.terminate()
            try:
                dry.wait(timeout=30)
            except subprocess.TimeoutExpired:
                dry.kill()
    shutil.rmtree(PIPE_DIR, ignore_errors=True)
    # The phases after this one need the card's memory back.
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 2 ** 30
    log(f"pipeline: {left:.3f} GiB left allocated after the phase")
    if left > 1.0:
        fail(f"pipeline: {left:.2f} GiB still allocated after the phase")


def _pipeline_runs(dry, dry_log: str, t_dry: float) -> None:
    """Phase pipeline's checks while the dry run ``dry`` (writing to
    ``dry_log``, started at ``t_dry``) runs beside them; its result last.
    Each run's ranks start once one process's step of that run is saved,
    and run beside the next run's one process and ranks."""
    import torch

    started = {}
    with contextlib.ExitStack() as stack:
        for name, run in PIPE_RUNS.items():
            t0 = time.time()
            one, v, blocks = _pipe_run(run)
            ref = {"forward": v.cpu(),
                   "blocks": {n: (g.to(torch.bfloat16).cpu(),
                                  torch.sign(du).to(torch.int8).cpu())
                              for n, (g, du) in blocks.items()}}
            del v
            if run["dtype"] == "bfloat16":
                # A reading of bf16's own noise: an fp32 twin (the plain core,
                # TF32 off) on the same weights and draws; one process's bf16
                # gradients and forward against it, beside the ranks'.
                torch.cuda.empty_cache()
                tf32 = torch.backends.cudnn.allow_tf32
                torch.backends.cudnn.allow_tf32 = False
                _, v32, b32 = _pipe_run(dict(run, dtype="float32", impl="xla"))
                torch.backends.cudnn.allow_tf32 = tf32
                ref["fp32"] = {n: g.to(torch.bfloat16).cpu() for n, (g, _) in b32.items()}
                ref["forward_fp32"] = v32.cpu()
                one["fp32_rel"] = {blk: _rel_l2([(blocks[n][0], b32[n][0]) for n in ns])
                                   for blk, ns in _by_block(b32).items()}
                one["forward_fp32_mean_err"] = float((ref["forward"] - ref["forward_fp32"])
                                                     .abs().mean())
                del v32, b32
            torch.save(ref, os.path.join(PIPE_DIR, f"ref_{name}.pt"))
            del blocks, ref
            torch.cuda.empty_cache()
            log(f"pipeline ({name}): one process: {one['params'] / 1e9:.3f} B parameters, loss "
                f"{one['loss']:.6f}, grad norm {one['grad_norm']:.6f}, step "
                f"{one['step']['s']:.2f} s, peak {one['step']['peak_gib']:.2f} GiB, launches "
                f"{one['step']['launches']} [{CARD}]")
            nproc = math.prod(run["mesh"])
            started[name] = (one, t0, stack.enter_context(_beside_torchrun(
                nproc, f"pipeline-{name}", os.path.join(PIPE_DIR, f"{name}_ranks.log"))))
        _pipe_scan_forward()
        for name, run in PIPE_RUNS.items():
            one, t0, ranks_run = started[name]
            nproc = math.prod(run["mesh"])
            rc, text = ranks_run.wait(timeout=600)
            if rc != 0:
                fail(f"pipeline ({name}): the {nproc} ranks exited {rc}:\n{text[-6000:]}")
            per_rank = run["micro"] * _pipe_cfg(run).depth // run["mesh"][1]
            want = ({"flash_attention_fwd": per_rank, "flash_attention_bwd": per_rank}
                    if run["impl"] == "pallas" else {})
            for r in range(nproc):
                with open(os.path.join(PIPE_DIR, f"{name}_rank{r}.json")) as f:
                    got = json.load(f)
                lr = abs(got["loss"] - one["loss"]) / abs(one["loss"])
                gr = abs(got["grad_norm"] - one["grad_norm"]) / one["grad_norm"]
                e, top = got["forward_err"]
                worst_g = max(b["grad_rel"] for b in got["blocks"].values())
                worst_u = min(b["update_agree"] for b in got["blocks"].values())
                st = got["step"]
                if "fp32_rel" in one:
                    # A reading, not a check: each block's gradient and the
                    # forward against the fp32 twin, the ranks' beside one
                    # process's bf16.
                    ratios = sorted(b["fp32_rel"] / one["fp32_rel"][blk]
                                    for blk, b in got["blocks"].items())
                    log(f"pipeline ({name}) rank {r}: against the fp32 twin: block gradients rel "
                        f"L2 {min(b['fp32_rel'] for b in got['blocks'].values()):.3e}-"
                        f"{max(b['fp32_rel'] for b in got['blocks'].values()):.3e} (one process's "
                        f"bf16 {min(one['fp32_rel'][b] for b in got['blocks']):.3e}-"
                        f"{max(one['fp32_rel'][b] for b in got['blocks']):.3e}; ratio "
                        f"{ratios[0]:.3f}-{ratios[-1]:.3f}); forward mean abs err "
                        f"{got['forward_fp32_mean_err']:.4e} (one process's bf16 "
                        f"{one['forward_fp32_mean_err']:.4e}); gradient rel L2 from one process "
                        f"by block "
                        f"{[round(got['blocks'][b]['grad_rel'], 5) for b in got['held']]}")
                log(f"pipeline ({name}) rank {r} of mesh {run['mesh']} (data, pipe, expert): "
                    f"{got['params'] / 1e9:.3f} B parameters, blocks {got['held'][0]}..."
                    f"{got['held'][-1]}; loss {got['loss']:.6f} vs one process {one['loss']:.6f} "
                    f"(rel {lr:.2e}, bound {PARALLEL_LOSS_RTOL}), grad norm "
                    f"{got['grad_norm']:.6f} vs {one['grad_norm']:.6f} (rel {gr:.2e}, bound "
                    f"{PARALLEL_GRAD_NORM_RTOL}); "
                    f"no-grad forward max_abs_err {e:.3e} (rel {e / top:.3e}, bound "
                    f"{KERNEL_RTOL:.3e}); worst block gradient rel L2 {worst_g:.2e} (bound "
                    f"{PIPE_BLOCK_GRAD_RTOL}), update sign agreement {worst_u:.5f} (bound "
                    f"{PIPE_UPDATE_AGREE}); step {st['s']:.2f} s (gloo on one card: not a speed), "
                    f"peak {st['peak_gib']:.2f} GiB, forward {got['forward']['s']:.2f} s; "
                    f"launches step {st['launches']}, forward {got['forward']['launches']}; "
                    f"microbatch runs {st['runs']}; staged {st['staged']} over "
                    f"{got['staged_backend']} [{CARD}]")
                if (lr > PARALLEL_LOSS_RTOL or gr > PARALLEL_GRAD_NORM_RTOL or not got["applied"]
                        or not e <= KERNEL_RTOL * top or worst_g > PIPE_BLOCK_GRAD_RTOL
                        or worst_u < PIPE_UPDATE_AGREE):
                    fail(f"pipeline ({name}) rank {r}: off the one process's step")
                runs = {"forward": run["micro"], "backward": run["micro"]}
                if (st["launches"] != want or st["runs"] != runs
                        or got["forward"]["launches"] != {k: v for k, v in want.items()
                                                          if k.endswith("fwd")}):
                    fail(f"pipeline ({name}) rank {r}: launches {st['launches']}, forward "
                         f"{got['forward']['launches']}, runs {st['runs']}; want {want} and "
                         f"{runs}")
                PIPE_PATHS[f"pipeline_{name}_step_rank{r}"] = st["launches"]
                PIPE_PATHS[f"pipeline_{name}_forward_rank{r}"] = got["forward"]["launches"]
            log(f"pipeline ({name}) took {time.time() - t0:.1f}s, its ranks {ranks_run.s:.1f}s "
                f"(beside the other run's)")
            os.remove(os.path.join(PIPE_DIR, f"ref_{name}.pt"))
    rc = dry.wait(timeout=600)
    with open(dry_log) as f:
        text = f.read()
    lines = [ln for ln in text.splitlines() if ln.startswith("dryrun")]
    for ln in lines:
        log(f"pipeline (c): {ln}")
    if rc != 0 or not any(ln.startswith("dryrun PP+EP OK") for ln in lines):
        fail(f"pipeline (c): the dry run on {PIPE_DRYRUN_NPROC} ranks exited {rc}:\n"
             f"{text[-6000:]}")
    log(f"pipeline (c): the dry run took {time.time() - t_dry:.1f}s beside (a) and (b) "
        f"[{CARD}]")


def main():
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="build,kernels,grad,fold_thin,train,data,dit,gan,recipe,remat,serve,"
                            "serve_mesh,time,eval,quant,scan,context,pipeline,parallel")
    ap.add_argument("--worker", choices=["dp", "dp-gan-cut", "context", "serve-nccl", "tensor4",
                                         "refusal-nccl", "refusal-gloo", "refusal-gloo-p2p",
                                         "subset-one"]
                    + [f"serve-mesh-{i}" for i in range(len(SERVE_MESH_GROUPS))]
                    + [f"pipeline-{n}" for n in PIPE_RUNS],
                    help="run as a rank of phase parallel, context, pipeline or serve_mesh "
                         "(started by torchrun)")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--baseline", metavar="DIR", nargs="+", default=[],
                    help="checkouts whose wgmma kernels (WGMMA_KERNELS) are timed "
                         "beside this tree's (phase kernels)")
    args = ap.parse_args()
    if args.worker:
        sys.path.insert(0, ROOT)
        if args.worker.startswith("dp"):
            dp_worker(gan_cut=args.worker == "dp-gan-cut")
        elif args.worker == "context":
            context_worker()
        elif args.worker.startswith("serve-mesh-"):
            serve_mesh_worker(int(args.worker.rsplit("-", 1)[1]))
        elif args.worker == "serve-nccl":
            serve_nccl_worker()
        elif args.worker == "tensor4":
            tensor4_worker()
        elif args.worker == "refusal-gloo-p2p":
            p2p_probe_worker()
        elif args.worker == "subset-one":
            subset_one_worker()
        elif args.worker.startswith("pipeline-"):
            pipeline_worker(args.worker.split("-", 1)[1])
        else:
            refusal_worker(args.worker.split("-")[1])
        return
    phases = set(args.phases.split(","))
    # make_vf_teacher looks for DINOv2 weights on this machine only.
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this test needs a CUDA device")
    sys.path.insert(0, ROOT)
    try:
        import deepl_project_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the deepl_project_tpu_torch package is not beside this script ({e})")
    CARD = card_line()
    log(f"card: {CARD}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(CARD, flush=True)

    t0 = time.time()
    phase_build()
    results, baseline = {}, {}
    if "kernels" in phases:
        with phase_clock("kernels"):
            results.update(phase_kernels())
            results.update(phase_flash_kernels())
            results.update(phase_eval_kernels())
            results.update(phase_local_kernels())
            if args.baseline:
                baseline = phase_baseline(args.baseline)
    if "grad" in phases:
        with phase_clock("grad"):
            phase_grad()
    if "fold_thin" in phases:
        with phase_clock("fold_thin"):
            phase_fold_thin()
    train_counts, stage1_ckpt, train_info = {}, None, {}
    for later in ("gan", "remat", "parallel"):
        if later in phases and "train" not in phases:
            fail(f"phase {later} reads phase train's checkpoint or rows: run both")
    if "train" in phases:
        with phase_clock("train"):
            train_counts, train_info, stage1_ckpt = phase_train(
                args.profile, bool(phases & {"gan", "remat"}))

    def add(more):
        return {k: train_counts.get(k, 0) + more.get(k, 0)
                for k in set(train_counts) | set(more)}

    if "gan" in phases:
        with phase_clock("gan"):
            train_counts = add(phase_gan(stage1_ckpt, args.profile)[0])
    if "recipe" in phases:
        with phase_clock("recipe"):
            train_counts = add(phase_recipe(args.profile)[0])
    if "remat" in phases:
        with phase_clock("remat"):
            train_counts = add(phase_remat(stage1_ckpt, args.profile)[0])
    if stage1_ckpt is not None:
        import shutil

        shutil.rmtree(os.path.dirname(stage1_ckpt), ignore_errors=True)
    if "data" in phases:
        with phase_clock("data"):
            train_counts = add(phase_data()[0])
    if "dit" in phases:
        with phase_clock("dit"):
            phase_dit(args.profile)
    counts = {}
    model = None
    evaluated = {}
    if phases & {"serve", "serve_mesh", "time", "eval", "quant", "scan"}:
        from deepl_project_tpu_torch import create_transvae

        model = create_transvae("large", 16, 32, device="cuda", seed=0)
        if "serve" in phases:
            with phase_clock("serve"):
                counts = phase_serve(model)
        if "serve_mesh" in phases:
            with phase_clock("serve_mesh"):
                phase_serve_mesh(model)
        if "time" in phases:
            with phase_clock("time"):
                phase_time(model, args.profile)
        if "eval" in phases:
            with phase_clock("eval"):
                evaluated = phase_eval(model, args.profile)
        if "quant" in phases:
            with phase_clock("quant"):
                phase_quant(model, args.profile)
        if "scan" in phases:
            with phase_clock("scan"):
                phase_scan(model)
        del model
        torch.cuda.empty_cache()
    # The single-process phases above create no process group; phase
    # context's ranks are processes of their own, and phase parallel makes
    # its own group and ends it.
    if "context" in phases:
        with phase_clock("context"):
            phase_context()
    if "pipeline" in phases:
        with phase_clock("pipeline"):
            phase_pipeline()
    if "parallel" in phases:
        with phase_clock("parallel"):
            phase_parallel(train_info["rows"])
    if "refusals" in phases:
        with phase_clock("refusals"):
            phase_refusals()
    if "gan_cut" in phases:
        with phase_clock("gan_cut"):
            phase_gan_cut()

    if results:
        want = launches_per_reconstruct()[0] if counts else {}
        kernels = []
        for name, source, replaces in (
                ("ln_qkv_rope", "deepl_project_tpu_torch/csrc/ln_qkv_rope.cu",
                 "deepl_project_tpu/ops/pallas/fused_attention_block.py:376"),
                ("attention_core", "deepl_project_tpu_torch/csrc/attention_core.cu",
                 "deepl_project_tpu/ops/pallas/fused_attention_block.py:248"),
                ("proj_bias_gemm", "deepl_project_tpu_torch/csrc/proj_bias_gemm.cu",
                 "deepl_project_tpu/ops/pallas/fused_attention_block.py:248")):
            rows = {k: r for k, r in results.items() if k[0] == name}
            # Times per reconstruct at b32: each shape's time times its launches.
            per = {k: want.get(k, 1) for k in rows}
            tot = lambda key: sum(per[k] * r[key] for k, r in rows.items())  # noqa: E731
            flops = sum(per[k] * r["flops"] for k, r in rows.items())
            nbytes = sum(per[k] * r["bytes"] for k, r in rows.items())
            libs = [r["library_ms"] for r in rows.values()]
            extra = {
                # The two-call yardstick (not the one-call library_ms) and the
                # sweep's shapes: (kernel, yardstick, bound) ms by (B, N, C).
                "yardstick_ms": tot("yardstick_ms"), "yardstick": QKV_YARDSTICK,
                "sweep_ms_by_shape": {str(k[1:]): [v["ms"], v["yardstick_ms"], v["bound_ms"]]
                                      for k, v in results.items() if k[0] == "ln_qkv_rope_sweep"},
            } if name == "ln_qkv_rope" else {}
            # One rank's heads at model 2 (phase serve_mesh): [kernel, plain,
            # yardstick (F.layer_norm + F.linear; F.linear; SDPA), bound] ms
            # and the max abs error by (B, N, C, W).
            local = {k: r for k, r in results.items() if k[0] == name + "_local"}
            extra["local_ms_by_shape"] = {
                str(k[1:]): [r["ms"], r["plain_ms"], r["yardstick_ms"], r["bound_ms"], r["err"]]
                for k, r in local.items()}
            kernels.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": counts.get(name, 0),
                "max_abs_err": max(r["err"] for r in [*rows.values(), *local.values()]),
                "ms": tot("ms"), "plain_ms": tot("plain_ms"), "bound_ms": tot("bound_ms"),
                "bound_by": ("operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_HBM_BYTES
                             else "bytes"),
                "library_ms": None if None in libs else tot("library_ms"),
                "per": "one reconstruct at b32 (sum over shapes of launches x time)",
                # max_abs_err is over these batches at each of the row's shapes.
                "checked_batches": sorted({b for r in rows.values()
                                           for b in r["checked_batches"]}),
                **extra,
            })
        for name, source, replaces in (
                ("flash_attention_fwd", "deepl_project_tpu_torch/csrc/flash_attention_fwd.cu",
                 "deepl_project_tpu/ops/pallas/flash_attention.py:87"),
                ("flash_attention_bwd", "deepl_project_tpu_torch/csrc/flash_attention_bwd.cu",
                 "deepl_project_tpu/ops/pallas/flash_attention.py:196")):
            r = results[(name, *FLASH_TRAIN)]
            extra = {
                # The serving and sweep shapes: (kernel, SDPA) ms by (B, N, h).
                "ms_by_shape": {str(k[1:]): [v["ms"], v["library_ms"]]
                                for k, v in results.items() if k[0] == name}
            } if name == "flash_attention_fwd" else {
                # One pass for both TPU kernels of _flash_backward: dq (:196)
                # and dk/dv (:218); ms is the whole flash_backward call; the
                # deterministic launcher's call and the memory it adds.
                "also_replaces": "deepl_project_tpu/ops/pallas/flash_attention.py:218",
                "dq_rerun_max_abs_diff": r["rerun_max_abs_diff"],
                "deterministic_ms": r["det_ms"], "deterministic_peak_gib": r["det_peak_gib"]}
            # Phase recipe's and remat's microbatches: [kernel, plain, bound,
            # SDPA (its backward for flash_attention_bwd)] ms.
            extra["train_ms_by_shape"] = {
                str(k[2:]): [v["ms"], v["plain_ms"], v["bound_ms"], v["library_ms"]]
                for k, v in results.items() if k[:2] == ("flash_train_timed", name)}
            kernels.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": train_counts.get(name, 0),
                "max_abs_err": r["err"], "checked_shapes": r["checked_shapes"],
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": ("operations" if r["flops"] / PEAK_BF16_FLOPS
                             >= r["bytes"] / PEAK_HBM_BYTES else "bytes"),
                "library_ms": r["library_ms"],
                "per": (f"one call at the training microbatch (B, N, h)={FLASH_TRAIN}; "
                        f"launches over {TRAIN_STEPS} stage-1 training steps, "
                        f"{GAN_STEPS} stage-2 GAN steps, {RECIPE_STEPS} steps of the "
                        f"yaml recipe, {REMAT_FIT_STEPS} remat-dots + Adafactor steps, "
                        f"one self-perceptual step and cli.train on an image folder "
                        f"({TRAIN_STEPS} steps and a validation batch of 16)"),
                **extra,
            })
        r = results[("small_attention", *SMALL_512)]
        dit = results[("small_attention", *SMALL_DIT)]
        kernels.append({
            "name": "small_attention", "route": "cuda",
            "source": "deepl_project_tpu_torch/csrc/small_attention.cu",
            "replaces": "deepl_project_tpu/ops/pallas/small_attention.py:50",
            "launches": evaluated.get("small_attention_launches", 0),
            "max_abs_err": max(r["err"], dit["err"]), "checked_shapes": [SMALL_512, SMALL_DIT],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            # DiT-B/1's shape and operand layout: [kernel, plain, bound, library] ms.
            "ms_by_shape": {str(SMALL_DIT): [dit["ms"], dit["plain_ms"], dit["bound_ms"],
                                             dit["library_ms"]]},
            "per": (f"one call at 512px stage 4 (B, N, h)={SMALL_512}; launches in the "
                    f"eval phase's 512px sweep ({EVAL_IMAGES} images)"),
        })
        # --baseline: each DIR's and this tree's best times per shape, in turns.
        for row in kernels:
            if row["name"] in baseline:
                row["baseline_turns_ms"] = {
                    d: {str(k): v for k, v in by_shape.items()}
                    for d, by_shape in baseline[row["name"]].items()}
        # group_norm_silu: launches in the serve phase's concurrent requests
        # (the main path), each path's exact count beside them (every phase
        # checks its own against norm_table).
        by_path = {path: {name: sum(n for (k, _, _), n in got.items() if k == name)
                          for name in ("group_norm_stats", "group_norm_apply")}
                   for path, got in NORM_PATHS.items()}
        if counts and not all(counts.get(n, 0) for n in ("group_norm_stats",
                                                          "group_norm_apply")):
            fail(f"group_norm_silu was not launched while serving: {counts}")
        for name, line, library in (
                ("group_norm_stats", 71, "torch.var_mean(x, dim=(2, 3)) on the same "
                                         "channels_last x"),
                ("group_norm_apply", 92, "none: no one PyTorch call computes "
                                         "silu(x * mul + add)")):
            rows = {label: r for label, r in results.items() if label[0] == name}
            checked = results[("group_norm_checked",)]
            bf16 = [r for label, r in rows.items() if label[-1] == "bf16"]
            tot = lambda key: sum(r[key] for r in bf16)  # noqa: E731
            row = {
                "name": name, "route": "cuda",
                "source": "deepl_project_tpu_torch/csrc/group_norm_silu.cu",
                "replaces": f"deepl_project_tpu/ops/pallas/fused_norm.py:{line}",
                "launches": counts.get(name, 0),
                # Over the timed shapes and the checked-only ones.
                "max_abs_err": max([r["err"] for r in rows.values()] + [checked[name]]),
                "checked_shapes": checked["shapes"], "ms": tot("ms"),
                "plain_ms": tot("plain_ms"), "bound_ms": tot("bound_ms"),
                "bound_by": "bytes",
                "library_ms": None if bf16[0]["library_ms"] is None else tot("library_ms"),
                "ms_by_shape": {str(k[1:]): [r["ms"], r["bound_ms"], r["library_ms"]]
                                for k, r in rows.items()},
                "launches_by_path": {p: c[name] for p, c in by_path.items()},
                "per": (f"one call at each of {list(GROUP_NORM_SHAPES)} bf16, summed "
                        f"(ms_by_shape: [kernel, bound, library] ms, the fp32 shape "
                        f"too); library: {library}; launches in the serve phase's "
                        f"concurrent requests"),
            }
            if name == "group_norm_apply":
                # The whole function (both launches) against F.group_norm +
                # F.silu on the same channels_last x and on an NCHW copy.
                row["group_norm_silu_by_shape"] = {
                    str(k[1:]): r for k, r in results.items() if k[0] == "group_norm_silu"}
            kernels.append(row)
        # Phase dit's, serve_mesh's, context's, pipeline's, parallel's,
        # scan's and time's paths, each driven with the counts set to 0 just
        # before.
        for row in kernels:
            row.setdefault("launches_by_path", {}).update(
                {p: c.get(row["name"], 0)
                 for p, c in {**DIT_PATHS, **SERVE_MESH_PATHS, **CONTEXT_PATHS, **PIPE_PATHS,
                              **PARALLEL_PATHS, **SCAN_PATHS, **TIME_PATHS}.items()})
            # The flash kernels at the pipelined DiT-L/2's shape: [kernel,
            # plain, bound, SDPA (its backward for flash_attention_bwd)] ms
            # and the max abs error against the plain version.
            if row["name"] in PIPE_ROWS:
                r = PIPE_ROWS[row["name"]]
                row["pipeline_ms_by_shape"] = {str(PIPE_FLASH): [
                    r["ms"], r["plain_ms"], r["bound_ms"], r["library_ms"], r["max_abs_err"]]}
            # The ring's partials at the context step's local shapes: [kernel,
            # plain, bound, SDPA] ms and the max abs error against the plain
            # version as the ring runs them.
            ring = {k.split(" ", 1)[1]: [r["ms"], r["plain_ms"], r["bound_ms"], r["library_ms"],
                                         r["max_abs_err"]]
                    for k, r in CONTEXT_RING_ROWS.items()
                    if k.split(" ", 1)[0] == row["name"]}
            if ring:
                row["ring_ms_by_shape"] = ring
        print(json.dumps({"kernels": kernels}), flush=True)
    log(f"all phases passed in {time.time() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
