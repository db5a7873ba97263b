#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero, no result):

1. Needs ``torch.cuda.is_available()``; prints the card's name and power
   limit as ``nvidia-smi`` reports them.
2. Builds the hand-written CUDA kernels from ``pointcloudmatters_tpu_torch/
   csrc`` (nvcc, sm_90a, one process a source, all at once) and prints the
   build time and ptxas's registers and spills by kernel function; those of
   the tensor-core kernels (bf16 kernel 9, the bf16 oneshot backward, kernel
   7's and 8's GEMM instantiations and attention kernels at dh 64 and 128,
   the 3xTF32 f32 kernels 3, 4, 9, 10 and 11 at dh 64 and 128, the routed dW
   kernel 6), of the FP32 GEMM, of the FPS cluster kernel (held and
   streamed slices), of the
   lane-group kNN kernels 2, 12 and 13 (k = 16 and 128, groups of 8 and 32
   lanes; 13 also in groups of 16) and of kernel 5 and its partial sum go
   into the kernels line (``ptxas``).
3. Holds each kernel against its plain PyTorch version on the card at the
   flagship's shapes, and times both:
   FPS -> 2048 (one thread-block cluster a cloud) index-exact at B=1, 4
   and 32 for N=10240 and at B=1 and 4 for N=20480, 40960, 40961, what a
   cluster holds (196,608) and above it, where the slices are streamed
   (196,609 and 1,048,576), on clouds of exact ties and on partly masked
   ones with a row of fewer valid points than it samples, each case's
   cluster size, threads a CTA, ms and microseconds a round logged; kNN
   over M=2048 FPS queries at each of
   KNN_CASES (B=1, 4 and 32 at N=10240, B=1 and 4 at N=20480, k=16, 96 and
   128, a lattice of exact ties, a row of fewer valid points than k), in FPS
   order and Morton-sorted (B=32: FPS order, no kernel 12): kernels 2
   (``v3``), 12 (chunk-skip) and 13 (dense scan) each index-exact against
   its plain version and the plain kNN, d2 bit-equal to them and across the
   three, relaunches bit-identical, kernel 12's skipped (tile, chunk) pairs
   equal to its plain version's at the kernel's query tile TQ; each case's
   lane group S, TQ, times and kernel 12's skipped and box-pruned shares
   logged; k=160 launching no kNN kernel on any selector; attention forward
   B=4, H=8, L=2051, dh=64, f32 (3xTF32, ``csrc/attention_fwd.cuh``), at
   dropout rate 0 and 0.1, each timed, also at dh=128, H=4 (max abs error
   <= 1e-4; also a masked key tail); the dropout mask read back from the
   forward bit for bit (q = 0, v = I); the attention backward at rate 0,
   0.1 and a masked key tail (each of dQ, dK, dV within
   1e-4 * max(1, max |plain|)), two identical launches bit-identical. The
   bf16 attention forward and backward (the tensor-core kernels of
   ``csrc/attention_mma.cuh``) at the same shape, rates 0 and 0.1, each
   timed at both rates, and at dh=128, Lq=70, Lk=650, l_actual=600 (each
   output within BF16_TOL * max(1, max |plain|), row statistics within
   1e-5, the mask read back bit for bit, two backward launches
   bit-identical). The data-source builder at B=4 and 32, N=10240, M=2048,
   K=16, D=512 with holes, and at B=4 on K=9 of the neighbours of M=2000
   queries: kernel 5's vmax, vmin and tie bitmap bit-equal, sg
   within one bf16 ulp, totals within 1e-5 relative of the exact totals
   (f64 sums; the plain version's f32 sums logged beside), each case timed; kernel 6 (Cin=515, on
   the bf16 tensor cores) at B=4 and B=32, with queries of one live
   neighbour (its w_lo product), within 1e-5 * max |dW|, the share of its
   tiles that ran the w_lo product logged; two launches of each
   bit-identical. The fused
   attention layer (kernels 7 and 8) at B=4, L=2051, D=512, H=8, f32 and
   bf16, rates 0 and 0.1: the output and each of the ten gradients within
   BF16_TOL * max(1, max |plain|), two launches of each bit-identical; once
   at dh=128; and at rate 0.1, f32 and bf16, with the weights as transposed
   views (one at no unit stride, rows not 16-byte aligned), at D=256,
   H=4 over B L = 1551 rows (not a multiple of 64) and at L=513 (a ragged
   one-row last tile), as strictly. Flash
   attention (kernels 9, 10 and 11) at B=4, H=8, L=2051, dh=64 with the
   adapter's 512-row tiles, f32 and bf16, rates 0 and 0.1; a causal case
   with a bias (its gradient ds), a masked key tail, a batch row whose keys
   are all masked and Lq != Lk; dh=128; kernel 9's
   1024-key blocks (scores computed again in each pass) and its single-step
   variant; in f32 (kernels 9, 10 and 11 in 3xTF32, ``csrc/f32_mma.cuh``)
   and in bf16 (on the tensor cores, ``csrc/flash_mma.cuh``) also Lq=70,
   Lk=650 with a segment-masked key tail, the same on views whose rows are
   not 16-byte aligned (plain loads, no cp.async), and a causal case whose
   48- and 40-row TPU tiles straddle the 64-row mma tiles, each at rate
   0.1, and kernels 9, 10 and 11 of both types timed at rate 0 beside rate
   0.1:
   o and every gradient within 1e-4 * max(1, max |plain|) in f32 and BF16_TOL in bf16,
   l and m within 1e-5 relative, two launches of each bit-identical, the
   mask read back bit for bit and the same for every batch item and head.
   Each attention shape is also timed through
   ``torch.nn.functional.scaled_dot_product_attention`` at rate 0 (forward,
   and forward + backward), and the fused layer through
   ``torch.nn.functional.multi_head_attention_forward``: the library
   yardsticks.
4. Serves the flagship ACT + PointNet policy (24,124,456 parameters, seeded
   random weights) through ``BCModule.predict``: after a warm-up request at
   each batch size, 3 requests at B=1 and 3 at B=32, N=10240, no actions.
   Checks a_hat's shape and finiteness, that each kernel of the path was
   launched in that run, that the last B=32 answer matches the same predict
   with every kernel swapped for its plain version (1e-3 abs), and that a
   small policy on the card matches itself on the CPU (1e-4). Then the same for the flagship with ``attention_impl="fused"``:
   kernel 7 launched and kernel 3 not, the B=32 answer and a small fused
   policy (515 tokens, dh=64) within 1e-2 * max(1, max |ref|) (the fused
   layer's bf16 roundings, whose flips carry through the network). Then
   with ``attention_impl="flash"``: kernel 9 once in every encoder layer of
   every request and no other attention kernel, the B=32 answer within
   1e-3 of the plain versions, a small flash policy (1027 tokens, dh=64)
   within 1e-4 of the CPU.
5. Trains the flagship ("32-true", dropout 0.1, AdamW + OneCycleLR of
   ``configs/model/maniskill2_act_pcd_model.yaml``, 10,000 total steps) at
   B=32, N=10240: one warm-up step, then 5 steps under
   ``torch.cuda.set_sync_debug_mode("error")`` timed by the host clock to
   ``torch.cuda.synchronize()``. Checks finite loss and grad_norm, changed
   parameters and each kernel of the path launched; prints the peak device
   memory. Then one B=4 step with every kernel against every plain version
   from the same generator states (loss within 1e-5 relative, each
   gradient within 1e-5 * max(1, max |g|)), and one step of a small policy
   (dropout 0) on the card against the CPU (loss within 1e-5 relative,
   gradients within 1e-4 * max(1, max |g|)).
6. Trains at ``"bf16-mixed"``, as phase 5, (a) the flagship as shipped and
   (b) its frozen-backbone variant, whose token builder takes kernels 5 and
   6: each one's ms/step, samples/s and peak memory; finite losses, moved
   parameters, the bf16 attention kernels launched in both, the builder
   kernels in (b) and never in (a). Then a B=4 bf16 step of (b) with every
   kernel against every plain version (loss and each gradient within
   BF16_STEP_TOL of max(1, max |g|)).
7. Trains the flagship with ``attention_impl="fused"`` at dropout 0, at
   ``"32-true"`` and at ``"bf16-mixed"``, as phase 5 times it: kernels 7 and
   8 of the step's type launched in every encoder layer and no oneshot
   kernel; then an f32 and a bf16 B=4 step, each with every
   kernel against every plain version (BF16_STEP_TOL: the fused layer
   rounds to bf16 in both types), and a B=4 step at
   dropout 0.1, which the fused backend routes to the bf16 oneshot kernels
   (and no fused kernel), as JAX does, against every plain version
   (BF16_STEP_TOL).
8. Trains the flagship with ``attention_impl="flash"`` at the shipped
   dropout 0.1, at ``"32-true"`` and at ``"bf16-mixed"``, as phase 5 times
   it: kernels 9, 10 and 11 of the step's type once in every encoder layer
   of every step, and no other attention kernel; then a B=4 step of each
   type with every kernel against every plain version from the same
   generators (f32 1e-5, as phase 5; bf16 BF16_STEP_TOL). Flash kernels
   launched on any other path fail the run.
9. The kNN selector ``PCM_KNN_IMPL`` (phases 3-8 run with it unset,
   whatever the caller's environment holds): the flagship served at B=1
   and B=32 (3 warmed requests a size) under ``chunkskip`` and under
   ``baseline``, kernel 12 or 13 in every request and kernel 2 never, the
   B=32 answer bit-equal to the default route's; at N=20480 with the
   variable unset, kernel 12 in every request (the automatic route above
   16,384 points) and the B=32 answer within 1e-3 of the all-plain
   version; ``bogus`` raising ``ValueError`` with no kNN kernel launched;
   a warmed bf16 B=32 step under ``chunkskip`` timed as phase 5, kernel 12
   once a step. Kernels 12 and 13 launched on any other path fail the run.
10. Trains the flagship as shipped through ``Trainer.fit``: its task module
   ``ManiSkill2ACTBCModule`` (24,124,456 parameters, dropout 0.1, AdamW +
   OneCycleLR), ``"bf16-mixed"``, ``accumulate_grad_batches=2``, B=8, 8
   micro-steps over the ported data pipeline (the config's grid sampling,
   colour normalisation, shuffle and collect; the point-cloud collate,
   pinned batches, 4 loader threads) on synthetic ManiSkill2 demos held in
   memory, so that no h5py is needed (one 128 x 128 camera, 8 episodes of
   60 steps, 2 held out).
   Checks 8 micro-steps and 4 optimizer and schedule steps, every parameter
   bit-equal across each odd micro-step and moved after each even one, the
   batch statistics moved after every micro-step, finite losses and
   gradient norms, kernels 1, 2 and bf16 3/4 launched in the counts of one
   micro-step each and no other kernel, and the module's validation over
   the configs' ``DummyDataset`` returning ``{}``. Then the same fit warmed,
   timed by the host clock between optimizer steps (ms a step, samples/s,
   the share of the loop spent waiting on the loader, peak memory, points
   a cloud and the grid sampling's route); one accumulated pair of
   micro-steps with every kernel against the same pair on the plain
   versions (mean gradient and updated parameters within BF16_STEP_TOL of
   max(1, max |ref|)); and ``Trainer.validate`` of a base ``BCModule`` over
   4 held-out batches of 1 (finite ``val/loss``, FPS, kNN and f32 kernel 3
   launched in the counts of one eval forward each).
11. Trains the flagship through the port's entry point,
   ``pointcloudmatters_tpu_torch.train.main``, composing ``configs/`` as the
   README's command does (``exp_maniskill2_act_policy=base``,
   ``scratch_pointnet_pcd``, ``PickCube-v0``: B=8, k=2, ``"bf16-mixed"``,
   the default callbacks, the TensorBoard logger), over phase 10's demos,
   2 epochs of 4 micro-steps, validating on the held-out demos after each
   (the overrides and their reasons are at ``cli_argv``). Checks (a) ``last``
   and a top-k checkpoint named by the shipped pattern, and
   ``best_model_path``; (b) a fresh trainer's restore of ``last`` bit-equal
   to the run's end in every parameter, running statistic, AdamW moment,
   gradient mean, schedule step and generator state; (c) a second run from
   ``ckpt_path=last`` resuming at epoch 2, its first logged step the saved
   one plus an epoch's, writing a new ``last``; (d)
   ``pointcloudmatters_tpu_torch.validate.main(ckpt_path=best)`` returning
   a finite held-out loss equal to ``Trainer.validate``'s from the same
   restored state; (e) kernels 1, 2 and bf16 3/4 launched in the counts of
   the run's micro-steps and f32 3 in those of its validations, and no
   other. Logs the seconds from ``main`` to the first step, the ms per
   optimizer step from the trainer's epoch rate beside phase 10's on the
   same call, and the checkpoint's size and save and restore seconds.

12. Trains the flagship data-parallel, one process a card
   (``pointcloudmatters_tpu_torch/utils/dist.py``): (a) in a spawned
   process, three shipped ``"bf16-mixed"`` B=32 steps (dropout 0.1) with no
   process group, again (their reproducibility, logged), then in an NCCL
   group of one rank, bit-equal to no group in losses, grad_norm,
   parameters and running statistics; (b) two spawned processes on the one
   card under a gloo group (NCCL refuses two ranks on one card; gloo takes
   CUDA tensors), B=16 each, three AdamW + OneCycleLR steps of the
   flagship at ``"32-true"`` and of its frozen backbone at
   ``"bf16-mixed"`` (kernels 5 and 6), dropout 0, the posterior noise rows
   of one global draw: the ranks' end states equal, rank 0's against a
   world of one over the concatenated B=32 in this process within
   ``DDP_LIMITS``, each kernel of the path launched on both ranks, each
   world's ms a step and the flat all-reduce's ms, and at dropout 0.1 the
   dense attention's mask and the kernels' seed drawn alike on both ranks
   while BitsDropout's bits and the posterior noise differ; under NCCL
   across two cards too where the machine has them; (c)
   ``train.main`` on phase 11's composition at ``trainer.devices=auto``
   (the README's composition sets ``devices: 1``): a world of one, and
   ``trainer.devices`` above the card count raising before any launch.
   Gloo over one card rehearses the path; it is no scaling figure.

13. The Diffusion Policy over point clouds as
   ``configs/exp_maniskill2_diffusion_policy`` ships it
   (``scratch_pointnet_pcd``, PickCube-v0: 255,852,391 parameters, 255,687,303
   of them the ConditionalUnet1D; seeded random weights; a normalizer fitted
   on seeded data): (a) FPS and kNN (k = 16) over the 128 clouds of a B=64
   step and the 2 of a rollout request, N = 16,384 with ragged valid counts,
   M = 2048: index-exact (kNN d2 bit-equal) against their plain versions,
   timed, FPS's cluster size and kNN's lane group logged (``dp_cases`` in
   their kernels-line entries); (b) ``predict`` in f32, 100 DDPM steps, at
   B=1 and B=8: a warm-up and three timed requests at each, FPS and kNN
   once a request and no other kernel, the last B=8 answer against the plain
   versions from the same generator seed (within 1e-5 of max(1, max
   |plain|), bit-equality logged); (c) the ``"bf16-mixed"`` step at B=64,
   timed as phase 5 times it (samples/s, peak memory), FPS and kNN once a
   step, and one step on the kernels against one on the plain versions
   (BF16_STEP_TOL, as phase 6); (d) ``train.main`` on the DP composition
   over phase 10's demos (``dp_cli_argv``: 2 epochs of 2 micro-steps of 64,
   held-out validation by ``held_out_dp_module``), the normalizer wired
   from the dataset, ``last`` restored by a fresh trainer bit-equal with the
   normalizer rebuilt from its extras; the checkpoint's size and save and
   restore seconds logged. ``python3 tools/dp_phase.py`` builds the kernels
   and runs this phase alone.
14. SpUNet (``scratch_spunet_pcd``: the flagship's ACT head over SpUNet,
   43,599,040 of its 67,426,536 parameters; B=8 clouds of 12,509-12,695
   grid-sampled points padded to 12,800): (a) SpUNet alone: the valid slots
   at each of its five levels and the forward's flops as the code runs and
   on the valid slots alone; the f32 train-mode forward of one cloud on
   the card against the CPU at the valid slots (SPUNET_CPU_TOL); two f32
   forward + backward runs at B=8 bit-equal in outputs and every parameter
   gradient; f32 and bf16 forward and forward + backward times and peak
   memory; (b) ACT over SpUNet ``predict`` in f32 at B=1 and B=8, a warm-up
   and three timed requests, FPS, kNN and f32 kernel 3 and no other; (c)
   its ``"bf16-mixed"`` step at B=8 timed as phase 5 times it (under
   ``set_sync_debug_mode("error")``), FPS and kNN once a step and bf16
   kernels 3/4 once a layer, and one step on the kernels against one on the
   plain versions (BF16_STEP_TOL); (d) the ``pre_sample`` variant:
   ``predict`` at B=1 and two bf16 steps at B=8, kernels 5/6 launched zero
   times; (e) ``train.main`` on scratch_spunet_pcd over phase 10's demos
   (phase 11's overrides; 2 epochs of 2 micro-steps of B=8 x 2), a resume
   at epoch 2 and ``validate.main`` on the best checkpoint, with the seconds
   to the first step, ms per optimizer step and the checkpoint's size; (f)
   ``pretrained_ponderv2_pcd`` with HOME at a temporary directory holding a
   fake ``.ponderv2/ponderv2.pth``, loaded bit for bit by
   ``train.instantiate_model``, and a ``predict`` at B=1; (g) the DP over
   SpUNet from ``configs/exp_maniskill2_diffusion_policy``
   (``scratch_spunet_pcd``): ``predict`` at B=1 and one bf16 step at
   DP_SPUNET_BATCH, the largest batch that the reckoning of its peak
   memory (beside the constant) puts under 60 GB. ``python3
   tools/spunet_phase.py [part ...]`` builds the kernels and runs this
   phase, or some of its parts, alone; ``python3 tools/profile_spunet.py``
   profiles (c)'s step and a B=1 request.
15. ACT over images (the 12 image models of
   ``configs/exp_maniskill2_act_policy/maniskill2_model``; the flagship's
   head over ResNet-50, ViT-B/16 or the MultiViT-B trunk, 128 x 128 camera
   images, B=16): (a) each backbone alone at full width, f32 (ResNet-50
   and ViT-B/16 at 1, 3, 4 and 6 channels, MultiViT on RGB-D): its eval
   forward of 2 images on the card against the CPU (IMAGE_CPU_TOL of max
   |CPU|), forward and forward + backward ms at B=16 and peak memory, the
   forward's flops counted on the CPU run; (b) ``predict`` in f32 of
   scratch_resnet50_rgb, scratch_vit_rgb and scratch_multivit_rgbd at B=1
   and B=16, a warm-up and three timed requests; (c) their
   ``"bf16-mixed"`` step at B=16 timed as phase 5 times it (under
   ``set_sync_debug_mode("error")``), and the f32 step of 2 samples on the
   card against the CPU (dropout 0, the posterior noise fixed; loss and
   each gradient within IMAGE_CPU_TOL; ResNet's gradients with its batch
   norms at their running statistics, IMAGE_TRAIN_GRADS says why); (d) ``train.main`` on
   scratch_resnet50_rgb (the RGB-D task) and scratch_resnet50_pointmap (the
   point-cloud task) over phase 10's demos and their RGB-D images (2 epochs
   of 2 micro-steps of 16, held-out validation), a resume at epoch 2 and
   ``validate.main`` on the best checkpoint, with the seconds to the first
   step, ms per optimizer step and the checkpoint's size; (e)
   ``pretrained_r3m_rgb`` and ``pretrained_vc1_rgb`` with HOME at a
   temporary directory holding fake R3M and VC-1 files, loaded bit for bit
   by ``train.instantiate_model``, and a ``predict`` at B=1. Their rows are
   short (at most 52 tokens), so the attention gates route them dense, as
   in JAX: the phase fails if any kernel of #1-#13 launches on its paths.
   ``python3 tools/image_phase.py [part ...]`` builds the kernels and runs
   this phase, or some of its parts, alone.
16. The Diffusion Policy over images (the 12 image models of
   ``configs/exp_maniskill2_diffusion_policy``): (a) ``MultiImageObsEncoder``
   over ResNet-50 (1, 3, 4, 6 channels), ViT-B/16 and MultiViT-B alone, f32,
   on 64 images of 128 x 128 (the RGB-D task's B=32 of two frames): card
   against CPU on 2 rows within IMAGE_DP_CPU_TOL, forward and forward +
   backward ms; (b) ``predict`` (100 DDPM steps, f32) of
   scratch_resnet50_rgb, scratch_vit_rgb and scratch_multivit_rgbd at B=1
   and B=8; (c) their ``"bf16-mixed"`` step at B=32 (ms, samples/s, peak)
   and the f32 step of 2 samples on the card against the CPU, the draws
   fixed (ResNet's gradients at its running statistics, in f32 within
   IMAGE_DP_RESNET_F32_TOL, which a TF32 control must exceed, with a count
   of the ReLU inputs on opposite sides of zero, and in f64 within
   IMAGE_DP_CPU_TOL);
   (d) ``train.main`` on scratch_resnet50_rgbd (RGB-D task) and
   scratch_resnet50_pointmap (point-cloud task), both at the shipped width,
   a resume and ``validate.main``; (e) ``pretrained_r3m_rgb`` from
   a fake R3M file into the shared ``rgb_model``, ``pretrained_vc1_rgb``
   kept at its seeded weights as shipped and loaded by override; (f) fake
   reference checkpoints of scratch_resnet50_rgb and the ACT
   scratch_pointnet_pcd through ``python -m
   pointcloudmatters_tpu_torch.port_reference_ckpt``, restored by
   ``validate.main(ckpt_path=)`` bit for bit, then a ``predict``. The phase
   fails if a kernel of #1-#13 launches on an image DP path.
   ``python3 tools/image_dp_phase.py [part ...]`` runs it alone.
17. RLBench (the paper's second simulator) over episodes the phase writes
   in the processed layout (6 + 2 held out, 30 steps, one 128 x 128 front
   camera: ~16,320 of 16,384 points after the crop and the 5 mm grid, padded
   to 16,384, kNN's v3 route): (a) ``scratch_pointnet_pcd`` of
   ``exp_rlbench_act_policy`` (24,391,212 parameters, seeded): ``predict``
   f32 at B=1 and B=8 (unit quaternions), the ``"bf16-mixed"`` step at B=8,
   kernels 1-4 on the tensors those paths gave them against their plain
   versions (each call recorded or the phase fails; the attention within
   1e-4 or BF16_TOL of max |plain| itself, no floor of 1, the backward on
   the step's upstream gradient and on a random one of unit size; timed,
   with bounds), the card against the CPU within
   RLBENCH_CPU_TOL; (b) the RLBench DP (270,575,467): ``predict`` B=1, the
   bf16 step at B=32, FPS and kNN against their plain versions, a
   checkpoint; (c) ``train.main`` on scratch_pointnet_pcd (2 epochs of 2
   micro-steps of 8, held-out ``val/loss`` after each), scratch_spunet_pcd
   and scratch_resnet50_rgb (one epoch each); (d) ``test_rlbench_act`` and
   ``test_rlbench_dp`` on (c)'s and (b)'s checkpoints against a fake task
   (an IK error at each episode's first try), the goal from a
   ``CachedTextEncoder`` cache; the result lines and a loop step's ms; (e)
   the flagship's ManiSkill2 module validating by rollouts at ``num_envs``
   1 and 4 (the same ``val/mean_success``); (f) a ``profiler="simple"``
   fit, its trace read back. ``python3 tools/rlbench_phase.py [part ...]``
   runs it alone.
18. The last modules, in under 90 s: (a) ``train.main`` on the
   flagship's composition with ``callbacks=stochastic_weight_averaging``
   at the shipped widths (B=8 x 2, 4 epochs of 2 optimizer steps,
   ``swa_lrs`` 5e-4, ``swa_epoch_start`` 0.5, ``annealing_epochs`` 1): two
   epochs averaged, the rate at the last step ``swa_lrs``, the swapped
   weights bit-equal to the mean of the epoch-end snapshots the phase
   keeps, the refreshed statistics within 1e-5 of max|stat| of the
   per-batch mean the phase recomputes over the same batches (JAX's probe
   from zeros and ones), the exact launches (#1, #2, bf16 #3/#4, f32 #3 in
   the refresh); (b) the state-only ACT at ``maniskill2_act_model.yaml``'s
   widths (``env_state_dim`` 42): ``predict`` at B=1 and 32 and a bf16 step
   at B=32, card vs CPU, no kernel launched (rows of 2-3 keys take the
   dense attention, JAX's gate), and kernels 3/4 at L = 2 and 3, f32 and
   bf16, rates 0 and 0.1, against their plain versions (1e-4 / BF16_TOL of
   max|plain|, no floor); (c) ``ACTPCD(use_mask=True)`` at the flagship's
   widths, ``bg_ratio`` 0 and 0.25, on clouds whose point 0 is background,
   one with 100 foreground points and one with none: FPS index-exact,
   ``predict`` and a bf16 step with their launches; (d) the library point
   ops at phase 3's shapes and a packed batch of ragged clouds under each
   ``PCM_KNN_IMPL`` (#1, #2, #12, #13) index-exact and within 1e-6 of
   their plain versions, the ball queries deterministic, two
   ``attention_fusion_step`` launches bit-identical; (e) the flagship's bf16
   steps with ``param_dicts`` under ``CosineLRScheduler``, then on
   ``build_optimizer_v2`` with layer decay, each step's rates equal to the
   CPU's, and ``TransformerForDiffusion`` at its default width, forward
   and gradients card vs CPU within 1e-4 and a step.
   ``python3 tools/phase18.py [part ...]`` runs it alone.
19. The reference's scripts on the port, in under 60 s: (a)
   ``preprocess_rlbench.main`` against the fake ``rlbench``
   (``tools/fake_rlbench.py``: 3 + 2 raw episodes of 8 frames, one 128 x 128
   front camera, ``--text-encoder hash``), then ``train.main`` on the
   episodes it wrote (``exp_rlbench_act_policy``, ``scratch_pointnet_pcd``,
   B=8 x 2, ``"bf16-mixed"``, one optimizer step, held-out ``val/loss``),
   kernels 1-4 on the path's own tensors against their plain versions as
   phase 17 holds them; (b) the first two commands of
   ``pointcloudmatters_tpu_torch/scripts/run_rlbench_camera_view.sh`` (5
   degrees about y, then z), recorded under a stub ``python``, through
   ``test_rlbench_act.main`` on (a)'s checkpoint with the fake ``rlbench``
   (the front camera must receive ``perturb_camera_matrix``'s matrix; goals
   from (a)'s ``clip_cache.npz``); (c) both ManiSkill2 sweep scripts under
   the stub, their env ids against ``iter_env_ids()``, one command of each
   through ``validate.main`` with ``gym.make`` recording (env id, shader,
   ray-tracing samples and denoiser; the cloud only on the swept camera of
   8); (d) the image DP with a ResNet-18 a camera that does not pool (two
   cameras, resized to 64, the UNet at 256/512/1024, 16 reverse steps):
   ``predict`` B=1 and a bf16 step at B=8, card vs CPU, no kernel of #1-#13;
   (e) an SGD flagship after 2 bf16 steps, written in JAX's restored form
   (``tools/jax_form.py``'s ``torch_to_flax``), converted by
   ``jax_checkpoint_to_torch``, resumed and stepped once: bit-equal to the
   source's step; (f) (d)'s model at the shipped widths on the card alone
   (224 px crops: 25,088 features a camera, the UNet at 512/1024/2048, 100
   reverse steps, 3.15 billion parameters): ``predict`` B=1 and two bf16
   steps at B=8, finite, the parameters moved, peak memory logged.
   ``python3 tools/phase19.py [part ...]`` runs it alone.

Prints the seconds of each phase as one JSON line (``phase_seconds``) just
before the kernels line.

Prints a JSON line of the kernels (route, source, the TPU kernel each
replaces, launches on each path (phase 11's: ``train_cli``,
``train_cli_resume``, ``validate_cli``; phase 12's: ``train_ddp``, the
gloo ranks' and (a)'s group's steps, and ``train_cli_ddp``; phase 13's:
``dp_predict``, ``dp_train``, ``train_cli_dp``; phase 14's: ``spunet_predict``,
``spunet_train``, ``spunet_presample_predict``, ``spunet_presample_train``,
``train_cli_spunet``, ``train_cli_spunet_resume``, ``validate_cli_spunet``,
``spunet_ponderv2``, ``dp_spunet_predict``, ``dp_spunet_train``; phase 15's:
``<model>_predict`` and ``<model>_train`` of its three policies,
``train_cli_<model>``, its ``_resume`` and ``validate_cli_<model>`` of its
two compositions, ``pretrained_r3m_rgb``, ``pretrained_vc1_rgb``: all
zero; phase 16's: ``dp_<model>_predict``, ``dp_<model>_train``,
``train_cli_dp_<model>``, its ``_resume``, ``validate_cli_dp_<model>``,
``dp_pretrained_r3m_rgb``, ``converter_validate_<model>`` and
``converter_predict_<model>``: all zero but the ACT's
``scratch_pointnet_pcd`` converter paths, which run FPS, kNN and the
attention forward; phase 17's: ``rlbench_predict``, ``rlbench_train``,
``rlbench_dp_predict``, ``rlbench_dp_train``, ``train_cli_rlbench`` (+
``_scratch_spunet_pcd``, ``_scratch_resnet50_rgb``, the last all zero),
``rlbench_eval``, ``rlbench_dp_eval``, ``rollouts_1_envs``,
``rollouts_4_envs``, ``rlbench_profiled_fit``; phase 18's:
``swa_train_cli``, ``state_predict``, ``state_train`` (both zero),
``masked_predict_bg0`` / ``_bg25``, ``masked_train_bg0`` / ``_bg25``,
``pointops_v3``, ``pointops_chunkskip``, ``pointops_baseline``,
``groups_train``, ``optimizer_v2_train``, ``tfd`` (zero); phase 19's:
``preprocessed_rlbench_train``, ``rlbench_camera_view``,
``sweep_camera_view``, ``sweep_visual_changes``, ``unpooled_dp_predict``,
``unpooled_dp_train``, ``unpooled_full_predict``, ``unpooled_full_train``
(all four zero), ``sgd_round_trip``), error,
kernel, plain and library times,
and the bound: the larger of the bytes over 3.35 TB/s and the flops over
the peak of the inputs' type, 67 TFLOP/s f32 or 989 TFLOP/s bf16 (FPS and
kNN count the flops of the valid points only: neither needs the padding); one
``attention_bwd`` launch is one call of the three-kernel backward: the
``rowsum(dO * O)`` pre-pass, dK/dV and dQ, timed together, and its library
time is the library's forward + backward less its forward; the bf16
oneshot kernels, flash kernels 9, 10 and 11 of both types and the f32
kernels 3 and 4 also carry ``ms_rate0``, their time at dropout 0 beside ``ms`` at 0.1, like
for like with the library's rate-0 call (kernel 9 of both types also
``ms_single_step``, its single-step variant at rate 0.1, which takes S once
more over every key; f32 kernel 3 also ``ms_dh128`` and ``ms_rate0_dh128``,
at dh 128, H=4); the kernels of ``PTXAS_FUNCTIONS`` carry ``ptxas``; FPS carries ``cases``,
each phase-3 case's cluster size, threads, whether its slices were streamed,
ms and microseconds a round, ``max_points``, the most points a cloud the
kernel takes, and ``max_resident``, the most a cluster holds without
streaming, the kNN kernels theirs (S, kernel 12's TQ
and shares, ms), kernel 5 its six (errors, ms, plain ms, bound; its ``ms``
through ``builder_core_cuda``, as earlier builds were timed, ``ms_entry``
the C entry's on buffers made once: the wrapper's host time is above the
kernels' at B=4); kernel 12 also
``skipped_share`` and ``pruned_share`` of the first case; a fused layer's
bound sums its products' times at their operands' peaks; flash kernels 10
and 11 are timed apart, and the library's backward stands on kernel 10's
row, against the two together), then
as its last line ``{"ok": true, "device": {...}}``. Times are CUDA-event or
synchronised host-clock milliseconds on the card named above.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

N_POINTS = 10240  # points a cloud
BIG_BATCH = 32    # the bench batch
ATTN_DROPOUT = 0.1  # the flagship's dropout rate
TRAIN_STEPS = 5
# configs/model/maniskill2_act_pcd_model.yaml:11-25; total steps as bench.py
FLAGSHIP_OPT = {"type": "AdamW", "lr": 5e-5, "weight_decay": 0.05}
FLAGSHIP_SCHED = {"scheduler": {"type": "OneCycleLR", "max_lr": 5e-5, "pct_start": 0.1,
                                "anneal_strategy": "cos", "div_factor": 100.0,
                                "final_div_factor": 1000.0}}
TOTAL_STEPS = 10_000
SMALL = dict(hidden_dim=32, npoints=64, nsample=4, chunk=5, enc_layers=2,
             dec_layers=3, nhead=4)
# name -> (source, the TPU function that reaches pl.pallas_call), as PERF.md
# section 6 names it
_OPS = "pointcloudmatters_tpu/ops/"
_CSRC = "pointcloudmatters_tpu_torch/csrc/"
KERNELS = {
    "fps": (_CSRC + "fps.cu", _OPS + "pallas_fps.py:74"),
    "knn": (_CSRC + "knn.cu", _OPS + "pallas_knn3.py:105"),
    "knn_chunkskip": (_CSRC + "knn_chunkskip.cu", _OPS + "pallas_knn2.py:110"),
    "knn_baseline": (_CSRC + "knn_baseline.cu", _OPS + "pallas_knn.py:81"),
    "attention_fwd": (_CSRC + "attention_fwd.cu", _OPS + "oneshot_attention.py:203"),
    "attention_bwd": (_CSRC + "attention_bwd.cu", _OPS + "oneshot_attention.py:233"),
    "attention_fwd_bf16": (_CSRC + "attention_mma.cuh", _OPS + "oneshot_attention.py:203"),
    "attention_bwd_bf16": (_CSRC + "attention_mma.cuh", _OPS + "oneshot_attention.py:233"),
    "builder_fwd": (_CSRC + "fused_builder.cu", _OPS + "fused_builder.py:226"),
    "routed_dw": (_CSRC + "fused_builder.cu", _OPS + "fused_builder.py:361"),
    "fused_mha_fwd": (_CSRC + "fused_mha.cu", _OPS + "fused_mha.py:154"),
    "fused_mha_bwd": (_CSRC + "fused_mha.cu", _OPS + "fused_mha.py:406"),
    "fused_mha_fwd_bf16": (_CSRC + "gemm_mma.cuh", _OPS + "fused_mha.py:154"),
    "fused_mha_bwd_bf16": (_CSRC + "fused_mha.cu", _OPS + "fused_mha.py:406"),
    "flash_fwd": (_CSRC + "flash_attention.cu", _OPS + "flash_attention.py:697"),
    "flash_dkv": (_CSRC + "flash_attention.cu", _OPS + "flash_attention.py:1068"),
    "flash_dq": (_CSRC + "flash_attention.cu", _OPS + "flash_attention.py:1427"),
    "flash_fwd_bf16": (_CSRC + "flash_mma.cuh", _OPS + "flash_attention.py:697"),
    "flash_dkv_bf16": (_CSRC + "flash_mma.cuh", _OPS + "flash_attention.py:1068"),
    "flash_dq_bf16": (_CSRC + "flash_mma.cuh", _OPS + "flash_attention.py:1427"),
}
# phase 2: the tensor-core kernels (bf16, kernel 6, and f32 kernels 3, 4, 9,
# 10 and 11 in 3xTF32), the FPS cluster kernel, the lane-group kNN kernels
# 2, 12 and 13 (k = 16 and 128 in groups of 8 and 32 lanes; 13 also in the
# 16 it takes at B=4) and kernel 5 with its partial sum, whose ptxas registers and
# spills the kernels line records, by a piece of their mangled names (the
# two f32_dq_kernel pieces by their argument types as well: each library has
# one)
PTXAS_FUNCTIONS = {
    "attention_bwd": {"dkdv_dh64": "15f32_dkdv_kernelILi64E",
                      "dq_dh64": "13f32_dq_kernelILi64EEEvNS_4ArgsIfEE",
                      "dkdv_dh128": "15f32_dkdv_kernelILi128E",
                      "dq_dh128": "13f32_dq_kernelILi128EEEvNS_4ArgsIfEE"},
    "attention_bwd_bf16": {"dkdv_dh64": "8attn_mma11dkdv_kernelILi64ENS0_7OneshotE",
                           "dq_dh64": "8attn_mma9dq_kernelILi64ENS0_7OneshotE"},
    "flash_fwd": {"dh64": "14f32_fwd_kernelILi64E", "dh128": "14f32_fwd_kernelILi128E"},
    "flash_dkv": {"dh64": "14f32_dkv_kernelILi64E", "dh128": "14f32_dkv_kernelILi128E"},
    "flash_dq": {"dh64": "13f32_dq_kernelILi64EEEvN3pcm5flash4ArgsE",
                 "dh128": "13f32_dq_kernelILi128EEEvN3pcm5flash4ArgsE"},
    "flash_fwd_bf16": {"dh64": "5flash10fwd_kernelILi64E", "dh128": "5flash10fwd_kernelILi128E"},
    "fused_mha_fwd": {"gemm_qkv": "16fp32_gemm_kernelIff13__nv_bfloat16E",
                      "gemm_out": "16fp32_gemm_kernelI13__nv_bfloat16ffE"},
    "fused_mha_fwd_bf16": {"gemm": "8gemm_mma11gemm_kernelILb0ELi0E",
                           "core_dh64": "8attn_mma10fwd_kernelILi64ENS0_7OneshotE",
                           "core_dh128": "8attn_mma10fwd_kernelILi128ENS0_7OneshotE"},
    "fused_mha_bwd": {"gemm_wgrad": "16fp32_gemm_kernelIf13__nv_bfloat16fE",
                      "stats_dh64": "8attn_mma10fwd_kernelILi64ENS0_5FusedE",
                      "stats_dh128": "8attn_mma10fwd_kernelILi128ENS0_5FusedE",
                      "dkdv_dh64": "8attn_mma11dkdv_kernelILi64ENS0_5FusedE",
                      "dkdv_dh128": "8attn_mma11dkdv_kernelILi128ENS0_5FusedE",
                      "dq_dh64": "8attn_mma9dq_kernelILi64ENS0_5FusedE",
                      "dq_dh128": "8attn_mma9dq_kernelILi128ENS0_5FusedE"},
    "fps": {"held": "18fps_cluster_kernelILb0E", "streamed": "18fps_cluster_kernelILb1E"},
    "knn": {"k16_S8": "16knn_group_kernelILi8ELi2EE", "k16_S32": "16knn_group_kernelILi32ELi1EE",
            "k128_S8": "16knn_group_kernelILi8ELi16EE",
            "k128_S32": "16knn_group_kernelILi32ELi4EE"},
    "knn_chunkskip": {"k16_S8": "20knn_chunkskip_kernelILi8ELi2EE",
                      "k16_S32": "20knn_chunkskip_kernelILi32ELi1EE",
                      "k128_S8": "20knn_chunkskip_kernelILi8ELi16EE",
                      "k128_S32": "20knn_chunkskip_kernelILi32ELi4EE"},
    "knn_baseline": {"k16_S8": "19knn_baseline_kernelILi8ELi2EE",
                     "k16_S16": "19knn_baseline_kernelILi16ELi1EE",
                     "k16_S32": "19knn_baseline_kernelILi32ELi1EE",
                     "k128_S8": "19knn_baseline_kernelILi8ELi16EE",
                     "k128_S32": "19knn_baseline_kernelILi32ELi4EE"},
    "routed_dw": {"mma": "16routed_dw_kernelE"},
    "builder_fwd": {"fwd": "18builder_fwd_kernelE", "sum": "19sum_partials_kernelE"},
    "attention_fwd": {"dh64": "4attn15attn_fwd_kernelILi64E",
                      "dh128": "4attn15attn_fwd_kernelILi128E"},
    "fused_mha_bwd_bf16": {"gemm_f32": "8gemm_mma11gemm_kernelILb0ELi1E",
                           "gemm_addend": "8gemm_mma11gemm_kernelILb0ELi2E",
                           "gemm_wgrad": "8gemm_mma11gemm_kernelILb1ELi1E"},
}
PREDICT_KERNELS = ("fps", "knn", "attention_fwd")  # serving runs no backward
TRAIN_KERNELS = ("fps", "knn", "attention_fwd", "attention_bwd")  # "32-true"
BF16_KERNELS = ("fps", "knn", "attention_fwd_bf16", "attention_bwd_bf16")
BUILDER_KERNELS = ("builder_fwd", "routed_dw")  # frozen backbone only
ONESHOT_KERNELS = ("attention_fwd", "attention_bwd", "attention_fwd_bf16",
                   "attention_bwd_bf16")
FUSED_KERNELS = ("fused_mha_fwd", "fused_mha_bwd", "fused_mha_fwd_bf16",
                 "fused_mha_bwd_bf16")
# attention_impl="fused": the serving path and the dropout-0 steps
FUSED_PREDICT_KERNELS = ("fps", "knn", "fused_mha_fwd")
FUSED_TRAIN_KERNELS = ("fps", "knn", "fused_mha_fwd", "fused_mha_bwd")
FUSED_BF16_KERNELS = ("fps", "knn", "fused_mha_fwd_bf16", "fused_mha_bwd_bf16")
FLASH_KERNELS = ("flash_fwd", "flash_dkv", "flash_dq", "flash_fwd_bf16", "flash_dkv_bf16",
                 "flash_dq_bf16")
ATTENTION_KERNELS = ONESHOT_KERNELS + FUSED_KERNELS + FLASH_KERNELS
KNN_KERNELS = ("knn", "knn_chunkskip", "knn_baseline")
# PCM_KNN_IMPL -> the kNN kernel of its route at N <= 16,384 (phase 9)
SELECTOR_KERNEL = {"chunkskip": "knn_chunkskip", "baseline": "knn_baseline"}
BIG_CLOUD = 20480  # points: above 16,384 the default route takes kernel 12
# attention_impl="flash": the serving path and the dropout-0.1 steps
FLASH_PREDICT_KERNELS = ("fps", "knn", "flash_fwd")
FLASH_TRAIN_KERNELS = ("fps", "knn", "flash_fwd", "flash_dkv", "flash_dq")
FLASH_BF16_KERNELS = ("fps", "knn", "flash_fwd_bf16", "flash_dkv_bf16", "flash_dq_bf16")
# a small fused policy whose encoder reaches the fused gate (515 tokens) with
# dh = 64, which the kernels take
SMALL_FUSED = dict(hidden_dim=128, npoints=512, nsample=4, chunk=5, enc_layers=2,
                   dec_layers=3, nhead=2)
# a small flash policy whose encoder reaches the flash gate (1027 rows), dh 64
SMALL_FLASH = dict(SMALL_FUSED, npoints=1024)
ENC_LAYERS = 4  # the flagship's encoder layers
FLASH_BLOCK = 512  # the flash adapter's tile (ops/attention.py FLASH_TILE)
# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its bytes over the memory rate and its flops over the rate of
# its inputs' type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}
# bf16 kernels against their plain versions: both round at the same points
# but sum in another order, which moves a rounded e, p or dS by a bf16 ulp
# (2^-8 relative) here and there; 0.01 is ~2.5 ulps at the largest value
BF16_TOL = 1e-2
# a bf16 step with kernels against one with plain versions: the rounding
# differences above, carried through the network
BF16_STEP_TOL = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


PHASE_SECONDS: dict = {}  # seconds by phase, printed on one line before the kernels line


def timed(phase: str, fn, *args):
    """``fn(*args)``, its seconds kept under ``phase`` in PHASE_SECONDS."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[phase] = round(time.perf_counter() - t0, 1)
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi reported no GPU")
    return out[0]


def ptxas_usage(logs: dict) -> dict:
    """Registers, stack frame and spill bytes by kernel function (mangled
    name), from the ``-Xptxas=-v`` output of phase 2's build."""
    usage, fn = {}, None
    for text in logs.values():
        for line in text.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
            if m:
                fn = m.group(1)
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m and fn:
                usage.setdefault(fn, {}).update(stack=int(m[1]), spill_stores=int(m[2]),
                                                spill_loads=int(m[3]))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                usage.setdefault(fn, {})["registers"] = int(m[1])
    return usage


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` runs, after
    one warm-up run, by CUDA events."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, dtype: str) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the flops over the peak rate of ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


@contextlib.contextmanager
def knn_impl(value):
    """``PCM_KNN_IMPL`` set to ``value`` (None: unset) inside, and restored
    after, whatever the caller's environment holds."""
    saved = os.environ.get("PCM_KNN_IMPL")
    if value is None:
        os.environ.pop("PCM_KNN_IMPL", None)
    else:
        os.environ["PCM_KNN_IMPL"] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("PCM_KNN_IMPL", None)
        else:
            os.environ["PCM_KNN_IMPL"] = saved


@contextlib.contextmanager
def plain_kernels():
    """Swap every kernel of the path for its plain PyTorch version."""
    from pointcloudmatters_tpu_torch.ops import (
        flash_attention,
        fps,
        fused_builder,
        fused_mha,
        knn,
        knn_baseline,
        knn_chunkskip,
        oneshot_attention,
        pointops,
    )

    one, fb, fm, fa = oneshot_attention, fused_builder, fused_mha, flash_attention
    kc, kb = knn_chunkskip, knn_baseline
    saved = (fps.farthest_point_sampling_padded_cuda, knn.knn_query_padded_cuda,
             kc.knn_query_chunkskip_cuda, kb.knn_query_baseline_cuda,
             one.oneshot_attention_cuda, one.oneshot_attention_bwd_cuda,
             fb.builder_core_cuda, fb.routed_dw_cuda, fm.fused_mha_cuda,
             fm.fused_mha_bwd_cuda, fa.flash_attention_cuda, fa.flash_attention_bwd_dkv_cuda,
             fa.flash_attention_bwd_dq_cuda)
    fps.farthest_point_sampling_padded_cuda = pointops.farthest_point_sampling_padded_plain
    knn.knn_query_padded_cuda = pointops.knn_query_padded_plain
    kc.knn_query_chunkskip_cuda = pointops.knn_query_chunkskip_plain
    kb.knn_query_baseline_cuda = pointops.knn_query_baseline_plain
    one.oneshot_attention_cuda = one.oneshot_attention_plain
    one.oneshot_attention_bwd_cuda = one.oneshot_attention_plain_bwd
    fb.builder_core_cuda = fb.builder_core_plain
    fb.routed_dw_cuda = fb.routed_dw_plain
    fm.fused_mha_cuda = fm.fused_mha_plain
    fm.fused_mha_bwd_cuda = fm.fused_mha_plain_bwd
    fa.flash_attention_cuda = fa.flash_attention_plain
    fa.flash_attention_bwd_dkv_cuda = fa.flash_attention_plain_bwd_dkv
    fa.flash_attention_bwd_dq_cuda = fa.flash_attention_plain_bwd_dq
    try:
        yield
    finally:
        (fps.farthest_point_sampling_padded_cuda, knn.knn_query_padded_cuda,
         kc.knn_query_chunkskip_cuda, kb.knn_query_baseline_cuda, one.oneshot_attention_cuda, one.oneshot_attention_bwd_cuda,
         fb.builder_core_cuda, fb.routed_dw_cuda, fm.fused_mha_cuda,
         fm.fused_mha_bwd_cuda, fa.flash_attention_cuda, fa.flash_attention_bwd_dkv_cuda,
         fa.flash_attention_bwd_dq_cuda) = saved


def check_kernels(dev) -> dict:
    """Phase 3: each kernel against its plain version; returns per-kernel
    max_abs_err, ms and plain_ms."""
    res = {"fps": check_fps(dev)}
    res.update(check_knn(dev))
    res.update(check_attention(dev))
    res.update(check_attention_bf16(dev))
    res.update(check_builder(dev))
    res.update(check_fused_mha(dev))
    res.update(check_flash(dev))
    return res


# phase 3's FPS cases: (what, B, N), the first the kernels line's times; N
# None is what a cluster holds, fps.MAX_RESIDENT (196,608); above it each
# CTA streams the rest of its slice (STREAMED_CLOUD: 53,248 points a CTA)
STREAMED_CLOUD = 1 << 20
FPS_CASES = (("random", 4, N_POINTS), ("random", 1, N_POINTS), ("random", BIG_BATCH, N_POINTS),
             ("random", 1, BIG_CLOUD), ("random", 4, BIG_CLOUD), ("random", 1, 40960),
             ("random", 4, 40960), ("random", 1, 40961), ("random", 4, 40961),
             ("random", 1, None), ("random", 4, None), ("ties", 4, N_POINTS),
             ("masked", 4, BIG_CLOUD), ("random", 1, 196609), ("random", 4, 196609),
             ("random", 1, STREAMED_CLOUD), ("random", 4, STREAMED_CLOUD),
             ("ties", 1, STREAMED_CLOUD), ("masked", 4, STREAMED_CLOUD))


def hold_fps(what: str, xyz, mask, n: int):
    """Kernel 1's ``n`` samples of (xyz, mask), failing unless index-exact
    against its plain version."""
    import torch

    from pointcloudmatters_tpu_torch.ops import fps, pointops

    idx = fps.farthest_point_sampling_padded_cuda(xyz, mask, n)
    ref = pointops.farthest_point_sampling_padded_plain(xyz, mask, n)
    if not torch.equal(idx, ref):
        raise AssertionError(f"{what} disagrees with its plain version at "
                             f"{(idx != ref).sum().item()} indices")
    return idx


def fps_bound(xyz, mask, n: int) -> dict:
    """Kernel 1's bound: n - 1 rounds of ~8 flops a valid point (the padding
    needs none); xyz and mask read, the indices written."""
    return bound(8.0 * int(mask.sum()) * (n - 1),
                 xyz.numel() * 4 + mask.numel() + xyz.shape[0] * n * 4, "f32")


def knn_bound(q, xyz, mask, k: int, pruned: float = 0.0) -> dict:
    """A kNN kernel's bound: ~8 flops a (query, valid point) distance, but
    for the ``pruned`` points of each query's scan; the inputs read, idx and
    d2 written."""
    B, M = q.shape[:2]
    return bound(8.0 * M * max(0.0, int(mask.sum()) - pruned),
                 (q.numel() + xyz.numel()) * 4 + mask.numel() + B * M * k * 8, "f32")


def check_fps(dev) -> dict:
    """Phase 3, FPS (kernel 1, one thread-block cluster a cloud) at each of
    FPS_CASES, 2048 samples: index-exact against its plain version; its
    cluster size C, threads a CTA, ms and microseconds a round logged.
    ``random`` clouds come from ``build_batch`` (rows with holes at the
    end); ``ties`` puts every point on a coarse grid with each point twice
    (exact ties everywhere); ``masked`` drops 40% of the points at random
    and leaves one row 1000 valid points, fewer than it samples. Clouds
    above 196,608 points run the streamed slices."""
    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch.entry import build_batch
    from pointcloudmatters_tpu_torch.ops import fps, pointops

    rng = np.random.RandomState(5)
    res, cases = None, []
    for what, B, N in FPS_CASES:
        N = fps.MAX_RESIDENT if N is None else N
        if what == "random":
            batch = build_batch(batch_size=B, n_points=N, seed=0, with_actions=False)
            xyz = torch.from_numpy(batch["pcds"]["coord"]).to(dev)
            mask = torch.from_numpy(batch["pcds"]["valid"]).to(dev)
        elif what == "ties":
            grid = (rng.randint(0, 6, (B, N // 2, 3)) * 0.25).astype(np.float32)
            xyz = torch.from_numpy(np.concatenate([grid, grid], 1)).to(dev)
            mask = torch.ones((B, N), dtype=torch.bool, device=dev)
        else:
            xyz = torch.from_numpy((rng.rand(B, N, 3) - 0.5).astype(np.float32)).to(dev)
            valid = rng.rand(B, N) < 0.6
            valid[1, 1000:] = False
            mask = torch.from_numpy(valid).to(dev)
        run = lambda: fps.farthest_point_sampling_padded_cuda(xyz, mask, 2048)  # noqa: E731
        hold_fps(f"FPS kernel ({what}, B={B}, N={N})", xyz, mask, 2048)
        C, T = fps.launch_shape(B, N, dev.index)
        ms = cuda_ms(run, 5)
        streamed = fps.cluster_slice(N, C) > fps.MAX_SLICE
        case = dict(what=what, B=B, N=N, cluster=C, threads=T, streamed=streamed, ms=ms,
                    us_per_round=ms * 1e3 / 2047)
        cases.append(case)
        log(f"fps     {what} B={B} N={N}->2048: index-exact; cluster of {C} CTAs x {T} "
            f"threads{', slices streamed' if streamed else ''}; kernel {ms:.3f} ms, "
            f"{case['us_per_round']:.3f} us a round")
        if res is None:
            res = dict(
                max_abs_err=0.0, ms=ms,
                plain_ms=cuda_ms(lambda: pointops.farthest_point_sampling_padded_plain(
                    xyz, mask, 2048), 2),
                library_ms=None, **fps_bound(xyz, mask, 2048))
            log(f"fps     B={B} N={N}: plain {res['plain_ms']:.3f} ms, bound "
                f"{res['bound_ms']:.4f} ms")
    res["cases"] = cases
    res["max_points"], res["max_resident"] = fps.max_points(), fps.MAX_RESIDENT
    return res


# phase 3's kNN cases: (what, B, N, k), the first the kernels line's times;
# "lattice" puts the cloud and its queries on a coarse grid (exact ties
# everywhere), "short" leaves row 1 ten valid points, fewer than k
KNN_CASES = (("random", 4, N_POINTS, 16), ("random", 1, N_POINTS, 16),
             ("random", BIG_BATCH, N_POINTS, 16), ("random", 1, BIG_CLOUD, 16),
             ("random", 4, BIG_CLOUD, 16), ("random", 4, N_POINTS, 96),
             ("random", 4, N_POINTS, 128), ("random", 1, BIG_CLOUD, 128),
             ("lattice", 4, N_POINTS, 16), ("short", 4, N_POINTS, 16),
             ("short", 4, N_POINTS, 128))


def check_knn(dev) -> dict:
    """Phase 3, the kNN kernels 2, 12 and 13 at each of KNN_CASES over
    M=2048 FPS queries, in FPS order and sorted along a Morton curve (B=32:
    FPS order only, and no kernel 12): indices equal to
    ``knn_query_padded_plain``'s, to each kernel's plain version's and to
    kernel 2's; d2 bit-equal to the plain kNN's and across the three
    kernels (they share one distance expression); two launches
    bit-identical; kernel 12's skipped (tile, chunk) pairs equal to its
    plain version's at the kernel's query tile TQ. Logs each case's times
    (kernel 2 on the FPS order, kernel 12 on the sorted queries, as its
    route runs them, kernel 13 on the FPS order), the lane group S, TQ and
    kernel 12's skipped and box-pruned shares. k=160 takes the plain
    version on every selector and launches no kNN kernel; kernel 2's visiting
    order (``ops.knn.order_multiplier``) is the C entry's."""
    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch.entry import build_batch
    from pointcloudmatters_tpu_torch.ops import fps, knn, pointops
    from pointcloudmatters_tpu_torch.ops import knn_baseline as kb
    from pointcloudmatters_tpu_torch.ops import knn_chunkskip as kc

    lib = knn._lib()
    for n in (1, 3, 1000, N_POINTS, 16400, BIG_CLOUD):
        if lib.pcm_knn_order_multiplier(n) != knn.order_multiplier(n):
            raise AssertionError(f"kernel 2's visiting order differs from ops/knn.py's at N={n}")
    kernels = {"knn": (knn.knn_query_padded_cuda, pointops.knn_query_padded_plain),
               "knn_chunkskip": (kc.knn_query_chunkskip_cuda,
                                 pointops.knn_query_chunkskip_plain),
               "knn_baseline": (kb.knn_query_baseline_cuda, pointops.knn_query_baseline_plain)}
    res = {name: dict(max_abs_err=0.0, library_ms=None, cases=[]) for name in kernels}
    rng = np.random.RandomState(9)
    for what, B, N, k in KNN_CASES:
        batch = build_batch(batch_size=B, n_points=N, seed=0, with_actions=False)
        xyz = torch.from_numpy(batch["pcds"]["coord"]).to(dev)
        mask = torch.from_numpy(batch["pcds"]["valid"]).to(dev)
        if what == "lattice":
            grid = (rng.randint(0, 24, (B, N, 3)) * (0.4 / 24) - 0.2).astype(np.float32)
            xyz = torch.from_numpy(grid).to(dev)
        elif what == "short":
            mask[1, 10:] = False
        idx = fps.farthest_point_sampling_padded_cuda(xyz, mask, 2048)
        q = torch.gather(xyz, 1, idx.long()[..., None].expand(-1, -1, 3)).contiguous()
        all_valid = torch.ones(q.shape[:2], dtype=torch.bool, device=dev)
        perm = pointops.spatial_sort_order(q, all_valid).long()
        q_sorted = torch.gather(q, 1, perm[..., None].expand(-1, -1, 3)).contiguous()
        M = q.shape[1]
        S2 = knn.launch_group(B, M, k, dev.index)
        S12, TQ = kc.launch_shape(B, M, k, dev.index)
        S13, TQ13 = kb.launch_shape(B, M, k, dev.index)
        orders = (("FPS order", q),) if B == BIG_BATCH else (("FPS order", q),
                                                             ("Morton-sorted", q_sorted))
        notes, skip_share, prune_share = [], None, None
        for order, qq in orders:
            pi, pd = pointops.knn_query_padded_plain(qq, xyz, mask, k)
            outs = {}
            for name, (kernel, plain) in kernels.items():
                if name == "knn_chunkskip" and B == BIG_BATCH:
                    continue
                gi, gd = kernel(qq, xyz, mask, k)
                again = kernel(qq, xyz, mask, k)
                si, sd = plain(qq, xyz, mask, k, **({"tm": TQ} if name == "knn_chunkskip"
                                                     else {}))
                where = f"{name} ({what}, B={B}, N={N}, k={k}, {order})"
                if not (torch.equal(gi, pi) and torch.equal(gi, si)):
                    raise AssertionError(f"{where}: indices differ from the plain kNN at "
                                         f"{(gi != pi).sum().item()}, from its plain version "
                                         f"at {(gi != si).sum().item()} places")
                if not (torch.equal(gd, pd) and torch.equal(gd, sd)):
                    raise AssertionError(f"{where}: d2 not bit-equal to the plain versions "
                                         f"(max diff {_max_err(gd, pd):.3e})")
                if not (torch.equal(gi, again[0]) and torch.equal(gd, again[1])):
                    raise AssertionError(f"{where}: two identical launches differ")
                res[name]["max_abs_err"] = max(res[name]["max_abs_err"], _max_err(gd, sd))
                outs[name] = gd
            if any(not torch.equal(d, outs["knn"]) for d in outs.values()):
                raise AssertionError(f"kNN ({what}, B={B}, N={N}, k={k}, {order}): d2 differs "
                                     f"across kernels 2, 12 and 13")
            if B != BIG_BATCH:
                _, _, skipped, pruned = kc.knn_query_chunkskip_cuda(
                    qq, xyz, mask, k, with_skipped=True, with_pruned=True)
                plain_skipped = int(pointops.knn_query_chunkskip_plain(
                    qq, xyz, mask, k, with_skipped=True, tm=TQ)[2])
                if int(skipped) != plain_skipped:
                    raise AssertionError(f"kernel 12 ({what}, B={B}, N={N}, k={k}, {order}) "
                                         f"skipped {int(skipped)} chunks, its plain version "
                                         f"{plain_skipped}")
                total = B * -(-M // TQ) * -(-N // kc.chunk_points(N))
                notes.append(f"{order}: kernel 12 skipped {int(skipped)} of {total} (tile, "
                             f"chunk) pairs, as its plain version, {int(pruned)} by boxes")
                if order == "Morton-sorted":
                    skip_share, prune_share = int(skipped) / total, int(pruned) / total
        # times: kernel 2 and 13 on the FPS order, kernel 12 on the sorted queries
        times = {}
        for name, (kernel, plain) in kernels.items():
            if name == "knn_chunkskip" and B == BIG_BATCH:
                continue
            qq = q_sorted if name == "knn_chunkskip" else q
            times[name] = cuda_ms(lambda: kernel(qq, xyz, mask, k), 5)
            case = dict(what=what, B=B, N=N, k=k, ms=times[name])
            case["S"] = {"knn": S2, "knn_chunkskip": S12, "knn_baseline": S13}[name]
            if name != "knn":
                case["TQ"] = TQ if name == "knn_chunkskip" else TQ13
            if name == "knn_chunkskip":
                case.update(skipped_share=skip_share, pruned_share=prune_share)
            res[name]["cases"].append(case)
        log(f"knn     {what} B={B} M=2048 N={N} k={k}: kernels 2, 12 and 13 index-exact, "
            f"d2 bit-equal, relaunches bit-identical; kernel 2 S={S2}, kernel 12 S={S12}, "
            f"TQ={TQ}, kernel 13 S={S13}, TQ={TQ13}; ms: "
            + ", ".join(f"{n} {t:.4f}" for n, t in times.items()) + "; " + "; ".join(notes))
        if (what, B, N, k) == KNN_CASES[0]:
            for name, (kernel, plain) in kernels.items():
                qq = q_sorted if name == "knn_chunkskip" else q
                # kernel 12 computes no distance for the (tile, chunk) pairs
                # its boxes prune, a share of all B * M * N
                pruned = B * N * (prune_share if name == "knn_chunkskip" else 0.0)
                res[name].update(
                    ms=times[name], plain_ms=cuda_ms(lambda: plain(qq, xyz, mask, 16), 2),
                    **knn_bound(q, xyz, mask, 16, pruned))
                log(f"{name} B={B} M=2048 N={N} k=16: kernel {res[name]['ms']:.3f} ms, "
                    f"plain {res[name]['plain_ms']:.3f} ms")
            res["knn_chunkskip"].update(skipped_share=skip_share, pruned_share=prune_share)
            ref = pointops.knn_query_padded_plain(q, xyz, mask, 160)
            for impl in (None,) + tuple(SELECTOR_KERNEL):
                ops.reset_launch_counts()
                with knn_impl(impl):
                    got = pointops.knn_query_padded(q, xyz, mask, 160)
                counts = ops.launch_counts()
                if any(counts[n] for n in KNN_KERNELS):
                    raise AssertionError(f"k=160 launched a kNN kernel: {counts}")
                if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                    raise AssertionError(f"k=160 under PCM_KNN_IMPL={impl} is not the plain kNN")
            log("knn     k=160: the plain version on every selector, no kNN kernel launched")
    return res


def _max_err(got, ref) -> float:
    return (got.float() - ref.float()).abs().max().item()


def hold(what: str, got, ref, tol: float, floor: bool = True) -> tuple[float, float]:
    """(max abs error, max |plain|) of a kernel's ``got`` against its plain
    version's ``ref``; fails past tol * max(1, max |plain|), or tol * max
    |plain| without the ``floor``, where the limit must also be one a zeroed
    output would exceed."""
    err, scale = _max_err(got, ref), ref.float().abs().max().item()
    limit = tol * (max(1.0, scale) if floor else scale)
    if not err <= limit:
        raise AssertionError(f"{what} off by {err:.3e} > {limit:.3e} (max |plain| "
                             f"{scale:.3e})")
    if not floor and not scale > limit:
        raise AssertionError(f"{what}: the limit {limit:.3e} passes a zeroed output")
    return err, scale


def _attention_bounds(B, H, L, dh, dtype: str) -> tuple[dict, dict]:
    """Bounds of the attention forward (4 B H L^2 dh flops; q, k, v read and
    o written) and backward (10 B H L^2 dh flops with S recomputed; q, k, v,
    o, dO read and dq, dk, dv written)."""
    elem = 4 if dtype == "f32" else 2
    t = B * H * L * dh * elem
    return (bound(4.0 * B * H * L * L * dh, 4 * t, dtype),
            bound(10.0 * B * H * L * L * dh, 8 * t, dtype))


def sdpa_ms(q, k, v) -> tuple[float, float]:
    """(forward, forward + backward) ms of one
    ``torch.nn.functional.scaled_dot_product_attention`` at dropout 0 on the
    same inputs: the library yardstick, used nowhere in the port."""
    import torch
    import torch.nn.functional as F

    fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 5)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    dout = torch.ones_like(q)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg)
        torch.autograd.grad(out, (qg, kg, vg), dout)

    return fwd, cuda_ms(fwd_bwd, 5)


def check_attention(dev) -> dict:
    """Phase 3, attention: the forward kernel at rates 0 and 0.1 and the
    backward kernel against their plain versions; the dropout mask read back
    exactly; two backward launches bit-identical."""
    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch.ops import oneshot_attention as one

    res = {}
    rng = np.random.RandomState(0)

    def qkv(B, H, L, dh):
        return [torch.from_numpy(rng.randn(B, H, L, dh).astype(np.float32)).to(dev)
                for _ in range(3)]

    # forward, rate 0 (serving) and 0.1 (training)
    for B, H, L, dh in ((4, 8, 2051, 64), (4, 4, 2051, 128)):
        q, k, v = qkv(B, H, L, dh)
        scale = dh ** -0.5
        for rate in (0.0, ATTN_DROPOUT):
            got = one.oneshot_attention_cuda(q, k, v, scale, rate=rate, seed=11)
            err = _max_err(got, one.oneshot_attention_plain(q, k, v, scale, rate=rate,
                                                            seed=11))
            if not err <= 1e-4:
                raise AssertionError(f"attention kernel (dh={dh}, rate={rate}) off "
                                     f"by {err:.3e}")
            log(f"attn    fwd B={B} H={H} L={L} dh={dh} rate={rate}: max abs err "
                f"{err:.3e}")
            ms = cuda_ms(lambda: one.oneshot_attention_cuda(q, k, v, scale, rate=rate,
                                                            seed=11), 5)
            if dh != 64:
                log(f"attn    fwd dh={dh} rate={rate}: kernel {ms:.3f} ms")
                res.setdefault("attention_fwd", {})[
                    f"ms{'_rate0' if rate == 0.0 else ''}_dh{dh}"] = ms
                continue
            plain_ms = cuda_ms(lambda: one.oneshot_attention_plain(
                q, k, v, scale, rate=rate, seed=11), 5)
            log(f"attn    fwd rate={rate}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
            fwd = res.setdefault("attention_fwd", {})
            fwd.update(max_abs_err=max(err, fwd.get("max_abs_err", 0.0)), plain_ms=plain_ms,
                       **{"ms_rate0" if rate == 0.0 else "ms": ms})
            if rate == 0.0:
                lib_fwd, lib_fb = sdpa_ms(q, k, v)
                log(f"attn    scaled_dot_product_attention f32 B={B} H={H} L={L} dh={dh} "
                    f"rate 0: fwd {lib_fwd:.3f} ms, fwd+bwd {lib_fb:.3f} ms")
                fwd_bound, bwd_bound = _attention_bounds(B, H, L, dh, "f32")
                res["attention_fwd"].update(library_ms=lib_fwd, **fwd_bound)
                res["attention_bwd"] = dict(library_ms=lib_fb - lib_fwd, **bwd_bound)
    # keys padded with junk and masked by l_actual, Lq != Lk
    q = qkv(2, 8, 100, 64)[0]
    k, v = qkv(2, 8, 700, 64)[1:]
    k[:, :, 650:] *= 1e3
    err = _max_err(one.oneshot_attention_cuda(q, k, v, 0.125, l_actual=650),
                   one.oneshot_attention_plain(q, k[:, :, :650], v[:, :, :650], 0.125))
    if not err <= 1e-4:
        raise AssertionError(f"attention kernel with a masked key tail off by {err:.3e}")
    log(f"attn    fwd Lq=100 Lk=700 l_actual=650: max abs err {err:.3e}")

    # the mask read back: q = 0 makes every weight 1/128, v = I picks column j
    B, H, Lq, n = 2, 8, 300, 128
    q = torch.zeros((B, H, Lq, n), device=dev)
    k = qkv(B, H, n, n)[1]
    v = torch.eye(n, device=dev).expand(B, H, n, n)
    out = one.oneshot_attention_cuda(q, k, v, 1.0, rate=ATTN_DROPOUT, seed=12345)
    read = torch.round(out * (n * (1.0 - ATTN_DROPOUT))).to(torch.int64)
    mask = one.keep_mask(12345, ATTN_DROPOUT, H, Lq, n, device=dev).to(torch.int64)
    if not torch.equal(read, mask.expand(B, H, Lq, n)):
        raise AssertionError(f"kernel dropout mask differs from the plain mask at "
                             f"{(read != mask).sum().item()} of {read.numel()} places")
    log(f"attn    mask read back: {read.numel()} keep bits equal the plain mask, "
        f"keep fraction {mask.float().mean().item():.5f} (1 - rate = "
        f"{1 - ATTN_DROPOUT})")

    # backward
    def bwd_case(B, H, Lq, Lk, dh, rate, l_actual=None):
        q = qkv(B, H, Lq, dh)[0]
        k, v = qkv(B, H, Lk, dh)[1:]
        if l_actual is not None:
            k[:, :, l_actual:] *= 1e3
        scale = dh ** -0.5
        out, m, r = one.oneshot_attention_cuda(q, k, v, scale, l_actual, rate, 21,
                                               with_stats=True)
        dout = torch.from_numpy(rng.randn(B, H, Lq, dh).astype(np.float32)).to(dev)
        args = (q, k, v, out, dout, m, r, scale, l_actual, rate, 21)
        return args, one.oneshot_attention_bwd_cuda(*args), \
            one.oneshot_attention_plain_bwd(*args)

    for B, H, Lq, Lk, dh, rate, l_act in ((4, 8, 2051, 2051, 64, 0.0, None),
                                          (4, 8, 2051, 2051, 64, ATTN_DROPOUT, None),
                                          (2, 8, 100, 700, 64, ATTN_DROPOUT, 650),
                                          (2, 4, 515, 515, 128, ATTN_DROPOUT, 500)):
        args, got, ref = bwd_case(B, H, Lq, Lk, dh, rate, l_act)
        if (B, Lq, rate) == (4, 2051, 0.0):  # the kernel at rate 0, beside the library
            bwd_ms_rate0 = cuda_ms(lambda: one.oneshot_attention_bwd_cuda(*args), 5)
        errs, scales = [], []
        for name, g, p in zip(("dq", "dk", "dv"), got, ref):
            err = _max_err(g, p)
            limit = 1e-4 * max(1.0, p.abs().max().item())
            if not err <= limit:
                raise AssertionError(f"attention backward {name} (B={B} Lq={Lq} "
                                     f"Lk={Lk} dh={dh} rate={rate} l_actual={l_act}) "
                                     f"off by {err:.3e} > {limit:.3e}")
            errs.append(err)
            scales.append(p.abs().max().item())
        log(f"attn    bwd B={B} H={H} Lq={Lq} Lk={Lk} dh={dh} rate={rate} "
            f"l_actual={l_act}: max abs err (max |plain|) dq {errs[0]:.3e} "
            f"({scales[0]:.3e}) dk {errs[1]:.3e} ({scales[1]:.3e}) dv {errs[2]:.3e} "
            f"({scales[2]:.3e})")
        if (B, Lq, rate) == (4, 2051, ATTN_DROPOUT):
            again = one.oneshot_attention_bwd_cuda(*args)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError("two identical backward launches differ")
            log("attn    bwd: two identical launches are bit-identical")
            res["attention_bwd"].update(
                max_abs_err=max(errs), ms_rate0=bwd_ms_rate0,
                ms=cuda_ms(lambda: one.oneshot_attention_bwd_cuda(*args), 5),
                plain_ms=cuda_ms(lambda: one.oneshot_attention_plain_bwd(*args), 5))
            t = res["attention_bwd"]
            log(f"attn    bwd: kernel {t['ms']:.3f} ms at rate {rate}, {t['ms_rate0']:.3f} ms "
                f"at rate 0; plain {t['plain_ms']:.3f} ms; library {t['library_ms']:.3f} ms "
                f"(rate 0); bound {t['bound_ms']:.3f} ms; worst error {max(errs):.3e}")
        del args, got, ref
    return res


def check_attention_bf16(dev) -> dict:
    """Phase 3, bf16 attention (the tensor-core kernels of
    ``csrc/attention_mma.cuh``): the forward and backward kernels at rates 0
    and 0.1 against their plain versions within BF16_TOL * max(1,
    max|plain|), the row statistics within 1e-5, the mask read back bit for
    bit, two backward launches bit-identical; each kernel timed at both
    rates; and an edge case at dh = 128, Lq = 70, Lk = 650, l_actual = 600
    (junk keys past l_actual, a ragged last key tile), also on views whose
    rows are not 16-byte aligned."""
    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch.ops import oneshot_attention as one

    bf16 = torch.bfloat16
    res = {}
    rng = np.random.RandomState(1)
    B, H, L, dh = 4, 8, 2051, 64
    scale = dh ** -0.5

    def arr(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev, bf16)

    def fwd_bwd_case(q, k, v, dout, scale, l_actual, rate, what):
        """Forward (with statistics) and backward against the plain versions
        -> (fwd err, statistics err, bwd errs, backward args, kernel grads)."""
        out, m, r = one.oneshot_attention_cuda(q, k, v, scale, l_actual, rate, 11,
                                               with_stats=True)
        ref, m_p, r_p = one.oneshot_attention_plain(q, k, v, scale, l_actual, rate, 11,
                                                    with_stats=True)
        err = hold(f"bf16 attention fwd {what}", out, ref, BF16_TOL)[0]
        stat_err = max(_max_err(m, m_p) / max(1.0, m_p.abs().max().item()),
                       _max_err(r, r_p) / r_p.abs().max().item())
        if not stat_err <= 1e-5:
            raise AssertionError(f"bf16 attention row statistics ({what}) off by "
                                 f"{stat_err:.3e}")
        args = (q, k, v, out, dout, m, r, scale, l_actual, rate, 11)
        got_b = one.oneshot_attention_bwd_cuda(*args)
        ref_b = one.oneshot_attention_plain_bwd(*args)
        errs = [hold(f"bf16 attention bwd {n} {what}", g, p, BF16_TOL)[0]
                for n, g, p in zip(("dq", "dk", "dv"), got_b, ref_b)]
        log(f"attn    bf16 {what}: fwd max abs err {err:.3e} (max |plain| "
            f"{ref.float().abs().max().item():.3e}), statistics {stat_err:.3e}; bwd "
            f"dq/dk/dv {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} (max |plain| "
            f"{'/'.join(f'{t.float().abs().max().item():.3e}' for t in ref_b)})")
        return err, errs, args, got_b

    q, k, v = arr(B, H, L, dh), arr(B, H, L, dh), arr(B, H, L, dh)
    dout = arr(B, H, L, dh)
    fwd_bound, bwd_bound = _attention_bounds(B, H, L, dh, "bf16")
    ms = {}
    for rate in (0.0, ATTN_DROPOUT):
        err, errs, args, got_b = fwd_bwd_case(q, k, v, dout, scale, None, rate,
                                              f"B={B} H={H} L={L} dh={dh} rate={rate}")
        ms[rate] = (
            cuda_ms(lambda: one.oneshot_attention_cuda(q, k, v, scale, None, rate, 11,
                                                       with_stats=True), 5),
            cuda_ms(lambda: one.oneshot_attention_bwd_cuda(*args), 5))
        if rate == 0.0:
            lib_fwd, lib_fb = sdpa_ms(q, k, v)
            log(f"attn    scaled_dot_product_attention bf16 rate 0: fwd {lib_fwd:.3f} ms, "
                f"fwd+bwd {lib_fb:.3f} ms")
            continue
        again = one.oneshot_attention_bwd_cuda(*args)
        if not all(torch.equal(a, b) for a, b in zip(got_b, again)):
            raise AssertionError("two identical bf16 backward launches differ")
        res["attention_fwd_bf16"] = dict(
            max_abs_err=err, library_ms=lib_fwd, **fwd_bound, ms=ms[rate][0],
            ms_rate0=ms[0.0][0],
            plain_ms=cuda_ms(lambda: one.oneshot_attention_plain(
                q, k, v, scale, None, rate, 11, with_stats=True), 5))
        res["attention_bwd_bf16"] = dict(
            max_abs_err=max(errs), library_ms=lib_fb - lib_fwd, **bwd_bound, ms=ms[rate][1],
            ms_rate0=ms[0.0][1],
            plain_ms=cuda_ms(lambda: one.oneshot_attention_plain_bwd(*args), 5))
        for name in ("attention_fwd_bf16", "attention_bwd_bf16"):
            t = res[name]
            log(f"attn    {name}: kernel {t['ms']:.3f} ms at rate {rate}, "
                f"{t['ms_rate0']:.3f} ms at rate 0; plain {t['plain_ms']:.3f} ms; "
                f"library {t['library_ms']:.3f} ms; bound {t['bound_ms']:.3f} ms "
                f"({t['bound_by']})")
        log("attn    bf16 bwd: two identical launches are bit-identical")
    del args, got_b

    # the ragged edge at dh = 128: junk keys past l_actual, Lq != Lk; then
    # views whose rows are not 16-byte aligned (row stride dh + 1), which
    # the kernels load without cp.async
    for dh_e, pad, rate in ((128, 0, 0.0), (128, 0, ATTN_DROPOUT), (64, 1, ATTN_DROPOUT)):
        qe, ke, ve, de = (arr(2, 4, n, dh_e + pad)[..., pad:] for n in (70, 650, 650, 70))
        ke[:, :, 600:] *= 1e3
        fwd_bwd_case(qe, ke, ve, de, dh_e ** -0.5, 600, rate,
                     f"B=2 H=4 Lq=70 Lk=650 l_actual=600 dh={dh_e} rate={rate}"
                     + (", row stride dh + 1" if pad else ""))

    # the mask read back in bf16: q = 0, v = I
    n = 128
    q0 = torch.zeros((2, H, 300, n), device=dev, dtype=bf16)
    k0 = arr(2, H, n, n)
    eye = torch.eye(n, device=dev, dtype=bf16).expand(2, H, n, n)
    out = one.oneshot_attention_cuda(q0, k0, eye, 1.0, rate=ATTN_DROPOUT, seed=12345)
    read = torch.round(out.float() * (n * (1.0 - ATTN_DROPOUT))).to(torch.int64)
    mask = one.keep_mask(12345, ATTN_DROPOUT, H, 300, n, device=dev).to(torch.int64)
    if not torch.equal(read, mask.expand_as(read)):
        raise AssertionError(f"bf16 kernel dropout mask differs from the plain mask at "
                             f"{(read != mask).sum().item()} places")
    log(f"attn    bf16 mask read back: {read.numel()} keep bits equal the plain mask")
    return res


def _fused_mha_bounds(B, L, D, H, dtype: str) -> tuple[dict, dict]:
    """Bounds of the fused layer's forward and backward: each product's flops
    at the peak of its operands' type (the projections in the inputs' type,
    the attention products in bf16, as the TPU kernel rounds q, k, v, e and
    the heads) and the bytes of the inputs read and outputs written once.
    Forward: q, k, v and out projections (4 x 2 B L D^2) and 4 B H L^2 dh of
    attention; backward, as the TPU kernel counts them: q, k, v recomputed,
    dheads, three input and four weight gradients (11 x 2 B L D^2) and six
    L^2 dh products a head (S, P V, dV, dP, dQ, dK)."""
    elem = 4 if dtype == "f32" else 2
    dh = D // H
    proj = 2.0 * B * L * D * D
    attn = 2.0 * B * H * L * L * dh
    params = (4 * D * D + 4 * D) * elem
    act = B * L * D * elem

    def one(n_proj, n_attn, nbytes):
        t_ops = (n_proj * proj / PEAK_FLOPS[dtype] + n_attn * attn / PEAK_FLOPS["bf16"]) * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return dict(bound_ms=max(t_ops, t_bytes),
                    bound_by="bytes" if t_bytes >= t_ops else "operations")

    return one(4, 2, 3 * act + params), one(11, 6, 5 * act + 2 * params)


def mha_library_ms(args, H) -> tuple[float, float]:
    """(forward, forward + backward) ms of one
    ``torch.nn.functional.multi_head_attention_forward`` computing the same
    layer at dropout 0 on the same inputs (separate projection weights,
    ``need_weights=False``): the library yardstick, used nowhere in the
    port."""
    import torch
    import torch.nn.functional as F

    x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo = (
        t.detach().clone().requires_grad_() for t in args)

    def fwd():
        q, v = x_qk.transpose(0, 1), x_v.transpose(0, 1)  # (L, B, D)
        return F.multi_head_attention_forward(
            q, q, v, q.shape[-1], H, None, torch.cat([bq, bk, bv]), None, None, False,
            0.0, wo.t(), bo, training=False, need_weights=False,
            use_separate_proj_weight=True, q_proj_weight=wq.t(), k_proj_weight=wk.t(),
            v_proj_weight=wv.t())[0]

    dout = torch.ones_like(fwd())
    inputs = (x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo)
    with torch.no_grad():
        fwd_ms = cuda_ms(fwd, 5)
    return fwd_ms, cuda_ms(lambda: torch.autograd.grad(fwd(), inputs, dout), 5)


def check_fused_mha(dev) -> dict:
    """Phase 3, the fused attention layer (kernels 7 and 8) at B=4, L=2051,
    D=512, H=8, f32 and bf16, rates 0 and 0.1: the output and each of the ten
    gradients within BF16_TOL * max(1, max |plain|) of the plain versions
    (both round to bf16 at the TPU kernel's points and sum in another
    order); two launches of each bit-identical; kernel, plain and library
    times; also dh=128 (H=4) once."""
    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch.ops import fused_mha as fm

    res = {}
    names = ("dx_qk", "dx_v", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo", "dbo")
    B, L, D, H = 4, 2051, 512, 8

    def inputs(B, L, dtype, seed, D=D):
        rng = np.random.RandomState(seed)
        arr = lambda *s, std=1.0: torch.from_numpy(  # noqa: E731
            (rng.randn(*s) * std).astype(np.float32)).to(dev, dtype)
        x = [arr(B, L, D), arr(B, L, D)]
        wb = [t for _ in range(4) for t in (arr(D, D, std=D ** -0.5), arr(D, std=0.2))]
        return x + wb, arr(B, L, D)

    def check(what, got, ref):
        err = _max_err(got, ref)
        limit = BF16_TOL * max(1.0, ref.float().abs().max().item())
        if not err <= limit:
            raise AssertionError(f"fused_mha {what} off by {err:.3e} > {limit:.3e}")
        return err

    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        suffix = "" if tag == "f32" else "_bf16"
        args, dout = inputs(B, L, dtype, 3)
        fwd_bound, bwd_bound = _fused_mha_bounds(B, L, D, H, tag)
        lib_fwd, lib_fb = mha_library_ms(args, H)
        fwd_errs, bwd_errs = [], []
        for rate in (0.0, ATTN_DROPOUT):
            out = fm.fused_mha_cuda(*args, H, rate, 17)
            ref = fm.fused_mha_plain(*args, H, rate, 17)
            fwd_errs.append(check(f"{tag} fwd rate={rate}", out, ref))
            if not torch.equal(out, fm.fused_mha_cuda(*args, H, rate, 17)):
                raise AssertionError(f"two identical fused_mha {tag} forward launches differ")
            got = fm.fused_mha_bwd_cuda(*args, dout, H, rate, 17)
            want = fm.fused_mha_plain_bwd(*args, dout, H, rate, 17)
            errs = [check(f"{tag} bwd {n} rate={rate}", g, p)
                    for n, g, p in zip(names, got, want)]
            bwd_errs.append(max(errs))
            again = fm.fused_mha_bwd_cuda(*args, dout, H, rate, 17)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"two identical fused_mha {tag} backward launches differ")
            log(f"fmha    {tag} B={B} L={L} D={D} H={H} rate={rate}: fwd max abs err "
                f"{fwd_errs[-1]:.3e} (max |plain| {ref.float().abs().max().item():.3e}); bwd "
                + " ".join(f"{n} {e:.2e}/{p.float().abs().max().item():.2e}"
                           for n, e, p in zip(names, errs, want))
                + "; two launches of each bit-identical")
            del out, ref, got, want, again
        rate = 0.0
        res["fused_mha_fwd" + suffix] = dict(
            max_abs_err=max(fwd_errs), library_ms=lib_fwd, **fwd_bound,
            ms=cuda_ms(lambda: fm.fused_mha_cuda(*args, H, rate, 17), 5),
            plain_ms=cuda_ms(lambda: fm.fused_mha_plain(*args, H, rate, 17), 3))
        res["fused_mha_bwd" + suffix] = dict(
            max_abs_err=max(bwd_errs), library_ms=lib_fb - lib_fwd, **bwd_bound,
            ms=cuda_ms(lambda: fm.fused_mha_bwd_cuda(*args, dout, H, rate, 17), 3),
            plain_ms=cuda_ms(lambda: fm.fused_mha_plain_bwd(*args, dout, H, rate, 17), 2))
        log(f"fmha    {tag} rate 0: fwd kernel {res['fused_mha_fwd' + suffix]['ms']:.3f} ms, "
            f"plain {res['fused_mha_fwd' + suffix]['plain_ms']:.3f} ms, "
            f"multi_head_attention_forward {lib_fwd:.3f} ms; bwd kernel "
            f"{res['fused_mha_bwd' + suffix]['ms']:.3f} ms, plain "
            f"{res['fused_mha_bwd' + suffix]['plain_ms']:.3f} ms, library fwd+bwd less fwd "
            f"{lib_fb - lib_fwd:.3f} ms")
        del args, dout
        torch.cuda.empty_cache()

    # dh = 128 (D=512, H=4), bf16, dropout on, a ragged last tile
    args, dout = inputs(2, 700, torch.bfloat16, 4)
    err = check("dh=128 fwd", fm.fused_mha_cuda(*args, 4, ATTN_DROPOUT, 5),
                fm.fused_mha_plain(*args, 4, ATTN_DROPOUT, 5))
    errs = [check(f"dh=128 bwd {n}", g, p) for n, g, p in zip(
        names, fm.fused_mha_bwd_cuda(*args, dout, 4, ATTN_DROPOUT, 5),
        fm.fused_mha_plain_bwd(*args, dout, 4, ATTN_DROPOUT, 5))]
    log(f"fmha    bf16 B=2 L=700 D=512 H=4 (dh=128) rate={ATTN_DROPOUT}: fwd {err:.3e}, "
        f"bwd worst {max(errs):.3e}")

    def case(what, args, dout, H, ref_args):
        """Forward and backward at rate 0.1 against the plain versions on
        ``ref_args`` (the same values); a second launch of each bit-identical."""
        rate, seed = ATTN_DROPOUT, 11
        out = fm.fused_mha_cuda(*args, H, rate, seed)
        err = check(f"{what} fwd", out, fm.fused_mha_plain(*ref_args, H, rate, seed))
        got = fm.fused_mha_bwd_cuda(*args, dout, H, rate, seed)
        errs = [check(f"{what} bwd {n}", g, p) for n, g, p in zip(
            names, got, fm.fused_mha_plain_bwd(*ref_args, dout, H, rate, seed))]
        again = fm.fused_mha_bwd_cuda(*args, dout, H, rate, seed)
        if not (torch.equal(out, fm.fused_mha_cuda(*args, H, rate, seed))
                and all(torch.equal(a, b) for a, b in zip(got, again))):
            raise AssertionError(f"two identical fused_mha launches differ: {what}")
        log(f"fmha    {what} rate={ATTN_DROPOUT}: fwd {err:.3e}, bwd worst {max(errs):.3e}; "
            f"two launches of each bit-identical")

    def strided(w, how):
        """``w``'s values in a view at other strides: transposed (s_in = 1,
        s_out = D, as ``nn.Linear.weight.t()``), or every other column of a
        wider buffer from an odd offset (no stride 1, rows not 16-byte
        aligned: the GEMMs' plain loads)."""
        if how == "t":
            return w.t().contiguous().t()
        n = w.shape[1]
        view = torch.zeros((w.shape[0], 2 * n + 1), dtype=w.dtype, device=w.device)[:, 1::2]
        view.copy_(w)
        return view

    # weights as transposed views (wk at no unit stride), f32 and bf16
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        args, dout = inputs(2, 700, dtype, 6)
        views = list(args)
        for i, how in ((2, "t"), (4, "s"), (6, "t"), (8, "t")):  # wq, wk, wv, wo
            views[i] = strided(args[i], how)
        strides = [tuple(views[i].stride()) for i in (2, 4, 6, 8)]
        case(f"{tag} B=2 L=700 D={D} H={H}, weights at strides {strides}", views, dout, H, args)
        # D = 256, H = 4 (dh = 64), B L = 1551 rows, not a multiple of 64
        args, dout = inputs(3, 517, dtype, 7, D=256)
        case(f"{tag} B=3 L=517 D=256 H=4", args, dout, 4, args)
        # L = 513: a last 64-row tile of one row, in every kernel of 7 and 8
        args, dout = inputs(2, 513, dtype, 8)
        case(f"{tag} B=2 L=513 D={D} H={H}", args, dout, H, args)
    return res


def _flash_bounds(B, H, Lq, Lk, dh, dtype: str) -> tuple[dict, dict, dict]:
    """Bounds of kernels 9, 10 and 11 on the unpadded rows: 4, 8 and 6
    B H Lq Lk dh flops (S and P V; S, dP, dV and dK; S, dP and dQ) at the
    peak of the inputs' type, or the bytes of q, k, v (and do) read, the
    row statistics (l and m, and di in the backward, f32) and the outputs
    written once."""
    elem = 4 if dtype == "f32" else 2
    qb, kb, stats = B * H * Lq * dh * elem, B * H * Lk * dh * elem, B * H * Lq * 4
    work = float(B * H * Lq * Lk * dh)
    return (bound(4 * work, 2 * qb + 2 * kb + 2 * stats, dtype),
            bound(8 * work, 2 * qb + 4 * kb + 3 * stats, dtype),
            bound(6 * work, 3 * qb + 2 * kb + 3 * stats, dtype))


def check_flash(dev) -> dict:
    """Phase 3, flash attention (kernels 9, 10 and 11) against the plain
    versions: B=4, H=8, L=2051, dh=64 at the adapter's 512-row tiles, f32
    and bf16, rates 0 and 0.1; a small causal case with a bias (its
    gradient ds), a masked key tail, a batch row whose keys are all masked,
    Lq != Lk and 128-row tiles; dh=128; Lq=70, Lk=650 with a
    segment-masked key tail, aligned and not, and causal 48/40-row tiles.
    o, dq, dk, dv and ds within 1e-4 *
    max(1, max |plain|) in f32 and BF16_TOL in bf16, l and m within 1e-5
    relative; two launches of each kernel bit-identical; the mask read back
    bit for bit, the same for every batch item and head. Kernel, plain and
    library times at the flagship shape (10 and 11 also at rate 0)."""
    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch.ops import flash_attention as fa

    res = {}
    rng = np.random.RandomState(5)
    f32, bf16, i32 = torch.float32, torch.bfloat16, torch.int32

    def arr(dtype, *shape, std=1.0):
        return torch.from_numpy((rng.randn(*shape) * std).astype(np.float32)).to(dev, dtype)

    def run(q, k, v, ab, ids, do, kw):
        """(kernels, plain versions): o, l, m, dk, dv, dq, ds; both
        backwards from the kernel's forward. Raises unless a second launch
        of each kernel gives the same bits."""
        o, l, m = fa.flash_attention_cuda(q, k, v, ab, ids, **kw)
        di = (o.float() * do.float()).sum(-1)
        args = (q, k, v, ab, ids, l, m, do, di)
        got = (o, l, m, *fa.flash_attention_bwd_dkv_cuda(*args, **kw),
               *fa.flash_attention_bwd_dq_cuda(*args, **kw))
        again = (*fa.flash_attention_cuda(q, k, v, ab, ids, **kw),
                 *fa.flash_attention_bwd_dkv_cuda(*args, **kw),
                 *fa.flash_attention_bwd_dq_cuda(*args, **kw))
        if not all(a is b or torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("two identical flash launches differ")
        ref = (*fa.flash_attention_plain(q, k, v, ab, ids, **kw),
               *fa.flash_attention_plain_bwd_dkv(*args, **kw),
               *fa.flash_attention_plain_bwd_dq(*args, **kw))
        return got, ref

    def check(what, got, ref, dtype) -> dict:
        errs, scale = {}, {}
        for name, g, r in zip(("o", "l", "m", "dk", "dv", "dq", "ds"), got, ref):
            if r is None:
                continue
            if name in ("l", "m"):
                err = ((g - r).abs() / r.abs().clamp_min(1.0)).max().item()
                lim = 1e-5
            else:
                err = _max_err(g, r)
                lim = (1e-4 if dtype == f32 else BF16_TOL) * max(1.0, r.float().abs().max().item())
            if not err <= lim:
                raise AssertionError(f"flash {what}: {name} off by {err:.3e} > {lim:.3e}")
            errs[name] = err
            scale[name] = r.float().abs().max().item()
        log(f"flash   {what}: max abs err (max |plain|) " + " ".join(
            f"{n} {e:.2e} ({scale[n]:.2e})" for n, e in errs.items())
            + "; relaunches bit-identical")
        return errs

    B, H, L, dh = 4, 8, 2051, 64
    blocks = dict(block_q=FLASH_BLOCK, block_k=FLASH_BLOCK)
    for dtype, tag in ((f32, "f32"), (bf16, "bf16")):
        suffix = "" if tag == "f32" else "_bf16"
        q, k, v, do = (arr(dtype, B, H, L, dh) for _ in range(4))
        worst = {}
        for rate in (0.0, ATTN_DROPOUT):
            kw = dict(sm_scale=dh ** -0.5, dropout_rate=rate, dropout_seed=23, **blocks)
            for n, e in check(f"{tag} B={B} H={H} L={L} dh={dh} rate={rate}",
                              *run(q, k, v, None, None, do, kw), dtype).items():
                worst[n] = max(worst.get(n, 0.0), e)
        # timed at rate 0.1, as the training steps run them; the library at rate 0
        kw = dict(sm_scale=dh ** -0.5, dropout_rate=ATTN_DROPOUT, dropout_seed=23, **blocks)
        o, l, m = fa.flash_attention_cuda(q, k, v, **kw)
        args = (q, k, v, None, None, l, m, do, (o.float() * do.float()).sum(-1))
        lib_fwd, lib_fb = sdpa_ms(q, k, v)
        fwd_b, dkv_b, dq_b = _flash_bounds(B, H, L, L, dh, tag)
        res["flash_fwd" + suffix] = dict(
            max_abs_err=worst["o"], library_ms=lib_fwd, **fwd_b,
            ms=cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw), 5),
            plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), 3))
        res["flash_dkv" + suffix] = dict(
            max_abs_err=max(worst["dk"], worst["dv"]), library_ms=lib_fb - lib_fwd,
            library_of="the whole backward (fwd+bwd less fwd), against flash_dkv + flash_dq",
            **dkv_b, ms=cuda_ms(lambda: fa.flash_attention_bwd_dkv_cuda(*args, **kw), 5),
            plain_ms=cuda_ms(lambda: fa.flash_attention_plain_bwd_dkv(*args, **kw), 2))
        res["flash_dq" + suffix] = dict(
            max_abs_err=worst["dq"], library_ms=None, **dq_b,
            ms=cuda_ms(lambda: fa.flash_attention_bwd_dq_cuda(*args, **kw), 5),
            plain_ms=cuda_ms(lambda: fa.flash_attention_plain_bwd_dq(*args, **kw), 2))
        # kernel 9 at rate 0, beside the library; and the price of one more
        # pass of S over every key: the single-step variant (block_k >= Lk)
        # takes S three times, 512-key blocks twice
        kw0 = dict(kw, dropout_rate=0.0)
        fwd = res["flash_fwd" + suffix]
        fwd["ms_rate0"] = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw0), 5)
        kw1 = dict(kw, block_k=L)
        fwd["ms_single_step"] = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw1), 5)
        log(f"flash   flash_fwd{suffix}: kernel {fwd['ms']:.3f} ms at rate {ATTN_DROPOUT}, "
            f"{fwd['ms_rate0']:.3f} ms at rate 0, {fwd['ms_single_step']:.3f} ms in the "
            f"single-step variant (block_k={L}, rate {ATTN_DROPOUT}); worst error "
            f"{fwd['max_abs_err']:.3e}")
        # kernels 10 and 11 at rate 0: like for like with the library, and
        # the share of Philox
        o0, l0, m0 = fa.flash_attention_cuda(q, k, v, **kw0)
        args0 = (q, k, v, None, None, l0, m0, do, (o0.float() * do.float()).sum(-1))
        for name, fn in (("flash_dkv" + suffix, fa.flash_attention_bwd_dkv_cuda),
                         ("flash_dq" + suffix, fa.flash_attention_bwd_dq_cuda)):
            res[name]["ms_rate0"] = cuda_ms(lambda: fn(*args0, **kw0), 5)
            log(f"flash   {name}: kernel {res[name]['ms']:.3f} ms at rate "
                f"{ATTN_DROPOUT}, {res[name]['ms_rate0']:.3f} ms at rate 0")
        del o0, l0, m0, args0
        log(f"flash   {tag} rate={ATTN_DROPOUT}: fwd kernel {res['flash_fwd' + suffix]['ms']:.3f} "
            f"ms, plain {res['flash_fwd' + suffix]['plain_ms']:.3f} ms, "
            f"scaled_dot_product_attention {lib_fwd:.3f} ms (rate 0); dkv kernel "
            f"{res['flash_dkv' + suffix]['ms']:.3f} ms, plain "
            f"{res['flash_dkv' + suffix]['plain_ms']:.3f} ms; dq kernel "
            f"{res['flash_dq' + suffix]['ms']:.3f} ms, plain "
            f"{res['flash_dq' + suffix]['plain_ms']:.3f} ms; library fwd+bwd less fwd "
            f"{lib_fb - lib_fwd:.3f} ms")
        del q, k, v, do, o, l, m, args
        torch.cuda.empty_cache()

    for dtype, tag in ((f32, "f32"), (bf16, "bf16")):
        # causal with 128-row tiles, a bias, a masked key tail, batch row 1
        # with every key masked, Lq != Lk
        Bs, Hs, Lq, Lk = 2, 2, 700, 650
        q, do = arr(dtype, Bs, Hs, Lq, 64), arr(dtype, Bs, Hs, Lq, 64)
        k, v = arr(dtype, Bs, Hs, Lk, 64), arr(dtype, Bs, Hs, Lk, 64)
        ab = arr(dtype, Bs, Hs, Lq, Lk, std=0.5)
        kv = torch.ones((Bs, Lk), dtype=i32, device=dev)
        kv[:, 600:] = 0
        kv[1] = 0
        ids = fa.SegmentIds(torch.ones((Bs, Lq), dtype=i32, device=dev), kv)
        for rate in (0.0, ATTN_DROPOUT):
            kw = dict(causal=True, sm_scale=0.125, dropout_rate=rate, dropout_seed=7,
                      block_q=128, block_k=128)
            check(f"{tag} causal, bias, masked tail and a fully masked row, Lq={Lq} "
                  f"Lk={Lk}, rate={rate}", *run(q, k, v, ab, ids, do, kw), dtype)
        # dh = 128, a ragged last key block
        q, k, v, do = (arr(dtype, 2, 4, 515, 128) for _ in range(4))
        kw = dict(sm_scale=128 ** -0.5, dropout_rate=ATTN_DROPOUT, dropout_seed=9, **blocks)
        check(f"{tag} B=2 H=4 L=515 dh=128 rate={ATTN_DROPOUT}",
              *run(q, k, v, None, None, do, kw), dtype)
        # kernel 9's other block routes: 1024-key blocks, whose scores do not
        # fit shared memory (computed again in each pass), and the
        # single-step variant (block_k >= Lk), staged and not
        for L, bk in ((2051, 1024), (300, 512), (1100, 2048)):
            q, k, v, do = (arr(dtype, 2, 2, L, 64) for _ in range(4))
            kw = dict(sm_scale=0.125, dropout_rate=ATTN_DROPOUT, dropout_seed=9,
                      block_q=min(FLASH_BLOCK, L), block_k=bk)
            check(f"{tag} B=2 H=2 L={L} dh=64 block_k={bk} rate={ATTN_DROPOUT}",
                  *run(q, k, v, None, None, do, kw), dtype)

    # shapes that stress the mma tiling of kernels 10 and 11 (tensor cores
    # in bf16, 3xTF32 in f32): Lq = 70 and Lk = 650 (ragged 64-row tiles and
    # sub-tiles) with a segment-masked key tail, also on views whose rows
    # are not 16-byte aligned (row stride dh + 1, loaded without cp.async);
    # and a causal case whose TPU tiles straddle the 64-row mma tiles
    Bs, Hs, Lq, Lk = 2, 4, 70, 650
    kv = torch.ones((Bs, Lk), dtype=i32, device=dev)
    kv[:, 600:] = 0
    ids = fa.SegmentIds(torch.ones((Bs, Lq), dtype=i32, device=dev), kv)
    for dtype, tag in ((f32, "f32"), (bf16, "bf16")):
        kw = dict(sm_scale=0.125, dropout_rate=ATTN_DROPOUT, dropout_seed=13, block_q=Lq,
                  block_k=FLASH_BLOCK)
        for pad in (0, 1):
            q, do = (arr(dtype, Bs, Hs, Lq, 64 + pad)[..., pad:] for _ in range(2))
            k, v = (arr(dtype, Bs, Hs, Lk, 64 + pad)[..., pad:] for _ in range(2))
            check(f"{tag} Lq={Lq} Lk={Lk} dh=64, segment-masked key tail, rate={ATTN_DROPOUT}"
                  + (", row stride dh + 1" if pad else ""),
                  *run(q, k, v, None, ids, do, kw), dtype)
        q, k, v, do = (arr(dtype, 2, 2, 300, 64) for _ in range(4))
        kw = dict(causal=True, sm_scale=0.125, dropout_rate=ATTN_DROPOUT, dropout_seed=3,
                  block_q=48, block_k=40)
        check(f"{tag} causal L=300 dh=64 block_q=48 block_k=40 rate={ATTN_DROPOUT}",
              *run(q, k, v, None, None, do, kw), dtype)

    # the mask read back: q = 0 weighs every key alike, v = Lk I in two
    # stripes of 128 columns picks one key a column, so o != 0 where kept
    Lq, Lk, n = 300, 256, 128
    mask = fa.flash_keep_mask(12345, ATTN_DROPOUT, Lq, Lk, device=dev)
    for dtype, tag in ((f32, "f32"), (bf16, "bf16")):
        qz, kz = torch.zeros((2, H, Lq, n), device=dev, dtype=dtype), arr(dtype, 2, H, Lk, n)
        read = []
        for c0 in (0, n):
            vs = torch.zeros((Lk, n), device=dev)
            vs[c0:c0 + n] = torch.eye(n, device=dev) * Lk
            o, _, _ = fa.flash_attention_cuda(
                qz, kz, vs.to(dtype).expand(2, H, Lk, n), dropout_rate=ATTN_DROPOUT,
                dropout_seed=12345, block_q=128, block_k=128)
            read.append(o != 0)
        read = torch.cat(read, dim=-1)
        if not torch.equal(read, mask.expand_as(read)):
            raise AssertionError(f"{tag} flash dropout mask differs from the plain mask at "
                                 f"{(read != mask).sum().item()} of {read.numel()} places")
        log(f"flash   {tag} mask read back: {read.numel()} keep bits equal the plain mask, "
            f"one for every batch item and head; keep fraction "
            f"{mask.float().mean().item():.5f}")
    return res


# phase 3's builder batches (kernels 5 and 6): B=4 (the kernels line's times)
# and the step's B=32
ROUTED_BATCHES = (4, BIG_BATCH)


def builder_inputs(dev, B: int) -> dict:
    """The data-source builder's inputs at the flagship's shapes (B clouds
    of N=10240 points, M=2048 FPS queries, K=16 kNN neighbours, D=512,
    Cin=515, seeded): nn_idx with all-hole queries (the last 8), partial
    holes, duplicate neighbours (exact ties) and queries with one live
    neighbour (rows 300-339: that neighbour holds both tie bits in every
    column, so the routed weight is dvx + dvn); bf16 src, g = src W and h;
    seeded bf16 cotangents dvx and dvn."""
    import torch

    from pointcloudmatters_tpu_torch.entry import build_batch
    from pointcloudmatters_tpu_torch.ops import pointops

    bf16 = torch.bfloat16
    M, K, D, Cin = 2048, 16, 512, 515
    batch = build_batch(batch_size=B, n_points=N_POINTS, seed=2, with_actions=False)
    xyz = torch.from_numpy(batch["pcds"]["coord"]).to(dev)
    mask = torch.from_numpy(batch["pcds"]["valid"]).to(dev)
    idx = pointops.farthest_point_sampling_padded(xyz, mask, M).long()
    new_xyz = torch.gather(xyz, 1, idx[..., None].expand(-1, -1, 3))
    nn_idx, _ = pointops.knn_query_padded(new_xyz, xyz, mask, K)
    nn_idx[:, -8:, :] = -1             # queries with holes only
    nn_idx[:, 100:300, 9:] = -1        # partial holes
    nn_idx[0, 3, 5:] = nn_idx[0, 3, 0]  # duplicate neighbours: exact ties
    nn_idx[:, 300:340, 1:] = -1        # one live neighbour: both tie bits on it
    nn_idx = nn_idx.contiguous()
    gen = torch.Generator(device=dev).manual_seed(0)
    feat = torch.relu(torch.randn((B, N_POINTS, Cin - 3), generator=gen, device=dev))
    src = torch.cat([xyz, feat], -1).to(bf16).contiguous()
    W = (torch.randn((Cin, D), generator=gen, device=dev) * Cin ** -0.5).to(bf16)
    query = torch.cat([new_xyz, torch.zeros_like(feat[:, :M])], -1).to(bf16)
    return dict(src=src, nn_idx=nn_idx, g=(src @ W).contiguous(), h=(query @ W).contiguous(),
                dvx=torch.randn((B, M, D), generator=gen, device=dev).to(bf16),
                dvn=torch.randn((B, M, D), generator=gen, device=dev).to(bf16))


def _check_builder_fwd(g, h, nn_idx, what: str) -> dict:
    """Kernel 5 on one case: vmax, vmin and the tie bitmap equal to the plain
    version's, sg within one bf16 ulp, totals within 1e-5 relative of the
    exact totals (f64 sums of the plain version's x), two launches
    bit-identical; its time (``ms``: ``builder_core_cuda``, as every
    earlier build was timed; ``ms_entry``: the C entry, both kernels, on
    buffers made once), the plain version's and the bound."""
    import torch

    from pointcloudmatters_tpu_torch.ops import fused_builder as fb
    from pointcloudmatters_tpu_torch.ops.pointops import gather_rows_padded

    B, M, K = nn_idx.shape
    D = g.shape[-1]
    got = fb.builder_core_cuda(g, h, nn_idx)
    ref = fb.builder_core_plain(g, h, nn_idx)
    for name, a, b in zip(("vmax", "vmin"), got[:2], ref[:2]):
        if not torch.equal(a, b):
            raise AssertionError(f"builder kernel ({what}) {name} differs from the plain "
                                 f"version at {(a != b).sum().item()} places")
    if not torch.equal(got[3], ref[3]):
        raise AssertionError(f"builder kernel ({what}) tie bitmap differs at "
                             f"{(got[3] != ref[3]).sum().item()} places")
    sg, sg_p = got[2].float(), ref[2].float()
    ulp = torch.exp2(torch.floor(torch.log2(sg_p.abs().clamp_min(1e-30))) - 7)
    if not bool(((sg - sg_p).abs() <= ulp).all()):
        raise AssertionError(f"builder kernel ({what}) sg off by more than one bf16 ulp at "
                             f"{((sg - sg_p).abs() > ulp).sum().item()} places")
    # the totals against their exact values: x as the plain version rounds
    # it, summed in f64 a cloud at a time. The plain version's f32 sums are
    # no reference at 1e-5 where a channel's x nearly cancel (the ragged
    # case's worst channel sums to 2e-5 of its sum |x|, and the plain f32
    # sum misses it by 8.6e-6 relative)
    hole = (nn_idx < 0)[..., None]
    exact = torch.zeros((2, D), dtype=torch.float64, device=g.device)
    for b in range(B):
        gg = torch.where(hole[b:b + 1], 0, gather_rows_padded(g[b:b + 1], nn_idx[b:b + 1]))
        xz = torch.where(hole[b:b + 1], 0, gg - h[b:b + 1, :, None, :]).double()
        exact[0] += xz.sum(dim=(0, 1, 2))
        exact[1] += (xz * xz).sum(dim=(0, 1, 2))
        del gg, xz

    def rel(t):  # worst relative error of (total, total_sq) against the exact ones
        return max(((a.double() - e).abs() / e.abs().clamp_min(1e-300)).max().item()
                   for a, e in zip(t, exact))

    tot_err, plain_tot_err = rel(got[4:]), rel(ref[4:])
    if not tot_err <= 1e-5:
        raise AssertionError(f"builder kernel ({what}) totals off by {tot_err:.3e} relative "
                             f"(the plain version's by {plain_tot_err:.3e})")
    again = fb.builder_core_cuda(g, h, nn_idx)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"two identical builder launches ({what}) differ")
    # the C entry on buffers made once: the wrapper's host time (its checks
    # and six allocations) is above the kernels' at B=4
    lib, dev = fb._lib(), g.device
    outs = [torch.empty_like(t) for t in got[:4]]
    part = torch.empty((lib.pcm_builder_fwd_partials(B, M, D), 2, D), dtype=torch.float32,
                       device=dev)
    totals = torch.empty((2, D), dtype=torch.float32, device=dev)

    def entry():
        err = lib.pcm_builder_fwd(g.data_ptr(), h.data_ptr(), nn_idx.data_ptr(),
                                  *[t.data_ptr() for t in outs], part.data_ptr(),
                                  totals.data_ptr(), B, g.shape[1], M, K, D, dev.index,
                                  fb._stream(dev))
        if err:
            raise RuntimeError(f"pcm_builder_fwd: CUDA error {err}")

    case = dict(
        what=what, B=B, M=M, K=K, D=D, max_abs_err=_max_err(sg, sg_p), totals_rel_err=tot_err,
        plain_totals_rel_err=plain_tot_err,
        sg_bit_equal=bool(torch.equal(got[2], ref[2])),
        max_tie_share=(fb.popcount16(got[3]) > 1).float().mean().item(),
        ms=cuda_ms(lambda: fb.builder_core_cuda(g, h, nn_idx), 20),
        ms_entry=cuda_ms(entry, 20),
        plain_ms=cuda_ms(lambda: fb.builder_core_plain(g, h, nn_idx), 2),
        # g, h, nn read; vmax, vmin, sg (bf16), bm (int32), totals written;
        # ~6 flops an (m, k, d)
        **bound(6.0 * B * M * K * D,
                (g.numel() + h.numel()) * 2 + nn_idx.numel() * 4 + B * M * D * (3 * 2 + 4)
                + 2 * D * 4, "bf16"))
    log(f"builder fwd {what} B={B} N={g.shape[1]} M={M} K={K} D={D}: vmax, vmin, bitmap "
        f"equal, sg within 1 ulp (max abs {case['max_abs_err']:.3e}, bit-equal "
        f"{case['sg_bit_equal']}), totals {tot_err:.3e} relative to the exact ones (plain "
        f"{plain_tot_err:.3e}), relaunch bit-identical, "
        f"{case['max_tie_share']:.4f} of (m, d) with a max tie; kernel {case['ms']:.4f} ms "
        f"(bound {case['bound_ms']:.4f}; {case['ms_entry']:.4f} through the C entry), "
        f"plain {case['plain_ms']:.3f} ms")
    return case


# kernel 5 at the other widths its decomposition takes, (D, queries a
# block, passes over the channels): (128, 16, 1), (384, 5, 1: one thread
# slot idle), (2064, 1, 2: the second pass 2 chunks wide)
BUILDER_WIDTHS = (128, 384, 2064)


def builder_width_inputs(dev, D: int):
    """Kernel 5's inputs at width D, B=2, N=1000, M=301, K=16, seeded: x = g
    - h near 1 (no channel's total cancels), all-hole queries, partial
    holes, duplicate neighbours and one-live-neighbour queries."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(D)
    B, N, M, K = 2, 1000, 301, 16
    g = (torch.randn((B, N, D), generator=gen, device=dev) * 0.5 + 1.0).to(torch.bfloat16)
    h = (torch.randn((B, M, D), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    nn = torch.randint(0, N, (B, M, K), generator=gen, device=dev).to(torch.int32)
    nn[:, -8:] = -1                    # queries with holes only
    nn[:, 100:150, 9:] = -1            # partial holes
    nn[0, 3, 5:] = nn[0, 3, 0]         # duplicate neighbours: exact ties
    nn[:, 200:220, 1:] = -1            # one live neighbour
    return g, h, nn.contiguous()


def check_builder(dev) -> dict:
    """Phase 3, the data-source builder on ``builder_inputs`` at each of
    ROUTED_BATCHES. Kernel 5 (``_check_builder_fwd``) on the flagship shapes
    and, at B=4, on a ragged case (K = 9 of the neighbours, M = 2000 of the
    queries, slices made contiguous), then at each of BUILDER_WIDTHS
    (``builder_width_inputs``); the kernels line's times are B=4's.
    Kernel 6 (on kernel 5's tie bitmap) within 1e-5 * max|dW| of its plain
    version (summation order only: its w_lo product makes every product
    exact), two launches bit-identical; the share of its tiles that ran the
    w_lo product logged, and the time of ``pad_channels``' copy of src."""
    import torch

    from pointcloudmatters_tpu_torch.ops import fused_builder as fb

    fwd_cases, cases = [], []
    for B in ROUTED_BATCHES:
        x = builder_inputs(dev, B)
        src, nn_idx, dvx, dvn = x["src"], x["nn_idx"], x["dvx"], x["dvn"]
        fwd_cases.append(_check_builder_fwd(x["g"], x["h"], nn_idx, "flagship"))
        if B == 4:
            fwd_cases.append(_check_builder_fwd(
                x["g"], x["h"][:, :2000].contiguous(), nn_idx[:, :2000, :9].contiguous(),
                "ragged"))
        bm = fb.builder_core_cuda(x["g"], x["h"], nn_idx)[3]
        _, M, K = nn_idx.shape
        D = bm.shape[-1]
        Cin = src.shape[-1]
        srcp = fb.pad_channels(src)[..., :Cin]  # as the backward hands it over
        dw, lo_share = fb.routed_dw_cuda(srcp, nn_idx, bm, dvx, dvn, with_lo_share=True)
        dw_p = fb.routed_dw_plain(src, nn_idx, bm, dvx, dvn)
        err = _max_err(dw, dw_p)
        limit = 1e-5 * dw_p.abs().max().item()
        if not err <= limit:
            raise AssertionError(f"routed dW kernel (B={B}) off by {err:.3e} > {limit:.3e}")
        if not torch.equal(dw, fb.routed_dw_cuda(srcp, nn_idx, bm, dvx, dvn)):
            raise AssertionError(f"two identical routed dW launches (B={B}) differ")
        case = dict(B=B, max_abs_err=err, limit=limit, lo_share=lo_share.item(),
                    ms=cuda_ms(lambda: fb.routed_dw_cuda(srcp, nn_idx, bm, dvx, dvn), 5),
                    pad_ms=cuda_ms(lambda: fb.pad_channels(src), 5),
                    plain_ms=cuda_ms(lambda: fb.routed_dw_plain(src, nn_idx, bm, dvx, dvn), 2),
                    # 2 B M K Cin D flops on bf16 inputs; src, nn, bm, dvx,
                    # dvn read, dW written
                    **bound(2.0 * B * M * K * Cin * D,
                            src.numel() * 2 + nn_idx.numel() * 4 + B * M * D * (4 + 2 + 2)
                            + Cin * D * 4, "bf16"))
        cases.append(case)
        log(f"routed  dW B={B} M={M} K={K} Cin={Cin} D={D}: max abs err {err:.3e} (limit "
            f"{limit:.3e}), two launches bit-identical, {case['lo_share']:.4f} of tiles ran "
            f"the w_lo product; kernel {case['ms']:.3f} ms (bound {case['bound_ms']:.4f}), "
            f"plain {case['plain_ms']:.3f} ms, pad_channels {case['pad_ms']:.3f} ms")
        del x, src, srcp, nn_idx, bm, dvx, dvn, dw, dw_p
        torch.cuda.empty_cache()
    for D in BUILDER_WIDTHS:
        fwd_cases.append(_check_builder_fwd(*builder_width_inputs(dev, D), f"D={D}"))
    first = {k: v for k, v in fwd_cases[0].items() if k not in ("what", "B", "M", "K", "D")}
    return {"builder_fwd": dict(first, library_ms=None, cases=fwd_cases),
            "routed_dw": dict(cases[0], library_ms=None, cases=cases)}


# attention_impl -> (the serving path's kernels, the small policy's widths and
# cloud size, the B=32 tolerance against the plain versions, the small
# policy's against the CPU): the fused layer rounds to bf16 (kernel and
# plain alike), whose flips carry through the network
SERVING = {
    "oneshot": (PREDICT_KERNELS, SMALL, 600, None, 1e-4),
    "fused": (FUSED_PREDICT_KERNELS, SMALL_FUSED, 1024, 1e-2, 1e-2),
    "flash": (FLASH_PREDICT_KERNELS, SMALL_FLASH, 2048, None, 1e-4),
}


def serve(dev, attention_impl: str = "oneshot") -> dict:
    """Phase 4: the flagship policy through BCModule.predict, with the
    encoder's attention backend ``attention_impl`` ("oneshot" as shipped;
    "fused": kernel 7 in every encoder layer, and never kernel 3; "flash":
    kernel 9 in every encoder layer, and no other attention kernel)."""
    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch.entry import build_batch, build_flagship
    from pointcloudmatters_tpu_torch.models.bc_module import BCModule

    want, small, small_points, rel_tol, small_tol = SERVING[attention_impl]
    module = BCModule(build_flagship(seed=0, attention_impl=attention_impl, device=dev))
    n_params = sum(p.numel() for p in module.policy.parameters())
    if n_params != 24_124_456:
        raise AssertionError(f"flagship has {n_params} parameters")
    requests = [build_batch(batch_size=1, n_points=N_POINTS, seed=s,
                            with_actions=False) for s in (1, 2, 3)]
    big = build_batch(batch_size=BIG_BATCH, n_points=N_POINTS, seed=0,
                      with_actions=False)
    for obs in (requests[0], big):  # warm-up: cuBLAS handles, the allocator's pool
        module.predict(obs)
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    answers = []
    for obs in requests + [big] * 3:
        t0 = time.perf_counter()
        a_hat = module.predict(obs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        B = obs["qpos"].shape[0]
        if tuple(a_hat.shape) != (B, 100, 7) or not torch.isfinite(a_hat).all():
            raise AssertionError(f"a_hat {tuple(a_hat.shape)} at B={B} is not a "
                                 f"finite (B, 100, 7)")
        answers.append(a_hat)
        log(f"predict {attention_impl} B={B:2d} N={N_POINTS}: {ms:.2f} ms")
    launches = ops.launch_counts()
    log(f"launches on the {attention_impl} serving path: {launches}")
    missing = [k for k in want if launches[k] == 0]
    if missing:
        raise AssertionError(f"the {attention_impl} serving path launched no {missing} kernel")
    stray = [k for k in ATTENTION_KERNELS if launches[k] and k not in want]
    if stray:
        raise AssertionError(f"the {attention_impl} serving path launched {stray}")
    if attention_impl == "flash" and launches["flash_fwd"] != ENC_LAYERS * len(answers):
        raise AssertionError(f"kernel 9 ran {launches['flash_fwd']} times over "
                             f"{len(answers)} requests of {ENC_LAYERS} encoder layers")

    with plain_kernels():
        a_plain = module.predict(big)
    torch.cuda.synchronize()
    err = (answers[-1] - a_plain).abs().max().item()
    limit = rel_tol * max(1.0, a_plain.abs().max().item()) if rel_tol else 1e-3
    if not err <= limit:
        raise AssertionError(f"B={BIG_BATCH} {attention_impl} predict with kernels vs "
                             f"plain: {err:.3e} > {limit:.3e}")
    log(f"predict {attention_impl} B={BIG_BATCH} kernels vs plain versions: max abs diff "
        f"{err:.3e}")
    del module, answers, a_plain
    torch.cuda.empty_cache()

    small = dict(small, attention_impl=attention_impl)
    obs = build_batch(batch_size=2, n_points=small_points, chunk=5, seed=4,
                      with_actions=False)
    ref = BCModule(build_flagship(**small, seed=1, device="cpu")).predict(obs)
    got = BCModule(build_flagship(**small, seed=1, device=dev)).predict(obs).cpu()
    err_small = (got - ref).abs().max().item()
    limit = small_tol * max(1.0, ref.abs().max().item()) if rel_tol else small_tol
    if not err_small <= limit:
        raise AssertionError(f"small {attention_impl} policy on the card vs on the CPU: "
                             f"{err_small:.3e} > {limit:.3e}")
    log(f"small {attention_impl} policy on the card vs the CPU: max abs diff {err_small:.3e}")
    return launches


def _step_grads(module, batch, rngs, compute_dtype=None):
    """Loss and parameter gradients of one train-mode forward/backward."""
    module.policy.zero_grad(set_to_none=True)
    out = module.forward_train(batch, rngs, compute_dtype)
    out["loss"].float().backward()
    grads = {n: p.grad.detach().clone() for n, p in module.policy.named_parameters()
             if p.grad is not None}
    return out["loss"].detach(), grads


def _compare_step(what, loss, grads, ref_loss, ref_grads, grad_rtol,
                  loss_rtol=1e-5) -> str:
    """Raises unless the losses agree within loss_rtol relative and each
    gradient within grad_rtol * max(1, max |g_ref|)."""
    loss, ref_loss = float(loss), float(ref_loss)
    rel = abs(loss - ref_loss) / abs(ref_loss)
    if not rel <= loss_rtol:
        raise AssertionError(f"{what}: loss {loss} vs {ref_loss} ({rel:.3e} relative)")
    if set(grads) != set(ref_grads):
        raise AssertionError(f"{what}: gradients of different parameters")
    worst, worst_name = 0.0, None
    for name, g in grads.items():
        ref = ref_grads[name].to(g.device)
        err = (g - ref).abs().max().item() / max(1.0, ref.abs().max().item())
        if not err <= grad_rtol:
            raise AssertionError(f"{what}: gradient {name} off by {err:.3e} of "
                                 f"max(1, max|g|) > {grad_rtol}")
        if err >= worst:
            worst, worst_name = err, name
    return (f"{what}: loss rel diff {rel:.3e}; worst gradient {worst_name} "
            f"{worst:.3e} of max(1, max|g|) ({len(grads)} tensors)")


def timed_steps(dev, path: str, precision: str, dropout: float = ATTN_DROPOUT,
                **flagship_kw) -> dict:
    """The flagship at B=32: one warm-up step, then TRAIN_STEPS steps under
    ``torch.cuda.set_sync_debug_mode("error")`` timed by the host clock to
    ``torch.cuda.synchronize()``. Checks finite losses and grad norms and
    moved parameters; returns the kernels' launches on the timed steps."""
    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch.entry import build_batch, build_flagship
    from pointcloudmatters_tpu_torch.models.bc_module import BCModule, to_device
    from pointcloudmatters_tpu_torch.trainer import Trainer

    module = BCModule(build_flagship(seed=0, dropout=dropout, device=dev, **flagship_kw),
                      optimizer=FLAGSHIP_OPT, lr_scheduler=FLAGSHIP_SCHED)
    trainer = Trainer(precision=precision, seed=0)
    trainer.setup(module, TOTAL_STEPS)
    # on the device before the timed steps, as a loader with pinned memory
    # and non-blocking copies would deliver it
    batch = to_device(build_batch(batch_size=BIG_BATCH, n_points=N_POINTS, seed=0), dev)
    start = [p.detach().clone() for p in module.policy.parameters()]
    trainer.train_step(module, batch)  # warm-up: cuBLAS workspaces, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")  # any host sync in a step raises
    try:
        t0 = time.perf_counter()
        steps = [trainer.train_step(module, batch) for _ in range(TRAIN_STEPS)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [float(m["loss"]) for m in steps]
    norms = [float(m["grad_norm"]) for m in steps]
    log(f"train   {path} B={BIG_BATCH} N={N_POINTS} {precision} dropout {dropout}: "
        f"{step_ms:.2f} ms/step over {TRAIN_STEPS} steps, "
        f"{BIG_BATCH * 1e3 / step_ms:.2f} samples/s, peak device memory "
        f"{peak / 2**30:.2f} GiB; loss {losses}; grad_norm {norms}")
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"{path}: non-finite loss or grad_norm: {losses}, {norms}")
    moved = sum(not torch.equal(a, p) for a, p in zip(start, module.policy.parameters()))
    if moved == 0:
        raise AssertionError(f"{path}: no parameter changed over the training steps")
    log(f"train   {path}: {moved} of {len(start)} parameter tensors changed; "
        f"launches {launches}")
    del module, trainer, batch, start
    torch.cuda.empty_cache()
    return launches


def train(dev) -> dict:
    """Phase 5: the flagship's ``"32-true"`` training step; returns the
    kernels' launches on the timed steps."""
    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch.entry import build_batch, build_flagship
    from pointcloudmatters_tpu_torch.models.bc_module import BCModule, to_device
    from pointcloudmatters_tpu_torch.models.components.act import act as act_module

    launches = timed_steps(dev, "train_step", "32-true")
    missing = [k for k in TRAIN_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"the training path launched no {missing} kernel")

    # B=4: every kernel against every plain version, dropout on, the same
    # generator states
    module = BCModule(build_flagship(seed=0, dropout=ATTN_DROPOUT, device=dev))
    batch = to_device(build_batch(batch_size=4, n_points=N_POINTS, seed=1), dev)
    got = _step_grads(module, batch, module.make_rngs(5))
    with plain_kernels():
        ref = _step_grads(module, batch, module.make_rngs(5))
    log("train   " + _compare_step("B=4 step, kernels vs plain versions", *got, *ref,
                                   grad_rtol=1e-5))
    del module, batch, got, ref
    torch.cuda.empty_cache()

    # a small policy, dropout 0, on the card against the CPU; the posterior
    # noise is one numpy array on both (CPU and CUDA generators differ)
    eps = torch.from_numpy(np.random.RandomState(0).randn(2, 32).astype(np.float32))
    saved = act_module.reparametrize
    act_module.reparametrize = (
        lambda mu, logvar, gen: mu + torch.exp(0.5 * logvar) * eps.to(mu.device))
    try:
        batch = build_batch(batch_size=2, n_points=600, chunk=5, seed=4)
        batch["is_pad"] = np.arange(5)[None].repeat(2, 0) >= 3
        results = []
        for device in ("cpu", dev):
            module = BCModule(build_flagship(**SMALL, seed=1, dropout=0.0, device=device))
            results.append(_step_grads(module, batch, module.make_rngs(5)))
    finally:
        act_module.reparametrize = saved
    log("train   " + _compare_step("small policy step, card vs CPU", *results[1],
                                   *results[0], grad_rtol=1e-4))
    return launches


def train_bf16(dev) -> dict:
    """Phase 6: ``"bf16-mixed"`` steps at B=32 of (a) the flagship as shipped
    and (b) its frozen-backbone variant; returns each one's kernel launches
    on its timed steps."""
    import torch

    from pointcloudmatters_tpu_torch.entry import build_batch, build_flagship
    from pointcloudmatters_tpu_torch.models.bc_module import BCModule, to_device

    launches = {path: timed_steps(dev, path, "bf16-mixed", **kw) for path, kw in (
        ("train_bf16", {}), ("train_bf16_frozen", {"freeze_backbone": True}))}
    for path, counts in launches.items():
        missing = [k for k in BF16_KERNELS if counts[k] == 0]
        if missing:
            raise AssertionError(f"{path} launched no {missing} kernel")
    if any(launches["train_bf16_frozen"][k] == 0 for k in BUILDER_KERNELS):
        raise AssertionError("the frozen-backbone step launched no builder kernel")
    if any(launches["train_bf16"][k] != 0 for k in BUILDER_KERNELS):
        raise AssertionError("the shipped flagship's step launched a builder kernel")

    # B=4, frozen backbone: every bf16 kernel against every plain version,
    # dropout on, the same generator states
    module = BCModule(build_flagship(seed=0, dropout=ATTN_DROPOUT, device=dev,
                                     freeze_backbone=True))
    batch = to_device(build_batch(batch_size=4, n_points=N_POINTS, seed=1), dev)
    got = _step_grads(module, batch, module.make_rngs(5), torch.bfloat16)
    with plain_kernels():
        ref = _step_grads(module, batch, module.make_rngs(5), torch.bfloat16)
    log("train   " + _compare_step("bf16 frozen B=4 step, kernels vs plain versions", *got,
                                   *ref, grad_rtol=BF16_STEP_TOL, loss_rtol=BF16_STEP_TOL))
    return launches


def train_fused(dev) -> dict:
    """Phase 7: steps of the flagship with ``attention_impl="fused"`` at
    dropout 0, at ``"32-true"`` and at ``"bf16-mixed"`` (each encoder
    layer's forward by kernel 7 and backward by kernel 8 of the step's type,
    no oneshot kernel); returns each one's kernel launches on its timed
    steps. Then an f32 and a bf16 B=4 step, each with every kernel against
    every plain version (BF16_STEP_TOL in both: the fused layer rounds to
    bf16 whatever the step's type), and a bf16 B=4 step at dropout 0.1,
    which the fused backend routes to the oneshot kernels and no fused
    kernel."""
    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch.entry import build_batch, build_flagship
    from pointcloudmatters_tpu_torch.models.bc_module import BCModule, to_device

    launches = {}
    for path, precision, want in (("train_fused", "32-true", FUSED_TRAIN_KERNELS),
                                  ("train_bf16_fused", "bf16-mixed", FUSED_BF16_KERNELS)):
        counts = timed_steps(dev, path, precision, dropout=0.0, attention_impl="fused")
        missing = [k for k in want if counts[k] == 0]
        stray = [k for k in ONESHOT_KERNELS + FUSED_KERNELS if counts[k] and k not in want]
        if missing or stray:
            raise AssertionError(f"{path} launched no {missing} kernel, and {stray}")
        launches[path] = counts

    batch = to_device(build_batch(batch_size=4, n_points=N_POINTS, seed=1), dev)
    module = BCModule(build_flagship(seed=0, dropout=0.0, attention_impl="fused", device=dev))
    for dtype, tag in ((None, "f32"), (torch.bfloat16, "bf16")):
        got = _step_grads(module, batch, module.make_rngs(5), dtype)
        with plain_kernels():
            ref = _step_grads(module, batch, module.make_rngs(5), dtype)
        log("train   " + _compare_step(f"{tag} fused B=4 step, kernels vs plain versions",
                                       *got, *ref, grad_rtol=BF16_STEP_TOL,
                                       loss_rtol=BF16_STEP_TOL))
        del got, ref
    del module
    torch.cuda.empty_cache()

    module = BCModule(build_flagship(seed=0, dropout=ATTN_DROPOUT, attention_impl="fused",
                                     device=dev))
    ops.reset_launch_counts()
    got = _step_grads(module, batch, module.make_rngs(5), torch.bfloat16)
    counts = ops.launch_counts()
    if not (torch.isfinite(got[0]) and counts["attention_fwd_bf16"]
            and counts["attention_bwd_bf16"] and not any(counts[k] for k in FUSED_KERNELS)):
        raise AssertionError(f"the fused dropout-{ATTN_DROPOUT} step: loss {float(got[0])}, "
                             f"launches {counts}")
    log(f"train   bf16 fused B=4 step at dropout {ATTN_DROPOUT}: the composed route, "
        f"launches {counts}")
    with plain_kernels():
        ref = _step_grads(module, batch, module.make_rngs(5), torch.bfloat16)
    log("train   " + _compare_step(f"bf16 fused B=4 step at dropout {ATTN_DROPOUT}, kernels "
                                   f"vs plain versions", *got, *ref, grad_rtol=BF16_STEP_TOL,
                                   loss_rtol=BF16_STEP_TOL))
    return launches


def train_flash(dev) -> dict:
    """Phase 8: steps of the flagship with ``attention_impl="flash"`` at the
    shipped dropout 0.1, at ``"32-true"`` and at ``"bf16-mixed"``, timed as
    phase 5 times them: kernels 9, 10 and 11 of the step's type in every
    encoder layer of every step, and no other attention kernel. Then a B=4
    step of each type with every kernel against every plain version from
    the same generators, so the same masks (f32 1e-5, as phase 5; bf16
    BF16_STEP_TOL).
    Returns each timed run's kernel launches."""
    import torch

    from pointcloudmatters_tpu_torch.entry import build_batch, build_flagship
    from pointcloudmatters_tpu_torch.models.bc_module import BCModule, to_device

    launches = {}
    for path, precision, want in (("train_flash", "32-true", FLASH_TRAIN_KERNELS),
                                  ("train_bf16_flash", "bf16-mixed", FLASH_BF16_KERNELS)):
        counts = timed_steps(dev, path, precision, attention_impl="flash")
        missing = [k for k in want if counts[k] == 0]
        stray = [k for k in ATTENTION_KERNELS if counts[k] and k not in want]
        uneven = [k for k in want if k.startswith("flash")
                  and counts[k] != ENC_LAYERS * TRAIN_STEPS]
        if missing or stray or uneven:
            raise AssertionError(f"{path} launched no {missing} kernel, {stray}, and "
                                 f"{uneven} not once a layer and step: {counts}")
        launches[path] = counts

    batch = to_device(build_batch(batch_size=4, n_points=N_POINTS, seed=1), dev)
    module = BCModule(build_flagship(seed=0, dropout=ATTN_DROPOUT, attention_impl="flash",
                                     device=dev))
    for dtype, tag, tol in ((None, "f32", 1e-5),
                            (torch.bfloat16, "bf16", BF16_STEP_TOL)):
        got = _step_grads(module, batch, module.make_rngs(5), dtype)
        with plain_kernels():
            ref = _step_grads(module, batch, module.make_rngs(5), dtype)
        log("train   " + _compare_step(
            f"flash {tag} B=4 step at dropout {ATTN_DROPOUT}, kernels vs plain versions",
            *got, *ref, grad_rtol=tol, loss_rtol=tol))
        del got, ref
    return launches


def serve_selectors(dev) -> dict:
    """Phase 9, the kNN selector (``PCM_KNN_IMPL``) end to end. The flagship
    (oneshot encoder, seeded weights) through ``BCModule.predict`` at
    N=10240 under ``chunkskip`` and under ``baseline``: after a warm-up
    request at each batch size, 3 requests at B=1 and 3 at B=32; the
    selector's kernel (12 or 13) once in every request and kernel 2 never;
    the B=32 answer bit-equal to the default route's (kernel 2, phase 4's
    answer) on the same weights and batch. Then N=20480 with the variable
    unset, the automatic route: kernel 12 in every request, kernel 2 never,
    the B=32 answer within 1e-3 of the all-plain version. Then
    ``PCM_KNN_IMPL=bogus``: ``predict`` raises ``ValueError`` and launches
    no kNN kernel. Last, a warmed bf16 B=32 training step under
    ``chunkskip``, timed as phase 5 times them: kernel 12 once a step,
    kernel 2 never. Returns each run's kernel launches by path."""
    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch.entry import build_batch, build_flagship
    from pointcloudmatters_tpu_torch.models.bc_module import BCModule

    module = BCModule(build_flagship(seed=0, device=dev))
    launches = {}

    def serve_path(path, n_points, want):
        """3 warmed requests at B=1 and 3 at B=32; returns the B=32 batch and
        the last answer."""
        small = [build_batch(batch_size=1, n_points=n_points, seed=s, with_actions=False)
                 for s in (1, 2, 3)]
        big = build_batch(batch_size=BIG_BATCH, n_points=n_points, seed=0, with_actions=False)
        for obs in (small[0], big):  # warm-up
            module.predict(obs)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        answers = []
        for obs in small + [big] * 3:
            t0 = time.perf_counter()
            a_hat = module.predict(obs)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            B = obs["qpos"].shape[0]
            if tuple(a_hat.shape) != (B, 100, 7) or not torch.isfinite(a_hat).all():
                raise AssertionError(f"{path}: a_hat {tuple(a_hat.shape)} at B={B} is not a "
                                     f"finite (B, 100, 7)")
            answers.append(a_hat)
            log(f"predict {path} B={B:2d} N={n_points}: {ms:.2f} ms")
        counts = ops.launch_counts()
        log(f"launches on {path}: {counts}")
        if counts[want] != len(answers) or any(counts[k] for k in KNN_KERNELS if k != want):
            raise AssertionError(f"{path}: want {want} once a request ({len(answers)}) and "
                                 f"no other kNN kernel, got {counts}")
        launches[path] = counts
        return big, answers[-1]

    with knn_impl(None):
        ref = module.predict(build_batch(batch_size=BIG_BATCH, n_points=N_POINTS, seed=0,
                                         with_actions=False))
    for impl, kernel in SELECTOR_KERNEL.items():
        with knn_impl(impl):
            _, a_hat = serve_path("predict_" + impl, N_POINTS, kernel)
        if not torch.equal(a_hat, ref):
            raise AssertionError(f"B={BIG_BATCH} predict under PCM_KNN_IMPL={impl} differs from "
                                 f"the default route by {(a_hat - ref).abs().max().item():.3e}")
        log(f"predict PCM_KNN_IMPL={impl} B={BIG_BATCH}: bit-equal to the default route")

    with knn_impl(None):
        big, a_hat = serve_path("predict_auto", BIG_CLOUD, "knn_chunkskip")
        with plain_kernels():
            a_plain = module.predict(big)
    err = (a_hat - a_plain).abs().max().item()
    if not err <= 1e-3:
        raise AssertionError(f"B={BIG_BATCH} N={BIG_CLOUD} predict with kernels vs plain: "
                             f"{err:.3e} > 1e-3")
    log(f"predict N={BIG_CLOUD} B={BIG_BATCH}, variable unset: kernel 12, kernels vs plain "
        f"versions max abs diff {err:.3e}")

    ops.reset_launch_counts()
    with knn_impl("bogus"):
        try:
            module.predict(build_batch(batch_size=1, n_points=N_POINTS, seed=1,
                                       with_actions=False))
        except ValueError as exc:
            log(f"predict PCM_KNN_IMPL=bogus: ValueError ({exc})")
        else:
            raise AssertionError("PCM_KNN_IMPL=bogus did not raise")
    if any(ops.launch_counts()[k] for k in KNN_KERNELS):
        raise AssertionError(f"PCM_KNN_IMPL=bogus launched a kNN kernel: {ops.launch_counts()}")
    del module, ref, a_hat, a_plain
    torch.cuda.empty_cache()

    with knn_impl("chunkskip"):
        counts = timed_steps(dev, "train_bf16_chunkskip", "bf16-mixed")
    if counts["knn_chunkskip"] != TRAIN_STEPS or any(
            counts[k] for k in KNN_KERNELS if k != "knn_chunkskip"):
        raise AssertionError(f"the chunkskip bf16 step: want kernel 12 once a step and no "
                             f"other kNN kernel, got {counts}")
    launches["train_bf16_chunkskip"] = counts
    return launches


# phase 10: the flagship trained as shipped (scratch_pointnet_pcd.yaml: batch
# 8, accumulate_grad_batches 2; maniskill2_act_pcd_dataset.yaml: one camera
# of 128 x 128 points, its transforms, pin_memory, pad_multiple 512) over
# synthetic demos, 6 episodes to train on and 2 held out
FIT_CAM_SIDE = 128
FIT_EPISODES, FIT_HELD_OUT, FIT_EPISODE_LEN = 8, 2, 60
FIT_BATCH, FIT_ACCUMULATE, FIT_MICRO_STEPS = 8, 2, 8
FIT_LOOP = 12  # 6 episodes x 12 = 72 samples: 9 batches of 8, one more than the fit takes
FIT_WORKERS = 4
FIT_VAL_BATCHES = 4  # at the config's batch_size_val of 1
FLAGSHIP_PARAMS = 24_124_456
ACT_KERNELS = ("fps", "knn", "attention_fwd_bf16", "attention_bwd_bf16")
# a micro-step's launches of each: FPS and kNN once, the attention kernels once
# in each encoder layer
ACT_KERNELS_A_STEP = {"fps": 1, "knn": 1, "attention_fwd_bf16": ENC_LAYERS,
                      "attention_bwd_bf16": ENC_LAYERS}
EVAL_KERNELS_A_BATCH = {"fps": 1, "knn": 1, "attention_fwd": ENC_LAYERS}


def synthetic_demos(n_episodes: int, episode_len: int, cam_side: int, seed: int = 0) -> list:
    """Trajectories in the ManiSkill2 layout that ``tests/synth.py`` writes
    (actions, agent qpos, the camera's xyzw and rgb, its RGB-D images
    ``obs.image.base_camera.{rgb,depth}`` at cam_side x cam_side, the goal
    position), held in memory: its tabletop cloud, xy in [-0.2, 0.2] and z in
    [0, 0.3] with about 20% w = 0 points and the ground band z <= 0.005 that
    the dataset drops; uint8 RGB and depth in mm below 2048; the flagship's
    widths (qpos 9, action 7, goal 3). The images come from a stream of
    their own, so the other arrays are those of the demos without them."""
    import numpy as np

    rng, image_rng = np.random.RandomState(seed), np.random.RandomState(seed + 1)
    n = cam_side * cam_side
    demos = []
    for _ in range(n_episodes):
        xyz = rng.rand(episode_len + 1, n, 3).astype(np.float32)
        xyz[..., :2] = (xyz[..., :2] - 0.5) * 0.4
        xyz[..., 2] *= 0.3
        w = (rng.rand(episode_len + 1, n, 1) > 0.2).astype(np.float32)
        frames = (episode_len + 1, cam_side, cam_side)
        demos.append({
            "actions": rng.randn(episode_len, 7).astype(np.float32),
            "obs": {
                "agent": {"qpos": rng.randn(episode_len + 1, 9).astype(np.float32)},
                "pointcloud": {
                    "xyzw": np.concatenate([xyz, w], -1),
                    "rgb": rng.randint(0, 255, (episode_len + 1, n, 3)).astype(np.uint8)},
                "image": {"base_camera": {
                    "rgb": image_rng.randint(0, 255, frames + (3,)).astype(np.uint8),
                    "depth": (image_rng.rand(*frames, 1) * 2048).astype(np.float32)}},
                "extra": {"goal_pos": rng.randn(episode_len + 1, 3).astype(np.float32)},
            },
        })
    return demos


class TimedLoader:
    """A loader that times how long the training loop waits for each batch,
    and keeps each batch's points a cloud and padded width."""

    def __init__(self, loader):
        self.loader, self.dataset, self.runs = loader, loader.dataset, []

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        run = dict(wait=0.0, counts=[], widths=set(), start=None, end=None)
        self.runs.append(run)
        batches = iter(self.loader)
        try:
            while True:
                t0 = time.perf_counter()
                run["start"] = run["start"] or t0
                try:
                    batch = next(batches)
                except StopIteration:
                    return
                run["wait"] += time.perf_counter() - t0
                run["counts"] += batch["pcds"]["count"].tolist()
                run["widths"].add(int(batch["pcds"]["coord"].shape[1]))
                yield batch
        finally:
            run["end"] = time.perf_counter()
            batches.close()


class StepClock:
    """A logger keeping the host clock at each logged micro-step: the
    trainer reads the step's floats first, which waits for the card."""

    def __init__(self):
        self.rows = []

    def log_metrics(self, metrics, step):
        self.rows.append((time.perf_counter(), step, dict(metrics)))

    def finalize(self):
        pass


ACT_PCD, DP_PCD, ACT_RGBD, DP_RGBD = (
    "ManiSkill2GoalPosSingleTaskACTPCDDataset",
    "ManiSkill2GoalPosSingleTaskDiffusionPolicyPCDDataset",
    "ManiSkill2GoalPosSingleTaskACTRGBDDataset",
    "ManiSkill2GoalPosSingleTaskDiffusionPolicyRGBDDataset")


def in_memory_dataset(trajs, dataset: str = ACT_PCD, **kw):
    """The port's ManiSkill2 dataset class ``dataset`` (the ACT point-cloud
    one, the Diffusion Policy's, or the ACT RGB-D one) over demos held in
    memory, so that the run needs no h5py: only the file read is replaced
    (the class keeps its base's name, which picks the collate as the
    configs' class names do)."""
    import copy

    from pointcloudmatters_tpu_torch.data.components import maniskill2 as ms2

    base = getattr(ms2, dataset)

    def __init__(self, trajs, **kw):
        self.trajs = trajs
        base.__init__(self, dataset_file="held-in-memory.h5", **kw)

    def _read_file(self, episode_ids):
        meta = {"episodes": [{"episode_id": i} for i in range(len(self.trajs))],
                "env_info": {"env_id": "PickCube-v0", "env_kwargs": {"obs_mode": "pointcloud"}}}
        return meta, [copy.deepcopy(self.trajs[i]) for i in episode_ids]

    cls = type(f"InMemory{base.__name__}", (base,), {"__init__": __init__,
                                                     "_read_file": _read_file})
    return cls(trajs, **kw)


def fit_transforms() -> list:
    """The point-cloud transforms of ``configs/data/maniskill2_act_pcd_dataset.yaml``."""
    from pointcloudmatters_tpu_torch.data.components import transformpcd as T

    return [T.GridSamplePCD(grid_size=0.005, hash_type="fnv", mode="train",
                            return_grid_coord=True, return_displacement=False,
                            keys=("coord", "color")),
            T.NormalizeColorPCD(), T.ShufflePointPCD(), T.ToTensorPCD(),
            T.CollectPCD(keys=("coord", "grid_coord"), feat_keys=("color", "coord"))]


def held_out_dataset(trajs, cache_dir: str):
    """Held-out demos, twice each, with the config's keys and transforms."""
    return in_memory_dataset(trajs, transform_pcd=fit_transforms(), loop=2,
                             goal_cond_keys=["goal_pos"], chunk_size=100, camera_ids=[0],
                             point_num_per_cam=FIT_CAM_SIDE ** 2, cache_dir=cache_dir)


def fit_datasets(cache_dir: str) -> tuple:
    """Phase 10's train set (6 episodes, FIT_LOOP times) and held-out set (2
    episodes, twice): the port's ManiSkill2 ACT point-cloud dataset with the
    config's transforms over synthetic demos held in memory."""
    demos = synthetic_demos(FIT_EPISODES, FIT_EPISODE_LEN, FIT_CAM_SIDE)
    n_train = FIT_EPISODES - FIT_HELD_OUT
    return (in_memory_dataset(demos[:n_train], transform_pcd=fit_transforms(), loop=FIT_LOOP,
                              goal_cond_keys=["goal_pos"], chunk_size=100, camera_ids=[0],
                              point_num_per_cam=FIT_CAM_SIDE ** 2, cache_dir=cache_dir),
            held_out_dataset(demos[n_train:], cache_dir))


def fit_data(train_set, val=None, workers: int = FIT_WORKERS):
    """The config's datamodule (pinned batches, pad_multiple 512, batch 8,
    validation batch 1; validation over the configs' ``DummyDataset``
    unless ``val`` is given) whose train loader is a ``TimedLoader``
    (``.timed``)."""
    from pointcloudmatters_tpu_torch.data.base_datamodule import BaseDataModule
    from pointcloudmatters_tpu_torch.data.components.misc import DummyDataset

    class TimedData(BaseDataModule):
        def train_dataloader(self):
            self.timed = TimedLoader(super().train_dataloader())
            return self.timed

    return TimedData(train=train_set, val=DummyDataset(size=400) if val is None else val,
                     batch_size_train=FIT_BATCH, batch_size_val=1, num_workers=workers,
                     pin_memory=True, pad_multiple=512)


def fit_module(dev):
    """The flagship's task module over the seeded flagship (dropout 0.1) with
    its config's AdamW + OneCycleLR."""
    from pointcloudmatters_tpu_torch.entry import build_flagship
    from pointcloudmatters_tpu_torch.models.maniskill2_modules import ManiSkill2ACTBCModule

    module = ManiSkill2ACTBCModule(build_flagship(seed=0, dropout=ATTN_DROPOUT, device=dev),
                                   optimizer=FLAGSHIP_OPT, lr_scheduler=FLAGSHIP_SCHED,
                                   env_id="PickCube-v0")
    n_params = sum(p.numel() for p in module.policy.parameters())
    if n_params != FLAGSHIP_PARAMS:
        raise AssertionError(f"the flagship has {n_params} parameters, not {FLAGSHIP_PARAMS}")
    return module


def fit_trainer(root: str, **kw):
    """``Trainer`` as phase 10 fits: bf16-mixed on the card, k = 2, one
    epoch of FIT_MICRO_STEPS micro-steps, the floats read every 2."""
    from pointcloudmatters_tpu_torch.trainer import Trainer

    return Trainer(accelerator="gpu", devices=1, precision="bf16-mixed",
                   accumulate_grad_batches=FIT_ACCUMULATE, max_epochs=1,
                   limit_train_batches=FIT_MICRO_STEPS, log_every_n_steps=2,
                   default_root_dir=root, seed=0, **kw)


def timed_fit(dev, module, data, root: str) -> dict:
    """A warmed fit timed by the host clock between logged micro-steps (the
    second of every optimizer step): ms a step, samples/s, the share of the
    loop waiting on the loader, the loop's seconds, peak memory, points a
    cloud and padded widths."""
    import torch

    clock = StepClock()
    torch.cuda.reset_peak_memory_stats(dev)
    fit_trainer(root, logger=clock, check_val_every_n_epoch=0).fit(module, data)
    marks = [t for t, step, m in clock.rows if "grad_norm" in m]
    run = data.timed.runs[-1]
    step_ms = (marks[-1] - marks[0]) * 1e3 / (len(marks) - 1)
    epoch_rate = next(m["samples_per_sec"] for _, _, m in clock.rows if "samples_per_sec" in m)
    return dict(step_ms=step_ms, steps=len(marks) - 1, epoch_samples_per_s=epoch_rate,
                samples_per_s=FIT_BATCH * FIT_ACCUMULATE * 1e3 / step_ms,
                wait_share=run["wait"] / (run["end"] - run["start"]),
                loop_s=run["end"] - run["start"], peak=torch.cuda.max_memory_allocated(dev),
                counts=run["counts"], widths=sorted(run["widths"]))


def fit_flagship(dev) -> dict:
    """Phase 10: ``Trainer.fit`` of the flagship as shipped: its task module
    (``ManiSkill2ACTBCModule``), ``"bf16-mixed"``, gradient accumulation 2,
    over the ported data pipeline; then ``Trainer.validate`` of a base
    ``BCModule`` on held-out demos. Returns the kernels' launches of the fit
    and of the validation, and the warmed fit's times."""
    import tempfile

    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch.data import native
    from pointcloudmatters_tpu_torch.data.base_datamodule import BaseDataModule
    from pointcloudmatters_tpu_torch.models.bc_module import BCModule, to_device
    from pointcloudmatters_tpu_torch.trainer import Trainer

    class Record:
        def __init__(self):
            self.val = []

        def setup(self, trainer, model): pass
        def on_fit_start(self, trainer, model): pass
        def on_train_epoch_end(self, trainer, model, metrics, epoch): pass
        def on_fit_end(self, trainer, model): pass

        def on_validation_end(self, trainer, model, metrics, epoch):
            self.val.append(dict(metrics))

    t0 = time.perf_counter()
    route = native.route()  # builds native/pcm_native.cpp on first use
    cache = tempfile.TemporaryDirectory()  # norm statistics of this run only
    train_set, held_out = fit_datasets(cache.name)
    data = fit_data(train_set)
    log(f"fit     grid sampling route: {route}; {FIT_EPISODES} synthetic episodes of "
        f"{FIT_EPISODE_LEN} steps, {FIT_CAM_SIDE ** 2} points a camera, in "
        f"{time.perf_counter() - t0:.1f} s")
    module = fit_module(dev)
    params = [p for p in module.policy.parameters()]
    stats = [b for n, b in module.policy.named_buffers() if n.endswith((".mean", ".var"))]

    def flat(tensors):
        return torch.cat([t.detach().flatten() for t in tensors])

    # after every micro-step (train_metrics.update ends the step): the
    # parameters, the batch statistics and the step's metrics, kept on the
    # card and compared after the fit
    shots, update = [(flat(params), flat(stats), None)], module.train_metrics.update

    def keep(outputs, weight=1.0):
        update(outputs, weight)
        shots.append((flat(params), flat(stats), dict(outputs)))

    module.train_metrics.update = keep
    record = Record()
    fit = fit_trainer(cache.name, callbacks=[record])
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    fit.fit(module, data)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    log(f"fit     {FIT_MICRO_STEPS} micro-steps at B={FIT_BATCH}, {FIT_ACCUMULATE} a step: "
        f"{time.perf_counter() - t0:.2f} s with the first steps' warm-up; launches {launches}")
    module.train_metrics.update = update

    steps = module.scheduler.last_epoch
    opt_steps = {int(s["step"]) for s in module.optimizer.state.values()}
    if (fit.global_step, steps, opt_steps) != (FIT_MICRO_STEPS, 4, {4}):
        raise AssertionError(f"want 8 micro-steps, 4 optimizer and schedule steps: got "
                             f"{fit.global_step}, {steps}, {opt_steps}")
    for i, (prev, now) in enumerate(zip(shots, shots[1:]), start=1):
        if torch.equal(prev[1], now[1]):
            raise AssertionError(f"micro-step {i} left the batch statistics as they were")
        if torch.equal(prev[0], now[0]) != (i % 2 == 1):
            raise AssertionError(f"micro-step {i} {'moved' if i % 2 else 'left'} the "
                                 f"parameters: the optimizer steps on every second one")
    losses = [float(m["loss"]) for *_, m in shots[1:]]
    norms = [float(m["grad_norm"]) for *_, m in shots[1:]]
    if not np.isfinite(losses + norms).all():
        raise AssertionError(f"fit: non-finite loss or grad_norm: {losses}, {norms}")
    log(f"fit     parameters bit-equal after micro-steps 1, 3, 5, 7 and moved after 2, 4, 6, 8; "
        f"batch statistics moved after each; loss {losses}; grad_norm {norms}")
    want = {k: n * FIT_MICRO_STEPS for k, n in ACT_KERNELS_A_STEP.items()}
    got = {k: launches[k] for k in ACT_KERNELS}
    stray = {k: n for k, n in launches.items() if k not in ACT_KERNELS and n}
    if got != want or stray:
        raise AssertionError(f"fit: want {want} launches and no other kernel, got {launches}")
    if record.val != [{}]:
        raise AssertionError(f"ManiSkill2ACTBCModule's validation over DummyDataset: want "
                             f"{{}}, got {record.val}")
    log("fit     ManiSkill2ACTBCModule validation over the configs' DummyDataset: {}")
    del shots
    torch.cuda.empty_cache()

    t = timed_fit(dev, module, data, cache.name)  # warmed: the same fit again
    counts = np.asarray(t["counts"])
    log(f"fit     B={FIT_BATCH} x {FIT_ACCUMULATE} bf16-mixed, warmed: {t['step_ms']:.2f} ms "
        f"per optimizer step over {t['steps']}, {t['samples_per_s']:.2f} samples/s, loader "
        f"wait {100 * t['wait_share']:.1f}% of the loop's {t['loop_s']:.2f} s ({FIT_WORKERS} "
        f"threads), peak device memory {t['peak'] / 2**30:.2f} GiB; points a cloud after grid "
        f"sampling mean {counts.mean():.1f}, max {counts.max()}, padded to {t['widths']}; "
        f"grid sampling {route}")

    # one accumulated pair of micro-steps with every kernel against the same
    # pair on the plain versions, from the same state, generators and batches
    batches = iter(data.train_dataloader())
    pair = [to_device(next(batches), dev) for _ in range(FIT_ACCUMULATE)]
    batches.close()
    start = {k: v.clone() for k, v in module.policy.state_dict().items()}

    def accumulated_pair():
        module.policy.load_state_dict(start)
        tr = Trainer(accelerator="gpu", precision="bf16-mixed",
                     accumulate_grad_batches=FIT_ACCUMULATE, seed=5)
        tr.setup(module, TOTAL_STEPS)
        loss = sum(tr.train_step(module, b)["loss"] for b in pair) / len(pair)
        return (loss, {n: p.grad.detach().clone() for n, p in module.policy.named_parameters()},
                {n: p.detach().clone() for n, p in module.policy.named_parameters()})

    got = accumulated_pair()
    with plain_kernels():
        ref = accumulated_pair()
    log("fit     " + _compare_step("accumulated pair, mean gradient, kernels vs plain versions",
                                   *got[:2], *ref[:2], grad_rtol=BF16_STEP_TOL,
                                   loss_rtol=BF16_STEP_TOL))
    worst = max((got[2][n] - ref[2][n]).abs().max().item() / max(1.0, ref[2][n].abs().max().item())
                for n in ref[2])
    if not worst <= BF16_STEP_TOL:
        raise AssertionError(f"accumulated pair: updated parameters off by {worst:.3e}")
    log(f"fit     accumulated pair, updated parameters: worst {worst:.3e} of max(1, max|p|)")
    del pair, start, got, ref
    torch.cuda.empty_cache()

    # held-out validation of a base BCModule (the mean loss) over the demos
    # kept out of training
    evaluate = BCModule(module.policy, optimizer=FLAGSHIP_OPT, lr_scheduler=FLAGSHIP_SCHED)
    val_data = BaseDataModule(train=train_set, val=held_out, batch_size_train=FIT_BATCH,
                              batch_size_val=1, num_workers=FIT_WORKERS, pad_multiple=512)
    ops.reset_launch_counts()
    metrics = Trainer(accelerator="gpu", precision="bf16-mixed", limit_val_batches=FIT_VAL_BATCHES,
                      default_root_dir=cache.name).validate(evaluate, val_data)
    val_launches = ops.launch_counts()
    if set(metrics) != {"val/loss", "val/loss_best"} or not np.isfinite(
            list(metrics.values())).all():
        raise AssertionError(f"held-out validation: {metrics}")
    # the eval forward runs the f32 parameters at dropout 0, as JAX's
    want = {k: n * FIT_VAL_BATCHES for k, n in EVAL_KERNELS_A_BATCH.items()}
    if {k: n for k, n in val_launches.items() if n} != {k: n for k, n in want.items() if n}:
        raise AssertionError(f"held-out validation: want {want} launches, got {val_launches}")
    log(f"fit     held-out validation over {FIT_VAL_BATCHES} batches of 1: {metrics}; "
        f"launches {val_launches}")
    cache.cleanup()
    del module, evaluate, train_set, held_out, data, val_data
    torch.cuda.empty_cache()
    return {"fit": launches, "validate": val_launches}, t


# phase 11: the flagship through the port's entry points, as the README runs
# it: python -m pointcloudmatters_tpu_torch.train exp_maniskill2_act_policy=base
# ...maniskill2_model=scratch_pointnet_pcd ...maniskill2_pcd_task=PickCube-v0
# (hidden 512, 2048 tokens, k = 16, chunk 100, B = 8, accumulate_grad_batches
# 2, "bf16-mixed", the default callbacks, the TensorBoard logger). The
# overrides, each for a reason:
# - data.train._target_ / data.val._target_: phase 10's in-memory dataset
#   (the card has no h5py), the held-out demos for validation
#   (``cli_train_set``, ``cli_held_out_set`` below); data.num_workers=4;
# - model._target_ = the base BCModule, ~model.val_metrics and
#   ~model.best_val_metrics: its validation is the held-out loss (val/loss).
#   ManiSkill2ACTBCModule's, without a simulator, keeps its mean_success
#   trackers and reads no loss (its val_metric_keys are empty, in JAX too),
#   so that no val/loss would ever be logged. The policy is the config's;
# - trainer.max_epochs=2, check_val_every_n_epoch=1, limit_train_batches=4
#   (two optimizer steps an epoch);
# - callbacks.model_checkpoint.monitor=val/loss, mode=min (the shipped
#   val/mean_success needs the simulator), and the probe
#   +callbacks.end_state (``EndState``), which only records;
# - paths.log_dir, hydra.run.dir: a temporary directory;
#   extras.print_config=false (the config tree is long).
CLI_TRAIN_BATCHES, CLI_EPOCHS = 4, 2
CLI_DATA: dict = {}  # the phase's demos and cache directory, read by the targets below


def cli_train_set(dataset_file=None, loop=FIT_LOOP, **kw):
    """``data.train``'s target in phase 11: phase 10's in-memory dataset over
    its training demos, with the config's keys (``dataset_file`` aside)."""
    return in_memory_dataset(CLI_DATA["train"], loop=loop, cache_dir=CLI_DATA["cache"], **kw)


def cli_held_out_set(size=None):
    """``data.val``'s target in phase 11 (the config's ``DummyDataset`` had
    ``size``): the held-out demos, as phase 10 validates on them."""
    return held_out_dataset(CLI_DATA["held_out"], CLI_DATA["cache"])


class EndState:
    """A probe callback: keeps the trainer and module of each run, the
    clock at fit start, and (epoch, global_step) at fit start and at each
    epoch end."""

    runs: list = []

    def __init__(self):
        self.epochs = []
        EndState.runs.append(self)

    def setup(self, trainer, module):
        self.trainer, self.module = trainer, module

    def on_fit_start(self, trainer, module):
        self.start = (trainer.current_epoch, trainer.global_step)
        self.t_start = time.perf_counter()

    def on_train_epoch_end(self, trainer, module, metrics, epoch):
        self.epochs.append((epoch, trainer.global_step, dict(metrics)))

    def on_validation_end(self, trainer, module, metrics, epoch):
        pass

    def on_fit_end(self, trainer, module):
        pass


def cli_argv(root: str, run: str, model: str = "scratch_pointnet_pcd") -> list[str]:
    return [
        "exp_maniskill2_act_policy=base",
        f"exp_maniskill2_act_policy/maniskill2_model@maniskill2_model={model}",
        "exp_maniskill2_act_policy/maniskill2_pcd_task@maniskill2_pcd_task=PickCube-v0",
        "data.train._target_=chip_smoke.cli_train_set",
        "data.val._target_=chip_smoke.cli_held_out_set", "data.num_workers=4",
        "model._target_=pointcloudmatters_tpu.models.bc_module.BCModule",
        "~model.val_metrics", "~model.best_val_metrics",
        f"trainer.max_epochs={CLI_EPOCHS}", "trainer.check_val_every_n_epoch=1",
        f"trainer.limit_train_batches={CLI_TRAIN_BATCHES}",
        "callbacks.model_checkpoint.monitor=val/loss", "callbacks.model_checkpoint.mode=min",
        "+callbacks.end_state._target_=chip_smoke.EndState",
        f"paths.log_dir={root}/logs", f"hydra.run.dir={root}/{run}",
        "extras.print_config=false",
    ]


def _run_state(trainer, module) -> dict:
    """Every tensor and value a checkpoint carries, on the CPU."""
    import torch

    out = {f"sd/{k}": v.detach().cpu().clone() for k, v in module.policy.state_dict().items()}
    opt = module.optimizer.state_dict()
    for i, st in opt["state"].items():
        for k, v in st.items():
            out[f"opt/{i}/{k}"] = v.detach().cpu().clone()
    out["groups"] = repr([{k: v for k, v in g.items() if k != "params"}
                          for g in opt["param_groups"]])
    out["schedule"] = module.scheduler.last_epoch
    if module.gradient_mean is not None:  # the DP composition accumulates nothing
        out["mini_step"] = module.gradient_mean.mini_step
        for i, a in enumerate(module.gradient_mean.acc or []):
            out[f"acc/{i}"] = a.detach().cpu().clone()
    for k, g in trainer.rngs.items():
        out[f"rng/{k}"] = g.get_state()
    return out


def _logged_steps(trainer) -> list[int]:
    """The steps of the ``train/loss`` the run's TensorBoard logger wrote
    (its event file, or its CSV stand-in)."""
    import csv

    from pointcloudmatters_tpu_torch.loggers import TensorBoardLogger

    tb = next(lg for lg in trainer.logger.loggers if isinstance(lg, TensorBoardLogger))
    if tb.writer == "csv":
        with open(os.path.join(tb.save_dir, "metrics.csv")) as f:
            return [int(r["step"]) for r in csv.DictReader(f) if r.get("train/loss")]
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    events = EventAccumulator(tb.save_dir)
    events.Reload()
    return [e.step for e in events.Scalars("train/loss")]


def train_cli(dev, fit_times: dict) -> dict:
    """Phase 11 (the comment above): (a) the checkpoint files, (b) a fresh
    trainer's restore of ``last`` bit-equal to the run's end, (c) a second
    run from ``ckpt_path=last`` resuming at epoch 2, (d)
    ``validate.main(ckpt_path=best)`` equal to ``Trainer.validate`` of the
    same restored state, (e) the launches of kernels 1, 2, bf16 3/4 (train)
    and f32 3 (validation) and no other. Returns the launches of the two
    runs and of the validation."""
    import tempfile

    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch import train as train_entry
    from pointcloudmatters_tpu_torch import validate as validate_entry
    from pointcloudmatters_tpu_torch.loggers import TensorBoardLogger
    from pointcloudmatters_tpu_torch.trainer import CHECKPOINT_FILE, Trainer
    from pointcloudmatters_tpu_torch.utils import config as C
    from pointcloudmatters_tpu_torch.utils.utils import seed_everything

    sys.modules.setdefault("chip_smoke", sys.modules[__name__])  # the targets' module
    root = tempfile.TemporaryDirectory()
    demos = synthetic_demos(FIT_EPISODES, FIT_EPISODE_LEN, FIT_CAM_SIDE)
    n_train = FIT_EPISODES - FIT_HELD_OUT
    CLI_DATA.update(train=demos[:n_train], held_out=demos[n_train:],
                    cache=os.path.join(root.name, "cache"))
    EndState.runs.clear()
    micro = CLI_EPOCHS * CLI_TRAIN_BATCHES
    n_val = FIT_HELD_OUT * 2  # held-out samples at a batch of 1, all of them a validation

    # the run, and (e) its launches
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t_main = time.perf_counter()
    train_entry.main(cli_argv(root.name, "run1"))
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = ops.launch_counts()
    probe = EndState.runs[-1]
    trainer, module = probe.trainer, probe.module
    writer = next(lg.writer for lg in trainer.logger.loggers
                  if isinstance(lg, TensorBoardLogger))
    want = {"fps": micro + CLI_EPOCHS * n_val, "knn": micro + CLI_EPOCHS * n_val,
            "attention_fwd_bf16": micro * ENC_LAYERS, "attention_bwd_bf16": micro * ENC_LAYERS,
            "attention_fwd": CLI_EPOCHS * n_val * ENC_LAYERS}
    if {k: n for k, n in launches.items() if n} != want:
        raise AssertionError(f"train_cli: want {want} launches and no other kernel, "
                             f"got {launches}")
    if (trainer.global_step, module.scheduler.last_epoch) != (micro, micro // FIT_ACCUMULATE):
        raise AssertionError(f"train_cli: {trainer.global_step} micro-steps, "
                             f"{module.scheduler.last_epoch} optimizer steps")
    if (type(module).__name__, type(module.policy).__name__, trainer.precision,
            trainer.accumulate_grad_batches, module.device.type) != (
            "BCModule", "ACTPCD", "bf16-mixed", FIT_ACCUMULATE, dev.type):
        raise AssertionError("train_cli: not the composition it should be")
    n_params = sum(p.numel() for p in module.policy.parameters())
    if n_params != FLAGSHIP_PARAMS:
        raise AssertionError(f"train_cli: {n_params} parameters, not {FLAGSHIP_PARAMS}")
    losses = [m["train/loss"] for _, _, m in probe.epochs]
    vals = [m["val/loss"] for _, _, m in probe.epochs]
    if not np.isfinite(losses + vals).all():
        raise AssertionError(f"train_cli: non-finite losses {losses} or val/loss {vals}")
    startup = probe.t_start - t_main
    epoch_rates = [m["samples_per_sec"] for _, _, m in probe.epochs]
    step_ms = FIT_BATCH * FIT_ACCUMULATE * 1e3 / epoch_rates[-1]
    log(f"cli     train.main: {n_params} parameters on {module.device}, {writer} writer; "
        f"{micro} micro-steps over {CLI_EPOCHS} epochs in {t_end - t_main:.2f} s; train/loss "
        f"{losses}, val/loss {vals}; launches {launches}")
    log(f"cli     {card_line()}: {startup:.2f} s from main to the first step (composition, "
        f"instantiation, weight draw, the device, the example batch); epoch 1 "
        f"{epoch_rates[-1]:.2f} samples/s = {step_ms:.2f} ms per optimizer step of B="
        f"{FIT_BATCH} x {FIT_ACCUMULATE} (epoch 0 {epoch_rates[0]:.2f} samples/s, with the "
        f"warm-up); phase 10 on this call: {fit_times['step_ms']:.2f} ms per optimizer step "
        f"between logged steps, its epoch {fit_times['epoch_samples_per_s']:.2f} samples/s = "
        f"{FIT_BATCH * FIT_ACCUMULATE * 1e3 / fit_times['epoch_samples_per_s']:.2f} ms")

    # (a) the files
    ckpts = os.path.join(root.name, "run1", "checkpoints")
    kept = sorted(os.listdir(ckpts))
    top = [d for d in kept if d != "last"]
    best = trainer.checkpoint_callback.best_model_path
    if ("last" not in kept or not top or not best or not os.path.isdir(best)
            or any(not re.fullmatch(r"epoch=\d{3}-val_mean_success=0", d) for d in top)):
        raise AssertionError(f"train_cli: checkpoints {kept}, best {best!r}")
    last = os.path.join(ckpts, "last")
    size = os.path.getsize(os.path.join(last, CHECKPOINT_FILE))
    log(f"cli     (a) checkpoints {kept}, best {os.path.basename(best)} "
        f"(val/loss {trainer.checkpoint_callback.best_model_score:.5f}); one is "
        f"{size / 1e6:.1f} MB")

    # (b) a fresh trainer restores ``last``: bit-equal to the run's end
    end = _run_state(trainer, module)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.save_checkpoint(os.path.join(root.name, "saved"))
    save_s = time.perf_counter() - t0
    shutil.rmtree(os.path.join(root.name, "saved"))
    cfg = train_entry.compose_run(cli_argv(root.name, "fresh"))
    other = train_entry.instantiate_model(cfg).to(dev)
    fresh = Trainer(accelerator=trainer.accelerator, precision="bf16-mixed",
                    accumulate_grad_batches=FIT_ACCUMULATE)
    fresh.setup(other, trainer.estimated_stepping_batches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.restore_checkpoint(last, other)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got = _run_state(fresh, other)
    differ = [k for k in end if k not in got or (
        not torch.equal(got[k], end[k]) if isinstance(end[k], torch.Tensor) else got[k] != end[k])]
    if differ or set(got) != set(end) or (fresh.current_epoch, fresh.global_step) != (
            CLI_EPOCHS, micro):
        raise AssertionError(f"train_cli: the restore of last differs in {differ[:10]}")
    log(f"cli     (b) {card_line()}: a checkpoint of {size / 1e6:.1f} MB saved in "
        f"{save_s:.2f} s, restored in {restore_s:.2f} s; {len(end)} tensors and values "
        f"(parameters, running statistics, AdamW moments, the gradient mean, the "
        f"schedule step, the {len(trainer.rngs)} generators) bit-equal to the run's end")
    del other, fresh, got

    # (c) a second run from ``last`` resumes at epoch 2
    ops.reset_launch_counts()
    train_entry.main(cli_argv(root.name, "run2") + [f"trainer.max_epochs={CLI_EPOCHS + 1}",
                                                    f"ckpt_path={last}"])
    torch.cuda.synchronize()
    resume_launches = ops.launch_counts()
    resumed = EndState.runs[-1]
    logged = _logged_steps(resumed.trainer)
    new_last = os.path.join(root.name, "run2", "checkpoints", "last")
    if (resumed.start != (CLI_EPOCHS, micro) or [e for e, *_ in resumed.epochs] != [CLI_EPOCHS]
            or not logged or logged[0] != micro + CLI_TRAIN_BATCHES
            or not os.path.isfile(os.path.join(new_last, CHECKPOINT_FILE))):
        raise AssertionError(f"train_cli: resumed at {resumed.start}, epochs "
                             f"{resumed.epochs}, logged steps {logged}")
    log(f"cli     (c) resumed at epoch {resumed.start[0]}, step {resumed.start[1]}; logged "
        f"steps {logged}; a new last at {new_last}; launches {resume_launches}")

    # (d) validate.main on the best checkpoint against Trainer.validate of the
    # same restored state; the loader in the main thread, so that both take
    # the same samples from numpy's stream
    val_argv = cli_argv(root.name, "val") + [f"ckpt_path={best}", "data.num_workers=0"]
    ops.reset_launch_counts()
    metrics = validate_entry.main(val_argv)
    torch.cuda.synchronize()
    val_launches = ops.launch_counts()
    cfg = train_entry.compose_run(cli_argv(root.name, "val_ref") + [f"ckpt_path={best}",
                                                                   "data.num_workers=0"])
    seed_everything(cfg.seed)
    datamodule = C.instantiate(cfg.data)
    reference = C.instantiate(cfg.trainer, callbacks=[], logger=[]).validate(
        train_entry.instantiate_model(cfg), datamodule, ckpt_path=best)
    gap = abs(metrics["val/loss"] - reference["val/loss"])
    if (set(metrics) != {"val/loss", "val/loss_best"} or not np.isfinite(metrics["val/loss"])
            or gap > 1e-6 * abs(reference["val/loss"])):
        raise AssertionError(f"train_cli: validate.main {metrics}, Trainer.validate "
                             f"{reference}")
    want = {"fps": n_val, "knn": n_val, "attention_fwd": n_val * ENC_LAYERS}
    if {k: n for k, n in val_launches.items() if n} != want:
        raise AssertionError(f"validate_cli: want {want} launches, got {val_launches}")
    log(f"cli     (d) validate.main(ckpt_path=best): {metrics}; Trainer.validate of the same "
        f"restored state: {reference} (|diff| {gap:.3e}); launches {val_launches}")
    root.cleanup()
    CLI_DATA.clear()
    EndState.runs.clear()
    del trainer, module, probe, resumed
    torch.cuda.empty_cache()
    return {"train_cli": launches, "train_cli_resume": resume_launches,
            "validate_cli": val_launches}



# phase 12: data parallelism, one process a card (PR 19). (a) an NCCL group
# of one rank is bit-equal to no group; (b) two processes on the one card
# under gloo (NCCL refuses two ranks on one card) against a world of one over
# the concatenated batch; (c) the CLI at trainer=ddp's devices: auto (the
# README's composition sets devices: 1), a world of one here, and its
# refusal of devices above the card count.
DDP_WORLD = 2
DDP_STEPS = 3  # the compared steps
DDP_TIMED = 2  # steps timed after them
DDP_CASES = (("32-true", {}), ("bf16-mixed", {"freeze_backbone": True}))
DDP_KERNELS = {"32-true": TRAIN_KERNELS, "bf16-mixed": BF16_KERNELS + BUILDER_KERNELS}
# world 2 against world 1, from the CPU tests' limits (tests/test_torch_ddp.py
# for f32, tests/test_torch_bf16.py for bf16): losses and grad_norm 1e-4
# relative in f32, 1e-2 in bf16; parameters within 2e-6 + 1e-4 of a tensor's
# largest entry, plus 4 lr a step for entries whose gradient is noise (an
# AdamW step moves an entry by about lr whatever its gradient's size);
# running statistics 1e-5 + 1e-5 relative in f32, 1e-5 + 1e-3 relative in
# bf16
DDP_LIMITS = {"32-true": dict(metric=1e-4, stats=1e-5), "bf16-mixed": dict(metric=1e-2, stats=1e-3)}


def _rows(tree, lo: int, hi: int):
    if isinstance(tree, dict):
        return {k: _rows(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi]


def ddp_run(dev, precision: str, rank: int = 0, world: int = 1, dropout: float = 0.0,
            fixed_eps: bool = True, timed: int = DDP_TIMED, **flagship_kw) -> dict:
    """DDP_STEPS steps of the flagship (AdamW + OneCycleLR) over this rank's
    rows of one global B=32 batch, the posterior noise (with ``fixed_eps``)
    its rows of one global draw; then ``timed`` steps timed by the host
    clock, and in a group the flat gradient all-reduce alone. Metrics,
    learning rates, the end state on the CPU, launches of the compared steps
    and the times."""
    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch.entry import build_batch, build_flagship
    from pointcloudmatters_tpu_torch.models.bc_module import BCModule, to_device
    from pointcloudmatters_tpu_torch.models.components.act import act as act_module
    from pointcloudmatters_tpu_torch.trainer import Trainer
    from pointcloudmatters_tpu_torch.utils import dist

    n = BIG_BATCH // world
    lo, hi = rank * n, (rank + 1) * n
    batch = to_device(_rows(build_batch(batch_size=BIG_BATCH, n_points=N_POINTS, seed=2),
                            lo, hi), dev)
    eps = torch.from_numpy(np.random.RandomState(1).randn(BIG_BATCH, 32).astype(np.float32)
                           [lo:hi]).to(dev)
    module = BCModule(build_flagship(seed=0, dropout=dropout, device=dev, **flagship_kw),
                      optimizer=FLAGSHIP_OPT, lr_scheduler=FLAGSHIP_SCHED)
    trainer = Trainer(precision=precision, seed=0)
    trainer.setup(module, TOTAL_STEPS)
    saved = act_module.reparametrize
    if fixed_eps:
        act_module.reparametrize = (
            lambda mu, logvar, gen: mu + torch.exp(0.5 * logvar) * eps.to(mu.dtype))
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        lrs, metrics = [], []
        for _ in range(DDP_STEPS):
            lrs.append(module.optimizer.param_groups[0]["lr"])
            metrics.append(trainer.train_step(module, batch))
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
        state = {k: v.detach().cpu().clone() for k, v in module.policy.state_dict().items()}
        t0 = time.perf_counter()
        for _ in range(timed):
            trainer.train_step(module, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / timed if timed else None
        reduce_ms = None
        if dist.is_initialized():  # the step's one all-reduce alone, at its size
            size = sum(p.numel() for p in module.policy.parameters() if p.requires_grad)
            flat = torch.zeros(size + 4, device=dev)
            dist.all_reduce_([flat])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                dist.all_reduce_([flat])
            torch.cuda.synchronize()
            reduce_ms = (time.perf_counter() - t0) * 1e3 / 3
    finally:
        act_module.reparametrize = saved
    out = dict(metrics=metrics, lrs=lrs, state=state, launches=launches, step_ms=step_ms,
               reduce_ms=reduce_ms)
    del module, trainer, batch
    torch.cuda.empty_cache()
    return out


def _differ(a: dict, b: dict) -> list:
    """The keys whose tensors are not bit-equal."""
    import torch

    return [k for k in a if not torch.equal(a[k], b[k])]


def ddp_nccl_one(out_file: str) -> None:
    """Phase 12 (a), a process of its own: three shipped ``"bf16-mixed"``
    steps (dropout 0.1, the generators' noise) with no group, again with no
    group (the steps' own reproducibility), then in an NCCL group of one
    rank; what differs, the group's launches and times."""
    import torch

    sys.path.insert(0, REPO)
    from pointcloudmatters_tpu_torch.utils import dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kw = dict(dropout=ATTN_DROPOUT, fixed_eps=False)
    free = ddp_run(dev, "bf16-mixed", timed=0, **kw)
    again = ddp_run(dev, "bf16-mixed", timed=0, **kw)
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{dist.free_port()}", rank=0, world_size=1)
    try:
        grouped = ddp_run(dev, "bf16-mixed", **kw)
    finally:
        dist.destroy()
    torch.save({
        "again": _differ(free["state"], again["state"]) + (
            ["metrics"] if free["metrics"] != again["metrics"] else []),
        "grouped": _differ(free["state"], grouped["state"]) + (
            ["metrics"] if free["metrics"] != grouped["metrics"] else []),
        "metrics": grouped["metrics"], "launches": grouped["launches"],
        "step_ms": grouped["step_ms"], "reduce_ms": grouped["reduce_ms"],
        "n_state": len(free["state"]),
    }, out_file)


def ddp_rank(rank: int, world: int, backend: str, store: str, out_dir: str) -> None:
    """Phase 12 (b), one rank: ``ddp_run`` of each of DDP_CASES in a
    ``backend`` group (gloo: every rank on card 0; nccl: card ``rank``);
    rank 1's end states against rank 0's (a broadcast); draws of the shared
    and the rank's own streams at dropout 0.1. Rank 0 keeps its end states."""
    import torch

    sys.path.insert(0, REPO)
    from pointcloudmatters_tpu_torch.entry import build_flagship
    from pointcloudmatters_tpu_torch.models.bc_module import BCModule
    from pointcloudmatters_tpu_torch.ops.attention import draw_seed
    from pointcloudmatters_tpu_torch.utils import dist

    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    torch.distributed.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                         world_size=world)
    out = {}
    try:
        for precision, kw in DDP_CASES:
            res = ddp_run(dev, precision, rank, world, **kw)
            state = res.pop("state")
            theirs = [v.to(dev).clone() for v in state.values()]
            dist.broadcast_(theirs)
            res["equal_to_rank0"] = all(torch.equal(a.cpu(), b) for a, b in
                                        zip(theirs, state.values()))
            if rank == 0:
                res["state"] = state
            out[precision] = res
        rngs = BCModule(build_flagship(**SMALL, seed=0, dropout=ATTN_DROPOUT, device=dev)
                        ).make_rngs(0, rank, world)
        out["streams"] = {
            "dense": torch.rand((102, 102), generator=rngs["dropout"], device=dev).cpu(),
            "seed": draw_seed(rngs["seed"]),
            "bits": torch.randint(0, 256, (4096,), generator=rngs["bits"], device=dev,
                                  dtype=torch.uint8).cpu(),
            "vae": torch.randn(64, generator=rngs["vae"], device=dev).cpu()}
    finally:
        dist.destroy()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _spawn(target, args_of_rank, n: int, what: str, timeout: float = 600) -> None:
    """``n`` processes of ``target`` (spawned: each imports this file
    afresh), joined; raises if one fails or outlives ``timeout`` s."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of_rank(r)) for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + timeout
    for p in procs:
        p.join(max(1.0, deadline - time.perf_counter()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    if alive or any(p.exitcode for p in procs):
        raise AssertionError(f"{what}: processes exited with {[p.exitcode for p in procs]}"
                             f"{' (killed at the time limit)' if alive else ''}")


def _check_world(what: str, precision: str, got: dict, ref: dict) -> str:
    """World 2 (rank 0's end state, both ranks' metrics) against world 1."""
    import numpy as np

    lim = DDP_LIMITS[precision]
    for key in ("loss", "action_loss", "kl_loss", "grad_norm"):
        a = np.array([m[key] for m in got["metrics"]])
        b = np.array([m[key] for m in ref["metrics"]])
        if not np.abs(a - b).max() <= lim["metric"] * np.abs(b).max():
            raise AssertionError(f"{what}: {key} {a} vs world 1 {b}")
    allowance = 4.0 * sum(ref["lrs"])
    worst = {}
    for name, r in ref["state"].items():
        g = got["state"][name]
        err = (g - r).abs().max().item()
        if name.endswith((".mean", ".var")):
            limit = 1e-5 + lim["stats"] * r.abs().max().item()
        else:
            limit = 2e-6 + 1e-4 * r.abs().max().item() + allowance
        if not err <= limit:
            raise AssertionError(f"{what}: {name} off by {err:.3e} > {limit:.3e}")
        kind = "stats" if name.endswith((".mean", ".var")) else "params"
        if err / limit >= worst.get(kind, (0, None))[0]:
            worst[kind] = (err / limit, name, err)
    return (f"{what}: losses and grad_norm within {lim['metric']} relative; worst parameter "
            f"{worst['params'][1]} {worst['params'][2]:.3e} ({worst['params'][0]:.2f} of its "
            f"limit), worst running statistic {worst['stats'][1]} {worst['stats'][2]:.3e} "
            f"({worst['stats'][0]:.2f} of its limit)")


def ddp_group_of_one(tmp: str, card: str) -> dict:
    """Phase 12 (a), an NCCL group of one rank against no group: the
    launches of the group's steps."""
    import torch

    out_file = os.path.join(tmp, "nccl_one.pt")
    _spawn(ddp_nccl_one, lambda r: (out_file,), 1, "train_ddp (a)")
    one = torch.load(out_file, weights_only=False)
    if one["again"]:
        log(f"ddp     (a) the group-free steps did not reproduce themselves bit for bit in "
            f"{one['again'][:8]}")
    if one["grouped"]:
        raise AssertionError(f"train_ddp (a): the NCCL group of one differs from no group in "
                             f"{one['grouped'][:10]}")
    log(f"ddp     (a) {card}: an NCCL group of one rank, three shipped bf16-mixed B=32 steps "
        f"(dropout 0.1) bit-equal to no group in losses, grad_norm and all {one['n_state']} "
        f"parameters and running statistics (group-free rerun bit-equal: "
        f"{not one['again']}); {one['step_ms']:.2f} ms/step in the group, the flat all-reduce "
        f"{one['reduce_ms']:.3f} ms; losses {[m['loss'] for m in one['metrics']]}")
    return one["launches"]


def ddp_two_ranks(dev, tmp: str, card: str) -> dict:
    """Phase 12 (b), two processes on the one card under gloo (and under
    NCCL across two cards where the machine has them) against a world of
    one: the gloo ranks' launches on their compared steps, summed."""
    import torch

    launches: dict = {}
    runs = [("gloo", 1)]
    if torch.cuda.device_count() > 1:
        runs.append(("nccl", DDP_WORLD))
    for backend, cards in runs:
        out_dir = os.path.join(tmp, backend)
        os.makedirs(out_dir)
        store = os.path.join(out_dir, "store")
        t0 = time.perf_counter()
        _spawn(ddp_rank, lambda r: (r, DDP_WORLD, backend, store, out_dir), DDP_WORLD,
               f"train_ddp (b) {backend}")
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                 for r in range(DDP_WORLD)]
        log(f"ddp     (b) {backend}, {DDP_WORLD} processes on {cards} card(s): "
            f"{time.perf_counter() - t0:.1f} s")
        for precision, kw in DDP_CASES:
            ref = ddp_run(dev, precision, **kw)
            for rank, res in enumerate(ranks):
                got = res[precision]
                if not got["equal_to_rank0"]:
                    raise AssertionError(f"train_ddp {backend} {precision}: rank {rank}'s "
                                         f"end state differs from rank 0's")
                missing = [k for k in DDP_KERNELS[precision] if not got["launches"][k]]
                if missing:
                    raise AssertionError(f"train_ddp {backend} {precision}: rank {rank} "
                                         f"launched no {missing}")
                if got["metrics"] != ranks[0][precision]["metrics"]:
                    raise AssertionError(f"train_ddp {backend} {precision}: the ranks' "
                                         f"metrics differ")
                if backend == "gloo":
                    for k, v in got["launches"].items():
                        launches[k] = launches.get(k, 0) + v
            got = dict(ranks[0][precision])
            log("ddp     (b) " + _check_world(
                f"{backend} {precision}{' frozen' if kw else ''} world 2 x B=16 vs world 1 "
                f"x B=32, {DDP_STEPS} steps", precision, got, ref))
            log(f"ddp     (b) {card}: {precision}{' frozen' if kw else ''}: world 1 "
                f"{ref['step_ms']:.2f} ms/step at B=32; world 2 ({backend}, {cards} card(s)) "
                f"{got['step_ms']:.2f} ms/step at B=16 a rank, the flat all-reduce "
                f"{got['reduce_ms']:.2f} ms (rank 1: {ranks[1][precision]['step_ms']:.2f}, "
                f"{ranks[1][precision]['reduce_ms']:.2f}); launches a rank "
                f"{ {k: v for k, v in got['launches'].items() if v} }")
            del ref, got
        s0, s1 = ranks[0]["streams"], ranks[1]["streams"]
        if not (torch.equal(s0["dense"], s1["dense"]) and s0["seed"] == s1["seed"]) or (
                torch.equal(s0["bits"], s1["bits"]) or torch.equal(s0["vae"], s1["vae"])):
            raise AssertionError(f"train_ddp {backend}: streams not shared and own as they "
                                 f"should be")
        differ = (s0["bits"] != s1["bits"]).float().mean().item()
        log(f"ddp     (b) {backend}: the dense attention's mask and the kernels' seed drawn "
            f"alike on both ranks, BitsDropout's bits ({differ:.3f} of 4096 differ) and the "
            f"posterior noise each rank's own")
        del ranks

    return launches


def ddp_cli(tmp: str) -> dict:
    """Phase 12 (c), the CLI: the README's composition (trainer=ddp) at
    devices=auto, a world of one on this card, over phase 10's demos; devices
    above the card count raise before any process starts. The launches of
    the devices=auto run."""
    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch import train as train_entry
    from pointcloudmatters_tpu_torch.utils import dist

    cards = torch.cuda.device_count()
    cli_launches = {}
    if cards == 1:  # on more cards auto starts ranks, which cannot see demos held here
        demos = synthetic_demos(FIT_EPISODES, FIT_EPISODE_LEN, FIT_CAM_SIDE)
        n_train = FIT_EPISODES - FIT_HELD_OUT
        CLI_DATA.update(train=demos[:n_train], held_out=demos[n_train:],
                        cache=os.path.join(tmp, "cache"))
        EndState.runs.clear()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        train_entry.main(cli_argv(tmp, "ddp") + [
            "trainer.devices=auto", "trainer.max_epochs=1",
            f"trainer.limit_train_batches={FIT_ACCUMULATE}"])
        torch.cuda.synchronize()
        cli_launches = ops.launch_counts()
        probe = EndState.runs[-1]
        if (probe.trainer.devices_spec, len(probe.epochs), dist.is_initialized()) != (
                "auto", 1, False) or any(not cli_launches[k] for k in BF16_KERNELS) or (
                not os.path.isdir(os.path.join(tmp, "ddp", "checkpoints", "last"))):
            raise AssertionError(f"train_ddp (c): devices {probe.trainer.devices_spec}, "
                                 f"epochs {probe.epochs}, launches {cli_launches}")
        log(f"ddp     (c) train.main, the README's composition, trainer=ddp, "
            f"trainer.devices=auto: a world of one on the one card, one epoch of "
            f"{FIT_ACCUMULATE} micro-steps and its validation in "
            f"{time.perf_counter() - t0:.2f} s, train/loss "
            f"{probe.epochs[0][2]['train/loss']:.5f}, a last checkpoint; launches "
            f"{ {k: v for k, v in cli_launches.items() if v} }")
        CLI_DATA.clear()
        EndState.runs.clear()
        del probe
    else:
        log(f"ddp     (c) {cards} cards: devices=auto would start {cards} processes, which "
            f"cannot read demos held in this one; not run")
    ops.reset_launch_counts()
    try:
        train_entry.main(cli_argv(tmp, "ddp2") + [f"trainer.devices={cards + 1}"])
    except ValueError as e:
        if "cards" not in str(e) or any(ops.launch_counts().values()) or dist.is_initialized():
            raise
        log(f"ddp     (c) trainer.devices={cards + 1} raised before any launch: {e}")
    else:
        raise AssertionError("train_ddp (c): devices above the card count did not raise")
    return cli_launches


def train_ddp(dev) -> dict:
    """Phase 12 (the comment above); returns the launches of the ranks'
    compared steps and of (a)'s group, summed (the path ``train_ddp``), and
    of (c)'s run (``train_cli_ddp``)."""
    import tempfile

    card = card_line()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        counts = [ddp_group_of_one(tmp, card), ddp_two_ranks(dev, tmp, card)]
        cli_launches = ddp_cli(tmp)
    launches = {k: sum(c.get(k, 0) for c in counts) for k in KERNELS}
    log(f"ddp     phase 12 in {time.perf_counter() - t_phase:.1f} s; train_ddp launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return {"train_ddp": launches,
            "train_cli_ddp": {k: cli_launches.get(k, 0) for k in KERNELS}}

# phase 13: the Diffusion Policy over point clouds, the shipped
# composition of configs/exp_maniskill2_diffusion_policy (scratch_pointnet_pcd,
# PickCube-v0): batch 64 of two observation frames, so B * To = 128 clouds a
# training step and 2 a rollout request, each of at most 16,384 points (one
# 128 x 128 camera); FPS to 2048 tokens, kNN k = 16; a DDPM of 100 steps; the
# ConditionalUnet1D of down_dims [512, 1024, 2048] (255,687,303 parameters)
DP_BATCH, DP_OBS_STEPS, DP_POINTS = 64, 2, FIT_CAM_SIDE ** 2
DP_SERVE_BATCHES = (1, 8)
DP_UNET_PARAMS, DP_PARAMS = 255_687_303, 255_852_391
DP_KERNELS = ("fps", "knn")
DP_PREDICT_TOL = 1e-5  # of max(1, max |plain|): kernels 1 and 2 are index-exact
DP_OPT = {"type": "AdamW", "betas": [0.9, 0.95], "lr": 1e-4, "weight_decay": 1e-4}
DP_SCHED = {"scheduler": {"type": "OneCycleLR", "max_lr": 1e-4, "pct_start": 0.15,
                          "anneal_strategy": "cos", "div_factor": 100.0,
                          "final_div_factor": 1000.0}}
DP_CLI_BATCHES = 2  # micro-steps an epoch in (d)
DP_CLI_LOOP = 24  # 6 episodes x 24 = 144 samples: 2 batches of 64


def dp_point_kernels(dev) -> dict:
    """Phase 13 (a): FPS (kernel 1) and kNN (kernel 2, k = 16) over the
    clouds of a DP training step (B * To = 128) and of a rollout request (2),
    N = 16,384 with ragged valid counts, M = 2048: FPS index-exact against
    its plain version, kNN index-exact with d2 bit-equal; each timed (CUDA
    events), with FPS's cluster size and threads and kNN's lane group S.
    Returns the cases of each."""
    import torch

    from pointcloudmatters_tpu_torch.entry import build_batch
    from pointcloudmatters_tpu_torch.ops import fps, knn, pointops

    cases = {"fps": [], "knn": []}
    for B in (DP_BATCH * DP_OBS_STEPS, DP_OBS_STEPS):
        batch = build_batch(batch_size=B, n_points=DP_POINTS, seed=0, with_actions=False)
        xyz = torch.from_numpy(batch["pcds"]["coord"]).to(dev)
        mask = torch.from_numpy(batch["pcds"]["valid"]).to(dev)
        n_valid = int(mask.sum())  # the bounds count valid points: neither kernel needs the padding
        run = lambda: fps.farthest_point_sampling_padded_cuda(xyz, mask, 2048)  # noqa: E731
        idx = run()
        if not torch.equal(idx, pointops.farthest_point_sampling_padded_plain(xyz, mask, 2048)):
            raise AssertionError(f"dp      FPS at B={B}, N={DP_POINTS} disagrees with its "
                                 f"plain version")
        C, T = fps.launch_shape(B, DP_POINTS, dev.index)
        ms = cuda_ms(run, 3)
        cases["fps"].append(dict(B=B, N=DP_POINTS, cluster=C, threads=T, ms=ms,
                                 **bound(8.0 * n_valid * 2047,
                                         xyz.numel() * 4 + mask.numel() + idx.numel() * 4,
                                         "f32")))
        q = torch.gather(xyz, 1, idx.long()[..., None].expand(-1, -1, 3)).contiguous()
        gi, gd = knn.knn_query_padded_cuda(q, xyz, mask, 16)
        pi, pd = pointops.knn_query_padded_plain(q, xyz, mask, 16)
        if not (torch.equal(gi, pi) and torch.equal(gd, pd)):
            raise AssertionError(f"dp      kNN at B={B}, N={DP_POINTS}: indices differ at "
                                 f"{(gi != pi).sum().item()} places, d2 max diff "
                                 f"{_max_err(gd, pd):.3e}")
        S = knn.launch_group(B, 2048, 16, dev.index)
        knn_ms = cuda_ms(lambda: knn.knn_query_padded_cuda(q, xyz, mask, 16), 3)
        cases["knn"].append(dict(B=B, N=DP_POINTS, k=16, S=S, ms=knn_ms,
                                 **bound(8.0 * 2048 * n_valid,
                                         (q.numel() + xyz.numel()) * 4 + mask.numel()
                                         + B * 2048 * 16 * 8, "f32")))
        log(f"dp      (a) {card_line()}: B*To={B} clouds of <= {DP_POINTS} points "
            f"(valid {int(mask.sum(1).min())}-{int(mask.sum(1).max())}) -> 2048: FPS "
            f"index-exact, cluster of {C} CTAs x {T} threads, {ms:.3f} ms; kNN k=16 "
            f"index-exact, d2 bit-equal, S={S}, {knn_ms:.3f} ms")
        del xyz, mask, q, gi, gd, pi, pd
    torch.cuda.empty_cache()
    return cases


def dp_normalizer(qpos_dim: int = 9):
    """A normalizer of the DP's fields fitted on seeded data: actions and
    qpos to [-1, 1] by their ranges."""
    import numpy as np

    from pointcloudmatters_tpu_torch.utils.normalizer import LinearNormalizer

    rng = np.random.RandomState(0)
    normalizer = LinearNormalizer()
    normalizer.fit({"action": rng.randn(1000, 7).astype(np.float32),
                    "qpos": rng.randn(1000, qpos_dim).astype(np.float32)})
    return normalizer


def dp_module(dev):
    """The DP task module over the full-width policy (seeded weights, the
    normalizer of ``dp_normalizer``) with its config's AdamW + OneCycleLR."""
    from pointcloudmatters_tpu_torch.entry import build_dp_policy
    from pointcloudmatters_tpu_torch.models.maniskill2_modules import (
        ManiSkill2DiffusionPolicyBCModule,
    )

    policy = build_dp_policy(seed=0, normalizer=dp_normalizer(), device=dev)
    n_unet = sum(p.numel() for p in policy.model.parameters())
    n_params = sum(p.numel() for p in policy.parameters())
    if (n_unet, n_params) != (DP_UNET_PARAMS, DP_PARAMS):
        raise AssertionError(f"the DP has {n_params} parameters, {n_unet} in its UNet")
    return ManiSkill2DiffusionPolicyBCModule(policy, optimizer=DP_OPT, lr_scheduler=DP_SCHED,
                                             env_id="PickCube-v0")


def _only(launches: dict, want: dict, what: str) -> None:
    got = {k: n for k, n in launches.items() if n}
    if got != want:
        raise AssertionError(f"{what}: want {want} launches and no other kernel, got {got}")


def dp_serve(dev) -> dict:
    """Phase 13 (b): ``predict`` of the full-width DP in f32 (the whole
    reverse chain, 100 UNet calls) at B=1 (the rollout shape) and B=8: a
    warm-up request at each size, then three timed by the host clock to
    ``torch.cuda.synchronize()``; finite (B, 8, 7) actions; FPS and kNN once
    a request and no other kernel; the last B=8 answer against the same
    predict on the plain versions from the same generator seed, within
    DP_PREDICT_TOL of max(1, max |plain|). Returns the launches."""
    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch.entry import build_dp_batch

    module = dp_module(dev)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    requests = {B: [build_dp_batch(B, DP_OBS_STEPS, DP_POINTS, seed=s, with_actions=False)
                    for s in (1, 2, 3)] for B in DP_SERVE_BATCHES}
    for B in DP_SERVE_BATCHES:  # warm-up
        module.predict(requests[B][0], gen(0))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    times = {}
    for B in DP_SERVE_BATCHES:
        for i, obs in enumerate(requests[B]):
            t0 = time.perf_counter()
            action = module.predict(obs, gen(i))
            torch.cuda.synchronize()
            times.setdefault(B, []).append((time.perf_counter() - t0) * 1e3)
            if tuple(action.shape) != (B, 8, 7) or not torch.isfinite(action).all():
                raise AssertionError(f"dp predict at B={B}: {tuple(action.shape)}, not a "
                                     f"finite (B, 8, 7)")
    launches = ops.launch_counts()
    n = len(DP_SERVE_BATCHES) * 3
    _only(launches, {"fps": n, "knn": n}, "dp_predict")
    for B, ms in times.items():
        log(f"dp      (b) {card_line()}: predict B={B} (B*To={B * DP_OBS_STEPS} clouds of "
            f"<= {DP_POINTS} points, 100 DDPM steps, f32): "
            + ", ".join(f"{t:.2f}" for t in ms) + " ms")
    with plain_kernels():
        plain = module.predict(requests[8][-1], gen(2))
    torch.cuda.synchronize()
    err = (action - plain).abs().max().item()
    limit = DP_PREDICT_TOL * max(1.0, plain.abs().max().item())
    if not err <= limit:
        raise AssertionError(f"dp predict B=8, kernels vs plain versions: {err:.3e} > "
                             f"{limit:.3e}")
    log(f"dp      (b) predict B=8 kernels vs plain versions, one generator seed: max abs "
        f"diff {err:.3e} ({'bit-equal' if torch.equal(action, plain) else 'not bit-equal'}); "
        f"launches {launches}")
    del module
    torch.cuda.empty_cache()
    return launches


def dp_train(dev) -> dict:
    """Phase 13 (c): the ``"bf16-mixed"`` step of the full-width DP at B=64
    (128 clouds): one warm-up step, then 5 under
    ``torch.cuda.set_sync_debug_mode("error")`` timed by the host clock;
    samples/s and peak memory; finite losses and grad norms, moved
    parameters, FPS and kNN once a step and no other kernel. Then one step
    on the kernels against one on the plain versions from the same
    generator states (loss and gradients within BF16_STEP_TOL, as phase 6).
    Returns the launches of the timed steps."""
    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch.entry import build_dp_batch
    from pointcloudmatters_tpu_torch.models.bc_module import to_device
    from pointcloudmatters_tpu_torch.trainer import Trainer

    module = dp_module(dev)
    trainer = Trainer(precision="bf16-mixed", seed=0)
    trainer.setup(module, TOTAL_STEPS)
    batch = to_device(build_dp_batch(DP_BATCH, DP_OBS_STEPS, DP_POINTS, seed=0), dev)
    start = [p.detach().clone() for p in module.policy.parameters()]
    trainer.train_step(module, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        steps = [trainer.train_step(module, batch) for _ in range(TRAIN_STEPS)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [float(m["loss"]) for m in steps]
    norms = [float(m["grad_norm"]) for m in steps]
    log(f"dp      (c) {card_line()}: train B={DP_BATCH} (B*To={DP_BATCH * DP_OBS_STEPS} "
        f"clouds of <= {DP_POINTS} points) bf16-mixed: {step_ms:.2f} ms/step over "
        f"{TRAIN_STEPS} steps, {DP_BATCH * 1e3 / step_ms:.2f} samples/s, peak device memory "
        f"{peak / 2**30:.2f} GiB; loss {losses}; grad_norm {norms}")
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"dp_train: non-finite loss or grad_norm: {losses}, {norms}")
    moved = sum(not torch.equal(a, p) for a, p in zip(start, module.policy.parameters()))
    if moved < len(start) // 2:
        raise AssertionError(f"dp_train: {moved} of {len(start)} parameter tensors moved")
    _only(launches, {"fps": TRAIN_STEPS, "knn": TRAIN_STEPS}, "dp_train")
    del start, steps
    got = _step_grads(module, batch, module.make_rngs(5), torch.bfloat16)
    with plain_kernels():
        ref = _step_grads(module, batch, module.make_rngs(5), torch.bfloat16)
    log("dp      (c) " + _compare_step(f"bf16 B={DP_BATCH} step, kernels vs plain versions",
                                       *got, *ref, grad_rtol=BF16_STEP_TOL,
                                       loss_rtol=BF16_STEP_TOL)
        + f"; {moved} parameter tensors moved; launches {launches}")
    del module, trainer, batch, got, ref
    torch.cuda.empty_cache()
    return launches


# (d): the DP composition through the port's entry point, over phase 10's
# demos; the overrides as phase 11's (cli_argv), and for the same reasons,
# except: model._target_ is held_out_dp_module (the base BCModule has no
# "noise" stream and sets no normalizer, in JAX too); the loader loops the
# six training episodes DP_CLI_LOOP times for two batches of 64; one top-k
# checkpoint (each is ~3 GB)
def dp_cli_train_set(dataset_file=None, loop=DP_CLI_LOOP, **kw):
    """``data.train``'s target in phase 13 (d): the port's DP point-cloud
    dataset over phase 10's training demos, with the config's keys."""
    return in_memory_dataset(CLI_DATA["train"], loop=loop, cache_dir=CLI_DATA["cache"],
                             dataset=DP_PCD, **kw)


def dp_cli_held_out_set(size=None):
    """``data.val``'s target in phase 13 (d): the held-out demos, twice."""
    return in_memory_dataset(CLI_DATA["held_out"], transform_pcd=fit_transforms(), loop=2,
                             goal_cond_keys=["goal_pos"], chunk_size=16, camera_ids=[0],
                             point_num_per_cam=DP_POINTS, cache_dir=CLI_DATA["cache"],
                             dataset=DP_PCD, n_obs_steps=DP_OBS_STEPS)


def held_out_dp_module(**kw):
    """``model._target_`` in phase 13 (d): the DP task module validating by
    its held-out loss (``val/loss``, its minimum as ``val/loss_best``). The
    shipped module, without a simulator, keeps its mean_success trackers and
    reads no loss, in JAX too."""
    from pointcloudmatters_tpu_torch.models.bc_module import BCModule
    from pointcloudmatters_tpu_torch.models.maniskill2_modules import (
        ManiSkill2DiffusionPolicyBCModule,
    )
    from pointcloudmatters_tpu_torch.utils.metrics import Metrics

    class HeldOutDPModule(ManiSkill2DiffusionPolicyBCModule):
        @property
        def val_metric_keys(self) -> list:
            return ["loss"]

        def run_validation(self, trainer, datamodule) -> dict:
            return BCModule.run_validation(self, trainer, datamodule)

    return HeldOutDPModule(
        val_metrics=Metrics(["MeanMetric"], ["loss"], ["val/loss"]),
        best_val_metrics=Metrics(["MinMetric"], ["val/loss"], ["val/loss_best"]), **kw)


def dp_cli_argv(root: str, run: str, model: str = "scratch_pointnet_pcd") -> list[str]:
    return [
        "exp_maniskill2_diffusion_policy=base",
        "exp_maniskill2_diffusion_policy/maniskill2_pcd_task@maniskill2_pcd_task=PickCube-v0",
        f"exp_maniskill2_diffusion_policy/maniskill2_model@maniskill2_model={model}",
        "data.train._target_=chip_smoke.dp_cli_train_set",
        "data.val._target_=chip_smoke.dp_cli_held_out_set", "data.num_workers=4",
        "model._target_=chip_smoke.held_out_dp_module", "~model.val_metrics",
        "~model.best_val_metrics",
        f"trainer.max_epochs={CLI_EPOCHS}", "trainer.check_val_every_n_epoch=1",
        f"trainer.limit_train_batches={DP_CLI_BATCHES}",
        "callbacks.model_checkpoint.monitor=val/loss", "callbacks.model_checkpoint.mode=min",
        "callbacks.model_checkpoint.save_top_k=1",
        "+callbacks.end_state._target_=chip_smoke.EndState",
        f"paths.log_dir={root}/logs", f"hydra.run.dir={root}/{run}",
        "extras.print_config=false",
    ]


def train_cli_dp(dev) -> dict:
    """Phase 13 (d): ``train.main`` on the DP composition (batch 64,
    ``"bf16-mixed"``) over phase 10's demos, 2 epochs of DP_CLI_BATCHES
    micro-steps, held-out validation after each: FPS and kNN launched once
    a micro-step and once a held-out batch, and no other kernel; finite
    losses; the normalizer wired from the dataset into the policy and the
    checkpoint's extras; ``last`` restored by a fresh trainer into a fresh
    module bit-equal in every parameter, running statistic and AdamW moment,
    with the normalizer rebuilt from the extras. Logs the checkpoint's size
    and its save and restore seconds. Returns the run's launches."""
    import tempfile

    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch import train as train_entry
    from pointcloudmatters_tpu_torch.trainer import CHECKPOINT_FILE, Trainer

    sys.modules.setdefault("chip_smoke", sys.modules[__name__])  # the targets' module
    root = tempfile.TemporaryDirectory()
    demos = synthetic_demos(FIT_EPISODES, FIT_EPISODE_LEN, FIT_CAM_SIDE)
    n_train = FIT_EPISODES - FIT_HELD_OUT
    CLI_DATA.update(train=demos[:n_train], held_out=demos[n_train:],
                    cache=os.path.join(root.name, "cache"))
    EndState.runs.clear()
    micro = CLI_EPOCHS * DP_CLI_BATCHES
    n_val = FIT_HELD_OUT * 2
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t_main = time.perf_counter()
    train_entry.main(dp_cli_argv(root.name, "run1"))
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = ops.launch_counts()
    probe = EndState.runs[-1]
    trainer, module = probe.trainer, probe.module
    _only(launches, {"fps": micro + CLI_EPOCHS * n_val, "knn": micro + CLI_EPOCHS * n_val},
          "train_cli_dp")
    if (type(module.policy).__name__, trainer.precision, module.device.type,
            trainer.global_step) != ("DiffusionUnetImagePolicy", "bf16-mixed", dev.type, micro):
        raise AssertionError("train_cli_dp: not the composition or the steps it should be")
    n_params = sum(p.numel() for p in module.policy.parameters())
    if n_params != DP_PARAMS:
        raise AssertionError(f"train_cli_dp: {n_params} parameters, not {DP_PARAMS}")
    normalizer = module.policy.normalizer
    if normalizer is None or set(module.state_dict_extras().get("normalizer", {})) != {
            "action", "qpos"}:
        raise AssertionError("train_cli_dp: the dataset's normalizer was not wired")
    losses = [m["train/loss"] for _, _, m in probe.epochs]
    vals = [m["val/loss"] for _, _, m in probe.epochs]
    if not np.isfinite(losses + vals).all():
        raise AssertionError(f"train_cli_dp: non-finite losses {losses} or val/loss {vals}")
    epoch_rates = [m["samples_per_sec"] for _, _, m in probe.epochs]
    log(f"dp      (d) {card_line()}: train.main {n_params} parameters, {micro} micro-steps "
        f"of B={DP_BATCH} over {CLI_EPOCHS} epochs in {t_end - t_main:.2f} s "
        f"({probe.t_start - t_main:.2f} s from main to the first step; epoch 1 "
        f"{epoch_rates[-1]:.2f} samples/s); train/loss {losses}, val/loss {vals}; "
        f"launches {launches}")

    ckpts = os.path.join(root.name, "run1", "checkpoints")
    kept = sorted(os.listdir(ckpts))
    last = os.path.join(ckpts, "last")
    if "last" not in kept or len(kept) < 2:
        raise AssertionError(f"train_cli_dp: checkpoints {kept}")
    size = os.path.getsize(os.path.join(last, CHECKPOINT_FILE))
    end = _run_state(trainer, module)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.save_checkpoint(os.path.join(root.name, "saved"))
    save_s = time.perf_counter() - t0
    shutil.rmtree(os.path.join(root.name, "saved"))
    cfg = train_entry.compose_run(dp_cli_argv(root.name, "fresh"))
    other = train_entry.instantiate_model(cfg).to(dev)
    fresh = Trainer(accelerator=trainer.accelerator, precision="bf16-mixed")
    fresh.setup(other, trainer.estimated_stepping_batches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.restore_checkpoint(last, other)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got = _run_state(fresh, other)
    differ = [k for k in end if k not in got or (
        not torch.equal(got[k], end[k]) if isinstance(end[k], torch.Tensor) else got[k] != end[k])]
    restored = other.policy.normalizer
    if differ or restored is None or any(
            not (np.array_equal(restored[k].scale, normalizer[k].scale)
                 and np.array_equal(restored[k].offset, normalizer[k].offset))
            for k in ("action", "qpos")):
        raise AssertionError(f"train_cli_dp: the restore of last differs in {differ[:10]} "
                             f"or in the normalizer")
    log(f"dp      (d) {card_line()}: checkpoints {kept}; one is {size / 1e9:.3f} GB, saved "
        f"in {save_s:.2f} s, restored in {restore_s:.2f} s; {len(end)} tensors and values "
        f"and the normalizer bit-equal to the run's end")
    root.cleanup()
    CLI_DATA.clear()
    EndState.runs.clear()
    del trainer, module, probe, other, fresh, got, end
    torch.cuda.empty_cache()
    return launches


def train_dp(dev) -> tuple[dict, dict]:
    """Phase 13: (a)-(d); the launches of paths ``dp_predict``, ``dp_train``
    and ``train_cli_dp``, and the (a) cases of FPS and kNN."""
    t_phase = time.perf_counter()
    cases = dp_point_kernels(dev)
    paths = {"dp_predict": dp_serve(dev), "dp_train": dp_train(dev),
             "train_cli_dp": train_cli_dp(dev)}
    log(f"dp      phase 13 in {time.perf_counter() - t_phase:.1f} s")
    return paths, cases


# phase 14: SpUNet (PR 21), the paper's sparse-voxel encoder, as
# configs/exp_maniskill2_act_policy/maniskill2_model/scratch_spunet_pcd.yaml
# ships it: the flagship's ACT head (hidden 512, 2048 tokens, k = 16, chunk
# 100, B = 8 x 2, "bf16-mixed") over SpUNet (in_channels 6, 96 channels out;
# 43,599,040 parameters); clouds of about 12,700 grid-sampled points
# (5 mm voxels, unique a cloud) padded to 12,800 (pad_multiple 512), as
# phase 10's demos hold after the config's GridSamplePCD. SpUNet has no
# kernel of its own (JAX computes its sparse convolutions in XLA): its
# paths launch kernels 1, 2 and 3/4 of the ACT head around it.
SPUNET_BATCH, SPUNET_POINTS, SPUNET_VALID = 8, 12800, (12500, 12750)
SPUNET_PARAMS = 43_599_040
SPUNET_CPU_TOL = 1e-4  # of max |CPU output|, f32: summation order only (CPU tests: 1e-4 at TINY)
SPUNET_SERVE_BATCHES = (1, SPUNET_BATCH)
SPUNET_CLI_BATCHES = 2  # micro-steps an epoch in (e): 2 epochs of 2, B = 8 x 2
# (g): the DP over SpUNet, one bf16 step at the largest batch that the
# reckoning of its peak memory puts under 60 GB (55.88 GiB). PR 21's first
# reckoning, from the tensors SpUNet saves for its backward (counted on the
# CPU: ~136 KB a padded point in bf16, 1.75 GB a cloud of 12,800, plus
# ~0.35 GB of recomputed gathers) and ~5.4 GB of masters, casts, gradients
# and AdamW moments, gave B = 12 (55.8 GB); the card measured 43.60 GiB
# there. Refitted on that: ~5.0 GiB + 3.22 GiB a sample (two clouds), so
# B = 15 (53.3 GiB); the shipped batch of 64 would need ~211 GiB.
DP_SPUNET_BATCH = 15
DP_SPUNET_GIB = (5.0, 3.22)  # the reckoning: fixed GiB, GiB a sample


def spunet_batch(batch_size: int, seed: int, with_actions: bool = True) -> dict:
    from pointcloudmatters_tpu_torch.entry import build_grid_batch

    return build_grid_batch(batch_size, SPUNET_POINTS, SPUNET_VALID, seed=seed,
                            with_actions=with_actions)


def spunet_levels(grid, valid) -> list:
    """Valid slots at each of SpUNet's five levels (the input and four
    stride-2 poolings), per cloud."""
    from pointcloudmatters_tpu_torch.ops import sparse as S

    counts = [valid.sum(1)]
    for _ in range(4):
        parent, _, valid = S.voxel_downsample(grid, valid)
        grid = parent.where(valid[..., None], 0)
        counts.append(valid.sum(1))
    return [c.tolist() for c in counts]


def spunet_flops(net, n_slots: list) -> list:
    """Forward flops of ``net`` by level, each convolution 2 K Ci Co a slot
    (``strided_downconv`` and ``inverse_upconv`` take all 8 taps' products,
    as JAX's one-hot product does), at ``n_slots[level]`` slots; the
    down-convolution and up-convolution of stage s count at level s (their
    children)."""
    import re as _re

    flops = [0.0] * 5
    for name, p in net.named_parameters(recurse=False):
        if p.ndim != 3:
            continue
        k, ci, co = p.shape
        m = _re.match(r"(down|up|enc|dec)(\d+)", name)
        level = 0 if m is None else int(m.group(2)) + (m.group(1) == "enc")
        flops[level] += 2.0 * k * ci * co * n_slots[level]
    return flops


def spunet_alone(dev) -> dict:
    """Phase 14 (a): SpUNet at scratch_spunet_pcd's shapes, f32 and bf16:
    valid slots by level; the f32 train-mode forward of one cloud on the card
    against the CPU at the valid slots (SPUNET_CPU_TOL); two forward +
    backward runs at B=8 from the same state bit-equal in outputs and
    parameter gradients; forward and forward + backward times (CUDA events)
    and peak memory."""
    import copy

    import torch

    from pointcloudmatters_tpu_torch.entry import init_parameters
    from pointcloudmatters_tpu_torch.models.bc_module import to_device
    from pointcloudmatters_tpu_torch.models.components.pcd_encoder.spunet import SpUNet

    net = SpUNet(in_channels=6)
    init_parameters(net, torch.Generator().manual_seed(0))
    if sum(p.numel() for p in net.parameters()) != SPUNET_PARAMS:
        raise AssertionError("SpUNet: not the configs' widths")
    pcds = to_device(spunet_batch(SPUNET_BATCH, seed=0)["pcds"], dev)
    levels = spunet_levels(pcds["grid_coord"], pcds["valid"])
    padded = spunet_flops(net, [SPUNET_BATCH * SPUNET_POINTS] * 5)
    valid_flops = spunet_flops(net, [sum(c) for c in levels])
    log(f"spunet  (a) valid slots a cloud by level (of {SPUNET_POINTS} padded): "
        + "; ".join(f"L{i} {min(c)}-{max(c)} (mean {sum(c) / len(c):.0f})"
                    for i, c in enumerate(levels)))
    log(f"spunet  (a) forward flops at B={SPUNET_BATCH}, as the code runs (every level "
        f"{SPUNET_POINTS} slots): {sum(padded) / 1e12:.3f} TFLOP, levels 3-4 "
        f"{sum(padded[3:]) / 1e12:.3f}; on the valid slots alone {sum(valid_flops) / 1e12:.3f} "
        f"TFLOP (" + ", ".join(f"L{i} {f / 1e9:.1f}" for i, f in enumerate(valid_flops))
        + " GFLOP)")

    # the card against the CPU, f32, one cloud
    one = {k: v[:1] for k, v in pcds.items()}
    cpu_net = copy.deepcopy(net)
    with torch.no_grad():
        ref = cpu_net({k: v.cpu() for k, v in one.items()}, train=True)
        got = copy.deepcopy(net).to(dev)(one, train=True)
    keep = one["valid"][0].cpu()
    err = (got[0].cpu()[keep] - ref[0][keep]).abs().max().item()
    scale = ref[0][keep].abs().max().item()
    if not err <= SPUNET_CPU_TOL * scale:
        raise AssertionError(f"spunet card vs CPU: {err:.3e} > {SPUNET_CPU_TOL} x {scale:.3e}")
    log(f"spunet  (a) f32 train-mode forward, one cloud, card vs CPU at the valid slots: "
        f"max abs diff {err:.3e} of max |CPU| {scale:.3e} (limit {SPUNET_CPU_TOL} of it)")
    del cpu_net, ref, got

    # two runs on the card: bit-equal
    cot = torch.randn(SPUNET_BATCH, SPUNET_POINTS, net.num_channels,
                      generator=torch.Generator().manual_seed(1)).to(dev)

    def fwd_bwd(model, d):
        model.zero_grad(set_to_none=True)
        out = model(d, train=True)
        (out.float() * cot).sum().backward()
        return out.detach(), {n: p.grad for n, p in model.named_parameters()}

    runs = [fwd_bwd(copy.deepcopy(net).to(dev), pcds) for _ in range(2)]
    same = torch.equal(runs[0][0], runs[1][0]) and all(
        torch.equal(g, runs[1][1][n]) for n, g in runs[0][1].items())
    if not same:
        raise AssertionError("spunet: two forward + backward runs on the card differ")
    log(f"spunet  (a) two f32 forward + backward runs at B={SPUNET_BATCH}: outputs and all "
        f"{len(runs[0][1])} parameter gradients bit-equal")
    del runs

    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = copy.deepcopy(net).to(dev, dtype)
        d = dict(pcds, feat=pcds["feat"].to(dtype))
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: model(d, train=True), 3)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        both_ms = cuda_ms(lambda: fwd_bwd(model, d), 3)
        peak = torch.cuda.max_memory_allocated(dev)
        name = str(dtype).split(".")[-1]
        times[name] = dict(fwd_ms=fwd_ms, fwd_bwd_ms=both_ms, peak_gib=peak / 2**30)
        log(f"spunet  (a) {card_line()}: {name} B={SPUNET_BATCH}: forward {fwd_ms:.2f} ms, "
            f"forward + backward {both_ms:.2f} ms, peak device memory {peak / 2**30:.2f} GiB")
        del model, d
        torch.cuda.empty_cache()
    return {"levels": levels, "tflop_padded": sum(padded) / 1e12,
            "tflop_valid": sum(valid_flops) / 1e12, **times}


def spunet_module(dev, **kw):
    from pointcloudmatters_tpu_torch.entry import build_flagship
    from pointcloudmatters_tpu_torch.models.bc_module import BCModule

    return BCModule(build_flagship(seed=0, backbone="spunet", device=dev, **kw),
                    optimizer=FLAGSHIP_OPT, lr_scheduler=FLAGSHIP_SCHED)


def spunet_serve(dev, module, what: str, batches=SPUNET_SERVE_BATCHES) -> dict:
    """``predict`` in f32: a warm-up request at each size, then three timed
    by the host clock; finite (B, 100, 7) actions; FPS, kNN and f32 kernel 3
    on every request and no other kernel. Returns the launches."""
    import torch

    from pointcloudmatters_tpu_torch import ops

    requests = {B: [spunet_batch(B, seed=s, with_actions=False) for s in (1, 2, 3)]
                for B in batches}
    for B in batches:
        module.predict(requests[B][0])
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    times = {}
    for B in batches:
        for obs in requests[B]:
            t0 = time.perf_counter()
            a_hat = module.predict(obs)
            torch.cuda.synchronize()
            times.setdefault(B, []).append((time.perf_counter() - t0) * 1e3)
            if tuple(a_hat.shape) != (B, 100, 7) or not torch.isfinite(a_hat).all():
                raise AssertionError(f"{what} B={B}: {tuple(a_hat.shape)}, not finite (B, 100, 7)")
    launches = ops.launch_counts()
    n = 3 * len(batches)
    _only(launches, {"fps": n, "knn": n, "attention_fwd": n * ENC_LAYERS}, what)
    for B, ms in times.items():
        log(f"spunet  {what} {card_line()}: predict B={B} (<= {SPUNET_VALID[1]} of "
            f"{SPUNET_POINTS} points, f32): " + ", ".join(f"{t:.2f}" for t in ms) + " ms")
    return launches


def spunet_steps(dev, module, what: str, steps: int = TRAIN_STEPS) -> dict:
    """``"bf16-mixed"`` steps at B=8: a warm-up, then ``steps`` under
    ``torch.cuda.set_sync_debug_mode("error")`` timed by the host clock;
    samples/s, peak memory, finite losses and moved parameters; FPS and kNN
    once a step and bf16 kernels 3/4 once a layer and no other kernel.
    Returns the launches and the batch."""
    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch.models.bc_module import to_device
    from pointcloudmatters_tpu_torch.trainer import Trainer

    trainer = Trainer(precision="bf16-mixed", seed=0)
    trainer.setup(module, TOTAL_STEPS)
    batch = to_device(spunet_batch(SPUNET_BATCH, seed=0), dev)
    start = [p.detach().clone() for p in module.policy.parameters()]
    trainer.train_step(module, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")  # any host sync in a step raises
    try:
        t0 = time.perf_counter()
        out = [trainer.train_step(module, batch) for _ in range(steps)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [float(m["loss"]) for m in out]
    if not np.isfinite(losses).all():
        raise AssertionError(f"{what}: non-finite losses {losses}")
    moved = sum(not torch.equal(a, p) for a, p in zip(start, module.policy.parameters()))
    if moved < len(start) // 2:
        raise AssertionError(f"{what}: {moved} of {len(start)} parameter tensors moved")
    _only(launches, {k: steps * n for k, n in ACT_KERNELS_A_STEP.items()}, what)
    log(f"spunet  {what} {card_line()}: B={SPUNET_BATCH} bf16-mixed {step_ms:.2f} ms/step over "
        f"{steps} steps, {SPUNET_BATCH * 1e3 / step_ms:.2f} samples/s, peak device memory "
        f"{peak / 2**30:.2f} GiB; loss {losses}; {moved} parameter tensors moved")
    del trainer, start, out
    return launches, batch


def spunet_act(dev) -> dict:
    """Phase 14 (b)-(d): ACT over SpUNet ``predict`` (B=1, 8) and its
    ``"bf16-mixed"`` step at B=8, one B=8 step on the kernels against one on
    the plain versions (BF16_STEP_TOL); then the ``pre_sample`` variant
    (``scratch_spunet_pcd_presample``): ``predict`` at B=1 and a bf16 step
    at B=8, the builder's kernels 5/6 launched zero times (its tokens are 6
    wide)."""
    import torch

    module = spunet_module(dev)
    n_params = sum(p.numel() for p in module.policy.parameters())
    paths = {"spunet_predict": spunet_serve(dev, module, "(b)")}
    paths["spunet_train"], batch = spunet_steps(dev, module, "(c)")
    got = _step_grads(module, batch, module.make_rngs(5), torch.bfloat16)
    with plain_kernels():
        ref = _step_grads(module, batch, module.make_rngs(5), torch.bfloat16)
    log("spunet  (c) " + _compare_step(f"bf16 B={SPUNET_BATCH} step, kernels vs plain versions",
                                       *got, *ref, grad_rtol=BF16_STEP_TOL,
                                       loss_rtol=BF16_STEP_TOL)
        + f"; {n_params} parameters")
    del module, batch, got, ref
    torch.cuda.empty_cache()

    module = spunet_module(dev, pre_sample=True)
    paths["spunet_presample_predict"] = spunet_serve(dev, module, "(d) pre_sample", (1,))
    paths["spunet_presample_train"], _ = spunet_steps(dev, module, "(d) pre_sample", 2)
    for path in ("spunet_presample_predict", "spunet_presample_train"):
        if any(paths[path][k] for k in BUILDER_KERNELS):
            raise AssertionError(f"{path} launched a builder kernel")
    del module
    torch.cuda.empty_cache()
    return paths


def train_cli_spunet(dev) -> dict:
    """Phase 14 (e): ``train.main`` on scratch_spunet_pcd over phase 10's
    demos with phase 11's overrides (B = 8 x 2, 2 epochs of 2 micro-steps,
    held-out validation after each); a run from ``last`` resuming at epoch
    2; ``validate.main`` on the best checkpoint. Launches of kernels 1, 2,
    bf16 3/4 (training) and f32 3 (validation) and no other; seconds to the
    first step, ms per optimizer step, the checkpoint's size."""
    import tempfile

    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch import train as train_entry
    from pointcloudmatters_tpu_torch import validate as validate_entry
    from pointcloudmatters_tpu_torch.trainer import CHECKPOINT_FILE

    sys.modules.setdefault("chip_smoke", sys.modules[__name__])  # the targets' module
    root = tempfile.TemporaryDirectory()
    demos = synthetic_demos(FIT_EPISODES, FIT_EPISODE_LEN, FIT_CAM_SIDE)
    n_train = FIT_EPISODES - FIT_HELD_OUT
    CLI_DATA.update(train=demos[:n_train], held_out=demos[n_train:],
                    cache=os.path.join(root.name, "cache"))
    EndState.runs.clear()
    micro, n_val = CLI_EPOCHS * SPUNET_CLI_BATCHES, FIT_HELD_OUT * 2

    def argv(run):
        return cli_argv(root.name, run, "scratch_spunet_pcd") + [
            f"trainer.limit_train_batches={SPUNET_CLI_BATCHES}"]

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t_main = time.perf_counter()
    train_entry.main(argv("run1"))
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = ops.launch_counts()
    probe = EndState.runs[-1]
    trainer, module = probe.trainer, probe.module
    n_eval = CLI_EPOCHS * n_val
    _only(launches, {"fps": micro + n_eval, "knn": micro + n_eval,
                     "attention_fwd_bf16": micro * ENC_LAYERS,
                     "attention_bwd_bf16": micro * ENC_LAYERS,
                     "attention_fwd": n_eval * ENC_LAYERS}, "train_cli_spunet")
    backbone = module.policy.backbone
    if (type(backbone).__name__, trainer.precision, trainer.global_step,
            module.scheduler.last_epoch) != ("SpUNet", "bf16-mixed", micro, micro // FIT_ACCUMULATE):
        raise AssertionError("train_cli_spunet: not the composition or the steps it should be")
    losses = [m["train/loss"] for _, _, m in probe.epochs]
    vals = [m["val/loss"] for _, _, m in probe.epochs]
    if not np.isfinite(losses + vals).all():
        raise AssertionError(f"train_cli_spunet: non-finite {losses} or val/loss {vals}")
    rate = probe.epochs[-1][2]["samples_per_sec"]
    ckpts = os.path.join(root.name, "run1", "checkpoints")
    last, best = os.path.join(ckpts, "last"), trainer.checkpoint_callback.best_model_path
    size = os.path.getsize(os.path.join(last, CHECKPOINT_FILE))
    log(f"spunet  (e) {card_line()}: train.main scratch_spunet_pcd, "
        f"{sum(p.numel() for p in module.policy.parameters())} parameters, {micro} micro-steps "
        f"of B={FIT_BATCH} over {CLI_EPOCHS} epochs in {t_end - t_main:.2f} s; "
        f"{probe.t_start - t_main:.2f} s from main to the first step; epoch 1 {rate:.2f} "
        f"samples/s = {FIT_BATCH * FIT_ACCUMULATE * 1e3 / rate:.2f} ms per optimizer step; "
        f"checkpoint {size / 1e6:.1f} MB; train/loss {losses}, val/loss {vals}; "
        f"checkpoints {sorted(os.listdir(ckpts))}; launches {launches}")
    del trainer, module, probe

    ops.reset_launch_counts()
    train_entry.main(argv("run2") + [f"trainer.max_epochs={CLI_EPOCHS + 1}", f"ckpt_path={last}"])
    torch.cuda.synchronize()
    resume_launches = ops.launch_counts()
    resumed = EndState.runs[-1]
    if resumed.start != (CLI_EPOCHS, micro) or [e for e, *_ in resumed.epochs] != [CLI_EPOCHS]:
        raise AssertionError(f"train_cli_spunet: resumed at {resumed.start}, "
                             f"epochs {resumed.epochs}")
    ops.reset_launch_counts()
    metrics = validate_entry.main(argv("val") + [f"ckpt_path={best}"])
    torch.cuda.synchronize()
    val_launches = ops.launch_counts()
    if set(metrics) != {"val/loss", "val/loss_best"} or not np.isfinite(metrics["val/loss"]):
        raise AssertionError(f"validate_cli_spunet: {metrics}")
    _only(val_launches, {"fps": n_val, "knn": n_val, "attention_fwd": n_val * ENC_LAYERS},
          "validate_cli_spunet")
    log(f"spunet  (e) resumed at epoch {resumed.start[0]}, step {resumed.start[1]}, launches "
        f"{resume_launches}; validate.main(best) {metrics}, launches {val_launches}")
    root.cleanup()
    CLI_DATA.clear()
    EndState.runs.clear()
    del resumed
    torch.cuda.empty_cache()
    return {"train_cli_spunet": launches, "train_cli_spunet_resume": resume_launches,
            "validate_cli_spunet": val_launches}


def spunet_ponderv2(dev) -> dict:
    """Phase 14 (f): ``pretrained_ponderv2_pcd`` with HOME at a temporary
    directory holding a fake ``.ponderv2/ponderv2.pth`` (a seeded SpUNet's
    weights and random batch statistics in PonderV2's keys and spconv's
    layout): ``train.instantiate_model`` loads it, every plane equal to the
    file's tensor permuted from (out, k, k, k, in) and every other entry to
    the file's; then one ``predict`` at B=1 on the card. Returns its
    launches (path ``spunet_ponderv2``)."""
    import tempfile

    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch import train as train_entry
    from pointcloudmatters_tpu_torch.entry import init_parameters
    from pointcloudmatters_tpu_torch.models.components.pcd_encoder import spunet as sp

    root = tempfile.TemporaryDirectory()
    fake = sp.SpUNet(in_channels=6)
    init_parameters(fake, torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, buf in fake.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=gen) + (0.5 if name.endswith("var") else -0.5))
    path = os.path.join(root.name, ".ponderv2", "ponderv2.pth")
    os.makedirs(os.path.dirname(path))
    sd = sp.to_ponderv2_state_dict(fake)
    torch.save({"state_dict": sd, "epoch": 100}, path)
    home = os.environ.get("HOME")
    os.environ["HOME"] = root.name
    try:
        cfg = train_entry.compose_run(cli_argv(root.name, "ponderv2", "pretrained_ponderv2_pcd"))
        module = train_entry.instantiate_model(cfg)
    finally:
        if home is None:
            del os.environ["HOME"]
        else:
            os.environ["HOME"] = home
    net = module.policy.backbone
    if net.pretrained_path != path:
        raise AssertionError(f"ponderv2: pretrained_path {net.pretrained_path!r}, not {path!r}")
    state = net.state_dict()
    wrong = [k for k, v in sp.ponderv2_state_dict(net, sd).items() if not torch.equal(state[k], v)]
    w = sd["module.backbone.enc.3.block5.conv2.weight"]
    plane = w.reshape(w.shape[0], 27, w.shape[-1]).permute(1, 2, 0)
    if wrong or not torch.equal(net.enc3_block5_conv2.detach(), plane) or len(sd) != len(state):
        raise AssertionError(f"ponderv2: {len(wrong)} entries differ from the file: {wrong[:5]}")
    module.to(dev)
    ops.reset_launch_counts()
    a_hat = module.predict(spunet_batch(1, seed=5, with_actions=False))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    if not torch.isfinite(a_hat).all():
        raise AssertionError("ponderv2: non-finite actions")
    _only(launches, {"fps": 1, "knn": 1, "attention_fwd": ENC_LAYERS}, "spunet_ponderv2")
    launches = {"spunet_ponderv2": launches}
    log(f"spunet  (f) pretrained_ponderv2_pcd: {len(sd)} tensors of a {os.path.getsize(path) / 1e6:.1f}"
        f" MB fake PonderV2 file loaded bit for bit (planes permuted from spconv's layout); "
        f"predict B=1 finite; launches {launches}")
    root.cleanup()
    del module
    torch.cuda.empty_cache()
    return launches


def dp_spunet_batch(batch_size: int, qpos_dim: int, seed: int,
                    with_actions: bool = True) -> dict:
    """A batch of the DP's scratch_spunet_pcd composition, its 2 x
    batch_size clouds grid-sampled as phase 14's."""
    from pointcloudmatters_tpu_torch.entry import build_dp_batch

    batch = build_dp_batch(batch_size, DP_OBS_STEPS, n_points=8, qpos_dim=qpos_dim, seed=seed,
                           with_actions=with_actions)
    batch["obs"]["pcds"] = spunet_batch(batch_size * DP_OBS_STEPS, seed=seed)["pcds"]
    return batch


def dp_spunet(dev) -> dict:
    """Phase 14 (g): the DP over SpUNet (configs/exp_maniskill2_diffusion_policy
    scratch_spunet_pcd, instantiated by ``train.instantiate_model``, a
    seeded normalizer): ``predict`` at B=1 (2 clouds, 100 DDPM steps), a
    warm-up and three timed; one ``"bf16-mixed"`` step at DP_SPUNET_BATCH
    after a warm-up, timed, with its peak memory. FPS and kNN once a
    request and a step, no other kernel."""
    import tempfile

    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch import train as train_entry
    from pointcloudmatters_tpu_torch.models.bc_module import to_device
    from pointcloudmatters_tpu_torch.trainer import Trainer

    sys.modules.setdefault("chip_smoke", sys.modules[__name__])  # the targets' module
    root = tempfile.TemporaryDirectory()
    cfg = train_entry.compose_run(dp_cli_argv(root.name, "dp_spunet", "scratch_spunet_pcd"))
    module = train_entry.instantiate_model(cfg).to(dev)
    qpos_dim = cfg.model.policy.shape_meta["obs"]["qpos"]["shape"][0]  # the task's, 9
    module.policy.normalizer = dp_normalizer(qpos_dim)
    n_params = sum(p.numel() for p in module.policy.parameters())
    if type(module.policy.obs_encoder.pcd_model).__name__ != "SpUNet":
        raise AssertionError("dp_spunet: the encoder is not SpUNet")

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    requests = [dp_spunet_batch(1, qpos_dim, seed=s, with_actions=False) for s in (1, 2, 3)]
    module.predict(requests[0], gen(0))  # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    times = []
    for i, obs in enumerate(requests):
        t0 = time.perf_counter()
        action = module.predict(obs, gen(i))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if tuple(action.shape) != (1, 8, 7) or not torch.isfinite(action).all():
            raise AssertionError(f"dp_spunet predict: {tuple(action.shape)}, not finite (1, 8, 7)")
    predict_launches = ops.launch_counts()
    _only(predict_launches, {"fps": 3, "knn": 3}, "dp_spunet_predict")
    log(f"spunet  (g) {card_line()}: DP over SpUNet, {n_params} parameters: predict B=1 "
        f"(2 clouds, 100 DDPM steps, f32): " + ", ".join(f"{t:.2f}" for t in times) + " ms")

    trainer = Trainer(precision="bf16-mixed", seed=0)
    trainer.setup(module, TOTAL_STEPS)
    batch = to_device(dp_spunet_batch(DP_SPUNET_BATCH, qpos_dim, seed=0), dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    trainer.train_step(module, batch)  # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    loss = float(trainer.train_step(module, batch)["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    train_launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    if not np.isfinite(loss):
        raise AssertionError(f"dp_spunet: loss {loss}")
    _only(train_launches, {"fps": 1, "knn": 1}, "dp_spunet_train")
    log(f"spunet  (g) {card_line()}: bf16-mixed step B={DP_SPUNET_BATCH} "
        f"({DP_SPUNET_BATCH * DP_OBS_STEPS} clouds): {step_ms:.2f} ms, "
        f"{DP_SPUNET_BATCH * 1e3 / step_ms:.2f} samples/s, peak device memory "
        f"{peak / 2**30:.2f} GiB (reckoned "
        f"{DP_SPUNET_GIB[0] + DP_SPUNET_GIB[1] * DP_SPUNET_BATCH:.1f} GiB); loss {loss}")
    root.cleanup()
    del module, trainer, batch
    torch.cuda.empty_cache()
    return {"dp_spunet_predict": predict_launches, "dp_spunet_train": train_launches}


def train_spunet(dev) -> tuple[dict, dict]:
    """Phase 14: (a)-(g); the launches of its paths and (a)'s figures."""
    t_phase = time.perf_counter()
    alone = spunet_alone(dev)
    paths = spunet_act(dev)
    paths.update(train_cli_spunet(dev))
    paths.update(spunet_ponderv2(dev))
    paths.update(dp_spunet(dev))
    log(f"spunet  phase 14 in {time.perf_counter() - t_phase:.1f} s")
    return paths, alone


# phase 15: ACT over images, the 12 image models of
# configs/exp_maniskill2_act_policy/maniskill2_model at their shipped widths:
# the flagship's ACT head (hidden 512, 8 heads, 4 encoder layers, chunk 100,
# the 2-D sine embedding of 256 + 256 features, one camera) over ResNet-50
# (224 px, bilinear), ViT-B/16 or the MultiViT-B trunk (256 px bicubic,
# centre crop 224) of 128 x 128 camera images, at the configs' batch of 16
# ("bf16-mixed", no accumulation). Their token rows are short (ResNet: 49
# cells + 3 tokens, the ViTs: 1 + 3), so the oneshot gate routes every
# attention dense, as in JAX: no kernel of #1-#13 runs on these paths.
IMAGE_BATCH = 16
IMAGE_SIDE = 128
IMAGE_CPU_TOL = 1e-4  # card vs CPU, f32: of max |CPU| (outputs), of max(1, max|g|) (gradients)
IMAGE_BACKBONES = (("resnet", 1), ("resnet", 3), ("resnet", 4), ("resnet", 6),
                   ("vit", 1), ("vit", 3), ("vit", 4), ("vit", 6), ("multivit", 4))
IMAGE_POLICIES = {"scratch_resnet50_rgb": ("resnet", 3), "scratch_vit_rgb": ("vit", 3),
                  "scratch_multivit_rgbd": ("multivit", 4)}
# (c)'s card-vs-CPU step: the policies without batch norms compare the
# train-mode step's gradients (IMAGE_CPU_TOL). ResNet-50's do not agree so:
# its train-mode features differ by ~1.4e-4 between the card and the CPU
# (cuDNN on or off: the single-pass batch variance of 2 images, E[x^2] -
# mean^2 in f32, as JAX computes it), and a ReLU input within that of zero
# routes its gradient differently on each: 4.7e-2 of a backbone tensor's
# largest gradient (measured on an H100 80GB HBM3 at 700 W; the loss
# 4e-7 relative). So ResNet's compare the train-mode loss, and the
# gradients with the batch norms at their running statistics, from one
# state on both sides (2.4e-6 in the same runs).
IMAGE_TRAIN_GRADS = ("scratch_vit_rgb", "scratch_multivit_rgbd")
IMAGE_CLI_BATCHES = 2  # micro-steps an epoch in (d): 2 epochs of 2, B = 16
IMAGE_CLI_LOOP = 8  # 6 episodes x 8 = 48 samples: 3 batches of 16


def image_backbone(kind: str, channels: int):
    """A backbone at the configs' width: ResNet-50, ViT-B/16 or MultiViT-B."""
    from pointcloudmatters_tpu_torch.models.components.img_encoder import multivit, resnet, vit

    if kind == "resnet":
        return resnet.ResNetTorchVision(resnet_model="resnet50", channels=channels)
    if kind == "vit":
        return vit.ViT(model_name="vit_base_patch16", channels=channels)
    return multivit.MultiViTModel()


def image_batch(batch_size: int, channels: int, seed: int, with_actions: bool = True) -> dict:
    from pointcloudmatters_tpu_torch.entry import build_image_batch

    return build_image_batch(batch_size, IMAGE_SIDE, channels, seed=seed,
                             with_actions=with_actions)


def image_backbones(dev) -> dict:
    """Phase 15 (a): each backbone alone at full width, f32, seeded weights:
    the eval forward of 2 images on the card against the CPU
    (IMAGE_CPU_TOL); forward and forward + backward ms (train mode, CUDA
    events) and peak memory at B=16, the forward's flops counted by
    ``torch.utils.flop_counter`` on the CPU run. Returns the figures."""
    import copy

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from pointcloudmatters_tpu_torch.entry import init_parameters

    out = {}
    for kind, channels in IMAGE_BACKBONES:
        net = image_backbone(kind, channels)
        init_parameters(net, torch.Generator().manual_seed(0))
        images = torch.from_numpy(image_batch(IMAGE_BATCH, channels, seed=0)["image"][:, 0])
        counter = FlopCounterMode(display=False)
        with torch.no_grad(), counter:
            ref = net(images[:2], train=False)
        flops = counter.get_total_flops() / 2 * IMAGE_BATCH
        model = copy.deepcopy(net).to(dev)
        x = images.to(dev)
        with torch.no_grad():
            got = model(x[:2], train=False).cpu()
        err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
        if not err <= IMAGE_CPU_TOL * scale:
            raise AssertionError(f"{kind} {channels}ch card vs CPU: {err:.3e} > "
                                 f"{IMAGE_CPU_TOL} x {scale:.3e}")
        cot = torch.randn(got.shape[1:], generator=torch.Generator().manual_seed(1)).to(dev)

        def fwd_bwd():
            model.zero_grad(set_to_none=True)
            (model(x, train=True) * cot).sum().backward()

        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: model(x, train=True), 3)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        both_ms = cuda_ms(fwd_bwd, 3)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        name = f"{kind}_{channels}ch"
        out[name] = dict(params=sum(p.numel() for p in net.parameters()), err=err / scale,
                         fwd_ms=fwd_ms, fwd_bwd_ms=both_ms, peak_gib=peak,
                         fwd_tflops=flops / fwd_ms / 1e9)
        log(f"image   (a) {card_line()}: {name}, {out[name]['params']} parameters: card vs CPU "
            f"(eval, 2 images) {err:.3e} of max |CPU| {scale:.3e}; B={IMAGE_BATCH} f32 forward "
            f"{fwd_ms:.2f} ms ({flops / 1e9:.1f} GFLOP, {flops / fwd_ms / 1e9:.1f} TFLOP/s), "
            f"forward + backward {both_ms:.2f} ms, peak device memory {peak:.2f} GiB")
        del net, model, x, images
        torch.cuda.empty_cache()
    return out


def image_module(dev, model: str, **kw):
    from pointcloudmatters_tpu_torch.entry import build_image_policy
    from pointcloudmatters_tpu_torch.models.bc_module import BCModule

    kind, channels = IMAGE_POLICIES[model]
    return BCModule(build_image_policy(kind, channels, seed=0, device=dev, **kw),
                    optimizer=FLAGSHIP_OPT, lr_scheduler=FLAGSHIP_SCHED)


def image_serve(dev) -> dict:
    """Phase 15 (b): ``predict`` in f32 of the three image policies at B=1
    and B=16: a warm-up request at each size, then three timed by the host
    clock; finite (B, 100, 7) actions and no launch of a kernel of #1-#13.
    Returns the launches by path."""
    import torch

    from pointcloudmatters_tpu_torch import ops

    paths = {}
    for model, (_, channels) in IMAGE_POLICIES.items():
        module = image_module(dev, model)
        requests = {B: [image_batch(B, channels, seed=s, with_actions=False) for s in (1, 2, 3)]
                    for B in (1, IMAGE_BATCH)}
        for B, reqs in requests.items():
            module.predict(reqs[0])
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        times = {}
        for B, reqs in requests.items():
            for obs in reqs:
                t0 = time.perf_counter()
                a_hat = module.predict(obs)
                torch.cuda.synchronize()
                times.setdefault(B, []).append((time.perf_counter() - t0) * 1e3)
                if tuple(a_hat.shape) != (B, 100, 7) or not torch.isfinite(a_hat).all():
                    raise AssertionError(f"{model} B={B}: {tuple(a_hat.shape)}, not finite "
                                         f"(B, 100, 7)")
        paths[f"{model}_predict"] = launches = ops.launch_counts()
        _only(launches, {}, f"{model} predict")
        log(f"image   (b) {card_line()}: {model} predict (f32, {IMAGE_SIDE} px): "
            + "; ".join(f"B={B} " + ", ".join(f"{t:.2f}" for t in ms) + " ms"
                        for B, ms in times.items()))
        del module
        torch.cuda.empty_cache()
    return paths


def _fixed_posterior_noise(batch_size: int):
    """A context in which ACT's CVAE posterior draws one fixed standard
    normal (batch_size, 32) array on every device, so that a step on the
    card and one on the CPU take the same latent."""
    import torch

    from pointcloudmatters_tpu_torch.models.components.act import act

    eps = torch.randn(batch_size, 32, generator=torch.Generator().manual_seed(7))

    @contextlib.contextmanager
    def ctx():
        saved = act.reparametrize
        act.reparametrize = lambda mu, logvar, gen: mu + torch.exp(0.5 * logvar) * eps.to(
            mu.device, mu.dtype)
        try:
            yield
        finally:
            act.reparametrize = saved

    return ctx()


def _eval_grads(module, batch):
    """Loss and parameter gradients of the policy's eval-mode forward over a
    batch with actions: the batch norms at their running statistics, the
    posterior's mean, no dropout."""
    from pointcloudmatters_tpu_torch.models.bc_module import select_model_batch, to_device

    module.policy.zero_grad(set_to_none=True)
    out = module.policy(to_device(select_model_batch(batch), module.device), train=False)
    out["loss"].backward()
    grads = {n: p.grad.detach().clone() for n, p in module.policy.named_parameters()
             if p.grad is not None}
    return out["loss"].detach(), grads


def image_steps(dev) -> dict:
    """Phase 15 (c): the ``"bf16-mixed"`` step of the three image policies
    at B=16: a warm-up, then TRAIN_STEPS steps under
    ``torch.cuda.set_sync_debug_mode("error")`` timed by the host clock;
    samples/s, peak memory, finite losses, moved parameters and no launch of
    #1-#13; then the f32 step on the card against the same step on the CPU
    at B=2 (dropout 0, the posterior noise fixed): the loss within
    IMAGE_CPU_TOL relative and each gradient within IMAGE_CPU_TOL of
    max(1, max|g|) of its tensor (ResNet's gradients with its batch norms
    at their running statistics, from one state: IMAGE_TRAIN_GRADS says
    why). Returns the launches by path."""
    import copy

    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch.models.bc_module import to_device
    from pointcloudmatters_tpu_torch.trainer import Trainer

    paths = {}
    for model, (_, channels) in IMAGE_POLICIES.items():
        module = image_module(dev, model)
        trainer = Trainer(precision="bf16-mixed", seed=0)
        trainer.setup(module, TOTAL_STEPS)
        batch = to_device(image_batch(IMAGE_BATCH, channels, seed=0), dev)
        start = [p.detach().clone() for p in module.policy.parameters()]
        trainer.train_step(module, batch)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")  # any host sync in a step raises
        try:
            t0 = time.perf_counter()
            outs = [trainer.train_step(module, batch) for _ in range(TRAIN_STEPS)]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
        paths[f"{model}_train"] = launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        losses = [float(m["loss"]) for m in outs]
        moved = sum(not torch.equal(a, p) for a, p in zip(start, module.policy.parameters()))
        if not np.isfinite(losses).all() or moved < len(start) // 2:
            raise AssertionError(f"{model}: losses {losses}, {moved} of {len(start)} moved")
        _only(launches, {}, f"{model} bf16 step")
        log(f"image   (c) {card_line()}: {model} B={IMAGE_BATCH} bf16-mixed {step_ms:.2f} ms/step "
            f"over {TRAIN_STEPS} steps, {IMAGE_BATCH * 1e3 / step_ms:.2f} samples/s, peak device "
            f"memory {peak:.2f} GiB; loss {losses}; "
            f"{sum(p.numel() for p in module.policy.parameters())} parameters")
        del module, trainer, batch, start, outs
        torch.cuda.empty_cache()

        card = image_module(dev, model, dropout=0.0)
        cpu = copy.deepcopy(card).to("cpu")
        small = image_batch(2, channels, seed=3)
        with _fixed_posterior_noise(2):
            got = _step_grads(card, to_device(small, dev), card.make_rngs(5))
            ref = _step_grads(cpu, small, cpu.make_rngs(5))
        what = f"{model} f32 B=2 step, card vs CPU"
        if model in IMAGE_TRAIN_GRADS:
            log("image   (c) " + _compare_step(what, *got, *ref, grad_rtol=IMAGE_CPU_TOL,
                                               loss_rtol=IMAGE_CPU_TOL))
        else:
            log("image   (c) " + _compare_step(what + ", train-mode loss", got[0], {}, ref[0],
                                               {}, grad_rtol=IMAGE_CPU_TOL,
                                               loss_rtol=IMAGE_CPU_TOL))
            # fresh copies: the steps above moved each side's running
            # statistics by its own batch statistics
            card = image_module(dev, model, dropout=0.0)
            cpu = copy.deepcopy(card).to("cpu")
            log("image   (c) " + _compare_step(
                f"{model} f32 B=2, card vs CPU, batch norms at their running statistics",
                *_eval_grads(card, small), *_eval_grads(cpu, small),
                grad_rtol=IMAGE_CPU_TOL, loss_rtol=IMAGE_CPU_TOL))
        del card, cpu, got, ref
        torch.cuda.empty_cache()
    return paths


# (d): the image compositions through the port's entry point, over phase
# 10's demos held in memory (their 128 x 128 RGB-D images; the pointmap's
# 6-channel image from their cloud), with phase 11's overrides and these:
# the RGB-D task (maniskill2_task) but for the pointmap, the data targets
# below, 2 micro-steps an epoch of the configs' 16 (no accumulation).
def _image_dataset(kw: dict) -> str:
    """The RGB-D dataset for the configs' ``camera_names``, the point-cloud
    one (a pointmap) for their ``camera_ids``."""
    return ACT_RGBD if "camera_names" in kw else ACT_PCD


def cli_image_train_set(dataset_file=None, loop=IMAGE_CLI_LOOP, **kw):
    """``data.train``'s target in phase 15 (d): the port's RGB-D dataset
    (the configs' ``camera_names``), or its point-cloud dataset (a
    pointmap's ``camera_ids``), over phase 10's training demos."""
    CLI_DATA["train_kw"] = kw
    return in_memory_dataset(CLI_DATA["train"], _image_dataset(kw), loop=loop,
                             cache_dir=CLI_DATA["cache"], **kw)


def cli_image_held_out_set(size=None):
    """``data.val``'s target in phase 15 (d): the held-out demos, twice, with
    the training set's keys."""
    kw = CLI_DATA["train_kw"]
    return in_memory_dataset(CLI_DATA["held_out"], _image_dataset(kw), loop=2,
                             cache_dir=CLI_DATA["cache"], **kw)


def image_cli_argv(root: str, run: str, model: str) -> list[str]:
    """Phase 11's overrides for an image model, with the task and data
    targets above."""
    task = "maniskill2_pcd_task" if "pointmap" in model else "maniskill2_task"
    swap = {"exp_maniskill2_act_policy/maniskill2_pcd_task@":
            f"exp_maniskill2_act_policy/{task}@{task}=PickCube-v0",
            "data.train._target_=": "data.train._target_=chip_smoke.cli_image_train_set",
            "data.val._target_=": "data.val._target_=chip_smoke.cli_image_held_out_set",
            "trainer.limit_train_batches=": f"trainer.limit_train_batches={IMAGE_CLI_BATCHES}"}
    return [next((new for old, new in swap.items() if arg.startswith(old)), arg)
            for arg in cli_argv(root, run, model)]


def train_cli_image(dev) -> dict:
    """Phase 15 (d): ``train.main`` on scratch_resnet50_rgb (the RGB-D task)
    and on scratch_resnet50_pointmap (the point-cloud task) over phase 10's
    demos (2 epochs of 2 micro-steps of 16, held-out validation after
    each); a run from ``last`` resuming at epoch 2; ``validate.main`` on the
    best checkpoint. No kernel of #1-#13 launches; seconds to the first
    step, ms per optimizer step, the checkpoint's size. Returns the
    launches by path."""
    import tempfile

    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch import train as train_entry
    from pointcloudmatters_tpu_torch import validate as validate_entry
    from pointcloudmatters_tpu_torch.trainer import CHECKPOINT_FILE

    sys.modules.setdefault("chip_smoke", sys.modules[__name__])  # the targets' module
    demos = synthetic_demos(FIT_EPISODES, FIT_EPISODE_LEN, FIT_CAM_SIDE)
    n_train = FIT_EPISODES - FIT_HELD_OUT
    micro = CLI_EPOCHS * IMAGE_CLI_BATCHES
    paths = {}
    for model, channels in (("scratch_resnet50_rgb", 3), ("scratch_resnet50_pointmap", 6)):
        root = tempfile.TemporaryDirectory()
        CLI_DATA.update(train=demos[:n_train], held_out=demos[n_train:],
                        cache=os.path.join(root.name, "cache"))
        EndState.runs.clear()
        ops.reset_launch_counts()
        t_main = time.perf_counter()
        train_entry.main(image_cli_argv(root.name, "run1", model))
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        paths[f"train_cli_{model}"] = launches = ops.launch_counts()
        probe = EndState.runs[-1]
        trainer, module = probe.trainer, probe.module
        net = module.policy.backbone
        if (type(net).__name__, net.channels, trainer.precision, trainer.global_step) != (
                "ResNetTorchVision", channels, "bf16-mixed", micro):
            raise AssertionError(f"train_cli {model}: not the composition or the steps it "
                                 f"should be")
        losses = [m["train/loss"] for _, _, m in probe.epochs]
        vals = [m["val/loss"] for _, _, m in probe.epochs]
        if not np.isfinite(losses + vals).all():
            raise AssertionError(f"train_cli {model}: non-finite {losses} or val/loss {vals}")
        rate = probe.epochs[-1][2]["samples_per_sec"]
        ckpts = os.path.join(root.name, "run1", "checkpoints")
        last, best = os.path.join(ckpts, "last"), trainer.checkpoint_callback.best_model_path
        size = os.path.getsize(os.path.join(last, CHECKPOINT_FILE))
        _only(launches, {}, f"train_cli {model}")
        log(f"image   (d) {card_line()}: train.main {model}, "
            f"{sum(p.numel() for p in module.policy.parameters())} parameters, {micro} "
            f"micro-steps of B={IMAGE_BATCH} over {CLI_EPOCHS} epochs in {t_end - t_main:.2f} s; "
            f"{probe.t_start - t_main:.2f} s from main to the first step; epoch 1 {rate:.2f} "
            f"samples/s = {IMAGE_BATCH * 1e3 / rate:.2f} ms per optimizer step; checkpoint "
            f"{size / 1e6:.1f} MB; train/loss {losses}, val/loss {vals}; "
            f"checkpoints {sorted(os.listdir(ckpts))}")
        del trainer, module, probe, net

        ops.reset_launch_counts()
        train_entry.main(image_cli_argv(root.name, "run2", model)
                         + [f"trainer.max_epochs={CLI_EPOCHS + 1}", f"ckpt_path={last}"])
        torch.cuda.synchronize()
        paths[f"train_cli_{model}_resume"] = ops.launch_counts()
        resumed = EndState.runs[-1]
        if resumed.start != (CLI_EPOCHS, micro) or [e for e, *_ in resumed.epochs] != [CLI_EPOCHS]:
            raise AssertionError(f"train_cli {model}: resumed at {resumed.start}, "
                                 f"epochs {resumed.epochs}")
        ops.reset_launch_counts()
        metrics = validate_entry.main(image_cli_argv(root.name, "val", model)
                                      + [f"ckpt_path={best}"])
        torch.cuda.synchronize()
        paths[f"validate_cli_{model}"] = ops.launch_counts()
        if set(metrics) != {"val/loss", "val/loss_best"} or not np.isfinite(metrics["val/loss"]):
            raise AssertionError(f"validate_cli {model}: {metrics}")
        for path in (f"train_cli_{model}_resume", f"validate_cli_{model}"):
            _only(paths[path], {}, path)
        log(f"image   (d) {model}: resumed at epoch {resumed.start[0]}, step "
            f"{resumed.start[1]}; validate.main(best) {metrics}")
        root.cleanup()
        CLI_DATA.clear()
        EndState.runs.clear()
        del resumed
        torch.cuda.empty_cache()
    return paths


def _torchvision_keys(net) -> dict:
    """A torchvision-named state dict of ``net``'s own entries (the inverse
    of ``resnet_state_dict``), under R3M's ``module.convnet.`` prefix."""
    names = {"scale": "weight", "mean": "running_mean", "var": "running_var"}
    sd = {}
    for name, t in net.state_dict().items():
        mod, leaf = name.rsplit(".", 1)
        mod = re.sub(r"^layer(\d)_(\d+)", r"layer\1.\2", mod)
        mod = mod.replace("downsample_conv", "downsample.0").replace("downsample_bn",
                                                                      "downsample.1")
        sd[f"module.convnet.{mod}.{names.get(leaf, leaf)}"] = t.clone()
    return sd


def _timm_keys(net) -> dict:
    """A timm / VC-1-named state dict of a ViT's own entries (the inverse of
    ``vit_state_dict``): the query, key and value stacked into ``qkv``."""
    import torch

    vt, sd = net.model, {}
    for name, t in vt.state_dict().items():
        m = re.match(r"blocks_(\d+)\.attn\.(query|key|value)\.(weight|bias)", name)
        if m:
            if m[2] == "query":
                parts = [vt.state_dict()[f"blocks_{m[1]}.attn.{p}.{m[3]}"]
                         for p in ("query", "key", "value")]
                sd[f"blocks.{m[1]}.attn.qkv.{m[3]}"] = torch.cat(parts).clone()
            continue
        name = re.sub(r"^blocks_(\d+)", r"blocks.\1", name).replace("attn.out", "attn.proj")
        name = name.replace("mlp_fc", "mlp.fc").replace("patch_embed_proj", "patch_embed.proj")
        sd[name] = t.clone()
    return sd


def image_pretrained(dev) -> dict:
    """Phase 15 (e): ``pretrained_r3m_rgb`` and ``pretrained_vc1_rgb`` with
    HOME at a temporary directory holding fake ``.r3m/r3m_50.pt`` and
    ``.vc1/vc1_vitb.pth`` files (a seeded backbone's weights and random
    batch statistics in R3M's and timm's keys): ``train.instantiate_model``
    loads each bit for bit, then one ``predict`` at B=1 on the card, no
    kernel launched. Returns the launches by path."""
    import tempfile

    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch import train as train_entry
    from pointcloudmatters_tpu_torch.entry import init_parameters
    from pointcloudmatters_tpu_torch.models.components.img_encoder import resnet, vit

    paths = {}
    root = tempfile.TemporaryDirectory()
    for model, rel, key, kind in (("pretrained_r3m_rgb", ".r3m/r3m_50.pt", "r3m", "resnet"),
                                  ("pretrained_vc1_rgb", ".vc1/vc1_vitb.pth", "model", "vit")):
        fake = image_backbone(kind, 3)
        init_parameters(fake, torch.Generator().manual_seed(3))
        gen = torch.Generator().manual_seed(4)
        with torch.no_grad():
            for name, buf in fake.named_buffers():
                if name.endswith(("mean", "var")) and not name.startswith("_"):
                    buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
        sd = _torchvision_keys(fake) if kind == "resnet" else _timm_keys(fake)
        path = os.path.join(root.name, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save({key: sd}, path)
        home = os.environ.get("HOME")
        os.environ["HOME"] = root.name
        try:
            cfg = train_entry.compose_run(image_cli_argv(root.name, model, model))
            module = train_entry.instantiate_model(cfg)
        finally:
            if home is None:
                del os.environ["HOME"]
            else:
                os.environ["HOME"] = home
        net = module.policy.backbone
        want = (resnet.resnet_state_dict(net, sd) if kind == "resnet"
                else vit.vit_state_dict(net, sd))
        state = net.state_dict()
        wrong = [k for k, v in fake.state_dict().items() if not torch.equal(state[k], v)]
        wrong += [k for k, v in want.items() if not torch.equal(state[k], v)]
        if net.pretrained_path != path or wrong or set(want) != set(state):
            raise AssertionError(f"{model}: {len(wrong)} entries differ from the file: "
                                 f"{wrong[:5]}")
        module.to(dev)
        ops.reset_launch_counts()
        a_hat = module.predict(image_batch(1, 3, seed=5, with_actions=False))
        torch.cuda.synchronize()
        paths[model] = launches = ops.launch_counts()
        if not torch.isfinite(a_hat).all():
            raise AssertionError(f"{model}: non-finite actions")
        _only(launches, {}, model)
        log(f"image   (e) {model}: {len(sd)} tensors of a {os.path.getsize(path) / 1e6:.1f} MB "
            f"fake file loaded bit for bit (frozen backbone: {module.policy.freeze_backbone}); "
            f"predict B=1 finite")
        del module, net, fake
        torch.cuda.empty_cache()
    root.cleanup()
    return paths


def train_images(dev) -> tuple[dict, dict]:
    """Phase 15: (a)-(e); the launches of its paths and (a)'s figures."""
    t_phase = time.perf_counter()
    alone = image_backbones(dev)
    paths = image_serve(dev)
    paths.update(image_steps(dev))
    paths.update(train_cli_image(dev))
    paths.update(image_pretrained(dev))
    stray = {path: {k: n for k, n in counts.items() if n} for path, counts in paths.items()
             if any(counts.values())}
    if stray:
        raise AssertionError(f"kernels launched on the image paths: {stray}")
    log(f"image   phase 15 in {time.perf_counter() - t_phase:.1f} s; no kernel of #1-#13 "
        f"launched on its {len(paths)} paths")
    return paths, alone


# phase 16: the Diffusion Policy over images, the 12 image models of
# configs/exp_maniskill2_diffusion_policy/maniskill2_model at their shipped
# widths: the DP's UNet (down_dims [512, 1024, 2048], step embedding 128,
# horizon 16, 8 executed steps, 100 DDPM steps) conditioned on two frames of
# one 128 x 128 camera through MultiImageObsEncoder (resize 256, centre crop
# 224, one shared model) over ResNet-50, ViT-B/16 or the MultiViT-B trunk,
# at the RGB-D task's batch of 32 (64 images a step). The condition is
# (backbone width + 9) x 2 + 3 wide: the UNet's FiLM linears grow with it
# (28,672 weights a unit). No kernel of #1-#13 runs (the backbones' rows are
# dense attention or convolutions, as in JAX).
IMAGE_DP_BATCH, IMAGE_DP_OBS_STEPS = 32, 2
IMAGE_DP_ROWS = IMAGE_DP_BATCH * IMAGE_DP_OBS_STEPS  # images a step
IMAGE_DP_SERVE_BATCHES = (1, 8)
IMAGE_DP_CPU_TOL = 1e-4  # card vs CPU, f32: of max |CPU| (features), of max(1, max|g|) (gradients)
# ResNet's f32 gradients at its seeded running statistics, card vs CPU, of
# max(1, max|g|): 1.13e-4 in four runs on an H100 80GB HBM3 at 700 W, the
# same with cuDNN off; 7 of 38.4 M ReLU inputs land on the other side of
# zero, the largest 2.3e-7 of its call's largest; in f64 they agree within
# 1.6e-8. The same step with TF32 on the card read 7.7e-4: (c) fails unless
# its TF32 control stays above this limit, so the limit tells f32 from TF32
IMAGE_DP_RESNET_F32_TOL = 3e-4
IMAGE_DP_ENCODERS = (("resnet", 3), ("resnet", 4), ("resnet", 1), ("resnet", 6), ("vit", 3),
                     ("multivit", 4))
IMAGE_DP_POLICIES = {"scratch_resnet50_rgb": ("resnet", 3), "scratch_vit_rgb": ("vit", 3),
                     "scratch_multivit_rgbd": ("multivit", 4)}
IMAGE_DP_PARAMS = {"scratch_resnet50_rgb": 389_295_815, "scratch_vit_rgb": 378_186_119,
                   "scratch_multivit_rgbd": 378_230_663}  # JAX's counts (tests/test_torch_config.py)
IMAGE_DP_CLI_BATCHES = 2  # micro-steps an epoch in (d)
# the tasks' batches (the RGB-D task's 32, the point-cloud task's 64) and the
# loops over the six training demos that give 2 of them
IMAGE_DP_CLI_BATCH = {"scratch_resnet50_rgbd": 32, "scratch_resnet50_pointmap": 64}
IMAGE_DP_CLI_LOOP = {"scratch_resnet50_rgbd": 12, "scratch_resnet50_pointmap": 24}


def image_dp_encoder(kind: str, channels: int):
    """The configs' MultiImageObsEncoder over a full-width backbone."""
    from pointcloudmatters_tpu_torch.entry import image_backbone, image_dp_shape_meta
    from pointcloudmatters_tpu_torch.models.components.diffusion_policy.vision.multi_image_obs_encoder import (  # noqa: E501
        MultiImageObsEncoder,
    )

    pool = {"avg_pool": True} if kind == "resnet" else {}
    return MultiImageObsEncoder(
        shape_meta=image_dp_shape_meta(channels), rgb_model=image_backbone(kind, channels, pool),
        resize_shape=(256, 256), crop_shape=(224, 224), random_crop=False,
        share_rgb_model=True, use_depth=channels in (1, 4), only_depth=channels == 1)


def image_dp_obs(rows: int, channels: int, seed: int) -> dict:
    """One frame a row of each key, as the policy hands the encoder."""
    from pointcloudmatters_tpu_torch.entry import build_image_dp_batch

    batch = build_image_dp_batch(rows, IMAGE_SIDE, channels, n_obs_steps=1, horizon=1,
                                 seed=seed)
    return {k: v[:, 0] for k, v in batch["obs"].items()}


def image_dp_encoders(dev) -> dict:
    """Phase 16 (a): each encoder alone at full width, f32, seeded weights:
    the eval features of 2 rows on the card against the CPU
    (IMAGE_DP_CPU_TOL of max |CPU|); the train-mode forward and forward +
    backward ms (CUDA events) and peak memory over the 64 images of a
    B=32 step. Returns the figures."""
    import copy

    import torch

    from pointcloudmatters_tpu_torch.entry import init_parameters
    from pointcloudmatters_tpu_torch.models.bc_module import to_device

    out = {}
    for kind, channels in IMAGE_DP_ENCODERS:
        enc = image_dp_encoder(kind, channels)
        init_parameters(enc, torch.Generator().manual_seed(0))
        obs = to_device(image_dp_obs(IMAGE_DP_ROWS, channels, 0), "cpu")
        small = {k: v[:2] for k, v in obs.items()}
        with torch.no_grad():
            ref = enc(small, train=False)
        model = copy.deepcopy(enc).to(dev)
        x = to_device(obs, dev)
        with torch.no_grad():
            got = model(to_device(small, dev), train=False).cpu()
        err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
        if not err <= IMAGE_DP_CPU_TOL * scale:
            raise AssertionError(f"image dp encoder {kind} {channels}ch card vs CPU: {err:.3e} "
                                 f"> {IMAGE_DP_CPU_TOL} x {scale:.3e}")
        cot = torch.randn(model.feature_dim, generator=torch.Generator().manual_seed(1)).to(dev)

        def fwd_bwd():
            model.zero_grad(set_to_none=True)
            (model(x, train=True) * cot).sum().backward()

        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: model(x, train=True), 3)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        both_ms = cuda_ms(fwd_bwd, 3)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        name = f"{kind}_{channels}ch"
        out[name] = dict(params=sum(p.numel() for p in enc.parameters()), err=err / scale,
                         fwd_ms=fwd_ms, fwd_bwd_ms=both_ms, peak_gib=peak)
        log(f"imagedp (a) {card_line()}: MultiImageObsEncoder over {name} "
            f"({out[name]['params']} parameters, {model.feature_dim} features a frame): card "
            f"vs CPU (eval, 2 rows) {err:.3e} of max |CPU| {scale:.3e}; {IMAGE_DP_ROWS} images "
            f"of {IMAGE_SIDE} px, f32 train-mode forward {fwd_ms:.2f} ms, forward + backward "
            f"{both_ms:.2f} ms, peak device memory {peak:.2f} GiB")
        del enc, model, x, obs
        torch.cuda.empty_cache()
    return out


def image_dp_normalizer(channels: int):
    """``dp_normalizer`` with identity entries for the image keys, as the DP
    RGB-D datasets build theirs (the images stay f32 under bf16-mixed)."""
    from pointcloudmatters_tpu_torch.entry import image_dp_shape_meta
    from pointcloudmatters_tpu_torch.utils.normalizer import SingleFieldLinearNormalizer

    normalizer = dp_normalizer()
    for key in image_dp_shape_meta(channels)["obs"]:
        if key != "qpos":
            normalizer[key] = SingleFieldLinearNormalizer.create_identity()
    return normalizer


def image_dp_task(policy):
    """The DP task module over ``policy`` with its config's AdamW + OneCycleLR."""
    from pointcloudmatters_tpu_torch.models.maniskill2_modules import (
        ManiSkill2DiffusionPolicyBCModule,
    )

    return ManiSkill2DiffusionPolicyBCModule(policy, optimizer=DP_OPT, lr_scheduler=DP_SCHED,
                                             env_id="PickCube-v0")


def image_dp_module(dev, model: str, seed: int = 0):
    """:func:`image_dp_task` over a full-width image policy of ``model``."""
    from pointcloudmatters_tpu_torch.entry import build_image_dp_policy

    kind, channels = IMAGE_DP_POLICIES[model]
    policy = build_image_dp_policy(kind, channels, seed=seed,
                                   normalizer=image_dp_normalizer(channels), device=dev)
    n = sum(p.numel() for p in policy.parameters())
    if n != IMAGE_DP_PARAMS[model]:
        raise AssertionError(f"{model}: {n} parameters, not JAX's {IMAGE_DP_PARAMS[model]}")
    return image_dp_task(policy)


def image_dp_batch(batch_size: int, channels: int, seed: int, with_actions: bool = True):
    from pointcloudmatters_tpu_torch.entry import build_image_dp_batch

    return build_image_dp_batch(batch_size, IMAGE_SIDE, channels, seed=seed,
                                with_actions=with_actions)


SERVED: dict = {}  # (b)'s modules by model, which (c) trains next


def image_dp_serve(dev) -> dict:
    """Phase 16 (b): ``predict`` in f32 (the whole 100-step chain) of the
    three image policies at B=1 and B=8: a warm-up request, then two timed
    by the host clock at each size; finite (B, 8, 7) actions and no launch
    of #1-#13. Keeps each module for (c). Returns the launches by path."""
    import torch

    from pointcloudmatters_tpu_torch import ops

    paths = {}
    for model, (_, channels) in IMAGE_DP_POLICIES.items():
        module = SERVED[model] = image_dp_module(dev, model)
        requests = {B: [image_dp_batch(B, channels, s, with_actions=False) for s in (1, 2)]
                    for B in IMAGE_DP_SERVE_BATCHES}
        module.predict(image_dp_batch(1, channels, 0, with_actions=False),
                       torch.Generator(device=dev).manual_seed(0))  # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        times = {}
        for B, reqs in requests.items():
            for i, obs in enumerate(reqs):
                t0 = time.perf_counter()
                action = module.predict(obs, torch.Generator(device=dev).manual_seed(i))
                torch.cuda.synchronize()
                times.setdefault(B, []).append((time.perf_counter() - t0) * 1e3)
                if tuple(action.shape) != (B, 8, 7) or not torch.isfinite(action).all():
                    raise AssertionError(f"{model} predict B={B}: {tuple(action.shape)}, not "
                                         f"a finite (B, 8, 7)")
        paths[f"dp_{model}_predict"] = launches = ops.launch_counts()
        _only(launches, {}, f"dp {model} predict")
        log(f"imagedp (b) {card_line()}: {model} predict (f32, 100 DDPM steps, "
            f"{IMAGE_DP_OBS_STEPS} frames of {IMAGE_SIDE} px a sample): "
            + "; ".join(f"B={B} " + ", ".join(f"{t:.2f}" for t in ms) + " ms"
                        for B, ms in times.items()))
        del module
        torch.cuda.empty_cache()
    return paths


@contextlib.contextmanager
def fixed_dp_draws(seed: int):
    """The DP loss's noise and timesteps drawn once on the CPU from
    ``seed`` and handed to every device, so that a step on the card and one
    on the CPU take the same draws."""
    import torch

    from pointcloudmatters_tpu_torch.models.components.diffusion_policy import (
        diffusion_unet_image_policy as dp,
    )

    saved = dp.training_draws

    def draws(generator, shape, dtype, batch, num_train_timesteps):
        noise, ts = saved(torch.Generator().manual_seed(seed), shape, dtype, batch,
                          num_train_timesteps)
        return noise.to(generator.device), ts.to(generator.device)

    dp.training_draws = draws
    try:
        yield
    finally:
        dp.training_draws = saved


def _dp_eval_grads(module, batch):
    """Loss and gradients of the eval-mode loss (batch norms at their
    running statistics) from one state; the draws as ``fixed_dp_draws``."""
    import torch

    from pointcloudmatters_tpu_torch.models.bc_module import select_model_batch, to_device

    module.policy.zero_grad(set_to_none=True)
    out = module.policy(to_device(select_model_batch(batch), module.device), train=False,
                        rngs={"noise": torch.Generator(device=module.device)})
    out["loss"].backward()
    return out["loss"].detach(), {n: p.grad.detach().clone()
                                  for n, p in module.policy.named_parameters()
                                  if p.grad is not None}


@contextlib.contextmanager
def relu_inputs(into: list):
    """Every ResNet ReLU's input, in call order, appended to ``into``."""
    import torch.nn.functional as F

    from pointcloudmatters_tpu_torch.models.components.img_encoder import resnet

    class Recording:
        def __getattr__(self, name):
            return getattr(F, name)

        @staticmethod
        def relu(x, *args, **kwargs):
            into.append(x.detach())
            return F.relu(x, *args, **kwargs)

    saved, resnet.F = resnet.F, Recording()
    try:
        yield
    finally:
        resnet.F = saved


def relu_flips(card: list, cpu: list) -> str:
    """Where the card's and the CPU's ReLU inputs fall on different sides of
    zero: how many elements, the first call that has one, and the largest
    |input| of a flipped element over the largest |input| of its call."""
    import torch

    if len(card) != len(cpu):
        raise AssertionError(f"{len(card)} ReLU calls on the card, {len(cpu)} on the CPU")
    flips, first, worst = 0, None, 0.0
    for i, (x, ref) in enumerate(zip(card, cpu)):
        ref = ref.to(x.device)
        flipped = (x > 0) != (ref > 0)
        n = int(flipped.sum())
        if n:
            flips += n
            first = i if first is None else first
            size = torch.maximum(x.abs(), ref.abs())[flipped].max().item()
            worst = max(worst, size / max(ref.abs().max().item(), 1e-30))
    return (f"{flips} ReLU inputs of {sum(x.numel() for x in card)} on opposite sides of zero"
            + (f", the first in call {first} of {len(card)}; the largest flipped |input| "
               f"{worst:.3e} of its call's largest" if flips else ""))


def image_dp_steps(dev) -> dict:
    """Phase 16 (c): the ``"bf16-mixed"`` step of the three image policies
    at B=32 (64 images; (b)'s modules where (b) ran): a warm-up, then
    TRAIN_STEPS steps under ``torch.cuda.set_sync_debug_mode("error")``
    timed by the host clock; samples/s, peak memory, finite losses, moved
    parameters, no launch of #1-#13. Then, from the seeded state again, the
    f32 step on the card against the CPU at B=2, the draws fixed: the loss
    within IMAGE_DP_CPU_TOL relative and each gradient within
    IMAGE_DP_CPU_TOL of max(1, max|g|). ResNet's train-mode loss is held
    and its gradients are held at its running statistics: in f32 within
    IMAGE_DP_RESNET_F32_TOL (a TF32 control on the card must exceed it; the
    ReLU inputs that land on opposite sides of zero counted), in f64 within
    IMAGE_DP_CPU_TOL. Returns the launches by path."""
    import copy

    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch.models.bc_module import to_device
    from pointcloudmatters_tpu_torch.trainer import Trainer

    paths = {}
    for model, (kind, channels) in IMAGE_DP_POLICIES.items():
        module = SERVED.pop(model, None) or image_dp_module(dev, model)
        seeded = {k: v.detach().clone() for k, v in module.policy.state_dict().items()}
        trainer = Trainer(precision="bf16-mixed", seed=0)
        trainer.setup(module, TOTAL_STEPS)
        batch = to_device(image_dp_batch(IMAGE_DP_BATCH, channels, 0), dev)
        start = [p.detach().clone() for p in module.policy.parameters()]
        trainer.train_step(module, batch)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            outs = [trainer.train_step(module, batch) for _ in range(TRAIN_STEPS)]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
        paths[f"dp_{model}_train"] = launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        losses = [float(m["loss"]) for m in outs]
        moved = sum(not torch.equal(a, p) for a, p in zip(start, module.policy.parameters()))
        if not np.isfinite(losses).all() or moved < len(start) // 2:
            raise AssertionError(f"{model}: losses {losses}, {moved} of {len(start)} moved")
        _only(launches, {}, f"dp {model} bf16 step")
        log(f"imagedp (c) {card_line()}: {model} B={IMAGE_DP_BATCH} ({IMAGE_DP_ROWS} images) "
            f"bf16-mixed {step_ms:.2f} ms/step over {TRAIN_STEPS} steps, "
            f"{IMAGE_DP_BATCH * 1e3 / step_ms:.2f} samples/s, peak device memory {peak:.2f} "
            f"GiB; loss {losses}; {sum(p.numel() for p in module.policy.parameters())} "
            f"parameters")
        policy = module.policy
        del module, trainer, batch, start, outs
        policy.load_state_dict(seeded)  # the seeded weights and statistics again
        policy.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()

        card = image_dp_task(policy)
        cpu = image_dp_task(copy.deepcopy(policy).to("cpu"))
        small = image_dp_batch(2, channels, 3)
        what = f"dp {model} f32 B=2 step, card vs CPU"
        with fixed_dp_draws(5):
            got = _step_grads(card, to_device(small, dev), card.make_rngs(5))
            ref = _step_grads(cpu, small, cpu.make_rngs(5))
            if kind != "resnet":
                log("imagedp (c) " + _compare_step(what, *got, *ref, grad_rtol=IMAGE_DP_CPU_TOL,
                                                   loss_rtol=IMAGE_DP_CPU_TOL))
            else:
                gap = max(((g - ref[1][n].to(g.device)).abs().max().item()
                           / max(1.0, ref[1][n].abs().max().item()), n)
                          for n, g in got[1].items())
                log("imagedp (c) " + _compare_step(what + ", train-mode loss", got[0], {},
                                                   ref[0], {}, grad_rtol=IMAGE_DP_CPU_TOL,
                                                   loss_rtol=IMAGE_DP_CPU_TOL)
                    + f"; train-mode gradients {gap[0]:.3e} of max(1, max|g|) at {gap[1]} "
                    f"(batch statistics: not held)")
                for m in (card, cpu):  # the train-mode step moved the statistics
                    m.policy.load_state_dict(seeded)
                card_relu, cpu_relu = [], []
                with relu_inputs(card_relu):
                    got = _dp_eval_grads(card, small)
                with relu_inputs(cpu_relu):
                    ref = _dp_eval_grads(cpu, small)
                flips = relu_flips(card_relu, cpu_relu)
                del card_relu, cpu_relu
                tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
                torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
                try:
                    control = _dp_eval_grads(card, small)
                finally:
                    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
                control_gap = max(((g - ref[1][n].to(g.device)).abs().max().item()
                                   / max(1.0, ref[1][n].abs().max().item()), n)
                                  for n, g in control[1].items())
                if not control_gap[0] > IMAGE_DP_RESNET_F32_TOL:
                    raise AssertionError(f"dp {model}: the TF32 control's gradients "
                                         f"{control_gap[0]:.3e} of max(1, max|g|) are within "
                                         f"the f32 limit {IMAGE_DP_RESNET_F32_TOL}")
                log("imagedp (c) " + _compare_step(
                    f"dp {model} f32 B=2, card vs CPU, batch norms at their running "
                    f"statistics", *got, *ref, grad_rtol=IMAGE_DP_RESNET_F32_TOL,
                    loss_rtol=IMAGE_DP_CPU_TOL)
                    + f" (limit {IMAGE_DP_RESNET_F32_TOL}); {flips}; TF32 control on the card "
                    f"{control_gap[0]:.3e} of max(1, max|g|) at {control_gap[1]}")
                del control
                card.policy.double()
                cpu.policy.double()
                log("imagedp (c) " + _compare_step(
                    f"dp {model} f64 B=2, card vs CPU, batch norms at their running "
                    f"statistics", *_dp_eval_grads(card, _f64(small)),
                    *_dp_eval_grads(cpu, _f64(small)),
                    grad_rtol=IMAGE_DP_CPU_TOL, loss_rtol=IMAGE_DP_CPU_TOL))
        del card, cpu, got, ref, policy, seeded
        torch.cuda.empty_cache()
    return paths


def _f64(tree):
    """A numpy batch with its floating arrays in f64, for (c)'s f64 hold of
    ResNet's gradients."""
    if isinstance(tree, dict):
        return {k: _f64(v) for k, v in tree.items()}
    return tree.astype("float64") if tree.dtype.kind == "f" else tree


# (d), (e), (f): the image DP compositions through the port's entry points,
# over phase 10's demos held in memory (their 128 x 128 RGB-D images; the
# pointmap's 6-channel image from their cloud), with phase 13's overrides
# (dp_cli_argv) and these: the RGB-D task (maniskill2_task) but for the
# pointmap, the data targets below; 2 micro-steps an epoch of the configs'
# 32 (RGB-D task) or 64 (the point-cloud task's pointmap).
def _image_dp_dataset(kw: dict) -> str:
    return DP_RGBD if "camera_names" in kw else DP_PCD


def dp_image_cli_train_set(dataset_file=None, **kw):
    """``data.train``'s target in phase 16: the port's DP RGB-D dataset (the
    configs' ``camera_names``) or its DP point-cloud dataset (a pointmap's
    ``camera_ids``) over phase 10's training demos."""
    CLI_DATA["train_kw"] = kw
    return in_memory_dataset(CLI_DATA["train"], _image_dp_dataset(kw), loop=CLI_DATA["loop"],
                             cache_dir=CLI_DATA["cache"], **kw)


def dp_image_cli_held_out_set(size=None):
    """``data.val``'s target in phase 16: the held-out demos, twice, with
    the training set's keys."""
    kw = CLI_DATA["train_kw"]
    return in_memory_dataset(CLI_DATA["held_out"], _image_dp_dataset(kw), loop=2,
                             cache_dir=CLI_DATA["cache"], **kw)


PROBED: list = []  # the task modules phase 16's targets built, latest last


def probed_held_out_dp_module(**kw):
    """``held_out_dp_module``, kept in PROBED."""
    PROBED.append(held_out_dp_module(**kw))
    return PROBED[-1]


def probed_bc_module(**kw):
    """The base ``BCModule`` (phase 11's held-out-loss module), kept in PROBED."""
    from pointcloudmatters_tpu_torch.models.bc_module import BCModule

    PROBED.append(BCModule(**kw))
    return PROBED[-1]


def image_dp_cli_argv(root: str, run: str, model: str) -> list[str]:
    """Phase 13's overrides for an image model of the DP, with the task and
    data targets above and the probed module."""
    task = "maniskill2_pcd_task" if "pointmap" in model else "maniskill2_task"
    swap = {"exp_maniskill2_diffusion_policy/maniskill2_pcd_task@":
            f"exp_maniskill2_diffusion_policy/{task}@{task}=PickCube-v0",
            "data.train._target_=": "data.train._target_=chip_smoke.dp_image_cli_train_set",
            "data.val._target_=": "data.val._target_=chip_smoke.dp_image_cli_held_out_set",
            "model._target_=": "model._target_=chip_smoke.probed_held_out_dp_module",
            "trainer.limit_train_batches=":
                f"trainer.limit_train_batches={IMAGE_DP_CLI_BATCHES}"}
    return [next((new for old, new in swap.items() if arg.startswith(old)), arg)
            for arg in dp_cli_argv(root, run, model)] + [
        "callbacks.model_checkpoint.save_weights_only=true"]  # top-k: weights alone


def _cli_demos(root: str, model: str) -> None:
    demos = synthetic_demos(FIT_EPISODES, FIT_EPISODE_LEN, FIT_CAM_SIDE)
    n_train = FIT_EPISODES - FIT_HELD_OUT
    CLI_DATA.update(train=demos[:n_train], held_out=demos[n_train:],
                    cache=os.path.join(root, "cache"), loop=IMAGE_DP_CLI_LOOP.get(model, 12))


def train_cli_image_dp(dev) -> dict:
    """Phase 16 (d): ``train.main`` on scratch_resnet50_rgbd (the RGB-D task,
    depth on) and on scratch_resnet50_pointmap (the point-cloud task) over
    phase 10's demos (2 epochs of 2 micro-steps, held-out validation after
    each; the dataset's normalizer wired), a run from ``last`` resuming at
    epoch 2, ``validate.main`` on the best checkpoint. No kernel of #1-#13
    launches; seconds to the first step, ms an optimizer step, the
    checkpoint's size. Returns the launches by path."""
    import tempfile

    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch import train as train_entry
    from pointcloudmatters_tpu_torch import validate as validate_entry
    from pointcloudmatters_tpu_torch.trainer import CHECKPOINT_FILE

    sys.modules.setdefault("chip_smoke", sys.modules[__name__])  # the targets' module
    micro = CLI_EPOCHS * IMAGE_DP_CLI_BATCHES
    paths = {}
    for model, channels, keys in (
            ("scratch_resnet50_rgbd", 4, {"action", "qpos", "base_camera_rgb",
                                          "base_camera_depth"}),
            ("scratch_resnet50_pointmap", 6, {"action", "qpos", "base_camera_rgb"})):
        root = tempfile.TemporaryDirectory()
        _cli_demos(root.name, model)
        EndState.runs.clear()
        ops.reset_launch_counts()
        t_main = time.perf_counter()
        argv = image_dp_cli_argv(root.name, "run1", model)
        train_entry.main(argv)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        paths[f"train_cli_dp_{model}"] = launches = ops.launch_counts()
        probe = EndState.runs[-1]
        trainer, module = probe.trainer, probe.module
        enc = module.policy.obs_encoder
        if (type(enc).__name__, enc.rgb_model.channels, trainer.precision,
                trainer.global_step) != ("MultiImageObsEncoder", channels, "bf16-mixed", micro):
            raise AssertionError(f"train_cli_dp {model}: not the composition or the steps it "
                                 f"should be")
        if set(module.state_dict_extras().get("normalizer", {})) != keys:
            raise AssertionError(f"train_cli_dp {model}: the dataset's normalizer was not "
                                 f"wired: {sorted(module.state_dict_extras())}")
        losses = [m["train/loss"] for _, _, m in probe.epochs]
        vals = [m["val/loss"] for _, _, m in probe.epochs]
        if not np.isfinite(losses + vals).all():
            raise AssertionError(f"train_cli_dp {model}: non-finite {losses} or {vals}")
        batch = IMAGE_DP_CLI_BATCH[model]
        rate = probe.epochs[-1][2]["samples_per_sec"]
        ckpts = os.path.join(root.name, "run1", "checkpoints")
        last, best = os.path.join(ckpts, "last"), trainer.checkpoint_callback.best_model_path
        size = os.path.getsize(os.path.join(last, CHECKPOINT_FILE))
        _only(launches, {}, f"train_cli_dp {model}")
        log(f"imagedp (d) {card_line()}: train.main {model}, "
            f"{sum(p.numel() for p in module.policy.parameters())} parameters, {micro} "
            f"micro-steps of B={batch} over {CLI_EPOCHS} epochs in {t_end - t_main:.2f} s; "
            f"{probe.t_start - t_main:.2f} s from main to the first step; epoch 1 {rate:.2f} "
            f"samples/s = {batch * 1e3 / rate:.2f} ms per optimizer step; checkpoint "
            f"{size / 1e9:.3f} GB; train/loss {losses}, val/loss {vals}; checkpoints "
            f"{sorted(os.listdir(ckpts))}")
        del trainer, module, probe, enc
        PROBED.clear()

        ops.reset_launch_counts()
        train_entry.main(image_dp_cli_argv(root.name, "run2", model)
                         + [f"trainer.max_epochs={CLI_EPOCHS + 1}", f"ckpt_path={last}"])
        torch.cuda.synchronize()
        paths[f"train_cli_dp_{model}_resume"] = ops.launch_counts()
        resumed = EndState.runs[-1]
        if resumed.start != (CLI_EPOCHS, micro) or [e for e, *_ in resumed.epochs] != [CLI_EPOCHS]:
            raise AssertionError(f"train_cli_dp {model}: resumed at {resumed.start}, epochs "
                                 f"{resumed.epochs}")
        del resumed
        PROBED.clear()
        ops.reset_launch_counts()
        metrics = validate_entry.main(image_dp_cli_argv(root.name, "val", model)
                                      + [f"ckpt_path={best}"])
        torch.cuda.synchronize()
        paths[f"validate_cli_dp_{model}"] = ops.launch_counts()
        if set(metrics) != {"val/loss", "val/loss_best"} or not np.isfinite(metrics["val/loss"]):
            raise AssertionError(f"validate_cli_dp {model}: {metrics}")
        for path in (f"train_cli_dp_{model}_resume", f"validate_cli_dp_{model}"):
            _only(paths[path], {}, path)
        log(f"imagedp (d) {model}: resumed at epoch {CLI_EPOCHS}, step {micro}; "
            f"validate.main(best) {metrics}")
        root.cleanup()
        CLI_DATA.clear()
        EndState.runs.clear()
        PROBED.clear()
        torch.cuda.empty_cache()
    return paths


def image_dp_pretrained(dev) -> dict:
    """Phase 16 (e): ``pretrained_r3m_rgb`` as shipped, with HOME at a
    temporary directory holding a fake ``.r3m/r3m_50.pt`` (a seeded
    ResNet-50's weights and random statistics in R3M's keys): the shared
    ``rgb_model`` loads it bit for bit, then a ``predict`` at B=1 on the
    card. ``pretrained_vc1_rgb`` names no ``pretrained_path``: as shipped its
    ViT keeps the seed's weights though a fake ``.vc1/vc1_vitb.pth`` is
    there (as in JAX); with the path given as an override it loads the file
    bit for bit. Returns the launches by path."""
    import tempfile

    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch import train as train_entry
    from pointcloudmatters_tpu_torch.entry import init_parameters
    from pointcloudmatters_tpu_torch.models.components.img_encoder import resnet, vit

    sys.modules.setdefault("chip_smoke", sys.modules[__name__])
    paths = {}
    root = tempfile.TemporaryDirectory()
    _cli_demos(root.name, "pretrained")
    files = {}
    for rel, key, kind in ((".r3m/r3m_50.pt", "r3m", "resnet"),
                           (".vc1/vc1_vitb.pth", "model", "vit")):
        fake = image_backbone(kind, 3)
        init_parameters(fake, torch.Generator().manual_seed(3))
        gen = torch.Generator().manual_seed(4)
        with torch.no_grad():
            for name, buf in fake.named_buffers():
                if name.endswith(("mean", "var")) and not name.startswith("_"):
                    buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
        sd = _torchvision_keys(fake) if kind == "resnet" else _timm_keys(fake)
        path = os.path.join(root.name, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save({key: sd}, path)
        files[kind] = (path, sd, fake)

    def build(model, extra=()):
        home = os.environ.get("HOME")
        os.environ["HOME"] = root.name
        try:
            cfg = train_entry.compose_run(image_dp_cli_argv(root.name, model, model)
                                          + list(extra))
            return train_entry.instantiate_model(cfg)
        finally:
            if home is None:
                del os.environ["HOME"]
            else:
                os.environ["HOME"] = home

    for model, kind, extra in (
            ("pretrained_r3m_rgb", "resnet", ()),
            ("pretrained_vc1_rgb", "vit", ()),
            ("pretrained_vc1_rgb", "vit", (
                f"+model.policy.obs_encoder.rgb_model.pretrained_path={files['vit'][0]}",))):
        path, sd, fake = files[kind]
        module = build(model, extra)
        net = module.policy.obs_encoder.rgb_model
        state = net.state_dict()
        loads = model == "pretrained_r3m_rgb" or any("pretrained_path" in e for e in extra)
        if loads:
            want = (resnet.resnet_state_dict(net, sd) if kind == "resnet"
                    else vit.vit_state_dict(net, sd))
            wrong = [k for k, v in fake.state_dict().items() if not torch.equal(state[k], v)]
            wrong += [k for k, v in want.items() if not torch.equal(state[k], v)]
            if net.pretrained_path != path or wrong or set(want) != set(state):
                raise AssertionError(f"{model} {extra}: {len(wrong)} entries differ from the "
                                     f"file: {wrong[:5]}")
        else:
            seeded = build(model, extra).policy.obs_encoder.rgb_model.state_dict()
            if net.pretrained_path is not None or any(
                    not torch.equal(state[k], v) for k, v in seeded.items()) or all(
                    torch.equal(state[k], v) for k, v in fake.state_dict().items()):
                raise AssertionError(f"{model}: as shipped it must keep the seed's weights")
        name = model + ("_path" if loads and model != "pretrained_r3m_rgb" else "")
        if model == "pretrained_r3m_rgb":
            module.policy.normalizer = image_dp_normalizer(3)
            module.to(dev)
            ops.reset_launch_counts()
            action = module.predict(image_dp_batch(1, 3, 5, with_actions=False),
                                    torch.Generator(device=dev).manual_seed(0))
            torch.cuda.synchronize()
            paths[f"dp_{name}"] = launches = ops.launch_counts()
            if not torch.isfinite(action).all():
                raise AssertionError(f"{model}: non-finite actions")
            _only(launches, {}, name)
        log(f"imagedp (e) {name}: " + (f"{len(sd)} tensors of a "
                                       f"{os.path.getsize(path) / 1e6:.1f} MB fake file loaded "
                                       f"bit for bit" if loads else
                                       "no pretrained_path, the seed's weights kept (as JAX)")
            + ("; predict B=1 finite" if model == "pretrained_r3m_rgb" else ""))
        del module, net
        torch.cuda.empty_cache()
    root.cleanup()
    CLI_DATA.clear()
    PROBED.clear()
    return paths


def _converted(root: str, name: str, policy, normalizer=None) -> tuple[str, float]:
    """A reference ``.ckpt`` of ``policy`` (``tools/reference_ckpt.py``)
    through ``python -m pointcloudmatters_tpu_torch.port_reference_ckpt``:
    the converted directory and the command's seconds."""
    sys.path.insert(0, REPO)
    from tools.reference_ckpt import reference_state_dict, save_lightning_ckpt

    ckpt, out = os.path.join(root, f"{name}.ckpt"), os.path.join(root, f"{name}_ported")
    save_lightning_ckpt(ckpt, reference_state_dict(policy, normalizer))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "pointcloudmatters_tpu_torch.port_reference_ckpt",
                          ckpt, out], cwd=REPO, capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        raise AssertionError(f"port_reference_ckpt {name}: {run.stderr[-2000:]}")
    os.remove(ckpt)
    return out, time.perf_counter() - t0


def image_dp_converter(dev) -> dict:
    """Phase 16 (f): fake reference checkpoints of the DP scratch_resnet50_rgb
    and of the ACT scratch_pointnet_pcd (seeded policies of their
    compositions, renamed to the reference's keys by
    ``tools/reference_ckpt.py``), each converted by the port's command,
    restored through ``validate.main ckpt_path=`` bit for bit in every
    tensor (and the DP's normalizer), then one ``predict`` on the card.
    Returns the launches by path (the ACT's run kernels 1, 2 and 3)."""
    import tempfile

    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch import train as train_entry
    from pointcloudmatters_tpu_torch import validate as validate_entry

    sys.modules.setdefault("chip_smoke", sys.modules[__name__])
    paths = {}
    root = tempfile.TemporaryDirectory()
    for model, family in (("scratch_resnet50_rgb", "dp"), ("scratch_pointnet_pcd", "act")):
        _cli_demos(root.name, model)
        if family == "dp":
            argv = image_dp_cli_argv(root.name, "conv", model)
        else:
            argv = [a.replace("pointcloudmatters_tpu.models.bc_module.BCModule",
                              "chip_smoke.probed_bc_module") for a in cli_argv(root.name, "conv")]
        source = train_entry.instantiate_model(train_entry.compose_run(argv + ["seed=11"]))
        normalizer = image_dp_normalizer(3) if family == "dp" else None
        out, seconds = _converted(root.name, model, source.policy,
                                  None if normalizer is None else normalizer.state_dict())
        PROBED.clear()
        ops.reset_launch_counts()
        metrics = validate_entry.main(argv + [f"ckpt_path={out}"])
        torch.cuda.synchronize()
        paths[f"converter_validate_{model}"] = ops.launch_counts()
        module = PROBED[-1]
        state, want = module.policy.state_dict(), source.policy.state_dict()
        wrong = [k for k, v in want.items() if not torch.equal(state[k].cpu(), v)]
        if wrong or set(state) != set(want) or not np.isfinite(metrics["val/loss"]):
            raise AssertionError(f"converter {model}: {len(wrong)} tensors differ "
                                 f"({wrong[:5]}), or val/loss {metrics}")
        if family == "dp":
            got = module.policy.normalizer.state_dict()
            if set(got) != set(normalizer.state_dict()) or any(
                    not np.array_equal(got[k]["scale"], normalizer[k].scale) for k in got):
                raise AssertionError(f"converter {model}: the normalizer differs")
        module.to(dev)
        ops.reset_launch_counts()
        if family == "dp":
            action = module.predict(image_dp_batch(1, 3, 6, with_actions=False),
                                    torch.Generator(device=dev).manual_seed(0))
        else:
            from pointcloudmatters_tpu_torch.entry import build_batch

            action = module.predict(build_batch(1, N_POINTS, seed=6, with_actions=False))
        torch.cuda.synchronize()
        paths[f"converter_predict_{model}"] = launches = ops.launch_counts()
        if not torch.isfinite(action).all():
            raise AssertionError(f"converter {model}: non-finite actions")
        if family == "dp":
            for path in (f"converter_validate_{model}", f"converter_predict_{model}"):
                _only(paths[path], {}, path)
        log(f"imagedp (f) {card_line()}: {model} ({family}, "
            f"{sum(v.numel() for v in want.values())} values): reference .ckpt converted by "
            f"the command in {seconds:.2f} s, validate.main(ckpt_path=) restored every tensor "
            f"bit for bit, val/loss {metrics['val/loss']:.4f}; predict B=1 finite on the card; "
            f"launches {({k: n for k, n in launches.items() if n})}")
        del source, module, state, want
        PROBED.clear()
        CLI_DATA.clear()
        shutil.rmtree(out)
        torch.cuda.empty_cache()
    root.cleanup()
    return paths


def train_image_dp(dev) -> tuple[dict, dict]:
    """Phase 16: (a)-(f); the launches of its paths and (a)'s figures. The
    image DP's paths launch no kernel of #1-#13 (the converter's ACT paths
    run FPS, kNN and attention, as phase 4's ``predict``)."""
    t_phase = time.perf_counter()
    alone = image_dp_encoders(dev)
    paths = image_dp_serve(dev)
    paths.update(image_dp_steps(dev))
    paths.update(train_cli_image_dp(dev))
    paths.update(image_dp_pretrained(dev))
    paths.update(image_dp_converter(dev))
    stray = {path: {k: n for k, n in counts.items() if n} for path, counts in paths.items()
             if "pointnet" not in path and any(counts.values())}
    if stray:
        raise AssertionError(f"kernels launched on the image DP paths: {stray}")
    log(f"imagedp phase 16 in {time.perf_counter() - t_phase:.1f} s; no kernel of #1-#13 "
        f"launched on its {sum('pointnet' not in p for p in paths)} image DP paths")
    return paths, alone


# ---------------------------------------------------------------------------
# phase 17: RLBench, the paper's second simulator, under both heads,
# over episodes the phase writes in the processed layout
# (``entry.write_rlbench_episodes``: one 128 x 128 front camera, the cloud
# uniform in SCENE_BOUNDS but for RLBENCH_OUTSIDE points past it, so each
# frame keeps ~16,320 of 16,384 points after the crop and the 5 mm grid,
# padded to 16,384: kNN's v3 route, kernel 2, at its boundary). The
# configs' own datasets read them (the card needs no h5py for RLBench).
RLBENCH_TASK = "close_jar"
RLBENCH_SIDE = 128
RLBENCH_OUTSIDE = 64
RLBENCH_EPISODES, RLBENCH_HELD_OUT, RLBENCH_EPISODE_LEN = 6, 2, 30
RLBENCH_BATCH, RLBENCH_DP_BATCH = 8, 32  # the configs' batch_size_train
RLBENCH_LOOP = 8  # 6 episodes x 8 = 48 samples: 6 batches of 8, 1 of 32
RLBENCH_ACT_PARAMS, RLBENCH_DP_PARAMS = 24_391_212, 270_575_467  # JAX's (tests/test_torch_config.py)
RLBENCH_CPU_TOL = 1e-4  # card vs CPU, f32: of max(1, max |CPU|)
RLBENCH_STEPS = 3  # timed steps of (a) and (b)
RLBENCH_CLI_BATCHES, RLBENCH_CLI_EPOCHS = 2, 2  # (c): micro-steps of 8 an epoch, epochs
RLBENCH_EVAL_EPISODES, RLBENCH_EVAL_STEPS, RLBENCH_EVAL_SUCCESS = 2, 10, 7  # (d)
ROLLOUT_EPISODES, ROLLOUT_STEPS = 8, 6  # (e)
RLBENCH: dict = {}  # the phase's episode root and checkpoints


def rlbench_argv(root: str, run: str, family: str = "exp_rlbench_act_policy",
                 model: str = "scratch_pointnet_pcd") -> list[str]:
    """The README's RLBench composition over the phase's episodes (each
    RLBENCH_LOOP times an epoch), with a probe callback (``EndState``), the
    CSV logger and 4 loader workers."""
    return [f"{family}=base", f"{family}/rlbench_model@rlbench_model={model}",
            f"rlbench_task={RLBENCH_TASK}", f"data.train.root={root}/data/train",
            f"data.val.root={root}/data/val", f"data.train.loop={RLBENCH_LOOP}",
            "data.num_workers=4", "logger=csv",
            "+callbacks.end_state._target_=chip_smoke.EndState", f"paths.log_dir={root}/logs",
            f"hydra.run.dir={root}/{run}", "extras.print_config=false"]


def rlbench_data(root: str) -> None:
    """The phase's episodes under ``root/data``: RLBENCH_EPISODES to train
    on, RLBENCH_HELD_OUT held out (``val``), RLBENCH_EPISODE_LEN steps."""
    from pointcloudmatters_tpu_torch.entry import write_rlbench_episodes

    t0 = time.perf_counter()
    for stage, n, seed in (("train", RLBENCH_EPISODES, 0), ("val", RLBENCH_HELD_OUT, 1)):
        write_rlbench_episodes(os.path.join(root, "data"), RLBENCH_TASK, n, RLBENCH_EPISODE_LEN,
                               RLBENCH_SIDE, stages=(stage,), n_outside=RLBENCH_OUTSIDE,
                               seed=seed)
    RLBENCH["root"] = root
    log(f"rlbench {RLBENCH_EPISODES} + {RLBENCH_HELD_OUT} episodes of {RLBENCH_EPISODE_LEN} "
        f"steps, {RLBENCH_SIDE} x {RLBENCH_SIDE} front camera, written in "
        f"{time.perf_counter() - t0:.1f} s")


def rlbench_composed(family: str, model: str = "scratch_pointnet_pcd", extra=()):
    """(config, task module with seeded weights on the CPU, datamodule) of a
    composition over the phase's episodes."""
    from pointcloudmatters_tpu_torch import train as train_entry
    from pointcloudmatters_tpu_torch.utils import config as C

    sys.modules.setdefault("chip_smoke", sys.modules[__name__])
    cfg = train_entry.compose_run(rlbench_argv(RLBENCH["root"], f"{family}_{model}", family,
                                               model) + list(extra))
    return cfg, train_entry.instantiate_model(cfg), C.instantiate(cfg.data)


def rlbench_batch(dataset, batch_size: int, seed: int, pad_multiple: int = 512,
                  with_actions: bool = True) -> dict:
    """``batch_size`` samples of ``dataset`` (their draws from numpy's and
    Python's streams seeded ``seed``) collated as the datamodule collates."""
    import random

    import numpy as np

    from pointcloudmatters_tpu_torch.data.collate import padded_pcd_collate_fn

    np.random.seed(seed)
    random.seed(seed)
    batch = padded_pcd_collate_fn([dataset[i % len(dataset)] for i in range(batch_size)],
                                  pad_multiple=pad_multiple)
    if not with_actions:  # ACT's actions and is_pad, the DP's action
        for key in ("actions", "is_pad", "action"):
            batch.pop(key, None)
    return batch


@contextlib.contextmanager
def recorded_kernel_calls(into: dict):
    """The arguments of the first call of each of kernels 1-4's wrappers
    inside, by kernel name (the type of the attention's inputs picks f32 or
    bf16); the wrappers run as they do."""
    import torch

    from pointcloudmatters_tpu_torch.ops import fps, knn
    from pointcloudmatters_tpu_torch.ops import oneshot_attention as one

    saved = []
    for mod, attr, name in ((fps, "farthest_point_sampling_padded_cuda", "fps"),
                            (knn, "knn_query_padded_cuda", "knn"),
                            (one, "oneshot_attention_cuda", "attention_fwd"),
                            (one, "oneshot_attention_bwd_cuda", "attention_bwd")):
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))

        def wrapper(*args, _fn=fn, _name=name, **kw):
            bf16 = _name.startswith("attention") and args[0].dtype == torch.bfloat16
            into.setdefault(_name + ("_bf16" if bf16 else ""), (args, kw))
            return _fn(*args, **kw)

        setattr(mod, attr, wrapper)
    try:
        yield into
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


# the kernel calls each part of phase 17 must record on its path
RLBENCH_KERNEL_CALLS = {"(a)": {"fps", "knn", "attention_fwd", "attention_fwd_bf16",
                                "attention_bwd_bf16"},
                        "(b)": {"fps", "knn"}}


def rlbench_kernel_checks(dev, calls: dict, what: str) -> None:
    """Each recorded kernel call of the path (every one RLBENCH_KERNEL_CALLS
    names for ``what``, or it fails) against its plain version on the same
    tensors: FPS index-exact; kNN on the v3 route, index-exact, d2
    bit-equal; the attention within 1e-4 (f32) or BF16_TOL (bf16) of max
    |plain| itself, with no floor of 1 (the path's gradients are far below
    1), and a limit a zeroed output would exceed; the backward once on the
    step's own upstream gradient and once on a random one of unit size. Each
    kernel and plain version timed (CUDA events), the f32 attention beside
    ``scaled_dot_product_attention``, each with its bound; all logged."""
    import torch

    from pointcloudmatters_tpu_torch.ops import fps, knn, pointops
    from pointcloudmatters_tpu_torch.ops import oneshot_attention as one

    if set(calls) != RLBENCH_KERNEL_CALLS[what]:
        raise AssertionError(f"{what}: recorded kernel calls {sorted(calls)}, want "
                             f"{sorted(RLBENCH_KERNEL_CALLS[what])}")
    out = {}
    if "fps" in calls:
        (xyz, mask, n), _ = calls["fps"]
        hold_fps(f"{what} FPS", xyz, mask, n)
        out["fps"] = dict(
            B=xyz.shape[0], N=xyz.shape[1], valid=int(mask.sum()),
            ms=cuda_ms(lambda: fps.farthest_point_sampling_padded_cuda(xyz, mask, n), 3),
            plain_ms=cuda_ms(lambda: pointops.farthest_point_sampling_padded_plain(
                xyz, mask, n), 1), **fps_bound(xyz, mask, n))
    if "knn" in calls:
        (q, xyz, mask, k), _ = calls["knn"]
        route = pointops.knn_route("v3", xyz.shape[1], k, "cuda")
        gi, gd = knn.knn_query_padded_cuda(q, xyz, mask, k)
        pi, pd = pointops.knn_query_padded_plain(q, xyz, mask, k)
        if route != "v3" or not (torch.equal(gi, pi) and torch.equal(gd, pd)):
            raise AssertionError(f"{what}: kNN at N={xyz.shape[1]} (route {route}): indices "
                                 f"differ at {(gi != pi).sum().item()} places, d2 max diff "
                                 f"{_max_err(gd, pd):.3e}")
        out["knn"] = dict(
            B=xyz.shape[0], N=xyz.shape[1], queries=q.shape[1], k=k, route=route,
            ms=cuda_ms(lambda: knn.knn_query_padded_cuda(q, xyz, mask, k), 3),
            plain_ms=cuda_ms(lambda: pointops.knn_query_padded_plain(q, xyz, mask, k), 1),
            **knn_bound(q, xyz, mask, k))
    for name in ("attention_fwd", "attention_fwd_bf16"):
        if name not in calls:
            continue
        args, kw = calls[name]
        q, k, v = args[:3]
        rest = dict(kw, with_stats=False)
        tol, dtype = (1e-4, "f32") if name == "attention_fwd" else (BF16_TOL, "bf16")
        err, scale = hold(f"{what} {name}", one.oneshot_attention_cuda(*args, **rest),
                          one.oneshot_attention_plain(*args, **rest), tol, floor=False)
        B, H, L, dh = q.shape
        out[name] = dict(
            shape=[B, H, L, dh], max_abs_err=err, max_plain=scale,
            ms=cuda_ms(lambda: one.oneshot_attention_cuda(*args, **rest), 3),
            plain_ms=cuda_ms(lambda: one.oneshot_attention_plain(*args, **rest), 3),
            library_ms=sdpa_ms(q, k, v)[0] if dtype == "f32" else None,
            **_attention_bounds(B, H, L, dh, dtype)[0])
    if "attention_bwd_bf16" in calls:
        args, kw = calls["attention_bwd_bf16"]
        dout = args[4]
        unit = torch.randn(dout.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(0)).to(dout.dtype)
        figures = {}
        for which, d in (("step's upstream gradient", dout), ("unit upstream gradient", unit)):
            a = args[:4] + (d,) + args[5:]
            for n, g, p in zip(("dq", "dk", "dv"), one.oneshot_attention_bwd_cuda(*a, **kw),
                               one.oneshot_attention_plain_bwd(*a, **kw)):
                figures[f"{n} ({which})"] = hold(f"{what} attention_bwd_bf16 {n} ({which})",
                                                 g, p, BF16_TOL, floor=False)
        B, H, L, dh = args[0].shape
        out["attention_bwd_bf16"] = dict(
            shape=[B, H, L, dh],
            max_abs_err_of_max_plain=", ".join(f"{n} {e:.3e} of {m:.3e}"
                                               for n, (e, m) in figures.items()),
            ms=cuda_ms(lambda: one.oneshot_attention_bwd_cuda(*args, **kw), 3),
            plain_ms=cuda_ms(lambda: one.oneshot_attention_plain_bwd(*args, **kw), 3),
            **_attention_bounds(B, H, L, dh, "bf16")[1])
    for name, figures in out.items():
        log(f"rlbench {what} {card_line()}: {name} vs plain on the path's tensors: "
            + ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                        for k, v in figures.items()))


def _rlbench_requests(dataset, sizes=(1, RLBENCH_BATCH)) -> dict:
    return {B: [rlbench_batch(dataset, B, seed, with_actions=False) for seed in (1, 2, 3)]
            for B in sizes}


def rlbench_act(dev) -> dict:
    """Phase 17 (a): ACT over PointNet on RLBench (``scratch_pointnet_pcd``
    of ``exp_rlbench_act_policy``, 24,391,212 parameters, seeded weights):
    ``predict`` in f32 at B=1 and B=8 (three timed requests each), unit
    quaternions; the ``"bf16-mixed"`` step at B=8, RLBENCH_STEPS under
    ``set_sync_debug_mode("error")``; kernels 1-4 of those paths against
    their plain versions on the tensors the path gave them; the card
    against the port's CPU (predict, and the f32 loss and gradients at the
    running statistics) within RLBENCH_CPU_TOL. Returns the launches by
    path."""
    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch.models.bc_module import to_device
    from pointcloudmatters_tpu_torch.trainer import Trainer

    cfg, module, data = rlbench_composed("exp_rlbench_act_policy")
    n_params = sum(p.numel() for p in module.policy.parameters())
    if (type(module.policy).__name__, n_params) != ("ACTRLBenchPCD", RLBENCH_ACT_PARAMS):
        raise AssertionError(f"rlbench ACT: {type(module.policy).__name__} of {n_params}")
    cpu_state = {k: v.clone() for k, v in module.policy.state_dict().items()}
    ds = data.data_train
    requests = _rlbench_requests(ds)
    counts = requests[RLBENCH_BATCH][0]["pcds"]["count"]
    N = requests[RLBENCH_BATCH][0]["pcds"]["coord"].shape[1]
    module.to(dev)
    for B, reqs in requests.items():
        module.predict(reqs[0])
    torch.cuda.synchronize()
    paths, times = {}, {}
    ops.reset_launch_counts()
    for B, reqs in requests.items():
        for obs in reqs:
            t0 = time.perf_counter()
            a_hat = module.predict(obs)
            torch.cuda.synchronize()
            times.setdefault(B, []).append((time.perf_counter() - t0) * 1e3)
            quat = a_hat[..., 3:7]
            if (tuple(a_hat.shape) != (B, 100, 9) or not torch.isfinite(a_hat).all()
                    or (quat.norm(dim=-1) - 1).abs().max().item() > 1e-5
                    or (quat[..., 0] < 0).any()):
                raise AssertionError(f"rlbench predict B={B}: {tuple(a_hat.shape)}, not "
                                     f"finite (B, 100, 9) with unit quaternions")
    paths["rlbench_predict"] = launches = ops.launch_counts()
    n_req = sum(len(r) for r in requests.values())
    _only(launches, {k: n * n_req for k, n in EVAL_KERNELS_A_BATCH.items()}, "rlbench_predict")
    for B, ms in times.items():
        log(f"rlbench (a) {card_line()}: predict f32 B={B} (<= {N} points a cloud, valid "
            f"{int(counts.min())}-{int(counts.max())} at B=8): "
            + ", ".join(f"{t:.2f}" for t in ms) + " ms")

    trainer = Trainer(precision="bf16-mixed", seed=0)
    trainer.setup(module, TOTAL_STEPS)
    batch = to_device(rlbench_batch(ds, RLBENCH_BATCH, 4), dev)
    trainer.train_step(module, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        steps = [trainer.train_step(module, batch) for _ in range(RLBENCH_STEPS)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / RLBENCH_STEPS
    paths["rlbench_train"] = launches = ops.launch_counts()
    losses = [float(m["loss"]) for m in steps]
    if not np.isfinite(losses).all():
        raise AssertionError(f"rlbench_train: non-finite losses {losses}")
    _only(launches, {k: n * RLBENCH_STEPS for k, n in ACT_KERNELS_A_STEP.items()},
          "rlbench_train")
    log(f"rlbench (a) {card_line()}: train bf16-mixed B={RLBENCH_BATCH}: {step_ms:.2f} "
        f"ms/step over {RLBENCH_STEPS} steps, {RLBENCH_BATCH * 1e3 / step_ms:.2f} samples/s, "
        f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
        f"loss {losses}")

    calls = {}
    with recorded_kernel_calls(calls):
        module.predict(requests[RLBENCH_BATCH][0])
        trainer.train_step(module, batch)
    torch.cuda.synchronize()
    rlbench_kernel_checks(dev, calls, "(a)")
    del trainer, batch, steps, calls

    # the card against the CPU, f32: a request, and the loss and gradients
    # of a batch with actions at the running statistics (the same weights)
    module.policy.load_state_dict(cpu_state)
    cpu = rlbench_composed("exp_rlbench_act_policy")[1]
    cpu.policy.load_state_dict(cpu_state)
    request, with_actions = requests[1][1], rlbench_batch(ds, 1, 5)
    ref, got = cpu.predict(request), module.predict(request).cpu()
    err = _max_err(got, ref)
    if not err <= RLBENCH_CPU_TOL * max(1.0, ref.abs().max().item()):
        raise AssertionError(f"rlbench predict card vs CPU: {err:.3e}")
    line = _compare_step("f32 loss and gradients at the running statistics, card vs CPU",
                         *_eval_grads(module, with_actions), *_eval_grads(cpu, with_actions),
                         grad_rtol=RLBENCH_CPU_TOL, loss_rtol=RLBENCH_CPU_TOL)
    log(f"rlbench (a) predict card vs CPU max abs diff {err:.3e}; {line}")
    del module, cpu
    torch.cuda.empty_cache()
    return paths


def rlbench_dp(dev) -> dict:
    """Phase 17 (b): the RLBench Diffusion Policy (``scratch_pointnet_pcd``
    of ``exp_rlbench_diffusion_policy``, 270,575,467 parameters, the
    dataset's identity normalizer wired by ``setup_module``): ``predict``
    (100 DDPM steps, f32) at B=1, three timed; the ``"bf16-mixed"`` step at
    the config's B=32 (64 clouds), RLBENCH_STEPS timed; FPS and kNN once a
    request and a step and no other kernel, each against its plain version
    on the path's tensors; then a checkpoint for (d). Returns the launches
    by path."""
    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch.models.bc_module import to_device
    from pointcloudmatters_tpu_torch.trainer import Trainer

    family = "exp_rlbench_diffusion_policy"
    cfg, module, data = rlbench_composed(family)
    n_params = sum(p.numel() for p in module.policy.parameters())
    if n_params != RLBENCH_DP_PARAMS:
        raise AssertionError(f"rlbench DP: {n_params} parameters")
    trainer = Trainer(default_root_dir=os.path.join(RLBENCH["root"], "dp"),
                      precision="bf16-mixed", seed=0)
    data.setup("fit")
    trainer._start(module, data, data.train_dataloader(), dev)
    if "normalizer" not in module.state_dict_extras():
        raise AssertionError("rlbench DP: the dataset's normalizer was not wired")
    trainer.setup(module, TOTAL_STEPS)
    ds = data.data_train
    requests = [rlbench_batch(ds, 1, s, with_actions=False) for s in (1, 2, 3, 4)]

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    module.predict(requests[0], gen(0))
    torch.cuda.synchronize()
    paths, ms = {}, []
    ops.reset_launch_counts()
    for i, obs in enumerate(requests[1:]):
        t0 = time.perf_counter()
        action = module.predict(obs, gen(i))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if tuple(action.shape) != (1, 8, 11) or not torch.isfinite(action).all():
            raise AssertionError(f"rlbench DP predict: {tuple(action.shape)}, not a finite "
                                 f"(1, 8, 11)")
    paths["rlbench_dp_predict"] = launches = ops.launch_counts()
    _only(launches, {"fps": 3, "knn": 3}, "rlbench_dp_predict")
    batch = to_device(rlbench_batch(ds, RLBENCH_DP_BATCH, 6), dev)
    trainer.train_step(module, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        steps = [trainer.train_step(module, batch) for _ in range(RLBENCH_STEPS)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / RLBENCH_STEPS
    paths["rlbench_dp_train"] = launches = ops.launch_counts()
    losses = [float(m["loss"]) for m in steps]
    if not np.isfinite(losses).all():
        raise AssertionError(f"rlbench_dp_train: non-finite losses {losses}")
    _only(launches, {"fps": RLBENCH_STEPS, "knn": RLBENCH_STEPS}, "rlbench_dp_train")
    log(f"rlbench (b) {card_line()}: DP predict B=1 (2 clouds, 100 DDPM steps, f32): "
        + ", ".join(f"{t:.2f}" for t in ms) + f" ms; train bf16-mixed B={RLBENCH_DP_BATCH} "
        f"({2 * RLBENCH_DP_BATCH} clouds): {step_ms:.2f} ms/step over {RLBENCH_STEPS} steps, "
        f"{RLBENCH_DP_BATCH * 1e3 / step_ms:.2f} samples/s, peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; loss {losses}")
    calls = {}
    with recorded_kernel_calls(calls):
        trainer.train_step(module, batch)
    torch.cuda.synchronize()
    rlbench_kernel_checks(dev, calls, "(b)")
    RLBENCH["dp_ckpt"] = os.path.join(RLBENCH["root"], "dp", "checkpoint")
    trainer.save_checkpoint(RLBENCH["dp_ckpt"])
    del module, trainer, batch, calls
    torch.cuda.empty_cache()
    return paths


def _cli_run(argv: list[str], what: str, want_steps: int, want_launches: dict,
             part: str = "rlbench (c)"):
    """``train.main(argv)``: checks the run's micro-steps, finite train and
    held-out losses after each epoch, a ``last`` checkpoint and the exact
    launches; logs under ``part``; returns (launches, the probe, the
    ``last`` checkpoint)."""
    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch import train as train_entry
    from pointcloudmatters_tpu_torch.trainer import CHECKPOINT_FILE

    EndState.runs.clear()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    train_entry.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    probe = EndState.runs[-1]
    trainer = probe.trainer
    losses = [m["train/loss"] for _, _, m in probe.epochs]
    vals = [m["val/loss"] for _, _, m in probe.epochs]
    last = os.path.join(trainer.checkpoint_callback.dirpath, "last")
    if (trainer.global_step != want_steps or not np.isfinite(losses + vals).all()
            or not os.path.isfile(os.path.join(last, CHECKPOINT_FILE))):
        raise AssertionError(f"{what}: {trainer.global_step} micro-steps, train/loss {losses}, "
                             f"val/loss {vals}, last {os.listdir(os.path.dirname(last))}")
    _only(launches, want_launches, what)
    size = os.path.getsize(os.path.join(last, CHECKPOINT_FILE))
    log(f"{part} {card_line()}: {what}: {trainer.global_step} micro-steps of "
        f"B={RLBENCH_BATCH} in {seconds:.2f} s ({probe.t_start - t0:.2f} s to the first step;"
        f" last epoch {probe.epochs[-1][2]['samples_per_sec']:.2f} samples/s); train/loss "
        f"{losses}, val/loss {vals}; checkpoint {size / 1e6:.1f} MB; launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    return launches, probe, last


def train_cli_rlbench(dev) -> dict:
    """Phase 17 (c): ``train.main`` on ``exp_rlbench_act_policy=base`` over
    the phase's episodes: ``scratch_pointnet_pcd`` for RLBENCH_CLI_EPOCHS
    epochs of RLBENCH_CLI_BATCHES micro-steps of 8 (two a optimizer step),
    held-out validation (``val/loss``) after each, checkpoints (``last``
    kept for (d)); ``scratch_spunet_pcd`` and ``scratch_resnet50_rgb`` for
    one epoch each. Returns the launches by path."""
    root = RLBENCH["root"]
    common = [f"trainer.limit_train_batches={RLBENCH_CLI_BATCHES}",
              "trainer.accumulate_grad_batches=2", "trainer.check_val_every_n_epoch=1",
              f"trainer.limit_val_batches={RLBENCH_HELD_OUT}"]
    paths = {}
    for model, epochs in (("scratch_pointnet_pcd", RLBENCH_CLI_EPOCHS),
                          ("scratch_spunet_pcd", 1), ("scratch_resnet50_rgb", 1)):
        micro, val_batches = epochs * RLBENCH_CLI_BATCHES, epochs * RLBENCH_HELD_OUT
        want = {} if "rgb" in model else {
            k: n * micro for k, n in ACT_KERNELS_A_STEP.items()}
        for k, n in ({} if "rgb" in model else EVAL_KERNELS_A_BATCH).items():
            want[k] = want.get(k, 0) + n * val_batches
        name = "train_cli_rlbench" + ("" if model == "scratch_pointnet_pcd" else f"_{model}")
        argv = rlbench_argv(root, f"cli_{model}", model=model) + common + [
            f"trainer.max_epochs={epochs}"]
        paths[name], probe, last = _cli_run(argv, name, micro, want)
        if model == "scratch_pointnet_pcd":
            RLBENCH["act_ckpt"], RLBENCH["act_argv"] = last, argv
        del probe
        EndState.runs.clear()
    import torch

    torch.cuda.empty_cache()
    return paths


class RLBenchEvalTask:
    """The RLBench task the evaluation entry points see in (d): a held-out
    episode's frames as observations, one IK error (``RuntimeError``, the
    loops' error type without PyRep) at the first try of each episode,
    success at step RLBENCH_EVAL_SUCCESS of episode 0; the host clock at
    each step."""

    def __init__(self, frames):
        self.frames, self.clock, self.widths = frames, [], set()

    def reset(self, ep):
        self.ep, self.t, self.failed = ep, 0, False
        return "close the jar", self.frames[0]

    def step(self, action):
        if not self.failed:
            self.failed = True
            raise RuntimeError("IK failed")
        self.clock.append((self.ep, time.perf_counter()))
        self.widths.add(len(action))
        self.t += 1
        success = self.ep == 0 and self.t == RLBENCH_EVAL_SUCCESS
        return self.frames[self.t % len(self.frames)], float(success), False

    def shutdown(self):
        pass


def rlbench_eval(dev) -> dict:
    """Phase 17 (d): ``python -m pointcloudmatters_tpu_torch.test_rlbench_act``
    (its ``main``) on (c)'s ``last`` checkpoint and ``test_rlbench_dp`` on
    (b)'s, with the port's ``rlbench_utils.build_env_and_task`` /
    ``reset_task`` patched to RLBenchEvalTask (RLBENCH_EVAL_EPISODES
    episodes of at most RLBENCH_EVAL_STEPS steps) and the goal from a
    ``CachedTextEncoder`` over a ``clip_cache.npz`` the phase writes. Reads
    the line each appends to the result file, and times a loop step at
    B=1. Returns the launches by path."""
    import numpy as np

    from pointcloudmatters_tpu_torch import ops, test_rlbench_act, test_rlbench_dp
    from pointcloudmatters_tpu_torch.utils import rlbench_utils as RU

    root = RLBENCH["root"]
    frames = np.load(os.path.join(root, "data", "val", RLBENCH_TASK, "ep0.npy"),
                     allow_pickle=True).item()["demo"]
    cache = RU.CachedTextEncoder(os.path.join(root, "clip_cache.npz"))
    cache.put("close the jar", np.random.RandomState(0).randn(512).astype(np.float32))
    cache.save()
    saved = RU.build_env_and_task, RU.reset_task
    paths = {}
    try:
        for name, entry, argv, width, predicts in (
                ("rlbench_eval", test_rlbench_act, RLBENCH["act_argv"], 9,
                 RLBENCH_EVAL_SUCCESS + RLBENCH_EVAL_STEPS),
                ("rlbench_dp_eval", test_rlbench_dp,
                 rlbench_argv(root, "dp_eval", "exp_rlbench_diffusion_policy"), 11,
                 1 + 2)):  # 8 actions a prediction: 7 steps take 1, 10 take 2
            task = RLBenchEvalTask(frames)
            RU.build_env_and_task = lambda cfg: (task, task)
            RU.reset_task = lambda t, cfg, ep: (t, None, [t.reset(ep)[0]], t.frames[0])
            ckpt = RLBENCH["act_ckpt"] if width == 9 else RLBENCH["dp_ckpt"]
            result = os.path.join(root, f"{name}_results")
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            metrics = entry.main(argv + [
                f"ckpt_path={ckpt}", f"episodes_num={RLBENCH_EVAL_EPISODES}",
                f"max_steps={RLBENCH_EVAL_STEPS}", f"result_path={result}",
                f"clip_cache_path={root}/clip_cache.npz"])
            seconds = time.perf_counter() - t0
            paths[name] = launches = ops.launch_counts()
            with open(os.path.join(result, "test_result.txt")) as f:
                lines = f.read().splitlines()
            if metrics != {"success_rate": 0.5} or lines != [f"{ckpt}: 0.5"] \
                    or task.widths != {width}:
                raise AssertionError(f"{name}: {metrics}, result file {lines}, action widths "
                                     f"{task.widths}")
            want = ({k: n * predicts for k, n in EVAL_KERNELS_A_BATCH.items()} if width == 9
                    else {"fps": predicts, "knn": predicts})
            _only(launches, want, name)
            gaps = [b - a for (ea, a), (eb, b) in zip(task.clock, task.clock[1:]) if ea == eb]
            log(f"rlbench (d) {card_line()}: {name}: result line {lines[0]!r}; "
                f"{len(task.clock)} steps, {predicts} predictions at B=1 in {seconds:.2f} s "
                f"(composition, restore and episodes); a loop step "
                f"{1e3 * float(np.mean(gaps)):.2f} ms mean, {1e3 * float(np.median(gaps)):.2f} "
                f"median, {1e3 * max(gaps):.2f} most (a prediction, its conversions, the step)")
    finally:
        RU.build_env_and_task, RU.reset_task = saved
    return paths


class RolloutEnv:
    """A ManiSkill2 env for (e): a 128 x 128 camera's cloud following the
    seed and the step (as phase 10's demos: a fifth of it w = 0),
    success on seeds divisible by 3 after ROLLOUT_STEPS steps."""

    def reset(self, seed=None, options=None):
        self.seed, self.t = seed, 0
        return self.obs(), {}

    def obs(self):
        import numpy as np

        rng = np.random.RandomState(self.seed * 100 + self.t)
        n = FIT_CAM_SIDE ** 2
        xyz = rng.rand(n, 3).astype(np.float32)
        xyz[:, :2] = (xyz[:, :2] - 0.5) * 0.4
        xyz[:, 2] *= 0.3
        w = (rng.rand(n, 1) > 0.2).astype(np.float32)
        return {"agent": {"qpos": rng.randn(9).astype(np.float32)},
                "pointcloud": {"xyzw": np.concatenate([xyz, w], -1),
                               "rgb": rng.randint(0, 255, (n, 3)).astype(np.uint8)},
                "extra": {"goal_pos": rng.randn(3).astype(np.float32)}}

    def step(self, action):
        if len(action) != 7:
            raise AssertionError(f"rollout action of width {len(action)}")
        self.t += 1
        done = self.t >= ROLLOUT_STEPS
        return self.obs(), 0.0, done, False, {"success": done and self.seed % 3 == 0}

    def close(self):
        pass


def rlbench_rollouts(dev) -> dict:
    """Phase 17 (e): the flagship's ManiSkill2 task module validating by
    rollouts (``run_validation`` with an ``env_factory`` of RolloutEnv),
    ROLLOUT_EPISODES episodes at ``num_envs`` 1 and 4: the same
    ``val/mean_success`` (2 of 8 seeds succeed), the wall seconds of each.
    Returns the launches by path."""
    import tempfile

    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch.data.base_datamodule import BaseDataModule
    from pointcloudmatters_tpu_torch.data.components.misc import DummyDataset
    from pointcloudmatters_tpu_torch.entry import build_flagship
    from pointcloudmatters_tpu_torch.models.maniskill2_modules import ManiSkill2ACTBCModule
    from pointcloudmatters_tpu_torch.trainer import Trainer

    tmp = tempfile.TemporaryDirectory()
    ds = in_memory_dataset(synthetic_demos(2, 10, FIT_CAM_SIDE), transform_pcd=fit_transforms(),
                           goal_cond_keys=["goal_pos"], chunk_size=100, camera_ids=[0],
                           point_num_per_cam=FIT_CAM_SIDE ** 2, cache_dir=tmp.name)
    data = BaseDataModule(train=ds, val=DummyDataset(size=ROLLOUT_EPISODES), batch_size_train=8)
    policy = build_flagship(seed=0, device=dev)
    paths, outs, seconds = {}, [], []
    for num_envs in (1, 4):
        module = ManiSkill2ACTBCModule(policy, env_id="PickCube-v0", num_envs=num_envs,
                                       env_factory=lambda m: RolloutEnv())
        trainer = Trainer(default_root_dir=tmp.name, seed=0)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        outs.append(module.run_validation(trainer, data))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        paths[f"rollouts_{num_envs}_envs"] = launches = ops.launch_counts()
        n = ROLLOUT_EPISODES * ROLLOUT_STEPS
        _only(launches, {k: c * n for k, c in EVAL_KERNELS_A_BATCH.items()},
              f"rollouts at num_envs {num_envs}")
    if outs[0] != outs[1] or outs[0] != {"val/mean_success": 0.25}:
        raise AssertionError(f"rollouts: val/mean_success {outs[0]} at 1 env, {outs[1]} at 4")
    log(f"rlbench (e) {card_line()}: flagship rollout validation, {ROLLOUT_EPISODES} episodes "
        f"of {ROLLOUT_STEPS} steps (B=1 requests of <= {FIT_CAM_SIDE ** 2} points): "
        f"{outs[0]} at num_envs 1 in {seconds[0]:.2f} s and at num_envs 4 in "
        f"{seconds[1]:.2f} s")
    tmp.cleanup()
    del policy
    torch.cuda.empty_cache()
    return paths


def rlbench_profiled_fit(dev) -> dict:
    """Phase 17 (f): one ``Trainer(profiler="simple")`` fit of the RLBench
    ACT (bf16-mixed, 2 micro-steps of 8, no validation): the trace it
    writes (``<root>/torch_trace/trace.json``) read back, the device kernels
    by total time. Returns the launches by path."""
    import collections

    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch.trainer import Trainer
    from pointcloudmatters_tpu_torch.utils import profiling

    _, module, data = rlbench_composed("exp_rlbench_act_policy")
    root = os.path.join(RLBENCH["root"], "profiled")
    trainer = Trainer(default_root_dir=root, precision="bf16-mixed", max_epochs=1,
                      limit_train_batches=2, check_val_every_n_epoch=0, profiler="simple",
                      seed=0)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.fit(module, data)
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    _only(launches, {k: 2 * n for k, n in ACT_KERNELS_A_STEP.items()}, "rlbench_profiled_fit")
    with open(os.path.join(root, "torch_trace", profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    by_kernel = collections.Counter()
    for e in events:
        if e.get("cat") == "kernel":
            by_kernel[e["name"]] += float(e.get("dur", 0.0))
    if not by_kernel:
        raise AssertionError("the profiled fit's trace holds no device kernel")
    total = sum(by_kernel.values())
    top = by_kernel.most_common(5)
    log(f"rlbench (f) {card_line()}: profiled fit (2 micro-steps) in {seconds:.2f} s; trace "
        f"{os.path.getsize(os.path.join(root, 'torch_trace', profiling.TRACE_FILE)) / 1e6:.1f} "
        f"MB, {len(by_kernel)} kernels, {total / 1e3:.2f} ms of kernel time; top: "
        + "; ".join(f"{name[:60]} {us / 1e3:.2f} ms ({100 * us / total:.1f}%)"
                    for name, us in top))
    del module, trainer
    torch.cuda.empty_cache()
    return {"rlbench_profiled_fit": launches}


def train_rlbench(dev) -> dict:
    """Phase 17: (a)-(f) over the phase's episodes; the launches of its
    paths."""
    import tempfile

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    rlbench_data(tmp.name)
    paths = rlbench_act(dev)
    paths.update(rlbench_dp(dev))
    paths.update(train_cli_rlbench(dev))
    paths.update(rlbench_eval(dev))
    paths.update(rlbench_rollouts(dev))
    paths.update(rlbench_profiled_fit(dev))
    tmp.cleanup()
    RLBENCH.clear()
    log(f"rlbench phase 17 in {time.perf_counter() - t_phase:.1f} s")
    return paths


# ---------------------------------------------------------------------------
# phase 18: SWA, the state-only and masked ACT, the library surface
# ---------------------------------------------------------------------------

SWA_EPOCHS, SWA_TRAIN_BATCHES = 4, 4  # micro-batches an epoch: 2 optimizer steps at k = 2
SWA_LRS = 5e-4  # tests/test_training.py's SWA run
SWA_STAT_TOL = 1e-5  # of max|stat|: the probe's division by 1 - momentum
STATE_ENV_DIM = 42  # the phase's env_state width: no shipped config sets one
STATE_PARAMS = 23_799_336
STATE_STEPS = 3
STATE_CPU_TOL = 1e-4  # card vs CPU, f32: of max(1, max |CPU|)
MASK_BATCH = 4
MASK_FEW = 100  # foreground points of the cloud with fewer than n_fg
LIB_BATCH, LIB_QUERIES, LIB_K = 4, 2048, 16  # phase 3's shapes
LIB_OFFSETS = (10240, 16000, 22113, 30720)  # a packed batch of ragged clouds
LIB_TOL = 1e-6  # distances and values: of max(1, max |plain|)
GROUPS = [{"keyword": "backbone", "lr": 1e-5}]
GROUP_STEPS = 3
TFD_BATCH = 8
TFD_CPU_TOL = 1e-4  # card vs CPU, f32: of max(1, max |CPU|)
PHASE18_SELECTOR_PATHS = ("pointops_chunkskip", "pointops_baseline")


class SWASnapshots:
    """A probe callback of phase 18 (a): each epoch's end parameters (on the
    card) and numpy's global state after the last epoch, which the SWA
    refresh's loader then draws from."""

    runs: list = []

    def __init__(self):
        self.params, self.np_state = {}, None
        SWASnapshots.runs.append(self)

    def setup(self, trainer, module):
        pass

    def on_fit_start(self, trainer, module):
        pass

    def on_validation_end(self, trainer, module, metrics, epoch):
        pass

    def on_train_epoch_end(self, trainer, module, metrics, epoch):
        import numpy as np

        self.params[epoch] = {n: p.detach().clone() for n, p in module.policy.named_parameters()}
        self.np_state = np.random.get_state()

    def on_fit_end(self, trainer, module):
        pass


def swa_argv(root: str) -> list[str]:
    return [
        "exp_maniskill2_act_policy=base",
        "exp_maniskill2_act_policy/maniskill2_model@maniskill2_model=scratch_pointnet_pcd",
        "exp_maniskill2_act_policy/maniskill2_pcd_task@maniskill2_pcd_task=PickCube-v0",
        "data.train._target_=chip_smoke.cli_train_set",
        "data.val._target_=chip_smoke.cli_held_out_set", "data.num_workers=0",
        "callbacks=stochastic_weight_averaging",
        f"callbacks.stochastic_weight_averaging.swa_lrs={SWA_LRS}",
        "callbacks.stochastic_weight_averaging.swa_epoch_start=0.5",
        "callbacks.stochastic_weight_averaging.annealing_epochs=1",
        "+callbacks.end_state._target_=chip_smoke.EndState",
        "+callbacks.snapshots._target_=chip_smoke.SWASnapshots",
        f"trainer.max_epochs={SWA_EPOCHS}", f"trainer.limit_train_batches={SWA_TRAIN_BATCHES}",
        "trainer.check_val_every_n_epoch=0", "trainer.num_sanity_val_steps=0",
        f"paths.log_dir={root}/logs", f"hydra.run.dir={root}/swa", "extras.print_config=false",
    ]


def probed_batch_stats(module, loader, n: int) -> dict:
    """The uniform mean of the per-batch statistics over ``n`` batches of
    ``loader``, recovered as the JAX callback recovers them (a forward from
    zeroed statistics and one from ones give the momentum, then each
    batch's statistics from zeros), in f32 train mode; the module's
    buffers are left as they were."""
    import torch

    policy = module.policy
    names = {k for k, _ in policy.named_parameters()}
    stats = {k: b for k, b in policy.state_dict().items() if k not in names}
    saved = {k: b.clone() for k, b in stats.items()}
    acc, momentum = None, None

    def run(fill, batch, i):
        for b in stats.values():
            b.fill_(fill)
        module.forward_train(batch, module.make_rngs(i))
        return {k: b.clone() for k, b in stats.items()}

    with torch.no_grad():
        for i, batch in enumerate(loader):
            if i >= n:
                break
            a = run(0.0, batch, i)
            if momentum is None:
                b = run(1.0, batch, i)
                momentum = {k: b[k] - a[k] for k in a}
            x = {k: a[k] / torch.clamp_min(1.0 - momentum[k], 1e-6) for k in a}
            acc = x if acc is None else {k: acc[k] + (x[k] - acc[k]) / (i + 1.0) for k in acc}
        for k, b in stats.items():
            b.copy_(saved[k])
    return acc


def swa_fit(dev) -> dict:
    """Phase 18 (a): ``train.main`` on the flagship's composition with
    ``callbacks=stochastic_weight_averaging`` at the shipped widths, B=8 x
    2, 4 epochs of 2 optimizer steps (``swa_lrs`` 5e-4, ``swa_epoch_start``
    0.5, ``annealing_epochs`` 1): two epochs averaged; the rate at the last
    step is ``swa_lrs``; the swapped weights bit-equal to the mean of the
    epoch-end snapshots the phase keeps; the refreshed statistics within
    SWA_STAT_TOL of max|stat| of the per-batch mean the phase recomputes
    over the same batches (JAX's probe); the exact launches."""
    import tempfile

    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch import callbacks as tcb
    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch import train as train_entry

    sys.modules.setdefault("chip_smoke", sys.modules[__name__])  # the targets' module
    t_part = time.perf_counter()
    root = tempfile.TemporaryDirectory()
    demos = synthetic_demos(FIT_EPISODES, FIT_EPISODE_LEN, FIT_CAM_SIDE)
    n_train = FIT_EPISODES - FIT_HELD_OUT
    CLI_DATA.update(train=demos[:n_train], held_out=demos[n_train:],
                    cache=os.path.join(root.name, "cache"))
    EndState.runs.clear()
    SWASnapshots.runs.clear()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    train_entry.main(swa_argv(root.name))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    probe, snaps = EndState.runs[-1], SWASnapshots.runs[-1]
    trainer, module = probe.trainer, probe.module
    swa = next(cb for cb in trainer.callbacks if isinstance(cb, tcb.StochasticWeightAveraging))
    micro = SWA_EPOCHS * SWA_TRAIN_BATCHES
    total = micro // FIT_ACCUMULATE
    n_refresh = len(trainer.datamodule.train_dataloader())
    _only(launches, {"fps": micro + n_refresh, "knn": micro + n_refresh,
                     "attention_fwd_bf16": micro * ENC_LAYERS,
                     "attention_bwd_bf16": micro * ENC_LAYERS,
                     "attention_fwd": n_refresh * ENC_LAYERS}, "swa_train_cli")
    rates = [trainer._schedule.lr_at(s) for s in range(total + 1)]
    lr = [g["lr"] for g in module.optimizer.param_groups]
    if (swa.n_averaged, swa._swa_start_epoch, trainer.global_step,
            module.scheduler.last_epoch) != (2, 2, micro, total):
        raise AssertionError(f"swa: n_averaged {swa.n_averaged}, start epoch "
                             f"{swa._swa_start_epoch}, {trainer.global_step} micro-steps, "
                             f"{module.scheduler.last_epoch} optimizer steps")
    if rates[-1] != float(np.float32(SWA_LRS)) or lr != [rates[-1]]:
        raise AssertionError(f"swa: the rate at step {total} is {rates[-1]} (groups {lr}), "
                             f"not swa_lrs {SWA_LRS}")
    # the mean of the snapshots, as the average is taken: a + (p - a) / (n + 1)
    mean = {k: v.clone() for k, v in snaps.params[2].items()}
    n1 = torch.full((), 2.0, device=dev)
    for k, a in mean.items():
        a.add_((snaps.params[3][k] - a) / n1)
    differ = [k for k, p in module.policy.named_parameters() if not torch.equal(p, mean[k])]
    if differ:
        raise AssertionError(f"swa: the swapped weights differ from the snapshots' mean at "
                             f"{differ[:5]}")
    np.random.set_state(snaps.np_state)
    t_probe = time.perf_counter()
    want = probed_batch_stats(module, trainer.datamodule.train_dataloader(), n_refresh)
    probe_s = time.perf_counter() - t_probe
    state = module.policy.state_dict()
    worst = 0.0
    for k, w in want.items():
        err = _max_err(state[k], w)
        scale = w.abs().max().item()
        if not err <= SWA_STAT_TOL * scale:
            raise AssertionError(f"swa: refreshed {k} off by {err:.3e} (max |stat| {scale:.3e})")
        worst = max(worst, err / max(scale, 1e-30))
    losses = [m["train/loss"] for _, _, m in probe.epochs]
    if not np.isfinite(losses).all():
        raise AssertionError(f"swa: non-finite losses {losses}")
    log(f"phase18 (a) {card_line()}: SWA train.main {micro} micro-steps of B={FIT_BATCH} x "
        f"{FIT_ACCUMULATE} over {SWA_EPOCHS} epochs in {seconds:.2f} s ({probe.t_start - t0:.2f}"
        f" s to the first step); n_averaged {swa.n_averaged}; rates by optimizer step "
        + ", ".join(f"{r:.6g}" for r in rates) + f"; weights bit-equal to the mean of epochs "
        f"2-3; {len(want)} statistics over {n_refresh} refresh batches within "
        f"{worst:.3e} of max|stat| of the probe's mean (its recompute {probe_s:.2f} s); "
        f"train/loss {losses}; launches { {k: n for k, n in launches.items() if n} }; part "
        f"{time.perf_counter() - t_part:.1f} s")
    CLI_DATA.clear()
    root.cleanup()
    del trainer, module, swa, snaps, probe
    EndState.runs.clear()
    SWASnapshots.runs.clear()
    torch.cuda.empty_cache()
    return {"swa_train_cli": launches}


def hold_oneshot_short_rows(dev) -> dict:
    """Kernels 3 and 4 at L = 2 and 3 (the state-only ACT's encoder rows;
    B=32, 8 heads, dh 64), f32 and bf16, rates 0 and 0.1, against their
    plain versions: within 1e-4 (f32) and BF16_TOL (bf16) of max |plain|
    with no floor, a limit a zeroed output would exceed; the backward on a
    unit upstream gradient. Returns the worst error of each."""
    import torch

    from pointcloudmatters_tpu_torch.ops import oneshot_attention as one

    gen = torch.Generator(device=dev).manual_seed(18)
    worst = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, BF16_TOL)):
        for L in (2, 3):
            for rate in (0.0, ATTN_DROPOUT):
                q, k, v, dout = (torch.randn((BIG_BATCH, 8, L, 64), generator=gen,
                                             device=dev).to(dtype) for _ in range(4))
                args = (q, k, v, 64 ** -0.5, None, rate, 7)
                out, m, r = one.oneshot_attention_cuda(*args, with_stats=True)
                ref, m_p, r_p = one.oneshot_attention_plain(*args, with_stats=True)
                what = f"{str(dtype)[6:]} L={L} rate={rate}"
                errs = [hold(f"oneshot fwd {what}", out, ref, tol, floor=False)[0] / max(
                    ref.float().abs().max().item(), 1e-30)]
                bargs = (q, k, v, out, dout, m, r, 64 ** -0.5, None, rate, 7)
                for n, g, p in zip(("dq", "dk", "dv"), one.oneshot_attention_bwd_cuda(*bargs),
                                   one.oneshot_attention_plain_bwd(*bargs)):
                    errs.append(hold(f"oneshot bwd {n} {what}", g, p, tol, floor=False)[0]
                                / max(p.float().abs().max().item(), 1e-30))
                worst[what] = max(errs)
    return worst


def state_only_act(dev) -> dict:
    """Phase 18 (b): the state-only ACT at ``maniskill2_act_model.yaml``'s
    widths (hidden 512, 4 + 7 layers, 8 heads; ``backbone: null``,
    ``env_state_dim`` STATE_ENV_DIM): ``predict`` f32 at B=1 and B=32, a
    ``"bf16-mixed"`` step at B=32, card against the CPU. Its encoder rows
    hold 2-3 tokens, under the oneshot gate's 512 keys (JAX
    ``attention.py:112``), so the path takes the dense attention and
    launches none of kernels 1-13; kernels 3 and 4 are held at L = 2 and 3
    directly (:func:`hold_oneshot_short_rows`)."""
    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch import entry, ops
    from pointcloudmatters_tpu_torch.models.bc_module import BCModule, to_device
    from pointcloudmatters_tpu_torch.trainer import Trainer

    t_part = time.perf_counter()
    worst = hold_oneshot_short_rows(dev)
    policy = entry.build_state_policy(env_state_dim=STATE_ENV_DIM, device="cpu")
    n_params = sum(p.numel() for p in policy.parameters())
    if n_params != STATE_PARAMS:
        raise AssertionError(f"state-only ACT: {n_params} parameters, not {STATE_PARAMS}")
    cpu_state = {k: v.clone() for k, v in policy.state_dict().items()}
    module = BCModule(policy.to(dev), optimizer=FLAGSHIP_OPT, lr_scheduler=FLAGSHIP_SCHED)
    requests = {B: [entry.build_state_batch(B, STATE_ENV_DIM, seed=s, with_actions=False)
                    for s in (1, 2, 3)] for B in (1, BIG_BATCH)}
    for reqs in requests.values():
        module.predict(reqs[0])
    torch.cuda.synchronize()
    paths, times = {}, {}
    ops.reset_launch_counts()
    for B, reqs in requests.items():
        for obs in reqs:
            t0 = time.perf_counter()
            a_hat = module.predict(obs)
            torch.cuda.synchronize()
            times.setdefault(B, []).append((time.perf_counter() - t0) * 1e3)
            if tuple(a_hat.shape) != (B, 100, 7) or not torch.isfinite(a_hat).all():
                raise AssertionError(f"state-only predict B={B}: {tuple(a_hat.shape)}")
    paths["state_predict"] = launches = ops.launch_counts()
    _only(launches, {}, "state_predict")
    trainer = Trainer(precision="bf16-mixed", seed=0)
    trainer.setup(module, TOTAL_STEPS)
    batch = to_device(entry.build_state_batch(BIG_BATCH, STATE_ENV_DIM, seed=4), dev)
    trainer.train_step(module, batch)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [float(trainer.train_step(module, batch)["loss"]) for _ in range(STATE_STEPS)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / STATE_STEPS
    paths["state_train"] = launches = ops.launch_counts()
    _only(launches, {}, "state_train")
    if not np.isfinite(losses).all():
        raise AssertionError(f"state-only step: non-finite losses {losses}")
    module.policy.load_state_dict(cpu_state)
    cpu = BCModule(entry.build_state_policy(env_state_dim=STATE_ENV_DIM, device="cpu"))
    cpu.policy.load_state_dict(cpu_state)
    ref, got = cpu.predict(requests[BIG_BATCH][1]), module.predict(requests[BIG_BATCH][1]).cpu()
    err = _max_err(got, ref)
    if not err <= STATE_CPU_TOL * max(1.0, ref.abs().max().item()):
        raise AssertionError(f"state-only predict card vs CPU: {err:.3e}")
    log(f"phase18 (b) {card_line()}: state-only ACT {n_params} parameters, env_state "
        f"{STATE_ENV_DIM}: predict f32 " + "; ".join(
            f"B={B} " + ", ".join(f"{t:.2f}" for t in ms) + " ms" for B, ms in times.items())
        + f"; bf16 step B={BIG_BATCH} {step_ms:.2f} ms ({BIG_BATCH * 1e3 / step_ms:.2f} "
        f"samples/s), loss {losses}; predict card vs CPU {err:.3e}; no kernel launched "
        f"(rows of 2-3 keys take the dense attention); kernels 3/4 at L = 2, 3 against "
        f"their plain versions, worst of max|plain|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f"; part {time.perf_counter() - t_part:.1f} s")
    del module, cpu, trainer, batch
    torch.cuda.empty_cache()
    return paths


def masked_clouds(dev):
    """The flagship's padded batch of MASK_BATCH clouds with a foreground
    ``mask``: point 0 background in every cloud; cloud 1 with MASK_FEW
    foreground points (fewer than any n_fg), cloud 2 with none."""
    import numpy as np

    from pointcloudmatters_tpu_torch import entry

    batch = entry.build_batch(MASK_BATCH, n_points=N_POINTS, chunk=100, seed=18)
    rng = np.random.RandomState(18)
    mask = rng.rand(MASK_BATCH, N_POINTS) < 0.5
    mask[:, 0] = False
    mask[1] = False
    mask[1, 1 + rng.choice(N_POINTS // 2 - 1, MASK_FEW, replace=False)] = True
    mask[2] = False
    batch["pcds"]["mask"] = mask
    return batch


def masked_act(dev) -> dict:
    """Phase 18 (c): ``ACTPCD(use_mask=True)`` at the flagship's widths,
    ``bg_ratio`` 0 and 0.25, on :func:`masked_clouds`: kernel 1 index-exact
    against its plain version on the foreground and background masks (the
    seed at index 0 outside the mask, the few-point cloud repeating, the
    empty one all 0); ``predict`` f32 at B=4 and a ``"bf16-mixed"`` step;
    their launches."""
    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch import entry, ops
    from pointcloudmatters_tpu_torch.models.bc_module import BCModule, to_device
    from pointcloudmatters_tpu_torch.trainer import Trainer

    t_part = time.perf_counter()
    batch = masked_clouds(dev)
    obs = {k: v for k, v in batch.items() if k not in ("actions", "is_pad")}
    coord = torch.from_numpy(batch["pcds"]["coord"]).to(dev)
    valid = torch.from_numpy(batch["pcds"]["valid"]).to(dev)
    fg = torch.from_numpy(batch["pcds"]["mask"]).to(dev)
    npoints = 2048
    paths, lines = {}, []
    for bg_ratio in (0.0, 0.25):
        tag = f"bg{int(bg_ratio * 100)}"
        n_bg = int(npoints * bg_ratio)
        idx = hold_fps(f"masked FPS fg {tag}", coord, (valid & fg).contiguous(), npoints - n_bg)
        if not ((idx[2] == 0).all() and len(set(idx[1].tolist())) <= MASK_FEW + 1):
            raise AssertionError(f"masked FPS {tag}: the empty cloud gave {idx[2][:8]}, the "
                                 f"few-point one {len(set(idx[1].tolist()))} distinct indices")
        if n_bg:
            hold_fps(f"masked FPS bg {tag}", coord, (valid & ~fg).contiguous(), n_bg)
        module = BCModule(entry.build_flagship(use_mask=True, bg_ratio=bg_ratio, device=dev),
                          optimizer=FLAGSHIP_OPT, lr_scheduler=FLAGSHIP_SCHED)
        module.predict(obs)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        a_hat = module.predict(obs)
        torch.cuda.synchronize()
        predict_ms = (time.perf_counter() - t0) * 1e3
        fps_calls = 2 if n_bg else 1
        paths[f"masked_predict_{tag}"] = launches = ops.launch_counts()
        _only(launches, {"fps": fps_calls, "knn": 1, "attention_fwd": ENC_LAYERS},
              f"masked_predict_{tag}")
        if tuple(a_hat.shape) != (MASK_BATCH, 100, 7) or not torch.isfinite(a_hat).all():
            raise AssertionError(f"masked predict {tag}: {tuple(a_hat.shape)}")
        trainer = Trainer(precision="bf16-mixed", seed=0)
        trainer.setup(module, TOTAL_STEPS)
        dev_batch = to_device(batch, dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        loss = float(trainer.train_step(module, dev_batch)["loss"])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        paths[f"masked_train_{tag}"] = launches = ops.launch_counts()
        _only(launches, {"fps": fps_calls, "knn": 1, "attention_fwd_bf16": ENC_LAYERS,
                         "attention_bwd_bf16": ENC_LAYERS}, f"masked_train_{tag}")
        if not np.isfinite(loss):
            raise AssertionError(f"masked step {tag}: loss {loss}")
        lines.append(f"bg_ratio {bg_ratio}: FPS index-exact ({npoints - n_bg} foreground"
                     f"{f', {n_bg} background' if n_bg else ''}), predict B={MASK_BATCH} "
                     f"{predict_ms:.2f} ms, bf16 step (first) {step_ms:.2f} ms, loss {loss:.4g}")
        del module, trainer, dev_batch
        torch.cuda.empty_cache()
    log(f"phase18 (c) {card_line()}: use_mask ACTPCD over {N_POINTS} points, point 0 "
        f"background, a cloud of {MASK_FEW} foreground points, one of none: "
        + "; ".join(lines) + f"; part {time.perf_counter() - t_part:.1f} s")
    return paths


def _hold_values(what: str, got, ref) -> float:
    err = _max_err(got, ref)
    limit = LIB_TOL * max(1.0, ref.float().abs().max().item())
    if not err <= limit:
        raise AssertionError(f"{what} off by {err:.3e} > {limit:.3e}")
    return err


def _hold_index(what: str, got, ref) -> None:
    import torch

    if not torch.equal(got, ref):
        raise AssertionError(f"{what}: indices differ at {(got != ref).sum().item()} places")


def library_pointops(dev) -> dict:
    """Phase 18 (d): the library point ops at phase 3's shapes (B=4,
    N=10240, M=2048 FPS centres, k=16) and one packed batch of ragged
    clouds: the ops that reach kernels 1, 2, 12 and 13 (``interpolation``,
    ``knn_query_and_group``, the packed ``knn_query``, ``query_and_group``
    and FPS), under each ``PCM_KNN_IMPL``, index-exact and within LIB_TOL
    of their plain versions on the card; the ball queries (plain torch)
    run twice alike, their candidates within the radius and in order; two
    launches of ``attention_fusion_step`` bit-identical."""
    import torch

    from pointcloudmatters_tpu_torch import entry, ops
    from pointcloudmatters_tpu_torch.ops import pointops as P

    t_part = time.perf_counter()
    b = entry.build_batch(LIB_BATCH, n_points=N_POINTS, chunk=5, seed=18)
    xyz = torch.from_numpy(b["pcds"]["coord"]).to(dev)
    mask = torch.from_numpy(b["pcds"]["valid"]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(18)
    feat = torch.randn((LIB_BATCH, N_POINTS, 32), generator=gen, device=dev)
    centres = P.farthest_point_sampling_padded(xyz, mask, LIB_QUERIES)
    new_xyz = torch.gather(xyz, 1, centres.long()[..., None].expand(-1, -1, 3))
    ends = torch.tensor(LIB_OFFSETS, device=dev)
    counts = torch.diff(ends, prepend=ends.new_zeros(1))
    pxyz = torch.rand((LIB_OFFSETS[-1], 3), generator=gen, device=dev) * 0.4
    pfeat = torch.randn((LIB_OFFSETS[-1], 16), generator=gen, device=dev)
    new_ends = torch.cumsum(counts // 5, 0)

    def packed_and_padded():
        fps_idx = P.farthest_point_sampling(pxyz, ends, new_ends)
        pnew = pxyz[fps_idx.long()]
        return dict(
            interp=P.interpolation_padded(xyz, new_xyz, feat, mask, k=3),
            group=P.knn_query_and_group_padded(feat, xyz, mask, new_xyz, LIB_K, with_xyz=True),
            fps=fps_idx, knn=P.knn_query(LIB_K, pxyz, ends, pnew, new_ends),
            qg=P.query_and_group(LIB_K, pxyz, pnew, pfeat, None, ends, new_ends, dilation=1),
            pinterp=P.interpolation(pxyz, pnew, pfeat, ends, new_ends))

    paths, lines = {}, []
    for impl, name in ((None, "pointops_v3"), ("chunkskip", "pointops_chunkskip"),
                       ("baseline", "pointops_baseline")):
        with knn_impl(impl):
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            got = packed_and_padded()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            paths[name] = launches = ops.launch_counts()
            with plain_kernels():
                ref = packed_and_padded()
        kernel = {"pointops_v3": "knn"}.get(name, SELECTOR_KERNEL.get(impl))
        # v3 at N = 10240 takes kernel 2 on the padded clouds, and on the
        # packed ones (<= 8,607 points a cloud) too
        _only(launches, {"fps": 1, kernel: 5}, name)
        _hold_index(f"{name} packed FPS", got["fps"], ref["fps"])
        _hold_index(f"{name} knn_query_and_group idx", got["group"][1], ref["group"][1])
        _hold_index(f"{name} knn_query idx", got["knn"][0], ref["knn"][0])
        _hold_index(f"{name} query_and_group idx", got["qg"][1], ref["qg"][1])
        errs = [_hold_values(f"{name} interpolation", got["interp"], ref["interp"]),
                _hold_values(f"{name} knn_query_and_group", got["group"][0], ref["group"][0]),
                _hold_values(f"{name} knn_query dist", got["knn"][1], ref["knn"][1]),
                _hold_values(f"{name} query_and_group", got["qg"][0], ref["qg"][0]),
                _hold_values(f"{name} packed interpolation", got["pinterp"], ref["pinterp"])]
        lines.append(f"{name}: {ms:.2f} ms, worst {max(errs):.3e}, launches "
                     f"{ {k: n for k, n in launches.items() if n} }")

    ops.reset_launch_counts()
    radius = 0.02
    t0 = time.perf_counter()
    bi, bd = P.ball_query_padded(new_xyz, xyz, mask, LIB_K, radius)
    torch.cuda.synchronize()
    ball_ms = (time.perf_counter() - t0) * 1e3
    bi2, bd2 = P.ball_query_padded(new_xyz, xyz, mask, LIB_K, radius)
    rgen = lambda: torch.Generator(device=dev).manual_seed(3)  # noqa: E731
    ri, rd = P.random_ball_query_padded(rgen(), new_xyz, xyz, mask, LIB_K, radius)
    ri2, rd2 = P.random_ball_query_padded(rgen(), new_xyz, xyz, mask, LIB_K, radius)
    if not all(torch.equal(a, c) for a, c in ((bi, bi2), (bd, bd2), (ri, ri2), (rd, rd2))):
        raise AssertionError("ball queries differ between two runs")
    found = bi >= 0
    if not (bd[found] < radius ** 2).all() or not (bd.diff(dim=-1)[found[..., 1:]] >= 0).all():
        raise AssertionError("ball query: a candidate outside the radius or out of order")
    if any(ops.launch_counts().values()):
        raise AssertionError("the ball queries launched a kernel")
    idx = P.knn_query_padded(new_xyz, xyz, mask, LIB_K)[0].long()
    offs = (torch.arange(LIB_BATCH, device=dev) * N_POINTS)[:, None, None]
    tgt = (torch.arange(LIB_BATCH * LIB_QUERIES, device=dev)[:, None]
           .expand(-1, LIB_K).reshape(-1))
    ref_ = (idx + offs).reshape(-1) % (LIB_BATCH * LIB_QUERIES)
    value = torch.randn((LIB_BATCH * LIB_QUERIES, 8, 32), generator=gen, device=dev)
    weight = torch.randn((tgt.numel(), 8), generator=gen, device=dev)
    fused = [P.attention_fusion_step(weight, value, tgt, ref_) for _ in range(2)]
    if not torch.equal(fused[0], fused[1]):
        raise AssertionError("attention_fusion_step: two launches differ")
    fusion_ms = cuda_ms(lambda: P.attention_fusion_step(weight, value, tgt, ref_), 3)
    log(f"phase18 (d) {card_line()}: library point ops at B={LIB_BATCH}, N={N_POINTS}, "
        f"M={LIB_QUERIES}, k={LIB_K} and packed clouds {list(LIB_OFFSETS)}: "
        + "; ".join(lines) + f"; ball queries r={radius} {ball_ms:.2f} ms, "
        f"{found.float().mean().item():.3f} of slots filled, deterministic; "
        f"attention_fusion_step over {tgt.numel()} edges {fusion_ms:.3f} ms, two launches "
        f"bit-identical; part {time.perf_counter() - t_part:.1f} s")
    return paths


def _rates(optimizer) -> list:
    return [g["lr"] for g in optimizer.param_groups]


def groups_and_tfd(dev) -> dict:
    """Phase 18 (e): the flagship's bf16 steps with ``param_dicts`` (the
    backbone at 1e-5) under timm's ``CosineLRScheduler``, then on
    ``build_optimizer_v2`` with layer decay: each step's rate of each group
    equal to the CPU's, the groups' sizes alike, the launches;
    ``TransformerForDiffusion`` at its default width (12 layers of 768, 12
    heads), f32 forward and the loss's gradients card against CPU within
    TFD_CPU_TOL, and an AdamW step."""
    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch import entry, ops
    from pointcloudmatters_tpu_torch.models.bc_module import BCModule, to_device
    from pointcloudmatters_tpu_torch.models.components.diffusion_policy.diffusion import (
        transformer_for_diffusion as tfd,
    )
    from pointcloudmatters_tpu_torch.trainer import Trainer
    from pointcloudmatters_tpu_torch.utils import optimizer as topt
    from pointcloudmatters_tpu_torch.utils import scheduler as tsched

    t_part = time.perf_counter()
    sched = {"scheduler": {"type": "CosineLRScheduler", "warmup_t": 1,
                           "warmup_lr_init": 1e-6, "lr_min": 1e-6}}

    def grouped(device):
        return BCModule(entry.build_flagship(device=device), optimizer=FLAGSHIP_OPT,
                        lr_scheduler=sched, param_dicts=GROUPS)

    module, cpu = grouped(dev), grouped("cpu")
    trainer = Trainer(precision="bf16-mixed", seed=0)
    trainer.setup(module, GROUP_STEPS * 2)
    cpu.configure_optimizers(GROUP_STEPS * 2)
    sizes = [len(g["params"]) for g in module.optimizer.param_groups]
    if sizes != [len(g["params"]) for g in cpu.optimizer.param_groups]:
        raise AssertionError(f"param_dicts: group sizes {sizes} differ from the CPU's")
    batch = to_device(entry.build_batch(FIT_BATCH, n_points=N_POINTS, seed=18), dev)
    ops.reset_launch_counts()
    rates, losses = [], []
    for _ in range(GROUP_STEPS):
        losses.append(float(trainer.train_step(module, batch)["loss"]))
        cpu.optimizer.step()
        cpu.scheduler.step()
        rates.append(_rates(module.optimizer))
        if rates[-1] != _rates(cpu.optimizer):
            raise AssertionError(f"param_dicts: rates {rates[-1]} on the card, "
                                 f"{_rates(cpu.optimizer)} on the CPU")
    paths = {"groups_train": ops.launch_counts()}
    per_step = {"fps": GROUP_STEPS, "knn": GROUP_STEPS,
                "attention_fwd_bf16": GROUP_STEPS * ENC_LAYERS,
                "attention_bwd_bf16": GROUP_STEPS * ENC_LAYERS}
    _only(paths["groups_train"], per_step, "groups_train")
    v2 = {"type": "AdamW", "lr": 5e-5, "weight_decay": 0.05, "layer_decay": 0.75}
    module.optimizer, module.scheduler = topt.build_optimizer_v2(
        v2, module.policy, lr_schedule=tsched.cosine_lr_scheduler(5e-5, GROUP_STEPS * 2,
                                                                  warmup_t=1))
    cpu_opt, cpu_sched = topt.build_optimizer_v2(
        v2, cpu.policy, lr_schedule=tsched.cosine_lr_scheduler(5e-5, GROUP_STEPS * 2,
                                                               warmup_t=1))
    ops.reset_launch_counts()
    v2_rates = []
    for _ in range(GROUP_STEPS):
        losses.append(float(trainer.train_step(module, batch)["loss"]))
        cpu_opt.step()
        cpu_sched.step()
        v2_rates.append(_rates(module.optimizer))
        if v2_rates[-1] != _rates(cpu_opt):
            raise AssertionError("build_optimizer_v2: rates differ from the CPU's")
    paths["optimizer_v2_train"] = ops.launch_counts()
    _only(paths["optimizer_v2_train"], per_step, "optimizer_v2_train")
    if not np.isfinite(losses).all():
        raise AssertionError(f"grouped steps: losses {losses}")
    n_v2 = len(module.optimizer.param_groups)
    del module, cpu, trainer, batch
    torch.cuda.empty_cache()

    net = tfd.TransformerForDiffusion(input_dim=7, output_dim=7, horizon=16, n_obs_steps=2,
                                      cond_dim=64, p_drop_emb=0.0, p_drop_attn=0.0)
    entry.init_parameters(net, torch.Generator().manual_seed(18))
    gen = torch.Generator().manual_seed(19)
    sample, cond = torch.randn(TFD_BATCH, 16, 7, generator=gen), torch.randn(
        TFD_BATCH, 2, 64, generator=gen)
    t = torch.randint(0, 100, (TFD_BATCH,), generator=gen)
    card = tfd.TransformerForDiffusion(input_dim=7, output_dim=7, horizon=16, n_obs_steps=2,
                                       cond_dim=64, p_drop_emb=0.0, p_drop_attn=0.0).to(dev)
    card.load_state_dict(net.state_dict())
    ops.reset_launch_counts()
    out_cpu, out = net(sample, t, cond), card(sample.to(dev), t.to(dev), cond.to(dev))
    err = _max_err(out.cpu(), out_cpu)
    if not err <= TFD_CPU_TOL * max(1.0, out_cpu.abs().max().item()):
        raise AssertionError(f"TransformerForDiffusion card vs CPU: {err:.3e}")
    (out_cpu ** 2).mean().backward()
    (out ** 2).mean().backward()
    grad_err = 0.0
    for (n, p), q in zip(net.named_parameters(), card.parameters()):
        e = _max_err(q.grad.cpu(), p.grad)
        if not e <= TFD_CPU_TOL * max(1.0, p.grad.abs().max().item()):
            raise AssertionError(f"TransformerForDiffusion gradient {n}: {e:.3e}")
        grad_err = max(grad_err, e)
    opt = topt.build_optimizer({"type": "AdamW", "lr": 1e-4}, card)
    opt.step()
    torch.cuda.synchronize()
    fwd_ms = cuda_ms(lambda: card(sample.to(dev), t.to(dev), cond.to(dev)), 3)
    paths["tfd"] = ops.launch_counts()
    _only(paths["tfd"], {}, "tfd")
    if not all(torch.isfinite(p).all() for p in card.parameters()):
        raise AssertionError("TransformerForDiffusion: a non-finite parameter after a step")
    log(f"phase18 (e) {card_line()}: param_dicts {sizes} tensors by group under "
        f"CosineLRScheduler, rates by step {rates}; build_optimizer_v2 with layer decay "
        f"{n_v2} groups, rates by step (first 3 groups) {[r[:3] for r in v2_rates]}: all "
        f"equal to the CPU's; losses {[round(x, 4) for x in losses]}; "
        f"TransformerForDiffusion {sum(p.numel() for p in net.parameters())} parameters, "
        f"B={TFD_BATCH}: card vs CPU output {err:.3e}, worst gradient {grad_err:.3e}, "
        f"forward {fwd_ms:.2f} ms; part {time.perf_counter() - t_part:.1f} s")
    del card, net, opt
    torch.cuda.empty_cache()
    return paths


def phase18(dev) -> dict:
    """Phase 18: (a)-(e); the launches of its paths."""
    t_phase = time.perf_counter()
    paths = swa_fit(dev)
    paths.update(state_only_act(dev))
    paths.update(masked_act(dev))
    paths.update(library_pointops(dev))
    paths.update(groups_and_tfd(dev))
    log(f"phase 18 in {time.perf_counter() - t_phase:.1f} s")
    return paths


# ---------------------------------------------------------------------------
# phase 19: the reference's scripts on the port (RLBench preprocessing and the
# three generalization sweeps), a per-key image DP that does not pool, and a
# JAX SGD checkpoint converted and resumed
# ---------------------------------------------------------------------------

P19_EPISODES = {"train": 3, "val": 2}  # raw episodes preprocessed in (a)
P19_FRAMES = 8  # frames an episode
P19_TRAIN_BATCHES, P19_VAL_BATCHES = 2, 2  # (a): micro-steps of 8 (one optimizer step), held out
P19_EVAL_EPISODES, P19_SUCCESS_AT = 2, 3  # (b): episodes a command, the step that succeeds
P19_SWEEP_EPISODES = 2  # (c): rollout episodes a command
STANDARD_ENV_IDS = {"PickCube-v0", "LiftCube-v0", "StackCube-v0", "PegInsertionSide-v0",
                    "TurnFaucet-v0", "Hang-v0", "Pour-v0", "Fill-v0", "Excavate-v0"}
SWEEP_CAMERAS = 8  # a MultiView rig
# (d): two cameras, each through its own ResNet-18 without avg_pool (resizing
# to 64: a 2 x 2 x 512 map a camera, flattened), the UNet at half the
# shipped widths and 16 reverse steps, so that the CPU's answer fits the phase
UNPOOLED_CAMERAS = ("base_camera", "hand_camera")
UNPOOLED_BACKBONE = {"resnet_model": "resnet18", "avg_pool": False, "resize_to": 64}
UNPOOLED_UNET = {"down_dims": (256, 512, 1024), "num_inference_steps": 16}
UNPOOLED_BATCH = 8
# (f): (d)'s model at the shipped widths, on the card alone (the CPU could not
# run it within the phase): the configs' resize 256 and crop 224, so a 7 x 7 x
# 512 map a camera (25,088 features), the UNet at down_dims 512/1024/2048
# (FiLM linears of 100,501 inputs) and 100 reverse steps
UNPOOLED_FULL_BACKBONE = {"resnet_model": "resnet18", "avg_pool": False}
UNPOOLED_FULL_PARAMS = 3_147_992_839  # counted on the meta device
SGD_OPT = {"type": "SGD", "lr": 5e-3, "momentum": 0.9, "weight_decay": 1e-4}  # (e)
SGD_BATCH = 8
P19: dict = {}  # the phase's root, raw episodes and checkpoint
SWEEP: dict = {}  # (c)'s demos and dataset class
RLBENCH_KERNEL_CALLS["p19 (a)"] = RLBENCH_KERNEL_CALLS["(a)"]


def recorded_sweep(script: str, args: list[str], tmp: str) -> list[list[str]]:
    """The argument lists of every ``python`` call that the port's sweep
    script ``script`` makes with ``args``, under a stub ``python`` that
    records them (in ``tmp``)."""
    import shlex

    bindir = os.path.join(tmp, "stub_bin")
    os.makedirs(bindir, exist_ok=True)
    record = os.path.join(tmp, "record.txt")
    if os.path.exists(record):
        os.remove(record)
    stub = os.path.join(bindir, "python")
    with open(stub, "w") as f:
        f.write(f'#!/usr/bin/env bash\nprintf "%q " "$@" >> {record}\necho >> {record}\n')
    os.chmod(stub, 0o755)
    env = dict(os.environ, PATH=f"{bindir}:{os.environ['PATH']}")
    proc = subprocess.run(["bash", os.path.join(REPO, "pointcloudmatters_tpu_torch", "scripts",
                                                script), *args],
                          env=env, cwd=REPO, capture_output=True, text=True, timeout=60)
    if proc.returncode != 0 or not os.path.exists(record):
        raise AssertionError(f"{script}: exit {proc.returncode}, {proc.stderr[-2000:]}")
    with open(record) as f:
        return [shlex.split(line) for line in f.read().splitlines()]


def p19_root(root: str) -> None:
    P19.clear()
    P19["root"] = root


def preprocessed_rlbench(dev) -> dict:
    """Phase 19 (a): ``preprocess_rlbench.main`` against the fake ``rlbench``
    (``tools/fake_rlbench.py``: one 128 x 128 front camera, P19_FRAMES
    frames) with ``--text-encoder hash`` over P19_EPISODES raw episodes,
    then ``train.main`` on the episodes it wrote (``exp_rlbench_act_policy``,
    ``scratch_pointnet_pcd``, B=8 x 2, ``"bf16-mixed"``, one epoch of
    P19_TRAIN_BATCHES micro-steps, held-out ``val/loss``): the exact
    launches (#1, #2, bf16 #3/#4, f32 #3 in validation), and each kernel on
    the tensors the path gave it against its plain version
    (``rlbench_kernel_checks``). Returns the launches by path."""
    import numpy as np

    from pointcloudmatters_tpu_torch import preprocess_rlbench
    from tools import fake_rlbench

    sys.modules.setdefault("chip_smoke", sys.modules[__name__])  # the probe's module
    root = P19["root"]
    raw = P19["raw"] = fake_rlbench.write_raw(os.path.join(root, "raw"), (RLBENCH_TASK,),
                                              P19_EPISODES)
    saved = preprocess_rlbench.EPISODES
    preprocess_rlbench.EPISODES = dict(P19_EPISODES)
    t0 = time.perf_counter()
    try:
        with fake_rlbench.installed(side=RLBENCH_SIDE, frames=P19_FRAMES):
            preprocess_rlbench.main(["--task_names", RLBENCH_TASK, "--root", raw,
                                     "--save_root", os.path.join(root, "data"),
                                     "--text-encoder", "hash"])
    finally:
        preprocess_rlbench.EPISODES = saved
    seconds = time.perf_counter() - t0
    for stage, n in P19_EPISODES.items():
        folder = os.path.join(root, "data", stage, RLBENCH_TASK)
        names = sorted(os.listdir(folder))
        if names != sorted(f"ep{i}.npy" for i in range(n)):
            raise AssertionError(f"preprocess_rlbench wrote {names} for {stage}")
        episode = np.load(os.path.join(folder, "ep0.npy"), allow_pickle=True).item()
        frame = episode["demo"][0]
        if len(episode["demo"]) != P19_FRAMES or episode["task_goal"].shape != (512,) \
                or frame["front_point_cloud"].shape != (RLBENCH_SIDE, RLBENCH_SIDE, 3):
            raise AssertionError(f"preprocess_rlbench {stage}/ep0.npy: {len(episode['demo'])} "
                                 f"frames, goal {episode['task_goal'].shape}")
    cache = dict(np.load(os.path.join(root, "data", "clip_cache.npz")))
    if len(cache) != 3:  # episode i is in variation i % 3
        raise AssertionError(f"clip_cache.npz holds {len(cache)} descriptions, not 3")
    log(f"p19 (a) {card_line()}: preprocess_rlbench of {sum(P19_EPISODES.values())} episodes "
        f"of {P19_FRAMES} frames ({RLBENCH_SIDE} x {RLBENCH_SIDE} front camera) in "
        f"{seconds:.2f} s")
    argv = rlbench_argv(root, "p19_train") + [
        f"trainer.limit_train_batches={P19_TRAIN_BATCHES}", "trainer.accumulate_grad_batches=2",
        "trainer.max_epochs=1", "trainer.check_val_every_n_epoch=1",
        f"trainer.limit_val_batches={P19_VAL_BATCHES}"]
    want = {k: n * P19_TRAIN_BATCHES for k, n in ACT_KERNELS_A_STEP.items()}
    for k, n in EVAL_KERNELS_A_BATCH.items():
        want[k] = want.get(k, 0) + n * P19_VAL_BATCHES
    calls: dict = {}
    with recorded_kernel_calls(calls):
        launches, probe, last = _cli_run(argv, "preprocessed_rlbench_train", P19_TRAIN_BATCHES,
                                         want, "p19 (a)")
    if probe.trainer.precision != "bf16-mixed":
        raise AssertionError(f"p19 (a): precision {probe.trainer.precision}")
    P19["act_ckpt"] = last
    del probe
    EndState.runs.clear()
    rlbench_kernel_checks(dev, calls, "p19 (a)")
    return {"preprocessed_rlbench_train": launches}


def rlbench_camera_view(dev) -> dict:
    """Phase 19 (b): the first two commands of the port's RLBench sweep
    (``run_rlbench_camera_view.sh``, recorded under a stub ``python``: the
    front camera rotated 5 degrees about y, then about z) through
    ``test_rlbench_act.main`` on (a)'s checkpoint, with the fake ``rlbench``
    installed (``rlbench_utils.build_env_and_task`` and ``reset_task`` run
    as they are): the goals from (a)'s ``clip_cache.npz``, P19_EVAL_EPISODES
    held-out episodes each, success at step P19_SUCCESS_AT. The front
    camera must have received ``perturb_camera_matrix``'s matrix, the result
    file the command's line, and each prediction FPS, kNN and the f32
    attention forward. Returns the launches by path."""
    import tempfile

    import numpy as np

    from pointcloudmatters_tpu_torch import ops, test_rlbench_act
    from pointcloudmatters_tpu_torch.utils import rlbench_utils as RU
    from tools import fake_rlbench

    root, ckpt = P19["root"], P19["act_ckpt"]
    with tempfile.TemporaryDirectory() as tmp:
        commands = recorded_sweep("run_rlbench_camera_view.sh",
                                  ["scratch_pointnet_pcd", RLBENCH_TASK, ckpt], tmp)
    if len(commands) != 8 or {tuple(c[:2]) for c in commands} != {
            ("-m", "pointcloudmatters_tpu_torch.test_rlbench_act")}:
        raise AssertionError(f"run_rlbench_camera_view.sh: {len(commands)} commands")
    result_path = os.path.join(root, "camera_view_results")
    extra = [f"data.train.root={root}/data/train", f"data.val.root={root}/data/val",
             f"data.train.loop={RLBENCH_LOOP}", f"data_root={P19['raw']}/val", f"episodes_num={P19_EVAL_EPISODES}",
             f"max_steps={2 * P19_SUCCESS_AT}", f"result_path={result_path}",
             f"clip_cache_path={root}/data/clip_cache.npz", "data.num_workers=0",
             f"paths.log_dir={root}/logs", f"hydra.run.dir={root}/camera_view",
             "extras.print_config=false"]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for argv in commands[:2]:
        view = dict(a.split("=", 1) for a in argv[2:] if a.startswith("camera_view_test."))
        with fake_rlbench.installed(side=RLBENCH_SIDE, frames=P19_FRAMES,
                                    success_at=P19_SUCCESS_AT) as fake:
            metrics = test_rlbench_act.main(argv[2:] + extra)
            matrices = list(fake.RECORD["camera_matrices"])
        want = RU.perturb_camera_matrix(fake_rlbench.FRONT_MATRIX,
                                        float(view["camera_view_test.rot_angle"]),
                                        view["camera_view_test.rot_axis"], [0, 0, 0])
        if metrics != {"success_rate": 1.0} or len(matrices) != 1 \
                or not np.array_equal(matrices[0], want):
            raise AssertionError(f"p19 (b) {view}: {metrics}, camera matrices {matrices}")
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    with open(os.path.join(result_path, "test_result.txt")) as f:
        lines = f.read().splitlines()
    if lines != ["scratch_pointnet_pcd_y_5: 1.0", "scratch_pointnet_pcd_z_5: 1.0"]:
        raise AssertionError(f"p19 (b): result file {lines}")
    predictions = 2 * P19_EVAL_EPISODES * P19_SUCCESS_AT
    _only(launches, {k: n * predictions for k, n in EVAL_KERNELS_A_BATCH.items()},
          "rlbench_camera_view")
    log(f"p19 (b) {card_line()}: run_rlbench_camera_view.sh's first two commands (rotations "
        f"of 5 degrees about y and z) through test_rlbench_act.main: the front camera "
        f"perturbed, success 1.0 each, {predictions} predictions at B=1 in {seconds:.2f} s "
        f"(composition, restore and episodes); result lines {lines}")
    return {"rlbench_camera_view": launches}


class SweepEnv(RolloutEnv):
    """(c)'s env: RolloutEnv's cloud on camera ``camera`` of SWEEP_CAMERAS
    and every other camera's points invalid (w = 0), so that a cloud
    reaches the policy only through the swept camera id."""

    def __init__(self, camera: int):
        self.camera = camera
        self.successes = 0

    def obs(self):
        import numpy as np

        obs = super().obs()
        pc = obs["pointcloud"]
        n = len(pc["xyzw"])
        xyzw = np.zeros((SWEEP_CAMERAS * n, 4), np.float32)
        xyzw[self.camera * n:(self.camera + 1) * n] = pc["xyzw"]
        pc["xyzw"], pc["rgb"] = xyzw, np.tile(pc["rgb"], (SWEEP_CAMERAS, 1))
        return obs

    def step(self, action):
        out = super().step(action)
        self.successes += bool(out[4]["success"])
        return out


def sweep_train_set(dataset_file=None, cache_dir=None, loop=None, **kw):
    """``data.train``'s target in (c): the composition's ManiSkill2 dataset
    class (SWEEP["dataset"]) over synthetic demos of SWEEP_CAMERAS cameras,
    FIT_LOOP times, with the config's other keys; the data config's
    transforms where the composition lost them (StackCube's NullGoal task,
    ROADMAP.md §3)."""
    kw.setdefault("transform_pcd", fit_transforms())
    return in_memory_dataset(SWEEP["demos"], SWEEP["dataset"], cache_dir=SWEEP["cache"],
                             loop=FIT_LOOP, **kw)


@contextlib.contextmanager
def recorded_gym_make(made: list, camera: int):
    """``gymnasium`` and ``mani_skill2.envs`` as stub modules inside (the
    card's machine has neither): ``make_maniskill2_env``'s ``gym.make``
    records (env_id, keywords) in ``made`` and returns a SweepEnv of
    ``camera``."""
    import types

    import pointcloudmatters_tpu_torch.envs.custom_maniskill2  # noqa: F401  (before the stubs)

    gym, ms2, ms2_envs = (types.ModuleType(n) for n in ("gymnasium", "mani_skill2",
                                                         "mani_skill2.envs"))
    gym.make = lambda env_id, **kw: made.append((env_id, kw, SweepEnv(camera))) or made[-1][2]
    ms2.envs = ms2_envs
    saved = {n: sys.modules.get(n) for n in ("gymnasium", "mani_skill2", "mani_skill2.envs")}
    sys.modules.update({"gymnasium": gym, "mani_skill2": ms2, "mani_skill2.envs": ms2_envs})
    try:
        yield made
    finally:
        for name, module in saved.items():
            if module is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module


def maniskill2_sweeps(dev) -> dict:
    """Phase 19 (c): each ManiSkill2 sweep script of the port run under a
    stub ``python`` (``run_maniskill2_camera_view.sh`` on PickCube-v0 and
    ``run_maniskill2_visual_changes.sh``, ``scratch_pointnet_pcd``), its
    env ids checked against ``iter_env_ids()`` (and ManiSkill2's own); then
    one recorded command of each through ``validate.main`` in-process (the
    camera view's first, camera id 4 of PickCube-MultiView; the visual
    changes' first ray-tracing one: StackCube-v0, ``shader_dir=rt``, 2
    samples a pixel, no denoiser), on a weights-only checkpoint of the composition's
    seeded flagship, over synthetic demos of SWEEP_CAMERAS cameras, with
    ``make_maniskill2_env``'s ``gym.make`` recording into a SweepEnv of the
    command's camera: ``env_id``, ``shader_dir``, ``rt_samples_per_pixel``
    and ``rt_use_denoiser`` reached it, every prediction's cloud came from
    the swept camera, P19_SWEEP_EPISODES rollouts of ROLLOUT_STEPS steps,
    each prediction FPS, kNN and the f32 attention forward. The visual
    changes' commands name StackCube's point-cloud task, whose composition
    keeps only the task's own keys of ``data.train`` in both packages
    (ROADMAP.md §3): the phase adds back the data config's ``chunk_size``
    (100) and transforms. Returns the launches by path."""
    import tempfile

    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch import train as train_entry
    from pointcloudmatters_tpu_torch import validate as validate_entry
    from pointcloudmatters_tpu_torch.envs.custom_maniskill2 import iter_env_ids
    from pointcloudmatters_tpu_torch.trainer import Trainer

    sys.modules.setdefault("chip_smoke", sys.modules[__name__])  # the dataset's module
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    demos = synthetic_demos(2, 10, FIT_CAM_SIDE)
    for demo in demos:
        pc = demo["obs"]["pointcloud"]
        pc["xyzw"], pc["rgb"] = _tile_cameras(pc["xyzw"]), _tile_cameras(pc["rgb"])
    SWEEP.update(demos=demos, cache=os.path.join(root, "cache"))
    registered = set(iter_env_ids()) | STANDARD_ENV_IDS
    runs = {"sweep_camera_view": ("run_maniskill2_camera_view.sh",
                                  ["PickCube-v0", "scratch_pointnet_pcd", "0"], 0),
            "sweep_visual_changes": ("run_maniskill2_visual_changes.sh",
                                     ["scratch_pointnet_pcd", "0"], 6)}
    paths = {}
    for path, (script, args, pick) in runs.items():
        ckpt = os.path.join(root, f"{path}_ckpt")
        commands = recorded_sweep(script, [ckpt, *args], os.path.join(root, path))
        ids = {a.split("=", 1)[1] for c in commands for a in c if a.startswith("model.env_id=")}
        if not ids or ids - registered:
            raise AssertionError(f"{script}: env ids {sorted(ids - registered)} not registered")
        entry, argv = commands[pick][:2], commands[pick][2:]
        given = dict(a.split("=", 1) for a in argv if "@" not in a.split("=", 1)[0])
        if entry != ["-m", "pointcloudmatters_tpu_torch.validate"]:
            raise AssertionError(f"{script}: entry point {entry}")
        camera = int(given.get("data.train.camera_ids", "[0]").strip("[]"))
        extra = ["data.train._target_=chip_smoke.sweep_train_set", "data.num_workers=0",
                 f"trainer.limit_val_batches={P19_SWEEP_EPISODES}", "logger=csv",
                 f"paths.log_dir={root}/logs", f"hydra.run.dir={root}/{path}_run",
                 "extras.print_config=false"]
        if "StackCube" in given["model.env_id"]:  # the NullGoal task dropped the data config's
            extra.append("data.train.chunk_size=100")
        composed = train_entry.compose_run(argv + extra[1:], output_dir=os.path.join(
            root, f"{path}_composed"))
        SWEEP["dataset"] = composed.data.train._target_.rsplit(".", 1)[1]
        module = train_entry.instantiate_model(composed)
        trainer = Trainer(default_root_dir=os.path.join(root, f"{path}_save"), seed=0,
                          accumulate_grad_batches=composed.trainer.accumulate_grad_batches)
        trainer.setup(module, 1)
        trainer.save_checkpoint(ckpt, weights_only=True)  # the module's streams are the CPU's
        del module, trainer
        made: list = []
        calls: dict = {}
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with recorded_gym_make(made, camera), recorded_kernel_calls(calls):
            metrics = validate_entry.main(argv + extra)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        paths[path] = launches = ops.launch_counts()
        env_id, kw, env = made[0] if len(made) == 1 else (None, {}, None)
        render = kw.get("render_config", {})
        want = {"env_id": given["model.env_id"], "shader_dir": given.get("model.shader_dir", "ibl"),
                "rt_samples_per_pixel": int(given.get("model.rt_samples_per_pixel", 32)),
                "rt_use_denoiser": given.get("model.rt_use_denoiser", "true") == "true"}
        got = {"env_id": env_id, "shader_dir": kw.get("shader_dir"),
               "rt_samples_per_pixel": render.get("rt_samples_per_pixel"),
               "rt_use_denoiser": render.get("rt_use_denoiser")}
        if got != want:
            raise AssertionError(f"{path}: gym.make got {got}, want {want} ({len(made)} envs)")
        (xyz, mask, _), _ = calls["fps"]
        valid = int(mask.sum())
        if not valid:
            raise AssertionError(f"{path}: the first request's cloud is empty (camera "
                                 f"{camera} did not reach the observation)")
        _only(launches, {k: n * P19_SWEEP_EPISODES * ROLLOUT_STEPS
                         for k, n in EVAL_KERNELS_A_BATCH.items()}, path)
        if metrics.get("val/mean_success") != env.successes / P19_SWEEP_EPISODES:
            raise AssertionError(f"{path}: validation metrics {metrics}, {env.successes} of "
                                 f"{P19_SWEEP_EPISODES} rollouts succeeded")
        log(f"p19 (c) {card_line()}: {script} ({len(commands)} commands, {len(ids)} env ids, "
            f"all registered); command {pick + 1} ({' '.join(a for a in argv if a.startswith(('model.', 'data.train.camera')))}) "
            f"through validate.main in {seconds:.2f} s: gym.make({env_id!r}, {kw}); "
            f"{P19_SWEEP_EPISODES} rollouts, {valid} valid points from camera {camera} in the "
            f"first request, {metrics}")
    tmp.cleanup()
    SWEEP.clear()
    torch.cuda.empty_cache()
    return paths


def _tile_cameras(a):
    """A camera's (frames, n, c) array as SWEEP_CAMERAS cameras of it."""
    import numpy as np

    return np.concatenate([a] * SWEEP_CAMERAS, axis=1)


@contextlib.contextmanager
def fixed_sampling_draws(seed: int):
    """The reverse chain's draws made on the CPU from ``seed`` (one
    generator a call, ``step`` folded in) and handed to every device, so
    that a chain on the card and one on the CPU take the same draws."""
    import torch

    from pointcloudmatters_tpu_torch.models.components.diffusion_policy import (
        diffusion_unet_image_policy as dp,
    )

    saved = dp.sampling_noise

    def draws(generator, shape, dtype, step):
        gen = torch.Generator().manual_seed(seed * 1000 + (0 if step is None else step + 1))
        return saved(gen, shape, dtype, step).to(generator.device)

    dp.sampling_noise = draws
    try:
        yield
    finally:
        dp.sampling_noise = saved


def unpooled_image_dp(dev) -> dict:
    """Phase 19 (d): the image DP with a ResNet-18 a camera that does not
    pool (``share_rgb_model`` false, ``avg_pool`` false; UNPOOLED_*: each
    camera's 2 x 2 x 512 map flattened into the condition, which sizes the
    UNet), seeded on the CPU and copied to the card: ``predict`` at B=1 in
    f32 against the CPU's from the same draws within IMAGE_DP_CPU_TOL of
    max(1, max|CPU|); one ``"bf16-mixed"`` step at B=UNPOOLED_BATCH on each
    from the same draws, the losses within BF16_TOL relative, finite, and
    the card's parameters moved. No kernel of #1-#13 runs on this path (the
    image DP's layers are convolutions and linears, as in JAX). Returns the
    launches by path."""
    import copy

    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch.entry import (
        build_image_dp_batch,
        build_image_dp_policy,
        image_dp_shape_meta,
    )
    from pointcloudmatters_tpu_torch.models.bc_module import to_device
    from pointcloudmatters_tpu_torch.trainer import Trainer
    from pointcloudmatters_tpu_torch.utils.normalizer import SingleFieldLinearNormalizer

    normalizer = dp_normalizer()
    for key in image_dp_shape_meta(3, UNPOOLED_CAMERAS)["obs"]:
        if key != "qpos":
            normalizer[key] = SingleFieldLinearNormalizer.create_identity()
    t0 = time.perf_counter()
    policy = build_image_dp_policy("resnet", 3, share_rgb_model=False, cameras=UNPOOLED_CAMERAS,
                                   backbone_kw=UNPOOLED_BACKBONE, normalizer=normalizer,
                                   device="cpu", **UNPOOLED_UNET)
    encoder = policy.obs_encoder
    width = len(UNPOOLED_CAMERAS) * 2 * 2 * 512 + 9
    if encoder.feature_dim != width or policy.global_cond_dim != width * 2 + 3:
        raise AssertionError(f"unpooled DP: {encoder.feature_dim} features a frame, condition "
                             f"{policy.global_cond_dim}")
    cpu, card = image_dp_task(policy), image_dp_task(copy.deepcopy(policy).to(dev))
    n_params = sum(p.numel() for p in policy.parameters())
    seeded = {k: v.clone() for k, v in policy.state_dict().items()}
    request = build_image_dp_batch(1, IMAGE_SIDE, 3, UNPOOLED_CAMERAS, seed=1,
                                   with_actions=False)
    with fixed_sampling_draws(3):
        ref = cpu.predict(request, torch.Generator().manual_seed(0))
        card.predict(request, torch.Generator(device=dev).manual_seed(0))  # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        got = card.predict(request, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        predict_ms = (time.perf_counter() - t1) * 1e3
    paths = {"unpooled_dp_predict": ops.launch_counts()}
    _only(paths["unpooled_dp_predict"], {}, "unpooled dp predict")
    err, scale = (got.float().cpu() - ref.float()).abs().max().item(), ref.abs().max().item()
    if not (tuple(got.shape) == (1, 8, 7) and err <= IMAGE_DP_CPU_TOL * max(1.0, scale)):
        raise AssertionError(f"unpooled dp predict card vs CPU: {tuple(got.shape)}, {err:.3e} "
                             f"> {IMAGE_DP_CPU_TOL} x max(1, {scale:.3e})")
    batch = build_image_dp_batch(UNPOOLED_BATCH, IMAGE_SIDE, 3, UNPOOLED_CAMERAS, seed=2)
    losses = {}
    for name, module in (("cpu", cpu), ("card", card)):
        trainer = Trainer(precision="bf16-mixed", seed=0,
                          accelerator="cpu" if name == "cpu" else "auto")
        trainer.setup(module, TOTAL_STEPS)
        ops.reset_launch_counts()
        with fixed_dp_draws(5):
            t1 = time.perf_counter()
            losses[name] = float(trainer.train_step(
                module, to_device(batch, module.device))["loss"])
            if name == "card":
                torch.cuda.synchronize()
                step_ms = (time.perf_counter() - t1) * 1e3
                paths["unpooled_dp_train"] = ops.launch_counts()
    _only(paths["unpooled_dp_train"], {}, "unpooled dp bf16 step")
    moved = sum(not torch.equal(seeded[n].to(dev), p) for n, p in card.policy.named_parameters())
    rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    if not (np.isfinite(list(losses.values())).all() and rel <= BF16_TOL
            and moved > len(seeded) // 2):
        raise AssertionError(f"unpooled dp bf16 step: losses {losses} ({rel:.3e} relative), "
                             f"{moved} parameters moved")
    log(f"p19 (d) {card_line()}: image DP, a ResNet-18 a camera without avg_pool "
        f"({len(UNPOOLED_CAMERAS)} cameras, {encoder.feature_dim} features a frame, condition "
        f"{policy.global_cond_dim}, {n_params} parameters): predict B=1 ({UNPOOLED_UNET['num_inference_steps']} "
        f"steps) {predict_ms:.2f} ms, card vs CPU {err:.3e} of max(1, {scale:.3e}); bf16 step "
        f"B={UNPOOLED_BATCH} {step_ms:.2f} ms (first step), loss card {losses['card']:.6f} vs "
        f"CPU {losses['cpu']:.6f} ({rel:.3e} relative); no kernel of #1-#13 launched; "
        f"{time.perf_counter() - t0:.1f} s in all")
    del cpu, card, policy
    torch.cuda.empty_cache()
    return paths


def unpooled_image_dp_full(dev) -> dict:
    """Phase 19 (f): (d)'s model at the shipped widths (UNPOOLED_FULL_*:
    ResNet-18 a camera without ``avg_pool`` at the configs' resize 256 /
    crop 224, the UNet at 512/1024/2048, 100 reverse steps; 3.15 billion
    parameters, most of them in the FiLM linears of the 100,373-wide
    condition), built and drawn on the card (``init_device``): ``predict``
    at B=1 after a warm-up, finite (1, 8, 7) actions; two ``"bf16-mixed"``
    steps at B=UNPOOLED_BATCH under the configs' AdamW + OneCycleLR, finite
    losses, every parameter finite and most of them moved; the peak memory
    after each. No kernel of #1-#13 runs on this path. Returns the launches
    by path."""
    import gc
    import math

    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch.entry import build_image_dp_batch, build_image_dp_policy
    from pointcloudmatters_tpu_torch.models.bc_module import to_device
    from pointcloudmatters_tpu_torch.trainer import Trainer
    from pointcloudmatters_tpu_torch.utils.normalizer import SingleFieldLinearNormalizer

    gib = 2 ** 30
    gc.collect()  # the earlier phases' tensors that only cycles still hold
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    normalizer = dp_normalizer()
    for key in ("base_camera_rgb", "hand_camera_rgb"):
        normalizer[key] = SingleFieldLinearNormalizer.create_identity()
    t0 = time.perf_counter()
    policy = build_image_dp_policy("resnet", 3, share_rgb_model=False, cameras=UNPOOLED_CAMERAS,
                                   backbone_kw=UNPOOLED_FULL_BACKBONE, normalizer=normalizer,
                                   device=dev, init_device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    encoder = policy.obs_encoder
    n_params = sum(p.numel() for p in policy.parameters())
    width = len(UNPOOLED_CAMERAS) * 7 * 7 * 512 + 9
    if (encoder.feature_dim, policy.global_cond_dim, n_params) != (
            width, width * 2 + 3, UNPOOLED_FULL_PARAMS):
        raise AssertionError(f"full-width unpooled DP: {encoder.feature_dim} features a frame, "
                             f"condition {policy.global_cond_dim}, {n_params} parameters")
    peaks = {"build": torch.cuda.max_memory_allocated() / gib}
    task = image_dp_task(policy)
    request = build_image_dp_batch(1, IMAGE_SIDE, 3, UNPOOLED_CAMERAS, seed=1,
                                   with_actions=False)
    task.predict(request, torch.Generator(device=dev).manual_seed(0))  # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    actions = task.predict(request, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    predict_ms = (time.perf_counter() - t1) * 1e3
    paths = {"unpooled_full_predict": ops.launch_counts()}
    _only(paths["unpooled_full_predict"], {}, "full-width unpooled dp predict")
    if tuple(actions.shape) != (1, 8, 7) or not torch.isfinite(actions).all():
        raise AssertionError(f"full-width unpooled dp predict: {tuple(actions.shape)}, "
                             f"finite {bool(torch.isfinite(actions).all())}")
    peaks["predict"] = torch.cuda.max_memory_allocated() / gib
    del actions, request
    sums = [p.detach().double().sum() for p in policy.parameters()]
    batch = to_device(build_image_dp_batch(UNPOOLED_BATCH, IMAGE_SIDE, 3, UNPOOLED_CAMERAS,
                                           seed=2), task.device)
    trainer = Trainer(precision="bf16-mixed", seed=0)
    trainer.setup(task, TOTAL_STEPS)
    ops.reset_launch_counts()
    losses, step_ms = [], []
    for _ in range(2):
        t1 = time.perf_counter()
        losses.append(float(trainer.train_step(task, batch)["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    paths["unpooled_full_train"] = ops.launch_counts()
    _only(paths["unpooled_full_train"], {}, "full-width unpooled dp bf16 step")
    peaks["train"] = torch.cuda.max_memory_allocated() / gib
    params = list(policy.parameters())
    moved = sum(not torch.equal(p.detach().double().sum(), s) for p, s in zip(params, sums))
    finite = all(bool(torch.isfinite(p).all()) for p in params)
    if not (all(map(math.isfinite, losses)) and finite and moved > len(params) // 2):
        raise AssertionError(f"full-width unpooled dp bf16 steps: losses {losses}, parameters "
                             f"finite {finite}, {moved} of {len(params)} moved")
    total = torch.cuda.get_device_properties(dev).total_memory / gib
    log(f"p19 (f) {card_line()}: image DP at the shipped widths, a ResNet-18 a camera without "
        f"avg_pool ({len(UNPOOLED_CAMERAS)} cameras at 224 px, {encoder.feature_dim} features "
        f"a frame, condition {policy.global_cond_dim}, {n_params} parameters, built on the "
        f"card in {build_s:.2f} s): predict B=1 (100 steps) {predict_ms:.2f} ms, finite; bf16 "
        f"steps B={UNPOOLED_BATCH} {step_ms[0]:.2f} ms (first) and {step_ms[1]:.2f} ms, "
        f"losses {losses[0]:.6f}, {losses[1]:.6f}, {moved} of {len(params)} parameters moved; "
        f"peak allocated after build / predict / steps {peaks['build']:.2f} / "
        f"{peaks['predict']:.2f} / {peaks['train']:.2f} GiB of {total:.2f} (the phase started "
        f"at {before / gib:.2f}); no kernel of #1-#13 launched; "
        f"{time.perf_counter() - t0:.1f} s in all")
    del task, policy, trainer, batch, params, sums
    torch.cuda.empty_cache()
    return paths


def sgd_round_trip(dev) -> dict:
    """Phase 19 (e): the flagship (seeded) on SGD_OPT (momentum 0.9,
    Nesterov off, coupled decay) under the flagship's OneCycleLR, two
    ``"bf16-mixed"`` steps at B=SGD_BATCH on the card; its state written in
    the form a JAX checkpoint restored without a template has
    (``torch_to_flax``: the parameters, the batch statistics, and the
    optimizer state as JAX's SGD chain holds it, ``[{}, {"trace": ...},
    {"count": 2}]``), converted by ``jax_checkpoint_to_torch`` into a
    flagship of other seeded weights and resumed on the card: every tensor
    bit-equal to the source's; then one more step's gradients (one
    forward/backward of the source) applied by both optimizers, the
    parameters and momentum buffers after it bit-equal. Returns the
    launches by path."""
    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch.entry import build_batch, build_flagship
    from pointcloudmatters_tpu_torch.models.bc_module import BCModule, to_device
    from pointcloudmatters_tpu_torch.trainer import Trainer
    from pointcloudmatters_tpu_torch.utils.flax_to_torch import jax_checkpoint_to_torch
    from tools.jax_form import torch_to_flax

    t0 = time.perf_counter()
    batch = to_device(build_batch(batch_size=SGD_BATCH, n_points=N_POINTS), dev)
    source = BCModule(build_flagship(seed=0, device=dev), optimizer=SGD_OPT,
                      lr_scheduler=FLAGSHIP_SCHED)
    trainer = Trainer(precision="bf16-mixed", seed=0)
    trainer.setup(source, TOTAL_STEPS)
    ops.reset_launch_counts()
    for _ in range(2):
        trainer.train_step(source, batch)
    policy = source.policy
    names = [n for n, _ in policy.named_parameters()]
    state = source.optimizer.state_dict()["state"]
    buffers = {n: state[i]["momentum_buffer"] for i, n in enumerate(names)}
    variables = torch_to_flax(policy)
    restored = {"params": variables["params"], "batch_stats": variables["batch_stats"],
                "step": np.asarray(2), "epoch": np.asarray(0),
                "opt_state": [{}, {"trace": torch_to_flax(policy, buffers)},
                              {"count": np.asarray(2, np.int32)}]}
    resumed = BCModule(build_flagship(seed=1, device=dev), optimizer=SGD_OPT,
                       lr_scheduler=FLAGSHIP_SCHED)
    Trainer(precision="bf16-mixed", seed=0).setup(resumed, TOTAL_STEPS)
    ckpt = jax_checkpoint_to_torch(restored, resumed)
    resumed.policy.load_state_dict({**ckpt["params"], **ckpt["batch_stats"]}, strict=True)
    resumed.optimizer.load_state_dict(ckpt["opt_state"]["optimizer"])
    resumed.scheduler.load_state_dict(ckpt["opt_state"]["scheduler"])
    differ = [k for k, v in policy.state_dict().items()
              if not torch.equal(v, resumed.policy.state_dict()[k])]
    differ += [n for i, n in enumerate(names) if not torch.equal(
        buffers[n], resumed.optimizer.state_dict()["state"][i]["momentum_buffer"])]
    if differ or resumed.scheduler.last_epoch != 2:
        raise AssertionError(f"sgd round trip: {len(differ)} tensors differ after the "
                             f"conversion ({differ[:3]}), schedule at "
                             f"{resumed.scheduler.last_epoch}")
    source.optimizer.zero_grad(set_to_none=False)
    out = source.forward_train(batch, trainer.rngs, trainer.compute_dtype)
    out["loss"].to(torch.float32).backward()
    for p, q in zip(policy.parameters(), resumed.policy.parameters()):
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        q.grad = p.grad.clone()
    for module in (source, resumed):
        module.optimizer.step()
        module.scheduler.step()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    _only(launches, {k: 3 * n for k, n in ACT_KERNELS_A_STEP.items()}, "sgd_round_trip")
    after = resumed.optimizer.state_dict()["state"]
    differ = [n for (n, p), q in zip(policy.named_parameters(), resumed.policy.parameters())
              if not torch.equal(p, q)]
    differ += [n for i, n in enumerate(names) if not torch.equal(
        source.optimizer.state_dict()["state"][i]["momentum_buffer"],
        after[i]["momentum_buffer"])]
    if differ:
        raise AssertionError(f"sgd round trip: the resumed step differs at {differ[:5]}")
    log(f"p19 (e) {card_line()}: flagship on SGD (momentum 0.9, coupled decay, OneCycleLR), "
        f"2 bf16 steps at B={SGD_BATCH}, written in JAX's form and converted: "
        f"{len(policy.state_dict())} tensors and {len(names)} momentum buffers bit-equal; "
        f"the next step bit-equal to the source's; {time.perf_counter() - t0:.1f} s")
    del source, resumed, trainer, batch
    torch.cuda.empty_cache()
    return {"sgd_round_trip": launches}


def phase19(dev) -> dict:
    """Phase 19: (a)-(e); the launches of its paths."""
    import tempfile

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    p19_root(tmp.name)
    paths = {}
    for tag, part in zip("abcdef", (preprocessed_rlbench, rlbench_camera_view,
                                    maniskill2_sweeps, unpooled_image_dp, sgd_round_trip,
                                    unpooled_image_dp_full)):
        t0 = time.perf_counter()
        paths.update(part(dev))
        PHASE_SECONDS[f"19 ({tag})"] = round(time.perf_counter() - t0, 1)
        log(f"phase 19 {part.__name__}: {PHASE_SECONDS[f'19 ({tag})']:.1f} s")
    tmp.cleanup()
    P19.clear()
    log(f"phase 19 in {time.perf_counter() - t_phase:.1f} s")
    return paths


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from pointcloudmatters_tpu_torch import _build

    log(card_line())  # name, power limit
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    t_main = time.perf_counter()
    logs = timed("2 build", _build.build)
    log(f"built {sorted(logs) or 'nothing (cached)'} in {PHASE_SECONDS['2 build']:.1f} s")
    usage = ptxas_usage(logs)
    for fn, u in sorted(usage.items()):
        log(f"  {fn}: {u.get('registers')} registers, stack frame {u.get('stack')} B, "
            f"spill stores {u.get('spill_stores')} B, loads {u.get('spill_loads')} B")
    ptxas = {name: {tag: next((u for fn, u in usage.items() if piece in fn), None)
                    for tag, piece in pieces.items()}
             for name, pieces in PTXAS_FUNCTIONS.items()}
    # only a build of every library prints every kernel's usage
    full_build = set(logs) == set(_build.KERNELS)
    if full_build and not all(all(ptxas[name].values()) for name in ptxas):
        raise AssertionError(f"ptxas reported no usage for a tensor-core kernel: {ptxas}")

    with knn_impl(None):  # phases 3-8 on the default kNN route, whatever the caller set
        res = timed("3 kernels", check_kernels, dev)
        if full_build:  # a build that found libraries cached prints no record of theirs
            for name, record in ptxas.items():
                res[name]["ptxas"] = record
        torch.cuda.empty_cache()  # the serving phase starts from an empty pool, as before
        paths = {"predict": timed("4 predict", serve, dev),
                 "train_step": timed("5 train", train, dev)}
        paths.update(timed("6 bf16", train_bf16, dev))
        paths["predict_fused"] = timed("7 predict fused", serve, dev, "fused")
        paths.update(timed("7 train fused", train_fused, dev))
        paths["predict_flash"] = timed("8 predict flash", serve, dev, "flash")
        paths.update(timed("8 train flash", train_flash, dev))
    torch.cuda.empty_cache()
    selector_paths = timed("9 selectors", serve_selectors, dev)
    paths.update(selector_paths)
    with knn_impl(None):
        fit_paths, fit_times = timed("10 fit", fit_flagship, dev)
        paths.update(fit_paths)
        paths.update(timed("11 train_cli", train_cli, dev, fit_times))
        paths.update(timed("12 ddp", train_ddp, dev))
        dp_paths, dp_cases = timed("13 dp", train_dp, dev)
        paths.update(dp_paths)
        for name, found in dp_cases.items():
            res[name]["dp_cases"] = found
        spunet_paths, _ = timed("14 spunet", train_spunet, dev)
        paths.update(spunet_paths)
        image_paths, _ = timed("15 images", train_images, dev)
        paths.update(image_paths)
        image_dp_paths, _ = timed("16 image dp", train_image_dp, dev)
        paths.update(image_dp_paths)
        paths.update(timed("17 rlbench", train_rlbench, dev))
        paths.update(timed("18", phase18, dev))
        paths.update(timed("19", phase19, dev))
    stray = {path: [k for k in FLASH_KERNELS if counts[k]] for path, counts in paths.items()
             if "flash" not in path and any(counts[k] for k in FLASH_KERNELS)}
    if stray:
        raise AssertionError(f"flash kernels launched off the flash paths: {stray}")
    stray = {path: [k for k in SELECTOR_KERNEL.values() if counts[k]]
             for path, counts in paths.items()
             if path not in selector_paths and path not in PHASE18_SELECTOR_PATHS
             and any(counts[k] for k in SELECTOR_KERNEL.values())}
    if stray:
        raise AssertionError(f"kernels 12/13 launched off the selector paths: {stray}")

    kernels = [
        dict(name=name, route="cuda", source=src, replaces=tpu,
             launches=sum(counts[name] for counts in paths.values()),
             launches_by_path={path: counts[name] for path, counts in paths.items()},
             **res[name])
        for name, (src, tpu) in KERNELS.items()
    ]
    PHASE_SECONDS["all"] = round(time.perf_counter() - t_main, 1)
    print(json.dumps({"phase_seconds": PHASE_SECONDS}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
