"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # full run (one card, ~minutes)
    python3 chip_smoke.py --quick    # build + kernel checks (to V2)
    python3 chip_smoke.py --moe      # build + the moe phases (M1-M5)
    python3 chip_smoke.py --hybrid   # build + the hybrid phases (H1-H5)
    python3 chip_smoke.py --encdec   # build + the encdec phases (E1-E5)
    python3 chip_smoke.py --shard    # build + cell sharding and ZeRO-1 (C1-Z2)
    python3 chip_smoke.py --tp       # build + tensor parallelism (DR1, TP1-TP8)

Drives only ``repro_torch`` (never jax, never the JAX package ``repro``):

1. card and environment (``nvidia-smi`` name and power limit, versions);
2. builds ``src/repro_torch/kernels/csrc/sim_step.cu``, ``ssd_scan.cu``,
   ``ckpt_quant.cu`` and ``flash_attention.cu`` with nvcc for sm_90a (one
   nvcc per source, started together) and prints the build seconds and
   the ``-Xptxas -v`` reports: registers, stack and spill bytes of each of
   sim_step's 32 kernels (16 flag variants x 2 draw routes); the
   variants the paths run (0000: Fig. 4, 0001: the fleet grid, 1000 and
   0010: the sweeps, 1100, 1010 and 1110: the workflow DAGs) must not
   spill;
L1. the port's static-contracts linter (``repro_torch.analysis``, the
   rules of ``python -m repro_torch.launch.reprolint``) over its default
   paths in this checkout: ``src/repro_torch``, ``tests/test_torch_*.py``,
   this script and ``tp_noise_probe.py``.  It prints a ``lint:`` line (files,
   gating findings, suppressions), and any gating finding fails the run;
3. sim_step against its plain torch version on the card: the kernel's own
   Philox generator against ``PhiloxDraws.at`` (every row, step0 0, 256
   and 2**32 - 3, seeds >= 2**32 and negative), then a mixed batch of
   4,096 cells with every static flag through both routes -- draws made in
   the kernel and pre-generated draws -- against the plain step fed
   ``PhiloxDraws.next``, two chunks from step 0 and again from just
   below 2**32 with seeds >= 2**32: every ``_State`` field and the steps
   per warp bitwise equal;
4. across devices: parity draws (the pre-generated route), kernel on the
   card against the plain version on the CPU -- counts exact, floats
   within 1e-9 relative;
G1. across devices, the per-peer estimator form: a mixed batch (gossip
   at fanout 1, 3 and 8 with k = 2, 8, 16 and 32, isolated, pooled, fixed,
   oracle, a heterogeneous mix, a shock, a store cell, a class-pooled cell;
   2 h of work a cell; macro-stepping on) through the plain step on the
   card against the CPU
   with parity draws -- counts exact, floats within 1e-9 relative, no
   sim_step launch; and the Philox per-peer observation rows made on the
   card against those made on the CPU, bit for bit;
S1. both ssd_scan kernels -- the tensor-core kernels (the route of bf16
   at these shapes) and the SIMT kernel -- against their plain torch
   version on the card at the serving shape (b 8, s 1024, h 24, p 64,
   n 128, Q 256, bf16 x/B/C) with a zero and a random initial state, at
   two chunks with a random state, at s < Q and s = Q, and at zamba2-7b's
   prefill shape (b 8, s 1024, h 112, p 64, n 64, Q 256) with a zero and
   a random initial state: y within 1e-2 (one bf16 rounding of y after
   float32 sums in another order), the final state within 1e-4;
S2. across devices: the mamba2 SMOKE config in float32, prefill and four
   teacher-forced decode steps, kernel on the card against the plain
   version on the CPU -- logits and caches within 1e-4; at a 32-token
   prompt (two chunks) and a 40-token one (zero-padded to three chunks
   for the kernel); these float32 prefills are the SIMT kernel's path
   (one launch per layer and prefill);
5. main path: the paper's Fig. 4 grids (4 seeds, 12 h of work, k = 16)
   through ``compare_grid`` -- at least 16 of the 18 static rows must show
   relative runtime > 100% and every oracle gap must lie in [0.95, 1.05];
6. main path: the fleet grid, 10,000 class-pooled gossip cells of
   k = 1,000,000 peers, through ``run_cells(step="fused")`` -- every cell
   must complete.  The sim_step launches of phases 5 and 6 are that
   path's count (15, all on the Philox route; by variant too);
G2. main path: ``gossip_fidelity_sweep`` at
   ``benchmarks/gossip_fidelity.py``'s settings (288 cells, k = 16, 12 h
   of work, 16 seeds, Philox draws) -- a per-peer batch, so the plain step
   and 0 sim_step launches; every cell completes, isolated's mean wall
   above pooled's and gossip every 300 s within 10% of pooled in each
   scenario; steps, seconds and seconds a step (cold and warm), and
   ``torch.profiler`` over 32 warm steps (device time by kernel, kernels a
   step, idle share);
G3. main path: ``server_offload_sweep``, ``heterogeneity_sweep`` and
   ``correlated_churn_sweep`` at the reference's defaults, their depth cut
   to 12 h of work a cell (the defaults' 24 h made phase 7's plain-step
   runs of these batches ~100 s), through the kernel with Philox draws
   (variants 1000, 0000 and 0010): every cell
   completes, R = 3 moves fewer server bytes and finishes sooner than
   R = 0, every heterogeneity row > 100% with its oracle gap in
   [0.95, 1.05], relative runtime at 2 shocks/h above that at 0 in every
   scenario; sim_step launches by route and by variant;
G4. ``python -m repro_torch.launch.paper_figs --fast`` as a subprocess on
   the card: exit 0 and every CSV header printed;
W1. the workflow digital twin across devices: ``tests/test_exec.py``'s
   shocked 3-stage DAG at 8 seeds, homogeneous, with a ``StoreSpec(R=3)``
   and two-class with the store, through ``simulate_workflow`` with parity
   draws on the card (the kernel's pre-generated route; variants 0010,
   1010, 1110) and on the CPU -- counts and ``completed`` exact, floats
   within 1e-9 relative; the sim_step launches by variant;
W2. main path: ``examples/workflow_dag.py``'s DAG at full shape (diurnal,
   MTBF 7,200 s), 4,096 seeds a stage on the Philox route, the adaptive
   and the fixed 1 h policy, homogeneous and with ``--mix
   fast_core_volunteer_tail --p2p --replicas 3``: mean makespan, waste
   band, server bytes, wall, cells/s, a profiled run's idle share; the
   means of makespan and waste within 3 sigma of the port's CPU run with
   numpy draws at 64 seeds, and the completed shares within 3 sigma of
   each other (the check that binds where the fixed policy censors
   seeds); the CPU run is made in a spawned worker while W3 waits on the
   disk, and held after W3;
W3. main path: the example's ``--execute`` on the card (``MixTask(dim=64)``
   payloads on the card, 4 schedule seeds) on both forms of the DAG: the
   executor's mean waste inside the sim's 3-sigma band; supersteps a
   second, checkpoints, write seconds, restores.  The sim_step launches
   of W2 and W3 are the workflow path's count (Philox route, 0000 and
   1100);
W4. ``PowerIterTask(dim=2048)`` on the card (a 16 MiB float32 matrix in
   every checkpoint), one schedule seed of the 3-stage DAG: killed in
   ``train``, resumed, the final payload bitwise equal to an
   uninterrupted run's; the eigenvalue against ``eigvalsh``;
P1. the policy service's ``--smoke`` flows (2,048 clients x 8 flushes, 16
   queries, calibrate) with the session state on the card and on the CPU,
   windowed and moment: every decision bitwise equal;
P2. the policy service at scale on the card: 100,000 windowed clients
   (``policy_session_replay``) and 1,000,000 moment clients
   (``policy_moment_1m``): us a decision, flush p50/p99, peak memory, a
   profiled flush's idle share, the 100k run's decisions bitwise the CPU
   service's;
   ``python -m repro_torch.launch.serve_policy --smoke --device cuda`` as
   a subprocess, exit 0;
S3. main path: ``repro_torch.serve`` on the full mamba2-130m (24 layers,
   d_model 768, bf16, the port's seeded init): ``greedy_generate`` of 32
   tokens after a 1024-token prompt, batch 8 -- 24 ssd_scan launches (one
   per layer), all on the tensor-core route; then prefill seconds and
   decode tokens/s through the step factories, peak device memory, and
   the prefill seconds of the plain ``ssd_chunked`` path
   (``use_flash_kernel=False``) on the same input, and whether the kernel
   path's prefill is no slower;
S4. the same parameters and prompt with ``use_flash_kernel=False`` (the
   plain ``ssd_chunked`` path on the card): last-position prefill logits
   and four teacher-forced decode steps' logits.  bf16: elementwise within
   5e-2 + 5e-2|b|, widened only where two plain implementations (the
   kernel's plain version against ``ssd_chunked``, the bf16 noise floor
   measured in the same run) cross it, to at most 1.2x their gap; relative
   RMS within 5e-2.  The same parameters in float32 within 1e-4
   elementwise;
7. each sim_step variant the main path ran, against the plain step on
   the card at its shapes (every ``BatchResult`` / ``_State`` field
   equal over FIG4_VS_PLAIN_MAX_STEPS (1,024) steps of the Fig. 4 grids,
   both routes at the fleet chunk); one 256-step chunk timed by
   CUDA events at the Fig. 4 batches (B = 216) and the fleet batch: the
   in-kernel route, the pre-generated route, and the kernel's generator
   on its own (``philox_draws``) followed by the pre-generated route,
   beside the plain version and the bound (bytes: parameters, state and
   seeds; operations: the step's and Box-Muller's FP64 instructions at
   the FP64 instruction rate, Philox's 32-bit integer operations at the
   INT32 rate; the pre-generated route's bound beside it); run_cells'
   host stages; G3's three sweep batches the same way (run_cells with the
   kernel against the plain step for SWEEP_VS_PLAIN_MAX_STEPS (256)
   steps, every field
   equal; a 256-step chunk on
   both routes beside the plain step's and the bound: bytes against the
   step's and Box-Muller's FP64 instructions and Philox's INT32
   operations);
   ``torch.profiler`` over one warm fleet ``run_cells`` (device time by
   kernel, idle share, and no ``PhiloxDraws`` draws: none of its calls and
   none of its torch kernels);
S5. ``torch.profiler`` over one warm prefill and five decode steps:
   device time by kernel, launches per step, the device's idle share;
S6. both ssd_scan kernels timed by CUDA events at the serving shape (in
   turns) beside their plain version, and the bound: the least time over
   the card's routes (bytes, or every operation at the bf16 tensor rate),
   and the SIMT kernel's own (the float32 SIMT rate);
T1. the ckpt_quant kernels (quantize_blocks, dequantize_blocks) against
   their plain versions on the card, bitwise (0 mismatching codes, scales
   and float32/bf16 values): at mamba2-130m's embedding leaf (38,615,040
   float32, 75,420 blocks of 512) and an in_proj leaf (2,574,336, 5,028
   blocks), and at the edge cases (zero block, exact .5 ties, values near
   the float32 range, 1, 3 and 257 blocks, blocks of 32, 96 and 4096,
   float32 and bf16 in, a misaligned input);
T2. across devices, mamba2 SMOKE float32: compress_grads on the same
   gradients for three error-feedback steps, card against CPU, bitwise;
   one train step from the same weights: loss within 1e-5 relative,
   gradients within 1e-4 max|g| + 1e-6, the AdamW update of the same
   gradients within 1e-5 relative + 1e-6;
T3. main path: ``repro_torch.launch.train``'s code path on mamba2-130m
   at full width cut to TRAIN_LAYERS (8) layers (the config's depth
   replaced around ``build``; bf16,
   remat 'full', ssd_chunked), SyntheticLM batch 8 x
   1024 in 2 microbatches, the adaptive policy, 8 steps, checkpoints into
   ``.smoke_ckpt/`` with one neighbour replica (removed afterwards); an
   injector seed with one restart; >= 1 checkpoint, finite losses, the mean
   of the last 3 below the first; then compress_grads three times on the
   trained model's gradients, the error state carried: every |new_err|
   within its block's scale / 2 (1 + 2^-15), and one quantize and two
   dequantize launches per leaf (74 and 148 a call at 8 layers);
T4. training numbers: warm step seconds and tokens/s, peak memory, V
   (blocking snapshot) and write seconds, a timed restore of the newest
   image (T_d), the controller's interval, compress_grads seconds, a
   profiler pass over one train step (device time by kernel, idle share);
   each quant kernel by CUDA events at the embedding leaf beside its plain
   version, its bytes bound and, for dequantize, torch.dequantize;
D1. across devices, dense training: the five dense SMOKE configs
   (olmo-1b, gemma2-27b, stablelm-1.6b, starcoder2-3b, qwen2-vl-7b) in
   float32 at 64 tokens (wider than the SMOKE window of 32), one train
   step from the same seeded weights on the card and the CPU, held as T2
   holds mamba2's; then remat 'none', 'full' and 'dots' on the card
   (olmo, gemma2): bitwise the same gradients, 'none' twice the control;
D2. main path: ``repro_torch.launch.train --arch olmo-1b``'s code path at
   full width cut to DENSE_TRAIN_LAYERS (4) layers (as T3's; d_model
   2048, 0.37 B parameters drawn on the card, bf16, remat 'full',
   attention through
   ``_attention_core``), SyntheticLM batch 8 x 1024 in 2 microbatches, 7
   steps at AdamW rate 1e-4, the adaptive policy with fixed virtual
   overheads (V 20 s, T_d 30 s), no replica, the newest image kept (5.2
   GB images in
   ``.smoke_ckpt/``, removed afterwards; the disk and the host memory are
   checked against the image first); injector seed 11: >= 2 commits and a
   failure rolled back to a committed image, finite falling losses, no
   launch but ckpt_quant's; compress_grads three times on the trained
   model's gradients (29 quantize + 58 dequantize launches a call,
   |err| within EF_SLACK); both quant kernels bitwise their plain versions
   on every olmo-1b leaf;
D3. dense training numbers: warm step seconds, tokens/s and 6 N tokens/s
   against the bf16 tensor-core peak, peak memory, image, V, write, T_d
   (the in-run restore), the controller's interval; torch.profiler over
   one warm step (device time by kernel, idle share, ``_attention_core``'s
   share by its operators' shapes); ``_attention_core`` and
   ``scaled_dot_product_attention`` forward + backward timed at the step's
   attention shape (a yardstick for a flash backward, never on the path);
   both quant kernels at olmo-1b's embedding leaf (103,022,592 float32)
   beside their plain versions, bound and torch.dequantize;
D4. ``python -m repro_torch.launch.fault_tolerant_training --preset ci
   --device cuda --steps 12`` as a subprocess: exit 0, every policy line,
   ``MATCH``;
A1. both flash_attention kernels against their plain torch version on
   the card: the kernel each case's route names (bf16 at head_dim 64 and
   128: the tensor-core kernel; float32 and head_dim 16/32: the SIMT
   kernel), and the SIMT kernel too on every tensor-core case --
   kernel_bench's shapes, tests/test_kernels.py's four shapes in float32
   and bf16, softcap 50 with and without the causal mask (q scaled so the
   scores reach the cap, and the softcap must move the plain output by
   10x the tolerance), Sq < Skv, Sq >
   Skv (the rows that see no key must be exactly 0), lengths off the
   128-row grid, strided views, head_dim 16 and 32, olmo-1b's prefill
   shape (128, 1, 1024, 128) and a GQA serving shape (16, 12, 1024, 128),
   bf16 -- within 2e-5 (float32) and 2e-2 (bf16), rtol = atol;
A2. across devices: the olmo SMOKE config in float32 (float32 KV cache)
   with the kernel on, prefill and 8 teacher-forced decode steps, kernel on
   the card against the plain version on the CPU -- logits and caches
   within 1e-4; at 24- and 40-token prompts; these float32 prefills are
   the SIMT kernel's path;
A3. main path: ``repro_torch.serve`` on the full olmo-1b (16 layers,
   d_model 2048, bf16, the port's seeded init, timed):
   ``greedy_generate`` of 32 tokens after a 1024-token prompt, batch 8 --
   exactly 16 flash_attention launches (one per layer, prefill only), all
   on the tensor-core route; then
   prefill seconds and decode tokens/s through the step factories, peak
   device memory, and the plain path's prefill (``use_flash_kernel=False``,
   ``_attention_core``) on the same input;
A4. the same parameters and prompt with the knob off: last-position
   prefill logits and four teacher-forced decode steps' logits, held as
   S4 holds them (bf16: 5e-2 + 5e-2|b|, widened only where two plain
   implementations -- ``_attention_core`` and ``flash_attention_plain`` in
   the kernel's place -- cross it in the same run, to at most 1.2x their
   gap; relative RMS within 5e-2); float32 (the bf16 weights cast on the
   card, float32 KV cache) within 1e-4 elementwise;
A5. ``torch.profiler`` over one warm olmo-1b prefill and five decode steps:
   device time by kernel, launches per step, the device's idle share;
A6. both flash_attention kernels timed by CUDA events (in turns) at
   olmo-1b's prefill shape and at the GQA shape, beside their plain
   version,
   ``scaled_dot_product_attention`` (the library yardstick; whether it
   equals the kernel within A1's tolerance) and its bound;
V1. the flash_attention kernel against its plain version on the card at
   the four dense variants' prefill shapes (batch 8, 1024 tokens, bf16:
   the tensor-core route): gemma2-27b (128, 2, 1024, 128) with softcap 50
   and scale 1/12, stablelm-1.6b (256, 1, 1024, 64), starcoder2-3b (16,
   12, 1024, 128), qwen2-vl-7b (32, 7, 1024, 128), and zamba2-7b's (256,
   1, 1024, 112), its head_dim zero-padded to 128 by the wrapper; A1's
   bf16 tolerance; at zamba2's the scale check (the kernel's output lies
   nearer the plain output at 1/sqrt(112) than at 1/sqrt(128));
   and gemma2's shape again with q scaled so the scores reach the cap
   (standard deviation 30), where the plain version with the softcap must
   differ from the same call without it by 10x the tolerance;
V2. across devices: the four variants' SMOKE configs in float32 (float32
   KV cache) with the kernel on, prefill and 8 teacher-forced decode steps
   at 24- and 40-token prompts (40 is wider than the SMOKE window of 32:
   gemma2's and starcoder2's local layers take ``_attention_core``) --
   logits and caches within 1e-4, one SIMT launch a layer whose window is
   not narrower than the prompt; the int8 KV cache (gemma2 SMOKE):
   ``quantize_kv`` of the same K/V bitwise on both devices, a decode step
   over the CPU's own prefill cache within 1e-4, the card's own prefill
   codes within one step of the CPU's with at most 0.1% off;
V3. main path: ``repro_torch.serve`` on the full gemma2-27b (46 layers,
   d_model 4608, 27,227,128,320 parameters, bf16, drawn on the card by a
   CUDA generator): ``greedy_generate`` of 32 tokens after a 1024-token
   prompt, batch 8 -- exactly 46 flash_attention launches (one per
   layer, prefill only: the prompt is inside the 4,096 window), all on the
   tensor-core route; prefill seconds and decode tokens/s through the step
   factories, peak device memory, the plain path's prefill;
V4. V3's parameters and prompt with the knob off, held as A4 holds olmo
   (bf16 with the same-run floor; float32 within 1e-4 at full width and
   the depth cut to 2 layers: 46 float32 layers need ~109 GB);
V5. ``torch.profiler`` over one warm gemma2-27b prefill and five decode
   steps: device time by kernel, launches per step, the idle share;
V6. stablelm-1.6b, starcoder2-3b and qwen2-vl-7b at full width and depth,
   each drawn on the card: ``greedy_generate`` (batch 8, 1024 + 32) with
   exactly 24, 30 and 28 flash launches, all on the tensor-core route; the
   timed prefill and decode; A4's logits check (float32 at full depth);
   each model freed before the next;
V7. the flash kernel timed by CUDA events at V1's four shapes beside its
   plain version, ``scaled_dot_product_attention`` (none at gemma2's:
   SDPA has no softcap) and the bound (bytes; the bf16 tensor-core
   operations and, at gemma2's, the softcap's float32 operations);
W5. each sim_step variant the workflow path ran (0000, 1100 at W2's
   4,096-cell train stage; 0010, 1010, 1110 at W1's): one 256-step chunk
   from the batch's initial state on both routes against the plain step
   fed the same draws (every ``_State`` field and the steps per warp
   equal), the chunk timed on both routes beside the plain step's, and
   the bound (the step's FP64 instructions with the diurnal hazard and
   the replica draw's class and shock terms);
M1. across devices, the moe family: both moe SMOKE configs (olmoe-1b-7b,
   deepseek-moe-16b) in float32 with the kernel on, from the same
   CPU-drawn weights, at capacity factors 8.0 and 0.5 (tokens drop):
   prefill of 32 tokens and 4 teacher-forced decode steps, logits and KV
   caches within 1e-4, the routes (expert ids and the within-capacity
   mask) equal on every layer and step (where one differs: the
   probabilities at the differing token, and a failure), 8 SIMT launches;
   one float32 train step each by T2's rule; remat 'none', 'full' and
   'dots' on the card (olmoe SMOKE) bitwise the same gradients, and 'none'
   twice (the backward run twice) too;
M2. main path: ``repro_torch.serve`` on the full olmoe-1b-7b (16 layers,
   d_model 2048, 64 experts top-8, 6,919,096,320 parameters drawn on the
   card, bf16): ``greedy_generate`` of 32 tokens after a 1024-token
   prompt, batch 8 -- exactly 16 flash launches, all ``wgmma``; the timed
   prefill and decode, peak memory, the plain path's prefill; the logits
   against ``_attention_core`` by S4's floor rule (for moe the relative
   RMS limit also follows the floor's: its routes flip as well), with the
   share of (layer, token, k) routes that differ between the two paths
   (and between the two plain paths); float32 at full depth with the
   kernel path made to take the plain path's routes, each of its own
   differing choices a near tie (1e-4 relative), within 1e-4;
M3. the same for the full deepseek-moe-16b (28 layers, 64 routed top-6
   and 2 shared experts, 16,879,568,896 parameters): 28 ``wgmma``
   launches; the float32 check at 8 layers;
M4. both models' numbers beside the card's name and power limit:
   ``torch.profiler`` over one warm prefill and 5 decode steps, the
   device time split into attention, the moe blocks' products (expert
   and router), the rest of the moe blocks (dispatch, combine, routing,
   activation) and the rest, the moe blocks' operators by device time,
   the idle share; decode beside its weight-read bound (every expert is
   computed every step);
M5. main path: olmoe-1b-7b at full width cut to 2 layers (1,045,178,368
   parameters, drawn on the card, bf16, remat 'dots', ``_attention_core``),
   5 steps of ``make_train_step`` on SyntheticLM 8 x 1024 in 2
   microbatches, AdamW 1e-4: finite losses and the moe metrics; step
   seconds, tokens/s, peak; compress_grads three times on its gradients
   (23 quantize + 46 dequantize launches a call, |err| within EF_SLACK),
   both quant kernels bitwise their plain versions on every leaf (the
   134,217,728-element expert stacks among them) and timed there beside
   their plain versions, the bound and ``torch.dequantize``;
H1. across devices, the hybrid family: zamba2 SMOKE in float32 with the
   kernels on (SIMT SSD, SIMT flash at head_dim 16), from the same
   CPU-drawn weights: prefill of 32 and 40 tokens and 4 teacher-forced
   decode steps, logits, SSM state, conv carry and K/V within 1e-4, one
   SSD launch a layer and one flash launch a use of the shared block a
   prefill; one float32 train step by T2's rule; remat 'none', 'full' and
   'dots' and a second backward bitwise the same gradients on the card;
H2. zamba2-7b's kernel shapes: S1's and V1's zamba2 cases (run there in
   the whole script, here with ``--hybrid``), and both kernels timed by
   CUDA events at those shapes beside their plain versions, their bounds
   (SSD 270.0 MB, flash 234.9 MB: bytes) and, for flash,
   ``scaled_dot_product_attention`` at head_dim 112 (the yardstick; the
   kernel's time includes the wrapper's pad copies);
H3. main path: ``repro_torch.serve`` on the full zamba2-7b (81 Mamba2
   layers, the shared block after every 6: 13 uses, d_model 3584,
   6,636,442,832 parameters drawn on the card, bf16): ``greedy_generate``
   of 32 tokens after a 1024-token prompt, batch 8 -- exactly 81 SSD calls
   (all ``mma``) and 13 flash launches (all ``wgmma``) a prefill, none in
   decode; the logits against the plain path (``ssd_chunked``,
   ``_attention_core``) by S4's floor rule, the relative RMS limit also
   following the floor's, the decode steps reported alone; float32 on the
   first 6 layers within 1e-4; the flash kernel's output at each of the
   prefill's 13 shared-block uses against its plain version on the same
   recorded q, k, v within A1's bf16 tolerance;
H4. zamba2-7b's numbers beside the card's name and power limit: the
   timed prefill and decode, peak memory, the plain path's prefill;
   ``torch.profiler`` over one warm prefill and 5 decode steps, the device
   time split into the SSD kernels, flash, the Mamba2 projections, the rest
   of the mixers, the shared block's products, the rest of it and the
   rest, the idle share; the prefill beside its operations bound and a
   decode step beside its read bound;
H5. main path: zamba2-7b at full width cut to 12 layers (1,255,956,416
   parameters, two uses of the shared block, drawn on the card, bf16,
   remat 'dots', ``ssd_chunked`` and ``_attention_core``), 5 steps of
   ``make_train_step`` on SyntheticLM 8 x 1024 in 2 microbatches, AdamW
   1e-4: finite losses, step seconds, tokens/s, peak; compress_grads
   three times on its gradients (119 quantize + 238 dequantize launches a
   call, |err| within EF_SLACK), both quant kernels bitwise their plain
   versions on every leaf and timed at the 114,688,000-element embedding
   leaf beside their plain versions, the bound and ``torch.dequantize``;
E1. across devices, the encdec family: whisper SMOKE in float32 with the
   kernel on (the SIMT flash kernel at head_dim 16, unmasked in the
   encoder and the cross-attention), from the same CPU-drawn weights and
   frames: prefill of 8 and 13 decoder tokens over 16 frames and 4
   teacher-forced decode steps, logits, self K/V and cross K/V within
   1e-4, exactly 6 flash launches a prefill (2 encoder, 2 decoder self, 2
   cross) and none in decode; one float32 train step on a batch with
   frames by T2's rule; remat 'none', 'full' and 'dots' and a second
   backward bitwise the same gradients on the card;
E2. whisper-large-v3's kernel shapes: the flash kernel against its plain
   version at the encoder's unmasked (160, 1, 1500, 1500, 64), the
   cross-attention's unmasked (160, 1, 128, 1500, 64) and the decoder's
   causal (160, 1, 128, 128, 64), bf16 (the tensor-core route; the first
   two are in A1's list too), A1's tolerance; each timed by CUDA events
   beside the plain version, ``scaled_dot_product_attention`` with the
   same mask and the bound (operations at the encoder's, bytes at the
   cross-attention's);
E3. main path: ``repro_torch.serve`` on the full whisper-large-v3 (32
   encoder and 32 decoder layers, d_model 1280, 1,534,809,600 parameters
   drawn on the card, bf16), frames (8, 1500, 1280) from seed 2 as
   ``launch.serve`` draws them: ``greedy_generate`` of 32 tokens after a
   128-token decoder prompt, batch 8 -- exactly 96 flash launches a
   prefill (32 unmasked encoder, 32 causal decoder self, 32 unmasked
   cross), all ``wgmma``, none in decode; each of the 96 calls against
   ``flash_attention_plain`` on its own q, k, v within A1's bf16
   tolerance; the logits against the plain path (``_attention_core`` and
   the plain cross-attention) by S4's floor rule; float32 on the first 8
   encoder and 8 decoder layers within 1e-4;
E4. whisper-large-v3's numbers beside the card's name and power limit:
   the timed prefill and decode, peak memory, the plain path's prefill;
   ``torch.profiler`` over one warm prefill and 5 decode steps, the device
   time split into the encoder's products, flash, the cross K/V
   projections, the decoder's products and the rest, the idle share; the
   flash calls split into the encoder's, the cross-attention's and the
   decoder's self-attention's by CUDA events in a prefill of their own;
   the prefill beside its operations bound and a decode step beside its
   read bound;
E5. main path: whisper-large-v3 at full width cut to 8 + 8 layers
   (433,497,600 parameters, drawn on the card, bf16, remat 'dots',
   ``_attention_core`` and the plain cross-attention), 5 steps of
   ``make_train_step`` on SyntheticLM tokens 8 x 448 with seeded frames
   (8, 1500, 1280) in 2 microbatches, AdamW 1e-4: finite losses, step
   seconds, decoder tokens/s, frames/s, peak; compress_grads three times
   on its gradients (213 quantize + 426 dequantize launches a call, |err|
   within EF_SLACK), both quant kernels bitwise their plain versions on
   every leaf and timed at the 66,388,480-element embedding leaf beside
   their plain versions, the bound and ``torch.dequantize``;
C1. main path sharded over a device mesh (``run_cells(mesh=...)``, the
   sim_step counts at 0 just before C1 and read after C2): the fleet grid
   at data extents 1, 2, 3 and 4 x cuda:0 (3 pads the batch with
   born-finished copies), every ``BatchResult`` field and n_steps bitwise
   the unsharded run's and shards x chunks sim_step launches, the seconds
   at 1 and 4 shards; Fig. 4 static's 216 cells over 5 shards on the
   numpy parity route (the pre-generated route), bitwise; G1's per-peer
   batch over 3 shards, ``step="scan"``, one 64-step chunk, bitwise;
C2. phase 4's 64 cells on parity draws over a mesh of (cuda:0, cpu),
   512 steps deep: the card's shard (the kernel) bitwise the unsharded run
   on the card, the CPU's (the plain step) by phase 4's rule;
Z1. ZeRO-1 at SMOKE in float32 (olmo, olmoe) on the card: data meshes of
   2 and 4 x cuda:0 with and without ``zero1_grads_in_scan``, a step the
   norm does not clip and one it does, against the unsharded step with
   as many microbatches -- bitwise unclipped, within 1e-6 relative
   (grad_norm too) clipped; a 4-shard state's checkpoint image equal to
   the unsharded one's and restored into the pieces; a (cuda:0, cpu) mesh
   (a replica and half the state on each) by T2's rule;
Z2. olmo-1b at full width, D2's configuration (clipping off): the
   unsharded step with 4 microbatches, then 4 x cuda:0 with one
   microbatch a shard and 2 x cuda:0 x 2 microbatches under
   ``zero1_grads_in_scan``, each bitwise the unsharded step by per-leaf
   sha256 of ``tree()`` made on the host; step seconds and peaks beside
   D3's;
DR1. the dry run on the card: a (1, 1) mesh of cuda:0 at A3's prefill and
   D3's train shape, the card's FLOPs equal to the meta count and its
   peak within DR_PEAK_RANGE of the estimate; the production cells
   gemma2-27b, zamba2-7b, mamba2-130m, starcoder2-3b and
   whisper-large-v3 ``decode_32k`` on meta "ok";
TP1. split SMOKE models in float32 with the kernels on (olmo, gemma2,
   olmoe, deepseek, mamba2, zamba2) over (1, 2) and (1, 4) of cuda:0, and
   zamba2 at batch 1 over (2, 2) (its K/V along the sequence over the data
   positions): logits and gathered caches within 1e-4 of the CPU's split
   run and of the card's unsplit run, moe routes and the Mamba2 shards' B
   and C conv carries bitwise equal on the shards; one (2, 2) train step
   of olmo, olmoe, mamba2 and zamba2 by T2's rule with the master held to
   the bound that follows Adam; remat and a second backward bitwise.
   The layouts of rules that split no heads: starcoder2 and qwen2-vl over
   (1, 4) by a prefill cell's rules (kv_seq: the SIMT kernel with offsets
   and statistics) and a decode cell's (head_dim), whisper over (1, 2)
   (its heads) and (1, 8) (kv_seq, head_dim), against the CPU's split run
   and the card's unsplit run within 1e-4; one (1, 4) step of starcoder2
   and one (1, 8) step of whisper under kv_seq by the same rule;
TP2-TP4. olmo-1b served whole at model extents 1, 2 and 4 (exactly 16·m
   ``wgmma`` launches a prefill), olmoe-1b-7b at 2, olmo-1b at 8 layers
   trained over (2, 2);
TP5. zamba2-7b served whole at model extents 2 and 16 of cuda:0 (7 SSM
   heads and 2 attention heads a shard at 16): exactly 81·m ``mma`` SSD
   calls and 13·m ``wgmma`` flash launches a prefill, none in decode;
   every shard's SSD and flash call against its plain version; bf16
   logits by S4's floor rule against the unsplit kernel path; float32 at
   6 layers; prefill s, decode tokens/s (8 steps at 2, 2 at 16), peak;
   the shard shapes timed;
TP6. mamba2-130m served whole at 2 (12 heads a shard) and 16 (replicas):
   exactly 24·m ``mma`` SSD calls a prefill; bf16 logits by S4's floor
   rule at 2, bitwise the unsplit kernel path's at 16;
TP7. starcoder2-3b at full width over model extent 4 of cuda:0 (batch 8,
   prompt 1024, 32 tokens), prefilled by its prefill cell's rules
   (kv_seq: 4 key parts of 264/264/264/232 prompt keys) and decoded by its
   decode cell's (head_dim), the cache carried across by ``gather_cache``
   and ``split_cache``: exactly 120 ``wgmma`` launches a prefill, each
   with its offset and statistics, none in decode; each call against its
   plain version on o, m and l by A1's bf16 rule; bf16 logits by S4's
   floor rule against the unsplit kernel path; float32 at 4 layers;
TP8. whisper-large-v3 the same over model extent 16 (frames 8 x 1,500 x
   1,280, prompt 128): exactly 1,440 launches a prefill (encoder 32 x 16
   parts, decoder self 32 x 13, cross 32 x 16 whole on every position);
   float32 at 4 + 4 layers.  Then the offset and statistics mode timed at
   a starcoder2-3b part and a whisper encoder part beside its bound and
   SDPA under the same mask;
8. a ``kernels`` JSON line (for each kernel: launches on its path --
   the serving prefills for the tensor-core kernels (the flash kernel's
   by model, the moe, hybrid and encdec models' too; the SSD kernel's by
   model), the float32 SMOKE prefills of S2/A2/V2/M1/H1/E1 for the SIMT
   ones, sim_step's main path and the workflow path's, the quant kernels'
   by training path (T3, D2, M5, H5, E5), sim_step's sharded launches
   (C1, C2) --, error,
   times, bound; the flash kernel's at the variants' and whisper's
   shapes, the quant kernels' at the expert and zamba2's and whisper's
   embedding leaves too), the card's name and power limit, and the final result line.  ``[t]`` lines give the seconds of
   each group of phases.

Any failed phase exits non-zero before the result line is printed.
Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import shutil
import subprocess
import sys
import time
from unittest import mock
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet peaks used for the bounds.
HBM_BYTES_PER_S = 3.35e12
# FP64 instructions: the data sheet's 34 TFLOP/s counts an FMA as two
# operations, and sim_step.cu is built with -fmad=false (no FMA), so its
# FP64 work runs at most one instruction per FP64 lane and clock: 64 lanes
# per SM (Hopper architecture white paper) x 132 SMs x the 1.98 GHz boost
# clock.
FP64_OPS_PER_S = 64 * 132 * 1.98e9
# 32-bit integer operations: 64 INT32 lanes per SM x 132 SMs x 1.98 GHz.
INT32_OPS_PER_S = 64 * 132 * 1.98e9
FP32_OPS_PER_S = 67e12          # float32 outside the tensor cores
BF16_TC_OPS_PER_S = 989e12      # bf16 tensor cores, dense
# FP64 operations of one step of one class-pooled adaptive gossip cell
# (the fleet grid's path: constant hazard, no store, no shock), counted
# from csrc/sim_step.cu with every arithmetic operation, comparison-select
# and math-library call as one operation: _attempt 104 (of which the
# 4-iteration Lambert W 74), _apply without the estimator 121, pooled
# estimator 12, class-pooled update 241 (the 16-term Poisson unroll 88).
OPS_PER_FLEET_CELL_STEP = 104 + 121 + 12 + 241
# The in-kernel draws of one class-pooled cell-step (csrc/sim_step.cu,
# philox_draws<true>), counted the same way, at the fewest instructions
# that do the work.  32-bit integer: four Philox4x32-10 calls of 10 rounds,
# 4 a round -- each of the two products is one wide multiply giving both
# its high and low words, and each ``hi ^ c ^ k`` one three-input logic
# operation; the key schedule is the same every step of a cell and not
# counted -- the counter's two words and its add, and 7 uniforms'
# shift-shift-add.  FP64: the 7 uniforms' conversion and scale, and the
# two Box-Muller pairs (negation, log1p, scale, sqrt, 2 pi b, cos,
# product; the pm pair's sin and second product).  A math-library call
# counts as one operation, so the FP64 count is a lower bound.
PHILOX_INT_OPS_PER_PM_STEP = 4 * 10 * 4 + 3 + 7 * 3
BOX_MULLER_OPS_PER_PM_STEP = 7 * 2 + 7 + 9
# The no-pm Philox route's draws of one cell-step (philox_draws<false>),
# counted as above: two Philox4x32-10 calls (block 0: u, u2; block 1: the
# Box-Muller pair's uniforms), the counter's words and add, 4 uniforms'
# shift-shift-add; FP64: 4 uniforms' conversion and scale, one Box-Muller
# normal (negation, log1p, scale, sqrt, 2 pi b, cos, product).
PHILOX_INT_OPS_PER_STEP = 2 * 10 * 4 + 3 + 4 * 3
BOX_MULLER_OPS_PER_STEP = 4 * 2 + 7
# FP64 operations of one step of one pooled-estimator cell (the Fig. 4,
# heterogeneity and correlated-churn batches), counted as for the fleet
# cell: _attempt 104, _apply without the estimator 121, the pooled
# estimator 12.  A shock adds no per-step work there (its rates are
# per-cell constants, computed once).  A store cell adds the replica draw
# (replica_draw<false, false>): the availability and its clamp 6, the
# ratio and (1 - A)^R 4, the m = 0 term 1, 8 unrolled terms of 18 (the
# count's compare-add, the pmf update, the CDF, the striped restore time
# and the E[T_d] sum) and the final count, restore time and selects 8.
OPS_PER_POOLED_CELL_STEP = 104 + 121 + 12
REPLICA_DRAW_OPS = 6 + 4 + 1 + 8 * 18 + 8
# The main path's kernel variants, as (store, het, shock, pm): the Fig. 4
# grids and the heterogeneity sweep run 0000, the fleet grid 0001, the
# server-offload sweep 1000, the correlated-churn sweep 0010.
MAIN_PATH_VARIANTS = ("0000", "0001", "1000", "0010")
# FP64 operations a step adds to OPS_PER_POOLED_CELL_STEP, counted from
# csrc/sim_step.cu as above.  A time-varying hazard (the diurnal scenario
# of the example DAG): hazard() 7 (add, product, division, sin, product,
# add, division) and set_mu_terms() 38 per step.  The replica draw's
# heterogeneous terms (replica_draw<true, _>): per class 6 (the class
# availability's two products, two sums and division, the count's
# product), the shared product, 3 sums, the mixed availability 4 and the
# mixed striped time 9, 2 selects.  Its shock terms (replica_draw<_,
# true>): q 3, the post-shock availability 2, its ratio 2 and (1 - A)^R 2,
# the pmf mixture 4, and per unrolled term 7 (the second pmf update and
# the mixture).  Both: the post-shock class terms 8, 3 sums, availability
# 4, striped time 9, the restore-time mixture 4.
TIME_VARYING_MU_OPS = 7 + 38
REPLICA_HET_OPS = 4 * 6 + 1 + 3 + 4 + 9 + 2
REPLICA_SHOCK_OPS = 3 + 2 + 2 + 2 + 4 + 8 * 7
REPLICA_HET_SHOCK_OPS = 8 + 3 + 4 + 9 + 4
# The workflow path's variants, as (store, het, shock, pm): the example DAG
# (W2, W3) runs 0000 and, with --mix and --p2p, 1100; W1's shocked DAGs
# 0010, 1010 (--p2p) and 1110 (--mix and --p2p).
WORKFLOW_VARIANTS = ("0000", "1100", "0010", "1010", "1110")
TWIN_SEEDS = 8            # W1: seeds of each DAG, card and CPU
WF_SEEDS = 4096           # W2: seeds a stage on the card (Philox draws)
WF_CPU_SEEDS = 64         # W2: the CPU run it is held to (numpy draws)
EXEC_SEEDS = 2            # W3: pinned schedule seeds executed per DAG
                          # (4 until TP1-DR1 needed the time)
POWER_DIM = 2048          # W4: PowerIterTask's matrix (float32, 16 MiB)
POLICY_TEMPLATE = dict(k=8.0, window=32, prior_mu=1.0 / 7200.0)
# P2: benchmarks/policy_service_bench.py's policy_session_replay (full mode)
# and policy_moment_1m rows, as (name, estimator, clients, rounds, key bits,
# whether the CPU service runs the same stream to hold the decisions to)
POLICY_SCALE = (("session_replay_100k", "windowed", 100_000, 6, 12, True),
                ("moment_1m", "moment", 1_000_000, 3, 10, False))


# G3's depth: 12 h of work a cell (the sweeps' default is 24 h)
G3_WORK = 12 * 3600.0
# sim_step launches of the main path: 256-step chunks of Fig. 4 static (6)
# and dynamic (8) and of the fleet grid (1).
MAIN_PATH_SIM_STEP_LAUNCHES = 15

REPORT: dict = {}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    REPORT["failed"] = msg
    _dump()
    sys.exit(1)


def _dump() -> None:
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(REPORT, indent=1,
                                                    default=str))


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f"nvidia-smi failed: {r.stderr.strip()}"


def cuda_ms(fn, reps: int = 1) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


_LAP = {"t0": 0.0, "last": 0.0}


def _lap(name) -> None:
    """Seconds since the previous lap (``None`` starts the clock)."""
    now = time.monotonic()
    if name is None:
        _LAP["t0"] = _LAP["last"] = now
        return
    REPORT.setdefault("phase_seconds", {})[name] = now - _LAP["last"]
    print(f"[t] {name}: {now - _LAP['last']:.1f} s (script "
          f"{now - _LAP['t0']:.1f} s)", flush=True)
    _LAP["last"] = now


def phase_lint() -> None:
    """L1: the port's linter over its default paths; nothing may gate."""
    from repro_torch.analysis import default_paths, lint_paths

    t = time.monotonic()
    report = lint_paths(default_paths(ROOT), ROOT)
    seconds = time.monotonic() - t
    gating = report.gating
    n_sup = sum(f.suppressed for f in report.findings)
    REPORT["lint"] = dict(files=report.files_scanned, gating=len(gating),
                          suppressed=n_sup, seconds=seconds,
                          gating_findings=[str(f) for f in gating])
    print(f"lint: {report.files_scanned} files, {len(gating)} gating, "
          f"{n_sup} suppressed", flush=True)
    print(f"[L1] reprolint over the port's default paths: {seconds:.2f} s",
          flush=True)
    if gating:
        fail("lint: " + "; ".join(str(f) for f in gating))


def mixed_cells(n: int):
    """n cells over every static flag of the kernel: pooled fixed/adaptive/
    oracle over the five scenario kinds, store R=3 and R=0, a two-class
    store mix, shocks (fleet-wide and class-scoped), and class-pooled
    gossip at k = 64 and k = 1e6."""
    from repro_torch.p2p import StoreSpec
    from repro_torch.sim import (CellSpec, PeerClass, PeerClassMix,
                                 PolicyConfig, ShockSpec, scenario)

    scens = [scenario("constant", mtbf=4000.0),
             scenario("doubling", mtbf0=7200.0, double_after=3 * 3600.0),
             scenario("diurnal", mtbf=4000.0, amplitude=0.5,
                      period=6 * 3600.0),
             scenario("flash_crowd", mtbf=7200.0, spike_mtbf=900.0,
                      at=3600.0, duration=1800.0),
             scenario("trace", times=(0.0, 1800.0, 5400.0),
                      mtbfs=(7200.0, 2000.0, 5000.0))]
    mix = PeerClassMix((PeerClass("stable"),
                        PeerClass("volatile", hazard_mult=3.0, speed=0.7,
                                  uplink_mult=0.5)), (0.6, 0.4))
    pols = [PolicyConfig(kind="adaptive", prior_mu=1 / 4000.0, prior_v=20.0),
            PolicyConfig(kind="fixed", fixed_T=1800.0),
            PolicyConfig(kind="oracle")]
    gossip = PolicyConfig(kind="adaptive", prior_mu=1 / 4000.0, prior_v=20.0,
                          regime="gossip", gossip_period=600.0)
    kw = dict(work=4 * 3600.0, V=20.0, T_d=50.0, max_wall_time=40 * 3600.0)
    base = [CellSpec(scenario=s, policy=p, **kw) for s in scens for p in pols]
    base += [CellSpec(scenario=scens[0], policy=p, store=StoreSpec(R=3), **kw)
             for p in pols]
    base += [CellSpec(scenario=scens[0], policy=pols[0],
                      store=StoreSpec(R=0), **kw),
             CellSpec(scenario=scens[2], policy=pols[2], store=StoreSpec(R=3),
                      mix=mix, **kw),
             CellSpec(scenario=scens[0], policy=pols[0],
                      shock=ShockSpec(rate=2e-4, kill_frac=0.3), **kw),
             CellSpec(scenario=scens[0], policy=pols[0], store=StoreSpec(R=3),
                      mix=mix, shock=ShockSpec(rate=2e-4, kill_frac=0.5,
                                               scope="volatile"), **kw),
             CellSpec(scenario=scens[0], policy=gossip, k=64, n_slots=256,
                      **kw),
             CellSpec(scenario=scenario("constant", mtbf=4000.0 * 1e5),
                      policy=gossip, k=1_000_000, n_slots=4_000_000, **kw)]
    import dataclasses
    return [dataclasses.replace(base[i % len(base)], seed=i)
            for i in range(n)]


def phase_env() -> None:
    import torch

    REPORT["nvidia_smi"] = nvidia_smi()
    REPORT["python"] = sys.version.split()[0]
    REPORT["torch"] = torch.__version__
    REPORT["cuda"] = torch.version.cuda
    REPORT["device_count"] = torch.cuda.device_count()
    REPORT["device"] = torch.cuda.get_device_name(0)
    print(f"[1] {REPORT['nvidia_smi']} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | devices {REPORT['device_count']}",
          flush=True)
    # How this PyTorch build rounds the operations the bitwise contract
    # depends on (informational; the plain step divides by device tensors).
    x = torch.linspace(0.1, 7.3, 10001, dtype=torch.float64, device="cuda")
    three = torch.tensor(3.0, dtype=torch.float64, device="cuda")
    REPORT["div_by_python_scalar_is_true_division"] = bool(
        torch.equal(x / 3.0, x / three))
    REPORT["div_by_device_scalar_is_true_division"] = bool(
        torch.equal(x / three, (x.cpu() / 3.0).cuda()))
    REPORT["pow2_is_x_times_x"] = bool(torch.equal(x ** 2, x * x))
    print(f"    div by python scalar == true div: "
          f"{REPORT['div_by_python_scalar_is_true_division']}; "
          f"div by device scalar == true div: "
          f"{REPORT['div_by_device_scalar_is_true_division']}; "
          f"x**2 == x*x: {REPORT['pow2_is_x_times_x']}", flush=True)


def ptxas_table(log: str) -> list:
    """(variant as store-het-shock-pm bits, route, registers, stack bytes,
    spill-store bytes, spill-load bytes) per sim_step kernel instantiation,
    from nvcc's ``-Xptxas -v`` report: route "philox" for
    ``sim_step_philox_kernel``, "pregenerated" for ``sim_step_kernel``."""
    rows, cur, frame = [], None, None
    for line in log.splitlines():
        m = re.search(r"sim_step_(philox_)?kernelILb(\d)ELb(\d)ELb(\d)ELb(\d)E",
                      line)
        if m:
            cur = ("".join(m.groups()[1:]),
                   "philox" if m.group(1) else "pregenerated")
            frame = None
            continue
        sp = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                       r"(\d+) bytes spill loads", line)
        if cur is not None and frame is None and sp:
            frame = tuple(int(g) for g in sp.groups())
        r = re.search(r"Used (\d+) registers", line)
        if cur is not None and r:
            rows.append(cur + (int(r.group(1)),) + (frame or (0, 0, 0)))
            cur = None
    return rows


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.monotonic()
    names = list(build.SOURCES)
    build.build(names)
    for name in names:
        build.load(name)
    log = build.BUILD_LOG["sim_step"]
    REPORT["build_seconds"] = time.monotonic() - t0
    REPORT["ptxas"] = log["ptxas"]
    REPORT["ptxas_table"] = ptxas_table(log["ptxas"])
    REPORT["ssd_build_seconds"] = build.BUILD_LOG["ssd_scan"]["seconds"]
    REPORT["ssd_ptxas"] = build.BUILD_LOG["ssd_scan"]["ptxas"]
    REPORT["quant_build_seconds"] = build.BUILD_LOG["ckpt_quant"]["seconds"]
    REPORT["quant_ptxas"] = build.BUILD_LOG["ckpt_quant"]["ptxas"]
    REPORT["flash_build_seconds"] = \
        build.BUILD_LOG["flash_attention"]["seconds"]
    REPORT["flash_ptxas"] = build.BUILD_LOG["flash_attention"]["ptxas"]
    print(f"[2] built sim_step.cu, ssd_scan.cu, ckpt_quant.cu and "
          f"flash_attention.cu in {REPORT['build_seconds']:.1f} s (ssd_scan.cu "
          f"{REPORT['ssd_build_seconds']:.1f} s, ckpt_quant.cu "
          f"{REPORT['quant_build_seconds']:.1f} s, flash_attention.cu "
          f"{REPORT['flash_build_seconds']:.1f} s); sim_step.cu in "
          f"{log['seconds']:.1f} s; its kernels, variant (store, het, "
          f"shock, pm) and route -> registers, stack frame, spill "
          f"stores/loads:", flush=True)
    for var, route, regs, stack, st, ld in REPORT["ptxas_table"]:
        print(f"    {var} {route:12s} -> {regs} registers, {stack} B stack, "
              f"{st} B spill stores, {ld} B spill loads", flush=True)
    if log["ptxas"] == "(cached)":
        print("    (sim_step.cu was built before this run: no ptxas report)",
              flush=True)
    elif len(REPORT["ptxas_table"]) != 32:
        fail(f"expected 32 sim_step kernels in the ptxas report, found "
             f"{len(REPORT['ptxas_table'])}")
    spilled = [r for r in REPORT["ptxas_table"]
               if r[0] in MAIN_PATH_VARIANTS + WORKFLOW_VARIANTS
               and (r[4] or r[5])]
    if spilled:
        fail(f"main-path sim_step variants spill registers: {spilled}")
    for name, key in (("ssd_scan", "ssd_ptxas"), ("ckpt_quant", "quant_ptxas"),
                      ("flash_attention", "flash_ptxas")):
        for line in REPORT[key].splitlines():
            if ("registers" in line or "spill" in line or "Compiling" in line
                    or "C7513" in line):   # C7513: wgmmas serialized
                print(f"    {name}: {line.strip()}", flush=True)


def _state_diff(a, b):
    import torch

    out, worst = {}, 0.0
    for name, x, y in zip(a._fields, a, b):
        if x.is_floating_point():
            same = (x == y) | (torch.isnan(x) & torch.isnan(y))
            d = (x - y).abs()
            d = d[torch.isfinite(d)]
            if d.numel():
                worst = max(worst, float(d.max()))
        else:
            same = x == y
        out[name] = int((~same).sum())
    return out, worst


def _philox_chunk(s, p, src, n: int, **kw):
    """One launch of the in-kernel route on ``src``'s next ``n`` steps, on
    the packed operands: the new state and the steps taken per warp."""
    import torch

    from repro_torch.kernels import sim_step

    state = sim_step.pack_state(s)
    taken = torch.zeros(-(-s.t.shape[0] // sim_step.WARP), dtype=torch.int32,
                        device=state.device)
    sim_step.launch_philox(sim_step.pack_params(p), state, src.seeds,
                           src.skip(n), n, taken, **kw)
    return sim_step.unpack_state(state), taken


def phase_kernel_vs_plain(n_cells: int, chunks: int, chunk: int) -> float:
    """Phase 3: the in-kernel generator against PhiloxDraws, then both routes
    of the kernel against the plain step fed PhiloxDraws.next, on a mixed
    batch with every static flag -- from step 0, and from just below 2**32
    with seeds >= 2**32 (the counter's and the key's high words)."""
    import torch

    from repro_torch.kernels import sim_step
    from repro_torch.sim import engine
    from repro_torch.sim.draws import PhiloxDraws

    cells = mixed_cells(n_cells)
    gen_seeds = [c.seed for c in cells[:500]] + [
        2**32 + 7, 2**40 + 3, -1, -2**40, 2**63 - 1]
    gen = {}
    for any_pm in (False, True):
        src = PhiloxDraws(gen_seeds, any_pm, "cuda")
        for step0 in (0, 256, 2**32 - 3):
            d = sim_step.philox_draws(src, step0, 8)
            want = src.at(step0, 8)
            gen[f"pm={int(any_pm)} step0={step0}"] = [
                int((d[:, r] != want[:, r]).sum()) for r in range(d.shape[1])]
    torch.cuda.synchronize()
    print(f"[3] in-kernel Philox draws vs PhiloxDraws.at, mismatches per row "
          f"(u, z, u2[, u_pm, z_pm0, z_pm1]): {gen}", flush=True)
    p_np = engine._pack(cells)
    flags = engine.batch_flags(cells, p_np)
    assert all(flags.values()), flags
    p = engine.from_reference(p_np, device="cuda")
    total, worst, runs = {}, 0.0, []
    for step0, off in ((0, 0), (2**32 - (chunks * chunk) // 2, 2**32 + 11)):
        seeds = [c.seed + off for c in cells]
        s = engine._init_state(p, 1)
        src_k = PhiloxDraws(seeds, True, "cuda")
        src_r = PhiloxDraws(seeds, True, "cuda")
        src_k.step = src_r.step = step0
        for _ in range(chunks):
            d = src_r.next(chunk)
            b, tb = sim_step.fused_chunk_ref(s, p, d, macro_threshold=0.05,
                                             **flags)
            for route, (a, ta) in (
                    ("philox", _philox_chunk(s, p, src_k, chunk,
                                             macro_threshold=0.05, **flags)),
                    ("pregenerated", sim_step.fused_chunk(
                        s, p, d, macro_threshold=0.05, **flags))):
                torch.cuda.synchronize()
                diff, w = _state_diff(a, b)
                worst = max(worst, w)
                diff["steps_taken"] = int((ta != tb).sum())
                for k, v in diff.items():
                    key = f"{route}.{k}"
                    total[key] = total.get(key, 0) + v
            s = b
        runs.append(dict(step0=step0, seed_offset=off,
                         finished=int(s.finished.sum())))
    REPORT["kernel_vs_plain"] = dict(cells=n_cells, chunks=chunks,
                                     chunk=chunk, runs=runs,
                                     generator_mismatches=gen,
                                     mismatches=total, max_abs_err=worst)
    print(f"[3] kernel vs plain on the card: {n_cells} cells, {chunks} x "
          f"{chunk} steps from step 0 and from {runs[1]['step0']} (seeds + "
          f"{runs[1]['seed_offset']}), {[r['finished'] for r in runs]} "
          f"finished; mismatches per route and field: {total}; max |err| "
          f"{worst}", flush=True)
    if any(any(v) for v in gen.values()):
        fail("the in-kernel generator differs from PhiloxDraws")
    if any(total.values()):
        fail("kernel differs from the plain torch step")
    return worst


def phase_across_devices() -> None:
    import numpy as np

    from repro_torch.sim import run_cells

    cells = mixed_cells(64)
    a = run_cells(cells, device="cuda", draws="numpy", chunk=128)
    b = run_cells(cells, device="cpu", draws="numpy", chunk=128)
    bad = []
    for f in ("n_checkpoints", "n_failures", "n_server_restores",
              "n_peer_restores", "completed"):
        if not np.array_equal(getattr(a, f), getattr(b, f)):
            bad.append(f)
    rel = 0.0
    for f in ("wall_time", "wasted_work", "checkpoint_time", "restore_time",
              "server_bytes"):
        x, y = getattr(a, f), getattr(b, f)
        r = np.abs(x - y) / np.maximum(np.abs(y), 1e-300)
        rel = max(rel, float(np.max(np.where(x == y, 0.0, r))))
    REPORT["across_devices"] = dict(cells=64, count_mismatch=bad,
                                    max_rel_err=rel)
    print(f"[4] card kernel vs CPU plain, parity draws: count mismatches "
          f"{bad}, max rel err {rel:.3g}", flush=True)
    if bad or rel > 1e-9:
        fail("card and CPU disagree")


FIG4_KW = dict(seeds=range(4), work=12 * 3600.0, k=16)  # benchmarks KW


def phase_fig4() -> None:
    import numpy as np

    from repro_torch.sim import fig4_dynamic, fig4_static

    rows = {}
    for name, fn in (("fig4_static", fig4_static),
                     ("fig4_dynamic", fig4_dynamic)):
        t0 = time.monotonic()
        res = fn(**FIG4_KW)
        sec = time.monotonic() - t0
        rows[name] = [(m, c.fixed_T, c.relative_runtime, c.oracle_gap)
                      for m, cs in sorted(res.items()) for c in cs]
        print(f"[5] {name}: {len(rows[name])} rows in {sec:.2f} s "
              f"(mtbf, fixed_T, rel_runtime %, oracle_gap)", flush=True)
        for r in rows[name]:
            print(f"    {r[0]:.0f} {r[1]:.0f} {r[2]:.1f} {r[3]:.3f}",
                  flush=True)
        REPORT[name] = dict(seconds=sec, rows=rows[name])
    static = np.array([r[2] for r in rows["fig4_static"]])
    gaps = np.array([r[3] for name in rows for r in rows[name]])
    if (static > 100.0).sum() < 16:
        fail(f"only {(static > 100.0).sum()}/18 fig4_static rows > 100%")
    if not ((gaps >= 0.95) & (gaps <= 1.05)).all():
        fail(f"oracle_gap outside [0.95, 1.05]: {gaps}")


def _result_diff(a, b) -> dict:
    """Elements that differ per BatchResult field (floats: equal or both
    NaN)."""
    import dataclasses

    import numpy as np

    out = {}
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if not isinstance(x, np.ndarray):
            out[f.name] = int(x != y)
            continue
        same = x == y
        if x.dtype.kind == "f":
            same |= np.isnan(x) & np.isnan(y)
        out[f.name] = int((~same).sum())
    return out


def _flag_key(flags: dict) -> str:
    """The kernel instantiation a batch runs, as (store, het, shock, pm)."""
    from repro_torch.kernels import sim_step

    return sim_step.variant(flags["any_store"], flags["any_het"],
                            flags["any_shock"], flags["any_pm"])


def chunk_times(cells, reps: int = 20) -> dict:
    """One 256-step chunk of ``cells`` from the initial state, by CUDA
    events (mean of ``reps`` launches after one warm-up, the state reset
    before each), in turns: the Philox route, the pre-generated route, the
    kernel's generator on its own writing the chunk's draws followed by the
    pre-generated route on them, and the Philox route again."""
    import torch

    from repro_torch.kernels import sim_step
    from repro_torch.sim import engine
    from repro_torch.sim.draws import PhiloxDraws

    p_np = engine._pack(cells)
    flags = engine.batch_flags(cells, p_np)
    p = engine.from_reference(p_np, device="cuda")
    s0 = engine._init_state(p, 1)
    src = PhiloxDraws([c.seed for c in cells], flags["any_pm"], "cuda")
    n = engine.DEFAULT_CHUNK
    d = src.at(0, n)
    params = sim_step.pack_params(p)
    st0 = sim_step.pack_state(s0)
    st = st0.clone()
    taken = torch.zeros(-(-len(cells) // sim_step.WARP), dtype=torch.int32,
                        device="cuda")
    kw = dict(macro_threshold=0.05, **flags)

    def timed(fn) -> float:
        total = 0.0
        for i in range(reps + 1):
            st.copy_(st0)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            if i:
                total += a.elapsed_time(b)
        return total / reps

    def philox():
        sim_step.launch_philox(params, st, src.seeds, 0, n, taken, **kw)

    def generated_then_pregenerated():
        sim_step.launch(params, st, sim_step.philox_draws(src, 0, n), taken,
                        **kw)

    out = {"philox_ms": [timed(philox)]}
    out["pregenerated_ms"] = timed(
        lambda: sim_step.launch(params, st, d, taken, **kw))
    out["generated_then_pregenerated_ms"] = timed(generated_then_pregenerated)
    out["philox_ms"].append(timed(philox))
    out["steps_per_warp_max"] = int(taken.max())
    out["variant"] = _flag_key(flags)
    return out


FIG4_VS_PLAIN_MAX_STEPS = 1024   # to the end (1,536 / 2,048) until TP1-DR1
                                  # (1,536 / 2,048) until TP1-DR1


def phase_fig4_vs_plain() -> None:
    """The Fig. 4 batches (216 cells each) through run_cells with the kernel
    and with the plain step on the card, over FIG4_VS_PLAIN_MAX_STEPS
    steps: every BatchResult field equal; then the kernel's time a chunk
    at that batch (both routes)."""
    from repro_torch.sim import engine, run_cells
    from repro_torch.sim.experiments import (fig4_dynamic_entries,
                                             fig4_static_entries, grid_cells)

    for name, entries in (("fig4_static", fig4_static_entries()),
                          ("fig4_dynamic", fig4_dynamic_entries())):
        cells = grid_cells(entries, **FIG4_KW)
        key = _flag_key(engine.batch_flags(cells, engine._pack(cells)))
        t0 = time.monotonic()
        a = run_cells(cells, step="fused", max_steps=FIG4_VS_PLAIN_MAX_STEPS)
        b = run_cells(cells, step="scan", max_steps=FIG4_VS_PLAIN_MAX_STEPS)
        diff = _result_diff(a, b)
        REPORT[name]["vs_plain"] = dict(cells=len(cells), variant=key,
                                        mismatches=diff,
                                        seconds=time.monotonic() - t0)
        print(f"[7] {name} kernel vs plain step on the card: {len(cells)} "
              f"cells, variant (store, het, shock, pm) {key}, "
              f"{a.n_steps} steps; mismatches per field {diff}", flush=True)
        if any(diff.values()):
            fail(f"{name}: kernel and plain step disagree")
        t = chunk_times(cells)
        REPORT[name]["kernel"] = t
        print(f"[7] {name} kernel a 256-step chunk at B = {len(cells)} "
              f"(steps/warp max {t['steps_per_warp_max']}): in-kernel "
              f"Philox {t['philox_ms'][0]:.4f} / {t['philox_ms'][1]:.4f} ms, "
              f"pre-generated {t['pregenerated_ms']:.4f} ms, the generator "
              f"on its own then pre-generated "
              f"{t['generated_then_pregenerated_ms']:.4f} ms; compare_grid "
              f"{REPORT[name]['seconds']:.3f} s",
              flush=True)


def fleet_cells(B: int):
    from repro_torch.sim import CellSpec, PolicyConfig, scenario

    k = 1_000_000
    scen = scenario("constant", mtbf=250.0 * 1e6)
    pol = PolicyConfig(kind="adaptive", prior_mu=1.0 / (250.0 * 1e6),
                       prior_v=20.0, regime="gossip", gossip_period=600.0,
                       gossip_fanout=2)
    return [CellSpec(scenario=scen, policy=pol, seed=s, k=k, n_slots=4 * k,
                     work=1800.0, V=20.0, T_d=50.0) for s in range(B)]


def phase_fleet(B: int) -> dict:
    """The fleet grid through run_cells with the kernel (main path)."""
    import torch

    from repro_torch.sim import run_cells

    cells = fleet_cells(B)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    res = run_cells(cells, step="fused")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    mem = torch.cuda.max_memory_allocated()
    if not res.completed.all():
        fail(f"{int((~res.completed).sum())} fleet cells did not complete")
    return dict(cells=cells, res=res, wall=wall, mem=mem)


# Kernel names of the torch operations PhiloxDraws runs (reported only: a
# name can match other kernels).
PHILOX_OP_KERNELS = re.compile(r"(cos|sin|log1p|xor|shift|Xor|Shift)")


def phase_fleet_measure(run: dict) -> dict:
    """The fleet batch stage by stage on the host clock (where the time of
    run_cells goes), both routes against the plain step on one chunk
    (bitwise), the routes timed by CUDA events beside the plain step, the
    bound of each route, a profile of one warm run_cells (device time by
    kernel, idle share; no PhiloxDraws draws), and the plain scan path end
    to end (every BatchResult field equal to the kernel's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import sim_step
    from repro_torch.sim import engine, run_cells
    from repro_torch.sim.draws import PhiloxDraws

    cells, res, wall, mem = run["cells"], run["res"], run["wall"], run["mem"]
    B = len(cells)
    # run_cells' stages on the Philox route (no draws stage: the kernel
    # draws), host clock.
    stages = {}
    t = time.monotonic()
    p_np = engine._pack(cells)
    flags = engine.batch_flags(cells, p_np)
    stages["pack_s"] = time.monotonic() - t
    t = time.monotonic()
    p = engine.from_reference(p_np, device="cuda")
    s0 = engine._init_state(p, 1)
    torch.cuda.synchronize()
    stages["to_device_s"] = time.monotonic() - t
    t = time.monotonic()
    s_run, steps = sim_step.run_chunks(
        s0, p, PhiloxDraws([c.seed for c in cells], flags["any_pm"], "cuda"),
        chunk=engine.DEFAULT_CHUNK, max_steps=400_000, macro_threshold=0.05,
        **flags)
    torch.cuda.synchronize()
    stages["run_chunks_s"] = time.monotonic() - t
    t = time.monotonic()
    engine._result([s_run], p_np, steps)
    stages["result_s"] = time.monotonic() - t
    # One chunk: both routes against the plain step, bitwise; the plain
    # step's count of the cell-steps this data needs sets the bound.
    kw = dict(macro_threshold=0.05, **flags)
    n = engine.DEFAULT_CHUNK
    src = PhiloxDraws([c.seed for c in cells], flags["any_pm"], "cuda")
    d = src.at(0, n)
    cell_steps = torch.zeros(B, dtype=torch.int64, device="cuda")
    s2, taken2 = sim_step.fused_chunk_ref(s0, p, d, cell_steps=cell_steps,
                                          **kw)
    chunk_diff, worst = {}, 0.0
    for route, (s1, taken1) in (
            ("philox", _philox_chunk(s0, p, src, n, **kw)),
            ("pregenerated", sim_step.fused_chunk(s0, p, d, **kw))):
        torch.cuda.synchronize()
        diff, w = _state_diff(s1, s2)
        worst = max(worst, w)
        diff["steps_taken"] = int((taken1 != taken2).sum())
        chunk_diff[route] = diff
    key = _flag_key(flags)
    print(f"[7] fleet chunk, kernel vs plain step on the card: variant "
          f"(store, het, shock, pm) {key}; mismatches per route and field "
          f"{chunk_diff}", flush=True)
    if any(any(v.values()) for v in chunk_diff.values()):
        fail("fleet chunk: kernel and plain step disagree")
    times = chunk_times(cells)
    ms = sum(times["philox_ms"]) / 2
    pre_ms = times["pregenerated_ms"]
    gen_pre_ms = times["generated_then_pregenerated_ms"]
    wrapper_ms = cuda_ms(lambda: _philox_chunk(
        s0, p, PhiloxDraws(src.seeds.tolist(), flags["any_pm"], "cuda"), n,
        **kw), reps=5)
    plain_ms = cuda_ms(lambda: sim_step.fused_chunk_ref(s0, p, d, **kw))
    active = int(cell_steps.sum())
    L = p.trace_t.shape[1]
    n_draw = d.shape[1]
    param_state_bytes = 8 * (B * (len(sim_step.PARAM_ROWS)
                                  + 4 * len(sim_step.TAB4) + 2 + 2 * L)
                             + 2 * B * len(sim_step.STATE_ROWS))
    bytes_philox = param_state_bytes + 8 * B          # + the seeds
    bytes_pre = param_state_bytes + 8 * active * n_draw
    fp64_ops = active * (OPS_PER_FLEET_CELL_STEP + BOX_MULLER_OPS_PER_PM_STEP)
    int_ops = active * PHILOX_INT_OPS_PER_PM_STEP
    t_bytes = bytes_philox / HBM_BYTES_PER_S * 1e3
    t_fp64 = fp64_ops / FP64_OPS_PER_S * 1e3
    t_int = int_ops / INT32_OPS_PER_S * 1e3
    t_ops = max(t_fp64, t_int)
    pre_bytes_ms = bytes_pre / HBM_BYTES_PER_S * 1e3
    pre_ops_ms = active * OPS_PER_FLEET_CELL_STEP / FP64_OPS_PER_S * 1e3
    # A warm run_cells under the profiler: device time by kernel, idle
    # share against the unprofiled warm run's host-clock time, and no
    # PhiloxDraws draws (their torch kernels and their calls).
    calls = {"at": 0, "keys": 0}
    at_fn, keys_fn = PhiloxDraws.at, PhiloxDraws.keys

    def counted_at(self, step0, k):
        calls["at"] += 1
        return at_fn(self, step0, k)

    def counted_keys(self):
        calls["keys"] += 1
        return keys_fn(self)

    warm = []
    PhiloxDraws.at, PhiloxDraws.keys = counted_at, counted_keys
    try:
        for _ in range(2):
            t = time.monotonic()
            run_cells(cells)
            torch.cuda.synchronize()
            warm.append(time.monotonic() - t)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_cells(cells)
            torch.cuda.synchronize()
    finally:
        PhiloxDraws.at, PhiloxDraws.keys = at_fn, keys_fn
    rows = _kernel_rows(prof)
    dev_us = sum(r[1] for r in rows)
    kern_us = sum(r[1] for r in rows if "sim_step" in r[0])
    draw_kernels = [r[0][:80] for r in rows if PHILOX_OP_KERNELS.search(r[0])]
    profile_out = dict(warm_wall_s=warm, device_ms=dev_us / 1e3,
                       sim_step_ms=kern_us / 1e3,
                       kernels=sum(r[2] for r in rows), top=rows[:8],
                       philox_calls=calls, philox_op_kernels=draw_kernels)
    if dev_us > 0:
        profile_out["idle_share"] = 1.0 - dev_us / 1e6 / min(warm)
    print(f"[7] fleet run_cells profile: warm runs {warm} s, device time "
          f"{dev_us / 1e3:.3f} ms in {profile_out['kernels']} kernels "
          f"(sim_step {kern_us / 1e3:.3f} ms), idle share "
          f"{profile_out.get('idle_share', 'not measured')}; "
          f"PhiloxDraws draws and key derivations (each launches its torch "
          f"kernels) {calls}; kernels named like its operations "
          f"{draw_kernels}", flush=True)
    for name, us, cnt in rows[:8]:
        print(f"    {us / 1e3:8.3f} ms  {cnt:5d} x  {name[:70]}", flush=True)
    if any(calls.values()):
        fail("the fleet grid's Philox route generated draws outside the "
             "kernel")
    # The plain scan path end to end on the same batch.
    t1 = time.monotonic()
    res_scan = run_cells(cells, step="scan")
    torch.cuda.synchronize()
    scan_wall = time.monotonic() - t1
    scan_diff = _result_diff(res, res_scan)
    out = dict(cells=B, variant=key, wall_s=wall, cells_per_s=B / wall,
               n_steps=res.n_steps, max_memory_allocated=mem,
               kernel_ms_per_chunk=ms, philox_ms=times["philox_ms"],
               pregenerated_ms_per_chunk=pre_ms,
               generated_then_pregenerated_ms_per_chunk=gen_pre_ms,
               wrapper_ms_per_chunk=wrapper_ms,
               host_stages=stages, plain_ms_per_chunk=plain_ms,
               chunk_vs_plain=chunk_diff, max_abs_err=worst,
               steps_per_warp_max=times["steps_per_warp_max"],
               active_cell_steps=active, bytes=bytes_philox,
               fp64_ops=fp64_ops, int32_ops=int_ops,
               bound_bytes_ms=t_bytes, bound_fp64_ms=t_fp64,
               bound_int32_ms=t_int, bound_ops_ms=t_ops,
               pregenerated_bytes=bytes_pre,
               pregenerated_bound_bytes_ms=pre_bytes_ms,
               pregenerated_bound_ops_ms=pre_ops_ms, profile=profile_out,
               scan_wall_s=scan_wall, scan_vs_fused=scan_diff)
    REPORT["fleet"] = out
    print(f"[7] fleet grid: {B} cells x k=1e6 in {wall:.3f} s "
          f"({B / wall:.0f} cells/s), {res.n_steps} steps run, peak "
          f"{mem / 2**20:.1f} MiB; stages {stages}; kernel, in-kernel "
          f"Philox {ms:.4f} ms/chunk (with packing {wrapper_ms:.4f}), "
          f"pre-generated {pre_ms:.4f}, the generator on its own then "
          f"pre-generated {gen_pre_ms:.4f} vs plain {plain_ms:.1f} "
          f"ms/chunk (steps/warp max "
          f"{times['steps_per_warp_max']}); bound max({t_bytes:.4f} ms "
          f"bytes, {t_fp64:.4f} ms FP64, {t_int:.4f} ms INT32) = "
          f"{max(t_bytes, t_ops):.4f} ms, the pre-generated route's "
          f"max({pre_bytes_ms:.4f} ms bytes, {pre_ops_ms:.4f} ms FP64); plain "
          f"scan path end to end "
          f"{scan_wall:.2f} s, mismatches per field against the kernel's "
          f"run {scan_diff}", flush=True)
    if any(scan_diff.values()):
        fail("fleet grid: plain scan path and kernel path disagree")
    return out


# --------------------------------------------------------------------------- #
# The paper's main path closed: the per-peer form and the four sweeps
# --------------------------------------------------------------------------- #

def perpeer_cells():
    """G1's mixed per-peer batch: gossip cells at fanout 1, 3 and 8 with
    k = 2, 8, 16 and 32 and isolated cells at each k; pooled adaptive,
    fixed (with failure bursts to macro-step) and oracle cells; a
    heterogeneous gossip cell, a shocked isolated cell and a store gossip
    cell; a class-pooled gossip cell (k = 64) riding along."""
    import dataclasses

    from repro_torch.p2p import StoreSpec
    from repro_torch.sim import (CellSpec, PeerClass, PeerClassMix,
                                 PolicyConfig, ShockSpec, scenario)

    sc = scenario("constant", mtbf=4000.0)
    mix = PeerClassMix((PeerClass("stable"),
                        PeerClass("volatile", hazard_mult=3.0, speed=0.7,
                                  uplink_mult=0.5)), (0.6, 0.4))
    # 1 h of work a cell (4 h until C1-Z2 needed the time, 2 h until
    # TP1-DR1 did) -- the censored fixed-interval cell sets the depth
    kw = dict(work=1 * 3600.0, V=20.0, T_d=50.0, max_wall_time=16 * 3600.0)
    ad = dict(kind="adaptive", prior_mu=1 / 32000.0, prior_v=20.0)

    def gossip(fan, period=300.0):
        return PolicyConfig(regime="gossip", gossip_period=period,
                            gossip_fanout=fan, **ad)

    cells = []
    for k in (2, 8, 16, 32):
        cells += [CellSpec(scenario=sc, policy=gossip(f), k=k, **kw)
                  for f in (1, 3, 8)]
        cells.append(CellSpec(scenario=sc, policy=PolicyConfig(
            regime="isolated", **ad), k=k, **kw))
    cells += [
        CellSpec(scenario=sc, policy=PolicyConfig(**ad), **kw),
        CellSpec(scenario=scenario("constant", mtbf=1000.0),
                 policy=PolicyConfig(kind="fixed", fixed_T=3600.0), **kw),
        CellSpec(scenario=sc, policy=PolicyConfig(kind="oracle"), **kw),
        CellSpec(scenario=sc, policy=gossip(3), mix=mix, **kw),
        CellSpec(scenario=sc, policy=PolicyConfig(regime="isolated", **ad),
                 shock=ShockSpec(rate=2e-4, kill_frac=0.3), **kw),
        CellSpec(scenario=sc, policy=gossip(2, 600.0), store=StoreSpec(R=3),
                 **kw),
        CellSpec(scenario=sc, policy=gossip(2, 600.0), k=64, n_slots=256,
                 **kw)]
    return [dataclasses.replace(c, seed=i) for i, c in enumerate(cells)]


def _results_close(a, b) -> tuple:
    """(count fields that differ, the largest relative float difference)."""
    import numpy as np

    bad = [f for f in ("n_checkpoints", "n_failures", "n_server_restores",
                       "n_peer_restores", "completed")
           if not np.array_equal(getattr(a, f), getattr(b, f))]
    rel = 0.0
    for f in ("wall_time", "wasted_work", "checkpoint_time", "restore_time",
              "server_bytes"):
        x, y = getattr(a, f), getattr(b, f)
        r = np.abs(x - y) / np.maximum(np.abs(y), 1e-300)
        rel = max(rel, float(np.max(np.where(x == y, 0.0, r))))
    return bad, rel


def phase_perpeer_across_devices() -> None:
    """G1: the per-peer form through the plain step on the card against the
    same on the CPU with parity draws (counts exact, floats within 1e-9
    relative, macro-stepping on), no sim_step launch; then the Philox
    per-peer observation rows made on the card against those made on the
    CPU, bit for bit."""
    import torch

    from repro_torch.kernels import sim_step
    from repro_torch.sim import batch_step, run_cells
    from repro_torch.sim.draws import PhiloxDraws

    cells = perpeer_cells()
    if batch_step(cells) != "scan":
        fail("G1's batch does not need the per-peer form")
    before = sim_step.LAUNCHES
    t0 = time.monotonic()
    a = run_cells(cells, device="cuda", draws="numpy", step="scan",
                  chunk=128)
    torch.cuda.synchronize()
    card_s = time.monotonic() - t0
    b = run_cells(cells, device="cpu", draws="numpy", step="scan", chunk=128)
    bad, rel = _results_close(a, b)
    launched = sim_step.LAUNCHES - before
    seeds = [c.seed for c in cells] + [2**32 + 7, 2**40 + 3, -1, -2**40]
    obs = {}
    for step0 in (0, 2**32 - 3):
        x = PhiloxDraws(seeds, False, "cuda", 32).obs_at(step0, 256).cpu()
        y = PhiloxDraws(seeds, False, "cpu", 32).obs_at(step0, 256)
        obs[f"step0={step0}"] = [int((x[:, r] != y[:, r]).sum())
                                 for r in range(2)]
    REPORT["perpeer_across_devices"] = dict(
        cells=len(cells), n_steps=a.n_steps, card_s=card_s,
        count_mismatch=bad, max_rel_err=rel, sim_step_launches=launched,
        philox_obs_mismatches=obs)
    print(f"[G1] per-peer form, plain step, card vs CPU with parity draws: "
          f"{len(cells)} cells, {a.n_steps} steps ({card_s:.2f} s on the "
          f"card), count mismatches {bad}, max rel err {rel:.3g}, sim_step "
          f"launches {launched}; Philox per-peer rows card vs CPU, "
          f"mismatches (u3, z3): {obs}", flush=True)
    if bad or rel > 1e-9:
        fail("G1: card and CPU disagree on the per-peer form")
    if launched:
        fail("G1: a per-peer batch launched the sim_step kernel")
    if any(any(v) for v in obs.values()):
        fail("G1: the Philox per-peer rows differ between card and CPU")


class _Captured:
    """Records the cells of every ``run_cells`` call that ``module`` (by
    default ``repro_torch.sim.experiments``: the sweeps) makes, and in
    ``steps`` the steps the plain step runs: the most any warp took in
    each chunk."""

    def __init__(self, module=None):
        from repro_torch.sim import experiments

        self.module = module or experiments

    def __enter__(self):
        from repro_torch.kernels import sim_step

        self.cells, self.steps = [], 0
        self._run, self._ref = self.module.run_cells, sim_step.fused_chunk_ref

        def run(cells, **kw):
            self.cells.append(list(cells))
            return self._run(cells, **kw)

        def ref(*a, **kw):
            s, taken = self._ref(*a, **kw)
            self.steps += int(taken.max()) if taken.numel() else 0
            return s, taken

        self.module.run_cells, sim_step.fused_chunk_ref = run, ref
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import sim_step

        self.module.run_cells, sim_step.fused_chunk_ref = self._run, self._ref

    def batches(self) -> list:
        """(kernel variant, cells) of each recorded call."""
        from repro_torch.sim import engine

        return [(_flag_key(engine.batch_flags(c, engine._pack(c))), c)
                for c in self.cells]


def phase_gossip_sweep() -> dict:
    """G2, main path: ``gossip_fidelity_sweep`` at
    ``benchmarks/gossip_fidelity.py``'s settings on the card with Philox
    draws (a per-peer batch: the plain step, no sim_step launch).  Every
    cell completes; isolated's mean wall exceeds pooled's and gossip every
    300 s lies within 10% of pooled in each scenario.  Steps, seconds and
    seconds a step of one (cold) run -- a warm repeat ran beside it until
    TP1-DR1 needed the time; then ``torch.profiler`` over the first 32
    steps of a warm run of the same batch (device time by kernel, kernels
    a step, idle share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import sim_step
    from repro_torch.launch import paper_figs as PF
    from repro_torch.sim import gossip_fidelity_sweep, run_cells

    def sweep():
        return gossip_fidelity_sweep(
            PF._scenarios(PF.GOSSIP_MTBF), periods=PF.GOSSIP_PERIODS,
            fanouts=PF.GOSSIP_FANOUTS, mtbf0=PF.GOSSIP_MTBF, **PF.GOSSIP_KW)

    runs = []
    for _ in range(1):
        sim_step.LAUNCHES = 0
        with _Captured() as cap:
            t0 = time.monotonic()
            rows = sweep()
            torch.cuda.synchronize()
            sec = time.monotonic() - t0
        runs.append(dict(seconds=sec, steps=cap.steps,
                         s_per_step=sec / max(cap.steps, 1),
                         launches=sim_step.LAUNCHES))
    cells = cap.cells[0]
    out = dict(cells=len(cells), runs=runs,
               rows=[(c.scenario, c.regime, c.period, c.fanout, c.mean_wall,
                      c.inflation_pct, c.completed_frac) for c in rows])
    print(f"[G2] gossip_fidelity_sweep (main path): {len(cells)} cells, "
          f"{len(rows)} rows; cold {runs[0]['seconds']:.2f} s / "
          f"{runs[0]['steps']} steps ({runs[0]['s_per_step'] * 1e3:.2f} "
          f"ms/step); sim_step launches {[r['launches'] for r in runs]}",
          flush=True)
    for r in out["rows"]:
        print(f"    {r[0]:11s} {r[1]:8s} {r[2]:6.0f} {r[3]} wall "
              f"{r[4]:.1f} s inflation {r[5]:+.2f}% completed {r[6]:.3f}",
              flush=True)
    # The first 32 steps of a warm run under the profiler.
    n = 32
    walls = []
    for _ in range(2):
        t0 = time.monotonic()
        run_cells(cells, step="scan", max_steps=n, chunk=n)
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_cells(cells, step="scan", max_steps=n, chunk=n)
        torch.cuda.synchronize()
    prows = _kernel_rows(prof)
    dev_us = sum(r[1] for r in prows)
    kernels = sum(r[2] for r in prows)
    out["profile"] = dict(steps=n, wall_s=walls, device_ms=dev_us / 1e3,
                          kernels=kernels, kernels_per_step=kernels / n,
                          top=prows[:8])
    if dev_us > 0:
        out["profile"]["idle_share"] = 1.0 - dev_us / 1e6 / min(walls)
    print(f"[G2] profile of {n} warm steps: {min(walls):.3f} s unprofiled, "
          f"device time {dev_us / 1e3:.2f} ms in {kernels} kernels "
          f"({kernels / n:.0f} a step), idle share "
          f"{out['profile'].get('idle_share', 'not measured')}", flush=True)
    for name, us, cnt in prows[:8]:
        print(f"    {us / 1e3:8.3f} ms  {cnt:6d} x  {name[:70]}", flush=True)
    REPORT["gossip_sweep"] = out
    if any(r["launches"] for r in runs):
        fail("G2: the per-peer gossip sweep launched the sim_step kernel")
    if min(r[6] for r in out["rows"]) < 1.0:
        fail("G2: a gossip-sweep cell did not complete")
    for scen in {r[0] for r in out["rows"]}:
        wall = {(r[1], r[2]): r[4] for r in out["rows"] if r[0] == scen}
        pooled = wall[("pooled", 0.0)]
        if not wall[("isolated", 0.0)] > pooled:
            fail(f"G2: {scen}: isolated is not slower than pooled")
        g300 = [w for (reg, per), w in wall.items()
                if reg == "gossip" and per == 300.0]
        if not g300 or any(abs(w - pooled) >= 0.10 * pooled for w in g300):
            fail(f"G2: {scen}: gossip every 300 s is not within 10% of "
                 f"pooled")
    return out


def phase_kernel_sweeps() -> dict:
    """G3, main path: ``server_offload_sweep``, ``heterogeneity_sweep`` and
    ``correlated_churn_sweep`` at the reference's defaults but 12 h of work
    a cell (``G3_WORK``) on the card, through the kernel with Philox
    draws.  Every cell completes; R = 3 moves
    fewer server bytes and finishes sooner than R = 0 in every scenario;
    every heterogeneity row > 100% relative runtime with its oracle gap in
    [0.95, 1.05]; relative runtime at 2 shocks/h above that at 0 in every
    scenario.  Returns each sweep's cells (phase 7 holds them against the
    plain step) and the launches by route and variant."""
    import dataclasses

    import torch

    from repro_torch.kernels import sim_step
    from repro_torch.sim import (correlated_churn_sweep, heterogeneity_sweep,
                                 server_offload_sweep)

    sim_step.LAUNCHES = 0          # G3's main path starts here
    _zero(sim_step.LAUNCHES_BY_ROUTE)
    sim_step.LAUNCHES_BY_VARIANT.clear()
    out, cells = {}, {}
    for name, fn in (("offload", server_offload_sweep),
                     ("hetero", heterogeneity_sweep),
                     ("shock", correlated_churn_sweep)):
        before = dict(sim_step.LAUNCHES_BY_VARIANT)
        with _Captured() as cap:
            t0 = time.monotonic()
            rows = fn(work=G3_WORK)
            torch.cuda.synchronize()
            sec = time.monotonic() - t0
        cells[name] = cap.cells[0]
        launched = {k: v - before.get(k, 0)
                    for k, v in sim_step.LAUNCHES_BY_VARIANT.items()
                    if v - before.get(k, 0)}
        out[name] = dict(cells=len(cap.cells[0]), seconds=sec,
                         launches_by_variant=launched,
                         rows=[dataclasses.asdict(r) for r in rows])
        print(f"[G3] {name} sweep: {len(cap.cells[0])} cells in {sec:.2f} s, "
              f"launches by variant (store, het, shock, pm) {launched}",
              flush=True)
        for r in out[name]["rows"]:
            print(f"    {r}", flush=True)
    launches = dict(total=sim_step.LAUNCHES,
                    by_route=dict(sim_step.LAUNCHES_BY_ROUTE),
                    by_variant=dict(sim_step.LAUNCHES_BY_VARIANT))  # ... ends
    out["launches"] = launches
    REPORT["kernel_sweeps"] = out
    print(f"[G3] the sweeps' sim_step launches: {launches}", flush=True)
    if launches["by_route"]["pregenerated"] or launches["total"] == 0:
        fail("G3: the sweeps did not launch sim_step on the Philox route "
             "alone")
    for name, var in (("offload", "1000"), ("hetero", "0000"),
                      ("shock", "0010")):
        if set(out[name]["launches_by_variant"]) != {var}:
            fail(f"G3: the {name} sweep ran variants "
                 f"{out[name]['launches_by_variant']}, expected {var}")
    rows = {k: out[k]["rows"] for k in ("offload", "hetero", "shock")}
    if any(r["completed_frac"] < 1.0 for v in rows.values() for r in v):
        fail("G3: a sweep cell did not complete")
    for scen in {r["scenario"] for r in rows["offload"]}:
        by_r = {r["R"]: r for r in rows["offload"] if r["scenario"] == scen}
        if not (by_r[3]["mean_server_bytes"] < by_r[0]["mean_server_bytes"]
                and by_r[3]["mean_wall"] < by_r[0]["mean_wall"]):
            fail(f"G3: {scen}: R = 3 does not off-load the server")
    for r in rows["hetero"]:
        if not (r["relative_runtime"] > 100.0
                and 0.95 <= r["oracle_gap"] <= 1.05):
            fail(f"G3: heterogeneity row out of band: {r}")
    for scen in {r["scenario"] for r in rows["shock"]}:
        rel = {r["shocks_per_hour"]: r["relative_runtime"]
               for r in rows["shock"] if r["scenario"] == scen}
        if not rel[2.0] > rel[0.0]:
            fail(f"G3: {scen}: relative runtime at 2 shocks/h ({rel[2.0]}) "
                 f"is not above that at 0 ({rel[0.0]})")
    return dict(cells=cells, launches=launches)


def phase_entry_point() -> dict:
    """G4: ``python -m repro_torch.launch.paper_figs --fast`` on the card as
    a subprocess: exit 0 and every CSV header printed."""
    import os

    from repro_torch.launch import paper_figs as PF
    from repro_torch.sim import experiments as X

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.paper_figs",
                        "--fast"], capture_output=True, text=True, env=env,
                       cwd=str(ROOT), timeout=600)
    sec = time.monotonic() - t0
    lines = r.stdout.splitlines()
    headers = [PF.HEADER, X.OFFLOAD_CSV_HEADER, X.GOSSIP_CSV_HEADER,
               X.HETERO_CSV_HEADER, X.SHOCK_CSV_HEADER]
    missing = [h for h in headers if h not in lines]
    out = dict(rc=r.returncode, seconds=sec, lines=len(lines),
               missing_headers=missing, stderr=r.stderr[-4000:])
    REPORT["paper_figs_cli"] = out
    print(f"[G4] python -m repro_torch.launch.paper_figs --fast: exit "
          f"{r.returncode} in {sec:.1f} s, {len(lines)} lines, missing "
          f"headers {missing}; its timings:", flush=True)
    for line in r.stderr.splitlines()[-8:]:
        print(f"    {line}", flush=True)
    if r.returncode != 0 or missing:
        fail("G4: the paper_figs entry point failed")
    return out


def sweep_bound(p, active: int, fp64_per_step: int,
                int32_per_step: int) -> dict:
    """The least time of one chunk of a non-pm batch on the Philox route:
    bytes (parameters, state and seeds, as the fleet grid's bound counts
    them) against the FP64 instructions (the step's and Box-Muller's) and
    Philox's 32-bit integer operations of the ``active`` cell-steps this
    run's data needs."""
    from repro_torch.kernels import sim_step

    B, L = p.k.shape[0], p.trace_t.shape[1]
    nbytes = 8 * (B * (len(sim_step.PARAM_ROWS) + 4 * len(sim_step.TAB4)
                       + 2 + 2 * L) + 2 * B * len(sim_step.STATE_ROWS)) + 8 * B
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_fp64 = active * (fp64_per_step + BOX_MULLER_OPS_PER_STEP) \
        / FP64_OPS_PER_S * 1e3
    t_int = active * int32_per_step / INT32_OPS_PER_S * 1e3
    return dict(bytes=nbytes, bound_bytes_ms=t_bytes, bound_fp64_ms=t_fp64,
                bound_int32_ms=t_int,
                bound_ms=max(t_bytes, t_fp64, t_int),
                bound_by="bytes" if t_bytes >= max(t_fp64, t_int)
                else "operations")


# Phase 7's G3 comparisons run at most this many steps (the cells still
# running then are censored alike on both sides): the heterogeneity sweep
# runs 5,376 steps, its plain step on the card ~35 s of them; at 2,048 the
# heterogeneity and shock comparisons took 14.5 and 13.4 s, so 1,024 (the
# offload sweep's whole run) makes room for C1-Z2
SWEEP_VS_PLAIN_MAX_STEPS = 256    # 512 until TP7-TP8, 1,024 until TP1-DR1
                                  # needed the time


def phase_sweeps_vs_plain(sweep_cells: dict) -> dict:
    """Phase 7 for G3's variants: each sweep's batch through run_cells with
    the kernel and with the plain step on the card, for at most
    SWEEP_VS_PLAIN_MAX_STEPS steps (every BatchResult field equal), then
    one 256-step chunk of it by CUDA events on both routes, beside the
    plain step's chunk and the bound."""
    import torch

    from repro_torch.kernels import sim_step
    from repro_torch.sim import engine, run_cells
    from repro_torch.sim.draws import PhiloxDraws

    out = {}
    for name, cells in sweep_cells.items():
        p_np = engine._pack(cells)
        flags = engine.batch_flags(cells, p_np)
        key = _flag_key(flags)
        t0 = time.monotonic()
        a, b = (run_cells(cells, step=st, max_steps=SWEEP_VS_PLAIN_MAX_STEPS)
                for st in ("fused", "scan"))
        diff = _result_diff(a, b)
        vs_sec = time.monotonic() - t0
        print(f"[7] {name} sweep, kernel vs plain step on the card: "
              f"{len(cells)} cells, variant (store, het, shock, pm) {key}, "
              f"{a.n_steps} steps; mismatches per field {diff}", flush=True)
        if any(diff.values()):
            fail(f"{name} sweep: kernel and plain step disagree")
        t = chunk_times(cells)
        p = engine.from_reference(p_np, device="cuda")
        s0 = engine._init_state(p, 1)
        kw = dict(macro_threshold=0.05, **flags)
        d = PhiloxDraws([c.seed for c in cells], flags["any_pm"],
                        "cuda").at(0, engine.DEFAULT_CHUNK)
        cell_steps = torch.zeros(len(cells), dtype=torch.int64,
                                 device="cuda")
        sim_step.fused_chunk_ref(s0, p, d, cell_steps=cell_steps, **kw)
        plain_ms = cuda_ms(lambda: sim_step.fused_chunk_ref(s0, p, d, **kw))
        active = int(cell_steps.sum())
        ops = OPS_PER_POOLED_CELL_STEP + (REPLICA_DRAW_OPS
                                          if flags["any_store"] else 0)
        bound = sweep_bound(p, active, ops, PHILOX_INT_OPS_PER_STEP)
        ms = sum(t["philox_ms"]) / 2
        out[name] = dict(cells=len(cells), variant=key, n_steps=a.n_steps,
                         vs_plain_mismatches=diff, vs_plain_seconds=vs_sec,
                         ms=ms, philox_ms=t["philox_ms"],
                         pregenerated_ms=t["pregenerated_ms"],
                         generated_then_pregenerated_ms=t[
                             "generated_then_pregenerated_ms"],
                         plain_ms=plain_ms, active_cell_steps=active,
                         fp64_ops_per_cell_step=ops
                         + BOX_MULLER_OPS_PER_STEP,
                         steps_per_warp_max=t["steps_per_warp_max"],
                         **bound)
        print(f"[7] {name} sweep kernel ({key}) a 256-step chunk at B = "
              f"{len(cells)}: in-kernel Philox {t['philox_ms'][0]:.4f} / "
              f"{t['philox_ms'][1]:.4f} ms, pre-generated "
              f"{t['pregenerated_ms']:.4f} ms, plain {plain_ms:.1f} ms; "
              f"bound max({bound['bound_bytes_ms']:.4f} ms bytes, "
              f"{bound['bound_fp64_ms']:.4f} ms FP64, "
              f"{bound['bound_int32_ms']:.4f} ms INT32) = "
              f"{bound['bound_ms']:.4f} ms ({active} active cell-steps)",
              flush=True)
    REPORT["sweeps_vs_plain"] = out
    return out


# --------------------------------------------------------------------------- #
# mamba2 serving slice: the SSD kernel and the serve path
# --------------------------------------------------------------------------- #

ARCH = "mamba2-130m"
SERVE_SHAPE = dict(b=8, s=1024, h=24, p=64, n=128, chunk=256)
# zamba2-7b's prefill SSD at batch 8 x 1024 (112 heads of 64, d_state 64)
ZAMBA = "zamba2-7b"
ZAMBA_SSD_SHAPE = dict(b=8, s=1024, h=112, p=64, n=64, chunk=256)
SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS, SERVE_FORCED = 8, 1024, 32, 4
# the device kernels of each port kernel, as the profiler names them
SSD_KERNEL_NAMES = ("ssd_scan_kernel", "ssd_chunk_state_kernel",
                    "ssd_state_pass_kernel", "ssd_chunk_scan_kernel")
FLASH_KERNEL_NAMES = ("flash_attention_kernel", "flash_tc_kernel")
SSD_Y_TOL = 1e-2       # bf16 y: one rounding (2^-8 relative) + f32 reorder
SSD_F32_TOL = 1e-4     # float32 y and the final state: f32 sums reordered
LOGIT_TOL = 5e-2       # bf16 logits (tests/test_models_smoke.py's bound)
NOISE_FACTOR = 1.2     # bf16 logits may exceed LOGIT_TOL elementwise only
                       # where two plain paths do, by at most this factor


def ssd_inputs(b, s, h, p, n, dtype, seed, with_init, **_):
    """x, dt, A, B, C, initial state on the card, made as
    tests/test_kernels.py makes them, from a seeded generator."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    x = normal(b, s, h, p).to(dtype)
    dt = torch.nn.functional.softplus(normal(b, s, h)) * 0.1
    A = -torch.exp(normal(h) * 0.3)
    B = (normal(b, s, n) * 0.5).to(dtype)
    C = (normal(b, s, n) * 0.5).to(dtype)
    init = normal(b, h, p, n) if with_init else None
    return x, dt, A, B, C, init


def _gap(a, b, tol: float) -> dict:
    """How far a lies from b, in float32: max |a - b|, its largest ratio to
    tol + tol |b| (within tolerance when <= 1), the relative RMS gap, and
    whether a is finite."""
    a, b = a.float(), b.float()
    d = (a - b).abs()
    return dict(max_abs=float(d.max()),
                max_ratio=float((d / (tol + tol * b.abs())).max()),
                rel_rms=float(d.square().mean().sqrt()
                              / b.square().mean().sqrt()),
                finite=bool(a.isfinite().all()))


def _ok(g: dict) -> bool:
    return g["finite"] and g["max_ratio"] <= 1.0


def _zero(counts: dict) -> None:
    for k in counts:
        counts[k] = 0


def phase_ssd_kernel_vs_plain(hybrid_only: bool = False) -> float:
    """S1: the ssd_scan kernels against their plain version on the card.
    Each case runs the kernel its route names (bf16 at these shapes: the
    tensor-core kernels) and the SIMT kernel on the same inputs; the last
    two cases are zamba2-7b's prefill shape (H2; ``hybrid_only`` runs
    those alone)."""
    import torch

    from repro_torch.kernels import ssd_scan

    sh = SERVE_SHAPE
    cases = [("serve, zero state", dict(sh), False),
             ("serve, random state", dict(sh), True),
             ("2 chunks, random state", dict(sh, b=2, s=512), True),
             ("s < Q", dict(sh, s=128), True),
             ("s = Q", dict(sh, s=256), False)]
    hybrid = [("zamba2-7b, zero state", dict(ZAMBA_SSD_SHAPE), False),
              ("zamba2-7b, random state", dict(ZAMBA_SSD_SHAPE), True)]
    cases = hybrid if hybrid_only else cases + hybrid
    worst, rows = 0.0, []
    for i, (name, shape, with_init) in enumerate(cases):
        x, dt, A, B, C, init = ssd_inputs(dtype=torch.bfloat16, seed=100 + i,
                                          with_init=with_init, **shape)
        Q = min(shape["chunk"], shape["s"])
        y_p, st_p = ssd_scan.ssd_scan_plain(x, dt, A, B, C,
                                            chunk=shape["chunk"],
                                            initial_state=init)
        routed = ssd_scan.route(x.dtype, shape["p"], shape["n"], Q)
        for how in dict.fromkeys((routed, "simt")):
            if how == routed:
                y, st = ssd_scan.ssd_scan(x, dt, A, B, C,
                                          chunk=shape["chunk"],
                                          initial_state=init)
            else:
                y, st = ssd_scan._launch(x, dt, A, B, C, init, Q, how)
            torch.cuda.synchronize()
            gy, gs = _gap(y, y_p, SSD_Y_TOL), _gap(st, st_p, SSD_F32_TOL)
            ey, es = gy["max_abs"], gs["max_abs"]
            worst = max(worst, ey, es)
            rows.append(dict(case=name, shape=shape, route=how, y=gy,
                             state=gs, ok=_ok(gy) and _ok(gs)))
            tag = "S1, H2" if name.startswith("zamba2") else "S1"
            print(f"[{tag}] ssd_scan {how} kernel vs plain on the card, "
                  f"{name} {shape}: max |dy| {ey:.3g} = "
                  f"{gy['max_ratio']:.3f} x "
                  f"(tol {SSD_Y_TOL}), max |dstate| {es:.3g} = "
                  f"{gs['max_ratio']:.3f} x (tol {SSD_F32_TOL})", flush=True)
    REPORT["ssd_kernel_vs_plain"] = REPORT.get("ssd_kernel_vs_plain",
                                               []) + rows
    if not all(r["ok"] for r in rows):
        fail("ssd_scan kernel differs from its plain version")
    if {r["route"] for r in rows} != {"mma", "simt"}:
        fail("S1 did not run both ssd_scan kernels")
    return worst


def _prompt_batch(prompt, frames=None) -> dict:
    """A prefill batch: the prompt, and the encdec model's frames."""
    return {"tokens": prompt} if frames is None else {"tokens": prompt,
                                                      "frames": frames}


def _serve_run(model, cfg, prompt, forced, cache_dtype=None, frames=None):
    """Prefill (of the encdec model: with its ``frames``) + teacher-forced
    decode steps: the last-position logits of each and the caches (the KV
    cache, where there is one, in ``cache_dtype``, default bf16)."""
    import torch

    from repro_torch.serve.step import make_prefill_step, make_serve_step

    pre = make_prefill_step(cfg, max_seq=prompt.shape[1] + forced.shape[1],
                            cache_dtype=cache_dtype or torch.bfloat16)
    srv = make_serve_step(cfg)
    logits, cache = pre(model, _prompt_batch(prompt, frames))
    out = [logits[:, -1]]
    first_cache = cache
    for k in range(forced.shape[1]):
        logits, cache = srv(model, cache, {"tokens": forced[:, k:k + 1]})
        out.append(logits[:, -1])
    return out, first_cache


def phase_serve_card_vs_cpu() -> dict:
    """The SMOKE config in float32 with the kernel on: the card against the
    plain version on the CPU."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params

    cfg = get_smoke_config(ARCH).replace(param_dtype="float32",
                                         compute_dtype="float32",
                                         use_flash_kernel=True)
    from repro_torch.kernels import ssd_scan

    g = torch.Generator().manual_seed(7)
    toks = torch.randint(0, cfg.vocab, (2, 44), generator=g)
    models = {dev: init_params(0, cfg, device=dev) for dev in ("cuda", "cpu")}
    gaps = []
    _zero(ssd_scan.LAUNCHES_BY_ROUTE)   # the float32 serving path starts here
    for n in (32, 40):            # 40 is off the chunk grid: padded
        res = {dev: _serve_run(m, cfg, toks[:, :n].to(dev),
                               toks[:, n:n + 4].to(dev))
               for dev, m in models.items()}
        pairs = list(zip(res["cuda"][0], res["cpu"][0])) + [
            (res["cuda"][1]["ssm"][k], res["cpu"][1]["ssm"][k])
            for k in ("state", "conv")]
        gaps += [_gap(a.cpu(), b, SSD_F32_TOL) for a, b in pairs]
    by_route = dict(ssd_scan.LAUNCHES_BY_ROUTE)   # ... and ends here
    errs = [g["max_abs"] for g in gaps]
    ok = all(_ok(g) for g in gaps)
    REPORT["serve_card_vs_cpu"] = dict(max_abs_err=max(errs), errs=errs,
                                       launches_by_route=by_route)
    print(f"[S2] mamba2 SMOKE float32, kernel on the card vs plain on the "
          f"CPU, prompts of 32 and 40 tokens: prefill + 4 decode logits and "
          f"caches, max |d| "
          f"{max(errs):.3g} (tol {SSD_F32_TOL}); ssd_scan launches by route "
          f"{by_route}", flush=True)
    if not ok:
        fail("mamba2 SMOKE: card and CPU disagree")
    if by_route["simt"] != 2 * cfg.n_layers or by_route["mma"]:
        fail(f"the float32 serving path launched {by_route}, expected "
             f"{2 * cfg.n_layers} SIMT launches (one per layer and prefill)")
    return REPORT["serve_card_vs_cpu"]


def serve_setup():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config(ARCH)
    assert cfg.use_flash_kernel
    t0 = time.monotonic()
    model = init_params(0, cfg, device="cuda")
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                           generator=g).cuda()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[S3] mamba2-130m: {n_params:,} parameters from the port's seeded "
          f"init in {time.monotonic() - t0:.1f} s", flush=True)
    return cfg, model, prompt


def phase_serve(cfg, model, prompt, n_tokens: int, frames=None) -> dict:
    """A serving main path: greedy_generate on the full config (the
    kernel path; the encdec model after its encoder's pass over
    ``frames``)."""
    import torch

    from repro_torch.serve import greedy_generate

    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    out = greedy_generate(model, cfg, prompt, n_tokens, frames=frames)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    mem = torch.cuda.max_memory_allocated()
    if tuple(out.shape) != (prompt.shape[0], n_tokens) or not bool(
            ((out >= 0) & (out < cfg.vocab)).all()):
        fail(f"{cfg.name} greedy_generate gave {tuple(out.shape)} tokens "
             f"out of range")
    return dict(tokens=out, wall=wall, mem=mem)


# the serving measurements (S3, A3, V3, V6, M2-M3, H4, E4): warm prefills
# timed (and as many of the plain path's after one warm-up), and decode
# steps timed (3, 3 and the whole 31 until TP7-TP8 needed the time)
MEASURE_PREFILLS, MEASURE_DECODE_STEPS = 2, 16


def phase_serve_measure(tag: str, cfg, model, prompt, run, n_tokens: int,
                        plain_path: str, frames=None) -> dict:
    """Prefill seconds and decode tokens/s through the step factories (warm:
    MEASURE_PREFILLS prefills, then MEASURE_DECODE_STEPS greedy steps of a
    cache sized for ``n_tokens``), then the plain path's prefill
    (``use_flash_kernel=False``: mamba2's ssd_chunked, the dense family's
    _attention_core) on the same parameters and prompt (and the encdec
    model's frames)."""
    import torch

    from repro_torch.serve.step import make_prefill_step, make_serve_step

    batch, n_prompt = prompt.shape
    inputs = _prompt_batch(prompt, frames)
    max_seq = n_prompt + n_tokens
    pre = make_prefill_step(cfg, max_seq=max_seq)
    srv = make_serve_step(cfg)
    times = []
    for _ in range(MEASURE_PREFILLS):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        logits, cache = pre(model, inputs)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
    tok = logits[:, -1].argmax(-1)[:, None]
    n_dec = min(MEASURE_DECODE_STEPS, n_tokens - 1)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(n_dec):
        logits, cache = srv(model, cache, {"tokens": tok})
        tok = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    dec = time.monotonic() - t0
    tok_s = batch * n_dec / dec
    del cache
    # the plain path's prefill on the same input, warmed once
    plain_pre = make_prefill_step(cfg.replace(use_flash_kernel=False),
                                  max_seq=max_seq)
    plain_times = []
    for _ in range(MEASURE_PREFILLS + 1):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        plain_pre(model, inputs)
        torch.cuda.synchronize()
        plain_times.append(time.monotonic() - t0)
    plain_times = plain_times[1:]
    out = dict(batch=batch, prompt=n_prompt, tokens=n_tokens,
               greedy_wall_s=run["wall"], peak_bytes=run["mem"],
               prefill_s=times, plain_prefill_s=plain_times, decode_s=dec,
               decode_tok_s=tok_s)
    print(f"[{tag}] serve {cfg.name}, batch {batch}, prompt {n_prompt}, "
          f"{n_tokens} greedy tokens: greedy_generate {run['wall']:.3f} s "
          f"(first call), prefill {', '.join(f'{t:.4f}' for t in times)} s "
          f"(warm), decode {n_dec} steps in {dec:.3f} s = "
          f"{tok_s:.1f} tok/s, peak {run['mem'] / 2**30:.2f} GiB; plain "
          f"{plain_path} path prefill "
          f"{', '.join(f'{t:.4f}' for t in plain_times)} s (warm)",
          flush=True)
    return out


def phase_serve_vs_plain(cfg, model, prompt, run) -> dict:
    """Kernel path against the plain ssd_chunked path on the card: the
    last-position prefill logits and SERVE_FORCED teacher-forced decode
    steps' logits, same parameters, prompt and forced tokens.

    bf16 (the serving config): held elementwise at LOGIT_TOL + LOGIT_TOL
    |b|, as tests/test_models_smoke.py holds bf16 logits.  On a 24-layer
    bf16 stack two plain implementations of the same SSD (the kernel's
    plain version and ssd_chunked) can already cross that bound, so the
    run measures their gap, the noise floor, on the same input: the
    kernel path may exceed the bound only where the floor does, and by at
    most NOISE_FACTOR times the floor's ratio.  Its relative RMS gap is
    held at LOGIT_TOL.  float32 at full width (the same seeded
    parameters): held elementwise at SSD_F32_TOL.
    """
    import torch

    from repro_torch.kernels import ops, ssd_scan
    from repro_torch.models import init_params

    forced = run["tokens"][:, :SERVE_FORCED]
    plain_cfg = cfg.replace(use_flash_kernel=False)
    k_out, k_cache = _serve_run(model, cfg, prompt, forced)
    p_out, p_cache = _serve_run(model, plain_cfg, prompt, forced)
    # a second plain implementation in the kernel's place: its plain version
    with mock.patch.object(ops, "ssd_scan", ssd_scan.ssd_scan_plain):
        q_out, _ = _serve_run(model, cfg, prompt, forced)
    k, p, q = (torch.stack(o) for o in (k_out, p_out, q_out))
    bf16, floor = _gap(k, p, LOGIT_TOL), _gap(q, p, LOGIT_TOL)
    bf16["limit_ratio"] = max(1.0, NOISE_FACTOR * floor["max_ratio"])
    bf16["argmax_agree"] = float((k.argmax(-1) == p.argmax(-1)).float().mean())
    st_err = float((k_cache["ssm"]["state"] - p_cache["ssm"]["state"]
                    ).abs().max())
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    model32 = init_params(0, cfg32, device="cuda")
    k32, _ = _serve_run(model32, cfg32, prompt, forced)
    p32, _ = _serve_run(model32, cfg32.replace(use_flash_kernel=False),
                        prompt, forced)
    f32 = _gap(torch.stack(k32), torch.stack(p32), SSD_F32_TOL)
    del model32
    out = dict(bf16=bf16, bf16_plain_vs_plain=floor, bf16_state_err=st_err,
               f32=f32)
    REPORT["serve_vs_plain"] = out
    print(f"[S4] mamba2-130m kernel path vs plain ssd_chunked path on the "
          f"card, prefill + {SERVE_FORCED} teacher-forced decode logits: "
          f"bf16 rel RMS {bf16['rel_rms']:.4g} (tol {LOGIT_TOL}), max |d| "
          f"{bf16['max_abs']:.4g} = {bf16['max_ratio']:.3f} x "
          f"({LOGIT_TOL} + {LOGIT_TOL}|b|) (limit "
          f"{bf16['limit_ratio']:.3f} x), argmax agree "
          f"{bf16['argmax_agree']:.3f}, max |dstate| {st_err:.3g}; noise "
          f"floor (kernel's plain version vs ssd_chunked): rel RMS "
          f"{floor['rel_rms']:.4g}, max |d| {floor['max_abs']:.4g} = "
          f"{floor['max_ratio']:.3f} x; float32 at full width: max |d| "
          f"{f32['max_abs']:.3g} = {f32['max_ratio']:.4f} x ({SSD_F32_TOL} "
          f"+ {SSD_F32_TOL}|b|)", flush=True)
    if not (bf16["finite"] and bf16["max_ratio"] <= bf16["limit_ratio"]
            and bf16["rel_rms"] <= LOGIT_TOL and _ok(f32)):
        fail("mamba2-130m: kernel path and plain path disagree")
    return out


def _kernel_rows(prof) -> list:
    """(name, device microseconds, count) of each kernel a profile saw.
    Only the device's own rows: an operator's row repeats the time of the
    kernels it launched."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        rows.append((e.key, float(us), e.count))
    return sorted(rows, key=lambda r: -r[1])


def _operator_kernels(prof, skip: tuple = ()):
    """(event, its kernels' device microseconds, the names of its
    ancestors) for every CPU event that launched kernels, leaving out the
    kernels whose names hold one of ``skip`` and CUPTI's "Command Buffer
    Full" events: the host waiting on a full launch queue, which carry
    kernels their operators carry too (at zamba2-7b's prefill ~110 ms of
    ~820, which would otherwise be counted twice)."""
    from torch.autograd import DeviceType

    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels \
                or e.name == "Command Buffer Full":
            continue
        own = sum(k.duration for k in e.kernels
                  if not any(n in k.name for n in skip))
        up, p = set(), e.cpu_parent
        while p is not None:
            up.add(p.name)
            p = p.cpu_parent
        yield e, own, up


def phase_serve_profile(tag: str, cfg, model, prompt, n_tokens: int,
                        kernels: tuple) -> dict:
    """Where the serving time goes: ``torch.profiler`` over one warm
    prefill and 5 decode steps; device time by kernel (the share of the
    prefill of the kernels whose names hold one of ``kernels``: the port's
    kernel), kernels per step, and the device's idle share: each profiled
    run's device time against its own host-clock wall (kernels run one at
    a time on the one stream)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.step import make_prefill_step, make_serve_step

    pre = make_prefill_step(cfg, max_seq=prompt.shape[1] + n_tokens)
    srv = make_serve_step(cfg)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {}
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, cache = pre(model, {"tokens": prompt})
        torch.cuda.synchronize()
        pre_wall = time.perf_counter() - t0
    tok = logits[:, -1].argmax(-1)[:, None]
    rows = _kernel_rows(prof)
    total = sum(r[1] for r in rows)
    mine = sum(r[1] for r in rows if any(k in r[0] for k in kernels))
    kernel = kernels[0].replace("_kernel", "")
    top = rows[:8]
    out["prefill"] = dict(device_ms=total / 1e3, kernel=kernel,
                          kernel_ms=mine / 1e3,
                          kernels=sum(r[2] for r in rows), top=top)
    steps = 5
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = srv(model, cache, {"tokens": tok})
        torch.cuda.synchronize()
        dec_wall = (time.perf_counter() - t0) / steps
    rows = _kernel_rows(prof)
    total_d = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows)
    out["decode"] = dict(device_ms_per_step=total_d / 1e3 / steps,
                         kernels_per_step=launches / steps,
                         top=rows[:6])
    if total <= 0 or total_d <= 0:
        out["note"] = "the profiler recorded no device time: not measured"
        print(f"[{tag}] {cfg.name} serve profile: {out['note']}", flush=True)
    else:
        out["prefill"]["profiled_wall_s"] = pre_wall
        out["decode"]["profiled_wall_s_per_step"] = dec_wall
        out["prefill"]["idle_share"] = 1.0 - total / 1e6 / pre_wall
        out["decode"]["idle_share"] = (1.0 - total_d / 1e6 / steps
                                       / dec_wall)
        print(f"[{tag}] {cfg.name} serve profile: prefill device time "
              f"{total / 1e3:.2f} ms ({kernel} {mine / 1e3:.2f} ms = "
              f"{mine / total:.1%}), {out['prefill']['kernels']} kernels, "
              f"idle share against its own {pre_wall:.4f} s "
              f"{out['prefill']['idle_share']:.1%}; decode device time "
              f"{total_d / 1e3 / steps:.2f} ms/step, "
              f"{launches / steps:.0f} kernels/step, idle share against "
              f"its own {dec_wall * 1e3:.2f} ms/step "
              f"{out['decode']['idle_share']:.1%}", flush=True)
        for name, us, n in top:
            print(f"    prefill {us / 1e3:8.3f} ms  {n:5d} x  {name[:70]}",
                  flush=True)
        for name, us, n in out["decode"]["top"]:
            print(f"    decode  {us / 1e3 / steps:8.3f} ms/step  "
                  f"{n / steps:5.0f} x  {name[:60]}", flush=True)
    return out


def ssd_work(b, s, h, p, n, chunk, x_bytes, with_init):
    """Bytes the scan must move (each input read once, each output written
    once) and its float operations: C B^T once per (batch, chunk) on the
    i >= j half (bf16 operands), and per head the masked scores times
    dt x, C state^T and (dt x decay)^T B (float32 operands)."""
    nc = s // chunk
    tri = chunk * (chunk + 1) // 2
    ops_bf16 = 2 * b * nc * tri * n
    ops_f32 = 2 * b * h * nc * (tri * p + 2 * chunk * p * n)
    nbytes = (x_bytes * (2 * b * s * h * p + 2 * b * s * n)
              + 4 * (b * s * h + h) + 4 * b * h * p * n * (2 if with_init
                                                           else 1))
    return nbytes, ops_bf16, ops_f32


def phase_ssd_measure(sh: dict = SERVE_SHAPE, tag: str = "S6") -> dict:
    """S6 (and H2 at zamba2-7b's shape): both ssd_scan kernels and their
    plain version timed at a serving shape, and the bound.  ``bound_ms``
    is the least time over the routes the card has: the bytes, or every
    operation at the bf16 tensor rate (the tensor-core route issues the
    float32-operand products as three bf16 passes, but the work is counted
    once); ``f32_simt_bound_ms`` is the bound of the SIMT kernel, whose
    products run at the float32 SIMT rate."""
    import torch

    from repro_torch.kernels import ssd_scan

    x, dt, A, B, C, init = ssd_inputs(dtype=torch.bfloat16, seed=200,
                                      with_init=True, **sh)
    Q = sh["chunk"]
    routed = ssd_scan.route(x.dtype, sh["p"], sh["n"], Q)

    def kern():
        return ssd_scan.ssd_scan(x, dt, A, B, C, chunk=Q, initial_state=init)

    def simt():
        return ssd_scan._launch(x, dt, A, B, C, init, Q, "simt")

    def plain():
        return ssd_scan.ssd_scan_plain(x, dt, A, B, C, chunk=Q,
                                       initial_state=init)

    # in turns: kernel, SIMT, SIMT, kernel
    ms_a, simt_a = cuda_ms(kern, reps=20), cuda_ms(simt, reps=10)
    simt_b, ms_b = cuda_ms(simt, reps=10), cuda_ms(kern, reps=20)
    plain_ms = cuda_ms(plain, reps=3)
    nbytes, ops_bf16, ops_f32 = ssd_work(x_bytes=2, with_init=True, **sh)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_tc = (ops_bf16 + ops_f32) / BF16_TC_OPS_PER_S * 1e3
    t_simt = max(ops_bf16 / BF16_TC_OPS_PER_S, ops_f32 / FP32_OPS_PER_S) * 1e3
    out = dict(shape=sh, route=routed, ms=min(ms_a, ms_b), ms_runs=[ms_a, ms_b],
               simt_ms=min(simt_a, simt_b), simt_ms_runs=[simt_a, simt_b],
               plain_ms=plain_ms, bytes=nbytes, ops_bf16=ops_bf16,
               ops_f32=ops_f32, bound_bytes_ms=t_bytes,
               bound_ops_ms=t_tc, bound_ms=max(t_bytes, t_tc),
               bound_by="bytes" if t_bytes >= t_tc else "operations",
               f32_simt_bound_ms=max(t_bytes, t_simt))
    REPORT["ssd_measure" if tag == "S6" else f"ssd_measure_{tag}"] = out
    print(f"[{tag}] ssd_scan at {sh}: {routed} kernels {ms_a:.4f}, "
          f"{ms_b:.4f} ms; "
          f"SIMT kernel {simt_a:.4f}, {simt_b:.4f} ms; plain {plain_ms:.3f} "
          f"ms; bound {out['bound_ms']:.4f} ms ({out['bound_by']}: "
          f"{nbytes:,} B at 3.35 TB/s = {t_bytes:.4f} ms; {ops_f32:,} flop "
          f"with a float32 operand + {ops_bf16:,} bf16 flop at the bf16 "
          f"tensor rate = {t_tc:.4f} ms); the SIMT kernel's bound at the "
          f"float32 SIMT rate {out['f32_simt_bound_ms']:.4f} ms", flush=True)
    return out


# --------------------------------------------------------------------------- #
# olmo-1b serving slice: the flash-attention kernel and the dense serve path
# --------------------------------------------------------------------------- #

OLMO = "olmo-1b"
OLMO_BATCH, OLMO_PROMPT, OLMO_TOKENS, OLMO_FORCED = 8, 1024, 32, 4
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py's
# bf16 also holds the relative RMS gap: at 1,500 unit-normal keys (D 64,
# scale 1/8) an output element's standard deviation is ~sqrt(e/1500) =
# 0.043, about half of 2e-2 + 2e-2|b|, so the elementwise bound alone
# passes an output scaled by a few percent.  Sound wgmma runs read
# 0.9e-3-2.4e-3; the zero-filled keys of a part tile left visible read
# ~1.4e-2 at 1,500 keys (padded_keys_control)
FLASH_BF16_RMS = 1e-2
OLMO_F32_TOL = 1e-4    # float32 logits and caches (card vs CPU, A4 float32)
# (BG, R, Sq, Skv, D) of the timed shapes: olmo-1b's prefill at batch 8
# (16 heads, kv 16) and starcoder2-3b's 24 heads over kv 2 at batch 8
FLASH_OLMO_SHAPE = (128, 1, 1024, 1024, 128)
FLASH_GQA_SHAPE = (16, 12, 1024, 1024, 128)
# whisper-large-v3's prefill at batch 8 (20 heads, kv 20, head_dim 64):
# the encoder's unmasked self-attention over 1,500 frames (11 kv tiles of
# 128 and one of 92), the cross-attention of a 128-token prompt over them,
# and the decoder's causal self-attention
FLASH_WHISPER_ENC_SHAPE = (160, 1, 1500, 1500, 64)
FLASH_WHISPER_CROSS_SHAPE = (160, 1, 128, 1500, 64)
FLASH_WHISPER_SELF_SHAPE = (160, 1, 128, 128, 64)


def flash_inputs(bg, r, sq, skv, d, dtype, seed):
    """q, k, v standard normals on the card from a seeded generator."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in ((bg, r, sq, d), (bg, skv, d), (bg, skv, d))]


# The softcap's checks run with q scaled so that the scores s = scale q.k
# have this standard deviation (|s| up to ~150 over 1,024 keys): there
# tanh(s / 50) * 50 moves s by tens.  At unit-normal inputs it moves s by
# less than 0.01, and a kernel that dropped the softcap would pass.  The
# float32 cases stay at unit inputs: at scores of this size float32
# rounding of the scores alone takes 0.2-0.4 of the 2e-5 tolerance.
CAP_SCORE_STD = 30.0
# ... and the softcap must move the plain output by this many times the
# tolerance before the kernel's agreement with it counts
CAP_CONTROL = 10.0


def cap_scores(q, scale):
    """q scaled so that scale q.k has a standard deviation of CAP_SCORE_STD
    against unit-normal k."""
    return (q.float() * (CAP_SCORE_STD / (scale * q.shape[-1] ** 0.5))
            ).to(q.dtype)


def softcap_effect(q, k, v, kw, tol) -> dict:
    """How far the softcap moves the plain output on these inputs, as
    _gap's max_ratio of the uncapped output against the capped one, and
    the largest |score| of the first (BG) row."""
    import torch

    from repro_torch.kernels import flash_attention as FA

    capped = FA.flash_attention_plain(q, k, v, **kw)
    free = FA.flash_attention_plain(q, k, v, **{**kw, "softcap": None})
    s = torch.einsum("rsd,td->rst", q[0].float(), k[0].float()) * kw["scale"]
    return dict(control_ratio=_gap(free, capped, tol)["max_ratio"],
                max_score=float(s.abs().max()))


def _flash_ok(g: dict, dtype) -> bool:
    """A flash output within FLASH_TOL of its plain version, and bf16 also
    within FLASH_BF16_RMS relative RMS."""
    return _ok(g) and ("bfloat16" not in str(dtype)
                       or g["rel_rms"] <= FLASH_BF16_RMS)


def padded_keys_control(q, k, v, kw, want, tol) -> dict:
    """A planted fault for an unmasked call whose Skv is not a multiple of
    the 128-key tile: the plain attention over Skv rounded up to a
    multiple of 128 with the padded keys (k = v = 0, as TMA fills them)
    left visible, against the plain output ``want``, as :func:`_gap`
    gives it; ``_flash_ok`` must reject it."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA

    pad = -k.shape[1] % 128
    ctl = FA.flash_attention_plain(q, F.pad(k, (0, 0, 0, pad)),
                                   F.pad(v, (0, 0, 0, pad)), **kw)
    return dict(_gap(ctl, want, tol), padded_keys=pad)


def flash_work(bg, r, sq, skv, d, elt_bytes, causal=True, off=None,
               stats=False):
    """Bytes the attention must move (q, k, v read once, o written once;
    with ``stats`` also the rows' float32 m and l) and its operations: 4 d
    per visible (query, key) pair (q k^T and p v), the pairs this mask
    leaves (key j visible to row i iff j <= i + off, by default Skv -
    Sq)."""
    off = skv - sq if off is None else off
    rows = []
    for i in range(sq):
        rows.append(min(max(i + off + 1, 0), skv) if causal else skv)
    pairs = bg * r * sum(rows)
    nbytes = elt_bytes * (2 * bg * r * sq * d + 2 * bg * skv * d) \
        + (2 * 4 * bg * r * sq if stats else 0)
    return nbytes, 4 * d * pairs


def _strided(q, k, v):
    """Views of the same values that are not contiguous: q through a
    transposed copy, k and v as slices of one (BG, Skv, 2D) buffer."""
    import torch

    qs = q.transpose(0, 1).contiguous().transpose(0, 1)
    buf = torch.cat([k, v], dim=-1)
    d = k.shape[-1]
    return qs, buf[..., :d], buf[..., d:]


def phase_flash_kernel_vs_plain() -> float:
    """A1: the flash_attention kernels against their plain version on the
    card, at every listed shape; rows that see no key exactly 0.  Each case
    runs the kernel its route names; bf16 at head_dim 64 and 128 (the
    tensor-core kernel's) also runs the SIMT kernel on the same inputs."""
    import torch

    from repro_torch.kernels import flash_attention as FA

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("kernel_bench", (1, 2, 256, 256, 64), f32, True, None),
             ("kernel_bench", (1, 4, 512, 512, 128), f32, True, None)]
    for shape in ((2, 1, 128, 128, 64), (1, 4, 256, 256, 128),
                  (2, 2, 128, 384, 64), (1, 1, 512, 512, 128)):
        cases += [("test_kernels", shape, dt, True, None) for dt in (f32, bf16)]
    cases += [("softcap 50, causal", (1, 2, 128, 128, 64), f32, True, 50.0),
              ("softcap 50, no mask", (1, 2, 128, 128, 64), f32, False, 50.0),
              ("softcap 50, causal", (1, 2, 128, 128, 64), bf16, True, 50.0),
              ("softcap 50, no mask", (1, 2, 130, 130, 128), bf16, False,
               50.0),
              ("Sq < Skv, off grid", (2, 2, 100, 300, 64), bf16, True, None),
              ("Sq > Skv, zero rows", (1, 2, 200, 72, 64), f32, True, None),
              ("Sq > Skv, zero rows", (2, 1, 32, 16, 16), bf16, True, None),
              ("Sq > Skv, zero rows", (1, 2, 200, 72, 128), bf16, True, None),
              ("Sq > Skv, zero rows", (2, 3, 300, 170, 64), bf16, True, 50.0),
              ("off grid", (3, 2, 1000, 1000, 128), bf16, True, None),
              ("strided, off grid", (3, 2, 200, 260, 128), bf16, True, None),
              ("strided, off grid", (3, 2, 200, 260, 64), bf16, True, None),
              ("D 16", (4, 4, 40, 40, 16), f32, True, None),
              ("D 16", (4, 4, 24, 24, 16), bf16, True, 50.0),
              ("D 32", (2, 3, 70, 70, 32), f32, True, None),
              ("olmo-1b prefill", FLASH_OLMO_SHAPE, bf16, True, None),
              ("GQA serving", FLASH_GQA_SHAPE, bf16, True, None),
              ("whisper encoder, no mask", FLASH_WHISPER_ENC_SHAPE, bf16,
               False, None),
              ("whisper cross, no mask", FLASH_WHISPER_CROSS_SHAPE, bf16,
               False, None)]
    worst, rows = 0.0, []
    for i, (name, (bg, r, sq, skv, d), dt, causal, cap) in enumerate(cases):
        q, k, v = flash_inputs(bg, r, sq, skv, d, dt, 400 + i)
        if name.startswith("strided"):
            q, k, v = _strided(q, k, v)
        kw = dict(scale=d ** -0.5, causal=causal, softcap=cap)
        tol = FLASH_TOL[str(dt).split(".")[-1]]
        effect = {}
        if cap is not None and dt == bf16:
            q = cap_scores(q, kw["scale"])
            effect = softcap_effect(q, k, v, kw, tol)
        want = FA.flash_attention_plain(q, k, v, **kw)
        dead = max(sq - skv, 0) if causal else 0
        routed = FA.route(dt, d)
        for how in dict.fromkeys((routed, "simt")):
            if how == routed:
                out = FA.flash_attention(q, k, v, **kw)
            else:
                out = FA._launch(q, k, v, how, **kw)
            torch.cuda.synchronize()
            g = _gap(out, want, tol)
            g["zero_rows"] = dead
            g["zero_rows_exact"] = bool((out[:, :, :dead] == 0).all()) and \
                bool((want[:, :, :dead] == 0).all())
            ok = _flash_ok(g, dt) and g["zero_rows_exact"] and \
                out.dtype == dt and \
                effect.get("control_ratio", CAP_CONTROL) >= CAP_CONTROL
            worst = max(worst, g["max_abs"])
            rows.append(dict(case=name, shape=(bg, r, sq, skv, d),
                             dtype=str(dt), causal=causal, softcap=cap,
                             route=how, tol=tol, ok=ok, **g, **effect))
            print(f"[A1] flash_attention {how} kernel vs plain, {name} "
                  f"{(bg, r, sq, skv, d)} {str(dt).split('.')[-1]}"
                  f"{'' if causal else ', no mask'}"
                  f"{'' if cap is None else f', softcap {cap}'}: max |d| "
                  f"{g['max_abs']:.3g} = {g['max_ratio']:.3f} x ({tol} + "
                  f"{tol}|b|), rel RMS {g['rel_rms']:.3g}"
                  f"{f', {dead} zero rows exact' if dead else ''}"
                  + (f"; scores up to {effect['max_score']:.0f}, the "
                     f"softcap moves the plain output "
                     f"{effect['control_ratio']:.0f} x the tolerance"
                     if effect else ""), flush=True)
    REPORT["flash_kernel_vs_plain"] = rows
    if not all(r["ok"] for r in rows):
        fail("flash_attention kernel differs from its plain version (bf16 "
             f"also by relative RMS, limit {FLASH_BF16_RMS}; or a softcap "
             "case's softcap moved the plain output by less than "
             f"{CAP_CONTROL} x the tolerance)")
    if {r["route"] for r in rows} != {"wgmma", "simt"}:
        fail("A1 did not run both flash_attention kernels")
    return worst


def phase_olmo_card_vs_cpu() -> dict:
    """A2: the olmo SMOKE config in float32 with the kernel on, the card
    against the plain version on the CPU (float32 KV caches on both)."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import init_params

    cfg = get_smoke_config(OLMO).replace(param_dtype="float32",
                                         compute_dtype="float32",
                                         use_flash_kernel=True)
    g = torch.Generator().manual_seed(8)
    toks = torch.randint(0, cfg.vocab, (2, 48), generator=g)
    models = {dev: init_params(0, cfg, device=dev) for dev in ("cuda", "cpu")}
    gaps, launches = [], FA.LAUNCHES
    _zero(FA.LAUNCHES_BY_ROUTE)    # the float32 dense serving path starts here
    for n in (24, 40):
        res = {dev: _serve_run(m, cfg, toks[:, :n].to(dev),
                               toks[:, n:n + 8].to(dev),
                               cache_dtype=torch.float32)
               for dev, m in models.items()}
        pairs = list(zip(res["cuda"][0], res["cpu"][0])) + [
            (res["cuda"][1]["kv"][k], res["cpu"][1]["kv"][k])
            for k in ("k", "v")]
        gaps += [_gap(a.cpu(), b, OLMO_F32_TOL) for a, b in pairs]
    launches = FA.LAUNCHES - launches
    by_route = dict(FA.LAUNCHES_BY_ROUTE)   # ... and ends here
    errs = [g["max_abs"] for g in gaps]
    ok = (all(_ok(g) for g in gaps) and launches == 2 * cfg.n_layers
          and by_route["simt"] == launches)
    REPORT["olmo_card_vs_cpu"] = dict(max_abs_err=max(errs), errs=errs,
                                      kernel_launches=launches,
                                      launches_by_route=by_route)
    print(f"[A2] olmo SMOKE float32, kernel on the card ({launches} launches, "
          f"by route {by_route}) "
          f"vs plain on the CPU, prompts of 24 and 40 tokens: prefill + 8 "
          f"decode logits and KV caches, max |d| {max(errs):.3g} (tol "
          f"{OLMO_F32_TOL})", flush=True)
    if not ok:
        fail("olmo SMOKE: card and CPU disagree (or the kernel did not run)")
    return REPORT["olmo_card_vs_cpu"]


def olmo_setup():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config(OLMO)
    assert cfg.use_flash_kernel
    t0 = time.monotonic()
    model = init_params(0, cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (OLMO_BATCH, OLMO_PROMPT),
                           generator=g).cuda()
    n_params = sum(p.numel() for p in model.parameters())
    REPORT["olmo_init"] = dict(params=n_params, seconds=init_s)
    print(f"[A3] olmo-1b: {n_params:,} parameters from the port's seeded init "
          f"(CPU generator, moved to the card) in {init_s:.1f} s", flush=True)
    return cfg, model, prompt


def phase_dense_vs_plain(tag: str, cfg, model, prompt, run,
                         f32_layers=None) -> dict:
    """A4 and V4: the kernel path against the plain path
    (``_attention_core``) on the card, prefill + OLMO_FORCED teacher-forced
    decode logits, held as S4 holds the SSD path: bf16 within LOGIT_TOL +
    LOGIT_TOL |b| except where the same run's floor --
    ``flash_attention_plain`` in the kernel's place against
    ``_attention_core``, two plain implementations that differ in where
    they round (float32 against bf16 scores and probabilities) -- crosses
    it, by at most NOISE_FACTOR times the floor's ratio; relative RMS
    within LOGIT_TOL.  float32: the bf16 weights cast on the card (the
    first ``f32_layers`` blocks where given: gemma2-27b's 46 float32
    layers would need ~109 GB), float32 KV caches, elementwise within
    OLMO_F32_TOL."""
    import torch

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    forced = run["tokens"][:, :OLMO_FORCED]
    plain_cfg = cfg.replace(use_flash_kernel=False)
    moe = cfg.family == "moe"
    with RouteSpy() as k_routes:
        k_out, _ = _serve_run(model, cfg, prompt, forced)
    with RouteSpy() as p_routes:
        p_out, _ = _serve_run(model, plain_cfg, prompt, forced)
    with mock.patch.object(ops, "flash_attention", FA.flash_attention_plain), \
            RouteSpy() as q_routes:
        q_out, _ = _serve_run(model, cfg, prompt, forced)
    k, p, q = (torch.stack(o) for o in (k_out, p_out, q_out))
    bf16, floor = _gap(k, p, LOGIT_TOL), _gap(q, p, LOGIT_TOL)
    bf16["limit_ratio"] = max(1.0, NOISE_FACTOR * floor["max_ratio"])
    # moe: the floor's routes flip under bf16 noise as the kernel path's do
    # (M2/M3 report the share), and its relative RMS gap can cross
    # LOGIT_TOL too; there the relative RMS limit follows the floor's the
    # same way.  The dense models keep LOGIT_TOL.
    bf16["rms_limit"] = max(LOGIT_TOL, NOISE_FACTOR * floor["rel_rms"]) \
        if moe else LOGIT_TOL
    bf16["argmax_agree"] = float((k.argmax(-1) == p.argmax(-1)).float().mean())
    routes = {}
    if moe:     # the (layer-call, token, k) routes that flip under bf16 noise
        routes["bf16"] = route_gaps(k_routes.routes, p_routes.routes)
        routes["bf16_plain_vs_plain"] = route_gaps(q_routes.routes,
                                                   p_routes.routes)
        prefill = p_routes.routes[:cfg.n_layers]
        bf16["dropped_share_prefill"] = 1.0 - float(sum(
            r.kept.float().mean() for r in prefill)) / len(prefill)
    del k_out, p_out, q_out, k_routes, p_routes, q_routes
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32",
                        n_layers=f32_layers or cfg.n_layers)
    model32 = M.DenseLM(cfg32)                     # on the meta device
    kept = {n for n, _ in model32.named_parameters()}
    model32.load_state_dict({n: t.float() for n, t in
                             model.named_parameters() if n in kept},
                            assign=True)
    with RouteSpy() as p32_routes:
        p32, _ = _serve_run(model32, cfg32.replace(use_flash_kernel=False),
                            prompt, forced, cache_dtype=torch.float32)
    # moe: the kernel path on the plain path's routes; where its own choice
    # differs, the two experts must be a near tie
    with RouteSpy(force=[r.expert_ids for r in p32_routes.routes]
                  if moe else None) as k32_routes:
        k32, _ = _serve_run(model32, cfg32, prompt, forced,
                            cache_dtype=torch.float32)
    f32 = _gap(torch.stack(k32), torch.stack(p32), OLMO_F32_TOL)
    if moe:
        routes["f32"] = route_gaps(k32_routes.own, p32_routes.routes)
    del model32, k32, p32, k32_routes, p32_routes
    torch.cuda.empty_cache()
    out = dict(bf16=bf16, bf16_plain_vs_plain=floor, f32=f32,
               f32_layers=cfg32.n_layers, routes=routes)
    REPORT[f"{cfg.name}_vs_plain"] = out
    print(f"[{tag}] {cfg.name} kernel path vs plain _attention_core path on "
          f"the card, prefill + {OLMO_FORCED} teacher-forced decode logits: "
          f"bf16 "
          f"rel RMS {bf16['rel_rms']:.4g} (limit {bf16['rms_limit']:.4g}), "
          f"max |d| "
          f"{bf16['max_abs']:.4g} = {bf16['max_ratio']:.3f} x ({LOGIT_TOL} + "
          f"{LOGIT_TOL}|b|) (limit {bf16['limit_ratio']:.3f} x), argmax agree "
          f"{bf16['argmax_agree']:.3f}; noise floor (flash_attention_plain vs "
          f"_attention_core): rel RMS {floor['rel_rms']:.4g}, max |d| "
          f"{floor['max_abs']:.4g} = {floor['max_ratio']:.3f} x; float32 at "
          f"full width, {cfg32.n_layers} layers: max |d| "
          f"{f32['max_abs']:.3g} = {f32['max_ratio']:.4f} x ({OLMO_F32_TOL} "
          f"+ {OLMO_F32_TOL}|b|)", flush=True)
    if moe:
        print(f"[{tag}] {cfg.name}: the plain path's prefill drops "
              f"{bf16['dropped_share_prefill']:.4f} of its claims (capacity "
              f"factor {cfg.moe.capacity_factor})", flush=True)
    for name, r in routes.items():
        print(f"[{tag}] {cfg.name} routes, {name}: {r['differ']} of "
              f"{r['claims']:,} (layer-call, token, k) claims differ "
              f"(share {r['share']:.3g}), {r['moved']} to an expert the "
              f"token does not choose on the other path (share "
              f"{r['moved_share']:.3g}), within-capacity bits "
              f"{r['kept_differ']}; largest relative probability gap of a "
              f"differing claim {r['worst_rel_gap']:.3g}; examples "
              f"{r['examples'][:3]}", flush=True)
    if not (bf16["finite"] and bf16["max_ratio"] <= bf16["limit_ratio"]
            and bf16["rel_rms"] <= bf16["rms_limit"] and _ok(f32)):
        fail(f"{cfg.name}: kernel path and plain path disagree")
    if moe and routes["f32"]["worst_rel_gap"] > MOE_F32_NEAR_TIE:
        fail(f"{cfg.name}: float32 routes of the kernel path differ from the "
             f"plain path's beyond a near tie: {routes['f32']}")
    return out


def _sdpa(q, k, v, scale, causal=True, mask=None):
    """One PyTorch call computing the same attention (the library
    yardstick; never used by the port): q (BG, R, S, D) against k, v as
    (BG, 1, S, D), causal (top-left equals bottom-right at Sq = Skv),
    unmasked, or under an explicit boolean (Sq, Skv) ``mask``."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(
        q, k[:, None], v[:, None], attn_mask=mask,
        is_causal=causal and mask is None, scale=scale,
        enable_gqa=q.shape[1] > 1)


def phase_flash_measure() -> dict:
    """A6: both flash_attention kernels, their plain version and SDPA timed
    by CUDA events at olmo-1b's prefill shape and at the GQA shape, and
    the bound."""
    import torch

    from repro_torch.kernels import flash_attention as FA

    out = {}
    for name, shape in (("olmo-1b prefill", FLASH_OLMO_SHAPE),
                        ("GQA serving", FLASH_GQA_SHAPE)):
        bg, r, sq, skv, d = shape
        assert sq == skv
        q, k, v = flash_inputs(bg, r, sq, skv, d, torch.bfloat16, 500)
        scale = d ** -0.5
        routed = FA.route(q.dtype, d)

        def kern():
            return FA.flash_attention(q, k, v, scale=scale)

        def simt():
            return FA._launch(q, k, v, "simt", scale=scale, causal=True,
                              softcap=None)

        # in turns: kernel, SIMT, SIMT, kernel
        ms_a, simt_a = cuda_ms(kern, 20), cuda_ms(simt, 5)
        simt_b, ms_b = cuda_ms(simt, 5), cuda_ms(kern, 20)
        plain_ms = cuda_ms(lambda: FA.flash_attention_plain(q, k, v,
                                                            scale=scale), 3)
        lib_ms, lib_note, lib_gap = None, None, None
        try:
            lib = _sdpa(q, k, v, scale)
            lib_gap = _gap(lib, kern(), FLASH_TOL["bfloat16"])
            lib_ms = cuda_ms(lambda: _sdpa(q, k, v, scale), 20)
        except Exception as e:          # noqa: BLE001 - recorded, not hidden
            lib_note = f"{type(e).__name__}: {e}"[:300]
        nbytes, flops = flash_work(bg, r, sq, skv, d, 2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_TC_OPS_PER_S * 1e3
        row = dict(shape=shape, route=routed, ms=min(ms_a, ms_b),
                   ms_runs=[ms_a, ms_b], simt_ms=min(simt_a, simt_b),
                   simt_ms_runs=[simt_a, simt_b], plain_ms=plain_ms,
                   library_ms=lib_ms, library_note=lib_note,
                   library_equals_kernel=None if lib_gap is None
                   else _ok(lib_gap), library_gap=lib_gap, bytes=nbytes,
                   flops=flops, bound_bytes_ms=t_bytes, bound_ops_ms=t_ops,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   f32_simt_bound_ms=flops / FP32_OPS_PER_S * 1e3)
        out[name] = row
        if lib_ms is None:
            lib_txt = f"none ({lib_note})"
        else:
            lib_txt = (f"{lib_ms:.4f} ms (equals the kernel within 2e-2: "
                       f"{_ok(lib_gap)}, max |d| {lib_gap['max_abs']:.3g})")
        print(f"[A6] flash_attention at {name} {shape} bf16: {routed} kernel "
              f"{ms_a:.4f}, {ms_b:.4f} ms; SIMT kernel {simt_a:.4f}, "
              f"{simt_b:.4f} ms; plain {plain_ms:.4f} ms; "
              f"scaled_dot_product_attention {lib_txt}; bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {nbytes:,} B at "
              f"3.35 TB/s = {t_bytes:.4f} ms, {flops:,} flop at the bf16 "
              f"tensor rate = {t_ops:.4f} ms); at the float32 SIMT rate "
              f"{row['f32_simt_bound_ms']:.4f} ms", flush=True)
    REPORT["flash_measure"] = out
    return out


# --------------------------------------------------------------------------- #
# The dense variants: gemma2-27b on the main path, stablelm-1.6b,
# starcoder2-3b and qwen2-vl-7b beside it
# --------------------------------------------------------------------------- #

GEMMA = "gemma2-27b"
VARIANTS = (GEMMA, "stablelm-1.6b", "starcoder2-3b", "qwen2-vl-7b")
# V6's three models, with the depth each runs at (their published depth)
V6_ARCHS = ("stablelm-1.6b", "starcoder2-3b", "qwen2-vl-7b")
V4_F32_LAYERS = 2      # gemma2-27b's float32 check: 46 layers need ~109 GB
INT8_STEP_SHARE = 1e-3  # V2: codes off by one step, at most this share
# float32 operations of the attention softcap, tanh(s / cap) * cap, per
# visible score: the division, the tanh and the product (a math-library
# call counts as one)
SOFTCAP_OPS = 3


def variant_shape(cfg, batch: int = OLMO_BATCH, prompt: int = OLMO_PROMPT):
    """(BG, R, Sq, Skv, D), softcap and scale of the config's prefill
    attention at ``batch`` x ``prompt``."""
    a = cfg.attention
    scale = a.query_scale if a.query_scale is not None else \
        a.head_dim ** -0.5
    return ((batch * a.n_kv_heads, a.n_heads // a.n_kv_heads, prompt,
             prompt, a.head_dim), a.softcap, scale)


def flash_layers(cfg, prompt: int) -> int:
    """How many of a prefill's layers take the flash kernel's route: those
    whose sliding window, if any, is not narrower than the prompt."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    return sum(L.flash_route(cfg, q_offset=0, seq=prompt,
                             layer_is_local=M._layer_is_local_static(cfg, i))
               for i in range(cfg.n_layers))


def phase_variant_flash_vs_plain(archs: tuple = VARIANTS + (ZAMBA,)
                                 ) -> dict:
    """V1: the flash kernel against its plain version on the card at the
    four variants' and zamba2-7b's prefill shapes (bf16: the tensor-core
    route; zamba2's head_dim 112 zero-padded to 128), gemma2's with its
    softcap 50 and query scale 1/12, at A1's tolerance; then gemma2's
    shape with q scaled so the scores reach the cap (``cap_scores``),
    where the softcap must move the plain output by CAP_CONTROL x the
    tolerance.  At a padded head_dim the scale check: the kernel's output
    must lie nearer the plain version at the caller's scale (1/sqrt(112))
    than at 1/sqrt(128), the scale of the padded D (H2 runs zamba2's case
    alone)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA

    tol = FLASH_TOL["bfloat16"]
    cases = [(arch, arch, False) for arch in archs]
    if GEMMA in archs:
        cases.append((f"{GEMMA} at the cap", GEMMA, True))
    out = {}
    for name, arch, at_cap in cases:
        i = (VARIANTS + (f"{GEMMA} at the cap", ZAMBA)).index(name)
        (bg, r, sq, skv, d), cap, scale = variant_shape(get_config(arch))
        q, k, v = flash_inputs(bg, r, sq, skv, d, torch.bfloat16, 600 + i)
        kw = dict(scale=scale, causal=True, softcap=cap)
        effect = {}
        if at_cap:
            q = cap_scores(q, scale)
            effect = softcap_effect(q, k, v, kw, tol)
        want = FA.flash_attention_plain(q, k, v, **kw)
        before = FA.LAUNCHES_BY_ROUTE["wgmma"]
        got = FA.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        g = _gap(got, want, tol)
        g["route"] = FA.route(q.dtype, d)
        g["launched_wgmma"] = FA.LAUNCHES_BY_ROUTE["wgmma"] - before
        padded = FA.padded_head_dim(q.dtype, d)
        if padded != d:
            wrong = FA.flash_attention_plain(q, k, v, **{
                **kw, "scale": padded ** -0.5})
            effect = dict(padded_to=padded, scale_check=dict(
                gap_at_scale=g["max_abs"],
                gap_at_padded_scale=_gap(got, wrong, tol)["max_abs"],
                control_ratio=_gap(wrong, want, tol)["max_ratio"]))
            del wrong
        out[name] = dict(shape=(bg, r, sq, skv, d), softcap=cap, scale=scale,
                         **g, **effect)
        print(f"[V1] flash_attention {g['route']} kernel vs plain at "
              f"{arch}'s prefill {(bg, r, sq, skv, d)} bf16"
              f"{'' if cap is None else f', softcap {cap}'}, scale "
              f"{scale:.5f}: max |d| {g['max_abs']:.3g} = "
              f"{g['max_ratio']:.3f} x ({tol} + {tol}|b|)"
              + (f"; q scaled, scores up to {effect['max_score']:.0f}: the "
                 f"softcap moves the plain output "
                 f"{effect['control_ratio']:.0f} x the tolerance (at least "
                 f"{CAP_CONTROL:.0f})" if at_cap else ""), flush=True)
        if "scale_check" in effect:
            sc = effect["scale_check"]
            print(f"[V1, H2] {arch}: head_dim {d} padded to {padded}; the "
                  f"kernel's max |d| from the plain version at scale "
                  f"1/sqrt({d}) {sc['gap_at_scale']:.3g}, at 1/sqrt({padded})"
                  f" {sc['gap_at_padded_scale']:.3g} (the two plain outputs "
                  f"differ by {sc['control_ratio']:.2f} x the tolerance): "
                  f"nearer 1/sqrt({d}): "
                  f"{sc['gap_at_scale'] < sc['gap_at_padded_scale']}",
                  flush=True)
        del q, k, v, want, got
    REPORT["variant_flash_vs_plain"] = dict(
        REPORT.get("variant_flash_vs_plain", {}), **out)
    if not all(_ok(g) and g["route"] == "wgmma" and g["launched_wgmma"] == 1
               and g.get("control_ratio", CAP_CONTROL) >= CAP_CONTROL
               and g.get("scale_check", {}).get("gap_at_scale", 0.0)
               < g.get("scale_check", {}).get("gap_at_padded_scale", 1.0)
               for g in out.values()):
        fail("V1: the flash kernel differs from its plain version at a "
             "variant's shape (or left the tensor-core route, or the "
             "softcap moved the plain output at the cap by less than "
             f"{CAP_CONTROL} x the tolerance, or a padded head_dim's "
             "output lies nearer the padded D's scale)")
    return out


def phase_variants_card_vs_cpu() -> dict:
    """V2: each variant's SMOKE config in float32 (float32 KV cache) with
    the kernel on, prefill and 8 teacher-forced decode steps at 24- and
    40-token prompts, the card against the CPU: logits and caches within
    OLMO_F32_TOL.  At 40 tokens, wider than the SMOKE window of 32,
    gemma2's and starcoder2's local layers take ``_attention_core``.  Then
    the int8 KV cache (gemma2 SMOKE): ``quantize_kv`` of the same K/V
    bitwise on both devices; one decode step over the CPU's own prefill
    cache within OLMO_F32_TOL of the CPU's; the card's own prefill codes
    within one step of the CPU's, at most INT8_STEP_SHARE of them off (a
    value on a rounding boundary crosses it with the last bits of the two
    devices' products)."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models.layers import quantize_kv

    g = torch.Generator().manual_seed(9)
    toks = torch.randint(0, 256, (2, 48), generator=g)
    out, want_launches = {}, 0
    by_route0 = dict(FA.LAUNCHES_BY_ROUTE)
    for arch in VARIANTS:
        cfg = get_smoke_config(arch).replace(param_dtype="float32",
                                             compute_dtype="float32",
                                             use_flash_kernel=True)
        models = {dev: init_params(0, cfg, device=dev)
                  for dev in ("cuda", "cpu")}
        gaps = []
        for n in (24, 40):
            res = {dev: _serve_run(m, cfg, toks[:, :n].to(dev),
                                   toks[:, n:n + 8].to(dev),
                                   cache_dtype=torch.float32)
                   for dev, m in models.items()}
            pairs = list(zip(res["cuda"][0], res["cpu"][0])) + [
                (res["cuda"][1]["kv"][k], res["cpu"][1]["kv"][k])
                for k in ("k", "v")]
            gaps += [_gap(a.cpu(), b, OLMO_F32_TOL) for a, b in pairs]
            want_launches += flash_layers(cfg, n)
        out[arch] = dict(max_abs_err=max(x["max_abs"] for x in gaps),
                         ok=all(_ok(x) for x in gaps),
                         flash_layers={n: flash_layers(cfg, n)
                                       for n in (24, 40)})
        print(f"[V2] {arch} SMOKE float32, kernel on the card vs plain on "
              f"the CPU, prompts of 24 and 40 tokens: prefill + 8 decode "
              f"logits and KV caches, max |d| {out[arch]['max_abs_err']:.3g} "
              f"(tol {OLMO_F32_TOL}); flash layers a prefill "
              f"{out[arch]['flash_layers']}", flush=True)
    by_route = {k: FA.LAUNCHES_BY_ROUTE[k] - by_route0[k] for k in by_route0}
    # the int8 KV cache
    x = torch.randn(2, 2, 40, 16, generator=g) * 3
    x[0, 0, 3] = 0.0                      # an all-zero row: scale 1
    (qc, sc), (qg, sg) = quantize_kv(x), quantize_kv(x.cuda())
    quant_same = bool(torch.equal(qc, qg.cpu()) and torch.equal(sc, sg.cpu()))
    cfg = get_smoke_config(GEMMA).replace(
        param_dtype="float32", compute_dtype="float32", kv_cache_quant=True,
        use_flash_kernel=True)
    models = {dev: init_params(0, cfg, device=dev) for dev in ("cuda", "cpu")}
    q_toks = toks[:, :24]
    with torch.inference_mode():
        caches = {dev: prefill(m, q_toks[:, :-1].to(dev), cfg, 32)[1]
                  for dev, m in models.items()}
        steps = {k: (caches["cuda"]["kv"][k].cpu().int()
                     - caches["cpu"]["kv"][k].int()).abs()
                 for k in ("k", "v")}
        scale_rel = max(float(((caches["cuda"]["kv"][k].cpu()
                                / caches["cpu"]["kv"][k]) - 1).abs().max())
                        for k in ("k_scale", "v_scale"))
        moved = {"kv": {k: v.cuda() for k, v in caches["cpu"]["kv"].items()},
                 "index": caches["cpu"]["index"]}
        lg, _ = decode_step(models["cuda"], moved, q_toks[:, -1:].cuda(), cfg)
        lc, _ = decode_step(models["cpu"], caches["cpu"], q_toks[:, -1:], cfg)
    dec = _gap(lg.cpu(), lc, OLMO_F32_TOL)
    off = {k: int((d > 0).sum()) for k, d in steps.items()}
    n_codes = sum(d.numel() for d in steps.values())
    int8 = dict(quantize_kv_bitwise=quant_same, decode_over_cpu_cache=dec,
                codes_off_by_one=off, codes=n_codes,
                max_code_step=max(int(d.max()) for d in steps.values()),
                max_scale_rel=scale_rel)
    out["int8"] = int8
    out["launches_by_route"] = by_route
    out["expected_launches"] = want_launches
    REPORT["variants_card_vs_cpu"] = out
    print(f"[V2] flash launches of these prefills by route {by_route} "
          f"(expected {want_launches} SIMT); int8 KV cache (gemma2 SMOKE): "
          f"quantize_kv card == CPU bitwise: {quant_same}; decode over the "
          f"CPU's cache max |d| {dec['max_abs']:.3g} (tol {OLMO_F32_TOL}); "
          f"the card's own prefill codes off by one step {off} of "
          f"{n_codes} (largest step {int8['max_code_step']}), scales max rel "
          f"{scale_rel:.3g}", flush=True)
    if not all(r["ok"] for a, r in out.items() if a in VARIANTS):
        fail("V2: a variant's SMOKE config differs between card and CPU")
    if by_route["simt"] != want_launches or by_route["wgmma"]:
        fail(f"V2: the float32 prefills launched {by_route}, expected "
             f"{want_launches} SIMT launches")
    if not (quant_same and _ok(dec) and int8["max_code_step"] <= 1
            and sum(off.values()) <= INT8_STEP_SHARE * n_codes):
        fail("V2: the int8 KV cache differs between card and CPU")
    return out


def dense_setup(tag: str, arch: str, prompt_len: int = OLMO_PROMPT):
    """The full config, drawn on the card by a CUDA generator (seed 0), and
    a prompt of ``prompt_len`` tokens from a CPU generator (seed 1)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config(arch)
    assert cfg.use_flash_kernel
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    model = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (OLMO_BATCH, prompt_len),
                           generator=g).cuda()
    n_params = sum(p.numel() for p in model.parameters())
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    REPORT[f"{arch}_init"] = dict(params=n_params, weight_bytes=weights,
                                  seconds=init_s,
                                  peak_bytes=torch.cuda.max_memory_allocated())
    print(f"[{tag}] {arch}: {n_params:,} parameters ({weights / 1e9:.2f} GB) "
          f"drawn on the card in {init_s:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB while drawn",
          flush=True)
    return cfg, model, prompt


def serve_variant(tag: str, arch: str, f32_layers=None,
                  profile: bool = False) -> dict:
    """One dense variant's serving main path (V3 for gemma2-27b, V6 for
    the others): greedy_generate with the flash counts at 0 just before
    and read just after -- exactly one launch a layer, all on the
    tensor-core route -- then the timed prefill and decode, the plain
    path's prefill, the logits check against the plain path (V4) and,
    with ``profile``, the profiler (V5).  The model is freed after."""
    import torch

    from repro_torch.kernels import flash_attention as FA

    cfg, model, prompt = dense_setup(tag, arch)
    FA.LAUNCHES = 0                # this serving main path starts here
    _zero(FA.LAUNCHES_BY_ROUTE)
    run = phase_serve(cfg, model, prompt, OLMO_TOKENS)
    launches = FA.LAUNCHES         # ... and ends here
    by_route = dict(FA.LAUNCHES_BY_ROUTE)
    print(f"[{tag}] {arch} serving main path (greedy_generate, one prefill "
          f"of {cfg.n_layers} layers and {OLMO_TOKENS - 1} decode steps): "
          f"{launches} flash_attention launches, by route {by_route}",
          flush=True)
    want = flash_layers(cfg, OLMO_PROMPT)
    if launches != cfg.n_layers or want != cfg.n_layers or \
            by_route["wgmma"] != cfg.n_layers:
        fail(f"{arch}'s serving main path launched flash_attention "
             f"{launches} times ({by_route}), expected {cfg.n_layers} (one "
             f"per layer, prefill only), all on the tensor-core route")
    out = dict(launches=launches, launches_by_route=by_route)
    out["serve"] = phase_serve_measure(tag, cfg, model, prompt, run,
                                       OLMO_TOKENS, "_attention_core")
    torch.cuda.empty_cache()
    out["vs_plain"] = phase_dense_vs_plain(
        "V4" if arch == GEMMA else tag, cfg, model, prompt, run, f32_layers)
    if profile and cfg.family == "moe":
        out["profile"] = phase_moe_profile("M4", cfg, model, prompt,
                                           OLMO_TOKENS)
    elif profile:
        out["profile"] = phase_serve_profile(
            "V5", cfg, model, prompt, OLMO_TOKENS,
            FLASH_KERNEL_NAMES)
    del model, run
    torch.cuda.empty_cache()
    REPORT[f"{arch}_serving"] = out
    return out


def flash_bound(bg, r, sq, skv, d, softcap, causal=True, off=None,
                stats=False):
    """Bytes, tensor-core operations and softcap float32 operations of
    the attention (causal with the diagonal offset ``off``, or unmasked;
    with ``stats`` the rows' statistics written too), and the least time:
    the larger of the bytes at the memory rate and the operations at
    their rates (the tensor-core products and the softcap's float32 work
    may overlap)."""
    nbytes, flops = flash_work(bg, r, sq, skv, d, 2, causal, off, stats)
    cap_ops = SOFTCAP_OPS * flops // (4 * d) if softcap is not None else 0
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / BF16_TC_OPS_PER_S, cap_ops / FP32_OPS_PER_S) * 1e3
    return dict(bytes=nbytes, flops=flops, softcap_ops=cap_ops,
                bound_bytes_ms=t_bytes, bound_ops_ms=t_ops,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def phase_variant_flash_measure(archs: tuple = VARIANTS,
                                tag: str = "V7") -> dict:
    """V7 (and H2 at zamba2-7b's shape): the flash kernel (the tensor-core
    route; at zamba2's head_dim 112 the wrapper's pad copies included), its
    plain version and ``scaled_dot_product_attention`` timed by CUDA events
    at the variants' prefill shapes, beside the bound (counted at the
    unpadded head_dim).  SDPA has no softcap, so at gemma2's shape no
    library call computes the same function."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA

    out = {}
    for arch in archs:
        i = (VARIANTS + (ZAMBA,)).index(arch)
        (bg, r, sq, skv, d), cap, scale = variant_shape(get_config(arch))
        q, k, v = flash_inputs(bg, r, sq, skv, d, torch.bfloat16, 700 + i)

        def kern():
            return FA.flash_attention(q, k, v, scale=scale, softcap=cap)

        ms_a = cuda_ms(kern, 20)
        plain_ms = cuda_ms(lambda: FA.flash_attention_plain(
            q, k, v, scale=scale, softcap=cap), 3)
        ms_b = cuda_ms(kern, 20)
        lib_ms, lib_gap, lib_note = None, None, None
        if cap is not None:
            lib_note = "none: SDPA has no softcap"
        else:
            lib_gap = _gap(_sdpa(q, k, v, scale), kern(),
                           FLASH_TOL["bfloat16"])
            lib_ms = cuda_ms(lambda: _sdpa(q, k, v, scale), 20)
        row = dict(shape=(bg, r, sq, skv, d), softcap=cap, scale=scale,
                   route=FA.route(q.dtype, d), ms=min(ms_a, ms_b),
                   ms_runs=[ms_a, ms_b], plain_ms=plain_ms,
                   library_ms=lib_ms, library_note=lib_note,
                   library_equals_kernel=None if lib_gap is None
                   else _ok(lib_gap), library_gap=lib_gap,
                   **flash_bound(bg, r, sq, skv, d, cap))
        out[arch] = row
        lib_txt = lib_note if lib_ms is None else (
            f"{lib_ms:.4f} ms (equals the kernel within 2e-2: "
            f"{_ok(lib_gap)}, max |d| {lib_gap['max_abs']:.3g})")
        ops_txt = f"{row['flops']:,} flop at the bf16 tensor rate"
        if cap is not None:
            ops_txt += (f", {row['softcap_ops']:,} softcap operations at the "
                        f"float32 rate")
        print(f"[{tag}] flash_attention at {arch}'s prefill {row['shape']} "
              f"bf16"
              f"{'' if cap is None else f', softcap {cap}'}: {row['route']} "
              f"kernel {ms_a:.4f}, {ms_b:.4f} ms; plain {plain_ms:.4f} ms; "
              f"scaled_dot_product_attention {lib_txt}; bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}: "
              f"{row['bytes']:,} B at 3.35 TB/s = "
              f"{row['bound_bytes_ms']:.4f} ms; {ops_txt} = "
              f"{row['bound_ops_ms']:.4f} ms)", flush=True)
        del q, k, v
    REPORT["variant_flash_measure" if tag == "V7"
           else f"variant_flash_measure_{tag}"] = out
    return out


# --------------------------------------------------------------------------- #
# mamba2 training slice: the ckpt_quant kernels and the fault-tolerant trainer
# --------------------------------------------------------------------------- #

QBLOCK = 512
EMBED_LEAF = 50_280 * 768      # 38,615,040 elements: 75,420 blocks of 512
IN_PROJ_LEAF = 768 * 3_352     # 2,574,336 elements: 5,028 blocks
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 8, 1024, 2, 8
TRAIN_LAYERS = 8    # T3: mamba2-130m's depth cut (24 until TP5-TP6)
# The injector, picked on the CPU (its numpy streams are the same on the
# card): 64 nodes of MTBF 32,000 s at 60 virtual seconds a step, and fixed
# virtual overheads (V 5 s, T_d 12 s, the trainer tests' values) so that
# the clock, and with it every decision, does not hang on measured times.
# With seed 6 the adaptive policy commits 6 images; the one failure comes
# after the commit of step 4 and one step past it, so the run rolls back
# to step 4's image (restored in the loop, 1 wasted step) and restarts.
TRAIN_NODES, TRAIN_MTBF, TRAIN_STEP_S, TRAIN_INJECTOR_SEED = (
    64, 32000.0, 60.0, 6)
TRAIN_V, TRAIN_TD = 5.0, 12.0
# Error feedback: |new_err| <= scale / 2 (1 + 2^-15) in every block.  In
# exact arithmetic the residual is at most half a step; in float32, x /
# scale (|x / scale| <= 127.5) carries up to 2^-17 of a step before the
# rounding to an integer, q * scale and x - deq up to 2^-17 and 2^-25 more,
# so (0.5 + 2^-16 + 2^-25) steps in all.  The CPU rehearsal measured
# 1 + 4.4e-6, above 1 + 2^-20; the JAX package computes the same bits.
EF_SLACK = 1.0 + 2.0 ** -15
STEP_TOL = 1e-5                # T2: loss and master, card vs CPU, float32
# T2: elements whose nonzero CPU gradient is below ADAM_TINY_GRAD (Adam's
# step g / (|g| + eps) turns their float32 noise into a visible fraction of
# lr) are held to ADAM_TINY_STEP lr instead, and must be under 1% of the
# parameters: tests/test_torch_train.py's rule for three steps.
ADAM_TINY_GRAD, ADAM_TINY_STEP = 1e-6, 0.05


def quant_edge_cases():
    """(name, float64 values, block): the edge cases of the ckpt_quant
    kernels' contract, made from a numpy seed."""
    import numpy as np

    rng = np.random.default_rng(31)
    ties = rng.integers(-127, 127, 512) + 0.5
    ties[0] = 127.0                       # scale exactly 1.0: exact ties
    nonfinite = rng.standard_normal(3 * 512)
    nonfinite[[5, 512 + 7, 512 + 9, 1025, 1026]] = [np.nan, np.inf, -np.inf,
                                                    np.inf, np.nan]
    return [
        ("zero block", np.zeros(2 * 512), 512),
        ("ties", ties, 512),
        ("extremes", rng.uniform(-3e38, 3e38, 512), 512),
        ("single block", rng.standard_normal(512), 512),
        ("3 blocks", rng.standard_normal(3 * 512) * 1e-20, 512),
        ("257 blocks", rng.standard_normal(257 * 512) * 50.0, 512),
        ("block 32", rng.standard_normal(7 * 32), 32),
        ("block 96", rng.standard_normal(5 * 96), 96),
        ("block 4096", rng.standard_normal(3 * 4096), 4096),
        ("nan and inf", nonfinite, 512),
    ]


def _differ(a, b):
    """(elements that differ, largest |a - b| over the finite pairs): a NaN
    matches a NaN, an inf the same inf."""
    nan = a.isnan() & b.isnan()
    same = (a == b) | nan
    fin = a.isfinite() & b.isfinite()
    d = (a.double() - b.double()).abs()[fin]
    return int((~same).sum()), float(d.max()) if d.numel() else 0.0


def _quant_vs_plain(x, block: int):
    """Mismatching elements of the kernels against their plain versions
    (codes, scales, float32 and bf16 dequantized values) and the largest
    absolute difference."""
    import torch

    from repro_torch.kernels import ckpt_quant as Q

    q, s = Q.quantize_blocks(x, block)
    qp, sp = Q.quantize_blocks_plain(x, block)
    mism, err = {}, 0.0
    for name, a, b in (("codes", q, qp), ("scales", s, sp)):
        mism[name], e = _differ(a, b)
        err = max(err, e)
    for out in (torch.float32, torch.bfloat16):
        d = Q.dequantize_blocks(q, s, block, out)
        dp = Q.dequantize_blocks_plain(q, s, block, out)
        mism[f"dequant_{str(out)[6:]}"], e = _differ(d, dp)
        err = max(err, e)
    torch.cuda.synchronize()
    return mism, err


def phase_quant_kernel_vs_plain() -> float:
    """T1: the ckpt_quant kernels against their plain versions on the card,
    bitwise, at the full-width leaves and the edge cases."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(300)
    rows = []
    for name, n in (("embedding leaf", EMBED_LEAF), ("in_proj leaf",
                                                     IN_PROJ_LEAF)):
        mag = torch.pow(10.0, torch.empty(n // QBLOCK, device="cuda")
                        .uniform_(-6.0, 1.0, generator=g))
        x = torch.randn(n, generator=g, device="cuda") * mag.repeat_interleave(
            QBLOCK)
        mism, err = _quant_vs_plain(x, QBLOCK)
        rows.append(dict(case=name, dtype="float32", n=n, block=QBLOCK,
                         mismatches=mism, max_abs_err=err))
    for name, values, block in quant_edge_cases():
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.as_tensor(values, dtype=torch.float32).to(dtype).cuda()
            for tag, xin in (("", x), (", misaligned",
                                       torch.cat([x[:1], x])[1:])):
                mism, err = _quant_vs_plain(xin, block)
                rows.append(dict(case=name + tag, dtype=str(dtype)[6:],
                                 n=xin.numel(), block=block,
                                 mismatches=mism, max_abs_err=err))
    bad = [r for r in rows if any(r["mismatches"].values())]
    worst = max(r["max_abs_err"] for r in rows)
    REPORT["quant_kernel_vs_plain"] = rows
    for r in rows[:2]:
        print(f"[T1] ckpt_quant kernels vs plain on the card, {r['case']} "
              f"({r['n']:,} float32, {r['n'] // QBLOCK:,} blocks): "
              f"mismatches {r['mismatches']}", flush=True)
    print(f"[T1] edge cases ({len(rows) - 2} runs: zero block, .5 ties, "
          f"extremes, 1, 3 and 257 blocks, blocks of 32, 96 and 4096, NaN and "
          f"inf, float32 "
          f"and bf16 in, aligned and misaligned, float32 and bf16 out): "
          f"{len(bad)} with mismatches; max |kernel - plain| {worst}",
          flush=True)
    if bad:
        fail(f"ckpt_quant kernels differ from their plain versions: {bad}")
    return worst


def _train_smoke_cfg():
    from repro_torch.configs import get_smoke_config

    return get_smoke_config(ARCH).replace(param_dtype="float32",
                                          compute_dtype="float32")


def step_card_vs_cpu(cfg, batch) -> tuple:
    """One float32 train step of ``cfg`` from the same seeded weights on
    the card and on the CPU, checked part by part: the loss within
    STEP_TOL relative; each leaf's gradient within 1e-4 max|g| + 1e-6
    (the CPU tests' bound); the AdamW update of the same gradients on each
    device, master within STEP_TOL relative + 1e-6; and the whole step's
    master within STEP_TOL relative + 1e-6, except the elements of a tiny
    gradient (ADAM_TINY_GRAD, under 1% of them), held to ADAM_TINY_STEP
    lr.  Returns (the numbers with ``ok``, the CPU gradients)."""
    import torch

    from repro_torch.train.optimizer import AdamWConfig, adamw_update
    from repro_torch.train.schedule import constant
    from repro_torch.train.step import (_to_device, compute_grads,
                                        init_train_state, make_train_step)

    states = {dev: init_train_state(0, cfg, dev) for dev in ("cuda", "cpu")}
    states["cuda"].load_tree(states["cpu"].tree())     # the same weights
    tb = _to_device(batch, "cpu")          # the encdec frames stay float
    g_cpu, _ = compute_grads(states["cpu"].params, tb, cfg)
    g_own, _ = compute_grads(states["cuda"].params,
                             {k: v.cuda() for k, v in tb.items()}, cfg)
    g_gpu = {k: v.cuda() for k, v in g_cpu.items()}
    grad_ratio = max(float(((g_own[k].cpu() - g).abs()
                            / (1e-4 * g.abs().max() + 1e-6)).max())
                     for k, g in g_cpu.items())
    opt = AdamWConfig(lr=1e-3)
    upd = {dev: adamw_update(opt, g, states[dev].opt)[0]
           for dev, g in (("cuda", g_gpu), ("cpu", g_cpu))}
    opt_ratio = max(float(((upd["cuda"][k].cpu() - w).abs()
                           / (STEP_TOL * w.abs() + 1e-6)).max())
                    for k, w in upd["cpu"].items())
    out = {dev: make_train_step(cfg, opt, constant(1.0))(states[dev], batch)
           for dev in states}
    loss = {dev: float(m["loss"]) for dev, (_, m) in out.items()}
    loss_rel = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
    res = dict(loss_cuda=loss["cuda"], loss_cpu=loss["cpu"],
               loss_rel_err=loss_rel, grad_max_ratio=grad_ratio,
               adamw_max_ratio=opt_ratio,
               **master_rule(out["cpu"][0].opt.master,
                             out["cuda"][0].opt.master, g_cpu, g_own,
                             opt.lr))
    res["ok"] = res["ok"] and not (loss_rel > STEP_TOL or grad_ratio > 1.0
                                   or opt_ratio > 1.0)
    return res, g_cpu


def master_rule(want: dict, got: dict, g_ref: dict, g_other: dict,
                lr: float) -> dict:
    """T2's rule for a whole step's master: ``got`` within STEP_TOL
    relative + 1e-6 of ``want``, except the elements of a nonzero
    reference gradient below ADAM_TINY_GRAD (under 1% of them), held to
    ADAM_TINY_STEP lr.  ``g_other``: the other side's gradient, reported
    beside the worst elements."""
    beyond, n_tiny, tiny_max, worst = 0, 0, 0.0, []
    for k, w in want.items():
        w = w.cpu()
        d = (got[k].cpu() - w).abs()
        g = g_ref[k].cpu()
        tiny = (g.abs() < ADAM_TINY_GRAD) & (g != 0)
        bad = (d > STEP_TOL * w.abs() + 1e-6) & ~tiny
        beyond += int(bad.sum())
        n_tiny += int(tiny.sum())
        if tiny.any():
            tiny_max = max(tiny_max, float(d[tiny].max()))
        worst += [(float(d.reshape(-1)[i]), k, float(g.reshape(-1)[i]),
                   float(g_other[k].reshape(-1)[i].cpu()))
                  for i in bad.reshape(-1).nonzero()[:4, 0].tolist()]
    n_params = sum(t.numel() for t in g_ref.values())
    return dict(step_master_beyond_tol=beyond, step_master_tiny=n_tiny,
                step_master_tiny_max_abs=tiny_max,
                step_master_worst=sorted(worst, reverse=True)[:8],
                n_params=n_params, lr=lr,
                ok=not (beyond or n_tiny >= 1e-2 * n_params
                        or tiny_max > ADAM_TINY_STEP * lr))


def _step_line(res: dict) -> str:
    return (f"loss {res['loss_cuda']:.7f} vs {res['loss_cpu']:.7f} (rel "
            f"{res['loss_rel_err']:.3g}, tol {STEP_TOL}), gradients "
            f"{res['grad_max_ratio']:.3f} x (1e-4 max|g| + 1e-6), AdamW on "
            f"the same gradients {res['adamw_max_ratio']:.3f} x ({STEP_TOL}"
            f"|b| + 1e-6); whole step's master: "
            f"{res['step_master_beyond_tol']} of {res['n_params']:,} elements "
            f"beyond {STEP_TOL}|b| + 1e-6, {res['step_master_tiny']} of a "
            f"gradient below {ADAM_TINY_GRAD} within "
            f"{res['step_master_tiny_max_abs']:.3g} (limit "
            f"{ADAM_TINY_STEP * res['lr']:.3g})")


def phase_train_card_vs_cpu() -> dict:
    """T2: compress_grads on the same SMOKE gradients (the CPU's, carried to
    the card), card kernels against the CPU's plain versions for three
    error-feedback steps: bitwise.  Then one SMOKE float32 train step on
    each device, held by :func:`step_card_vs_cpu`."""
    import torch

    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.train.compress import compress_grads, init_error_feedback

    cfg = _train_smoke_cfg()
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                   global_batch=4, seed=2)).batch_at(0)
    res, g_cpu = step_card_vs_cpu(cfg, batch)
    g_gpu = {k: v.cuda() for k, v in g_cpu.items()}
    e_cpu, e_gpu = init_error_feedback(g_cpu), init_error_feedback(g_gpu)
    comp_mism = 0
    for _ in range(3):
        o_cpu, e_cpu = compress_grads(g_cpu, e_cpu)
        o_gpu, e_gpu = compress_grads(g_gpu, e_gpu)
        comp_mism += sum(int((o_gpu[k].cpu() != o_cpu[k]).sum())
                         + int((e_gpu[k].cpu() != e_cpu[k]).sum())
                         for k in g_cpu)
    res["compress_mismatches"] = comp_mism
    REPORT["train_card_vs_cpu"] = res
    print(f"[T2] mamba2 SMOKE float32, card vs CPU: compress_grads x3 on the "
          f"same gradients {comp_mism} mismatching elements; one train step: "
          f"{_step_line(res)}", flush=True)
    if comp_mism or not res["ok"]:
        fail(f"mamba2 SMOKE training: card and CPU disagree (worst master "
             f"elements: |d|, leaf, CPU and card gradient: "
             f"{res['step_master_worst']})")
    return res


def train_argv(ckpt_dir: str) -> list:
    """The command line of the training main path."""
    return ["--arch", ARCH, "--steps", str(TRAIN_STEPS), "--ckpt-dir",
            ckpt_dir, "--replicas", "1", "--policy", "adaptive", "--mtbf",
            str(TRAIN_MTBF), "--nodes", str(TRAIN_NODES), "--step-seconds",
            str(TRAIN_STEP_S), "--batch", str(TRAIN_BATCH), "--seq",
            str(TRAIN_SEQ), "--microbatches", str(TRAIN_MICRO),
            "--injector-seed", str(TRAIN_INJECTOR_SEED), "--keep", "1",
            "--virtual-ckpt-overhead", str(TRAIN_V), "--virtual-restore-time",
            str(TRAIN_TD)]


def phase_train(ckpt_dir: str) -> dict:
    """T3 (main path): ``repro_torch.launch.train`` on mamba2-130m (bf16,
    remat 'full', the SSD through ssd_chunked), the adaptive policy, 8
    steps of batch 8 x 1024 in 2 microbatches, one neighbour replica; then
    compress_grads on the trained model's gradients (three batches),
    carrying the error state."""
    import math

    out = train_with_compress("T3", train_argv(ckpt_dir), TRAIN_STEPS,
                              TRAIN_LAYERS)
    del out["last_grads"], out["last_err"]
    report, restored = out["report"], out["restored_steps"]
    losses = report["losses"]
    if not (report["steps_completed"] == TRAIN_STEPS
            and report["n_checkpoints"] >= 1 and report["n_restarts"] >= 1
            and report["wasted_steps"] >= 1
            and any(s is not None and s >= 1 for s in restored)):
        fail(f"training main path: no rollback to a committed image: "
             f"{report}, restores {restored}")
    if not (all(math.isfinite(v) for v in losses)
            and sum(losses[-3:]) / 3 < losses[0]):
        fail(f"training main path: losses {losses}")
    print(f"[T3] training main path: {report['steps_completed']} steps, "
          f"{report['n_failures']} failures, {report['n_checkpoints']} "
          f"checkpoints, {report['n_restarts']} restarts in "
          f"{out['wall_s']:.1f} s; losses {[round(v, 4) for v in losses]}; "
          f"compress_grads x3 over {out['n_leaves']} leaves: launches per "
          f"call {out['compress_launches']}, error feedback max |err| / "
          f"(scale/2) {out['error_feedback_max_ratio']:.7f} (limit "
          f"{EF_SLACK})", flush=True)
    _check_compress("T3", out)
    return out


def phase_train_measure(run: dict) -> dict:
    """T4: the training main path's numbers: warm step seconds and tokens/s,
    peak memory, V (blocking) and write seconds, a timed restore of the
    newest image (T_d), the controller's interval, compress_grads seconds;
    then torch.profiler over one train step (device time by kernel, idle
    share)."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    trainer = run.pop("trainer")
    tm = trainer.timings
    warm = tm["step"][1:] or tm["step"]
    step_s = statistics.median(warm)
    tok_s = TRAIN_BATCH * TRAIN_SEQ / step_s
    state = trainer.state
    t0 = time.monotonic()
    restored = trainer.ckpt.restore_latest(state.tree())
    if restored is None:
        fail("no committed checkpoint to restore")
    state.load_tree(restored[1])
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    del restored
    image_bytes = sum(t.numel() * t.element_size()
                      for t in state.tree().values())
    batch = trainer.data.batch_at(0)
    trainer.train_step(state, batch)          # warm, outside the profile
    torch.cuda.synchronize()
    t0 = time.monotonic()
    trainer.train_step(state, batch)
    torch.cuda.synchronize()
    unprof = time.monotonic() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
    rows = _kernel_rows(prof)
    total = sum(r[1] for r in rows)
    prof_out = dict(device_ms=total / 1e3, kernels=sum(r[2] for r in rows),
                    top=rows[:10], unprofiled_step_s=unprof)
    if total > 0:
        prof_out["idle_share"] = 1.0 - total / 1e6 / unprof
    out = dict(run, warm_step_s=warm, median_step_s=step_s, tokens_per_s=tok_s,
               image_bytes=image_bytes, restore_s=restore_s,
               controller_interval=run["report"]["controller_interval"],
               profile=prof_out)
    REPORT["train"] = out
    print(f"[T4] train mamba2-130m, batch {TRAIN_BATCH} x {TRAIN_SEQ} in "
          f"{TRAIN_MICRO} microbatches, bf16, remat full: warm step "
          f"{', '.join(f'{t:.4f}' for t in warm)} s (median {step_s:.4f} s = "
          f"{tok_s:,.0f} tokens/s; first {tm['step'][0]:.3f} s), peak "
          f"{run['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    print(f"[T4] checkpoint image {image_bytes / 1e9:.3f} GB: V (blocking "
          f"snapshot) {', '.join(f'{t:.3f}' for t in tm['save_blocking'])} s, "
          f"write + replica {', '.join(f'{t:.3f}' for t in tm['write'])} s, "
          f"restore of the newest image (T_d) {restore_s:.3f} s; in-run "
          f"restores {', '.join(f'{t:.3f}' for t in tm['restore'])} s; "
          f"controller interval {out['controller_interval']:.1f} virtual s; "
          f"compress_grads {', '.join(f'{t:.4f}' for t in run['compress_seconds'])} s",
          flush=True)
    if total > 0:
        print(f"[T4] train step profile: device time {total / 1e3:.2f} ms "
              f"against {unprof:.4f} s unprofiled, {prof_out['kernels']} "
              f"kernels, idle share {prof_out['idle_share']:.1%}", flush=True)
        for name, us, n in rows[:10]:
            print(f"    {us / 1e3:8.3f} ms  {n:5d} x  {name[:70]}", flush=True)
    else:
        print("[T4] train step profile: the profiler recorded no device "
              "time: not measured", flush=True)
    return out


def quant_work(n: int, block: int, in_bytes: int, out_bytes: int) -> int:
    """Bytes one pass must move: the input read once, the output written
    once (codes are 1 byte, scales 4 bytes a block)."""
    return n * in_bytes + n * out_bytes + 4 * (n // block)


def phase_quant_measure(n: int = EMBED_LEAF, tag: str = "T4",
                        leaf: str = "mamba2-130m's embedding leaf") -> dict:
    """T4 (D3 at olmo-1b's leaf): the quant kernels timed by CUDA events at
    an embedding leaf of ``n`` float32 (in and out), beside their plain
    versions, their bytes bounds and, for dequantize, torch.dequantize of a
    per-channel qint8 tensor (the one PyTorch call computing the same
    function; quantize has none: torch.quantize_per_channel needs the
    scales given)."""
    import torch

    from repro_torch.kernels import ckpt_quant as Q

    g = torch.Generator(device="cuda").manual_seed(301)
    x = torch.randn(n, generator=g, device="cuda") * 0.01
    q, s = Q.quantize_blocks(x, QBLOCK)
    ms_q = cuda_ms(lambda: Q.quantize_blocks(x, QBLOCK), reps=20)
    ms_d = cuda_ms(lambda: Q.dequantize_blocks(q, s, QBLOCK), reps=20)
    plain_q = cuda_ms(lambda: Q.quantize_blocks_plain(x, QBLOCK), reps=5)
    plain_d = cuda_ms(lambda: Q.dequantize_blocks_plain(q, s, QBLOCK), reps=5)
    b_q = quant_work(n, QBLOCK, 4, 1)
    b_d = quant_work(n, QBLOCK, 1, 4)
    lib_d, lib_note, lib_equal = None, None, None
    try:
        qt = torch._make_per_channel_quantized_tensor(
            q.reshape(-1, QBLOCK), s.double(),
            torch.zeros_like(s, dtype=torch.int64), 0)
        lib_equal = bool(torch.equal(torch.dequantize(qt).reshape(-1),
                                     Q.dequantize_blocks(q, s, QBLOCK)))
        lib_d = cuda_ms(lambda: torch.dequantize(qt), reps=20)
    except Exception as e:          # noqa: BLE001 - recorded, not hidden
        lib_note = f"{type(e).__name__}: {e}"[:300]
    out = dict(n=n, blocks=n // QBLOCK,
               quantize=dict(ms=ms_q, plain_ms=plain_q, bytes=b_q,
                             bound_ms=b_q / HBM_BYTES_PER_S * 1e3,
                             library_ms=None,
                             library_note="none: torch.quantize_per_channel "
                                          "needs the scales given"),
               dequantize=dict(ms=ms_d, plain_ms=plain_d, bytes=b_d,
                               bound_ms=b_d / HBM_BYTES_PER_S * 1e3,
                               library_ms=lib_d, library_note=lib_note,
                               library_equals_kernel=lib_equal))
    REPORT[f"quant_measure_{tag}"] = out
    for name in ("quantize", "dequantize"):
        r = out[name]
        print(f"[{tag}] {name}_blocks at {leaf} ({n:,} float32, "
              f"{n // QBLOCK:,} blocks): kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bytes']:,} B at 3.35 TB/s); "
              f"library {r['library_ms'] if r['library_ms'] is not None else 'none'}"
              f"{'' if r.get('library_note') is None else ' (' + r['library_note'] + ')'}"
              f"{'' if r.get('library_equals_kernel') is None else ', equals the kernel: ' + str(r['library_equals_kernel'])}",
              flush=True)
    return out


# --------------------------------------------------------------------------- #
# Dense training: the five dense configs, olmo-1b trained at full width
# --------------------------------------------------------------------------- #

DENSE_ARCHS = (OLMO,) + VARIANTS
DENSE_SEQ = 64          # D1: wider than the SMOKE window of 32, so it masks
DENSE_TRAIN_STEPS = 7
DENSE_TRAIN_LAYERS = 4   # D2: olmo-1b's depth cut (16 until TP5-TP6)
# D2's injector, picked on the CPU (the trainer's decisions hang on the
# virtual clock, the injector's numpy streams and the fixed virtual
# overheads alone, so the olmo SMOKE config makes the same ones): 64 nodes
# of MTBF 128,000 s at 60 virtual seconds a step, V 20 s and T_d 30 s (a
# 16.5 GB image costs more than mamba2's 1.8 GB).  With seed 11 the
# adaptive policy commits 2 images and the one failure comes 2 steps past
# the second, so the run rolls back to it (restored in the loop, 2 wasted
# steps) and restarts.
DENSE_NODES, DENSE_MTBF, DENSE_STEP_S, DENSE_INJECTOR_SEED = (
    64, 128000.0, 60.0, 11)
DENSE_V, DENSE_TD = 20.0, 30.0
# AdamW's rate on the full model: at the trainer's 1e-3, with no warmup,
# olmo-1b's losses ran 11.06, 8.04, 17.96, 12.65, ... (my first chip run)
DENSE_LR = 1e-4
OLMO_EMBED_LEAF = 50_304 * 2048   # 103,022,592 elements: 201,216 blocks
# D4's steps: the preset's 40 took 60.9 s on the card, 20 took 35.9 s;
# 12 (still MATCH on the CPU) make room for C1-Z2
FT_STEPS = 12


def _dense_smoke_cfg(arch: str):
    from repro_torch.configs import get_smoke_config

    return get_smoke_config(arch).replace(param_dtype="float32",
                                          compute_dtype="float32",
                                          use_flash_kernel=False)


def phase_dense_train_card_vs_cpu() -> dict:
    """D1: one float32 SMOKE train step of each dense config on the card
    against the CPU at DENSE_SEQ tokens (:func:`step_card_vs_cpu`, T2's
    rule); then ``remat`` none, full and dots on the card, olmo and gemma2:
    bitwise the same gradients (and none twice, the control)."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.train.step import (_to_device, compute_grads,
                                        init_train_state)

    steps = {}
    for arch in DENSE_ARCHS:
        cfg = _dense_smoke_cfg(arch)
        batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=DENSE_SEQ,
                                       global_batch=4, seed=2)).batch_at(0)
        steps[arch], _ = step_card_vs_cpu(cfg, batch)
        print(f"[D1] {arch} SMOKE float32 at {DENSE_SEQ} tokens, card vs CPU, "
              f"one train step: {_step_line(steps[arch])}", flush=True)
    remat = {}
    for arch in (OLMO, GEMMA):
        cfg = _dense_smoke_cfg(arch)
        state = init_train_state(0, cfg, "cuda")
        batch = _to_device(SyntheticLM(DataConfig(
            vocab=cfg.vocab, seq_len=DENSE_SEQ, global_batch=4,
            seed=2)).batch_at(1), "cuda")
        grads = {r: compute_grads(state.params, batch,
                                  cfg.replace(remat=r.split()[0]))[0]
                 for r in ("none", "full", "dots", "none again")}
        remat[arch] = {r: sum(int((grads[r][k] != g).sum())
                              for k, g in grads["none"].items())
                       for r in ("full", "dots", "none again")}
        print(f"[D1] {arch} SMOKE float32 on the card: gradients differing "
              f"from remat 'none' (of {sum(g.numel() for g in grads['none'].values()):,}): "
              f"{remat[arch]}", flush=True)
    out = dict(steps=steps, remat_mismatches=remat)
    REPORT["dense_train_card_vs_cpu"] = out
    bad = [a for a, r in steps.items() if not r["ok"]]
    if bad:
        fail(f"D1: dense SMOKE training, card and CPU disagree: {bad} "
             f"({ {a: steps[a]['step_master_worst'] for a in bad} })")
    if any(n for m in remat.values() for n in m.values()):
        fail(f"D1: remat changes the gradients on the card: {remat}")
    return out


def dense_train_argv(ckpt_dir: str) -> list:
    """The command line of the dense training main path."""
    return ["--arch", OLMO, "--steps", str(DENSE_TRAIN_STEPS), "--ckpt-dir",
            ckpt_dir, "--replicas", "0", "--keep", "1", "--policy",
            "adaptive", "--mtbf", str(DENSE_MTBF), "--nodes",
            str(DENSE_NODES), "--step-seconds", str(DENSE_STEP_S), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--microbatches",
            str(TRAIN_MICRO), "--lr", str(DENSE_LR), "--injector-seed",
            str(DENSE_INJECTOR_SEED), "--virtual-ckpt-overhead", str(DENSE_V),
            "--virtual-restore-time", str(DENSE_TD)]


def image_size(cfg) -> tuple:
    """(parameters, bytes of a checkpoint image): the parameters in their
    dtype, the float32 master, m and v, the int32 step."""
    from repro_torch.models import model as M

    params = list(M.model_class(cfg)(cfg).parameters())      # meta device
    n = sum(p.numel() for p in params)
    return n, sum(p.numel() * p.element_size() for p in params) + 12 * n + 4


def _mem_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def train_with_compress(tag: str, argv: list, n_steps: int,
                        n_layers: int) -> dict:
    """A training main path through ``repro_torch.launch.train``'s code
    (parser, build, the trainer's run), its config's depth cut to
    ``n_layers`` (the width kept), then compress_grads three times on the
    trained model's gradients, the error state carried: the launches of
    each call and the error-feedback ratio.  Keeps the last call's
    gradients and input error state (``last_grads``, ``last_err``)."""
    import torch

    from repro_torch.launch import train as launch
    from repro_torch.train.step import _to_device

    whole = launch.get_config
    args = launch.parser().parse_args(argv)
    with mock.patch.object(launch, "get_config", lambda arch: whole(
            arch).replace(n_layers=n_layers)):
        trainer, ckpt = launch.build(args)
    cfg = trainer.cfg
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    try:
        report = trainer.run(n_steps=args.steps)
    finally:
        ckpt.close()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    mem = torch.cuda.max_memory_allocated()
    print(f"[{tag}] {launch.summary(report)}", flush=True)
    print(f"[{tag}] in-run restores returned the images of steps "
          f"{trainer.restored_steps}; {report.wasted_steps} steps wasted",
          flush=True)
    state = trainer.state
    out = compress_calls(state.params, cfg, [
        _to_device(trainer.data.batch_at(n_steps + i), state.opt.step.device)
        for i in range(3)])
    return dict(out, report=report.__dict__,
                restored_steps=trainer.restored_steps, wall_s=wall,
                peak_bytes=mem, timings=trainer.timings, trainer=trainer)


def compress_calls(params, cfg, batches: list) -> dict:
    """compress_grads on the gradients of each batch in turn, the error
    state carried: the launches and seconds of each call and the
    error-feedback ratio (|g + err - deq| / (scale / 2), at most EF_SLACK
    in every block).  Keeps the last call's gradients and input error
    state (``last_grads``, ``last_err``)."""
    import torch

    from repro_torch.kernels import ckpt_quant as Q
    from repro_torch.train.compress import compress_grads, init_error_feedback
    from repro_torch.train.step import compute_grads

    err = init_error_feedback(dict(params.named_parameters()))
    per_call, secs, ef_ratio = [], [], 0.0
    for i, batch in enumerate(batches):
        grads, _ = compute_grads(params, batch, cfg)
        before = dict(Q.LAUNCHES)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        _, new_err = compress_grads(grads, err, block=QBLOCK)
        torch.cuda.synchronize()
        secs.append(time.monotonic() - t1)
        per_call.append({k: Q.LAUNCHES[k] - before[k] for k in before})
        for k, g in grads.items():
            flat = (g.float() + err[k]).reshape(-1)
            pad = -flat.numel() % QBLOCK
            amax = torch.nn.functional.pad(flat, (0, pad)).reshape(
                -1, QBLOCK).abs().amax(1)
            scale = torch.where(amax > 0, amax * Q._inv127(amax),
                                torch.ones_like(amax))
            e = torch.nn.functional.pad(new_err[k].reshape(-1), (0, pad))
            ratio = (e.reshape(-1, QBLOCK).abs().amax(1) / (scale / 2)).max()
            ef_ratio = max(ef_ratio, float(ratio))
        if i < len(batches) - 1:
            err = new_err
            del grads
    return dict(compress_seconds=secs, compress_launches=per_call,
                n_leaves=len(err), error_feedback_max_ratio=ef_ratio,
                last_grads=grads, last_err=err)


def _check_compress(tag: str, out: dict) -> None:
    want = {"quantize_blocks": out["n_leaves"],
            "dequantize_blocks": 2 * out["n_leaves"]}
    if any(c != want for c in out["compress_launches"]):
        fail(f"{tag}: compress_grads launched {out['compress_launches']} per "
             f"call, expected {want}")
    if out["error_feedback_max_ratio"] > EF_SLACK:
        fail(f"{tag}: error feedback invariant broken: "
             f"{out['error_feedback_max_ratio']}")


def phase_dense_train(ckpt_dir: str) -> dict:
    """D2 (main path): ``repro_torch.launch.train --arch olmo-1b`` at full
    width and depth (16 layers, d_model 2048, bf16, remat 'full',
    ``_attention_core``; the weights drawn on the card), the adaptive
    policy, DENSE_TRAIN_STEPS steps of batch 8 x 1024 in 2 microbatches, no
    replica, the newest image kept; then compress_grads three times on the
    trained model's gradients.  Fails first if the disk or the host memory
    cannot hold the images."""
    import math

    from repro_torch.configs import get_config

    n_params, image = image_size(get_config(OLMO).replace(
        n_layers=DENSE_TRAIN_LAYERS))
    root = Path(ckpt_dir).parent
    root.mkdir(parents=True, exist_ok=True)
    free, avail = shutil.disk_usage(root).free, _mem_available()
    print(f"[D2] olmo-1b: {n_params:,} parameters, a checkpoint image of "
          f"{image / 1e9:.2f} GB; {free / 1e9:.1f} GB free on the disk, "
          f"{avail / 1e9:.1f} GB of host memory available", flush=True)
    if free < 2 * image + 2e9 or avail < 1.5 * image:
        fail(f"D2: the machine cannot hold olmo-1b's images: {free:,} B free "
             f"on the disk (two images and 2 GB needed: "
             f"{2 * image + 2e9:,.0f}), {avail:,} B of host memory available "
             f"(1.5 images needed: {1.5 * image:,.0f})")
    out = train_with_compress("D2", dense_train_argv(ckpt_dir),
                              DENSE_TRAIN_STEPS, DENSE_TRAIN_LAYERS)
    out.update(n_params=n_params, image_bytes_predicted=image,
               disk_free=free, mem_available=avail)
    rep, restored = out["report"], out["restored_steps"]
    losses = rep["losses"]
    print(f"[D2] dense training main path: {rep['steps_completed']} steps, "
          f"{rep['n_failures']} failures, {rep['n_checkpoints']} checkpoints, "
          f"{rep['n_restarts']} restarts in {out['wall_s']:.1f} s; losses "
          f"{[round(v, 4) for v in losses]}; compress_grads x3 over "
          f"{out['n_leaves']} leaves: launches per call "
          f"{out['compress_launches']}, error feedback max |err| / "
          f"(scale/2) {out['error_feedback_max_ratio']:.7f} (limit "
          f"{EF_SLACK})", flush=True)
    if not (rep["steps_completed"] == DENSE_TRAIN_STEPS
            and rep["n_checkpoints"] >= 2 and rep["n_restarts"] >= 1
            and any(s is not None and s >= 1 for s in restored)):
        fail(f"D2: no rollback to a committed image after 2 commits: "
             f"{ {k: v for k, v in rep.items() if k != 'losses'} }, "
             f"restores {restored}")
    if not (all(math.isfinite(v) for v in losses)
            and sum(losses[-3:]) / 3 < losses[0]):
        fail(f"D2: losses {losses}")
    _check_compress("D2", out)
    return out


def phase_dense_quant_vs_plain(run: dict) -> dict:
    """D2: both quant kernels against their plain versions on every olmo-1b
    leaf, on the last compress_grads call's inputs (gradient + error
    state): codes, scales and float32/bf16 values bitwise."""
    import torch

    grads, err = run.pop("last_grads"), run.pop("last_err")
    mism, worst = {}, 0.0
    for k, g in grads.items():
        x = (g.float() + err[k]).reshape(-1)
        x = torch.nn.functional.pad(x, (0, -x.numel() % QBLOCK))
        m, e = _quant_vs_plain(x, QBLOCK)
        worst = max(worst, e)
        if any(m.values()):
            mism[k] = m
    out = dict(leaves=len(grads), leaves_with_mismatches=mism,
               max_abs_err=worst)
    REPORT["dense_quant_vs_plain"] = out
    print(f"[D2] ckpt_quant kernels vs plain on all {len(grads)} olmo-1b "
          f"leaves (the last call's gradient + error state): {len(mism)} "
          f"leaves with mismatches; max |kernel - plain| {worst}", flush=True)
    if mism:
        fail(f"D2: ckpt_quant kernels differ from their plain versions: "
             f"{mism}")
    return out


def attention_rows(prof, seq: int, q_chunk: int, attr: str) -> tuple:
    """(microseconds of ``attr`` in the operators of ``_attention_core``,
    in all operators) of a profile recorded with shapes: an operator is
    attention's when an input ends in a (queries, keys) score block -- a
    score, a probability, the mask, their gradients -- or it is a batched
    product with a batch above 1 (the dense model's weight products are
    batch-1 ``bmm``s or ``mm``s)."""
    attn = total = 0.0
    for e in prof.key_averages(group_by_input_shape=True):
        us = float(getattr(e, attr, 0.0) or 0.0)
        if us <= 0 or not e.key.startswith("aten::"):
            continue
        total += us
        shapes = [s for s in (e.input_shapes or []) if isinstance(s, list)]
        score = any(len(s) >= 2 and s[-1] == seq and s[-2] in (seq, q_chunk)
                    for s in shapes)
        batched = (e.key in ("aten::bmm", "aten::baddbmm") and shapes
                   and len(shapes[0]) == 3 and shapes[0][0] > 1)
        if score or batched:
            attn += us
    return attn, total


def attention_yardsticks(cfg, micro: int) -> dict:
    """``_attention_core`` forward, and forward + backward, timed by CUDA
    events at the training step's attention shape (a microbatch of
    ``micro`` sequences, bf16), and ``scaled_dot_product_attention``
    forward + backward at the same shape (the yardstick for a later flash
    backward; never on the path)."""
    import math

    import torch
    import torch.nn.functional as F

    from repro_torch.models.layers import _attention_core

    a, s = cfg.attention, TRAIN_SEQ
    g = torch.Generator(device="cuda").manual_seed(302)

    def x(*shape):
        return torch.randn(*shape, generator=g, device="cuda",
                           dtype=torch.bfloat16).requires_grad_(True)

    rep = a.n_heads // a.n_kv_heads
    q = x(micro, a.n_kv_heads, rep, s, a.head_dim)
    k, v = x(micro, a.n_kv_heads, s, a.head_dim), x(micro, a.n_kv_heads, s,
                                                    a.head_dim)
    scale = 1.0 / math.sqrt(a.head_dim)
    do = torch.randn(q.shape, generator=g, device="cuda", dtype=torch.bfloat16)

    def core():
        return _attention_core(q, k, v, scale=scale, softcap=a.softcap,
                               causal=True, sliding_window=None,
                               local_flag=False, q_offset=0, kv_valid=None,
                               q_chunk=512, cdt=torch.bfloat16)

    def core_fb():
        torch.autograd.grad(core(), (q, k, v), do)

    def sdpa_fb():
        o = F.scaled_dot_product_attention(
            q.reshape(micro, a.n_heads, s, a.head_dim), k, v, is_causal=True,
            scale=scale, enable_gqa=rep > 1)
        torch.autograd.grad(o, (q, k, v), do.reshape(o.shape))

    with torch.no_grad():
        fwd = cuda_ms(core, reps=10)
    return dict(shape=[micro, a.n_kv_heads, rep, s, a.head_dim],
                core_fwd_ms=fwd, core_fwd_bwd_ms=cuda_ms(core_fb, reps=10),
                sdpa_fwd_bwd_ms=cuda_ms(sdpa_fb, reps=10))


def phase_dense_train_measure(run: dict) -> dict:
    """D3: the dense training main path's numbers: warm step seconds,
    tokens/s and 6 N tokens/s against the bf16 tensor-core peak, peak
    memory, the image, V and write seconds, T_d (the in-run restores of
    the newest image: a timed restore more would cost ~40 s), the
    controller's interval; torch.profiler over one warm
    step (device time by kernel, idle share, the share of
    ``_attention_core``'s operators); ``_attention_core`` and SDPA timed at
    the step's attention shape."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    trainer = run.pop("trainer")
    cfg, tm = trainer.cfg, trainer.timings
    warm = tm["step"][1:] or tm["step"]
    step_s = statistics.median(warm)
    tok_s = TRAIN_BATCH * TRAIN_SEQ / step_s
    model_flops = 6 * run["n_params"] * tok_s
    state = trainer.state
    image_bytes = sum(t.numel() * t.element_size()
                      for t in state.tree().values())
    batch = trainer.data.batch_at(0)
    trainer.train_step(state, batch)          # warm, outside the profile
    torch.cuda.synchronize()
    t0 = time.monotonic()
    trainer.train_step(state, batch)
    torch.cuda.synchronize()
    unprof = time.monotonic() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
    rows = _kernel_rows(prof)
    total = sum(r[1] for r in rows)
    attn_us, op_us = attention_rows(prof, TRAIN_SEQ, 512,
                                    "self_device_time_total")
    prof_out = dict(device_ms=total / 1e3, kernels=sum(r[2] for r in rows),
                    top=rows[:12], unprofiled_step_s=unprof,
                    attention_ms=attn_us / 1e3, operators_ms=op_us / 1e3)
    if total > 0:
        prof_out["idle_share"] = 1.0 - total / 1e6 / unprof
        prof_out["attention_share"] = attn_us / total
    micro = TRAIN_BATCH // TRAIN_MICRO
    yard = attention_yardsticks(cfg, micro)
    # calls a step: each microbatch and layer runs the forward twice (remat
    # 'full' recomputes it) and the backward once
    calls = TRAIN_MICRO * cfg.n_layers
    yard["core_ms_a_step"] = calls * (yard["core_fwd_bwd_ms"]
                                      + yard["core_fwd_ms"])
    yard["sdpa_ms_a_step"] = calls * yard["sdpa_fwd_bwd_ms"]
    out = dict(run, warm_step_s=warm, median_step_s=step_s,
               tokens_per_s=tok_s, model_flops_per_s=model_flops,
               model_flops_share=model_flops / BF16_TC_OPS_PER_S,
               image_bytes=image_bytes,
               controller_interval=run["report"]["controller_interval"],
               profile=prof_out, attention=yard)
    REPORT["dense_train"] = out
    print(f"[D3] train olmo-1b, batch {TRAIN_BATCH} x {TRAIN_SEQ} in "
          f"{TRAIN_MICRO} microbatches, bf16, remat {cfg.remat}: warm step "
          f"{', '.join(f'{t:.4f}' for t in warm)} s (median {step_s:.4f} s = "
          f"{tok_s:,.0f} tokens/s, 6 N tokens/s {model_flops / 1e12:.1f} "
          f"TFLOP/s = {model_flops / BF16_TC_OPS_PER_S:.1%} of 989; first "
          f"{tm['step'][0]:.3f} s), peak {run['peak_bytes'] / 2**30:.2f} GiB",
          flush=True)
    print(f"[D3] checkpoint image {image_bytes / 1e9:.3f} GB: V (blocking "
          f"snapshot) {', '.join(f'{t:.3f}' for t in tm['save_blocking'])} s, "
          f"write {', '.join(f'{t:.3f}' for t in tm['write'])} s, T_d (the "
          f"in-run restores of the newest image) "
          f"{', '.join(f'{t:.3f}' for t in tm['restore'])} s; controller "
          f"interval {out['controller_interval']:.1f} virtual s; "
          f"compress_grads "
          f"{', '.join(f'{t:.4f}' for t in run['compress_seconds'])} s",
          flush=True)
    if total > 0:
        print(f"[D3] train step profile: device time {total / 1e3:.2f} ms "
              f"against {unprof:.4f} s unprofiled, {prof_out['kernels']} "
              f"kernels, idle share {prof_out['idle_share']:.1%}; "
              f"_attention_core's operators {attn_us / 1e3:.2f} ms = "
              f"{prof_out['attention_share']:.1%} of the device time",
              flush=True)
        for name, us, n in rows[:12]:
            print(f"    {us / 1e3:8.3f} ms  {n:5d} x  {name[:70]}", flush=True)
    else:
        print("[D3] train step profile: the profiler recorded no device "
              "time: not measured", flush=True)
    print(f"[D3] attention at the step's shape {yard['shape']} bf16: "
          f"_attention_core forward {yard['core_fwd_ms']:.3f} ms, forward + "
          f"backward {yard['core_fwd_bwd_ms']:.3f} ms ({calls} calls a step "
          f"with the recompute: {yard['core_ms_a_step']:.1f} ms); "
          f"scaled_dot_product_attention forward + backward "
          f"{yard['sdpa_fwd_bwd_ms']:.3f} ms ({yard['sdpa_ms_a_step']:.1f} "
          f"ms a step without a recompute)", flush=True)
    return out


def phase_ft_example() -> dict:
    """D4: ``python -m repro_torch.launch.fault_tolerant_training --preset
    ci --device cuda --steps FT_STEPS`` as a subprocess: exit 0, the
    adaptive and the three fixed policies' lines, and ``MATCH``."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-m",
                        "repro_torch.launch.fault_tolerant_training",
                        "--preset", "ci", "--device", "cuda", "--steps",
                        str(FT_STEPS)],
                       capture_output=True, text=True, env=env,
                       cwd=str(ROOT), timeout=600)
    sec = time.monotonic() - t0
    lines = r.stdout.splitlines()
    want = ["adaptive :"] + [f"fixed {f:6.0f}s:" for f in (60, 600, 3600)]
    missing = [w for w in want if not any(ln.startswith(w) for ln in lines)]
    match = any(ln.endswith("-> MATCH") for ln in lines)
    out = dict(rc=r.returncode, seconds=sec, stdout=r.stdout[-4000:],
               stderr=r.stderr[-4000:], missing=missing, match=match)
    REPORT["ft_example"] = out
    print(f"[D4] python -m repro_torch.launch.fault_tolerant_training "
          f"--preset ci --device cuda --steps {FT_STEPS}: exit "
          f"{r.returncode} in {sec:.1f} s, "
          f"missing lines {missing}, MATCH {match}:", flush=True)
    for line in lines:
        print(f"    {line}", flush=True)
    if r.returncode != 0 or missing or not match:
        fail(f"D4: the fault-tolerant-training entry point failed: "
             f"{r.stderr[-2000:]}")
    return out


# --------------------------------------------------------------------------- #
# The moe family: olmoe-1b-7b and deepseek-moe-16b served whole, moe training
# --------------------------------------------------------------------------- #

OLMOE, DEEPSEEK = "olmoe-1b-7b", "deepseek-moe-16b"
MOE_ARCHS = (OLMOE, DEEPSEEK)
MOE_CFS = (8.0, 0.5)    # M1: SMOKE's capacity factor; one where claims drop
MOE_SEQ = 32            # M1: 2 x 32 tokens, one dispatch group of 64
# M2/M3's float32 check at full width: olmoe's 16 float32 layers (27.7 GB
# beside the 13.8 GB bf16 model) fit; deepseek's 28 (67.5 GB) do not
MOE_F32_LAYERS = {OLMOE: None, DEEPSEEK: 8}
# a route of the kernel path may differ from the plain path's only where
# the two experts' probabilities lie this close (relative to the larger):
# float32 noise in the router's input between flash and _attention_core
MOE_F32_NEAR_TIE = 1e-4
MOE_MEM_BEFORE = 8 * 2**30   # M2/M3/M5: allocated bytes allowed before a draw
# M5: olmoe-1b-7b at full width, cut to 2 layers (1,045,178,368 parameters;
# the 16 layers would need ~311 GB at ~45 bytes a parameter)
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 2, 5
EXPERT_LEAF = 64 * 2048 * 1024   # 134,217,728 float32: 262,144 blocks of 512


class RouteSpy:
    """Records the routing of every moe layer call (``models.moe.route``
    through the module, so the model's calls are seen), optionally making
    each call take given expert choices instead of its own (``force``:
    one (G, group, K) tensor a call, in call order)."""

    def __init__(self, force=None):
        self.routes, self.own, self._force = [], [], force

    def __enter__(self):
        from repro_torch.models import moe as MOE

        real = MOE.route

        def spy(router, xt, cfg, C):
            r = real(router, xt, cfg, C)
            if self._force is not None:
                self.own.append(r)
                r = MOE.assign(r.probs, self._force[len(self.routes)]
                               .to(r.expert_ids.device), C)
            self.routes.append(r)
            return r

        self._patch = mock.patch.object(MOE, "route", spy)
        self._patch.__enter__()
        return self

    def __exit__(self, *exc):
        self._patch.__exit__(*exc)


def route_gaps(a: list, b: list) -> dict:
    """Where two runs' routes differ, call by call: claims (layer-call,
    group, token, k) whose expert differs (``differ``: the k-th choice;
    ``moved``: an expert the token does not choose at all in run ``b``)
    or whose within-capacity bit differs, their shares, and for the
    differing expert choices the gap between the two experts'
    probabilities in run ``a`` (relative to the larger) and between the
    k-th and (k+1)-th probability of that token."""
    import torch

    if len(a) != len(b):
        return dict(calls=(len(a), len(b)), claims=0, differ=-1, share=1.0,
                    moved=-1, moved_share=1.0, kept_differ=-1,
                    worst_rel_gap=float("inf"), examples=[])
    claims = differ = moved = kept_differ = 0
    worst_rel, gaps = 0.0, []
    for ra, rb in zip(a, b):
        ia, ib = ra.expert_ids, rb.expert_ids.to(ra.expert_ids.device)
        d = ia != ib
        claims += d.numel()
        differ += int(d.sum())
        # claims whose expert is not among the token's experts in run b
        moved += int((ia[..., :, None] != ib[..., None, :]).all(-1).sum())
        kept_differ += int((ra.kept != rb.kept.to(ra.kept.device)).sum())
        for g, s, k in d.nonzero()[:64].tolist():
            p = ra.probs[g, s].float()
            pa, pb = float(p[ia[g, s, k]]), float(p[ib[g, s, k]])
            srt = torch.sort(p, descending=True).values
            kk = ra.expert_ids.shape[-1]
            rel = abs(pa - pb) / max(pa, pb)
            worst_rel = max(worst_rel, rel)
            if len(gaps) < 8:
                gaps.append(dict(at=(g, s, k), p_own=pa, p_other=pb,
                                 rel_gap=rel, kth_gap=float(
                                     srt[kk - 1] - srt[kk])))
    return dict(calls=len(a), claims=claims, differ=differ,
                kept_differ=kept_differ, share=differ / max(claims, 1),
                moved=moved, moved_share=moved / max(claims, 1),
                worst_rel_gap=worst_rel, examples=gaps)


def phase_moe_card_vs_cpu() -> dict:
    """M1: both moe SMOKE configs in float32 with the kernel on, the card
    against the CPU from the same CPU-drawn weights, at capacity factors
    8.0 and 0.5 (tokens drop): prefill of MOE_SEQ tokens and 4
    teacher-forced decode steps, logits and KV caches within 1e-4, the
    routes (expert ids and the within-capacity mask) equal on every layer
    and step.  Then one float32 train step each (T2's rule), and on the
    card (olmoe SMOKE) remat none, full and dots bitwise the same
    gradients, the backward run twice bitwise the same."""
    import dataclasses

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import init_params
    from repro_torch.train.step import (_to_device, compute_grads,
                                        init_train_state)

    g = torch.Generator().manual_seed(21)
    serve, launches = {}, FA.LAUNCHES
    _zero(FA.LAUNCHES_BY_ROUTE)     # the float32 moe serving path starts here
    for arch in MOE_ARCHS:
        for cf in MOE_CFS:
            base = get_smoke_config(arch)
            cfg = base.replace(param_dtype="float32", compute_dtype="float32",
                               use_flash_kernel=True,
                               moe=dataclasses.replace(base.moe,
                                                       capacity_factor=cf))
            toks = torch.randint(0, cfg.vocab, (2, MOE_SEQ + 4), generator=g)
            res = {}
            for dev in ("cuda", "cpu"):
                model = init_params(0, cfg, device=dev)
                t = toks.to(dev)
                with RouteSpy() as spy:
                    out, cache = _serve_run(model, cfg, t[:, :MOE_SEQ],
                                            t[:, MOE_SEQ:],
                                            cache_dtype=torch.float32)
                res[dev] = (out, cache, spy.routes)
            pairs = list(zip(res["cuda"][0], res["cpu"][0])) + [
                (res["cuda"][1]["kv"][k], res["cpu"][1]["kv"][k])
                for k in ("k", "v")]
            gaps = [_gap(a.cpu(), b, OLMO_F32_TOL) for a, b in pairs]
            routes = route_gaps(res["cuda"][2], res["cpu"][2])
            dropped = 1.0 - float(torch.cat([r.kept.reshape(-1).float().cpu()
                                             for r in res["cpu"][2]]).mean())
            key = f"{arch} cf {cf}"
            serve[key] = dict(max_abs=max(x["max_abs"] for x in gaps),
                              ok=all(_ok(x) for x in gaps), routes=routes,
                              dropped_share=dropped)
            print(f"[M1] {arch} SMOKE float32, capacity factor {cf}, card vs "
                  f"CPU, prefill of {MOE_SEQ} + 4 decode: logits and KV "
                  f"caches max |d| {serve[key]['max_abs']:.3g} (tol "
                  f"{OLMO_F32_TOL}); routes {routes['differ']} of "
                  f"{routes['claims']} claims differ, within-capacity bits "
                  f"{routes['kept_differ']}; claims dropped "
                  f"{dropped:.3f}", flush=True)
            if routes["differ"] or routes["kept_differ"]:
                fail(f"M1: {key}: the card routes differently from the CPU: "
                     f"{routes}")
            if not serve[key]["ok"]:
                fail(f"M1: {key}: card and CPU disagree")
            if (cf < 1.0) != (dropped > 0.0):
                fail(f"M1: {key}: dropped share {dropped}")
    launches = FA.LAUNCHES - launches
    by_route = dict(FA.LAUNCHES_BY_ROUTE)   # ... and ends here
    want = 2 * len(MOE_ARCHS) * len(MOE_CFS)   # 2 layers a prefill, card only
    if launches != want or by_route["simt"] != want:
        fail(f"M1: the float32 moe prefills launched flash_attention "
             f"{launches} times ({by_route}), expected {want} SIMT launches")
    steps = {}
    for arch in MOE_ARCHS:
        cfg = get_smoke_config(arch).replace(param_dtype="float32",
                                             compute_dtype="float32")
        batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=DENSE_SEQ,
                                       global_batch=4, seed=2)).batch_at(0)
        steps[arch], _ = step_card_vs_cpu(cfg, batch)
        print(f"[M1] {arch} SMOKE float32 at {DENSE_SEQ} tokens, card vs CPU, "
              f"one train step: {_step_line(steps[arch])}", flush=True)
    cfg = get_smoke_config(OLMOE).replace(param_dtype="float32",
                                          compute_dtype="float32")
    state = init_train_state(0, cfg, "cuda")
    batch = _to_device(SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=DENSE_SEQ, global_batch=4,
        seed=2)).batch_at(1), "cuda")
    grads = {r: compute_grads(state.params, batch,
                              cfg.replace(remat=r.split()[0]))[0]
             for r in ("none", "full", "dots", "none again")}
    remat = {r: sum(int((grads[r][k] != x).sum())
                    for k, x in grads["none"].items())
             for r in ("full", "dots", "none again")}
    n = sum(x.numel() for x in grads["none"].values())
    print(f"[M1] {OLMOE} SMOKE float32 on the card: gradients differing from "
          f"remat 'none' (of {n:,}): {remat}", flush=True)
    out = dict(serve=serve, launches=launches, launches_by_route=by_route,
               steps=steps, remat_mismatches=remat)
    REPORT["moe_card_vs_cpu"] = out
    bad = [a for a, r in steps.items() if not r["ok"]]
    if bad:
        fail(f"M1: moe SMOKE training, card and CPU disagree: {bad} "
             f"({ {a: steps[a]['step_master_worst'] for a in bad} })")
    if any(remat.values()):
        fail(f"M1: remat (or a second backward) changes the moe gradients on "
             f"the card: {remat}")
    return out


def _require_free_card(tag: str) -> None:
    """Fail when an earlier phase left a model on the card."""
    import torch

    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"[{tag}] {held / 2**30:.2f} GiB allocated on the card before the "
          f"draw", flush=True)
    if held > MOE_MEM_BEFORE:
        fail(f"{tag}: {held:,} B still allocated on the card before drawing "
             f"a model")


def phase_moe_profile(tag: str, cfg, model, prompt, n_tokens: int) -> dict:
    """M4: ``torch.profiler`` over one warm prefill and 5 decode steps of a
    moe model, its device time split into attention (the flash kernels;
    ``_attention_core`` in decode), the expert products (the products
    inside the moe blocks: the stacked experts' bmm and the shared
    experts'), dispatch/combine and routing (the rest of the moe blocks),
    and the rest; the idle share against each profiled run's own wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.serve.step import make_prefill_step, make_serve_step

    real_moe, real_core = MOE.apply_moe, L._attention_core

    def moe_span(*a, **k):
        with record_function("moe block"):
            return real_moe(*a, **k)

    def core_span(*a, **k):
        with record_function("attention core"):
            return real_core(*a, **k)

    spans = ("moe block", "attention core")
    gemms = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")

    def split(prof, steps: int) -> dict:
        """Kernel microseconds by category: every kernel row but the spans'
        own device-side ranges; a kernel goes to the span its launching
        operator runs inside."""
        rows = [r for r in _kernel_rows(prof) if r[0] not in spans]
        total = sum(r[1] for r in rows)
        flash = sum(r[1] for r in rows
                    if any(n in r[0] for n in FLASH_KERNEL_NAMES))
        core = moe = gemm = 0.0
        ops: dict = {}
        for e, own, up in _operator_kernels(prof):
            if "attention core" in up:
                core += own
            elif "moe block" in up:
                moe += own
                gemm += own if e.name in gemms else 0.0
                ops[e.name] = ops.get(e.name, 0.0) + own
        ms = dict(device=total, attention=flash + core, expert_products=gemm,
                  dispatch_combine_routing=moe - gemm,
                  rest=total - flash - core - moe)
        out = {k: v / 1e3 / steps for k, v in ms.items()}
        out["moe_ops_ms"] = sorted(((k, v / 1e3 / steps) for k, v
                                    in ops.items()), key=lambda r: -r[1])[:8]
        return out

    pre = make_prefill_step(cfg, max_seq=prompt.shape[1] + n_tokens)
    srv = make_serve_step(cfg)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {}
    with mock.patch.object(MOE, "apply_moe", moe_span), \
            mock.patch.object(L, "_attention_core", core_span):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            logits, cache = pre(model, {"tokens": prompt})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out["prefill"] = dict(split(prof, 1), wall_ms=wall * 1e3)
        tok = logits[:, -1].argmax(-1)[:, None]
        steps = 5
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                logits, cache = srv(model, cache, {"tokens": tok})
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / steps
        out["decode"] = dict(split(prof, steps), wall_ms=wall * 1e3)
    for part in ("prefill", "decode"):
        r = out[part]
        if r["device"] <= 0:
            r["note"] = "the profiler recorded no device time: not measured"
        else:
            r["idle_share"] = 1.0 - r["device"] / r["wall_ms"]
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    out["decode"]["weight_read_bound_ms"] = weights / HBM_BYTES_PER_S * 1e3
    out["decode"]["weight_bytes"] = weights
    for part in ("prefill", "decode"):
        r = out[part]
        unit = "ms" if part == "prefill" else "ms a step"
        print(f"[{tag}] {cfg.name} {part} profile ({unit}): "
              f"device {r['device']:.3f} of {r['wall_ms']:.3f} wall, "
              f"idle {r.get('idle_share', float('nan')):.1%}; attention "
              f"{r['attention']:.3f}, expert products "
              f"{r['expert_products']:.3f}, dispatch/combine and routing "
              f"{r['dispatch_combine_routing']:.3f}, rest {r['rest']:.3f}"
              + (f"; weight-read bound {r['weight_read_bound_ms']:.3f} ms "
                 f"({weights / 1e9:.2f} GB at 3.35 TB/s)"
                 if part == "decode" else ""), flush=True)
        print(f"    the moe blocks' operators by device ms: "
              f"{[(n, round(v, 3)) for n, v in r['moe_ops_ms']]}", flush=True)
    return out


def phase_moe_train() -> dict:
    """M5 (main path): olmoe-1b-7b at full width cut to MOE_TRAIN_LAYERS
    layers, drawn on the card (bf16, remat 'dots', ``_attention_core``),
    MOE_TRAIN_STEPS steps of ``make_train_step`` on SyntheticLM batch 8 x
    1024 in 2 microbatches at AdamW 1e-4: finite losses, the moe metrics;
    step seconds, tokens/s, peak memory.  Then compress_grads three times
    on the trained model's gradients, the error state carried: one
    quantize and two dequantize launches a leaf a call, |err| within
    EF_SLACK; both quant kernels bitwise their plain versions on every
    leaf."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.train import training_config
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.schedule import constant
    from repro_torch.train.step import (_to_device, init_train_state,
                                        make_train_step)

    _require_free_card("M5")
    cfg = training_config(get_config(OLMOE)).replace(
        n_layers=MOE_TRAIN_LAYERS, remat="dots")
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                             cfg, "cuda")
    n_params = sum(p.numel() for p in state.params.parameters())
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=0))
    step = make_train_step(cfg, AdamWConfig(lr=DENSE_LR), constant(1.0),
                           n_microbatches=TRAIN_MICRO)
    secs, metrics = [], []
    for i in range(MOE_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, m = step(state, data.batch_at(i))
        torch.cuda.synchronize()
        secs.append(time.monotonic() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated()
    warm = min(secs[1:])
    tok_s = TRAIN_BATCH * TRAIN_SEQ / warm
    losses = [m["loss"] for m in metrics]
    print(f"[M5] {OLMOE} at full width, {cfg.n_layers} layers: {n_params:,} "
          f"parameters drawn on the card; {MOE_TRAIN_STEPS} steps of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_MICRO} microbatches (bf16, "
          f"remat dots, AdamW {DENSE_LR}): losses "
          f"{[round(v, 4) for v in losses]}, moe aux "
          f"{[round(m['moe_aux_loss'], 5) for m in metrics]}, dropped "
          f"{[round(m['moe_dropped_frac'], 4) for m in metrics]}; step "
          f"{', '.join(f'{s:.4f}' for s in secs)} s, warm {warm:.4f} s = "
          f"{tok_s:,.0f} tokens/s, peak {peak / 2**30:.2f} GiB", flush=True)
    if not all(math.isfinite(v) for m in metrics for v in m.values()) or \
            not all({"moe_aux_loss", "moe_dropped_frac"} <= set(m)
                    for m in metrics):
        fail(f"M5: moe training metrics {metrics}")
    out = dict(compress_calls(state.params, cfg, [
        _to_device(data.batch_at(MOE_TRAIN_STEPS + i), "cuda")
        for i in range(3)]), n_params=n_params, layers=cfg.n_layers,
        step_s=secs, warm_step_s=warm, tokens_per_s=tok_s, peak_bytes=peak,
        metrics=metrics)
    print(f"[M5] compress_grads x3 over {out['n_leaves']} leaves: launches "
          f"per call {out['compress_launches']}, "
          f"{', '.join(f'{t:.3f}' for t in out['compress_seconds'])} s, "
          f"error feedback max |err| / (scale/2) "
          f"{out['error_feedback_max_ratio']:.7f} (limit {EF_SLACK})",
          flush=True)
    _check_compress("M5", out)
    del state, step
    return out


def quant_vs_plain_all_leaves(tag: str, run: dict, largest: int) -> dict:
    """M5 and H5: both quant kernels against their plain versions on every
    leaf of a trained model's last ``compress_grads`` input (gradient plus
    error state), bitwise; the largest leaf must have ``largest``
    elements (the 2-layer olmoe's 134,217,728-element expert stacks, the
    12-layer zamba2's 114,688,000-element embedding)."""
    import torch

    grads, err = run.pop("last_grads"), run.pop("last_err")
    mism, worst, biggest = {}, 0.0, 0
    for k, x in grads.items():
        x = (x.float() + err[k]).reshape(-1)
        biggest = max(biggest, x.numel())
        x = torch.nn.functional.pad(x, (0, -x.numel() % QBLOCK))
        m, e = _quant_vs_plain(x, QBLOCK)
        worst = max(worst, e)
        if any(m.values()):
            mism[k] = m
    del grads, err
    torch.cuda.empty_cache()
    out = dict(leaves=run["n_leaves"], largest_leaf=biggest,
               leaves_with_mismatches=mism, max_abs_err=worst)
    REPORT[f"quant_vs_plain_{tag}"] = out
    print(f"[{tag}] ckpt_quant kernels vs plain on all {run['n_leaves']} "
          f"leaves (largest {biggest:,} elements): {len(mism)} leaves with "
          f"mismatches; max |kernel - plain| {worst}", flush=True)
    if mism or biggest != largest:
        fail(f"{tag}: ckpt_quant kernels differ from their plain versions "
             f"({mism}) or the largest leaf is not {largest:,}")
    return out


def moe_phases() -> dict:
    """M1-M5: the moe SMOKE checks, the two moe models served whole (their
    flash counts at 0 just before each serving main path and read just
    after, inside :func:`serve_variant`), the 2-layer olmoe trained (the
    ckpt_quant counts at 0 just before and read just after), both quant
    kernels timed at the expert leaf."""
    import torch

    from repro_torch.kernels import (ckpt_quant, flash_attention, sim_step,
                                     ssd_scan)

    card = phase_moe_card_vs_cpu()
    _lap("M1")
    serve = {}
    for tag, arch in (("M2", OLMOE), ("M3", DEEPSEEK)):
        # serve_variant: exactly one wgmma launch a layer, the timed prefill
        # and decode, the logits against the plain path with the route
        # comparison (phase_dense_vs_plain), the M4 profile
        _require_free_card(tag)
        serve[arch] = serve_variant(tag, arch, f32_layers=MOE_F32_LAYERS[arch],
                                    profile=True)
        _lap(f"{tag}, M4")
    for k in ckpt_quant.LAUNCHES:     # the moe training main path starts here
        ckpt_quant.LAUNCHES[k] = 0
    sim_step.LAUNCHES = ssd_scan.LAUNCHES = flash_attention.LAUNCHES = 0
    train = phase_moe_train()
    launches = dict(ckpt_quant.LAUNCHES)   # ... and ends here
    other = dict(sim_step=sim_step.LAUNCHES, ssd_scan=ssd_scan.LAUNCHES,
                 flash_attention=flash_attention.LAUNCHES)
    REPORT["moe_train_main_path_launches"] = dict(launches, **other)
    print(f"[M5] moe training main path: launches {launches} (3 "
          f"compress_grads calls over {train['n_leaves']} leaves), {other} "
          f"(training runs _attention_core)", flush=True)
    if min(launches.values()) < 1 or any(other.values()):
        fail("M5: the moe training main path launched no ckpt_quant kernel, "
             "or launched another kernel")
    quant_vs_plain = quant_vs_plain_all_leaves("M5", train, EXPERT_LEAF)
    torch.cuda.empty_cache()
    quant = phase_quant_measure(EXPERT_LEAF, "M5",
                                "olmoe-1b-7b's expert stack")
    _lap("M5")
    REPORT["moe_train"] = train
    return dict(card_vs_cpu=card, serve=serve, train=train,
                train_launches=launches, quant_vs_plain=quant_vs_plain,
                quant=quant)


# --------------------------------------------------------------------------- #
# The hybrid family: zamba2-7b served whole, hybrid training
# --------------------------------------------------------------------------- #

HYBRID_SEQS = (32, 40)      # H1: one SMOKE chunk, and off the chunk grid
# H3's and TP5's float32 check at full width: the first 6 layers (one use
# of the shared block; 12, two uses, until TP7-TP8 needed the time), 2.8 GB
# of float32 weights beside the 13.3 GB bf16 model
ZAMBA_F32_LAYERS = 6
# H5: zamba2-7b at full width cut to 12 layers (1,255,956,416 parameters,
# two uses of the shared block; the 81 layers would need ~300 GB at
# olmo-1b's ~45 bytes a parameter)
ZAMBA_TRAIN_LAYERS, ZAMBA_TRAIN_STEPS = 12, 5
ZAMBA_EMBED_LEAF = 32_000 * 3584   # 114,688,000 float32: 224,000 blocks


def _hybrid_smoke_cfg(**change):
    from repro_torch.configs import get_smoke_config

    return get_smoke_config(ZAMBA).replace(param_dtype="float32",
                                           compute_dtype="float32", **change)


def phase_hybrid_card_vs_cpu() -> dict:
    """H1: zamba2 SMOKE in float32 with the kernels on (the SIMT SSD and
    the SIMT flash kernel at head_dim 16), the card against the CPU from
    the same CPU-drawn weights: prefill of 32 and 40 tokens and 4
    teacher-forced decode steps, logits, SSM state, conv carry and K/V
    within 1e-4, one SSD launch a layer and one flash launch a use of the
    shared block a prefill.  Then one float32 train step (T2's rule), and
    on the card remat none, full and dots bitwise the same gradients, the
    backward run twice bitwise the same."""
    import torch

    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.models import init_params
    from repro_torch.train.step import (_to_device, compute_grads,
                                        init_train_state)

    cfg = _hybrid_smoke_cfg(use_flash_kernel=True)
    n_uses = cfg.n_layers // cfg.shared_attn_every
    g = torch.Generator().manual_seed(22)
    toks = torch.randint(0, cfg.vocab, (2, max(HYBRID_SEQS) + 4),
                         generator=g)
    models = {dev: init_params(0, cfg, device=dev) for dev in ("cuda", "cpu")}
    gaps = []
    _zero(SSD.LAUNCHES_BY_ROUTE)   # the float32 hybrid serving path starts
    _zero(FA.LAUNCHES_BY_ROUTE)    # here
    for n in HYBRID_SEQS:
        res = {dev: _serve_run(m, cfg, toks[:, :n].to(dev),
                               toks[:, n:n + 4].to(dev),
                               cache_dtype=torch.float32)
               for dev, m in models.items()}
        pairs = list(zip(res["cuda"][0], res["cpu"][0])) + [
            (res["cuda"][1][part][k], res["cpu"][1][part][k])
            for part, k in (("ssm", "state"), ("ssm", "conv"), ("kv", "k"),
                            ("kv", "v"))]
        gaps += [_gap(a.cpu(), b, OLMO_F32_TOL) for a, b in pairs]
    by_route = dict(ssd_scan=dict(SSD.LAUNCHES_BY_ROUTE),   # ... and ends
                    flash_attention=dict(FA.LAUNCHES_BY_ROUTE))   # here
    errs = [x["max_abs"] for x in gaps]
    print(f"[H1] zamba2 SMOKE float32, kernels on the card vs plain on the "
          f"CPU, prompts of {HYBRID_SEQS} tokens: prefill + 4 decode logits, "
          f"SSM state, conv carry and K/V, max |d| {max(errs):.3g} (tol "
          f"{OLMO_F32_TOL}); launches by route {by_route}", flush=True)
    if not all(_ok(x) for x in gaps):
        fail("H1: zamba2 SMOKE: card and CPU disagree")
    want = len(HYBRID_SEQS)
    if by_route["ssd_scan"] != {"mma": 0, "simt": want * cfg.n_layers} or \
            by_route["flash_attention"] != {"wgmma": 0,
                                            "simt": want * n_uses}:
        fail(f"H1: the float32 hybrid prefills launched {by_route}, expected "
             f"{cfg.n_layers} SIMT SSD and {n_uses} SIMT flash launches a "
             f"prefill")
    tcfg = _hybrid_smoke_cfg()
    batch = SyntheticLM(DataConfig(vocab=tcfg.vocab, seq_len=DENSE_SEQ,
                                   global_batch=4, seed=2)).batch_at(0)
    step, _ = step_card_vs_cpu(tcfg, batch)
    print(f"[H1] zamba2 SMOKE float32 at {DENSE_SEQ} tokens, card vs CPU, one "
          f"train step: {_step_line(step)}", flush=True)
    state = init_train_state(0, tcfg, "cuda")
    tb = _to_device(SyntheticLM(DataConfig(
        vocab=tcfg.vocab, seq_len=DENSE_SEQ, global_batch=4,
        seed=2)).batch_at(1), "cuda")
    grads = {r: compute_grads(state.params, tb,
                              tcfg.replace(remat=r.split()[0]))[0]
             for r in ("none", "full", "dots", "none again")}
    remat = {r: sum(int((grads[r][k] != x).sum())
                    for k, x in grads["none"].items())
             for r in ("full", "dots", "none again")}
    n = sum(x.numel() for x in grads["none"].values())
    print(f"[H1] zamba2 SMOKE float32 on the card: gradients differing from "
          f"remat 'none' (of {n:,}): {remat}", flush=True)
    out = dict(max_abs_err=max(errs), launches_by_route=by_route, step=step,
               remat_mismatches=remat)
    REPORT["hybrid_card_vs_cpu"] = out
    if not step["ok"]:
        fail(f"H1: zamba2 SMOKE training, card and CPU disagree "
             f"({step['step_master_worst']})")
    if any(remat.values()):
        fail(f"H1: remat (or a second backward) changes the hybrid gradients "
             f"on the card: {remat}")
    return out


def phase_hybrid_vs_plain(cfg, model, prompt, run) -> dict:
    """H3: the kernel path against the plain path (``ssd_chunked`` and
    ``_attention_core``) on the card, prefill + OLMO_FORCED teacher-forced
    decode logits, by S4's rule: bf16 within LOGIT_TOL + LOGIT_TOL |b|
    except where the same run's floor -- both kernels' plain versions in
    their places against the plain path -- crosses it, by at most
    NOISE_FACTOR times the floor's ratio.  The Mamba2 state carries bf16
    noise through 81 layers and 13 attentions, so the relative RMS limit
    follows the floor's the same way (as for moe), and both are reported.
    float32: the bf16 weights of the first ZAMBA_F32_LAYERS layers cast on
    the card (float32 KV cache; the SIMT SSD kernel, and
    ``_attention_core``: no flash kernel takes float32 at head_dim 112),
    within OLMO_F32_TOL.  The kernel path's prefill also records the
    flash kernel's q, k, v and output at each use of the shared block:
    each output is held against ``flash_attention_plain`` on the same
    inputs at the caller's scale within A1's bf16 tolerance -- the padded
    D-112 route on the activations the main path gives it, which the
    81-layer logits can no longer resolve."""
    import torch

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.models import model as M

    forced = run["tokens"][:, :OLMO_FORCED]
    uses, launch = [], ops.flash_attention

    def recorded(q, k, v, **kw):
        got = launch(q, k, v, **kw)
        uses.append((q.clone(), k.clone(), v.clone(), kw, got.clone()))
        return got

    with mock.patch.object(ops, "flash_attention", recorded):
        k_out, k_cache = _serve_run(model, cfg, prompt, forced)
    tol = FLASH_TOL["bfloat16"]
    flash_uses, n_uses = [], cfg.n_layers // cfg.shared_attn_every
    while uses:
        q, k, v, kw, got = uses.pop(0)
        want = FA.flash_attention_plain(q, k, v, **kw)
        flash_uses.append(dict(shape=tuple(q.shape), scale=kw["scale"],
                               **_gap(got, want, tol)))
        del q, k, v, got, want
    if len(flash_uses) != n_uses:
        fail(f"H3: {cfg.name}'s prefill called the flash kernel "
             f"{len(flash_uses)} times, expected {n_uses}")
    worst = max(flash_uses, key=lambda g: g["max_ratio"])
    print(f"[H3] {cfg.name} flash kernel vs flash_attention_plain on the "
          f"q, k, v of the prefill's {len(flash_uses)} shared-block uses "
          f"{flash_uses[0]['shape']} bf16, scale {flash_uses[0]['scale']:.5f}"
          f": worst max |d| {worst['max_abs']:.3g} = {worst['max_ratio']:.3f} "
          f"x ({tol} + {tol}|b|), rel RMS up to "
          f"{max(g['rel_rms'] for g in flash_uses):.3g}", flush=True)
    if not all(_ok(g) for g in flash_uses):
        fail(f"H3: {cfg.name}: the flash kernel at the shared block's uses "
             f"differs from its plain version (worst {worst})")
    st_k = k_cache["ssm"]["state"].clone()
    del k_cache
    p_out, p_cache = _serve_run(model, cfg.replace(use_flash_kernel=False),
                                prompt, forced)
    st_err = float((st_k - p_cache["ssm"]["state"]).abs().max())
    del p_cache, st_k
    with mock.patch.object(ops, "ssd_scan", SSD.ssd_scan_plain), \
            mock.patch.object(ops, "flash_attention",
                              FA.flash_attention_plain):
        q_out, _ = _serve_run(model, cfg, prompt, forced)
    k, p, q = (torch.stack(o) for o in (k_out, p_out, q_out))
    bf16, floor = _gap(k, p, LOGIT_TOL), _gap(q, p, LOGIT_TOL)
    bf16["limit_ratio"] = max(1.0, NOISE_FACTOR * floor["max_ratio"])
    bf16["rms_limit"] = max(LOGIT_TOL, NOISE_FACTOR * floor["rel_rms"])
    bf16["argmax_agree"] = float((k.argmax(-1) == p.argmax(-1)).float().mean())
    bf16["decode"] = _gap(k[1:], p[1:], LOGIT_TOL)
    del k_out, p_out, q_out
    torch.cuda.empty_cache()
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32",
                        n_layers=ZAMBA_F32_LAYERS)
    model32 = M.HybridLM(cfg32)                    # on the meta device
    kept = {n for n, _ in model32.named_parameters()}
    model32.load_state_dict({n: t.float() for n, t in
                             model.named_parameters() if n in kept},
                            assign=True)
    p32, _ = _serve_run(model32, cfg32.replace(use_flash_kernel=False),
                        prompt, forced, cache_dtype=torch.float32)
    k32, _ = _serve_run(model32, cfg32, prompt, forced,
                        cache_dtype=torch.float32)
    f32 = _gap(torch.stack(k32), torch.stack(p32), OLMO_F32_TOL)
    del model32, k32, p32
    torch.cuda.empty_cache()
    out = dict(bf16=bf16, bf16_plain_vs_plain=floor, bf16_state_err=st_err,
               f32=f32, f32_layers=ZAMBA_F32_LAYERS, flash_uses=flash_uses)
    REPORT["hybrid_vs_plain"] = out
    print(f"[H3] {cfg.name} kernel path vs plain path (ssd_chunked, "
          f"_attention_core) on the card, prefill + {OLMO_FORCED} "
          f"teacher-forced decode logits: bf16 rel RMS {bf16['rel_rms']:.4g} "
          f"(limit {bf16['rms_limit']:.4g}), max |d| {bf16['max_abs']:.4g} = "
          f"{bf16['max_ratio']:.3f} x ({LOGIT_TOL} + {LOGIT_TOL}|b|) (limit "
          f"{bf16['limit_ratio']:.3f} x), decode steps alone rel RMS "
          f"{bf16['decode']['rel_rms']:.4g}, {bf16['decode']['max_ratio']:.3f}"
          f" x; argmax agree {bf16['argmax_agree']:.3f}, max |dstate| after "
          f"the last step {st_err:.3g}; noise floor (both plain versions in "
          f"the kernels' places vs the plain path): rel RMS "
          f"{floor['rel_rms']:.4g}, max |d| {floor['max_abs']:.4g} = "
          f"{floor['max_ratio']:.3f} x; float32 at full width, "
          f"{ZAMBA_F32_LAYERS} layers: max |d| {f32['max_abs']:.3g} = "
          f"{f32['max_ratio']:.4f} x ({OLMO_F32_TOL} + {OLMO_F32_TOL}|b|)",
          flush=True)
    if not (bf16["finite"] and bf16["max_ratio"] <= bf16["limit_ratio"]
            and bf16["rel_rms"] <= bf16["rms_limit"] and _ok(f32)):
        fail(f"H3: {cfg.name}: kernel path and plain path disagree")
    return out


def hybrid_bounds(cfg, model, batch: int, prompt: int) -> dict:
    """The least time of a prefill (the operations at the bf16 tensor
    rate: every Mamba2 projection, the shared block's projections and MLP
    at each of its uses, the attention's causal pairs and the SSD's work;
    against the bytes of the weights) and of a decode step at a cache of
    ``prompt`` + 3 tokens (the bytes: every Mamba2 block's weights, the
    shared block's once a use -- its 0.41 GB do not stay in the 50 MB
    L2 --, the tied embedding; the SSM state and conv carry read and
    written; the K/V read up to the step's position)."""
    from repro_torch.models import ssm as SSM

    def nbytes(mod):
        return sum(p.numel() * p.element_size() for p in mod.parameters())

    def products(mod):
        return sum(p.numel() for p in mod.parameters() if p.dim() >= 2)

    a, s = cfg.attention, cfg.ssm
    n_uses = cfg.n_layers // cfg.shared_attn_every
    tokens = batch * prompt
    d_inner, nheads, hd = SSM.ssm_dims(cfg)
    mamba_mm = sum(b.mixer.in_proj.numel() + b.mixer.out_proj.numel()
                   for b in model.blocks)
    shared_mm = products(model.shared)
    _, attn_flops = flash_work(batch * a.n_kv_heads, a.n_heads // a.n_kv_heads,
                               prompt, prompt, a.head_dim, 2)
    _, ssd_bf16, ssd_f32 = ssd_work(batch, prompt, nheads, hd, s.d_state,
                                    s.chunk, 2, False)
    flops = (2 * tokens * (mamba_mm + n_uses * shared_mm)
             + n_uses * attn_flops
             + cfg.n_layers * (ssd_bf16 + ssd_f32)
             + 2 * batch * cfg.d_model * cfg.vocab)
    weights = nbytes(model)
    t_ops = flops / BF16_TC_OPS_PER_S * 1e3
    prefill = dict(flops=flops, bound_ops_ms=t_ops,
                   bound_bytes_ms=weights / HBM_BYTES_PER_S * 1e3,
                   bound_ms=max(t_ops, weights / HBM_BYTES_PER_S * 1e3))
    conv_dim = d_inner + 2 * s.d_state
    state = cfg.n_layers * batch * nheads * hd * s.d_state * 4
    conv = cfg.n_layers * batch * (s.conv_width - 1) * conv_dim * 4
    kv = n_uses * 2 * batch * a.n_kv_heads * (prompt + 3) * a.head_dim * 2
    read = (nbytes(model.blocks) + n_uses * nbytes(model.shared)
            + nbytes(model.embed) + nbytes(model.final_norm))
    step = read + 2 * (state + conv) + kv
    decode = dict(weight_bytes=read, state_bytes=2 * (state + conv),
                  kv_bytes=kv, bytes=step,
                  bound_ms=step / HBM_BYTES_PER_S * 1e3)
    return dict(prefill=prefill, decode=decode)


def phase_hybrid_profile(cfg, model, prompt, n_tokens: int,
                         bounds: dict) -> dict:
    """H4: ``torch.profiler`` over one warm prefill and 5 decode steps of
    zamba2-7b, the device time split into the SSD kernels, the flash
    kernel, the Mamba2 mixers' products (the in/out projections) and the
    rest of the mixers (the conv, gating, gated norm, the decode
    recurrence), the shared block's products and the rest of it (RoPE,
    norms, the pad copies, ``_attention_core`` in decode), and the rest;
    the idle share against each profiled run's own wall; beside the
    prefill's and a decode step's bounds."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import model as M
    from repro_torch.models import ssm as SSM
    from repro_torch.serve.step import make_prefill_step, make_serve_step

    real_mixer, real_block = SSM.apply_mamba2, M._apply_dense_block

    def mixer_span(*a, **k):
        with record_function("mamba2 mixer"):
            return real_mixer(*a, **k)

    def block_span(*a, **k):
        with record_function("shared block"):
            return real_block(*a, **k)

    spans = ("mamba2 mixer", "shared block")
    gemms = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")

    ours = SSD_KERNEL_NAMES + FLASH_KERNEL_NAMES

    def split(prof, steps: int) -> dict:
        """Kernel microseconds by category: the port's kernels (launched
        through ctypes, under no torch operator) by name; every other
        kernel by the span its launching operator runs inside."""
        rows = [r for r in _kernel_rows(prof) if r[0] not in spans]
        total = sum(r[1] for r in rows)
        ssd = sum(r[1] for r in rows
                  if any(n in r[0] for n in SSD_KERNEL_NAMES))
        flash = sum(r[1] for r in rows
                    if any(n in r[0] for n in FLASH_KERNEL_NAMES))
        part = dict(mamba_products=0.0, mamba_rest=0.0, shared_products=0.0,
                    shared_rest=0.0, rest=0.0)
        for e, own, up in _operator_kernels(prof, ours):
            where = ("mamba" if "mamba2 mixer" in up else
                     "shared" if "shared block" in up else None)
            if where is None:
                part["rest"] += own
            else:
                kind = "products" if e.name in gemms else "rest"
                part[f"{where}_{kind}"] += own
        ms = dict(device=total, ssd_kernels=ssd, flash=flash, **part)
        # the kernel rows' total against the operators' sums: what the
        # profiler filed under no operator, or under two
        ms["unattributed"] = total - ssd - flash - sum(part.values())
        return {k: v / 1e3 / steps for k, v in ms.items()}

    pre = make_prefill_step(cfg, max_seq=prompt.shape[1] + n_tokens)
    srv = make_serve_step(cfg)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {}
    with mock.patch.object(SSM, "apply_mamba2", mixer_span), \
            mock.patch.object(M, "_apply_dense_block", block_span):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            logits, cache = pre(model, {"tokens": prompt})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out["prefill"] = dict(split(prof, 1), wall_ms=wall * 1e3,
                              bound_ms=bounds["prefill"]["bound_ms"])
        tok = logits[:, -1].argmax(-1)[:, None]
        steps = 5
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                logits, cache = srv(model, cache, {"tokens": tok})
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / steps
        out["decode"] = dict(split(prof, steps), wall_ms=wall * 1e3,
                             bound_ms=bounds["decode"]["bound_ms"])
    del cache
    for part in ("prefill", "decode"):
        r = out[part]
        if r["device"] <= 0:
            r["note"] = "the profiler recorded no device time: not measured"
        else:
            r["idle_share"] = 1.0 - r["device"] / r["wall_ms"]
        unit = "ms" if part == "prefill" else "ms a step"
        print(f"[H4] {cfg.name} {part} profile ({unit}): device "
              f"{r['device']:.3f} of {r['wall_ms']:.3f} wall, idle "
              f"{r.get('idle_share', float('nan')):.1%}; SSD kernels "
              f"{r['ssd_kernels']:.3f}, flash {r['flash']:.3f}, Mamba2 "
              f"projections {r['mamba_products']:.3f}, rest of the Mamba2 "
              f"mixers (conv, gating, norm, recurrence) "
              f"{r['mamba_rest']:.3f}, shared block products "
              f"{r['shared_products']:.3f}, rest of the shared block "
              f"{r['shared_rest']:.3f}, rest {r['rest']:.3f} (kernel rows "
              f"no operator accounts for {r['unattributed']:.3f}); bound "
              f"{r['bound_ms']:.3f}", flush=True)
    return out


def hybrid_serve() -> dict:
    """H3 (main path) and H4: zamba2-7b at full width and depth (81 Mamba2
    layers, 13 uses of the shared block), drawn on the card by a CUDA
    generator, bf16: ``greedy_generate`` of 32 tokens after a 1024-token
    prompt, batch 8, with the SSD and flash counts at 0 just before and
    read just after -- exactly 81 SSD calls, all ``mma``, and 13 flash
    launches, all ``wgmma``, in the prefill; none in decode.  Then the
    timed prefill and decode, the plain path's prefill, the logits against
    the plain path, the profile and the bounds.  The model is freed
    after."""
    import torch

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD

    _require_free_card("H3")
    cfg, model, prompt = dense_setup("H3", ZAMBA)
    n_uses = cfg.n_layers // cfg.shared_attn_every
    SSD.LAUNCHES = FA.LAUNCHES = 0      # this serving main path starts here
    _zero(SSD.LAUNCHES_BY_ROUTE)
    _zero(FA.LAUNCHES_BY_ROUTE)
    run = phase_serve(cfg, model, prompt, OLMO_TOKENS)
    launches = dict(ssd_scan=SSD.LAUNCHES,    # ... and ends here
                    flash_attention=FA.LAUNCHES)
    by_route = dict(ssd_scan=dict(SSD.LAUNCHES_BY_ROUTE),
                    flash_attention=dict(FA.LAUNCHES_BY_ROUTE))
    print(f"[H3] {ZAMBA} serving main path (greedy_generate, one prefill of "
          f"{cfg.n_layers} Mamba2 layers and {n_uses} uses of the shared "
          f"block, {OLMO_TOKENS - 1} decode steps): launches {launches}, by "
          f"route {by_route}", flush=True)
    if by_route["ssd_scan"] != {"mma": cfg.n_layers, "simt": 0} or \
            by_route["flash_attention"] != {"wgmma": n_uses, "simt": 0}:
        fail(f"H3: {ZAMBA}'s serving main path launched {by_route}, expected "
             f"{cfg.n_layers} mma SSD calls and {n_uses} wgmma flash "
             f"launches (prefill only)")
    out = dict(launches=launches, launches_by_route=by_route)
    out["serve"] = phase_serve_measure(
        "H4", cfg, model, prompt, run, OLMO_TOKENS,
        "ssd_chunked + _attention_core")
    torch.cuda.empty_cache()
    out["vs_plain"] = phase_hybrid_vs_plain(cfg, model, prompt, run)
    bounds = hybrid_bounds(cfg, model, OLMO_BATCH, OLMO_PROMPT)
    out["bounds"] = bounds
    out["profile"] = phase_hybrid_profile(cfg, model, prompt, OLMO_TOKENS,
                                          bounds)
    pre_s = min(out["serve"]["prefill_s"])
    step_ms = 1e3 * OLMO_BATCH / out["serve"]["decode_tok_s"]
    print(f"[H4] {ZAMBA} on {nvidia_smi()}: prefill {pre_s:.4f} s (best warm) "
          f"against its bound {bounds['prefill']['bound_ms'] / 1e3:.4f} s "
          f"({bounds['prefill']['flops'] / 1e12:.1f} TFLOP at 989 TFLOP/s); "
          f"decode {out['serve']['decode_tok_s']:.1f} tokens/s = "
          f"{step_ms:.2f} ms a step against its bound "
          f"{bounds['decode']['bound_ms']:.2f} ms "
          f"({bounds['decode']['bytes'] / 1e9:.2f} GB at 3.35 TB/s: weights "
          f"{bounds['decode']['weight_bytes'] / 1e9:.2f}, SSM state and conv "
          f"{bounds['decode']['state_bytes'] / 1e9:.2f}, K/V "
          f"{bounds['decode']['kv_bytes'] / 1e9:.2f}); peak "
          f"{run['mem'] / 2**30:.2f} GiB", flush=True)
    del model, run
    torch.cuda.empty_cache()
    REPORT[f"{ZAMBA}_serving"] = out
    return out


def phase_hybrid_train() -> dict:
    """H5 (main path): zamba2-7b at full width cut to ZAMBA_TRAIN_LAYERS
    layers (two uses of the shared block), drawn on the card (bf16, remat
    'dots', ``ssd_chunked`` and ``_attention_core``), ZAMBA_TRAIN_STEPS
    steps of ``make_train_step`` on SyntheticLM batch 8 x 1024 in
    TRAIN_MICRO microbatches at AdamW 1e-4: finite losses; step seconds,
    tokens/s, peak memory.  Then compress_grads three times on the trained
    model's gradients, the error state carried: one quantize and two
    dequantize launches a leaf a call, |err| within EF_SLACK."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.train import training_config
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.schedule import constant
    from repro_torch.train.step import (_to_device, init_train_state,
                                        make_train_step)

    _require_free_card("H5")
    cfg = training_config(get_config(ZAMBA)).replace(
        n_layers=ZAMBA_TRAIN_LAYERS, remat="dots")
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                             cfg, "cuda")
    n_params = sum(p.numel() for p in state.params.parameters())
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=0))
    step = make_train_step(cfg, AdamWConfig(lr=DENSE_LR), constant(1.0),
                           n_microbatches=TRAIN_MICRO)
    secs, losses = [], []
    for i in range(ZAMBA_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, m = step(state, data.batch_at(i))
        torch.cuda.synchronize()
        secs.append(time.monotonic() - t0)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    warm = min(secs[1:])
    tok_s = TRAIN_BATCH * TRAIN_SEQ / warm
    print(f"[H5] {ZAMBA} at full width, {cfg.n_layers} layers "
          f"({cfg.n_layers // cfg.shared_attn_every} uses of the shared "
          f"block): {n_params:,} parameters drawn on the card; "
          f"{ZAMBA_TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} in "
          f"{TRAIN_MICRO} microbatches (bf16, remat dots, AdamW {DENSE_LR}): "
          f"losses {[round(v, 4) for v in losses]}; step "
          f"{', '.join(f'{s:.4f}' for s in secs)} s, warm {warm:.4f} s = "
          f"{tok_s:,.0f} tokens/s, peak {peak / 2**30:.2f} GiB", flush=True)
    if not all(math.isfinite(v) for v in losses):
        fail(f"H5: hybrid training losses {losses}")
    out = dict(compress_calls(state.params, cfg, [
        _to_device(data.batch_at(ZAMBA_TRAIN_STEPS + i), "cuda")
        for i in range(3)]), n_params=n_params, layers=cfg.n_layers,
        microbatches=TRAIN_MICRO, step_s=secs, warm_step_s=warm,
        tokens_per_s=tok_s, peak_bytes=peak, losses=losses)
    print(f"[H5] compress_grads x3 over {out['n_leaves']} leaves: launches "
          f"per call {out['compress_launches']}, "
          f"{', '.join(f'{t:.3f}' for t in out['compress_seconds'])} s, "
          f"error feedback max |err| / (scale/2) "
          f"{out['error_feedback_max_ratio']:.7f} (limit {EF_SLACK})",
          flush=True)
    _check_compress("H5", out)
    del state, step
    return out


def hybrid_phases(standalone: bool) -> dict:
    """H1-H5: the hybrid SMOKE checks; zamba2's kernel shapes (the S1 and
    V1 cases run here only when ``standalone``: the whole script runs them
    in S1 and V1) timed beside their bounds; zamba2-7b served whole (the
    SSD and flash counts at 0 just before its serving main path and read
    just after, inside :func:`hybrid_serve`); the 12-layer zamba2 trained
    (the ckpt_quant counts at 0 just before and read just after)."""
    import torch

    from repro_torch.kernels import (ckpt_quant, flash_attention, sim_step,
                                     ssd_scan)

    card = phase_hybrid_card_vs_cpu()
    _lap("H1")
    if standalone:
        phase_ssd_kernel_vs_plain(hybrid_only=True)
        phase_variant_flash_vs_plain((ZAMBA,))
    ssd = phase_ssd_measure(ZAMBA_SSD_SHAPE, "H2")
    flash = phase_variant_flash_measure((ZAMBA,), "H2")[ZAMBA]
    _lap("H2")
    serve = hybrid_serve()
    _lap("H3-H4")
    for k in ckpt_quant.LAUNCHES:   # the hybrid training main path starts here
        ckpt_quant.LAUNCHES[k] = 0
    sim_step.LAUNCHES = ssd_scan.LAUNCHES = flash_attention.LAUNCHES = 0
    train = phase_hybrid_train()
    launches = dict(ckpt_quant.LAUNCHES)   # ... and ends here
    other = dict(sim_step=sim_step.LAUNCHES, ssd_scan=ssd_scan.LAUNCHES,
                 flash_attention=flash_attention.LAUNCHES)
    REPORT["hybrid_train_main_path_launches"] = dict(launches, **other)
    print(f"[H5] hybrid training main path: launches {launches} (3 "
          f"compress_grads calls over {train['n_leaves']} leaves), {other} "
          f"(training runs ssd_chunked and _attention_core)", flush=True)
    if min(launches.values()) < 1 or any(other.values()):
        fail("H5: the hybrid training main path launched no ckpt_quant "
             "kernel, or launched another kernel")
    quant_vs_plain = quant_vs_plain_all_leaves("H5", train, ZAMBA_EMBED_LEAF)
    torch.cuda.empty_cache()
    quant = phase_quant_measure(ZAMBA_EMBED_LEAF, "H5",
                                "zamba2-7b's embedding leaf")
    _lap("H5")
    REPORT["hybrid_train"] = train
    return dict(card_vs_cpu=card, ssd=ssd, flash=flash,
                serve=serve, train=train, train_launches=launches,
                quant_vs_plain=quant_vs_plain, quant=quant)


# --------------------------------------------------------------------------- #
# The encdec family: whisper-large-v3 served whole, encdec training
# --------------------------------------------------------------------------- #

WHISPER = "whisper-large-v3"
ENCDEC_SEQS = (8, 13)       # E1: decoder prompts over SMOKE's 16 frames
# E3: batch 8, a 128-token decoder prompt (whisper's decoder conditions on
# up to 224 tokens of earlier text within its 448-token context), 32
# greedy tokens; the frames (8, 1500, 1280) from seed 2
WHISPER_PROMPT = 128
# E3's float32 check at full width: the first 4 encoder and 4 decoder
# layers (0.47 GB of float32 weights beside the 3.07 GB bf16 model; 4 + 4,
# not 8 + 8, to keep the whole script inside its time limit)
WHISPER_F32_LAYERS = 4
# E5: full width cut to 8 + 8 layers (433,497,600 parameters; 16 + 16 until
# TP7-TP8 needed the time): the whole model's training state at ~45 bytes a
# parameter (D2's olmo-1b measure) would be ~69 GB before activations.  8 x
# 448 decoder tokens (whisper's context) over 8 x 1,500 frames
WHISPER_TRAIN_LAYERS, WHISPER_TRAIN_STEPS, WHISPER_TRAIN_SEQ = 8, 5, 448
WHISPER_EMBED_LEAF = 51_866 * 1280   # 66,388,480 float32: 129,665 blocks


def _encdec_smoke_cfg(**change):
    from repro_torch.configs import get_smoke_config

    return get_smoke_config(WHISPER).replace(param_dtype="float32",
                                             compute_dtype="float32",
                                             **change)


def phase_encdec_card_vs_cpu() -> dict:
    """E1: whisper SMOKE in float32 with the kernel on (the SIMT flash
    kernel at head_dim 16, unmasked in the encoder and the
    cross-attention), the card against the CPU from the same CPU-drawn
    weights and frames: prefill of 8 and 13 decoder tokens over 16 frames
    and 4 teacher-forced decode steps, logits, self K/V and cross K/V
    within 1e-4, exactly 6 flash launches a prefill (2 encoder, 2 decoder
    self, 2 cross) and none in decode.  Then one float32 train step on a
    batch with frames (T2's rule), and on the card remat none, full and
    dots and a second backward bitwise the same gradients."""
    import torch

    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import init_params
    from repro_torch.train.step import (_to_device, compute_grads,
                                        init_train_state)

    cfg = _encdec_smoke_cfg(use_flash_kernel=True)
    g = torch.Generator().manual_seed(23)
    toks = torch.randint(0, cfg.vocab, (2, max(ENCDEC_SEQS) + 4),
                         generator=g)
    frames = torch.randn((2, cfg.enc_seq, cfg.d_model), generator=g)
    models = {dev: init_params(0, cfg, device=dev) for dev in ("cuda", "cpu")}
    per_prefill = cfg.n_enc_layers + 2 * cfg.n_layers
    gaps = []
    _zero(FA.LAUNCHES_BY_ROUTE)    # the float32 encdec serving path starts here
    for n in ENCDEC_SEQS:
        res = {dev: _serve_run(m, cfg, toks[:, :n].to(dev),
                               toks[:, n:n + 4].to(dev),
                               cache_dtype=torch.float32,
                               frames=frames.to(dev))
               for dev, m in models.items()}
        (lg, cg), (lc, cc) = res["cuda"], res["cpu"]
        pairs = list(zip(lg, lc)) + [(cg["kv"][k], cc["kv"][k])
                                     for k in ("k", "v")] + [
            (cg[k], cc[k]) for k in ("cross_k", "cross_v")]
        gaps += [_gap(a.cpu(), b, OLMO_F32_TOL) for a, b in pairs]
    by_route = dict(FA.LAUNCHES_BY_ROUTE)    # ... and ends here
    errs = [x["max_abs"] for x in gaps]
    print(f"[E1] whisper SMOKE float32, kernel on the card vs plain on the "
          f"CPU, decoder prompts of {ENCDEC_SEQS} tokens over "
          f"{cfg.enc_seq} frames: prefill + 4 decode logits, self K/V and "
          f"cross K/V, max |d| {max(errs):.3g} (tol {OLMO_F32_TOL}); flash "
          f"launches by route {by_route}", flush=True)
    if not all(_ok(x) for x in gaps):
        fail("E1: whisper SMOKE: card and CPU disagree")
    want = len(ENCDEC_SEQS) * per_prefill
    if by_route != {"wgmma": 0, "simt": want}:
        fail(f"E1: the float32 encdec prefills launched {by_route}, expected "
             f"{per_prefill} SIMT launches a prefill ({cfg.n_enc_layers} "
             f"encoder, {cfg.n_layers} decoder self, {cfg.n_layers} cross) "
             f"and none in decode")
    tcfg = _encdec_smoke_cfg()

    def batch_at(i):
        b = SyntheticLM(DataConfig(vocab=tcfg.vocab, seq_len=DENSE_SEQ,
                                   global_batch=4, seed=2)).batch_at(i)
        b["frames"] = torch.randn((4, tcfg.enc_seq, tcfg.d_model),
                                  generator=g).numpy()
        return b

    step, _ = step_card_vs_cpu(tcfg, batch_at(0))
    print(f"[E1] whisper SMOKE float32 at {DENSE_SEQ} decoder tokens, card vs "
          f"CPU, one train step: {_step_line(step)}", flush=True)
    state = init_train_state(0, tcfg, "cuda")
    tb = _to_device(batch_at(1), "cuda")
    grads = {r: compute_grads(state.params, tb,
                              tcfg.replace(remat=r.split()[0]))[0]
             for r in ("none", "full", "dots", "none again")}
    remat = {r: sum(int((grads[r][k] != x).sum())
                    for k, x in grads["none"].items())
             for r in ("full", "dots", "none again")}
    n = sum(x.numel() for x in grads["none"].values())
    print(f"[E1] whisper SMOKE float32 on the card: gradients differing from "
          f"remat 'none' (of {n:,}): {remat}", flush=True)
    out = dict(max_abs_err=max(errs), launches_by_route=by_route, step=step,
               remat_mismatches=remat)
    REPORT["encdec_card_vs_cpu"] = out
    if not step["ok"]:
        fail(f"E1: whisper SMOKE training, card and CPU disagree "
             f"({step['step_master_worst']})")
    if any(remat.values()):
        fail(f"E1: remat (or a second backward) changes the encdec gradients "
             f"on the card: {remat}")
    return out


def phase_encdec_flash() -> dict:
    """E2: the flash kernel at whisper-large-v3's three prefill shapes --
    the encoder's unmasked (160, 1, 1500, 1500, 64), the cross-attention's
    unmasked (160, 1, 128, 1500, 64) and the decoder's causal (160, 1,
    128, 128, 64), bf16: the tensor-core route -- against its plain
    version within A1's bf16 tolerance and FLASH_BF16_RMS, each unmasked
    shape also against its planted fault (:func:`padded_keys_control`),
    which the same check must reject; then timed by CUDA events beside
    the plain version, ``scaled_dot_product_attention`` with the same mask
    (the yardstick) and the bound."""
    import torch

    from repro_torch.kernels import flash_attention as FA

    tol = FLASH_TOL["bfloat16"]
    out = {}
    for i, (name, shape, causal) in enumerate((
            ("encoder", FLASH_WHISPER_ENC_SHAPE, False),
            ("cross", FLASH_WHISPER_CROSS_SHAPE, False),
            ("decoder self", FLASH_WHISPER_SELF_SHAPE, True))):
        bg, r, sq, skv, d = shape
        q, k, v = flash_inputs(bg, r, sq, skv, d, torch.bfloat16, 800 + i)
        kw = dict(scale=d ** -0.5, causal=causal)
        want = FA.flash_attention_plain(q, k, v, **kw)
        before = FA.LAUNCHES_BY_ROUTE["wgmma"]
        got = FA.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        g = _gap(got, want, tol)
        launched = FA.LAUNCHES_BY_ROUTE["wgmma"] - before
        ctl = None if causal else padded_keys_control(q, k, v, kw, want, tol)

        def kern():
            return FA.flash_attention(q, k, v, **kw)

        ms_a = cuda_ms(kern, 20)
        plain_ms = cuda_ms(lambda: FA.flash_attention_plain(q, k, v, **kw), 3)
        ms_b = cuda_ms(kern, 20)
        lib_gap = _gap(_sdpa(q, k, v, kw["scale"], causal), got, tol)
        lib_ms = cuda_ms(lambda: _sdpa(q, k, v, kw["scale"], causal), 20)
        row = dict(shape=shape, causal=causal, route=FA.route(q.dtype, d),
                   launched_wgmma=launched, max_abs_err=g["max_abs"],
                   gap=g, ms=min(ms_a, ms_b), ms_runs=[ms_a, ms_b],
                   plain_ms=plain_ms, library_ms=lib_ms,
                   library_equals_kernel=_ok(lib_gap), library_gap=lib_gap,
                   padded_keys_control=ctl,
                   control_rejected=ctl is None or not _flash_ok(
                       ctl, torch.bfloat16),
                   **flash_bound(bg, r, sq, skv, d, None, causal))
        row["ok"] = _flash_ok(g, torch.bfloat16) and launched == 1 and \
            row["route"] == "wgmma" and row["control_rejected"]
        out[name] = row
        planted = "" if ctl is None else (
            f"; planted fault (the {ctl['padded_keys']} zero keys of the "
            f"last tile visible) max |d| {ctl['max_abs']:.3g} = "
            f"{ctl['max_ratio']:.3f} x, rel RMS {ctl['rel_rms']:.3g}: "
            f"{'rejected' if row['control_rejected'] else 'PASSED'}")
        print(f"[E2] flash_attention {row['route']} kernel at whisper's "
              f"{name} {shape} bf16, {'causal' if causal else 'no mask'}: "
              f"vs plain max |d| {g['max_abs']:.3g} = {g['max_ratio']:.3f} x "
              f"({tol} + {tol}|b|), rel RMS {g['rel_rms']:.3g} (limit "
              f"{FLASH_BF16_RMS}){planted}; kernel {ms_a:.4f}, "
              f"{ms_b:.4f} ms; plain "
              f"{plain_ms:.4f} ms; scaled_dot_product_attention "
              f"{lib_ms:.4f} ms (equals the kernel within {tol}: "
              f"{_ok(lib_gap)}, max |d| {lib_gap['max_abs']:.3g}); bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}: "
              f"{row['bytes']:,} B at 3.35 TB/s = "
              f"{row['bound_bytes_ms']:.4f} ms, {row['flops']:,} flop at the "
              f"bf16 tensor rate = {row['bound_ops_ms']:.4f} ms)", flush=True)
        del q, k, v, want, got
    REPORT["encdec_flash"] = out
    if not all(r["ok"] for r in out.values()):
        fail("E2: the flash kernel differs from its plain version at a "
             "whisper shape (or left the tensor-core route, or the check "
             "passed the planted fault)")
    return out


def phase_encdec_vs_plain(cfg, model, prompt, frames, run) -> dict:
    """E3: the kernel path against the plain path (``_attention_core`` and
    the plain cross-attention) on the card, prefill + OLMO_FORCED
    teacher-forced decode logits, by S4's rule: bf16 within LOGIT_TOL +
    LOGIT_TOL |b| except where the same run's floor --
    ``flash_attention_plain`` in the kernel's place against the plain
    path -- crosses it, by at most NOISE_FACTOR times the floor's ratio;
    relative RMS within LOGIT_TOL, or NOISE_FACTOR times the floor's where
    the floor's is larger (as for moe and hybrid).  The kernel path's
    prefill also holds each of its flash calls against
    ``flash_attention_plain`` on the same q, k, v within A1's bf16
    tolerance and FLASH_BF16_RMS: 32 encoder calls (unmasked), then a
    decoder self-attention (causal) and a cross-attention (unmasked) a
    layer.  float32: the bf16
    weights of the first WHISPER_F32_LAYERS encoder and decoder layers cast
    on the card (float32 caches; the SIMT kernel), within OLMO_F32_TOL."""
    import torch

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    forced = run["tokens"][:, :OLMO_FORCED]
    tol = FLASH_TOL["bfloat16"]
    calls, launch = [], ops.flash_attention

    def recorded(q, k, v, **kw):
        got = launch(q, k, v, **kw)
        want = FA.flash_attention_plain(q, k, v, **kw)
        calls.append(dict(sq=q.shape[2], skv=k.shape[1],
                          causal=kw["causal"], **_gap(got, want, tol)))
        return got

    with mock.patch.object(ops, "flash_attention", recorded):
        k_out, _ = _serve_run(model, cfg, prompt, forced, frames=frames)
    T, S, E, L = cfg.enc_seq, prompt.shape[1], cfg.n_enc_layers, cfg.n_layers
    order = [(c["sq"], c["skv"], c["causal"]) for c in calls]
    want_order = [(T, T, False)] * E + [(S, S, True), (S, T, False)] * L
    worst = max(calls, key=lambda c: c["max_ratio"])
    worst_rms = max(calls, key=lambda c: c["rel_rms"])
    kinds, rms = {}, {}
    for c, key in zip(calls, ["encoder"] * E + ["self", "cross"] * L):
        kinds.setdefault(key, []).append(c["max_ratio"])
        rms.setdefault(key, []).append(c["rel_rms"])
    print(f"[E3] {cfg.name} flash kernel vs flash_attention_plain on the q, "
          f"k, v of each of the prefill's {len(calls)} calls (bf16): worst "
          f"max |d| {worst['max_abs']:.3g} = {worst['max_ratio']:.3f} x "
          f"({tol} + {tol}|b|) at {worst['sq']} x {worst['skv']}"
          f"{'' if worst['causal'] else ' unmasked'}; worst ratio by kind "
          f"{ {k: round(max(v), 4) for k, v in kinds.items()} }; worst rel "
          f"RMS {worst_rms['rel_rms']:.3g} (limit {FLASH_BF16_RMS}), by kind "
          f"{ {k: float(f'{max(v):.3g}') for k, v in rms.items()} }",
          flush=True)
    if order != want_order:
        fail(f"E3: {cfg.name}'s prefill called the flash kernel as "
             f"{order[:4]}... ({len(order)} calls), expected {E} unmasked "
             f"encoder calls, then a causal self and an unmasked cross call "
             f"for each of {L} decoder layers")
    if not all(_flash_ok(c, torch.bfloat16) for c in calls):
        fail(f"E3: {cfg.name}: the flash kernel at a prefill call differs "
             f"from its plain version (worst {worst}, {worst_rms})")
    p_out, _ = _serve_run(model, cfg.replace(use_flash_kernel=False), prompt,
                          forced, frames=frames)
    with mock.patch.object(ops, "flash_attention", FA.flash_attention_plain):
        q_out, _ = _serve_run(model, cfg, prompt, forced, frames=frames)
    k, p, q = (torch.stack(o) for o in (k_out, p_out, q_out))
    bf16, floor = _gap(k, p, LOGIT_TOL), _gap(q, p, LOGIT_TOL)
    bf16["limit_ratio"] = max(1.0, NOISE_FACTOR * floor["max_ratio"])
    bf16["rms_limit"] = max(LOGIT_TOL, NOISE_FACTOR * floor["rel_rms"])
    bf16["argmax_agree"] = float((k.argmax(-1) == p.argmax(-1)).float().mean())
    bf16["decode"] = _gap(k[1:], p[1:], LOGIT_TOL)
    del k_out, p_out, q_out
    torch.cuda.empty_cache()
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32",
                        n_layers=WHISPER_F32_LAYERS,
                        n_enc_layers=WHISPER_F32_LAYERS)
    model32 = M.EncDecLM(cfg32)                    # on the meta device
    kept = {n for n, _ in model32.named_parameters()}
    model32.load_state_dict({n: t.float() for n, t in
                             model.named_parameters() if n in kept},
                            assign=True)
    p32, _ = _serve_run(model32, cfg32.replace(use_flash_kernel=False),
                        prompt, forced, cache_dtype=torch.float32,
                        frames=frames)
    k32, _ = _serve_run(model32, cfg32, prompt, forced,
                        cache_dtype=torch.float32, frames=frames)
    f32 = _gap(torch.stack(k32), torch.stack(p32), OLMO_F32_TOL)
    del model32, k32, p32
    torch.cuda.empty_cache()
    out = dict(bf16=bf16, bf16_plain_vs_plain=floor, f32=f32,
               f32_layers=WHISPER_F32_LAYERS, flash_calls=len(calls),
               flash_worst=worst, flash_worst_rms=worst_rms,
               flash_worst_ratio_by_kind={k: max(v) for k, v in kinds.items()},
               flash_worst_rms_by_kind={k: max(v) for k, v in rms.items()})
    REPORT["encdec_vs_plain"] = out
    print(f"[E3] {cfg.name} kernel path vs plain path (_attention_core, the "
          f"plain cross-attention) on the card, prefill + {OLMO_FORCED} "
          f"teacher-forced decode logits: bf16 rel RMS {bf16['rel_rms']:.4g} "
          f"(limit {bf16['rms_limit']:.4g}), max |d| {bf16['max_abs']:.4g} = "
          f"{bf16['max_ratio']:.3f} x ({LOGIT_TOL} + {LOGIT_TOL}|b|) (limit "
          f"{bf16['limit_ratio']:.3f} x), decode steps alone rel RMS "
          f"{bf16['decode']['rel_rms']:.4g}, {bf16['decode']['max_ratio']:.3f}"
          f" x; argmax agree {bf16['argmax_agree']:.3f}; noise floor "
          f"(flash_attention_plain in the kernel's place vs the plain path): "
          f"rel RMS {floor['rel_rms']:.4g}, max |d| {floor['max_abs']:.4g} = "
          f"{floor['max_ratio']:.3f} x; float32 at full width, "
          f"{WHISPER_F32_LAYERS} + {WHISPER_F32_LAYERS} layers: max |d| "
          f"{f32['max_abs']:.3g} = {f32['max_ratio']:.4f} x ({OLMO_F32_TOL} "
          f"+ {OLMO_F32_TOL}|b|)", flush=True)
    if not (bf16["finite"] and bf16["max_ratio"] <= bf16["limit_ratio"]
            and bf16["rel_rms"] <= bf16["rms_limit"] and _ok(f32)):
        fail(f"E3: {cfg.name}: kernel path and plain path disagree")
    return out


def whisper_bounds(cfg, model, batch: int, prompt: int) -> dict:
    """The least time of a prefill (the operations at the bf16 tensor
    rate: the encoder's projections and MLPs over batch x enc_seq frames,
    its unmasked attention, the cross K/V projections of those frames,
    the decoder's projections and MLPs over batch x prompt tokens, its
    causal self-attention and the cross-attention over the frames, the
    last position's logits; against the bytes: the weights and frames
    read, the cross K/V cache written) and of a decode step at a cache of
    ``prompt`` + 3 tokens (the bytes: the decoder's weights, the
    cross-attention's norm, ``wq`` and ``wo`` -- a decode step reads the
    cached cross K/V, not ``wk`` and ``wv`` -- and the tied embedding,
    the cached cross K/V and the self K/V up to the step's position,
    read)."""
    def nbytes(mod):
        return sum(p.numel() * p.element_size() for p in mod.parameters())

    def products(mod):
        return sum(p.numel() for p in mod.parameters() if p.dim() >= 2)

    a = cfg.attention
    T, hd, L, E = cfg.enc_seq, a.head_dim, cfg.n_layers, cfg.n_enc_layers
    bg, r = batch * a.n_kv_heads, a.n_heads // a.n_kv_heads
    enc_tokens, dec_tokens = batch * T, batch * prompt
    cross_kv = sum(c.attn["wk"].numel() + c.attn["wv"].numel()
                   for c in model.cross)
    cross_qo = sum(c.attn["wq"].numel() + c.attn["wo"].numel()
                   for c in model.cross)
    parts = dict(
        encoder_products=2 * enc_tokens * products(model.enc_blocks),
        encoder_attention=E * flash_work(bg, r, T, T, hd, 2, False)[1],
        cross_kv_products=2 * enc_tokens * cross_kv,
        decoder_products=2 * dec_tokens * (products(model.blocks) + cross_qo),
        decoder_self_attention=L * flash_work(bg, r, prompt, prompt, hd,
                                              2)[1],
        cross_attention=L * flash_work(bg, r, prompt, T, hd, 2, False)[1],
        logits=2 * batch * cfg.d_model * cfg.vocab)
    flops = sum(parts.values())
    cross_cache = 2 * L * bg * T * hd * 2
    moved = nbytes(model) + enc_tokens * cfg.d_model * 2 + cross_cache
    t_ops = flops / BF16_TC_OPS_PER_S * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    prefill = dict(flops=flops, parts=parts, bytes=moved,
                   bound_ops_ms=t_ops, bound_bytes_ms=t_bytes,
                   bound_ms=max(t_ops, t_bytes))
    read = (nbytes(model.blocks) + nbytes(model.embed)
            + nbytes(model.final_norm) + sum(
                nbytes(c.norm) + (c.attn["wq"].numel() + c.attn["wo"].numel())
                * c.attn["wq"].element_size() for c in model.cross))
    kv = 2 * L * bg * (prompt + 3) * hd * 2
    step = read + cross_cache + kv
    decode = dict(weight_bytes=read, cross_kv_bytes=cross_cache, kv_bytes=kv,
                  bytes=step, bound_ms=step / HBM_BYTES_PER_S * 1e3)
    return dict(prefill=prefill, decode=decode)


def flash_ms_by_kind(cfg, model, inputs, max_seq: int) -> dict:
    """Device ms of the flash calls of one warm prefill by kind -- the
    encoder's (unmasked), the decoder's self-attention (causal) and the
    cross-attention (unmasked) -- each call timed by a pair of CUDA events
    around its launch; the calls come in a fixed order (the encoder's
    ``n_enc_layers`` first, then a self and a cross call a decoder layer),
    which their masks confirm."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve.step import make_prefill_step

    pre = make_prefill_step(cfg, max_seq=max_seq)
    calls, launch = [], ops.flash_attention

    def timed(q, k, v, **kw):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = launch(q, k, v, **kw)
        b.record()
        calls.append((kw["causal"], a, b))
        return out

    with mock.patch.object(ops, "flash_attention", timed):
        pre(model, inputs)
    torch.cuda.synchronize()
    kinds = ["encoder"] * cfg.n_enc_layers + ["self", "cross"] * cfg.n_layers
    if [c for c, _, _ in calls] != [k == "self" for k in kinds]:
        fail(f"E4: the prefill's flash calls came as "
             f"{[c for c, _, _ in calls][:6]}... ({len(calls)}), expected "
             f"{cfg.n_enc_layers} unmasked, then causal and unmasked in turn")
    out = {k: 0.0 for k in ("encoder", "self", "cross")}
    for kind, (_, a, b) in zip(kinds, calls):
        out[kind] += a.elapsed_time(b)
    return out


def phase_encdec_profile(cfg, model, prompt, frames, n_tokens: int,
                         bounds: dict) -> dict:
    """E4: ``torch.profiler`` over one warm prefill and 5 decode steps of
    whisper-large-v3, the device time split into the encoder's products,
    the flash kernel, the cross K/V projections, the decoder's products
    (its projections, the cross-attention's q and output projections, the
    MLPs; in decode also the plain attention's products), the rest of the
    encoder, the rest of the decoder and the rest; the idle share against
    each profiled run's own wall; beside the prefill's and a decode step's
    bounds.  The flash kernel runs under no torch operator, so no span
    claims its launches: :func:`flash_ms_by_kind` splits them into the
    encoder's, the cross-attention's and the decoder's self-attention's
    by CUDA events in a prefill of their own."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import model as M
    from repro_torch.serve.step import make_prefill_step, make_serve_step

    spans = {"encoder": M._encoder, "cross kv": M._cross_kv,
             "decoder layer": M._decoder_layer}

    def span(name, real):
        def wrapped(*a, **k):
            with record_function(name):
                return real(*a, **k)
        return wrapped

    gemms = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")

    def split(prof, steps: int) -> dict:
        rows = [r for r in _kernel_rows(prof) if r[0] not in spans]
        total = sum(r[1] for r in rows)
        flash = [r for r in rows
                 if any(n in r[0] for n in FLASH_KERNEL_NAMES)]
        part = dict(flash=sum(r[1] for r in flash), encoder_products=0.0,
                    cross_kv_products=0.0, decoder_products=0.0,
                    encoder_rest=0.0, decoder_rest=0.0, rest=0.0)
        for e, own, up in _operator_kernels(prof, FLASH_KERNEL_NAMES):
            if "cross kv" in up:
                part["cross_kv_products"] += own
            elif "encoder" in up:
                part["encoder_products" if e.name in gemms
                     else "encoder_rest"] += own
            elif "decoder layer" in up:
                part["decoder_products" if e.name in gemms
                     else "decoder_rest"] += own
            else:
                part["rest"] += own
        ms = dict(device=total, **part)
        # the kernel rows' total against the parts: what the profiler
        # filed under no operator, or under two
        ms["unattributed"] = total - sum(part.values())
        ms = {k: v / 1e3 / steps for k, v in ms.items()}
        ms["flash_launches"] = sum(r[2] for r in flash) // steps
        return ms

    inputs = {"tokens": prompt, "frames": frames}
    max_seq = prompt.shape[1] + n_tokens
    pre = make_prefill_step(cfg, max_seq=max_seq)
    srv = make_serve_step(cfg)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {}
    patches = [mock.patch.object(M, fn.__name__, span(name, fn))
               for name, fn in spans.items()]
    for p in patches:
        p.start()
    try:
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            logits, cache = pre(model, inputs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out["prefill"] = dict(split(prof, 1), wall_ms=wall * 1e3,
                              bound_ms=bounds["prefill"]["bound_ms"])
        tok = logits[:, -1].argmax(-1)[:, None]
        steps = 5
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                logits, cache = srv(model, cache, {"tokens": tok})
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / steps
        out["decode"] = dict(split(prof, steps), wall_ms=wall * 1e3,
                             bound_ms=bounds["decode"]["bound_ms"])
    finally:
        for p in patches:
            p.stop()
    del cache
    out["prefill"]["flash_by_kind_events"] = flash_ms_by_kind(
        cfg, model, inputs, max_seq)
    for part in ("prefill", "decode"):
        r = out[part]
        if r["device"] <= 0:
            r["note"] = "the profiler recorded no device time: not measured"
        else:
            r["idle_share"] = 1.0 - r["device"] / r["wall_ms"]
        unit = "ms" if part == "prefill" else "ms a step"
        kinds = r.get("flash_by_kind_events")
        by_kind = "" if kinds is None else (
            f" (by CUDA events in a prefill of their own: encoder "
            f"{kinds['encoder']:.3f}, cross {kinds['cross']:.3f}, decoder "
            f"self {kinds['self']:.3f})")
        print(f"[E4] {cfg.name} {part} profile ({unit}): device "
              f"{r['device']:.3f} of {r['wall_ms']:.3f} wall, idle "
              f"{r.get('idle_share', float('nan')):.1%}; encoder products "
              f"{r['encoder_products']:.3f}, flash {r['flash']:.3f} "
              f"({r['flash_launches']} launches){by_kind}, cross K/V "
              f"projections {r['cross_kv_products']:.3f}, decoder products "
              f"{r['decoder_products']:.3f}, rest of the encoder "
              f"{r['encoder_rest']:.3f}, rest of the decoder "
              f"{r['decoder_rest']:.3f}, rest {r['rest']:.3f} (kernel rows "
              f"no operator accounts for {r['unattributed']:.3f}); bound "
              f"{r['bound_ms']:.3f}", flush=True)
    return out


def whisper_serve() -> dict:
    """E3 (main path) and E4: whisper-large-v3 at full width and depth
    (32 encoder and 32 decoder layers), drawn on the card by a CUDA
    generator, bf16, the frames (8, 1500, 1280) from seed 2 as
    ``launch.serve`` draws them: ``greedy_generate`` of 32 tokens after a
    128-token decoder prompt, batch 8, with the flash counts at 0 just
    before and read just after -- exactly 96 launches in the prefill (32
    encoder, 32 decoder self, 32 cross), all ``wgmma``, none in decode.
    Then the timed prefill and decode, the plain path's prefill, the
    logits and each flash call against the plain path, the profile and the
    bounds.  The model is freed after."""
    import torch

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.serve import audio_frames

    _require_free_card("E3")
    cfg, model, prompt = dense_setup("E3", WHISPER, WHISPER_PROMPT)
    frames = audio_frames(cfg, prompt.shape[0]).cuda()
    per_prefill = cfg.n_enc_layers + 2 * cfg.n_layers
    FA.LAUNCHES = 0                 # this serving main path starts here
    _zero(FA.LAUNCHES_BY_ROUTE)
    run = phase_serve(cfg, model, prompt, OLMO_TOKENS, frames)
    launches = FA.LAUNCHES          # ... and ends here
    by_route = dict(FA.LAUNCHES_BY_ROUTE)
    print(f"[E3] {WHISPER} serving main path (greedy_generate, one prefill of "
          f"{cfg.n_enc_layers} encoder and {cfg.n_layers} decoder layers over "
          f"{tuple(frames.shape)} frames, {OLMO_TOKENS - 1} decode steps): "
          f"{launches} flash_attention launches, by route {by_route}",
          flush=True)
    if launches != per_prefill or by_route != {"wgmma": per_prefill,
                                               "simt": 0}:
        fail(f"E3: {WHISPER}'s serving main path launched {by_route}, "
             f"expected {per_prefill} wgmma flash launches (prefill only)")
    out = dict(launches=launches, launches_by_route=by_route)
    out["serve"] = phase_serve_measure(
        "E4", cfg, model, prompt, run, OLMO_TOKENS,
        "_attention_core + plain cross-attention", frames)
    torch.cuda.empty_cache()
    out["vs_plain"] = phase_encdec_vs_plain(cfg, model, prompt, frames, run)
    bounds = whisper_bounds(cfg, model, prompt.shape[0], prompt.shape[1])
    out["bounds"] = bounds
    out["profile"] = phase_encdec_profile(cfg, model, prompt, frames,
                                          OLMO_TOKENS, bounds)
    pre_s = min(out["serve"]["prefill_s"])
    step_ms = 1e3 * prompt.shape[0] / out["serve"]["decode_tok_s"]
    print(f"[E4] {WHISPER} on {nvidia_smi()}: prefill {pre_s:.4f} s (best "
          f"warm; plain path {min(out['serve']['plain_prefill_s']):.4f} s) "
          f"against its bound {bounds['prefill']['bound_ms'] / 1e3:.4f} s "
          f"({bounds['prefill']['flops'] / 1e12:.2f} TFLOP at 989 TFLOP/s: "
          f"{ {k: round(v / 1e12, 3) for k, v in bounds['prefill']['parts'].items()} }"
          f"); decode {out['serve']['decode_tok_s']:.1f} tokens/s = "
          f"{step_ms:.2f} ms a step against its bound "
          f"{bounds['decode']['bound_ms']:.2f} ms "
          f"({bounds['decode']['bytes'] / 1e9:.2f} GB at 3.35 TB/s: weights "
          f"{bounds['decode']['weight_bytes'] / 1e9:.2f}, cross K/V "
          f"{bounds['decode']['cross_kv_bytes'] / 1e9:.2f}, self K/V "
          f"{bounds['decode']['kv_bytes'] / 1e9:.2f}); peak "
          f"{run['mem'] / 2**30:.2f} GiB", flush=True)
    del model, run, frames
    torch.cuda.empty_cache()
    REPORT[f"{WHISPER}_serving"] = out
    return out


def phase_encdec_train() -> dict:
    """E5 (main path): whisper-large-v3 at full width cut to
    WHISPER_TRAIN_LAYERS encoder and decoder layers, drawn on the card
    (bf16, remat 'dots', ``_attention_core`` and the plain
    cross-attention), WHISPER_TRAIN_STEPS steps of ``make_train_step`` on
    SyntheticLM tokens TRAIN_BATCH x WHISPER_TRAIN_SEQ with seeded frames
    (TRAIN_BATCH, 1500, 1280) in TRAIN_MICRO microbatches at AdamW 1e-4:
    finite losses; step seconds, decoder tokens/s, frames/s, peak memory.
    Then compress_grads three times on the trained model's gradients, the
    error state carried: one quantize and two dequantize launches a leaf a
    call, |err| within EF_SLACK."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.serve import audio_frames
    from repro_torch.launch.train import training_config
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.schedule import constant
    from repro_torch.train.step import (_to_device, init_train_state,
                                        make_train_step)

    _require_free_card("E5")
    cfg = training_config(get_config(WHISPER)).replace(
        n_layers=WHISPER_TRAIN_LAYERS, n_enc_layers=WHISPER_TRAIN_LAYERS,
        remat="dots")
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                             cfg, "cuda")
    n_params = sum(p.numel() for p in state.params.parameters())
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=WHISPER_TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=0))

    def batch_at(i):
        return dict(data.batch_at(i), frames=audio_frames(
            cfg, TRAIN_BATCH, seed=100 + i).cuda())

    step = make_train_step(cfg, AdamWConfig(lr=DENSE_LR), constant(1.0),
                           n_microbatches=TRAIN_MICRO)
    secs, losses = [], []
    for i in range(WHISPER_TRAIN_STEPS):
        batch = batch_at(i)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        secs.append(time.monotonic() - t0)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    warm = min(secs[1:])
    tok_s = TRAIN_BATCH * WHISPER_TRAIN_SEQ / warm
    frames_s = TRAIN_BATCH * cfg.enc_seq / warm
    print(f"[E5] {WHISPER} at full width, {cfg.n_enc_layers} + "
          f"{cfg.n_layers} layers: {n_params:,} parameters drawn on the "
          f"card; {WHISPER_TRAIN_STEPS} steps of {TRAIN_BATCH} x "
          f"{WHISPER_TRAIN_SEQ} decoder tokens over {TRAIN_BATCH} x "
          f"{cfg.enc_seq} frames in {TRAIN_MICRO} microbatches (bf16, remat "
          f"dots, AdamW {DENSE_LR}): losses {[round(v, 4) for v in losses]}; "
          f"step {', '.join(f'{s:.4f}' for s in secs)} s, warm {warm:.4f} s "
          f"= {tok_s:,.0f} decoder tokens/s, {frames_s:,.0f} frames/s, peak "
          f"{peak / 2**30:.2f} GiB", flush=True)
    if not all(math.isfinite(v) for v in losses):
        fail(f"E5: encdec training losses {losses}")
    out = dict(compress_calls(state.params, cfg, [
        _to_device(batch_at(WHISPER_TRAIN_STEPS + i), "cuda")
        for i in range(3)]), n_params=n_params,
        layers=(cfg.n_enc_layers, cfg.n_layers), microbatches=TRAIN_MICRO,
        step_s=secs, warm_step_s=warm, tokens_per_s=tok_s,
        frames_per_s=frames_s, peak_bytes=peak, losses=losses)
    print(f"[E5] compress_grads x3 over {out['n_leaves']} leaves: launches "
          f"per call {out['compress_launches']}, "
          f"{', '.join(f'{t:.3f}' for t in out['compress_seconds'])} s, "
          f"error feedback max |err| / (scale/2) "
          f"{out['error_feedback_max_ratio']:.7f} (limit {EF_SLACK})",
          flush=True)
    _check_compress("E5", out)
    del state, step
    return out


def encdec_phases() -> dict:
    """E1-E5: the encdec SMOKE checks; whisper's kernel shapes against the
    plain version and timed (the first two also in A1 in the whole
    script); whisper-large-v3 served whole (the flash counts at 0 just
    before its serving main path and read just after, inside
    :func:`whisper_serve`); the 8 + 8-layer whisper trained (the
    ckpt_quant counts at 0 just before and read just after) and both quant
    kernels timed at its embedding leaf."""
    import torch

    from repro_torch.kernels import (ckpt_quant, flash_attention, sim_step,
                                     ssd_scan)

    card = phase_encdec_card_vs_cpu()
    _lap("E1")
    flash = phase_encdec_flash()
    _lap("E2")
    serve = whisper_serve()
    _lap("E3-E4")
    for k in ckpt_quant.LAUNCHES:   # the encdec training main path starts here
        ckpt_quant.LAUNCHES[k] = 0
    sim_step.LAUNCHES = ssd_scan.LAUNCHES = flash_attention.LAUNCHES = 0
    train = phase_encdec_train()
    launches = dict(ckpt_quant.LAUNCHES)   # ... and ends here
    other = dict(sim_step=sim_step.LAUNCHES, ssd_scan=ssd_scan.LAUNCHES,
                 flash_attention=flash_attention.LAUNCHES)
    REPORT["encdec_train_main_path_launches"] = dict(launches, **other)
    print(f"[E5] encdec training main path: launches {launches} (3 "
          f"compress_grads calls over {train['n_leaves']} leaves), {other} "
          f"(training runs _attention_core and the plain cross-attention)",
          flush=True)
    if min(launches.values()) < 1 or any(other.values()):
        fail("E5: the encdec training main path launched no ckpt_quant "
             "kernel, or launched another kernel")
    quant_vs_plain = quant_vs_plain_all_leaves("E5", train,
                                               WHISPER_EMBED_LEAF)
    torch.cuda.empty_cache()
    quant = phase_quant_measure(WHISPER_EMBED_LEAF, "E5",
                                "whisper-large-v3's embedding leaf")
    _lap("E5")
    REPORT["encdec_train"] = train
    return dict(card_vs_cpu=card, flash=flash, serve=serve, train=train,
                train_launches=launches, quant_vs_plain=quant_vs_plain,
                quant=quant)


# --------------------------------------------------------------------------- #
# The workflow digital twin (sim/workflow.py, exec/) and the policy service
# --------------------------------------------------------------------------- #

def _fp64_ops_per_step(key: str, time_varying: bool) -> int:
    """FP64 operations of one cell-step of variant ``key`` (store, het,
    shock, pm) without the draws, a lower bound as counted above."""
    store, het, shock = key[0] == "1", key[1] == "1", key[2] == "1"
    ops = OPS_PER_POOLED_CELL_STEP
    if time_varying:
        ops += TIME_VARYING_MU_OPS
    if store:
        ops += REPLICA_DRAW_OPS
        ops += REPLICA_HET_OPS if het else 0
        ops += REPLICA_SHOCK_OPS if shock else 0
        ops += REPLICA_HET_SHOCK_OPS if het and shock else 0
    return ops


def twin_dag(form: str):
    """W1's DAGs: ``tests/test_exec.py``'s shocked 3-stage DAG, homogeneous
    (variant 0010), with a ``StoreSpec(R=3)`` (1010), and two-class with
    the store (1110)."""
    from repro_torch.p2p import StoreSpec
    from repro_torch.sim import (PolicyConfig, ShockSpec, Stage, WorkflowSpec,
                                 peer_class_mix, scenario)

    spec = WorkflowSpec(stages=(
        Stage(name="prep", work=1800.0, k=8),
        Stage(name="train", work=2400.0, k=8, deps=("prep",), handoff=120.0),
        Stage(name="eval", work=900.0, k=8, deps=("train",), handoff=60.0)))
    scen = scenario("constant", mtbf=5400.0).with_shock(
        ShockSpec(rate=1 / 3600.0, kill_frac=0.3))
    kw = dict(policy=PolicyConfig(kind="adaptive", prior_mu=1 / 5400.0,
                                  prior_v=20.0), V=20.0, T_d=50.0)
    if form in ("p2p", "two_class"):
        kw["store"] = StoreSpec(R=3)
    if form == "two_class":
        kw["mix"] = peer_class_mix("fast_core_volunteer_tail")
    return spec, scen, kw


def example_runs():
    """W2's four runs of ``examples/workflow_dag.py``'s DAG (diurnal, MTBF
    7,200 s): the adaptive and the fixed 1 h policy, homogeneous and with
    ``--mix fast_core_volunteer_tail --p2p --replicas 3`` (200 MB images)."""
    from repro_torch.launch import workflow_dag as WD
    from repro_torch.p2p import StoreSpec, TransferModel
    from repro_torch.sim import PolicyConfig, peer_class_mix, scenario

    scen = scenario("diurnal", mtbf=7200.0)
    adaptive = PolicyConfig(kind="adaptive", prior_mu=1.0 / 7200.0,
                            prior_v=WD.V)
    fixed = PolicyConfig(kind="fixed", fixed_T=3600.0)
    p2p = dict(mix=peer_class_mix("fast_core_volunteer_tail"),
               store=StoreSpec(R=3, transfer=TransferModel(img_bytes=200e6)))
    return WD.build_workflow(), scen, [
        ("adaptive", adaptive, {}), ("fixed", fixed, {}),
        ("adaptive_mix_p2p", adaptive, p2p), ("fixed_mix_p2p", fixed, p2p)]


def _workflow_diff(a, b) -> tuple:
    """(count/completed fields that differ, the largest relative float
    difference) between two WorkflowResults."""
    bad, rel = [], 0.0
    if not np.array_equal(a.completed, b.completed):
        bad.append("completed")
    for sname in a.stages:
        sa, sb = a.stages[sname], b.stages[sname]
        cb, cr = _results_close(sa.sim, sb.sim)
        bad += [f"{sname}.{f}" for f in cb]
        rel = max(rel, cr)
        for f in ("ready", "start", "finish", "handoff_time", "handoff_waste",
                  "server_bytes"):
            x, y = getattr(sa, f), getattr(sb, f)
            r = np.abs(x - y) / np.maximum(np.abs(y), 1e-300)
            rel = max(rel, float(np.max(np.where(x == y, 0.0, r))))
    return bad, rel


def phase_workflow_across_devices() -> dict:
    """W1: the shocked 3-stage DAGs at 8 seeds, card against CPU with
    parity draws (the kernel's pre-generated route on the card, the plain
    step on the CPU): counts and ``completed`` exact, floats within 1e-9
    relative; the sim_step launches by variant."""
    from repro_torch.kernels import sim_step
    from repro_torch.sim import workflow
    from repro_torch.sim.workflow import simulate_workflow, waste_band

    out, batches = {}, {}
    for form, want in (("homogeneous", "0010"), ("p2p", "1010"),
                       ("two_class", "1110")):
        spec, scen, kw = twin_dag(form)
        before = dict(sim_step.LAUNCHES_BY_VARIANT)
        pre = sim_step.LAUNCHES_BY_ROUTE["pregenerated"]
        with _Captured(workflow) as cap:
            t0 = time.monotonic()
            a = simulate_workflow(spec, scen, seeds=range(TWIN_SEEDS),
                                  device="cuda", draws="numpy", **kw)
            card_s = time.monotonic() - t0
        launched = {k: v - before.get(k, 0)
                    for k, v in sim_step.LAUNCHES_BY_VARIANT.items()
                    if v - before.get(k, 0)}
        t0 = time.monotonic()
        b = simulate_workflow(spec, scen, seeds=range(TWIN_SEEDS),
                              device="cpu", draws="numpy", **kw)
        cpu_s = time.monotonic() - t0
        bad, rel = _workflow_diff(a, b)
        out[form] = dict(count_mismatch=bad, max_rel_err=rel,
                         launches_by_variant=launched,
                         pregenerated=sim_step.LAUNCHES_BY_ROUTE[
                             "pregenerated"] - pre,
                         card_s=card_s, cpu_s=cpu_s,
                         completed=bool(a.all_completed),
                         waste_band=waste_band(a),
                         mean_makespan=a.mean_makespan)
        batches[want] = max((c for k, c in cap.batches() if k == want),
                            key=lambda c: c[0].work, default=[])
        print(f"[W1] {form} shocked 3-stage DAG, {TWIN_SEEDS} seeds, card "
              f"vs CPU with parity draws: count mismatches {bad}, max rel "
              f"err {rel:.3g}; sim_step launches by variant (store, het, "
              f"shock, pm) {launched}; card {card_s:.2f} s, CPU {cpu_s:.2f} "
              f"s; makespan {a.mean_makespan / 3600:.3f} h, waste band "
              f"{tuple(round(x, 1) for x in out[form]['waste_band'])} s",
              flush=True)
        if bad or rel > 1e-9:
            fail(f"W1: {form} DAG, card and CPU disagree")
        if set(launched) != {want} or out[form]["pregenerated"] != sum(
                launched.values()):
            fail(f"W1: {form} DAG launched {launched}, expected only {want} "
                 f"on the pre-generated route")
        if not a.all_completed:
            fail(f"W1: {form} DAG did not complete")
    REPORT["workflow_across_devices"] = out
    return batches


def _w2_cpu_reference() -> dict:
    """W2's CPU run (numpy draws, 64 seeds) of each example run: per-seed
    makespan and predicted waste.  Runs in a worker process of its own."""
    import torch

    from repro_torch.sim.workflow import predicted_waste, simulate_workflow

    torch.set_num_threads(2)
    spec, scen, runs = example_runs()
    out = {}
    for name, pol, kw in runs:
        t0 = time.monotonic()
        r = simulate_workflow(spec, scen, policy=pol,
                              seeds=range(WF_CPU_SEEDS), V=20.0, T_d=50.0,
                              device="cpu", draws="numpy", **kw)
        out[name] = dict(makespan=r.makespan.tolist(),
                         waste=predicted_waste(r).tolist(),
                         completed=float(r.completed.mean()),
                         seconds=time.monotonic() - t0)
    return out


def start_w2_cpu_reference():
    """Start ``_w2_cpu_reference`` in a worker process of its own (spawned,
    so it never touches the card); the worker is terminated at exit."""
    import atexit
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(1)
    atexit.register(pool.terminate)
    return pool, pool.apply_async(_w2_cpu_reference)


def _three_sigma(a, b) -> tuple:
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    tol = 3.0 * float(np.sqrt(np.var(a, ddof=1) / a.size
                              + np.var(b, ddof=1) / b.size))
    return abs(float(a.mean()) - float(b.mean())), tol


def _share_three_sigma(p1: float, n1: int, p2: float, n2: int) -> tuple:
    """Gap between two completed shares and 3 sigma of it, the shares
    pooled (a sample that completed every seed has no spread of its own)."""
    p = (p1 * n1 + p2 * n2) / (n1 + n2)
    return abs(p1 - p2), 3.0 * float(np.sqrt(p * (1 - p) * (1 / n1 + 1 / n2)))


def phase_workflow_example() -> tuple:
    """W2, main path: the example DAG at full shape, 4,096 seeds a stage on
    the Philox route, four runs; mean makespan, waste band, server bytes,
    wall, cells/s; a profiled run's device idle share (its device time
    over its own wall).  Returns the runs (held against the CPU run by
    ``phase_workflow_example_vs_cpu``) and each variant's batch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.sim import workflow
    from repro_torch.sim.workflow import (predicted_waste, simulate_workflow,
                                          waste_band)

    spec, scen, runs = example_runs()
    out, batches = {}, {}
    for name, pol, kw in runs:
        with _Captured(workflow) as cap:
            t0 = time.monotonic()
            res = simulate_workflow(spec, scen, policy=pol,
                                    seeds=range(WF_SEEDS), V=20.0, T_d=50.0,
                                    device="cuda", **kw)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        captured = cap.batches()
        if name.startswith("adaptive"):   # each variant's longest stage
            for key, cells in captured:
                if cells[0].work > batches.get(key, [cells[0]])[0].work \
                        or key not in batches:
                    batches[key] = cells
        band = waste_band(res)
        n_cells = WF_SEEDS * len(spec)
        out[name] = dict(
            seeds=WF_SEEDS, wall_s=wall, cells_per_s=n_cells / wall,
            mean_makespan_h=res.mean_makespan / 3600.0,
            completed=float(res.completed.mean()), waste_band=band,
            mean_server_bytes=float(res.server_bytes.mean()),
            steps={s: r.sim.n_steps for s, r in res.stages.items()},
            variants=sorted({k for k, _ in captured}),
            makespan=res.makespan, waste=predicted_waste(res))
        print(f"[W2] example DAG, {name}: {WF_SEEDS} seeds a stage in "
              f"{wall:.2f} s ({n_cells / wall:.0f} cells/s), makespan "
              f"{res.mean_makespan / 3600:.3f} h, completed "
              f"{out[name]['completed']:.4f}, waste band ({band[0]:.0f}, "
              f"{band[1]:.0f}, {band[2]:.0f}) s, server bytes "
              f"{out[name]['mean_server_bytes']:.4g}, steps "
              f"{out[name]['steps']}, variants {out[name]['variants']}",
              flush=True)
    # The device's idle share over one more (warm) run of the mixed-fleet
    # DAG: its device time over its own wall, under the profiler.
    name, pol, kw = runs[2]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        simulate_workflow(spec, scen, policy=pol, seeds=range(WF_SEEDS),
                          V=20.0, T_d=50.0, device="cuda", **kw)
        torch.cuda.synchronize()
        warm = time.monotonic() - t0
    rows = _kernel_rows(prof)
    dev_us = sum(r[1] for r in rows)
    kern_us = sum(r[1] for r in rows if "sim_step" in r[0])
    prof_out = dict(run=name, profiled_wall_s=warm, device_ms=dev_us / 1e3,
                    sim_step_ms=kern_us / 1e3,
                    kernels=sum(r[2] for r in rows), top=rows[:6],
                    idle_share=1.0 - dev_us / 1e6 / warm if dev_us else None)
    print(f"[W2] profile of the {name} run: {warm:.2f} s, device time "
          f"{dev_us / 1e3:.2f} ms in {prof_out['kernels']} kernels "
          f"(sim_step {kern_us / 1e3:.2f} ms), idle share "
          f"{prof_out['idle_share']}", flush=True)
    REPORT["workflow_example"] = dict(runs=out, profile=prof_out)
    return out, batches


def phase_workflow_example_vs_cpu(out: dict, cpu_ref) -> None:
    """W2's check: each run's means of makespan and predicted waste within
    3 sigma of the CPU run with numpy draws at 64 seeds, and its completed
    share within 3 sigma of the CPU run's (``cpu_ref``: the worker pool
    and the pending result of ``start_w2_cpu_reference``)."""
    pool, pending = cpu_ref
    t0 = time.monotonic()
    ref = pending.get(timeout=1200)
    waited = time.monotonic() - t0
    pool.close()
    pool.join()
    print(f"[W2] waited {waited:.1f} s for the CPU run", flush=True)
    checks = {}
    for name, r in out.items():
        c = ref[name]
        dm, tm = _three_sigma(r.pop("makespan"), c["makespan"])
        dw, tw = _three_sigma(r.pop("waste"), c["waste"])
        dc, tc = _share_three_sigma(r["completed"], WF_SEEDS, c["completed"],
                                    WF_CPU_SEEDS)
        checks[name] = dict(makespan_gap=dm, makespan_tol=tm, waste_gap=dw,
                            waste_tol=tw, completed_gap=dc, completed_tol=tc,
                            cpu_completed=c["completed"],
                            cpu_seconds=c["seconds"])
        print(f"[W2] {name} vs the CPU run ({WF_CPU_SEEDS} seeds, numpy "
              f"draws, {c['seconds']:.1f} s): makespan gap {dm:.1f} s (3 "
              f"sigma {tm:.1f}), waste gap {dw:.1f} s (3 sigma {tw:.1f}), "
              f"completed {r['completed']:.4f} vs {c['completed']:.4f} (gap "
              f"{dc:.4f}, 3 sigma {tc:.4f})", flush=True)
    REPORT["workflow_example"].update(vs_cpu=checks, cpu_wait_s=waited)
    for name, c in checks.items():
        if not (c["makespan_gap"] <= c["makespan_tol"]
                and c["waste_gap"] <= c["waste_tol"]
                and c["completed_gap"] <= c["completed_tol"]):
            fail(f"W2: {name}: the card's means or completed share are not "
                 f"within 3 sigma of the CPU run's")
    for name in ("adaptive", "adaptive_mix_p2p"):
        if out[name]["completed"] < 1.0:
            fail(f"W2: {name}: a workflow did not complete")


def phase_twin_execute() -> dict:
    """W3, main path: the example's ``--execute`` on the card --
    ``MixTask(dim=64)`` payloads on the card, 4 schedule seeds (executed at
    once, in threads), both forms of the DAG; the measured mean waste
    inside the sim's 3-sigma band."""
    from repro_torch.launch import workflow_dag as WD

    spec, scen, runs = example_runs()
    out = {}
    for form, (name, pol, kw) in (("homogeneous", runs[0]),
                                  ("mix_p2p", runs[2])):
        t0 = time.monotonic()
        got = WD.execute_for_real(spec, scen, pol, sim_seeds=8,
                                  exec_seeds=EXEC_SEEDS, device="cuda",
                                  dim=64, **kw)
        sec = time.monotonic() - t0
        reps = got["reports"]
        real = sum(r.real_seconds for r in reps)
        steps = sum(r.executed_supersteps for r in reps)
        out[form] = dict(
            band=got["band"], measured=got["measured"],
            inside=got["inside"], seconds=sec,
            supersteps=steps, supersteps_per_s=steps / real,
            supersteps_per_phase_s=steps / sec,
            checkpoints=sum(r.n_checkpoints for r in reps),
            write_s=sum(r.write_real_s for r in reps),
            restore_read_s=sum(r.restore_real_s for r in reps),
            restores=sum(r.n_restores for r in reps),
            failures=sum(s.n_failures for r in reps
                         for s in r.stages.values()),
            completed=all(r.completed for r in reps),
            server_bytes=[r.server_bytes for r in reps])
        o = out[form]
        print(f"[W3] digital twin on the card, {form}: measured mean waste "
              f"{np.mean(o['measured']):.0f} s, band ({o['band'][0]:.0f}, "
              f"{o['band'][1]:.0f}, {o['band'][2]:.0f}) s: "
              f"{'INSIDE' if o['inside'] else 'OUTSIDE'}; {steps} supersteps "
              f"at {o['supersteps_per_s']:.0f} a second a run "
              f"({EXEC_SEEDS} runs at once: {o['supersteps_per_phase_s']:.0f} "
              f"a second in all), {o['checkpoints']} "
              f"checkpoints written in {o['write_s']:.2f} s, {o['restores']} "
              f"restores after {o['failures']} failures (images read in "
              f"{o['restore_read_s']:.2f} s); {sec:.1f} s",
              flush=True)
        if not (o["inside"] and o["completed"]):
            fail(f"W3: {form}: the executor's waste is outside the sim's "
                 f"band, or a run did not complete")
    REPORT["twin_execute"] = out
    return out


def phase_power_iter() -> dict:
    """W4: one schedule seed of the shocked 3-stage DAG with
    ``PowerIterTask(dim=2048)`` on the card (a 16 MiB float32 matrix in
    every checkpoint): killed mid-stage and resumed, the final payload
    bitwise equal to an uninterrupted run's."""
    import tempfile

    import torch

    from repro_torch.exec import (ExecutorConfig, ExecutorKilled, KillSpec,
                                  PowerIterTask, WorkflowExecutor)
    from repro_torch.sim.workflow import export_failure_schedule

    spec, scen, _ = twin_dag("homogeneous")
    sched = export_failure_schedule(spec, scen, seed=0, horizon_factor=60.0)
    tasks = {s.name: PowerIterTask(dim=POWER_DIM, seed=i, device="cuda")
             for i, s in enumerate(spec.stages)}
    like = tasks["eval"].init({"train": tasks["train"].init({})})
    knobs = dict(seconds_per_superstep=15.0, V=20.0, T_d=50.0,
                 prior_mu=1 / 5400.0)
    base = ROOT / ".smoke_ckpt"
    base.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="w4_", dir=str(base)) as root:
        cfg = ExecutorConfig(root=f"{root}/killed", **knobs)
        t0 = time.monotonic()
        try:
            WorkflowExecutor(spec, tasks, sched, cfg).run(
                kill=KillSpec("train", after_supersteps=80))
            fail("W4: the kill did not fire")
        except ExecutorKilled as e:
            killed_at = e.superstep
        resumed = WorkflowExecutor(spec, tasks, sched, cfg).run(resume=True)
        t1 = time.monotonic()
        ref_cfg = ExecutorConfig(root=f"{root}/whole", **knobs)
        whole = WorkflowExecutor(spec, tasks, sched, ref_cfg)
        rep = whole.run()
        t2 = time.monotonic()
        a = WorkflowExecutor(spec, tasks, sched, cfg).output("eval", like)
        b = whole.output("eval", like)
    same = all(torch.equal(a[k], b[k]) for k in a)
    mat = b["mat"].double()
    lam_max = float(torch.linalg.eigvalsh(mat)[-1])
    eig = float(b["eig"])
    out = dict(dim=POWER_DIM, killed_at=killed_at,
               resumed_from=resumed.stages["train"].start_superstep,
               bitwise=same, eig=eig, lam_max=lam_max,
               checkpoints=rep.n_checkpoints, write_s=rep.write_real_s,
               restores=rep.n_restores, supersteps=rep.executed_supersteps,
               supersteps_per_s=rep.steps_per_second,
               kill_resume_s=t1 - t0, whole_s=t2 - t1,
               device=str(b["mat"].device), waste=rep.total_waste)
    REPORT["power_iter"] = out
    print(f"[W4] PowerIterTask(dim={POWER_DIM}) on the card, 3-stage DAG, "
          f"schedule seed 0: killed in train at superstep {killed_at}, "
          f"resumed from {out['resumed_from']}, final payload bitwise equal "
          f"to an uninterrupted run: {same}; eig {eig:.6f} (largest "
          f"eigenvalue {lam_max:.6f}); uninterrupted run {rep.n_checkpoints} "
          f"checkpoints written in {rep.write_real_s:.2f} s, "
          f"{rep.n_restores} restores, {rep.executed_supersteps} supersteps "
          f"at {rep.steps_per_second:.0f} a second; kill + resume "
          f"{t1 - t0:.1f} s, whole {t2 - t1:.1f} s", flush=True)
    if not same or out["device"] != "cuda:0":
        fail("W4: the resumed payload differs from the uninterrupted run's")
    if not (0.0 < eig <= lam_max * (1 + 1e-4)):
        fail(f"W4: eig {eig} is not a Rayleigh quotient of the matrix")
    return out


def phase_workflow_vs_plain(batches: dict) -> dict:
    """W5: each sim_step variant the workflow path ran, at its batch: one
    256-step chunk from the batch's initial state through both routes --
    the Philox draws made in the kernel, and the same draws pre-generated
    (``PhiloxDraws.at``) -- against the plain step fed those draws, every
    ``_State`` field and the steps per warp equal; the chunk timed on both
    routes (CUDA events) beside the plain step's (one run, CUDA events)
    and the bound."""
    import torch

    from repro_torch.kernels import sim_step
    from repro_torch.sim import engine
    from repro_torch.sim.draws import PhiloxDraws

    out = {}
    for key in WORKFLOW_VARIANTS:
        cells = batches.get(key)
        if not cells:
            fail(f"the workflow path ran no batch of variant {key}")
        p_np = engine._pack(cells)
        flags = engine.batch_flags(cells, p_np)
        if _flag_key(flags) != key:
            fail(f"variant {key}: batch flags {flags}")
        p = engine.from_reference(p_np, device="cuda")
        s0 = engine._init_state(p, 1)
        kw = dict(macro_threshold=0.05, **flags)
        n = engine.DEFAULT_CHUNK
        src = PhiloxDraws([c.seed for c in cells], flags["any_pm"], "cuda")
        d = src.at(0, n)
        cell_steps = torch.zeros(len(cells), dtype=torch.int64,
                                 device="cuda")
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        ref, taken_ref = sim_step.fused_chunk_ref(s0, p, d,
                                                  cell_steps=cell_steps, **kw)
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1)
        diffs, worst = {}, 0.0
        for route, (st, taken) in (
                ("philox", _philox_chunk(s0, p, src, n, **kw)),
                ("pregenerated", sim_step.fused_chunk(s0, p, d, **kw))):
            torch.cuda.synchronize()
            diff, w = _state_diff(st, ref)
            worst = max(worst, w)
            diff["steps_taken"] = int((taken != taken_ref).sum())
            diffs[route] = diff
        t = chunk_times(cells)
        active = int(cell_steps.sum())
        varying = any(c.scenario.name != "constant" for c in cells)
        ops = _fp64_ops_per_step(key, varying)
        bound = sweep_bound(p, active, ops, PHILOX_INT_OPS_PER_STEP)
        out[key] = dict(cells=len(cells), k=cells[0].k,
                        work=cells[0].work, scenario=cells[0].scenario.name,
                        vs_plain_mismatches=diffs, max_abs_err=worst,
                        ms=sum(t["philox_ms"]) / 2, philox_ms=t["philox_ms"],
                        pregenerated_ms=t["pregenerated_ms"],
                        plain_ms=plain_ms, active_cell_steps=active,
                        finished=int(ref.finished.sum()),
                        fp64_ops_per_cell_step=ops + BOX_MULLER_OPS_PER_STEP,
                        steps_per_warp_max=t["steps_per_warp_max"], **bound)
        bad = {r: {f: v for f, v in dd.items() if v}
               for r, dd in diffs.items()}
        print(f"[W5] workflow variant {key} at its batch ({len(cells)} cells "
              f"of k = {cells[0].k}, {cells[0].scenario.name}, work "
              f"{cells[0].work:.0f} s): one 256-step chunk, kernel vs plain "
              f"step on the card, mismatching fields per route {bad} "
              f"({out[key]['finished']} cells finished in it); in-kernel "
              f"Philox {t['philox_ms'][0]:.4f} / {t['philox_ms'][1]:.4f} ms, "
              f"pre-generated {t['pregenerated_ms']:.4f} ms, plain "
              f"{plain_ms:.1f} ms; bound max({bound['bound_bytes_ms']:.4f} ms "
              f"bytes, {bound['bound_fp64_ms']:.4f} ms FP64, "
              f"{bound['bound_int32_ms']:.4f} ms INT32) = "
              f"{bound['bound_ms']:.4f} ms ({active} active cell-steps x "
              f"{ops + BOX_MULLER_OPS_PER_STEP} FP64)", flush=True)
        if any(any(v.values()) for v in diffs.values()):
            fail(f"variant {key}: kernel and plain step disagree")
    REPORT["workflow_vs_plain"] = out
    return out


def _smoke_flows(svc) -> dict:
    """``launch/serve_policy.py --smoke``'s flows on one service: the
    calibrate report, the 16 query decisions, the 8 session flushes of
    2,048 clients (their DecisionBatches) and each flush's seconds."""
    import torch

    from repro_torch.policy import PolicyRequest

    out = {"calibrate": svc.calibrate(1.0 / 7200.0, n_observations=128,
                                      seed=0)}
    out["query"] = svc.query([
        PolicyRequest(client=f"q{i}", k=float(4 + i),
                      failures=(1800.0 + 60.0 * i, 5400.0),
                      checkpoint_overheads=(15.0,), now=7200.0)
        for i in range(16)])
    clients = [f"s{i}" for i in range(2048)]
    rng = np.random.default_rng(0)
    out["session"], out["seconds"] = [], []
    for rnd in range(8):
        batch = {
            "failures": rng.exponential(3600.0, (len(clients), 2)) + 1e-3,
            "checkpoint_overheads": rng.exponential(20.0, len(clients)),
            "restores": np.where(rng.random(len(clients)) < 0.5,
                                 rng.exponential(50.0, len(clients)), np.nan),
            "now": np.full(len(clients), (rnd + 1) * 1800.0)}
        t0 = time.perf_counter()
        out["session"].append(svc.session_update_arrays(clients, **batch))
        if svc.device.type == "cuda":
            torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
    return out


def phase_policy_across_devices() -> dict:
    """P1: the ``--smoke`` flows (2,048 clients x 8 flushes, a query batch,
    calibrate) on the card and on the CPU, windowed and moment: every
    decision bitwise equal."""
    from repro_torch.serve.policy_service import PolicyService

    out = {}
    for est in ("windowed", "moment"):
        a = _smoke_flows(PolicyService(estimator=est, device="cuda"))
        b = _smoke_flows(PolicyService(estimator=est, device="cpu"))
        bad = 0
        for x, y in zip(a["session"], b["session"]):
            for f in ("interval", "mu", "V", "T_d", "n_failures", "clamped"):
                bad += int((getattr(x, f).view(np.uint8)
                            != getattr(y, f).view(np.uint8)).sum())
        bad += sum(d.to_dict() != e.to_dict()
                   for d, e in zip(a["query"], b["query"]))
        ca, cb = a["calibrate"], b["calibrate"]
        bad += int((ca.mu_hat, ca.interval, ca.interval_oracle)
                   != (cb.mu_hat, cb.interval, cb.interval_oracle))
        out[est] = dict(mismatches=bad, card_flush_s=a["seconds"],
                        cpu_flush_s=b["seconds"])
        print(f"[P1] policy service --smoke flows, {est}, card vs CPU: "
              f"{bad} mismatching decision bytes over 8 x 2,048 session "
              f"decisions, 16 queries and calibrate; flush p50 card "
              f"{np.median(a['seconds']) * 1e3:.2f} ms, CPU "
              f"{np.median(b['seconds']) * 1e3:.2f} ms", flush=True)
        if bad:
            fail(f"P1: {est}: card and CPU decisions differ")
    REPORT["policy_across_devices"] = out
    return out


def _replay(est: str, n: int, rounds: int, key_bits: int,
            device: str) -> dict:
    """``benchmarks/policy_service_bench.py``'s replay of the diurnal,
    boinc-mix stream through ``session_update_arrays``."""
    import torch

    from repro_torch.policy import PolicyRequest
    from repro_torch.serve.policy_service import (PolicyService,
                                                  synthetic_stream)

    tpl = PolicyRequest(**POLICY_TEMPLATE)
    stream = list(synthetic_stream("diurnal", n_clients=n, n_rounds=rounds,
                                   obs_per_round=2, mix="boinc", seed=0))
    svc = PolicyService(estimator=est, max_window=tpl.window,
                        lw_key_bits=key_bits, device=device)
    clients = [f"c{i}" for i in range(n)]
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    lat, out = [], []
    for batch in stream:
        t0 = time.perf_counter()
        out.append(svc.session_update_arrays(clients, template=tpl, **batch))
        lat.append(time.perf_counter() - t0)
    res = dict(clients=n, rounds=rounds, estimator=est, key_bits=key_bits,
               flush_s=lat, p50_ms=float(np.percentile(lat, 50) * 1e3),
               p99_ms=float(np.percentile(lat, 99) * 1e3),
               us_per_decision=float(np.sum(lat)) / (n * rounds) * 1e6,
               mean_interval=float(out[-1].interval.mean()),
               lw_hit_rate=svc.stats()["lw_hit_rate"])
    if device == "cuda":
        res["peak_bytes"] = torch.cuda.max_memory_allocated()
    return dict(res, _svc=svc, _clients=clients, _tpl=tpl, _stream=stream,
                _decisions=out)


def phase_policy_scale() -> dict:
    """P2: the policy service at scale on the card -- 100,000 clients
    windowed (``policy_session_replay``: 6 rounds, key bits 12) and
    1,000,000 moment clients (``policy_moment_1m``: 3 rounds, key bits 10):
    us a decision, flush p50/p99, peak device memory, a profiled flush's
    idle share; the 100k run's decisions bitwise equal to the CPU
    service's;
    then ``python -m repro_torch.launch.serve_policy --smoke --device
    cuda`` as a subprocess, exit 0."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, est, n, rounds, bits, vs_cpu in POLICY_SCALE:
        run = _replay(est, n, rounds, bits, "cuda")
        cpu = _replay(est, n, rounds, bits, "cpu") if vs_cpu else None
        bad = sum(int((getattr(x, f).view(np.uint8)
                       != getattr(y, f).view(np.uint8)).sum())
                  for x, y in zip(run["_decisions"], cpu["_decisions"])
                  for f in ("interval", "mu", "V", "T_d", "n_failures",
                            "clamped")) if cpu else None
        # One more flush (the first round's arrays again) under the
        # profiler: its device time against its own seconds.
        svc, batch = run["_svc"], run["_stream"][0]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            svc.session_update_arrays(run["_clients"], template=run["_tpl"],
                                      **batch)
            torch.cuda.synchronize()
            warm = time.perf_counter() - t0
        rows = _kernel_rows(prof)
        dev_us = sum(r[1] for r in rows)
        res = {k: v for k, v in run.items() if not k.startswith("_")}
        res.update(card_vs_cpu_mismatches=bad, profiled_flush_s=warm,
                   device_ms=dev_us / 1e3, kernels=sum(r[2] for r in rows),
                   idle_share=1.0 - dev_us / 1e6 / warm if dev_us else None,
                   top=rows[:5])
        if cpu:
            res.update(cpu_p50_ms=cpu["p50_ms"], cpu_p99_ms=cpu["p99_ms"],
                       cpu_us_per_decision=cpu["us_per_decision"])
        out[name] = res
        versus = (f"CPU service {cpu['us_per_decision']:.3f} us a decision; "
                  f"card vs CPU {bad} mismatching decision bytes" if cpu
                  else "not run against the CPU service (P1 and the 100k "
                  "run hold that)")
        print(f"[P2] policy service {name} ({est}, {n:,} clients x {rounds} "
              f"flushes, key bits {bits}) on the card: "
              f"{res['us_per_decision']:.3f} us a decision, flush p50 "
              f"{res['p50_ms']:.1f} ms p99 {res['p99_ms']:.1f} ms, peak "
              f"{res['peak_bytes'] / 2**20:.1f} MiB, a flush's device time "
              f"{res['device_ms']:.2f} ms in {res['kernels']} kernels against "
              f"{warm * 1e3:.1f} ms (idle share {res['idle_share']}); "
              f"{versus}", flush=True)
        if bad:
            fail(f"P2: {name}: card and CPU decisions differ")
        del run, cpu, svc
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-m",
                        "repro_torch.launch.serve_policy", "--smoke",
                        "--device", "cuda"], capture_output=True, text=True,
                       env=env, cwd=str(ROOT), timeout=300)
    out["cli"] = dict(rc=r.returncode, seconds=time.monotonic() - t0,
                      stdout=r.stdout[-3000:], stderr=r.stderr[-3000:])
    print(f"[P2] python -m repro_torch.launch.serve_policy --smoke --device "
          f"cuda: exit {r.returncode} in {out['cli']['seconds']:.1f} s",
          flush=True)
    for line in r.stdout.splitlines():
        print(f"    {line[:160]}", flush=True)
    REPORT["policy_scale"] = out
    if r.returncode != 0:
        fail("P2: the serve_policy entry point failed")
    return out


# --------------------------------------------------------------------------- #
# Cell sharding and ZeRO-1 over a device mesh (C1-Z2)
# --------------------------------------------------------------------------- #

SHARD_EXTENTS = (1, 2, 3, 4)   # C1: the fleet grid's data extents (3 pads)
FIG4_SHARDS = 5                # C1: Fig. 4 static's 216 cells (pads to 220)
PERPEER_SHARDS = 3
# C1's per-peer comparison runs one 64-step chunk of G1's batch (the plain
# per-peer step costs ~13 ms a step and shard on the card)
PERPEER_SHARD_STEPS = 64
# C2's depth: phase 4's cells run ~6,600 steps, ~5 ms a step of the plain
# step for the CPU's shard; C2 stops at 512 (the cells still running are
# censored alike on both sides)
CARD_CPU_STEPS = 512
Z1_ARCHS = (OLMO, "olmoe-1b-7b")
Z1_CLIPS = (1e6, 1e-3)         # Z1: a step the norm does not clip, one it does
# Z2: D2's olmo-1b with clipping off, so that the bitwise contract applies
# (Z1 holds a clipped step at SMOKE)
Z2_CLIP = 1e9


def _data_mesh(devices: list):
    from repro_torch.distributed import make_mesh

    return make_mesh((len(devices),), ("data",), devices)


def _result_slice(r, sl):
    """The BatchResult ``r`` restricted to the cells ``sl``."""
    import dataclasses

    return dataclasses.replace(r, **{
        f.name: getattr(r, f.name)[sl] for f in dataclasses.fields(r)
        if f.name != "n_steps"})


def _sharded_run(tag: str, cells, want, n: int, **kw) -> dict:
    """``run_cells`` of ``cells`` over ``n`` x cuda:0 against the unsharded
    result ``want``: every field and n_steps bitwise; the seconds and the
    sim_step launches of the sharded run."""
    import torch

    from repro_torch.kernels import sim_step
    from repro_torch.sim import run_cells

    before = sim_step.LAUNCHES
    torch.cuda.synchronize()
    t0 = time.monotonic()
    got = run_cells(cells, mesh=_data_mesh(["cuda:0"] * n), **kw)
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    diff = _result_diff(want, got)
    out = dict(shards=n, seconds=sec, n_steps=got.n_steps,
               launches=sim_step.LAUNCHES - before, mismatches=diff)
    print(f"[C1] {tag} over {n} x cuda:0: {got.n_steps} steps in {sec:.4f} s, "
          f"{out['launches']} sim_step launches; mismatches per field "
          f"{ {k: v for k, v in diff.items() if v} or 'none'}", flush=True)
    if any(diff.values()):
        fail(f"C1: {tag} over {n} shards differs from the unsharded run")
    return out


def phase_cells_sharded(fleet_res=None) -> dict:
    """C1, main path sharded: the fleet grid (10,000 class-pooled cells, the
    Philox route) over data meshes of 1-4 x cuda:0, each bitwise the
    unsharded run with shards x chunks sim_step launches; Fig. 4 static's
    216 cells over 5 shards on the numpy parity route (the pre-generated
    route); G1's per-peer batch over 3 shards, ``step="scan"``."""
    from repro_torch.kernels import sim_step
    from repro_torch.sim import engine, run_cells
    from repro_torch.sim.experiments import fig4_static_entries, grid_cells

    cells = fleet_cells(10_000)
    if fleet_res is None:
        fleet_res = run_cells(cells, step="fused", mesh=None)
    chunks = -(-fleet_res.n_steps // engine.DEFAULT_CHUNK)
    fleet = {n: _sharded_run("fleet grid", cells, fleet_res, n, step="fused")
             for n in SHARD_EXTENTS}
    bad = {n: r["launches"] for n, r in fleet.items()
           if r["launches"] != n * chunks}
    if bad:
        fail(f"C1: fleet launches {bad}, expected shards x {chunks} chunks")
    print(f"[C1] the fleet grid's run_cells on one card: "
          f"{fleet[1]['seconds']:.4f} s at 1 shard, "
          f"{fleet[4]['seconds']:.4f} s at 4 (the shards' chunks run one "
          f"after another on one card)", flush=True)
    f4 = grid_cells(fig4_static_entries(), **FIG4_KW)
    want = run_cells(f4, draws="numpy", mesh=None)
    by_route = dict(sim_step.LAUNCHES_BY_ROUTE)
    fig4 = _sharded_run("Fig. 4 static (numpy draws)", f4, want,
                        FIG4_SHARDS, draws="numpy")
    pre = sim_step.LAUNCHES_BY_ROUTE["pregenerated"] - by_route["pregenerated"]
    f4_chunks = -(-want.n_steps // engine.DEFAULT_CHUNK)
    if pre != fig4["launches"] or pre != FIG4_SHARDS * f4_chunks:
        fail(f"C1: Fig. 4 over {FIG4_SHARDS} shards made {fig4['launches']} "
             f"launches ({pre} pre-generated), expected "
             f"{FIG4_SHARDS * f4_chunks} on the pre-generated route")
    pp = perpeer_cells()
    kw = dict(device="cuda", draws="numpy", step="scan",
              chunk=PERPEER_SHARD_STEPS, max_steps=PERPEER_SHARD_STEPS)
    want = run_cells(pp, mesh=None, **kw)
    kw.pop("device")
    perpeer = _sharded_run("G1's per-peer batch (plain step)", pp, want,
                           PERPEER_SHARDS, **kw)
    if perpeer["launches"]:
        fail("C1: a per-peer batch launched the sim_step kernel")
    out = dict(fleet=fleet, fleet_chunks=chunks, fig4_static=fig4,
               perpeer=perpeer)
    REPORT["cells_sharded"] = out
    return out


def phase_cells_card_and_cpu() -> dict:
    """C2: phase 4's 64 cells on parity draws, CARD_CPU_STEPS steps deep,
    over a mesh of (cuda:0, cpu) against the unsharded run on the card: the
    card's shard (the kernel) bitwise, the CPU's (the plain step) by phase
    4's rule."""
    from repro_torch.kernels import sim_step
    from repro_torch.sim import run_cells

    cells = mixed_cells(64)
    kw = dict(draws="numpy", chunk=128, max_steps=CARD_CPU_STEPS)
    want = run_cells(cells, device="cuda", **kw)
    before = sim_step.LAUNCHES
    got = run_cells(cells, mesh=_data_mesh(["cuda:0", "cpu"]), **kw)
    launches = sim_step.LAUNCHES - before
    card = _result_diff(_result_slice(want, slice(0, 32)),
                        _result_slice(got, slice(0, 32)))
    bad, rel = _results_close(_result_slice(got, slice(32, None)),
                              _result_slice(want, slice(32, None)))
    out = dict(card_mismatches=card, cpu_count_mismatch=bad,
               cpu_max_rel_err=rel, n_steps=(want.n_steps, got.n_steps),
               launches=launches)
    REPORT["cells_card_and_cpu"] = out
    print(f"[C2] 64 cells over (cuda:0, cpu), parity draws, against the "
          f"unsharded run on the card: the card's 32 cells' mismatches "
          f"{ {k: v for k, v in card.items() if v} or 'none'}; the CPU's 32: "
          f"count mismatches {bad}, max rel err {rel:.3g}; steps "
          f"{want.n_steps} / {got.n_steps}; {launches} sim_step launches "
          f"(the card's shard)", flush=True)
    if any(card.values()) or bad or rel > 1e-9 or not launches:
        fail("C2: the (cuda:0, cpu) mesh disagrees with the unsharded run")
    return out


def _tree_gap(want: dict, got: dict, rtol: float) -> tuple:
    """(leaves that differ bitwise, leaves beyond ``rtol`` relative above a
    floor of ``rtol`` x the leaf's largest value)."""
    import torch

    differ, beyond = [], []
    for k, w in want.items():
        g = got[k]
        if not torch.equal(w, g):
            differ.append(k)
            w, g = w.detach().double(), g.detach().double().to(w.device)
            floor = rtol * float(w.abs().max())
            if bool(((g - w).abs() > rtol * w.abs() + floor).any()):
                beyond.append(k)
    return differ, beyond


def _zero1_step(cfg, opt, batch, devices: list, m: int, in_scan: bool):
    from repro_torch.train.optimizer import zero1_grad_constraint
    from repro_torch.train.schedule import constant
    from repro_torch.train.step import (init_train_state, make_train_step,
                                        shard_train_state, zero1_specs)

    mesh = _data_mesh(devices)
    state = shard_train_state(init_train_state(0, cfg, devices[0]), mesh)
    c = zero1_grad_constraint(mesh, zero1_specs(cfg, mesh).master)
    return make_train_step(cfg, opt, constant(1.0), n_microbatches=m,
                           grad_constraint=c,
                           zero1_grads_in_scan=in_scan)(state, batch)


def phase_zero1_smoke() -> dict:
    """Z1: ZeRO-1 at SMOKE in float32 (olmo, olmoe) on the card: data
    meshes of 2 and 4 x cuda:0, with and without ``zero1_grads_in_scan``,
    against the unsharded step with as many microbatches -- bitwise where
    the norm does not clip, within 1e-6 relative (grad_norm too) where it
    clips; a sharded state's checkpoint image equal to the unsharded one's
    (manifest and arrays) and restored into the pieces; a (cuda:0, cpu)
    mesh by T2's rule."""
    import tempfile

    import torch

    from repro_torch.ckpt import store
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed import make_mesh
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.schedule import constant
    from repro_torch.train.step import (_to_device, compute_grads,
                                        init_train_state, make_train_step,
                                        shard_train_state)

    out = {}
    for arch in Z1_ARCHS:
        cfg = _dense_smoke_cfg(arch)
        batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                       global_batch=8, seed=4)).batch_at(0)
        rows = []
        for clip in Z1_CLIPS:
            opt = AdamWConfig(lr=1e-3, grad_clip=clip)
            want, wm = make_train_step(cfg, opt, constant(1.0),
                                       n_microbatches=4)(
                init_train_state(0, cfg, "cuda"), batch)
            clipped = float(wm["grad_norm"]) > clip
            wt = want.tree()
            for n, m in ((2, 2), (4, 1)):
                for in_scan in (False, True):
                    got, gm = _zero1_step(cfg, opt, batch, ["cuda:0"] * n, m,
                                          in_scan)
                    differ, beyond = _tree_gap(wt, got.tree(), 1e-6)
                    gn = abs(float(gm["grad_norm"]) - float(wm["grad_norm"])
                             ) / float(wm["grad_norm"])
                    rows.append(dict(clip=clip, clipped=clipped, shards=n,
                                     microbatches=m, in_scan=in_scan,
                                     leaves_not_bitwise=len(differ),
                                     leaves_beyond_1e6=beyond,
                                     grad_norm_rel=gn))
                    if beyond or gn > 1e-6 or (differ and not clipped):
                        fail(f"Z1: {arch} over {n} x cuda:0 x {m} "
                             f"microbatches (in scan {in_scan}, clipped "
                             f"{clipped}): {len(differ)} leaves not bitwise, "
                             f"beyond 1e-6 {beyond[:4]}, grad_norm rel {gn}")
        out[arch] = dict(rows=rows)
        print(f"[Z1] {arch} SMOKE float32: {len(rows)} sharded steps; "
              f"unclipped bitwise: "
              f"{all(r['leaves_not_bitwise'] == 0 for r in rows if not r['clipped'])}; "
              f"clipped: leaves not bitwise "
              f"{[r['leaves_not_bitwise'] for r in rows if r['clipped']]}, "
              f"grad_norm rel "
              f"{max(r['grad_norm_rel'] for r in rows):.3g} (<= 1e-6)",
              flush=True)
    # the checkpoint image of a sharded state and its restore
    cfg = _dense_smoke_cfg(OLMO)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                   global_batch=8, seed=4)).batch_at(0)
    opt = AdamWConfig(lr=1e-3, grad_clip=Z1_CLIPS[0])
    want, _ = make_train_step(cfg, opt, constant(1.0), n_microbatches=4)(
        init_train_state(0, cfg, "cuda"), batch)
    got, _ = _zero1_step(cfg, opt, batch, ["cuda:0"] * 4, 1, False)
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        a = store.save_pytree(f"{tmp}/whole", 1, want.tree())
        b = store.save_pytree(f"{tmp}/sharded", 1, got.tree())
        same = (Path(a, "manifest.json").read_bytes()
                == Path(b, "manifest.json").read_bytes())
        for i in range(4):
            with np.load(f"{a}/shard_{i}.npz") as x, \
                    np.load(f"{b}/shard_{i}.npz") as y:
                same &= x.files == y.files and all(
                    x[f].tobytes() == y[f].tobytes() for f in x.files)
        fresh = shard_train_state(init_train_state(1, cfg, "cuda"),
                                  make_mesh((4,), ("data",), ["cuda:0"] * 4))
        fresh.load_tree(store.load_pytree(b, fresh.tree()))
    restored = all(torch.equal(fresh.tree()[k], v)
                   for k, v in want.tree().items())
    pieces = all(torch.equal(piece, sl)
                 for k, v in fresh.opt.master.items()
                 for piece, sl in v.slices(want.opt.master[k]))
    out["image"] = dict(equal=same, restored=restored, pieces=pieces)
    print(f"[Z1] olmo SMOKE, a 4-shard state's checkpoint image equals the "
          f"unsharded one's: {same}; restored into a sharded state: "
          f"{restored}, every piece its slice: {pieces}", flush=True)
    if not (same and restored and pieces):
        fail("Z1: the sharded state's checkpoint image or its restore")
    # a mesh of two devices: a replica and half the state on each
    want, wm = make_train_step(cfg, opt, constant(1.0), n_microbatches=2)(
        init_train_state(0, cfg, "cuda"), batch)
    got, gm = _zero1_step(cfg, opt, batch, ["cuda:0", "cpu"], 1, True)
    ref = init_train_state(0, cfg, "cuda")
    g_ref, _ = compute_grads(ref.params, _to_device(batch, "cuda"), cfg)
    devs = sorted({str(t.device) for v in got.opt.master.values()
                   for t in v.shards})
    res = master_rule(want.opt.master,
                      {k: v.gather("cuda") for k, v in got.opt.master.items()},
                      g_ref, g_ref, opt.lr)
    loss_rel = abs(float(gm["loss"]) - float(wm["loss"])) / abs(
        float(wm["loss"]))
    res.update(loss_rel_err=loss_rel, devices=devs,
               replicas=len({id(r) for r in got.replicas}))
    out["card_and_cpu"] = res
    print(f"[Z1] olmo SMOKE over (cuda:0, cpu), in-scan accumulator, "
          f"against the unsharded card step: loss rel {loss_rel:.3g}; "
          f"master {res['step_master_beyond_tol']} of {res['n_params']:,} "
          f"beyond {STEP_TOL}|b| + 1e-6, {res['step_master_tiny']} of a tiny "
          f"gradient within {res['step_master_tiny_max_abs']:.3g}; pieces on "
          f"{devs}, {res['replicas']} replicas", flush=True)
    if not res["ok"] or loss_rel > STEP_TOL or len(devs) != 2 \
            or res["replicas"] != 2:
        fail(f"Z1: the (cuda:0, cpu) mesh by T2's rule: "
             f"{res['step_master_worst']}")
    REPORT["zero1_smoke"] = out
    return out


HASH_CHUNK = 1 << 28   # Z2: bytes a pinned staging buffer holds
HASH_BUFFERS = 8


def _host_hashes(state) -> dict:
    """sha256 of each leaf of ``state.tree()`` (gathered whole), made on the
    host: each leaf's bytes come over in chunks through a pool of pinned
    staging buffers (non-blocking copies) and are hashed on the host in
    order, a leaf's chunks on one thread (hashlib releases the GIL)."""
    import hashlib
    import queue
    from concurrent.futures import ThreadPoolExecutor

    import torch

    tree = state.tree()
    free = queue.Queue()
    for _ in range(HASH_BUFFERS):
        free.put(torch.empty(HASH_CHUNK, dtype=torch.uint8, pin_memory=True))
    hashes = {k: hashlib.sha256() for k in tree}
    lanes = [ThreadPoolExecutor(1) for _ in range(HASH_BUFFERS)]

    def update(h, buf, n, ev):
        ev.synchronize()
        h.update(buf[:n].numpy())
        free.put(buf)

    done = []
    try:
        for i, (k, t) in enumerate(tree.items()):
            u8 = t.detach().reshape(-1).view(torch.uint8)
            for o in range(0, u8.numel(), HASH_CHUNK):
                n = min(HASH_CHUNK, u8.numel() - o)
                buf = free.get()
                buf[:n].copy_(u8[o:o + n], non_blocking=True)
                ev = torch.cuda.Event()
                ev.record()
                done.append(lanes[i % len(lanes)].submit(update, hashes[k],
                                                         buf, n, ev))
        for f in done:
            f.result()
    finally:
        for lane in lanes:
            lane.shutdown()
    return {k: h.hexdigest() for k, h in hashes.items()}


def phase_zero1_olmo() -> dict:
    """Z2: olmo-1b at full width (D2's configuration: 16 layers, 8 x 1024,
    AdamW 1e-4, the weights drawn on the card by a CUDA generator of seed
    0; clipping off): the unsharded step with 4 microbatches first (its
    per-leaf host hashes kept, the state freed), then 4 x cuda:0 with one
    microbatch a shard and 2 x cuda:0 with 2 microbatches under
    ``zero1_grads_in_scan`` -- both bitwise the unsharded step by the
    hashes; the step seconds and peaks beside D3's."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed import make_mesh
    from repro_torch.launch.train import training_config
    from repro_torch.train.optimizer import AdamWConfig, zero1_grad_constraint
    from repro_torch.train.schedule import constant
    from repro_torch.train.step import (init_train_state, make_train_step,
                                        shard_train_state, zero1_specs)

    _require_free_card("Z2")
    cfg = training_config(get_config(OLMO))
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                   global_batch=TRAIN_BATCH)).batch_at(0)
    opt = AdamWConfig(lr=DENSE_LR, grad_clip=Z2_CLIP)

    def state0():
        return init_train_state(torch.Generator(device="cuda").manual_seed(0),
                                cfg, "cuda")

    runs = {}
    for name, n, m, in_scan in (("unsharded, 4 microbatches", 0, 4, False),
                                ("4 x cuda:0, 1 microbatch a shard", 4, 1,
                                 False),
                                ("2 x cuda:0 x 2 microbatches, in scan", 2,
                                 2, True)):
        state, c = state0(), None
        if n:
            mesh = make_mesh((n,), ("data",), ["cuda:0"] * n)
            state = shard_train_state(state, mesh)
            c = zero1_grad_constraint(mesh, zero1_specs(cfg, mesh).master)
        step = make_train_step(cfg, opt, constant(1.0), n_microbatches=m,
                               grad_constraint=c, zero1_grads_in_scan=in_scan)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        sec = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated()
        t0 = time.monotonic()
        hashes = _host_hashes(state)
        runs[name] = dict(step_s=sec, peak_gib=peak / 2**30,
                          grad_norm=float(metrics["grad_norm"]),
                          loss=float(metrics["loss"]), hashes=hashes,
                          hash_s=time.monotonic() - t0)
        del state, step, metrics
        torch.cuda.empty_cache()
    want = runs["unsharded, 4 microbatches"]["hashes"]
    for name, r in runs.items():
        r["leaves_differ"] = [k for k, h in r.pop("hashes").items()
                              if h != want[k]]
        print(f"[Z2] olmo-1b, {name}: step {r['step_s']:.3f} s (first step, "
              f"cold), peak {r['peak_gib']:.2f} GiB, loss {r['loss']:.5f}, "
              f"grad_norm {r['grad_norm']:.5f}; host hashes of "
              f"{len(want)} leaves in {r['hash_s']:.1f} s, "
              f"{len(r['leaves_differ'])} differ from the unsharded step's",
              flush=True)
    d3 = REPORT.get("dense_train", {})
    if "median_step_s" in d3:
        print(f"[Z2] D3 in this run: a warm step {d3['median_step_s']:.3f} s "
              f"of 8 x 1024 in 2 microbatches, peak "
              f"{d3.get('peak_bytes', 0) / 2**30:.2f} GiB", flush=True)
    REPORT["zero1_olmo"] = runs
    if any(r["leaves_differ"] for r in runs.values()):
        fail("Z2: a sharded olmo-1b step is not bitwise the unsharded step")
    return runs


def shard_phases(fleet_res=None) -> dict:
    """C1-Z2 with the sim_step counts at 0 just before the sharded cell
    paths and read just after."""
    import torch

    from repro_torch.kernels import sim_step

    sim_step.LAUNCHES = 0          # the sharded cell paths start here
    _zero(sim_step.LAUNCHES_BY_ROUTE)
    cells = phase_cells_sharded(fleet_res)
    card_cpu = phase_cells_card_and_cpu()
    launches = dict(total=sim_step.LAUNCHES,   # ... and end here
                    by_route=dict(sim_step.LAUNCHES_BY_ROUTE))
    REPORT["sharded_cells_launches"] = launches
    _lap("C1-C2")
    zero1 = phase_zero1_smoke()
    _lap("Z1")
    olmo = phase_zero1_olmo()
    torch.cuda.empty_cache()
    _lap("Z2")
    return dict(cells=cells, card_and_cpu=card_cpu, launches=launches,
                zero1=zero1, olmo=olmo)


# --------------------------------------------------------------------------- #
# Tensor parallelism over a model axis (TP1-TP4) and the dry run on the card
# (DR1)
# --------------------------------------------------------------------------- #

TP_SMOKE_ARCHS = (OLMO, GEMMA, OLMOE, DEEPSEEK, ARCH, ZAMBA)
TP_EXTENTS = (2, 4)      # TP1/TP2: model extents over cuda:0 repeated
TP_SEQ, TP_FORCED = 32, 4   # TP1: prompt tokens and teacher-forced steps
TP_TRAIN_LAYERS = 8      # TP4: olmo-1b's depth cut (the unsplit and the
                         # split state and step side by side on one card)
TP_TRAIN_STEPS = 3
TP_LOSS_REL, TP_GNORM_REL = 1e-2, 5e-2   # TP4: bf16 step against unsplit
TP_MOE_F32_LAYERS = 4    # TP3: olmoe's float32 check (27.7 GB at 16 layers)
TP_DECODE_STEPS = 8      # TP2/TP3: decode steps timed beside the greedy run
TP_WIDE_DECODE_STEPS = 2    # TP5 at m = 16 (2-4 s a step, host-bound; 4
                            # until TP7-TP8 needed the time)
DR_PEAK_RANGE = (0.8, 1.25)   # DR1: card peak / the dry run's estimate
TP_ZAMBA_EXTENTS = (2, 16)    # TP5: 56 / 7 SSM heads, 16 / 2 attention heads
TP_MAMBA_EXTENTS = (2, 16)    # TP6: a split of 12 heads / replicas
TP_SPLIT_FORCED = 1   # TP5/TP6: teacher-forced decode steps in the logits
TP_SSD_CHECK_LAYERS = 2   # TP5: layers whose shard SSD calls meet S1's rule
STARCODER, QWEN = "starcoder2-3b", "qwen2-vl-7b"
DR_DECODE_CELLS = ((ZAMBA, "decode_32k"), (ARCH, "decode_32k"),   # DR1
                   (STARCODER, "decode_32k"), ("whisper-large-v3",
                                               "decode_32k"))
# TP1's context-parallel, head_dim and encdec splits: (arch, mesh, the
# cell whose rules the split takes) -- starcoder2's and qwen2-vl's 2 KV
# heads do not divide 4, whisper's SMOKE 4 heads divide 2 (Megatron), not 8
TP_ATTN_CASES = ((STARCODER, (1, 4), "prefill"), (STARCODER, (1, 4), "decode"),
                 (QWEN, (1, 4), "prefill"), (QWEN, (1, 4), "decode"),
                 ("whisper-large-v3", (1, 2), "prefill"),
                 ("whisper-large-v3", (1, 8), "prefill"),
                 ("whisper-large-v3", (1, 8), "decode"))
TP_ATTN_STEPS = ((STARCODER, (1, 4)), ("whisper-large-v3", (1, 8)))
TP_WHISPER_SEQ = 28     # TP1: whisper's prompt, 28 + 4 = 32 slots (8 | 32)
TP7_M, TP7_DECODE_STEPS, TP7_F32_LAYERS = 4, 8, 4   # TP7: starcoder2-3b
TP8_M, TP8_DECODE_STEPS, TP8_F32_LAYERS = 16, 4, 4  # TP8: whisper-large-v3


def _model_mesh(shape, dev: str = "cuda"):
    """A (data, model) mesh repeating one device."""
    from repro_torch.distributed.mesh import Mesh

    return Mesh(shape, ("data", "model"), [dev] * math.prod(shape))


def _tp_serve(model, cfg, prompt, forced, cache_dtype=None, frames=None):
    """:func:`_serve_run` of a whole or split model: the logits stacked,
    and the KV cache in the unsplit layout."""
    import torch

    out, cache = _serve_run(model, cfg, prompt, forced, cache_dtype, frames)
    if getattr(model, "is_split", False):
        if not _carries_equal(model, cache):
            fail(f"{cfg.name}: the shards' B and C conv carries differ")
        cache = model.gather_cache(cache)
    return torch.stack(out), cache


def _cache_leaves(c) -> dict:
    """A cache's leaves by name (K/V, SSM state, conv, cross K/V)."""
    return {f"{part}/{n}": t for part, v in c.items() if part != "index"
            for n, t in (v.items() if isinstance(v, dict) else [("", v)])}


def _cache_gap(a, b, tol) -> dict:
    """The worst gap over the caches' leaves (K/V, SSM state, conv, cross
    K/V)."""
    la, lb = _cache_leaves(a), _cache_leaves(b)
    return max((_gap(t.to(lb[k].device), lb[k], tol) for k, t in la.items()),
               key=lambda g: g["max_ratio"])


def _carries_equal(split, cache) -> bool:
    """Every shard's B and C conv carry (the channels every shard
    computes whole) the same to the bit, at each data index."""
    import torch

    if not split.ssm_split:
        return True
    n = split.cfg.ssm.d_state
    for d in split.data_indices():
        bc = [cache["pieces"][(d, j)]["ssm"]["conv"][..., -2 * n:]
              for j, _ in split.group(d)]
        if not all(torch.equal(x, bc[0]) for x in bc[1:]):
            return False
    return True


def _shards_equal(routes: list, m: int) -> bool:
    """Each moe layer call of a split model routes once a shard, in model
    order: the m routes of a call must be bitwise equal."""
    import torch

    return len(routes) % m == 0 and all(
        torch.equal(routes[i].expert_ids, routes[i + j].expert_ids)
        and torch.equal(routes[i].kept, routes[i + j].kept)
        for i in range(0, len(routes), m) for j in range(1, m))


def _split_grads(split, cfg, batch) -> dict:
    """Every piece's gradients of the split loss (data index 0)."""
    from repro_torch.models import model as M

    for p in split.modules():
        p.zero_grad(set_to_none=True)
    import torch
    with torch.enable_grad():
        loss, _ = M._split_loss(split, batch, cfg, 0)
        loss.backward()
    out = {(j, k): p.grad.clone() for j, piece in split.group(0)
           for k, p in piece.named_parameters()}
    for p in split.modules():
        p.zero_grad(set_to_none=True)
    return out


def tp_step_vs_unsplit(cfg, batch, dev: str = "cuda", shape=(2, 2),
                       rules=None) -> dict:
    """One float32 train step over ``shape`` (data, model) of ``dev`` (by
    ``rules``, default the split's) against the unsplit step with as many
    microbatches (4), by T2's rule: the loss within STEP_TOL relative,
    grad_norm likewise, and the whole step's master by
    :func:`master_rule` (the unsplit gradients as reference)."""
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.schedule import constant
    from repro_torch.train.step import (_to_device, compute_grads,
                                        init_train_state, make_train_step,
                                        shard_train_state)

    opt = AdamWConfig(lr=1e-3)
    whole = init_train_state(0, cfg, dev)
    split = shard_train_state(init_train_state(0, cfg, dev),
                              _model_mesh(shape, dev), rules=rules)
    # the reference gradient is the mean of the 4 microbatches' (a moe
    # gradient of the whole batch differs: its aux loss is the batch's)
    micro = [{k: v[i * 2:(i + 1) * 2] for k, v in
              _to_device(batch, dev).items()} for i in range(4)]
    g_ref = {}
    for mb in micro:
        for k, t in compute_grads(whole.params, mb, cfg)[0].items():
            g_ref[k] = g_ref[k] + t.float() if k in g_ref else t.float()
    g_ref = {k: t / 4 for k, t in g_ref.items()}
    want, wm = make_train_step(cfg, opt, constant(1.0), n_microbatches=4)(
        whole, batch)
    got, gm = make_train_step(cfg, opt, constant(1.0),
                              n_microbatches=4 // shape[0])(split, batch)
    a, b = want.tree(), got.tree()
    layout = all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
                 for k in a) and a.keys() == b.keys()
    rel = {k: abs(float(gm[k]) - float(wm[k])) / abs(float(wm[k]))
           for k in ("loss", "grad_norm")}
    res = dict(loss=float(gm["loss"]), loss_unsplit=float(wm["loss"]),
               loss_rel_err=rel["loss"], grad_norm_rel_err=rel["grad_norm"],
               image_layout_equal=layout, **adam_master_rule(a, b, g_ref,
                                                             opt))
    res["ok"] = res["ok"] and layout and max(rel.values()) <= STEP_TOL
    return res


def adam_master_rule(want: dict, got: dict, g_ref: dict, opt) -> dict:
    """T2's rule for a whole step's master between two states' images
    (``tree()``), with the bound that follows Adam
    (``train.optimizer.master_gap_bound``: lr |dm^| / (sqrt(v^) + eps) x
    2 + STEP_TOL |w| + 1e-6, dm^ the two states' first moments'
    difference) in place of T2's exemption of tiny gradients; the first
    moments (m = 0.1 clip g) within 1e-4 max|g| + 1e-6 of the
    reference's gradient ``g_ref``."""
    from repro_torch.train.optimizer import master_gap_bound

    step = int(want["opt/step"])
    beyond, worst, m_beyond = 0, 0.0, []
    for k in g_ref:
        w = want[f"opt/master/{k}"].cpu()
        bound = master_gap_bound(opt, step, w, want[f"opt/m/{k}"].cpu(),
                                 got[f"opt/m/{k}"].cpu(),
                                 want[f"opt/v/{k}"].cpu(), opt.lr,
                                 rtol=STEP_TOL)
        d = (got[f"opt/master/{k}"].cpu() - w).abs()
        beyond += int((d > bound).sum())
        worst = max(worst, float((d / bound).max()))
        dm = float((got[f"opt/m/{k}"] - want[f"opt/m/{k}"]).abs().max())
        if dm > (1 - opt.b1) * (1e-4 * float(g_ref[k].abs().max()) + 1e-6):
            m_beyond.append(k)
    return dict(step_master_beyond_bound=beyond,
                step_master_worst_ratio=worst, moments_beyond=m_beyond,
                n_params=sum(t.numel() for t in g_ref.values()),
                ok=not beyond and not m_beyond)


def phase_tp_smoke(dev: str = "cuda") -> dict:
    """TP1: six SMOKE configs in float32 with the kernels on (SIMT flash;
    mamba2's and zamba2's SIMT SSD), split over (1, 2) and (1, 4) of
    ``dev`` (4 where the heads divide), against the CPU's split run and
    the card's unsplit run: prefill of TP_SEQ tokens and TP_FORCED
    teacher-forced decode steps, logits and the gathered caches (K/V, SSM
    state, conv carry) within OLMO_F32_TOL; moe routes bitwise equal on
    every shard and against the unsplit run; every shard's B and C conv
    carry bitwise equal.  zamba2 at batch 1 over (2, 2): the batch run
    whole by each data position, the shared block's K/V along the
    sequence over them.  Then one train step over (2, 2) of olmo, olmoe,
    mamba2 and zamba2 SMOKE against the unsplit step (T2's rule, the
    master by the bound that follows Adam), and remat none, full and dots
    and a second backward bitwise on ``dev`` (olmo and zamba2 over (1,
    2))."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.models import init_params

    tol = OLMO_F32_TOL
    FA.LAUNCHES = SSD.LAUNCHES = 0
    _zero(FA.LAUNCHES_BY_ROUTE)
    _zero(SSD.LAUNCHES_BY_ROUTE)
    rows, bad = {}, []
    runs = [(arch, (1, m), 4) for arch in TP_SMOKE_ARCHS
            for m in TP_EXTENTS] + [(ZAMBA, (2, 2), 1)]
    made = {}
    for arch, shape, batch in runs:
        cfg = get_smoke_config(arch).replace(
            param_dtype="float32", compute_dtype="float32",
            use_flash_kernel=True)
        if (arch, batch) not in made:
            here, cpu = init_params(0, cfg, device=dev), \
                init_params(0, cfg, device="cpu")
            g = torch.Generator().manual_seed(3)
            prompt = torch.randint(0, cfg.vocab, (batch, TP_SEQ), generator=g)
            forced = torch.randint(0, cfg.vocab, (batch, TP_FORCED),
                                   generator=g)
            with RouteSpy() as r_whole:
                lw, cw = _tp_serve(here, cfg, prompt.to(dev), forced.to(dev),
                                   torch.float32)
            made[(arch, batch)] = (here, cpu, prompt, forced, r_whole, lw, cw)
        here, cpu, prompt, forced, r_whole, lw, cw = made[(arch, batch)]
        name = f"{arch} {shape}" + (f" batch {batch}" if batch != 4 else "")
        rules = TP.split_rules(cfg, _model_mesh(shape, dev))
        if TP.unsupported_axes(cfg, rules):
            rows[name] = dict(
                skipped=f"the rules put {TP.unsupported_axes(cfg, rules)}"
                        f" on the model axis")
            continue
        card = TP.split_model(here, _model_mesh(shape, dev))
        host = TP.split_model(cpu, _model_mesh(shape, "cpu"))
        with RouteSpy() as r_card:
            lc, cc = _tp_serve(card, cfg, prompt.to(dev), forced.to(dev),
                               torch.float32)
        lp, cp = _tp_serve(host, cfg, prompt, forced, torch.float32)
        row = dict(vs_cpu=_gap(lc.cpu(), lp, tol),
                   cache_vs_cpu=_cache_gap(cc, cp, tol),
                   vs_unsplit=_gap(lc, lw, tol),
                   cache_vs_unsplit=_cache_gap(cc, cw, tol))
        ok = all(_ok(g) for g in row.values())
        if cfg.family == "moe":
            m = shape[1]
            row["routes_equal_on_shards"] = _shards_equal(r_card.routes,
                                                         m)
            row["routes_equal_to_unsplit"] = all(
                torch.equal(a.expert_ids, b.expert_ids)
                and torch.equal(a.kept, b.kept) for a, b in
                zip(r_card.routes[::m], r_whole.routes)) and \
                len(r_card.routes) == m * len(r_whole.routes)
            ok = ok and row["routes_equal_on_shards"] and \
                row["routes_equal_to_unsplit"]
        row["ok"] = ok
        rows[name] = row
        print(f"[TP1] {name} SMOKE float32 split: logits vs the CPU's split "
              f"run {row['vs_cpu']['max_abs']:.3g}, vs the unsplit run "
              f"{row['vs_unsplit']['max_abs']:.3g}; caches "
              f"{row['cache_vs_cpu']['max_abs']:.3g} / "
              f"{row['cache_vs_unsplit']['max_abs']:.3g} (tol {tol})"
              + (f"; routes equal on the shards "
                 f"{row['routes_equal_on_shards']}, to the unsplit run "
                 f"{row['routes_equal_to_unsplit']}"
                 if cfg.family == "moe" else "")
              + ("; B and C conv carries bitwise equal on the shards"
                 if card.ssm_split else ""), flush=True)
        if not ok:
            bad.append(name)
    del made
    attn_rows, attn_bad = _tp1_attn_layouts(dev, tol)
    rows.update(attn_rows)
    bad += attn_bad
    launches = dict(flash_attention=dict(FA.LAUNCHES_BY_ROUTE),
                    ssd_scan=dict(SSD.LAUNCHES_BY_ROUTE))
    steps = {}
    step_cases = [(arch, (2, 2)) for arch in (OLMO, OLMOE, ARCH, ZAMBA)] + \
        list(TP_ATTN_STEPS)
    for arch, shape in step_cases:
        cfg = get_smoke_config(arch).replace(param_dtype="float32",
                                             compute_dtype="float32")
        g = torch.Generator().manual_seed(4)
        tok = torch.randint(0, cfg.vocab, (8, TP_SEQ), generator=g)
        batch = {"tokens": tok, "labels": tok.roll(-1, 1)}
        rules = None
        if shape != (2, 2):         # the train cell's rules: kv_seq
            rules = _cell_rules(cfg, shape, "prefill", 8, TP_SEQ, TP_SEQ)
            if cfg.family == "encdec":
                batch["frames"] = torch.randn(8, cfg.enc_seq, cfg.d_model,
                                              generator=g)
        res = tp_step_vs_unsplit(cfg, batch, dev, shape, rules)
        steps[f"{arch} {shape}"] = res
        print(f"[TP1] {arch} SMOKE train step over (data {shape[0]}, model "
              f"{shape[1]}){'' if rules is None else ' (kv_seq)'} vs the "
              f"unsplit step (4 microbatches): loss {res['loss']:.7f} vs "
              f"{res['loss_unsplit']:.7f} (rel {res['loss_rel_err']:.3g}), "
              f"grad_norm rel {res['grad_norm_rel_err']:.3g} (tol "
              f"{STEP_TOL}); whole step's master: "
              f"{res['step_master_beyond_bound']} of {res['n_params']:,} "
              f"beyond the Adam bound (worst "
              f"{res['step_master_worst_ratio']:.3g} of it), first moments "
              f"beyond 1e-4 max|g| + 1e-6: "
              f"{res['moments_beyond']}; image layout equal "
              f"{res['image_layout_equal']}", flush=True)
        if not res["ok"]:
            bad.append(f"{arch} train step")
    # remat none, full, dots and a second backward: bitwise
    remat_ok = {}
    for arch in (OLMO, ZAMBA):
        cfg = get_smoke_config(arch).replace(param_dtype="float32",
                                             compute_dtype="float32")
        split = TP.split_model(init_params(0, cfg, device=dev)
                               .requires_grad_(True),
                               _model_mesh((1, 2), dev))
        g = torch.Generator().manual_seed(5)
        tok = torch.randint(0, cfg.vocab, (4, TP_SEQ), generator=g).to(dev)
        batch = {"tokens": tok, "labels": tok.roll(-1, 1)}
        grads = {r: _split_grads(split, cfg.replace(remat=r), batch)
                 for r in ("none", "full", "dots")}
        again = _split_grads(split, cfg, batch)
        remat_ok[arch] = all(torch.equal(grads["none"][k], grads[r][k])
                             for r in ("full", "dots")
                             for k in grads["none"]) and \
            all(torch.equal(grads["none"][k], again[k]) for k in again)
        print(f"[TP1] {arch} SMOKE split over (1, 2): remat none, full, dots "
              f"and a second backward bitwise the same: {remat_ok[arch]}",
              flush=True)
        if not remat_ok[arch]:
            bad.append(f"{arch} remat")
    print(f"[TP1] launches of the split float32 SMOKE prefills: {launches}",
          flush=True)
    out = dict(rows=rows, steps=steps, remat_bitwise=remat_ok,
               launches_by_route=launches["flash_attention"],
               ssd_launches_by_route=launches["ssd_scan"])
    REPORT["tp_smoke"] = out
    if bad:
        fail(f"TP1: the split SMOKE runs disagree: {bad}")
    return out


def _record_calls(model, cfg, prompt, forced):
    """The kernel path's logits with each flash call of the prefill held
    against its plain version on the call's own q, k, v."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops

    tol = FLASH_TOL["bfloat16"]
    calls, launch = [], ops.flash_attention

    def recorded(q, k, v, **kw):
        got = launch(q, k, v, **kw)
        want = FA.flash_attention_plain(q, k, v, **kw)
        calls.append(dict(shape=tuple(q.shape), **_gap(got, want, tol)))
        return got

    with mock.patch.object(ops, "flash_attention", recorded):
        logits, _ = _tp_serve(model, cfg, prompt, forced)
    return logits, calls


def _floor_rule(got, want, floor, moe: bool) -> dict:
    """S4's rule: ``got`` against ``want`` within LOGIT_TOL + LOGIT_TOL |b|
    except where the same run's floor crosses it, by NOISE_FACTOR times
    the floor's ratio; relative RMS within LOGIT_TOL (moe: or
    NOISE_FACTOR times the floor's)."""
    g = _gap(got, want, LOGIT_TOL)
    g["limit_ratio"] = max(1.0, NOISE_FACTOR * floor["max_ratio"])
    g["rms_limit"] = max(LOGIT_TOL, NOISE_FACTOR * floor["rel_rms"]) \
        if moe else LOGIT_TOL
    g["ok"] = g["finite"] and g["max_ratio"] <= g["limit_ratio"] and \
        g["rel_rms"] <= g["rms_limit"]
    return g


def _tp_flash_shard_times(cfg, m: int) -> dict:
    """One shard's flash call at the split prefill's shape (B·G/m, R,
    1024, D), bf16: the kernel, its plain version and SDPA by CUDA events,
    beside the bound."""
    import torch

    from repro_torch.kernels import flash_attention as FA

    a = cfg.attention
    bg, r = OLMO_BATCH * a.n_kv_heads // m, a.n_heads // a.n_kv_heads
    d, s = a.head_dim, OLMO_PROMPT
    q, k, v = flash_inputs(bg, r, s, s, d, torch.bfloat16, 600 + m)
    scale = d ** -0.5
    got = FA.flash_attention(q, k, v, scale=scale)
    gap = _gap(got, FA.flash_attention_plain(q, k, v, scale=scale),
               FLASH_TOL["bfloat16"])
    ms = min(cuda_ms(lambda: FA.flash_attention(q, k, v, scale=scale), 20)
             for _ in range(2))
    plain_ms = cuda_ms(lambda: FA.flash_attention_plain(q, k, v,
                                                        scale=scale), 3)
    lib_ms = cuda_ms(lambda: _sdpa(q, k, v, scale), 20)
    b = flash_bound(bg, r, s, s, d, None)
    return dict(shape=(bg, r, s, s, d), ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b["bound_ms"],
                bound_by=b["bound_by"], max_abs_err=gap["max_abs"],
                ok=_flash_ok(gap, torch.bfloat16))


def _serve_numbers(cfg, params, prompt, n_tokens: int) -> dict:
    """Prefill seconds (3 warm runs) and decode tokens/s (``n_tokens`` - 1
    greedy steps) of a whole or split model."""
    import torch

    from repro_torch.serve.step import make_prefill_step, make_serve_step

    pre = make_prefill_step(cfg, max_seq=prompt.shape[1] + n_tokens)
    srv = make_serve_step(cfg)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        logits, cache = pre(params, {"tokens": prompt})
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
    tok = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(n_tokens - 1):
        logits, cache = srv(params, cache, {"tokens": tok})
        tok = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    dec = time.monotonic() - t0
    return dict(prefill_s=times,
                decode_tok_s=prompt.shape[0] * (n_tokens - 1) / dec)


def phase_tp_olmo() -> dict:
    """TP2: olmo-1b served whole at model extents 2 and 4 of cuda:0 (batch
    8, prompt 1024, 32 greedy tokens): exactly 16·m ``wgmma`` flash
    launches a prefill and none in decode; each shard's prefill call
    against its plain version on its own q, k, v (A1's bf16 rule); bf16
    logits against the unsplit kernel path by S4's floor rule (the floor:
    the unsplit kernel path against the unsplit plain path); float32 at
    m = 2 within OLMO_F32_TOL.  The prefill seconds and decode tokens/s
    at m = 1, 2 and 4 (no claim: on one card the shards run one after
    another), each shard call's time beside its bound, the peak."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import init_params
    from repro_torch.models import model as M

    _require_free_card("TP2")
    cfg = get_config(OLMO)
    assert cfg.use_flash_kernel
    model = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (OLMO_BATCH, OLMO_PROMPT),
                           generator=g).cuda()
    forced = torch.randint(0, cfg.vocab, (OLMO_BATCH, OLMO_FORCED),
                           generator=g).cuda()
    whole, _ = _tp_serve(model, cfg, prompt, forced)
    plain, _ = _tp_serve(model, cfg.replace(use_flash_kernel=False), prompt,
                         forced)
    floor = _gap(whole, plain, LOGIT_TOL)
    rows, bad = {}, []
    for m in (1,) + TP_EXTENTS:
        params = model if m == 1 else TP.split_model(
            model, _model_mesh((1, m)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        FA.LAUNCHES = 0      # this extent's serving main path starts here
        _zero(FA.LAUNCHES_BY_ROUTE)
        run = phase_serve(cfg, params, prompt, OLMO_TOKENS)
        launches = dict(FA.LAUNCHES_BY_ROUTE)   # ... and ends here
        total = FA.LAUNCHES
        row = dict(launches_by_route=launches, peak_bytes=run["mem"],
                   greedy_wall_s=run["wall"],
                   **_serve_numbers(cfg, params, prompt, TP_DECODE_STEPS))
        want = cfg.n_layers * m
        if launches["wgmma"] != want or total != want:
            bad.append(f"m={m}: launches {launches}, expected {want} wgmma")
        if m > 1:
            logits, calls = _record_calls(params, cfg, prompt, forced)
            worst = max(calls, key=lambda c: c["max_ratio"])
            row["calls"] = len(calls)
            row["call_worst"] = {k: worst[k] for k in (
                "shape", "max_abs", "max_ratio", "rel_rms")}
            row["calls_ok"] = len(calls) == want and all(
                _flash_ok(c, torch.bfloat16) for c in calls)
            row["bf16"] = _floor_rule(logits, whole, floor, moe=False)
            row["shard_call"] = _tp_flash_shard_times(cfg, m)
            if not (row["calls_ok"] and row["bf16"]["ok"]
                    and row["shard_call"]["ok"]):
                bad.append(f"m={m}: calls {row['call_worst']}, logits "
                           f"{row['bf16']}")
            del params
        rows[m] = row
        sc = row.get("shard_call")
        print(f"[TP2] olmo-1b over (1, {m}) of cuda:0: flash launches "
              f"{launches} (expected {want} wgmma), prefill "
              f"{', '.join(f'{t:.4f}' for t in row['prefill_s'])} s, decode "
              f"{row['decode_tok_s']:.1f} tok/s, peak "
              f"{row['peak_bytes'] / 2**30:.2f} GiB"
              + ("" if m == 1 else
                 f"; {row['calls']} shard calls vs plain: worst "
                 f"{row['call_worst']['max_ratio']:.3f} x (2e-2 + 2e-2|b|), "
                 f"rel RMS {row['call_worst']['rel_rms']:.3g}; bf16 logits vs "
                 f"the unsplit kernel path: max {row['bf16']['max_ratio']:.3f}"
                 f" x (limit {row['bf16']['limit_ratio']:.3f}), rel RMS "
                 f"{row['bf16']['rel_rms']:.4g}; floor (unsplit kernel vs "
                 f"plain) {floor['max_ratio']:.3f} x, rel RMS "
                 f"{floor['rel_rms']:.4g}; shard call {sc['shape']}: kernel "
                 f"{sc['ms']:.4f} ms, plain {sc['plain_ms']:.4f}, SDPA "
                 f"{sc['library_ms']:.4f}, bound {sc['bound_ms']:.4f} "
                 f"({sc['bound_by']})"), flush=True)
        torch.cuda.empty_cache()
    # float32 at m = 2: the bf16 weights cast on the card, float32 caches
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    model32 = M.DenseLM(cfg32)
    model32.load_state_dict({n: t.float() for n, t in
                             model.named_parameters()}, assign=True)
    del model
    torch.cuda.empty_cache()
    w32, _ = _tp_serve(model32, cfg32, prompt, forced, torch.float32)
    s32 = TP.split_model(model32, _model_mesh((1, 2)))
    l32, _ = _tp_serve(s32, cfg32, prompt, forced, torch.float32)
    f32 = _gap(l32, w32, OLMO_F32_TOL)
    print(f"[TP2] olmo-1b float32 over (1, 2) vs unsplit: max |d| "
          f"{f32['max_abs']:.3g} = {f32['max_ratio']:.4f} x ({OLMO_F32_TOL} "
          f"+ {OLMO_F32_TOL}|b|)", flush=True)
    if not _ok(f32):
        bad.append(f"float32 {f32}")
    del model32, s32
    torch.cuda.empty_cache()
    out = dict(rows=rows, floor=floor, f32=f32)
    REPORT["tp_olmo"] = out
    if bad:
        fail(f"TP2: {bad}")
    return out


def phase_tp_olmoe() -> dict:
    """TP3: olmoe-1b-7b served whole at model extent 2 (32 experts a
    shard): exactly 32 ``wgmma`` flash launches a prefill; every layer
    call's routes bitwise equal on the two shards; bf16 logits against
    the unsplit kernel path by S4's floor rule with moe's relative RMS
    (M2's), the route gaps to the unsplit run reported beside the floor's;
    float32 at TP_MOE_F32_LAYERS layers on the unsplit run's routes, each
    differing own choice a near tie (MOE_F32_NEAR_TIE), logits within
    OLMO_F32_TOL."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import init_params
    from repro_torch.models import model as M

    _require_free_card("TP3")
    cfg = get_config(OLMOE)
    m = 2
    model = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (OLMO_BATCH, OLMO_PROMPT),
                           generator=g).cuda()
    forced = torch.randint(0, cfg.vocab, (OLMO_BATCH, OLMO_FORCED),
                           generator=g).cuda()
    with RouteSpy() as r_whole:
        whole, _ = _tp_serve(model, cfg, prompt, forced)
    with RouteSpy() as r_plain:
        plain, _ = _tp_serve(model, cfg.replace(use_flash_kernel=False),
                             prompt, forced)
    floor = _gap(whole, plain, LOGIT_TOL)
    split = TP.split_model(model, _model_mesh((1, m)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FA.LAUNCHES = 0          # the split moe serving main path starts here
    _zero(FA.LAUNCHES_BY_ROUTE)
    run = phase_serve(cfg, split, prompt, OLMO_TOKENS)
    launches = dict(FA.LAUNCHES_BY_ROUTE)       # ... and ends here
    total = FA.LAUNCHES
    numbers = _serve_numbers(cfg, split, prompt, TP_DECODE_STEPS)
    with RouteSpy() as r_split:
        logits, _ = _tp_serve(split, cfg, prompt, forced)
    shards_equal = _shards_equal(r_split.routes, m)
    bf16 = _floor_rule(logits, whole, floor, moe=True)
    routes = dict(split_vs_unsplit=route_gaps(r_split.routes[::m],
                                              r_whole.routes),
                  floor=route_gaps(r_whole.routes, r_plain.routes))
    del split, r_whole, r_plain, r_split
    # float32 at a few layers, on the unsplit run's routes
    n32 = min(TP_MOE_F32_LAYERS, cfg.n_layers)
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32",
                        n_layers=n32)
    model32 = M.DenseLM(cfg32)
    kept = {n for n, _ in model32.named_parameters()}
    model32.load_state_dict({n: t.float() for n, t in
                             model.named_parameters() if n in kept},
                            assign=True)
    del model
    torch.cuda.empty_cache()
    with RouteSpy() as r32:
        w32, _ = _tp_serve(model32, cfg32, prompt, forced, torch.float32)
    s32 = TP.split_model(model32, _model_mesh((1, m)))
    with RouteSpy(force=[r.expert_ids for r in r32.routes
                         for _ in range(m)]) as k32:
        l32, _ = _tp_serve(s32, cfg32, prompt, forced, torch.float32)
    f32 = _gap(l32, w32, OLMO_F32_TOL)
    f32_routes = route_gaps(k32.own[::m], r32.routes)
    del model32, s32, r32, k32
    torch.cuda.empty_cache()
    out = dict(launches_by_route=launches, peak_bytes=run["mem"],
               greedy_wall_s=run["wall"], shards_equal=shards_equal,
               bf16=bf16, floor=floor, routes=routes, f32=f32,
               f32_routes=f32_routes, f32_layers=n32, **numbers)
    REPORT["tp_olmoe"] = out
    print(f"[TP3] olmoe-1b-7b over (1, {m}) of cuda:0: flash launches "
          f"{launches} (expected {m * cfg.n_layers} wgmma), prefill "
          f"{', '.join(f'{t:.4f}' for t in numbers['prefill_s'])} s, decode "
          f"{numbers['decode_tok_s']:.1f} tok/s, peak "
          f"{run['mem'] / 2**30:.2f} GiB; routes bitwise equal on the shards "
          f"{shards_equal}; bf16 logits vs the unsplit kernel path max "
          f"{bf16['max_ratio']:.3f} x (limit {bf16['limit_ratio']:.3f}), rel "
          f"RMS {bf16['rel_rms']:.4g} (limit {bf16['rms_limit']:.4g}); route "
          f"claims on another expert than the unsplit run's: "
          f"{routes['split_vs_unsplit']['moved_share']:.3g} (floor, unsplit "
          f"kernel vs plain: {routes['floor']['moved_share']:.3g}); float32 "
          f"at {n32} layers on the unsplit routes: max |d| "
          f"{f32['max_abs']:.3g} = {f32['max_ratio']:.4f} x, differing own "
          f"choices' largest relative gap {f32_routes['worst_rel_gap']:.3g}",
          flush=True)
    want = m * cfg.n_layers
    if launches["wgmma"] != want or total != want or not shards_equal \
            or not bf16["ok"] or not _ok(f32) \
            or f32_routes["worst_rel_gap"] > MOE_F32_NEAR_TIE:
        fail(f"TP3: launches {launches}, shards equal {shards_equal}, bf16 "
             f"{bf16}, float32 {f32}, float32 routes {f32_routes}")
    return out


def phase_tp_train() -> dict:
    """TP4: olmo-1b at full width (TP_TRAIN_LAYERS layers) trained over
    (data 2, model 2) of cuda:0, D2's configuration with clipping off:
    one step's loss and grad_norm against the unsplit step with as many
    microbatches (TP_LOSS_REL, TP_GNORM_REL), TP_TRAIN_STEPS steps with
    finite losses, and the split state's image in the unsplit layout
    (names, shapes, dtypes)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.schedule import constant
    from repro_torch.train.step import (init_train_state, make_train_step,
                                        shard_train_state)

    _require_free_card("TP4")
    cfg = get_config(OLMO).replace(n_layers=TP_TRAIN_LAYERS,
                                   use_flash_kernel=False)
    opt = AdamWConfig(lr=DENSE_LR, grad_clip=1e9)
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                             cfg, "cuda")
    split = shard_train_state(state.clone(), _model_mesh((2, 2)))
    g = torch.Generator().manual_seed(7)
    tok = torch.randint(0, cfg.vocab, (OLMO_BATCH, OLMO_PROMPT), generator=g)
    batch = {"tokens": tok, "labels": tok.roll(-1, 1)}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    state, wm = make_train_step(cfg, opt, constant(1.0), n_microbatches=4)(
        state, batch)
    torch.cuda.synchronize()
    whole_s = time.monotonic() - t0
    layout = {k: (tuple(v.shape), v.dtype) for k, v in state.tree().items()}
    want = {k: float(wm[k]) for k in ("loss", "grad_norm")}
    del state
    torch.cuda.empty_cache()
    step = make_train_step(cfg, opt, constant(1.0), n_microbatches=2)
    torch.cuda.reset_peak_memory_stats()
    losses, times, first = [], [], None
    for i in range(TP_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        split, m = step(split, batch)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
        losses.append(float(m["loss"]))
        if first is None:
            first = {k: float(m[k]) for k in ("loss", "grad_norm")}
    peak = torch.cuda.max_memory_allocated()
    image = {k: (tuple(v.shape), v.dtype) for k, v in split.tree().items()}
    rel = {k: abs(first[k] - want[k]) / abs(want[k]) for k in want}
    out = dict(layers=cfg.n_layers, split=first, unsplit=want, rel=rel,
               losses=losses, step_s=times, unsplit_step_s=whole_s,
               peak_bytes=peak, image_layout_equal=image == layout,
               image_leaves=len(image))
    REPORT["tp_train"] = out
    print(f"[TP4] olmo-1b at {cfg.n_layers} layers over (data 2, model 2) "
          f"of cuda:0, 8 x 1024 as 2 microbatches a data position: loss "
          f"{first['loss']:.5f} vs unsplit {want['loss']:.5f} (rel "
          f"{rel['loss']:.3g}, tol {TP_LOSS_REL}), grad_norm "
          f"{first['grad_norm']:.5f} vs {want['grad_norm']:.5f} (rel "
          f"{rel['grad_norm']:.3g}, tol {TP_GNORM_REL}); losses {losses}; "
          f"step {', '.join(f'{t:.3f}' for t in times)} s (unsplit, cold "
          f"{whole_s:.3f} s), peak {peak / 2**30:.2f} GiB; image of "
          f"{len(image)} leaves in the unsplit layout: {image == layout}",
          flush=True)
    del split
    torch.cuda.empty_cache()
    if not (rel["loss"] <= TP_LOSS_REL and rel["grad_norm"] <= TP_GNORM_REL
            and all(math.isfinite(x) for x in losses) and image == layout):
        fail(f"TP4: {out}")
    return out


def phase_dryrun_on_card() -> dict:
    """DR1: the dry run for a (1, 1) mesh of cuda:0 at A3's prefill shape
    (olmo-1b, 8 x 1024) and D3's train shape (8 x 1024 in 2
    microbatches), on the meta device and then the same programs on the
    card under the same counter: the card's FLOPs (the flash kernel
    reporting its work) equal to the meta count, and the card's peak
    allocation within DR_PEAK_RANGE of the estimate.  Then one production
    cell on meta (gemma2-27b decode_32k, single pod)."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as D

    _require_free_card("DR1")
    mesh = _model_mesh((1, 1))
    rows, bad = {}, []
    for shape, micro in ((ShapeConfig("a3_prefill", OLMO_PROMPT, OLMO_BATCH,
                                      "prefill"), None),
                         (ShapeConfig("d3_train", OLMO_PROMPT, OLMO_BATCH,
                                      "train"), 2)):
        meta = D.run_cell(OLMO, None, shape=shape, mesh=mesh,
                          n_microbatches=micro)
        card = D.run_cell(OLMO, None, shape=shape, mesh=mesh,
                          n_microbatches=micro, device="cuda")
        torch.cuda.empty_cache()
        est = meta["memory_per_device"]["peak_estimate_bytes"]
        ratio = card["device_peak_bytes"] / est
        row = dict(meta_flops=meta["cost"]["dot_flops"],
                   card_flops=card["cost"]["dot_flops"],
                   kernel_flops=card["cost"]["kernel_flops"],
                   peak_estimate_bytes=est,
                   card_peak_bytes=card["device_peak_bytes"],
                   card_held_bytes=card["device_held_bytes"],
                   peak_ratio=ratio, meta_s=meta["run_seconds"],
                   card_s=card["run_seconds"],
                   meta_bytes=meta["cost"]["bytes_accessed"],
                   card_bytes=card["cost"]["bytes_accessed"],
                   memory=meta["memory_per_device"])
        rows[shape.name] = row
        print(f"[DR1] olmo-1b {shape.name} on a (1, 1) mesh: dot FLOPs meta "
              f"{row['meta_flops']:,.0f}, card {row['card_flops']:,.0f} "
              f"(the flash kernel reporting {row['kernel_flops']:,.0f}); "
              f"bytes meta {row['meta_bytes']:,.0f}, card "
              f"{row['card_bytes']:,.0f}; peak on the card "
              f"{row['card_peak_bytes'] / 2**30:.3f} GiB / estimate "
              f"{est / 2**30:.3f} GiB = {ratio:.4f} (range {DR_PEAK_RANGE}); "
              f"counted in {row['meta_s']:.1f} s on meta, "
              f"{row['card_s']:.1f} s on the card", flush=True)
        if row["meta_flops"] != row["card_flops"] or not (
                DR_PEAK_RANGE[0] <= ratio <= DR_PEAK_RANGE[1]):
            bad.append(shape.name)
    prods = {}
    for arch, cell in ((GEMMA, "decode_32k"),) + DR_DECODE_CELLS:
        t0 = time.monotonic()
        prod = D.run_cell(arch, cell, False)
        prod["wall_seconds"] = time.monotonic() - t0
        prods[f"{arch} {cell}"] = prod
        print(f"[DR1] production cell on meta: {json.dumps(prod, default=str)}",
              flush=True)
    out = dict(rows=rows, production=prods[f"{GEMMA} decode_32k"],
               productions=prods)
    REPORT["dryrun_on_card"] = out
    status = {k: p.get("status") for k, p in prods.items()}
    if bad or set(status.values()) != {"ok"}:
        fail(f"DR1: {bad}, production statuses {status}")
    return out


def _record_shard_calls(model, cfg, prompt, forced):
    """A split model's prefill and teacher-forced decode (:func:`_tp_serve`)
    with each SSD call of the first TP_SSD_CHECK_LAYERS layers (every
    shard's) held against ``ssd_scan_plain`` on its own inputs by S1's
    rule (y within SSD_Y_TOL, the state within SSD_F32_TOL) and each flash
    call against ``flash_attention_plain`` by A1's bf16 rule.  Returns
    (the logits, the SSD calls -- the checked ones with their gaps --,
    the flash calls' gaps)."""
    import torch

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as SSD

    ssd_calls, flash_calls = [], []
    ssd_launch, flash_launch = ops.ssd_scan, ops.flash_attention

    n_check = TP_SSD_CHECK_LAYERS * getattr(model, "extent", 1)

    def ssd_rec(x, dt, A, B, C, *, chunk, initial_state=None):
        if len(ssd_calls) >= n_check:
            ssd_calls.append(dict(shape=tuple(x.shape)))
            return ssd_launch(x, dt, A, B, C, chunk=chunk,
                              initial_state=initial_state)
        init = None if initial_state is None else initial_state.clone()
        y, st = ssd_launch(x, dt, A, B, C, chunk=chunk,
                           initial_state=initial_state)
        wy, wst = SSD.ssd_scan_plain(x, dt, A, B, C, chunk=chunk,
                                     initial_state=init)
        gy, gs = _gap(y, wy, SSD_Y_TOL), _gap(st, wst, SSD_F32_TOL)
        ssd_calls.append(dict(shape=tuple(x.shape), y=gy, state=gs,
                              ok=_ok(gy) and _ok(gs)))
        return y, st

    def flash_rec(q, k, v, **kw):
        got = flash_launch(q, k, v, **kw)
        g = _gap(got, FA.flash_attention_plain(q, k, v, **kw),
                 FLASH_TOL["bfloat16"])
        flash_calls.append(dict(shape=tuple(q.shape), **g,
                                ok=_flash_ok(g, torch.bfloat16)))
        return got

    with mock.patch.object(ops, "ssd_scan", ssd_rec), \
            mock.patch.object(ops, "flash_attention", flash_rec):
        logits, _ = _tp_serve(model, cfg, prompt, forced)
    return logits, ssd_calls, flash_calls


def _split_serve_counted(tag: str, cfg, split, prompt,
                         n_decode: int = TP_DECODE_STEPS) -> dict:
    """A split model's serving main path with the SSD and flash counts at
    0 just before and read just after: one prefill (cold), then
    ``n_decode`` greedy decode steps timed, the prefill's launches and
    the decode's apart; then a warm prefill timed; the peak."""
    import torch

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.serve.step import make_prefill_step, make_serve_step

    pre = make_prefill_step(cfg, max_seq=prompt.shape[1] + n_decode)
    srv = make_serve_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    SSD.LAUNCHES = FA.LAUNCHES = 0      # this split serving path starts here
    _zero(SSD.LAUNCHES_BY_ROUTE)
    _zero(FA.LAUNCHES_BY_ROUTE)
    t0 = time.monotonic()
    logits, cache = pre(split, {"tokens": prompt})
    torch.cuda.synchronize()
    cold = time.monotonic() - t0
    prefill = dict(ssd_scan=dict(SSD.LAUNCHES_BY_ROUTE),
                   flash_attention=dict(FA.LAUNCHES_BY_ROUTE))
    tok = logits[:, -1].argmax(-1)[:, None]
    t0 = time.monotonic()
    for _ in range(n_decode):
        logits, cache = srv(split, cache, {"tokens": tok})
        tok = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    dec = time.monotonic() - t0
    total = dict(ssd_scan=dict(SSD.LAUNCHES_BY_ROUTE),   # ... and ends here
                 flash_attention=dict(FA.LAUNCHES_BY_ROUTE))
    decode = {k: {r: total[k][r] - prefill[k][r] for r in total[k]}
              for k in total}
    peak = torch.cuda.max_memory_allocated()
    del cache, logits
    warm = []
    for _ in range(1):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = pre(split, {"tokens": prompt})
        torch.cuda.synchronize()
        warm.append(time.monotonic() - t0)
        del out
    return dict(prefill_launches=prefill, decode_launches=decode,
                prefill_s=[cold] + warm,
                decode_tok_s=prompt.shape[0] * n_decode / dec,
                decode_step_s=dec / n_decode, decode_steps=n_decode,
                peak_bytes=peak)


def _launch_line(run: dict) -> str:
    return (f"prefill launches {run['prefill_launches']}, decode launches "
            f"{run['decode_launches']}; prefill "
            f"{', '.join(f'{t:.4f}' for t in run['prefill_s'])} s (cold, "
            f"warm), decode {run['decode_tok_s']:.2f} tok/s "
            f"({run['decode_step_s']:.3f} s a step), peak "
            f"{run['peak_bytes'] / 2**30:.2f} GiB")


def phase_tp_zamba() -> dict:
    """TP5: zamba2-7b served whole at model extents 2 and 16 of cuda:0
    (16: 7 SSM heads and 2 attention heads a shard), batch 8, prompt 1024,
    the model drawn on the card, m = 2 freed before m = 16: exactly 81·m
    ``mma`` SSD calls and 13·m ``wgmma`` flash launches a prefill, none in
    decode (TP_DECODE_STEPS greedy steps timed at m = 2,
    TP_WIDE_DECODE_STEPS at 16); every shard's SSD calls
    of the first TP_SSD_CHECK_LAYERS layers against their plain version on
    their own inputs by S1's rule and each flash call by A1's bf16 rule; bf16 logits (prefill and
    TP_SPLIT_FORCED teacher-forced steps) against the unsplit kernel path
    by S4's floor rule with H3's relative RMS (the floor: the unsplit
    kernel path against the plain path); every shard's B and C conv carry
    bitwise equal; float32 at ZAMBA_F32_LAYERS layers at m = 2 within
    OLMO_F32_TOL.  The shards' SSD and flash calls timed at their shapes
    beside the bound (and SDPA for flash)."""
    import torch

    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.models import model as M

    _require_free_card("TP5")
    cfg, model, prompt = dense_setup("TP5", ZAMBA)
    n_uses = cfg.n_layers // cfg.shared_attn_every
    g = torch.Generator().manual_seed(2)
    forced = torch.randint(0, cfg.vocab, (OLMO_BATCH, TP_SPLIT_FORCED),
                           generator=g).cuda()
    whole, _ = _tp_serve(model, cfg, prompt, forced)
    plain, _ = _tp_serve(model, cfg.replace(use_flash_kernel=False), prompt,
                         forced)
    floor = _gap(whole, plain, LOGIT_TOL)
    del plain
    rows, bad = {}, []
    for m in TP_ZAMBA_EXTENTS:
        split = TP.split_model(model, _model_mesh((1, m)))
        if not split.ssm_split:
            fail(f"TP5: {ZAMBA} at m = {m}: the mixers are not split")
        run = _split_serve_counted("TP5", cfg, split, prompt,
                                   TP_DECODE_STEPS if m <= 2
                                   else TP_WIDE_DECODE_STEPS)
        want = dict(ssd_scan={"mma": cfg.n_layers * m, "simt": 0},
                    flash_attention={"wgmma": n_uses * m, "simt": 0})
        nothing = {k: {r: 0 for r in v} for k, v in want.items()}
        if run["prefill_launches"] != want or \
                run["decode_launches"] != nothing:
            bad.append(f"m={m}: launches {run['prefill_launches']} / decode "
                       f"{run['decode_launches']}, expected {want} a prefill")
        logits, ssd_calls, flash_calls = _record_shard_calls(
            split, cfg, prompt, forced)
        row = dict(run, ssd_calls=len(ssd_calls), flash_calls=len(flash_calls))
        checked = [c for c in ssd_calls if "ok" in c]
        row["ssd_checked"] = len(checked)
        row["ssd_worst"] = max(checked, key=lambda c: max(
            c["y"]["max_ratio"], c["state"]["max_ratio"]))
        row["flash_worst"] = max(flash_calls, key=lambda c: c["max_ratio"])
        row["calls_ok"] = len(ssd_calls) == cfg.n_layers * m and \
            len(checked) == TP_SSD_CHECK_LAYERS * m and \
            len(flash_calls) == n_uses * m and \
            all(c["ok"] for c in checked + flash_calls)
        row["bf16"] = _floor_rule(logits, whole, floor, moe=True)
        del split, logits, ssd_calls, flash_calls
        torch.cuda.empty_cache()
        row["ssd_shard"] = phase_ssd_measure(
            dict(ZAMBA_SSD_SHAPE, h=ZAMBA_SSD_SHAPE["h"] // m), f"TP5 m={m}")
        row["flash_shard"] = _tp_flash_shard_times(cfg, m)
        if not (row["calls_ok"] and row["bf16"]["ok"]
                and row["flash_shard"]["ok"]):
            bad.append(f"m={m}: SSD calls worst {row['ssd_worst']}, flash "
                       f"calls worst {row['flash_worst']}, logits "
                       f"{row['bf16']}")
        rows[m] = row
        sw, fw, fs = row["ssd_worst"], row["flash_worst"], row["flash_shard"]
        print(f"[TP5] {ZAMBA} over (1, {m}) of cuda:0: {_launch_line(run)}; "
              f"{row['ssd_calls']} shard SSD calls, {row['ssd_checked']} of "
              f"them (the first {TP_SSD_CHECK_LAYERS} layers') vs plain: "
              f"worst y "
              f"{sw['y']['max_ratio']:.3f} x {SSD_Y_TOL}, state "
              f"{sw['state']['max_ratio']:.3f} x {SSD_F32_TOL} at "
              f"{sw['shape']}; {row['flash_calls']} shard flash calls vs "
              f"plain: worst {fw['max_ratio']:.3f} x (2e-2 + 2e-2|b|), rel "
              f"RMS {fw['rel_rms']:.3g}; bf16 logits vs the unsplit kernel "
              f"path: max {row['bf16']['max_ratio']:.3f} x (limit "
              f"{row['bf16']['limit_ratio']:.3f}), rel RMS "
              f"{row['bf16']['rel_rms']:.4g} (limit "
              f"{row['bf16']['rms_limit']:.4g}); floor (unsplit kernel vs "
              f"plain) {floor['max_ratio']:.3f} x, rel RMS "
              f"{floor['rel_rms']:.4g}; shard flash {fs['shape']}: kernel "
              f"{fs['ms']:.4f} ms, plain {fs['plain_ms']:.4f}, SDPA "
              f"{fs['library_ms']:.4f}, bound {fs['bound_ms']:.4f} "
              f"({fs['bound_by']})", flush=True)
    # float32 at ZAMBA_F32_LAYERS layers, m = 2: the bf16 weights cast on
    # the card, float32 caches (the SIMT SSD kernel, _attention_core)
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32",
                        n_layers=ZAMBA_F32_LAYERS)
    model32 = M.HybridLM(cfg32)
    kept = {n for n, _ in model32.named_parameters()}
    model32.load_state_dict({n: t.float() for n, t in
                             model.named_parameters() if n in kept},
                            assign=True)
    del model
    torch.cuda.empty_cache()
    w32, _ = _tp_serve(model32, cfg32, prompt, forced, torch.float32)
    s32 = TP.split_model(model32, _model_mesh((1, TP_ZAMBA_EXTENTS[0])))
    l32, _ = _tp_serve(s32, cfg32, prompt, forced, torch.float32)
    f32 = _gap(l32, w32, OLMO_F32_TOL)
    print(f"[TP5] {ZAMBA} float32 at {ZAMBA_F32_LAYERS} layers over (1, "
          f"{TP_ZAMBA_EXTENTS[0]}) vs unsplit: max |d| {f32['max_abs']:.3g} "
          f"= {f32['max_ratio']:.4f} x ({OLMO_F32_TOL} + "
          f"{OLMO_F32_TOL}|b|)", flush=True)
    if not _ok(f32):
        bad.append(f"float32 {f32}")
    del model32, s32
    torch.cuda.empty_cache()
    out = dict(rows=rows, floor=floor, f32=f32)
    REPORT["tp_zamba"] = out
    if bad:
        fail(f"TP5: {bad}")
    return out


def phase_tp_mamba() -> dict:
    """TP6: mamba2-130m served whole at model extents 2 (a real split: 12
    SSM heads a shard, the vocabulary over the model axis) and 16 (the
    rules put nothing of it on the model axis: replicas), batch 8, prompt
    1024: exactly 24·m ``mma`` SSD calls a prefill, none in decode; bf16
    logits at m = 2 by S4's floor rule against the unsplit kernel path,
    every shard's B and C conv carry bitwise equal; at m = 16 the logits
    bitwise the unsplit kernel path's."""
    import torch

    from repro_torch.distributed import tensor_parallel as TP

    _require_free_card("TP6")
    cfg, model, prompt = dense_setup("TP6", ARCH)
    g = torch.Generator().manual_seed(2)
    forced = torch.randint(0, cfg.vocab, (OLMO_BATCH, TP_SPLIT_FORCED),
                           generator=g).cuda()
    whole, _ = _tp_serve(model, cfg, prompt, forced)
    plain, _ = _tp_serve(model, cfg.replace(use_flash_kernel=False), prompt,
                         forced)
    floor = _gap(whole, plain, LOGIT_TOL)
    rows, bad = {}, []
    for m in TP_MAMBA_EXTENTS:
        split = TP.split_model(model, _model_mesh((1, m)))
        run = _split_serve_counted("TP6", cfg, split, prompt)
        want = dict(ssd_scan={"mma": cfg.n_layers * m, "simt": 0},
                    flash_attention={"wgmma": 0, "simt": 0})
        nothing = {k: {r: 0 for r in v} for k, v in want.items()}
        if run["prefill_launches"] != want or \
                run["decode_launches"] != nothing:
            bad.append(f"m={m}: launches {run['prefill_launches']} / decode "
                       f"{run['decode_launches']}, expected {want}")
        logits, _ = _tp_serve(split, cfg, prompt, forced)
        row = dict(run, replicas=split.replicas, ssm_split=split.ssm_split)
        if split.replicas:
            row["bitwise"] = bool(torch.equal(logits, whole))
            ok = row["bitwise"]
            cmp = f"logits bitwise the unsplit kernel path's: {ok}"
        else:
            row["bf16"] = _floor_rule(logits, whole, floor, moe=False)
            ok = row["bf16"]["ok"] and split.ssm_split
            cmp = (f"bf16 logits vs the unsplit kernel path: max "
                   f"{row['bf16']['max_ratio']:.3f} x (limit "
                   f"{row['bf16']['limit_ratio']:.3f}), rel RMS "
                   f"{row['bf16']['rel_rms']:.4g}; floor "
                   f"{floor['max_ratio']:.3f} x")
        if (m == 16) != split.replicas or not ok:
            bad.append(f"m={m}: replicas {split.replicas}, {cmp}")
        rows[m] = row
        print(f"[TP6] {ARCH} over (1, {m}) of cuda:0 ("
              f"{'replicas' if split.replicas else 'split over its heads'}):"
              f" {_launch_line(run)}; {cmp}", flush=True)
        del split, logits
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    out = dict(rows=rows, floor=floor)
    REPORT["tp_mamba"] = out
    if bad:
        fail(f"TP6: {bad}")
    return out


def _cell_rules(cfg, shape, kind: str, batch: int, prompt: int,
                max_seq: int):
    """The rules of a prefill (``q_seq`` the prompt; a train cell's are
    the same) or a decode cell (``q_seq`` 1) of ``cfg`` at these sizes on
    a (data, model) mesh of ``shape``."""
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.distributed.sharding import resolve_rules
    from repro_torch.models import model as M

    return resolve_rules(Mesh(shape, ("data", "model")), M.sharding_dims(
        cfg, batch, kv_seq=max_seq, q_seq=prompt if kind != "decode" else 1))


ATTN_LAYOUT = {"prefill": "kv_seq", "decode": "head_dim"}


def _tp1_attn_layouts(dev: str, tol: float) -> tuple:
    """TP1's splits whose rules put no heads on the model axis, and the
    encdec family's: starcoder2 and qwen2-vl SMOKE over (1, 4) by a
    prefill cell's rules (``kv_seq``: the SIMT kernel with a diagonal
    offset and the rows' statistics a part) and a decode cell's
    (``head_dim``), whisper SMOKE over (1, 2) (its heads) and (1, 8)
    (``kv_seq``, ``head_dim``), float32 with the knob on: prefill and
    TP_FORCED teacher-forced steps, logits and gathered caches (the cross
    K/V too) within ``tol`` of the CPU's split run and of the card's
    unsplit run.  Returns (rows, the names that failed)."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import init_params

    rows, bad, made = {}, [], {}
    for arch, shape, kind in TP_ATTN_CASES:
        cfg = get_smoke_config(arch).replace(
            param_dtype="float32", compute_dtype="float32",
            use_flash_kernel=True)
        seq = TP_WHISPER_SEQ if cfg.family == "encdec" else TP_SEQ
        if arch not in made:
            here, cpu = init_params(0, cfg, device=dev), \
                init_params(0, cfg, device="cpu")
            g = torch.Generator().manual_seed(3)
            prompt = torch.randint(0, cfg.vocab, (4, seq), generator=g)
            forced = torch.randint(0, cfg.vocab, (4, TP_FORCED), generator=g)
            frames = torch.randn(4, cfg.enc_seq, cfg.d_model, generator=g) \
                if cfg.family == "encdec" else None
            fr = None if frames is None else frames.to(dev)
            lw, cw = _tp_serve(here, cfg, prompt.to(dev), forced.to(dev),
                               torch.float32, fr)
            made[arch] = (here, cpu, prompt, forced, frames, fr, lw, cw)
        here, cpu, prompt, forced, frames, fr, lw, cw = made[arch]
        rules = _cell_rules(cfg, shape, kind, 4, seq, seq + TP_FORCED)
        card = TP.split_model(here, _model_mesh(shape, dev), rules)
        host = TP.split_model(cpu, _model_mesh(shape, "cpu"), rules)
        want = "heads" if cfg.attention.n_heads % shape[1] == 0 and \
            cfg.attention.n_kv_heads % shape[1] == 0 else ATTN_LAYOUT[kind]
        modes = dict(FA.LAUNCHES_BY_MODE)
        lc, cc = _tp_serve(card, cfg, prompt.to(dev), forced.to(dev),
                           torch.float32, fr)
        by_mode = {k: FA.LAUNCHES_BY_MODE[k] - n for k, n in modes.items()}
        lp, cp = _tp_serve(host, cfg, prompt, forced, torch.float32, frames)
        row = dict(layout=card.attn_layout, launches_by_mode=by_mode,
                   vs_cpu=_gap(lc.cpu(), lp, tol),
                   cache_vs_cpu=_cache_gap(cc, cp, tol),
                   vs_unsplit=_gap(lc, lw, tol),
                   cache_vs_unsplit=_cache_gap(cc, cw, tol))
        # kv_seq: every part of the prefill through the kernel with its
        # statistics; head_dim: the plain path, no launch with statistics
        parts_ok = (by_mode["stats"] > 0) == (want == "kv_seq")
        row["ok"] = all(_ok(row[k]) for k in (
            "vs_cpu", "cache_vs_cpu", "vs_unsplit", "cache_vs_unsplit")) \
            and card.attn_layout == want and parts_ok
        name = f"{arch} {shape} {kind} rules"
        rows[name] = row
        print(f"[TP1] {name} ({card.attn_layout}) SMOKE float32 split: "
              f"logits vs the CPU's split run {row['vs_cpu']['max_abs']:.3g}, "
              f"vs the unsplit run {row['vs_unsplit']['max_abs']:.3g}; caches "
              f"{row['cache_vs_cpu']['max_abs']:.3g} / "
              f"{row['cache_vs_unsplit']['max_abs']:.3g} (tol {tol}); flash "
              f"launches by mode {by_mode}", flush=True)
        if not row["ok"]:
            bad.append(name)
        del card, host
    return rows, bad


def _carry(pre, dec, cache):
    """A serving cache from the prefill cell's split to the decode cell's:
    gathered into the unsplit layout, then cut by the decode split (the
    controller's work)."""
    return dec.split_cache(pre.gather_cache(cache))


def _two_rule_splits(cfg, model, m: int, batch: int, prompt: int,
                     max_seq: int) -> tuple:
    """``model`` split over (1, m) of cuda:0 by its prefill cell's rules
    and by its decode cell's."""
    from repro_torch.distributed import tensor_parallel as TP

    return tuple(TP.split_model(model, _model_mesh((1, m)), _cell_rules(
        cfg, (1, m), kind, batch, prompt, max_seq))
        for kind in ("prefill", "decode"))


def _two_rule_logits(cfg, pre, dec, prompt, forced, max_seq: int,
                     cache_dtype=None, frames=None, record: bool = False):
    """Prefill under ``pre`` into a cache of ``max_seq`` slots (the
    rules' sequence), the cache carried to ``dec``, the forced
    decode steps there: the logits stacked, and with ``record`` each flash
    call of the prefill against its plain version on its own q, k, v by
    A1's bf16 rule -- on o and, for a key part, on the statistics m and l."""
    import torch

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.serve.step import make_prefill_step, make_serve_step

    tol, calls, launch = FLASH_TOL["bfloat16"], [], FA.flash_attention

    def recorded(q, k, v, **kw):
        got = launch(q, k, v, **kw)
        want = FA.flash_attention_plain(q, k, v, **kw)
        pairs = zip(("o", "m", "l"), got, want) if kw.get("stats") else \
            [("o", got, want)]
        gaps = {n: _gap(a, b, tol) for n, a, b in pairs}
        calls.append(dict(shape=tuple(q.shape), skv=k.shape[1],
                          off=kw.get("off"), **gaps,
                          ok=all(_flash_ok(g, torch.bfloat16)
                                 for g in gaps.values())))
        return got

    pre_step = make_prefill_step(cfg, max_seq=max_seq,
                                 cache_dtype=cache_dtype or torch.bfloat16)
    srv = make_serve_step(cfg)
    with mock.patch.object(FA, "flash_attention", recorded) if record \
            else contextlib.nullcontext():
        logits, cache = pre_step(pre, _prompt_batch(prompt, frames))
    out = [logits[:, -1]]
    cache = _carry(pre, dec, cache)
    for k in range(forced.shape[1]):
        logits, cache = srv(dec, cache, {"tokens": forced[:, k:k + 1]})
        out.append(logits[:, -1])
    return torch.stack(out), calls


def _two_rule_serve_counted(cfg, pre, dec, prompt, max_seq: int,
                            n_decode: int, frames=None) -> dict:
    """The serving main path across two rule sets, the flash counts at 0
    just before and read just after: one prefill under the prefill cell's
    split (cold), the cache carried to the decode cell's split, then
    ``n_decode`` greedy decode steps timed there; the prefill's launches
    (by route and by mode) and the decode's apart; a warm prefill timed;
    the peak."""
    import torch

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.serve.step import make_prefill_step, make_serve_step

    pre_step = make_prefill_step(cfg, max_seq=max_seq)
    srv = make_serve_step(cfg)
    batch = _prompt_batch(prompt, frames)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FA.LAUNCHES = 0            # this two-rule serving path starts here
    _zero(FA.LAUNCHES_BY_ROUTE)
    _zero(FA.LAUNCHES_BY_MODE)
    t0 = time.monotonic()
    logits, cache = pre_step(pre, batch)
    torch.cuda.synchronize()
    cold = time.monotonic() - t0
    prefill = dict(route=dict(FA.LAUNCHES_BY_ROUTE),
                   mode=dict(FA.LAUNCHES_BY_MODE), total=FA.LAUNCHES)
    t0 = time.monotonic()
    cache = _carry(pre, dec, cache)
    torch.cuda.synchronize()
    carry = time.monotonic() - t0
    tok = logits[:, -1].argmax(-1)[:, None]
    t0 = time.monotonic()
    for _ in range(n_decode):
        logits, cache = srv(dec, cache, {"tokens": tok})
        tok = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    dec_s = time.monotonic() - t0
    decode = dict(route=dict(FA.LAUNCHES_BY_ROUTE),   # ... and ends here
                  mode=dict(FA.LAUNCHES_BY_MODE), total=FA.LAUNCHES)
    decode = {k: ({r: v - prefill[k][r] for r, v in decode[k].items()}
                  if isinstance(v, dict) else decode[k] - prefill[k])
              for k, v in decode.items()}
    peak = torch.cuda.max_memory_allocated()
    if not bool(((tok >= 0) & (tok < cfg.vocab)).all()):
        fail(f"{cfg.name}: a greedy token out of range")
    del cache, logits
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = pre_step(pre, batch)
    torch.cuda.synchronize()
    warm = time.monotonic() - t0
    del out
    return dict(prefill_launches=prefill, decode_launches=decode,
                prefill_s=[cold, warm], carry_s=carry,
                decode_tok_s=prompt.shape[0] * n_decode / dec_s,
                decode_step_s=dec_s / n_decode, decode_steps=n_decode,
                peak_bytes=peak)


def _f32_cut(cfg, model, enc_layers=None, layers=None):
    """The first ``layers`` (and ``enc_layers``) layers of ``model`` in
    float32: its bf16 weights cast on the card."""
    from repro_torch.models import model as M

    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32",
                        n_layers=layers, **({} if enc_layers is None else
                                            {"n_enc_layers": enc_layers}))
    model32 = M.model_class(cfg32)(cfg32)
    kept = {n for n, _ in model32.named_parameters()}
    model32.load_state_dict({n: t.float() for n, t in
                             model.named_parameters() if n in kept},
                            assign=True)
    return cfg32, model32


def _tp_two_rules(tag: str, arch: str, m: int, prompt_len: int,
                  n_tokens: int, n_decode: int, f32_layers: int,
                  want_launches: int, want_modes: dict) -> dict:
    """TP7 / TP8: ``arch`` at full width served over (1, m) of cuda:0
    across its two rule sets (prefill: ``kv_seq``; decode:
    ``head_dim``): the main path's launches (exactly ``want_launches``
    ``wgmma`` and ``want_modes`` a prefill, none in decode); each flash
    call of the prefill against its plain version by A1's bf16 rule on o
    and the statistics; bf16 logits (prefill + TP_SPLIT_FORCED forced
    steps) by S4's floor rule against the unsplit kernel path (the floor:
    the unsplit kernel path against the plain path); float32 at
    ``f32_layers`` layers (and as many encoder layers) within
    OLMO_F32_TOL; prefill s, decode tokens/s, peak."""
    import torch

    from repro_torch.launch.serve import audio_frames

    _require_free_card(tag)
    cfg, model, prompt = dense_setup(tag, arch, prompt_len)
    frames = audio_frames(cfg, prompt.shape[0]).cuda() \
        if cfg.family == "encdec" else None
    max_seq = prompt_len + n_tokens
    g = torch.Generator().manual_seed(2)
    forced = torch.randint(0, cfg.vocab, (OLMO_BATCH, TP_SPLIT_FORCED),
                           generator=g).cuda()
    whole, _ = _tp_serve(model, cfg, prompt, forced, frames=frames)
    plain, _ = _tp_serve(model, cfg.replace(use_flash_kernel=False), prompt,
                         forced, frames=frames)
    floor = _gap(whole, plain, LOGIT_TOL)
    del plain
    pre, dec = _two_rule_splits(cfg, model, m, OLMO_BATCH, prompt_len,
                                max_seq)
    layouts = (pre.attn_layout, dec.attn_layout)
    run = _two_rule_serve_counted(cfg, pre, dec, prompt, max_seq, n_decode,
                                  frames)
    want = dict(route={"wgmma": want_launches, "simt": 0},
                mode=want_modes, total=want_launches)
    nothing = dict(route={"wgmma": 0, "simt": 0},
                   mode={"offset": 0, "stats": 0}, total=0)
    bad = []
    if layouts != ("kv_seq", "head_dim"):
        bad.append(f"layouts {layouts}")
    if run["prefill_launches"] != want or run["decode_launches"] != nothing:
        bad.append(f"launches {run['prefill_launches']} / decode "
                   f"{run['decode_launches']}, expected {want} a prefill")
    logits, calls = _two_rule_logits(cfg, pre, dec, prompt, forced, max_seq,
                                     frames=frames, record=True)
    worst = {n: max((c for c in calls if n in c),
                    key=lambda c: c[n]["max_ratio"]) for n in ("o", "m", "l")}
    n_calls = len(calls)
    calls_ok = n_calls == want_launches and all(c["ok"] for c in calls)
    bf16 = _floor_rule(logits, whole, floor, moe=False)
    if not (calls_ok and bf16["ok"]):
        bad.append(f"calls worst {worst}, logits {bf16}")
    del pre, dec, logits, calls
    torch.cuda.empty_cache()
    # float32 at f32_layers layers: the bf16 weights cast on the card,
    # float32 caches (the SIMT kernel takes the parts)
    cfg32, model32 = _f32_cut(
        cfg, model, f32_layers if cfg.family == "encdec" else None,
        f32_layers)
    del model, whole
    torch.cuda.empty_cache()
    w32, _ = _tp_serve(model32, cfg32, prompt, forced, torch.float32, frames)
    p32, d32 = _two_rule_splits(cfg32, model32, m, OLMO_BATCH, prompt_len,
                                max_seq)
    l32, _ = _two_rule_logits(cfg32, p32, d32, prompt, forced, max_seq,
                              torch.float32, frames)
    f32 = _gap(l32, w32, OLMO_F32_TOL)
    if not _ok(f32):
        bad.append(f"float32 {f32}")
    del model32, p32, d32, frames
    torch.cuda.empty_cache()
    out = dict(run, layouts=layouts, calls=n_calls,
               call_worst={n: {k: w[k] for k in ("shape", "skv", "off")}
                           | {k: w[n][k] for k in ("max_abs", "max_ratio",
                                                   "rel_rms")}
                           for n, w in worst.items()},
               bf16=bf16, floor=floor, f32=f32, f32_layers=f32_layers)
    wo = out["call_worst"]
    print(f"[{tag}] {arch} over (1, {m}) of cuda:0, prefill by {layouts[0]}, "
          f"decode by {layouts[1]}: {_launch_line(run)}; cache carried in "
          f"{run['carry_s']:.4f} s; {want_launches} prefill calls vs plain: "
          f"worst o {wo['o']['max_ratio']:.3f} x, m "
          f"{wo['m']['max_ratio']:.3f} x, l {wo['l']['max_ratio']:.3f} x "
          f"(2e-2 + 2e-2|b|), o's rel RMS {wo['o']['rel_rms']:.3g}; bf16 "
          f"logits vs the unsplit kernel path: max {bf16['max_ratio']:.3f} x "
          f"(limit {bf16['limit_ratio']:.3f}), rel RMS "
          f"{bf16['rel_rms']:.4g}; floor (unsplit kernel vs plain) "
          f"{floor['max_ratio']:.3f} x, rel RMS {floor['rel_rms']:.4g}; "
          f"float32 at {f32_layers} layers: max |d| {f32['max_abs']:.3g} = "
          f"{f32['max_ratio']:.4f} x ({OLMO_F32_TOL} + {OLMO_F32_TOL}|b|)",
          flush=True)
    if bad:
        fail(f"{tag}: {bad}")
    return out


def phase_tp_starcoder2() -> dict:
    """TP7: starcoder2-3b at full width over model extent 4 of cuda:0,
    batch 8, prompt 1024, 32 tokens (max_seq 1,056), decode timed over 8
    steps.  The prefill cell's rules give ``kv_seq`` (T = 264 slots a
    part; the 4 parts hold 264/264/264/232 prompt keys), the decode
    cell's ``head_dim`` (32 channels a shard): exactly 30 x 4 = 120
    ``wgmma`` launches a prefill, each with its diagonal offset and its
    statistics, none in decode (:func:`_tp_two_rules`)."""
    from repro_torch.configs import get_config

    n = get_config(STARCODER).n_layers * TP7_M
    out = _tp_two_rules("TP7", STARCODER, TP7_M, OLMO_PROMPT, OLMO_TOKENS,
                        TP7_DECODE_STEPS, TP7_F32_LAYERS, n,
                        {"offset": n, "stats": n})
    REPORT["tp_starcoder2"] = out
    return out


def phase_tp_whisper() -> dict:
    """TP8: whisper-large-v3 at full width over model extent 16 of cuda:0,
    frames 8 x 1,500 x 1,280, prompt 128, 32 tokens (max_seq 160), decode
    timed over 4 steps.  The prefill cell's rules give ``mlp`` and
    ``kv_seq``: the encoder's 1,500 frames in 12 parts of 94 and 4 of 93
    (unmasked, statistics), the decoder's self-attention in parts of 10
    slots of which 13 hold prompt keys (offset and statistics), the
    cross-attention whole on every position; the decode cell's
    ``head_dim`` (4 channels a shard).  Launches a prefill: 32 x 16 + 32 x
    13 + 32 x 16 = 1,440 ``wgmma``, 928 with statistics and 416 with an
    offset; none in decode (:func:`_tp_two_rules`)."""
    import math as _m

    from repro_torch.configs import get_config

    cfg = get_config("whisper-large-v3")
    max_seq = WHISPER_PROMPT + OLMO_TOKENS
    T = max_seq // TP8_M
    held = _m.ceil(WHISPER_PROMPT / T)                 # parts holding keys
    enc, self_, cross = (cfg.n_enc_layers * TP8_M, cfg.n_layers * held,
                         cfg.n_layers * TP8_M)
    print(f"[TP8] expected flash launches a prefill: encoder {enc} "
          f"({cfg.n_enc_layers} x {TP8_M} parts), decoder self {self_} "
          f"({cfg.n_layers} x {held} parts of {T} slots holding prompt "
          f"keys), cross {cross} (whole on every position) = "
          f"{enc + self_ + cross}", flush=True)
    out = _tp_two_rules("TP8", "whisper-large-v3", TP8_M, WHISPER_PROMPT,
                        OLMO_TOKENS, TP8_DECODE_STEPS, TP8_F32_LAYERS,
                        enc + self_ + cross,
                        {"offset": self_, "stats": enc + self_})
    REPORT["tp_whisper"] = out
    return out


def phase_part_times() -> dict:
    """The flash kernel's offset and statistics mode at two part shapes
    of TP7 and TP8, bf16, by CUDA events: a starcoder2-3b part (16, 12,
    1024, 264, 128), causal with ``off = -264 j`` for j = 0 ... 3, and a
    whisper-large-v3 encoder part (160, 1, 1500, 94, 64), unmasked; the
    kernel with its statistics, its plain version and SDPA under the same
    explicit mask, beside the bound (the bytes of q, k, v, o, m and l;
    the operations of the pairs the mask leaves)."""
    import torch

    from repro_torch.kernels import flash_attention as FA

    rows, bad = {}, []
    for name, (bg, r, sq, skv, d), causal, offs in (
            (f"{STARCODER} part", (16, 12, 1024, 264, 128), True,
             (0, -264, -528, -792)),
            ("whisper-large-v3 encoder part", (160, 1, 1500, 94, 64), False,
             (None,))):
        q, k, v = flash_inputs(bg, r, sq, skv, d, torch.bfloat16, 700)
        scale = d ** -0.5
        for off in offs:
            kw = dict(scale=scale, causal=causal, off=off, stats=True)
            got = FA.flash_attention(q, k, v, **kw)
            want = FA.flash_attention_plain(q, k, v, **kw)
            gaps = {n: _gap(a, b, FLASH_TOL["bfloat16"])
                    for n, a, b in zip(("o", "m", "l"), got, want)}
            ms = min(cuda_ms(lambda: FA.flash_attention(q, k, v, **kw), 20)
                     for _ in range(2))
            plain_ms = cuda_ms(lambda: FA.flash_attention_plain(q, k, v,
                                                                **kw), 3)
            mask = FA._visible(sq, skv, q.device, off) if causal else None
            lib_ms = cuda_ms(lambda: _sdpa(q, k, v, scale, False, mask), 20)
            b = flash_bound(bg, r, sq, skv, d, None, causal, off, True)
            key = name if off is None else f"{name}, off {off}"
            rows[key] = dict(
                shape=(bg, r, sq, skv, d), causal=causal, off=off, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                max_abs_err=max(g["max_abs"] for g in gaps.values()),
                ok=all(_flash_ok(g, torch.bfloat16) for g in gaps.values()))
            print(f"[TP7-TP8] flash kernel, offset and statistics mode, "
                  f"{key} {(bg, r, sq, skv, d)} bf16: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f}, SDPA (same mask) {lib_ms:.4f}, "
                  f"bound {b['bound_ms']:.4f} ({b['bound_by']}); vs plain: "
                  f"o {gaps['o']['max_ratio']:.3f} x, m "
                  f"{gaps['m']['max_ratio']:.3f} x, l "
                  f"{gaps['l']['max_ratio']:.3f} x", flush=True)
            if not rows[key]["ok"]:
                bad.append(key)
        del q, k, v
    torch.cuda.empty_cache()
    REPORT["flash_part_times"] = rows
    if bad:
        fail(f"TP7-TP8 part shapes: {bad}")
    return rows


def tp_phases() -> dict:
    """DR1 and TP1-TP8, their seconds lapped."""
    out = dict(dryrun=phase_dryrun_on_card())
    _lap("DR1")
    out["smoke"] = phase_tp_smoke()
    _lap("TP1")
    out["olmo"] = phase_tp_olmo()
    _lap("TP2")
    out["olmoe"] = phase_tp_olmoe()
    _lap("TP3")
    out["train"] = phase_tp_train()
    _lap("TP4")
    out["zamba"] = phase_tp_zamba()
    _lap("TP5")
    out["mamba"] = phase_tp_mamba()
    _lap("TP6")
    out["starcoder2"] = phase_tp_starcoder2()
    _lap("TP7")
    out["whisper"] = phase_tp_whisper()
    _lap("TP8")
    out["parts"] = phase_part_times()
    _lap("TP7-TP8 part shapes")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    # float32 products in full float32 on the card (the references' setting)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    quick = "--quick" in sys.argv[1:]
    _lap(None)
    phase_env()
    phase_build()
    _lap("1-2")
    phase_lint()
    _lap("L1")
    from repro_torch.kernels import (ckpt_quant, flash_attention, sim_step,
                                     ssd_scan)

    if "--moe" in sys.argv[1:]:
        moe = moe_phases()
        _dump()
        print(json.dumps({"moe": True, "m5_launches": moe["train_launches"]}))
        return 0
    if "--hybrid" in sys.argv[1:]:
        hybrid = hybrid_phases(standalone=True)
        _dump()
        print(json.dumps({"hybrid": True,
                          "h3_launches": hybrid["serve"]["launches_by_route"],
                          "h5_launches": hybrid["train_launches"]}))
        return 0
    if "--encdec" in sys.argv[1:]:
        encdec = encdec_phases()
        _dump()
        print(json.dumps({"encdec": True,
                          "e3_launches": encdec["serve"]["launches_by_route"],
                          "e5_launches": encdec["train_launches"]}))
        return 0
    if "--tp" in sys.argv[1:]:
        tp = tp_phases()
        _dump()
        print(json.dumps({"tp": True, "tp2_launches": {
            m: r["launches_by_route"] for m, r in tp["olmo"]["rows"].items()},
            "tp3_launches": tp["olmoe"]["launches_by_route"],
            "tp5_launches": {m: r["prefill_launches"]
                             for m, r in tp["zamba"]["rows"].items()},
            "tp6_launches": {m: r["prefill_launches"]
                             for m, r in tp["mamba"]["rows"].items()},
            "tp7_launches": tp["starcoder2"]["prefill_launches"],
            "tp8_launches": tp["whisper"]["prefill_launches"]}))
        return 0
    if "--shard" in sys.argv[1:]:
        shard = shard_phases()
        _dump()
        print(json.dumps({"shard": True, "c1_launches": {
            n: r["launches"] for n, r in shard["cells"]["fleet"].items()}}))
        return 0

    # 2 chunks of 128 steps from each start (4 until TP7-TP8 needed the time)
    worst = phase_kernel_vs_plain(256 if quick else 4096, 2,
                                  64 if quick else 128)
    phase_across_devices()
    phase_perpeer_across_devices()
    phase_ssd_kernel_vs_plain()
    s2 = phase_serve_card_vs_cpu()
    quant_worst = phase_quant_kernel_vs_plain()
    phase_train_card_vs_cpu()
    phase_flash_kernel_vs_plain()
    a2 = phase_olmo_card_vs_cpu()
    v1 = phase_variant_flash_vs_plain()
    v2 = phase_variants_card_vs_cpu()
    _lap("3-4, G1, S1-S2, T1-T2, A1-A2, V1-V2")
    if quick:
        _dump()
        print(json.dumps({"quick": True}))
        return 0
    sim_step.LAUNCHES = 0          # the engine's main path starts here
    _zero(sim_step.LAUNCHES_BY_ROUTE)
    sim_step.LAUNCHES_BY_VARIANT.clear()
    phase_fig4()
    fleet_run = phase_fleet(10_000)
    launches = sim_step.LAUNCHES   # ... and ends here
    sim_by_route = dict(sim_step.LAUNCHES_BY_ROUTE)
    sim_by_variant = dict(sim_step.LAUNCHES_BY_VARIANT)
    REPORT["main_path_launches"] = launches
    REPORT["main_path_launches_by_route"] = sim_by_route
    REPORT["main_path_launches_by_variant"] = sim_by_variant
    print(f"[6] main path (Fig. 4 static + dynamic, fleet grid): "
          f"{launches} sim_step launches, by route {sim_by_route}, by "
          f"variant (store, het, shock, pm) {sim_by_variant}", flush=True)
    if launches != MAIN_PATH_SIM_STEP_LAUNCHES or \
            sim_by_route["philox"] != launches:
        fail(f"the main path launched sim_step {launches} times "
             f"({sim_by_route}), expected {MAIN_PATH_SIM_STEP_LAUNCHES}, all "
             f"with the draws made in the kernel")
    _lap("5-6")
    # The rest of the paper's main path: the per-peer gossip sweep (no
    # sim_step launch: its counts are zeroed and read inside), the three
    # sweeps through the kernel (their counts likewise), the entry point.
    gossip = phase_gossip_sweep()
    sweeps = phase_kernel_sweeps()
    phase_entry_point()
    _lap("G2-G4")
    # The digital twin; the workflow main path (W2, W3) with the counts at
    # 0 just before it.
    wf_batches = phase_workflow_across_devices()
    _lap("W1")
    sim_step.LAUNCHES = 0          # the workflow main path starts here
    _zero(sim_step.LAUNCHES_BY_ROUTE)
    sim_step.LAUNCHES_BY_VARIANT.clear()
    wf_runs, batches = phase_workflow_example()
    wf_batches.update(batches)
    _lap("W2")
    # W2's CPU run, in a worker while W3 waits on the disk
    cpu_ref = start_w2_cpu_reference()
    phase_twin_execute()
    wf_launches = dict(total=sim_step.LAUNCHES,   # ... and ends here
                       by_route=dict(sim_step.LAUNCHES_BY_ROUTE),
                       by_variant=dict(sim_step.LAUNCHES_BY_VARIANT))
    REPORT["workflow_main_path_launches"] = wf_launches
    print(f"[W3] workflow main path (W2's example DAG runs and W3's "
          f"digital twin): sim_step launches {wf_launches}", flush=True)
    if wf_launches["total"] == 0 or wf_launches["by_route"]["pregenerated"] \
            or not {"0000", "1100"} <= set(wf_launches["by_variant"]):
        fail("the workflow main path did not launch sim_step on the Philox "
             "route with variants 0000 and 1100")
    phase_workflow_example_vs_cpu(wf_runs, cpu_ref)
    _lap("W3, W2 vs CPU")
    phase_power_iter()
    _lap("W4")
    phase_policy_across_devices()
    _lap("P1")
    phase_policy_scale()
    _lap("P2")
    cfg, model, prompt = serve_setup()
    ssd_scan.LAUNCHES = 0          # the serving main path starts here
    _zero(ssd_scan.LAUNCHES_BY_ROUTE)
    serve_run = phase_serve(cfg, model, prompt, SERVE_TOKENS)
    ssd_launches = ssd_scan.LAUNCHES   # ... and ends here
    ssd_by_route = dict(ssd_scan.LAUNCHES_BY_ROUTE)
    REPORT["serve_main_path_launches"] = ssd_launches
    REPORT["serve_main_path_launches_by_route"] = ssd_by_route
    print(f"[S3] serving main path (greedy_generate, one prefill of "
          f"{cfg.n_layers} layers): {ssd_launches} ssd_scan launches, by "
          f"route {ssd_by_route}", flush=True)
    if ssd_launches != cfg.n_layers or ssd_by_route["mma"] != cfg.n_layers:
        fail(f"the serving main path launched ssd_scan {ssd_launches} "
             f"times ({ssd_by_route}), expected {cfg.n_layers} (one per "
             f"layer), all on the tensor-core route")
    REPORT["serve"] = phase_serve_measure("S3", cfg, model, prompt,
                                          serve_run, SERVE_TOKENS,
                                          "ssd_chunked")
    kp, pp = min(REPORT["serve"]["prefill_s"]), min(
        REPORT["serve"]["plain_prefill_s"])
    REPORT["serve"]["kernel_path_no_slower"] = kp <= pp
    print(f"[S3] mamba2-130m prefill, best of the warm runs: kernel path "
          f"{kp:.4f} s, plain ssd_chunked path {pp:.4f} s: the kernel path "
          f"is {'no slower' if kp <= pp else 'SLOWER'}", flush=True)
    logits_vs_plain = phase_serve_vs_plain(cfg, model, prompt, serve_run)
    REPORT["serve_profile"] = phase_serve_profile(
        "S5", cfg, model, prompt, SERVE_TOKENS,
        SSD_KERNEL_NAMES)
    del model
    torch.cuda.empty_cache()
    _lap("S3-S5")
    cfg, model, prompt = olmo_setup()
    flash_attention.LAUNCHES = 0   # the dense serving main path starts here
    _zero(flash_attention.LAUNCHES_BY_ROUTE)
    olmo_run = phase_serve(cfg, model, prompt, OLMO_TOKENS)
    flash_launches = flash_attention.LAUNCHES   # ... and ends here
    flash_by_route = dict(flash_attention.LAUNCHES_BY_ROUTE)
    REPORT["olmo_main_path_launches"] = flash_launches
    REPORT["olmo_main_path_launches_by_route"] = flash_by_route
    print(f"[A3] dense serving main path (greedy_generate on olmo-1b, one "
          f"prefill of {cfg.n_layers} layers and {OLMO_TOKENS - 1} decode "
          f"steps): {flash_launches} flash_attention launches, by route "
          f"{flash_by_route}", flush=True)
    if flash_launches != cfg.n_layers or \
            flash_by_route["wgmma"] != cfg.n_layers:
        fail(f"the dense serving main path launched flash_attention "
             f"{flash_launches} times ({flash_by_route}), expected "
             f"{cfg.n_layers} (one per layer, prefill only), all on the "
             f"tensor-core route")
    REPORT["olmo_serve"] = phase_serve_measure("A3", cfg, model, prompt,
                                               olmo_run, OLMO_TOKENS,
                                               "_attention_core")
    olmo_vs_plain = phase_dense_vs_plain("A4", cfg, model, prompt, olmo_run)
    REPORT["olmo_profile"] = phase_serve_profile(
        "A5", cfg, model, prompt, OLMO_TOKENS,
        FLASH_KERNEL_NAMES)
    del model, olmo_run
    torch.cuda.empty_cache()
    _lap("A3-A5")
    # The dense variants' serving main paths, the flash counts at 0 just
    # before each and read just after (inside serve_variant).
    variants = {GEMMA: serve_variant("V3", GEMMA, f32_layers=V4_F32_LAYERS,
                                     profile=True)}
    _lap("V3-V5")
    for arch in V6_ARCHS:
        variants[arch] = serve_variant("V6", arch)
    _lap("V6")
    # Held against the plain step: each variant the main path ran, at its
    # shapes (the checks fail the run on any mismatch).
    phase_fig4_vs_plain()
    fleet = phase_fleet_measure(fleet_run)
    sweeps_vs_plain = phase_sweeps_vs_plain(sweeps["cells"])
    wf_vs_plain = phase_workflow_vs_plain(wf_batches)
    _lap("7 and W5")
    ssd = phase_ssd_measure()
    flash = phase_flash_measure()
    vflash = phase_variant_flash_measure()
    _lap("S6, A6, V7")
    # The training main path: counts to 0 just before, read just after.
    ckpt_root = ROOT / ".smoke_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    for k in ckpt_quant.LAUNCHES:
        ckpt_quant.LAUNCHES[k] = 0
    sim_step.LAUNCHES = ssd_scan.LAUNCHES = flash_attention.LAUNCHES = 0
    try:
        train_run = phase_train(str(ckpt_root / "run"))
        quant_launches = dict(ckpt_quant.LAUNCHES)
        other = dict(sim_step=sim_step.LAUNCHES, ssd_scan=ssd_scan.LAUNCHES,
                     flash_attention=flash_attention.LAUNCHES)
        REPORT["train_main_path_launches"] = dict(quant_launches, **other)
        print(f"[T3] training main path: launches {quant_launches} (3 "
              f"compress_grads calls over {train_run['n_leaves']} leaves), "
              f"{other} (training runs ssd_chunked)", flush=True)
        if min(quant_launches.values()) < 1:
            fail("the training main path launched no ckpt_quant kernel")
        phase_train_measure(train_run)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    _lap("T3-T4")
    quant = phase_quant_measure()
    _lap("T4 quant")
    phase_dense_train_card_vs_cpu()
    _lap("D1")
    torch.cuda.empty_cache()
    # The dense training main path: counts to 0 just before, read just after.
    shutil.rmtree(ckpt_root, ignore_errors=True)
    for k in ckpt_quant.LAUNCHES:
        ckpt_quant.LAUNCHES[k] = 0
    sim_step.LAUNCHES = ssd_scan.LAUNCHES = flash_attention.LAUNCHES = 0
    try:
        dense_run = phase_dense_train(str(ckpt_root / "dense"))
        dense_quant_launches = dict(ckpt_quant.LAUNCHES)
        other = dict(sim_step=sim_step.LAUNCHES, ssd_scan=ssd_scan.LAUNCHES,
                     flash_attention=flash_attention.LAUNCHES)
        REPORT["dense_train_main_path_launches"] = dict(dense_quant_launches,
                                                        **other)
        print(f"[D2] dense training main path: launches "
              f"{dense_quant_launches} (3 compress_grads calls over "
              f"{dense_run['n_leaves']} leaves), {other} (training runs "
              f"_attention_core)", flush=True)
        if min(dense_quant_launches.values()) < 1 or any(other.values()):
            fail("the dense training main path launched no ckpt_quant "
                 "kernel, or launched another kernel")
        dense_quant_worst = phase_dense_quant_vs_plain(dense_run)[
            "max_abs_err"]
        phase_dense_train_measure(dense_run)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    torch.cuda.empty_cache()
    _lap("D2-D3")
    dense_quant = phase_quant_measure(OLMO_EMBED_LEAF, "D3",
                                      "olmo-1b's embedding leaf")
    phase_ft_example()
    _lap("D3 quant, D4")
    shard = shard_phases(fleet_run["res"])
    moe = moe_phases()
    hybrid = hybrid_phases(standalone=False)
    encdec = encdec_phases()
    tp = tp_phases()
    bound = max(fleet["bound_bytes_ms"], fleet["bound_ops_ms"])
    fig4_kernel = {name: {"philox_ms": REPORT[name]["kernel"]["philox_ms"],
                          "pregenerated_ms":
                              REPORT[name]["kernel"]["pregenerated_ms"],
                          "generated_then_pregenerated_ms":
                              REPORT[name]["kernel"][
                                  "generated_then_pregenerated_ms"],
                          "compare_grid_s": REPORT[name]["seconds"]}
                   for name in ("fig4_static", "fig4_dynamic")}
    ssd_rows, flash_rows = (REPORT["ssd_kernel_vs_plain"],
                            REPORT["flash_kernel_vs_plain"])

    def worst_of(rows, how, keys):
        return max(r[k]["max_abs"] if k else r["max_abs"]
                   for r in rows if r["route"] == how for k in keys)

    ssd_logits = {
        "bf16_rel_rms": logits_vs_plain["bf16"]["rel_rms"],
        "bf16_max_abs": logits_vs_plain["bf16"]["max_abs"],
        "bf16_max_ratio": logits_vs_plain["bf16"]["max_ratio"],
        "bf16_floor_max_ratio":
            logits_vs_plain["bf16_plain_vs_plain"]["max_ratio"],
        "f32_max_abs": logits_vs_plain["f32"]["max_abs"]}
    flash_logits = {
        "bf16_rel_rms": olmo_vs_plain["bf16"]["rel_rms"],
        "bf16_max_abs": olmo_vs_plain["bf16"]["max_abs"],
        "bf16_max_ratio": olmo_vs_plain["bf16"]["max_ratio"],
        "bf16_floor_max_ratio":
            olmo_vs_plain["bf16_plain_vs_plain"]["max_ratio"],
        "f32_max_abs": olmo_vs_plain["f32"]["max_abs"]}
    olmo_t, gqa_t = flash["olmo-1b prefill"], flash["GQA serving"]
    tc_by_path = {"olmo-1b": flash_by_route["wgmma"], **{
        arch: r["launches_by_route"]["wgmma"] for arch, r in variants.items()},
        **{arch: moe["serve"][arch]["launches_by_route"]["wgmma"]
           for arch in MOE_ARCHS},
        ZAMBA: hybrid["serve"]["launches_by_route"]["flash_attention"][
            "wgmma"],
        WHISPER: encdec["serve"]["launches_by_route"]["wgmma"],
        **{f"olmo-1b split over (1, {m}) (TP2)":
           r["launches_by_route"]["wgmma"]
           for m, r in tp["olmo"]["rows"].items() if m > 1},
        "olmoe-1b-7b split over (1, 2) (TP3)":
            tp["olmoe"]["launches_by_route"]["wgmma"],
        **{f"zamba2-7b split over (1, {m}) (TP5)":
           r["prefill_launches"]["flash_attention"]["wgmma"]
           for m, r in tp["zamba"]["rows"].items()},
        f"starcoder2-3b over (1, {TP7_M}), kv_seq (TP7)":
            tp["starcoder2"]["prefill_launches"]["route"]["wgmma"],
        f"whisper-large-v3 over (1, {TP8_M}), kv_seq (TP8)":
            tp["whisper"]["prefill_launches"]["route"]["wgmma"]}
    tc_by_mode = {f"{name} ({tag})": tp[key]["prefill_launches"]["mode"]
                  for name, tag, key in (("starcoder2-3b", "TP7", "starcoder2"),
                                         ("whisper-large-v3", "TP8",
                                          "whisper"))}
    simt_by_path = {"olmo SMOKE float32 (A2)": a2["launches_by_route"]["simt"],
                    "variants' SMOKE float32 (V2)":
                        v2["launches_by_route"]["simt"],
                    "moe SMOKE float32 (M1)":
                        moe["card_vs_cpu"]["launches_by_route"]["simt"],
                    "zamba2 SMOKE float32 (H1)":
                        hybrid["card_vs_cpu"]["launches_by_route"][
                            "flash_attention"]["simt"],
                    "whisper SMOKE float32 (E1)":
                        encdec["card_vs_cpu"]["launches_by_route"]["simt"],
                    "split SMOKE float32 (TP1)":
                        tp["smoke"]["launches_by_route"]["simt"]}
    hybrid_ssd = hybrid["serve"]["launches_by_route"]["ssd_scan"]
    split_ssd = {**{f"zamba2-7b split over (1, {m}) (TP5)":
                    r["prefill_launches"]["ssd_scan"]["mma"]
                    for m, r in tp["zamba"]["rows"].items()},
                 **{f"mamba2-130m over (1, {m}) (TP6)":
                    r["prefill_launches"]["ssd_scan"]["mma"]
                    for m, r in tp["mamba"]["rows"].items()}}
    split_ssd_shapes = {f"zamba2-7b shard at model extent {m} (TP5)": dict(
        {k: r["ssd_shard"][k] for k in (
            "shape", "ms", "simt_ms", "plain_ms", "bound_ms", "bound_by",
            "f32_simt_bound_ms")}, calls_worst=r["ssd_worst"])
        for m, r in tp["zamba"]["rows"].items()}
    hv = hybrid["serve"]["vs_plain"]
    hybrid_logits = {
        "bf16_rel_rms": hv["bf16"]["rel_rms"],
        "bf16_rms_limit": hv["bf16"]["rms_limit"],
        "bf16_max_ratio": hv["bf16"]["max_ratio"],
        "bf16_floor_max_ratio": hv["bf16_plain_vs_plain"]["max_ratio"],
        "bf16_floor_rel_rms": hv["bf16_plain_vs_plain"]["rel_rms"],
        "f32_max_abs": hv["f32"]["max_abs"]}
    zamba_flash = dict({k: hybrid["flash"][k] for k in (
        "shape", "scale", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms")}, max_abs_err=v1[ZAMBA]["max_abs"],
        scale_check=v1[ZAMBA]["scale_check"],
        logits_vs_plain_path=hybrid_logits)
    ev = encdec["serve"]["vs_plain"]
    whisper_flash = {name: {k: r[k] for k in (
        "shape", "causal", "max_abs_err", "ms", "plain_ms", "bound_ms",
        "bound_by", "library_ms")} for name, r in encdec["flash"].items()}
    whisper_flash["logits_vs_plain_path"] = {
        "bf16_rel_rms": ev["bf16"]["rel_rms"],
        "bf16_rms_limit": ev["bf16"]["rms_limit"],
        "bf16_max_ratio": ev["bf16"]["max_ratio"],
        "bf16_floor_max_ratio": ev["bf16_plain_vs_plain"]["max_ratio"],
        "f32_max_abs": ev["f32"]["max_abs"],
        "prefill_calls_worst_ratio": ev["flash_worst_ratio_by_kind"]}
    variant_rows = {arch: {
        k: r[k] for k in ("shape", "softcap", "ms", "plain_ms", "bound_ms",
                          "bound_by", "library_ms", "library_note")}
        for arch, r in vflash.items()}
    for arch, row in variant_rows.items():
        row["max_abs_err"] = v1[arch]["max_abs"]
        if arch == GEMMA:
            row["at_the_cap"] = {k: v1[f"{GEMMA} at the cap"][k] for k in (
                "max_abs", "max_ratio", "control_ratio", "max_score")}
        row["logits_vs_plain_path"] = {
            "bf16_max_ratio": variants[arch]["vs_plain"]["bf16"]["max_ratio"],
            "bf16_rel_rms": variants[arch]["vs_plain"]["bf16"]["rel_rms"],
            "f32_max_abs": variants[arch]["vs_plain"]["f32"]["max_abs"]}
    kernels = {"kernels": [{
        "name": "sim_step", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sim_step.cu",
        "replaces": "src/repro/kernels/sim_step.py:63",
        "launches": launches, "launches_by_route": sim_by_route,
        "launches_by_variant": sim_by_variant,
        "sweeps": {name: {k: r[k] for k in (
            "variant", "cells", "ms", "plain_ms", "bound_ms", "bound_by",
            "bound_fp64_ms", "bound_int32_ms", "bound_bytes_ms",
            "pregenerated_ms")} for name, r in sweeps_vs_plain.items()},
        "sweeps_launches": sweeps["launches"],
        "workflow_launches": wf_launches,
        "workflow": {key: {k: r[k] for k in (
            "cells", "ms", "plain_ms", "bound_ms", "bound_by",
            "bound_fp64_ms", "bound_bytes_ms", "pregenerated_ms")}
            for key, r in wf_vs_plain.items()},
        "gossip_sweep_launches": [r["launches"] for r in gossip["runs"]],
        "sharded_launches": {
            "fleet grid (C1), by shard count": {
                n: r["launches"] for n, r in shard["cells"]["fleet"].items()},
            f"Fig. 4 static over {FIG4_SHARDS} shards (C1, pre-generated)":
                shard["cells"]["fig4_static"]["launches"],
            "64 cells over (cuda:0, cpu) (C2, the card's shard)":
                shard["card_and_cpu"]["launches"],
            "total": shard["launches"]["total"]},
        "max_abs_err": max(worst, fleet["max_abs_err"]), "bitwise": True,
        "shape": "fleet grid, 10,000 cells, one 256-step chunk",
        "ms": fleet["kernel_ms_per_chunk"],
        "plain_ms": fleet["plain_ms_per_chunk"], "bound_ms": bound,
        "bound_by": ("bytes" if fleet["bound_bytes_ms"]
                     >= fleet["bound_ops_ms"] else "operations"),
        "bound_int32_ms": fleet["bound_int32_ms"],
        "bound_fp64_ms": fleet["bound_fp64_ms"],
        "pregenerated_ms": fleet["pregenerated_ms_per_chunk"],
        "generated_then_pregenerated_ms":
            fleet["generated_then_pregenerated_ms_per_chunk"],
        "pregenerated_bound_ms": max(fleet["pregenerated_bound_bytes_ms"],
                                     fleet["pregenerated_bound_ops_ms"]),
        "fig4": fig4_kernel,
        "library_ms": None}, {
        "name": "ssd_scan_tc", "route": "cuda", "kernel_route": "mma",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:33",
        "path": "mamba2-130m and zamba2-7b serving prefills (bf16, S3, "
                "H3); zamba2-7b split over model extents 2 and 16 (TP5: one "
                "call a layer and shard over its heads) and mamba2-130m over "
                "2 and 16 (TP6)",
        "launches": (ssd_by_route["mma"] + hybrid_ssd["mma"]
                     + sum(split_ssd.values())),
        "launches_by_path": {"mamba2-130m (S3)": ssd_by_route["mma"],
                             "zamba2-7b (H3)": hybrid_ssd["mma"],
                             **split_ssd},
        "max_abs_err": worst_of(ssd_rows, "mma", ("y", "state")),
        "tolerance": {"y_bf16": SSD_Y_TOL, "state": SSD_F32_TOL},
        "logits_vs_plain_path": ssd_logits,
        "hybrid_logits_vs_plain_path": hybrid_logits,
        "ms": ssd["ms"], "plain_ms": ssd["plain_ms"],
        "bound_ms": ssd["bound_ms"], "bound_by": ssd["bound_by"],
        "f32_simt_bound_ms": ssd["f32_simt_bound_ms"],
        "zamba2_shape": {k: hybrid["ssd"][k] for k in (
            "shape", "ms", "simt_ms", "plain_ms", "bound_ms", "bound_by",
            "f32_simt_bound_ms")},
        "split_shapes": split_ssd_shapes,
        "library_ms": None}, {
        "name": "ssd_scan", "route": "cuda", "kernel_route": "simt",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:33",
        "path": "mamba2 and zamba2 serving in float32 (S2, H1, TP1: SMOKE "
                "prefills)",
        "launches": (s2["launches_by_route"]["simt"]
                     + hybrid["card_vs_cpu"]["launches_by_route"][
                         "ssd_scan"]["simt"]
                     + tp["smoke"]["ssd_launches_by_route"]["simt"]),
        "launches_by_path": {
            "mamba2 SMOKE float32 (S2)": s2["launches_by_route"]["simt"],
            "zamba2 SMOKE float32 (H1)": hybrid["card_vs_cpu"][
                "launches_by_route"]["ssd_scan"]["simt"],
            "split mamba2 and zamba2 SMOKE float32 (TP1)":
                tp["smoke"]["ssd_launches_by_route"]["simt"]},
        "max_abs_err": worst_of(ssd_rows, "simt", ("y", "state")),
        "tolerance": {"y_bf16": SSD_Y_TOL, "state": SSD_F32_TOL},
        "ms": ssd["simt_ms"], "plain_ms": ssd["plain_ms"],
        "bound_ms": ssd["bound_ms"], "bound_by": ssd["bound_by"],
        "f32_simt_bound_ms": ssd["f32_simt_bound_ms"],
        "library_ms": None}] + [{
        "name": f"{name}_blocks", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ckpt_quant.cu",
        "replaces": replaces,
        "launches": (quant_launches[f"{name}_blocks"]
                     + dense_quant_launches[f"{name}_blocks"]
                     + moe["train_launches"][f"{name}_blocks"]
                     + hybrid["train_launches"][f"{name}_blocks"]
                     + encdec["train_launches"][f"{name}_blocks"]),
        "launches_by_path": {
            "mamba2-130m training (T3)": quant_launches[f"{name}_blocks"],
            "olmo-1b training (D2)": dense_quant_launches[f"{name}_blocks"],
            "olmoe-1b-7b 2-layer training (M5)":
                moe["train_launches"][f"{name}_blocks"],
            "zamba2-7b 12-layer training (H5)":
                hybrid["train_launches"][f"{name}_blocks"],
            f"whisper-large-v3 {WHISPER_TRAIN_LAYERS} + "
            f"{WHISPER_TRAIN_LAYERS}-layer training (E5)":
                encdec["train_launches"][f"{name}_blocks"]},
        "launches_per_compress_grads": {
            "mamba2-130m": train_run["compress_launches"][0][f"{name}_blocks"],
            "olmo-1b": dense_run["compress_launches"][0][f"{name}_blocks"],
            "olmoe-1b-7b, 2 layers": moe["train"]["compress_launches"][0][
                f"{name}_blocks"],
            "zamba2-7b, 12 layers": hybrid["train"]["compress_launches"][0][
                f"{name}_blocks"],
            f"whisper-large-v3, {WHISPER_TRAIN_LAYERS} + "
            f"{WHISPER_TRAIN_LAYERS} layers": encdec["train"][
                "compress_launches"][0][f"{name}_blocks"]},
        "max_abs_err": max(quant_worst, dense_quant_worst,
                           moe["quant_vs_plain"]["max_abs_err"],
                           hybrid["quant_vs_plain"]["max_abs_err"],
                           encdec["quant_vs_plain"]["max_abs_err"]),
        "bitwise": True,
        "shape": f"mamba2-130m's embedding leaf, {EMBED_LEAF:,} float32",
        "ms": quant[name]["ms"], "plain_ms": quant[name]["plain_ms"],
        "bound_ms": quant[name]["bound_ms"], "bound_by": "bytes",
        "library_ms": quant[name]["library_ms"],
        "olmo_embedding_leaf": dict(n=OLMO_EMBED_LEAF, bound_by="bytes", **{
            k: dense_quant[name][k] for k in (
                "ms", "plain_ms", "bound_ms", "library_ms")}),
        "olmoe_expert_leaf": dict(n=EXPERT_LEAF, bound_by="bytes", **{
            k: moe["quant"][name][k] for k in (
                "ms", "plain_ms", "bound_ms", "library_ms")}),
        "zamba2_embedding_leaf": dict(n=ZAMBA_EMBED_LEAF, bound_by="bytes", **{
            k: hybrid["quant"][name][k] for k in (
                "ms", "plain_ms", "bound_ms", "library_ms")}),
        "whisper_embedding_leaf": dict(n=WHISPER_EMBED_LEAF,
                                       bound_by="bytes", **{
            k: encdec["quant"][name][k] for k in (
                "ms", "plain_ms", "bound_ms", "library_ms")})}
        for name, replaces in (
            ("quantize", "src/repro/kernels/ckpt_quant.py:28"),
            ("dequantize", "src/repro/kernels/ckpt_quant.py:37"))] + [{
        "name": "flash_attention_tc", "route": "cuda", "kernel_route": "wgmma",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:37",
        "path": "the dense, moe, hybrid and encdec serving prefills "
                "(bf16): olmo-1b (A3), gemma2-27b (V3), stablelm-1.6b, "
                "starcoder2-3b, qwen2-vl-7b (V6), olmoe-1b-7b (M2), "
                "deepseek-moe-16b (M3), zamba2-7b (H3, head_dim 112 padded "
                "to 128), whisper-large-v3 (E3: 32 unmasked encoder, 32 "
                "causal decoder and 32 unmasked cross-attention calls); "
                "olmo-1b split over model extents 2 and 4 (TP2: one call a "
                "layer and shard), olmoe-1b-7b over 2 (TP3) and zamba2-7b "
                "over 2 and 16 (TP5: one call a shared use and shard); "
                "starcoder2-3b over 4 (TP7) and whisper-large-v3 over 16 "
                "(TP8) by their prefill cells' kv_seq rules: one call a "
                "layer and key part, with its diagonal offset and its "
                "rows' statistics",
        "launches": sum(tc_by_path.values()),
        "launches_by_path": tc_by_path,
        "launches_by_mode": tc_by_mode,
        "part_shapes": {k: {n: r[n] for n in (
            "shape", "causal", "off", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "max_abs_err")}
            for k, r in tp["parts"].items()},
        "max_abs_err": max(worst_of(flash_rows, "wgmma", (None,)),
                           max(g["max_abs"] for g in v1.values()),
                           max(r["max_abs_err"]
                               for r in encdec["flash"].values())),
        "tolerance": FLASH_TOL, "logits_vs_plain_path": flash_logits,
        "shape": FLASH_OLMO_SHAPE, "ms": olmo_t["ms"],
        "plain_ms": olmo_t["plain_ms"], "bound_ms": olmo_t["bound_ms"],
        "bound_by": olmo_t["bound_by"],
        "f32_simt_bound_ms": olmo_t["f32_simt_bound_ms"],
        "library_ms": olmo_t["library_ms"],
        "gqa_shape": {k: gqa_t[k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "library_ms")},
        "variant_shapes": variant_rows,
        "split_shapes": {**{
            f"olmo-1b shard at model extent {m} (TP2)": dict(
                r["shard_call"], calls_worst=r["call_worst"],
                logits_vs_unsplit={k: r["bf16"][k] for k in (
                    "max_ratio", "limit_ratio", "rel_rms")})
            for m, r in tp["olmo"]["rows"].items() if m > 1}, **{
            f"zamba2-7b shard at model extent {m} (TP5)": dict(
                r["flash_shard"], calls_worst=r["flash_worst"],
                logits_vs_unsplit={k: r["bf16"][k] for k in (
                    "max_ratio", "limit_ratio", "rel_rms", "rms_limit")})
            for m, r in tp["zamba"]["rows"].items()}},
        "zamba2_shape": zamba_flash,
        "whisper_shapes": whisper_flash}, {
        "name": "flash_attention", "route": "cuda", "kernel_route": "simt",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:37",
        "path": "dense, moe, hybrid and encdec serving in float32 (A2, V2, "
                "M1, H1, E1, TP1: SMOKE prefills; TP1's kv_seq splits with "
                "offsets and statistics)",
        "launches": sum(simt_by_path.values()),
        "launches_by_path": simt_by_path,
        "max_abs_err": worst_of(flash_rows, "simt", (None,)),
        "tolerance": FLASH_TOL,
        "shape": FLASH_OLMO_SHAPE, "ms": olmo_t["simt_ms"],
        "plain_ms": olmo_t["plain_ms"], "bound_ms": olmo_t["bound_ms"],
        "bound_by": olmo_t["bound_by"],
        "f32_simt_bound_ms": olmo_t["f32_simt_bound_ms"],
        "library_ms": olmo_t["library_ms"],
        "gqa_shape": {"shape": gqa_t["shape"], "ms": gqa_t["simt_ms"],
                      "plain_ms": gqa_t["plain_ms"],
                      "bound_ms": gqa_t["bound_ms"],
                      "library_ms": gqa_t["library_ms"]}}]}
    REPORT["kernels"] = kernels
    _lap("T4 quant, 8")
    _dump()
    print(json.dumps(kernels))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
