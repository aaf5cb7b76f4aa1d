#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--seed 0] [--out results.json]

Phases, each of which fails loudly (non-zero exit, nothing caught):

1. device  — require a CUDA card; print its name and power limit.
2. build   — build every kernel under src/repro_torch/kernels/csrc with nvcc
             (one process per source, all at once); print the seconds
             and each kernel instance's registers and spills (ptxas).
3. kernels — hold the sig_trunc kernel (both cells: terminal and streamed,
             strides 1 and 3; fp32 and bf16_fp32) against its plain
             PyTorch version in float64 on the card, over (d, N) in
             {(2,3), (3,4), (6,5), (10,3), (10,5)}, B = 5, M in {1, 37}, at
             every partition the planner can choose
             (sig_trunc.partition_variants: its own, and every feasible
             split with one example a block and with the most examples a
             block may share).  fp32: rtol 2e-4, atol 2e-5; bf16_fp32:
             relative error of level n within n·2^-8.  Then the fused
             transform cases: raw increments (d in 1, 2, 3, 5) and the
             time rows of a ragged batch through lead_lag and
             time_augment+lead_lag, at every partition of the augmented
             alphabet, against the plain version's fused scan.
4. serve   — DynamicBatcher.signature_service(d=6, depth=5, max_len=1024)
             answers 256 requests of log-uniform lengths in [16, 1024];
             32 sampled answers are held against the plain version on the
             unpadded path, and the kernel must have been launched once per
             flushed micro-batch.  The largest micro-batch is timed.
5. dispatch — ops.signature at the paper's Table 1 grid, the kernel's median
             time beside the plain version's, and one streamed cell through
             core.signature.signature(stream=True).
6. words   — hold the sig_words kernel (both cells, strides 1 and 3; fp32
             and bf16_fp32) against its plain version in float64 on the
             card: the full truncation all_words(3, 4), a sparse set over
             d = 4, anisotropic_words((1, 2, 1.5), 4), all_words(2, 4) +
             Lyndon_5, and 20 random word sets from the seed (d in 2..4,
             lengths 1..4, repeats allowed), max_rows in {8, 32, 256},
             B = 5, M in {1, 37}, at every partition the planner can
             choose (sig_words.partition_variants: its own, one tile and
             one example a block, and the most examples a block for both
             packings).  fp32 as in phase 3; bf16_fp32 against the plain
             version on the same rounded increments (emissions within
             2^-8) and every full level within n·2^-8.  Then the fused
             transform cases over word sets of the augmented alphabets
             (a random set for d in 1, 2, 3 and each transform, and the
             §8 sparse lead-lag set at d = 2), max_rows in {8, 256}.
7. cross   — ops.projected over all_words(6, 5) (sig_words) equals
             ops.signature(·, 5) (sig_trunc) at (32, 100, 6, 5).
8. project — the paper's §8 projection at full width: Brownian paths
             (B = 128, M = 250, d = 5), lead_lag, 500 increments over 10
             letters, projected onto generated_words(
             sparse_leadlag_generators(5), 4) (1,685 words) through
             projected_signature_from_increments, ops.projected_forward_
             only, a ragged ops.projected (lengths) and a streamed call
             (stride 10); one launch per call; values against the plain
             version (16 ragged rows on their unpadded paths); kernel and
             plain times, the bound and the planner's partition; the
             truncated ops.signature(·, 4) time of the same input as
             information.
9. logsig  — logsignature_projected on the card at every cell of
             benchmarks/table3_logsig.py, one sig_words launch per call,
             held against the dense logsignature on the torch engine; the
             sig_words kernel alone over each cell's closure tiles (time,
             plain time, bound and partition).
10. gram   — hold the sig_gram kernel against its plain version in float64
             on the card: B_x, B_y in {1, 7, 63, 64, 65, 128, 129, 130, 300},
             D in {1, 6, 127, 511, 512, 513, 1025, 1685, 9330} (both sides
             of the row tiles and of the 512-word blocks that split-K
             slices are made of); weights uniform in [0.2, 2], half of
             them zeroed, all zero, and the anisotropic gamma weights at
             D = 9330; fp32 and bf16_fp32 operands (the plain version on
             the same rounded operands).  Then every tile, split and copy
             width forced at six ragged shapes, and an operand 4 bytes off
             16.  |G − G_64| <= 1e-5·max|G_64|, the
             reference's acceptance (tests/test_sigkernel.py).
11. score  — SigScoreEngine over R = 2048 Brownian reference paths of 1024
             steps (d = 6, depth = 5, gamma spaced in [0.5, 2], KRR targets
             the Lévy area of channels 0 and 1, reg 1e-3), then
             DynamicBatcher.scoring_service answers 256 requests (lengths
             log-uniform in [16, 1024]) in each mode, scores / nearest /
             predict; one sig_trunc and one sig_gram launch per
             micro-batch.  32 answers per mode are held against the
             unpadded plain path (ops.signature on the torch engine in
             float64, then sig_gram_plain) to 1e-4·max|plain| (predictions
             to 1e-4·Σ_j |K_j α_j| with the engine's own duals); nearest
             must be the plain argmax.  Kernel, plain and library
             (torch.matmul, TF32 off) times of the reference Gram and of
             the largest cross-Gram (kernel and library per call of 20
             back to back, and one call alone), with both bounds; two
             kernel runs bitwise equal; sig_trunc over the references
             (time, bound and partition).
12. mmd    — sig_mmd of two samples of the §8 lead-lag input (B = 128 each,
             500 increments over 10 letters) on the §8 word set (1,685
             words): two sig_words legs into three sig_gram products,
             against the statistic from the plain versions in float64 to
             1e-4·max|K_64|; the 128 × 128 × 1,685 Gram timed as in 11.
13. sweep  — hold the sig_sweep kernel (the §4.2 reverse sweep, the
             backward of both signature kernels) against sig_sweep_plain in
             float64 on the card, through SigTruncFunction over (d, N) in
             the sweep of phase 3 (with (10, 5), whose 111,110-row closure
             runs from device memory) and SigWordsFunction over phase 6's
             word sets (closure tiles of at most 32 rows): terminal and
             streamed, strides 1 and 3, fp32 and bf16_fp32, B = 5, M in {1,
             37}, random cotangents, the plain version on the same
             increments and the same saved terminal state.  |g − g_64| <=
             1e-3·|g_64| + 1e-4·max|g_64| in both precisions: the kernel
             sums in fp32, and sums of terms up to max|g| cancel, so a
             bound absolute in the gradient's units is below fp32's
             resolution at max|g| ~ 1e3 (the fp32 plain sweep fails rtol
             1e-3 + atol 1e-5 too: for each truncated (d, N) the phase
             prints the least atol, over max|g|, that rtol 1e-3 needs for
             the kernel and for the fp32 plain sweep on the same inputs);
             bf16 rounding enters only through the increments, which both
             share.  Then every partition the planner can choose
             (sig_sweep.partition_variants: its own, one warp, a thread a
             row of the widest level and the most threads an example,
             a block an example; and its own threads with the state in
             the device-memory scratch), forced, over the same
             closures at B = 5, M = 37, terminal and stride 3: each within
             the same rule, and a second run bitwise equal (the kernel
             has no atomics).  The fused transform cells of phases 3 and
             6 too: their backward builds the augmented increments from
             the saved raw ones, sweeps them and applies fused_adjoint,
             held against the plain sweep on the same augmented
             increments pulled back the same way; their closures join
             the forced partitions.
14. train  — the paper's Table 1 train mode, ((ops.signature(x, N))**2).sum()
             with its gradient at every Table 1 cell: one sig_trunc and one
             sig_sweep launch per call; at every cell the gradient, and
             sig_sweep alone on the same inputs, against the plain sweep in
             float64 from the same terminal signature, and at the depth
             sweep also against the torch engine's float64 autodiff
             (tolerance as in 13); value plus gradient ms, sig_sweep alone
             (ms, plain ms, bound), and the torch engine's autodiff value
             plus gradient at the depth sweep for information.
15. memory — the paper's Table 2 cell (B = 32, d = 5, N = 4, M from 50 to
             1600): torch.cuda.max_memory_allocated during value plus
             gradient, increments included, above what was allocated
             before, for inverse (the card), checkpoint (the card) and
             autodiff; from M = 50 to 1600 the inverse peak grows by at
             most 4× the increments' own growth (B·ΔM·d·4 bytes),
             autodiff's by more than 10×, and the checkpoint peak less
             the increments' bytes with a least-squares exponent in M
             within [0.35, 0.65] (√M: 0.5); peaks as multiples of
             Mem_out = 4·B·D_sig.  The streamed cells
             (ops.signature and ops.projected over W_{<=4}, stride 1): the
             storages behind the tensors saved for the backward grow from
             M = 50 to 1600 by at most the increments' own growth.
16. mmdgrad — the gradient of sig_mmd on the §8 word set with respect to
             the generated sample (two sig_words launches, three sig_gram,
             one sig_sweep) against the float64 torch engine to
             1e-4·max|g|.
17. hurst  — the §8 model of examples/hurst_fbm_torch.py at the --full
             widths (d = 5, M = 250: 500 lead-lag increments over 10
             letters, depth 3, batch 128, lr 1e-2): 10 Adam steps of
             truncated (1,110 features, sig_trunc) and of sparse (260
             words, 285-row closure, sig_words) on 1,280 training paths of
             the port's hurst_dataset, whitened on 256; one forward kernel
             and one sig_sweep a step, finite losses, the first step's
             gradients against the same model on the torch engine in
             float64 to 1e-3·max|g| per parameter; step ms (median of
             steps 2-10), the loss curve, the kernels' ms, sig_sweep at the
             step's shape held against the float64 plain sweep (tolerance
             as in 13).
18. transform — the fused transform cells through the user entry
             points: the paper's §8 at full width through
             transform="lead_lag" (B = 128, M = 250, d = 5: 500
             augmented steps over 10 letters) in ops.projected onto the
             1,685-word set (terminal, ragged, streamed at stride 10),
             ops.projected_forward_only, ops.projected onto its 1,860-word
             prefix closure with its gradient, and ops.signature(·, 3) with
             its gradient; the Table 1 transform cells of
             benchmarks/table1_runtime.py (fused_transform (32, 100, 6, 2)
             fp32 and combined (32, 100, 3, 3) bf16_fp32, both
             time_augment+lead_lag), terminal, streamed at stride 3 and
             value plus gradient; and signature_service(d=6, depth=5,
             max_len=1024, transform="time_augment") answering 256
             requests.  Each call launches one fused forward kernel (the
             fused counter shows it) and one sig_sweep a backward; values
             against the plain version's fused scan in float64 (bf16:
             every level within n·2^-8 and the plain version on the same
             rounded raw increments), against the same kernel on the
             materialised increments, gradients by phase 13's rule; the
             tensors saved for the backward hold the raw increments,
             never the augmented ones; each fused case timed, one call
             and back to back, beside the materialising route
             (fused_augment in PyTorch, then the same kernel) and the plain
             version, with its bound (the raw increments and time rows in,
             the output out, against the Horner operations over the
             augmented steps, counting in each sub-step only the letters
             that move: half of a lead-lag increment is zero by
             construction).
19. checkpoint — value plus gradient at every Table 1 cell with
             backward="checkpoint" and with time_chunks 4 and 16: one
             sig_trunc launch over the folded chunks and one sig_sweep a
             call, values by phase 3's fp32 rule and gradients by phase
             13's against the float64 plain version, value plus gradient
             ms beside phase 14's inverse cell; sig_trunc over the folded
             chunks and sig_sweep over them alone at the largest cell
             (ms, plain ms, bound), and one value plus gradient there of
             inverse and of checkpoint under torch.profiler (wall ms,
             device busy ms, kernels, idle share); transform="lead_lag"
             with checkpoint
             at the Table 1 fused_transform cell (materialised: one
             unfused sig_trunc, one sig_sweep); ops.projected(backward=
             "checkpoint") at §8 width through lead_lag, which runs the
             torch engine on the card and launches no kernel.
20. windows — the Fig. 3 grid of benchmarks/fig3_windows.py (B = 16,
             d = 4, N = 3, window 16, stride 8, K in {4, 16, 64, 256,
             1024}, M = 8K + 16; and (32, 2048, 4, 4), window 256, stride
             8, K = 225): fold, chen, auto and per-window (K ops.signature
             calls, not at the last cell) ms, auto's pick and whether it
             is within 15% of the faster route (printed, not gated), one
             launch a route, fold against the float64 plain per-window
             signatures by phase 3's rule and chen to
             1e-4·max|plain|, the auto route's gradient (one sig_sweep)
             against float64 autodiff of the torch engine by phase 13's
             rule; at K = 64 windowed_projection onto the §8 sparse
             lead-lag word set at d = 4, depth 3, through lead_lag (one
             fused sig_words launch, its gradient), a ragged batch on both
             routes and a time_augment per-window case; both routes'
             kernels alone at the heavy-overlap cell.
21. stream — a StreamCarry of 100,000 rows (d = 3, depth 3, ring 64, 1%
             dead lanes), the scale of benchmarks/session_throughput.py:
             ten rounds of stream_extend (per-row counts 0..32, 10% zero)
             and stream_rolling_drop, one sig_trunc launch an extend,
             zero-count and dead rows bitwise unchanged, ms a round and
             rows per second; stream_take / stream_scatter of 4,096 rows;
             256 sampled rows against the float64 plain signature of their
             ring to 1e-4·max|plain|; stream_extend(return_stream=True) at
             10,000 rows (one streamed launch); a batch-1 SignatureStream
             over 20 hops of 8 ticks.
22. sessions — the session pool on the card: (a)
             benchmarks/session_throughput.py's full sweep (10,000,
             100,000 and 1,000,000 sessions, d = 3, depth 3, 4 rounds of
             ~512 ticking sessions, up to 32 ticks, seed 0, traffic from
             session_tick_stream): SessionStore cold and warm epochs
             (host clock to a synchronize), updates/s, staleness p50/p99,
             flush and launch shapes against their bound, one sig_trunc
             launch a flush bucket (the buckets worked out from each
             round's counts), the per-object plan (a batch-1
             SignatureStream a session) with 8 sessions against it, 256
             sampled sessions against the float64 plain signature of their
             ticks to 1e-4·max|S|; (b) a ring pool (ring 64, max_sessions
             below the population, ttl 2, arrivals and churn) with TTL,
             LRU and explicit evictions, dropped ticks, a stale handle,
             hopping windows by drop_block and 256 rows against the
             float64 plain signature of their rings; (c) SigStreamEngine
             (d = 6, depth 5, batch 64, window 256, stride 8: 8 pushes of
             64 steps, one streamed sig_trunc launch each, features
             against the float64 plain stream) and SigScoreEngine over
             2,048 references of 1,024 steps (one sig_trunc and one
             sig_gram launch a push; scores, predict and nearest against
             float64), and both engines on one shared store; (d) the
             100,000-session pool checkpointed and restored, every lane
             equal; (e) signature_service with the prefetch on and off,
             bitwise equal, in-flight peak within max_in_flight.
23. slice8 — (a) benchmarks/ragged_throughput.py at full size (384
             requests of the port's geometric_lengths up to 1,024 steps,
             d = 4, depth 4, 4 rounds, max_batch 64, min_bucket 48): per
             request, pad-to-max, signature_service and bucket_paths (one
             ops.signature launch a bucket), cold and warm, requests a
             second, every plan against the per-request answers (rtol
             2e-4, atol 2e-5); from_segments, point_mask,
             terminal_points and RaggedPathStream batches on card tensors
             against numpy.  (b) backend="hybrid" at the six Table 3
             cells on the §3.3 set: logsignature_projected and
             ops.projected, value and gradient, against the cuda route
             (sig_words, then sig_sweep) and float64 (values
             1e-4·max|float64|, gradients by phase 13's rule); both
             routes' ms and launches, a traced value plus gradient at the
             largest cell, the hybrid backward's saved bytes equal to the
             increments plus the output.  (c) PATHSIG_AUTOTUNE=sweep into
             a temporary cache over kernels/autotune.py's --quick grid:
             each winner against the plain version, ms <= default_ms, a
             non-default winner >= 10% faster, the default timed, a
             second lookup a hit, the file round trip; the tuned
             128 × 128 × 1,685 Gram beside cuBLAS.  (d) metrics, a trace
             and the flight recorder over a ragged serving round, a warm
             session flush at 10^4 sessions and one §8 truncated step in
             a train.step span: span nesting, the Chrome JSON, the
             counters against the host's counts, one retrace tick per new
             launch shape, a failing ingest's single flight dump; round
             and flush wall ms with obs off and on in turns (not gated),
             the same launches either way; the §8 step's device busy ms,
             kernels and idle share under torch.profiler.  Phases 1-22
             run with PATHSIG_AUTOTUNE=off.
24. lm     — the dense-decoder LM substrate at qwen3-4b's published
             widths.  (a) ServeEngine over get_config("qwen3-4b") as
             published (36 layers, d_model 2,560, 32/8 heads of 128,
             d_ff 9,728, vocab 151,936: 4.02B parameters in fp32, drawn
             on the card): 8 prompts of 64 tokens from TokenStream(seed=0)
             and 32 greedy tokens each; the prefill step's last logits
             against the decode path's to 1e-4·max|logit|, the first
             greedy token the prefill's argmax up to near ties, no
             signature launch; tokens/s, ms a decode step, a traced
             step's kernels and idle share, peak memory.  (b) train_loop
             at full width with the depth cut to 2 layers (0.59B
             parameters, cut from 4 for time when phase 28 took case
             (g); 36 layers need 64 GB for fp32 parameters,
             gradients and AdamW state before any activation), the
             SigHeadConfig defaults (8 channels, depth 3) and an
             init_sig_head projection, AdamW under linear_warmup_cosine,
             batches of 8 × 512 tokens: 10 sig-MMD steps against 8 fBM
             reference paths of 512 points (hurst_dataset, scaled by
             1/√512 as the learned path is), checkpointed at step 5 and
             at the end; 3 ragged steps (ragged_token_batches masks,
             RaggedPathStream lengths) and 3 LM steps while the last
             checkpoint is written; then a loop resumed from the step-5
             checkpoint whose losses must equal the uninterrupted run's
             to 1e-4; exactly 2 sig_trunc, 3 sig_gram and
             1 sig_sweep launches a sig-MMD step, none an LM step; median
             step ms, peak memory, the loss curves, one sig-MMD step
             under torch.profiler (busy ms, kernels, idle share, the
             signature kernels' share).  (c) one full-width hidden state
             of the trained model, (8, 512, 2,560) -> path (8, 512, 8):
             the sig-MMD loss, sig_pool truncated, projected onto 172
             words and with 16 kernel landmarks, and sig_stream_features
             (stride 8), value and gradient with backend="cuda" against
             backend="torch" on the same tensors (values
             1e-4·max|torch|, gradients by phase 13's rule), each with
             its exact launches; then sig_trunc, its streamed cell,
             sig_words, sig_gram and sig_sweep alone at those shapes
             against their plain versions in float64, timed, with bounds
             and partitions.
25. families — the MoE/MLA, hybrid, RWKV6 and encoder-decoder LMs
             (float32, TF32 off, random init on the card from the seed).
             (a) ServeEngine over deepseek-v2-lite-16b, zamba2-7b,
             rwkv6-1.6b and whisper-large-v3 as published and
             phi3.5-moe-42b-a6.6b at full width with its depth cut to the
             most layers that leave 10 GB free, each freed before the
             next: prompts from TokenStream(seed=0) (4 × 64; phi3.5 2 ×
             32; whisper 4 × 32 over 1,500 stub frames; a MoE prompt
             batch is <= 4E tokens, one dropless group) and 16 greedy
             tokens; prefill logits against P decode steps to
             1e-4·max|logit| (MoE/MLA; rwkv6 in float64, its float32
             gap reported; zamba2 at a 12-layer cut of the same weights,
             its full depth finite: with 14 groups over 2 shared blocks
             the reference's decode is not its prefill; whisper encode ->
             prefill_cross -> decode_step against decode_train); new
             tokens/s, ms a decode step by CUDA events beside the
             weight-read bound, a traced step's kernels and idle share,
             peak memory, no signature launch.  (b) deepseek-v2-lite at
             full width, depth 4 (1 dense + 3 MoE layers), through the
             sig-MMD loss with the SigHeadConfig defaults, AdamW, 5 steps
             of 8 × 512 tokens: finite losses, exactly 2 sig_trunc, 3
             sig_gram and 1 sig_sweep launches a step, step ms, a traced
             step's signature share, the leg's kernels alone against
             their plain versions; one LM step each of zamba2-7b,
             rwkv6-1.6b and whisper-large-v3 at full width, depth 4,
             4 × 256 tokens (two SSD chunks): finite loss and gradient
             norm, peak memory.  (c) the plain _ssd_chunked and _wkv_scan
             forward at those shapes: ms, kernels a call, bytes bound.
26. distributed — the data-parallel slice (repro_torch.distributed):
             gloo worlds of P = 2 and P = 4 ranks spawned side by side on
             the one card (NCCL refuses two ranks on one device; a
             collective times out after 120 s and the worlds after 420 s,
             each rank's exit code is checked; phases 27 and 28 run their
             two worlds side by side too), each rank loading the kernels
             phase 2 built.  Under
             sharding_ctx(make_sig_mesh()), against rank 0's single-rank
             result on the card (values rtol 2e-4 / atol 2e-5, the Gram
             1e-5·max|G|, gradients 1e-3·|g| + 1e-4·max|g|): (a) sharded
             ops.signature value plus gradient at (64, 500, 4, 5) with
             inverse and checkpoint and a ragged B = 63 batch, one
             sig_trunc and one sig_sweep launch a rank; (b) sharded
             ops.projected on §8's 1,685 words over 500 lead-lag
             increments (B = 128), one sig_words and one sig_sweep a
             rank; (c) the Gram ring at 2,048 × 2,048 × 9,330 and 8 × 8 ×
             584, value and three gradients, P sig_gram launches a rank a
             forward and none a backward, P − 1 send/recv steps of
             (P − 1)·⌈B_y/P⌉·D·4 bytes, equal to the analytic counters,
             each posted before its tile (ring_overlap).  At P = 2 only:
             (d) the sig-MMD train_loop, qwen3-4b at full width, depth 2,
             8 × 512 tokens, AdamW, 2 steps: losses within
             1e-4·max(1, |loss|) of one rank's, the first step's
             gradients by the gradient rule, 2 sig_trunc, 3·P sig_gram and
             1 sig_sweep launches a rank a step; (e) signature_service(
             d=6, depth=5, max_len=1024) placed over the mesh answering
             256 requests like one rank, every rung a multiple of P; (f) a
             SessionStore over the mesh at phase 22's configuration
             (10,000 sessions, one round), its checkpoint restored with no
             mesh answering bit for bit.  Then a world of one over NCCL:
             the size-1 context bit-identical to none for the value and
             gradient of a signature and of a Gram.  Each case's ms (rank
             0, the ranks starting together) beside the single-rank ms
             (rank 0 alone): ranks that share one card are not faster.
             The launches a rank and the transport of each collective
             are printed.
27. model_parallel — the model-parallel slice (repro_torch.distributed.
             model_parallel): a gloo world of 4 ranks on a 2 x 2
             ("data", "model") mesh and one of 2 ranks on a 1 x 2 mesh,
             spawned on the one card as in phase 26, the models laid out by
             param_specs (tensor, expert and FSDP parallel), each against
             rank 0 alone with the whole model: (a) qwen3-4b at full width,
             depth 2, the sig-MMD train_loop, 8 x 512 tokens, AdamW, 2
             steps: losses within 1e-4·max(1, |loss|), the first step's
             gradients (gathered to full arrays) by the gradient rule, 2
             sig_trunc, 3·2 sig_gram and 1 sig_sweep launches a rank a step
             (the Gram ring over the data subgroup of 2), and the
             collectives of one backbone forward by kind and site against
             the analytic count (2 model-axis all-reduces and 7 FSDP
             all-gathers a dense layer, one for the embedding); (b)
             qwen3-4b at full width, 12 of 36 layers (cut from 36 when
             phase 28 took case (g)), served on the 1 x 2 mesh:
             greedy tokens equal to one rank's, ms a decode step; (c)
             deepseek-v2-lite-16b, zamba2-7b and rwkv6-1.6b at full width,
             depth 2 each: one SGD step on the 2 x 2 mesh (loss within
             1e-4·max(1, |loss|), gradient norm within 1e-3 relative) and
             three greedy tokens on the 1 x 2 mesh equal to one rank's;
             (d) every parameter and cache leaf of a sharded decode step
             updated in place (hlo.donation_stats); (e) deepseek-v2-lite
             at full width, depth 2, decoded on the 2 x 2 mesh under
             dryrun.rules_for(arch, decode_32k), the reference's decode
             layout (the requests over the data axis, the MLA latent
             cache's 16 positions in blocks of 8 over the model axis,
             which the 6-token prompts and 4 new tokens cross): greedy
             tokens equal to one rank's, the cache bytes a rank beside
             the whole cache's.
28. dryrun_mp — the dry run, whisper's model axis and Adafactor on
             sharded parameters: gloo worlds of 4 (2 x 2) and 2 (1 x 2)
             ranks sharing the card as in phase 27, each case against rank
             0 alone, and the dry run (launch/dryrun.py::lower_cell on an
             AbstractMesh((2, 2)) in a fake world of 4, in a process of its
             own that never touches the card): (a) whisper-large-v3 at
             full width, 8 + 8 of 32 + 32 layers, on 1 x 2: encode
             1,500 frames, prefill the cross caches, greedy tokens equal to
             one rank's, ms a decode step; (b) whisper at full width,
             depth 1 + 1, Adafactor, 2 steps on 2 x 2 under its train
             cell's rules (FSDP over both axes, each sequence in blocks
             over "model") and under the default rules (heads and ff over
             "model", FSDP over "data"); (c) phase 27's qwen3-4b sig-MMD
             step with Adafactor, 2 steps on 2 x 2 under its train cell's
             rules (2 sig_trunc, 3·2 sig_gram and 1 sig_sweep launches a
             rank a step, on the gathered path); (f) zamba2-7b and
             rwkv6-1.6b at full width, depth 2, LM loss, 2 steps under
             their train cells' rules.  Each training case against one
             rank (that rank's model alone on the card): losses within
             1e-4·max(1, |loss|), first-step gradients by the gradient
             rule, ms a step, peak bytes a rank below one rank's, a
             step's sequence exchanges and their backward by tag; (d)
             qwen3-4b at full width, 12 of 36 layers, on 2 x 2: greedy
             tokens equal to one
             rank's under dryrun.rules_for(qwen3-4b, decode_32k) and
             under the default rules, ms a step of each (rules_for's no
             more than the default's) and one rank's; under rules_for
             also 4 requests with 10-token prompts and 4 new tokens,
             whose positions cross the cache's sequence blocks of 8; the
             cache bytes a rank under each rule set beside the whole
             cache's; (e) the prefill under rules_for(arch,
             "prefill_32k"), each prompt in blocks over "model":
             qwen3-4b (6 layers), zamba2-7b, rwkv6-1.6b and whisper,
             last-position logits against one rank's; (g) Megatron
             sequence parallelism under rules_for(arch, shape, {"seq":
             "model"}) (heads, ff and experts over "model", which cuts
             each sequence): deepseek-v2-lite-16b at full width, depth 2,
             2 sig-MMD Adafactor steps at 8 x 512 (the training gates
             above; 2 sig_trunc, 3·2 sig_gram and 1 sig_sweep launches a
             rank a step; the split layers' sp_tp_* and sp_moe_*
             exchanges and their backward), and its prefill and
             phi3.5-moe's (depth 2) at 2 x 1,024 against one rank's
             logits; (h) phi3.5-moe at full width, depth 2, under
             rules_for(arch, "decode_32k"): the cell's 128 requests,
             each step one dispatch group of 128 tokens (C = 20) split
             across both data ranks, greedy tokens equal to one rank's,
             each step's logits within 1e-4·max|ref|, the dropped pairs
             a step equal to one rank's and above 0 in some step, one
             moe_pos all-gather a MoE layer a step, ms a step and peak
             bytes a rank beside one rank's; and the dry run's
             parameter and Adafactor-state bytes a rank for both (b)
             cells and (c) equal to rank 0's exactly, one backbone
             forward's collectives by kind and a step's collectives by
             tag equal to the real world's log.
29. examples — the eight examples with a _torch counterpart
             (examples/quickstart_torch.py, streaming_torch.py,
             kernel_methods_torch.py, ragged_serving_torch.py,
             sessions_serving_torch.py, serve_lm_torch.py,
             train_lm_torch.py at --preset 100m --steps 20 with its
             restart, and observability_torch.py --check, whose ring
             spawns 2 gloo ranks sharing the card), each imported by name
             and its main(argv) called on the card with the launch
             counters set to 0 just before it and read just after.  An
             example that raises, exits non-zero or fails one of its
             printed checks (quickstart's kernels against their plain
             versions, the ragged and session bit-identities, train_lm's
             resumed losses against the uninterrupted run's, the
             observability check) fails the phase; so does a kernel of
             sig_trunc, sig_words, sig_gram and sig_sweep that no example
             launched.  Each example's seconds and launches are printed.
30. cost   — the four kernels as registered operators: at the serving
             micro-batch sig_trunc (64, 1,024, 6, 5), the §8 sig_words
             (128, 500, 10; 1,685 words), the reference Gram 2,048 ×
             2,048 × 9,330 and the §8 truncated value and gradient
             (sig_trunc + sig_sweep, 128 × 500 over 10 letters, depth 3),
             obs.record_cost of the cuda route on meta tensors (nothing
             built or launched) equals kernels/cost.py's count exactly, a
             CostCounter around the same call on the card reads the same
             FLOPs, and the call launches one of each of its kernels and
             nothing else; then the host ms from call to return of a
             (64, 32, 4, 3) sig_trunc launch through the operator beside
             the kernel's launch body called directly, and of the
             sig_trunc wrapper.
31. report — one JSON line of kernels (the sig_trunc row with its cases:
             serving micro-batch, engine references, largest Table 1 cell,
             streamed cell, and the fused ones: §8 lead_lag depth 3, the
             time_augment serving micro-batch, the two Table 1 transform
             cells; the sig_trunc_stream row with the two streamed Table 1
             transform cells; the sig_words row with its cases: §8
             terminal, §8 streamed, the largest Table 3 set, §8 lead_lag
             fused; the sig_words_stream row with §8 lead_lag streamed
             fused, each fused case with its materialising route's ms;
             the sig_sweep row with
             its cases: largest Table 1 train cell, §8 sparse step, §8
             truncated step, each with µs a step and partition, and its
             instances' ptxas registers and stack; the dependent phases a
             step as the kernel is written, design_phases, is a count of
             its layout (sig_sweep.step_phases), not a measurement;
             each with ms, bound and partition; and the cases of phases
             19-21: on the sig_trunc row the checkpoint chunks, the windows
             fold route and a stream extend, on the sig_trunc_stream row
             the windows chen route and the streamed extend, on the
             sig_words row the windowed projection, on the sig_sweep row
             the sweep over the folded chunks; and phase 22's: on the
             sig_trunc row a flush bucket of the 1,000,000-session pool and
             a score-engine push, on the sig_trunc_stream row a
             stream-engine push, on the sig_gram row the cross-Gram a
             push; and phase 23's: on the sig_trunc row a bucket_paths
             bucket, on the sig_words row the hybrid comparison's largest
             Table 3 set, on the sig_gram row the tuned 128 × 128 × 1,685
             Gram, each with its launches; and phase 24's: the LM
             path's sig-MMD leg on the sig_trunc row, its stream on the
             sig_trunc_stream row, the projected head on the sig_words
             row, the sig-MMD Gram on the sig_gram row and the leg's
             backward on the sig_sweep row, with their launches; and
             phase 25's: deepseek-v2-lite's sig-MMD leg on the sig_trunc
             row, its Gram on the sig_gram row and its backward on the
             sig_sweep row, with their launches; and phase 26's sharded
             cases at P = 2 and 4 on their kernels' rows, with their
             launches a rank; and phase 27's 2 x 2 sig-MMD train_loop and
             phase 28's 2 x 2 Adafactor sig-MMD steps on the sig_trunc,
             sig_gram and sig_sweep rows, with their launches a rank; and
             phase 29's launches on every row, by example; and phase
             30's cost case on each kernel's row, and the host ms on the
             sig_trunc row), the card's name and power limit, then the
             device line last.

Nothing of JAX or of the JAX package is imported.  Times come from CUDA
events on the card; bounds from the shapes by kernels/cost.py, the one
module of the work counts and bounds (H100 SXM: 3.35 TB/s HBM,
67 TFLOP/s FP32 on the CUDA cores, 495 TFLOP/s dense TF32 on the tensor
cores, where the Gram is held to three TF32 products).  Tolerances of
composed results (signature kernel, then Gram) are 1e-4·max|plain|: each
fp32 kernel is within 1e-5 of its float64 plain version, and the
composition adds the signature's rounding to the Gram's.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import signature as sig  # noqa: E402
from repro_torch.core import stream  # noqa: E402
from repro_torch.core import tensor_ops as tops  # noqa: E402
from repro_torch.core import windows as win  # noqa: E402
from repro_torch.core.hybrid import hybrid_low_plus_top  # noqa: E402
from repro_torch.core.logsignature import (logsig_dim,  # noqa: E402
                                           logsignature,
                                           logsignature_projected)
from repro_torch.core.projection import (  # noqa: E402
    projected_signature_from_increments)
from repro_torch.core.transforms import (  # noqa: E402
    as_transform, augment_increments, fused_adjoint, fused_augment, lead_lag,
    sparse_leadlag_generators, transform_dim, transform_time_aux)
from repro_torch.core.words import (all_words, anisotropic_words,  # noqa: E402
                                    generated_words, lyndon_words, make_plan,
                                    make_tiled_plan, prefix_closure)
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch import models as LM  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config, with_sig_head  # noqa: E402
from repro_torch.data.pipeline import (RaggedPathStream,  # noqa: E402
                                       TokenStream, geometric_lengths,
                                       hurst_dataset, ragged_token_batches,
                                       session_tick_stream)
from repro_torch.launch.train import reference_paths  # noqa: E402
from repro_torch.models.sig_head import (_learned_path,  # noqa: E402
                                         init_sig_head, sig_pool,
                                         sig_stream_features)
from repro_torch.optim import adamw, linear_warmup_cosine  # noqa: E402
from repro_torch.kernels import _build, autotune, ops  # noqa: E402
from repro_torch.kernels.cost import (FP32_FLOPS_PER_S,  # noqa: E402
                                      HBM_BYTES_PER_S, bound,
                                      fused_step_flops, gram_bound,
                                      gram_work, horner_flops,
                                      lm_matmul_flops, roofline_ms,
                                      sweep_bound, sweep_work, trunc_work,
                                      words_flops, words_work)
from repro_torch.kernels import sig_gram as sg  # noqa: E402
from repro_torch.kernels import sig_sweep as ss  # noqa: E402
from repro_torch.kernels import sig_trunc as st  # noqa: E402
from repro_torch.kernels import sig_words as sw  # noqa: E402
from repro_torch.ragged import (RaggedPaths, assign_buckets,  # noqa: E402
                                batch_rung, bucket_ladder, bucket_paths,
                                pad_batch)
from repro_torch.serve import (DynamicBatcher, ServeEngine,  # noqa: E402
                               SessionStore, SigScoreEngine, SigStreamEngine,
                               make_prefill_step)
from repro_torch.sigkernel import (gram_diag, krr_fit,  # noqa: E402
                                   sig_mmd, word_weights)
from repro_torch.train import (TrainLoopConfig,  # noqa: E402
                               make_train_step, train_loop)

TOL = dict(rtol=2e-4, atol=2e-5)
SWEEP = [(2, 3), (3, 4), (6, 5), (10, 3), (10, 5)]
# (B, M, d, N) cells of the paper's Table 1 (depth, length and batch sweeps)
TABLE1 = ([(32, 100, 6, n) for n in (2, 3, 4, 5)]
          + [(64, m, 4, 5) for m in (50, 100, 200, 500)]
          + [(b, 200, 10, 3) for b in (1, 16, 64, 128)])
STREAM_CELL = (32, 100, 6, 5, 10)   # (B, M, d, N, stride)
CROSS_CELL = (32, 100, 6, 5)        # (B, M, d, N)
# paper §8 (examples/hurst_fbm.py --full): B, M path steps, d channels,
# depth of the sparse lead-lag word set, streamed stride
PROJ_CELL = (128, 250, 5, 4, 10)
# (B, M, d, N) cells of benchmarks/table3_logsig.py
TABLE3 = [(32, 100, 6, 2), (32, 100, 6, 3), (32, 100, 6, 4),
          (64, 50, 4, 5), (64, 100, 4, 5), (16, 100, 10, 3)]
MAX_ROWS = (8, 32, 256)
# fused transform cases of phases 3, 6 and 13: raw (d, N) whose augmented
# alphabets (lead_lag 2d letters, time_augment+lead_lag 2d + 1) span 2 to
# 11 letters, the §8 width (d = 5) included
FUSED_SWEEP = [(1, 4), (2, 3), (3, 4), (5, 3)]
FUSED_SPECS = ("lead_lag", "time_augment+lead_lag")
# the transform cells of benchmarks/table1_runtime.py (run_levers):
# fused_transform at _LEVER_CELL_JAX, combined at _LEVER_CELL_PALLAS in
# bf16_fp32; (name, B, M, d, N, precision)
TABLE1_TRANSFORM = "time_augment+lead_lag"
TABLE1_FUSED = [("fused_transform", 32, 100, 6, 2, "fp32"),
                ("combined", 32, 100, 3, 3, "bf16_fp32")]
# Gram sweep: both sides of the 64- and 128-row tiles and of the 512-word
# blocks that split-K slices are made of
GRAM_B = (1, 7, 63, 64, 65, 128, 129, 130, 300)
GRAM_D = (1, 6, 127, 511, 512, 513, 1025, 1685, 9330)
# (B_x, B_y, D) at which every tile, split and copy width is forced
GRAM_VARIANTS = [(129, 130, 1025), (300, 257, 1685), (65, 1, 513),
                 (1, 129, 9330), (128, 128, 1024), (64, 300, 2048)]
GRAM_TOL = 1e-5     # |G − G_64| <= GRAM_TOL · max|G_64|
E2E_TOL = 1e-4      # composed results: signature kernel, then Gram
# scoring: R reference paths of M steps, d channels, depth, requests
SCORE_CELL = (2048, 1024, 6, 5, 256)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def trunc_partition(B: int, d: int, depth: int) -> dict:
    """The planner's sig_trunc partition for a (B, ·, d) batch."""
    p = st.plan_launch(B, d, depth)
    return dict(split=p.split, threads=p.threads, top_slots=p.top_slots,
                examples=p.examples, block=p.block,
                blocks=p.grid[0] * p.grid[1], smem=p.smem)


def words_partition(p) -> dict:
    """A sig_words partition (sw.plan_words_launch), as reported."""
    return dict(groups=len(p.groups), rows=p.rows, r_pad=p.r_pad,
                rows_per_thread=p.rows_per_thread,
                depth_slots=p.depth_slots, threads=p.threads,
                examples=p.examples, block=p.block,
                blocks=p.grid[0] * p.grid[1], chunk=p.chunk, smem=p.smem)


def trunc_case(case: str, shape: list, t: dict) -> dict:
    """One entry of the sig_trunc row's ``cases``."""
    part = trunc_partition(shape[0], shape[2], shape[3])
    return dict(case=case, shape=shape, partition=part, ms=t["ms"],
                bound_ms=t["bound_ms"], bound_by=t["bound_by"])


def reset_counts() -> None:
    """Every kernel's launch counters to 0, just before a path is driven."""
    st.launches = st.stream_launches = st.fused_launches = 0
    sw.launches = sw.stream_launches = sw.fused_launches = 0
    sg.launches = 0
    ss.launches = 0


def counts() -> dict:
    return dict(sig_trunc=st.launches, sig_trunc_stream=st.stream_launches,
                sig_trunc_fused=st.fused_launches, sig_words=sw.launches,
                sig_words_stream=sw.stream_launches,
                sig_words_fused=sw.fused_launches, sig_gram=sg.launches,
                sig_sweep=ss.launches)


def brownian(rng, B: int, M: int, d: int) -> torch.Tensor:
    """(B, M+1, d) Brownian paths on [0, 1] from 0, as
    benchmarks/common.py makes them."""
    incs = rng.normal(size=(B, M, d)) / np.sqrt(M)
    path = np.concatenate([np.zeros((B, 1, d)), np.cumsum(incs, axis=1)], 1)
    return torch.tensor(path, dtype=torch.float32, device="cuda")


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def cuda_ms_back_to_back(fn, n: int = 20, reps: int = 5) -> float:
    """Milliseconds per call of ``fn`` launched ``n`` times back to back
    (median over ``reps`` runs), by CUDA events: the device's time per call,
    with the host's work for one call overlapping the last call's."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def level_relerr(got: torch.Tensor, want: torch.Tensor, d: int,
                 depth: int) -> list[float]:
    errs, off = [], 0
    for n in range(1, depth + 1):
        g, w = got[..., off:off + d**n], want[..., off:off + d**n]
        errs.append(float((g - w).norm() / w.norm().clamp_min(1e-30)))
        off += d**n
    return errs


def phase_device() -> str:
    check(torch.cuda.is_available(), "no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)
    return smi


def phase_build() -> dict:
    """Build every kernel; returns {source: {kernel instance, as
    name<template integers>: {registers, stack bytes}}} from ptxas."""
    t0 = time.perf_counter()
    seconds = _build.build_all()
    print(f"[build] {seconds} ({time.perf_counter() - t0:.1f} s in all)")
    ptxas = {}
    for name, log in _build.build_log.items():
        entry = ""  # ptxas names each kernel instance before its figures
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
            elif "registers" in line or "spill" in line:
                print(f"[build] {name}: {entry}: {line.strip()}")
                m = re.search(r"(?<=\d)([a-z][a-z_]*_kernel)I(.*?)EEv",
                              entry)
                short = (f"{m.group(1)}<"
                         f"{','.join(re.findall(r'L[ib](\d+)E', m.group(2)))}>"
                         if m else entry)
                inst = ptxas.setdefault(name, {}).setdefault(short, {})
                for key, pat in (("registers", r"Used (\d+) registers"),
                                 ("stack", r"(\d+) bytes stack frame")):
                    m = re.search(pat, line)
                    if m:
                        inst[key] = int(m.group(1))
    sys.stdout.flush()
    return ptxas


def fused_batch(rng, B: int, M: int, d: int, spec) -> tuple:
    """Raw increments (B, M, d), float64 on the card, and the (B, 2) time
    rows of a ragged batch (lengths uniform in 0..M): the fused cells'
    inputs."""
    x = torch.tensor(rng.normal(size=(B, M, d)) * 0.3, device="cuda")
    lengths = torch.tensor(rng.integers(0, M + 1, size=B), device="cuda")
    return x, transform_time_aux(spec, B, M, lengths, device="cuda")


def phase_kernels(rng) -> dict:
    """Kernel against plain, every cell, with and without a fused
    transform; returns the max fp32 |error| per kernel name."""
    max_err = {"sig_trunc": 0.0, "sig_trunc_stream": 0.0}
    cases = 0
    for d, N in SWEEP:
        for M in (1, 37):
            x = torch.tensor(rng.normal(size=(5, M, d)) * 0.3,
                             device="cuda")
            cells = [(False, 1), (True, 1), (True, 3)]
            want = {c: st.sig_trunc_plain(x, N, stream=c[0],
                                          stream_stride=c[1]) for c in cells}
            for plan in st.partition_variants(len(x), d, N):
                part = (f"split={plan.split} threads={plan.threads} "
                        f"slots={plan.top_slots} examples={plan.examples}")
                for stream, stride in cells:
                    name = "sig_trunc_stream" if stream else "sig_trunc"
                    w = want[(stream, stride)]
                    got = st._launch(x.float(), N, None, stream, stride,
                                     "fp32", plan).double()
                    torch.cuda.synchronize()
                    err = float((got - w).abs().max())
                    ok = bool(((got - w).abs() <= TOL["atol"]
                               + TOL["rtol"] * w.abs()).all())
                    check(ok, f"{name} d={d} N={N} M={M} {part} "
                          f"stride={stride} fp32: max |err| {err:.3e}")
                    max_err[name] = max(max_err[name], err)
                    got = st._launch(x.float(), N, None, stream, stride,
                                     "bf16_fp32", plan).double()
                    rel = level_relerr(got, w, d, N)
                    check(all(e <= n * 2.0**-8 for n, e in
                              enumerate(rel, start=1)),
                          f"{name} d={d} N={N} M={M} {part} "
                          f"stride={stride} bf16_fp32: level errors {rel}")
                    cases += 2
                    print(f"[kernels] {name:16s} d={d:2d} N={N} M={M:2d} "
                          f"{part} stride={stride}: fp32 max|err| "
                          f"{err:.2e}, bf16 max level relerr {max(rel):.2e}")
    print(f"[kernels] {cases} cases within tolerance", flush=True)
    fused = phase_kernels_fused(rng)
    return {k: max(v, fused[k]) for k, v in max_err.items()}


def phase_kernels_fused(rng) -> dict:
    """The fused transform cases of phase 3: raw increments and ragged time
    rows into the kernel at every partition of the augmented alphabet,
    against the plain version (the fused scan) in float64."""
    max_err = {"sig_trunc": 0.0, "sig_trunc_stream": 0.0}
    cases = 0
    cells = [(False, 1), (True, 1), (True, 3)]
    for d, N in FUSED_SWEEP:
        for tname in FUSED_SPECS:
            spec = as_transform(tname)
            da = transform_dim(spec, d)
            for M in (1, 37):
                x, taux = fused_batch(rng, 5, M, d, spec)
                want = {c: st.sig_trunc_plain(x, N, stream=c[0],
                                              stream_stride=c[1],
                                              transform=spec, taux=taux)
                        for c in cells}
                for plan in st.partition_variants(len(x), da, N):
                    part = (f"split={plan.split} threads={plan.threads} "
                            f"slots={plan.top_slots} "
                            f"examples={plan.examples}")
                    for stream, stride in cells:
                        name = "sig_trunc_stream" if stream else "sig_trunc"
                        where = (f"{name} [{tname}] d={d} (d_aug={da}) N={N}"
                                 f" M={M} {part} stride={stride}")
                        w = want[(stream, stride)]
                        got = st._launch(x.float(), N, None, stream, stride,
                                         "fp32", plan, spec, taux).double()
                        torch.cuda.synchronize()
                        check(got.shape == w.shape, f"{where}: shape")
                        err = float((got - w).abs().max())
                        check(within(got, w, TOL["rtol"]),
                              f"{where} fp32: max |err| {err:.3e}")
                        max_err[name] = max(max_err[name], err)
                        got = st._launch(x.float(), N, None, stream, stride,
                                         "bf16_fp32", plan, spec,
                                         taux).double()
                        rel = level_relerr(got, w, da, N)
                        check(all(e <= n * 2.0**-8 for n, e in
                                  enumerate(rel, start=1)),
                              f"{where} bf16_fp32: level errors {rel}")
                        cases += 2
                print(f"[kernels] fused [{tname}] d={d} (d_aug={da}) N={N} "
                      f"M={M:2d}: max|err| {max(max_err.values()):.2e}",
                      flush=True)
    print(f"[kernels] {cases} fused transform cases within tolerance",
          flush=True)
    return max_err


def serving_inputs(rng, n: int, d: int, lo: int, hi: int) -> list:
    lengths = np.round(np.exp(rng.uniform(np.log(lo), np.log(hi), n)))
    return [np.cumsum(np.concatenate([np.zeros((1, d)), rng.normal(
        size=(int(L), d)) / np.sqrt(L)]), axis=0).astype(np.float32)
        for L in lengths]


def phase_serve(rng) -> dict:
    d, depth, max_len = 6, 5, 1024
    svc = DynamicBatcher.signature_service(d=d, depth=depth,
                                           max_len=max_len)
    reqs = serving_inputs(rng, 256, d, 16, max_len)
    reset_counts()
    t0 = time.perf_counter()
    tickets = [svc.submit(p) for p in reqs]
    out = svc.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, stream_launches = st.launches, st.stream_launches
    stats = svc.stats()
    print(f"[serve] {len(reqs)} requests in {wall * 1e3:.1f} ms "
          f"(first flush, includes host packing); stats {json.dumps(stats)}")
    print(f"[serve] sig_trunc launches {launches}, micro-batches "
          f"{stats['batches']}")
    check(launches > 0 and launches == stats["batches"],
          f"sig_trunc launched {launches} times for {stats['batches']} "
          "micro-batches")
    check(stream_launches == 0, "the serving path launched a streamed cell")
    D = sum(d**n for n in range(1, depth + 1))
    for t in tickets:
        check(out[t].shape == (D,) and bool(torch.isfinite(out[t]).all()),
              f"ticket {t}: bad answer")
    worst = 0.0
    for i in rng.choice(len(reqs), 32, replace=False):
        x = tops.path_increments(torch.tensor(reqs[i], dtype=torch.float64,
                                              device="cuda"))[None]
        want = st.sig_trunc_plain(x, depth)[0]
        got = out[tickets[i]].double()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        check(bool(((got - want).abs() <= TOL["atol"]
                    + TOL["rtol"] * want.abs()).all()),
              f"request {i} (length {len(reqs[i]) - 1}): max |err| {err}")
    print(f"[serve] 32 sampled answers match the unpadded plain version, "
          f"max |err| {worst:.2e}", flush=True)
    # time the kernel on the largest micro-batch the main path fed it
    rung, B_pad = max(stats["shapes"], key=lambda s: s[0] * s[1])
    which = assign_buckets([len(p) - 1 for p in reqs], svc.ladder)
    part = [p for p, k in zip(reqs, which) if svc.ladder[k] == rung][:B_pad]
    rp = pad_batch(RaggedPaths.from_list(part, pad_to=rung), B_pad)
    incs = rp.increments()
    ms = cuda_ms(lambda: st.sig_trunc(incs, depth), 10)
    plain_ms = cuda_ms(lambda: st.sig_trunc_plain(incs, depth), 1)
    bms, by = bound(B_pad, rung, d, depth, 4, B_pad * D, 4)
    print(f"[serve] sig_trunc at the largest micro-batch (B={B_pad}, "
          f"M={rung}, d={d}, N={depth}, "
          f"{trunc_partition(B_pad, d, depth)}): {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bms:.4f} ms ({by})", flush=True)
    return dict(launches=launches, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, shape=[B_pad, rung, d, depth], stats=stats,
                wall_ms=wall * 1e3)


def phase_dispatch(rng) -> tuple[list, dict]:
    rows = []
    for B, M, d, N in TABLE1:
        # increments of a Brownian path on [0, 1], as benchmarks/common.py
        incs = torch.tensor(rng.normal(size=(B, M, d)) / np.sqrt(M),
                            dtype=torch.float32, device="cuda")
        got = ops.signature(incs, N)
        want = st.sig_trunc_plain(incs.double(), N)
        check(bool(torch.isfinite(got).all()), f"Table 1 cell {B, M, d, N}")
        torch.testing.assert_close(got.double(), want, **TOL)
        ms = cuda_ms(lambda: ops.signature(incs, N), 5)
        plain_ms = cuda_ms(lambda: st.sig_trunc_plain(incs, N), 1)
        D = sum(d**n for n in range(1, N + 1))
        bms, by = bound(B, M, d, N, 4, B * D, 4)
        rows.append(dict(B=B, M=M, d=d, N=N,
                         partition=trunc_partition(B, d, N), ms=ms,
                         plain_ms=plain_ms, bound_ms=bms, bound_by=by))
        print(f"[dispatch] B={B:3d} M={M:3d} d={d:2d} N={N}: kernel "
              f"{ms:8.3f} ms, plain {plain_ms:9.3f} ms, bound {bms:.4f} ms "
              f"({by})", flush=True)
    B, M, d, N, stride = STREAM_CELL
    path = torch.tensor(np.cumsum(rng.normal(size=(B, M + 1, d))
                                  / np.sqrt(M), axis=1),
                        dtype=torch.float32, device="cuda")
    reset_counts()
    out = sig.signature(path, N, stream=True, stream_stride=stride)
    torch.cuda.synchronize()
    launches = st.stream_launches
    check(launches > 0, "the streamed cell did not launch the kernel")
    incs = path[:, 1:] - path[:, :-1]
    want = st.sig_trunc_plain(incs.double(), N, stream=True,
                              stream_stride=stride)
    check(out.shape == want.shape, f"streamed shape {tuple(out.shape)}")
    torch.testing.assert_close(out.double(), want, **TOL)
    ms = cuda_ms(lambda: st.sig_trunc(incs, N, stream=True,
                                      stream_stride=stride), 5)
    plain_ms = cuda_ms(lambda: st.sig_trunc_plain(
        incs, N, stream=True, stream_stride=stride), 1)
    bms, by = bound(B, M, d, N, 4, out.numel(), 4)
    print(f"[dispatch] streamed B={B} M={M} d={d} N={N} stride={stride}: "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bms:.4f} ms "
          f"({by}), launches {launches}", flush=True)
    return rows, dict(launches=launches, ms=ms, plain_ms=plain_ms,
                      bound_ms=bms, bound_by=by,
                      shape=[B, M, d, N, stride])


def word_sets(rng) -> list:
    """(name, d, words) of phase 6: four fixed sets and 20 random ones."""
    sets = [("all_words(3,4)", 3, all_words(3, 4)),
            ("sparse d=4", 4, [(0,), (3, 2), (1, 1, 1, 1), (2, 0, 3),
                               (3, 3)]),
            ("anisotropic(1,2,1.5;4)", 3,
             anisotropic_words((1.0, 2.0, 1.5), 4.0)),
            ("all_words(2,4)+Lyndon_5", 2, all_words(2, 4)
             + [w for w in lyndon_words(2, 5) if len(w) == 5])]
    for i in range(20):
        d = int(rng.integers(2, 5))
        words = [tuple(int(c) for c in rng.integers(0, d, rng.integers(1, 5)))
                 for _ in range(int(rng.integers(1, 13)))]
        sets.append((f"random {i} d={d}", d, words))
    return sets


def full_level_errors(got: torch.Tensor, want: torch.Tensor, words,
                      d: int) -> dict[int, float]:
    """Relative error of the coefficients of each full level (every word
    of that length is requested).  A sparse level can hold one coefficient
    that cancels, where bf16 input rounding has no relative bound."""
    errs = {}
    for n in sorted({len(w) for w in words}):
        idx = [k for k, w in enumerate(words) if len(w) == n]
        if len({words[k] for k in idx}) < d**n:
            continue
        g, w = got[..., idx], want[..., idx]
        errs[n] = float((g - w).norm() / w.norm().clamp_min(1e-30))
    return errs


def within(got: torch.Tensor, want: torch.Tensor, rtol: float) -> bool:
    return bool(((got - want).abs() <= TOL["atol"]
                 + rtol * want.abs()).all())


def phase_words_kernels(rng) -> tuple[dict, list, list]:
    """sig_words against its plain version, every cell, at every
    partition the planner can choose (sw.partition_variants), with and
    without a fused transform; returns the max fp32 |error| per kernel
    name, the word sets and the fused word sets.  bf16_fp32 is held
    against the plain version on the same bf16-rounded increments
    (streamed emissions within one bf16 rounding, 2^-8), and each full
    level against the unrounded answer within n·2^-8."""
    max_err = {"sig_words": 0.0, "sig_words_stream": 0.0}
    cases = 0
    cells = [(False, 1), (True, 1), (True, 3)]
    sets = word_sets(rng)
    for name, d, words in sets:
        for M in (1, 37):
            x = torch.tensor(rng.normal(size=(5, M, d)) * 0.3, device="cuda")
            xq = x.float().to(torch.bfloat16).double()
            for max_rows in MAX_ROWS:
                tp = make_tiled_plan(words, d, max_rows=max_rows)
                plans = sw.partition_variants(5, sw.tile_tables(tp), d)
                for stream, stride in cells:
                    kname = "sig_words_stream" if stream else "sig_words"
                    kw = dict(stream=stream, stream_stride=stride)
                    want = sw.sig_words_plain(x, tp, **kw)
                    want_q = sw.sig_words_plain(xq, tp, **kw)
                    for plan in plans:
                        where = (f"{kname} [{name}] M={M} max_rows="
                                 f"{max_rows} tiles={len(tp.tiles)} "
                                 f"stride={stride} {words_partition(plan)}")
                        got = sw._launch(x.float(), tp, stream, stride,
                                         "fp32", plan).double()
                        torch.cuda.synchronize()
                        check(got.shape == want.shape, f"{where}: shape")
                        err = float((got - want).abs().max())
                        check(within(got, want, TOL["rtol"]),
                              f"{where} fp32: max |err| {err:.3e}")
                        max_err[kname] = max(max_err[kname], err)
                        got = sw._launch(x.float(), tp, stream, stride,
                                         "bf16_fp32", plan).double()
                        errq = float((got - want_q).abs().max())
                        check(within(got, want_q,
                                     2.0**-8 if stream else TOL["rtol"]),
                              f"{where} bf16_fp32 vs plain on the rounded "
                              f"increments: max |err| {errq:.3e}")
                        rel = full_level_errors(got, want, tp.words, d)
                        check(all(e <= n * 2.0**-8 for n, e in rel.items()),
                              f"{where} bf16_fp32: full-level errors {rel}")
                        cases += 2
            print(f"[words] {name:24s} d={d} M={M:2d} {len(words):3d} words: "
                  f"max|err| {max(max_err.values()):.2e}", flush=True)
    print(f"[words] {cases} cases within tolerance", flush=True)
    fsets = fused_word_sets(rng)
    fused = phase_words_fused(rng, fsets)
    return {k: max(v, fused[k]) for k, v in max_err.items()}, sets, fsets


def fused_word_sets(rng) -> list:
    """(name, d_raw, transform, words over the augmented alphabet) of the
    fused cases: a random set for each raw d in 1..3 and transform, and
    the §8 sparse lead-lag set at d = 2."""
    sets = []
    for d in (1, 2, 3):
        for tname in FUSED_SPECS:
            da = transform_dim(tname, d)
            words = [tuple(int(c) for c in rng.integers(
                0, da, rng.integers(1, 5)))
                for _ in range(int(rng.integers(3, 13)))]
            sets.append((f"random {tname} d={d}", d, tname, words))
    sets.append(("§8 lead_lag d=2", 2, "lead_lag",
                 generated_words(sparse_leadlag_generators(2), 4)))
    return sets


def phase_words_fused(rng, fsets) -> dict:
    """The fused transform cases of phase 6: raw increments and ragged time
    rows into sig_words at every partition of the augmented alphabet's
    tiles, against the plain version (the fused scan) in float64; bf16 as
    in phase 6."""
    max_err = {"sig_words": 0.0, "sig_words_stream": 0.0}
    cases = 0
    cells = [(False, 1), (True, 1), (True, 3)]
    for name, d, tname, words in fsets:
        spec = as_transform(tname)
        da = transform_dim(spec, d)
        for M in (1, 37):
            x, taux = fused_batch(rng, 5, M, d, spec)
            xq = x.float().to(torch.bfloat16).double()
            for max_rows in (8, 256):
                tp = make_tiled_plan(words, da, max_rows=max_rows)
                plans = sw.partition_variants(5, sw.tile_tables(tp), da,
                                              lead_lag=spec.lead_lag)
                for stream, stride in cells:
                    kname = "sig_words_stream" if stream else "sig_words"
                    kw = dict(stream=stream, stream_stride=stride,
                              transform=spec, taux=taux)
                    want = sw.sig_words_plain(x, tp, **kw)
                    want_q = sw.sig_words_plain(xq, tp, **kw)
                    for plan in plans:
                        where = (f"{kname} [{name}] M={M} max_rows="
                                 f"{max_rows} stride={stride} "
                                 f"{words_partition(plan)}")
                        got = sw._launch(x.float(), tp, stream, stride,
                                         "fp32", plan, spec, taux).double()
                        torch.cuda.synchronize()
                        check(got.shape == want.shape, f"{where}: shape")
                        err = float((got - want).abs().max())
                        check(within(got, want, TOL["rtol"]),
                              f"{where} fp32: max |err| {err:.3e}")
                        max_err[kname] = max(max_err[kname], err)
                        got = sw._launch(x.float(), tp, stream, stride,
                                         "bf16_fp32", plan, spec,
                                         taux).double()
                        errq = float((got - want_q).abs().max())
                        check(within(got, want_q,
                                     2.0**-8 if stream else TOL["rtol"]),
                              f"{where} bf16_fp32 vs plain on the rounded "
                              f"increments: max |err| {errq:.3e}")
                        rel = full_level_errors(got, want, tp.words, da)
                        check(all(e <= n * 2.0**-8 for n, e in rel.items()),
                              f"{where} bf16_fp32: full-level errors {rel}")
                        cases += 2
        print(f"[words] fused {name:28s} (d_aug={da}) {len(words):3d} "
              f"words: max|err| {max(max_err.values()):.2e}", flush=True)
    print(f"[words] {cases} fused transform cases within tolerance",
          flush=True)
    return max_err


def phase_cross(rng) -> dict:
    """Two independent kernels agree: sig_words over the full truncation
    and sig_trunc."""
    B, M, d, N = CROSS_CELL
    incs = tops.path_increments(brownian(rng, B, M, d))
    reset_counts()
    a = ops.projected(incs, all_words(d, N))
    b = ops.signature(incs, N)
    torch.cuda.synchronize()
    n = counts()
    check(n["sig_words"] == 1 and n["sig_trunc"] == 1,
          f"cross-kernel launches {n}")
    err = float((a - b).abs().max())
    torch.testing.assert_close(a, b, **TOL)
    print(f"[cross] ops.projected(all_words({d},{N})) == ops.signature(·, "
          f"{N}) at (B={B}, M={M}): max |diff| {err:.2e}", flush=True)
    return dict(shape=[B, M, d, N], max_abs_diff=err)


def phase_projection(rng) -> dict:
    """The §8 sparse lead-lag projection at full width through the user
    entry points; returns the measurements of both sig_words cells."""
    B, M, d, N, stride = PROJ_CELL
    path = brownian(rng, B, M, d)
    lengths = torch.tensor(rng.integers(M // 4, M + 1, size=B),
                           dtype=torch.int32, device="cuda")
    words = generated_words(sparse_leadlag_generators(d), N)
    plan = make_plan(words, 2 * d)
    tp = make_tiled_plan(words, 2 * d)
    ctp = make_tiled_plan(prefix_closure(words), 2 * d)
    print(f"[project] {len(words)} words over {2 * d} letters, closure "
          f"{plan.closure_size}; {len(tp.tiles)} tiles (largest "
          f"{max(p.closure_size for p in tp.tiles)} rows), closure "
          f"{len(ctp.tiles)} tiles", flush=True)
    reset_counts()
    t0 = time.perf_counter()
    incs = tops.path_increments(lead_lag(path))        # (B, 2M, 2d)
    full = projected_signature_from_increments(incs, plan)
    torch.cuda.synchronize()
    n1 = counts()
    fwd = ops.projected_forward_only(incs, plan)
    torch.cuda.synchronize()
    n2 = counts()
    ll, ll_len = lead_lag(path, lengths)
    ragged = ops.projected(tops.path_increments(ll), plan, lengths=ll_len)
    torch.cuda.synchronize()
    n3 = counts()
    stream = projected_signature_from_increments(incs, plan, stream=True,
                                                 stream_stride=stride)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n4 = counts()
    print(f"[project] 4 calls in {wall * 1e3:.1f} ms (first calls: plans, "
          f"tables and host work included); launches after each call "
          f"{[n['sig_words'] for n in (n1, n2, n3, n4)]} / streamed "
          f"{n4['sig_words_stream']}", flush=True)
    check((n1["sig_words"], n2["sig_words"], n3["sig_words"],
           n4["sig_words"], n4["sig_words_stream"]) == (1, 2, 3, 3, 1),
          f"each projection call launches sig_words once: {n1} {n2} {n3} "
          f"{n4}")
    check(n4["sig_trunc"] == n4["sig_trunc_stream"] == 0,
          "the projection path launched sig_trunc")
    M2 = 2 * M
    check(full.shape == fwd.shape == ragged.shape == (B, len(words)),
          f"shapes {full.shape} {fwd.shape} {ragged.shape}")
    check(stream.shape == (B, -(-M2 // stride), len(words)),
          f"streamed shape {tuple(stream.shape)}")
    for name, out in (("full", full), ("fwd", fwd), ("ragged", ragged),
                      ("stream", stream)):
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite values")
    want = sw.sig_words_plain(incs.double(), tp)
    torch.testing.assert_close(full.double(), want, **TOL)
    torch.testing.assert_close(fwd.double(), want, **TOL)
    err = float((full.double() - want).abs().max())
    want_s = sw.sig_words_plain(incs.double(), tp, stream=True,
                                stream_stride=stride)
    torch.testing.assert_close(stream.double(), want_s, **TOL)
    err_s = float((stream.double() - want_s).abs().max())
    worst = 0.0
    sampled = rng.choice(B, min(16, B), replace=False)
    for i in sampled:
        L = int(lengths[i])
        x = tops.path_increments(lead_lag(path[i, :L + 1].double()))[None]
        w = sw.sig_words_plain(x, tp)[0]
        torch.testing.assert_close(ragged[i].double(), w, **TOL)
        worst = max(worst, float((ragged[i].double() - w).abs().max()))
    print(f"[project] values match the plain version: max |err| {err:.2e} "
          f"(full), {err_s:.2e} (stream), {worst:.2e} ({len(sampled)} "
          "ragged rows on their unpadded paths)", flush=True)
    ms = cuda_ms(lambda: sw.sig_words(incs, tp), 10)
    plain_ms = cuda_ms(lambda: sw.sig_words_plain(incs, tp), 1)
    # half of each lead-lag increment is zero: count the letters that move
    ll_flops = fused_step_flops(as_transform("lead_lag"), d,
                                lambda m: words_flops(plan, m))
    bms, by = bound(B, M2, 2 * d, N, 4, B * len(words), 4, ll_flops)
    ms_s = cuda_ms(lambda: sw.sig_words(incs, ctp, stream=True,
                                        stream_stride=stride), 10)
    plain_ms_s = cuda_ms(lambda: sw.sig_words_plain(
        incs, ctp, stream=True, stream_stride=stride), 1)
    bms_s, by_s = bound(B, M2, 2 * d, N, 4,
                        B * (-(-M2 // stride)) * len(ctp.words), 4, ll_flops)
    trunc_ms = cuda_ms(lambda: ops.signature(incs, N), 10)
    part = words_partition(sw.plan_words_launch(B, sw.tile_tables(tp), 2 * d))
    part_s = words_partition(sw.plan_words_launch(B, sw.tile_tables(ctp),
                                                  2 * d))
    print(f"[project] sig_words (B={B}, M={M2}, d={2 * d}, {len(words)} "
          f"words, {len(tp.tiles)} tiles, {part}): {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bms:.4f} ms ({by}); truncated "
          f"ops.signature(·, {N}) ({sum((2 * d)**k for k in range(1, N + 1))}"
          f" coefficients): {trunc_ms:.3f} ms", flush=True)
    print(f"[project] sig_words_stream (stride {stride}, closure "
          f"{len(ctp.words)} words, {len(ctp.tiles)} tiles, {part_s}): "
          f"{ms_s:.3f} ms, plain {plain_ms_s:.3f} ms, bound {bms_s:.4f} ms "
          f"({by_s})", flush=True)
    return dict(partition=part, stream_partition=part_s,
        launches=n4["sig_words"], stream_launches=n4["sig_words_stream"],
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        stream_ms=ms_s, stream_plain_ms=plain_ms_s, stream_bound_ms=bms_s,
        stream_bound_by=by_s, trunc_ms=trunc_ms, wall_ms=wall * 1e3,
        max_abs_err=max(err, err_s, worst),
        shape=[B, M2, 2 * d, N, stride], words=len(words),
        closure=plan.closure_size, tiles=len(tp.tiles),
        closure_tiles=len(ctp.tiles))


def phase_logsig(rng) -> list:
    """logsignature_projected on the card at the Table 3 cells, and the
    sig_words kernel alone over each cell's closure tiles (as ops.projected
    tiles W_{<=N-1} ∪ Lyndon_N)."""
    rows = []
    for B, M, d, N in TABLE3:
        path = brownian(rng, B, M, d)
        reset_counts()
        got = logsignature_projected(path, N)
        torch.cuda.synchronize()
        n = counts()
        check(n["sig_words"] == 1 and n["sig_trunc"] == 0,
              f"Table 3 cell {B, M, d, N}: launches {n}")
        want = logsignature(path.double(), N, backend="torch")
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"Table 3 cell {B, M, d, N}: shape {tuple(got.shape)}")
        torch.testing.assert_close(got.double(), want, **TOL)
        err = float((got.double() - want).abs().max())
        ms = cuda_ms(lambda: logsignature_projected(path, N), 5)
        dense_ms = cuda_ms(lambda: logsignature(path, N), 5)
        plan = make_plan(all_words(d, N - 1) + [
            w for w in lyndon_words(d, N) if len(w) == N], d)
        ctp = make_tiled_plan(plan.closure, d)
        incs = tops.path_increments(path)
        kms = cuda_ms(lambda: sw.sig_words(incs, ctp), 10)
        kplain = cuda_ms(lambda: sw.sig_words_plain(incs, ctp), 1)
        bms, by = bound(B, M, d, N, 4, B * plan.closure_size, 4,
                        words_flops(plan))
        rows.append(dict(B=B, M=M, d=d, N=N, launches=n["sig_words"],
                         max_abs_err=err, ms=ms, dense_ms=dense_ms,
                         words=plan.closure_size, kernel_ms=kms,
                         kernel_plain_ms=kplain, bound_ms=bms, bound_by=by,
                         partition=words_partition(sw.plan_words_launch(
                             B, sw.tile_tables(ctp), d))))
        print(f"[logsig] B={B:2d} M={M:3d} d={d:2d} N={N}: projected "
              f"(sig_words) {ms:7.3f} ms, dense (sig_trunc) {dense_ms:7.3f} "
              f"ms, max |err| vs dense torch {err:.2e}; sig_words alone over "
              f"{plan.closure_size} words {kms:.4f} ms, plain {kplain:.3f} "
              f"ms, bound {bms:.4f} ms ({by}), {rows[-1]['partition']}",
              flush=True)
    return rows


def gram_within(got: torch.Tensor, want: torch.Tensor, tol: float) -> bool:
    """|got − want| <= tol · max|want| (exactly equal when want is 0)."""
    return float((got.double() - want).abs().max()) \
        <= tol * float(want.abs().max())


def gram_weights(rng, D: int) -> list:
    """(name, weights) cases of phase 10 at width D, float64 on the card."""
    u = rng.uniform(0.2, 2.0, D)
    half = np.where(rng.random(D) < 0.5, 0.0, u)
    cases = [("uniform", u), ("half zero", half), ("zero", np.zeros(D))]
    if D == 9330:  # the scoring configuration's anisotropic weights
        cases.append(("gamma", word_weights(
            6, 5, gamma=np.linspace(0.5, 2.0, 6)).astype(np.float64)))
    return [(n, torch.tensor(w, device="cuda")) for n, w in cases]


def phase_gram_kernels(rng) -> float:
    """sig_gram against its plain version in float64; returns the max fp32
    |error| with uniform weights."""
    max_err, cases = 0.0, 0
    for D in GRAM_D:
        for Bx in GRAM_B:
            for By in GRAM_B:
                x = torch.tensor(rng.normal(size=(Bx, D)), device="cuda")
                y = torch.tensor(rng.normal(size=(By, D)), device="cuda")
                xq, yq = (a.float().to(torch.bfloat16).double()
                          for a in (x, y))
                for name, w in gram_weights(rng, D):
                    where = f"sig_gram B_x={Bx} B_y={By} D={D} [{name}]"
                    want = sg.sig_gram_plain(x, y, w)
                    got = sg.sig_gram(x.float(), y.float(), w.float())
                    torch.cuda.synchronize()
                    check(got.shape == (Bx, By), f"{where}: shape")
                    err = float((got.double() - want).abs().max())
                    check(gram_within(got, want, GRAM_TOL),
                          f"{where} fp32: max |err| {err:.3e}, max|G| "
                          f"{float(want.abs().max()):.3e}")
                    if name == "uniform":
                        max_err = max(max_err, err)
                    got = ops.gram(x.float(), y.float(), w.float(),
                                   precision="bf16_fp32")
                    want = sg.sig_gram_plain(xq, yq, w)
                    check(gram_within(got, want, GRAM_TOL),
                          f"{where} bf16_fp32 vs plain on the rounded "
                          f"operands: max |err| "
                          f"{float((got.double() - want).abs().max()):.3e}")
                    cases += 2
        print(f"[gram] D={D:5d}: every B_x, B_y and weight case within "
              f"{GRAM_TOL}·max|G| (max fp32 |err| so far {max_err:.2e})",
              flush=True)
    print(f"[gram] {cases} cases within tolerance", flush=True)
    return max_err


def phase_gram_variants(rng) -> int:
    """Every tile variant (64 and 128 rows), split width (one, two or all
    512-word blocks a slice) and copy width (1, 2 or 4 floats, as far as D
    and the pointers allow), forced through the launcher at ragged shapes
    the planner would route otherwise; and an operand whose base lies
    4 bytes off 16 (a contiguous view at storage offset 1)."""
    cases = 0
    for Bx, By, D in GRAM_VARIANTS:
        x = torch.tensor(rng.normal(size=(Bx, D)), device="cuda")
        y = torch.tensor(rng.normal(size=(By, D)), device="cuda")
        w = torch.tensor(rng.uniform(0.2, 2.0, D), device="cuda")
        want = sg.sig_gram_plain(x, y, w)
        xf, yf, wf = x.float(), y.float(), w.float()
        top = sg.copy_width(D, xf.data_ptr(), yf.data_ptr())
        for rows in (64, 128):
            for width in sorted({512, 1024, -(-D // 512) * 512}):
                for vec in (v for v in (1, 2, 4) if v <= top):
                    got = sg._launch(xf, yf, wf, rows, width, vec)
                    err = float((got.double() - want).abs().max())
                    check(gram_within(got, want, GRAM_TOL),
                          f"sig_gram {[Bx, By, D]} rows {rows} slice "
                          f"{width} vec {vec}: max |err| {err:.3e}")
                    cases += 1
        buf = torch.empty(Bx * D + 1, dtype=torch.float32, device="cuda")
        xo = buf[1:].view(Bx, D)
        xo.copy_(xf)
        check(sg.copy_width(D, xo.data_ptr()) == 1, "offset view's width")
        check(gram_within(sg.sig_gram(xo, yf, wf), want, GRAM_TOL),
              f"sig_gram {[Bx, By, D]} with S_x at storage offset 1")
        cases += 1
    print(f"[gram] {cases} forced tile, split and copy-width cases within "
          f"tolerance", flush=True)
    return cases


def time_gram(Sx: torch.Tensor, Sy: torch.Tensor, w: torch.Tensor) -> dict:
    """Kernel, plain and library times (ms) of one Gram, and its bounds.
    The library call is torch.matmul in full FP32 (TF32 off).  ``ms`` and
    ``library_ms`` are times per call of 20 calls back to back; the
    ``call_ms`` are one call alone, the host's work in the wrapper (or in
    PyTorch) included.  Two kernel runs must agree bit for bit (split-K
    sums its slices in order)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lib = cuda_ms_back_to_back(lambda: torch.matmul(Sx * w, Sy.T))
        lib_call = cuda_ms(lambda: torch.matmul(Sx * w, Sy.T), 10)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (Bx, D), By = Sx.shape, Sy.shape[0]
    check(torch.equal(sg.sig_gram(Sx, Sy, w), sg.sig_gram(Sx, Sy, w)),
          f"sig_gram {[Bx, By, D]}: two runs differ")
    slices = sg.word_slices(Bx, By, D, torch.cuda.get_device_properties(
        0).multi_processor_count)
    return dict(shape=[Bx, By, D], slices=len(slices),
                ms=cuda_ms_back_to_back(lambda: sg.sig_gram(Sx, Sy, w)),
                call_ms=cuda_ms(lambda: sg.sig_gram(Sx, Sy, w), 10),
                plain_ms=cuda_ms(lambda: sg.sig_gram_plain(Sx, Sy, w), 3),
                library_ms=lib, library_call_ms=lib_call,
                **gram_bound(Bx, By, D))


def print_gram(where: str, t: dict) -> None:
    print(f"{where} sig_gram {t['shape']} ({t['slices']} word slices): "
          f"{t['ms']:.4f} ms a call back to back ({t['call_ms']:.4f} alone), "
          f"plain {t['plain_ms']:.3f} ms, library (torch.matmul, TF32 off) "
          f"{t['library_ms']:.4f} ms ({t['library_call_ms']:.4f} alone), "
          f"bound {t['bound_ms']:.4f} ms on the tensor cores in 3xTF32 "
          f"({t['bound_by']}; held to), {t['fp32_bound_ms']:.4f} ms on the "
          f"FP32 cores ({t['fp32_bound_by']})", flush=True)


def levy_area(paths: torch.Tensor) -> torch.Tensor:
    """(B, M+1, d) -> (B,) Lévy area of channels 0 and 1, in float64."""
    p = paths.double()
    dx = p[:, 1:] - p[:, :-1]
    return 0.5 * (p[:, :-1, 0] * dx[..., 1] - p[:, :-1, 1] * dx[..., 0]).sum(1)


def phase_scoring(rng) -> dict:
    """SigScoreEngine at full width and DynamicBatcher.scoring_service in
    every mode; returns the measurements."""
    R, M, d, depth, n_req = SCORE_CELL
    gamma = tuple(float(g) for g in np.linspace(0.5, 2.0, d))
    refs = brownian(rng, R, M, d)
    targets = levy_area(refs).float()
    reset_counts()
    t0 = time.perf_counter()
    eng = SigScoreEngine(d=d, depth=depth, batch=1, references=refs,
                         targets=targets, gamma=gamma, reg=1e-3)
    torch.cuda.synchronize()
    eng_ms = (time.perf_counter() - t0) * 1e3
    n_eng = counts()
    check(n_eng["sig_trunc"] == 1 and n_eng["sig_gram"] == 1,
          f"the engine's reference state launched {n_eng}")
    D = eng.ref_sigs.shape[1]
    print(f"[score] SigScoreEngine R={R} M={M} d={d} depth={depth} "
          f"(D={D}): {eng_ms:.1f} ms wall (reference signatures, Gram, KRR "
          f"solve); launches {n_eng}", flush=True)
    # the cached state against the plain versions
    idx = rng.choice(R, 32, replace=False)
    incs = tops.path_increments(refs[idx].double())
    torch.testing.assert_close(eng.ref_sigs[idx].double(),
                               st.sig_trunc_plain(incs, depth), **TOL)
    S64, w64 = eng.ref_sigs.double(), eng.weights.double()
    G64 = sg.sig_gram_plain(S64, S64, w64)
    gerr = float((eng.ref_gram.double() - G64).abs().max())
    check(gram_within(eng.ref_gram, G64, GRAM_TOL),
          f"reference Gram: max |err| {gerr:.3e}")
    A = eng.ref_gram.double() + 1e-3 * torch.eye(R, dtype=torch.float64,
                                                 device="cuda")
    alpha64 = eng.alpha.double()
    resid = float((A @ alpha64 - targets.double()).norm()
                  / (A.norm() * alpha64.norm()))
    check(bool(torch.isfinite(eng.alpha).all()) and resid <= 1e-4,
          f"KRR duals: relative residual {resid:.3e}")
    print(f"[score] reference signatures (32 rows) and Gram match the plain "
          f"versions (Gram max |err| {gerr:.2e}, max|G| "
          f"{float(G64.abs().max()):.3e}); KRR relative residual "
          f"{resid:.2e}", flush=True)
    reqs = serving_inputs(rng, n_req, d, 16, M)
    flushes = {}
    for mode in ("scores", "nearest", "predict"):
        svc = DynamicBatcher.scoring_service(eng, max_len=M, mode=mode)
        reset_counts()
        t0 = time.perf_counter()
        tickets = [svc.submit(p) for p in reqs]
        out = svc.flush()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        n, stats = counts(), svc.stats()
        check(n["sig_trunc"] == n["sig_gram"] == stats["batches"] > 0
              and n["sig_words"] == n["sig_trunc_stream"] == 0,
              f"{mode}: launches {n} for {stats['batches']} micro-batches")
        shape = (R,) if mode == "scores" else ()
        for t in tickets:
            check(tuple(out[t].shape) == shape
                  and bool(torch.isfinite(out[t].double()).all()),
                  f"{mode}: ticket {t} answered {tuple(out[t].shape)}")
        flushes[mode] = dict(wall_ms=wall, launches=n, stats=stats,
                             out=[out[t] for t in tickets])
        print(f"[score] {mode:8s} flush of {n_req} requests: {wall:.1f} ms "
              f"wall, {stats['batches']} micro-batches, launches "
              f"sig_trunc {n['sig_trunc']} sig_gram {n['sig_gram']}",
              flush=True)
    # 32 answers per mode against the unpadded plain path
    rn = torch.sqrt(torch.clamp_min(gram_diag(S64, w64), 1e-12))
    errs, ties = dict(scores=0.0, predict=0.0), 0
    sampled = rng.choice(n_req, min(32, n_req), replace=False)
    for i in sampled:
        x = tops.path_increments(torch.tensor(reqs[i], dtype=torch.float64,
                                              device="cuda"))[None]
        S = ops.signature(x, depth, backend="torch")
        K = sg.sig_gram_plain(S, S64, w64)[0]
        qn = torch.sqrt(torch.clamp_min(gram_diag(S, w64), 1e-12))
        want = K / (qn * rn)
        got = flushes["scores"]["out"][i].double()
        err = float((got - want).abs().max())
        errs["scores"] = max(errs["scores"], err)
        check(err <= E2E_TOL * float(want.abs().max()),
              f"scores of request {i}: max |err| {err:.3e}")
        near = int(flushes["nearest"]["out"][i])
        if near != int(want.argmax()):
            check(float(want.max() - want[near])
                  <= E2E_TOL * float(want.abs().max()),
                  f"nearest of request {i}: {near}, plain argmax "
                  f"{int(want.argmax())}")
            ties += 1
        pred = float(K @ alpha64)
        err = abs(float(flushes["predict"]["out"][i]) - pred)
        errs["predict"] = max(errs["predict"], err)
        check(err <= E2E_TOL * float(K.abs() @ alpha64.abs()),
              f"prediction of request {i}: |err| {err:.3e} (plain {pred})")
    print(f"[score] {len(sampled)} answers per mode match the unpadded "
          f"plain path: "
          f"scores max |err| {errs['scores']:.2e}, predictions max |err| "
          f"{errs['predict']:.2e}, nearest equal to the plain argmax "
          f"({ties} ties within tolerance)", flush=True)
    # kernel times: the reference Gram and the largest cross-Gram
    ref = time_gram(eng.ref_sigs, eng.ref_sigs, eng.weights)
    stats = flushes["scores"]["stats"]
    rung, B_pad = max(stats["shapes"], key=lambda s: s[0] * s[1])
    which = assign_buckets([len(p) - 1 for p in reqs], np.asarray(
        stats["ladder"]))
    part = [p for p, k in zip(reqs, which) if stats["ladder"][k] == rung]
    rp = pad_batch(RaggedPaths.from_list(part[:B_pad], pad_to=rung), B_pad)
    Sq = ops.signature(rp.increments(), depth, lengths=rp.lengths)
    cross = time_gram(Sq, eng.ref_sigs, eng.weights)
    print_gram("[score] reference Gram", ref)
    print_gram("[score] largest cross-Gram", cross)
    # the engine's other parts: the reference signatures and the solve
    incs = tops.path_increments(refs)
    sig_ms = cuda_ms(lambda: st.sig_trunc(incs, depth), 3)
    sig_bound, sig_by = bound(R, M, d, depth, 4, R * D, 4)
    solve_ms = cuda_ms(lambda: krr_fit(eng.ref_gram, targets, 1e-3), 3)
    print(f"[score] engine parts: sig_trunc over the references (B={R}, "
          f"M={M}) {sig_ms:.3f} ms (bound {sig_bound:.4f} ms, {sig_by}; "
          f"{trunc_partition(R, d, depth)}), KRR solve {solve_ms:.3f} ms",
          flush=True)
    for f in flushes.values():
        del f["out"]
    return dict(engine_ms=eng_ms, engine_launches=n_eng, flushes=flushes,
                ref_sigs=dict(ms=sig_ms, bound_ms=sig_bound, bound_by=sig_by,
                              shape=[R, M, d, depth]),
                ref_sigs_ms=sig_ms, solve_ms=solve_ms,
                launches=n_eng["sig_gram"] + sum(
                    f["launches"]["sig_gram"] for f in flushes.values()),
                ref_gram=ref, cross_gram=cross, max_abs_err=errs,
                ref_gram_err=gerr, krr_residual=resid, nearest_ties=ties)


def phase_projected_mmd(rng) -> dict:
    """sig_mmd on the §8 word set: sig_words legs into sig_gram products."""
    B, M, d, N, _ = PROJ_CELL
    x, y = lead_lag(brownian(rng, B, M, d)), lead_lag(brownian(rng, B, M, d))
    plan = make_plan(generated_words(sparse_leadlag_generators(d), N), 2 * d)
    reset_counts()
    t0 = time.perf_counter()
    mmd = sig_mmd(x, y, words=plan)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    n = counts()
    check(n["sig_words"] == 2 and n["sig_gram"] == 3 and n["sig_trunc"] == 0,
          f"projected MMD launches {n}")
    tp = make_tiled_plan(plan.words, 2 * d)
    Sx, Sy = (sw.sig_words_plain(tops.path_increments(p.double()), tp)
              for p in (x, y))
    w = torch.ones(len(plan.words), dtype=torch.float64, device="cuda")
    Kxx, Kyy, Kxy = (sg.sig_gram_plain(a, b, w)
                     for a, b in ((Sx, Sx), (Sy, Sy), (Sx, Sy)))
    m = B * (B - 1)
    want = float((Kxx.sum() - Kxx.trace()) / m + (Kyy.sum() - Kyy.trace()) / m
                 - 2.0 * Kxy.mean())
    scale = max(float(K.abs().max()) for K in (Kxx, Kyy, Kxy))
    err = abs(float(mmd) - want)
    check(err <= E2E_TOL * scale,
          f"projected MMD {float(mmd)} vs plain {want}: |err| {err:.3e}")
    Sxk = ops.projected(tops.path_increments(x), plan)
    t = time_gram(Sxk, Sxk, w.float())
    print(f"[mmd] sig_mmd on {len(plan.words)} words (B={B} per sample, "
          f"{2 * M} increments over {2 * d} letters): {float(mmd):.6e}, "
          f"plain {want:.6e}, |err| {err:.2e} (max|K| {scale:.3e}); "
          f"{wall:.1f} ms wall; launches {n}", flush=True)
    print_gram("[mmd] projected-MMD Gram", t)
    return dict(mmd=float(mmd), plain=want, abs_err=err, wall_ms=wall,
                launches=n, gram=t)


# ---------------------------------------------------------------------------
# training: the §4.2 reverse sweep (sig_sweep) and the paths that run it
# ---------------------------------------------------------------------------

# (B, d, N, M values) of the paper's Table 2 memory cell
MEM_CELL = (32, 5, 4, (50, 100, 200, 400, 800, 1600))
# paper §8 training (examples/hurst_fbm_torch.py --full): path channels,
# path steps, depth, batch, learning rate, training paths, whitening paths,
# steps per model
HURST = (5, 250, 3, 128, 1e-2, 1280, 256, 10)


def grad_within(got: torch.Tensor, want: torch.Tensor) -> bool:
    """|g − g_64| <= 1e-3·|g_64| + E2E_TOL·max|g_64| (phase 13's rule)."""
    scale = float(want.abs().max())
    return bool(((got.double() - want).abs()
                 <= 1e-3 * want.abs() + E2E_TOL * scale).all())


def atol_needed(got: torch.Tensor, want: torch.Tensor) -> float:
    """The least atol, over max|want|, with which ``got`` meets rtol 1e-3
    against ``want``."""
    excess = (got.double() - want).abs() - 1e-3 * want.abs()
    return max(0.0, float(excess.max())) / float(want.abs().max())


def sweep_case(rng, fn, x: torch.Tensor, plan, stream: bool, stride: int,
               where: str, spec=None, taux=None) -> dict:
    """Run ``fn`` (a kernel's autograd node) forward and back with a random
    cotangent; hold the gradient against sig_sweep_plain in float64 on the
    same increments and the same saved terminal state (with a fused
    ``spec``: on the augmented increments, pulled back by fused_adjoint).
    Returns the max |error|, max|g_64|, and the least atol (over
    max|g_64|) that rtol 1e-3 needs for the kernel and for the fp32 plain
    sweep on the same inputs."""
    xin = x.detach().clone().requires_grad_()
    out = fn(xin)
    co = torch.tensor(rng.normal(size=tuple(out.shape)),
                      device="cuda").to(out.dtype)
    reset_counts()
    g, = torch.autograd.grad(out, xin, co)
    torch.cuda.synchronize()
    check(ss.launches == 1, f"{where}: sig_sweep launches {counts()}")
    terminal = (out[:, -1] if stream else out).detach().double()

    def plain(xp, S_T, cot):
        ge = ss.sig_sweep_plain(fused_augment(xp, taux, spec), plan, S_T,
                                cot, stream=stream, stream_stride=stride)
        return fused_adjoint(ge, spec, x.shape[-1])

    want = plain(x.double(), terminal, co.double())
    err = float((g.double() - want).abs().max())
    check(g.shape == want.shape and grad_within(g, want),
          f"{where}: max |err| {err:.3e}, max|g| "
          f"{float(want.abs().max()):.3e}")
    plain32 = plain(x, terminal.float(), co.float())
    return dict(err=err, max_g=float(want.abs().max()),
                atol=atol_needed(g, want), plain_atol=atol_needed(plain32,
                                                                  want))


def phase_sweep(rng, sets, fsets) -> dict:
    """sig_sweep against its plain version through both kernels' autograd
    nodes.  Returns the max |error| (fp32 increments) and, for the fp32
    cases, the least atol over max|g| that rtol 1e-3 needs: the kernel's,
    and the fp32 plain sweep's on the same inputs (per (d, N) at the
    truncated cells)."""
    cells = [(False, 1), (True, 1), (True, 3)]
    worst, cases, need = 0.0, 0, {}

    def run(key, fn, x, plan, where, spec=None, taux=None):
        nonlocal worst, cases
        for precision in ("fp32", "bf16_fp32"):
            xp = x if precision == "fp32" else x.to(torch.bfloat16).float()
            for stream, stride in cells:
                r = sweep_case(rng, lambda t: fn(t, stream, stride,
                                                 precision), xp, plan,
                               stream, stride, f"{where} stride="
                               f"{stride if stream else 0} {precision}",
                               spec, taux)
                cases += 1
                if precision == "fp32":
                    worst = max(worst, r["err"])
                    n = need.setdefault(key, dict(atol=0.0, plain_atol=0.0,
                                                  max_g=0.0))
                    for k in n:
                        n[k] = max(n[k], r[k])

    for d, N in SWEEP:
        plan = sig.truncation_closure(d, N)
        for M in (1, 37):
            x = torch.tensor(rng.normal(size=(5, M, d)) * 0.3,
                             device="cuda").float()
            run(f"{d},{N}", lambda t, stream, stride, precision:
                st.SigTruncFunction.apply(t, N, None, stream, stride,
                                          precision), x, plan,
                f"sig_sweep (sig_trunc) d={d} N={N} M={M}")
        where = "shared" if ss.plan_sweep_launch(plan).in_smem \
            else "device"
        n = need[f"{d},{N}"]
        print(f"[sweep] truncated d={d:2d} N={N} (W={plan.closure_size}, "
              f"state in {where} memory): max |err| so far {worst:.2e}; "
              f"fp32 atol needed with rtol 1e-3, over max|g| "
              f"({n['max_g']:.3e}): kernel {n['atol']:.2e}, plain fp32 "
              f"sweep {n['plain_atol']:.2e}", flush=True)
    for name, d, words in sets:
        plan = make_plan(make_plan(words, d).closure, d)
        ctp = make_tiled_plan(plan.words, d, max_rows=32)
        for M in (1, 37):
            x = torch.tensor(rng.normal(size=(5, M, d)) * 0.3,
                             device="cuda").float()
            run("words", lambda t, stream, stride, precision:
                sw.SigWordsFunction.apply(t, ctp, stream, stride, precision,
                                          plan), x, plan,
                f"sig_sweep (sig_words) [{name}] M={M}")
    # the fused cells' backward: the sweep over the augmented increments
    # the node builds from the raw ones and taux, then fused_adjoint
    fplans = []
    for d, N in FUSED_SWEEP:
        for tname in FUSED_SPECS:
            spec = as_transform(tname)
            plan = sig.truncation_closure(transform_dim(spec, d), N)
            fplans.append(plan)
            for M in (1, 37):
                x, taux = fused_batch(rng, 5, M, d, spec)
                run("fused", lambda t, stream, stride, precision:
                    st.SigTruncFunction.apply(t, N, None, stream, stride,
                                              precision, spec, taux),
                    x.float(), plan, f"sig_sweep (sig_trunc [{tname}]) "
                    f"d={d} N={N} M={M}", spec, taux)
    for name, d, tname, words in fsets:
        spec = as_transform(tname)
        da = transform_dim(spec, d)
        plan = make_plan(make_plan(words, da).closure, da)
        fplans.append(plan)
        ctp = make_tiled_plan(plan.words, da, max_rows=32)
        for M in (1, 37):
            x, taux = fused_batch(rng, 5, M, d, spec)
            run("fused", lambda t, stream, stride, precision:
                sw.SigWordsFunction.apply(t, ctp, stream, stride, precision,
                                          plan, spec, taux),
                x.float(), plan, f"sig_sweep (sig_words [{name}]) M={M}",
                spec, taux)
    print(f"[sweep] {cases} cases within tolerance (fused transform cases "
          f"included), max fp32 |err| {worst:.2e}", flush=True)
    plans = [sig.truncation_closure(d, N) for d, N in SWEEP]
    plans += [make_plan(make_plan(words, d).closure, d)
              for _, d, words in sets]
    plans += fplans
    parts, perr = sweep_partitions(rng, plans)
    return dict(max_abs_err=max(worst, perr), atol_needed=need,
                partitions=parts)


def sweep_partitions(rng, plans) -> tuple[int, float]:
    """Every partition of sig_sweep.partition_variants, forced, at B = 5,
    M = 37, terminal and stride 3, against the float64 plain sweep, and a
    second run bitwise equal.  Returns the cases and the max |error|."""
    cases, worst = 0, 0.0
    for plan in plans:
        B, M = 5, 37
        x = torch.tensor(rng.normal(size=(B, M, plan.d)) * 0.3,
                         device="cuda").float()
        S_T = torch.tensor(rng.normal(size=(B, plan.closure_size)) * 0.1,
                           device="cuda")
        for stride in (0, 3):
            shape = (B, -(-M // stride), len(plan.words)) if stride \
                else (B, len(plan.words))
            co = torch.tensor(rng.normal(size=shape), device="cuda")
            want = ss.sig_sweep_plain(x.double(), plan, S_T, co,
                                      stream=bool(stride),
                                      stream_stride=stride or 1)
            for p in ss.partition_variants(plan):
                got = ss._launch(x, plan, S_T.float(), co.float(), stride, p)
                again = ss._launch(x, plan, S_T.float(), co.float(), stride,
                                   p)
                torch.cuda.synchronize()
                err = float((got.double() - want).abs().max())
                where = (f"sig_sweep partition d={plan.d} W="
                         f"{plan.closure_size} stride={stride} {p}")
                check(grad_within(got, want), f"{where}: max |err| {err:.3e}"
                      f", max|g| {float(want.abs().max()):.3e}")
                check(torch.equal(got, again), f"{where}: two runs differ")
                worst = max(worst, err)
                cases += 1
    print(f"[sweep] {cases} forced partitions within tolerance and bitwise "
          f"equal on a second run, max |err| {worst:.2e}", flush=True)
    return cases, worst


def time_sweep(incs: torch.Tensor, plan, S_T: torch.Tensor,
               g: torch.Tensor, where: str) -> dict:
    """sig_sweep alone and its plain version at one shape, and its bound;
    the kernel's gradient held against the plain sweep in float64 on the
    same inputs (returned as ``want``)."""
    B, M, _ = incs.shape
    bms, by = sweep_bound(B, M, plan, 1)
    got = ss.sig_sweep(incs, plan, S_T, g)
    want = ss.sig_sweep_plain(incs.double(), plan, S_T.double(), g.double())
    err = float((got.double() - want).abs().max())
    check(grad_within(got, want), f"{where}: sig_sweep max |err| {err:.3e} "
          f"vs the float64 plain sweep, max|g| {float(want.abs().max()):.3e}")
    again = ss.sig_sweep(incs, plan, S_T, g)
    check(torch.equal(got, again), f"{where}: two sig_sweep runs differ")
    t = cuda_ms(lambda: ss.sig_sweep(incs, plan, S_T, g), 5)
    p = ss.plan_sweep_launch(plan)
    return dict(ms=t, us_per_step=1e3 * t / M,
                partition=dict(threads=p.threads, lanes=list(p.lanes),
                               in_smem=p.in_smem, smem=p.smem),
                plain_ms=cuda_ms(lambda: ss.sig_sweep_plain(
                    incs, plan, S_T, g), 1),
                bound_ms=bms, bound_by=by, W=plan.closure_size,
                max_abs_err=err, max_g=float(want.abs().max()), want=want)


def phase_train_grid(rng) -> list:
    """Table 1 train mode at every cell, through ops.signature."""
    rows = []
    for B, M, d, N in TABLE1:
        incs = torch.tensor(rng.normal(size=(B, M, d)) / np.sqrt(M),
                            dtype=torch.float32, device="cuda")
        x = incs.clone().requires_grad_()

        def value_and_grad():
            out = ops.signature(x, N)
            return out, torch.autograd.grad((out ** 2).sum(), x)[0]

        reset_counts()
        out, g = value_and_grad()
        torch.cuda.synchronize()
        n = counts()
        check(n["sig_trunc"] == 1 and n["sig_sweep"] == 1
              and n["sig_trunc_stream"] == 0,
              f"Table 1 train cell {B, M, d, N}: launches {n}")
        check(bool(torch.isfinite(g).all()), f"train cell {B, M, d, N}")
        # the gradient against the plain sweep in float64 from the same
        # terminal signature, at every cell
        sweep = time_sweep(incs, sig.truncation_closure(d, N), out.detach(),
                           2 * out.detach(), f"train cell {B, M, d, N}")
        want = sweep.pop("want")
        row = dict(B=B, M=M, d=d, N=N, launches=n,
                   ms=cuda_ms(value_and_grad, 5),
                   plain_max_abs_err=float((g.double() - want).abs().max()))
        check(grad_within(g, want),
              f"train cell {B, M, d, N}: gradient max |err| "
              f"{row['plain_max_abs_err']:.3e} vs the float64 plain sweep, "
              f"max|g| {float(want.abs().max()):.3e}")
        row.update({f"sweep_{k}": v for k, v in sweep.items()})
        if (B, M, d) == (32, 100, 6):   # the depth sweep
            x64 = incs.double().requires_grad_()
            g64, = torch.autograd.grad((ops.signature(
                x64, N, backend="torch", backward="autodiff") ** 2).sum(),
                x64)
            row["max_abs_err"] = float((g.double() - g64).abs().max())
            check(grad_within(g, g64),
                  f"train cell {B, M, d, N}: gradient max |err| "
                  f"{row['max_abs_err']:.3e}, max|g| "
                  f"{float(g64.abs().max()):.3e}")
            xa = incs.clone().requires_grad_()
            row["autodiff_ms"] = cuda_ms(lambda: torch.autograd.grad((
                ops.signature(xa, N, backward="autodiff") ** 2).sum(), xa),
                1)
        rows.append(row)
        print(f"[train] B={B:3d} M={M:3d} d={d:2d} N={N}: value+grad "
              f"{row['ms']:8.3f} ms, max |err| vs the float64 plain sweep "
              f"{row['plain_max_abs_err']:.2e} (max|g| "
              f"{row['sweep_max_g']:.3e}); sig_sweep alone "
              f"{row['sweep_ms']:.3f} "
              f"ms, plain {row['sweep_plain_ms']:.3f} ms, bound "
              f"{row['sweep_bound_ms']:.4f} ms ({row['sweep_bound_by']})"
              + (f"; torch autodiff {row['autodiff_ms']:.3f} ms, max |err| "
                 f"vs float64 autodiff {row['max_abs_err']:.2e}"
                 if "autodiff_ms" in row else ""), flush=True)
    return rows


def phase_memory(rng) -> dict:
    """Peak device memory of value plus gradient at the Table 2 cell, the
    increments included, above what earlier phases hold."""
    B, d, N, Ms = MEM_CELL
    mem_out = 4 * B * sum(d**n for n in range(1, N + 1))
    peaks = {"inverse": [], "checkpoint": [], "autodiff": []}
    for M in Ms:
        for mode in peaks:
            xn = rng.normal(size=(B, M, d)) / np.sqrt(M)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            x = torch.tensor(xn, dtype=torch.float32,
                             device="cuda").requires_grad_()
            out = ops.signature(x, N, backward=mode)
            g, = torch.autograd.grad((out ** 2).sum(), x)
            torch.cuda.synchronize()
            peaks[mode].append(torch.cuda.max_memory_allocated() - base)
            check(bool(torch.isfinite(g).all()), f"memory cell M={M} {mode}")
            del x, out, g
        print(f"[memory] B={B} d={d} N={N} M={M:4d}: peak inverse "
              f"{peaks['inverse'][-1] / mem_out:8.1f} Mem_out, checkpoint "
              f"{peaks['checkpoint'][-1] / mem_out:8.1f} Mem_out, autodiff "
              f"{peaks['autodiff'][-1] / mem_out:8.1f} Mem_out (Mem_out = "
              f"{mem_out} bytes)", flush=True)
    inc_growth = B * (Ms[-1] - Ms[0]) * d * 4
    grow = {m: p[-1] - p[0] for m, p in peaks.items()}
    print(f"[memory] growth M={Ms[0]}..{Ms[-1]}: inverse {grow['inverse']} "
          f"bytes ({grow['inverse'] / inc_growth:.2f}× the increments' "
          f"{inc_growth}), autodiff {grow['autodiff']} bytes "
          f"({grow['autodiff'] / inc_growth:.1f}×)", flush=True)
    check(grow["inverse"] <= 4 * inc_growth,
          f"inverse peak grew {grow['inverse']} bytes, above 4× the "
          f"increments' {inc_growth}")
    check(grow["autodiff"] > 10 * inc_growth,
          f"autodiff peak grew only {grow['autodiff']} bytes")
    # the checkpoint peak beyond the increments grows like √M: the exponent
    # of a least-squares line through log(peak − B·M·d·4) against log M
    excess = [p - B * M * d * 4 for p, M in zip(peaks["checkpoint"], Ms)]
    exponent = float(np.polyfit(np.log(Ms), np.log(excess), 1)[0])
    ends = float(np.log(excess[-1] / excess[0]) / np.log(Ms[-1] / Ms[0]))
    print(f"[memory] checkpoint: peak beyond the increments "
          f"{excess[0]} bytes at M={Ms[0]}, {excess[-1]} at M={Ms[-1]}; "
          f"fitted exponent {exponent:.3f} (first to last point "
          f"{ends:.3f}; √M is 0.5)", flush=True)
    check(0.35 <= exponent <= 0.65, f"checkpoint peak exponent {exponent:.3f}"
          f" outside [0.35, 0.65]: {excess}")
    # the streamed cells: what the backward keeps (the storages behind the
    # saved tensors) beyond the increments must not grow with M
    words = all_words(d, N)
    saved = {}
    for name, fn in (("signature", lambda t: ops.signature(
            t, N, stream=True)), ("projected", lambda t: ops.projected(
                t, words, stream=True))):
        saved[name] = [saved_storage_bytes(fn, torch.tensor(
            rng.normal(size=(B, M, d)) / np.sqrt(M), dtype=torch.float32,
            device="cuda").requires_grad_()) for M in (Ms[0], Ms[-1])]
        g = saved[name][1] - saved[name][0]
        print(f"[memory] streamed {name} (stride 1): saved for the backward "
              f"{saved[name][0]} bytes at M={Ms[0]}, {saved[name][1]} at "
              f"M={Ms[-1]}, growth {g / inc_growth:.2f}× the increments'",
              flush=True)
        check(g <= inc_growth, f"streamed {name}: the saved tensors grew "
              f"{g} bytes, above the increments' {inc_growth}")
    return dict(B=B, d=d, N=N, M=list(Ms), mem_out=mem_out, peaks=peaks,
                growth=grow, inc_growth=inc_growth, stream_saved=saved,
                checkpoint_exponent=exponent,
                checkpoint_exponent_ends=ends)


def saved_storage_bytes(fn, x: torch.Tensor) -> int:
    """Bytes of the distinct storages behind the tensors autograd saves for
    the backward of fn(x): a saved view keeps its whole base alive."""
    storages = {}

    def pack(t):
        st_ = t.untyped_storage()
        storages[st_.data_ptr()] = st_.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(x)
    return sum(storages.values())


def phase_mmd_grad(rng) -> dict:
    """The gradient of the §8 projected MMD w.r.t. the generated sample."""
    B, M, d, N, _ = PROJ_CELL
    plan = make_plan(generated_words(sparse_leadlag_generators(d), N), 2 * d)
    xp, yp = lead_lag(brownian(rng, B, M, d)), lead_lag(brownian(rng, B, M, d))
    x = xp.clone().requires_grad_()
    reset_counts()
    t0 = time.perf_counter()
    g, = torch.autograd.grad(sig_mmd(x, yp, words=plan), x)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    n = counts()
    check(n["sig_words"] == 2 and n["sig_gram"] == 3 and n["sig_sweep"] == 1
          and n["sig_trunc"] == 0, f"MMD gradient launches {n}")
    x64 = xp.double().requires_grad_()
    g64, = torch.autograd.grad(sig_mmd(x64, yp.double(), words=plan,
                                       backend="torch"), x64)
    err = float((g.double() - g64).abs().max())
    scale = float(g64.abs().max())
    check(err <= E2E_TOL * scale,
          f"MMD gradient max |err| {err:.3e}, max|g| {scale:.3e}")
    print(f"[mmdgrad] d sig_mmd / d x on {len(plan.words)} words (B={B} a "
          f"sample): {wall:.1f} ms wall, launches {n}; max |err| vs float64 "
          f"torch {err:.2e} (max|g| {scale:.3e})", flush=True)
    return dict(wall_ms=wall, launches=n, max_abs_err=err, max_g=scale)


def phase_hurst(seed: int) -> dict:
    """The §8 model at full width: 10 training steps of each signature
    variant through the example's module."""
    hf = example_module("hurst_fbm_torch")
    d, M, depth, batch, lr, n_tr, n_white, steps = HURST
    X, H = hurst_dataset(seed=seed, n_paths=n_tr, n_steps=M, d=d)
    X = torch.as_tensor(X, device="cuda")
    H = torch.as_tensor(H, device="cuda")
    perm = torch.as_tensor(np.random.default_rng(seed).permutation(n_tr),
                           device="cuda")
    fwd = {"truncated": "sig_trunc", "sparse": "sig_words"}
    out = {}
    for kind, kname in fwd.items():
        model = hf.make_model(kind, d, depth, M, X[:n_white], seed=seed)
        ref = hf.HurstModel(kind, d, depth, M, backend="torch",
                            device="cuda", dtype=torch.float64)
        ref.load_state_dict({k: v.double()
                             for k, v in model.state_dict().items()})
        ref.mu.copy_(model.mu)
        ref.sd.copy_(model.sd)
        opt = hf.adam(model, lr)
        losses, ms, grads, sweeps = [], [], None, 0
        for i in range(steps):
            idx = perm[i * batch:(i + 1) * batch]
            xb, yb = X[idx], H[idx]
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss = hf.mse(model, xb, yb)
            loss.backward()
            if i == 0:
                grads = {k: p.grad.clone()
                         for k, p in model.named_parameters()}
            opt.step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            n = counts()
            check(n[kname] == 1 and n["sig_sweep"] == 1
                  and sum(n.values()) == 2,
                  f"§8 {kind} step {i}: launches {n}")
            sweeps += n["sig_sweep"]
            losses.append(float(loss.detach()))
        check(all(np.isfinite(losses)), f"§8 {kind}: losses {losses}")
        xb, yb = X[perm[:batch]], H[perm[:batch]]
        hf.mse(ref, xb.double(), yb.double()).backward()
        errs = {}
        for k, p in ref.named_parameters():
            scale = float(p.grad.abs().max())
            errs[k] = float((grads[k].double() - p.grad).abs().max())
            check(errs[k] <= 1e-3 * scale,
                  f"§8 {kind}: gradient of {k} max |err| {errs[k]:.3e}, "
                  f"max|g| {scale:.3e}")
        # the kernels alone at the step's shape
        with torch.no_grad():
            incs = tops.path_increments(lead_lag(X[perm[:batch]]
                                                 * model.scale))
        if kind == "sparse":
            ctp = make_tiled_plan(model.plan.closure, 2 * d)
            plan = make_plan(model.plan.closure, 2 * d)
            S_T = sw.sig_words(incs, ctp)
            fwd_ms = cuda_ms(lambda: sw.sig_words(incs, ctp), 10)
        else:
            plan = sig.truncation_closure(2 * d, depth)
            S_T = st.sig_trunc(incs, depth)
            fwd_ms = cuda_ms(lambda: st.sig_trunc(incs, depth), 10)
        g = torch.tensor(np.random.default_rng(seed).normal(
            size=tuple(S_T.shape)), dtype=torch.float32, device="cuda")
        sweep = time_sweep(incs, plan, S_T, g, f"§8 {kind} step")
        del sweep["want"]
        step_ms = float(np.median(ms[1:]))
        out[kind] = dict(features=model.feat_dim, W=plan.closure_size,
                         losses=losses, step_ms=step_ms, steps_ms=ms,
                         grad_err=errs, forward_ms=fwd_ms, sweep=sweep,
                         sweep_launches=sweeps,
                         shape=[batch, 2 * M, 2 * d, depth])
        print(f"[hurst] {kind:9s} ({model.feat_dim} features, closure "
              f"{plan.closure_size} rows): step {step_ms:.3f} ms (median of "
              f"steps 2-{steps}); losses "
              f"{' '.join(f'{v:.5f}' for v in losses)}; first-step "
              f"gradients within 1e-3·max|g| of float64 torch (worst "
              f"{max(errs.values()):.2e}); {kname} {fwd_ms:.3f} ms, "
              f"sig_sweep {sweep['ms']:.3f} ms (max |err| vs the float64 "
              f"plain sweep {sweep['max_abs_err']:.2e}, max|g| "
              f"{sweep['max_g']:.3e}), plain {sweep['plain_ms']:.3f}"
              f" ms, bound {sweep['bound_ms']:.4f} ms ({sweep['bound_by']})",
              flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 18: the fused transform cells through the user entry points
# ---------------------------------------------------------------------------

def one_forward(fn, kernel: str, where: str, backward: bool = False):
    """Run ``fn`` with every count at 0 and check that it launched
    ``kernel`` (terminal or streamed cell) exactly once, fused, one
    sig_sweep if ``backward``, and nothing else.  Returns fn's result and
    the counts."""
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    n = counts()
    want = {k: 0 for k in n}
    stream = n[kernel + "_stream"] == 1
    want[kernel + ("_stream" if stream else "")] = 1
    want[kernel + "_fused"] = 1
    want["sig_sweep"] = int(backward)
    check(n == want, f"{where}: launches {n}, expected {want}")
    return out, n


def fused_times(fused, mat, plain) -> dict:
    """The fused kernel's ms beside the materialising route's (the
    augment in PyTorch, then the same kernel) and the plain version's: one
    call (median of 10) and a call's share of 20 back to back (b2b), where
    the host's work for a call hides behind the last call's."""
    return dict(ms=cuda_ms(fused, 10), materialise_ms=cuda_ms(mat, 10),
                b2b_ms=cuda_ms_back_to_back(fused),
                materialise_b2b_ms=cuda_ms_back_to_back(mat),
                plain_ms=cuda_ms(plain, 1))


def fused_line(t: dict, b: tuple) -> str:
    """A fused case's times and bound, as printed."""
    return (f"fused {t['ms']:.3f} ms ({t['b2b_ms']:.3f} b2b), materialised "
            f"{t['materialise_ms']:.3f} ({t['materialise_b2b_ms']:.3f} b2b), "
            f"plain {t['plain_ms']:.3f}, bound {b[0]:.5f} ms ({b[1]})")


def fused_case(case: str, shape: list, t: dict, b: tuple, **kw) -> dict:
    """One fused entry of a kernel row's ``cases``."""
    return dict(case=case, shape=shape, transform=kw.pop("transform"),
                **t, bound_ms=b[0], bound_by=b[1], **kw)


def saved_for_backward(fn, x: torch.Tensor, where: str,
                       allowed: int, augmented: int) -> int:
    """Bytes saved for the backward of fn(x): at most ``allowed`` (the raw
    increments, the time rows and the terminal state; for a projection
    also its words' int64 read-out index), never the augmented
    increments' ``augmented`` bytes."""
    saved = saved_storage_bytes(fn, x)
    check(saved <= allowed, f"{where}: {saved} bytes saved for the backward"
          f", above the raw increments, time rows and terminal state "
          f"({allowed}); the augmented increments are {augmented}")
    return saved


def transform_projection(rng) -> dict:
    """§8 at full width through transform="lead_lag": ops.projected
    (terminal, ragged, streamed) and ops.projected_forward_only onto the
    1,685-word set, and ops.signature(·, 3) with its gradient."""
    B, M, d, N, stride = PROJ_CELL
    tname = "lead_lag"
    spec = as_transform(tname)
    da, Ma = transform_dim(spec, d), 2 * M
    incs = tops.path_increments(brownian(rng, B, M, d))
    lengths = torch.tensor(rng.integers(M // 4, M + 1, size=B),
                           dtype=torch.int32, device="cuda")
    words = generated_words(sparse_leadlag_generators(d), N)
    plan = make_plan(words, da)
    tp = make_tiled_plan(words, da)
    ctp = make_tiled_plan(prefix_closure(words), da)
    x64 = incs.double()
    kw = dict(transform=tname)
    full, _ = one_forward(lambda: ops.projected(incs, plan, **kw),
                          "sig_words", "§8 lead_lag ops.projected")
    fwd, _ = one_forward(lambda: ops.projected_forward_only(incs, plan, **kw),
                         "sig_words", "§8 lead_lag projected_forward_only")
    ragged, _ = one_forward(lambda: ops.projected(incs, plan, lengths=lengths,
                                                  **kw),
                            "sig_words", "§8 lead_lag ragged ops.projected")
    stream, _ = one_forward(lambda: ops.projected(
        incs, plan, stream=True, stream_stride=stride, **kw),
        "sig_words", "§8 lead_lag streamed ops.projected")
    check(full.shape == fwd.shape == ragged.shape == (B, len(words))
          and stream.shape == (B, -(-Ma // stride), len(words)),
          f"§8 lead_lag shapes {full.shape} {fwd.shape} {ragged.shape} "
          f"{stream.shape}")
    want = sw.sig_words_plain(x64, tp, transform=spec)
    want_r = sw.sig_words_plain(sig.mask_increments(x64, lengths), tp,
                                transform=spec)
    want_s = sw.sig_words_plain(x64, tp, stream=True, stream_stride=stride,
                                transform=spec)
    errs = []
    for name, got, w in (("terminal", full, want), ("forward-only", fwd, want),
                         ("ragged", ragged, want_r),
                         ("streamed", stream, want_s)):
        check(bool(torch.isfinite(got).all()), f"§8 lead_lag {name}: "
              "non-finite values")
        torch.testing.assert_close(got.double(), w, **TOL)
        errs.append(float((got.double() - w).abs().max()))
    # the same kernel on the materialised increments
    e = augment_increments(incs, spec)
    torch.testing.assert_close(full, ops.projected(e, plan), **TOL)
    torch.testing.assert_close(stream, ops.projected(
        e, plan, stream=True, stream_stride=stride), **TOL)
    t = fused_times(lambda: sw.sig_words(incs, tp, transform=spec),
                    lambda: sw.sig_words(fused_augment(incs, None, spec), tp),
                    lambda: sw.sig_words_plain(incs, tp, transform=spec))
    w_flops = fused_step_flops(spec, d, lambda m: words_flops(plan, m))
    b = bound(B, Ma, da, N, 4, B * len(words), 4, w_flops, raw=(M, d))
    ts_ = fused_times(
        lambda: sw.sig_words(incs, ctp, stream=True, stream_stride=stride,
                             transform=spec),
        lambda: sw.sig_words(fused_augment(incs, None, spec), ctp,
                             stream=True, stream_stride=stride),
        lambda: sw.sig_words_plain(incs, ctp, stream=True,
                                   stream_stride=stride, transform=spec))
    bs = bound(B, Ma, da, N, 4, B * (-(-Ma // stride)) * len(ctp.words), 4,
               w_flops, raw=(M, d))
    print(f"[transform] §8 lead_lag (B={B}, M={M} raw, {Ma} augmented "
          f"steps over {da} letters, {len(words)} words): ops.projected "
          f"terminal, forward-only, ragged and streamed (stride {stride}) "
          f"one fused sig_words launch each, max |err| vs plain "
          f"{max(errs):.2e}; sig_words {fused_line(t, b)}; streamed over "
          f"the {len(ctp.words)}-word closure {fused_line(ts_, bs)}",
          flush=True)
    # the projection onto the prefix-closed set, value and gradient: the
    # sweep runs back from the closure state the forward saved
    cplan = make_plan(ctp.words, da)
    W = len(cplan.words)
    xp = incs.clone().requires_grad_()

    def proj_value_and_grad():
        out = ops.projected(xp, cplan, **kw)
        return out, torch.autograd.grad((out ** 2).sum(), xp)[0]

    (po, pg), _ = one_forward(proj_value_and_grad, "sig_words",
                              "§8 lead_lag ops.projected value and gradient",
                              backward=True)
    torch.testing.assert_close(po.double(), sw.sig_words_plain(
        x64, ctp, transform=spec), **TOL)
    p64 = po.detach().double()
    pgw = fused_adjoint(ss.sig_sweep_plain(
        fused_augment(x64, None, spec), cplan, p64, 2 * p64), spec, d)
    pgerr = float((pg.double() - pgw).abs().max())
    check(grad_within(pg, pgw), f"§8 lead_lag ops.projected gradient: max "
          f"|err| {pgerr:.3e}, max|g| {float(pgw.abs().max()):.3e}")
    psaved = saved_for_backward(lambda v: ops.projected(v, cplan, **kw),
                                incs.clone().requires_grad_(),
                                "§8 lead_lag ops.projected",
                                4 * (B * M * d + B * W) + 8 * W,
                                4 * B * Ma * da)
    pvg_ms = cuda_ms(proj_value_and_grad, 5)
    print(f"[transform] §8 lead_lag ops.projected onto the {W}-word closure"
          f": one fused sig_words and one sig_sweep launch; gradient max "
          f"|err| vs the float64 plain sweep {pgerr:.2e}; {psaved} bytes "
          f"saved for the backward (raw increments {4 * B * M * d}, "
          f"augmented {4 * B * Ma * da}); value+grad {pvg_ms:.3f} ms",
          flush=True)
    # the truncated signature at depth 3, value and gradient
    D = sum(da**n for n in range(1, 4))
    x = incs.clone().requires_grad_()

    def value_and_grad():
        out = ops.signature(x, 3, **kw)
        return out, torch.autograd.grad((out ** 2).sum(), x)[0]

    (out, g), n = one_forward(value_and_grad, "sig_trunc",
                              "§8 lead_lag ops.signature value and "
                              "gradient", backward=True)
    torch.testing.assert_close(out.double(), st.sig_trunc_plain(
        x64, 3, transform=spec), **TOL)
    torch.testing.assert_close(out, ops.signature(e, 3), **TOL)
    o64 = out.detach().double()
    gw = fused_adjoint(ss.sig_sweep_plain(
        fused_augment(x64, None, spec), sig.truncation_closure(da, 3), o64,
        2 * o64), spec, d)
    gerr = float((g.double() - gw).abs().max())
    check(grad_within(g, gw), f"§8 lead_lag ops.signature gradient: max "
          f"|err| {gerr:.3e}, max|g| {float(gw.abs().max()):.3e}")
    saved = saved_for_backward(lambda v: ops.signature(v, 3, **kw),
                               incs.clone().requires_grad_(),
                               "§8 lead_lag ops.signature",
                               4 * (B * M * d + B * D), 4 * B * Ma * da)
    tt_ = fused_times(lambda: st.sig_trunc(incs, 3, transform=spec),
                      lambda: st.sig_trunc(fused_augment(incs, None, spec),
                                           3),
                      lambda: st.sig_trunc_plain(incs, 3, transform=spec))
    bt = bound(B, Ma, da, 3, 4, B * D, 4, fused_step_flops(
        spec, d, lambda m: horner_flops(da, 3, len(m))), raw=(M, d))
    vg_ms = cuda_ms(value_and_grad, 5)
    print(f"[transform] §8 lead_lag ops.signature(·, 3) ({D} features): "
          f"one fused sig_trunc and one sig_sweep launch; gradient max |err| "
          f"vs the float64 plain sweep {gerr:.2e}; {saved} bytes saved for "
          f"the backward (raw increments {4 * B * M * d}, augmented "
          f"{4 * B * Ma * da}); value+grad {vg_ms:.3f} ms; sig_trunc "
          f"{fused_line(tt_, bt)}", flush=True)
    shape = [B, M, d, N]
    return dict(
        words=fused_case("§8 lead_lag terminal", shape, t, b,
                         transform=tname, words=len(words),
                         max_abs_err=max(errs), launches=1,
                         closure_value_and_grad_ms=pvg_ms,
                         closure_grad_max_abs_err=pgerr,
                         closure_saved_bytes=psaved),
        words_stream=fused_case("§8 lead_lag streamed", shape + [stride],
                                ts_, bs, transform=tname,
                                words=len(ctp.words), launches=1),
        trunc=fused_case("§8 lead_lag depth 3, value and gradient",
                         [B, M, d, 3], tt_, bt, transform=tname,
                         value_and_grad_ms=vg_ms, grad_max_abs_err=gerr,
                         saved_bytes=saved, launches=1))


def transform_table1(rng) -> list:
    """The Table 1 transform cells: terminal, streamed (stride 3), and
    value plus gradient, through ops.signature."""
    out = []
    for name, B, M, d, N, prec in TABLE1_FUSED:
        spec = as_transform(TABLE1_TRANSFORM)
        da, Ma = transform_dim(spec, d), 2 * M
        D = sum(da**n for n in range(1, N + 1))
        incs = torch.tensor(rng.normal(size=(B, M, d)) / np.sqrt(M),
                            dtype=torch.float32, device="cuda")
        taux = transform_time_aux(spec, B, M, device="cuda")
        xq = incs.to(torch.bfloat16).double() if prec == "bf16_fp32" \
            else incs.double()
        where = f"Table 1 {name} ({B}, {M}, {d}, {N}) {prec}"
        kw = dict(transform=TABLE1_TRANSFORM, precision=prec)
        got, _ = one_forward(lambda: ops.signature(incs, N, **kw),
                             "sig_trunc", where)
        want = st.sig_trunc_plain(xq, N, transform=spec, taux=taux)
        torch.testing.assert_close(got.double(), want, **TOL)
        err = float((got.double() - want).abs().max())
        if prec == "bf16_fp32":
            rel = level_relerr(got.double(), st.sig_trunc_plain(
                incs.double(), N, transform=spec, taux=taux), da, N)
            check(all(e <= n * 2.0**-8 for n, e in enumerate(rel, start=1)),
                  f"{where}: level errors {rel}")
        # the same kernel on the materialised increments (from the same
        # rounded raw increments, the time channel in fp32)
        e = fused_augment(xq.float(), taux, spec)
        torch.testing.assert_close(got, st.sig_trunc(e, N), **TOL)
        gs, _ = one_forward(lambda: ops.signature(
            incs, N, stream=True, stream_stride=3, **kw), "sig_trunc",
            where + " streamed")
        want_s = st.sig_trunc_plain(xq, N, stream=True, stream_stride=3,
                                    transform=spec, taux=taux)
        check(gs.shape == want_s.shape and within(
            gs.double(), want_s, 2.0**-8 if prec == "bf16_fp32"
            else TOL["rtol"]), f"{where} streamed: max |err| "
            f"{float((gs.double() - want_s).abs().max()):.3e}")
        x = incs.clone().requires_grad_()

        def value_and_grad():
            o = ops.signature(x, N, **kw)
            return o, torch.autograd.grad((o ** 2).sum(), x)[0]

        (o, g), _ = one_forward(value_and_grad, "sig_trunc",
                                where + " value and gradient", backward=True)
        o64 = o.detach().double()
        gw = fused_adjoint(ss.sig_sweep_plain(
            fused_augment(xq, taux, spec), sig.truncation_closure(da, N),
            o64, 2 * o64), spec, d)
        gerr = float((g.double() - gw).abs().max())
        check(grad_within(g, gw), f"{where}: gradient max |err| {gerr:.3e}, "
              f"max|g| {float(gw.abs().max()):.3e}")
        saved = saved_for_backward(lambda v: ops.signature(v, N, **kw),
                                   incs.clone().requires_grad_(), where,
                                   4 * (B * M * d + 2 * B + B * D),
                                   4 * B * Ma * da)
        kk = dict(transform=spec, taux=taux, precision=prec)
        t = fused_times(lambda: st.sig_trunc(incs, N, **kk),
                        lambda: st.sig_trunc(fused_augment(incs, taux, spec),
                                             N, precision=prec),
                        lambda: st.sig_trunc_plain(incs, N, transform=spec,
                                                   taux=taux))
        ts_ = fused_times(
            lambda: st.sig_trunc(incs, N, stream=True, stream_stride=3, **kk),
            lambda: st.sig_trunc(fused_augment(incs, taux, spec), N,
                                 stream=True, stream_stride=3,
                                 precision=prec),
            lambda: st.sig_trunc_plain(incs, N, stream=True,
                                       stream_stride=3, transform=spec,
                                       taux=taux))
        ib = 2 if prec == "bf16_fp32" else 4
        t_flops = fused_step_flops(spec, d,
                                   lambda m: horner_flops(da, N, len(m)))
        b = bound(B, Ma, da, N, ib, B * D, 4, t_flops, raw=(M, d),
                  aux_bytes=8 * B)
        bs = bound(B, Ma, da, N, ib, gs.numel(), ib, t_flops, raw=(M, d),
                   aux_bytes=8 * B)
        vg_ms = cuda_ms(value_and_grad, 5)
        print(f"[transform] {where}, {TABLE1_TRANSFORM} ({Ma} augmented "
              f"steps over {da} letters): terminal, streamed (stride 3) and "
              f"value+grad one fused launch each; max |err| vs plain "
              f"{err:.2e}, gradient {gerr:.2e}; {saved} bytes saved "
              f"(augmented increments {4 * B * Ma * da}); sig_trunc "
              f"{fused_line(t, b)}; streamed {fused_line(ts_, bs)}; "
              f"value+grad {vg_ms:.3f} ms", flush=True)
        shape = [B, M, d, N]
        out.append(dict(
            trunc=fused_case(f"Table 1 {name}", shape, t, b,
                             transform=TABLE1_TRANSFORM, precision=prec,
                             value_and_grad_ms=vg_ms, max_abs_err=err,
                             grad_max_abs_err=gerr, saved_bytes=saved,
                             launches=1),
            stream=fused_case(f"Table 1 {name} streamed", shape + [3], ts_,
                              bs, transform=TABLE1_TRANSFORM, precision=prec,
                              launches=1)))
    return out


def transform_serving(rng) -> dict:
    """signature_service(transform="time_augment") answers 256 requests:
    the per-example dt of ragged micro-batches at serving width."""
    d, depth, max_len = 6, 5, 1024
    tname = "time_augment"
    spec = as_transform(tname)
    da = transform_dim(spec, d)
    D = sum(da**n for n in range(1, depth + 1))
    svc = DynamicBatcher.signature_service(d=d, depth=depth, max_len=max_len,
                                           transform=tname)
    reqs = serving_inputs(rng, 256, d, 16, max_len)
    reset_counts()
    t0 = time.perf_counter()
    tickets = [svc.submit(p) for p in reqs]
    out = svc.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n, stats = counts(), svc.stats()
    check(n["sig_trunc"] == n["sig_trunc_fused"] == stats["batches"] > 0
          and sum(n.values()) == 2 * stats["batches"],
          f"time_augment serving: launches {n} for {stats['batches']} "
          "micro-batches")
    for tk in tickets:
        check(out[tk].shape == (D,) and bool(torch.isfinite(out[tk]).all()),
              f"time_augment ticket {tk}: bad answer")
    worst = 0.0
    for i in rng.choice(len(reqs), 32, replace=False):
        x = tops.path_increments(torch.tensor(reqs[i], dtype=torch.float64,
                                              device="cuda"))[None]
        taux = transform_time_aux(spec, 1, x.shape[1], device="cuda")
        want = st.sig_trunc_plain(x, depth, transform=spec, taux=taux)[0]
        got = out[tickets[i]].double()
        worst = max(worst, float((got - want).abs().max()))
        check(within(got, want, TOL["rtol"]), f"time_augment request {i} "
              f"(length {len(reqs[i]) - 1}): max |err| {worst:.3e}")
    rung, B_pad = max(stats["shapes"], key=lambda s: s[0] * s[1])
    which = assign_buckets([len(p) - 1 for p in reqs], svc.ladder)
    part = [p for p, k in zip(reqs, which) if svc.ladder[k] == rung][:B_pad]
    rp = pad_batch(RaggedPaths.from_list(part, pad_to=rung), B_pad)
    incs = sig.mask_increments(rp.increments(), rp.lengths)
    taux = transform_time_aux(spec, B_pad, rung, rp.lengths, device="cuda")
    t = fused_times(
        lambda: st.sig_trunc(incs, depth, transform=spec, taux=taux),
        lambda: st.sig_trunc(fused_augment(incs, taux, spec), depth),
        lambda: st.sig_trunc_plain(incs, depth, transform=spec, taux=taux))
    b = bound(B_pad, rung, da, depth, 4, B_pad * D, 4, fused_step_flops(
        spec, d, lambda m: horner_flops(da, depth, len(m))), raw=(rung, d),
        aux_bytes=8 * B_pad)
    print(f"[transform] signature_service(d={d}, depth={depth}, "
          f"transform={tname}): {len(reqs)} requests in {wall * 1e3:.1f} ms "
          f"(first flush), {stats['batches']} micro-batches, one fused "
          f"sig_trunc launch each; 32 sampled answers match the unpadded "
          f"plain version, max |err| {worst:.2e}; largest micro-batch (B="
          f"{B_pad}, M={rung}): sig_trunc {fused_line(t, b)}", flush=True)
    return fused_case("serving time_augment micro-batch",
                      [B_pad, rung, d, depth], t, b, transform=tname,
                      launches=n["sig_trunc"], wall_ms=wall * 1e3,
                      max_abs_err=worst)


def phase_transform(rng) -> dict:
    """Phase 18: the fused transform cells on the card through the entry
    points a user calls."""
    proj = transform_projection(rng)
    table1 = transform_table1(rng)
    serve = transform_serving(rng)
    return dict(projection=proj, table1=table1, serve=serve)


# ---------------------------------------------------------------------------
# phases 19-21: the √M checkpoint backward and time chunks, windowed
# signatures (Fig. 3) and online signature streams
# ---------------------------------------------------------------------------

# the Fig. 3 grid of benchmarks/fig3_windows.py (its non-quick run): B, M,
# d, N, window length, stride, and whether per-window calls are timed
FIG3 = ([(16, 16 * K // 2 + 16, 4, 3, 16, 8, True)
         for K in (4, 16, 64, 256, 1024)]
        + [(32, 2048, 4, 4, 256, 8, False)])
# benchmarks/session_throughput.py: path channels, depth, most ticks a
# round, pool rows, ring capacity, rounds, rows moved by take / scatter,
# rows of the streamed extend
SESSIONS = (3, 3, 32, 100_000, 64, 10, 4096, 10_000)


def launched(fn, where: str, **want):
    """Run ``fn`` with every count at 0; check that the kernels named in
    ``want`` launched that many times and nothing else did.  Returns fn's
    result and the counts."""
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    n = counts()
    expect = {k: want.get(k, 0) for k in n}
    check(n == expect, f"{where}: launches {n}, expected {expect}")
    return out, n


def value_and_grad_fn(fn, x: torch.Tensor):
    """() -> (fn(x), d sum(fn(x)²) / dx) on a leaf copy of x."""
    x = x.detach().clone().requires_grad_()

    def run():
        out = fn(x)
        return out, torch.autograd.grad((out ** 2).sum(), x)[0]
    return run


def phase_checkpoint(rng, train) -> dict:
    """Phase 19: value plus gradient with backward="checkpoint" and with
    time_chunks 4 and 16 at every Table 1 cell (one sig_trunc launch over
    the folded chunks, one sig_sweep), held against the float64 plain
    version; the folded forward and its sweep alone at the largest cell; a
    lead_lag checkpoint cell; the projected checkpoint cell at §8 width,
    which launches no kernel."""
    inverse_ms = {(r["B"], r["M"], r["d"], r["N"]): r["ms"] for r in train}
    modes = [("checkpoint", dict(backward="checkpoint")),
             ("time_chunks=4", dict(time_chunks=4)),
             ("time_chunks=16", dict(time_chunks=16))]
    rows, worst = [], 0.0
    for B, M, d, N in TABLE1:
        incs = torch.tensor(rng.normal(size=(B, M, d)) / np.sqrt(M),
                            dtype=torch.float32, device="cuda")
        x64 = incs.double()
        want = st.sig_trunc_plain(x64, N)
        g_want = ss.sig_sweep_plain(x64, sig.truncation_closure(d, N), want,
                                    2 * want)
        row = dict(B=B, M=M, d=d, N=N, inverse_ms=inverse_ms[(B, M, d, N)])
        line = []
        for name, kw in modes:
            where = f"Table 1 {name} cell {B, M, d, N}"
            run = value_and_grad_fn(lambda t: ops.signature(t, N, **kw), incs)
            (out, g), n = launched(run, where, sig_trunc=1, sig_sweep=1)
            err = float((out.double() - want).abs().max())
            check(within(out.double(), want, TOL["rtol"]),
                  f"{where}: value max |err| {err:.3e}")
            gerr = float((g.double() - g_want).abs().max())
            check(grad_within(g, g_want), f"{where}: gradient max |err| "
                  f"{gerr:.3e}, max|g| {float(g_want.abs().max()):.3e}")
            worst = max(worst, err)
            row[name] = dict(ms=cuda_ms(run, 5), max_abs_err=err,
                             grad_max_abs_err=gerr, launches=n)
            line.append(f"{name} {row[name]['ms']:.3f}")
        rows.append(row)
        print(f"[checkpoint] B={B:3d} M={M:3d} d={d:2d} N={N}: value+grad ms "
              f"inverse {row['inverse_ms']:.3f}, {', '.join(line)}; one "
              f"sig_trunc and one sig_sweep launch each; max |err| "
              f"{max(row[k]['max_abs_err'] for k, _ in modes):.2e}, "
              f"gradient "
              f"{max(row[k]['grad_max_abs_err'] for k, _ in modes):.2e}"
              f" (max|g| {float(g_want.abs().max()):.3e})", flush=True)
    cases = checkpoint_kernel_cases(rng)
    lead_lag = checkpoint_lead_lag(rng)
    projected = checkpoint_projected(rng)
    return dict(rows=rows, max_abs_err=worst, lead_lag=lead_lag,
                projected=projected, **cases)


def checkpoint_kernel_cases(rng) -> dict:
    """The checkpoint cell's two launches alone at the largest Table 1
    cell: sig_trunc over the folded chunks, and sig_sweep over them with
    each chunk signature as terminal state."""
    B, M, d, N = max(TABLE1, key=lambda c: c[0] * c[1] * horner_flops(
        c[2], c[3]))
    chunk = sig.default_chunk(M)
    C = -(-M // chunk)
    Mc = -(-M // C)
    incs = torch.tensor(rng.normal(size=(B, M, d)) / np.sqrt(M),
                        dtype=torch.float32, device="cuda")
    folded = torch.nn.functional.pad(incs, (0, 0, 0, C * Mc - M)).reshape(
        B * C, Mc, d)
    D = sum(d**n for n in range(1, N + 1))
    S = st.sig_trunc(folded, N)
    want = st.sig_trunc_plain(folded.double(), N)
    check(within(S.double(), want, TOL["rtol"]), "checkpoint chunks: "
          f"max |err| {float((S.double() - want).abs().max()):.3e}")
    b = bound(B * C, Mc, d, N, 4, B * C * D, 4)
    fwd = dict(case="checkpoint chunks, largest Table 1 cell",
               shape=[B * C, Mc, d, N], partition=trunc_partition(B * C, d, N),
               ms=cuda_ms(lambda: st.sig_trunc(folded, N), 5),
               plain_ms=cuda_ms(lambda: st.sig_trunc_plain(folded, N), 1),
               bound_ms=b[0], bound_by=b[1], launches=1)
    sweep = time_sweep(folded, sig.truncation_closure(d, N), S, 2 * S,
                       "checkpoint sweep over the folded chunks")
    sweep.pop("want")
    sweep.update(case="checkpoint sweep over folded chunks, largest "
                 "Table 1 cell", shape=[B * C, Mc, d, N], launches=1)
    traces = {mode: device_busy(value_and_grad_fn(lambda t: ops.signature(
        t, N, backward=mode), incs)) for mode in ("inverse", "checkpoint")}
    for mode, t in traces.items():
        print(f"[checkpoint] trace of one value+grad, {mode}, ({B}, {M}, "
              f"{d}, {N}): wall {t['wall_ms']:.3f} ms, device busy "
              + (f"{t['device_ms']:.3f} ms ({t['kernels']} kernels; idle "
                 f"share {1 - t['device_ms'] / t['wall_ms']:.2f})"
                 if t["device_ms"] else "not measured (no device events)"),
              flush=True)
    print(f"[checkpoint] largest Table 1 cell ({B}, {M}, {d}, {N}): {C} "
          f"chunks of {Mc} steps; sig_trunc over ({B * C}, {Mc}, {d}) "
          f"{fwd['ms']:.3f} ms (plain {fwd['plain_ms']:.3f}, bound "
          f"{b[0]:.5f} ms, {b[1]}); sig_sweep over them {sweep['ms']:.3f} ms "
          f"(plain {sweep['plain_ms']:.3f}, bound {sweep['bound_ms']:.5f} ms,"
          f" {sweep['bound_by']})", flush=True)
    return dict(trunc_case=fwd, sweep_case=sweep, traces=traces)


SIG_KERNELS = ("sig_trunc_kernel", "sig_words_kernel", "sig_gram_kernel",
               "sweep_kernel")


def device_busy(fn) -> dict:
    """One warm call of ``fn`` under torch.profiler: the host's wall ms to
    a synchronize, the device's busy ms (the kernels' summed self time),
    the number of kernels and the busy ms of the signature kernels
    (``sig_ms``); device_ms is 0 when the profiler records no device
    events."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA")]
    def self_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    busy = sum(self_us(e) for e in dev)
    sig_us = sum(self_us(e) for e in dev
                 if any(k in e.key for k in SIG_KERNELS))
    return dict(wall_ms=wall, device_ms=busy / 1e3,
                kernels=sum(e.count for e in dev), sig_ms=sig_us / 1e3)


def checkpoint_lead_lag(rng) -> dict:
    """transform="lead_lag" with backward="checkpoint" at the Table 1
    fused_transform cell: the augmented increments are materialised, then
    the checkpoint cell runs (one unfused sig_trunc, one sig_sweep)."""
    _, B, M, d, N, _ = TABLE1_FUSED[0]
    spec = as_transform("lead_lag")
    incs = torch.tensor(rng.normal(size=(B, M, d)) / np.sqrt(M),
                        dtype=torch.float32, device="cuda")
    x64 = incs.double()
    want = st.sig_trunc_plain(x64, N, transform=spec)
    g_want = fused_adjoint(ss.sig_sweep_plain(
        fused_augment(x64, None, spec), sig.truncation_closure(2 * d, N),
        want, 2 * want), spec, d)
    where = f"lead_lag checkpoint ({B}, {M}, {d}, {N})"
    run = value_and_grad_fn(lambda t: ops.signature(
        t, N, transform="lead_lag", backward="checkpoint"), incs)
    (out, g), n = launched(run, where, sig_trunc=1, sig_sweep=1)
    err = float((out.double() - want).abs().max())
    gerr = float((g.double() - g_want).abs().max())
    check(within(out.double(), want, TOL["rtol"]),
          f"{where}: max |err| {err:.3e}")
    check(grad_within(g, g_want), f"{where}: gradient max |err| {gerr:.3e}")
    ms = cuda_ms(run, 5)
    print(f"[checkpoint] {where}: {2 * M} augmented steps over {2 * d} "
          f"letters, launches {n}; value+grad {ms:.3f} ms; max |err| "
          f"{err:.2e}, gradient {gerr:.2e}", flush=True)
    return dict(shape=[B, M, d, N], ms=ms, launches=n, max_abs_err=err,
                grad_max_abs_err=gerr)


def checkpoint_projected(rng) -> dict:
    """ops.projected(backward="checkpoint") at §8 width through lead_lag:
    the torch engine on the card's tensors (the word kernel emits no
    boundary closure states), so no kernel launches."""
    B, M, d, N, _ = PROJ_CELL
    plan = make_plan(generated_words(sparse_leadlag_generators(d), N), 2 * d)
    incs = tops.path_increments(brownian(rng, B, M, d))
    kw = dict(transform="lead_lag")
    where = f"projected checkpoint §8 ({B}, {M}, {d}, {N})"
    run = value_and_grad_fn(lambda t: ops.projected(
        t, plan, backward="checkpoint", **kw), incs)
    (out, g), n = launched(run, where)
    want, g_want = value_and_grad_fn(lambda t: ops.projected(
        t, plan, backend="torch", **kw), incs.double())()
    want = want.detach()
    err = float((out.double() - want).abs().max())
    gerr = float((g.double() - g_want).abs().max())
    check(within(out.double(), want, TOL["rtol"]),
          f"{where}: max |err| {err:.3e}")
    check(grad_within(g, g_want), f"{where}: gradient max |err| {gerr:.3e}")
    ms = cuda_ms(run, 1)
    print(f"[checkpoint] {where} onto {len(plan.words)} words: the torch "
          f"engine on the card, launches {n} (no kernel: the word kernel "
          f"emits no boundary closure states); value+grad {ms:.3f} ms; max "
          f"|err| vs the float64 inverse cell {err:.2e}, gradient "
          f"{gerr:.2e}", flush=True)
    return dict(shape=[B, M, d, N], words=len(plan.words), ms=ms,
                launches=n, max_abs_err=err, grad_max_abs_err=gerr)


def phase_windows(rng) -> dict:
    """Phase 20: the Fig. 3 grid through windowed_signature: fold, chen,
    auto and per-window times, auto's pick, one launch a route, values
    against the float64 plain per-window signatures, the auto route's
    gradient against float64 autodiff; then a §8-set windowed projection
    through lead_lag, a ragged case and a time_augment case."""
    rows = []
    for B, M, d, N, wlen, stride, per_window in FIG3:
        path = brownian(rng, B, M, d)
        windows = win.sliding_windows(M, wlen, stride)
        K = len(windows)
        where = (f"Fig. 3 B={B} M={M} K={K} window {wlen} stride {stride} "
                 f"d={d} N={N}")
        pick = win.select_route("auto", windows, M)
        out, ms = {}, {}
        for route in ("fold", "chen", "auto"):
            kern = pick if route == "auto" else route
            want = dict(sig_trunc=1) if kern == "fold" \
                else dict(sig_trunc_stream=1)

            def call(route=route):
                return win.windowed_signature(path, windows, N, route=route)
            out[route], _ = launched(call, f"{where} {route}", **want)
            ms[route] = cuda_ms(call, 5)
        if per_window:
            incs = tops.path_increments(path)

            def per():
                return [ops.signature(incs[:, lo:hi], N)
                        for lo, hi in windows]
            launched(per, f"{where} per-window", sig_trunc=K)
            ms["per_window"] = cuda_ms(per, 3)
        plain = win.windowed_signature(path.double(), windows, N,
                                       route="fold", backend="torch",
                                       backward="autodiff")
        scale = float(plain.abs().max())
        err = {r: float((out[r].double() - plain).abs().max())
               for r in ("fold", "chen")}
        check(within(out["fold"].double(), plain, TOL["rtol"]),
              f"{where}: fold max |err| {err['fold']:.3e}")
        check(err["chen"] <= E2E_TOL * scale, f"{where}: chen max |err| "
              f"{err['chen']:.3e}, max|S| {scale:.3e}")
        fold_vs_chen = float((out["fold"] - out["chen"]).abs().max())
        run = value_and_grad_fn(lambda p: win.windowed_signature(
            p, windows, N), path)
        (_, g), n = launched(run, f"{where} auto value and gradient",
                             sig_sweep=1, **({"sig_trunc": 1}
                                             if pick == "fold" else
                                             {"sig_trunc_stream": 1}))
        # the float64 oracle: autodiff through the torch engine's fold
        # route, or for long windows its chen route (fewer saved steps)
        oracle = "chen" if wlen > 64 else "fold"
        _, g64 = value_and_grad_fn(lambda p: win.windowed_signature(
            p, windows, N, route=oracle, backend="torch",
            backward="autodiff"), path.double())()
        gerr = float((g.double() - g64).abs().max())
        check(grad_within(g, g64), f"{where}: auto gradient max |err| "
              f"{gerr:.3e}, max|g| {float(g64.abs().max()):.3e}")
        ms["auto_value_and_grad"] = cuda_ms(run, 3)
        best = min(ms["fold"], ms["chen"])
        faster = "fold" if ms["fold"] <= ms["chen"] else "chen"
        row = dict(B=B, M=M, K=K, wlen=wlen, stride=stride, d=d, N=N,
                   auto_route=pick, faster_route=faster,
                   auto_within_15pct=bool(ms[pick] <= 1.15 * best),
                   auto_over_best=ms["auto"] / best, max_abs_err=err,
                   fold_vs_chen=fold_vs_chen, grad_max_abs_err=gerr,
                   max_g=float(g64.abs().max()), launches=n,
                   **{f"{k}_ms": v for k, v in ms.items()})
        rows.append(row)
        print(f"[windows] {where}: fold {ms['fold']:.3f} ms, chen "
              f"{ms['chen']:.3f}, auto ({pick}) {ms['auto']:.3f}"
              + (f", per-window {ms['per_window']:.3f}" if per_window
                 else "")
              + f"; faster {faster}, auto within 15%: "
              f"{row['auto_within_15pct']}; one launch a route; max |err| "
              f"vs float64 plain fold {err['fold']:.2e}, chen "
              f"{err['chen']:.2e} (max|S| {scale:.2e}), fold vs chen "
              f"{fold_vs_chen:.2e}; auto value+grad "
              f"{ms['auto_value_and_grad']:.3f} ms, launches {n}, gradient "
              f"max |err| {gerr:.2e}", flush=True)
    extra = windows_extra_cases(rng)
    cases = windows_kernel_cases(rng)
    return dict(rows=rows, **extra, **cases)


def windows_extra_cases(rng) -> dict:
    """At the K = 64 cell of the grid: windowed_projection onto the §8
    sparse lead-lag word set at d = 4, depth 3, through lead_lag (one fused
    sig_words launch, one sig_sweep); a ragged batch on both routes; a
    time_augment per-window case (one fused sig_trunc launch)."""
    B, M, d, _, wlen, stride, _ = FIG3[2]
    path = brownian(rng, B, M, d)
    windows = win.sliding_windows(M, wlen, stride)
    K = len(windows)
    words = generated_words(sparse_leadlag_generators(d), 3)
    plan = make_plan(words, 2 * d)
    where = f"windowed projection §8 set (d={d}, depth 3) lead_lag K={K}"
    run = value_and_grad_fn(lambda p: win.windowed_projection(
        p, windows, plan, transform="lead_lag"), path)
    (proj, g), n = launched(run, where, sig_words=1, sig_words_fused=1,
                            sig_sweep=1)
    want, g64 = value_and_grad_fn(lambda p: win.windowed_projection(
        p, windows, plan, transform="lead_lag", backend="torch",
        backward="autodiff"), path.double())()
    want = want.detach()
    perr = float((proj.double() - want).abs().max())
    gerr = float((g.double() - g64).abs().max())
    check(within(proj.double(), want, TOL["rtol"]),
          f"{where}: max |err| {perr:.3e}")
    check(grad_within(g, g64), f"{where}: gradient max |err| {gerr:.3e}")
    pms = cuda_ms(lambda: win.windowed_projection(path, windows, plan,
                                                  transform="lead_lag"), 5)
    # the sig_words launch alone on the window increments
    g_inc = win._window_increments(path, windows).reshape(B * K, wlen, d)
    ctp = make_tiled_plan(plan.closure, 2 * d)
    spec = as_transform("lead_lag")
    kms = cuda_ms(lambda: sw.sig_words(g_inc, ctp, transform=spec), 5)
    flops = fused_step_flops(spec, d, lambda mv: words_flops(plan, mv))
    b = bound(B * K, 2 * wlen, 2 * d, 3, 4, B * K * len(plan.closure), 4,
              flops, raw=(wlen, d))
    print(f"[windows] {where} onto {len(words)} words: launches {n}; "
          f"windowed_projection {pms:.3f} ms, sig_words alone over "
          f"({B * K}, {wlen}, {d}) raw {kms:.3f} ms, bound {b[0]:.5f} ms "
          f"({b[1]}); max |err| {perr:.2e}, gradient {gerr:.2e}", flush=True)
    words_case = dict(case="windowed projection fold, §8 set lead_lag",
                      shape=[B * K, wlen, d, 3], words=len(plan.closure),
                      transform="lead_lag", ms=kms, route_ms=pms,
                      bound_ms=b[0], bound_by=b[1], launches=1)
    lengths = torch.tensor(rng.integers(M // 4, M + 1, size=B),
                           dtype=torch.int32, device="cuda")
    ragged = {}
    for route, kern in (("fold", "sig_trunc"), ("chen", "sig_trunc_stream")):
        out, _ = launched(lambda: win.windowed_signature(
            path, windows, 3, route=route, lengths=lengths),
            f"ragged windows {route}", **{kern: 1})
        want = win.windowed_signature(path.double(), windows, 3,
                                      route="fold", lengths=lengths,
                                      backend="torch")
        ragged[route] = float((out.double() - want).abs().max())
        check(within(out.double(), want, TOL["rtol"]) if route == "fold"
              else ragged[route] <= E2E_TOL * float(want.abs().max()),
              f"ragged windows {route}: max |err| {ragged[route]:.3e}")
    out, n_t = launched(lambda: win.windowed_signature(
        path, windows, 3, transform="time_augment"),
        "time_augment windows", sig_trunc=1, sig_trunc_fused=1)
    want = win.windowed_signature(path.double(), windows, 3,
                                  transform="time_augment", backend="torch")
    terr = float((out.double() - want).abs().max())
    check(within(out.double(), want, TOL["rtol"]),
          f"time_augment windows: max |err| {terr:.3e}")
    print(f"[windows] ragged (lengths in [{M // 4}, {M}]): fold max |err| "
          f"{ragged['fold']:.2e}, chen {ragged['chen']:.2e}; time_augment "
          f"per window: one fused sig_trunc launch {n_t}, max |err| "
          f"{terr:.2e}", flush=True)
    return dict(projection=dict(words=len(words), launches=n,
                                max_abs_err=perr, grad_max_abs_err=gerr,
                                ms=pms),
                ragged=ragged, time_augment_err=terr, words_case=words_case)


def windows_kernel_cases(rng) -> dict:
    """The two routes' launches alone at the heavy-overlap cell: sig_trunc
    over the B·K folded windows, the streamed sig_trunc over the path."""
    B, M, d, N, wlen, stride, _ = FIG3[-1]
    path = brownian(rng, B, M, d)
    windows = win.sliding_windows(M, wlen, stride)
    K = len(windows)
    D = sum(d**n for n in range(1, N + 1))
    folded = win._window_increments(path, windows).reshape(B * K, wlen, d)
    incs = tops.path_increments(path)
    fb = bound(B * K, wlen, d, N, 4, B * K * D, 4)
    cb = bound(B, M, d, N, 4, B * M * D, 4)
    fold = dict(case="windows fold, Fig. 3 heavy-overlap cell",
                shape=[B * K, wlen, d, N],
                partition=trunc_partition(B * K, d, N),
                ms=cuda_ms(lambda: st.sig_trunc(folded, N), 5),
                bound_ms=fb[0], bound_by=fb[1], launches=1)
    chen = dict(case="windows chen, Fig. 3 heavy-overlap cell",
                shape=[B, M, d, N, 1], partition=trunc_partition(B, d, N),
                ms=cuda_ms(lambda: st.sig_trunc(incs, N, stream=True), 5),
                bound_ms=cb[0], bound_by=cb[1], launches=1)
    print(f"[windows] heavy-overlap cell, kernels alone: sig_trunc over "
          f"({B * K}, {wlen}, {d}) {fold['ms']:.3f} ms (bound {fb[0]:.5f} "
          f"ms, {fb[1]}); streamed sig_trunc over ({B}, {M}, {d}) "
          f"{chen['ms']:.3f} ms (bound {cb[0]:.5f} ms, {cb[1]})", flush=True)
    return dict(fold_case=fold, chen_case=chen)


def ring_windows(carry, rows: torch.Tensor) -> torch.Tensor:
    """(len(rows), R, d) each row's ring contents oldest first, zero past
    its length (a zero increment is the identity)."""
    R = carry.capacity
    length, end = carry.length[rows].long(), carry.end[rows].long()
    steps = torch.arange(R, device=rows.device)
    idx = (end[:, None] - length[:, None] + steps) % R
    w = carry.ring[rows[:, None], idx]
    return w * (steps[None, :] < length[:, None])[..., None].to(w.dtype)


def phase_stream(rng) -> dict:
    """Phase 21: a StreamCarry at the scale of
    benchmarks/session_throughput.py: ten rounds of stream_extend with
    per-row counts and stream_rolling_drop, stream_take / stream_scatter of
    4,096 rows, one sig_trunc launch an extend; sampled rows against the
    float64 plain signature of their ring, dead and zero-count rows
    bitwise unchanged; the streamed extend; a batch-1 SignatureStream."""
    d, N, m, n_rows, R, rounds, n_move, n_feat = SESSIONS
    D = sum(d**n for n in range(1, N + 1))
    dev = "cuda"
    pool = stream.stream_init(n_rows, d, N, capacity=R, valid=True)
    alive = rng.random(n_rows) >= 0.01
    pool = dataclasses.replace(pool, valid=torch.tensor(alive, device=dev))
    dead = torch.tensor(~alive, device=dev)
    length = np.zeros(n_rows, np.int64)     # the host's mirror
    round_ms, ticks = [], 0
    for r in range(rounds):
        ticks_in = rng.integers(0, m + 1, size=n_rows)
        ticks_in[rng.random(n_rows) < 0.1] = 0
        counts_t = torch.tensor(ticks_in, dtype=torch.int32, device=dev)
        x = torch.tensor(rng.normal(size=(n_rows, m, d)) * 0.1,
                         dtype=torch.float32, device=dev)
        eff = ticks_in * alive
        drop = np.minimum(np.maximum(length + eff - m, 0)
                          + rng.integers(0, 5, size=n_rows), length + eff)
        drop_t = torch.tensor(drop, dtype=torch.int32, device=dev)
        before = pool
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        reset_counts()
        t0.record()
        mid = stream.stream_extend(pool, x, counts=counts_t)
        pool = stream.stream_rolling_drop(mid, drop_t,
                                          max_drop=int(drop.max()))
        t1.record()
        t1.synchronize()
        round_ms.append(t0.elapsed_time(t1))
        n = counts()
        check(n == {**{k: 0 for k in n}, "sig_trunc": 1},
              f"stream round {r}: launches {n}")
        idle = torch.tensor(eff == 0, device=dev)
        for f in ("sig", "ring", "length", "end"):
            check(torch.equal(getattr(mid, f)[idle], getattr(before, f)[idle]),
                  f"stream round {r}: zero-count or dead rows changed {f}")
        kept = torch.tensor(drop == 0, device=dev)
        check(torch.equal(pool.sig[kept], mid.sig[kept]),
              f"stream round {r}: rows without a drop changed")
        length = length + eff - drop
        ticks += int(eff.sum())
    check(np.array_equal(pool.length.cpu().numpy(), length),
          "stream: lengths differ from the host's mirror")
    check(not pool.sig[dead].any() and not pool.ring[dead].any(),
          "stream: a dead lane changed")
    # take / scatter of 4,096 rows, one extend between
    slots = torch.tensor(rng.choice(n_rows, n_move, replace=False),
                         device=dev)
    c_move = np.minimum(rng.integers(1, m + 1, size=n_move),
                        R - length[slots.cpu().numpy()])
    y = torch.tensor(rng.normal(size=(n_move, m, d)) * 0.1,
                     dtype=torch.float32, device=dev)

    def move():
        sub = stream.stream_take(pool, slots)
        sub = stream.stream_extend(sub, y, counts=torch.tensor(
            c_move, dtype=torch.int32, device=dev))
        return stream.stream_scatter(pool, slots, sub)
    pool, _ = launched(move, "stream take/extend/scatter", sig_trunc=1)
    length[slots.cpu().numpy()] += c_move * alive[slots.cpu().numpy()]
    move_ms = cuda_ms(move, 3)
    # 256 sampled rows (half of them moved) against the float64 plain
    # signature of their ring's contents
    sample = torch.cat([slots[:128], torch.tensor(
        rng.choice(n_rows, 128, replace=False), device=dev)])
    want = st.sig_trunc_plain(ring_windows(pool, sample).double(), N)
    got = pool.sig[sample].double()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(err <= E2E_TOL * scale, f"stream sampled rows: max |err| "
          f"{err:.3e}, max|S| {scale:.3e}")
    # the kernel alone at an extend's shape
    x = torch.tensor(rng.normal(size=(n_rows, m, d)) * 0.1,
                     dtype=torch.float32, device=dev)
    b = bound(n_rows, m, d, N, 4, n_rows * D, 4)
    extend_case = dict(case="stream extend, 100,000 rows",
                       shape=[n_rows, m, d, N],
                       partition=trunc_partition(n_rows, d, N),
                       ms=cuda_ms(lambda: st.sig_trunc(x, N), 5),
                       bound_ms=b[0], bound_by=b[1], launches=rounds + 1)
    feats = stream_features(rng)
    single = stream_single(rng)
    med = float(np.median(round_ms))
    print(f"[stream] StreamCarry of {n_rows} rows (d={d}, depth {N}, ring "
          f"{R}, {int((~alive).sum())} dead): {rounds} rounds of extend "
          f"(counts 0..{m}) and rolling_drop, one sig_trunc launch an "
          f"extend, {med:.3f} ms a round (median), {n_rows / med * 1e3:.0f} "
          f"rows/s, {ticks / sum(round_ms) * 1e3:.0f} ticks/s; zero-count "
          f"and dead rows bitwise unchanged; take/extend/scatter of "
          f"{n_move} rows {move_ms:.3f} ms; 256 sampled rows vs float64 "
          f"plain of their rings max |err| {err:.2e} (max|S| {scale:.2e}); "
          f"sig_trunc alone at ({n_rows}, {m}, {d}) {extend_case['ms']:.3f} "
          f"ms, bound {b[0]:.5f} ms ({b[1]})", flush=True)
    return dict(rows=n_rows, round_ms=round_ms, median_round_ms=med,
                rows_per_s=n_rows / med * 1e3,
                ticks_per_s=ticks / sum(round_ms) * 1e3, move_ms=move_ms,
                max_abs_err=err, max_sig=scale, extend_case=extend_case,
                features=feats, single=single)


def stream_features(rng) -> dict:
    """stream_extend(return_stream=True) at 10,000 rows: one streamed
    sig_trunc launch; 64 rows' features against the float64 plain stream
    of their whole history."""
    d, N, m, _, _, _, _, n = SESSIONS
    D = sum(d**k for k in range(1, N + 1))
    pool = stream.stream_init(n, d, N, valid=True)
    first = torch.tensor(rng.normal(size=(n, m, d)) * 0.1,
                         dtype=torch.float32, device="cuda")
    x = torch.tensor(rng.normal(size=(n, m, d)) * 0.1, dtype=torch.float32,
                     device="cuda")
    pool = stream.stream_extend(pool, first)
    (_, feats), launches = launched(lambda: stream.stream_extend(
        pool, x, return_stream=True), "streamed extend",
        sig_trunc_stream=1)
    rows = torch.tensor(rng.choice(n, 64, replace=False), device="cuda")
    want = st.sig_trunc_plain(torch.cat([first, x], 1)[rows].double(), N,
                              stream=True)[:, m:]
    err = float((feats[rows].double() - want).abs().max())
    check(err <= E2E_TOL * float(want.abs().max()),
          f"streamed extend: max |err| {err:.3e}")
    b = bound(n, m, d, N, 4, n * m * D, 4)
    case = dict(case="stream extend return_stream, 10,000 rows",
                shape=[n, m, d, N, 1], partition=trunc_partition(n, d, N),
                ms=cuda_ms(lambda: st.sig_trunc(x, N, stream=True), 5),
                route_ms=cuda_ms(lambda: stream.stream_extend(
                    pool, x, return_stream=True), 5),
                bound_ms=b[0], bound_by=b[1], launches=1)
    print(f"[stream] extend(return_stream=True) at {n} rows: launches "
          f"{launches}; {case['route_ms']:.3f} ms, the streamed sig_trunc "
          f"alone {case['ms']:.3f} ms (bound {b[0]:.5f} ms, {b[1]}); 64 "
          f"rows max |err| {err:.2e}", flush=True)
    return dict(max_abs_err=err, case=case)


def stream_single(rng) -> dict:
    """A batch-1 SignatureStream with a 64-step ring: 20 hops of 8 ticks,
    dropping as needed, one sig_trunc launch an extend; the last window
    against the float64 plain signature."""
    d, N, _, _, R, _, _, _ = SESSIONS
    hop, hops = 8, 20
    x = torch.tensor(rng.normal(size=(1, hop * hops, d)) * 0.1,
                     dtype=torch.float32, device="cuda")
    s = stream.signature_stream_init(1, d, N, capacity=R)
    start, t = 0, []
    for k in range(hops):
        need = max(0, s.length + hop - R)
        s = s.rolling_drop(need)
        start += need
        t0 = time.perf_counter()
        s, _ = launched(lambda: s.extend(x[:, hop * k:hop * (k + 1)]),
                        "SignatureStream extend", sig_trunc=1)
        t.append((time.perf_counter() - t0) * 1e3)
    want = st.sig_trunc_plain(x[:, start:].double(), N)
    err = float((s.sig.double() - want).abs().max())
    check(err <= E2E_TOL * float(want.abs().max()),
          f"SignatureStream: max |err| {err:.3e}")
    ms = float(np.median(t))
    print(f"[stream] SignatureStream batch 1, ring {R}: {hops} hops of "
          f"{hop}, one sig_trunc launch each, {ms:.3f} ms an extend "
          f"(host clock, median); window [{start}, {hop * hops}) max |err| "
          f"{err:.2e}", flush=True)
    return dict(max_abs_err=err, extend_ms=ms)


# ---------------------------------------------------------------------------
# phase 22: the session pool, its engines, pool checkpoints and the
# batcher's prefetch
# ---------------------------------------------------------------------------

DEV = "cuda"
# benchmarks/session_throughput.py run(quick=False): pool sizes, path
# channels, depth, rounds, ticking sessions a round, most ticks a session
# and round, seed; RATE_MEAN is its _RATE_MEAN (the mean Pareto activity)
POOL_SWEEP = (10_000, 100_000, 1_000_000)
POOL_CFG = (3, 3, 4, 512, 32, 0)
RATE_MEAN = 6.0
# the ring pool: population, ring, max_sessions, ttl, tick probability,
# arrivals and churn a round, rounds
RING_POOL = (4_000, 64, 2_048, 2.0, 0.15, 40.0, 0.02, 8)
# the engines: d, depth, batch, window, stride, pushes, steps a push
ENGINE_CELL = (6, 5, 64, 256, 8, 8, 64)


def pool_rounds(n: int) -> list:
    """The benchmark's pre-generated ingest rounds from the port's
    session_tick_stream (tick_prob aims the ticking set at k)."""
    d, _, rounds, k, max_ticks, seed = POOL_CFG
    traffic = session_tick_stream(n, d, seed=seed, max_ticks=max_ticks,
                                  tick_prob=min(1.0, k / (RATE_MEAN * n)))
    return [(r["sids"], r["counts"], r["ticks"])
            for r in (next(traffic) for _ in range(rounds))]


def expected_buckets(counts, max_ticks: int, max_rows: int) -> int:
    """Buckets (one sig_trunc launch each) of a flush in which each
    session has queued ``counts`` ticks, worked out from the counts alone:
    per wave of at most max_ticks ticks, one bucket per tick rung and
    max_rows rows."""
    left, n = np.asarray(counts, np.int64), 0
    while left.size:
        rungs = np.minimum(max_ticks, 2 ** np.ceil(np.log2(np.maximum(
            np.minimum(left, max_ticks), 1))).astype(np.int64))
        n += sum(-(-int((rungs == u).sum()) // max_rows)
                 for u in np.unique(rungs))
        left = left[left > max_ticks] - max_ticks
    return n


def pooled_plan(n: int, rounds: list) -> dict:
    """SessionStore over the rounds, two epochs (cold, warm): one flush a
    round, its sig_trunc launches counted against its buckets."""
    d, N, _, _, max_ticks, _ = POOL_CFG
    store = SessionStore(d, N, initial_sessions=n, max_ticks=max_ticks,
                         device=DEV)
    walls, launches, want = [], [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for sids, cnt, ticks in rounds:
            reset_counts()
            store.ingest_many(sids, cnt, ticks, auto_create=True)
            store.flush()
            launches.append(counts())
            want.append(expected_buckets(cnt, store.max_ticks,
                                         store.max_rows))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    for k, (got, w) in enumerate(zip(launches, want)):
        check(got == {**{key: 0 for key in got}, "sig_trunc": w},
              f"pool of {n}: flush {k} launched {got}, {w} buckets")
    return dict(store=store, cold_s=walls[0], warm_s=walls[1],
                launches=sum(x["sig_trunc"] for x in launches),
                flushes=len(launches))


def per_object_plan(rounds: list) -> tuple[dict, list]:
    """One batch-1 SignatureStream a ticking session, one extend (one
    sig_trunc launch) a session and round; two epochs."""
    d, N = POOL_CFG[:2]
    streams, walls = {}, []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for sids, cnt, ticks in rounds:
            for sid, chunk in zip(sids, np.split(ticks, np.cumsum(cnt)[:-1])):
                s = streams.get(sid)
                if s is None:
                    s = stream.signature_stream_init(1, d, N, device=DEV)
                streams[sid] = s.extend(torch.from_numpy(chunk)[None].to(DEV))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return streams, walls


def sessions_plain(rounds: list, sids: list, N: int) -> torch.Tensor:
    """Float64 plain signatures of each sid's ticks over two epochs of the
    rounds, zero-padded to one batch (a zero increment is the identity)."""
    hist = {s: [] for s in sids}
    for _ in range(2):
        for r_sids, cnt, ticks in rounds:
            for sid, chunk in zip(r_sids, np.split(ticks,
                                                   np.cumsum(cnt)[:-1])):
                if sid in hist:
                    hist[sid].append(chunk)
    L = max(sum(len(c) for c in h) for h in hist.values())
    x = np.zeros((len(sids), L, POOL_CFG[0]))
    for i, sid in enumerate(sids):
        cat = np.concatenate(hist[sid])
        x[i, :len(cat)] = cat
    return st.sig_trunc_plain(torch.tensor(x, device=DEV), N)


def round_trace(store, rnd) -> dict:
    """Where a warm round's time goes at a pool: one ingest + flush under
    torch.profiler (device_busy), then one more with the ingest and the
    flush timed apart on the host clock (the flush to a synchronize)."""
    sids, cnt, ticks = rnd

    def one():
        store.ingest_many(sids, cnt, ticks)
        store.flush()

    trace = device_busy(one)
    t0 = time.perf_counter()
    store.ingest_many(sids, cnt, ticks)
    t1 = time.perf_counter()
    store.flush()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return dict(trace=trace, ingest_ms=(t1 - t0) * 1e3,
                flush_ms=(t2 - t1) * 1e3, ticks=int(cnt.sum()),
                buckets=expected_buckets(cnt, store.max_ticks,
                                         store.max_rows))


def phase_pool(rng) -> dict:
    """Phase 22a: benchmarks/session_throughput.py's full sweep, pooled and
    per object, on the card."""
    d, N, n_rounds, k, max_ticks, _ = POOL_CFG
    rows, keep, bucket = [], None, None
    for n in POOL_SWEEP:
        rounds = pool_rounds(n)
        ticks = int(sum(int(c.sum()) for _, c, _ in rounds))
        p = pooled_plan(n, rounds)
        store = p.pop("store")
        stats = store.stats()
        bound_shapes = (int(np.log2(store.max_ticks)) + 1) * (
            int(np.log2(store.max_rows)) + 1) * len(stats["pool_sizes"])
        check(stats["compiled_shapes"] <= bound_shapes,
              f"pool of {n}: {stats['compiled_shapes']} launch shapes > "
              f"bound {bound_shapes}")
        check(stats["updates"] == 2 * ticks, f"pool of {n}: "
              f"{stats['updates']} updates for {2 * ticks} ticks")
        streams, o_walls = per_object_plan(rounds)
        worst = 0.0
        for sid in list(streams)[:8]:
            got, want = store.features(sid), streams[sid].sig[0]
            err = float((got - want).abs().max())
            worst = max(worst, err)
            check(err <= E2E_TOL * float(want.abs().max()),
                  f"pool of {n}: {sid} pooled vs per object max |err| "
                  f"{err:.3e}")
        live = list(store._ids)
        sample = [live[i] for i in rng.choice(len(live), min(256, len(live)),
                                              replace=False)]
        want = sessions_plain(rounds, sample, N)
        got = store.block_features(sample).double()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(err <= E2E_TOL * scale, f"pool of {n}: 256 sampled sessions "
              f"max |err| {err:.3e}, max|S| {scale:.3e}")
        row = dict(n_sessions=n, ticks_per_epoch=ticks,
                   touched_sessions=len(streams), **p,
                   updates_per_s_warm=ticks / p["warm_s"],
                   p50_staleness_s=stats["p50_staleness_s"],
                   p99_staleness_s=stats["p99_staleness_s"],
                   flush_shapes=stats["flush_shapes"],
                   compiled_shapes=stats["compiled_shapes"],
                   compiled_shape_bound=bound_shapes,
                   pool_size=stats["pool_size"],
                   per_object_cold_s=o_walls[0], per_object_warm_s=o_walls[1],
                   per_object_updates_per_s_warm=ticks / o_walls[1],
                   speedup_warm=o_walls[1] / p["warm_s"],
                   max_abs_err_vs_per_object=worst, max_abs_err=err,
                   max_sig=scale, health=store.health()["status"])
        rows.append(row)
        print(f"[sessions] pool of {n}: {ticks} ticks an epoch over "
              f"{len(streams)} sessions; pooled cold {p['cold_s']:.3f} s, "
              f"warm {p['warm_s']:.4f} s ({row['updates_per_s_warm']:.0f} "
              f"updates/s), staleness p50 {row['p50_staleness_s'] * 1e3:.3f}"
              f" ms p99 {row['p99_staleness_s'] * 1e3:.3f} ms; "
              f"{p['launches']} sig_trunc launches over {p['flushes']} "
              f"flushes, one a bucket; flush shapes {stats['flush_shapes']},"
              f" {stats['compiled_shapes']} launch shapes (bound "
              f"{bound_shapes}); per object warm {o_walls[1]:.3f} s "
              f"({row['per_object_updates_per_s_warm']:.0f} updates/s), "
              f"pooled {row['speedup_warm']:.1f}x; 8 sessions vs per "
              f"object max |err| {worst:.2e}; 256 sampled vs float64 plain "
              f"max |err| {err:.2e} (max|S| {scale:.2e}); health "
              f"{row['health']}", flush=True)
        if n == 100_000:
            keep = store
        if n == POOL_SWEEP[-1]:
            row["round"] = rt = round_trace(store, rounds[0])
            tr = rt["trace"]
            print(f"[sessions] a warm round at the pool of {n} "
                  f"({rt['ticks']} ticks, {rt['buckets']} buckets): ingest "
                  f"{rt['ingest_ms']:.3f} ms, flush {rt['flush_ms']:.3f} ms "
                  f"(host clock); traced, {tr['wall_ms']:.3f} ms wall, "
                  f"device busy {tr['device_ms']:.3f} ms in "
                  f"{tr['kernels']} kernels (idle share "
                  f"{1 - tr['device_ms'] / tr['wall_ms']:.2f})", flush=True)
            rung, B = max(stats["flush_shapes"], key=lambda s: s[0] * s[1])
            x = torch.tensor(rng.normal(size=(B, rung, d)) * 0.1,
                             dtype=torch.float32, device=DEV)
            D = sum(d**j for j in range(1, N + 1))
            b = bound(B, rung, d, N, 4, B * D, 4)
            bucket = dict(case="session flush bucket, pool of 1,000,000",
                          shape=[B, rung, d, N],
                          partition=trunc_partition(B, d, N),
                          ms=cuda_ms(lambda: st.sig_trunc(x, N), 10),
                          plain_ms=cuda_ms(lambda: st.sig_trunc_plain(x, N),
                                           1),
                          bound_ms=b[0], bound_by=b[1],
                          launches=p["launches"])
            print(f"[sessions] sig_trunc alone at the largest bucket "
                  f"({B}, {rung}, {d}, {N}): {bucket['ms']:.4f} ms, plain "
                  f"{bucket['plain_ms']:.3f} ms, bound {b[0]:.6f} ms "
                  f"({b[1]})", flush=True)
        del store, streams
    return dict(rows=rows, store=keep, bucket_case=bucket)


def phase_ring_pool(rng) -> dict:
    """Phase 22b: a ring pool below its population, with TTL, LRU and
    explicit (churn) evictions, hopping windows by drop_block."""
    d, N = POOL_CFG[:2]
    pop, R, cap, ttl, prob, arrivals, churn, rounds = RING_POOL
    store = SessionStore(d, N, ring_capacity=R, initial_sessions=1024,
                         max_sessions=cap, ttl=ttl, max_ticks=32,
                         device=DEV)
    traffic = session_tick_stream(pop, d, seed=1, tick_prob=prob,
                                  arrival_rate=arrivals, churn_prob=churn,
                                  max_ticks=32)
    stale, drops, t0 = None, 0, time.perf_counter()
    for _ in range(rounds):
        r = next(traffic)
        fresh = [s for s in r["sids"] if s not in store]
        store.create_many(fresh)             # may LRU-evict
        keep = [i for i, s in enumerate(r["sids"]) if s in store]
        sids = [r["sids"][i] for i in keep]
        cnt = r["counts"][keep]
        chunks = np.split(r["ticks"], np.cumsum(r["counts"])[:-1])
        need = {}
        for sid, c in zip(sids, cnt):
            over = store.length(sid) + int(c) - R
            if over > 0:
                need.setdefault(over, []).append(sid)
        for n_drop, block in need.items():   # hopping windows
            store.drop_block(block, n_drop)
            drops += len(block)
        if sids:
            store.ingest_many(sids, cnt, np.concatenate(
                [chunks[i] for i in keep]))
        for sid in r["departures"]:
            if sid in store:
                if stale is None:
                    stale = store.lookup(sid)
                store.evict(sid)             # its queued ticks are dropped
        store.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    try:
        store.lookup(stale)
        check(False, "a stale handle resolved")
    except ValueError:
        pass
    stats = store.stats()
    ev = stats["evictions"]
    check(min(ev.values()) > 0 and stats["dropped_ticks"] > 0 and drops,
          f"ring pool: evictions {ev}, dropped ticks "
          f"{stats['dropped_ticks']}, drops {drops}")
    live = np.asarray(list(store._ids.values()))
    rows = torch.tensor(rng.choice(live, min(256, len(live)), replace=False),
                        device=DEV)
    want = st.sig_trunc_plain(ring_windows(store.pool, rows).double(), N)
    err = float((store.pool.sig[rows].double() - want).abs().max())
    scale = float(want.abs().max())
    check(err <= E2E_TOL * scale, f"ring pool sampled rows: max |err| "
          f"{err:.3e}, max|S| {scale:.3e}")
    print(f"[sessions] ring pool (ring {R}, max_sessions {cap}, ttl {ttl}) "
          f"over {rounds} rounds in {wall:.3f} s: {len(store)} live, "
          f"evictions {ev}, dropped ticks {stats['dropped_ticks']}, "
          f"{drops} hopping-window drops; a stale handle raises; "
          f"{len(rows)} sampled rows vs float64 plain of their rings max "
          f"|err| {err:.2e} (max|S| {scale:.2e})", flush=True)
    return dict(wall_s=wall, evictions=ev, drops=drops, live=len(store),
                dropped_ticks=stats["dropped_ticks"], max_abs_err=err,
                max_sig=scale)


def push_times(ms: list, filled: int) -> dict:
    """Host-clock ms of each push, and the medians of the pushes that fill
    the window (no drop) and of those that drop a hop first."""
    return dict(push_ms=ms, fill_push_ms=float(np.median(ms[:filled])),
                drop_push_ms=float(np.median(ms[filled:])))


def push_line(case: dict) -> str:
    return (f"{case['fill_push_ms']:.3f} ms a push while the window fills, "
            f"{case['drop_push_ms']:.3f} ms once each push drops a hop "
            f"first (host clock, medians)")


def window_of(x: torch.Tensor, end: int, window: int) -> torch.Tensor:
    return x[:, max(0, end - window):end]


def score_plain(eng, S64: torch.Tensor) -> tuple:
    """Float64 plain (raw cross-Gram, scores) of window signatures against
    the engine's references."""
    R64, w64 = eng.ref_sigs.double(), eng.weights.double()
    K = sg.sig_gram_plain(S64, R64, w64)
    qn = torch.sqrt(torch.clamp_min(gram_diag(S64, w64), 1e-12))
    rn = torch.sqrt(torch.clamp_min(gram_diag(R64, w64), 1e-12))
    return K, K / (qn[:, None] * rn[None, :])


def check_scores(eng, scores, pred, near, S64, where: str) -> float:
    K, want = score_plain(eng, S64)
    scale = float(want.abs().max())
    err = float((scores.double() - want).abs().max())
    check(err <= E2E_TOL * scale, f"{where}: scores max |err| {err:.3e}")
    alpha = eng.alpha.double()
    perr = (pred.double() - K @ alpha).abs()
    check(bool((perr <= E2E_TOL * (K.abs() @ alpha.abs())).all()),
          f"{where}: predictions max |err| {float(perr.max()):.3e}")
    best = want.max(dim=1).values
    picked = want.gather(1, near[:, None].long())[:, 0]
    check(bool((best - picked <= E2E_TOL * scale).all()),
          f"{where}: nearest is not the plain argmax")
    return err


def phase_engines(rng) -> dict:
    """Phase 22c: SigStreamEngine and SigScoreEngine pushes on the card,
    and both on one shared store."""
    d, N, B, W, stride, pushes, hop = ENGINE_CELL
    D = sum(d**j for j in range(1, N + 1))
    x = torch.tensor(rng.normal(size=(B, pushes * hop, d)) / np.sqrt(W),
                     dtype=torch.float32, device=DEV)
    x64 = x.double()
    chk = torch.arange(8, device=DEV)        # rows held to float64
    eng = SigStreamEngine(d=d, depth=N, batch=B, window=W,
                          stream_stride=stride, device=DEV)
    push_ms, serr = [], 0.0
    for k in range(pushes):
        end = hop * (k + 1)
        chunk = x[:, end - hop:end]
        t0 = time.perf_counter()
        feats, _ = launched(lambda: eng.push(chunk),
                            f"SigStreamEngine push {k}", sig_trunc_stream=1)
        push_ms.append((time.perf_counter() - t0) * 1e3)
        start = max(0, end - W)
        want = st.sig_trunc_plain(x64[chk, start:end], N, stream=True,
                                  stream_stride=stride)
        want = want[:, (end - hop - start) // stride:]
        err = float((feats[chk].double() - want).abs().max())
        serr = max(serr, err)
        check(feats.shape == (B, hop // stride, D)
              and err <= E2E_TOL * float(want.abs().max()),
              f"SigStreamEngine push {k}: max |err| {err:.3e}")
    stream_case = dict(
        case="SigStreamEngine push", shape=[B, hop, d, N, stride],
        partition=trunc_partition(B, d, N),
        ms=cuda_ms(lambda: st.sig_trunc(chunk, N, stream=True,
                                        stream_stride=stride), 10),
        plain_ms=cuda_ms(lambda: st.sig_trunc_plain(
            chunk, N, stream=True, stream_stride=stride), 1),
        launches=pushes, **push_times(push_ms, W // hop),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(B, hop, d, N, 4, B * (hop // stride) * D, 4))))
    print(f"[sessions] SigStreamEngine (d={d}, depth {N}, batch {B}, window"
          f" {W}, stride {stride}): {pushes} pushes of {hop} steps, one "
          f"streamed sig_trunc launch each, {push_line(stream_case)}; "
          f"features vs "
          f"float64 plain max |err| {serr:.2e}; the streamed kernel alone "
          f"{stream_case['ms']:.4f} ms (bound "
          f"{stream_case['bound_ms']:.5f}, {stream_case['bound_by']})",
          flush=True)

    R, M = SCORE_CELL[:2]
    refs = brownian(rng, R, M, d)
    score, _ = launched(lambda: SigScoreEngine(
        d=d, depth=N, batch=B, references=refs, targets=levy_area(
            refs).float(), window=W, device=DEV), "SigScoreEngine set-up",
        sig_trunc=1, sig_gram=1)
    score_ms, cerr = [], 0.0
    for k in range(pushes):
        end = hop * (k + 1)
        chunk = x[:, end - hop:end]
        t0 = time.perf_counter()
        (s, p, i), _ = launched(
            lambda: (score.push(chunk), score.predict(), score.nearest()),
            f"SigScoreEngine push {k}", sig_trunc=1, sig_gram=1)
        score_ms.append((time.perf_counter() - t0) * 1e3)
        S64 = st.sig_trunc_plain(window_of(x64, end, W), N)
        cerr = max(cerr, check_scores(score, s, p, i, S64,
                                      f"SigScoreEngine push {k}"))
    push_case = dict(
        case="SigScoreEngine push", shape=[B, hop, d, N],
        partition=trunc_partition(B, d, N),
        ms=cuda_ms(lambda: st.sig_trunc(chunk, N), 10),
        plain_ms=cuda_ms(lambda: st.sig_trunc_plain(chunk, N), 1),
        launches=pushes, **push_times(score_ms, W // hop),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(B, hop, d, N, 4, B * D, 4))))
    gram = time_gram(score._terminal_sigs(), score.ref_sigs, score.weights)
    gram_case = dict(case="SigScoreEngine cross-Gram a push",
                     launches=pushes, **gram)
    print(f"[sessions] SigScoreEngine ({R} references of {M} steps, batch "
          f"{B}, window {W}): {pushes} pushes, one sig_trunc and one "
          f"sig_gram launch each (scores, predict, nearest), "
          f"{push_line(push_case)}; "
          f"scores vs float64 plain max |err| {cerr:.2e}; sig_trunc alone "
          f"{push_case['ms']:.4f} ms (bound {push_case['bound_ms']:.5f},"
          f" {push_case['bound_by']})", flush=True)
    print_gram("[sessions] cross-Gram a push", gram)

    # two engines on one shared store, against the private stream engine
    pool = SessionStore(d, N, ring_capacity=W, initial_sessions=2 * B,
                        device=DEV)
    shared = SigStreamEngine(d=d, depth=N, batch=B, window=W,
                             stream_stride=stride, store=pool)
    small = brownian(rng, 256, 256, d)
    tenant = SigScoreEngine(d=d, depth=N, batch=B, references=small,
                            targets=levy_area(small).float(), window=W,
                            store=pool)
    for k in range(pushes):
        end = hop * (k + 1)
        shared.push(x[:, end - hop:end])
        s = tenant.push(x[:, end - hop:end])
    check(len(pool) == 2 * B and pool.pool_size == 2 * B
          and torch.equal(shared.features, eng.features),
          "shared store: the stream engine differs from its private twin")
    S64 = st.sig_trunc_plain(window_of(x64, pushes * hop, W), N)
    sh_err = check_scores(tenant, s, tenant.predict(), tenant.nearest(), S64,
                          "shared store score engine")
    print(f"[sessions] one store of {pool.pool_size} rows shared by a "
          f"SigStreamEngine (features bitwise equal to its private twin's) "
          f"and a SigScoreEngine over 256 references (scores vs float64 "
          f"plain max |err| {sh_err:.2e})", flush=True)
    # where a push goes once the window is full: each traced, and the
    # hop's drop_block alone
    traces = dict(stream_push=device_busy(lambda: eng.push(chunk)),
                  score_push=device_busy(lambda: score.push(chunk)),
                  drop_block=device_busy(lambda: eng.store.drop_block(
                      eng.handles, hop)))
    for name, tr in traces.items():
        print(f"[sessions] traced {name} ({hop} steps): {tr['wall_ms']:.3f}"
              f" ms wall, device busy {tr['device_ms']:.3f} ms in "
              f"{tr['kernels']} kernels", flush=True)
    return dict(stream_case=stream_case, trunc_case=push_case,
                gram_case=gram_case, stream_max_abs_err=serr,
                score_max_abs_err=cerr, shared_max_abs_err=sh_err,
                traces=traces)


def phase_pool_checkpoint(store) -> dict:
    """Phase 22d: the 100,000-session pool saved and restored, every lane
    equal."""
    where = ROOT / "build" / "chip_smoke_sessions_ckpt"
    shutil.rmtree(where, ignore_errors=True)
    ck = Checkpointer(str(where), async_save=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store.checkpoint(ck, 1)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = SessionStore.restore(ck, device=DEV)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in where.rglob("*") if f.is_file())
    shutil.rmtree(where, ignore_errors=True)
    for lane in ("sig", "ring", "length", "end", "valid"):
        check(torch.equal(getattr(back.pool, lane), getattr(store.pool, lane)),
              f"restored pool: lane {lane} differs")
    check(back._ids == store._ids and back.now == store.now,
          "restored pool: host state differs")
    print(f"[sessions] checkpoint of the {store.pool_size}-row pool "
          f"({len(store)} sessions, {size / 1e6:.1f} MB): save "
          f"{save_s:.3f} s, restore {restore_s:.3f} s; every lane equal",
          flush=True)
    return dict(pool_size=store.pool_size, sessions=len(store),
                bytes=size, save_s=save_s, restore_s=restore_s)


def phase_prefetch(rng) -> dict:
    """Phase 22e: signature_service with the prefetch on and off, bitwise
    equal results; after one warm-up flush each, three flushes each in
    turns (on, off, off, on, on, off), one sig_trunc launch a
    micro-batch."""
    d, N, max_len = 6, 5, 1024
    reqs = serving_inputs(rng, 256, d, 16, max_len)
    svcs = {flag: DynamicBatcher.signature_service(
        d=d, depth=N, max_len=max_len, async_dispatch=flag, device=DEV)
        for flag in (True, False)}
    walls, first = {True: [], False: []}, None
    for k, flag in enumerate((True, False, True, False, False, True, True,
                              False)):
        svc = svcs[flag]
        tickets = [svc.submit(p) for p in reqs]
        batches = svc.stats()["batches"]
        reset_counts()
        t0 = time.perf_counter()
        res = svc.flush()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        n, stats = counts(), svc.stats()
        check(n["sig_trunc"] == stats["batches"] - batches > 0,
              f"prefetch={flag}: launches {n} for "
              f"{stats['batches'] - batches} micro-batches")
        values = torch.stack([res[t] for t in tickets])
        first = values if first is None else first
        check(torch.equal(values, first),
              f"prefetch={flag}: results differ from the first flush's")
        if k >= 2:
            walls[flag].append(wall)
    out = {}
    for flag, svc in svcs.items():
        stats = svc.stats()
        check(stats["in_flight_peak"] <= stats["max_in_flight"]
              and (stats["prefetched_rungs"] > 0) == flag,
              f"prefetch={flag}: stats {stats}")
        out["on" if flag else "off"] = dict(
            wall_ms=walls[flag], median_wall_ms=float(np.median(walls[flag])),
            health=svc.health()["status"],
            in_flight_peak=stats["in_flight_peak"],
            prefetched_rungs=stats["prefetched_rungs"],
            batches=stats["batches"])
    on, off = out["on"], out["off"]
    print(f"[sessions] signature_service, 256 requests a flush: prefetch on "
          f"{on['median_wall_ms']:.2f} ms (median of "
          f"{', '.join(f'{w:.2f}' for w in on['wall_ms'])}; in flight at "
          f"most {on['in_flight_peak']}, {on['prefetched_rungs']} rungs "
          f"staged ahead, health {on['health']}), off "
          f"{off['median_wall_ms']:.2f} ms (median of "
          f"{', '.join(f'{w:.2f}' for w in off['wall_ms'])}; health "
          f"{off['health']}); one sig_trunc launch a micro-batch; every "
          f"flush bitwise equal", flush=True)
    return out


def phase_sessions(rng) -> dict:
    """Phase 22: the session path on the card."""
    pool = phase_pool(rng)
    ring = phase_ring_pool(rng)
    engines = phase_engines(rng)
    ckpt = phase_pool_checkpoint(pool.pop("store"))
    prefetch = phase_prefetch(rng)
    return dict(pool=pool, ring=ring, engines=engines, checkpoint=ckpt,
                prefetch=prefetch)


# ---------------------------------------------------------------------------
# phase 23: ragged serving, the hybrid cell, the autotuner, observability
# ---------------------------------------------------------------------------

# benchmarks/ragged_throughput.py run(quick=False)
RAGGED = dict(seed=0, n_requests=384, max_len=1024, d=4, depth=4,
              n_rounds=4, max_batch=64, min_bucket=48)


def ragged_workload() -> list:
    """The bench's make_workload, its lengths from the port's
    geometric_lengths: the request paths split into flush rounds."""
    c = RAGGED
    lengths = geometric_lengths(c["seed"], c["n_requests"], c["max_len"],
                                min_steps=2)
    rng = np.random.default_rng((c["seed"], 1))
    reqs = []
    for L in lengths:
        steps = rng.standard_normal((int(L), c["d"])).astype(np.float32)
        steps /= np.sqrt(max(int(L), 1))
        reqs.append(np.concatenate([np.zeros((1, c["d"]), np.float32),
                                    np.cumsum(steps, axis=0)], axis=0))
    bounds = np.linspace(0, c["n_requests"], c["n_rounds"] + 1).astype(int)
    return [reqs[bounds[i]:bounds[i + 1]] for i in range(c["n_rounds"])]


def walk_batch(seed: int, step: int, B: int, M: int, d: int) -> tuple:
    """One RaggedPathStream(kind="walk") batch drawn in numpy alone: the
    reference's keys ((seed, step) for the walk, (7919, seed * 1_000_003
    + step) for the lengths) and frozen tails."""
    rng = np.random.default_rng((seed, step))
    p = min(1.0, 1.0 / max(0.25 * M, 1.0))
    lengths = np.clip(np.random.default_rng(
        (7919, seed * 1_000_003 + step)).geometric(p, size=B), 2, M)
    steps = rng.standard_normal((B, M, d)).astype(np.float32)
    steps /= np.sqrt(np.maximum(lengths, 1))[:, None, None]
    X = np.concatenate([np.zeros((B, 1, d), np.float32),
                        np.cumsum(steps, axis=1)], axis=1)
    idx = np.minimum(np.arange(M + 1)[None, :], lengths[:, None])
    return np.take_along_axis(X, idx[..., None], axis=1), lengths


def ragged_plans(rounds: list) -> tuple[dict, dict]:
    """The four serving plans over the rounds, each an epoch function
    returning the answers in request order and its launches."""
    c = RAGGED
    d, N, max_len, mb = c["d"], c["depth"], c["max_len"], c["max_batch"]
    svc = DynamicBatcher.signature_service(d, N, max_len=max_len,
                                           max_batch=mb,
                                           min_bucket=c["min_bucket"])
    ladder = bucket_ladder(max_len, min_len=c["min_bucket"])
    buckets = []

    def per_request():
        return [ops.signature(torch.from_numpy(p[1:] - p[:-1])[None].to(DEV),
                              N)[0] for rnd in rounds for p in rnd]

    def pad_to_max():
        out = []
        for rnd in rounds:
            for off in range(0, len(rnd), mb):
                part = rnd[off:off + mb]
                rp = pad_batch(RaggedPaths.from_list(part, pad_to=max_len),
                               batch_rung(len(part), mb))
                res = ops.signature(rp.values[:, 1:] - rp.values[:, :-1], N,
                                    lengths=rp.lengths)
                out.extend(res[i] for i in range(len(part)))
        return out

    def service():
        out = []
        for rnd in rounds:
            tickets = [svc.submit(p) for p in rnd]
            res = svc.flush()
            out.extend(res[t] for t in tickets)
        return out

    def bucketed():
        out = []
        for rnd in rounds:
            res = [None] * len(rnd)
            for idx, sub in bucket_paths(RaggedPaths.from_list(rnd), ladder):
                sig_ = ops.signature(sub.values[:, 1:] - sub.values[:, :-1],
                                     N, lengths=sub.lengths)
                buckets.append((len(idx), sub.max_len))
                for j, i in enumerate(idx):
                    res[i] = sig_[j]
            out.extend(res)
        return out

    return dict(per_request=per_request, pad_to_max=pad_to_max,
                signature_service=service, bucket_paths=bucketed), \
        dict(svc=svc, buckets=buckets, ladder=ladder)


def ragged_card_checks(rounds: list) -> None:
    """from_segments, point_mask, terminal_points and one RaggedPathStream
    batch on card tensors against numpy."""
    rnd = rounds[0]
    rp = RaggedPaths.from_list(rnd)
    seg = RaggedPaths.from_segments(np.concatenate(rnd), [len(p) for p in rnd])
    check(torch.equal(seg.values, rp.values)
          and torch.equal(seg.lengths, rp.lengths),
          "from_segments does not round-trip a round")
    lengths = np.asarray([len(p) - 1 for p in rnd])
    mask = np.arange(rp.max_len + 1)[None, :] <= lengths[:, None]
    check(rp.point_mask().device == rp.values.device
          and np.array_equal(rp.point_mask().cpu().numpy(), mask),
          "point_mask differs from numpy")
    check(np.array_equal(rp.terminal_points().cpu().numpy(),
                         np.stack([p[-1] for p in rnd])),
          "terminal_points differ from each path's last point")
    for step in (0, 3):
        s = RaggedPathStream(batch=64, max_steps=1024, d=4, seed=0)
        s.restore({"step": step, "seed": 0})
        b = next(s)
        X, L = walk_batch(0, step, 64, 1024, 4)
        check(b["paths"].device.type == torch.device(DEV).type
              and np.array_equal(b["paths"].cpu().numpy(), X)
              and np.array_equal(b["path_lengths"].cpu().numpy(), L),
              f"RaggedPathStream step {step} differs from the numpy draw")
    print("[ragged] from_segments, point_mask, terminal_points and two "
          "RaggedPathStream(64, 1024, 4) batches equal numpy", flush=True)


def phase_ragged(rng) -> dict:
    """Phase 23a: benchmarks/ragged_throughput.py at full size on the card,
    four plans cold and warm, and the ragged utilities on card tensors."""
    c = RAGGED
    rounds = ragged_workload()
    n = c["n_requests"]
    lens = [len(p) - 1 for rnd in rounds for p in rnd]
    print(f"[ragged] {n} requests in {c['n_rounds']} rounds, lengths max "
          f"{max(lens)}, median {np.median(lens):.0f}, d={c['d']}, "
          f"N={c['depth']}", flush=True)
    plans, extra = ragged_plans(rounds)
    results, out = {}, {}
    for name, epoch in plans.items():
        walls, launches = [], []
        for _ in range(2):
            extra["buckets"].clear()
            batches0 = extra["svc"].batches
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            res = epoch()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches.append(counts())
        n_l = launches[-1]
        check(sum(n_l.values()) == n_l["sig_trunc"],
              f"ragged {name}: launches {n_l}")
        if name == "bucket_paths":
            check(n_l["sig_trunc"] == len(extra["buckets"]),
                  f"bucket_paths: {n_l['sig_trunc']} sig_trunc launches for "
                  f"{len(extra['buckets'])} buckets")
        if name == "signature_service":
            check(n_l["sig_trunc"] == extra["svc"].batches - batches0,
                  f"signature_service: {n_l['sig_trunc']} launches")
        if name == "per_request":
            check(n_l["sig_trunc"] == n, f"per request: {n_l} launches")
        results[name] = torch.stack(res).double()
        out[name] = dict(cold_s=walls[0], warm_s=walls[1],
                         req_per_s_warm=n / walls[1],
                         req_per_s_cold=n / walls[0],
                         launches=n_l["sig_trunc"])
        print(f"[ragged] {name:17s} cold {walls[0] * 1e3:8.1f} ms, warm "
              f"{walls[1] * 1e3:8.1f} ms, {n / walls[1]:9.1f} requests/s "
              f"warm, {n_l['sig_trunc']} sig_trunc launches an epoch",
              flush=True)
    ref = results["per_request"]
    for name, got in results.items():
        err = float((got - ref).abs().max())
        out[name]["max_abs_err_vs_per_request"] = err
        check(bool(((got - ref).abs() <= TOL["atol"]
                    + TOL["rtol"] * ref.abs()).all()),
              f"ragged {name}: max |err| {err:.2e} against per request")
    flat = [p for rnd in rounds for p in rnd]
    for i in rng.choice(n, 16, replace=False):
        x = torch.tensor(flat[i][1:] - flat[i][:-1], dtype=torch.float64,
                         device=DEV)[None]
        want = st.sig_trunc_plain(x, c["depth"])[0]
        check(bool(((ref[i] - want).abs() <= TOL["atol"]
                    + TOL["rtol"] * want.abs()).all()),
              f"ragged request {i}: per-request answer off the plain one")
    ragged_card_checks(rounds)
    # sig_trunc alone on the largest bucket of the bucket_paths plan
    groups = bucket_paths(RaggedPaths.from_list(rounds[0]), extra["ladder"])
    idx, sub = max(groups, key=lambda g: len(g[0]) * g[1].max_len)
    incs = sub.increments()
    B, M, d, N = len(idx), sub.max_len, c["d"], c["depth"]
    D = sum(d**k for k in range(1, N + 1))
    reset_counts()
    st.sig_trunc(incs, N)
    launched = counts()["sig_trunc"]
    ms = cuda_ms(lambda: st.sig_trunc(incs, N), 10)
    plain_ms = cuda_ms(lambda: st.sig_trunc_plain(incs, N), 1)
    bms, by = bound(B, M, d, N, 4, B * D, 4)
    case = dict(trunc_case("a bucket_paths bucket (ragged serving)",
                           [B, M, d, N], dict(ms=ms, bound_ms=bms,
                                              bound_by=by)),
                launches=launched, plain_ms=plain_ms)
    print(f"[ragged] sig_trunc on the largest bucket (B={B}, M={M}): "
          f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bms:.5f} ms "
          f"({by})", flush=True)
    return dict(plans=out, bucket_case=case, svc=extra["svc"], rounds=rounds)


def value_and_grad(fn, x: torch.Tensor, w: torch.Tensor) -> tuple:
    """fn(x) and the gradient of Σ fn(x)·w."""
    x = x.detach().clone().requires_grad_()
    out = fn(x)
    (g,) = torch.autograd.grad((out * w.to(out.dtype)).sum(), x)
    return out.detach(), g


def values_within(got: torch.Tensor, want: torch.Tensor,
                  scale: float = 1e-4) -> bool:
    """|got − want| <= scale·max|want| (composed results)."""
    return float((got.double() - want).abs().max()) \
        <= scale * float(want.abs().max())


def phase_hybrid(rng) -> dict:
    """Phase 23b: backend="hybrid" at the six Table 3 cells on the §3.3
    set, against the cuda route (sig_words, then sig_sweep) and float64."""
    rows, case, traces = [], None, {}
    for B, M, d, N in TABLE3:
        path = brownian(rng, B, M, d)
        incs = tops.path_increments(path)
        words = all_words(d, N - 1) + [w for w in lyndon_words(d, N)
                                       if len(w) == N]
        plan = make_plan(words, d)
        wl = torch.tensor(rng.normal(size=(B, logsig_dim(d, N))), device=DEV)
        wp = torch.tensor(rng.normal(size=(B, len(words))), device=DEV)
        log64 = value_and_grad(lambda p: logsignature_projected(
            p, N, backend="torch"), path.double(), wl)
        proj64 = value_and_grad(lambda x: projected_signature_from_increments(
            x, plan, backend="torch", device=DEV), incs.double(), wp)
        got, row = {}, dict(B=B, M=M, d=d, N=N, words=len(words))
        for route in ("hybrid", "cuda"):
            runs = dict(
                logsig=(lambda p: logsignature_projected(p, N, backend=route),
                        path, wl, log64),
                projected=(lambda x: ops.projected(x, plan, backend=route),
                           incs, wp, proj64))
            for what, (fn, x, w, ref) in runs.items():
                reset_counts()
                val, g = value_and_grad(fn, x, w)
                torch.cuda.synchronize()
                n = counts()
                want_n = {k: 0 for k in n}
                if route == "cuda":
                    want_n.update(sig_words=1, sig_sweep=1)
                check(n == want_n, f"hybrid phase {B, M, d, N} {route} "
                      f"{what}: launches {n}")
                check(values_within(val, ref[0]),
                      f"{route} {what} {B, M, d, N}: value off float64")
                check(grad_within(g, ref[1]),
                      f"{route} {what} {B, M, d, N}: gradient off float64")
                got[route, what] = (val, g)
                row[f"{route}_{what}_launches"] = sum(n.values())
            row[f"{route}_ms"] = cuda_ms(
                lambda: ops.projected(incs, plan, backend=route), 5)
            row[f"{route}_grad_ms"] = cuda_ms(
                lambda: value_and_grad(lambda x: ops.projected(
                    x, plan, backend=route), incs, wp), 3)
        for what in ("logsig", "projected"):
            # each route is within 1e-4·max|float64|: the two within 2e-4
            check(values_within(got["hybrid", what][0],
                                got["cuda", what][0].double(), 2e-4),
                  f"hybrid against the cuda route {what} {B, M, d, N}")
        top = [w for w in words if len(w) == N]
        xg = incs.detach().requires_grad_()
        saved = saved_storage_bytes(
            lambda x: hybrid_low_plus_top(x, top, N), xg)
        want_b = incs.numel() * 4 + B * len(words) * 4
        check(saved == want_b, f"hybrid backward saves {saved} bytes, the "
              f"increments and the output are {want_b}")
        row["saved_bytes"] = saved
        ctp = ops._closure_tiled_plan(plan.words, d, 256)
        row["sig_words_ms"] = cuda_ms(lambda: sw.sig_words(incs, ctp), 10)
        row["bound_ms"], row["bound_by"] = bound(
            B, M, d, N, 4, B * plan.closure_size, 4, words_flops(plan))
        rows.append(row)
        print(f"[hybrid] B={B:2d} M={M:3d} d={d:2d} N={N} ({len(words)} "
              f"words): forward hybrid {row['hybrid_ms']:8.3f} ms, cuda "
              f"route {row['cuda_ms']:7.3f} ms (sig_words alone "
              f"{row['sig_words_ms']:.4f}); value+grad hybrid "
              f"{row['hybrid_grad_ms']:8.3f} ms, cuda "
              f"{row['cuda_grad_ms']:7.3f} ms; launches hybrid 0, cuda "
              f"{row['cuda_projected_launches']}; saved {saved} bytes",
              flush=True)
    big = max(rows, key=lambda r: r["bound_ms"])
    B, M, d, N = (big[k] for k in "BMdN")
    path = brownian(rng, B, M, d)
    incs = tops.path_increments(path)
    plan = make_plan(all_words(d, N - 1) + [
        w for w in lyndon_words(d, N) if len(w) == N], d)
    wp = torch.tensor(rng.normal(size=(B, len(plan.words))), device=DEV)
    for route in ("hybrid", "cuda"):
        traces[route] = device_busy(lambda: value_and_grad(
            lambda x: ops.projected(x, plan, backend=route), incs, wp))
        t = traces[route]
        print(f"[hybrid] traced value+grad at {B, M, d, N}, {route}: wall "
              f"{t['wall_ms']:.3f} ms, device busy {t['device_ms']:.3f} ms "
              f"in {t['kernels']} kernels", flush=True)
    case = dict(case="hybrid comparison: largest Table 3 §3.3 set",
                shape=[B, M, d, N], words=plan.closure_size,
                ms=big["sig_words_ms"], bound_ms=big["bound_ms"],
                bound_by=big["bound_by"], launches=big["cuda_projected_launches"]
                - 1, hybrid_ms=big["hybrid_ms"], route_ms=big["cuda_ms"],
                partition=words_partition(sw.plan_words_launch(
                    B, sw.tile_tables(ops._closure_tiled_plan(
                        plan.words, d, 256)), d)))
    return dict(rows=rows, traces=traces, words_case=case)


def tuned_result(kind: str, cell: dict, part: dict, rng) -> float:
    """The tuned partition's result against the plain version in float64:
    returns max |err| (checked by the kernel's own rule)."""
    if kind == "gram":
        Bx, By, D = cell["Bx"], cell["By"], cell["D"]
        Sx = torch.tensor(rng.normal(size=(Bx, D)) * 0.1, device=DEV)
        Sy = torch.tensor(rng.normal(size=(By, D)) * 0.1, device=DEV)
        w = torch.tensor(rng.uniform(0.2, 2.0, D), device=DEV)
        got = sg.sig_gram(Sx.float(), Sy.float(), w.float(), **part)
        want = sg.sig_gram_plain(Sx, Sy, w)
        check(gram_within(got, want, GRAM_TOL),
              f"tuned gram {cell} {part} off the plain version")
        return float((got.double() - want).abs().max())
    B, M, d, depth = cell["B"], cell["M"], cell["d"], cell["depth"]
    prec = cell["precision"]
    x = brownian(rng, B, M, d)
    x = tops.path_increments(x)
    x64 = x.to(torch.bfloat16).double() if prec == "bf16_fp32" \
        else x.double()
    if kind == "sig_trunc":
        got = st.sig_trunc(x, depth, precision=prec, **part)
        want = st.sig_trunc_plain(x64, depth)
    else:
        tplan = ops._closure_tiled_plan(tuple(all_words(d, depth)), d,
                                        part["max_rows"])
        got = sw.sig_words(x, tplan, precision=prec)
        want = sw.sig_words_plain(x64, tplan)
    check(within(got.double(), want, TOL["rtol"]),
          f"tuned {kind} {cell} {part} off the plain version")
    return float((got.double() - want).abs().max())


def default_partition(kind: str, cell: dict) -> dict:
    if kind == "sig_trunc":
        p = st.plan_launch(cell["B"], cell["d"], cell["depth"])
        return {"split": p.split, "examples": p.examples}
    if kind == "sig_words":
        return {"max_rows": 256}
    rows, words = sg._plan(cell["Bx"], cell["By"], cell["D"],
                           torch.cuda.get_device_properties(
                               0).multi_processor_count)
    return {"rows": rows, "slice_words": words}


def phase_autotune(rng) -> dict:
    """Phase 23c: PATHSIG_AUTOTUNE=sweep into a temporary cache over the
    --quick grid; each winner against the plain version, the hysteresis
    rule, a second lookup a hit, the cache file round trip."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="pathsig_autotune_")
    path = Path(tmp) / "tune.json"
    os.environ.update(PATHSIG_AUTOTUNE="sweep",
                      PATHSIG_AUTOTUNE_CACHE=str(path))
    autotune.clear()
    rows = []
    try:
        with obs.enabled_scope():
            lookups = obs.counter("pathsig_autotune_lookups_total", "",
                                  ("kind", "outcome"))
            for kind, cell in autotune.QUICK_GRID:
                t0 = time.perf_counter()
                rec = autotune.lookup(kind, **cell)
                sweep_s = time.perf_counter() - t0
                check(bool(rec), f"autotune {kind} {cell}: no record")
                part = autotune.partition(rec, kind)
                default = default_partition(kind, cell)
                timed = [autotune.partition(c, kind)
                         for c in rec["candidates"]]
                check(default in timed,
                      f"autotune {kind}: the default {default} was not timed")
                check(rec["ms"] <= rec["default_ms"],
                      f"autotune {kind}: {rec['ms']} > default "
                      f"{rec['default_ms']}")
                if part != default:
                    check(rec["ms"] < 0.9 * rec["default_ms"],
                          f"autotune {kind}: a non-default winner within "
                          "10% of the default")
                err = tuned_result(kind, cell, part, rng)
                hits = lookups.value(kind=kind, outcome="hit")
                sweeps = lookups.value(kind=kind, outcome="sweep")
                check(autotune.lookup(kind, **cell) == rec
                      and lookups.value(kind=kind, outcome="hit") == hits + 1
                      and lookups.value(kind=kind, outcome="sweep")
                      == sweeps, f"autotune {kind}: second lookup no hit")
                rows.append(dict(kind=kind, cell=cell, winner=part,
                                 default=default, ms=rec["ms"],
                                 default_ms=rec["default_ms"],
                                 candidates=rec["candidates"],
                                 max_abs_err=err, sweep_s=sweep_s))
                print(f"[autotune] {autotune.cell_key(kind, **cell)}: winner "
                      f"{part} {rec['ms']:.5f} ms, default {default} "
                      f"{rec['default_ms']:.5f} ms, sweep {sweep_s:.2f} s; "
                      f"max |err| vs plain {err:.2e}; candidates "
                      + ", ".join(f"{autotune.partition(c, kind)} "
                                  f"{c['ms']:.5f}" for c in
                                  rec["candidates"]), flush=True)
        cells = dict(autotune.load_cache())
        autotune.clear()
        head = json.loads(path.read_text())
        check(autotune.load_cache() == cells and head["device"]
              == torch.cuda.get_device_name(0) and head["version"] == 1,
              "the autotune cache does not round-trip")
        # the tuned 128 x 128 x 1,685 Gram beside cuBLAS, through ops.gram
        os.environ["PATHSIG_AUTOTUNE"] = "load"
        g = next(r for r in rows if r["kind"] == "gram"
                 and r["cell"]["Bx"] == 128)
        Sx = torch.tensor(rng.normal(size=(128, 1685)) * 0.1,
                          dtype=torch.float32, device=DEV)
        Sy = torch.tensor(rng.normal(size=(128, 1685)) * 0.1,
                          dtype=torch.float32, device=DEV)
        w = torch.tensor(rng.uniform(0.2, 2.0, 1685), dtype=torch.float32,
                         device=DEV)
        reset_counts()
        ops.gram(Sx, Sy, w)
        launched = counts()["sig_gram"]
        check(launched == 1, f"tuned ops.gram launched {launched}")
        t = time_gram(Sx, Sy, w)
        # device times behind a sleep, as the sweep takes them
        tuned_ms = autotune._median_time(
            lambda: sg.sig_gram(Sx, Sy, w, **g["winner"]), 20) * 1e3
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            lib_ms = autotune._median_time(
                lambda: torch.matmul(Sx * w, Sy.T), 20) * 1e3
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        closes = min(c["ms"] for c in g["candidates"]) <= lib_ms
        print(f"[autotune] 128 x 128 x 1,685 Gram, device ms behind a "
              f"sleep: tuned {g['winner']} {tuned_ms:.4f}, cuBLAS "
              f"(torch.matmul, TF32 off) {lib_ms:.4f}: "
              f"{'a' if closes else 'no'} candidate closes the gap; back "
              f"to back: planner's {t['ms']:.4f}, cuBLAS "
              f"{t['library_ms']:.4f}", flush=True)
        gram_case = dict(case="tuned projected-MMD Gram", shape=[128, 128,
                                                                 1685],
                         partition=g["winner"], ms=tuned_ms,
                         library_ms=lib_ms, planner_b2b_ms=t["ms"],
                         library_b2b_ms=t["library_ms"],
                         plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                         bound_by=t["bound_by"],
                         fp32_bound_ms=t["fp32_bound_ms"],
                         launches=launched, closes_gap=closes)
    finally:
        os.environ["PATHSIG_AUTOTUNE"] = "off"
        os.environ.pop("PATHSIG_AUTOTUNE_CACHE", None)
        autotune.clear()
    return dict(rows=rows, gram_case=gram_case)


def span_inside(inner: dict, outer: dict) -> bool:
    return (outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"]
            <= outer["ts"] + outer["dur"] + 1.0
            and inner["args"]["depth"] > outer["args"]["depth"])


def obs_step(hf, model, opt, xb, yb):
    """One §8 training step inside a ``train.step`` span."""
    with obs.span("train.step"):
        opt.zero_grad(set_to_none=True)
        loss = hf.mse(model, xb, yb)
        loss.backward()
        opt.step()
    return loss


def phase_observability(rng, ragged: dict) -> dict:
    """Phase 23d: metrics, a trace and the flight recorder on over a
    ragged serving round, a warm session flush at 10^4 sessions and one
    §8 step; the instruments against the host's own counts."""
    import tempfile
    obs.enable_flight()
    svc, rnd = ragged["svc"], ragged["rounds"][0]
    d, N, _, _, max_ticks, _ = POOL_CFG
    prounds = pool_rounds(10_000)
    store = SessionStore(d, N, initial_sessions=10_000, max_ticks=max_ticks,
                         device=DEV)
    for sids, cnt, ticks in prounds:                   # cold epoch
        store.ingest_many(sids, cnt, ticks, auto_create=True)
        store.flush()
    hf = example_module("hurst_fbm_torch")
    hd, hM, depth, batch, lr, _, n_white, _ = HURST
    X, H = hurst_dataset(seed=1, n_paths=n_white, n_steps=hM, d=hd)
    X, H = torch.as_tensor(X, device=DEV), torch.as_tensor(H, device=DEV)
    model = hf.make_model("truncated", hd, depth, hM, X, seed=1)
    opt = hf.adam(model, lr)
    xb, yb = X[:batch], H[:batch]

    def serve_round():
        for p in rnd:
            svc.submit(p)
        svc.flush()
        torch.cuda.synchronize()

    def session_flush(k):
        sids, cnt, ticks = prounds[k % len(prounds)]
        store.ingest_many(sids, cnt, ticks)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store.flush()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # obs off and on in turns, medians of three, and the launches of each
    walls = {("round", False): [], ("round", True): [],
             ("flush", False): [], ("flush", True): []}
    flush_launches = {}
    for k in range(6):
        on = bool(k % 2)
        if on:
            obs.enable()
            obs.start_trace(None)
        reset_counts()
        t0 = time.perf_counter()
        serve_round()
        walls["round", on].append(time.perf_counter() - t0)
        reset_counts()
        walls["flush", on].append(session_flush(k))
        flush_launches.setdefault(on, []).append(counts()["sig_trunc"])
        obs.disable()
        obs.stop_trace()
    check(flush_launches[False] == flush_launches[True],
          f"a flush launches {flush_launches[False]} with obs off and "
          f"{flush_launches[True]} with it on")
    med = {f"{w}_{'on' if on else 'off'}_ms": float(np.median(v)) * 1e3
           for (w, on), v in walls.items()}
    print(f"[obs] serving round {med['round_off_ms']:.3f} ms off, "
          f"{med['round_on_ms']:.3f} ms on; session flush "
          f"{med['flush_off_ms']:.3f} ms off, {med['flush_on_ms']:.3f} ms on "
          f"(medians of three, in turns; not gated); flush launches "
          f"{flush_launches[False]} off, {flush_launches[True]} on",
          flush=True)
    # the instrumented window
    tmp = Path(tempfile.mkdtemp(prefix="pathsig_obs_"))
    shapes0 = {m.__name__: set(m.launch_shapes) for m in (st, sw, sg, ss)}
    store_shapes0 = set(store._shape_keys)
    batches0, updates0 = svc.stats()["batches"], store.stats()["updates"]
    obs.reset()
    obs.FLIGHT.clear()
    obs.enable()
    obs.start_trace(str(tmp / "trace.json"))
    sids, cnt, ticks = prounds[1]
    try:
        serve_round()
        store.ingest_many(sids, cnt, ticks)
        store.flush()
        obs_step(hf, model, opt, xb, yb)
        torch.cuda.synchronize()
        snap = obs.snapshot()
    finally:
        trace_path = obs.stop_trace()
        obs.disable()
    doc = json.load(open(trace_path))
    evs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    named = {n: [e for e in evs if e["name"] == n] for n in (
        "serve.batcher.flush", "serve.batcher.rung", "kernels.signature",
        "serve.sessions.flush", "train.step")}
    check(len(named["serve.batcher.flush"]) == 1
          and len(named["serve.sessions.flush"]) == 1
          and len(named["train.step"]) == 1, "obs: missing spans")
    bf, sf = named["serve.batcher.flush"][0], named["serve.sessions.flush"][0]
    rungs = named["serve.batcher.rung"]
    check(rungs and all(span_inside(r, bf) for r in rungs),
          "serve.batcher.rung outside serve.batcher.flush")
    in_rungs = [k for k in named["kernels.signature"]
                if any(span_inside(k, r) for r in rungs)]
    check(len(in_rungs) == len(rungs),
          f"{len(in_rungs)} kernels.signature spans in {len(rungs)} rungs")
    in_flush = [e for e in evs if e["name"].startswith("kernels.")
                and span_inside(e, sf)]
    buckets = expected_buckets(cnt, store.max_ticks, store.max_rows)
    check(len(in_flush) == buckets,
          f"{len(in_flush)} kernels spans in the session flush, {buckets} "
          "buckets")

    def metric(name, **labels):
        rows = snap["metrics"].get(name, {}).get("values", [])
        return sum(r["value"] for r in rows
                   if all(r["labels"].get(k) == v for k, v in labels.items()))

    batches = svc.stats()["batches"] - batches0
    check(metric("pathsig_batcher_requests_total") == len(rnd),
          "pathsig_batcher_requests_total is not the round's requests")
    check(metric("pathsig_sessions_ticks_applied_total")
          == store.stats()["updates"] - updates0 == int(cnt.sum()),
          "pathsig_sessions_ticks_applied_total is not the ticks applied")
    calls = metric("pathsig_dispatch_calls_total", op="signature")
    check(calls == batches + buckets + 1,
          f"pathsig_dispatch_calls_total {calls}: {batches} micro-batches, "
          f"{buckets} flush buckets and one §8 step")
    sites = {}
    for mod, site in ((st, "sig_trunc"), (sw, "sig_words"),
                      (sg, "sig_gram_tiles"), (ss, "sig_sweep")):
        new = len(mod.launch_shapes - shapes0[mod.__name__])
        sites[site] = (metric(obs.TRACE_COUNTER_NAME, site=site), new)
    sites["session_flush"] = (metric(obs.TRACE_COUNTER_NAME,
                                     site="session_flush"),
                              len(store._shape_keys - store_shapes0))
    for site, (ticked, new) in sites.items():
        check(ticked == new, f"pathsig_jit_traces_total{{site={site}}} "
              f"{ticked}, {new} new launch shapes")
    # a failing ingest: one flight dump across nested boundaries
    os.environ["PATHSIG_FLIGHT_DIR"] = str(tmp / "flight")
    try:
        with obs.dump_on_error("phase23.caller"):
            store.ingest(sids[0], np.zeros((3, d + 1), np.float32))
        check(False, "ingest with the wrong d did not raise")
    except ValueError as e:
        check("increments must be" in str(e), f"ingest raised {e}")
    finally:
        os.environ.pop("PATHSIG_FLIGHT_DIR")
    dumps = list((tmp / "flight").glob("flight_*.json"))
    check(len(dumps) == 1, f"{len(dumps)} flight dumps")
    fd = json.load(open(dumps[0]))
    check(fd["otherData"]["exception"]["type"] == "ValueError"
          and fd["otherData"]["note"] == "sessions.ingest"
          and {"serve.sessions.flush", "train.step"}
          <= {e["name"] for e in fd["traceEvents"]},
          "the flight dump lacks the recent spans or the exception")
    # the §8 step traced on the device, and its wall untraced
    trace = device_busy(lambda: obs_step(hf, model, opt, xb, yb))
    idle = 1 - trace["device_ms"] / trace["wall_ms"]
    step_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        obs_step(hf, model, opt, xb, yb)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.median(step_ms))
    print(f"[obs] spans nest (batcher flush > {len(rungs)} rungs > "
          f"kernels.signature; session flush > {len(in_flush)} kernels "
          f"spans); counters equal the host's ({len(rnd)} requests, "
          f"{int(cnt.sum())} ticks, {calls:.0f} dispatch calls); new launch "
          f"shapes {sites}; one flight dump; §8 truncated step traced: wall "
          f"{trace['wall_ms']:.3f} ms, device busy {trace['device_ms']:.3f} "
          f"ms in {trace['kernels']} kernels, idle share {idle:.3f}; "
          f"untraced {step_ms:.3f} ms (median of 5), busy over that "
          f"{trace['device_ms'] / step_ms:.3f}", flush=True)
    return dict(times=med, flush_launches=flush_launches, sites={
        k: list(v) for k, v in sites.items()}, step_trace=trace,
        step_idle_share=idle, step_ms=step_ms,
        trace_events=len(doc["traceEvents"]))


def phase_slice8(rng) -> dict:
    """Phase 23: ragged serving, the hybrid cell, the autotuner and the
    observability layer."""
    ragged = phase_ragged(rng)
    hyb = phase_hybrid(rng)
    tune = phase_autotune(rng)
    obs_ = phase_observability(rng, ragged)
    for k in ("svc", "rounds"):
        ragged.pop(k)
    return dict(ragged=ragged, hybrid=hyb, autotune=tune,
                observability=obs_)


# ---------------------------------------------------------------------------
# phase 24: the dense-decoder LM substrate, the signature heads and the
# sig-MMD trainer at qwen3-4b's published widths
# ---------------------------------------------------------------------------

LM_ARCH = "qwen3-4b"
# serving: requests, prompt tokens, new greedy tokens each
LM_SERVE = (8, 64, 32)
# training: layers (the depth cut: 36 layers need 64 GB for fp32
# parameters, gradients and AdamW state before any activation), batch,
# tokens a sequence, sig-MMD steps, the step checkpointed, steps resumed
# from that checkpoint, ragged steps, LM steps
# (2 layers: cut from 4 for time when phase 28 took case (g))
LM_TRAIN = (2, 8, 512, 10, 5, 2, 3, 3)
LM_HEAD = dict(channels=8, depth=3, backend="auto")   # the SigHeadConfig
LM_OUT = 16            # the pooled heads' readout width
LM_STREAM_STRIDE = 8
LM_LANDMARKS = 16
LM_LEVEL3 = 100        # level-3 words of the projected head's word set


def lm_free() -> None:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_lm_serve(seed: int) -> dict:
    """Phase 24a: ServeEngine over qwen3-4b as published."""
    B, P, n_new = LM_SERVE
    cfg = get_config(LM_ARCH)
    lm_free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = LM.init_params(seed, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size)
          == (36, 2560, 32, 8, 128, 9728, 151936)
          and abs(n_params - cfg.param_count()) <= 1e-4 * n_params,
          f"qwen3-4b as published: {n_params} parameters against the "
          f"config's {cfg.param_count()}")
    check(all(p.is_cuda for p in params.parameters()),
          "init_params without a device did not place the model on the card")
    prompts = next(TokenStream(cfg.vocab_size, B, P, seed=0))["tokens"]
    reset_counts()
    logits = make_prefill_step(cfg)(params, {"tokens": prompts})
    cache = LM.init_cache(cfg, B, P + n_new, torch.float32)
    for j in range(P):
        step_logits, cache = LM.decode_step(params, cfg,
                                            prompts[:, j:j + 1], cache)
    scale = float(logits.abs().max())
    err = float((step_logits[:, -1].float() - logits).abs().max())
    check(bool(torch.isfinite(logits).all()) and err <= E2E_TOL * scale,
          f"qwen3-4b prefill against decode: max |err| {err:.3e}, "
          f"max|logit| {scale:.3e}")
    engine = ServeEngine(cfg, params, max_len=P + n_new)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.generate(prompts, n_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = counts()
    check(all(v == 0 for v in n.values()),
          f"LM serving launched signature kernels: {n}")
    check(tuple(out.shape) == (B, P + n_new)
          and torch.equal(out[:, :P], prompts)
          and int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size,
          f"generated tokens {tuple(out.shape)}")
    # the first greedy token is the prefill's argmax, up to near ties
    chosen = logits.gather(1, out[:, P:P + 1].long())[:, 0]
    check(bool((logits.max(-1).values - chosen <= E2E_TOL * scale).all()),
          "the first greedy token is not the prefill's argmax")
    tok = out[:, -1:]
    step_ms = cuda_ms(lambda: LM.decode_step(params, cfg, tok, cache), 5)
    tr = device_busy(lambda: LM.decode_step(params, cfg, tok, cache))
    steps = P - 1 + n_new
    # a decode step reads every weight once
    bound_ms = 4 * n_params / HBM_BYTES_PER_S * 1e3
    res = dict(params=n_params, layers=cfg.n_layers, init_s=init_s,
               decode_step_bound_ms=bound_ms,
               requests=B, prompt=P, new_tokens=n_new,
               prefill_decode_err=err, max_logit=scale, generate_s=wall,
               tokens_per_s=B * n_new / wall,
               ms_per_decode_step=wall * 1e3 / steps, decode_step_ms=step_ms,
               kernels_per_decode_step=tr["kernels"],
               decode_step_busy_ms=tr["device_ms"],
               decode_step_idle_share=1 - tr["device_ms"] / tr["wall_ms"],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               signature_launches=n)
    print(f"[lm] serve {cfg.name} as published ({cfg.n_layers} layers, "
          f"{n_params / 1e9:.3f}B parameters in fp32, drawn on the card in "
          f"{init_s:.2f} s): {B} prompts of {P} tokens + {n_new} greedy "
          f"tokens in {wall:.3f} s = {res['tokens_per_s']:.1f} new tokens/s "
          f"(the prefill through decode steps included), "
          f"{res['ms_per_decode_step']:.2f} ms a decode step over {steps} "
          f"steps, {step_ms:.2f} ms one step by CUDA events (bound "
          f"{bound_ms:.2f} ms: the weights read once, bytes); one step "
          f"traced: {tr['kernels']} kernels, {tr['device_ms']:.3f} ms busy "
          f"of {tr['wall_ms']:.3f} (idle {res['decode_step_idle_share']:.3f})"
          f"; prefill logits against the decode path max |err| {err:.2e} "
          f"(max|logit| {scale:.2f}); peak {res['peak_gb']:.2f} GB; "
          f"signature launches {n}", flush=True)
    del engine, params, cache, logits, step_logits, out
    lm_free()
    return res


def lm_data(cfg, kind: str, start: int, seed: int):
    """Training batches from stream step ``start``: tokens, with the fBM
    reference sample (``sig_mmd``), or ragged masks with RaggedPathStream
    paths and lengths (``ragged``), or alone (``lm``)."""
    _, B, S = LM_TRAIN[:3]
    c = cfg.sig_head.channels
    if kind == "ragged":
        paths = RaggedPathStream(B, S - 1, c, seed=seed)
        for tokens, p in zip(ragged_token_batches(cfg.vocab_size, B, S,
                                                  seed), paths):
            yield dict(tokens, **p)
        return
    ref = reference_paths(seed, B, S, c, "cuda") if kind == "sig_mmd" \
        else None
    for item in TokenStream(cfg.vocab_size, B, S, seed, step=start):
        yield item if ref is None else dict(item, paths=ref)


def lm_loop(cfg, params, opt, kind: str, steps: int, seed: int,
            start: int = 0, data_start: int = 0, **kw) -> tuple:
    """One train_loop run, every count at 0 just before it: (params,
    opt_state, history, launches, wall s)."""
    loop = TrainLoopConfig(steps=steps, log_every=1, run_dir="",
                           loss="lm" if kind == "lm" else "sig_mmd",
                           ckpt_every=kw.pop("ckpt_every", 0))
    reset_counts()
    t0 = time.perf_counter()
    params, state, hist = train_loop(cfg, params, opt,
                                     lm_data(cfg, kind, data_start, seed),
                                     loop, start_step=start, **kw)
    torch.cuda.synchronize()
    return params, state, hist, counts(), time.perf_counter() - t0


def lm_model(cfg, seed: int):
    model = LM.init_params(seed, cfg)
    model["sig_head"] = init_sig_head(seed + 1, cfg, LM_OUT)
    return model


def phase_lm_train(seed: int) -> dict:
    """Phase 24b: train_loop at qwen3-4b's width, depth cut."""
    L, B, S, n_mmd, ck_step, n_resume, n_rag, n_lm = LM_TRAIN
    cfg = lm_train_cfg()
    lm_free()
    torch.cuda.reset_peak_memory_stats()
    model = lm_model(cfg, seed)
    n_params = sum(p.numel() for p in model.parameters())
    opt = adamw(lr=linear_warmup_cosine(3e-4, 2, n_mmd))
    where = ROOT / "build" / "chip_smoke_lm_ckpt"
    shutil.rmtree(where, ignore_errors=True)
    ck = Checkpointer(str(where), keep=2)
    params, _, hist, n_mmd_launch, mmd_s = lm_loop(
        cfg, model, opt, "sig_mmd", n_mmd, seed, ckpt_every=ck_step,
        checkpointer=ck)
    del model
    per = dict(sig_trunc=2, sig_gram=3, sig_sweep=1)
    want = {k: per.get(k, 0) * n_mmd for k in n_mmd_launch}
    check(n_mmd_launch == want,
          f"sig-MMD steps: launches {n_mmd_launch}, expected {want}")
    losses = [h["loss"] for h in hist]
    check(all(np.isfinite(losses)), f"sig-MMD losses {losses}")
    # the ragged and LM loops run while the last checkpoint is written
    lm_free()
    params, _, hist_g, n_g, _ = lm_loop(cfg, params, opt, "ragged", n_rag,
                                        seed)
    want = {k: per.get(k, 0) * n_rag for k in n_g}
    check(n_g == want, f"ragged steps: launches {n_g}, expected {want}")
    params, _, hist_l, n_l, _ = lm_loop(cfg, params, opt, "lm", n_lm, seed)
    check(all(v == 0 for v in n_l.values()),
          f"LM steps launched signature kernels: {n_l}")
    for h in hist_g + hist_l:
        check(np.isfinite(h["loss"]), f"loss {h}")
    # the checkpoint of step ck_step holds ck_step + 1 updates: a loop
    # resumed there reads batch ck_step + 1 first and must give the
    # uninterrupted run's losses
    lm_free()
    ck.wait()
    t0 = time.perf_counter()
    _, _, hist_r, n_r, _ = lm_loop(
        cfg, lm_model(cfg, seed + 7), opt, "sig_mmd", ck_step + n_resume,
        seed, start=ck_step, data_start=ck_step + 1, checkpointer=ck)
    resume_s = time.perf_counter() - t0
    ck.wait()
    ckpt_bytes = sum(f.stat().st_size for f in where.rglob("*")
                     if f.is_file())
    shutil.rmtree(where, ignore_errors=True)
    resumed = [h["loss"] for h in hist_r]
    check([h["step"] for h in hist_r] == list(range(ck_step,
                                                    ck_step + n_resume))
          and all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(
              resumed, losses[ck_step + 1:])),
          f"resumed losses {resumed} against {losses[ck_step + 1:]}")
    lm_free()
    # one sig-MMD step traced
    step_fn = make_train_step(cfg, opt, loss="sig_mmd")
    state = opt.init(params)
    batch = next(lm_data(cfg, "sig_mmd", 0, seed))
    tr = device_busy(lambda: step_fn(params, state, batch))
    peak = torch.cuda.max_memory_allocated() / 1e9
    flops = lm_matmul_flops(cfg, B, S)

    def med(h):
        return float(np.median([x["sec"] for x in h[1:]])) * 1e3

    res = dict(layers=L, params=n_params, batch=[B, S], head=LM_HEAD,
               sig_mmd_step_ms=med(hist), ragged_step_ms=med(hist_g),
               lm_step_ms=med(hist_l), peak_gb=peak,
               launches_a_step={k: v / n_mmd for k, v in n_mmd_launch.items()
                                if v},
               launches=n_mmd_launch, ragged_launches=n_g,
               loss_curve=losses, resumed_losses=resumed,
               ragged_losses=[h["loss"] for h in hist_g],
               lm_losses=[h["loss"] for h in hist_l],
               grad_norms=[h["grad_norm"] for h in hist],
               matmul_tflop=flops / 1e12,
               matmul_bound_ms=flops / FP32_FLOPS_PER_S * 1e3,
               checkpoint_bytes=ckpt_bytes, sig_mmd_loop_s=mmd_s,
               resume_s=resume_s, trace=dict(
                   tr, idle_share=1 - tr["device_ms"] / tr["wall_ms"],
                   sig_share=tr["sig_ms"] / max(tr["device_ms"], 1e-9)))
    print(f"[lm] train {cfg.name} at full width, depth {L} "
          f"({n_params / 1e9:.3f}B parameters, fp32, AdamW; head "
          f"channels {cfg.sig_head.channels}, depth {cfg.sig_head.depth}), "
          f"batch {B} x {S}: sig-MMD step {res['sig_mmd_step_ms']:.1f} ms "
          f"(median of steps 1-{n_mmd - 1}), ragged "
          f"{res['ragged_step_ms']:.1f} ms, LM {res['lm_step_ms']:.1f} ms; "
          f"peak {peak:.2f} GB; launches a sig-MMD step "
          f"{res['launches_a_step']}; losses {np.round(losses, 6).tolist()}, "
          f"resumed at step {ck_step} {np.round(resumed, 6).tolist()}, "
          f"ragged {np.round(res['ragged_losses'], 6).tolist()}, LM "
          f"{np.round(res['lm_losses'], 4).tolist()}; checkpoints "
          f"{ckpt_bytes / 1e9:.2f} GB on disk at the end, the resumed loop "
          f"(restore, {n_resume} steps, save) {resume_s:.1f} s", flush=True)
    print(f"[lm] one sig-MMD step traced: {tr['wall_ms']:.1f} ms wall, "
          f"{tr['device_ms']:.1f} ms busy in {tr['kernels']} kernels (idle "
          f"{res['trace']['idle_share']:.3f}); the signature kernels "
          f"{tr['sig_ms']:.3f} ms, {res['trace']['sig_share']:.4f} of the "
          f"busy time; its matmuls {flops / 1e12:.2f} TFLOP, "
          f"{res['matmul_bound_ms']:.1f} ms at the FP32 peak", flush=True)
    return res, cfg, params


def lm_train_cfg():
    return with_sig_head(dataclasses.replace(get_config(LM_ARCH),
                                             n_layers=LM_TRAIN[0]),
                         **LM_HEAD)


def lm_head_routes(cfg, head: dict, ref: torch.Tensor, plan, seed: int):
    """(name, config, parameters, fn(p, x, cfg), launches) of each head
    route phase 24c holds on the card against the torch engine."""
    sc = cfg.sig_head
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    n_feat = len(plan.words) + sc.channels
    proj = dict(head, out=torch.randn(n_feat, LM_OUT, generator=g,
                                      device="cuda") / np.sqrt(n_feat))
    kcfg = dataclasses.replace(cfg, sig_head=dataclasses.replace(
        sc, kernel_landmarks=LM_LANDMARKS))
    kp = dict(head, **{k: v.detach() for k, v in init_sig_head(
        seed + 1, kcfg, LM_OUT).named_parameters() if k != "proj"})
    scfg = dataclasses.replace(cfg, sig_head=dataclasses.replace(
        sc, stream_stride=LM_STREAM_STRIDE))

    def mmd(p, x, c):
        return sig_mmd(_learned_path(p, x, c.sig_head), ref,
                       c.sig_head.depth, backend=c.sig_head.backend,
                       device=x.device)

    return [
        ("sig-MMD loss", cfg, head, mmd,
         dict(sig_trunc=2, sig_gram=3, sig_sweep=1)),
        ("sig_pool truncated", cfg, head,
         lambda p, x, c: sig_pool(p, x, c), dict(sig_trunc=1, sig_sweep=1)),
        ("sig_pool projected", cfg, proj,
         lambda p, x, c: sig_pool(p, x, c, plan=plan),
         dict(sig_words=1, sig_sweep=1)),
        ("sig_pool kernel landmarks", kcfg, kp,
         lambda p, x, c: sig_pool(p, x, c),
         dict(sig_trunc=2, sig_gram=1, sig_sweep=1)),
        ("sig_stream_features", scfg, head,
         lambda p, x, c: sig_stream_features(p, x, c),
         dict(sig_trunc_stream=1, sig_sweep=1)),
    ]


def with_backend(cfg, backend: str):
    return dataclasses.replace(cfg, sig_head=dataclasses.replace(
        cfg.sig_head, backend=backend))


def phase_lm_heads(rng, cfg, params, seed: int) -> dict:
    """Phase 24c: every head route on one full-width hidden state of the
    trained model, backend="cuda" against backend="torch" on the same
    tensors (the heads sign a float32 path, as the reference's do); then
    each kernel alone against its plain version in float64."""
    _, B, S = LM_TRAIN[:3]
    sc = cfg.sig_head
    d, N = sc.channels, sc.depth
    batch = next(lm_data(cfg, "sig_mmd", 0, seed))
    with torch.no_grad():
        hidden, _ = LM.transformer.backbone(params, cfg,
                                            tokens=batch["tokens"],
                                            remat="none")
    ref = batch["paths"]
    head = {k: v.detach() for k, v in params["sig_head"].named_parameters()}
    level3 = rng.choice(d ** 3, LM_LEVEL3, replace=False)
    words = ([(i,) for i in range(d)]
             + [(i, j) for i in range(d) for j in range(d)]
             + [(int(w) // d ** 2, int(w) // d % d, int(w) % d)
                for w in sorted(level3)])
    plan = make_plan(words, d)
    routes = []
    for name, c, p, fn, want in lm_head_routes(cfg, head, ref, plan, seed):

        def value_and_grad(backend, fn=fn, p=p, c=c):
            x = hidden.clone().requires_grad_()
            out = fn(p, x, with_backend(c, backend))
            w = torch.randn(out.shape, device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(seed))
            return out, torch.autograd.grad((out * w).sum(), x)[0]

        want_out, want_g = value_and_grad("torch")
        (out, g), n = launched(lambda: value_and_grad("cuda"),
                               f"LM head {name}", **want)
        out, g = out.detach(), g.detach()
        err = float((out - want_out.detach()).abs().max())
        scale = float(want_out.detach().abs().max())
        check(err <= E2E_TOL * scale,
              f"LM head {name}: max |err| {err:.3e}, max|torch| "
              f"{scale:.3e}")
        gerr = float((g - want_g).abs().max())
        check(grad_within(g, want_g.double()),
              f"LM head {name}: gradient max |err| {gerr:.3e}, max|g| "
              f"{float(want_g.abs().max()):.3e}")
        ms = cuda_ms(lambda: value_and_grad("cuda"), 3)
        torch_ms = cuda_ms(lambda: value_and_grad("torch"), 1)
        routes.append(dict(route=name, shape=list(out.shape), launches=n,
                           max_abs_err=err, max_torch=scale,
                           grad_max_abs_err=gerr,
                           max_g=float(want_g.abs().max()), ms=ms,
                           torch_ms=torch_ms))
        print(f"[lm] {name} on the ({B}, {S}, {hidden.shape[-1]}) hidden "
              f"state: value and gradient {ms:.3f} ms on the kernels, "
              f"{torch_ms:.1f} ms on the torch engine; launches "
              f"{ {k: v for k, v in n.items() if v} }; against the torch "
              f"engine max |err| {err:.2e} (max|out| {scale:.3e}), gradient "
              f"{gerr:.2e} (max|g| {float(want_g.abs().max()):.3e})",
              flush=True)
    kernels = lm_kernel_cases(cfg, head, hidden, ref, words, plan)
    return dict(routes=routes, words=len(words), **kernels)


def mmd_kernel_cases(cfg, head, hidden, ref, where: str) -> dict:
    """The sig-MMD leg's kernels alone at the path's shapes (sig_trunc,
    the Gram and the leg's sig_sweep): against their plain versions, timed
    beside them, with their bounds."""
    sc = cfg.sig_head
    d, N = sc.channels, sc.depth
    incs = tops.path_increments(_learned_path(head, hidden, sc)).detach()
    B, M, _ = incs.shape
    D = sum(d ** k for k in range(1, N + 1))
    S_x = st.sig_trunc(incs, N)
    torch.testing.assert_close(S_x.double(),
                               st.sig_trunc_plain(incs.double(), N), **TOL)
    trunc = dict(ms=cuda_ms(lambda: st.sig_trunc(incs, N), 10),
                 plain_ms=cuda_ms(lambda: st.sig_trunc_plain(incs, N), 1))
    trunc["bound_ms"], trunc["bound_by"] = bound(B, M, d, N, 4, B * D, 4)
    S_y = st.sig_trunc(tops.path_increments(ref), N)
    w = torch.as_tensor(word_weights(d, N), dtype=torch.float32,
                        device="cuda")
    G64 = sg.sig_gram_plain(S_x.double(), S_y.double(), w.double())
    gram_err = float((sg.sig_gram(S_x, S_y, w).double() - G64).abs().max())
    check(gram_err <= GRAM_TOL * float(G64.abs().max()),
          f"{where} Gram: max |err| {gram_err:.3e}")
    gram = time_gram(S_x, S_y, w)
    sweep = time_sweep(incs, sig.truncation_closure(d, N), S_x, 2 * S_x,
                       f"{where} leg")
    sweep.pop("want")
    return dict(incs=incs, trunc=trunc, gram_err=gram_err, gram=gram,
                sweep=sweep,
                trunc_case=dict(trunc_case(f"{where} leg", [B, M, d, N],
                                           trunc),
                                plain_ms=trunc["plain_ms"]),
                gram_case=dict(case=f"{where} Gram", **gram),
                sweep_case=dict(case=f"{where} leg backward",
                                shape=[B, M, d, N], **sweep))


def lm_kernel_cases(cfg, head, hidden, ref, words, plan) -> dict:
    """Each kernel of the path alone at the path's shapes: against its
    plain version, timed beside it, with its bound and partition."""
    sc = cfg.sig_head
    d, N, s = sc.channels, sc.depth, LM_STREAM_STRIDE
    mmd = mmd_kernel_cases(cfg, head, hidden, ref, "LM sig-MMD")
    incs, trunc, sweep = mmd["incs"], mmd["trunc"], mmd["sweep"]
    B, M, _ = incs.shape
    out_s = st.sig_trunc(incs, N, stream=True, stream_stride=s)
    torch.testing.assert_close(out_s.double(), st.sig_trunc_plain(
        incs.double(), N, stream=True, stream_stride=s), **TOL)
    b = bound(B, M, d, N, 4, out_s.numel(), 4)
    stream_case = dict(
        case="LM sig_stream_features", shape=[B, M, d, N, s],
        partition=trunc_partition(B, d, N),
        ms=cuda_ms(lambda: st.sig_trunc(incs, N, stream=True,
                                        stream_stride=s), 10),
        plain_ms=cuda_ms(lambda: st.sig_trunc_plain(
            incs, N, stream=True, stream_stride=s), 1),
        bound_ms=b[0], bound_by=b[1], launches=1)
    tp = make_tiled_plan(words, d)
    torch.testing.assert_close(sw.sig_words(incs, tp).double(),
                               sw.sig_words_plain(incs.double(), tp), **TOL)
    b = bound(B, M, d, N, 4, B * len(words), 4, words_flops(plan))
    words_case = dict(
        case="LM sig_pool projected", shape=[B, M, d, N], words=len(words),
        partition=words_partition(sw.plan_words_launch(
            B, sw.tile_tables(tp), d)),
        ms=cuda_ms(lambda: sw.sig_words(incs, tp), 10),
        plain_ms=cuda_ms(lambda: sw.sig_words_plain(incs, tp), 1),
        bound_ms=b[0], bound_by=b[1], launches=1)
    print(f"[lm] the path's kernels alone: sig_trunc {[B, M, d, N]} "
          f"{trunc['ms']:.4f} ms (plain {trunc['plain_ms']:.2f}, bound "
          f"{trunc['bound_ms']:.5f}, {trunc['bound_by']}); streamed stride "
          f"{s} {stream_case['ms']:.4f} ms (bound "
          f"{stream_case['bound_ms']:.5f}); sig_words {len(words)} words "
          f"{words_case['ms']:.4f} ms (plain {words_case['plain_ms']:.2f}, "
          f"bound {words_case['bound_ms']:.5f}); sig_sweep "
          f"{sweep['ms']:.4f} ms (plain {sweep['plain_ms']:.2f}, bound "
          f"{sweep['bound_ms']:.5f}, {sweep['bound_by']}); Gram max |err| "
          f"{mmd['gram_err']:.2e}", flush=True)
    print_gram("[lm] sig-MMD", mmd["gram"])
    return dict(trunc_case=dict(mmd["trunc_case"],
                                case="LM sig-MMD leg and sig_pool"),
                stream_case=stream_case,
                words_case=words_case, gram_case=mmd["gram_case"],
                sweep_case=mmd["sweep_case"])


def phase_lm(rng, seed: int) -> dict:
    """Phase 24: serve qwen3-4b as published, train it at full width with
    the depth cut, and hold every head route's kernels on the card."""
    serve = phase_lm_serve(seed)
    train, cfg, params = phase_lm_train(seed)
    heads = phase_lm_heads(rng, cfg, params, seed)
    del params
    lm_free()
    return dict(serve=serve, train=train, heads=heads)

# ---------------------------------------------------------------------------
# phase 25: the MoE/MLA, hybrid, RWKV6 and encoder-decoder families
# ---------------------------------------------------------------------------

# served as published (phi3.5-moe at full width, its depth cut to what
# leaves FAM_FREE_GB free): requests, prompt tokens, new greedy tokens.  A
# MoE prompt batch holds B·P <= 4E tokens, so its prefill is one dropless
# group, as its decode steps are.
FAM_SERVE = {"deepseek-v2-lite-16b": (4, 64, 16),
             "phi3.5-moe-42b-a6.6b": (2, 32, 16),
             "zamba2-7b": (4, 64, 16),
             "rwkv6-1.6b": (4, 64, 16),
             "whisper-large-v3": (4, 32, 16)}
FAM_FREE_GB = 10
# rwkv6's float32 prefill is 6.6e-4·max|logit| from its decode on the
# card (tools/rwkv_drift.py): the channel mix's GEMMs over the prompt's
# 256 rows round coarser than a decode step's 4, and 24 layers amplify
# the gap (tools/rwkv_gemm_variants.py; 2.4e-4 on the CPU).  float32
# prefill = decode is held at FAM_F32_TOL·max|logit|, 3x that gap, and
# at E2E_TOL with the weights and activations in float64 (the float32
# casts of the WKV state, decay and norms kept, as the reference has them)
FAM_F32_TOL = {"rwkv6-1.6b": 2e-3}
# zamba2's prefill equals its decode while its groups do not outnumber its
# shared blocks: 12 layers are 2 groups over the 2 blocks
FAM_ZAMBA_CHECK = 12
# deepseek-v2-lite at full width through the sig-MMD loss: layers (1 dense
# + 3 MoE), steps; batch and tokens as phase 24's (LM_TRAIN)
FAM_TRAIN = (4, 5)
# one LM-loss step of the other families at full width: layers, batch,
# tokens (two 128-token SSD chunks)
FAM_LM_STEP = (4, 4, 256)


def expected_params(cfg) -> int:
    """The model's parameter count: the config's ``param_count()``, to
    within its approximate norms, except for the encoder-decoder, whose
    count leaves out the third matrix of each gated GELU MLP (w_gate) and
    the decoder's position table."""
    n = cfg.param_count()
    if cfg.family == "encdec":
        n += ((cfg.n_layers + cfg.n_encoder_layers) * cfg.d_model * cfg.d_ff
              + cfg.decoder_max_len * cfg.d_model)
    return n


def decode_weights(cfg, params) -> int:
    """Parameters one decode step reads: all but the encoder's."""
    return sum(p.numel() for n, p in params.named_parameters()
               if not n.startswith(("enc_layers.", "ln_enc")))


def routed_weights(cfg, params, step) -> tuple[int, list]:
    """Parameters one decode step would read if each MoE layer read only
    the experts its tokens route to: the step's other weights and, for
    each MoE layer, its routed experts' w_gate, w_up and w_down.  ``step``
    runs the decode step once; the routes are read from its top-k.  Also
    returns the experts routed in each MoE layer."""
    picked, top_k = [], LM.layers.top_k

    def record(probs, k):
        vals, idx = top_k(probs, k)
        picked.append(int(idx.unique().numel()))
        return vals, idx

    LM.layers.top_k = record
    try:
        step()
    finally:
        LM.layers.top_k = top_k
    experts = sum(p.numel() for n, p in params.named_parameters()
                  if re.search(r"\.moe\.w_(gate|up|down)$", n))
    one = experts // (cfg.n_experts * len(picked))
    return decode_weights(cfg, params) - experts + one * sum(picked), picked


def family_model(arch: str, seed: int):
    """(config, model) of ``arch`` as published, drawn on the card; for
    phi3.5-moe the most layers that leave FAM_FREE_GB free."""
    cfg = get_config(arch)
    if 4 * cfg.param_count() > torch.cuda.mem_get_info()[0] - FAM_FREE_GB * 1e9:
        free = torch.cuda.mem_get_info()[0] - FAM_FREE_GB * 1e9

        def size(n):
            return 4 * dataclasses.replace(cfg, n_layers=n).param_count()

        n = max(n for n in range(1, cfg.n_layers + 1) if size(n) <= free)
        cfg = dataclasses.replace(cfg, n_layers=n)
    model = LM.init_params(seed, cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    check(abs(n_params - expected_params(cfg)) <= 1e-3 * n_params
          and all(p.is_cuda for p in model.parameters()),
          f"{arch}: {n_params} parameters on the card against "
          f"{expected_params(cfg)} expected")
    free = torch.cuda.mem_get_info()[0]
    check(free >= FAM_FREE_GB * 1e9 or cfg.n_layers == get_config(
        arch).n_layers, f"{arch}: {free / 1e9:.1f} GB free after the cut")
    return cfg, model


def prefill_decode_err(logits: torch.Tensor, step_logits: torch.Tensor):
    scale = float(logits.abs().max())
    return float((step_logits.float() - logits).abs().max()), scale


def family_prefill_check(cfg, params, prompts, tol: float | None,
                         dtype=torch.float32) -> dict:
    """The prompt's last logits by make_prefill_step and by P decode steps
    into a cache of ``dtype`` (the parameters'); equal within
    tol·max|logit| unless ``tol`` is None, finite always."""
    B, P = prompts.shape
    logits = make_prefill_step(cfg)(params, {"tokens": prompts})
    cache = LM.init_cache(cfg, B, P, dtype)
    for j in range(P):
        step_logits, cache = LM.decode_step(params, cfg, prompts[:, j:j + 1],
                                            cache)
    err, scale = prefill_decode_err(logits, step_logits[:, -1])
    check(bool(torch.isfinite(logits).all()
               and torch.isfinite(step_logits).all())
          and (tol is None or err <= tol * scale),
          f"{cfg.name} ({cfg.n_layers} layers) prefill against decode: max "
          f"|err| {err:.3e}, max|logit| {scale:.3e}")
    return dict(layers=cfg.n_layers, err=err, max_logit=scale, tol=tol,
                dtype=str(dtype))


def whisper_check(cfg, params, prompts, frames) -> tuple[dict, dict]:
    """encode -> prefill_cross -> P decode steps against decode_train's
    logits; returns the check and the prefilled cache."""
    B, P = prompts.shape
    enc = LM.encdec.encode(params, cfg, frames, remat="none")
    full = LM.encdec.decode_train(params, cfg, enc, prompts, remat="none")
    logits = (full[:, -1] @ params["embed"].T).float()
    cache = LM.encdec.prefill_cross(params, cfg, enc, LM.init_cache(
        cfg, B, frames.shape[1], torch.float32))
    for j in range(P):
        step_logits, cache = LM.decode_step(params, cfg, prompts[:, j:j + 1],
                                            cache)
    err, scale = prefill_decode_err(logits, step_logits[:, -1])
    check(bool(torch.isfinite(step_logits).all()) and err <= E2E_TOL * scale,
          f"{cfg.name} decode against decode_train: max |err| {err:.3e}, "
          f"max|logit| {scale:.3e}")
    return dict(layers=cfg.n_layers, frames=frames.shape[1], err=err,
                max_logit=scale, tol=E2E_TOL), cache


@torch.no_grad()
def family_serve(arch: str, seed: int) -> dict:
    """Phase 25a for one family: drawn on the card, its prefill checked
    against its decode, ServeEngine's greedy tokens, one decode step timed
    and traced."""
    B, P, n_new = FAM_SERVE[arch]
    lm_free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params = family_model(arch, seed)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    prompts = next(TokenStream(cfg.vocab_size, B, P, seed=0))["tokens"]
    reset_counts()
    if cfg.family == "encdec":
        g = torch.Generator(device="cuda").manual_seed(seed)
        frames = torch.randn(B, cfg.n_audio_frames, cfg.d_model,
                             generator=g, device="cuda")
        checked, cache = whisper_check(cfg, params, prompts, frames)
    elif cfg.family == "hybrid":
        # the full depth's decode is not its prefill (the reference's
        # groups past the shared blocks discard their cache writes):
        # finite there, equal at the 12-layer cut of the same weights
        tree = {k: params[k] for k in params.keys() if k != "layers"}
        cut = dataclasses.replace(cfg, n_layers=FAM_ZAMBA_CHECK)
        sub = LM.transformer.DecoderLM(dict(tree, layers=list(
            params["layers"])[:FAM_ZAMBA_CHECK]), cut)
        checked = dict(full=family_prefill_check(cfg, params, prompts, None),
                       cut=family_prefill_check(cut, sub, prompts, E2E_TOL))
        del sub
    else:
        checked = family_prefill_check(cfg, params, prompts,
                                       FAM_F32_TOL.get(arch, E2E_TOL))
    engine = ServeEngine(cfg, params, max_len=P + n_new)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.generate(prompts, n_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = counts()
    check(all(v == 0 for v in n.values()),
          f"{arch} serving launched signature kernels: {n}")
    check(tuple(out.shape) == (B, P + n_new)
          and torch.equal(out[:, :P], prompts)
          and int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size,
          f"{arch} generated tokens {tuple(out.shape)}")
    if cfg.family != "encdec":
        cache = LM.init_cache(cfg, B, P + n_new, torch.float32)
    tok = out[:, -1:]
    step_ms = cuda_ms(lambda: LM.decode_step(params, cfg, tok, cache), 5)
    tr = device_busy(lambda: LM.decode_step(params, cfg, tok, cache))
    steps = P - 1 + n_new
    read = decode_weights(cfg, params)
    bound_ms = 4 * read / HBM_BYTES_PER_S * 1e3
    routed = {}
    if cfg.moe:
        # the batched expert product reads every expert; the step's routes
        # reach only some of them
        r_read, picked = routed_weights(
            cfg, params, lambda: LM.decode_step(params, cfg, tok, cache))
        routed = dict(params_routed_a_step=r_read,
                      experts_routed_per_layer=picked,
                      decode_step_routed_bound_ms=4 * r_read
                      / HBM_BYTES_PER_S * 1e3)
    res = dict(arch=arch, layers=cfg.n_layers,
               published_layers=get_config(arch).n_layers, params=n_params,
               params_read_a_step=read, init_s=init_s, requests=B, prompt=P,
               new_tokens=n_new, check=checked, generate_s=wall,
               tokens_per_s=B * n_new / wall,
               ms_per_decode_step=wall * 1e3 / steps, decode_step_ms=step_ms,
               decode_step_bound_ms=bound_ms, **routed,
               kernels_per_decode_step=tr["kernels"],
               decode_step_busy_ms=tr["device_ms"],
               decode_step_idle_share=1 - tr["device_ms"] / tr["wall_ms"],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               signature_launches=n)
    del engine, cache, out
    if arch in FAM_F32_TOL:
        checked = res["check"] = dict(
            float32=checked, float64=family_prefill_check(
                cfg, params.double(), prompts, E2E_TOL, torch.float64))
    cut = "" if cfg.n_layers == res["published_layers"] else (
        f", depth cut from {res['published_layers']} to {cfg.n_layers} "
        f"layers to leave >= {FAM_FREE_GB} GB free")
    print(f"[families] serve {arch} at full width ({cfg.n_layers} layers"
          f"{cut}; {n_params / 1e9:.3f}B parameters in fp32, drawn on the "
          f"card in {init_s:.2f} s): {B} prompts of {P} tokens + {n_new} "
          f"greedy tokens in {wall:.3f} s = {res['tokens_per_s']:.1f} new "
          f"tokens/s, {res['ms_per_decode_step']:.2f} ms a decode step over "
          f"{steps} steps, {step_ms:.2f} ms one step by CUDA events (bound "
          f"{bound_ms:.2f} ms: {read / 1e9:.3f}B weights read once, bytes"
          + (f"; {routed['decode_step_routed_bound_ms']:.2f} ms from the "
             f"{routed['params_routed_a_step'] / 1e9:.3f}B weights of the "
             f"routed experts, {min(routed['experts_routed_per_layer'])}-"
             f"{max(routed['experts_routed_per_layer'])} of "
             f"{cfg.n_experts} a layer" if routed else "") + "); "
          f"one step traced: {tr['kernels']} kernels, {tr['device_ms']:.3f} "
          f"ms busy of {tr['wall_ms']:.3f} (idle "
          f"{res['decode_step_idle_share']:.3f}); check {checked}; peak "
          f"{res['peak_gb']:.2f} GB; signature launches {n}", flush=True)
    del params
    lm_free()
    return res


def family_sig_mmd(seed: int) -> dict:
    """Phase 25b: deepseek-v2-lite at full width, its depth cut, trained
    through the sig-MMD loss (SigHeadConfig's defaults) with AdamW; the
    signature kernels' launches counted; then the leg's kernels alone."""
    L, n_steps = FAM_TRAIN
    _, B, S = LM_TRAIN[:3]
    lm_free()
    torch.cuda.reset_peak_memory_stats()
    cfg = with_sig_head(dataclasses.replace(
        get_config("deepseek-v2-lite-16b"), n_layers=L))
    model = LM.init_params(seed, cfg)
    model["sig_head"] = init_sig_head(seed + 1, cfg, LM_OUT)
    n_params = sum(p.numel() for p in model.parameters())
    opt = adamw(lr=linear_warmup_cosine(3e-4, 2, n_steps))
    state = opt.init(model)
    step_fn = make_train_step(cfg, opt, loss="sig_mmd")
    data = lm_data(cfg, "sig_mmd", 0, seed)
    batches = [next(data) for _ in range(n_steps)]
    losses, secs = [], []
    reset_counts()
    for batch in batches:
        t0 = time.perf_counter()
        model, state, m = step_fn(model, state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    n = counts()
    per = dict(sig_trunc=2, sig_gram=3, sig_sweep=1)
    want = {k: per.get(k, 0) * n_steps for k in n}
    check(n == want, f"deepseek sig-MMD steps: launches {n}, expected {want}")
    check(all(np.isfinite(losses)), f"deepseek sig-MMD losses {losses}")
    tr = device_busy(lambda: step_fn(model, state, batches[0]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():
        hidden, _ = LM.transformer.backbone(model, cfg,
                                            tokens=batches[0]["tokens"],
                                            remat="none")
    head = {k: v.detach() for k, v in model["sig_head"].named_parameters()}
    cases = mmd_kernel_cases(cfg, head, hidden, batches[0]["paths"],
                             "deepseek sig-MMD")
    step_ms = float(np.median(secs[1:])) * 1e3
    res = dict(layers=L, params=n_params, batch=[B, S], steps=n_steps,
               losses=losses, step_ms=step_ms, peak_gb=peak, launches=n,
               launches_a_step=per,
               trace=dict(tr, idle_share=1 - tr["device_ms"] / tr["wall_ms"],
                          sig_share=tr["sig_ms"] / max(tr["device_ms"],
                                                       1e-9)),
               **{k: cases[k] for k in ("trunc_case", "gram_case",
                                        "sweep_case")})
    print(f"[families] train deepseek-v2-lite at full width, depth {L} (1 "
          f"dense + {L - 1} MoE; {n_params / 1e9:.3f}B parameters, fp32, "
          f"AdamW, sig-MMD with SigHeadConfig's defaults: channels "
          f"{cfg.sig_head.channels}, depth {cfg.sig_head.depth}), batch {B} x "
          f"{S}: {step_ms:.1f} ms a step (median of steps 1-{n_steps - 1}); "
          f"losses {np.round(losses, 6).tolist()}; launches {n}; peak "
          f"{peak:.2f} GB; one step traced: {tr['wall_ms']:.1f} ms wall, "
          f"{tr['device_ms']:.1f} ms busy in {tr['kernels']} kernels (idle "
          f"{res['trace']['idle_share']:.3f}), the signature kernels "
          f"{tr['sig_ms']:.3f} ms = {res['trace']['sig_share']:.4f} of the "
          f"busy time; the leg's kernels alone: sig_trunc "
          f"{cases['trunc']['ms']:.4f} ms, Gram {cases['gram']['ms']:.4f} "
          f"ms, sig_sweep {cases['sweep']['ms']:.4f} ms", flush=True)
    del model, state, batches, hidden
    lm_free()
    return res


def family_lm_step(arch: str, seed: int) -> dict:
    """Phase 25b: one LM-loss train step of ``arch`` at full width, its
    depth cut (the encoder's too), AdamW."""
    L, B, S = FAM_LM_STEP
    lm_free()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(arch), n_layers=L)
    if cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, n_encoder_layers=L)
    model = LM.init_params(seed, cfg)
    opt = adamw(lr=3e-4)
    state = opt.init(model)
    batch = next(TokenStream(cfg.vocab_size, B, S, seed))
    if cfg.family == "encdec":
        g = torch.Generator(device="cuda").manual_seed(seed)
        batch["frames"] = torch.randn(B, cfg.n_audio_frames, cfg.d_model,
                                      generator=g, device="cuda")
    step_fn = make_train_step(cfg, opt)
    reset_counts()
    t0 = time.perf_counter()
    model, state, m = step_fn(model, state, batch)
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step_fn(model, state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    n = counts()
    check(np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0
          and all(v == 0 for v in n.values()),
          f"{arch} LM step: loss {loss}, |g| {gnorm}, launches {n}")
    frames = (f" over {cfg.n_audio_frames:,} frames"
              if cfg.family == "encdec" else "")
    res = dict(arch=arch, layers=L, batch=[B, S],
               params=sum(p.numel() for p in model.parameters()), loss=loss,
               grad_norm=gnorm, first_step_s=first_s, step_ms=step_ms,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[families] one LM step of {arch} at full width, depth {L}, batch "
          f"{B} x {S}{frames}"
          f": loss {loss:.4f}, |g| {gnorm:.3f}, {step_ms:.1f} ms (the first "
          f"{first_s:.1f} s), peak {res['peak_gb']:.2f} GB", flush=True)
    del model, state, batch
    lm_free()
    return res


@torch.no_grad()
def family_scans(seed: int) -> dict:
    """The plain SSD scan and WKV recurrence forward at the LM step's
    shapes (zamba2-7b's and rwkv6-1.6b's widths): ms by CUDA events, the
    kernels one call launches, and the bytes bound (inputs read once,
    output written once)."""
    _, B, S = FAM_LM_STEP
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device="cuda")

    z = get_config("zamba2-7b")
    _, nh = LM.ssm.mamba_dims(z)
    hd, ds = z.mamba_head_dim, z.ssm_state
    dt = torch.nn.functional.softplus(randn(B, S, nh))
    ssd_args = (randn(B, S, nh, hd), dt, -dt, randn(B, S, ds, scale=0.3),
                randn(B, S, ds, scale=0.3))
    r = get_config("rwkv6-1.6b")
    nh_r, hk = r.d_model // r.rwkv_head_dim, r.rwkv_head_dim
    wkv_args = (randn(B, S, nh_r, hk, scale=0.3),
                randn(B, S, nh_r, hk, scale=0.3),
                randn(B, S, nh_r, hk, scale=0.3),
                torch.exp(-torch.exp(-4.0 + randn(B, S, nh_r, hk, scale=0.3))),
                randn(nh_r, hk, scale=0.1),
                torch.zeros(B, nh_r, hk, hk, device="cuda"))
    out = {}
    for name, fn, args in (
            ("_ssd_chunked", lambda: LM.ssm._ssd_chunked(*ssd_args, 128),
             ssd_args),
            ("_wkv_scan", lambda: LM.ssm._wkv_scan(*wkv_args), wkv_args)):
        y = fn()
        ys = y if isinstance(y, tuple) else (y,)
        check(all(bool(torch.isfinite(t).all()) for t in ys),
              f"{name}: non-finite output")
        moved = 4 * (sum(a.numel() for a in args)
                     + sum(t.numel() for t in ys))
        tr = device_busy(fn)
        out[name] = dict(ms=cuda_ms(fn, 5), kernels=tr["kernels"],
                         busy_ms=tr["device_ms"], wall_ms=tr["wall_ms"],
                         bound_ms=moved / HBM_BYTES_PER_S * 1e3,
                         bound_by="bytes",
                         shape=[list(a.shape) for a in args])
        print(f"[families] {name} forward at {out[name]['shape'][0]}: "
              f"{out[name]['ms']:.3f} ms by CUDA events, {tr['kernels']} "
              f"kernels a call, {tr['device_ms']:.3f} ms busy of "
              f"{tr['wall_ms']:.3f} traced; bound {out[name]['bound_ms']:.4f}"
              f" ms (bytes)", flush=True)
    return out


def phase_families(seed: int) -> dict:
    """Phase 25: serve each family at its published size, train
    deepseek-v2-lite through the sig-MMD loss, one LM step each of the
    others, and the plain scans' times."""
    t0 = time.perf_counter()
    serve = [family_serve(arch, seed) for arch in FAM_SERVE]
    train = family_sig_mmd(seed)
    steps = [family_lm_step(a, seed) for a in ("zamba2-7b", "rwkv6-1.6b",
                                                 "whisper-large-v3")]
    scans = family_scans(seed)
    return dict(serve=serve, train=train, lm_steps=steps, scans=scans,
                seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phase 26: the data-parallel slice (repro_torch.distributed) on the card.
# gloo worlds of P ranks share the one H100 (NCCL refuses two ranks on one
# device); a world of one over NCCL holds the size-1 context bit for bit.
# ---------------------------------------------------------------------------

DIST_WORLDS = (2, 4)
DIST_SIG = (64, 500, 4, 5)        # Table 1's largest train cell
DIST_RAGGED_B = 63                # a batch P does not divide
# the reference Gram (scoring) and the sig-MMD Gram of phase 24's head
DIST_GRAMS = (("reference Gram", 2048, 2048, 9330),
              ("sig-MMD Gram", 8, 8, 584))
# the trainer: layers (qwen3-4b at full width, depth cut so that two
# ranks' fp32 weights, gradients and AdamW state share one card), steps;
# batch and tokens are phase 24's (LM_TRAIN: 8 x 512)
# qwen3-4b depth, steps (cut from 3 steps when phase 28 took case (g))
DIST_TRAIN = (2, 2)
DIST_POOL_N = 10_000              # phase 22's smallest pool
DIST_COLLECTIVE_S = 120           # a hung collective fails the phase
DIST_WORLD_S = 420                # a hung world fails the phase


def dist_ms(fn, group, reps: int = 3) -> float:
    """Median wall ms of ``fn`` on this rank, every rank starting each
    repetition together (a barrier) and the card synchronised."""
    ts = []
    for _ in range(reps):
        torch.distributed.barrier(group=group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def dist_alone(fn, rank: int, group, warm: bool = True):
    """``fn()`` on rank 0 while the other ranks wait: the single-rank
    result and its time, after one untimed call with ``warm`` (None
    elsewhere)."""
    out = None
    if rank == 0:
        if warm:
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        out = (out, (time.perf_counter() - t0) * 1e3)
    torch.distributed.barrier(group=group)
    return out


def dist_vg(fn, x: torch.Tensor, cot: torch.Tensor, mesh):
    """Value and gradient of ⟨fn(x), cot⟩ under the installed context: the
    gathered rows and the input's gradient summed over the ranks."""
    from repro_torch.distributed import batch as DB
    from repro_torch.distributed import collectives as C
    group = mesh.get_group()
    a = x.detach().clone().requires_grad_(True)
    out = fn(a)
    C.reduce_sum((DB.to_local(out) * DB.local_rows(cot, mesh, pad=False)
                  ).sum(), group).backward()
    return DB.gather_rows(out), C.all_reduce_(a.grad.clone(), group)


def single_vg(fn, x: torch.Tensor, cot: torch.Tensor):
    a = x.detach().clone().requires_grad_(True)
    out = fn(a)
    (out * cot).sum().backward()
    return out.detach(), a.grad


def dist_values_within(got, want) -> bool:
    return bool(((got - want).abs() <= TOL["atol"]
                 + TOL["rtol"] * want.abs()).all())


def dist_case(rank: int, mesh, name: str, fn, x, cot, shape) -> dict:
    """One sharded value-plus-gradient case against rank 0's single-rank
    result: launches per rank, ms beside the single-rank ms."""
    from repro_torch.distributed import sharding_ctx
    group = mesh.get_group()
    alone = dist_alone(lambda: single_vg(fn, x, cot), rank, group)
    reset_counts()
    with sharding_ctx(mesh):
        got, g = dist_vg(fn, x, cot, mesh)
    torch.cuda.synchronize()
    launches = {k: v for k, v in counts().items() if v}
    with sharding_ctx(mesh):
        ms = dist_ms(lambda: dist_vg(fn, x, cot, mesh), group)
    res = dict(case=name, shape=list(shape), P=mesh.size(), ms=ms,
               launches_per_rank=launches)
    if rank == 0:
        (want, gwant), single_ms = alone
        check(dist_values_within(got, want),
              f"{name} P={mesh.size()}: values differ from one rank, max "
              f"|err| {float((got - want).abs().max()):.3e}")
        check(grad_within(g, gwant.double()),
              f"{name} P={mesh.size()}: gradients differ from one rank, "
              f"max |err| {float((g - gwant).abs().max()):.3e}")
        res.update(single_ms=alone[1],
                   max_abs_err=float((got - want).abs().max()),
                   grad_max_abs_err=float((g - gwant).abs().max()))
    return res


def dist_signature(rank: int, mesh, seed: int) -> list:
    """(a) sharded ops.signature, value plus gradient, inverse and
    checkpoint at (64, 500, 4, 5), and a ragged B = 63 batch."""
    B, M, d, N = DIST_SIG
    rng = np.random.default_rng(seed + 2601)
    x = torch.tensor(rng.normal(size=(B, M, d)) / np.sqrt(M),
                     dtype=torch.float32, device="cuda")
    D = sum(d**n for n in range(1, N + 1))
    cot = torch.tensor(rng.normal(size=(B, D)), dtype=torch.float32,
                       device="cuda")
    lens = torch.tensor(rng.integers(M // 2, M + 1, size=DIST_RAGGED_B),
                        dtype=torch.int32, device="cuda")
    cases = []
    for name, kw, b in (
            ("inverse", {}, B),
            ("checkpoint", dict(backward="checkpoint"), B),
            ("ragged B=63", dict(lengths=lens), DIST_RAGGED_B)):
        cases.append(dist_case(
            rank, mesh, f"sharded signature {name}",
            lambda a, kw=kw: ops.signature(a, N, **kw), x[:b], cot[:b],
            (b, M, d, N)))
    for c in cases:
        want = dict(sig_trunc=1, sig_sweep=1)
        check(c["launches_per_rank"] == want,
              f"{c['case']}: launches a rank {c['launches_per_rank']}, "
              f"expected {want}")
    return cases


def dist_projected(rank: int, mesh, seed: int) -> dict:
    """(b) sharded ops.projected on §8's set: B = 128, 500 lead-lag
    increments over 10 letters, 1,685 words."""
    B, M, d, N, _ = PROJ_CELL
    rng = np.random.default_rng(seed + 2602)
    incs = tops.path_increments(lead_lag(brownian(rng, B, M, d)))
    words = generated_words(sparse_leadlag_generators(d), N)
    plan = make_plan(words, 2 * d)
    cot = torch.tensor(rng.normal(size=(B, len(words))),
                       dtype=torch.float32, device="cuda")
    case = dist_case(rank, mesh, "sharded projected §8",
                     lambda a: ops.projected(a, plan), incs, cot,
                     (B, incs.shape[1], 2 * d, N))
    case["words"] = len(words)
    want = dict(sig_words=1, sig_sweep=1)
    check(case["launches_per_rank"] == want,
          f"sharded projected: launches a rank {case['launches_per_rank']}, "
          f"expected {want}")
    return case


def dist_gram(rank: int, mesh, seed: int) -> list:
    """(c) the Gram ring: value and the three gradients against one rank,
    the communication record and the analytic counters."""
    from repro_torch.distributed import batch as DB
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import collective_stats, sharding_ctx
    from repro_torch.distributed.hlo import ring_overlap
    group, P = mesh.get_group(), mesh.size()
    rng = np.random.default_rng(seed + 2603)
    cases = []
    for name, Bx, By, D in DIST_GRAMS:
        Sx, Sy = (torch.tensor(rng.normal(size=(b, D)) * 0.1,
                               dtype=torch.float32, device="cuda")
                  for b in (Bx, By))
        w = torch.tensor(rng.uniform(0.2, 2.0, D), dtype=torch.float32,
                         device="cuda")
        cot = torch.tensor(rng.normal(size=(Bx, By)), dtype=torch.float32,
                           device="cuda")

        def single():
            ts = [t.clone().requires_grad_(True) for t in (Sx, Sy, w)]
            G = ops.gram(*ts)
            (G * cot).sum().backward()
            return G.detach(), [t.grad for t in ts]

        alone = dist_alone(single, rank, group)
        ts = [t.clone().requires_grad_(True) for t in (Sx, Sy, w)]
        C.LOG.reset()
        obs.enable()
        obs.reset()
        reset_counts()
        with sharding_ctx(mesh):
            G = ops.gram(*ts)
            torch.cuda.synchronize()
            fwd_launches = counts()["sig_gram"]
            stats = collective_stats(tag="gram_ring")
            ov = ring_overlap()
            C.reduce_sum((DB.to_local(G) * DB.local_rows(cot, mesh, pad=False)
                          ).sum(), group).backward()
        wire = obs.counter("pathsig_ring_wire_bytes_total", "",
                           ("ctx",)).value(ctx="eager")
        steps = obs.counter("pathsig_ring_ppermute_total", "",
                            ("ctx",)).value(ctx="eager")
        obs.disable()
        bwd_gram = counts()["sig_gram"] - fwd_launches
        grads = [C.all_reduce_(t.grad.clone(), group) for t in ts]
        full = DB.gather_rows(G)
        analytic = (P - 1) * (-(-By // P)) * D * 4
        n, result, wire_bytes = stats.by_kind["collective-permute"]
        check(fwd_launches == P and bwd_gram == 0,
              f"{name} P={P}: sig_gram launched {fwd_launches} times a "
              f"forward and {bwd_gram} a backward, expected {P} and 0")
        check(n == P - 1 and wire_bytes == analytic == wire
              and steps == P - 1,
              f"{name} P={P}: {n} permutes of {wire_bytes} bytes, counters "
              f"{steps} steps {wire} bytes, analytic {P - 1} and {analytic}")
        check(ov.overlapped and ov.n_permutes == P - 1 and ov.n_dots == P,
              f"{name} P={P}: ring overlap {ov.summary()}")

        def ring():
            with sharding_ctx(mesh):
                ops.gram(Sx, Sy, w)

        ms = dist_ms(ring, group)
        # one rank's forward alone, for the time beside the ring's
        fwd_alone = dist_alone(lambda: ops.gram(Sx, Sy, w), rank, group)
        res = dict(case=f"ring {name}", shape=[Bx, By, D], P=P, ms=ms,
                   launches_per_rank=dict(sig_gram=fwd_launches),
                   permutes=n, wire_bytes=wire_bytes,
                   overlap=ov.summary())
        if rank == 0:
            (G1, g1), single_ms = alone
            err = float((full - G1).abs().max())
            check(err <= GRAM_TOL * float(G1.abs().max()),
                  f"{name} P={P}: ring max |err| {err:.3e}")
            for k, (a, b) in enumerate(zip(grads, g1)):
                check(grad_within(a, b.double()),
                      f"{name} P={P}: gradient {k} max |err| "
                      f"{float((a - b).abs().max()):.3e}")
            res.update(single_ms=fwd_alone[1],
                       single_value_and_grad_ms=single_ms, max_abs_err=err)
        cases.append(res)
    return cases


def dist_train(rank: int, mesh, seed: int) -> dict:
    """(d) the data-parallel sig-MMD train_loop against one rank: losses
    within 1e-4·max(1, |loss|), the first step's gradients by the gate."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding_ctx
    from repro_torch.optim.optimizers import named
    from repro_torch.train import make_sig_mmd_loss, place_batch
    group, P = mesh.get_group(), mesh.size()
    L, steps = DIST_TRAIN
    cfg = with_sig_head(dataclasses.replace(get_config(LM_ARCH),
                                            n_layers=L), **LM_HEAD)
    model = lm_model(cfg, seed)
    loop = TrainLoopConfig(steps=steps, log_every=1, run_dir="",
                           loss="sig_mmd")
    loss_fn = make_sig_mmd_loss(cfg)
    batch = next(lm_data(cfg, "sig_mmd", 0, seed))

    def first_grads():
        # placed under the context (data-parallel), as it is without one
        loss, _ = loss_fn(model, place_batch(batch), "dots")
        return torch.autograd.grad(loss, list(named(model).values()),
                                   allow_unused=True)

    def single():
        g = first_grads()
        _, _, hist = train_loop(cfg, model, adamw(lr=3e-4),
                                lm_data(cfg, "sig_mmd", 0, seed), loop)
        return g, hist

    alone = dist_alone(single, rank, group, warm=False)
    lm_free()
    with sharding_ctx(mesh):
        g = [None if t is None else C.all_reduce_(t, group)
             for t in first_grads()]
        reset_counts()
        t0 = time.perf_counter()
        _, _, hist = train_loop(cfg, model, adamw(lr=3e-4),
                                lm_data(cfg, "sig_mmd", 0, seed), loop)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
    launches = counts()
    want = {k: dict(sig_trunc=2, sig_gram=3 * P, sig_sweep=1).get(k, 0)
            * steps for k in launches}
    check(launches == want, f"data-parallel sig-MMD steps: launches a rank "
          f"{launches}, expected {want}")
    losses = [h["loss"] for h in hist]
    res = dict(case="data-parallel sig-MMD train_loop", layers=L, P=P,
               batch=[LM_TRAIN[1], LM_TRAIN[2]], losses=losses,
               shape=[LM_TRAIN[1], LM_TRAIN[2], LM_HEAD["channels"],
                      LM_HEAD["depth"]],
               step_ms=float(np.median([h["sec"] for h in hist[1:]])) * 1e3,
               loop_s=loop_s,
               launches_per_rank={k: v for k, v in launches.items() if v})
    if rank == 0:
        (g1, hist1), _ = alone
        ref = [h["loss"] for h in hist1]
        check(all(abs(a - b) <= 1e-4 * max(1.0, abs(b))
                  for a, b in zip(losses, ref)),
              f"data-parallel losses {losses} against one rank's {ref}")
        for (name, _), a, b in zip(named(model).items(), g, g1):
            if b is None:      # a parameter the loss does not read
                check(a is None, f"first-step gradient {name}: one rank "
                      f"has none, the mesh has one")
                continue
            check(grad_within(a, b.double()),
                  f"first-step gradient {name}: max |err| "
                  f"{float((a - b).abs().max()):.3e}")
        res.update(single_losses=ref, single_step_ms=float(np.median(
            [h["sec"] for h in hist1[1:]])) * 1e3)
    del model, g, alone
    lm_free()
    return res


def dist_batcher(rank: int, mesh, seed: int) -> dict:
    """(e) DynamicBatcher.signature_service(d=6, depth=5, max_len=1024)
    placed over the mesh: phase 4's 256 requests."""
    group, P = mesh.get_group(), mesh.size()
    reqs = serving_inputs(np.random.default_rng(seed + 2605), 256, 6, 16,
                          1024)

    def serve(m):
        svc = DynamicBatcher.signature_service(d=6, depth=5, max_len=1024,
                                               mesh=m)
        tickets = [svc.submit(p) for p in reqs]
        t0 = time.perf_counter()
        out = svc.flush()
        torch.cuda.synchronize()
        return ([out[t] for t in tickets], svc.stats(),
                (time.perf_counter() - t0) * 1e3)

    alone = dist_alone(lambda: serve(None), rank, group)
    reset_counts()
    got, stats, ms = serve(mesh)
    launches = counts()
    check(all(Bp % P == 0 for _, Bp in stats["shapes"]),
          f"batcher rungs {stats['shapes']} not multiples of {P}")
    check(launches["sig_trunc"] == stats["batches"],
          f"batcher: {launches['sig_trunc']} sig_trunc launches a rank for "
          f"{stats['batches']} rungs")
    res = dict(case="mesh-placed batcher", P=P, requests=len(reqs),
               flush_ms=ms, rows_per_device=stats["rows_per_device"],
               occupancy=stats["occupancy"], devices=stats["devices"],
               shapes=stats["shapes"],
               launches_per_rank=dict(sig_trunc=launches["sig_trunc"]))
    if rank == 0:
        (want, _, single_ms), _ = alone
        worst = max(float((a - b).abs().max()) for a, b in zip(got, want))
        check(all(dist_values_within(a, b) for a, b in zip(got, want)),
              f"batcher answers differ from one rank: max |err| {worst}")
        res.update(single_flush_ms=single_ms, max_abs_err=worst)
    return res


def dist_sessions(rank: int, mesh, seed: int, where: str) -> dict:
    """(f) a SessionStore over the mesh at phase 22's configuration: one
    round, its checkpoint restored with no mesh: the same answers."""
    from repro_torch.distributed import batch as DB
    d, N, _, _, max_ticks, _ = POOL_CFG
    group, P = mesh.get_group(), mesh.size()
    sids, cnt, ticks = pool_rounds(DIST_POOL_N)[0]

    def one_round(m):
        store = SessionStore(d, N, initial_sessions=DIST_POOL_N,
                             max_ticks=max_ticks, device=DEV, mesh=m)
        t0 = time.perf_counter()
        store.ingest_many(sids, cnt, ticks, auto_create=True)
        store.flush()
        torch.cuda.synchronize()
        return store, (time.perf_counter() - t0) * 1e3

    alone = dist_alone(lambda: one_round(None), rank, group)
    reset_counts()
    store, ms = one_round(mesh)
    launches = counts()["sig_trunc"]
    sample = list(dict.fromkeys(sids))[:256]
    before = store.block_features(sample)
    ck = Checkpointer(os.path.join(where, "pool"), async_save=False)
    store.checkpoint(ck, 1)
    back = SessionStore.restore(ck, mesh=None)
    after = back.block_features(sample)
    check(torch.equal(before, after), "the pool restored at P = 1 answers "
          "differently from the pool checkpointed over the mesh")
    check(DB.is_dtensor(store.pool.sig) and store.stats()["devices"] == P,
          "the pool is not placed over the mesh")
    res = dict(case="sharded session pool", P=P, sessions=len(store),
               pool_size=store.pool_size, round_ms=ms,
               launches_per_rank=dict(sig_trunc=launches))
    if rank == 0:
        single, single_ms = alone[0]
        want = single.block_features(sample)
        check(dist_values_within(before, want),
              f"sharded pool differs from one rank: max |err| "
              f"{float((before - want).abs().max()):.3e}")
        res.update(single_round_ms=single_ms)
    return res


def dist_rank(rank: int, world: int, where: str, seed: int, queue) -> None:
    """One gloo rank on the card: every case of phase 26; nothing is
    caught (an exception exits the process non-zero)."""
    from datetime import timedelta
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import make_sig_mesh
    os.environ["PATHSIG_AUTOTUNE"] = "off"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    torch.distributed.init_process_group(
        "gloo", store=torch.distributed.FileStore(
            os.path.join(where, "store"), world), rank=rank,
        world_size=world, timeout=timedelta(seconds=DIST_COLLECTIVE_S))
    mesh = make_sig_mesh()
    parts = [("signature", dist_signature), ("projected", dist_projected),
             ("gram", dist_gram)]
    if world == 2:
        parts += [("train", dist_train), ("batcher", dist_batcher),
                  ("sessions", lambda r, m, s: dist_sessions(r, m, s, where))]
    res, seconds = dict(rank=rank), {}
    for name, fn in parts:
        t0 = time.perf_counter()
        res[name] = fn(rank, mesh, seed)
        seconds[name] = time.perf_counter() - t0
    res["seconds"] = seconds
    res["transports"] = dict(C.LOG.transports)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    queue.put(res)


def dist_world(P: int, seed: int, target=None) -> list:
    """Spawn a gloo world of P ranks on the card running ``target``
    (default :func:`dist_rank`); -> every rank's results
    (:func:`dist_worlds` of one world)."""
    return dist_worlds((P,), seed, target)[0][P]


def dist_worlds(sizes: tuple, seed: int, target=None) -> tuple:
    """Spawn a gloo world of each size in ``sizes`` side by side on the
    card, every rank running ``target`` (default :func:`dist_rank`) ->
    ({P: every rank's results}, {P: seconds from the spawn to the
    world's last result}).  Each rank's exit code is checked, and worlds
    that do not finish in DIST_WORLD_S fail."""
    import queue as queue_mod
    import tempfile
    ctx = torch.multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    worlds = {}
    for P in sizes:
        q = ctx.Queue()
        where = tempfile.mkdtemp(dir=ROOT / "build")
        procs = [ctx.Process(target=target or dist_rank,
                             args=(r, P, where, seed, q)) for r in range(P)]
        worlds[P] = (q, where, procs, {})
        for p in procs:
            p.start()
    seconds, deadline = {}, t0 + DIST_WORLD_S
    try:
        while len(seconds) < len(sizes):
            for P, (q, _, procs, got) in worlds.items():
                if P in seconds:
                    continue
                try:
                    res = q.get(timeout=1)
                    got[res["rank"]] = res
                    if len(got) == P:
                        seconds[P] = time.perf_counter() - t0
                except queue_mod.Empty:
                    dead = [p.exitcode for p in procs if p.exitcode not in
                            (None, 0)]
                    check(not dead, f"world of {P}: a rank exited {dead}")
                    check(time.perf_counter() < deadline,
                          f"world of {P}: no result in {DIST_WORLD_S} s")
        for _, _, procs, _ in worlds.values():
            for p in procs:
                p.join(timeout=60)
    finally:
        for _, where, procs, _ in worlds.values():
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            shutil.rmtree(where, ignore_errors=True)
    for P, (_, _, procs, _) in worlds.items():
        codes = [p.exitcode for p in procs]
        check(codes == [0] * P, f"world of {P}: exit codes {codes}")
    return ({P: [got[r] for r in range(P)]
             for P, (_, _, _, got) in worlds.items()}, seconds)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_nccl_one(seed: int) -> dict:
    """A world of one over NCCL: the size-1 context takes the
    single-device path, bit for bit (values and gradients of one
    signature and one Gram)."""
    from datetime import timedelta
    from repro_torch.distributed import sharding_ctx
    from repro_torch.launch.mesh import make_sig_mesh
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
        world_size=1, timeout=timedelta(seconds=DIST_COLLECTIVE_S))
    try:
        mesh = make_sig_mesh(1)
        rng = np.random.default_rng(seed + 2606)
        B, M, d, N = DIST_SIG
        x = torch.tensor(rng.normal(size=(B, M, d)) / np.sqrt(M),
                         dtype=torch.float32, device="cuda")
        S = torch.tensor(rng.normal(size=(8, 584)), dtype=torch.float32,
                         device="cuda")
        w = S[0].abs() + 0.2

        def sig():
            a = x.clone().requires_grad_(True)
            out = ops.signature(a, N)
            out.square().sum().backward()
            return out.detach(), a.grad

        def gram():
            a = S.clone().requires_grad_(True)
            G = ops.gram(a, S, w)
            G.square().sum().backward()
            return G.detach(), a.grad

        same = {}
        for name, fn in (("signature", sig), ("gram", gram)):
            ref = fn()
            with sharding_ctx(mesh):
                got = fn()
            same[name] = all(type(g) is torch.Tensor and torch.equal(g, r)
                             for g, r in zip(got, ref))
            check(same[name], f"NCCL world of one: the size-1 context's "
                  f"{name} differs from no context")
        return dict(backend=str(torch.distributed.get_backend()),
                    bit_identical=same)
    finally:
        torch.distributed.destroy_process_group()


def phase_distributed(seed: int) -> dict:
    """Phase 26: the data-parallel slice over gloo worlds of 2 and 4 ranks
    on the one card, and a world of one over NCCL."""
    t0 = time.perf_counter()
    one = dist_nccl_one(seed)
    print(f"[dist] NCCL world of one: the size-1 context is bit-identical "
          f"to none {one['bit_identical']}", flush=True)
    # the worlds run side by side, sharing the card and the host
    worlds, world_s = dist_worlds(DIST_WORLDS, seed)
    print(f"[dist] worlds' wall seconds (spawn to exit) {world_s}",
          flush=True)
    for P, ranks in worlds.items():
        r0 = ranks[0]
        for c in r0["signature"] + [r0["projected"]] + r0["gram"]:
            per = [next(x for x in (r["signature"] + [r["projected"]]
                                    + r["gram"]) if x["case"] == c["case"]
                        )["launches_per_rank"] for r in ranks]
            print(f"[dist] P={P} {c['case']} {c['shape']}: {c['ms']:.2f} ms "
                  f"sharded value{'' if 'ring' in c['case'] else '+grad'} "
                  f"(rank 0), {c['single_ms']:.2f} ms on one rank alone; "
                  f"launches a rank {per}; max |err| "
                  f"{c['max_abs_err']:.2e}", flush=True)
        for g in r0["gram"]:
            print(f"[dist] P={P} {g['case']}: {g['permutes']} send/recv "
                  f"steps, {g['wire_bytes']} bytes a rank; {g['overlap']}",
                  flush=True)
        if "train" in r0:
            t, b, s = r0["train"], r0["batcher"], r0["sessions"]
            print(f"[dist] P={P} sig-MMD train_loop qwen3-4b depth "
                  f"{t['layers']}, {t['batch'][0]} x {t['batch'][1]}: losses "
                  f"{np.round(t['losses'], 6).tolist()} against one rank's "
                  f"{np.round(t['single_losses'], 6).tolist()}; step "
                  f"{t['step_ms']:.1f} ms (one rank alone "
                  f"{t['single_step_ms']:.1f} ms); launches a rank "
                  f"{[r['train']['launches_per_rank'] for r in ranks]}",
                  flush=True)
            print(f"[dist] P={P} batcher: {b['requests']} requests, flush "
                  f"{b['flush_ms']:.1f} ms (one rank alone "
                  f"{b['single_flush_ms']:.1f} ms); rungs {b['shapes']}; "
                  f"rows_per_device {b['rows_per_device']}, occupancy "
                  f"{b['occupancy']:.3f}; launches a rank "
                  f"{[r['batcher']['launches_per_rank'] for r in ranks]}",
                  flush=True)
            print(f"[dist] P={P} session pool of {s['sessions']} sessions "
                  f"(pool {s['pool_size']}): round {s['round_ms']:.1f} ms "
                  f"(one rank alone {s['single_round_ms']:.1f} ms); "
                  f"restored at P = 1 bit for bit; launches a rank "
                  f"{[r['sessions']['launches_per_rank'] for r in ranks]}",
                  flush=True)
        print(f"[dist] P={P} transports: {r0['transports']}; seconds a "
              f"case (rank 0) {np.round(list(r0['seconds'].values()), 1)}"
              f" {list(r0['seconds'])}", flush=True)
    seconds = time.perf_counter() - t0
    print(f"[dist] ranks share one card: a sharded time is not a speedup. "
          f"Phase 26 {seconds:.1f} s", flush=True)
    return dict(nccl_one=one, world_s=world_s,
                worlds={P: ranks[0] for P, ranks in worlds.items()},
                launches={P: [{k: r[k] for k in ("signature", "projected",
                                                   "gram")} for r in ranks]
                          for P, ranks in worlds.items()},
                seconds=seconds)


# qwen3-4b depth, sig-MMD steps (2 x 2; cut from 3 steps when phase 28
# took case (g))
MP_TRAIN = (2, 2)
MP_SERVE = (4, 8, 8, 64)          # batch, prompt, new tokens, max_len
MP_SERVE_DEPTH = 12               # of qwen3-4b's 36 (cut for case (g))
MP_FAMILIES = ("deepseek-v2-lite-16b", "zamba2-7b", "rwkv6-1.6b")
MP_FAM_DEPTH = 2
MP_FAM_TRAIN = (2, 512)           # batch, tokens: one row a data rank
MP_FAM_DECODE = (2, 4, 3, 16)     # batch, prompt, new tokens, max_len
# deepseek's MLA decoded under rules_for(arch, "decode_32k") on 2 x 2: the
# requests over the data axis, the latent cache's 16 positions in blocks
# of 8 over the model axis, which the prompt and new tokens cross
MP_CP_ARCH = "deepseek-v2-lite-16b"
MP_CP_DECODE = (2, 6, 4, 16)
MP_SGD_LR = 1e-3


def mp_full_grads(model, grads, placed) -> list:
    """A sharded model's gradients of a loss of the placed batch leaf
    ``placed`` as the reference's full arrays, reduced by the train step's
    rule (``train.trainer.reduce_grads``: summed over the axes that split
    the batch, where an FSDP shard's reduce-scatter has not)."""
    from repro_torch.distributed import model_parallel as MP
    from repro_torch.optim.optimizers import named
    from repro_torch.train.trainer import reduce_grads
    pl = MP.placements(model)
    have = {k: g.clone() for k, g in zip(named(model), grads)
            if g is not None}
    summed = reduce_grads(have, model, placed)
    return [None if name not in summed else
            MP.gather_tensor(summed[name], pl[name]) if name in pl
            else summed[name] for name in named(model)]


def mp_forward_collectives(model, cfg, batch, mesh) -> dict:
    """The collectives of one backbone forward on the sharded model: counts
    and bytes by kind, counts by site, against the analytic count."""
    from repro_torch.distributed import batch as DB
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding_ctx
    from repro_torch.distributed.hlo import collective_stats
    from repro_torch.models import transformer as TT
    from repro_torch.train import place_batch
    with sharding_ctx(mesh), torch.no_grad():
        placed = place_batch(batch)["tokens"]
        C.LOG.reset()
        TT.backbone(model, cfg, tokens=DB.to_local(placed), remat="none")
        recs = list(C.LOG.records)
    sites: dict = {}
    for r in recs:
        sites[r.tag] = sites.get(r.tag, 0) + 1
    L = cfg.n_layers
    want = {"tp_out": 2 * L, "fsdp_gather": 7 * L, "embed": 1}
    check(all(sites.get(k, 0) == v for k, v in want.items()),
          f"model-parallel forward collectives by site {sites}, expected "
          f"{want}")
    st = collective_stats(recs)
    return dict(by_kind={k: list(v) for k, v in st.by_kind.items()},
                by_site=sites, expected=want,
                transports=dict(C.LOG.transports))


def mp_qwen_train(rank: int, mesh, seed: int) -> dict:
    """(a) the sig-MMD train_loop of qwen3-4b (full width, depth 2) on
    the 2 x 2 mesh against one rank."""
    import copy
    from repro_torch.distributed import model_parallel as MP
    from repro_torch.distributed import sharding_ctx
    from repro_torch.optim.optimizers import named
    from repro_torch.train import make_sig_mmd_loss, place_batch
    L, steps = MP_TRAIN
    cfg = with_sig_head(dataclasses.replace(get_config(LM_ARCH),
                                            n_layers=L), **LM_HEAD)
    model = lm_model(cfg, seed)
    loop = TrainLoopConfig(steps=steps, log_every=1, run_dir="",
                           loss="sig_mmd")
    loss_fn = make_sig_mmd_loss(cfg)
    batch = next(lm_data(cfg, "sig_mmd", 0, seed))

    def first_grads(m, placed=None):
        loss, _ = loss_fn(m, batch if placed is None else placed, "dots")
        return torch.autograd.grad(loss, list(named(m).values()),
                                   allow_unused=True)

    def single():
        g = first_grads(model)
        _, _, hist = train_loop(cfg, model, adamw(lr=3e-4),
                                lm_data(cfg, "sig_mmd", 0, seed), loop)
        return [None if t is None else t.cpu() for t in g], hist

    alone = dist_alone(single, rank, None, warm=False)
    lm_free()
    sharded = MP.shard_model(copy.deepcopy(model), mesh)
    with sharding_ctx(mesh):
        placed = place_batch(batch)
        g = mp_full_grads(sharded, first_grads(sharded, placed),
                          placed["tokens"])
    coll = mp_forward_collectives(sharded, cfg, batch, mesh)
    del sharded
    lm_free()
    with sharding_ctx(mesh):
        reset_counts()
        t0 = time.perf_counter()
        trained, _, hist = train_loop(cfg, model, adamw(lr=3e-4),
                                      lm_data(cfg, "sig_mmd", 0, seed), loop)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
    launches = counts()
    P = 2
    want = {k: dict(sig_trunc=2, sig_gram=3 * P, sig_sweep=1).get(k, 0)
            * steps for k in launches}
    check(launches == want, f"model-parallel sig-MMD steps: launches a rank "
          f"{launches}, expected {want}")
    losses = [h["loss"] for h in hist]
    local = sum(p.numel() for p in trained.parameters())
    res = dict(case="2 x 2 model-parallel sig-MMD train_loop", layers=L,
               mesh=[2, 2], shape=[LM_TRAIN[1], LM_TRAIN[2],
                                   LM_HEAD["channels"], LM_HEAD["depth"]],
               losses=losses, collectives=coll,
               local_params=local,
               full_params=sum(p.numel() for p in model.parameters()),
               step_ms=float(np.median([h["sec"] for h in hist[1:]])) * 1e3,
               loop_s=loop_s,
               launches_per_rank={k: v for k, v in launches.items() if v})
    if rank == 0:
        (g1, hist1), _ = alone
        ref = [h["loss"] for h in hist1]
        check(all(abs(a - b) <= 1e-4 * max(1.0, abs(b))
                  for a, b in zip(losses, ref)),
              f"model-parallel losses {losses} against one rank's {ref}")
        worst = 0.0
        for name, a, b in zip(named(model), g, g1):
            if b is None:
                check(a is None, f"first-step gradient {name}: one rank has "
                      f"none, the mesh has one")
                continue
            b = b.cuda()
            worst = max(worst, float((a - b).abs().max()))
            check(grad_within(a, b.double()),
                  f"model-parallel first-step gradient {name}: max |err| "
                  f"{float((a - b).abs().max()):.3e}")
        res.update(single_losses=ref, grad_max_abs_err=worst,
                   single_step_ms=float(np.median(
                       [h["sec"] for h in hist1[1:]])) * 1e3)
    del model, trained, g, alone
    lm_free()
    return res


def mp_family_cfg(arch: str):
    cfg = dataclasses.replace(get_config(arch), n_layers=MP_FAM_DEPTH)
    if cfg.family == "hybrid":      # one group: the Mamba2 layers, a block
        cfg = dataclasses.replace(cfg, hybrid_attn_every=MP_FAM_DEPTH)
    return cfg


def mp_family_train(rank: int, mesh, seed: int, arch: str) -> dict:
    """(c) one SGD step at full width, depth 2, on the 2 x 2 mesh against
    one rank: the loss and the gradient norm."""
    import copy
    from repro_torch.distributed import model_parallel as MP
    from repro_torch.distributed import sharding_ctx
    from repro_torch.optim import sgd
    from repro_torch.train import place_batch
    cfg = mp_family_cfg(arch)
    model = LM.init_params(seed, cfg)
    B, S = MP_FAM_TRAIN
    batch = next(iter(TokenStream(cfg.vocab_size, B, S, seed)))

    def one(m, b):
        opt = sgd(lr=MP_SGD_LR)
        state = opt.init(m)
        step = make_train_step(cfg, opt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, metrics = step(m, state, b)
        torch.cuda.synchronize()
        return ({k: float(v) for k, v in metrics.items()},
                (time.perf_counter() - t0) * 1e3)

    alone = dist_alone(lambda: one(copy.deepcopy(model), batch), rank, None,
                       warm=False)
    lm_free()
    MP.shard_model(model, mesh)
    with sharding_ctx(mesh):
        got, ms = one(model, place_batch(batch))
    res = dict(case=f"{arch} depth {MP_FAM_DEPTH}, one SGD step", mesh=[2, 2],
               batch=[B, S], loss=got["loss"], grad_norm=got["grad_norm"],
               ms=ms)
    if rank == 0:
        (want, single_ms), _ = alone
        check(abs(got["loss"] - want["loss"])
              <= 1e-4 * max(1.0, abs(want["loss"])),
              f"{arch} model-parallel loss {got['loss']} against one rank's "
              f"{want['loss']}")
        check(abs(got["grad_norm"] - want["grad_norm"])
              <= 1e-3 * abs(want["grad_norm"]),
              f"{arch} model-parallel gradient norm {got['grad_norm']} "
              f"against one rank's {want['grad_norm']}")
        res.update(single_loss=want["loss"],
                   single_grad_norm=want["grad_norm"], single_ms=single_ms)
    del model
    lm_free()
    return res


def mp_decode(rank: int, mesh, seed: int, cfg, shape, donation=False,
              rules=None):
    """Greedy tokens of ``cfg`` on the model sharded under ``rules``
    against one rank's; ms a decode step (rank 0, the ranks starting
    together) and the cache bytes a rank against the whole cache's."""
    from repro_torch.distributed import model_parallel as MP
    from repro_torch.distributed import sharding_ctx
    from repro_torch.distributed.hlo import buffer_ptrs, donation_stats
    from repro_torch.launch.dryrun import tree_bytes
    B, P, new, max_len = shape
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 27)
    prompts = torch.randint(1, cfg.vocab_size, (B, P), generator=g,
                            device="cuda", dtype=torch.int32)
    model = LM.init_params(seed, cfg)
    n_steps = P - 1 + new
    dev = torch.device("cuda", torch.cuda.current_device())

    def gen():
        return ServeEngine(cfg, model, max_len=max_len,
                           device=dev).generate(prompts, new)

    alone = dist_alone(gen, rank, None, warm=False)
    MP.shard_model(model, mesh, rules)
    lm_free()
    with sharding_ctx(mesh, rules):
        cache_bytes = tree_bytes(LM.init_cache(cfg, B, max_len,
                                               torch.float32, device=dev))
        gen()
        torch.distributed.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = gen()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n_steps
        don = None
        if donation:
            cache = LM.init_cache(cfg, B, max_len, torch.float32, device=dev)
            before = buffer_ptrs((model, cache))
            LM.decode_step(model, cfg, prompts[:, :1], cache)
            st = donation_stats(before, (model, cache))
            don = (st.n_aliased, len(before))
            check(st.n_aliased == len(before), f"{cfg.name} sharded decode: "
                  f"{st.n_aliased} of {len(before)} buffers in place")
    res = dict(case=f"{cfg.name} ({cfg.n_layers} layers) greedy"
               + (f" under {rules}" if rules else ""),
               mesh=list(mesh.shape),
               shape=[B, P, new, max_len], ms_per_step=ms, donation=don,
               local_params=sum(p.numel() for p in model.parameters()),
               cache_bytes=cache_bytes, whole_cache_bytes=tree_bytes(
                   LM.init_cache(cfg, B, max_len, torch.float32,
                                 device="meta")))
    if rank == 0:
        want, single_ms = alone
        check(torch.equal(toks, want), f"{cfg.name} model-parallel tokens "
              f"{toks.tolist()} against one rank's {want.tolist()}")
        res.update(single_ms_per_step=single_ms / n_steps)
    del model
    lm_free()
    return res


def mp_rank(rank: int, world: int, where: str, seed: int, queue) -> None:
    """One gloo rank on the card: the cases of phase 27 on a 2 x 2 mesh
    (world 4) or a 1 x 2 mesh (world 2); nothing is caught."""
    from datetime import timedelta
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import make_dev_mesh
    os.environ["PATHSIG_AUTOTUNE"] = "off"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    torch.distributed.init_process_group(
        "gloo", store=torch.distributed.FileStore(
            os.path.join(where, "store"), world), rank=rank,
        world_size=world, timeout=timedelta(seconds=DIST_COLLECTIVE_S))
    res, seconds = dict(rank=rank), {}
    if world == 4:
        from repro_torch.launch.dryrun import rules_for
        mesh = make_dev_mesh(2, 2)
        parts = [("train", lambda: mp_qwen_train(rank, mesh, seed))]
        parts += [(f"train/{a}", lambda a=a: mp_family_train(rank, mesh,
                                                             seed, a))
                  for a in MP_FAMILIES]
        parts += [("decode_cp", lambda: mp_decode(
            rank, mesh, seed, mp_family_cfg(MP_CP_ARCH), MP_CP_DECODE,
            rules=rules_for(MP_CP_ARCH, "decode_32k")))]
    else:
        mesh = make_dev_mesh(1, 2)
        parts = [("serve", lambda: mp_decode(
            rank, mesh, seed, dataclasses.replace(
                get_config(LM_ARCH), n_layers=MP_SERVE_DEPTH), MP_SERVE,
            donation=True))]
        parts += [(f"decode/{a}", lambda a=a: mp_decode(
            rank, mesh, seed, mp_family_cfg(a), MP_FAM_DECODE))
            for a in MP_FAMILIES]
    for name, fn in parts:
        t0 = time.perf_counter()
        res[name] = fn()
        seconds[name] = time.perf_counter() - t0
    res["seconds"] = seconds
    res["transports"] = dict(C.LOG.transports)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    queue.put(res)


def phase_model_parallel(seed: int) -> dict:
    """Phase 27: the model-parallel slice on a 2 x 2 and a 1 x 2 mesh of
    gloo ranks sharing the one card, against one rank."""
    t0 = time.perf_counter()
    # the worlds run side by side, sharing the card and the host
    worlds, world_s = dist_worlds((4, 2), seed, target=mp_rank)
    r4, r2 = worlds[4][0], worlds[2][0]
    t = r4["train"]
    print(f"[mp] 2 x 2 sig-MMD train_loop qwen3-4b depth {t['layers']}, "
          f"{t['shape'][0]} x {t['shape'][1]}: losses "
          f"{np.round(t['losses'], 6).tolist()} against one rank's "
          f"{np.round(t['single_losses'], 6).tolist()}; first-step "
          f"gradients max |err| {t['grad_max_abs_err']:.2e}; step "
          f"{t['step_ms']:.1f} ms (one rank alone {t['single_step_ms']:.1f} "
          f"ms); {t['local_params']} of {t['full_params']} parameters on "
          f"rank 0; launches a rank "
          f"{[r['train']['launches_per_rank'] for r in worlds[4]]}",
          flush=True)
    c = t["collectives"]
    print(f"[mp] 2 x 2 backbone forward collectives by site {c['by_site']} "
          f"(expected {c['expected']}); by kind [count, result bytes, wire "
          f"bytes a rank] {c['by_kind']}; transports {c['transports']}",
          flush=True)
    for a in MP_FAMILIES:
        f = r4[f"train/{a}"]
        print(f"[mp] 2 x 2 {f['case']} {f['batch']}: loss {f['loss']:.6f} "
              f"(one rank {f['single_loss']:.6f}), |g| {f['grad_norm']:.4f} "
              f"(one rank {f['single_grad_norm']:.4f}); {f['ms']:.1f} ms "
              f"(one rank alone {f['single_ms']:.1f} ms)", flush=True)
    for world, key in [(2, "serve")] + [(2, f"decode/{a}")
                                        for a in MP_FAMILIES] \
            + [(4, "decode_cp")]:
        d = (r2 if world == 2 else r4)[key]
        print(f"[mp] {' x '.join(map(str, d['mesh']))} {d['case']} "
              f"{d['shape']}: tokens equal one rank's; "
              f"{d['ms_per_step']:.1f} ms a decode step (one rank alone "
              f"{d['single_ms_per_step']:.1f} ms); {d['local_params']} "
              f"parameters on rank 0; cache bytes a rank "
              f"{d['cache_bytes']} of {d['whole_cache_bytes']} whole"
              + (f"; buffers in place {d['donation']}" if d["donation"]
                 else ""), flush=True)
    print(f"[mp] worlds' wall seconds {world_s}; seconds a case (rank 0) "
          f"{ {k: round(v, 1) for k, v in r4['seconds'].items()} } "
          f"{ {k: round(v, 1) for k, v in r2['seconds'].items()} }",
          flush=True)
    seconds = time.perf_counter() - t0
    print(f"[mp] ranks share one card: a sharded time is not a speedup. "
          f"Phase 27 {seconds:.1f} s", flush=True)
    return dict(world_s=world_s, world4=r4, world2=r2,
                launches=[r["train"]["launches_per_rank"] for r in worlds[4]],
                seconds=seconds)


# ---------------------------------------------------------------------------
# phase 28: the dry run against a real world, whisper's model axis,
# Adafactor on sharded parameters, decode under the dry run's rules
# ---------------------------------------------------------------------------

DR_ARCH = "whisper-large-v3"
# layers a stack and steps (cut from 4 and 3 when the case took the
# sequence rule: FSDP over both axes gathers every layer through the
# host; from 2 layers when phase 28 took case (g)), batch, tokens
DR_WHISPER_TRAIN = (1, 2, 64, 2)
DR_WHISPER_SERVE = (2, 4, 8)       # batch, prompt, new tokens (1 x 2)
DR_WHISPER_SERVE_DEPTH = 8         # a stack, of 32 (cut for case (g))
DR_ADAFACTOR = dict(lr=1e-3)       # factored at the published widths
# qwen3-4b's decode on 2 x 2 at full width and DR_DECODE_DEPTH of its 36
# layers (cut from all 36 when phase 28 took case (g)): batch, prompt, new
# tokens, max_len (a step under the default rules gathers every layer's
# weights through the host, 12.3 s at 36 layers with four ranks sharing
# the card: two steps, the second timed)
DR_DECODE_DEPTH = 12
DR_DECODE = (4, 1, 2, 16)
# and under rules_for(qwen3-4b, "decode_32k") at a shape whose 14
# positions cross the cache's sequence blocks of 8 (the model axis): the
# four requests over the data axis, 2 a rank
DR_DECODE_CP = (4, 10, 4, 16)
# (b), (c) and (f) train under rules_for(arch, their shape): no batch here
# divides by 256, so each carries the reference's "seq": "model" rule (the
# rows over the data axis, each sequence in blocks over the model axis,
# FSDP over both axes, no tensor parallelism).  (f): zamba2-7b and
# rwkv6-1.6b at full width, DR_FAMILY_TRAIN's layers, batch, tokens (blocks
# of 128) and Adafactor steps
DR_FAMILY = ("zamba2-7b", "rwkv6-1.6b")
DR_FAMILY_TRAIN = (2, 4, 256, 2)
DR_QWEN_STEPS = 2                 # (c)'s steps (phase 27 (a) takes 3)
DR_SHAPES = {"whisper": ("phase28_whisper", DR_WHISPER_TRAIN[1:3]),
             "qwen": ("phase28_qwen", LM_TRAIN[1:3]),
             "family": ("phase28_family", DR_FAMILY_TRAIN[1:3]),
             "sptp": ("phase28_sptp", LM_TRAIN[1:3])}
# rwkv6's float32 gradients over blocks against the whole sequence's: its
# WKV state folds change the order of float32 sums, as its prefill's
# (FAM_F32_TOL), so the atol is FAM_F32_TOL's share of max|g|
DR_GRAD_ATOL = {"rwkv6-1.6b": FAM_F32_TOL["rwkv6-1.6b"]}
# (e) the prefill under rules_for(arch, "prefill_32k") on 2 x 2: the
# requests over the data axis, each prompt in blocks over the model axis.
# qwen3-4b at full width and DR_PREFILL_QWEN_DEPTH of its 36 layers (cut
# from all 36 when phase 28 took the training cases, from 12 when it took
# case (g)); zamba2-7b and
# rwkv6-1.6b at full width and DR_PREFILL_DEPTH layers, whisper at
# DR_PREFILL_DEPTH + DR_PREFILL_DEPTH over its 1,500 frames and 448
# decoder tokens.  A prefill on the mesh gathers every layer's weights
# (FSDP over both axes) through gloo's host staging, so qwen3-4b is timed
# once and the smaller models after one warm call.
DR_PREFILL = (2, 2048)             # requests, prompt tokens (blocks of 1,024)
DR_PREFILL_ARCHS = (LM_ARCH, "zamba2-7b", "rwkv6-1.6b", DR_ARCH)
DR_PREFILL_DEPTH = 2
DR_PREFILL_QWEN_DEPTH = 6
DR_PREFILL_SHAPE = "prefill_32k"
# (g) Megatron sequence parallelism under rules_for(arch, shape,
# DR_SPTP_OVERRIDE) on 2 x 2: heads, ff and experts over the model axis,
# which also cuts each sequence, FSDP over the data axis.  deepseek-v2-
# lite-16b at full width and DR_SPTP_DEPTH layers (layer 0 dense with its
# 10,944-wide MLP, layer 1 its 64 experts top-6 and 2 shared; MLA in
# both): DR_SPTP_STEPS sig-MMD Adafactor steps at LM_TRAIN's 8 x 512, then
# a prefill of DR_SPTP_PREFILL; phi3.5-moe-42b-a6.6b at full width and
# the same depth (GQA heads split, 16 experts top-2): the prefill
DR_SPTP = ("deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b")
DR_SPTP_DEPTH = 2
DR_SPTP_STEPS = 2
DR_SPTP_PREFILL = (2, 1024)        # requests, prompt tokens (blocks of 512)
DR_SPTP_OVERRIDE = {"seq": "model"}
# (h) phi3.5-moe-42b-a6.6b's decode_32k cell on the 2 x 2 mesh: the cell's
# 128 requests (64 a data rank) are one capacity-bound dispatch group of
# 128 tokens a step (C = 20 slots an expert), split across both data ranks
DR_MOE_ARCH = "phi3.5-moe-42b-a6.6b"
DR_MOE_DEPTH = 2
DR_MOE_DECODE = (128, 4, 4, 16)    # requests, prompt, new tokens, max_len


def dr_whisper_cfg():
    L = DR_WHISPER_TRAIN[0]
    return dataclasses.replace(get_config(DR_ARCH), n_layers=L,
                               n_encoder_layers=L)


def dr_qwen_cfg():
    return with_sig_head(dataclasses.replace(get_config(LM_ARCH),
                                             n_layers=MP_TRAIN[0]),
                         **LM_HEAD)


def dr_whisper_batch(cfg, seed: int, device="cuda") -> dict:
    """frames (B, 1,500, 1,280), tokens and labels (B, S) from the seed."""
    _, B, S, _ = DR_WHISPER_TRAIN
    item = next(TokenStream(cfg.vocab_size, B, S, seed, device=device))
    g = torch.Generator(device=device).manual_seed(seed + 28)
    frames = torch.randn(B, cfg.n_audio_frames, cfg.d_model, generator=g,
                         device=device)
    return dict(item, frames=frames)


def dr_meta(batch: dict) -> dict:
    return {k: torch.empty_like(v, device="meta") for k, v in batch.items()}


def dr_rules(name: str, arch: str, override: dict | None = None) -> dict:
    """rules_for(arch, DR_SHAPES[name]'s train shape, override), the
    shape made known to the dry run's table first."""
    from repro_torch.launch import dryrun, specs
    shape, (B, S) = DR_SHAPES[name]
    specs.SHAPES[shape] = dict(kind="train", seq=S, batch=B)
    return dryrun.rules_for(arch, shape, override)


def dr_child(seed: int, queue) -> None:
    """The dry run's process (the fake world of 4 is its default process
    group; it never touches the card): ``lower_cell`` on
    ``AbstractMesh((2, 2))`` for phase 28's training steps under their
    cells' rules (``dr_rules``: each sequence in blocks), whisper's under
    the default rules too."""
    from repro_torch.distributed.ctx import AbstractMesh
    from repro_torch.launch import dryrun
    from repro_torch.optim import adafactor
    mesh = AbstractMesh((2, 2), ("data", "model"))
    out = {}
    w = dr_whisper_cfg()
    wb = dr_meta(dr_whisper_batch(w, seed, "cpu"))
    q = dr_qwen_cfg()
    qb = dr_meta(next(lm_data_cpu(q, seed)))

    def whisper():
        return LM.init_params(seed, w, torch.float32, device="meta")
    # (cell, DR_SHAPES key, arch, config, meta parameters, batch, loss,
    # rules): whisper under its train cell's rules and the default rules
    cells = (("whisper", "whisper", DR_ARCH, w, whisper, wb, "lm",
              dr_rules("whisper", DR_ARCH)),
             ("whisper_default", "whisper", DR_ARCH, w, whisper, wb, "lm",
              {}),
             ("qwen", "qwen", LM_ARCH, q, lambda: lm_model_meta(q, seed), qb,
              "sig_mmd", dr_rules("qwen", LM_ARCH)))
    for name, key, arch, cfg, params, batch, loss, rules in cells:
        check(tuple(batch["tokens"].shape) == DR_SHAPES[key][1],
              f"the dry run's {name} batch {tuple(batch['tokens'].shape)}")
        t0 = time.perf_counter()
        res = dryrun.lower_cell(arch, DR_SHAPES[key][0], mesh=mesh, cfg=cfg,
                                params=params(), batch=batch, loss=loss,
                                opt=adafactor(**DR_ADAFACTOR), rules=rules,
                                forward_collectives=True)
        res["wall_s"] = time.perf_counter() - t0
        out[name] = res
    dryrun.close_world()
    queue.put(out)


def lm_data_cpu(cfg, seed: int):
    """phase 24's sig-MMD batches (lm_data) made on the host."""
    _, B, S = LM_TRAIN[:3]
    ref = reference_paths(seed, B, S, cfg.sig_head.channels, "cpu")
    for item in TokenStream(cfg.vocab_size, B, S, seed, device="cpu"):
        yield dict(item, paths=ref)


def lm_model_meta(cfg, seed: int):
    model = LM.init_params(seed, cfg, torch.float32, device="meta")
    model["sig_head"] = init_sig_head(seed + 1, cfg, LM_OUT, device="meta")
    return model


def dr_measured(model, state, cfg, batch: dict, mesh, rules) -> dict:
    """What the dry run predicts, on this rank: parameter and
    optimizer-state bytes, and one backbone forward's collectives by
    kind."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding_ctx
    from repro_torch.distributed.hlo import collective_stats
    from repro_torch.launch import dryrun
    from repro_torch.train import place_batch
    with sharding_ctx(mesh, rules):
        placed = place_batch(batch)
        C.LOG.reset()
        dryrun.backbone_forward(model, cfg, placed)
        st = collective_stats()
    return dict(param_bytes=dryrun.tree_bytes(model),
                opt_state_bytes=dryrun.tree_bytes(state),
                forward={k: list(v) for k, v in st.by_kind.items()})


def dr_steps(cfg, m, batches: list, loss: str, place):
    """Adafactor steps of ``m`` over ``batches`` (each placed by
    ``place``): [(loss, ms)], the optimizer state, the peak bytes since
    the first step began, the first step's collectives by tag and its
    gradients as the step applies them (reduced by its rule), copied to
    the host."""
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.dryrun import collectives_by_tag
    from repro_torch.optim import Optimizer, adafactor
    inner = adafactor(**DR_ADAFACTOR)
    first = {}

    def update(grads, state, params):
        # the first step's gradients, copied to the host (no device bytes
        # added to the step's peak)
        if not first:
            first.update({k: g.detach().cpu() for k, g in grads.items()})
        return inner.update(grads, state, params)
    opt = Optimizer(init=inner.init, update=update)
    state = opt.init(m)
    step = make_train_step(cfg, opt, loss=loss)
    hist, tags = [], None
    torch.cuda.reset_peak_memory_stats()
    for b in batches:
        placed = place(b)
        torch.cuda.synchronize()
        C.LOG.reset()
        t0 = time.perf_counter()
        _, _, metrics = step(m, state, placed)
        value = float(metrics["loss"])
        hist.append((value, (time.perf_counter() - t0) * 1e3))
        if tags is None:
            tags = collectives_by_tag(C.LOG.records)
    return hist, state, torch.cuda.max_memory_allocated(), tags, first


def dr_alone(rank: int, cfg, model, batches: list, loss: str):
    """``dr_steps`` of a copy of ``model`` on rank 0 alone while the other
    ranks wait, ``model`` moved to the host meanwhile so that the peak
    counts one copy of the weights: (first-step gradients, [(loss, ms)],
    peak bytes) on rank 0, None elsewhere."""
    import copy

    def single():
        model.cpu()
        lm_free()
        m = copy.deepcopy(model).cuda()
        hist, _, peak, _, g = dr_steps(cfg, m, batches, loss, lambda b: b)
        del m
        lm_free()
        model.cuda()
        return g, hist, peak
    alone = dist_alone(single, rank, None, warm=False)
    lm_free()
    return None if alone is None else alone[0]


def dr_train(rank: int, mesh, cfg, model, batches: list, loss: str,
             rules: dict, alone, measure: bool = True) -> dict:
    """Adafactor steps of ``model`` on the mesh under ``rules`` against one
    rank's (``alone``, from :func:`dr_alone`): the losses, the first
    step's gradients (as the step applies them: reduced by its rule, then
    gathered whole), ms a step, peak bytes a rank, the first sharded
    step's collectives by tag (under a ``"seq"`` rule, the sequence
    blocks' exchanges and their backward), launches a rank counted over
    the sharded steps; with ``measure``, the measured side of the dry
    run."""
    from repro_torch.distributed import batch as DB
    from repro_torch.distributed import model_parallel as MP
    from repro_torch.distributed import sharding_ctx
    from repro_torch.optim.optimizers import named
    from repro_torch.train import place_batch
    if rules.get("fsdp"):
        # FSDP over both axes shards on their flattened group: every rank
        # makes it together
        MP.axes_split(mesh, rules["fsdp"])
    MP.shard_model(model, mesh, rules)
    with sharding_ctx(mesh, rules):
        split = DB.batch_seq(place_batch(batches[0]))
        reset_counts()
        hist, state, peak, tags, g = dr_steps(cfg, model, batches, loss,
                                              place_batch)
        torch.cuda.synchronize()
    launches = counts()
    pl = MP.placements(model)
    g = {k: MP.gather_tensor(v, pl[k]) if k in pl else v
         for k, v in g.items()}
    measured = dr_measured(model, state, cfg, batches[0], mesh, rules) \
        if measure else None
    res = dict(losses=[h[0] for h in hist],
               step_ms=float(np.median([h[1] for h in hist[1:]])),
               peak_bytes=peak, by_tag=tags, rules=str(rules),
               block=None if split is None else
               list(split.block(batches[0]["tokens"].shape[1])),
               launches_per_rank={k: v for k, v in launches.items() if v},
               local_params=sum(p.numel() for p in model.parameters()),
               measured=measured)
    if rules.get("seq") is None:
        check(split is None, f"{cfg.name} 2 x 2 steps under {rules}: the "
              f"batch's sequence is cut over {split}")
    else:
        check(split is not None and split.axes == ("model",),
              f"{cfg.name} 2 x 2 steps under {rules}: the batch's sequence "
              f"is not cut over the model axis")
        check({"sp_kv", "sp_kv_grad"} <= set(tags) or
              {"sp_state", "sp_state_grad"} <= set(tags) or
              {"sp_tp_in", "sp_tp_in_grad"} <= set(tags),
              f"{cfg.name} 2 x 2 steps: collectives by tag {sorted(tags)} "
              f"hold no sequence-block exchange and its backward")
    if rank == 0:
        g1, hist1, single_peak = alone
        ref = [h[0] for h in hist1]
        check(all(abs(a - b) <= 1e-4 * max(1.0, abs(b))
                  for a, b in zip(res["losses"], ref)),
              f"{cfg.name} 2 x 2 Adafactor losses {res['losses']} against "
              f"one rank's {ref}")
        atol = DR_GRAD_ATOL.get(cfg.name, E2E_TOL)
        worst, need = 0.0, 0.0
        check(set(g) == set(g1) == set(named(model)),
              f"{cfg.name} first-step gradients: names differ")
        for name in named(model):
            a, b = g[name].cuda(), g1[name].cuda().double()
            worst = max(worst, float((a - b).abs().max()))
            scale = float(b.abs().max())
            if scale > 0:
                need = max(need, atol_needed(a, b))
            check(bool(((a.double() - b).abs()
                        <= 1e-3 * b.abs() + atol * scale).all()),
                  f"{cfg.name} 2 x 2 first-step gradient {name}: max |err| "
                  f"{float((a - b).abs().max()):.3e} (atol {atol}·max|g|)")
        check(peak < single_peak, f"{cfg.name} 2 x 2 steps: peak {peak} "
              f"bytes a rank against one rank's {single_peak}")
        res.update(single_losses=ref, grad_max_abs_err=worst,
                   grad_atol_needed=need, grad_atol=atol,
                   single_peak_bytes=single_peak,
                   single_step_ms=float(np.median(
                       [h[1] for h in hist1[1:]])))
    return res


def dr_whisper_train(rank: int, mesh, seed: int) -> dict:
    """(b) whisper at full width, depth cut, Adafactor on the 2 x 2 mesh
    under its train cell's rules (the frames and the tokens in blocks,
    key "seq") and under the default rules (heads and ``ff`` over the
    model axis, FSDP over the data axis, key "default"), both against the
    same one-rank steps."""
    cfg = dr_whisper_cfg()
    batches = [dr_whisper_batch(cfg, seed + i) for i in
               range(DR_WHISPER_TRAIN[3])]
    model = LM.init_params(seed, cfg)
    alone = dr_alone(rank, cfg, model, batches, "lm")
    out = {}
    for key, rules in (("seq", dr_rules("whisper", DR_ARCH)),
                       ("default", {})):
        if model is None:
            model = LM.init_params(seed, cfg)
        res = dr_train(rank, mesh, cfg, model, batches, "lm", rules, alone)
        res.update(layers=[cfg.n_encoder_layers, cfg.n_layers],
                   published_layers=[get_config(DR_ARCH).n_encoder_layers,
                                     get_config(DR_ARCH).n_layers],
                   batch=list(batches[0]["frames"].shape[:2])
                   + [batches[0]["tokens"].shape[1]],
                   full_params=sum(p.numel() for p in LM.init_params(
                       seed, cfg, device="meta").parameters()))
        out[key] = res
        model = None
        lm_free()
    return out


def dr_qwen_train(rank: int, mesh, seed: int) -> dict:
    """(c) phase 27's qwen3-4b sig-MMD step with Adafactor on 2 x 2 under
    its train cell's rules: each rank projects its block, the whole path
    is gathered, and the three kernels run on it."""
    cfg = dr_qwen_cfg()
    model = lm_model(cfg, seed)
    data = lm_data(cfg, "sig_mmd", 0, seed)
    batches = [next(data) for _ in range(DR_QWEN_STEPS)]
    alone = dr_alone(rank, cfg, model, batches, "sig_mmd")
    res = dr_train(rank, mesh, cfg, model, batches, "sig_mmd",
                   dr_rules("qwen", LM_ARCH), alone)
    P = 2
    want = {k: dict(sig_trunc=2, sig_gram=3 * P, sig_sweep=1).get(k, 0)
            * DR_QWEN_STEPS for k in counts()}
    got = {k: res["launches_per_rank"].get(k, 0) for k in want}
    check(got == want, f"2 x 2 Adafactor sig-MMD steps: launches a rank "
          f"{got}, expected {want}")
    check("sp_path" in res["by_tag"], f"2 x 2 sig-MMD steps: no gathered "
          f"path among {sorted(res['by_tag'])}")
    res.update(layers=cfg.n_layers, mesh=[2, 2],
               shape=[LM_TRAIN[1], LM_TRAIN[2], LM_HEAD["channels"],
                      LM_HEAD["depth"]],
               case="2 x 2 model-parallel sig-MMD Adafactor steps")
    del model
    lm_free()
    return res


def dr_family_train(rank: int, mesh, seed: int) -> dict:
    """(f) zamba2-7b and rwkv6-1.6b at full width and DR_FAMILY_TRAIN's
    depth, LM loss, Adafactor on 2 x 2 under their train cells' rules
    (each sequence in blocks over the model axis)."""
    L, B, S, n = DR_FAMILY_TRAIN
    out = {}
    for arch in DR_FAMILY:
        cfg = dataclasses.replace(mp_family_cfg(arch), n_layers=L)
        model = LM.init_params(seed, cfg)
        batches = [dict(item) for item, _ in zip(
            TokenStream(cfg.vocab_size, B, S, seed + 6), range(n))]
        alone = dr_alone(rank, cfg, model, batches, "lm")
        res = dr_train(rank, mesh, cfg, model, batches, "lm",
                       dr_rules("family", arch), alone, measure=False)
        res.update(layers=L, batch=[B, S],
                   full_params=sum(p.numel() for p in LM.init_params(
                       seed, cfg, device="meta").parameters()))
        out[arch] = res
        del model
        lm_free()
    return out


def dr_in_turns(rank: int, world: int, make):
    """``make()`` on each rank in turn (a published model drawn whole,
    then cut to its blocks), so one full tree is on the card at a time."""
    out = None
    for r in range(world):
        if r == rank:
            out = make()
            lm_free()
        torch.distributed.barrier()
    return out


@torch.no_grad()
def dr_greedy(model, cfg, prompts, n_new: int, cache):
    """The prompt's decode steps, then n_new greedy tokens through
    ``make_serve_step`` (the whole batch's on every rank), each step
    timed to a synchronize; -> (tokens, median ms a step after the first
    step, which is warm-up)."""
    from repro_torch.serve.engine import make_serve_step
    step = make_serve_step(cfg)
    P = prompts.shape[1]
    ms, tok, out = [], prompts[:, :1], [prompts]
    for j in range(P - 1 + n_new):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nxt, cache = step(model, cache, tok)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if j + 1 < P:
            tok = prompts[:, j + 1:j + 2]
        else:
            tok = nxt
            out.append(nxt)
    return torch.cat(out, dim=1), float(np.median(ms[1:]))


def dr_decode(rank: int, mesh, seed: int) -> dict:
    """(d) qwen3-4b at full width, DR_DECODE_DEPTH layers, on the 2 x 2
    mesh: greedy tokens and ms a step under the dry run's decode rules,
    under the default rules, and on one rank alone (DR_DECODE: every
    weight is gathered over the data axis a step under the default rules,
    through gloo's host staging);
    then under the decode rules at DR_DECODE_CP, whose positions cross
    the cache's sequence blocks.  The cache bytes a rank holds under each
    rule set, beside the whole cache's."""
    from repro_torch.distributed import model_parallel as MP
    from repro_torch.distributed import sharding_ctx
    from repro_torch.launch.dryrun import rules_for, tree_bytes
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=DR_DECODE_DEPTH)
    g = torch.Generator(device="cuda").manual_seed(seed + 28)
    prompts = {shape: torch.randint(
        1, cfg.vocab_size, shape[:2], generator=g, device="cuda",
        dtype=torch.int32) for shape in (DR_DECODE, DR_DECODE_CP)}
    dev = torch.device("cuda", torch.cuda.current_device())
    decode_rules = rules_for(LM_ARCH, "decode_32k")

    def gen(model, shape, key=None):
        B, _, new, max_len = shape
        cache = LM.init_cache(cfg, B, max_len, torch.float32, device=dev)
        if key is not None:
            res[f"{key}_cache_bytes"] = tree_bytes(cache)
        return dr_greedy(model, cfg, prompts[shape], new, cache)

    res = dict(rules=str(decode_rules))
    for key, (B, _, _, max_len) in (("whole", DR_DECODE),
                                    ("whole_cp", DR_DECODE_CP)):
        res[f"{key}_cache_bytes"] = tree_bytes(LM.init_cache(
            cfg, B, max_len, torch.float32, device="meta"))
    alone = {}
    if rank == 0:
        whole = LM.init_params(seed, cfg)
        alone = {shape: gen(whole, shape) for shape in (DR_DECODE,
                                                        DR_DECODE_CP)}
        del whole
    torch.distributed.barrier()
    lm_free()
    runs = (("default", None, (DR_DECODE,)),
            ("rules_for", decode_rules, (DR_DECODE, DR_DECODE_CP)))
    for name, rules, shapes in runs:
        model = dr_in_turns(rank, 4, lambda rules=rules: MP.shard_model(
            LM.init_params(seed, cfg), mesh, rules))
        for shape in shapes:
            key = name if shape is DR_DECODE else f"{name}_cp"
            with sharding_ctx(mesh, rules):
                torch.distributed.barrier()
                toks, res[f"{key}_ms"] = gen(model, shape, key)
            if rank == 0:
                check(torch.equal(toks, alone[shape][0]), f"qwen3-4b 2 x 2 "
                      f"decode {list(shape)} under the {name} rules: tokens "
                      f"{toks.tolist()} against one rank's "
                      f"{alone[shape][0].tolist()}")
        res[f"{name}_local_params"] = sum(p.numel()
                                          for p in model.parameters())
        del model
        lm_free()
    if rank == 0:
        res["single_ms"] = alone[DR_DECODE][1]
        res["single_cp_ms"] = alone[DR_DECODE_CP][1]
        check(res["rules_for_ms"] <= res["default_ms"],
              f"qwen3-4b 2 x 2 decode: {res['rules_for_ms']:.1f} ms a step "
              f"under rules_for against {res['default_ms']:.1f} under the "
              f"default rules")
    res.update(shape=list(DR_DECODE[:3]), cp_shape=list(DR_DECODE_CP),
               params=cfg.param_count())
    return res


@torch.no_grad()
def dr_whisper_greedy(model, cfg, frames, prompts, n_new: int):
    """encode -> prefill_cross -> dr_greedy; -> (tokens, ms a decode
    step)."""
    B = prompts.shape[0]
    enc = LM.encdec.encode(model, cfg, frames, remat="none")
    cache = LM.encdec.prefill_cross(model, cfg, enc, LM.init_cache(
        cfg, B, frames.shape[1], torch.float32, device=frames.device))
    return dr_greedy(model, cfg, prompts, n_new, cache)


def dr_whisper_serve(rank: int, mesh, seed: int) -> dict:
    """(a) whisper at full width, DR_WHISPER_SERVE_DEPTH layers a stack,
    on the 1 x 2 mesh against one rank."""
    from repro_torch.distributed import model_parallel as MP
    from repro_torch.distributed import sharding_ctx
    cfg = dataclasses.replace(get_config(DR_ARCH),
                              n_layers=DR_WHISPER_SERVE_DEPTH,
                              n_encoder_layers=DR_WHISPER_SERVE_DEPTH)
    B, P, new = DR_WHISPER_SERVE
    g = torch.Generator(device="cuda").manual_seed(seed + 29)
    frames = torch.randn(B, cfg.n_audio_frames, cfg.d_model, generator=g,
                         device="cuda")
    prompts = torch.randint(1, cfg.vocab_size, (B, P), generator=g,
                            device="cuda", dtype=torch.int32)
    model = LM.init_params(seed, cfg)
    n_params = sum(p.numel() for p in model.parameters())
    alone = dist_alone(lambda: dr_whisper_greedy(model, cfg, frames,
                                                 prompts, new),
                       rank, None, warm=True)
    MP.shard_model(model, mesh)
    lm_free()
    with sharding_ctx(mesh):
        dr_whisper_greedy(model, cfg, frames, prompts, new)
        torch.distributed.barrier()
        toks, ms = dr_whisper_greedy(model, cfg, frames, prompts, new)
    res = dict(params=n_params, layers=[cfg.n_encoder_layers, cfg.n_layers],
               shape=[B, cfg.n_audio_frames, P, new], ms_per_step=ms,
               local_params=sum(p.numel() for p in model.parameters()))
    if rank == 0:
        (want, single_ms), _ = alone
        check(torch.equal(toks, want), f"whisper 1 x 2 tokens "
              f"{toks.tolist()} against one rank's {want.tolist()}")
        res["single_ms_per_step"] = single_ms
    del model
    lm_free()
    return res


def dr_prefill_cfg(arch: str):
    """Case (e)'s config: each arch at full width, qwen3-4b at
    DR_PREFILL_QWEN_DEPTH layers, the others at DR_PREFILL_DEPTH (each
    stack)."""
    cfg = get_config(arch)
    if arch == LM_ARCH:
        return dataclasses.replace(cfg, n_layers=DR_PREFILL_QWEN_DEPTH)
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_layers=DR_PREFILL_DEPTH,
                                   n_encoder_layers=DR_PREFILL_DEPTH)
    return dataclasses.replace(cfg, n_layers=DR_PREFILL_DEPTH)


def dr_prefill_batch(cfg, seed: int, shape=DR_PREFILL) -> dict:
    """Case (e)'s prompts, the same on every rank: ``shape``'s tokens
    (requests, prompt), or whisper's frames and its decoder_max_len
    tokens."""
    B, S = shape
    g = torch.Generator(device="cuda").manual_seed(seed + 33)
    if cfg.family == "encdec":
        return {"frames": torch.randn(B, cfg.n_audio_frames, cfg.d_model,
                                      generator=g, device="cuda"),
                "tokens": torch.randint(1, cfg.vocab_size,
                                        (B, cfg.decoder_max_len),
                                        generator=g, device="cuda",
                                        dtype=torch.int32)}
    return {"tokens": torch.randint(1, cfg.vocab_size, (B, S), generator=g,
                                    device="cuda", dtype=torch.int32)}


def dr_timed(fn, warm: bool):
    """``fn()`` (after one untimed call with ``warm``) -> (its result, ms
    to a synchronize, this process's peak allocated bytes during the
    timed call, the collectives it issued)."""
    from repro_torch.distributed import collectives as C
    if warm:
        fn()
    torch.cuda.synchronize()
    C.LOG.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, (time.perf_counter() - t0) * 1e3,
            torch.cuda.max_memory_allocated(), list(C.LOG.records))


def dr_prefill(rank: int, mesh, seed: int) -> dict:
    """(e) each of DR_PREFILL_ARCHS prefilled on the 2 x 2 mesh under its
    prefill cell's rules (each rank its request and its block of the
    prompt) against one rank's prefill of the whole batch
    (:func:`dr_prefill_one`)."""
    from repro_torch.launch.dryrun import rules_for
    out = {}
    for arch in DR_PREFILL_ARCHS:
        cfg = dr_prefill_cfg(arch)
        out[arch] = dr_prefill_one(rank, mesh, seed, cfg,
                                   rules_for(arch, DR_PREFILL_SHAPE),
                                   dr_prefill_batch(cfg, seed),
                                   warm=arch != LM_ARCH)
    return out


def dr_prefill_one(rank: int, mesh, seed: int, cfg, rules: dict,
                   batch: dict, warm: bool) -> dict:
    """``cfg``'s prefill of ``batch`` on the 2 x 2 mesh under ``rules``
    against one rank's prefill of the whole batch: the last position's
    logits of every rank within 1e-4·max|ref| (rwkv6 at FAM_F32_TOL)
    with equal argmax, ms a prefill beside one rank's (timed once, or
    after a warm call with ``warm``), peak bytes a rank beside one
    rank's, all-gathers and reduce-scatters a forward by tag, and the
    kernel launches the path made (none: no kernel is on it)."""
    from repro_torch.distributed import batch as DB
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import model_parallel as MP
    from repro_torch.distributed import sharding_ctx
    from repro_torch.launch.dryrun import collectives_by_tag
    from repro_torch.train import place_batch
    arch = cfg.name
    step = make_prefill_step(cfg)
    t0 = time.perf_counter()
    alone = None
    if rank == 0:
        whole = LM.init_params(seed, cfg)
        alone = dr_timed(lambda: step(whole, batch), warm=True)
        del whole
        print(f"[dryrun_mp] {arch}: one rank's prefill, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.distributed.barrier()
    lm_free()
    # FSDP over both axes shards on their flattened group: a new process
    # group is made by every rank together, not in turns
    MP.axes_split(mesh, rules.get("fsdp") or "data")
    model = dr_in_turns(rank, 4, lambda: MP.shard_model(
        LM.init_params(seed, cfg), mesh, rules))
    if rank == 0:
        print(f"[dryrun_mp] {arch}: sharded in turns, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    with sharding_ctx(mesh, rules):
        placed = place_batch(batch)
        lead = placed.get("tokens")
        with DB.rows_scope(lead) as rows:
            start, block = rows.start, rows.seq.block(lead.shape[1])
        torch.distributed.barrier()
        reset_counts()
        logits, ms, peak, records = dr_timed(
            lambda: step(model, placed), warm=warm)
        launches = {k: v for k, v in counts().items() if v}
    every = C.all_gather(logits, torch.distributed.group.WORLD,
                         tag="check")
    starts = [None] * 4
    torch.distributed.all_gather_object(starts, start)
    by_tag = collectives_by_tag(records)
    res = dict(ms=ms, peak_bytes=peak, launches=launches, block=block,
               layers=[cfg.n_encoder_layers, cfg.n_layers]
               if cfg.family == "encdec" else cfg.n_layers,
               batch={k: list(v.shape) for k, v in batch.items()},
               all_gathers={t: v["all-gather"]["count"] for t, v in
                            by_tag.items() if "all-gather" in v},
               reduce_scatters={t: v["reduce-scatter"]["count"] for t, v
                                in by_tag.items() if "reduce-scatter" in v},
               local_params=sum(p.numel() for p in model.parameters()),
               rules=str(rules))
    del model
    lm_free()
    if rank == 0:
        want, single_ms, single_peak, _ = alone
        tol = FAM_F32_TOL.get(arch, 1e-4)
        scale = float(want.abs().max())
        errs = []
        for r in range(4):
            ref = want[starts[r]:starts[r] + 1]
            errs.append(float((every[r:r + 1] - ref).abs().max()))
            check(errs[-1] <= tol * scale and torch.equal(
                every[r:r + 1].argmax(-1), ref.argmax(-1)),
                f"{arch} 2 x 2 prefill, rank {r}: max |err| "
                f"{errs[-1]:.3e} against one rank's (max |logit| "
                f"{scale:.3e}, tolerance {tol}·max), argmax "
                f"{int(every[r].argmax())} against "
                f"{int(ref[0].argmax())}")
        check(peak < single_peak, f"{arch} 2 x 2 prefill: peak "
              f"{peak} bytes a rank against one rank's {single_peak}")
        check(set(res["all_gathers"]) >= {"sp_last"},
              f"{arch} 2 x 2 prefill: all-gathers {res['all_gathers']}"
              f" hold no sequence-block exchange")
        res.update(single_ms=single_ms, single_peak_bytes=single_peak,
                   max_abs_err=max(errs), max_logit=scale, tol=tol)
    return res


def dr_sptp_cfg(arch: str, sig: bool = False):
    """Case (g)'s config: ``arch`` at full width and DR_SPTP_DEPTH layers
    (deepseek-v2-lite: the dense layer 0 and the first MoE layer), with
    phase 24's signature head for the sig-MMD steps."""
    cfg = dataclasses.replace(get_config(arch), n_layers=DR_SPTP_DEPTH)
    return with_sig_head(cfg, **LM_HEAD) if sig else cfg


def dr_sptp(rank: int, mesh, seed: int) -> dict:
    """(g) Megatron sequence parallelism on the 2 x 2 mesh under
    ``rules_for(arch, shape, {"seq": "model"})``: heads, ``ff`` and
    experts over the model axis, which also cuts each sequence, FSDP over
    the data axis.  deepseek-v2-lite-16b's DR_SPTP_STEPS sig-MMD
    Adafactor steps at LM_TRAIN's 8 x 512 against one rank's (the three
    kernels on the gathered path at one data rank's 4 sequences), then
    the prefill of DR_SPTP_PREFILL of deepseek-v2-lite-16b and
    phi3.5-moe-42b-a6.6b against one rank's."""
    from repro_torch.launch.dryrun import rules_for
    arch = DR_SPTP[0]
    cfg = dr_sptp_cfg(arch, sig=True)
    model = lm_model(cfg, seed)
    data = lm_data(cfg, "sig_mmd", 0, seed)
    batches = [next(data) for _ in range(DR_SPTP_STEPS)]
    alone = dr_alone(rank, cfg, model, batches, "sig_mmd")
    res = dr_train(rank, mesh, cfg, model, batches, "sig_mmd",
                   dr_rules("sptp", arch, DR_SPTP_OVERRIDE), alone,
                   measure=False)
    del model
    lm_free()
    P = 2
    want = {k: dict(sig_trunc=2, sig_gram=3 * P, sig_sweep=1).get(k, 0)
            * DR_SPTP_STEPS for k in counts()}
    got = {k: res["launches_per_rank"].get(k, 0) for k in want}
    check(got == want, f"(g) 2 x 2 {arch} sig-MMD steps: launches a rank "
          f"{got}, expected {want}")
    need = {"sp_tp_in", "sp_tp_out", "sp_moe_in", "sp_moe_out", "sp_path"}
    need |= {t + "_grad" for t in need - {"sp_path"}}
    check(need <= set(res["by_tag"]), f"(g) 2 x 2 {arch} steps: "
          f"collectives by tag {sorted(res['by_tag'])} lack "
          f"{sorted(need - set(res['by_tag']))}")
    res.update(layers=cfg.n_layers, shape=[LM_TRAIN[1], LM_TRAIN[2],
                                           LM_HEAD["channels"],
                                           LM_HEAD["depth"]],
               full_params=sum(p.numel() for p in LM.init_params(
                   seed, cfg, device="meta").parameters()))
    out = {"train": res}
    for a in DR_SPTP:
        cfg = dr_sptp_cfg(a)
        pre = dr_prefill_one(rank, mesh, seed, cfg, rules_for(
            a, DR_PREFILL_SHAPE, DR_SPTP_OVERRIDE),
            dr_prefill_batch(cfg, seed, DR_SPTP_PREFILL), warm=False)
        check({"sp_tp_in", "sp_moe_in"} <= set(pre["all_gathers"])
              and {"sp_tp_out", "sp_moe_out"}
              <= set(pre["reduce_scatters"]),
              f"(g) 2 x 2 {a} prefill: all-gathers {pre['all_gathers']}, "
              f"reduce-scatters {pre['reduce_scatters']}")
        out[f"prefill/{a}"] = pre
    return out


@torch.no_grad()
def dr_moe_greedy(model, cfg, prompts, n_new: int, max_len: int):
    """Greedy decode through ``decode_step``, each step timed to a
    synchronize (the whole batch's logits gathered after the timed call)
    -> (tokens, the whole batch's float32 logits a step, median ms a step
    after the first, this rank's dropped pairs a step, this process's
    peak allocated bytes, the collectives' records of the steps)."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.model_parallel import gather_decode_rows
    from repro_torch.models.layers import dropped_pairs
    B, P = prompts.shape
    cache = LM.init_cache(cfg, B, max_len, torch.float32,
                          device=prompts.device)
    tok, out, hist, ms, drops = prompts[:, :1], [prompts], [], [], []
    records = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for j in range(P - 1 + n_new):
        C.LOG.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with dropped_pairs() as d:
            logits, cache = LM.decode_step(model, cfg, tok, cache)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        records += C.LOG.records
        logits = gather_decode_rows(logits[:, -1].float(), cache)
        drops.append(int(sum(d)))
        hist.append(logits)
        if j + 1 < P:
            tok = prompts[:, j + 1:j + 2]
        else:
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            out.append(tok)
    return (torch.cat(out, dim=1), torch.stack(hist),
            float(np.median(ms[1:])), drops,
            torch.cuda.max_memory_allocated(), records)


def dr_moe_decode(rank: int, mesh, seed: int) -> dict:
    """(h) phi3.5-moe-42b-a6.6b at full width, DR_MOE_DEPTH layers, on
    the 2 x 2 mesh under ``rules_for(arch, "decode_32k")`` (the requests
    over the data axis, 8 experts a rank over the model axis, the cache's
    sequence over the model axis): DR_MOE_DECODE's 128 requests, a step's
    one dispatch group of 128 tokens split across both data ranks, whose
    capacity positions each rank completes with the lower rank's
    per-expert counts (``moe_pos``), against the same model decoded by
    one rank alone: greedy tokens equal, each step's logits within
    1e-4·max|ref|, pairs dropped in some step; ms a step, peak bytes a
    rank and ``moe_pos`` all-gathers a step beside one rank's."""
    from repro_torch.distributed import model_parallel as MP
    from repro_torch.distributed import sharding_ctx
    from repro_torch.launch.dryrun import rules_for
    from repro_torch.models.layers import moe_groups
    cfg = dataclasses.replace(get_config(DR_MOE_ARCH), n_layers=DR_MOE_DEPTH)
    B, P, n_new, max_len = DR_MOE_DECODE
    g = torch.Generator(device="cuda").manual_seed(seed + 36)
    prompts = torch.randint(1, cfg.vocab_size, (B, P), generator=g,
                            device="cuda", dtype=torch.int32)
    rules = rules_for(DR_MOE_ARCH, "decode_32k")
    alone = None
    if rank == 0:
        whole = LM.init_params(seed, cfg)
        alone = dr_moe_greedy(whole, cfg, prompts, n_new, max_len)
        del whole
    torch.distributed.barrier()
    lm_free()
    model = dr_in_turns(rank, 4, lambda: MP.shard_model(
        LM.init_params(seed, cfg), mesh, rules))
    with sharding_ctx(mesh, rules):
        torch.distributed.barrier()
        toks, logits, ms, drops, peak, records = dr_moe_greedy(
            model, cfg, prompts, n_new, max_len)
    local = sum(p.numel() for p in model.parameters())
    del model
    lm_free()
    every = [None] * 4
    torch.distributed.all_gather_object(every, drops)
    steps = P - 1 + n_new
    moe_pos = sum(r.tag == "moe_pos" for r in records)
    _, Tg, C = moe_groups(cfg, B)
    res = dict(ms=ms, peak_bytes=peak, local_params=local,
               moe_pos_per_step=moe_pos / steps, group=[Tg, C],
               shape=list(DR_MOE_DECODE), layers=cfg.n_layers,
               rules=str(rules))
    if rank == 0:
        want, want_logits, single_ms, _, single_peak, _ = alone
        # ranks 0 and 2 hold the two data rows' tokens; 1 and 3 repeat them
        mesh_drops = [a + b for a, b in zip(every[0], every[2])]
        check(torch.equal(toks, want), f"(h) 2 x 2 {DR_MOE_ARCH} decode: "
              f"tokens {toks.tolist()} against one rank's {want.tolist()}")
        scale = float(want_logits.abs().max())
        err = float((logits - want_logits).abs().max())
        check(err <= 1e-4 * scale, f"(h) 2 x 2 {DR_MOE_ARCH} decode: "
              f"logits max |err| {err:.3e} against one rank's (max |logit| "
              f"{scale:.3e})")
        check(mesh_drops == alone[3], f"(h) 2 x 2 {DR_MOE_ARCH} decode: "
              f"dropped pairs a step {mesh_drops} against one rank's "
              f"{alone[3]}")
        check(max(mesh_drops) > 0, f"(h) 2 x 2 {DR_MOE_ARCH} decode: no "
              f"pair dropped in {steps} steps: the capacity path is not "
              f"exercised")
        check(moe_pos == steps * cfg.n_layers, f"(h) 2 x 2 {DR_MOE_ARCH} "
              f"decode: {moe_pos} moe_pos all-gathers in {steps} steps, "
              f"expected one a MoE layer a step")
        res.update(single_ms=single_ms, single_peak_bytes=single_peak,
                   drops=mesh_drops, max_abs_err=err, max_logit=scale,
                   tokens_equal=True)
    return res


def dr_rank(rank: int, world: int, where: str, seed: int, queue) -> None:
    """One gloo rank on the card: phase 28's cases on a 2 x 2 mesh (world
    4) or a 1 x 2 mesh (world 2); nothing is caught."""
    from datetime import timedelta
    from repro_torch.launch.mesh import make_dev_mesh
    os.environ["PATHSIG_AUTOTUNE"] = "off"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    torch.distributed.init_process_group(
        "gloo", store=torch.distributed.FileStore(
            os.path.join(where, "store"), world), rank=rank,
        world_size=world, timeout=timedelta(seconds=DIST_COLLECTIVE_S))
    res, seconds = dict(rank=rank), {}
    if world == 4:
        mesh = make_dev_mesh(2, 2)
        parts = [("whisper_train", dr_whisper_train),
                 ("qwen_train", dr_qwen_train),
                 ("family_train", dr_family_train), ("decode", dr_decode),
                 ("prefill", dr_prefill), ("sptp", dr_sptp),
                 ("moe_decode", dr_moe_decode)]
    else:
        mesh = make_dev_mesh(1, 2)
        parts = [("whisper_serve", dr_whisper_serve)]
    for name, fn in parts:
        t0 = time.perf_counter()
        res[name] = fn(rank, mesh, seed)
        seconds[name] = time.perf_counter() - t0
        if rank == 0:
            print(f"[dryrun_mp] world of {world}: {name} "
                  f"{seconds[name]:.1f} s", flush=True)
    res["seconds"] = seconds
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    queue.put(res)


def dr_compare(name: str, predicted: dict, measured: dict,
               step_tags: dict) -> dict:
    """The dry run's bytes a rank, forward collectives and a step's
    collectives by tag against the real world's rank 0 (counts by kind
    equal, bytes exactly equal; by tag, counts and result bytes)."""
    mem = predicted["memory_analysis"]
    fwd = {k: v["count"] for k, v in predicted["forward_collectives"].items()}
    real = {k: v[0] for k, v in measured["forward"].items()}
    check(mem["param_bytes"] == measured["param_bytes"]
          and mem["opt_state_bytes"] == measured["opt_state_bytes"],
          f"{name}: the dry run's bytes a rank (parameters "
          f"{mem['param_bytes']}, Adafactor state {mem['opt_state_bytes']})"
          f" against rank 0's ({measured['param_bytes']}, "
          f"{measured['opt_state_bytes']})")
    check(fwd == real, f"{name}: the dry run's forward collectives {fwd} "
          f"against the real world's {real}")
    check(predicted["collectives_by_tag"] == step_tags,
          f"{name}: the dry run's step collectives by tag "
          f"{predicted['collectives_by_tag']} against the real world's first "
          f"step's {step_tags}")
    return dict(param_bytes=mem["param_bytes"],
                opt_state_bytes=mem["opt_state_bytes"], forward=fwd,
                step_collectives={k: v["count"] for k, v in
                                  predicted["collectives"].items()},
                step_by_tag={t: {k: v["count"] for k, v in kinds.items()}
                             for t, kinds in step_tags.items()},
                flops_per_dev=predicted["hlo_flops_per_dev"],
                t_s={k: predicted[k] for k in ("t_compute_s", "t_memory_s",
                                              "t_collective_s")},
                temp_bytes=mem["temp_size_bytes"],
                wall_s=predicted["wall_s"])


def dr_train_line(r: dict) -> str:
    """A training case's numbers against one rank, for its printed
    line."""
    tags = {t: {k: v["count"] for k, v in kinds.items()}
            for t, kinds in sorted(r["by_tag"].items())
            if t.startswith("sp_")}
    return (f"losses {np.round(r['losses'], 6).tolist()} against one rank's "
            f"{np.round(r['single_losses'], 6).tolist()}; first-step "
            f"gradients max |err| {r['grad_max_abs_err']:.2e}, within "
            f"1e-3·|g| + {r['grad_atol']}·max|g| (least atol "
            f"{r['grad_atol_needed']:.2e}); step {r['step_ms']:.1f} ms (one "
            f"rank alone {r['single_step_ms']:.1f} ms; ranks share the card:"
            f" not a speedup); peak {r['peak_bytes']} bytes a rank against "
            f"one rank's {r['single_peak_bytes']} (its model alone on the "
            f"card); a step's sequence exchanges by tag {tags or 'none'}")


def phase_dryrun_mp(seed: int) -> dict:
    """Phase 28: the dry run on an abstract 2 x 2 mesh against a real
    gloo world, whisper's model axis served and trained, Adafactor on
    sharded parameters, decode under the dry run's rules, (e) the
    prefill under the dry run's prefill rules, each prompt in blocks over
    the model axis, (g) Megatron sequence parallelism, and (h)
    phi3.5-moe's decode_32k cell, whose dispatch group straddles the data
    ranks."""
    import queue as queue_mod
    t0 = time.perf_counter()
    ctx = torch.multiprocessing.get_context("spawn")
    dq = ctx.Queue()
    child = ctx.Process(target=dr_child, args=(seed, dq))
    child.start()
    try:
        # the worlds run side by side, sharing the card and the host
        worlds, world_s = dist_worlds((4, 2), seed, target=dr_rank)
        try:
            predicted = dq.get(timeout=DIST_WORLD_S)
        except queue_mod.Empty:
            check(False, f"the dry run's process: no result in "
                  f"{DIST_WORLD_S} s (exit code {child.exitcode})")
        child.join(timeout=60)
    finally:
        if child.is_alive():
            child.kill()
            child.join()
    check(child.exitcode == 0, f"the dry run's process exited "
          f"{child.exitcode}")
    r4, r2 = worlds[4][0], worlds[2][0]
    s = r2["whisper_serve"]
    print(f"[dryrun_mp] 1 x 2 whisper-large-v3 at full width ("
          f"{s['params'] / 1e9:.2f}B parameters, {s['layers'][0]} + "
          f"{s['layers'][1]} layers), {s['shape'][0]} requests over "
          f"{s['shape'][1]} frames, {s['shape'][2]}-token prompts, "
          f"{s['shape'][3]} greedy tokens: tokens equal one rank's; "
          f"{s['ms_per_step']:.1f} ms a decode step (one rank alone "
          f"{s['single_ms_per_step']:.1f} ms); {s['local_params']} "
          f"parameters on rank 0", flush=True)
    for key, w in r4["whisper_train"].items():
        rules = ("its train cell's rules" if key == "seq" else
                 "the default rules (heads and ff over the model axis, "
                 "FSDP over the data axis, each sequence whole)")
        print(f"[dryrun_mp] (b) 2 x 2 whisper-large-v3 at full width, depth "
              f"cut to {w['layers'][0]} + {w['layers'][1]} of "
              f"{w['published_layers'][0]} + {w['published_layers'][1]} "
              f"layers, batch {w['batch']} (requests, frames, tokens), "
              f"Adafactor {len(w['losses'])} steps under {rules} "
              f"{w['rules']}"
              + ("" if w["block"] is None else
                 f" (rank 0's block {w['block']} of the tokens)")
              + f": {dr_train_line(w)}; {w['local_params']} of "
              f"{w['full_params']} parameters on rank 0", flush=True)
    q = r4["qwen_train"]
    print(f"[dryrun_mp] (c) 2 x 2 qwen3-4b sig-MMD with Adafactor (depth "
          f"{q['layers']}, {q['shape'][0]} x {q['shape'][1]}) under "
          f"{q['rules']} (rank 0's block {q['block']}): {dr_train_line(q)}; "
          f"launches a rank "
          f"{[r['qwen_train']['launches_per_rank'] for r in worlds[4]]}",
          flush=True)
    for arch, f in r4["family_train"].items():
        print(f"[dryrun_mp] (f) 2 x 2 {arch} at full width, depth "
              f"{f['layers']}, batch {f['batch']} (sequences, tokens), LM "
              f"loss, Adafactor {len(f['losses'])} steps under {f['rules']} "
              f"(rank 0's block {f['block']}): {dr_train_line(f)}; "
              f"{f['local_params']} of {f['full_params']} parameters on "
              f"rank 0", flush=True)
    d = r4["decode"]
    B, P, new, max_len = d["cp_shape"]
    print(f"[dryrun_mp] 2 x 2 qwen3-4b at full width, {DR_DECODE_DEPTH} "
          f"of 36 layers, greedy "
          f"{d['shape']}: tokens equal one rank's under both rule sets; "
          f"{d['rules_for_ms']:.1f} ms a step under rules_for(qwen3-4b, "
          f"decode_32k) = {d['rules']}, {d['default_ms']:.1f} under the "
          f"default rules, {d['single_ms']:.1f} on one rank alone (ranks "
          f"share the card: ratio rules_for / default "
          f"{d['rules_for_ms'] / d['default_ms']:.3f}, not a speedup); "
          f"{d['rules_for_local_params']} and {d['default_local_params']} "
          f"parameters on rank 0; cache bytes a rank "
          f"{d['rules_for_cache_bytes']} under rules_for (the requests over "
          f"the data axis, the sequence over the model axis) and "
          f"{d['default_cache_bytes']} under the default rules, of "
          f"{d['whole_cache_bytes']} whole", flush=True)
    print(f"[dryrun_mp] 2 x 2 qwen3-4b at full width, {DR_DECODE_DEPTH} "
          f"of 36 layers, under rules_for, "
          f"{B} requests, {P}-token prompts, {new} greedy tokens, max_len "
          f"{max_len} (the positions cross the model axis's sequence "
          f"blocks of {max_len // 2}): tokens equal one rank's; "
          f"{d['rules_for_cp_ms']:.1f} ms a step ({d['single_cp_ms']:.1f} "
          f"on one rank alone); cache bytes a rank "
          f"{d['rules_for_cp_cache_bytes']} of "
          f"{d['whole_cp_cache_bytes']} whole", flush=True)
    for arch, e in r4["prefill"].items():
        print(f"[dryrun_mp] (e) 2 x 2 {arch} prefill (layers {e['layers']},"
              f" batch {e['batch']}) under rules_for({arch}, "
              f"{DR_PREFILL_SHAPE}) = {e['rules']}: each rank its request "
              f"and its block {e['block']} (start, length) of the prompt; "
              f"last-position logits of every rank within "
              f"{e['tol']}·max|ref| of one rank's (max |err| "
              f"{e['max_abs_err']:.2e}, max |logit| {e['max_logit']:.2e}), "
              f"argmax equal; {e['ms']:.1f} ms a prefill "
              f"({'first call' if arch == LM_ARCH else 'after a warm call'}"
              f"; one rank alone {e['single_ms']:.1f} ms; ranks share the "
              f"card: not a speedup); peak {e['peak_bytes']} bytes a rank "
              f"against one rank's {e['single_peak_bytes']}; "
              f"{e['local_params']} parameters on rank 0; all-gathers a "
              f"forward by tag {e['all_gathers']}; kernel launches "
              f"{[r['prefill'][arch]['launches'] for r in worlds[4]]}",
              flush=True)
    g = r4["sptp"]
    t = g["train"]
    print(f"[dryrun_mp] (g) 2 x 2 {DR_SPTP[0]} at full width, depth "
          f"{t['layers']} ({t['local_params']} of {t['full_params']} "
          f"parameters on rank 0), sig-MMD Adafactor {len(t['losses'])} "
          f"steps at {t['shape'][0]} x {t['shape'][1]} under {t['rules']} "
          f"(heads, ff and experts over the model axis that cuts each "
          f"sequence; rank 0's block {t['block']}): {dr_train_line(t)}; "
          f"launches a rank "
          f"{[r['sptp']['train']['launches_per_rank'] for r in worlds[4]]}",
          flush=True)
    for arch in DR_SPTP:
        e = g[f"prefill/{arch}"]
        print(f"[dryrun_mp] (g) 2 x 2 {arch} prefill (layers {e['layers']},"
              f" batch {e['batch']}) under {e['rules']}: each rank its "
              f"request and its block {e['block']} of the prompt, its heads "
              f"and experts over the whole prompt; last-position logits of "
              f"every rank within {e['tol']}·max|ref| of one rank's (max "
              f"|err| {e['max_abs_err']:.2e}, max |logit| "
              f"{e['max_logit']:.2e}), argmax equal; {e['ms']:.1f} ms a "
              f"prefill, its first call (one rank alone, after a warm call, "
              f"{e['single_ms']:.1f} ms; ranks share the card: not a "
              f"speedup); peak {e['peak_bytes']} bytes a rank against one "
              f"rank's {e['single_peak_bytes']}; {e['local_params']} "
              f"parameters on rank 0; all-gathers a forward by tag "
              f"{e['all_gathers']}, reduce-scatters {e['reduce_scatters']}"
              f"; kernel launches "
              f"{[r['sptp'][f'prefill/{arch}']['launches'] for r in worlds[4]]}",
              flush=True)
    h = r4["moe_decode"]
    B, P, new, max_len = h["shape"]
    print(f"[dryrun_mp] (h) 2 x 2 {DR_MOE_ARCH} at full width, depth "
          f"{h['layers']}, under rules_for({DR_MOE_ARCH}, decode_32k) = "
          f"{h['rules']}: {B} requests ({B // 2} a data rank), {P}-token "
          f"prompts, {new} greedy tokens, max_len {max_len}; a step's "
          f"tokens are one dispatch group of {h['group'][0]} with "
          f"{h['group'][1]} slots an expert, split across both data ranks: "
          f"tokens equal one rank's; logits max |err| "
          f"{h['max_abs_err']:.2e} (max |logit| {h['max_logit']:.2e}, "
          f"within 1e-4·max); dropped pairs a step {h['drops']} (equal to "
          f"one rank's); {h['ms']:.1f} ms a step (one rank alone "
          f"{h['single_ms']:.1f} ms; ranks share the card: not a speedup); "
          f"peak {h['peak_bytes']} bytes a rank against one rank's "
          f"{h['single_peak_bytes']}; {h['moe_pos_per_step']:g} moe_pos "
          f"all-gathers a step a rank; {h['local_params']} parameters on "
          f"rank 0", flush=True)
    w = r4["whisper_train"]
    dry = {"whisper": dr_compare("whisper", predicted["whisper"],
                                 w["seq"]["measured"], w["seq"]["by_tag"]),
           "whisper_default": dr_compare(
               "whisper under the default rules",
               predicted["whisper_default"], w["default"]["measured"],
               w["default"]["by_tag"]),
           "qwen": dr_compare("qwen3-4b sig-MMD", predicted["qwen"],
                              q["measured"], q["by_tag"])}
    print(f"[dryrun_mp] dry run on AbstractMesh((2, 2)) against rank 0: "
          + "; ".join(f"{k}: parameters {v['param_bytes']} B, Adafactor "
                      f"state {v['opt_state_bytes']} B (equal), one "
                      f"forward's collectives {v['forward']} (equal), a "
                      f"step's {v['step_collectives']}, "
                      f"by tag {v['step_by_tag']} (equal), "
                      f"{v['flops_per_dev']:.4e} FLOPs a rank, terms "
                      f"{ {t: float(f'{x:.4g}') for t, x in v['t_s'].items()} }"
                      f", {v['wall_s']:.1f} s"
                      for k, v in dry.items()), flush=True)
    seconds = time.perf_counter() - t0
    print(f"[dryrun_mp] worlds' wall seconds {world_s}; seconds a case "
          f"(rank 0) { {k: round(v, 1) for k, v in r4['seconds'].items()} }"
          f" { {k: round(v, 1) for k, v in r2['seconds'].items()} }; "
          f"phase 28 {seconds:.1f} s", flush=True)
    return dict(world_s=world_s, world4=r4, world2=r2, dryrun=dry,
                launches=[r["qwen_train"]["launches_per_rank"]
                          for r in worlds[4]],
                sptp_launches=[r["sptp"]["train"]["launches_per_rank"]
                               for r in worlds[4]], seconds=seconds)


# phase 29: the examples with a _torch counterpart, each run on the card as
# a user runs it: (module under examples/, argv)
EXAMPLES = [
    ("quickstart_torch", []), ("streaming_torch", []),
    ("kernel_methods_torch", []), ("ragged_serving_torch", []),
    ("sessions_serving_torch", []), ("serve_lm_torch", []),
    ("train_lm_torch", ["--preset", "100m", "--steps", "20", "--ckpt-dir",
                        str(ROOT / "build" / "chip_smoke_train_lm_ckpt")]),
    ("observability_torch", ["--check"])]
# each kernel's counters: the terminal and the streamed launches
EXAMPLE_KERNELS = {"sig_trunc": ("sig_trunc", "sig_trunc_stream"),
                   "sig_words": ("sig_words", "sig_words_stream"),
                   "sig_gram": ("sig_gram",), "sig_sweep": ("sig_sweep",)}
# the launches that the examples hold against their plain versions on the
# same inputs (the "plain_checks" their main returns): quickstart's
# sig_trunc, sig_words and section 2 gradient, streaming's streamed forward
# and its gradient, kernel_methods' Gram
PLAIN_CHECKED = {"sig_trunc", "sig_trunc_stream", "sig_words", "sig_gram",
                 "sig_sweep"}


def example_module(name: str):
    """An example imported by name from examples/, which goes on sys.path
    so that the ranks an example spawns import it too."""
    where = str(ROOT / "examples")
    if where not in sys.path:
        sys.path.insert(0, where)
    return importlib.import_module(name)


def phase_examples() -> dict:
    """Phase 29: every example's main(argv) on the card, with the launch
    counters set to 0 just before it and read just after."""
    t_phase = time.perf_counter()
    runs, checked = {}, set()
    for name, argv in EXAMPLES:
        mod = example_module(name)
        print(f"[examples] {name} {' '.join(argv)}", flush=True)
        reset_counts()
        t0 = time.perf_counter()
        try:
            out = mod.main(argv)
        except SystemExit as e:
            check(e.code in (None, 0), f"examples/{name}.py exited "
                  f"{e.code!r}")
            out = None
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(not isinstance(out, int) or out == 0,
              f"examples/{name}.py returned {out}")
        plain = out.get("plain_checks", []) if isinstance(out, dict) else []
        for c in plain:
            print(f"[examples] {name}: {c['kernel']} {c['what']} max|err| "
                  f"{c['max_abs_err']:.2e}", flush=True)
            check(c["ok"], f"examples/{name}.py: {c['what']} missed its "
                  f"tolerance")
        checked.update(c["kernel"] for c in plain)
        runs[name] = dict(seconds=seconds, plain_checks=plain,
                          launches={k: v for k, v in counts().items() if v})
    shutil.rmtree(ROOT / "build" / "chip_smoke_train_lm_ckpt",
                  ignore_errors=True)
    totals = {k: sum(r["launches"].get(c, 0) for r in runs.values()
                     for c in cs) for k, cs in EXAMPLE_KERNELS.items()}
    for name, r in runs.items():
        print(f"[examples] {name}: {r['seconds']:.1f} s, launches "
              f"{r['launches']}", flush=True)
    for k, n in totals.items():
        check(n > 0, f"no example launched the {k} kernel")
    check(checked == PLAIN_CHECKED, f"the examples held {sorted(checked)} "
          f"against their plain versions, not {sorted(PLAIN_CHECKED)}")
    seconds = time.perf_counter() - t_phase
    print(f"[examples] launches by kernel over the eight examples {totals}; "
          f"phase 29 {seconds:.1f} s", flush=True)
    return dict(runs=runs, totals=totals, seconds=seconds)


def examples_case(ex: dict, counter: str) -> dict:
    """One kernel row's case of phase 29: its launches by example, and
    the examples' checks of it against its plain version."""
    by = {name: r["launches"].get(counter, 0) for name, r in
          ex["runs"].items()}
    held = {f"{name}: {c['what']}": c["max_abs_err"]
            for name, r in ex["runs"].items() for c in r["plain_checks"]
            if c["kernel"] == counter}
    return dict(case="examples (phase 29)", launches=sum(by.values()),
                by_example={k: v for k, v in by.items() if v},
                plain_max_abs_err=held)


# ---------------------------------------------------------------------------
# phase 30: the kernels as operators, costed on meta tensors and on the card
# ---------------------------------------------------------------------------

# (B, M, d, N) of the serving micro-batch; the §8 projection's augmented
# increments (B, M, letters) and word depth; the reference Gram; the §8
# truncated training step (B, M, letters, N)
COST_TRUNC = (64, 1024, 6, 5)
COST_WORDS = (128, 500, 10, 4)
COST_GRAM = (2048, 2048, 9330)
COST_VG = (128, 500, 10, 3)
HOST_CELL = (64, 32, 4, 3)     # the small launch whose host time is taken
HOST_CALLS = 400


def cost_case(name: str, fn, args: tuple, want: int, kernels: dict) -> dict:
    """``obs.record_cost`` of ``fn`` on meta copies of ``args`` (nothing
    built, nothing launched), then a ``CostCounter`` around the real call
    on the card: both read ``want`` FLOPs exactly, and the real call
    launches ``kernels`` ({counter: launches}) and nothing else."""
    reset_counts()
    meta = obs.record_cost(f"chip_smoke.{name}", fn, *args)
    check(all(v == 0 for v in counts().values()),
          f"{name}: the meta count launched {counts()}")
    reset_counts()
    with obs.compile.CostCounter() as cc:
        fn(*args)
    torch.cuda.synchronize()
    got = counts()
    print(f"[cost] {name}: record_cost {meta['flops']:,.0f} FLOPs on meta, "
          f"{cc.flops:,.0f} around the call on the card, cost.py "
          f"{want:,}; launches {got}; by operator "
          f"{cc.raw()['flops_by_op']}", flush=True)
    check(meta["flops"] == want, f"{name}: record_cost reads "
          f"{meta['flops']} FLOPs, cost.py {want}")
    check(cc.flops == meta["flops"], f"{name}: the call on the card reads "
          f"{cc.flops} FLOPs, the meta count {meta['flops']}")
    check(got == dict({k: 0 for k in got}, **kernels),
          f"{name}: launches {got}, expected {kernels}")
    return dict(case=name, shape=[int(v) for v in args[0].shape],
                flops=int(want), meta_flops=meta["flops"],
                card_flops=cc.flops, meta_bytes=meta["bytes"],
                launches=kernels)


def host_ms(fns: dict) -> dict:
    """Median host ms from call to return of each of ``fns``, in turns
    (each call of one, then each of the next), ``HOST_CALLS`` calls
    each, synchronizing every 50 calls so the queue stays short."""
    times = {k: [] for k in fns}
    for f in fns.values():
        f()
    torch.cuda.synchronize()
    for i in range(HOST_CALLS):
        for k, f in fns.items():
            t0 = time.perf_counter()
            f()
            times[k].append((time.perf_counter() - t0) * 1e3)
        if i % 50 == 49:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return {k: float(np.median(v)) for k, v in times.items()}


def direct_launch(x: torch.Tensor, depth: int) -> torch.Tensor:
    """The ``sig_trunc`` launch as ``_launch`` made it before the kernel
    became an operator: the planner, the increments detached and cast,
    the kernel's launch body called directly (no dispatcher) and the
    reassembly."""
    B, _, d = x.shape
    p = st.plan_launch(B, d, depth)
    xs = x.detach().to(st._storage_dtype("fp32")).contiguous()
    out = st._kernel(xs, None, depth, 0, 0, p.split, 0, p.threads,
                     p.examples, p.top_slots)
    return st._reassemble(out, d, depth, p.split)


def phase_cost(rng) -> dict:
    """Phase 30: each kernel's route costed by ``obs.record_cost`` on
    meta tensors against ``kernels/cost.py`` and against a
    ``CostCounter`` around the same call on the card, one launch each;
    then the host time of a small ``sig_trunc`` launch through the
    operator beside the direct launch."""
    t_phase = time.perf_counter()
    os.environ["PATHSIG_AUTOTUNE"] = "off"
    cases = {}
    B, M, d, N = COST_TRUNC
    x = torch.diff(brownian(rng, B, M, d), dim=1)
    cases["sig_trunc"] = cost_case(
        "sig_trunc serving micro-batch",
        lambda a: ops.signature(a, N, backend="cuda"), (x,),
        trunc_work(B, M, d, N)[0], {"sig_trunc": 1})
    check(roofline_ms(*trunc_work(B, M, d, N)) == bound(
        B, M, d, N, 4, B * sig.sig_dim(d, N), 4),
        "cost.trunc_work's bound differs from cost.bound's")
    B, M, d, N = COST_WORDS
    words = generated_words(sparse_leadlag_generators(d // 2), N)
    x = torch.diff(brownian(rng, B, M, d), dim=1)
    cases["sig_words"] = cost_case(
        f"sig_words §8 ({len(words)} words)",
        lambda a: ops.projected(a, words, backend="cuda"), (x,),
        words_work(B, M, d, make_plan(words, d), len(words))[0],
        {"sig_words": 1})
    Bx, By, D = COST_GRAM
    Sx = torch.tensor(rng.normal(size=(Bx, D)), dtype=torch.float32,
                      device="cuda")
    Sy = torch.tensor(rng.normal(size=(By, D)), dtype=torch.float32,
                      device="cuda")
    w = torch.tensor(rng.random(D), dtype=torch.float32, device="cuda")
    cases["sig_gram"] = cost_case(
        "sig_gram reference Gram",
        lambda a, b, c: ops.gram(a, b, c, backend="cuda"), (Sx, Sy, w),
        gram_work(Bx, By, D)[0], {"sig_gram": 1})
    del Sx, Sy
    B, M, d, N = COST_VG
    x = torch.diff(brownian(rng, B, M, d), dim=1).requires_grad_()

    def value_and_grad(a):
        out = ops.signature(a, N, backend="cuda")
        return out, torch.autograd.grad(out, a, torch.ones_like(out))

    want = (trunc_work(B, M, d, N)[0]
            + sweep_work(B, M, sig.truncation_closure(d, N), 1)[0])
    cases["sig_sweep"] = cost_case(
        "§8 truncated value and gradient", value_and_grad, (x,), want,
        {"sig_trunc": 1, "sig_sweep": 1})
    B, M, d, N = HOST_CELL
    x = torch.diff(brownian(rng, B, M, d), dim=1)
    torch.testing.assert_close(st._launch(x, N, None, False, 1, "fp32"),
                               direct_launch(x, N), rtol=0, atol=0)
    host = host_ms({
        "operator": lambda: st._launch(x, N, None, False, 1, "fp32"),
        "direct": lambda: direct_launch(x, N),
        "wrapper": lambda: st.sig_trunc(x, N)})
    print(f"[cost] host ms from call to return of a sig_trunc launch "
          f"{HOST_CELL}, median of {HOST_CALLS}: through the operator "
          f"{host['operator']:.4f}, the direct launch {host['direct']:.4f} "
          f"(+{host['operator'] - host['direct']:.4f}), the sig_trunc "
          f"wrapper {host['wrapper']:.4f}", flush=True)
    seconds = time.perf_counter() - t_phase
    print(f"[timing] cost phase: {seconds:.1f} s", flush=True)
    return dict(cases=cases, host_ms=host, host_cell=list(HOST_CELL),
                seconds=seconds)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the measurements here (JSON)")
    args = ap.parse_args()
    # phases 1-22 run the planner's partitions; phase 23 sweeps its own
    os.environ["PATHSIG_AUTOTUNE"] = "off"
    # the reference's matmuls are exact fp32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = phase_device()
    ptxas = phase_build()
    rng = np.random.default_rng(args.seed)
    max_err = phase_kernels(rng)
    serve = phase_serve(rng)
    table1, stream = phase_dispatch(rng)
    words_err, sets, fsets = phase_words_kernels(rng)
    cross = phase_cross(rng)
    proj = phase_projection(rng)
    logsig = phase_logsig(rng)
    gram_err = phase_gram_kernels(rng)
    phase_gram_variants(rng)
    score = phase_scoring(rng)
    mmd = phase_projected_mmd(rng)
    sweep = phase_sweep(rng, sets, fsets)
    train = phase_train_grid(rng)
    memory = phase_memory(rng)
    mmd_grad = phase_mmd_grad(rng)
    hurst = phase_hurst(args.seed)
    fused = phase_transform(rng)
    t0 = time.perf_counter()
    ckpt = phase_checkpoint(rng, train)
    windows = phase_windows(rng)
    streams = phase_stream(rng)
    new_s = time.perf_counter() - t0
    print(f"[timing] checkpoint, windows and stream phases: {new_s:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    sessions = phase_sessions(rng)
    sessions_s = time.perf_counter() - t0
    print(f"[timing] sessions phase: {sessions_s:.1f} s", flush=True)
    t0 = time.perf_counter()
    slice8 = phase_slice8(rng)
    slice8_s = time.perf_counter() - t0
    print(f"[timing] ragged, hybrid, autotune and observability phase: "
          f"{slice8_s:.1f} s", flush=True)
    os.environ["PATHSIG_AUTOTUNE"] = "off"
    t0 = time.perf_counter()
    lm = phase_lm(rng, args.seed)
    lm_s = time.perf_counter() - t0
    print(f"[timing] LM serving, training and heads phase: {lm_s:.1f} s",
          flush=True)
    fam = phase_families(args.seed)
    print(f"[timing] families phase: {fam['seconds']:.1f} s", flush=True)
    lm_free()
    distd = phase_distributed(args.seed)
    print(f"[timing] distributed phase: {distd['seconds']:.1f} s",
          flush=True)
    mpar = phase_model_parallel(args.seed)
    print(f"[timing] model-parallel phase: {mpar['seconds']:.1f} s",
          flush=True)
    drmp = phase_dryrun_mp(args.seed)
    print(f"[timing] dry-run and model-axis phase: {drmp['seconds']:.1f} s",
          flush=True)
    ex = phase_examples()
    costed = phase_cost(rng)
    shard_cases = {name: [] for name in ("sig_trunc", "sig_words",
                                         "sig_gram", "sig_sweep")}
    for P, r0 in distd["worlds"].items():
        for c in r0["signature"]:
            shard_cases["sig_trunc"].append(c)
            shard_cases["sig_sweep"].append(c)
        shard_cases["sig_words"].append(r0["projected"])
        shard_cases["sig_sweep"].append(r0["projected"])
        shard_cases["sig_gram"] += r0["gram"]
        if "train" in r0:
            for k in ("sig_trunc", "sig_gram", "sig_sweep"):
                shard_cases[k].append({key: v for key, v in
                                       r0["train"].items()
                                       if key != "losses"})
    mp_case = {k: v for k, v in mpar["world4"]["train"].items()
               if k not in ("losses", "single_losses", "collectives")}
    for k in ("sig_trunc", "sig_gram", "sig_sweep"):
        shard_cases[k].append(dict(mp_case, launches_per_rank=[
            {n: c for n, c in r.items() if n == k} for r in mpar["launches"]]))
    for case, launches in ((drmp["world4"]["qwen_train"], drmp["launches"]),
                           (drmp["world4"]["sptp"]["train"],
                            drmp["sptp_launches"])):
        dr_case = {k: v for k, v in case.items()
                   if k not in ("losses", "single_losses", "measured")}
        for k in ("sig_trunc", "sig_gram", "sig_sweep"):
            shard_cases[k].append(dict(dr_case, launches_per_rank=[
                {n: c for n, c in r.items() if n == k} for r in launches]))
    heads = lm["heads"]
    lm_launches = lm["train"]["launches"]
    moe = fam["train"]
    moe_launches = moe["launches"]
    eng = sessions["engines"]
    src = "src/repro_torch/kernels/csrc/sig_trunc.cu"
    largest = max(table1, key=lambda r: r["bound_ms"])
    trunc_cases = [
        trunc_case("serving micro-batch", serve["shape"], serve),
        trunc_case("engine references", score["ref_sigs"]["shape"],
                   score["ref_sigs"]),
        trunc_case("largest Table 1 cell", [largest[k] for k in "BMdN"],
                   largest),
        trunc_case("streamed", stream["shape"], stream),
        fused["projection"]["trunc"], fused["serve"]]
    trunc_cases += [c["trunc"] for c in fused["table1"]]
    trunc_cases += [ckpt["trunc_case"], windows["fold_case"],
                    streams["extend_case"], sessions["pool"]["bucket_case"],
                    eng["trunc_case"], slice8["ragged"]["bucket_case"],
                    dict(heads["trunc_case"],
                         launches=lm_launches["sig_trunc"]),
                    dict(moe["trunc_case"], launches=moe_launches["sig_trunc"])]
    trunc_cases += shard_cases["sig_trunc"]
    wsrc = "src/repro_torch/kernels/csrc/sig_words.cu"
    t3 = max(logsig, key=lambda r: r["bound_ms"])
    words_cases = [
        dict(case="§8 terminal", shape=proj["shape"][:4],
             words=proj["words"], partition=proj["partition"],
             ms=proj["ms"], bound_ms=proj["bound_ms"],
             bound_by=proj["bound_by"]),
        dict(case="§8 streamed", shape=proj["shape"],
             words=proj["closure"], partition=proj["stream_partition"],
             ms=proj["stream_ms"], bound_ms=proj["stream_bound_ms"],
             bound_by=proj["stream_bound_by"]),
        dict(case="largest Table 3 set", shape=[t3[k] for k in "BMdN"],
             words=t3["words"], partition=t3["partition"],
             ms=t3["kernel_ms"], bound_ms=t3["bound_ms"],
             bound_by=t3["bound_by"]),
        fused["projection"]["words"], windows["words_case"],
        slice8["hybrid"]["words_case"], heads["words_case"]]
    words_cases += shard_cases["sig_words"]
    kernels = [
        dict(name="sig_trunc", route="cuda", source=src,
             replaces="src/repro/kernels/sig_trunc.py:300",
             launches=serve["launches"], max_abs_err=max_err["sig_trunc"],
             ms=serve["ms"], plain_ms=serve["plain_ms"],
             bound_ms=serve["bound_ms"], bound_by=serve["bound_by"],
             library_ms=None,
             cases=trunc_cases + [examples_case(ex, "sig_trunc")]),
        dict(name="sig_trunc_stream", route="cuda", source=src,
             replaces="src/repro/kernels/sig_trunc.py:313",
             launches=stream["launches"],
             max_abs_err=max_err["sig_trunc_stream"], ms=stream["ms"],
             plain_ms=stream["plain_ms"], bound_ms=stream["bound_ms"],
             bound_by=stream["bound_by"], library_ms=None,
             cases=[c["stream"] for c in fused["table1"]]
             + [windows["chen_case"], streams["features"]["case"],
                eng["stream_case"], heads["stream_case"],
                examples_case(ex, "sig_trunc_stream")]),
        dict(name="sig_words", route="cuda", source=wsrc,
             replaces="src/repro/kernels/sig_words.py:197",
             launches=proj["launches"], max_abs_err=words_err["sig_words"],
             ms=proj["ms"], plain_ms=proj["plain_ms"],
             bound_ms=proj["bound_ms"], bound_by=proj["bound_by"],
             library_ms=None,
             cases=words_cases + [examples_case(ex, "sig_words")]),
        dict(name="sig_words_stream", route="cuda", source=wsrc,
             replaces="src/repro/kernels/sig_words.py:212",
             launches=proj["stream_launches"],
             max_abs_err=words_err["sig_words_stream"], ms=proj["stream_ms"],
             plain_ms=proj["stream_plain_ms"],
             bound_ms=proj["stream_bound_ms"],
             bound_by=proj["stream_bound_by"], library_ms=None,
             cases=[fused["projection"]["words_stream"],
                    examples_case(ex, "sig_words_stream")]),
        dict(name="sig_gram", route="cuda",
             source="src/repro_torch/kernels/csrc/sig_gram.cu",
             replaces="src/repro/kernels/sig_gram.py:68",
             launches=score["launches"], max_abs_err=gram_err,
             ms=score["ref_gram"]["ms"],
             plain_ms=score["ref_gram"]["plain_ms"],
             bound_ms=score["ref_gram"]["bound_ms"],
             bound_by=score["ref_gram"]["bound_by"],
             library_ms=score["ref_gram"]["library_ms"],
             fp32_bound_ms=score["ref_gram"]["fp32_bound_ms"],
             cases=[dict(case=name, **{k: t[k] for k in (
                 "shape", "slices", "ms", "call_ms", "plain_ms",
                 "library_ms", "library_call_ms", "bound_ms", "bound_by",
                 "fp32_bound_ms")})
                 for name, t in (("reference Gram", score["ref_gram"]),
                                 ("cross-Gram", score["cross_gram"]),
                                 ("projected-MMD Gram", mmd["gram"]))]
             + [eng["gram_case"], slice8["autotune"]["gram_case"],
                dict(heads["gram_case"], launches=lm_launches["sig_gram"]),
                dict(moe["gram_case"], launches=moe_launches["sig_gram"])]
             + shard_cases["sig_gram"] + [examples_case(ex, "sig_gram")]),
    ]
    big = max(train, key=lambda r: r["sweep_bound_ms"])
    sweep_cases = [dict(case="largest Table 1 train cell",
                        shape=[big[k] for k in "BMdN"], W=big["sweep_W"],
                        value_and_grad_ms=big["ms"],
                        **{k: big[f"sweep_{k}"] for k in (
                            "ms", "us_per_step", "partition",
                            "plain_ms", "bound_ms", "bound_by")})]
    for kind, case in (("sparse", "§8 sparse step"),
                       ("truncated", "§8 truncated step")):
        h = hurst[kind]
        sweep_cases.append(dict(case=case, shape=h["shape"], W=h["W"],
                                step_ms=h["step_ms"], **{
                                    k: h["sweep"][k] for k in (
                                        "ms", "us_per_step",
                                        "partition", "plain_ms", "bound_ms",
                                        "bound_by")}))
    sweep_cases += [ckpt["sweep_case"],
                    dict(heads["sweep_case"],
                         launches=lm_launches["sig_sweep"]),
                    dict(moe["sweep_case"],
                         launches=moe_launches["sig_sweep"])]
    sweep_cases += shard_cases["sig_sweep"]
    sweep_cases.append(examples_case(ex, "sig_sweep"))
    sp = hurst["sparse"]["sweep"]
    kernels.append(dict(
        name="sig_sweep", route="cuda",
        source="src/repro_torch/kernels/csrc/sig_sweep.cu",
        replaces="src/repro/core/signature.py:308",
        replaces_scans=["src/repro/core/signature.py:308",
                        "src/repro/core/signature.py:354",
                        "src/repro/core/projection.py:76",
                        "src/repro/core/projection.py:134"],
        launches=sum(h["sweep_launches"] for h in hurst.values()),
        max_abs_err=sweep["max_abs_err"], ms=sp["ms"],
        plain_ms=sp["plain_ms"], bound_ms=sp["bound_ms"],
        bound_by=sp["bound_by"], library_ms=None,
        us_per_step=sp["us_per_step"],
        design_phases={str(n): ss.step_phases(n) for n in sorted(
            {c["shape"][3] for c in sweep_cases if "shape" in c})},
        partitions_checked=sweep["partitions"],
        ptxas=ptxas.get("sig_sweep", {}), cases=sweep_cases))
    for row in kernels:   # phase 30: the route's FLOPs, meta and on the card
        if row["name"] in costed["cases"]:
            row["cost"] = costed["cases"][row["name"]]
    kernels[0]["host_ms"] = dict(costed["host_ms"],
                                 shape=costed["host_cell"])
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            device=smi, kernels=kernels, serve=serve, table1=table1,
            stream=stream, cross=cross, projection=proj, logsig=logsig,
            scoring=score, projected_mmd=mmd, sweep=sweep,
            train=train, memory=memory, mmd_grad=mmd_grad, hurst=hurst,
            transform=fused, checkpoint=ckpt, windows=windows,
            streams=streams, new_phases_s=new_s, sessions=sessions,
            sessions_s=sessions_s, slice8=slice8, slice8_s=slice8_s,
            lm=lm, lm_s=lm_s, families=fam, distributed=distd,
            model_parallel=mpar, dryrun_mp=drmp, examples=ex,
            cost=costed), indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
